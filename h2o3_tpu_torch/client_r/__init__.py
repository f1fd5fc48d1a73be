"""h2o-r client generator — the gen_R.py codegen role.

The port's copy of h2o3_tpu/client_r/__init__.py: the same generator, so
the package generated from the port server's ``/3/ModelBuilders`` is
the reference's file for file when the two servers list the same
builders and defaults.

Reference: h2o-r (~96K LoC, one file per algo under
h2o-r/h2o-package/R/) is GENERATED from REST schema metadata by
h2o-bindings/bin/gen_R.py. This module performs that generation step
against a live server: `generate_r_package(outdir, url)` emits an
installable R source package whose functions (h2o.init, h2o.importFile,
h2o.gbm, h2o.glm, …, h2o.predict, h2o.performance, h2o.downloadMOJO)
speak the same /3 REST wire protocol as the Python client.

The generated R depends only on base R + jsonlite (the reference also
requires jsonlite) and shells out to `curl` for HTTP, so it installs
without compiled dependencies. The build image has no R runtime
(PARITY.md), so the generated package is validated structurally here
and executably wherever R exists.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List


_CORE_R = r'''# Generated by h2o3-tpu (gen_R.py role). Core connection + REST plumbing.

.h2o.env <- new.env(parent = emptyenv())

h2o.init <- function(url = "http://127.0.0.1:54321") {
  assign("url", sub("/+$", "", url), envir = .h2o.env)
  cloud <- .h2o.request("GET", "/3/Cloud")
  message(sprintf("Connected to %s (%d node(s))",
                  cloud$cloud_name, cloud$cloud_size))
  invisible(cloud)
}

.h2o.url <- function() {
  if (!exists("url", envir = .h2o.env))
    stop("no connection - call h2o.init(url)")
  get("url", envir = .h2o.env)
}

.h2o.encode <- function(params) {
  if (length(params) == 0) return("")
  enc <- vapply(names(params), function(k) {
    v <- params[[k]]
    if (is.list(v) || length(v) > 1)
      v <- jsonlite::toJSON(v, auto_unbox = TRUE)
    paste0(utils::URLencode(k, reserved = TRUE), "=",
           utils::URLencode(as.character(v), reserved = TRUE))
  }, character(1))
  paste(enc, collapse = "&")
}

.h2o.request <- function(method, path, params = list()) {
  url <- paste0(.h2o.url(), path)
  body <- .h2o.encode(params)
  if (method == "GET") {
    if (nzchar(body)) url <- paste0(url, "?", body)
    out <- system2("curl", c("-s", shQuote(url)), stdout = TRUE)
  } else {
    out <- system2("curl", c("-s", "-X", method, "-d", shQuote(body),
                             shQuote(url)), stdout = TRUE)
  }
  jsonlite::fromJSON(paste(out, collapse = ""), simplifyVector = FALSE)
}

.h2o.wait.job <- function(resp) {
  key <- resp$job$key
  if (is.list(key)) key <- key$name
  if (is.null(key)) return(resp)
  repeat {
    j <- .h2o.request("GET", paste0("/3/Jobs/", key))$jobs[[1]]
    if (identical(j$status, "FAILED"))
      stop(paste("job failed:", j$exception))
    if (identical(j$status, "CANCELLED"))
      stop("job was cancelled")
    if (identical(j$status, "DONE")) return(j)
    Sys.sleep(0.2)
  }
}

h2o.importFile <- function(path, destination_frame = NULL) {
  .h2o.request("POST", "/3/ImportFiles", list(path = path))
  params <- list(source_frames = path)
  if (!is.null(destination_frame))
    params$destination_frame <- destination_frame
  j <- .h2o.wait.job(.h2o.request("POST", "/3/Parse", params))
  structure(list(frame_id = if (is.null(j$dest))
    paste0(basename(path), ".hex") else j$dest), class = "H2OFrame")
}

h2o.getFrame <- function(id) structure(list(frame_id = id),
                                       class = "H2OFrame")

h2o.ls <- function() {
  fr <- .h2o.request("GET", "/3/Frames")$frames
  vapply(fr, function(f) f$frame_id$name, character(1))
}

as.data.frame.H2OFrame <- function(x, n = 10L, ...) {
  f <- .h2o.request("GET", paste0("/3/Frames/", x$frame_id))$frames[[1]]
  cols <- lapply(f$columns, function(c)
    unlist(lapply(c$data, function(v) if (is.null(v)) NA else v)))
  names(cols) <- vapply(f$columns, function(c) c$label, character(1))
  do.call(data.frame, c(cols, stringsAsFactors = FALSE))
}

h2o.rapids <- function(ast) .h2o.request("POST", "/99/Rapids",
                                         list(ast = ast))

.h2o.train <- function(algo, x, y, training_frame, params) {
  if (inherits(training_frame, "H2OFrame"))
    training_frame <- training_frame$frame_id
  params$training_frame <- training_frame
  params$response_column <- y
  if (!is.null(x))
    params$ignored_columns <- jsonlite::toJSON(
      setdiff(h2o.colnames(training_frame), c(x, y)), auto_unbox = FALSE)
  params <- Filter(Negate(is.null), params)
  j <- .h2o.wait.job(.h2o.request(
    "POST", paste0("/3/ModelBuilders/", algo), params))
  structure(list(model_id = j$dest, algo = algo), class = "H2OModel")
}

h2o.colnames <- function(frame_id) {
  if (inherits(frame_id, "H2OFrame")) frame_id <- frame_id$frame_id
  f <- .h2o.request("GET", paste0("/3/Frames/", frame_id))$frames[[1]]
  vapply(f$columns, function(c) c$label, character(1))
}

h2o.getModel <- function(id) structure(list(model_id = id),
                                       class = "H2OModel")

h2o.performance <- function(model, newdata = NULL) {
  if (is.null(newdata)) {
    m <- .h2o.request("GET", paste0("/3/Models/", model$model_id))
    return(m$models[[1]]$training_metrics)
  }
  .h2o.request("POST", sprintf("/3/ModelMetrics/models/%s/frames/%s",
                               model$model_id,
                               newdata$frame_id))$model_metrics[[1]]
}

h2o.predict <- function(model, newdata, ...) {
  r <- .h2o.request("POST",
                    sprintf("/3/Predictions/models/%s/frames/%s",
                            model$model_id, newdata$frame_id), list(...))
  h2o.getFrame(r$predictions_frame$name)
}

h2o.predict_contributions <- function(model, newdata)
  h2o.predict(model, newdata, predict_contributions = "true")

h2o.downloadMOJO <- function(model, path) {
  url <- paste0(.h2o.url(), "/3/Models/", model$model_id, "/mojo")
  system2("curl", c("-s", "-o", shQuote(path), shQuote(url)))
  path
}

h2o.shutdown <- function() invisible(NULL)

h2o.automl <- function(x = NULL, y, training_frame, max_models = 10,
                       max_runtime_secs = 0, seed = -1) {
  if (inherits(training_frame, "H2OFrame"))
    training_frame <- training_frame$frame_id
  spec <- list(input_spec = list(training_frame = training_frame,
                                 response_column = y),
               build_control = list(stopping_criteria = list(
                 max_models = max_models,
                 max_runtime_secs = max_runtime_secs, seed = seed)))
  j <- .h2o.wait.job(.h2o.request("POST", "/99/AutoMLBuilder", spec))
  j
}
'''

_ALGO_FUN = '''
#' {title} (generated from /3/ModelBuilders[{algo}])
h2o.{rname} <- function(x = NULL, y, training_frame{arglist}) {{
  params <- list({paramlist})
  .h2o.train("{algo}", x, y, training_frame, params)
}}
'''

# reference h2o-r exposes snake algo names as h2o.gbm, h2o.randomForest...
_R_NAMES = {
    "drf": "randomForest", "deeplearning": "deeplearning",
    "isolationforest": "isolationForest",
    "extendedisolationforest": "extendedIsolationForest",
    "naivebayes": "naiveBayes", "upliftdrf": "upliftRandomForest",
    "targetencoder": "targetencoder",
    "isotonicregression": "isotonicRegression",
    "modelselection": "modelSelection",
}


def _r_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)
    return "NULL"   # lists/dicts default NULL client-side


def generate_r_package(outdir: str, builders: Dict[str, dict]) -> List[str]:
    """Emit the R package source; returns written file paths.

    builders: GET /3/ModelBuilders response's model_builders dict.
    """
    rdir = os.path.join(outdir, "R")
    os.makedirs(rdir, exist_ok=True)
    written = []

    p = os.path.join(outdir, "DESCRIPTION")
    with open(p, "w") as fh:
        fh.write("Package: h2o3tpu\nTitle: R Interface to h2o3-tpu\n"
                 "Version: 0.1.0\nImports: jsonlite, utils\n"
                 "Description: Generated REST client for the h2o3-tpu\n"
                 "  cluster (gen_R.py role of the reference h2o-r).\n"
                 "License: Apache-2.0\n")
    written.append(p)

    p = os.path.join(outdir, "NAMESPACE")
    exports = ["h2o.init", "h2o.importFile", "h2o.getFrame", "h2o.ls",
               "h2o.rapids", "h2o.colnames", "h2o.getModel",
               "h2o.performance", "h2o.predict",
               "h2o.predict_contributions", "h2o.downloadMOJO",
               "h2o.automl", "h2o.shutdown"]
    fun_names = []
    for algo in builders:
        fun_names.append(f"h2o.{_R_NAMES.get(algo, algo)}")
    with open(p, "w") as fh:
        for e in exports + sorted(fun_names):
            fh.write(f"export({e})\n")
        fh.write("S3method(as.data.frame, H2OFrame)\n")
    written.append(p)

    p = os.path.join(rdir, "h2o.R")
    with open(p, "w") as fh:
        fh.write(_CORE_R)
    written.append(p)

    for algo, info in sorted(builders.items()):
        rname = _R_NAMES.get(algo, algo)
        params = [q for q in info.get("parameters", [])
                  if q["name"] not in ("training_frame", "response_column",
                                       "ignored_columns")]
        args = "".join(
            f",\n                    {q['name']} = "
            f"{_r_literal(q.get('default_value'))}"
            for q in params)
        plist = ",\n    ".join(f"{q['name']} = {q['name']}" for q in params)
        src = _ALGO_FUN.format(title=f"Train a {algo} model", algo=algo,
                               rname=rname, arglist=args,
                               paramlist=plist or "")
        p = os.path.join(rdir, f"{rname}.R")
        with open(p, "w") as fh:
            fh.write(src)
        written.append(p)
    return written


def generate_from_live(outdir: str, url: str) -> List[str]:
    """Generate against a running server (the codegen build step)."""
    import urllib.request
    meta = json.loads(urllib.request.urlopen(
        f"{url}/3/ModelBuilders", timeout=60).read())
    return generate_r_package(outdir, meta["model_builders"])
