"""Compilable-Java POJO export for GBM / DRF / GLM.

The port's copy of h2o3_tpu/genmodel/pojo_java.py; the port imports nothing
of the reference package, so it keeps its own.

Reference contract: hex/Model.java toJava() emits a .java source file
whose class extends hex.genmodel.GenModel and implements
``public final double[] score0(double[] data, double[] preds)``
(hex/genmodel/GenModel.java:363) with every model constant embedded —
a zero-dependency scorer the user javac's against h2o-genmodel.jar.

The TPU-land model stores trees depth-major over BIN codes (one fused
array per forest, models/tree.py), so the generated Java embeds the
binning tables (edges / per-feature bin counts) plus the packed tree
arrays and scores in two steps exactly like in-cluster predict:
raw double[] -> bin codes -> depth-major walk.  Tree data is
initialized through numbered ``initT<k>()`` methods because javac puts
all static field initializers into one <clinit> whose bytecode must
stay under 64KB — the same reason the reference splits big forests
into per-tree nested classes.

No JVM ships in this image, so validation is the same two-sided scheme
as reference-MOJO (tests/test_reference_mojo.py): structural checks
that the source is javac-shaped, plus an INDEPENDENT re-reader
(``java_pojo_rescore``) that parses the emitted Java constants back
out of the source text and re-scores rows with its own walk,
cross-checked against in-cluster predictions.
"""

from __future__ import annotations

import json
import re
from typing import List

import numpy as np


def _jid(s: str) -> str:
    """Sanitize to a Java identifier (model keys contain '.', '-')."""
    out = re.sub(r"[^A-Za-z0-9_]", "_", str(s))
    return out if out and not out[0].isdigit() else "m_" + out


def _jd(x) -> str:
    """Java double literal (NaN / infinities spelled the Java way)."""
    v = float(x)
    if np.isnan(v):
        return "Double.NaN"
    if np.isinf(v):
        return ("Double.POSITIVE_INFINITY" if v > 0
                else "Double.NEGATIVE_INFINITY")
    return repr(v)


def _arr_i(vals) -> str:
    return "{" + ",".join(str(int(v)) for v in vals) + "}"


def _arr_d(vals) -> str:
    return "{" + ",".join(_jd(v) for v in vals) + "}"


def _arr_b(vals) -> str:
    return "{" + ",".join("true" if v else "false" for v in vals) + "}"


def _arr_s(vals) -> str:
    if vals is None:
        return "null"
    return "{" + ",".join(json.dumps(str(v)) for v in vals) + "}"


def _header(cls: str, algo: str, meta, arrays, supervised=True) -> List[str]:
    names = meta["names"]
    fdoms = meta["feature_domains"]
    resp_dom = meta.get("domain")
    cat = str(meta["category"])
    nclasses = int(meta.get("nclasses") or
                   (len(resp_dom) if resp_dom else 1))
    doms = [
        "    " + (_arr_s(d) if d is not None else "null") + ","
        for d in fdoms]
    doms.append("    " + _arr_s(resp_dom))
    L = [
        "/*",
        "  Generated by h2o3-tpu.  Standalone %s scorer." % algo,
        "  Compile: javac -cp h2o-genmodel.jar %s.java" % cls,
        "*/",
        "import hex.genmodel.GenModel;",
        "",
        "public class %s extends GenModel {" % cls,
        "",
        "  public static final String[] NAMES = new String[]"
        + _arr_s(names) + ";",
        "  public static final String[][] DOMAINS = new String[][]{",
        *doms,
        "  };",
        "",
        "  public %s() { super(NAMES, DOMAINS, %s); }" % (
            cls, json.dumps(str(meta.get("response_name", "response")))),
        "  public boolean isSupervised() { return %s; }"
        % ("true" if supervised else "false"),
        "  public int nfeatures() { return %d; }" % len(names),
        "  public int nclasses() { return %d; }" % nclasses,
        "  public hex.ModelCategory getModelCategory() "
        "{ return hex.ModelCategory.%s; }" % cat,
        "  public String getUUID() { return %s; }"
        % json.dumps(str(meta.get("uuid", "0"))),
        "",
    ]
    return L


def _tree_java(cls: str, algo: str, meta, arrays) -> str:
    names = meta["names"]
    cat = str(meta["category"])
    nclasses = int(meta.get("nclasses") or 1)
    B = int(meta["nbins_total"])
    feat = np.asarray(arrays["tree_feat"])          # [T, D, Lmax]
    thresh = np.asarray(arrays["tree_thresh"])
    na_left = np.asarray(arrays["tree_na_left"])
    is_split = np.asarray(arrays["tree_is_split"])
    leaf = np.asarray(arrays["tree_leaf"])          # [T, 2^D]
    cat_split = np.asarray(arrays["tree_cat_split"]) \
        if "tree_cat_split" in arrays else None
    words = np.asarray(arrays["tree_left_words"]) \
        if "tree_left_words" in arrays else None
    T, D, _ = feat.shape
    edges = arrays["edges"]
    nbins = np.asarray(arrays["nbins"]).astype(int)
    is_cat = np.asarray(arrays["is_cat"]).astype(bool)
    card = [len(d) if d else 1 for d in meta["feature_domains"]]

    L = _header(cls, algo, meta, arrays)
    L += [
        "  static final int NBINS_TOTAL = %d;" % B,
        "  static final int NTREES = %d;" % T,
        "  static final int DEPTH = %d;" % D,
        "  static final boolean[] IS_CAT = " + _arr_b(is_cat) + ";",
        "  static final int[] NBINS = " + _arr_i(nbins) + ";",
        "  static final int[] CARD = " + _arr_i(card) + ";",
        "  static final double[][] EDGES = new double[%d][];" % len(names),
        "  static final int[][][] TREE_FEAT = new int[NTREES][][];",
        "  static final int[][][] TREE_THRESH = new int[NTREES][][];",
        "  static final boolean[][][] TREE_NA_LEFT = "
        "new boolean[NTREES][][];",
        "  static final boolean[][][] TREE_IS_SPLIT = "
        "new boolean[NTREES][][];",
        "  static final double[][] TREE_LEAF = new double[NTREES][];",
    ]
    has_cat_nodes = cat_split is not None and bool(cat_split.any())
    if has_cat_nodes:
        W = words.shape[-1]
        L += [
            "  static final boolean[][][] TREE_CAT_SPLIT = "
            "new boolean[NTREES][][];",
            "  static final int[][][][] TREE_WORDS = "
            "new int[NTREES][][][];",
        ]
    # ---- chunked static init: one method per tree keeps every method
    # under javac's 64KB bytecode ceiling
    for t in range(T):
        L.append("  static void initT%d() {" % t)
        L.append("    TREE_FEAT[%d] = new int[][]{%s};" % (
            t, ",".join(_arr_i(row) for row in feat[t])))
        L.append("    TREE_THRESH[%d] = new int[][]{%s};" % (
            t, ",".join(_arr_i(row) for row in thresh[t])))
        L.append("    TREE_NA_LEFT[%d] = new boolean[][]{%s};" % (
            t, ",".join(_arr_b(row) for row in na_left[t])))
        L.append("    TREE_IS_SPLIT[%d] = new boolean[][]{%s};" % (
            t, ",".join(_arr_b(row) for row in is_split[t])))
        L.append("    TREE_LEAF[%d] = new double[]%s;" % (
            t, _arr_d(leaf[t])))
        if has_cat_nodes:
            L.append("    TREE_CAT_SPLIT[%d] = new boolean[][]{%s};" % (
                t, ",".join(_arr_b(row) for row in cat_split[t])))
            L.append("    TREE_WORDS[%d] = new int[][][]{%s};" % (
                t, ",".join(
                    "{" + ",".join(
                        _arr_i(words[t, d, l])
                        for l in range(words.shape[2])) + "}"
                    for d in range(D))))
        L.append("  }")
    L.append("  static void initEdges() {")
    for i, e in enumerate(edges):
        fin = [float(x) for x in np.asarray(e).ravel()
               if np.isfinite(x)]
        L.append("    EDGES[%d] = new double[]%s;" % (i, _arr_d(fin)))
    L.append("  }")
    L.append("  static {")
    L.append("    initEdges();")
    for t in range(T):
        L.append("    initT%d();" % t)
    L.append("  }")

    # ---- binning + walk (frame/binning.py and models/tree.py
    # semantics, restated in Java)
    L += [
        "",
        "  static int binOf(int i, double v) {",
        "    if (IS_CAT[i]) {",
        "      int code = Double.isNaN(v) ? -1 : (int) v;",
        "      if (code < 0 || code >= CARD[i]) return NBINS_TOTAL - 1;",
        "      if (NBINS[i] < CARD[i]) {",
        "        int per = (CARD[i] + NBINS[i] - 1) / NBINS[i];",
        "        return code / per;",
        "      }",
        "      return code;",
        "    }",
        "    if (Double.isNaN(v)) return NBINS_TOTAL - 1;",
        "    int b = 0;",
        "    double[] e = EDGES[i];",
        "    while (b < e.length && v >= e[b]) b++;",
        "    return b;",
        "  }",
        "",
        "  static double walk(int t, int[] bins) {",
        "    int nid = 0;",
        "    for (int d = 0; d < DEPTH; d++) {",
        "      boolean goLeft = true;",
        "      if (TREE_IS_SPLIT[t][d][nid]) {",
        "        int b = bins[TREE_FEAT[t][d][nid]];",
        "        if (b == NBINS_TOTAL - 1) {",
        "          goLeft = TREE_NA_LEFT[t][d][nid];",
    ]
    if has_cat_nodes:
        L += [
            "        } else if (TREE_CAT_SPLIT[t][d][nid]) {",
            "          goLeft = ((TREE_WORDS[t][d][nid][b >>> 5]"
            " >>> (b & 31)) & 1) == 1;",
        ]
    L += [
        "        } else {",
        "          goLeft = b <= TREE_THRESH[t][d][nid];",
        "        }",
        "      }",
        "      nid = 2 * nid + (goLeft ? 0 : 1);",
        "    }",
        "    return TREE_LEAF[t][nid];",
        "  }",
        "",
        "  public final double[] score0(double[] data, double[] preds) {",
        "    int[] bins = new int[NAMES.length];",
        "    for (int i = 0; i < NAMES.length; i++)"
        " bins[i] = binOf(i, data[i]);",
    ]
    if algo == "drf":
        if cat == "Regression":
            L += [
                "    double s = 0;",
                "    for (int t = 0; t < NTREES; t++) s += walk(t, bins);",
                "    preds[0] = s / NTREES;",
                "    return preds;",
            ]
        elif cat == "Binomial":
            L += [
                "    double s = 0;",
                "    for (int t = 0; t < NTREES; t++) s += walk(t, bins);",
                "    double p1 = Math.min(Math.max(s / NTREES, 0.0), 1.0);",
                "    preds[1] = 1.0 - p1; preds[2] = p1;",
                "    preds[0] = p1 >= %s ? 1 : 0;"
                % _jd(meta.get("default_threshold", 0.5)),
                "    return preds;",
            ]
        else:
            L += [
                "    int K = %d;" % nclasses,
                "    double[] votes = new double[K];",
                "    for (int t = 0; t < NTREES; t++)"
                " votes[t %% K] += walk(t, bins);",
                "    double s = 0;",
                "    for (int k = 0; k < K; k++) {",
                "      votes[k] = Math.min(Math.max("
                "votes[k] / (NTREES / K), 0.0), 1.0);",
                "      s += votes[k];",
                "    }",
                "    if (s == 0) s = 1;",
                "    int best = 0;",
                "    for (int k = 0; k < K; k++) {",
                "      preds[k + 1] = votes[k] / s;",
                "      if (preds[k + 1] > preds[best + 1]) best = k;",
                "    }",
                "    preds[0] = best;",
                "    return preds;",
            ]
    else:  # gbm
        if cat == "Multinomial":
            f0 = meta.get("f0") or [0.0] * nclasses
            L += [
                "    int K = %d;" % nclasses,
                "    double[] F0 = new double[]%s;" % _arr_d(f0),
                "    double[] z = new double[K];",
                "    for (int k = 0; k < K; k++) z[k] = F0[k];",
                "    for (int t = 0; t < NTREES; t++)"
                " z[t %% K] += walk(t, bins);",
                "    double mx = z[0];",
                "    for (int k = 1; k < K; k++)"
                " if (z[k] > mx) mx = z[k];",
                "    double s = 0;",
                "    for (int k = 0; k < K; k++)"
                " { z[k] = Math.exp(z[k] - mx); s += z[k]; }",
                "    int best = 0;",
                "    for (int k = 0; k < K; k++) {",
                "      preds[k + 1] = z[k] / s;",
                "      if (preds[k + 1] > preds[best + 1]) best = k;",
                "    }",
                "    preds[0] = best;",
                "    return preds;",
            ]
        else:
            f0 = float(meta.get("f0") or 0.0)
            L += [
                "    double marg = %s;" % _jd(f0),
                "    for (int t = 0; t < NTREES; t++)"
                " marg += walk(t, bins);",
            ]
            if cat == "Binomial":
                L += [
                    "    double p1 = 1.0 / (1.0 + Math.exp(-marg));",
                    "    preds[1] = 1.0 - p1; preds[2] = p1;",
                    "    preds[0] = p1 >= %s ? 1 : 0;"
                    % _jd(meta.get("default_threshold", 0.5)),
                    "    return preds;",
                ]
            elif meta.get("distribution") in ("poisson", "gamma",
                                              "tweedie"):
                L += ["    preds[0] = Math.exp(marg);",
                      "    return preds;"]
            else:
                L += ["    preds[0] = marg;", "    return preds;"]
    L += ["  }", "}", ""]
    return "\n".join(L)


def _glm_java(cls: str, meta, arrays) -> str:
    names = meta["names"]
    cat = str(meta["category"])
    fdoms = meta["feature_domains"]
    use_all = bool(meta.get("use_all_factor_levels", False))
    stdize = bool(meta.get("standardize", True))
    link = meta.get("link", "identity")
    multi = arrays.get("coef_multinomial")
    L = _header(cls, "glm", meta, arrays)
    L += [
        "  static final boolean USE_ALL_LEVELS = %s;"
        % ("true" if use_all else "false"),
        "  static final boolean STANDARDIZE = %s;"
        % ("true" if stdize else "false"),
        "  static final double[] NUM_MEANS = "
        + _arr_d(arrays["num_means"]) + ";",
        "  static final double[] NUM_SIGMAS = "
        + _arr_d(arrays["num_sigmas"]) + ";",
        "  static final int[] CARD = " + _arr_i(
            [len(d) if d else 0 for d in fdoms]) + ";",
    ]
    if multi is not None:
        CM = np.asarray(multi).T      # [K, n_coefs]
        L.append("  static final double[][] COEF_K = new double[][]{%s};"
                 % ",".join(_arr_d(row) for row in CM))
    else:
        L.append("  static final double[] COEF = "
                 + _arr_d(arrays["coef"]) + ";")
    L += [
        "",
        "  static double[] designRow(double[] data) {",
        "    int n = 0;",
        "    for (int i = 0; i < NAMES.length; i++)",
        "      n += CARD[i] > 0 ? (USE_ALL_LEVELS ? CARD[i]"
        " : CARD[i] - 1) : 1;",
        "    double[] xs = new double[n + 1];",
        "    int j = 0, ni = 0;",
        "    for (int i = 0; i < NAMES.length; i++) {",
        "      if (CARD[i] > 0) {",
        "        int code = Double.isNaN(data[i]) ? -1 : (int) data[i];",
        "        int first = USE_ALL_LEVELS ? 0 : 1;",
        "        for (int l = first; l < CARD[i]; l++)",
        "          xs[j++] = code == l ? 1.0 : 0.0;",
        "      } else {",
        "        double x = data[i];",
        "        double mu = NUM_MEANS[ni], sd = NUM_SIGMAS[ni];",
        "        ni++;",
        "        if (Double.isNaN(x)) x = mu;",
        "        if (STANDARDIZE) x = (x - mu) / (sd > 0 ? sd : 1.0);",
        "        xs[j++] = x;",
        "      }",
        "    }",
        "    xs[j] = 1.0;  // intercept",
        "    return xs;",
        "  }",
        "",
        "  static double linkInv(double eta) {",
    ]
    if link == "logit":
        L.append("    return 1.0 / (1.0 + Math.exp(-eta));")
    elif link in ("log", "tweedie"):
        L.append("    return Math.exp(eta);")
    elif link == "inverse":
        L.append("    return 1.0 / (Math.abs(eta) > 1e-12 ? eta"
                 " : 1e-12);")
    else:
        L.append("    return eta;")
    L += [
        "  }",
        "",
        "  public final double[] score0(double[] data, double[] preds) {",
        "    double[] xs = designRow(data);",
    ]
    if multi is not None:
        L += [
            "    int K = COEF_K.length;",
            "    double[] etas = new double[K];",
            "    for (int k = 0; k < K; k++)",
            "      for (int j = 0; j < xs.length; j++)"
            " etas[k] += xs[j] * COEF_K[k][j];",
            "    double mx = etas[0];",
            "    for (int k = 1; k < K; k++)"
            " if (etas[k] > mx) mx = etas[k];",
            "    double s = 0;",
            "    for (int k = 0; k < K; k++)"
            " { etas[k] = Math.exp(etas[k] - mx); s += etas[k]; }",
            "    int best = 0;",
            "    for (int k = 0; k < K; k++) {",
            "      preds[k + 1] = etas[k] / s;",
            "      if (preds[k + 1] > preds[best + 1]) best = k;",
            "    }",
            "    preds[0] = best;",
            "    return preds;",
        ]
    else:
        L += [
            "    double eta = 0;",
            "    for (int j = 0; j < xs.length; j++)"
            " eta += xs[j] * COEF[j];",
            "    double mu = linkInv(eta);",
        ]
        if cat == "Binomial":
            L += [
                "    preds[1] = 1.0 - mu; preds[2] = mu;",
                "    preds[0] = mu >= %s ? 1 : 0;"
                % _jd(meta.get("default_threshold", 0.5)),
                "    return preds;",
            ]
        else:
            L += ["    preds[0] = mu;", "    return preds;"]
    L += ["  }", "}", ""]
    return "\n".join(L)


def java_pojo_source(model, class_name: str = None) -> str:
    """Render compilable Java for a trained gbm/drf/glm model
    (hex/Model.java toJava role)."""
    from h2o3_tpu_torch.genmodel.export import mojo_artifacts
    meta, arrays = mojo_artifacts(model)
    algo = meta["algo"]
    cls = _jid(class_name or getattr(model, "key", "pojo_model"))
    if algo in ("gbm", "drf"):
        return _tree_java(cls, algo, meta, arrays)
    if algo == "glm":
        return _glm_java(cls, meta, arrays)
    raise ValueError(
        f"Java POJO export covers gbm/drf/glm; '{algo}' ships the "
        "stdlib-Python POJO (pojo.py) and MOJO instead")


# --------------------------------------------------------------------
# Independent re-reader: parse the EMITTED JAVA SOURCE back into
# arrays and score with a separate numpy walk — the same two-sided
# validation used for reference-MOJO bytes.

def _grab(src: str, decl: str) -> str:
    i = src.index(decl)
    j = src.index(";", i)
    return src[i + len(decl):j].strip()


def _parse_nums(text: str):
    """All numeric literals (Java spellings) in order."""
    toks = re.findall(
        r"Double\.NaN|Double\.POSITIVE_INFINITY|"
        r"Double\.NEGATIVE_INFINITY|true|false|-?\d+\.?\d*(?:[eE]-?\d+)?",
        text)
    out = []
    for t in toks:
        if t == "Double.NaN":
            out.append(np.nan)
        elif t == "Double.POSITIVE_INFINITY":
            out.append(np.inf)
        elif t == "Double.NEGATIVE_INFINITY":
            out.append(-np.inf)
        elif t == "true":
            out.append(1.0)
        elif t == "false":
            out.append(0.0)
        else:
            out.append(float(t))
    return out


def _parse_2d(text: str):
    """'{{1,2},{3,4}}' -> list of rows of floats."""
    rows = re.findall(r"\{([^{}]*)\}", text)
    return [_parse_nums(r) for r in rows]


class JavaPojoScorer:
    """Re-reads the generated .java source (constants only — no JVM)
    and scores rows with an independent numpy implementation."""

    def __init__(self, src: str):
        self.src = src
        self.names = json.loads(
            "[" + _grab(src, "String[] NAMES = new String[]")
            .strip("{}") + "]") if '"' in _grab(
                src, "String[] NAMES = new String[]") else []
        self.is_tree = "TREE_FEAT" in src
        if self.is_tree:
            self.B = int(_grab(src, "int NBINS_TOTAL ="))
            self.T = int(_grab(src, "int NTREES ="))
            self.D = int(_grab(src, "int DEPTH ="))
            self.is_cat = np.array(
                _parse_nums(_grab(src, "boolean[] IS_CAT =")), bool)
            self.nbins = np.array(
                _parse_nums(_grab(src, "int[] NBINS =")), int)
            self.card = np.array(
                _parse_nums(_grab(src, "int[] CARD =")), int)
            self.edges = {}
            for m in re.finditer(
                    r"EDGES\[(\d+)\] = new double\[\]\{([^}]*)\};", src):
                self.edges[int(m.group(1))] = _parse_nums(m.group(2))
            self.feat, self.thresh, self.nal, self.isp = {}, {}, {}, {}
            self.leaf, self.catsp, self.words = {}, {}, {}
            for nm, store in (("TREE_FEAT", self.feat),
                              ("TREE_THRESH", self.thresh),
                              ("TREE_NA_LEFT", self.nal),
                              ("TREE_IS_SPLIT", self.isp),
                              ("TREE_CAT_SPLIT", self.catsp)):
                for m in re.finditer(
                        re.escape(nm) +
                        r"\[(\d+)\] = new (?:int|boolean)\[\]\[\]\{(.*?)\};",
                        src):
                    store[int(m.group(1))] = _parse_2d(m.group(2))
            for m in re.finditer(
                    r"TREE_LEAF\[(\d+)\] = new double\[\]\{([^}]*)\};",
                    src):
                self.leaf[int(m.group(1))] = _parse_nums(m.group(2))
            for m in re.finditer(
                    r"TREE_WORDS\[(\d+)\] = new int\[\]\[\]\[\]\{(.*?)\};",
                    src):
                t = int(m.group(1))
                per_d = re.findall(r"\{((?:\{[^{}]*\},?)+)\}",
                                   m.group(2))
                self.words[t] = [_parse_2d("{" + d + "}") for d in per_d]
        else:
            self.card = np.array(
                _parse_nums(_grab(src, "int[] CARD =")), int)
            self.mu = _parse_nums(_grab(src, "double[] NUM_MEANS ="))
            self.sd = _parse_nums(_grab(src, "double[] NUM_SIGMAS ="))
            self.use_all = "USE_ALL_LEVELS = true" in src
            self.stdize = "STANDARDIZE = true" in src
            if "COEF_K" in src:
                self.coef_k = _parse_2d(_grab(
                    src, "double[][] COEF_K = new double[][]"))
                self.coef = None
            else:
                self.coef = _parse_nums(_grab(src, "double[] COEF ="))
                self.coef_k = None

    # -- tree scoring ------------------------------------------------
    def _bin(self, i, v):
        if self.is_cat[i]:
            code = -1 if np.isnan(v) else int(v)
            if code < 0 or code >= self.card[i]:
                return self.B - 1
            if self.nbins[i] < self.card[i]:
                per = -(-self.card[i] // self.nbins[i])
                return code // per
            return code
        if np.isnan(v):
            return self.B - 1
        e = self.edges.get(i, [])
        b = 0
        while b < len(e) and v >= e[b]:
            b += 1
        return b

    def _walk(self, t, bins):
        nid = 0
        for d in range(self.D):
            go_left = True
            if self.isp[t][d][nid]:
                b = bins[int(self.feat[t][d][nid])]
                if b == self.B - 1:
                    go_left = bool(self.nal[t][d][nid])
                elif t in self.catsp and self.catsp[t][d][nid]:
                    w = self.words[t][d][nid]
                    go_left = bool((int(w[b >> 5]) >> (b & 31)) & 1)
                else:
                    go_left = b <= self.thresh[t][d][nid]
            nid = 2 * nid + (0 if go_left else 1)
        return self.leaf[t][nid]

    def margins(self, data):
        bins = [self._bin(i, float(v)) for i, v in enumerate(data)]
        return [self._walk(t, bins) for t in range(self.T)]

    # -- glm scoring -------------------------------------------------
    def design_row(self, data):
        xs, ni = [], 0
        for i, c in enumerate(self.card):
            if c > 0:
                code = -1 if np.isnan(data[i]) else int(data[i])
                first = 0 if self.use_all else 1
                xs.extend(1.0 if code == l else 0.0
                          for l in range(first, c))
            else:
                x = float(data[i])
                mu, sd = self.mu[ni], self.sd[ni]
                ni += 1
                if np.isnan(x):
                    x = mu
                if self.stdize:
                    x = (x - mu) / (sd if sd > 0 else 1.0)
                xs.append(x)
        xs.append(1.0)
        return xs

    def glm_eta(self, data):
        xs = self.design_row(data)
        if self.coef_k is not None:
            return [float(np.dot(xs, ck)) for ck in self.coef_k]
        return float(np.dot(xs, self.coef))


def check_java_shape(src: str, cls: str = None) -> List[str]:
    """Structural javac-shape checks; returns a list of problems
    (empty = passes)."""
    probs = []
    if src.count("{") != src.count("}"):
        probs.append("unbalanced braces")
    if not re.search(r"public class \w+ extends GenModel", src):
        probs.append("missing 'class ... extends GenModel'")
    if "public final double[] score0(double[] data, double[] preds)" \
            not in src:
        probs.append("missing GenModel.score0 signature")
    if "import hex.genmodel.GenModel;" not in src:
        probs.append("missing GenModel import")
    for bad in ("def ", "None", "elif", "self."):
        if bad in src:
            probs.append(f"python token {bad!r} leaked into Java")
    if cls and ("public class %s " % cls) not in src:
        probs.append(f"class name != {cls}")
    # every static method must stay plausibly under javac's 64KB
    # bytecode ceiling; ~60KB of source per init method is a safe proxy
    for m in re.finditer(r"static void (initT\d+|initEdges)\(\) \{", src):
        j = src.index("}", m.end())
        if j - m.end() > 260_000:
            probs.append(f"{m.group(1)} likely exceeds 64KB bytecode")
    return probs
