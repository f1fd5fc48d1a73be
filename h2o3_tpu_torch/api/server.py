"""REST API server — the water.api surface of the port.

Reference: h2o3_tpu/api/server.py (water/api/RequestServer.java: the
route tree and dispatch; the versioned Schema wire contract; one handler
per endpoint). The same URI shapes and JSON field names that h2o-py,
h2o-r and Flow rely on, served by Python's threading HTTP server over
the port's DKV, jobs, frames and models. The web tier is control plane
only: frames and fits live on the server's device (``start_server(
device=)``, CUDA unless named; it raises without a card and never moves
to the CPU on its own), and responses carry keys and small previews.

Ported with it: ``AdmissionGate`` (the bounded in-flight gate, 503 +
Retry-After past its queue), the body cap (413), the request deadline
(``?_timeout_ms=`` / ``X-H2O-Deadline-Ms``, through the port's
``core/request_ctx``: a deadlined request that started a job waits for it
and cancels it at expiry, 408) and ``_json_sanitize``.

Not ported (ROADMAP A #13): the routes that read the telemetry, logging,
timeline, memory-governor, cleaner, durability and step-profiler layers
answer 501 with the H2OErrorV3 body naming ROADMAP A #13 (``OUT_OF_SCOPE``).
Inside the ported routes the fields those layers supply are left out —
``/3/Cloud``'s heartbeat, scheduler, memory-governor and cluster-summary
fields, ``/3/Frames/{id}``'s lineage, the fleet routing of predictions —
as are the trace headers, the REST metrics and the timeline records of
every request. A ``NotImplementedError`` (a parameter the port does not
take yet) answers 501 as well.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.core import config as _cfg
from h2o3_tpu_torch.core import request_ctx
from h2o3_tpu_torch.core.job import Job, list_jobs
from h2o3_tpu_torch.core.kv import DKV
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import all_algos, get_builder
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.parallel import device as dev_mod
from h2o3_tpu_torch.serving.batcher import BatcherDraining, QueueSaturated

log = logging.getLogger("h2o3_tpu_torch.api")

VERSION = "0.1.0"        # the reference's h2o3_tpu.version.__version__

ROUTES: List[Tuple[str, re.Pattern, Callable]] = []

# the device every frame a handler builds and every fit it starts uses
_DEVICE: Optional[torch.device] = None
_START_MS = 0


def _device() -> torch.device:
    if _DEVICE is None:
        raise RuntimeError("the REST server has not been started "
                           "(api/server.start_server)")
    return _DEVICE


def route(method: str, pattern: str):
    rx = re.compile("^" + pattern + "$")

    def deco(fn):
        ROUTES.append((method, rx, fn))
        return fn
    return deco


def _register_metadata_routes():
    from h2o3_tpu_torch.api import metadata
    metadata.register(route)


class RouteNotPorted(Exception):
    """A route, or a part of one, that reads a layer the port does not
    have yet: answered 501 with the H2OErrorV3 body."""


def _coerce(v: str) -> Any:
    """Form-value → python (the Schema fillFromParms coercion)."""
    if not isinstance(v, str):
        return v
    s = v.strip()
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    if s.lower() in ("null", "none", ""):
        return None
    if s.startswith("[") or s.startswith("{"):
        try:
            return json.loads(s.replace("'", '"'))
        except json.JSONDecodeError:
            pass
    try:
        f = float(s)
        return int(f) if f == int(f) and "." not in s and "e" not in s.lower() else f
    except ValueError:
        return s


def _unquote(s):
    """Strip the client-side quoted() wrapper (h2o-py sends frame ids and
    type names wrapped in literal double quotes)."""
    if isinstance(s, str) and len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1]
    return s


_WIRE_TYPES = {"numeric": "real", "categorical": "enum",
               "time": "time", "string": "string", "uuid": "uuid"}


def _col_json(fr: Frame, name: str, row_offset: int, rows: int,
              summ: Optional[dict] = None) -> dict:
    """ColV3 wire shape (water/api/schemas3/FrameV3.java ColV3).

    The real h2o-py pops __meta / domain_cardinality / string_data
    unconditionally (h2o-py/h2o/expr.py:381-385), so those keys are
    mandatory."""
    c = fr.col(name)
    lo, hi = row_offset, min(row_offset + rows, fr.nrows)
    wire_type = _WIRE_TYPES.get(c.type, c.type)
    data, string_data, domain = None, None, None
    if c.type in ("string", "uuid"):
        vals = c.host_view()[lo:hi]
        string_data = [None if v is None else str(v) for v in vals]
        data = []
    elif c.is_categorical:
        domain = list(c.domain or [])
        # host view: f64 codes with NaN at NA. NA cells ride as JSON NaN:
        # the client probes math.isnan(cell) before indexing the domain
        # (h2o-py/h2o/expr.py:416 _tabulate)
        codes = c.host_view()[lo:hi]
        data = [float("nan") if np.isnan(v) else int(v) for v in codes]
    else:
        vals = np.asarray(c.host_view()[lo:hi], np.float64)
        if wire_type == "real" and vals.size and \
                np.all(np.isnan(vals) | (vals == np.round(vals))) and \
                np.nanmax(np.abs(vals), initial=0) < 2**53:
            wire_type = "int"
        data = [float("nan") if np.isnan(v) else
                (int(v) if wire_type in ("int", "time") else float(v))
                for v in vals]
    s = (summ if summ is not None else fr.summary()).get(name, {})
    mean = s.get("mean")
    sigma = s.get("sigma")
    mins = [s.get("min")] if s.get("min") is not None else []
    maxs = [s.get("max")] if s.get("max") is not None else []
    return {
        "__meta": {"schema_version": 3, "schema_name": "ColV3",
                   "schema_type": "Vec"},
        "label": name, "type": wire_type,
        "missing_count": int(s.get("na_count", 0) or 0),
        "zero_count": int(s.get("zero_count", 0) or 0),
        "positive_infinity_count": 0, "negative_infinity_count": 0,
        "mins": [None if (isinstance(v, float) and np.isnan(v)) else v
                 for v in mins],
        "maxs": [None if (isinstance(v, float) and np.isnan(v)) else v
                 for v in maxs],
        "mean": None if mean is None or (isinstance(mean, float)
                                         and np.isnan(mean)) else mean,
        "sigma": None if sigma is None or (isinstance(sigma, float)
                                           and np.isnan(sigma)) else sigma,
        "persist_type": "HBM", "precision": -1,
        "domain": domain,
        "domain_cardinality": len(domain) if domain else 0,
        "data": data, "string_data": string_data,
        "histogram_bins": None, "histogram_base": 0,
        "histogram_stride": 0, "percentiles": None,
    }


def _frame_json(fr: Frame, rows: int = 10, row_offset: int = 0) -> dict:
    """FrameV3 wire shape (water/api/schemas3/FrameV3.java)."""
    rows = min(rows, fr.nrows)
    summ = fr.summary()
    cols = [_col_json(fr, n, row_offset, rows, summ) for n in fr.names]
    return {"__meta": {"schema_version": 3, "schema_name": "FrameV3",
                       "schema_type": "Frame"},
            "frame_id": {"name": fr.key, "type": "Key<Frame>",
                         "URL": f"/3/Frames/{fr.key}"},
            "byte_size": 0, "is_text": False,
            "row_offset": row_offset, "row_count": rows,
            "column_offset": 0, "column_count": fr.ncols,
            "full_column_count": fr.ncols, "total_column_count": fr.ncols,
            "checksum": 0,
            "rows": fr.nrows, "num_columns": fr.ncols,
            "default_percentiles": [0.001, 0.01, 0.1, 0.25, 0.333, 0.5,
                                    0.667, 0.75, 0.9, 0.99, 0.999],
            "column_names": fr.names,
            "columns": cols, "compatible_models": [],
            "chunk_summary": None, "distribution_summary": None}


def _model_dict(m: Model) -> dict:
    """The reference's ``Model.to_dict`` (the /3/Models list entry)."""
    def mt(x):
        return x.to_dict() if x is not None else None
    return {
        "model_id": m.key,
        "algo": m.algo,
        "params": {k: v for k, v in m.params.items()
                   if isinstance(v, (int, float, str, bool, list,
                                     type(None)))},
        "output": {k: v for k, v in m.output.items()
                   if isinstance(v, (int, float, str, bool, list, dict,
                                     type(None)))},
        "training_metrics": mt(m.training_metrics),
        "validation_metrics": mt(m.validation_metrics),
        "cross_validation_metrics": mt(m.cross_validation_metrics),
    }


def _get_frame(key, what: str = "frame") -> Frame:
    fr = DKV.get(str(key))
    if not isinstance(fr, Frame):
        raise KeyError(f"{what} {key} not found")
    return fr


def _get_model(key) -> Model:
    m = DKV.get(str(key))
    if not isinstance(m, Model):
        raise KeyError(f"model {key} not found")
    return m


# ------------------------------------------------------------- handlers


def _cloud_info() -> dict:
    dev = _device()
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    return {"version": VERSION, "cloud_name": _cfg.ARGS.name,
            "cloud_size": 1, "cloud_healthy": True, "devices": [name],
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "cloud_uptime_ms": int(time.time() * 1000) - _START_MS}


@route("GET", "/3/Cloud")
def _cloud(params, body):
    """Cluster status (water/api/CloudHandler, schemas3/CloudV3.java):
    one node, the server's device. Left out until their layers are
    ported (ROADMAP A #13): the heartbeat block and each node's
    heartbeat-based ``healthy``/``last_ping`` (the cloud is one process:
    healthy while it answers), the scheduler (``sched``) and cluster
    summary (``metrics_summary``) blocks, the memory governor's
    ``mem_value_size``/``free_mem``/``max_mem``/``swap_mem`` (on a card
    ``free_mem``/``max_mem`` are ``torch.cuda.mem_get_info``'s free and
    total bytes) and the roofline peaks ``gflops``/``mem_bw``."""
    info = _cloud_info()
    dev = _device()
    node = {
        "h2o": info["devices"][0], "ip_port": "127.0.0.1:54321",
        "healthy": True, "last_ping": int(time.time() * 1000),
        "pid": os.getpid(), "num_cpus": os.cpu_count(),
        "cpus_allowed": os.cpu_count(), "nthreads": os.cpu_count(),
        "sys_load": 0.0, "my_cpu_pct": 0, "sys_cpu_pct": 0,
        "pojo_mem": 0,
        "num_keys": len(list(DKV.keys())),
        "free_disk": 0, "max_disk": 0, "rpcs_active": 0,
        "fjthrds": [], "fjqueue": [], "tcps_active": 0,
        "open_fds": -1, "process_index": 0,
    }
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        node.update({"free_mem": int(free), "max_mem": int(total)})
    return {"__meta": {"schema_version": 3, "schema_name": "CloudV3",
                       "schema_type": "Iced"},
            "version": info["version"], "branch_name": "tpu-native",
            "last_commit_hash": "", "describe": "h2o3-tpu",
            "compiled_by": "h2o3-tpu", "compiled_on": "",
            "build_number": "0", "build_age": "0 days",
            "build_too_old": False, "node_idx": 0,
            "cloud_name": info["cloud_name"],
            "cloud_size": info["cloud_size"],
            "cloud_uptime_millis": info["cloud_uptime_ms"],
            "cloud_internal_timezone": "UTC",
            "datafile_parser_timezone": "UTC",
            "cloud_healthy": info["cloud_healthy"],
            "bad_nodes": 0,
            "consensus": info["cloud_healthy"],
            "locked": True, "is_client": False,
            "nodes": [node], "internal_security_enabled": False,
            "web_ip": "127.0.0.1"}


@route("GET", "/3/Ping")
def _ping(params, body):
    return {"status": "running"}


_SESSIONS: set = set()


@route("POST", "/4/sessions")
def _new_session(params, body):
    """Issue a Rapids session id (water/api/InitIDHandler)."""
    import uuid
    sid = "_sid_" + uuid.uuid4().hex[:12]
    _SESSIONS.add(sid)
    return {"__meta": {"schema_version": 4, "schema_name": "SessionIdV4",
                       "schema_type": "Iced"},
            "session_key": sid}


@route("POST", "/3/InitID")
def _init_id(params, body):
    import uuid
    sid = "_sid_" + uuid.uuid4().hex[:12]
    _SESSIONS.add(sid)
    return {"__meta": {"schema_version": 3, "schema_name": "InitIDV3",
                       "schema_type": "Iced"},
            "session_key": sid}


@route("DELETE", r"/4/sessions/(?P<sid>[^/]+)")
def _end_session(params, body, sid=None):
    _SESSIONS.discard(sid)
    return {"session_key": sid}


@route("GET", "/3/Capabilities")
def _capabilities(params, body):
    caps = [{"name": n} for n in
            ("AutoML", "Algos", "TargetEncoder", "TPU")]
    return {"capabilities": caps}


@route("GET", "/3/Capabilities/Core")
def _capabilities_core(params, body):
    return {"capabilities": [{"name": "TPU"}, {"name": "Algos"}]}


@route("GET", "/3/Capabilities/API")
def _capabilities_api(params, body):
    return {"capabilities": [{"name": "AutoML"},
                             {"name": "TargetEncoder"}]}


@route("GET", "/3/About")
def _about(params, body):
    info = _cloud_info()
    return {"entries": [{"name": "Build version", "value": info["version"]},
                        {"name": "Backend", "value": info["platform"]}]}


def _wire_list(src) -> List[str]:
    """Decode h2o-py's stringify_list wire format: '[a,b]' where items
    may or may not be individually double-quoted (shared_utils.py:171 —
    bare for paths, quoted() for frame ids)."""
    if isinstance(src, list):
        items = src
    else:
        s = str(src).strip()
        if s.startswith("[") and s.endswith("]"):
            s = s[1:-1]
        items = s.split(",") if s else []
    out = []
    for it in items:
        if isinstance(it, dict):
            it = it.get("name")
        out.append(_unquote(str(it).strip()))
    return out


def _wire_nested_list(src):
    """Decode stringify_list of a list-of-lists — the na_strings wire
    format: '[["NA","x"],[],[""]]' with each item quoted() by the client
    (h2o-py/h2o/h2o.py:925 builds it, shared_utils.py:171 stringifies).
    Returns a list of per-column string lists, or None if unparseable.
    A flat list (h2o-py list-form semantics: same tokens for EVERY
    column) returns [tokens] and the caller broadcasts; null/None per
    column means 'no NA strings for that column'."""
    def _norm(lst):
        if not isinstance(lst, list):
            return None
        if all(x is None or isinstance(x, str) for x in lst) and \
                not any(isinstance(x, list) for x in lst):
            flat = [_unquote(x) for x in lst if isinstance(x, str)]
            return [flat] if flat else None
        out = []
        for inner in lst:
            if inner is None:
                out.append([])
            elif isinstance(inner, list):
                out.append([_unquote(str(x)) for x in inner
                            if x is not None])
            else:
                out.append([_unquote(str(inner))])
        return out
    if isinstance(src, list):
        return _norm(src)
    s = str(src).strip()
    try:
        parsed = json.loads(s)
        if isinstance(parsed, list):
            return _norm(parsed)
    except ValueError:
        pass                      # stringify_list fallback below
    if not (s.startswith("[") and s.endswith("]")):
        return None
    s, out, i, n = s[1:-1], [], 0, len(s) - 2
    while i < n:
        if s[i] != "[":
            i += 1
            continue
        j, inq = i + 1, False
        while j < n and (inq or s[j] != "]"):
            if s[j] == '"':
                inq = not inq
            j += 1
        inner = s[i + 1:j]
        items, cur, inq = [], [], False
        for ch in inner:
            if ch == '"':
                inq = not inq
                cur.append(ch)
            elif ch == "," and not inq:
                items.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        if cur or items:
            items.append("".join(cur))
        out.append([_unquote(t.strip()) for t in items])
        i = j + 1
    return out


def _wire_map(s: str) -> dict:
    """Decode stringify_dict_as_map output: near-JSON where bare words
    (enum/string values like bernoulli) arrive unquoted
    (h2o-py/h2o/utils/shared_utils.py:167)."""
    s = s.replace("'", '"')
    # python-repr literals (h2o-py stringifies dicts with repr()) become
    # JSON booleans; quote guards confine the rewrite to BARE literals
    s = re.sub(r'(?<!")\bTrue\b(?!")', "true", s)
    s = re.sub(r'(?<!")\bFalse\b(?!")', "false", s)
    s = re.sub(r'(?<!")\bNone\b(?!")', "null", s)
    # quote bare identifiers that aren't JSON literals
    s = re.sub(
        r'(?<![\w"])(?!true\b|false\b|null\b)'
        r'([A-Za-z_][A-Za-z0-9_.\-]*)(?!["\w])(?=\s*[,\]\}])',
        r'"\1"', s)
    return json.loads(s)


def _src_list(params) -> List[str]:
    """source_frames / paths param → clean list of path strings."""
    src = params.get("source_frames") or params.get("paths") or \
        params.get("path")
    return _wire_list(src)


@route("POST", "/3/ImportFiles")
def _import_files(params, body):
    path = _unquote(params.get("path"))
    if not os.path.exists(path) and not any(c in path for c in "*?["):
        return {"files": [], "destination_frames": [], "fails": [path],
                "dels": []}
    return {"files": [path], "destination_frames": [path], "fails": [],
            "dels": []}


@route("POST", "/3/ImportFilesMulti")
def _import_files_multi(params, body):
    """Multi-path import (water/api/ImportFilesHandler) — the real
    h2o-py always goes through this (h2o-py/h2o/h2o.py:336)."""
    paths = _src_list(params)
    files, fails = [], []
    for p in paths:
        if os.path.exists(p) or any(c in p for c in "*?["):
            files.append(p)
        else:
            fails.append(p)
    return {"files": files, "destination_frames": files, "fails": fails,
            "dels": []}


# ParseSetupV3 column-type enum names (water/parser/ParseSetup)
_SETUP_TYPES = {"numeric": "Numeric", "categorical": "Enum",
                "string": "String", "time": "Time"}
_SETUP_TYPES_BACK = {"numeric": "numeric", "enum": "categorical",
                     "factor": "categorical", "categorical": "categorical",
                     "string": "string", "time": "time", "int": "numeric",
                     "real": "numeric", "float": "numeric",
                     "uuid": "string"}


@route("POST", "/3/ParseSetup")
def _parse_setup(params, body):
    from h2o3_tpu_torch.io.parser import parse_setup
    srcs = _src_list(params)
    ch = params.get("check_header")
    hint = None
    if ch is not None:
        ch = int(float(ch))
        hint = True if ch == 1 else (False if ch == -1 else None)
    setup = parse_setup(srcs[0], header=hint)
    dest = srcs[0].split("/")[-1]
    for ext in (".zip", ".gz", ".csv", ".parquet", ".pq", ".xlsx",
                ".arff", ".svm", ".svmlight"):
        if dest.endswith(ext):
            dest = dest[: -len(ext)]
    return {"__meta": {"schema_version": 3, "schema_name": "ParseSetupV3",
                       "schema_type": "ParseSetup"},
            "source_frames": [{"name": s} for s in srcs],
            "destination_frame": dest + ".hex",
            "parse_type": "CSV",
            "column_names": setup["columns"],
            "column_types": [_SETUP_TYPES.get(setup["types"][c], "Numeric")
                             for c in setup["columns"]],
            "na_strings": None,
            "warnings": [],
            "separator": ord(setup["separator"]),
            "single_quotes": False,
            "check_header": 1 if setup["header"] else 0,
            "number_columns": len(setup["columns"]),
            "chunk_size": 1 << 22,
            "parse_plan": _chunk_plan(srcs),
            "total_filtered_column_count": len(setup["columns"])}


def _chunk_plan(srcs) -> dict:
    """How the ingest pipeline runs over ``srcs`` (the reference's
    ``io/chunking.parse_plan``): the port's CSV path is the native
    tokenizer's chunk-parallel read (``io/stream.py``)."""
    from h2o3_tpu_torch.io import chunking
    expanded = chunking.expand_paths(srcs)
    fmts = sorted({chunking.classify_format(p) for p in expanded}) or ["csv"]
    w = chunking.resolve_workers(None)
    cb = chunking.resolve_chunk_bytes(None)
    total = sum(os.path.getsize(p) for p in expanded
                if os.path.exists(p))
    return {"mode": "sequential" if w == 1 else "chunk-parallel",
            "workers": w, "chunk_bytes": cb, "formats": fmts,
            "files": len(expanded), "source_bytes": total,
            "est_chunks": max(1, (total + cb - 1) // cb) if total else None}


def _concat_frames(parts: List[Frame], key: Optional[str]) -> Frame:
    """The per-file frames of a multi-file parse as one frame: numeric
    columns concatenated, categorical ones over the union of the files'
    levels (sorted, as one parse would intern them), string columns
    kept (the reference's ``pd.concat`` of their ``to_pandas``)."""
    from h2o3_tpu_torch.frame.frame import raw_columns
    first = parts[0]
    for p in parts[1:]:
        if p.names != first.names:
            raise ValueError("multi-file parse: the files' columns differ "
                             f"({first.names} vs {p.names})")
    arrays, cats, strs = {}, [], []
    for n in first.names:
        c = first.col(n)
        if c.is_categorical:
            arrays[n] = np.concatenate(
                [raw_columns(p, [n])[n] for p in parts])
            cats.append(n)
        elif c.type in ("string", "uuid"):
            arrays[n] = np.concatenate(
                [np.asarray(p.col(n).host_view(), object) for p in parts])
            strs.append(n)
        else:
            arrays[n] = np.concatenate([p.col(n).host_view()
                                        for p in parts])
    return Frame.from_numpy(arrays, categorical=cats, strings=strs,
                            device=_device(), key=key)


@route("POST", "/3/Parse")
def _parse(params, body):
    from h2o3_tpu_torch.io.parser import import_file
    srcs = _src_list(params)
    dest = _unquote(params.get("destination_frame")) or None
    names = _wire_list(params["column_names"]) \
        if params.get("column_names") else None
    types = _wire_list(params["column_types"]) \
        if params.get("column_types") else None
    col_types = None
    if types and names:
        # type names arrive in either ParseSetup casing ("Enum") or the
        # client's lowercase coltype vocabulary ("enum"); unknowns are
        # left to the parser's own guess rather than forced numeric
        col_types = {}
        for n, t in zip(names, types):
            mapped = _SETUP_TYPES_BACK.get(str(t).lower())
            if mapped:
                col_types[n] = mapped
    # na_strings: column-indexed list of lists, passed POSITIONALLY
    na_map = None
    if params.get("na_strings"):
        nested = _wire_nested_list(params["na_strings"])
        if nested and any(nested):
            if len(nested) == 1 and names and len(names) > 1:
                nested = nested * len(names)
            na_map = [lst or None for lst in nested]
    job = Job(f"parse {srcs[0]}", dest=dest, device=_device())

    ch = params.get("check_header")
    header = None
    if ch is not None:
        ch = int(float(ch))
        header = True if ch == 1 else (False if ch == -1 else None)
    device = _device()

    def _run(j):
        if len(srcs) == 1:
            fr = import_file(srcs[0], destination_frame=dest,
                             col_types=col_types, header=header,
                             na_strings=na_map, device=device)
            if names and len(names) == fr.ncols and \
                    list(names) != list(fr.names):
                fr = _renamed(fr, list(names), dest)
        else:
            parts = [import_file(s, col_types=col_types, header=header,
                                 na_strings=na_map, device=device)
                     for s in srcs]
            fr = _concat_frames(parts, dest)
        if fr.key is None:
            fr._keyed(dest or f"{os.path.basename(srcs[0])}.hex")
        j.update(1.0, "parsed")
        return fr

    job.start(_run, background=True)
    return {"job": job.to_dict(), "parse_plan": _chunk_plan(srcs)}


def _renamed(fr: Frame, names: List[str], key: Optional[str]) -> Frame:
    """``fr`` with its columns renamed in order (the reference's
    ``Frame.rename_columns``), under ``key``."""
    import dataclasses
    cols = [dataclasses.replace(fr.col(o), name=n)
            for o, n in zip(fr.names, names)]
    out = Frame(cols, fr.nrows, fr.device, npad=fr.nrows_padded,
                block=fr.block)
    if fr.key is not None:
        DKV.remove(fr.key)
    return out._keyed(key or fr.key)


@route("GET", "/3/Frames")
def _frames(params, body):
    out = []
    for k in DKV.keys():
        # get_raw: listing must NOT parse a lazy stub
        v = DKV.get_raw(k)
        if isinstance(v, Frame):
            out.append({"frame_id": {"name": k}, "rows": v.nrows,
                        "num_columns": v.ncols})
        elif getattr(v, "_is_lazy_stub", False):
            out.append({"frame_id": {"name": k},
                        "rows": getattr(v, "nrows", None) or 0,
                        "num_columns": len(getattr(v, "names", []) or [])})
    return {"frames": out}


@route("GET", r"/3/Frames/(?P<fid>[^/]+)/summary")
def _frame_summary(params, body, fid=None):
    fr = _get_frame(fid)
    summ = fr.summary()
    j = _frame_json(fr)
    for c in j["columns"]:
        s = summ.get(c["label"], {})
        c.update({k: (None if v is None or (isinstance(v, float) and np.isnan(v)) else v)
                  for k, v in s.items() if k in
                  ("min", "max", "mean", "sigma", "na_count", "zero_count",
                   "cardinality", "type")})
    return {"frames": [j]}


@route("GET", "/3/DownloadDataset")
def _download_dataset(params, body):
    """Frame → CSV stream (water/api/DownloadDataHandler): the bytes the
    port's ``export_file`` writes (the reference's own CSV)."""
    from h2o3_tpu_torch.io.parser import _csv_text
    fid = _unquote(params.get("frame_id"))
    fr = _get_frame(fid)
    return {"__bytes__": _csv_text(fr, ","), "__ctype__": "text/csv",
            "__headers__": {
                "Content-Disposition":
                    f'attachment; filename="{fid}.csv"'}}


@route("GET", r"/3/Frames/(?P<fid>[^/]+)/light")
def _frame_light(params, body, fid=None):
    return _frame_one(params, body, fid=fid)


@route("GET", r"/3/Frames/(?P<fid>[^/]+)")
def _frame_one(params, body, fid=None):
    """One frame's FrameV3 (its ``lineage`` waits for the durability
    layer, ROADMAP A #13)."""
    fr = _get_frame(fid)
    rows = int(float(params.get("row_count") or 10))
    if rows < 0:
        rows = fr.nrows
    offset = int(float(params.get("row_offset") or 0))
    return {"frames": [_frame_json(fr, rows=rows, row_offset=offset)]}


@route("DELETE", r"/3/Frames/(?P<fid>[^/]+)")
def _frame_del(params, body, fid=None):
    DKV.remove(fid)
    return {}


@route("DELETE", "/3/DKV")
def _dkv_del_all(params, body):
    """h2o.remove_all(): clear every key except retained models/frames;
    a retained MODEL also keeps its training/validation frames
    (water/api/RemoveAllHandler → DKVManager.retain model→frame). The
    freed device memory goes back to the card at once."""
    retained = set(_wire_list(params.get("retained_keys") or []))
    for k in list(retained):
        v = DKV.get_raw(k)
        if isinstance(v, Model):
            for fk in (v.output.get("training_frame"),
                       v.output.get("validation_frame")):
                if fk:
                    retained.add(str(fk))
    for k in list(DKV.keys()):
        if k not in retained:
            DKV.remove(k)
    from h2o3_tpu_torch.core.job import free_device_memory
    free_device_memory(_device())
    return {}


@route("DELETE", r"/3/DKV/(?P<key>[^/]+)")
def _dkv_del(params, body, key=None):
    DKV.remove(key)
    return {}


@route("POST", "/3/LogAndEcho")
def _log_and_echo(params, body):
    log.info("client: %s", params.get("message") or "")
    return {"message": params.get("message") or ""}


@route("GET", "/3/ModelBuilders")
def _builders(params, body):
    out = {}
    for algo in all_algos():
        cls = get_builder(algo)
        defaults = getattr(cls, "DEFAULTS", {})
        out[algo] = {"algo": algo, "algo_full_name": cls.__name__,
                     "parameters": [
                         {"name": k, "default_value": defaults.get(k),
                          "type": type(defaults.get(k)).__name__}
                         for k in sorted(cls.accepted_params())]}
    return {"model_builders": out}


@route("POST", r"/3/ModelBuilders/(?P<algo>[^/]+)")
def _train(params, body, algo=None):
    cls = get_builder(algo)
    p = {k: _coerce(v) for k, v in params.items()}
    frame_key = p.pop("training_frame", None)
    y = p.pop("response_column", None)
    valid_key = p.pop("validation_frame", None)
    model_id = p.pop("model_id", None)
    ignored = p.pop("ignored_columns", None)
    fr = _get_frame(frame_key, "training_frame")
    vf = DKV.get(str(valid_key)) if valid_key else None
    known = cls.accepted_params()
    builder_params = {k: v for k, v in p.items() if k in known}
    if ignored is not None:
        builder_params["ignored_columns"] = ignored
    builder = cls(**builder_params)
    # the one ModelBuilder.train lifecycle (CV dispatch, run_time)
    job = builder.train(fr, y=y, validation_frame=vf, background=True,
                        dest_key=model_id)
    # ModelBuilderSchema shape: job + validation messages
    # (h2o-py/h2o/estimators/estimator_base.py:190 reads "messages")
    return {"__meta": {"schema_version": 3,
                       "schema_name": "ModelBuilderSchema",
                       "schema_type": "ModelBuilder"},
            "job": job.to_dict(), "messages": [], "error_count": 0}


@route("GET", r"/3/Jobs/(?P<key>[^/]+)")
def _job(params, body, key=None):
    j = DKV.get(key)
    if not isinstance(j, Job):
        raise KeyError(f"job {key} not found")
    d = j.to_dict()
    # h2o-py expects job.status in {CREATED,RUNNING,DONE,FAILED,CANCELLED}
    if j.status == "DONE" and isinstance(j.result, Model):
        d["dest"] = {"name": j.result.key, "type": "Key<Model>"}
    return {"jobs": [d]}


@route("POST", r"/3/Jobs/(?P<key>[^/]+)/cancel")
def _job_cancel(params, body, key=None):
    j = DKV.get(key)
    if isinstance(j, Job):
        j.cancel()
    return {}


@route("GET", "/3/Jobs")
def _jobs(params, body):
    """Job list (water/api/JobsHandler); one process, so ``?cluster=1``
    is the local list."""
    return {"jobs": list_jobs()}


@route("GET", "/3/Models")
def _models(params, body):
    out = []
    for k in DKV.keys():
        v = DKV.get(k)
        if isinstance(v, Model):
            out.append(_model_dict(v))
    return {"models": out}


@route("GET", r"/3/Models/(?P<mid>[^/]+)")
def _model_one(params, body, mid=None):
    from h2o3_tpu_torch.api.model_schema import model_to_v3
    return {"models": [model_to_v3(_get_model(mid))]}


@route("DELETE", r"/3/Models/(?P<mid>[^/]+)")
def _model_del(params, body, mid=None):
    DKV.remove(mid)
    return {}


@route("POST", r"/3/Predictions/models/(?P<mid>[^/]+)/frames/(?P<fid>[^/]+)")
def _predict(params, body, mid=None, fid=None):
    """Bulk scoring of a frame into a predictions frame (the fleet's
    routing to a replica is ROADMAP A #13: the model must be here)."""
    m = _get_model(mid)
    fr = _get_frame(fid)
    dest = params.get("predictions_frame") or f"predictions_{mid}_{fid}"

    def _flag(name):
        return str(params.get(name, "")).lower() in ("1", "true", "yes")
    for flag, meth in (("leaf_node_assignment", "predict_leaf_node_assignment"),
                       ("predict_staged_proba", "staged_predict_proba"),
                       ("feature_frequencies", "feature_frequencies"),
                       ("predict_contributions", "predict_contributions")):
        if _flag(flag):
            fn = getattr(m, meth, None)
            if fn is None:
                raise ValueError(f"{flag} is not supported for "
                                 f"algo '{m.algo}'")
            preds = fn(fr)
            break
    else:
        preds = m.predict(fr)
    if preds.key is not None:
        DKV.remove(preds.key)
    preds._keyed(str(dest))
    # scoring computes metrics when the response is present (the
    # reference's BigScore fills a MetricBuilder during predict; the
    # client's multinomial confusion_matrix(data=...) reads
    # model_metrics[0].cm from THIS response)
    metrics_list = [{}]
    resp = m.output.get("response")
    if resp and resp in fr:
        from h2o3_tpu_torch.api.model_schema import metrics_v3
        metrics_list = [metrics_v3(m.model_performance(fr), m,
                                   frame_key=fr.key)]
    return {"predictions_frame": {"name": preds.key},
            "model_metrics": metrics_list}


@route("POST", r"/4/Predictions/models/(?P<mid>[^/]+)/frames/(?P<fid>[^/]+)")
def _predict_async(params, body, mid=None, fid=None):
    """Async bulk scoring (water/api/ModelMetricsHandler.predictAsync —
    returns a bare JobV3; the real h2o-py polls it then fetches
    job.dest as the predictions frame). The job scores the frame in one
    ``predict`` (the reference's chunked BigScore with a cancel point
    between chunks waits for ROADMAP A #13's job layer)."""
    m = _get_model(mid)
    fr = _get_frame(fid)
    dest = f"prediction_{mid}_on_{fid}"
    job = Job(f"predict {mid}", dest=dest, device=fr.device)

    def _run(j):
        request_ctx.cancel_point("predict")
        preds = m.predict(fr)._keyed(dest)
        j.update(1.0, "scored")
        return preds

    job.start(_run, background=True)
    return job.to_dict()


@route("POST", r"/3/Predictions/models/(?P<mid>[^/]+)")
def _predict_rows(params, body, mid=None):
    """Row-payload predict: inline JSON rows — no DKV frame round trip —
    scored through the serving engine's micro-batcher
    (``serving/engine.py``), bit-identical to ``Model.predict`` on the
    same rows. Body: ``{"rows": [{"col": value, ...}, ...]}``; missing
    keys are NAs. The fleet routing to replicas is ROADMAP A #13."""
    rows = params.get("rows")
    if isinstance(rows, str):
        try:
            rows = json.loads(rows)
        except json.JSONDecodeError as e:
            raise ValueError(f"malformed 'rows' JSON: {e}") from None
    if rows is None:
        raise ValueError("missing 'rows': POST a JSON body "
                         '{"rows": [{"col": value, ...}, ...]}')
    m = _get_model(mid)
    from h2o3_tpu_torch.serving import ServingUnsupported
    from h2o3_tpu_torch.serving.engine import engine
    try:
        out, domains, meta = engine.score_rows(m, rows, device=_device())
    except ServingUnsupported as e:
        raise ValueError(str(e)) from None
    preds = {}
    for name, arr in out.items():
        vals = arr.tolist()
        dom = domains.get(name)
        if dom is not None:
            # label the predict column with the training response domain
            vals = [dom[int(v)] if 0 <= int(v) < len(dom) else None
                    for v in vals]
        preds[name] = vals
    return {"model_id": mid, "rows_scored": len(rows),
            "predictions": preds, "batch": meta}


@route("GET", r"/3/Models/(?P<mid>[^/]+)/mojo")
def _model_mojo(params, body, mid=None):
    """Stream the MOJO zip (h2o-py download_mojo GET endpoint)."""
    from h2o3_tpu_torch.genmodel.export import mojo_artifacts
    from h2o3_tpu_torch.genmodel.mojo import mojo_bytes
    m = _get_model(mid)
    return {"__bytes__": mojo_bytes(*mojo_artifacts(m)),
            "__ctype__": "application/zip"}


@route("GET", r"/3/Models\.java/(?P<mid>[^/]+)")
def _model_pojo(params, body, mid=None):
    """Generated-source scorer download (water/api Models.java POJO
    endpoint). gbm/drf/glm return compilable Java implementing
    hex.genmodel.GenModel.score0 (hex/genmodel/GenModel.java:363);
    other algos ship the stdlib-Python scorer module."""
    m = _get_model(mid)
    if getattr(m, "algo", None) in ("gbm", "drf", "glm"):
        from h2o3_tpu_torch.genmodel.pojo_java import java_pojo_source
        src = java_pojo_source(m, class_name=str(mid))
        ctype = "text/x-java; charset=utf-8"
    else:
        from h2o3_tpu_torch.genmodel.pojo import pojo_source
        src = pojo_source(m, modname=str(mid))
        ctype = "text/plain; charset=utf-8"
    return {"__bytes__": src.encode(), "__ctype__": ctype}


@route("POST", r"/3/ModelMetrics/models/(?P<mid>[^/]+)/frames/(?P<fid>[^/]+)")
def _model_metrics(params, body, mid=None, fid=None):
    """Score a frame and return its metrics (water/api/ModelMetricsHandler
    — the model_performance(test_data) wire call)."""
    m = _get_model(mid)
    fr = _get_frame(fid)
    from h2o3_tpu_torch.api.model_schema import metrics_v3
    return {"model_metrics": [metrics_v3(m.model_performance(fr), m,
                                         frame_key=fid)]}


@route("POST", "/3/CreateFrame")
def _create_frame(params, body):
    """Synthetic frame generator (water/api/CreateFrameHandler →
    hex/createframe/): randomized numeric/categorical/integer/binary/
    time/string columns with missing values and optional response. The
    port has no time column type: a time column holds its epoch
    milliseconds as a numeric column."""
    p = {k: _coerce(v) for k, v in params.items()}
    dest = _unquote(str(p.get("dest") or p.get("destination_frame")
                        or "createframe.hex"))
    rows = int(p.get("rows") or 100)
    cols_n = int(p.get("cols") or 10)
    seed = int(p.get("seed") or -1)
    r = np.random.RandomState(seed & 0x7FFFFFFF if seed >= 0 else None)
    cat_f = float(p.get("categorical_fraction") or 0.0)
    int_f = float(p.get("integer_fraction") or 0.0)
    bin_f = float(p.get("binary_fraction") or 0.0)
    time_f = float(p.get("time_fraction") or 0.0)
    str_f = float(p.get("string_fraction") or 0.0)
    miss_f = float(p.get("missing_fraction") or 0.0)
    factors = int(p.get("factors") or 100)
    real_range = float(p.get("real_range") or 100.0)
    int_range = int(p.get("integer_range") or 100)
    bin_ones = float(p.get("binary_ones_fraction") or 0.02)
    counts = {
        "cat": int(round(cols_n * cat_f)),
        "int": int(round(cols_n * int_f)),
        "bin": int(round(cols_n * bin_f)),
        "time": int(round(cols_n * time_f)),
        "str": int(round(cols_n * str_f)),
    }
    counts["real"] = max(cols_n - sum(counts.values()), 0)
    device = _device()
    job = Job("create frame", dest=dest, device=device)

    def _run(j):
        arrays, cats, strs = {}, [], []
        ci = 0
        for kind, cnt in counts.items():
            for _ in range(cnt):
                name = f"C{ci + 1}"
                ci += 1
                if kind == "cat":
                    arrays[name] = np.array(
                        [f"c{ci}.l{v}" for v in
                         r.randint(0, max(factors, 1), rows)], object)
                    cats.append(name)
                elif kind == "int":
                    arrays[name] = r.randint(-int_range, int_range + 1,
                                             rows).astype(np.float64)
                elif kind == "bin":
                    arrays[name] = (r.rand(rows) < bin_ones
                                    ).astype(np.float64)
                elif kind == "time":
                    arrays[name] = r.randint(0, 2 ** 40,
                                             rows).astype(np.float64)
                elif kind == "str":
                    arrays[name] = np.array(
                        [f"s{v}" for v in r.randint(0, 10 ** 6, rows)],
                        object)
                    strs.append(name)
                else:
                    arrays[name] = r.uniform(-real_range, real_range, rows)
        if miss_f > 0:
            for name, arr in arrays.items():
                mask = r.rand(rows) < miss_f
                if name in strs or name in cats:
                    a = arr.astype(object)
                    a[mask] = None
                    arrays[name] = a
                else:
                    arr[mask] = np.nan
        if str(p.get("has_response", "")).lower() in ("1", "true"):
            rf = int(p.get("response_factors") or 2)
            if rf <= 1:
                arrays["response"] = r.randn(rows)
            else:
                arrays["response"] = np.array(
                    [f"resp.l{v}" for v in r.randint(0, rf, rows)], object)
                cats.append("response")
        fr = Frame.from_numpy(arrays, categorical=cats, strings=strs,
                              device=device, key=dest)
        j.update(1.0)
        return fr

    job.start(_run, background=True)
    return {"job": job.to_dict()}


def _cat_codes(c) -> np.ndarray:
    """A categorical column's int64 codes, -1 at NA."""
    h = c.host_view()
    return np.where(np.isnan(h), -1, h).astype(np.int64)


@route("POST", "/3/Interaction")
def _interaction_ep(params, body):
    """Categorical interaction features (water/api/InteractionHandler →
    hex/Interaction: pairwise or full combination of factor columns,
    capped at max_factors levels by occurrence)."""
    p = {k: _coerce(v) for k, v in params.items()}
    src = _get_frame(_unquote(str(p.get("source_frame"))))
    dest = _unquote(str(p.get("dest") or "interaction.hex"))
    factors = [_unquote(f) for f in _wire_list(p.get("factor_columns"))]
    pairwise = str(p.get("pairwise", "")).lower() in ("1", "true")
    max_factors = int(p.get("max_factors") or 100)
    min_occ = int(p.get("min_occurrence") or 1)
    job = Job("interaction", dest=dest, device=src.device)

    def _run(j):
        import itertools
        groups = (list(itertools.combinations(factors, 2)) if pairwise
                  else [tuple(factors)])
        arrays, cats = {}, []
        for grp in groups:
            name = "_".join(grp)
            labels = None
            for g in grp:
                c = src.col(g)
                cc = _cat_codes(c)
                lab = np.array([c.domain[v] if 0 <= v < len(c.domain)
                                else "NA" for v in cc], object)
                labels = lab if labels is None else \
                    np.char.add(np.char.add(labels.astype(str), "_"),
                                lab.astype(str))
            vals, cnts = np.unique(labels, return_counts=True)
            keep = vals[cnts >= min_occ]
            if len(keep) > max_factors:
                keep = vals[np.argsort(-cnts)][:max_factors]
            keep_set = set(keep.tolist())
            out = np.array([v if v in keep_set else "other"
                            for v in labels], object)
            arrays[name] = out
            cats.append(name)
        fr = Frame.from_numpy(arrays, categorical=cats, device=src.device,
                              key=dest)
        j.update(1.0)
        return fr

    job.start(_run, background=True)
    return {"job": job.to_dict()}


@route("POST", "/3/MissingInserter")
def _missing_inserter(params, body):
    """Insert missing values into a frame in place
    (water/api/MissingInserterHandler)."""
    p = {k: _coerce(v) for k, v in params.items()}
    key = _unquote(str(p.get("dataset")))
    fr = _get_frame(key)
    frac = float(p.get("fraction") or 0.0)
    seed = int(p.get("seed") or -1)
    job = Job("insert missing", dest=key, device=fr.device)

    def _run(j):
        r = np.random.RandomState(seed & 0x7FFFFFFF if seed >= 0 else None)
        arrays, cats, doms, strs = {}, [], {}, []
        for n in fr.names:
            c = fr.col(n)
            if c.type == "string":
                a = c.to_numpy().astype(object).copy()
                a[r.rand(fr.nrows) < frac] = None
                arrays[n] = a
                strs.append(n)
            elif c.is_categorical:
                codes = _cat_codes(c).astype(np.int32)
                codes[r.rand(fr.nrows) < frac] = -1
                arrays[n] = codes
                cats.append(n)
                doms[n] = c.domain
            else:
                a = c.to_numpy()
                a[r.rand(fr.nrows) < frac] = np.nan
                arrays[n] = a
        new = Frame.from_numpy(arrays, categorical=cats, domains=doms,
                               strings=strs, device=fr.device, key=key)
        j.update(1.0)
        return new

    job.start(_run, background=True)
    return job.to_dict()


@route("GET", r"/3/Typeahead/files")
def _typeahead(params, body):
    """File-path completion (water/api/TypeaheadHandler)."""
    import glob as _g
    src = _unquote(str(params.get("src") or ""))
    limit = int(float(params.get("limit") or 100))
    if os.path.isdir(src):
        pattern = os.path.join(src, "*")
    else:
        pattern = src + "*"
    matches = sorted(_g.glob(pattern))[:limit]
    return {"src": src, "limit": limit, "matches": matches}


@route("GET", "/3/NetworkTest")
def _network_test(params, body):
    """Reduce micro-bench (water/init/NetworkBench): times a 32 KB
    segment_sum on the server's device, between synchronizations — the
    one device's reduce path (the all-reduce across ranks is
    ``/3/SelfBench``'s ``psum_us``)."""
    from h2o3_tpu_torch.ops.segments import segment_sum
    dev = _device()
    x = torch.ones((8192, 1), dtype=torch.float32, device=dev)
    nid = torch.zeros((8192,), dtype=torch.int64, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    s = segment_sum(nid, x, n_nodes=1)
    float(s.sum())
    dt = time.perf_counter() - t0
    info = _cloud_info()
    return {"table": [{"op": "psum-32KB", "devices": 1,
                       "seconds": round(dt, 5)}],
            "nodes": info["devices"]}


@route("POST", "/3/PartialDependence")
def _pdp(params, body):
    """water/api/PartialDependenceHandler: grid sweep per feature."""
    m = _get_model(params.get("model_id"))
    fr = _get_frame(params.get("frame_id"))
    cols = _coerce(params.get("cols") or "[]")
    if isinstance(cols, str):
        cols = [cols]
    nbins = int(params.get("nbins") or 20)
    from h2o3_tpu_torch.ml.explain import partial_dependence
    return {"partial_dependence_data": partial_dependence(
        m, fr, cols or m.output.get("names", []), nbins=nbins)}


@route("POST", "/99/Rapids")
def _rapids_ep(params, body):
    """Rapids eval (water/api/RapidsHandler) on the server's device. The
    real h2o-py reads key/num_rows/num_cols for frames, scalar, string,
    map_keys/frames (h2o-py/h2o/expr.py:116-128); errors must be
    H2OErrorV3."""
    from h2o3_tpu_torch.rapids import rapids
    val = rapids(params.get("ast") or "", device=_device())
    if isinstance(val, Frame):
        return {"__meta": {"schema_version": 3,
                           "schema_name": "RapidsFrameV3",
                           "schema_type": "RapidsFrame"},
                "key": {"name": val.key},
                "num_rows": val.nrows, "num_cols": val.ncols,
                "frame": _frame_json(val, rows=5)}
    if isinstance(val, (bool, np.bool_)):
        return {"scalar": bool(val)}
    if isinstance(val, (int, float, np.generic)):
        return {"scalar": float(val)}
    if val is None:
        return {"scalar": None}
    if isinstance(val, (list, np.ndarray)):
        return {"scalar": [float(x) for x in np.asarray(val).ravel()]}
    return {"string": str(val)}


def _keep_models(models) -> None:
    """Store under its key each model a grid or an AutoML run made that
    the DKV does not hold: a fit inside another job stores nothing
    (``ModelBuilder.train``), and a REST client reads every model it is
    given by key."""
    for m in models:
        if DKV.get_raw(m.key) is not m:
            m._store(m.key)


@route("POST", r"/99/Grid/(?P<algo>[^/]+)")
def _grid_build(params, body, algo=None):
    """Grid search build (water/api/GridSearchHandler +
    hex/grid/GridSearch.java:70). The real h2o-py posts
    hyper_parameters as a stringified map and polls the returned job
    (h2o-py/h2o/grid/grid_search.py:414). Eligible shape buckets train
    batched (``parallel/model_batch.py``)."""
    from h2o3_tpu_torch.ml.grid import GridSearch
    cls = get_builder(algo)
    p = {k: _coerce(v) for k, v in params.items()}
    hyper = p.pop("hyper_parameters", None) or {}
    if isinstance(hyper, str):
        hyper = _wire_map(hyper)
    criteria = p.pop("search_criteria", None)
    if isinstance(criteria, str):
        criteria = _wire_map(criteria)
    frame_key = str(p.pop("training_frame", None))
    y = p.pop("response_column", None)
    valid_key = p.pop("validation_frame", None)
    grid_id = p.pop("grid_id", None)
    ignored = p.pop("ignored_columns", None)
    if isinstance(ignored, str):
        ignored = _wire_list(ignored)
    fr = _get_frame(frame_key, "training_frame")
    vf = DKV.get(str(valid_key)) if valid_key else None
    known = cls.accepted_params()
    fixed = {k: v for k, v in p.items() if k in known and k not in hyper}
    if ignored:
        fixed["ignored_columns"] = [_unquote(c) for c in ignored]
    gs = GridSearch(cls, hyper, search_criteria=criteria,
                    grid_id=grid_id, **fixed)
    job = Job(f"grid {algo}", dest=gs.grid_id, device=fr.device)

    def _run(j):
        grid = gs.train(fr, y=y, validation_frame=vf)
        _keep_models(grid.models)
        j.update(1.0, "grid done")
        return grid

    job.start(_run, background=True)
    return {"__meta": {"schema_version": 99,
                       "schema_name": "GridSearchSchema",
                       "schema_type": "GridSearch"},
            "job": job.to_dict(), "messages": [], "error_count": 0}


def _grid_json(grid, sort_by=None, decreasing=None):
    from h2o3_tpu_torch.api.model_schema import twodim
    metric = sort_by or grid.sort_metric
    models = grid.sorted_models(metric)
    if decreasing is not None and str(decreasing).lower() == "true":
        models = models[::-1]
    hyper_names = sorted({k for m in models
                          for k in (m.output.get("grid_params") or {})})
    rows = []
    for m in models:
        gp = m.output.get("grid_params") or {}
        mm_ = m.default_metrics
        val = None
        if mm_ is not None:
            d = mm_.to_dict()
            val = d.get(metric.upper() if metric.lower() == "auc"
                        else metric, d.get("MSE"))
            val = None if val is None else float(val)
        rows.append([str(gp.get(h)) for h in hyper_names] +
                    [m.key, val])
    summary = twodim(
        "Hyper-Parameter Search Summary",
        hyper_names + ["model_ids", metric],
        ["string"] * len(hyper_names) + ["string", "float64"], rows)
    return {
        "__meta": {"schema_version": 99, "schema_name": "GridSchemaV99",
                   "schema_type": "Grid"},
        "grid_id": {"name": grid.grid_id, "type": "Key<Grid>"},
        "model_ids": [{"name": m.key, "type": "Key<Model>"}
                      for m in models],
        "hyper_names": hyper_names,
        "failure_details": [f["error"] for f in grid.failures],
        "failure_stack_traces": [f.get("stacktrace", f["error"])
                                 for f in grid.failures],
        "failed_params": [f["params"] for f in grid.failures],
        "warning_details": [],
        "export_checkpoints_dir": None,
        "summary_table": summary,
    }


@route("GET", r"/99/Grids/(?P<gid>[^/]+)")
def _grid_get(params, body, gid=None):
    from h2o3_tpu_torch.ml.grid import Grid
    g = DKV.get(gid)
    if not isinstance(g, Grid):
        raise KeyError(f"grid {gid} not found")
    return _grid_json(g, sort_by=params.get("sort_by"),
                      decreasing=params.get("decreasing"))


@route("GET", "/99/Grids")
def _grids_list(params, body):
    from h2o3_tpu_torch.ml.grid import Grid
    out = []
    for k in list(DKV.keys()):
        g = DKV.get_raw(k)
        if isinstance(g, Grid):
            out.append({"name": g.grid_id, "type": "Key<Grid>"})
    return {"grids": out}


@route("GET", r"/99/Models/(?P<mid>[^/]+)")
def _model_one_v99(params, body, mid=None):
    return _model_one(params, body, mid=mid)


@route("POST", "/99/AutoMLBuilder")
def _automl(params, body):
    from h2o3_tpu_torch.automl import H2OAutoML
    p = {k: _coerce(v) for k, v in params.items()}
    # h2o-py ships nested specs (h2o-py/h2o/automl/_estimator.py):
    # build_control{project_name,nfolds,stopping_criteria{...}},
    # input_spec{training_frame,response_column}, build_models{*_algos}
    ctl = p.get("build_control") or {}
    if isinstance(ctl, str):
        ctl = json.loads(ctl)
    crit = ctl.get("stopping_criteria") or {}
    inp = p.get("input_spec") or {}
    if isinstance(inp, str):
        inp = json.loads(inp)
    bm = p.get("build_models") or {}
    if isinstance(bm, str):
        bm = json.loads(bm)
    frame_key = inp.get("training_frame") or p.get("training_frame")
    y = inp.get("response_column") or p.get("response_column")
    if isinstance(y, dict):
        y = y.get("column_name")
    fr = _get_frame(frame_key, "training_frame")
    ignored = inp.get("ignored_columns")
    x_cols = ([n for n in fr.names if n not in set(ignored) and n != y]
              if ignored else None)
    aml = H2OAutoML(
        max_models=int(crit.get("max_models") or p.get("max_models") or 0),
        max_runtime_secs=float(crit.get("max_runtime_secs")
                               or p.get("max_runtime_secs") or 3600),
        seed=int(crit.get("seed") or p.get("seed") or -1),
        nfolds=int(next(v for v in (ctl.get("nfolds"), p.get("nfolds"), 5)
                        if v is not None)),
        include_algos=bm.get("include_algos"),
        exclude_algos=bm.get("exclude_algos"),
        project_name=ctl.get("project_name") or p.get("project_name"))
    job = Job("automl", dest=aml.project_name, device=fr.device)

    def _run(j):
        aml.train(y=y, training_frame=fr, x=x_cols)
        _keep_models(aml.leaderboard.models)
        j.update(1.0, "done")
        DKV.put(f"leaderboard_{aml.project_name}_result", aml)
        return aml

    job.start(_run, background=True)
    return {"job": job.to_dict(), "project_name": aml.project_name,
            "build_control": {"project_name": aml.project_name}}


def _automl_tables(aml):
    """leaderboard_table + event_log_table TwoDimTables the real h2o-py
    parses into H2OFrames (h2o-py/h2o/automl/_base.py:333 _fetch_state)."""
    from h2o3_tpu_torch.api.model_schema import twodim
    rows = []
    tab = aml.leaderboard.as_table()
    metric_cols = [k for k in (tab[0].keys() if tab else [])
                   if k != "model_id"]
    if not metric_cols:
        # an empty leaderboard still carries the metric columns of its
        # sort metric (the client slices fr[1:] off the parsed table)
        sm = (getattr(aml.leaderboard, "sort_metric", None) or "auc").lower()
        if sm in ("auc", "logloss", "aucpr"):
            metric_cols = ["auc", "logloss", "aucpr",
                           "mean_per_class_error", "rmse", "mse"]
        elif sm == "mean_per_class_error":
            metric_cols = ["mean_per_class_error", "logloss", "rmse", "mse"]
        else:
            metric_cols = ["mean_residual_deviance", "rmse", "mse",
                           "mae", "rmsle"]
    for r in tab:
        rows.append([str(r.get("model_id"))] +
                    [r.get(k) for k in metric_cols])
    # col_types feed straight into H2OFrame(column_types=...), whose
    # vocabulary is "double"/"string" (h2o-py _fetch_table)
    lb_table = twodim(
        "Leaderboard", ["model_id"] + metric_cols,
        ["string"] + ["double"] * len(metric_cols), rows)
    ev_rows = [[str(e.get("timestamp", "")), "info",
                e.get("stage", ""), e.get("message", ""), "", ""]
               for e in getattr(aml, "event_log", [])]
    ev_table = twodim(
        "Event Log",
        ["timestamp", "level", "stage", "message", "name", "value"],
        ["string"] * 6, ev_rows)
    return lb_table, ev_table


def _automl_of(project: str):
    aml = DKV.get(f"leaderboard_{project}_result")
    if aml is None:
        raise KeyError(f"automl project {project} not found")
    return aml


@route("GET", r"/99/AutoML/(?P<project>[^/]+)")
def _automl_state(params, body, project=None):
    """AutoML state fetch (water/api + ai/h2o/automl AutoMLV99): the
    real client reads project_name, leaderboard.models,
    leaderboard_table and event_log_table."""
    aml = _automl_of(project)
    lb_table, ev_table = _automl_tables(aml)
    return {"project_name": aml.project_name,
            "leaderboard": {"models": [
                {"name": m.key, "type": "Key<Model>"}
                for m in aml.leaderboard.sorted_models()]},
            "leaderboard_table": lb_table,
            "event_log_table": ev_table,
            "training_info": {}}


@route("GET", r"/99/Leaderboards/(?P<project>[^/]+)")
def _leaderboard(params, body, project=None):
    aml = _automl_of(project)
    lb_table, _ = _automl_tables(aml)
    return {"project_name": project,
            "models": [{"name": m.key, "type": "Key<Model>"}
                       for m in aml.leaderboard.sorted_models()],
            "table": lb_table,
            "leaderboard_table": aml.leaderboard.as_table()}


@route("GET", r"/flow(/index\.html)?/?")
def _flow(params, body, **_):
    """The Flow notebook UI (h2o-web role) — served from the node at
    /flow/index.html like the reference."""
    from h2o3_tpu_torch.api.flow import FLOW_HTML
    return {"__html__": FLOW_HTML}


@route("GET", "/")
def _index(params, body):
    """Minimal landing page (the h2o-web Flow-serving role: the node
    itself answers a browser with a live cluster view)."""
    info = _cloud_info()
    frames = sum(1 for k in DKV.keys()
                 if isinstance(DKV.get_raw(k), Frame)
                 or getattr(DKV.get_raw(k), "_is_lazy_stub", False))
    models = sum(1 for k in DKV.keys()
                 if isinstance(DKV.get_raw(k), Model))
    html = f"""<!doctype html><html><head><title>h2o3-tpu</title></head>
<body style="font-family:monospace">
<h2>h2o3-tpu cloud '{info["cloud_name"]}'</h2>
<p>{info["cloud_size"]} device(s) on {info["platform"]} —
healthy: {info["cloud_healthy"]}</p>
<p>{frames} frame(s), {models} model(s),
{len(all_algos())} algorithms registered</p>
<p><a href="/flow/index.html"><b>Open Flow (notebook UI)</b></a></p>
<p>REST: <a href="/3/Cloud">/3/Cloud</a> ·
<a href="/3/Frames">/3/Frames</a> ·
<a href="/3/Models">/3/Models</a> ·
<a href="/3/ModelBuilders">/3/ModelBuilders</a> ·
<a href="/3/Jobs">/3/Jobs</a> ·
<a href="/3/SelfBench">/3/SelfBench</a></p>
</body></html>"""
    return {"__html__": html}


@route("GET", "/3/JStack")
def _jstack(params, body):
    """Thread stack dump (water/api/JStackHandler role)."""
    import sys
    import traceback
    frames = sys._current_frames()
    threads = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in frames.items():
        out.append({"thread": threads.get(tid, str(tid)),
                    "stack": traceback.format_stack(frame)})
    return {"traces": out}


@route("GET", "/3/SelfBench")
def _selfbench(params, body):
    """Node capability probes (water/init/{Linpack,MemoryBandwidth,
    NetworkBench} role) on the server's device."""
    from h2o3_tpu_torch.core.selfcheck import run_self_bench
    return run_self_bench(device=_device())


@route("POST", "/3/Shutdown")
def _shutdown(params, body):
    threading.Thread(target=lambda: _SERVER and _SERVER.shutdown(),
                     daemon=True).start()
    return {}


# Routes that read a layer the port does not have yet: each answers 501
# with the H2OErrorV3 body naming ROADMAP A #13 (the layer it waits for).
OUT_OF_SCOPE: List[Tuple[str, str, str]] = [
    ("GET", "/3/Cleaner", "core/cleaner"),
    ("GET", "/3/Metrics", "telemetry/"),
    ("GET", "/3/Alerts", "telemetry/slo"),
    ("GET", "/3/WaterMeterCpuTicks", "telemetry/"),
    ("GET", "/3/Timeline", "utils/timeline"),
    ("GET", "/3/Profiler", "telemetry/"),
    ("POST", "/3/Profiler/capture", "telemetry/"),
    ("GET", "/3/Logs", "utils/log"),
    ("GET", "/3/Logs/download", "utils/log"),
    ("GET", r"/3/Jobs/(?P<key>[^/]+)/trace", "telemetry/flight_recorder"),
    ("GET", r"/3/Jobs/(?P<key>[^/]+)/telemetry",
     "telemetry/flight_recorder"),
    ("GET", "/3/Trace", "telemetry/trace_export"),
    ("POST", "/3/CloudCheckpoint", "core/durability"),
    ("GET", r"/3/Models/(?P<mid>[^/]+)/profile", "telemetry/stepprof"),
]


def _not_ported(pattern: str, layer: str):
    where = re.sub(r"\(\?P<(\w+)>[^)]*\)", r"{\1}", pattern)

    def handler(params, body, **_):
        raise RouteNotPorted(
            f"{where} is not ported yet: it reads {layer}, which comes "
            "with ROADMAP A #13")
    handler.__name__ = "_not_ported_" + re.sub(r"\W+", "_", pattern)
    handler.__doc__ = f"Not ported: reads {layer} (ROADMAP A #13)."
    return handler


# ahead of the ported routes: /3/Jobs/{key}/trace and
# /3/Models/{id}/profile must not fall into /3/Jobs/{key} or
# /3/Models/{id}
for _m, _pat, _layer in OUT_OF_SCOPE:
    ROUTES.insert(0, (_m, re.compile("^" + _pat + "$"),
                      _not_ported(_pat, _layer)))


# ------------------------------------------------------------- plumbing


class AdmissionGate:
    """Bounded in-flight request gate (the reference's bounded Jetty
    pool role, water/api/RequestServer): at most ``max_inflight``
    requests execute handlers concurrently; up to ``queue_depth`` more
    wait for a slot (bounded by ``queue_wait_s`` or their own request
    deadline, whichever is sooner); everything past that fails fast
    with 503 + Retry-After so overload degrades into clean client
    retries instead of an unbounded handler-thread pile-up."""

    def __init__(self, max_inflight: int, queue_depth: int,
                 queue_wait_s: float):
        self.max_inflight = max(1, int(max_inflight))
        self.queue_depth = max(0, int(queue_depth))
        self.queue_wait_s = float(queue_wait_s)
        self._inflight = 0
        self._waiting = 0
        self._cond = threading.Condition()

    def enter(self, deadline: Optional[float] = None) -> bool:
        """True = admitted (caller MUST pair with leave()); False =
        saturated, answer 503."""
        with self._cond:
            if self._inflight < self.max_inflight:
                self._inflight += 1
                return True
            if self._waiting >= self.queue_depth:
                return False
            limit = time.monotonic() + self.queue_wait_s
            if deadline is not None:
                limit = min(limit, deadline)
            self._waiting += 1
            try:
                while self._inflight >= self.max_inflight:
                    left = limit - time.monotonic()
                    if left <= 0:
                        return False
                    self._cond.wait(left)
                self._inflight += 1
                return True
            finally:
                self._waiting -= 1

    def leave(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify()


def _gate_from_config() -> AdmissionGate:
    """The gate from ``core/config.ARGS`` with H2O3TPU_REST_* environment
    overrides on top (servers booted without init() honor the knobs)."""
    env = os.environ.get
    a = _cfg.ARGS
    return AdmissionGate(
        max_inflight=int(env("H2O3TPU_REST_MAX_INFLIGHT",
                             a.rest_max_inflight)),
        queue_depth=int(env("H2O3TPU_REST_QUEUE_DEPTH",
                            a.rest_queue_depth)),
        queue_wait_s=float(env("H2O3TPU_REST_QUEUE_WAIT_S",
                               a.rest_queue_wait_s)))


def _max_body_bytes() -> int:
    mb = int(os.environ.get("H2O3TPU_REST_MAX_BODY_MB",
                            _cfg.ARGS.rest_max_body_mb))
    return mb << 20


# health checks and job polling/cancel keep answering while the gate
# rejects work — an overloaded node that stops ping/poll responses looks
# dead to every client
_EXEMPT_PREFIXES = ("/3/Ping", "/3/Metrics", "/3/Jobs")


def _admission_exempt(path: str) -> bool:
    return any(path == p or path.startswith(p + "/")
               for p in _EXEMPT_PREFIXES)


_UPLOAD_CHUNK = 1 << 20      # /3/PostFile disk-streaming block


def _job_key_of(out) -> Optional[str]:
    """Job key inside a handler response: ModelBuilderSchema-style
    {"job": JobV3} or a bare JobV3 at the root."""
    if not isinstance(out, dict):
        return None
    jd = out.get("job")
    if isinstance(jd, dict) and isinstance(jd.get("key"), dict):
        return jd["key"].get("name")
    meta = out.get("__meta")
    if isinstance(meta, dict) and meta.get("schema_name") == "JobV3" \
            and isinstance(out.get("key"), dict):
        return out["key"].get("name")
    return None


def _await_job_deadline(out, deadline: float, path: str):
    """A deadlined request that spawned a background job blocks until
    the job finishes or the deadline passes. Expiry cancels the job —
    its cooperative checks stop it at the next boundary, the job ends
    CANCELLED, and the client gets 408 instead of a leaked RUNNING
    job."""
    jk = _job_key_of(out)
    if not jk:
        return out, 200
    j = DKV.get(jk)
    while isinstance(j, Job) and j.status in ("CREATED", "RUNNING"):
        if time.monotonic() >= deadline:
            j.cancel()
            j.join(5.0)      # grace: one boundary away
            err = _error_json(path, request_ctx.DeadlineExceeded(
                f"request deadline exceeded; job {jk} cancelled"), 408)
            err["values"] = {"job": jk,
                             "job_status": getattr(j, "status", "?")}
            return err, 408
        time.sleep(0.02)
        j = DKV.get(jk)
    if isinstance(j, Job):
        # finished inside the deadline: refresh the snapshot the client
        # sees (it was RUNNING when the handler returned)
        if isinstance(out.get("job"), dict):
            out["job"] = j.to_dict()
        elif _job_key_of(out) == jk and out.get("__meta", {}).get(
                "schema_name") == "JobV3":
            out = j.to_dict()
    return out, 200


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # route to our logger
        log.debug("http: " + fmt, *args)

    def _dispatch(self, method: str):
        try:
            self._dispatch_inner(method)
        except (BrokenPipeError, ConnectionResetError) as e:
            # the client hung up mid-request/mid-response — a normal
            # event under load, not a handler crash worth a traceback
            log.info("client disconnected on %s %s: %r",
                     method, self.path, e)
            self.close_connection = True

    _DRAIN_CAP = 8 << 20

    def _drain(self, length: int) -> bool:
        """Consume a modest unread request body so an early error
        response can be read reliably and the connection stays usable;
        oversized bodies are left unread (the caller then closes the
        connection instead of swallowing gigabytes)."""
        if length > self._DRAIN_CAP:
            return False
        left = length
        while left > 0:
            chunk = self.rfile.read(min(_UPLOAD_CHUNK, left))
            if not chunk:
                break
            left -= len(chunk)
        return True

    def _respond(self, code: int, out, extra_headers: Optional[dict] = None,
                 close: bool = False):
        if isinstance(out, dict) and "__bytes__" in out:
            payload = out["__bytes__"]
            ctype = out.get("__ctype__", "application/octet-stream")
            extra_headers = {**(out.get("__headers__") or {}),
                             **(extra_headers or {})}
        elif isinstance(out, dict) and "__html__" in out:
            payload = out["__html__"].encode()
            ctype = "text/html; charset=utf-8"
        else:
            payload = json.dumps(_json_sanitize(out),
                                 default=_json_default).encode()
            ctype = "application/json"
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        for hk, hv in (extra_headers or {}).items():
            self.send_header(hk, hv)
        if close:
            # the body was not (fully) read: the connection cannot be
            # reused — the leftover bytes would parse as a new request
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(payload)

    def _dispatch_inner(self, method: str):
        parsed = urllib.parse.urlparse(self.path)
        path = parsed.path
        params: Dict[str, str] = {
            k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}

        # -- request deadline (?_timeout_ms= / X-H2O-Deadline-Ms) ------
        deadline = None
        tmo = params.pop("_timeout_ms", None)
        if tmo is None:
            tmo = self.headers.get("X-H2O-Deadline-Ms")
        if tmo is not None:
            try:
                tmo_ms = float(tmo)
            except (TypeError, ValueError):
                return self._respond(400, _error_json(path, ValueError(
                    f"malformed deadline {tmo!r} "
                    f"(expected milliseconds)"), 400))
            if tmo_ms > 0:
                deadline = time.monotonic() + tmo_ms / 1000.0

        # -- Content-Length must be a clean non-negative integer -------
        raw_len = self.headers.get("Content-Length")
        try:
            length = int(raw_len) if raw_len else 0
            if length < 0:
                raise ValueError(raw_len)
        except (TypeError, ValueError):
            return self._respond(400, _error_json(path, ValueError(
                f"malformed Content-Length: {raw_len!r}"), 400),
                close=True)

        # -- admission control (exempt: ping/job polling) --------------
        exempt = _admission_exempt(path)
        if not exempt and not _GATE.enter(deadline=deadline):
            drained = self._drain(length)
            return self._respond(503, _error_json(path, RuntimeError(
                f"server saturated ({_GATE.max_inflight} in flight, "
                f"{_GATE.queue_depth} queued); retry later"), 503),
                extra_headers={"Retry-After": "1"}, close=not drained)
        try:
            self._handle(method, path, params, length, deadline)
        finally:
            if not exempt:
                _GATE.leave()

    def _post_file(self, path: str, length: int):
        """Raw file-body upload (h2o-py sends the file bytes as the
        request body, h2o-py/h2o/backend/connection.py:473) — streamed
        to disk in 1 MiB blocks so a multi-GB upload never buffers in
        handler memory."""
        import tempfile
        first = self.rfile.read(min(length, _UPLOAD_CHUNK)) \
            if length else b""
        # the client sends no filename: sniff the container format so
        # the extension-dispatching parser picks the right reader
        if first[:4] == b"PK\x03\x04":
            suffix = ".zip"
        elif first[:2] == b"\x1f\x8b":
            suffix = ".csv.gz"
        elif first[:4] == b"PAR1":
            suffix = ".parquet"
        else:
            suffix = ".csv"
        fd, tmp = tempfile.mkstemp(prefix="h2o3tpu_upload_",
                                   suffix=suffix)
        total = len(first)
        with open(fd, "wb") as f:
            f.write(first)
            while total < length:
                chunk = self.rfile.read(min(_UPLOAD_CHUNK,
                                            length - total))
                if not chunk:
                    break
                f.write(chunk)
                total += len(chunk)
        self._respond(200, {"destination_frame": tmp,
                            "total_bytes": total})

    def _handle(self, method: str, path: str, params: Dict[str, str],
                length: int, deadline: Optional[float]):
        if path.startswith("/3/PostFile"):
            return self._post_file(path, length)
        max_body = _max_body_bytes()
        if length > max_body:
            drained = self._drain(length)
            return self._respond(413, _error_json(path, ValueError(
                f"request body of {length} bytes exceeds the "
                f"{max_body >> 20} MB cap (H2O3TPU_REST_MAX_BODY_MB); "
                f"use /3/PostFile for large uploads"), 413),
                close=not drained)
        raw = self.rfile.read(length) if length else b""
        body = raw.decode("utf-8", "replace")
        ctype = self.headers.get("Content-Type", "")
        if "json" in ctype and body:
            try:
                params.update(json.loads(body))
            except json.JSONDecodeError as e:
                # a body the client MARKED as JSON but that does not
                # parse must fail loudly
                return self._respond(400, _error_json(path, ValueError(
                    f"malformed JSON body: {e}"), 400))
        elif body:
            params.update({k: v[0]
                           for k, v in urllib.parse.parse_qs(body).items()})
        # h2o-py style clients ship every parameter form-encoded in the
        # body: honor a _timeout_ms that arrived there too
        tmo = params.pop("_timeout_ms", None)
        if tmo is not None and deadline is None:
            try:
                tmo_ms = float(tmo)
            except (TypeError, ValueError):
                return self._respond(400, _error_json(path, ValueError(
                    f"malformed deadline {tmo!r} "
                    f"(expected milliseconds)"), 400))
            if tmo_ms > 0:
                deadline = time.monotonic() + tmo_ms / 1000.0
        for m, rx, fn in ROUTES:
            if m != method:
                continue
            match = rx.match(path)
            if match:
                try:
                    # the deadline rides a contextvar: any Job the
                    # handler creates captures it (core/job.py)
                    with request_ctx.deadline_scope(deadline):
                        out = fn(params, body, **match.groupdict())
                    code = 200
                except request_ctx.DeadlineExceeded as e:
                    out, code = _error_json(path, e, 408), 408
                except KeyError as e:
                    out, code = _error_json(path, e, 404), 404
                except (RouteNotPorted, NotImplementedError) as e:
                    out, code = _error_json(path, e, 501), 501
                except ValueError as e:
                    # user-input errors → 412 + H2OErrorV3, which the
                    # real h2o-py maps to H2OResponseError
                    # (water/api/RequestServer.java:371 error path)
                    log.warning("412 on %s %s: %s", method, path, e,
                                exc_info=True)
                    out, code = _error_json(path, e, 412), 412
                except (QueueSaturated, BatcherDraining) as e:
                    # a full per-model predict queue, or a serving tier
                    # shutting down: fail fast, retry later
                    out, code = _error_json(path, e, 503), 503
                except Exception as e:   # noqa: BLE001 - request boundary
                    log.exception("handler error on %s %s", method, path)
                    out, code = _error_json(path, e, 500), 500
                if code == 200 and deadline is not None:
                    out, code = _await_job_deadline(out, deadline, path)
                extra = {"Retry-After": "1"} if code == 503 else None
                return self._respond(code, out, extra_headers=extra)
        self._respond(404, {"msg": f"no route {method} {path}"})

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")


_GATE = _gate_from_config()


def _error_json(path: str, e: Exception, status: int) -> dict:
    """H2OErrorV3 wire shape (water/api/schemas3/H2OErrorV3.java) — the
    real h2o-py turns this into an H2OResponseError with .msg etc."""
    import traceback
    return {"__meta": {"schema_version": 3, "schema_name": "H2OErrorV3",
                       "schema_type": "H2OError"},
            "timestamp": int(time.time() * 1000),
            "error_url": path, "msg": str(e),
            "dev_msg": str(e), "http_status": status, "values": {},
            "exception_type": type(e).__name__,
            "exception_msg": str(e),
            "stacktrace": traceback.format_exc().splitlines()[-10:]}


def _json_default(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, float) and np.isnan(o):
        return None
    return str(o)


def _nan_str_list(vals):
    """ColV3 data cells: NaN→"NaN", ±inf→"Infinity"/"-Infinity"
    (AutoBuffer JSON_NAN/JSON_POS_INF strings)."""
    out = []
    for v in vals:
        if isinstance(v, np.generic):
            v = v.item()
        if isinstance(v, float):
            if np.isnan(v):
                v = "NaN"
            elif np.isinf(v):
                v = "Infinity" if v > 0 else "-Infinity"
        out.append(v)
    return out


def _json_sanitize(o):
    """Strict-JSON cleanup: NaN/Infinity become null everywhere EXCEPT
    ColV3 ``data`` arrays — there NA cells ride as the STRING "NaN",
    exactly the reference wire (AutoBuffer.putJSON8d emits the quoted
    JSON_NAN string, water/AutoBuffer.java:2006); h2o-py decodes
    'x == "NaN"' back to float nan (h2o-py/h2o/expr.py:392) before
    probing math.isnan (expr.py:416)."""
    if isinstance(o, dict):
        meta = o.get("__meta")
        if isinstance(meta, dict) and meta.get("schema_name") == "ColV3":
            return {k: (_nan_str_list(o[k]) if k == "data" and o[k]
                        else _json_sanitize(v))
                    for k, v in o.items()}
        return {k: _json_sanitize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_json_sanitize(v) for v in o]
    if isinstance(o, np.generic):
        o = o.item()
    if isinstance(o, float) and (np.isnan(o) or np.isinf(o)):
        return None
    return o


_SERVER: Optional[ThreadingHTTPServer] = None
_THREAD: Optional[threading.Thread] = None


def start_server(port: Optional[int] = None, background: bool = True,
                 device: dev_mod.DeviceLike = None) -> int:
    """Start the REST server (water.api.RequestServer.start) on
    ``device`` (CUDA unless named; raises without a card), at ``port``
    (``core/config.ARGS.port`` by default; 0 picks an ephemeral port),
    logging at ``ARGS.log_level``. Returns the bound port."""
    global _SERVER, _THREAD, _GATE, _DEVICE, _START_MS
    dev = dev_mod.resolve_device(device)
    log.setLevel(_cfg.ARGS.log_level)
    if port is None:
        port = _cfg.ARGS.port
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _DEVICE = dev
    _START_MS = int(time.time() * 1000)
    # rebuild the admission gate at boot: H2O3TPU_REST_* env knobs set
    # after import must take effect
    _GATE = _gate_from_config()
    _SERVER = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    actual = _SERVER.server_address[1]
    log.info("REST server on http://127.0.0.1:%d (/3, /99), device %s",
             actual, dev)
    if background:
        _THREAD = threading.Thread(target=_SERVER.serve_forever, daemon=True)
        _THREAD.start()
    else:
        _SERVER.serve_forever()
    return actual


def stop_server():
    global _SERVER
    if _SERVER is not None:
        _SERVER.shutdown()
        _SERVER.server_close()
        _SERVER = None


# schema-metadata endpoints live in api/metadata.py; register them into the
# same ROUTES table at import time
_register_metadata_routes()
