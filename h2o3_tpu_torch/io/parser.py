"""Ingest — files and text into a Frame, and a Frame out as CSV.

Reference: h2o3_tpu/io/parser.py (ImportFiles → ParseSetup.guessSetup →
ParseDataset.forkParseDataset, water/parser/ParseDataset.java:127,253,
with cloud-wide categorical interning, ParseDataset.java:356-440).
``import_file`` reads one path, a glob or a directory:

- ``.csv`` and ``.csv.gz`` through the native tokenizer (the reference's
  ``_parse_csv_native``): header sniffing, multi-file domain
  unification, ``na_strings`` by name or position, ``col_types`` and
  UUID detection;
- ``.svm``/``.svmlight`` (every file of a glob, concatenated), ``.arff``,
  ``.xlsx`` and ``.avro`` through the host readers of ``io/formats.py``;
  ``.xls`` raises the reference's ``ValueError``;

then ``Frame.from_numpy`` lands the columns on the card unless
``device`` says otherwise; ``destination_frame`` stores the frame in the
DKV under that key. ``lazy=True`` stores an unparsed ``io/lazy``
``FileBackedFrame`` stub instead, parsed at its key's first
``DKV.get``. ``parse_setup`` guesses a schema (a CSV from the
tokenizer's parse of a sample, the host formats by reading them),
``export_file`` writes a frame as the reference's CSV bytes (pandas'
``to_csv`` text) through ``io/persist.py``'s drivers (a local path,
``file://``, ``hex://``), and ``parse_raw`` parses CSV text through
the tokenizer.

Not ported: Parquet and ORC, which need pyarrow (ROADMAP A #5′ leaves
them out); the reference's pandas fallback (``.zip``, other suffixes,
multi-file CSVs whose files disagree on a column), which raises
``NotImplementedError`` naming ROADMAP A #5; ``export_file`` to
``s3://``, ``gs://`` or ``hdfs://``, which need pyarrow; telemetry and
the durability hooks, which wait for ``telemetry/`` and
``core/durability.py`` (A #13).
"""

from __future__ import annotations

import glob as _glob
import gzip
import os
import re as _re
from typing import Dict, List, Optional

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.io import chunking
from h2o3_tpu_torch.io import formats
from h2o3_tpu_torch.native import parse_csv_bytes
from h2o3_tpu_torch.parallel import device as dev_mod

_UUID_RX = _re.compile(
    r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
    r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$")

_CSV = (".csv", ".csv.gz")
_HOST = (".svm", ".svmlight", ".arff", ".xlsx", ".xls", ".avro")
_ARROW = (".parquet", ".pq", ".orc")


def _unported(what: str):
    raise NotImplementedError(
        f"{what} needs the reference's pandas fallback, which is not "
        "ported (ROADMAP A #5)")


def _arrow_unported(what: str):
    raise NotImplementedError(
        f"{what}: Parquet and ORC need pyarrow, which the port does not "
        "use; they stay out of it (ROADMAP A #5′)")


def _expand(path: str) -> List[str]:
    """The files of a path, a glob or a directory (sorted); raises
    ``FileNotFoundError`` when one is missing or none matches."""
    if os.path.isdir(path):
        paths = sorted(os.path.join(path, f) for f in os.listdir(path))
    elif any(ch in path for ch in "*?["):
        paths = sorted(_glob.glob(path))
    else:
        paths = [path]
    if not paths or not all(os.path.exists(f) for f in paths):
        raise FileNotFoundError(path)
    return paths


def _read_text(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def _type_name(col) -> str:
    """ParseSetup's type word for a column."""
    if col.is_categorical:
        return "categorical"
    return "string" if col.type == "string" else "numeric"


def _sample_records(path: str, n: int) -> bytes:
    """The first ``n`` records of a CSV file (a newline outside double
    quotes ends one), or all of it when it holds fewer."""
    buf = b""
    with (gzip.open(path, "rb") if path.endswith(".gz")
          else open(path, "rb")) as f:
        while True:
            blk = f.read(1 << 16)
            if not blk:
                return buf
            buf += blk
            a = np.frombuffer(buf, np.uint8)
            nl = np.flatnonzero(a == 0x0A)
            q = np.flatnonzero(a == 0x22)
            ends = nl[(np.searchsorted(q, nl) & 1) == 0]
            if ends.size >= n:
                return buf[:int(ends[n - 1]) + 1]


def parse_setup(path: str, nrows_sample: int = 1000,
                header: Optional[bool] = None) -> dict:
    """Schema guess (ParseSetup.guessSetup): ``{"columns", "types",
    "separator", "header"}``. A CSV's types are those the tokenizer
    gives its first ``nrows_sample`` rows; SVMLight, ARFF, XLSX and Avro
    run their real reader (on the CPU) and read the frame's types, as
    the reference does. A glob or directory guesses from its first
    file."""
    expanded = chunking.expand_paths(path)
    if expanded and os.path.exists(expanded[0]):
        path = expanded[0]
    if path.endswith(_ARROW):
        _arrow_unported(f"parse_setup of {os.path.basename(path)}")
    if path.endswith(_HOST):
        fr = import_file(path, device="cpu")
        cols = list(fr.names)
        return {"columns": cols,
                "types": {n: _type_name(fr.col(n)) for n in cols},
                "separator": ",", "header": True}
    if not path.endswith(_CSV):
        _unported(f"parse_setup of {os.path.basename(path)}")
    has_header = guess_header(path) if header is None else bool(header)
    sample = _sample_records(path, nrows_sample + int(has_header))
    cols, domains = parse_csv_bytes(sample, header=has_header, decode=False)
    types = {n: "categorical" if n in domains else "numeric" for n in cols}
    return {"columns": list(cols), "types": types, "separator": ",",
            "header": has_header}


def _csv_field(s: str, sep: str) -> str:
    """``s`` as the csv module's minimal quoting writes it."""
    if sep in s or '"' in s or "\n" in s or "\r" in s:
        return '"' + s.replace('"', '""') + '"'
    return s


def _csv_column(col, sep: str) -> List[str]:
    """One column's fields as the reference writes them (pandas
    ``to_csv`` of ``Frame.to_pandas``): a categorical's levels, a
    string column's strings, a numeric column's integers when every
    value is integral, finite and below 2^53, else the shortest
    round-trip text of each float; NA is the empty field."""
    n = col.nrows
    if col.is_categorical and col.domain:
        dom = [_csv_field(str(v), sep) for v in col.domain] + [""]
        codes = col.host_view()
        idx = np.where(np.isnan(codes), len(col.domain), codes)
        return [dom[i] for i in idx.astype(np.int64).tolist()]
    if col.type in ("string", "uuid"):
        return ["" if v is None else _csv_field(str(v), sep)
                for v in col.host_view()[:n]]
    v = col.host_view()
    na = np.isnan(v)
    if v.size and not na.any() and np.all(v == np.round(v)) and \
            np.max(np.abs(v), initial=0) < 2 ** 53:
        return list(map(str, v.astype(np.int64).tolist()))
    out = list(map(repr, v.tolist()))
    for i in np.flatnonzero(na).tolist():
        out[i] = ""
    return out


def _csv_text(frame: Frame, sep: str) -> bytes:
    """The frame as the reference's ``export_file`` writes it: a header
    of the column names, then one newline-terminated line a row."""
    fields = [_csv_column(frame.col(n), sep) for n in frame.names]
    lines = [sep.join(_csv_field(str(n), sep) for n in frame.names)]
    if len(fields) == 1:
        # the csv module quotes a record of one empty field
        lines += ['""' if f == "" else f for f in fields[0]]
    else:
        lines += list(map(sep.join, zip(*fields)))
    return ("\n".join(lines) + "\n").encode("utf-8")


def export_file(frame: Frame, path: str, force: bool = False,
                sep: str = ",") -> str:
    """Write ``frame`` as CSV (h2o.export_file → water/api ExportHandler)
    through ``io/persist.py``'s drivers: a local path, ``file://`` or
    ``hex://`` (published atomically); raises ``IOError`` if the target
    exists and ``force`` is False, and for the read-only ``http(s)://``;
    ``s3://``, ``gs://`` and ``hdfs://`` raise ``NotImplementedError``
    (they need pyarrow)."""
    from h2o3_tpu_torch.io.persist import persist_manager
    if not force and persist_manager.exists(path):
        raise IOError(f"{path} exists (use force=True)")
    persist_manager.write(path, _csv_text(frame, sep))
    return path


def parse_raw(text: str, destination_frame: Optional[str] = None,
              device: dev_mod.DeviceLike = None) -> Frame:
    """CSV text (its first line the header) through the native
    tokenizer into a Frame on ``device`` (the upload path)."""
    device = dev_mod.resolve_device(device)
    cols, domains = parse_csv_bytes(text.encode("utf-8"), header=True,
                                    decode=False)
    return Frame.from_numpy(cols, domains=domains, device=device,
                            key=destination_frame)


def _is_num_token(t: str) -> bool:
    try:
        float(t)
        return True
    except ValueError:
        return False


def guess_header(path: str) -> bool:
    """ParseSetup header guess (water/parser/CsvParser.java guess logic):
    a header exists when the first row is all-non-numeric while a later
    row has at least one numeric field."""
    if not path.endswith((".csv", ".csv.gz")):
        return True          # containers (zip/parquet) sniff elsewhere
    op = gzip.open if path.endswith(".gz") else open
    try:
        with op(path, "rt", errors="replace") as f:
            first = f.readline().strip().split(",")
            second = f.readline().strip().split(",")
    except OSError:
        return True
    if not second or second == [""]:
        return True

    def _unq(t: str) -> str:
        # quotes are field escaping, not content: a fully-quoted CSV
        # (h2o-py python-object uploads use QUOTE_ALL) must sniff
        # "42.4" as numeric or the header joins the data and every
        # column collapses to categorical
        t = t.strip()
        if len(t) >= 2 and t[0] == '"' and t[-1] == '"':
            return t[1:-1]
        return t
    first_numeric = any(_is_num_token(_unq(t)) for t in first if t != "")
    second_numeric = any(_is_num_token(_unq(t)) for t in second if t != "")
    return (not first_numeric) and second_numeric


def import_file(path: str, destination_frame: Optional[str] = None,
                col_types: Optional[Dict[str, str]] = None,
                header: Optional[bool] = None, lazy: bool = False,
                na_strings=None, device: dev_mod.DeviceLike = None):
    """h2o.import_file analogue (h2o-py/h2o/h2o.py:414): a file path,
    glob or directory parsed into a Frame on ``device`` (CUDA unless the
    caller names another), stored in the DKV under ``destination_frame``
    when one is given. With ``lazy=True`` nothing is parsed: a
    ``FileBackedFrame`` stub (column names and row count sniffed from a
    CSV's header and newlines) is stored under ``destination_frame`` (or
    a new key) and returned; the key's first ``DKV.get`` parses the
    files with these arguments and stores the Frame in its place."""
    device = dev_mod.resolve_device(device)
    paths = _expand(path)
    if any(f.endswith(_ARROW) for f in paths):
        _arrow_unported(f"importing {os.path.basename(paths[0])}")
    if lazy:
        return _import_lazy(path, paths, destination_frame, dict(
            col_types=col_types, header=header, na_strings=na_strings,
            device=device))
    key = destination_frame
    if all(f.endswith((".svm", ".svmlight")) for f in paths):
        text = "\n".join(_read_text(f) for f in paths)
        return formats.parse_svmlight(text, key=key, device=device)
    if len(paths) == 1 and paths[0].endswith(".arff"):
        return formats.parse_arff(_read_text(paths[0]), key=key,
                                  device=device)
    if len(paths) == 1 and paths[0].endswith(".xls"):
        raise ValueError("legacy BIFF .xls is not supported in this build "
                         "(no xlrd); save as .xlsx or .csv")
    if len(paths) == 1 and paths[0].endswith(".xlsx"):
        return formats.parse_xlsx(paths[0], key=key, device=device)
    if len(paths) == 1 and paths[0].endswith(".avro"):
        return formats.parse_avro(paths[0], key=key, device=device)
    if not all(f.endswith(_CSV) for f in paths):
        odd = sorted({os.path.basename(f) for f in paths
                      if not f.endswith(_CSV)})
        _unported(f"importing {odd[:3]}")
    if header is None:
        header = guess_header(paths[0])
    parsed = _parse_csv_native(paths, col_types, header=header,
                               na_strings=na_strings)
    if parsed is None:
        _unported("CSV files that disagree on a column's type or columns")
    cols, cats, domains = parsed
    # UUID detection (water/fvec C16Chunk / Vec.T_UUID): a "categorical"
    # whose levels are all uuid-shaped and nearly unique is re-typed as a
    # host-side uuid column
    uuid_cols = []
    forced = set(col_types or ())
    for name in list(cats):
        if name in forced:       # explicit user type wins
            continue
        dom = domains.get(name) or []
        n_ = len(cols[name])
        if dom and len(dom) > max(16, 0.8 * n_) and \
                all(_UUID_RX.match(v or "") for v in dom[:64]):
            lut = np.array(dom, dtype=object)
            codes = np.asarray(cols[name])
            vals = np.where(codes >= 0, lut[np.maximum(codes, 0)], None)
            cols[name] = vals.astype(object)
            cats.remove(name)
            domains.pop(name, None)
            uuid_cols.append(name)
    str_cols = [c for c, t in (col_types or {}).items()
                if t == "string" and c in cols
                and np.asarray(cols[c]).dtype == object]
    return Frame.from_numpy(cols, categorical=cats, domains=domains,
                            strings=str_cols, uuids=uuid_cols,
                            device=device, key=key)


def _import_lazy(source: str, paths: List[str], key: Optional[str],
                 parse_kwargs: dict):
    """Store and return the unparsed stub of ``import_file(lazy=True)``
    (the water/fvec FileVec role)."""
    from h2o3_tpu_torch.core.kv import DKV, make_key
    from h2o3_tpu_torch.io.lazy import FileBackedFrame, sniff_meta
    if len(paths) == 1:
        names, nrows, nbytes = sniff_meta(paths[0],
                                          header=parse_kwargs["header"])
    else:
        names, nrows = None, None
        nbytes = sum(os.path.getsize(f) for f in paths)
    key = key or make_key("frame")
    stub = FileBackedFrame(key, source, paths, names, nrows, nbytes,
                           parse_kwargs)
    DKV.put(key, stub)
    return stub


def _na_by_name(na_strings, names_in_order: List[str]) -> Dict[str, List[str]]:
    """Normalize na_strings — a name-keyed dict OR a positional
    list-of-lists in file column order (the ParseSetup naStrings wire
    shape, which stays correct even when the client renames columns at
    parse) — to a dict keyed by the PARSED column names."""
    if not na_strings:
        return {}
    if isinstance(na_strings, dict):
        return {k: list(v) for k, v in na_strings.items() if v}
    out = {}
    for i, lst in enumerate(na_strings):
        if lst and i < len(names_in_order):
            out[names_in_order[i]] = list(lst)
    return out


def _factorize_sorted(strs: np.ndarray):
    """(int32 codes, sorted levels) of an object array of strings with
    None for missing: codes in the order of the sorted distinct levels,
    -1 for None (what ``pandas.factorize(sort=True)`` gives)."""
    ok = np.array([v is not None for v in strs], dtype=bool)
    codes = np.full(len(strs), -1, np.int32)
    if not ok.any():
        return codes, []
    uniq, inv = np.unique(strs[ok].astype(str), return_inverse=True)
    codes[ok] = inv.astype(np.int32)
    return codes, [str(u) for u in uniq]


def _parse_csv_native(paths: List[str],
                      col_types: Optional[Dict[str, str]],
                      header: bool = True,
                      na_strings=None):
    """Multi-file native CSV parse; returns (cols, categorical names,
    domains) or None where the reference falls back to pandas (files
    that disagree on a column's type or columns). Gzip members are
    decompressed into the buffer (the tokenizer parses bytes, like the
    reference's ZipUtil front)."""
    all_cols: Dict[str, List[np.ndarray]] = {}
    all_doms: Dict[str, List[List[str]]] = {}
    for f in paths:
        with (gzip.open(f, "rb") if f.endswith(".gz") else open(f, "rb")) \
                as fh:
            data = fh.read()
        cols, domains = parse_csv_bytes(data, header=header, decode=False)
        for name, arr in cols.items():
            all_cols.setdefault(name, []).append(arr)
        for name, dom in domains.items():
            all_doms.setdefault(name, []).append(dom)

    # consistency across files: every file must agree on each column's
    # type (all-categorical or all-numeric) and supply every column —
    # type drift is pandas-concat territory, fall back
    nfiles = len(paths)
    for name, parts in all_cols.items():
        if len(parts) != nfiles:
            return None
        ndoms = len(all_doms.get(name, []))
        if ndoms not in (0, nfiles):
            return None

    merged: Dict[str, np.ndarray] = {}
    domains: Dict[str, List[str]] = {}
    for name, parts in all_cols.items():
        if name in all_doms:
            # multi-file categorical: unify domains and renumber codes
            # (the ParseDataset cloud-wide domain-unification role)
            doms = all_doms[name]
            global_dom = sorted(set().union(*[set(d) for d in doms]))
            lut = {lvl: i for i, lvl in enumerate(global_dom)}
            out_parts = []
            for codes, dom in zip(parts, doms):
                remap = np.asarray([lut[lvl] for lvl in dom] or [0],
                                   dtype=np.int32)
                c = np.where(codes >= 0, remap[np.maximum(codes, 0)], -1)
                out_parts.append(c.astype(np.int32))
            merged[name] = (out_parts[0] if len(out_parts) == 1
                            else np.concatenate(out_parts))
            domains[name] = global_dom
        else:
            merged[name] = parts[0] if len(parts) == 1 else np.concatenate(parts)

    # na_strings apply at parse, BEFORE type coercion and before quoted
    # "" becomes a string token (water/parser/ParseSetup naStrings):
    # matching levels of a sniffed-categorical column become NA (level
    # dropped, codes renumbered); a column left all-numeric afterwards
    # reverts to numeric exactly as the reference's post-NA inference
    # would have typed it.
    for c, nas in _na_by_name(na_strings, list(merged)).items():
        if c not in merged or not nas:
            continue
        nas_set = set(nas)
        if c in domains:
            dom = domains[c]
            keep = [lvl for lvl in dom if lvl not in nas_set]
            if len(keep) != len(dom):
                lut = {lvl: i for i, lvl in enumerate(keep)}
                remap = np.asarray([lut.get(lvl, -1) for lvl in dom] or [-1],
                                   dtype=np.int32)
                codes = merged[c]
                merged[c] = np.where(codes >= 0,
                                     remap[np.maximum(codes, 0)],
                                     -1).astype(np.int32)
                domains[c] = keep
                forced = (col_types or {}).get(c)
                if forced not in ("enum", "categorical", "string") and \
                        all(_is_num_token(lvl) for lvl in keep):
                    lutv = np.asarray([float(lvl) for lvl in keep] or [0.0])
                    codes = merged[c]
                    merged[c] = np.where(codes >= 0,
                                         lutv[np.maximum(codes, 0)], np.nan)
                    domains.pop(c)
        else:
            # numeric column: na tokens that parse numeric were already
            # folded into values — null them back out by VALUE. Known
            # divergence from the reference's token-level match
            # (na_strings=["1"] also nulls cells written "1.0"): the
            # raw tokens are gone after the native tokenizer, and
            # value-match is what "-999 means missing" users intend.
            vals = merged[c]
            for s in nas_set:
                try:
                    vals = np.where(vals == float(s), np.nan, vals)
                except ValueError:
                    pass
            merged[c] = vals

    # honor explicit client types (POST /3/ParseSetup column_types)
    for c, t in (col_types or {}).items():
        if c not in merged:
            continue
        if t in ("enum", "categorical") and c not in domains:
            vals = merged[c]
            strs = np.asarray(
                [None if (isinstance(v, float) and np.isnan(v)) else str(v)
                 for v in vals], dtype=object)
            codes, uniq = _factorize_sorted(strs)
            merged[c] = codes
            domains[c] = uniq
        elif t == "string" and c in domains:
            # client forced a string column the sniffer typed enum
            # (H2OFrame column_types={"D": "string"} — pyunit_isna)
            dom = domains.pop(c)
            lut = np.asarray([str(s) for s in dom], dtype=object)
            codes = merged[c]
            merged[c] = np.asarray(
                [lut[k] if k >= 0 else None for k in codes], dtype=object)
        elif t in ("numeric", "real", "int") and c in domains:
            dom = np.asarray(domains.pop(c))

            def _tonum(s):
                try:
                    return float(s)
                except (TypeError, ValueError):
                    return np.nan
            lut = np.asarray([_tonum(s) for s in dom])
            codes = merged[c]
            merged[c] = np.where(codes >= 0,
                                 lut[np.maximum(codes, 0)]
                                 if len(lut) else np.nan, np.nan)
    return merged, sorted(domains), domains
