"""Ingest — CSV files into a Frame, through the native tokenizer.

Reference: h2o3_tpu/io/parser.py (ImportFiles → ParseSetup.guessSetup →
ParseDataset.forkParseDataset, water/parser/ParseDataset.java:127,253,
with cloud-wide categorical interning, ParseDataset.java:356-440). The
port takes the reference's native-tokenizer CSV path
(``_parse_csv_native``: ``.csv`` and ``.csv.gz`` files, one path, a
glob or a directory): header sniffing, multi-file domain unification,
``na_strings`` by name or position, ``col_types`` and UUID detection,
then ``Frame.from_numpy`` on the card unless ``device`` says otherwise.

Not ported yet (each raises ``NotImplementedError`` naming the ROADMAP
item it waits for): the pandas fallback and the formats that go through
it or through Arrow (``.zip``, Parquet, ORC, Avro, XLSX, ARFF,
SVMLight, multi-file CSVs whose files disagree on a column), and
``parse_setup``, ``export_file`` and ``parse_raw``, which use pandas
(ROADMAP A #5); ``lazy=True`` and ``destination_frame`` need the DKV
(A #9). Telemetry and the durability hooks wait with ``telemetry/`` and
``core/durability.py`` (A #13).
"""

from __future__ import annotations

import glob as _glob
import gzip
import os
import re as _re
from typing import Dict, List, Optional

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame, _no_key
from h2o3_tpu_torch.native import parse_csv_bytes
from h2o3_tpu_torch.parallel import device as dev_mod

_UUID_RX = _re.compile(
    r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
    r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$")

_PANDAS = ("needs the reference's pandas/Arrow readers, which are not "
           "ported (ROADMAP A #5); only .csv and .csv.gz files are")


def _unported(what: str):
    raise NotImplementedError(f"{what} {_PANDAS}")


def parse_setup(path: str, nrows_sample: int = 1000,
                header: Optional[bool] = None) -> dict:
    """Not ported: the reference guesses the schema from a pandas
    sample (ROADMAP A #5)."""
    _unported("parse_setup")


def export_file(frame: Frame, path: str, force: bool = False,
                sep: str = ",") -> str:
    """Not ported: the reference writes through ``to_pandas`` (ROADMAP
    A #5)."""
    _unported("export_file")


def parse_raw(text: str, destination_frame: Optional[str] = None) -> Frame:
    """Not ported: the reference parses through pandas (ROADMAP A #5)."""
    _unported("parse_raw")


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
                na_strings=None, device: dev_mod.DeviceLike = None) -> Frame:
    """h2o.import_file analogue (h2o-py/h2o/h2o.py:414), eager: a CSV or
    CSV.gz file path, glob or directory, parsed by the native tokenizer
    into a Frame on ``device`` (CUDA unless the caller names another).
    ``lazy=True`` and ``destination_frame`` need the DKV and raise
    ``NotImplementedError``, as does any other format."""
    if lazy:
        raise NotImplementedError(
            "lazy=True registers a file-backed frame in the DKV, which is "
            "not ported yet (ROADMAP A #9)")
    _no_key(destination_frame)
    device = dev_mod.resolve_device(device)
    if os.path.isdir(path):
        paths = sorted(os.path.join(path, f) for f in os.listdir(path))
    elif any(ch in path for ch in "*?["):
        paths = sorted(_glob.glob(path))
    else:
        paths = [path]
    if not paths or not all(os.path.exists(f) for f in paths):
        raise FileNotFoundError(path)
    if not all(f.endswith((".csv", ".csv.gz")) for f in paths):
        odd = sorted({os.path.basename(f) for f in paths
                      if not f.endswith((".csv", ".csv.gz"))})
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
                            device=device)


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
