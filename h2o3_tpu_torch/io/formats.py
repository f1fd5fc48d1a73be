"""Host ingest formats — SVMLight, ARFF, XLSX and Avro.

Reference: h2o3_tpu/io/formats.py (water/parser/SVMLightParser.java,
ARFFParser.java, XlsParser.java and h2o-parsers/h2o-avro-parser). Each
reader decodes its file on the host with numpy and the standard library
into dense columns and lands them on ``device`` through
``Frame.from_numpy`` (CUDA unless the caller names another device). The
frames equal the reference's: names, types, domains, codes, NA masks and
bit-equal numbers. Where the reference walks every token, byte or value
in Python, the port splits whole lines, maps ``int``/``float`` over
token lists and decodes Avro records with readers compiled once from the
schema; the values are the same calls' values.

Not ported: Parquet, ORC and the Arrow helpers, which need pyarrow
(``io/parser.import_file`` raises ``NotImplementedError`` naming them).
"""

from __future__ import annotations

import itertools
import re
import struct as _struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.parallel import device as dev_mod


# a token with two colons, or a colon at a token's edge
_SVM_BAD = re.compile(r":[^\s:]*:|(?:^|\s):|:(?:\s|$)")


def parse_svmlight(text: str, key: Optional[str] = None,
                   device: dev_mod.DeviceLike = None) -> Frame:
    """``label idx:val idx:val …`` lines → dense Frame with a C0 target
    column and C1..Cmax features, zero where a row names no value
    (1-based feature indices; ``qid:`` tokens and ``#`` comments are
    skipped; a repeated index keeps its last value)."""
    labels: List[str] = []
    rests: List[str] = []
    for line in text.splitlines():
        if "#" in line:
            line = line.split("#", 1)[0]
        parts = line.split(None, 1)
        if not parts:
            continue
        labels.append(parts[0])
        rest = parts[1] if len(parts) > 1 else ""
        if "qid:" in rest:
            rest = " ".join(t for t in rest.split()
                            if not t.startswith("qid:"))
        rests.append(rest)
    joined = " ".join(rests)
    # every token idx:val: as many colons as tokens, none doubled or bare
    toks = joined.split()
    if joined.count(":") != len(toks) or _SVM_BAD.search(joined):
        bad = next(t for t in toks if t.count(":") != 1
                   or t.startswith(":") or t.endswith(":"))
        raise ValueError(f"SVMLight token {bad!r} is not idx:val")
    flat = joined.replace(":", " ").split()
    idx = np.asarray(list(map(int, flat[0::2])), dtype=np.int64)
    vals = np.asarray(list(map(float, flat[1::2])), dtype=np.float64)
    if idx.size and idx.min() < 1:
        raise ValueError(
            f"SVMLight indices are 1-based, got {int(idx.min())}")
    n = len(labels)
    counts = [r.count(":") for r in rests]
    max_idx = int(idx.max()) if idx.size else 0
    dense = np.zeros((n, max_idx), dtype=np.float64)
    dense[np.repeat(np.arange(n), counts), idx - 1] = vals
    cols = {"C0": np.asarray(list(map(float, labels)), dtype=np.float64)}
    for j in range(max_idx):
        cols[f"C{j + 1}"] = dense[:, j]
    return Frame.from_numpy(cols, key=key, device=device)


_ARFF_ATTR = re.compile(r"@attribute\s+('[^']+'|\S+)\s+(.+)", re.IGNORECASE)


def _split_arff_row(line: str) -> List[str]:
    """Comma split honoring single-quoted values (reference ARFFParser
    quoting rules) — `5.1,'a, b',x` → three fields, quotes kept."""
    if "'" not in line:
        return line.split(",")
    out, cur, q = [], [], False
    for ch in line:
        if ch == "'":
            q = not q
            cur.append(ch)
        elif ch == "," and not q:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def parse_arff(text: str, key: Optional[str] = None,
               device: dev_mod.DeviceLike = None) -> Frame:
    """ARFF (@relation/@attribute/@data) → Frame: numeric attributes as
    numbers, nominal ones as categoricals in their declared level order
    (a value outside it is NA), string and date attributes as host
    string columns; ``?`` is NA."""
    names: List[str] = []
    kinds: List[Tuple[str, Optional[List[str]]]] = []
    data_lines: List[str] = []
    in_data = False
    for line in text.splitlines():
        s = line.strip()
        if not s or s.startswith("%"):
            continue
        if in_data:
            data_lines.append(s)
            continue
        low = s.lower()
        if low.startswith("@relation"):
            continue
        if low.startswith("@attribute"):
            m = _ARFF_ATTR.match(s)
            if not m:
                raise ValueError(f"bad @attribute line: {s}")
            name = m.group(1).strip("'")
            spec = m.group(2).strip()
            if spec.startswith("{"):
                levels = [v.strip().strip("'") for v in
                          spec.strip("{}").split(",")]
                kinds.append(("nominal", levels))
            elif spec.lower() in ("numeric", "real", "integer"):
                kinds.append(("numeric", None))
            else:                      # string, date, …: host strings
                kinds.append(("string", None))
            names.append(name)
            continue
        if low.startswith("@data"):
            in_data = True
    if not in_data:
        raise ValueError("no @data section")

    raw = [_split_arff_row(ln) for ln in data_lines]
    ncols = len(names)
    if raw and min(map(len, raw)) >= ncols:
        fields = list(zip(*raw))[:ncols]
    else:                               # short rows: missing fields are NA
        fields = [[r[j] if j < len(r) else "?" for r in raw]
                  for j in range(ncols)]
    # with no quote and no blank inside a line (the lines are stripped),
    # no field has anything to strip
    blob = "\n".join(data_lines)
    clean = "'" not in blob and len(blob.split()) == len(data_lines)
    cols: Dict[str, np.ndarray] = {}
    cats: List[str] = []
    strs: List[str] = []
    domains: Dict[str, List[str]] = {}
    for name, (kind, levels), col in zip(names, kinds, fields):
        vals = col if clean else [v.strip().strip("'") for v in col]
        if kind == "numeric":
            cols[name] = np.asarray(
                [np.nan if v == "?" else float(v) for v in vals]
                if "?" in vals else list(map(float, vals)),
                dtype=np.float64)
        elif kind == "nominal":
            lut = {lvl: i for i, lvl in enumerate(levels)}
            cols[name] = np.asarray(
                list(map(lut.get, vals, itertools.repeat(-1, len(vals)))),
                dtype=np.int32)
            cats.append(name)
            domains[name] = levels
        else:
            cols[name] = np.asarray(
                [None if v == "?" else v for v in vals], dtype=object)
            strs.append(name)
    return Frame.from_numpy(cols, categorical=cats, domains=domains,
                            strings=strs, key=key, device=device)


_XLSX_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _xlsx_col_index(ref: str) -> int:
    """0-based column of a cell reference such as ``AB12``."""
    j = 0
    for ch in ref:
        if not ch.isalpha():
            break
        j = j * 26 + (ord(ch.upper()) - ord("A") + 1)
    return j - 1


def parse_xlsx(path: str, key: Optional[str] = None,
               device: dev_mod.DeviceLike = None) -> Frame:
    """XLSX through the standard library (zipfile + ElementTree): the
    first worksheet; row 1 is the header when every cell in it is text,
    else columns are named C1..Cn; text columns intern as categoricals,
    the others are numbers (an empty cell is NA). Trailing empty rows are
    dropped, interior ones are all-NA rows."""
    import xml.etree.ElementTree as ET
    import zipfile

    ns = _XLSX_NS
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall(f"{ns}si"):
                shared.append("".join(t.text or ""
                                      for t in si.iter(f"{ns}t")))
        sheet_names = sorted(n for n in z.namelist()
                             if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n))
        if not sheet_names:
            raise ValueError(f"{path}: no worksheets found")
        root = ET.fromstring(z.read(sheet_names[0]))

    tag_c, tag_v, tag_is, tag_t = (f"{ns}c", f"{ns}v", f"{ns}is",
                                   f"{ns}t")
    rows: List[Dict[int, object]] = []
    ncols = 0
    for row_el in root.iter(f"{ns}row"):
        row: Dict[int, object] = {}
        ci = -1
        for c in row_el:
            if c.tag != tag_c:
                continue
            ci += 1
            ref = c.get("r")
            j = _xlsx_col_index(ref) if ref else ci
            t = c.get("t")
            v_el = is_el = None
            for ch in c:
                if ch.tag == tag_v and v_el is None:
                    v_el = ch
                elif ch.tag == tag_is and is_el is None:
                    is_el = ch
            if t == "inlineStr":
                val = "".join(tt.text or "" for tt in is_el.iter(tag_t)) \
                    if is_el is not None else None
            elif v_el is None or v_el.text is None:
                val = None
            elif t == "s":
                val = shared[int(v_el.text)]
            elif t == "b":
                val = float(int(v_el.text))
            elif t in ("str", "e"):
                val = v_el.text
            else:
                val = float(v_el.text)
            if val is not None:
                row[j] = val
                ncols = max(ncols, j + 1)
        rows.append(row)
    while rows and not rows[-1]:
        rows.pop()
    if not rows or ncols == 0:
        raise ValueError(f"{path}: empty worksheet")

    header = rows[0]
    has_header = (len(header) == ncols
                  and all(isinstance(v, str) for v in header.values()))
    names = ([str(header[j]) for j in range(ncols)] if has_header
             else [f"C{j + 1}" for j in range(ncols)])
    body = rows[1:] if has_header else rows
    cols: Dict[str, np.ndarray] = {}
    cats: List[str] = []
    for j, name in enumerate(names):
        vals = [r.get(j) for r in body]
        if set(map(type, vals)) <= {float, type(None)}:
            cols[name] = np.asarray(
                [np.nan if v is None else v for v in vals], dtype=np.float64)
        else:
            cols[name] = np.asarray(
                [None if v is None else str(v) for v in vals], dtype=object)
            cats.append(name)
    return Frame.from_numpy(cols, categorical=cats, key=key, device=device)


# ---- Avro object-container reader (h2o-parsers/h2o-avro-parser) ------


def _avro_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """zigzag-encoded long at ``pos``: (value, position after it)."""
    b = buf[pos]
    if b < 0x80:                                 # one byte: most values
        return (b >> 1) ^ -(b & 1), pos + 1
    shift = 0
    acc = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1), pos


def _avro_read(buf: bytes, pos: int, schema):
    """Decode one value of ``schema`` (JSON-decoded avro schema)."""
    return _avro_reader(schema)(buf, pos)


_F32 = _struct.Struct("<f").unpack_from
_F64 = _struct.Struct("<d").unpack_from


def _avro_reader(schema) -> Callable:
    """A function ``(buf, pos) -> (value, pos)`` decoding one value of
    ``schema``: primitives, unions, enums, records and arrays."""
    if isinstance(schema, list):                 # union: long index first
        branches = [_avro_reader(s) for s in schema]

        def union(buf, pos):
            i, pos = _avro_varint(buf, pos)
            return branches[i](buf, pos)
        return union
    if isinstance(schema, dict):
        st = schema["type"]
        if st == "record":
            fields = [(f["name"], _avro_reader(f["type"]))
                      for f in schema["fields"]]

            def record(buf, pos):
                out = {}
                for name, read in fields:
                    out[name], pos = read(buf, pos)
                return out, pos
            return record
        if st == "enum":
            symbols = schema["symbols"]

            def enum(buf, pos):
                i, pos = _avro_varint(buf, pos)
                return symbols[i], pos
            return enum
        if st == "array":
            item = _avro_reader(schema["items"])

            def array(buf, pos):
                items = []
                while True:
                    n, pos = _avro_varint(buf, pos)
                    if n == 0:
                        return items, pos
                    if n < 0:
                        _, pos = _avro_varint(buf, pos)   # block byte size
                        n = -n
                    for _ in range(n):
                        v, pos = item(buf, pos)
                        items.append(v)
            return array
        return _avro_reader(st)
    if schema == "null":
        return lambda buf, pos: (None, pos)
    if schema == "boolean":
        return lambda buf, pos: (buf[pos] != 0, pos + 1)
    if schema in ("int", "long"):
        return _avro_varint
    if schema == "float":
        return lambda buf, pos: (_F32(buf, pos)[0], pos + 4)
    if schema == "double":
        return lambda buf, pos: (_F64(buf, pos)[0], pos + 8)
    if schema in ("bytes", "string"):
        text = schema == "string"

        def blob(buf, pos):
            n, pos = _avro_varint(buf, pos)
            raw = buf[pos:pos + n]
            return (raw.decode("utf-8", "replace") if text else raw), pos + n
        return blob
    raise ValueError(f"unsupported avro type {schema!r}")


def _avro_flat(ft) -> bool:
    """A field type the reader lands as a column: a primitive, an enum,
    or a union of them."""
    if isinstance(ft, list):
        return all(_avro_flat(x) for x in ft)
    if isinstance(ft, dict):
        return ft.get("type") == "enum"
    return ft in ("null", "boolean", "int", "long", "float", "double",
                  "bytes", "string")


def parse_avro(path: str, key: Optional[str] = None,
               device: dev_mod.DeviceLike = None) -> Frame:
    """Avro object-container file → Frame (flat record schemas; null and
    deflate codecs): a field whose values are all text (or bytes) is a
    categorical over its sorted levels, any other field numbers (a value
    that is not a number is NA)."""
    import json
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"Obj\x01":
        raise ValueError(f"{path} is not an avro container file")
    pos = 4
    meta = {}
    while True:
        n, pos = _avro_varint(data, pos)
        if n == 0:
            break
        if n < 0:
            _, pos = _avro_varint(data, pos)
            n = -n
        for _ in range(n):
            klen, pos = _avro_varint(data, pos)
            k = data[pos:pos + klen].decode()
            pos += klen
            vlen, pos = _avro_varint(data, pos)
            meta[k] = data[pos:pos + vlen]
            pos += vlen
    sync = data[pos:pos + 16]
    pos += 16
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    if schema.get("type") != "record":
        raise ValueError("only flat record avro schemas are supported")
    bad = [f["name"] for f in schema["fields"] if not _avro_flat(f["type"])]
    if bad:
        raise ValueError("avro fields with nested/array types are not "
                         f"supported: {bad}")
    # one value list a field name (a repeated name keeps its last field,
    # as a decoded record dict does)
    names = list(dict.fromkeys(f["name"] for f in schema["fields"]))
    slot = {nm: i for i, nm in enumerate(names)}
    values: List[list] = [[] for _ in names]
    fields = [(values[slot[f["name"]]].append, _avro_reader(f["type"]))
              for f in schema["fields"]]
    while pos < len(data):
        cnt, pos = _avro_varint(data, pos)
        size, pos = _avro_varint(data, pos)
        block = data[pos:pos + size]
        pos += size
        if data[pos:pos + 16] != sync:
            raise ValueError("avro sync marker mismatch")
        pos += 16
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec '{codec}'")
        bpos = 0
        for _ in range(cnt):
            for append, read in fields:
                v, bpos = read(block, bpos)
                append(v)
    arrays, cats, doms = {}, [], {}
    for name, vals in zip(names, values):
        kinds = set(map(type, vals))
        if kinds <= {str, type(None)} and str in kinds:
            levels = sorted(set(vals) - {None})
            lut = {v: i for i, v in enumerate(levels)}
            arrays[name] = np.array(
                list(map(lut.get, vals, itertools.repeat(-1, len(vals)))),
                np.int32)
            cats.append(name)
            doms[name] = levels
        elif kinds <= {str, bytes, type(None)} and kinds - {type(None)}:
            def _s(v):
                return (v.decode("utf-8", "replace")
                        if isinstance(v, bytes) else str(v))
            levels = sorted({_s(v) for v in vals if v is not None})
            lut = {v: i for i, v in enumerate(levels)}
            arrays[name] = np.array(
                [lut.get(_s(v), -1) if v is not None else -1
                 for v in vals], np.int32)
            cats.append(name)
            doms[name] = levels
        elif kinds <= {int, float, bool}:
            arrays[name] = np.array(vals, np.float64)
        else:
            arrays[name] = np.array(
                [float(v) if isinstance(v, (int, float, bool)) else np.nan
                 for v in vals], np.float64)
    return Frame.from_numpy(arrays, categorical=cats, domains=doms,
                            key=key, device=device)
