"""CSV ingest of the PyTorch port (``io/parser.import_file``,
``io/stream.stream_import_csv``, ``io/chunking``, ``native``,
``frame/column`` blocks, ``Frame.from_blocks``) on the CPU, held against
the reference package on the same files.

The cases mirror the reference's own (tests/test_native_parser.py,
tests/test_stream_ingest.py, tests/test_ingest_parallel.py): types and
NAs, quotes and escapes, CRLF and blank lines, multi-window values,
domains and dtype promotion, categorical promotion mid-stream, all-NA
columns, parallel == sequential, multi-file globs and gzip, quoted
fields across chunk boundaries, ``na_strings``, ``col_types`` and UUID
columns. For each, both packages' frames are equal in names, types,
domain order, NA masks, the float64 host values (bit for bit) and the
float32 ``numeric_view()`` (bit for bit: the port keeps float32 device
values where the reference narrows, and its math-path view is the
reference's). A GBM trained on a CSV frame equals the reference's on
tie-free data. Inputs the port does not read yet raise
``NotImplementedError``."""

import gzip
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.io import chunking as ref_chunking
from h2o3_tpu.io.stream import stream_import_csv as ref_stream
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu.native import parse_csv_bytes as ref_parse
from h2o3_tpu_torch.io import chunking, parser
from h2o3_tpu_torch.io.stream import stream_import_csv
from h2o3_tpu_torch.native import parse_csv_bytes

from test_torch_gbm import PARAMS, _assert_forests
from torch_ranks import mixed_cols

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _reference_tokenizer_whole():
    """The reference builds its tokenizer in place (``g++ -o``) at first
    use, and a process that loads the file half-written gives up on it for
    good. So before the first reference call this module builds it, if it
    is missing or stale, into a temp file renamed over it; waits until a
    fresh process loads it and the file stays the same meanwhile (another
    test process may be writing it); then loads it here, clearing a
    failure this process may have cached. Nothing in the reference
    changes."""
    import h2o3_tpu.native as rn
    so, src = Path(rn._SO), Path(rn._SRC)
    if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
        fd, tmp = tempfile.mkstemp(dir=so.parent, prefix=".csv_parser.",
                                   suffix=".so")
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                            "-pthread", str(src), "-o", tmp], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    probe = "import ctypes, sys; ctypes.CDLL(sys.argv[1]).csv_parse"

    def stamp():
        st = so.stat()
        return st.st_ino, st.st_size, st.st_mtime_ns

    for _ in range(60):
        try:
            before = stamp()
            ok = subprocess.run([sys.executable, "-c", probe, str(so)],
                                capture_output=True).returncode == 0
            if ok and stamp() == before:
                break
        except FileNotFoundError:
            pass
        time.sleep(1.0)
    else:
        pytest.fail(f"the reference's tokenizer {so} does not load")
    with pytest.MonkeyPatch.context() as mp:
        if rn._lib is None:
            mp.setattr(rn, "_lib_failed", False)
        assert rn.load_csv_parser() is not None
        yield


def _csv(path, header, rows, opener=open):
    with opener(path, "wt", newline="") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(r) + "\n")
    return str(path)


def _fmt(v) -> str:
    """A cell: repr of a float (round-trips exactly), '' for NaN/None."""
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return ""
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def _write(path, cols, opener=open):
    names = list(cols)
    n = len(cols[names[0]])
    return _csv(path, names, ([_fmt(cols[c][i]) for c in names]
                              for i in range(n)), opener)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _same_floats(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    na, nb = np.isnan(a), np.isnan(b)
    assert np.array_equal(na, nb), what
    assert np.array_equal(_bits(a)[~na], _bits(b)[~nb]), what


def _assert_frames(ref, port):
    """The port's frame equals the reference's: names, types, domains,
    NA masks, bit-equal float64 host views and float32 numeric views."""
    n = ref.nrows
    assert port.names == list(ref.names) and port.nrows == n
    for nm in ref.names:
        rc, pc = ref.col(nm), port.col(nm)
        assert pc.type == rc.type, nm
        assert (pc.domain or None) == (rc.domain or None), nm
        if rc.type in ("string", "uuid"):
            assert list(pc.host_view()) == list(rc.host_view()), nm
            continue
        assert pc.data.dtype == (torch.int32 if rc.is_categorical
                                 else torch.float32)
        assert np.array_equal(pc.na_mask.numpy()[:n],
                              np.asarray(rc.na_mask)[:n]), nm
        _same_floats(pc.host_view(), rc.host_view(), f"{nm} host")
        _same_floats(pc.numeric_view().numpy()[:n],
                     np.asarray(rc.numeric_view())[:n], f"{nm} view")


def _assert_port_identical(a, b):
    """Two port frames bit for bit: device data, masks, host views."""
    assert a.names == b.names and a.nrows == b.nrows
    assert a.nrows_padded == b.nrows_padded
    for nm in a.names:
        ca, cb = a.col(nm), b.col(nm)
        assert (ca.type, ca.domain) == (cb.type, cb.domain), nm
        if ca.data is None:
            assert list(ca.host_view()) == list(cb.host_view())
            continue
        assert torch.equal(ca.data, cb.data) and \
            torch.equal(ca.na_mask, cb.na_mask), nm
        _same_floats(ca.host_view(), cb.host_view(), nm)


def _both_import(path, **kw):
    ref = h2o3_tpu.import_file(path, **kw)
    port = h2o3_tpu_torch.import_file(path, device="cpu", **kw)
    _assert_frames(ref, port)
    return ref, port


def _both_stream(path, chunk_bytes, workers=(1, 4), **kw):
    ports = [stream_import_csv(path, chunk_bytes=chunk_bytes, workers=w,
                               device="cpu", **kw) for w in workers]
    for p in ports[1:]:
        _assert_port_identical(ports[0], p)
    ref = ref_stream(path, chunk_bytes=chunk_bytes, workers=workers[-1],
                     **kw)
    _assert_frames(ref, ports[-1])
    return ref, ports[-1]


def _mixed(n, seed):
    r = np.random.RandomState(seed)
    f = np.round(r.randn(n), 4)
    f[::71] = np.nan
    return {"i8": r.randint(-100, 100, n), "i16": r.randint(0, 30_000, n),
            "f": f, "g": np.array(["aa", "bb", "cc", "dd"])[
                r.randint(0, 4, n)]}


# ----------------------------------------------------- the tokenizer


@pytest.mark.parametrize("data", [
    b"a,b,c,d\n1,2.5,x,2020-01-01\n2,NA,y,2020-01-02\n,3.5,,2020-01-03\n",
    b'name,val\n"hello, world",1\n"say ""hi""",2\nplain,3\n',
    b"a,b\r\n1,2\r\n\r\n3,4\r\n",
    b'a,b\n1,""\n2,x\n,NULL\nnan,null\n',
], ids=["types_and_nas", "quotes_and_escapes", "crlf_blank_lines",
        "na_tokens"])
@pytest.mark.parametrize("decode", [True, False])
def test_tokenizer_matches_the_reference(data, decode):
    (pc, pd_), (rc, rd) = (parse_csv_bytes(data, decode=decode),
                           ref_parse(data, decode=decode))
    assert list(pc) == list(rc) and pd_ == rd
    for k in rc:
        if rc[k].dtype == object:
            assert list(pc[k]) == list(rc[k]), k
        else:
            _same_floats(pc[k], rc[k], k)


def test_tokenizer_threads_match_single_thread():
    r = np.random.RandomState(0)
    lines = ["x,y,g"] + [f"{r.randn():.6f},{r.randint(100)},"
                         f"{'abcd'[r.randint(4)] * 2}" for _ in range(20_000)]
    data = ("\n".join(lines) + "\n").encode()
    c1, d1 = parse_csv_bytes(data, nthreads=1)
    c8, d8 = parse_csv_bytes(data, nthreads=8)
    _same_floats(c1["x"], c8["x"], "x")
    assert list(c1["g"]) == list(c8["g"]) and d1 == d8


def test_tokenizer_builds_atomically_in_two_processes(tmp_path):
    """Two processes build the tokenizer into the same cold directory at
    once: both load a whole library, one file stands, no temp left."""
    code = (
        "import sys; from pathlib import Path\n"
        "import h2o3_tpu_torch.native as n\n"
        "n.BUILD = Path(sys.argv[1])\n"
        "cols, _ = n.parse_csv_bytes(b'a\\n1\\n2\\n')\n"
        "assert list(cols['a']) == [1.0, 2.0]\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert [f.name for f in tmp_path.iterdir()] == \
        [h2o3_tpu_torch.native.lib_path().name]


def test_failed_build_raises(tmp_path, monkeypatch):
    import h2o3_tpu_torch.native as nat
    bad = tmp_path / "csv_parser.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nat, "SRC", bad)
    monkeypatch.setattr(nat, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nat.build()
    assert not any((tmp_path / "build").iterdir())


# -------------------------------------------------------- the splitter


@pytest.mark.parametrize("buf", [
    b'a,b\n"x,\ny', b'v\n"a""b\nc",9\n', b'"open field, no close',
    b"no newline here", b"a\nb\nc", b'"q"\n"r\n"\n', b""])
def test_quote_aware_cut_matches_the_reference(buf):
    assert chunking.quote_aware_cut(buf) == ref_chunking.quote_aware_cut(buf)


def test_windows_paths_and_formats_match_the_reference(tmp_path):
    cols = _mixed(3_000, 2)
    _write(tmp_path / "p_0.csv", cols)
    _write(tmp_path / "p_1.csv.gz", cols, gzip.open)
    paths = chunking.expand_paths(str(tmp_path / "p_*"))
    assert paths == ref_chunking.expand_paths(str(tmp_path / "p_*"))
    assert chunking.expand_paths(str(tmp_path)) == \
        ref_chunking.expand_paths(str(tmp_path))
    assert list(chunking.iter_line_chunks(paths, 4096)) == \
        list(ref_chunking.iter_line_chunks(paths, 4096))
    for p in ["a.csv", "a.csv.gz", "a.parquet", "a.pq", "a.orc", "a.avro",
              "a.svm", "a.arff", "a.xlsx", "a.txt"]:
        assert chunking.classify_format(p) == ref_chunking.classify_format(p)
    assert chunking.resolve_workers(3) == 3
    assert chunking.resolve_workers(0) == (os.cpu_count() or 1)
    assert chunking.resolve_chunk_bytes(None) == 64 << 20


# ------------------------------------------------------- import_file


def test_import_types_nas_and_gzip(tmp_path):
    r = np.random.RandomState(1)
    n = 5_000
    num = r.randn(n)
    num[r.rand(n) < 0.05] = np.nan
    cols = {"num": num, "int": r.randint(0, 50, n).astype(float),
            "big": r.randint(-2 ** 30, 2 ** 30, n).astype(float),
            "cat": np.array(["u", "v", "w"], object)[r.randint(0, 3, n)],
            "date": np.array(["2020-01-01", "2021-06-30"])[
                r.randint(0, 2, n)]}
    _both_import(_write(tmp_path / "t.csv", cols))
    _both_import(_write(tmp_path / "t.csv.gz", cols, gzip.open))


def test_import_quotes_crlf_and_headerless(tmp_path):
    p = tmp_path / "q.csv"
    p.write_bytes(b'name,val\r\n"hello, world",1\r\n"say ""hi""",2\r\n'
                  b'\r\nplain,3\r\n"x\ny",4\r\n')
    _both_import(str(p))
    h = tmp_path / "h.csv"
    h.write_bytes(b"1,a,2.5\n2,b,3.5\n3,a,\n")
    ref, port = _both_import(str(h))
    assert port.names == ["C1", "C2", "C3"]
    _both_import(str(h), header=False)


def test_import_multi_file_glob_unifies_domains(tmp_path):
    a = {"k": np.array(["x", "y"])[np.arange(40) % 2], "v": np.arange(40.0)}
    b = {"k": np.array(["w", "z", "y"])[np.arange(30) % 3],
         "v": np.arange(30.0) / 4}
    _write(tmp_path / "part_0.csv", a)
    _write(tmp_path / "part_1.csv.gz", b, gzip.open)
    ref, port = _both_import(str(tmp_path / "part_*"))
    assert port.col("k").domain == ["w", "x", "y", "z"]
    _both_import(str(tmp_path))                 # a directory


@pytest.mark.parametrize("na_strings", [
    {"n": ["-999"], "c": ["missing"]},            # by name
    [["-999"], ["missing"], []],                  # by position
    {"c": ["missing", "1", "2"]},                 # a level list left numeric
])
def test_import_na_strings(tmp_path, na_strings):
    n = 300
    r = np.random.RandomState(4)
    nv = r.randint(0, 9, n).astype(float)
    nv[::7] = -999
    cv = np.array(["1", "2", "missing"], object)[r.randint(0, 3, n)]
    cols = {"n": nv, "c": cv, "z": r.randn(n)}
    p = _write(tmp_path / "na.csv", cols)
    _both_import(p, na_strings=na_strings)
    h = _csv(tmp_path / "nh.csv", ["n", "c", "z"],
             ([_fmt(nv[i]), cv[i], _fmt(cols["z"][i])] for i in range(n)))
    with open(h) as f:
        body = f.read().split("\n", 1)[1]
    Path(h).write_text(body)
    if isinstance(na_strings, list):
        _both_import(h, header=False, na_strings=na_strings)
    else:
        _both_import(h, header=False,
                     na_strings={"C1": ["-999"], "C2": ["missing"]})


@pytest.mark.parametrize("col_types", [
    {"n": "enum"}, {"n": "categorical", "c": "string"},
    {"c": "numeric"}, {"c": "enum"}])
def test_import_col_types(tmp_path, col_types):
    n = 400
    r = np.random.RandomState(5)
    nv = np.round(r.randn(n) * 3, 1)
    nv[::9] = np.nan
    cv = np.array(["1.5", "2", "x", ""], object)[r.randint(0, 4, n)]
    p = _write(tmp_path / "ct.csv", {"n": nv, "c": cv})
    ref, port = _both_import(p, col_types=col_types)
    if col_types.get("n") in ("enum", "categorical"):
        assert port.col("n").is_categorical
    if col_types.get("c") == "string":
        assert port.col("c").type == "string"


def test_import_uuid_columns(tmp_path):
    r = np.random.RandomState(6)
    n = 200
    ids = np.array([f"{r.randint(16 ** 8):08x}-{r.randint(16 ** 4):04x}-"
                    f"{r.randint(16 ** 4):04X}-{r.randint(16 ** 4):04x}-"
                    f"{r.randint(16 ** 12):012x}" for _ in range(n)], object)
    ids[5] = ""
    cols = {"id": ids, "v": r.randn(n), "g": np.array(["a", "b"])[
        np.arange(n) % 2]}
    p = _write(tmp_path / "u.csv", cols)
    ref, port = _both_import(p)
    assert port.col("id").is_uuid and port.col("id").data is None
    # an explicit type wins over the detection
    _both_import(p, col_types={"id": "enum"})


def test_unported_inputs_raise(tmp_path):
    p = _write(tmp_path / "ok.csv", {"a": np.arange(3.0)})
    for name in ("f.zip", "f.parquet", "f.orc", "f.avro", "f.xlsx",
                 "f.arff", "f.svm", "f.txt"):
        q = tmp_path / name
        q.write_bytes(b"a\n1\n")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            h2o3_tpu_torch.import_file(str(q), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A #9′"):
        h2o3_tpu_torch.import_file(p, lazy=True, device="cpu")
    # destination_frame stores the frame under its key (the DKV)
    plain = h2o3_tpu_torch.import_file(p, device="cpu")
    for key, fr in (
            ("k_import", h2o3_tpu_torch.import_file(
                p, destination_frame="k_import", device="cpu")),
            ("k_stream", stream_import_csv(p, destination_frame="k_stream",
                                           device="cpu"))):
        assert h2o3_tpu_torch.DKV.get(key) is fr and fr.key == key
        np.testing.assert_array_equal(fr.col("a").host_view(),
                                      plain.col("a").host_view())
        h2o3_tpu_torch.DKV.remove(key)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parser.parse_setup(p)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parser.export_file(None, str(tmp_path / "out.csv"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parser.parse_raw("a\n1\n")
    # files that disagree on a column's type: the reference's pandas path
    (tmp_path / "d").mkdir()
    _csv(tmp_path / "d" / "0.csv", ["a"], [["1"], ["2"]])
    _csv(tmp_path / "d" / "1.csv", ["a"], [["x"], ["y"]])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        h2o3_tpu_torch.import_file(str(tmp_path / "d"), device="cpu")
    with pytest.raises(FileNotFoundError):
        h2o3_tpu_torch.import_file(str(tmp_path / "nope.csv"), device="cpu")


# --------------------------------------------------- stream_import_csv


def test_stream_multi_window_values_nas_and_domains(tmp_path):
    r = np.random.RandomState(3)
    n = 50_000
    f = np.round(r.randn(n), 3)
    f[::97] = np.nan
    cols = {"small": r.randint(0, 100, n), "wide": r.randint(0, 30_000, n),
            "f": f, "g": np.array(["aa", "bb", "cc", "dd"])[
                r.randint(0, 4, n)]}
    _both_stream(_write(tmp_path / "t.csv", cols), 64 << 10)


def test_stream_block_dtype_promotion_across_windows(tmp_path):
    n = 30_000
    vals = np.zeros(n)
    vals[:10_000] = np.arange(10_000) % 100
    vals[10_000:20_000] = 20_000 + np.arange(10_000)
    vals[20_000:] = np.linspace(0, 1, 10_000)
    ints = np.arange(n) % 50
    ints[25_000:] += 40_000                        # int8 → int32 late
    _both_stream(_write(tmp_path / "p.csv", {"v": vals, "i": ints}),
                 32 << 10)


def test_stream_categorical_promotion_mid_stream(tmp_path):
    n = 12_000
    col = np.array([str(i % 7) for i in range(n)], object)
    col[9000:] = np.array(["x", "y"])[np.arange(3000) % 2]
    frac = np.array([f"{(i % 5) / 4}" for i in range(n)], object)
    frac[11_000:] = "z"
    ref, port = _both_stream(_write(tmp_path / "c.csv", {
        "c": col, "h": frac, "k": np.arange(n)}), 16 << 10)
    assert port.col("c").is_categorical and port.col("h").is_categorical


def test_stream_all_na_and_forced_categorical(tmp_path):
    n = 5_000
    cols = {"a": np.arange(n, dtype=float), "b": [""] * n,
            "k": np.arange(n) % 13}
    p = _write(tmp_path / "n.csv", cols)
    ref, port = _both_stream(p, 8 << 10)
    assert not bool(port.col("a").na_mask[:n].any())
    _both_stream(p, 8 << 10, col_types={"k": "categorical"})


def test_stream_multi_file_glob_and_gzip(tmp_path):
    cols = _mixed(9_000, 7)
    parts = [{k: v[i * 3_000:(i + 1) * 3_000] for k, v in cols.items()}
             for i in range(3)]
    _write(tmp_path / "part_0.csv", parts[0])
    _write(tmp_path / "part_1.csv.gz", parts[1], gzip.open)
    _write(tmp_path / "part_2.csv", parts[2])
    whole = _write(tmp_path / "whole.csv", cols)
    ref, glob = _both_stream(str(tmp_path / "part_*"), 16 << 10)
    one = stream_import_csv(whole, chunk_bytes=16 << 10, workers=4,
                            device="cpu")
    _assert_port_identical(glob, one)


def test_stream_quoted_fields_across_chunk_boundaries(tmp_path):
    n = 4_000
    r = np.random.RandomState(11)
    vals = []
    for i in range(n):
        k = i % 4
        vals.append([f"plain{i}", f'"with,comma,{i}"',
                     f'"line1\nline2 {i}"', f'"both,\n{i}"'][k])
    p = _csv(tmp_path / "q.csv", ["s", "x"],
             ([v, str(r.randint(0, 1000))] for v in vals))
    ref, port = _both_stream(p, 1 << 10)
    _assert_frames(h2o3_tpu.import_file(p),
                   h2o3_tpu_torch.import_file(p, device="cpu"))


# ------------------------------------------------------- CSV → GBM


def test_csv_to_gbm_forest_equals_the_reference(tmp_path):
    """The CSV front door feeds the GBM: both packages import the same
    file and train the same forest (tie-free data, as
    tests/test_torch_gbm.py); the port's fit on the CSV frame equals its
    fit on ``Frame.from_numpy`` of the same columns."""
    cols, cats = mixed_cols(seed=6)
    p = _write(tmp_path / "m.csv", cols)
    ref, port = _both_import(p)
    m_r = RefGBM(**PARAMS).train(ref, y="y")
    m_p = h2o3_tpu_torch.GBMEstimator(**PARAMS).train(port, y="y")
    _assert_forests(m_r, m_p)
    direct = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                             device="cpu")
    m_d = h2o3_tpu_torch.GBMEstimator(**PARAMS).train(direct, y="y")
    for f in m_p.forest._fields:
        assert torch.equal(getattr(m_p.forest, f), getattr(m_d.forest, f))
    streamed = stream_import_csv(p, device="cpu")
    m_s = h2o3_tpu_torch.GBMEstimator(**PARAMS).train(streamed, y="y")
    _assert_forests(RefGBM(**PARAMS).train(ref_stream(p), y="y"), m_s)
