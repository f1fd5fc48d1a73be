"""Rapids of the PyTorch port (``h2o3_tpu_torch.rapids``) on the CPU,
held against the reference's ``h2o3_tpu.rapids`` on the same frames.

The expressions are the reference's own (tests/test_rapids.py,
test_rapids_ext.py, test_rapids_extra.py, test_rapids_device.py) plus
cases for NA group keys, merges with NA keys and name collisions, and the
string prims. Each goes through both packages' ``rapids()`` on frames
built from the same numpy columns. Tolerances:

- the host path (frames under ``_DEV_MIN_ROWS`` rows) is float64 numpy
  in both packages: every output EXACT (names, types, domains, NA masks,
  host values);
- the device path (``_DEV_MIN_ROWS`` patched low in both packages, as
  tests/test_rapids_device.py does): elementwise arithmetic,
  comparisons, rounding, ``cummax``/``cummin``, ``is.na``, ``ifelse``
  and the string LUT EXACT; the transcendentals (``TRANSCENDENTAL``)
  within ``REF_ULPS`` float32 ulps of the reference (2, except sinh 9
  and tanh 4: XLA's CPU float32 sinh and tanh are themselves up to 8.4
  and 3.7 ulps off the float64 value on these inputs, torch's 0.51 and
  0.53; there the port is also held within 1 ulp of the float64 value);
  ``cumsum``/``cumprod`` and the reductions within the float32
  summation bound (n-1)·2^-24·Σ|x| of their terms;
- group-by moments: counts EXACT, sums within the same bound.

The reference runs on one device (``_one_device``)."""

import contextlib

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu.rapids as ref_rapids
import h2o3_tpu_torch
import h2o3_tpu_torch.rapids as port_rapids
from h2o3_tpu_torch.core.kv import DKV as PDKV

from test_torch_isofor import _one_device
from torch_threads import one_torch_thread  # noqa: F401 - autouse

U = 2.0 ** -24
# float32 ulps between the reference's and the port's transcendentals
REF_ULPS = {"sinh": 9, "tanh": 4}


def _datasets():
    r = np.random.RandomState(0)
    t_ms = np.asarray([0.0, 86400000.0, 90000000.0, 3600000.0,
                       1234567890000.0])
    return {
        "data": ({"a": np.arange(10, dtype=np.float64), "b": r.randn(10),
                  "g": np.array(list("xyxyxyxyxy"), dtype=object)},
                 {"categorical": ["g"]}),
        "N": ({"x": np.array([1.0, np.nan, 3.0])}, {}),
        "S": ({"s": np.array(["Hello", "World", None], dtype=object)},
              {"categorical": ["s"]}),
        "L": ({"k": np.array(["a", "b", "c"], dtype=object),
               "v1": np.array([1.0, 2.0, 3.0])}, {"categorical": ["k"]}),
        "R": ({"k": np.array(["b", "c", "d"], dtype=object),
               "v2": np.array([20.0, 30.0, 40.0])}, {"categorical": ["k"]}),
        # NA keys on both sides, a colliding value column "v"
        "LN": ({"k": np.array([1.0, np.nan, 2.0, 3.0, 2.0, np.nan]),
                "v": np.arange(6, dtype=np.float64),
                "s": np.array(["p", "q", None, "p", "r", "q"], object)},
               {"categorical": ["s"]}),
        "RN": ({"k": np.array([2.0, np.nan, 3.0, 2.0, 9.0]),
                "v": np.array([10.0, 11.0, 12.0, 13.0, 14.0]),
                "w": np.array([0.5, 1.5, np.nan, 3.5, 4.5])}, {}),
        # NA group keys: a categorical key with NA (code -1, first) and a
        # numeric key whose NaN first appears after every number
        "GN": ({"g": np.array(["u", None, "v", "u", None, "v", "u", "w"],
                              object),
                "k": np.array([2.0, 1.0, 2.0, 3.0, 1.0, 3.0, np.nan, 2.0]),
                "x": np.array([1.0, 2.0, 3.0, 4.0, np.nan, 6.0, 7.0, 8.0])},
               {"categorical": ["g"]}),
        "mA": ({"a": np.array([1.0, 2.0]), "b": np.array([3.0, 4.0])}, {}),
        "mB": ({"a": np.array([1.0, 0.0]), "b": np.array([0.0, 1.0])}, {}),
        "hv": ({"v": np.linspace(0.0, 10.0, 101)}, {}),
        "fn": ({"v": np.array([1.0, np.nan, np.nan, 4.0, np.nan])}, {}),
        "kf": ({"v": np.arange(100, dtype=np.float64)}, {}),
        "sk": ({"y": np.array(["a"] * 60 + ["b"] * 40, object)},
               {"categorical": ["y"]}),
        "ss": ({"y": np.array(["a"] * 80 + ["b"] * 20, object)},
               {"categorical": ["y"]}),
        "rp": ({"v": np.array([7.0, 8.0])}, {}),
        "dA": ({"x": np.array([0.0, 3.0]), "y": np.array([0.0, 4.0])}, {}),
        "dB": ({"x": np.array([0.0]), "y": np.array([0.0])}, {}),
        "dd": ({"a": np.array([1.0, 1.0, 2.0, 2.0, 3.0]),
                "b": np.array([9.0, 9.0, 8.0, 7.0, 6.0])}, {}),
        "gg": ({"s": np.array(["apple", "banana", "cherry"], object)},
               {"categorical": ["s"]}),
        "st": ({"s": np.array(["  hi", "yo  ", "  both  "], object)},
               {"categorical": ["s"]}),
        "wide": ({"id": np.array([1.0, 2.0]), "p": np.array([10.0, 20.0]),
                  "q": np.array([30.0, 40.0])}, {}),
        "fns": ({"v": np.array([np.nan, 2.0, np.nan]),
                 "s": np.array(["a", None, "c"], object)},
                {"strings": ["s"]}),
        "ddn": ({"a": np.array([np.nan, np.nan, 1.0]),
                 "b": np.array([1.0, 2.0, 3.0])}, {}),
        "fo": ({"s": np.array(["a", "b", "c"], object),
                "v": np.array([1.0, np.nan, 3.0])}, {"strings": ["s"]}),
        "fcat": ({"g": np.array(["x", "y", "x"], object)},
                 {"categorical": ["g"]}),
        "dds": ({"s": np.array(["k", "k", "m", None, None], object),
                 "v": np.arange(5, dtype=np.float64)}, {"strings": ["s"]}),
        "rapx": ({"g": np.asarray(["a", "b", "c", "a", None], dtype=object),
                  "x": np.asarray([1.0, 2.0, 3.0, 4.0, 5.0]),
                  "y": np.asarray([2.0, 4.0, 6.0, 8.0, 10.0]),
                  "t": t_ms}, {"categorical": ["g"]}),
        "whichna": ({"v": np.asarray([1.0, 0.0, np.nan, 2.0])}, {}),
        "strf": ({"s": np.asarray(["a_b", "c_d_e", None], dtype=object)},
                 {"categorical": ["s"]}),
        "strs": ({"s": np.asarray(["Ab c", None, "de F", "Ab c"], object)},
                 {"strings": ["s"]}),
    }


HOST_EXPRS = [
    '(+ (cols_py data ["a"]) 5)',
    '(rows data (> (cols_py data ["a"]) 6))',
    '(sum (cols_py data ["a"]))', '(mean (cols_py data ["a"]))',
    '(sd (cols_py data ["a"]))', '(var (cols_py data ["b"]))',
    '(median (cols_py data ["b"]))', '(prod (cols_py data ["a"]))',
    '(ifelse (> (cols_py data ["a"]) 4) 1 0)',
    '(cbind (cols_py data ["a"]) (cols_py data ["b"]))',
    '(rbind data data)',
    '(GB data ["g"] "mean" "a" "all" "sum" "b" "all" "count" "a" "all")',
    '(GB data ["g"] "max" "a" "all" "min" "a" "all")',
    '(GB data ["g"] "sd" "b" "all" "var" "a" "all" "median" "b" "all")',
    '(GB GN ["g"] "sum" "x" "all" "count" "x" "all" "max" "x" "all")',
    '(GB GN ["k"] "sum" "x" "all" "min" "x" "all")',
    '(GB GN ["g" "k"] "count" "x" "all" "mean" "x" "all")',
    '(sort data ["b"] [1])', '(sort data ["g" "b"] [-1 1])',
    '(merge L R 0 0)', '(merge L R 1 0)',
    '(merge LN RN 0 0)', '(merge LN RN 0 0 [0] [0] "auto")',
    '(merge LN RN 1 0 [0] [0] "auto")', '(merge RN LN 1 0 [0] [0] "auto")',
    '(tolower S)', '(toupper S)', '(nchar S)', '(trim st)',
    '(sub gg "a" "A")', '(gsub gg "an" "AN")',
    '(as.factor (cols_py data ["a"]))',
    '(as.numeric (as.factor (cols_py data ["a"])))',
    '(as.character (cols_py data ["g"]))',
    '(is.na N)', '(sum N)', '(sum N 1)', '(h2o.impute N [0] "mean")',
    '(table (cols_py data ["g"]))', '(table (cols_py data ["a"]))',
    '(unique (cols_py data ["g"]))', '(unique (cols_py N ["x"]) 1)',
    '(rows data [0:5])', '(rows data [2:nan])', '(rows data [0:5:2])',
    '(cols_py data [0:2])', '(cols data -1)', '(cols data [-2])',
    '(== (cols_py data ["g"]) "x")', '(!= (cols_py data ["g"]) "x")',
    '(:= data 99 [0] [0:3])', '(:= data 7 [1] [])',
    '(:= data "z" [2] [0:2])',
    '(cumsum (cols_py data ["b"]) 0)', '(cummax (cols_py data ["b"]) 0)',
    '(quantile (cols_py data ["b"]) [0.1 0.5 0.9] "interpolate")',
    '(scale (cols_py data ["a" "b"]) 1 1)',
    '(%% (cols_py data ["b"]) 0.7)', '(intDiv (cols_py data ["b"]) 0.3)',
    "(t mA)", "(x mA mB)", "(hist hv 5)", "(cut hv [0 2.5 5 10] [] 1 1 3)",
    '(h2o.fillna fn "forward" 0 1)', "(kfold_column kf 5 42)",
    "(modulo_kfold_column kf 4)", "(stratified_kfold_column sk 5 42)",
    "(h2o.random_stratified_split ss 0.25 7)", "(seq_len 5)",
    "(seq 0 1 0.25)", "(rep_len rp 5)", '(distance dA dB "l2")',
    '(dropdup dd ["a"] "first")', '(grep gg "an" 0 0 0)',
    '(grep gg "an" 0 1 1)', "(lstrip st)", "(rstrip st)",
    '(melt wide ["id"] ["p" "q"] "variable" "value" 0)', "(seq 5 1 -1)",
    '(h2o.fillna fns "backward" 0 5)', '(dropdup ddn ["a"] "first")',
    '(h2o.fillna fo "forward" 0 5)', '(h2o.fillna fo "forward" 1 5)',
    '(h2o.fillna fcat "forward" 1 2)', '(dropdup dds ["s"] "first")',
    '(match (cols_py rapx "g") ["b" "c"] NaN 0)',
    '(levels (cols_py rapx "g"))', '(nlevels (cols_py rapx "g"))',
    '(is.factor (cols_py rapx "g"))', '(is.numeric (cols_py rapx "x"))',
    "(anyfactor rapx)", "(any.na rapx)",
    '(h2o.which (> (cols_py rapx "x") 2.5))',
    '(which.max (cols_py rapx ["x" "y"]) 1 1)',
    '(which.max (cols_py rapx ["x" "y"]) 1 0)',
    '(h2o.which (cols_py whichna "v"))',
    '(cor (cols_py rapx "x") (cols_py rapx "y") "everything" "Pearson")',
    '(skewness (cols_py rapx "x") 1)', '(kurtosis (cols_py rapx "x") 1)',
    '(strsplit (cols_py strf "s") "_")',
    '(countmatches (cols_py strf "s") ["_"])',
    '(entropy (cols_py strf "s"))', '(year (cols_py rapx "t"))',
    '(dayOfWeek (cols_py rapx "t"))', '(hour (cols_py rapx "t"))',
    '(difflag1 (cols_py rapx "x"))', '(relevel (cols_py rapx "g") "c")',
    '(tolower strs)', '(nchar strs)', '(gsub strs "c" "C")',
]


@contextlib.contextmanager
def _sessions():
    """Both packages' sessions holding every dataset under its key; the
    port's keys made inside are removed at the end."""
    before = set(PDKV.keys())
    rs, ps = ref_rapids.Session(), port_rapids.Session()
    for key, (cols, kw) in _datasets().items():
        with _one_device():
            rs.assign(key, h2o3_tpu.Frame.from_numpy(cols, **kw))
        ps.assign(key, h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu",
                                                       **kw))
    try:
        yield rs, ps
    finally:
        for k in set(PDKV.keys()) - before:
            PDKV.remove(k)


def _both(expr, rs, ps):
    with _one_device():
        ref = ref_rapids.rapids(expr, rs)
    port = port_rapids.rapids(expr, ps, device="cpu")
    return ref, port


def _ulps(a, b) -> np.ndarray:
    """|a - b| in float32 ulps of b."""
    a32, b32 = np.float32(a), np.float32(b)
    return np.abs(a32.astype(np.float64) - b32) / np.spacing(np.abs(b32))


def _same_values(ref, port, what, tol=None):
    """Equal float64 arrays (NaN where NaN); ``tol(ref, port)`` is the
    allowed |difference| per element where not exact."""
    ref = np.asarray(ref, np.float64)
    port = np.asarray(port, np.float64)
    assert ref.shape == port.shape, what
    assert np.array_equal(np.isnan(ref), np.isnan(port)), what
    ok = ~np.isnan(ref)
    if tol is None:
        assert np.array_equal(ref[ok], port[ok]), what
    else:
        bound = np.broadcast_to(tol(ref, port), ref.shape)[ok]
        assert np.all(np.abs(ref[ok] - port[ok]) <= bound), \
            (what, np.max(np.abs(ref[ok] - port[ok]) - bound))


def _same(ref, port, what, tol=None):
    if isinstance(ref, h2o3_tpu.Frame):
        assert isinstance(port, h2o3_tpu_torch.Frame), what
        assert port.key is not None, what
        assert list(port.names) == list(ref.names), what
        assert port.nrows == ref.nrows, what
        for nm in ref.names:
            rc, pc = ref.col(nm), port.col(nm)
            assert pc.type == rc.type, (what, nm)
            assert (pc.domain or None) == (rc.domain or None), (what, nm)
            if rc.type in ("string", "uuid"):
                assert list(pc.host_view()) == list(rc.host_view()), \
                    (what, nm)
            else:
                _same_values(rc.to_numpy(), pc.to_numpy(), (what, nm), tol)
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), what
        _same_values(ref, port, what, tol)
    elif isinstance(ref, str):
        assert port == ref, what
    else:
        _same_values([ref], [port], what, tol)


@pytest.mark.parametrize("expr", HOST_EXPRS)
def test_host_path_equals_reference(expr):
    with _sessions() as (rs, ps):
        ref, port = _both(expr, rs, ps)
        _same(ref, port, expr)


def test_assign_lookup_and_rm():
    with _sessions() as (rs, ps):
        for e in ('(tmp= doubled (* (cols_py data ["a"]) 2))',
                  "(sum doubled)"):
            _same(*_both(e, rs, ps), e)
        assert PDKV.get("doubled") is not None
        port_rapids.rapids("(rm doubled)", ps, device="cpu")
        assert PDKV.get("doubled") is None


def test_group_by_na_keys_order():
    """A categorical key's NA (code -1) forms the first group; a numeric
    key's NaN forms one group after every number (the reference's order
    when, as here, the NaN first appears after every other key)."""
    with _sessions() as (rs, ps):
        port = port_rapids.rapids('(GB GN ["g"] "count" "x" "all")', ps,
                         device="cpu")
        assert port.col("g").to_numpy()[0] != port.col("g").to_numpy()[0]
        assert port.col("nrow").to_numpy().tolist() == [1.0, 3.0, 2.0, 1.0]
        port = port_rapids.rapids('(GB GN ["k"] "count" "x" "all")', ps,
                         device="cpu")
        k = port.col("k").to_numpy()
        assert k[:3].tolist() == [1.0, 2.0, 3.0] and np.isnan(k[3])
        assert port.col("nrow").to_numpy().tolist() == [1.0, 3.0, 2.0, 1.0]


def test_merge_na_keys_never_match():
    with _sessions() as (rs, ps):
        out = port_rapids.rapids('(merge LN RN 0 0 [0] [0] "auto")', ps,
                        device="cpu")
        assert out.names == ["k", "v_x", "s", "v_y", "w"]
        assert not np.isnan(out.col("k").to_numpy()).any()
        left = port_rapids.rapids('(merge LN RN 1 0 [0] [0] "auto")', ps,
                         device="cpu")
        assert left.nrows == out.nrows + 3      # 1.0, NaN, NaN unmatched


# ----------------------------------------------------------- device path

def _device_cols(n=4096, seed=1):
    """tests/test_rapids_device.py's frame."""
    r = np.random.RandomState(seed)
    a = r.randn(n) * 4.0
    a[r.rand(n) < 0.05] = np.nan
    b = r.rand(n) * 5.0 + 0.5
    c = r.uniform(0.97, 1.03, n)
    g = np.array(["lvl%02d" % i for i in r.randint(0, 12, n)], object)
    return {"a": a, "b": b, "c": c, "g": g}


def device_exprs(key):
    """The device path's expressions (the reference's test_rapids_device
    set, the rest of its op table, and the string LUT)."""
    binops = ["+", "-", "*", "/", "^", "<", "<=", ">", ">=", "==", "!=",
              "&", "|", "intDiv", "%%"]
    es = [f'({op} (cols_py {key} ["a"]) (cols_py {key} ["b"]))'
          for op in binops]
    es += [f'({op} (cols_py {key} ["a"]) 2.5)'
           for op in ("+", "*", "<", "%%", "intDiv", "^")]
    es += [f'({op} 2.5 (cols_py {key} ["b"]))' for op in ("-", "/", "^")]
    es += [f'({op} (cols_py {key} ["a"]))'
           for op in ("abs", "floor", "ceiling", "trunc", "sign", "not",
                      "sin", "cos", "tanh", "atan", "sinh")]
    es += [f'({op} (cols_py {key} ["b"]))'
           for op in ("exp", "log", "sqrt", "log1p", "log10", "log2",
                      "tan", "cosh")]
    es += [f'({op} (cols_py {key} ["c"]) 0)'
           for op in ("cumsum", "cummax", "cummin", "cumprod")]
    es += [f'(is.na (cols_py {key} ["a"]))',
           f'(ifelse (> (cols_py {key} ["a"]) 0) '
           f'(cols_py {key} ["b"]) (cols_py {key} ["c"]))',
           f'(ifelse (> (cols_py {key} ["a"]) 0) 1 (cols_py {key} ["c"]))',
           f'(toupper (cols_py {key} ["g"]))',
           f'(sum (cols_py {key} ["b"]))', f'(mean (cols_py {key} ["a"]) 1)',
           f'(mean (cols_py {key} ["a"]))',
           f'(min (cols_py {key} ["b"]))', f'(max (cols_py {key} ["a"]) 1)']
    return es


def f32_sum_bound(terms: np.ndarray) -> float:
    """(n-1)·2^-24·Σ|x|: the float32 summation bound of ``terms``."""
    t = np.abs(np.asarray(terms, np.float64))
    t = t[~np.isnan(t)]
    return max(t.size - 1, 1) * U * float(t.sum())


def device_tolerance(expr, cols):
    """The tolerance the device path of ``expr`` is held to (None:
    EXACT), as the module docstring states."""
    head = expr[1:].split(" ")[0]
    if head in port_rapids.TRANSCENDENTAL:
        ulps = REF_ULPS.get(head, 2)
        return lambda ref, port: ulps * np.spacing(
            np.abs(ref).astype(np.float32)).astype(np.float64)
    if head in ("cumsum", "cumprod"):
        c = np.asarray(cols["c"], np.float64)
        x = np.log(c) if head == "cumprod" else c
        n = np.arange(1, c.size + 1)
        bound = np.maximum(n - 1, 1) * U * np.cumsum(np.abs(x))
        if head == "cumprod":       # relative error of the product
            return lambda ref, port: (bound + n * U) * np.abs(ref)
        return lambda ref, port: bound
    if head in ("sum", "mean"):
        col = expr.split('["')[1][0]
        b = f32_sum_bound(np.asarray(cols[col], np.float32))
        if head == "mean":
            b = b / np.count_nonzero(~np.isnan(cols[col])) + \
                U * np.nanmean(np.abs(cols[col]))
        return lambda ref, port: b
    return None


@pytest.mark.parametrize("expr", device_exprs("sd"))
def test_device_path_equals_reference(expr, monkeypatch):
    cols = _device_cols()
    monkeypatch.setattr(ref_rapids, "_DEV_MIN_ROWS", 1)
    monkeypatch.setattr(port_rapids, "_DEV_MIN_ROWS", 1)
    rs, ps = ref_rapids.Session(), port_rapids.Session()
    before = set(PDKV.keys())
    try:
        with _one_device():
            rs.assign("sd", h2o3_tpu.Frame.from_numpy(
                cols, categorical=["g"]))
        ps.assign("sd", h2o3_tpu_torch.Frame.from_numpy(
            cols, categorical=["g"], device="cpu"))
        r0, p0 = ref_rapids.DEV_OPS, port_rapids.DEV_OPS
        ref, port = _both(expr, rs, ps)
        assert ref_rapids.DEV_OPS > r0 and port_rapids.DEV_OPS > p0, expr
        _same(ref, port, expr, device_tolerance(expr, cols))
        head = expr[1:].split(" ")[0]
        if head in REF_ULPS:
            x = np.float32(cols["a"]).astype(np.float64)
            truth = getattr(np, head)(x)
            got = port.col("a").to_numpy()
            ok = ~np.isnan(truth)
            assert np.all(np.abs(got[ok] - truth[ok]) <= np.spacing(
                np.abs(truth[ok]).astype(np.float32))), expr
    finally:
        for k in set(PDKV.keys()) - before:
            PDKV.remove(k)


def test_device_eligibility_follows_the_reference_dtypes(monkeypatch):
    """Integer columns past int16 (the reference stores them int32) and
    string columns take the host path in both packages."""
    monkeypatch.setattr(ref_rapids, "_DEV_MIN_ROWS", 1)
    monkeypatch.setattr(port_rapids, "_DEV_MIN_ROWS", 1)
    cols = {"i8": np.arange(100, dtype=np.float64) - 50,
            "i32": np.arange(100, dtype=np.float64) * 1000,
            "f": np.linspace(0, 1, 100)}
    with _one_device():
        ref = h2o3_tpu.Frame.from_numpy(cols)
    port = h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu")
    for nm in cols:
        assert port_rapids._dev_col_ok(port.col(nm)) == ref_rapids._dev_col_ok(ref.col(nm))
    assert not port_rapids._dev_col_ok(port.col("i32"))
    assert port_rapids._dev_col_ok(port.col("i8")) and port_rapids._dev_col_ok(port.col("f"))
