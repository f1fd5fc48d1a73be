"""The device merge of the PyTorch port (``ops/merge.device_merge``) on
the CPU, held against the reference's ``device_merge`` on the same
frames.

The cases are the reference's own (tests/test_sort_merge.py: a two-key
join with NA keys, categorical keys with differing domains, the budget
guard, integer keys above 2^24, inner and left joins) plus mixed key
types, name collisions, NA in value columns, a join with no match, the
budget's exact edge and every input the reference sends to its host
path. Each joined frame equals the reference's EXACTLY: names, types,
domains, NA masks, the float64 host and float32 numeric views bit for
bit (the rows in the reference's order: left rows in order, each one's
matches in right-row order). Both return None on the same inputs. The
reference runs on one device (``_one_device``)."""

import sys
from pathlib import Path

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.ops import merge as ref_merge
from h2o3_tpu_torch.ops import merge as port_merge

from test_torch_ingest import _assert_frames
from test_torch_isofor import _one_device
from torch_threads import one_torch_thread  # noqa: F401 - autouse

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

N = ref_merge.DEVICE_MERGE_MIN_ROWS + 1234


def _frames(cols, categorical=(), domains=None):
    with _one_device():
        ref = h2o3_tpu.Frame.from_numpy(cols, categorical=categorical,
                                        domains=domains)
    port = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=categorical,
                                           domains=domains, device="cpu")
    return ref, port


def _merge_both(left, right, keys, how):
    """(reference result, port result), EXACTLY equal (or both None)."""
    with _one_device():
        ref = ref_merge.device_merge(left[0], right[0], keys, how)
    port = port_merge.device_merge(left[1], right[1], keys, how)
    assert (ref is None) == (port is None), (how, ref, port)
    if ref is not None:
        _assert_frames(ref, port)
    return ref, port


def test_merge_multikey_with_na_keys():
    r = np.random.RandomState(7)
    k1 = r.randint(0, 200, N).astype(float)
    k2 = r.randint(0, 5, N).astype(float)
    k1[::101] = np.nan
    nr = N // 3
    rk1 = r.randint(100, 300, nr).astype(float)
    rk2 = r.randint(0, 5, nr).astype(float)
    rk2[::53] = np.nan
    lf = _frames({"k1": k1, "k2": k2, "lv": np.arange(N, dtype=float)})
    rf = _frames({"k1": rk1, "k2": rk2, "rv": np.arange(nr, dtype=float)})
    for how in ("inner", "left"):
        _, port = _merge_both(lf, rf, ["k1", "k2"], how)
        li, ri = cs.host_join([k1, k2], [rk1, rk2], how)
        cs.check_join(port, li, ri, ("lv", np.arange(N, dtype=float)),
                      ("rv", np.arange(nr, dtype=float)), how)


def test_merge_categorical_key_domain_remap():
    r = np.random.RandomState(8)
    card = 512
    ldom = ["L%03d" % i for i in range(card)]
    rdom = ["L%03d" % i for i in range(1, card + 1)]   # L512 unseen
    lcode = r.randint(0, card, N)
    rcode = r.randint(0, card, N // 4)
    lcode[::97] = -1                                    # NA keys
    lf = _frames({"k": lcode.astype(np.int32),
                  "lv": np.arange(N, dtype=float)}, domains={"k": ldom})
    rf = _frames({"k": rcode.astype(np.int32),
                  "rv": np.arange(N // 4, dtype=float)}, domains={"k": rdom})
    for how in ("inner", "left"):
        _, port = _merge_both(lf, rf, ["k"], how)
        assert port.col("k").domain == ldom


def test_budget_guard_refuses_quadratic_join(monkeypatch):
    monkeypatch.setenv("H2O3TPU_MERGE_MAX_OUT_BYTES", str(1 << 30))
    r = np.random.RandomState(9)
    dom = ["a", "b", "c", "d"]
    lf = _frames({"k": r.randint(0, 4, N).astype(np.int32),
                  "lv": np.arange(N, dtype=float)}, domains={"k": dom})
    rf = _frames({"k": r.randint(0, 4, N // 4).astype(np.int32),
                  "rv": np.arange(N // 4, dtype=float)}, domains={"k": dom})
    assert _merge_both(lf, rf, ["k"], "inner") == (None, None)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_budget_edge_both_sides(monkeypatch, how):
    """A 4-level join whose result needs exactly B bytes (9 a cell): at
    budget B both packages join on the device, at B - 1 both decline."""
    r = np.random.RandomState(10)
    dom = ["a", "b", "c", "d", "e"]
    lk = r.randint(0, 5, N)
    rk = r.randint(0, 4, 40)                      # "e" never on the right
    lf = _frames({"k": lk.astype(np.int32), "lv": np.arange(N, dtype=float)},
                 domains={"k": dom})
    rf = _frames({"k": rk.astype(np.int32),
                  "rv": np.arange(40, dtype=float)}, domains={"k": dom})
    per = np.bincount(rk, minlength=5)[lk]
    total = int((np.maximum(per, 1) if how == "left" else per).sum())
    need = total * 3 * 9
    monkeypatch.setenv("H2O3TPU_MERGE_MAX_OUT_BYTES", str(need))
    ref, port = _merge_both(lf, rf, ["k"], how)
    assert port is not None and port.nrows == total
    monkeypatch.setenv("H2O3TPU_MERGE_MAX_OUT_BYTES", str(need - 1))
    assert _merge_both(lf, rf, ["k"], how) == (None, None)


def test_merge_int_keys_exact_above_f32():
    base = 20_000_000
    lk = base + np.arange(N)
    rk = base + np.arange(0, N, 7)
    lf = _frames({"k": lk.astype(np.int64), "lv": np.arange(N, dtype=float)})
    rf = _frames({"k": rk.astype(np.int64),
                  "rv": np.arange(len(rk), dtype=float)})
    for how in ("inner", "left"):
        _, port = _merge_both(lf, rf, ["k"], how)
        want = lk[::7] if how == "inner" else lk
        np.testing.assert_array_equal(port.col("k").host_view(), want)
    assert port.col("k").host_view()[1] == base + 1   # not its float32


@pytest.mark.parametrize("how", ["inner", "left"])
def test_merge_inner_and_left(how):
    r = np.random.RandomState(2)
    lk = r.randint(0, 1000, N).astype(float)
    rk = r.randint(500, 1500, N // 3).astype(float)
    lf = _frames({"k": lk, "lv": np.arange(N, dtype=float)})
    rf = _frames({"k": rk, "rv": np.arange(len(rk), dtype=float)})
    _, port = _merge_both(lf, rf, ["k"], how)
    li, ri = cs.host_join([lk], [rk], how)
    cs.check_join(port, li, ri, ("lv", np.arange(N, dtype=float)),
                  ("rv", np.arange(len(rk), dtype=float)), how)


def test_merge_mixed_key_types_collisions_and_value_nas():
    """An integer key against a float one compares as float32 (so keys
    above 2^24 that round alike match, as in the reference); columns
    both frames hold get _x/_y; NA and categorical value columns carry
    over, a left join's unmatched rows NA on the right."""
    r = np.random.RandomState(11)
    lk = (2 ** 24 + r.randint(0, 3000, N)).astype(float)
    rk = (2 ** 24 + r.randint(0, 3000, 900)).astype(float) + 0.25
    rk[::5] = np.round(rk[::5])
    v = r.randn(N)
    v[::13] = np.nan
    lf = _frames({"k": lk, "v": v, "g": r.choice(["p", "q"], N)},
                 categorical=["g"])
    rv = r.randn(900)
    rv[::3] = np.nan
    rf = _frames({"k": rk, "v": rv, "h": r.choice(["x", "y", "z"], 900),
                  "i": r.randint(-5, 5, 900).astype(float)},
                 categorical=["h"])
    for how in ("inner", "left"):
        _, port = _merge_both(lf, rf, ["k"], how)
        assert port.names == ["k", "v_x", "g", "v_y", "h", "i"]


def test_merge_declines_as_the_reference(monkeypatch):
    r = np.random.RandomState(12)
    big = _frames({"k": r.randint(0, 50, N).astype(float),
                   "a": r.randn(N)})
    rgt = _frames({"k": np.arange(50.0), "b": r.randn(50)})
    small = _frames({"k": np.arange(100.0), "c": np.arange(100.0)})
    cat = _frames({"k": np.array(["u", "v"] * 25, object),
                   "b": np.arange(50.0)})
    s_cols = {"k": np.arange(50.0), "s": np.arange(50).astype(str)}
    with _one_device():
        strs = (h2o3_tpu.Frame.from_numpy(s_cols, strings=["s"]),
                h2o3_tpu_torch.Frame.from_numpy(s_cols, strings=["s"],
                                                device="cpu"))
    for how in ("right", "outer"):
        assert _merge_both(big, rgt, ["k"], how) == (None, None)
    assert _merge_both(big, rgt, [], "inner") == (None, None)
    assert _merge_both(small, small, ["k"], "inner") == (None, None)
    assert _merge_both(big, cat, ["k"], "inner") == (None, None)
    assert _merge_both(big, strs, ["k"], "left") == (None, None)
    # no match at all: both return the zero-row frame of the join
    far = _frames({"k": np.arange(1000.0, 1050.0), "b": r.randn(50),
                   "a": r.randn(50)})
    ref, port = _merge_both(big, far, ["k"], "inner")
    assert port.nrows == 0 and port.names == ["k", "a_x", "b", "a_y"]


def test_merged_host_views_are_lazy():
    """The merge leaves each output column's host view to its first
    ``host_view()``; the device data is ready at once."""
    r = np.random.RandomState(13)
    lf = _frames({"k": r.randint(0, 100, N).astype(float),
                  "v": np.arange(N, dtype=float)})
    rf = _frames({"k": np.arange(100.0), "w": r.randn(100)})
    port = port_merge.device_merge(lf[1], rf[1], ["k"], "left")
    assert all(port.col(c).host is None for c in port.names)
    assert port.col("v").host_view() is port.col("v").host_view()
    assert port.col("v").host_fn is None
