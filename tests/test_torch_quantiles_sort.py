"""Quantiles, the device sort and the join index of the PyTorch port (on
the CPU) against the reference package.

Quantiles: up to 4,000,000 rows both packages sort the float64 host view
(the input values), so every ``combine_method`` is EXACT. Above that
both bracket the rank with 1024-bin float32 histograms on the device;
the bins are computed in float32 by the same expressions and the counts
are exact, so ``_values_at_ranks`` of the two packages is EXACT on a
small column too (called directly: the path starts above 4M rows).

Sort: a stable sort a key, minor to major, NA keys last, padding rows
last: the permutation (read off a row-id column) is the reference's
EXACTLY, ties, NAs and descending keys included; a key of integers
beyond ±2^24 and frames under ``DEVICE_SORT_MIN_ROWS`` take the host
path (None) in both. The join index pairs are the reference's EXACTLY.
The reference's frames live on a one-device mesh (``_one_device``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.frame import quantiles as ref_q
from h2o3_tpu.ops import sort as ref_sort
from h2o3_tpu_torch.frame import quantiles as port_q
from h2o3_tpu_torch.ops import sort as port_sort

from test_torch_isofor import _one_device
from torch_threads import one_torch_thread  # noqa: F401 - autouse

PROBS = (0.001, 0.01, 0.1, 0.25, 0.333, 0.5, 0.667, 0.75, 0.9, 0.99, 0.999)
N_SORT = 70_001                  # above DEVICE_SORT_MIN_ROWS, not 8k


def q_cols(n=3001, seed=2):
    r = np.random.RandomState(seed)
    x = r.lognormal(0, 1.5, n)
    x[::37] = np.nan
    return {"x": x, "k": r.randint(0, 50, n).astype(np.float64),
            "c": r.choice(["a", "b"], n)}


@pytest.mark.parametrize("method", ["interpolate", "average", "low", "high"])
def test_host_quantiles_exact(method):
    cols = q_cols()
    with _one_device():
        ref = ref_q.frame_quantiles(h2o3_tpu.Frame.from_numpy(cols), PROBS,
                                    combine_method=method)
    got = port_q.frame_quantiles(
        h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu"), PROBS,
        combine_method=method)
    assert set(got) == set(ref) == {"probs", "x", "k"}
    for k in ("x", "k"):
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_device_values_at_ranks_exact(seed):
    r = np.random.RandomState(seed)
    x = np.concatenate([r.randn(4000), r.randint(0, 9, 1000)]).astype(
        np.float32)
    w = (r.rand(len(x)) < 0.97).astype(np.float32)
    x0 = np.where(w > 0, x, 0).astype(np.float32)
    total = float(w.sum())
    ranks = np.unique(np.floor(np.array(PROBS) * (total - 1)))
    ranks = np.unique(np.r_[ranks, ranks + 1, 0, total - 1])
    gmin, gmax = float(x[w > 0].min()), float(x[w > 0].max())
    with _one_device():
        ref = ref_q._values_at_ranks(jnp.asarray(x0), jnp.asarray(w), ranks,
                                     gmin, gmax, 4)
    got = port_q._values_at_ranks(torch.from_numpy(x0), torch.from_numpy(w),
                                  ranks, gmin, gmax, 4)
    np.testing.assert_array_equal(got, ref)
    # four rounds resolve the order statistics
    srt = np.sort(x[w > 0]).astype(np.float64)
    np.testing.assert_allclose(got, srt[ranks.astype(int)], rtol=0,
                               atol=4 * np.spacing(np.float32(gmax - gmin)))


def sort_cols(n=N_SORT, seed=4):
    r = np.random.RandomState(seed)
    a = r.randint(0, 30, n).astype(np.float64)
    a[r.rand(n) < 0.02] = np.nan
    b = np.round(r.randn(n), 1)
    b[r.rand(n) < 0.02] = np.nan
    return {"a": a, "b": b, "g": r.choice(["x", "y", "z"], n),
            "rid": np.arange(n, dtype=np.float64)}


def _perm(fr) -> np.ndarray:
    return fr.col("rid").to_numpy()


@pytest.mark.parametrize("keys,asc", [
    (["a"], [True]), (["a", "b"], [True, False]), (["g", "b"], [False, True]),
    (["b", "a"], [False, False])])
def test_device_sort_permutation_exact(keys, asc):
    cols = sort_cols()
    with _one_device():
        ref = ref_sort.device_sort(h2o3_tpu.Frame.from_numpy(cols), keys, asc)
        p_ref = _perm(ref)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu")
    got = port_sort.device_sort(fr, keys, asc)
    np.testing.assert_array_equal(_perm(got), p_ref)
    assert got.nrows == fr.nrows and got.nrows_padded == fr.nrows_padded
    # every column moved with its row, device data and host view alike
    p = p_ref.astype(np.int64)
    for k in ("a", "b", "g"):
        np.testing.assert_array_equal(got.col(k).host_view(),
                                      fr.col(k).host_view()[p])
        np.testing.assert_array_equal(
            got.col(k).data[:fr.nrows].numpy(),
            fr.col(k).data[:fr.nrows].numpy()[p])
    assert got.col("g").domain == fr.col("g").domain
    assert bool(got.col("a").na_mask[fr.nrows:].all())


def test_device_sort_declines_as_the_reference():
    """Under DEVICE_SORT_MIN_ROWS rows, with a string column, or on an
    integer key beyond ±2^24 (a float64 id column), both return None;
    such a key within range sorts on the device."""
    small = sort_cols(n=1000)
    big = dict(sort_cols(), ids=np.arange(N_SORT) * 1000.0 + 2.0 ** 24)
    fine = dict(sort_cols(), ids=np.arange(N_SORT, 0, -1) * 100.0)
    with _one_device():
        assert ref_sort.device_sort(h2o3_tpu.Frame.from_numpy(small), ["a"],
                                    [True]) is None
        assert ref_sort.device_sort(h2o3_tpu.Frame.from_numpy(big), ["ids"],
                                    [True]) is None
        p_ref = _perm(ref_sort.device_sort(h2o3_tpu.Frame.from_numpy(fine),
                                           ["ids"], [True]))
    pf = lambda c, **kw: h2o3_tpu_torch.Frame.from_numpy(  # noqa: E731
        c, device="cpu", **kw)
    assert port_sort.device_sort(pf(small), ["a"], [True]) is None
    assert port_sort.device_sort(pf(big), ["ids"], [True]) is None
    assert port_sort.device_sort(pf(sort_cols(), strings=["g"]), ["a"],
                                 [True]) is None
    assert not port_sort._f32_safe(pf(big).col("ids"))
    assert port_sort._f32_safe(pf(big).col("b"))
    np.testing.assert_array_equal(
        _perm(port_sort.device_sort(pf(fine), ["ids"], [True])), p_ref)


@pytest.mark.parametrize("kind", ["float", "nan"])
def test_join_index_pairs_exact(kind):
    r = np.random.RandomState(7)
    lk = r.randint(0, 400, 3001).astype(np.float32)
    rk = r.randint(0, 300, 1003).astype(np.float32)
    if kind == "nan":
        lk[::11] = np.nan
        rk[::13] = np.nan
    with _one_device():
        l_r, r_r = ref_sort.device_join_index(jnp.asarray(lk),
                                              jnp.asarray(rk), 3001, 1003)
    l_p, r_p = port_sort.device_join_index(torch.from_numpy(lk),
                                           torch.from_numpy(rk), 3001, 1003)
    np.testing.assert_array_equal(l_p, l_r)
    np.testing.assert_array_equal(r_p, r_r)
    # the pairs are the equi-join's
    pairs = {(i, j) for i in range(3001) for j in np.flatnonzero(
        rk == lk[i])}
    assert set(zip(l_p.tolist(), r_p.tolist())) == pairs
