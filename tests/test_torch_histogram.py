"""The port's ``histogram`` entry point on the CPU (the plain version of
the ``histogram`` CUDA kernel) against the reference package's
``histogram`` / ``_local_histogram`` (XLA one-hot matmuls) and its Pallas
kernel ``pallas_local_histogram`` in interpret mode.

Shapes are those of tests/test_pallas_histogram.py. With small-integer
stats every float32 sum is exact in any order, so the outputs must be
EXACTLY equal; with real-valued stats they agree within rtol 1e-5,
atol 1e-4 (the two packages add in different orders)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from h2o3_tpu.ops.histogram import _local_histogram
from h2o3_tpu.ops.histogram import histogram as ref_histogram
from h2o3_tpu.ops.pallas_histogram import pallas_local_histogram
from h2o3_tpu_torch.ops import kernels
from h2o3_tpu_torch.ops.histogram import (histogram, local_histogram,
                                          plain_histogram)
from h2o3_tpu_torch.ops.kernels.histogram import full_histogram
from torch_threads import one_torch_thread  # noqa: F401 - autouse

SHAPES = [(1, 17, 4, 300), (8, 33, 7, 1000), (32, 65, 12, 2048)]


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _inputs(L, B, F, N, integer, seed=0):
    r = np.random.RandomState(seed)
    bins = r.randint(0, B, (N, F)).astype(np.int32)
    nid = r.randint(0, L, N).astype(np.int32)
    if integer:
        # uplift's stats: {w, w·y, w} with w, y in {0, 1}
        w = (r.rand(N) > 0.3).astype(np.float32)
        g = (r.rand(N) > 0.8).astype(np.float32)
        h = np.ones(N, np.float32)
    else:
        w = r.rand(N).astype(np.float32)
        w[r.rand(N) < 0.1] = 0.0   # padding-row zeros
        g = r.randn(N).astype(np.float32)
        h = r.rand(N).astype(np.float32)
    return bins, nid, w, g, h


def _assert_close(port, ref, integer):
    if integer:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
@pytest.mark.parametrize("L,B,F,N", SHAPES)
def test_histogram_matches_reference_histogram(L, B, F, N, integer):
    bins, nid, w, g, h = _inputs(L, B, F, N, integer)
    ref = ref_histogram(jnp.asarray(bins), jnp.asarray(nid), jnp.asarray(w),
                        jnp.asarray(g), jnp.asarray(h), n_nodes=L, n_bins=B,
                        mesh=_mesh1())
    t = torch.from_numpy
    kernels.reset_counts()
    port = histogram(t(bins), t(nid), t(w), t(g), t(h), n_nodes=L, n_bins=B)
    assert port.shape == (L, F, B, 3) and port.dtype == torch.float32
    assert kernels.LAUNCHES["histogram"] == 0   # CPU: the plain version
    _assert_close(port.numpy(), np.asarray(ref), integer)
    np.testing.assert_array_equal(
        plain_histogram(t(bins), t(nid), t(w), t(g), t(h), n_nodes=L,
                        n_bins=B).numpy(), port.numpy())


@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
@pytest.mark.parametrize("L,B,F,N", SHAPES)
def test_local_histogram_matches_pallas_kernel(L, B, F, N, integer):
    bins, nid, w, g, h = _inputs(L, B, F, N, integer, seed=1)
    stats = np.stack([w, w * g, w * h], axis=1).astype(np.float32)
    pal = pallas_local_histogram(jnp.asarray(bins), jnp.asarray(nid),
                                 jnp.asarray(stats), L, B, block_rows=256,
                                 interpret=True)
    xla = _local_histogram(jnp.asarray(bins), jnp.asarray(nid),
                           jnp.asarray(stats), L, B, block_rows=256)
    t = torch.from_numpy
    port = full_histogram(t(bins), t(nid), t(stats), n_nodes=L, n_bins=B)
    _assert_close(port.numpy(), np.asarray(pal), integer)
    _assert_close(port.numpy(), np.asarray(xla), integer)


def test_int8_bins_equal_int32_bins():
    bins, nid, w, g, h = _inputs(8, 65, 12, 1500, True, seed=2)
    stats = torch.from_numpy(np.stack([w, w * g, w * h], 1))
    a = full_histogram(torch.from_numpy(bins.astype(np.int8)),
                       torch.from_numpy(nid), stats, n_nodes=8, n_bins=65)
    b = full_histogram(torch.from_numpy(bins), torch.from_numpy(nid), stats,
                       n_nodes=8, n_bins=65)
    assert torch.equal(a, b)


def test_out_of_range_rows_and_bins_contribute_nothing():
    """A row whose nid lies outside [0, L), or a bin outside [0, B),
    adds nothing — the reference's one-hot row is all zeros there."""
    L, B, F, N = 4, 9, 3, 400
    bins, nid, w, g, h = _inputs(L, B, F, N, True, seed=3)
    nid[::7] = L + 2
    nid[1::11] = -1
    bins[::5, 1] = B + 3
    bins[2::13, 2] = -2
    ref = _local_histogram(jnp.asarray(bins), jnp.asarray(nid),
                           jnp.stack([jnp.asarray(w), jnp.asarray(w * g),
                                      jnp.asarray(w * h)], axis=1),
                           L, B, block_rows=128)
    t = torch.from_numpy
    port = local_histogram(t(bins), t(nid),
                           torch.stack([t(w), t(w * g), t(w * h)], 1),
                           n_nodes=L, n_bins=B)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    keep = (nid >= 0) & (nid < L)
    assert float(port[..., 0].sum(dim=(0, 2))[0]) == float(w[keep].sum())


def test_nan_stat_stays_in_its_slot():
    bins = torch.tensor([[0, 1], [0, 1]], dtype=torch.int8)
    nid = torch.zeros(2, dtype=torch.int32)
    stats = torch.tensor([[1.0, float("nan"), 2.0], [1.0, 3.0, 4.0]])
    out = full_histogram(bins, nid, stats, n_nodes=1, n_bins=3)
    assert torch.isnan(out[0, 0, 0, 1]) and torch.isnan(out[0, 1, 1, 1])
    assert out[0, 0, 0, 0] == 2.0 and out[0, 0, 0, 2] == 6.0
    assert not torch.isnan(out[0, :, 2]).any()
