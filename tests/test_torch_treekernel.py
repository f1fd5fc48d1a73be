"""Level parity: the port's ``fused_level`` on the CPU (the plain versions
of the three CUDA kernels) against the reference's fused Pallas kernel
(``ops/pallas/treekernel.py fused_level`` in interpret mode on a
1-device mesh, the single-shard ``_fused_call``), levels 0..2.

Stats are dyadic — small integers — so every float32 sum is exact in any
order and the whole 10-tuple must be EXACTLY equal. Also: the split scan
on its edge cases (all gains -inf, NaN Newton keys, empty bins), the
plain histogram and routing against the reference's XLA ops."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from h2o3_tpu.models.tree import TreeScalars as RefScalars
from h2o3_tpu.ops.pallas import treekernel as ref_tk
from h2o3_tpu.ops.split_scan import best_splits as ref_best_splits
from h2o3_tpu_torch.models.tree import TreeScalars
from h2o3_tpu_torch.ops.kernels import treekernel as tk
from h2o3_tpu_torch.ops.split_scan import best_splits

import torch_ranks as tr
from torch_threads import one_torch_thread  # noqa: F401 - autouse

OUT_NAMES = ("hist", "gain", "feat", "thresh", "na_left", "left_val",
             "right_val", "leftmask", "split", "new_nid")


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _sweep(bins, stats, B, depth, is_cat, cons, lo, hi, cm_of, scal):
    """(reference outputs, port outputs) per level; each side routes
    with its own node ids."""
    min_rows, lam, msi, dl = scal
    sc_r = RefScalars(jnp.float32(min_rows), jnp.float32(lam),
                      jnp.float32(msi), jnp.int32(dl))
    sc_p = TreeScalars(torch.tensor(min_rows), torch.tensor(lam),
                       torch.tensor(msi), torch.tensor(dl, dtype=torch.int32))
    mesh = _mesh1()
    nb = np.full(bins.shape[1], B - 1, np.int32)
    j = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a))

    @jax.jit
    def ref_sweep(bins, stats):
        outs, prev = [], None
        nid = jnp.zeros((bins.shape[0],), jnp.int32)
        for d in range(depth + 1):
            out = ref_tk.fused_level(
                bins, nid, stats, prev, jnp.asarray(cm_of(d)),
                jnp.asarray(nb), j(is_cat), j(cons), jnp.asarray(lo),
                jnp.asarray(hi), sc_r, d=d, n_nodes=2 ** d, n_bins=B,
                block_rows=128, mesh=mesh, interpret=True)
            outs.append(out)
            prev, nid = out[0], out[-1]
        return outs

    ref = ref_sweep(jnp.asarray(bins), jnp.asarray(stats))
    port, prev = [], None
    nid = torch.zeros(bins.shape[0], dtype=torch.int32)
    for d in range(depth + 1):
        out = tk.fused_level(
            t(bins), nid, t(stats), prev, t(cm_of(d)), t(nb), t(is_cat),
            t(cons), t(lo), t(hi), sc_p, d=d, n_nodes=2 ** d, n_bins=B)
        port.append(out)
        prev, nid = out[0], out[-1]
    return ref, port


def _assert_equal(ref, port):
    for d, (o_r, o_p) in enumerate(zip(ref, port)):
        for name, a, b in zip(OUT_NAMES, o_r, o_p):
            a = np.asarray(a)
            b = b.numpy()
            assert a.dtype == b.dtype, (d, name, a.dtype, b.dtype)
            np.testing.assert_array_equal(
                b, a, err_msg=f"level {d} output '{name}' diverged")


@pytest.mark.parametrize("case", ["numeric", "categorical",
                                  "constraints_depth_limit",
                                  "per_node_col_mask"])
def test_level_parity_with_pallas_kernel(case):
    bins, stats, B, is_cat, cons, lo, hi, masks, scal = tr.level_case(case)
    ref, port = _sweep(bins, stats, B, 2, is_cat, cons, lo, hi,
                       masks.__getitem__, scal)
    _assert_equal(ref, port)


def _edge_hist(case):
    """[L=2, F=3, B=6, 3] histograms for the split-scan edge cases."""
    r = np.random.RandomState(21)
    L, F, B = 2, 3, 6
    w = r.randint(1, 5, (L, F, B)).astype(np.float32)
    g = r.randint(-6, 7, (L, F, B)).astype(np.float32)
    h = r.randint(1, 4, (L, F, B)).astype(np.float32)
    cm = np.ones(F, bool)
    lam = 1.0
    if case == "empty_bins":
        w[:, :, [1, 3]] = 0.0
        g[:, :, [1, 3]] = 0.0
        h[:, :, [1, 3]] = 0.0
    elif case == "nan_keys":
        # h + λ + 1e-10 == 0 with g == 0: the Newton key is 0/0 = NaN
        lam = 0.0
        w[:, :, [0, 2]] = 1.0
        h[:, :, [0, 2]] = np.float32(-1e-10)
        g[:, :, [0, 2]] = 0.0
    elif case == "all_masked":
        cm = np.zeros(F, bool)          # every gain is -inf → index 0
    hist = np.stack([w, w * g, w * h], axis=-1).astype(np.float32)
    return hist, cm, lam


@pytest.mark.parametrize("case", ["all_masked", "nan_keys", "empty_bins"])
def test_best_splits_edge_cases(case):
    hist, cm, lam = _edge_hist(case)
    F, B = hist.shape[1], hist.shape[2]
    nb = np.full(F, B - 1, np.int32)
    is_cat = np.array([True, False, True])
    ref = ref_best_splits(jnp.asarray(hist), jnp.asarray(nb), jnp.asarray(cm),
                          min_rows=jnp.float32(1.0),
                          reg_lambda=jnp.float32(lam),
                          is_cat=jnp.asarray(is_cat))
    port = best_splits(torch.from_numpy(hist), torch.from_numpy(nb),
                       torch.from_numpy(cm), min_rows=torch.tensor(1.0),
                       reg_lambda=torch.tensor(lam),
                       is_cat=torch.from_numpy(is_cat))
    for i, (a, b) in enumerate(zip(ref, port)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"output {i}")
    if case == "all_masked":
        assert (port[1] == 0).all() and (port[2] == 0).all()
        assert torch.isneginf(port[0]).all()


def test_plain_histogram_matches_reference_xla_histogram():
    """The plain ``tree_hist`` at a sibling level (left children only,
    into the parent slot) equals the reference's XLA histogram of the
    same rows with odd-node weights zeroed."""
    from h2o3_tpu.ops.histogram import histogram as ref_histogram
    bins, stats, r = tr.dyadic_inputs(n=512, seed=9)
    B = 17
    nid = r.randint(0, 4, bins.shape[0]).astype(np.int32)
    w, wg, wh = stats[:, 0], stats[:, 1], stats[:, 2]
    g = np.where(w > 0, wg, 0).astype(np.float32)
    h = np.where(w > 0, wh, 0).astype(np.float32)
    even = (nid % 2 == 0).astype(np.float32)
    ref = ref_histogram(jnp.asarray(bins), jnp.asarray(nid >> 1),
                        jnp.asarray(w * even), jnp.asarray(g),
                        jnp.asarray(h), n_nodes=2, n_bins=B,
                        mesh=_mesh1())
    port = tk.tree_hist(torch.from_numpy(bins), torch.from_numpy(nid),
                        torch.from_numpy(stats), d=2, n_nodes_h=2, n_bins=B)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_plain_partition_matches_reference_routing():
    """The plain ``tree_partition`` equals the reference's
    ``_level_goleft`` on the same node decisions."""
    from h2o3_tpu.models.tree import _level_goleft, _pack_leftmask
    r = np.random.RandomState(13)
    n, F, B, L = 600, 5, 40, 8
    bins = r.randint(0, B, (n, F)).astype(np.int8)
    nid = r.randint(0, L, n).astype(np.int32)
    feat = r.randint(0, F, L).astype(np.int32)
    thresh = r.randint(0, B - 1, L).astype(np.int32)
    nal = r.rand(L) > 0.5
    split = r.rand(L) > 0.2
    cs = (r.rand(L) > 0.5) & split
    lm = r.rand(L, B - 1) > 0.5
    W = (B - 1 + 31) // 32
    words = jnp.where(jnp.asarray(cs)[:, None],
                      _pack_leftmask(jnp.asarray(lm), W), 0)
    ref = _level_goleft(jnp.where(jnp.asarray(split), jnp.asarray(feat), 0),
                        jnp.where(jnp.asarray(split), jnp.asarray(thresh), B),
                        jnp.asarray(nal & split), jnp.asarray(split),
                        jnp.asarray(cs), words, jnp.asarray(nid),
                        jnp.asarray(bins), B)
    t = torch.from_numpy
    port = tk.tree_partition(t(bins), t(nid), t(feat), t(thresh), t(nal),
                             t(split), t(cs), t(lm), n_bins=B)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
