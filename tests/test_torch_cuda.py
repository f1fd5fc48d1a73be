"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker ``gpu``; each test skips without a CUDA device).

Run on a machine with an NVIDIA GPU, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py boots the JAX reference cloud, and
these tests use neither JAX nor the reference package.)

The checks are those of chip_smoke.py phases 2, 3, 6, 7 and 10 at small
shapes: with small-integer stats every output is EXACTLY equal; with
real-valued stats histograms agree within the float32 summation bound
(2·n·2^-24·Σ|x| for a cell of n rows) and a split decision may differ
only at a near-tie. The slab histogram (``tree_hist``/``histogram``) is
also held at the plan's edges: many node chunks (rows sorted by chunk),
feature groups, slab copies, NaN stats, out-of-range ids and bins, and
views that start off a 16-byte boundary."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from h2o3_tpu_torch.ops import kernels  # noqa: E402
from h2o3_tpu_torch.ops.kernels import treekernel as tk  # noqa: E402

pytestmark = pytest.mark.gpu

N = 20_000
# shared memory of the warps' row queues beside the slab (slab_geometry)
QUEUE = kernels.SLAB_THREADS // 32 * kernels.SLAB_QUEUE * 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bm(dev, n=N):
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    cols, domains = cs.airlines_arrays(n)
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    x = [c for c in cols if c != "IsDepDelayed"]
    return bin_frame(fr, x, nbins=64, nbins_cats=1024)


def _chain(bins, stats, ops, B, depth, exact):
    nid = torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)
    prev = None
    flips = 0
    for d in range(depth):
        _, f, out_p, nid = cs.compare_level(tk, bins, nid, stats, prev, ops,
                                            d=d, L=2 ** d, B=B, exact=exact)
        prev = out_p[0]
        flips += f
    return flips


@pytest.mark.parametrize("label", ["dyadic", "real"])
def test_flagship_levels_kernels_vs_plain(dev, label):
    bm = _bm(dev)
    _, sc, is_cat, cm, lo, hi = cs.level_plan(bm, torch, dev)
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    stats = (cs.dyadic_stats if label == "dyadic" else cs.real_stats)(
        bm.bins.shape[0], 1, torch, dev)
    kernels.reset_counts()
    _chain(bm.bins, stats, ops, bm.nbins_total, 6, exact=label == "dyadic")
    assert kernels.LAUNCHES == {"tree_hist": 6, "tree_split": 6,
                                "tree_partition": 6, "histogram": 0,
                                "shard_hist": 0, "shard_partition": 0}


def test_constraints_bounds_and_node_masks(dev):
    """Monotone constraints, per-node [L] bounds and an [L, F] column
    mask through the kernel, exact on dyadic stats."""
    bm = _bm(dev)
    _, sc, is_cat, _, _, _ = cs.level_plan(bm, torch, dev)
    F, B = bm.bins.shape[1], bm.nbins_total
    r = np.random.RandomState(3)
    stats = cs.dyadic_stats(bm.bins.shape[0], 2, torch, dev)
    cons = torch.tensor([1, -1, 0, 0, 1, 0, 0, 0, 0, -1], dtype=torch.int8,
                        device=dev)
    nid = torch.zeros(bm.bins.shape[0], dtype=torch.int32, device=dev)
    prev = None
    for d in range(4):
        L = 2 ** d
        cm = torch.from_numpy((r.rand(L, F) > 0.3) | (np.arange(F) == 0)).to(dev)
        lo = torch.from_numpy(-r.rand(L).astype(np.float32)).to(dev)
        hi = torch.from_numpy(r.rand(L).astype(np.float32)).to(dev)
        ops = tk.level_operands(cm, bm.nbins, is_cat, cons, lo, hi, sc, dev)
        _, _, out_p, nid = cs.compare_level(tk, bm.bins, nid, stats, prev,
                                            ops, d=d, L=L, B=B, exact=True)
        prev = out_p[0]


def test_node_chunked_histogram_depth_bucket_10(dev, monkeypatch):
    """Lh = 256 parents (depth bucket 10), with the slab budget cut so the
    histogram runs in many node chunks (7 nodes a chunk: 37 chunks), then
    so that one node's features split into groups (3 features a group)."""
    bm = _bm(dev)
    _, sc, is_cat, cm, lo, hi = cs.level_plan(bm, torch, dev)
    B = bm.nbins_total
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    r = np.random.RandomState(4)
    nid = torch.from_numpy(r.randint(0, 512, N).astype(np.int32)).to(dev)
    stats = cs.dyadic_stats(N, 5, torch, dev)
    prev = tk.hist_plain(bm.bins, nid >> 1, stats, d=0, n_nodes_h=256,
                         n_bins=B)
    F = bm.bins.shape[1]
    for slab in (tk.HIST_SLAB_BYTES, 7 * F * B * 12 + QUEUE,
                 3 * B * 12 + QUEUE):
        monkeypatch.setattr(tk, "HIST_SLAB_BYTES", slab)
        cs.compare_level(tk, bm.bins, nid, stats, prev, ops, d=9, L=512,
                         B=B, exact=True)


def test_int32_bins_wide_histogram(dev):
    B, F = 200, 6
    r = np.random.RandomState(6)
    bins = torch.from_numpy(r.randint(0, B, (N, F)).astype(np.int32)).to(dev)
    nb = torch.full((F,), B - 1, dtype=torch.int32, device=dev)
    ic = torch.tensor([True, False, True, False, False, True], device=dev)
    sc = cs.level_plan(_bm(dev, 100), torch, dev)[1]
    inf = torch.full((1,), np.inf, device=dev)
    ops = tk.level_operands(torch.ones(F, dtype=torch.bool, device=dev), nb,
                            ic, None, -inf, inf, sc, dev)
    _chain(bins, cs.dyadic_stats(N, 7, torch, dev), ops, B, 4, exact=True)


def _edge_hist(case):
    r = np.random.RandomState(21)
    L, F, B = 2, 3, 6
    w = r.randint(1, 5, (L, F, B)).astype(np.float32)
    g = r.randint(-6, 7, (L, F, B)).astype(np.float32)
    h = r.randint(1, 4, (L, F, B)).astype(np.float32)
    cm = np.ones(F, bool)
    lam = 1.0
    if case == "empty_bins":
        w[:, :, [1, 3]] = g[:, :, [1, 3]] = h[:, :, [1, 3]] = 0.0
    elif case == "nan_keys":
        lam = 0.0
        w[:, :, [0, 2]] = 1.0
        h[:, :, [0, 2]] = np.float32(-1e-10)
        g[:, :, [0, 2]] = 0.0
    elif case == "all_masked":
        cm = np.zeros(F, bool)
    return np.stack([w, w * g, w * h], axis=-1).astype(np.float32), cm, lam


@pytest.mark.parametrize("case", ["all_masked", "nan_keys", "empty_bins"])
def test_split_scan_edge_cases_on_card(dev, case):
    """All gains -inf (index 0 wins), NaN Newton keys (sorted last, NaN
    gains win), empty bins (keyed +inf): kernel == plain."""
    hist, cm, lam = _edge_hist(case)
    F, B = hist.shape[1], hist.shape[2]
    lh = torch.from_numpy(hist[:1]).to(dev).contiguous()
    prev = torch.from_numpy(hist[:1] + hist[1:]).to(dev).contiguous()
    from h2o3_tpu_torch.models.tree import TreeScalars
    sc = TreeScalars(torch.tensor(1.0, device=dev),
                     torch.tensor(lam, device=dev),
                     torch.tensor(1e-5, device=dev),
                     torch.tensor(30, dtype=torch.int32, device=dev))
    inf = torch.full((1,), np.inf, device=dev)
    ops = tk.level_operands(torch.from_numpy(cm).to(dev),
                            torch.full((F,), B - 1, dtype=torch.int32),
                            torch.tensor([True, False, True]), None, -inf,
                            inf, sc, dev)
    out_p = tk.split_plain(lh, prev, *ops, d=1, n_nodes=2, n_bins=B)
    out_k = tk.tree_split(lh, prev, *ops, d=1, n_nodes=2, n_bins=B)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(out_k, out_p)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(),
                                      err_msg=f"output {i}")


def test_grow_tree_kernels_equal_plain(dev):
    from h2o3_tpu_torch.models.tree import Tree, grow_tree
    bm = _bm(dev)
    tp, sc, _, cm, _, _ = cs.level_plan(bm, torch, dev)
    st = cs.dyadic_stats(bm.bins.shape[0], 9, torch, dev)
    w = st[:, 0].contiguous()
    g, h = st[:, 1] / w.clamp_min(1.0), st[:, 2] / w.clamp_min(1.0)
    t_k, nid_k, _ = grow_tree(bm.bins, bm.nbins, w, g, h, cm, params=tp,
                              scalars=sc)
    t_p, nid_p, _ = grow_tree(bm.bins, bm.nbins, w, g, h, cm, params=tp,
                              scalars=sc, level_fn=tk.plain_level)
    for f in Tree._fields:
        assert torch.equal(getattr(t_k, f), getattr(t_p, f)), f
    assert torch.equal(nid_k, nid_p)


def test_multinomial_class_trees_kernels_equal_plain(dev):
    """One multinomial iteration's K = 4 class trees (g_k = p_k - 1[y=k],
    h_k = p_k(1 - p_k), one column mask) through the kernels and through
    the plain versions: equal Trees. Each row's class probabilities are a
    permutation of (1/2, 1/4, 1/8, 1/8), so every statistic is dyadic and
    every float32 sum exact in any order."""
    from h2o3_tpu_torch.models.tree import grow_tree
    bm = _bm(dev)
    tp, sc, _, cm, _, _ = cs.level_plan(bm, torch, dev)
    n, K = bm.bins.shape[0], 4
    r = np.random.RandomState(21)
    p = np.array([0.5, 0.25, 0.125, 0.125], np.float32)[
        np.argsort(r.rand(n, K), axis=1)]
    p = torch.from_numpy(p).to(dev)
    y = torch.from_numpy(r.randint(0, K, n)).to(dev)
    w = torch.ones(n, device=dev)
    for k in range(K):
        pk, yk = p[:, k], (y == k).to(torch.float32)
        g, h = pk - yk, pk * (1.0 - pk)
        t_k, nid_k, _ = grow_tree(bm.bins, bm.nbins, w, g, h, cm, params=tp,
                                  scalars=sc)
        t_p, nid_p, _ = grow_tree(bm.bins, bm.nbins, w, g, h, cm, params=tp,
                                  scalars=sc, level_fn=tk.plain_level)
        cs.equal_trees(t_k, t_p, f"class {k} tree")
        assert torch.equal(nid_k, nid_p), k
        assert t_k.is_split.any(), k


def test_gbm_on_card_goes_through_kernels(dev):
    import h2o3_tpu_torch as h2o
    cols, domains = cs.airlines_arrays(N)
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    kernels.reset_counts()
    m = h2o.GBMEstimator(ntrees=3, max_depth=4, seed=1).train(
        fr, y="IsDepDelayed")
    # depth 4 lays out at bucket 6: every bucket level launches
    assert kernels.LAUNCHES == {"tree_hist": 18, "tree_split": 18,
                                "tree_partition": 18, "histogram": 0,
                                "shard_hist": 0, "shard_partition": 0}
    m_cpu = h2o.GBMEstimator(ntrees=3, max_depth=4, seed=1).train(
        h2o.Frame.from_numpy(cols, domains=domains, device="cpu"),
        y="IsDepDelayed")
    assert abs(m.training_metrics["AUC"] - m_cpu.training_metrics["AUC"]) \
        < 5e-3
    p1 = m.predict(fr).col("p1").host_view()
    assert p1.shape == (N,) and np.isfinite(p1).all()


def test_boost_step_makes_no_host_sync(dev):
    """The boosting iteration (gradients, samples, one tree through the
    kernels, margin update), and a multinomial one, run with CUDA sync
    debugging set to error."""
    from h2o3_tpu_torch.models import gbm
    from h2o3_tpu_torch.models.distribution import get_distribution
    from h2o3_tpu_torch.models.tree import TreeParams, scalars_of
    bm = _bm(dev)
    tp = TreeParams(max_depth=6, min_rows=10.0, reg_lambda=0.0,
                    nbins_total=bm.nbins_total, col_sample_rate=0.7,
                    cat_feats=tuple(bool(v) for v in bm.is_cat))
    sc = scalars_of(tp, dev, depth_limit=5)
    lr = torch.tensor(0.1, device=dev)
    n = bm.bins.shape[0]
    y = (torch.rand(n, device=dev) > 0.5).to(torch.float32)
    w = torch.ones(n, device=dev)
    margin = torch.zeros(n, device=dev)
    gens = [gbm.tree_generator(1, t, dev) for t in range(3)]
    # a 3-class iteration too: softmax, K class trees, margin columns
    y3 = torch.randint(0, 3, (n,), device=dev)
    margins = torch.zeros((n, 3), device=dev)
    tk._lib()                                  # build + load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for gen in gens[:2]:
            _, margin, _ = gbm.boost_step(
                bm, y, w, margin, gen, dist=get_distribution("bernoulli"),
                tp=tp, sc=sc, learn_rate=lr, sample_rate=0.8)
        _, margins, _ = gbm.boost_step_multi(
            bm, y3, w, margins, gens[2], tp=tp, sc=sc, learn_rate=lr,
            sample_rate=0.8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(margin).all() and torch.isfinite(margins).all()


def _uplift(dev, n=N):
    cols, domains = cs.criteo_arrays(n)
    return cs.uplift_inputs(torch, dev, cols, domains, n)


@pytest.mark.parametrize("L", [1, 8, 64])
def test_histogram_kernel_vs_plain(dev, L):
    """The full histogram, exact on 0/1 stats (int8 and int32 bins),
    within the summation bound on real-valued stats; rows outside
    [0, L) are skipped."""
    bm, _, _ = _uplift(dev)
    bins, B = bm.bins, bm.nbins_total
    r = np.random.RandomState(L)
    nid = r.randint(0, L, N).astype(np.int32)
    nid[::50] = L
    nid = torch.from_numpy(nid).to(dev)
    kernels.reset_counts()
    cs.compare_histogram(bins, nid, cs.binary_stats(N, 1, torch, dev), L=L,
                         B=B, exact=True)
    cs.compare_histogram(bins.to(torch.int32).contiguous(), nid,
                         cs.binary_stats(N, 2, torch, dev), L=L, B=B,
                         exact=True)
    cs.compare_histogram(bins, nid, cs.real_stats(N, 3, torch, dev), L=L,
                         B=B, exact=False)
    assert kernels.LAUNCHES["histogram"] == 3
    assert kernels.LAUNCHES["tree_hist"] == 0


def test_histogram_node_chunks(dev, monkeypatch):
    """L = 512 with the slab budget cut so the histogram runs in many
    node chunks (5 nodes a chunk: 103 chunks), then in feature groups
    (4 features a group)."""
    from h2o3_tpu_torch.ops.kernels import histogram as kh
    bm, _, _ = _uplift(dev)
    nid = torch.from_numpy(np.random.RandomState(7).randint(
        0, 512, N).astype(np.int32)).to(dev)
    st = cs.binary_stats(N, 4, torch, dev)
    F, B = bm.bins.shape[1], bm.nbins_total
    for slab in (kh.HIST_SLAB_BYTES, 5 * F * B * 12 + QUEUE,
                 4 * B * 12 + QUEUE):
        monkeypatch.setattr(kh, "HIST_SLAB_BYTES", slab)
        cs.compare_histogram(bm.bins, nid, st, L=512, B=bm.nbins_total,
                             exact=True)


def test_tree_split_per_node_mtries_masks(dev):
    """DRF's [L, F] mtries masks through tree_split, levels 0..5, exact
    on dyadic stats."""
    from h2o3_tpu_torch.models.tree import _mtries_mask
    bm = _bm(dev)
    _, sc, is_cat, _, lo, hi = cs.level_plan(bm, torch, dev)
    F, B = bm.bins.shape[1], bm.nbins_total
    gen = torch.Generator(device=dev).manual_seed(5)
    stats = cs.dyadic_stats(bm.bins.shape[0], 11, torch, dev)
    nid = torch.zeros(bm.bins.shape[0], dtype=torch.int32, device=dev)
    prev = None
    for d in range(6):
        L = 2 ** d
        cm = _mtries_mask(gen, L, F, 3, dev)
        ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
        assert ops[0].shape == (L, F)
        _, _, out_p, nid = cs.compare_level(tk, bm.bins, nid, stats, prev,
                                            ops, d=d, L=L, B=B, exact=True)
        prev = out_p[0]


def test_grow_tree_with_mtries_kernels_equal_plain(dev):
    from h2o3_tpu_torch.models.gbm import tree_generator
    from h2o3_tpu_torch.models.tree import grow_tree
    bm = _bm(dev)
    tp, sc, _, cm, _, _ = cs.level_plan(bm, torch, dev)
    st = cs.dyadic_stats(bm.bins.shape[0], 12, torch, dev)
    w = st[:, 0].contiguous()
    g, h = st[:, 1] / w.clamp_min(1.0), st[:, 2] / w.clamp_min(1.0)
    t_k, nid_k, _ = grow_tree(bm.bins, bm.nbins, w, g, h, cm, params=tp,
                              scalars=sc, mtries=3,
                              generator=tree_generator(2, 0, dev))
    t_p, nid_p, _ = grow_tree(bm.bins, bm.nbins, w, g, h, cm, params=tp,
                              scalars=sc, mtries=3,
                              generator=tree_generator(2, 0, dev),
                              level_fn=tk.plain_level)
    cs.equal_trees(t_k, t_p, "grow_tree with mtries")
    assert torch.equal(nid_k, nid_p)


def test_grow_uplift_tree_kernel_equals_plain(dev):
    from h2o3_tpu_torch.models.uplift import _grow_uplift_tree
    from h2o3_tpu_torch.ops.histogram import plain_histogram
    bm, y, treat = _uplift(dev)
    w = torch.ones_like(y)
    kw = dict(depth=6, B=bm.nbins_total, mtries=12, metric="kl",
              min_rows=10.0)
    kernels.reset_counts()
    t_k, pt_k, pc_k = _grow_uplift_tree(bm.bins, bm.nbins, w, y, treat,
                                        None, **kw)
    assert kernels.LAUNCHES["histogram"] == 12
    t_p, pt_p, pc_p = _grow_uplift_tree(bm.bins, bm.nbins, w, y, treat,
                                        None, hist_fn=plain_histogram, **kw)
    cs.equal_trees(t_k, t_p, "_grow_uplift_tree")
    assert torch.equal(pt_k, pt_p) and torch.equal(pc_k, pc_p)


def test_drf_and_uplift_on_card_go_through_kernels(dev):
    import h2o3_tpu_torch as h2o
    cols, domains = cs.airlines_arrays(N)
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    kernels.reset_counts()
    m = h2o.DRFEstimator(ntrees=2, max_depth=5, seed=1).train(
        fr, y="IsDepDelayed")
    # depth 5 lays out at bucket 6
    assert kernels.LAUNCHES == {"tree_hist": 12, "tree_split": 12,
                                "tree_partition": 12, "histogram": 0,
                                "shard_hist": 0, "shard_partition": 0}
    assert np.isfinite(m.training_metrics["AUC"])
    ucols, udomains = cs.criteo_arrays(N)
    ufr = h2o.Frame.from_numpy(ucols, domains=udomains, device=dev)
    kernels.reset_counts()
    um = h2o.UpliftDRFEstimator(treatment_column="treatment", ntrees=2,
                                max_depth=4, seed=1).train(ufr, y="visit")
    assert kernels.LAUNCHES == {"tree_hist": 0, "tree_split": 0,
                                "tree_partition": 0, "histogram": 16,
                                "shard_hist": 0, "shard_partition": 0}
    assert np.isfinite(um.training_metrics["auuc"])


def test_shard_kernels_equal_plain_and_count_apart(dev):
    """``shard_hist``/``shard_partition`` launch the level kernels'
    device code on one rank's rows: EXACT against the plain versions on
    dyadic stats, counted under their own names."""
    bm = _bm(dev)
    _, sc, is_cat, cm, lo, hi = cs.level_plan(bm, torch, dev)
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    bins = bm.bins[: N // 2].contiguous()
    B = bm.nbins_total
    stats = cs.dyadic_stats(bins.shape[0], 2, torch, dev)
    nid = torch.zeros(bins.shape[0], dtype=torch.int32, device=dev)
    prev = None
    kernels.reset_counts()
    for d in range(4):
        L, Lh = 2 ** d, max(2 ** d // 2, 1)
        lh = tk.shard_hist(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
        assert torch.equal(lh, tk.hist_plain(bins, nid, stats, d=d,
                                             n_nodes_h=Lh, n_bins=B))
        out = tk.split_plain(lh, prev, *ops, d=d, n_nodes=L, n_bins=B)
        dec = (out[2], out[3], out[4], out[8], out[9], out[7])
        new = tk.shard_partition(bins, nid, *dec, n_bins=B)
        assert torch.equal(new, tk.partition_plain(bins, nid, *dec,
                                                   n_bins=B))
        prev, nid = out[0], new
    assert kernels.LAUNCHES == {"tree_hist": 0, "tree_split": 0,
                                "tree_partition": 0, "histogram": 0,
                                "shard_hist": 4, "shard_partition": 4}


def test_sharded_level_two_ranks_on_one_card(dev, tmp_path):
    """Two gloo ranks on one card run the sharded level (shard kernels,
    the all-reduce of CUDA tensors, ``tree_split``): the outputs equal
    one process's ``fused_level`` over all rows, EXACTLY."""
    import torch_ranks as tr
    from h2o3_tpu_torch.models.tree import TreeScalars
    ranks = tr.run_ranks("level", tmp_path, device="cuda")
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dev)
    for case in tr.LEVEL_CASES:
        bins, stats, B, is_cat, cons, lo, hi, masks, scal = \
            tr.level_case(case)
        min_rows, lam, msi, dl = scal
        sc = TreeScalars(*(torch.tensor(v, device=dev)
                           for v in (min_rows, lam, msi)),
                         torch.tensor(dl, dtype=torch.int32, device=dev))
        nb = np.full(bins.shape[1], B - 1, np.int32)
        nid = torch.zeros(bins.shape[0], dtype=torch.int32, device=dev)
        prev = None
        for d in range(tr.LEVEL_DEPTH + 1):
            o = tk.fused_level(t(bins), nid, t(stats), prev, t(masks[d]),
                               t(nb), t(is_cat), t(cons), t(lo), t(hi), sc,
                               d=d, n_nodes=2 ** d, n_bins=B)
            want = [x.cpu().numpy() for x in o]
            for res in ranks:
                for a, b in zip(res[case][d][:-1], want[:-1]):
                    np.testing.assert_array_equal(a, b, err_msg=case)
            np.testing.assert_array_equal(
                np.concatenate([res[case][d][-1] for res in ranks]),
                want[-1], err_msg=case)
            prev, nid = o[0], o[-1]


def _both_hists(bins, nid, stats, *, n_nodes, n_bins, d=0):
    """(kernel, plain) pairs of ``histogram`` and ``tree_hist`` (at level
    ``d``) on the same inputs, synchronised."""
    from h2o3_tpu_torch.ops.histogram import local_histogram
    from h2o3_tpu_torch.ops.kernels.histogram import full_histogram
    pairs = [(full_histogram(bins, nid, stats, n_nodes=n_nodes,
                             n_bins=n_bins),
              local_histogram(bins, nid, stats, n_nodes=n_nodes,
                              n_bins=n_bins)),
             (tk.tree_hist(bins, nid, stats, d=d, n_nodes_h=n_nodes,
                           n_bins=n_bins),
              tk.hist_plain(bins, nid, stats, d=d, n_nodes_h=n_nodes,
                            n_bins=n_bins))]
    torch.cuda.synchronize()
    return pairs


@pytest.mark.parametrize("d", [0, 1])
def test_wide_frame_feature_groups(dev, d):
    """F = 300 int32 features at B = 256: one node's slab (921,600 B)
    exceeds the budget, so the plan splits the features into groups;
    EXACT on dyadic stats through ``histogram`` and ``tree_hist``."""
    n, F, B, L = 20_000, 300, 256, 4
    plan = kernels.slab_geometry(n, F, L, B, sms=kernels.sm_count(dev))
    assert plan.n_groups > 1
    r = np.random.RandomState(31)
    bins = torch.from_numpy(r.randint(0, B, (n, F)).astype(np.int32)).to(dev)
    nid = torch.from_numpy(r.randint(0, 2 * L, n).astype(np.int32)).to(dev)
    stats = cs.dyadic_stats(n, 32, torch, dev)
    for got, want in _both_hists(bins, nid if d else nid % L, stats,
                                 n_nodes=L, n_bins=B, d=d):
        assert torch.equal(got, want)


def test_one_node_one_bin_replicas(dev):
    """L = 1 with every row in the same bin of every feature: all warps
    add into the same cells, each into its own copy of the slab; EXACT
    on 0/1 and dyadic stats."""
    n, F, B = 200_000, 12, 65
    plan = kernels.slab_geometry(n, F, 1, B, sms=kernels.sm_count(dev))
    assert plan.replicas > 1
    bins = torch.full((n, F), 7, dtype=torch.int8, device=dev)
    nid = torch.zeros(n, dtype=torch.int32, device=dev)
    for stats in (cs.binary_stats(n, 33, torch, dev),
                  cs.dyadic_stats(n, 34, torch, dev)):
        for got, want in _both_hists(bins, nid, stats, n_nodes=1, n_bins=B):
            assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_nan_stats_and_out_of_range_ids_and_bins(dev, dtype):
    """NaN stats stay in their own slot; nids outside [0, L) (negative,
    L, large; odd ones on the left-child path) and bins outside [0, B)
    (negative, B, the type's largest) are skipped: equal to the plain
    versions, NaN for NaN."""
    n, F, B, L = 30_000, 10, 126, 8
    r = np.random.RandomState(35)
    b = r.randint(0, B, (n, F))
    b[::13, 2] = -1
    b[::17, 5] = B
    b[::19, 7] = 127
    bins = torch.from_numpy(b.astype(np.int32)).to(dtype).to(dev)
    ids = r.randint(0, 2 * L, n)
    ids[::11] = -1
    ids[::23] = 2 * L
    ids[::29] = 1 << 30
    nid = torch.from_numpy(ids.astype(np.int32)).to(dev)
    stats = cs.dyadic_stats(n, 36, torch, dev)
    stats[::31, 1] = float("nan")
    stats[::37, 0] = float("inf")
    for d, ids_d in ((0, nid.clamp_max(L)), (1, nid)):
        for got, want in _both_hists(bins, ids_d, stats, n_nodes=L,
                                     n_bins=B, d=d):
            assert bool(torch.isnan(want).any())
            assert cs.identical(got, want)


def _perm_inputs(dev, n, F, B, ids, seed):
    r = np.random.RandomState(seed)
    bins = torch.from_numpy(r.randint(0, B, (n, F)).astype(np.int8)).to(dev)
    nid = torch.from_numpy(r.randint(0, ids, n).astype(np.int32)).to(dev)
    stats = cs.real_stats(n, seed + 1, torch, dev)
    stats[:, 0] = torch.from_numpy(r.rand(n).astype(np.float32)).to(dev)
    perm = torch.from_numpy(r.permutation(n)).to(dev)
    return bins, nid, stats, perm


@pytest.mark.parametrize("kind", ["tree_hist", "shard_hist", "histogram"])
@pytest.mark.parametrize("L", [1, 64])
def test_slab_histograms_bit_identical_under_row_permutation(dev, kind, L):
    """Real-valued stats: the same rows in another order (bins, nid and
    stats permuted alike) give the same bits, as the slab sums in 64-bit
    fixed point; and within the float32 summation bound of the plain
    version. L = 64 runs in node chunks with the rows sorted by chunk."""
    from h2o3_tpu_torch.ops.histogram import local_histogram
    from h2o3_tpu_torch.ops.kernels.histogram import full_histogram
    n, F, B = 300_000, 10, 126
    bins, nid, stats, perm = _perm_inputs(dev, n, F, B, 2 * L, 43)
    if kind == "histogram":
        nid = nid % L
        run = lambda b, i, s: full_histogram(  # noqa: E731
            b, i, s, n_nodes=L, n_bins=B)
        plain = lambda s: local_histogram(  # noqa: E731
            bins, nid, s, n_nodes=L, n_bins=B)
    else:
        fn = getattr(tk, kind)
        run = lambda b, i, s: fn(b, i, s, d=1, n_nodes_h=L,  # noqa: E731
                                 n_bins=B)
        plain = lambda s: tk.hist_plain(bins, nid, s, d=1,  # noqa: E731
                                        n_nodes_h=L, n_bins=B)
    a = run(bins, nid, stats)
    b = run(bins[perm].contiguous(), nid[perm].contiguous(),
            stats[perm].contiguous())
    again = run(bins, nid, stats)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, again)
    cs.check_within_bound(a, plain(stats), plain, stats, kind)


def test_segment_sum_bit_identical_under_row_permutation(dev):
    """The leaf sums on the card (fixed point): the same bits in any row
    order, within the float32 summation bound of a float sum."""
    from h2o3_tpu_torch.ops.segments import segment_sum
    n = 1_000_000
    _, nid, stats, perm = _perm_inputs(dev, n, 1, 3, 64, 45)
    a = segment_sum(nid, stats, n_nodes=64)
    b = segment_sum(nid[perm], stats[perm], n_nodes=64)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    exact = torch.zeros((64, 3), dtype=torch.float64, device=dev)
    exact.index_add_(0, nid.long(), stats.double())
    mass = torch.zeros((64, 3), dtype=torch.float64, device=dev)
    mass.index_add_(0, nid.long(), stats.double().abs())
    cnt = torch.bincount(nid.long(), minlength=64)[:, None].double()
    assert bool(((a.double() - exact).abs()
                 <= cnt * 2.0 ** -24 * mass).all())


def test_unaligned_views(dev):
    """Contiguous views that start 3 rows in (``bins[3:]``, ``nid[3:]``,
    ``stats[3:]``: not 16-byte aligned) give what the plain versions
    give on the same views."""
    n, F, B, L = 40_003, 10, 126, 4
    r = np.random.RandomState(37)
    bins = torch.from_numpy(r.randint(0, B, (n, F)).astype(np.int8)).to(dev)
    nid = torch.from_numpy(r.randint(0, 2 * L, n).astype(np.int32)).to(dev)
    stats = cs.dyadic_stats(n, 38, torch, dev)
    views = bins[3:], nid[3:], stats[3:]
    assert all(v.is_contiguous() for v in views)
    assert views[0].data_ptr() % 16 and views[2].data_ptr() % 16
    for got, want in _both_hists(*views, n_nodes=L, n_bins=B, d=1):
        assert torch.equal(got, want)


# --------------------------- tree_split (node, feature) blocks, the router


def _scalars(dev, min_rows=1.0, lam=0.0):
    from h2o3_tpu_torch.models.tree import TreeScalars
    return TreeScalars(torch.tensor(min_rows, device=dev),
                       torch.tensor(lam, device=dev),
                       torch.tensor(1e-5, device=dev),
                       torch.tensor(30, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("B,F", [(3, 40), (65, 40), (126, 40), (257, 24),
                                 (1025, 12), (2049, 6)])
def test_split_and_route_every_width_exact(dev, B, F):
    """``tree_split`` (one block per (node, feature), one thread per bin)
    and ``tree_partition`` EXACT on dyadic stats at every bin width: B = 3
    (one warp), 65, 126, 257 (int32 bins past 127), 1025
    (nbins_cats = 1024: 1024 threads, the sort in registers) and 2049 (two
    bins a thread, the sort in shared memory); F up to 40, half the
    features categorical, per-node mtries masks, levels 0..3."""
    from h2o3_tpu_torch.models.tree import _mtries_mask
    r = np.random.RandomState(B)
    dtype = np.int8 if B <= 128 else np.int32
    bins = torch.from_numpy(r.randint(0, B, (N, F)).astype(dtype)).to(dev)
    nb = torch.full((F,), B - 1, dtype=torch.int32, device=dev)
    ic = torch.from_numpy(np.arange(F) % 2 == 0).to(dev)
    inf = torch.full((1,), np.inf, device=dev)
    sc = _scalars(dev)
    stats = cs.dyadic_stats(N, B, torch, dev)
    gen = torch.Generator(device=dev).manual_seed(B)
    nid = torch.zeros(N, dtype=torch.int32, device=dev)
    prev = None
    for d in range(4):
        L = 2 ** d
        cm = _mtries_mask(gen, L, F, max(1, F // 3), dev)
        ops = tk.level_operands(cm, nb, ic, None, -inf, inf, sc, dev)
        _, _, out_p, nid = cs.compare_level(tk, bins, nid, stats, prev, ops,
                                            d=d, L=L, B=B, exact=True)
        prev = out_p[0]


def _level_hists(r, Lh, F, B, empty=0.0):
    """(lh, prev) [Lh, F, B, 3] dyadic: the left children and their
    parents (left + right), ``empty`` of the cells with w = 0."""
    def side():
        w = r.randint(1, 5, (Lh, F, B)).astype(np.float32)
        w[r.rand(Lh, F, B) < empty] = 0.0
        g = r.randint(-6, 7, (Lh, F, B)).astype(np.float32)
        h = r.randint(1, 4, (Lh, F, B)).astype(np.float32)
        return np.stack([w, w * g, w * h], axis=-1)
    left, right = side(), side()
    return left, left + right


def _split_both(dev, lh, prev, cm, ic, lam=0.0, min_rows=1.0):
    L, F, B = 2 * lh.shape[0], lh.shape[1], lh.shape[2]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    inf = torch.full((1,), np.inf, device=dev)
    ops = tk.level_operands(t(cm), torch.full((F,), B - 1, dtype=torch.int32),
                            None if ic is None else t(ic), None, -inf, inf,
                            _scalars(dev, min_rows, lam), dev)
    lh, prev = t(lh), t(prev)
    out_k = tk.tree_split(lh, prev, *ops, d=1, n_nodes=L, n_bins=B)
    out_p = tk.split_plain(lh, prev, *ops, d=1, n_nodes=L, n_bins=B)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(out_k, out_p)):
        assert cs.identical(a, b), f"output {i}"
    return out_k


@pytest.mark.parametrize("cats", ["numeric", "categorical"])
def test_split_ties_across_features_lowest_index_wins(dev, cats):
    """Every feature of a node holds the same histogram row, so their best
    gains tie: feature 0 (the lowest flat index) must win whichever
    (node, feature) block of the node arrives last. Run 20 times."""
    r = np.random.RandomState(41)
    Lh, F, B = 32, 40, 126
    lh, prev = _level_hists(r, Lh, 1, B)
    lh, prev = np.repeat(lh, F, axis=1), np.repeat(prev, F, axis=1)
    ic = None if cats == "numeric" else np.ones(F, bool)
    for _ in range(20):
        out = _split_both(dev, lh, prev, np.ones(F, bool), ic)
        assert bool((out[2] == 0).all())
        assert bool(torch.isfinite(out[1]).all())


def test_split_all_masked_nodes_and_mtries(dev):
    """Per-node [L, F] masks of 3 of 40 columns, a quarter of the nodes
    with every column masked: those nodes take index 0 (feature 0, t = 0,
    NA right) with its child values, gain -inf; EXACT against the plain
    version, categorical and numeric features mixed."""
    r = np.random.RandomState(42)
    Lh, F, B = 64, 40, 126
    lh, prev = _level_hists(r, Lh, F, B, empty=0.2)
    cm = np.zeros((2 * Lh, F), bool)
    for n in range(2 * Lh):
        if n % 4:
            cm[n, r.choice(F, 3, replace=False)] = True
    out = _split_both(dev, lh, prev, cm, np.arange(F) % 3 == 0)
    masked = torch.from_numpy(~cm.any(1)).to(dev)
    assert bool(torch.isneginf(out[1][masked]).all())
    assert bool((out[2][masked] == 0).all() and (out[3][masked] == 0).all())
    assert bool(torch.isfinite(out[1][~masked]).any())


def test_split_nan_keys_and_empty_bins_wide(dev):
    """NaN Newton keys (0/0: g = 0, h + λ + 1e-10 = 0) sort last and NaN
    gains win; empty bins key to +inf; at B = 126 and 257 over 24
    features: EXACT against the plain version."""
    r = np.random.RandomState(43)
    for B in (126, 257):
        Lh, F = 8, 24
        lh, prev = _level_hists(r, Lh, F, B, empty=0.3)
        nan_cells = r.rand(Lh, F, B) < 0.1
        for a in (lh, prev):
            a[..., 0][nan_cells] = 1.0
            a[..., 1][nan_cells] = 0.0
            a[..., 2][nan_cells] = np.float32(-1e-10)
        prev[..., 0][nan_cells] = 2.0
        _split_both(dev, lh, prev, np.ones(F, bool), np.arange(F) % 2 == 0,
                    lam=0.0)


def test_stream_is_the_current_stream(dev):
    """The wrappers launch on the caller's current stream: ``stream``
    reads its raw handle, inside and outside a ``torch.cuda.stream``
    block."""
    assert kernels.stream(dev) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert kernels.stream(dev) == side.cuda_stream
        assert kernels.stream(torch.device("cuda")) == side.cuda_stream
    assert kernels.stream(dev) == torch.cuda.current_stream(dev).cuda_stream


def test_split_arrival_counters_return_to_zero(dev):
    """Every launch leaves its per-node arrival counters at 0 for the
    next one (no memset, no host sync), and launches on one stream share
    one scratch."""
    r = np.random.RandomState(44)
    lh, prev = _level_hists(r, 256, 10, 126)
    _split_both(dev, lh, prev, np.ones(10, bool), np.arange(10) < 3)
    scr = tk.split_scratch(512, 5120, 4, dev, kernels.stream(dev))
    before = [t.data_ptr() for t in scr]
    _split_both(dev, lh, prev, np.ones(10, bool), np.arange(10) < 3)
    scr = tk.split_scratch(512, 5120, 4, dev, kernels.stream(dev))
    assert [t.data_ptr() for t in scr] == before
    assert scr[0].numel() >= 512 and int(scr[0].abs().sum()) == 0


@pytest.mark.parametrize("in_smem", [True, False])
def test_route_l512_categorical_unaligned(dev, monkeypatch, in_smem):
    """``tree_partition`` and ``shard_partition`` at L = 512 with
    categorical splits on most nodes: N = 4k + 1, + 2, + 3, views that
    start 1, 2, 3 rows in (nid and bins off their 16-byte boundary, the
    new ids then stored one by one), NA bins; the left sets staged as
    bits, then (budget cut) read from the byte mask. EXACT against the
    plain version."""
    if not in_smem:
        monkeypatch.setattr(tk, "ROUTE_SMEM_BYTES", 512 * 8)
    r = np.random.RandomState(45)
    L, F, B = 512, 10, 126
    feat = torch.from_numpy(r.randint(0, F, L).astype(np.int32)).to(dev)
    thresh = torch.from_numpy(r.randint(0, B - 1, L).astype(np.int32)).to(dev)
    nal = torch.from_numpy(r.rand(L) < 0.5).to(dev)
    split = torch.from_numpy(r.rand(L) < 0.9).to(dev)
    cat = torch.from_numpy(r.rand(L) < 0.8).to(dev) & split
    lm = torch.from_numpy(r.rand(L, B - 1) < 0.5).to(dev)
    dec = (feat, thresh, nal, split, cat, lm)
    for n in (40_001, 40_002, 40_003):
        b = r.randint(0, B, (n + 3, F))
        b[::7, :] = B - 1
        bins = torch.from_numpy(b.astype(np.int8)).to(dev)
        nid = torch.from_numpy(r.randint(0, L, n + 3).astype(np.int32)).to(
            dev)
        for k in range(4):
            bv, nv = bins[k:k + n - k], nid[k:k + n - k]
            plan = tk.route_plan(nv.shape[0], L, B, nv.data_ptr(), 0,
                                 sms=kernels.sm_count(dev))
            assert plan.bits_in_smem == in_smem
            want = tk.partition_plain(bv, nv, *dec, n_bins=B)
            for fn in (tk.tree_partition, tk.shard_partition):
                got = fn(bv, nv, *dec, n_bins=B)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (n, k, fn.__name__)


def _iso_inputs(dev, n=N):
    """Airlines bins binned uniform (B = 65), a 256-row bag and one tree's
    draws from a CPU generator, on ``dev``."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.models import isofor
    cols, domains = cs.airlines_arrays(n)
    x = [c for c in cols if c != "IsDepDelayed"]
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    bm = bin_frame(fr, x, nbins=64, nbins_cats=64, histogram_type="uniform")
    r = np.random.RandomState(46)
    w = np.zeros(bm.bins.shape[0], np.float32)
    w[r.choice(n, 256, replace=False)] = 1.0
    dr = isofor.draw_tree(torch.Generator().manual_seed(3),
                          bm.nbins.cpu(), 8, "cpu")
    return bm, torch.from_numpy(w), dr


def test_isolation_tree_growth_and_scoring_kernel_vs_plain(dev):
    """One isolation tree grown from fixed draws through ``tree_partition``
    on the card equals the plain version's field for field, and so do the
    rows' path lengths (8 launches growing, 8 scoring)."""
    from h2o3_tpu_torch.models import isofor
    bm, w, dr = _iso_inputs(dev)
    B = bm.nbins_total
    kernels.reset_counts()
    t_k = isofor.grow_isolation_tree(bm.bins, w.to(dev),
                                     *(dr[k].to(dev) for k in (
                                         "feat", "thresh", "na_left")), B=B)
    pl_k = isofor.tree_path_length(t_k, bm.bins, B)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tree_partition"] == 16
    bins = bm.bins.cpu()
    t_p = isofor.grow_isolation_tree(bins, w, dr["feat"], dr["thresh"],
                                     dr["na_left"], B=B)
    for f in t_p._fields:
        assert torch.equal(getattr(t_k, f).cpu(), getattr(t_p, f)), f
    assert torch.equal(pl_k.cpu(), isofor.tree_path_length(t_p, bins, B))
    assert int(t_p.is_split.sum()) > 20


def test_xgboost_forest_is_the_gbm_forest_on_the_card(dev):
    import h2o3_tpu_torch as h2o
    cols, domains = cs.airlines_arrays(N)
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    kw = dict(max_depth=5, seed=3, reg_lambda=1.0)
    xg = h2o.XGBoostEstimator(nrounds=4, eta=0.2, gamma=1e-3, max_bins=40,
                              subsample=0.8, **kw).train(fr, y=cs.Y)
    gb = h2o.GBMEstimator(ntrees=4, learn_rate=0.2,
                          min_split_improvement=1e-3, nbins=40,
                          sample_rate=0.8, **kw).train(fr, y=cs.Y)
    for a, b in zip(xg.forest, gb.forest):
        assert torch.equal(a, b)


def test_contributions_card_vs_cpu(dev):
    """TreeSHAP of one GBM forest on the card and on the CPU: within
    1e-5·max(1, |margin|), rows summing to the forest's output."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ml import shap
    from h2o3_tpu_torch.models.tree import predict_forest
    cols, domains = cs.airlines_arrays(N)
    m = h2o.GBMEstimator(ntrees=3, max_depth=6, seed=1).train(
        h2o.Frame.from_numpy(cols, domains=domains, device=dev), y=cs.Y)
    bins, B = m.bm.bins[:N], m.bm.nbins_total
    got = shap.forest_contributions(m.forest, bins, B)
    cpu = type(m.forest)(*(a.cpu() for a in m.forest))
    want = shap.forest_contributions(cpu, bins.cpu(), B)
    out = predict_forest(m.forest, bins, B).cpu().numpy()
    tol = 1e-5 * np.maximum(1.0, np.abs(out))
    assert (np.abs(got - want) <= tol[:, None]).all()
    assert (np.abs(got.sum(1) - out) <= tol).all()


def glm_case(case):
    """(columns, domains, response, estimator parameters, coefficient
    tolerance, probability tolerance or None) of one card-vs-CPU GLM
    case: binomial on the HIGGS generator (6 columns), or multinomial
    IRLSM on a 3-class airlines response (P = 263; ridge: Cholesky, L1:
    ADMM)."""
    if case in ("irlsm", "l_bfgs"):
        cols, domains, _ = cs.higgs_arrays(N, p=6)
        tol = cs.GLM_TOL if case == "irlsm" else cs.GLM_LBFGS_TOL
        return (cols, domains, "y", dict(cs.HIGGS_GLM, solver=case,
                                         max_iterations=20), tol, None)
    n = cs.N_SURFACE_CPU
    cols, domains = cs.airlines_arrays(n)
    cols.pop(cs.Y)
    cols["late"] = np.digitize(cs.airlines_delay(n), [0.0, 15.0]).astype(
        np.int32)
    domains = dict(domains, late=["l0_early", "l1_ontime", "l2_late"])
    domains.pop(cs.Y)
    params = dict(family="multinomial", solver="irlsm", lambda_=1e-3)
    if case == "multinomial_ridge":
        params["alpha"] = 0.0
    return cols, domains, "late", params, cs.GLM_TOL, cs.GLM_PROB_TOL


@pytest.mark.parametrize("case", ["irlsm", "l_bfgs", "multinomial_ridge",
                                  "multinomial_l1"])
def test_glm_card_vs_cpu_and_refit_bit_equal(dev, case):
    """GLM on the card (no kernel: cuBLAS Gram, TF32 off, plain torch
    solvers): binomial IRLSM and L-BFGS fits and converged multinomial
    IRLSM fits (ridge and L1) against the CPU plain fits of the same rows
    (training logloss within 1e-6 relative, coefficients within
    chip_smoke's GLM_TOL / GLM_LBFGS_TOL, multinomial probabilities
    within GLM_PROB_TOL), a refit bit-equal, and no kernel launched."""
    import h2o3_tpu_torch as h2o
    cols, domains, y, params, tol, prob_tol = glm_case(case)
    n = len(cols[y])
    kernels.reset_counts()
    m_card, _, _, _ = cs.cpu_glm_check(
        lambda: h2o.GLMEstimator(**params), cols, domains, y, n, tol, case,
        dev, prob_tol=prob_tol)
    assert not any(kernels.LAUNCHES.values())
    assert m_card.training_metrics["logloss"] < np.log(3)
    refit = h2o.GLMEstimator(**params).train(h2o.Frame.from_numpy(
        cols, domains=domains, device=dev), y=y)
    assert refit.coefficients == m_card.coefficients


def dl_case(case):
    """(columns, domains, response, estimator parameters) of one
    card-vs-CPU DeepLearning case at a small size."""
    if case in ("rectifier", "bf16"):
        n = 32_768 if case == "bf16" else 8_192
        cols, domains = cs.mnist_shape_arrays(n)
        params = dict(cs.DL, epochs=1.0)
        if case == "bf16":
            params["mini_batch_size"] = cs.DL_BF16_BATCH
        return cols, domains, "label", params
    n = 10_000
    cols, domains = cs.airlines_arrays(n)
    delay = cs.airlines_delay(n)
    cols["late"] = np.digitize(delay, [0.0, 15.0]).astype(np.int32)
    domains = dict(domains, late=["l0_early", "l1_ontime", "l2_late"])
    params = dict(cs.DL_SURFACE, activation="Maxout", adaptive_rate=False,
                  rate=0.002, momentum_start=0.5, momentum_stable=0.9,
                  momentum_ramp=2e4, l2=1e-4, ignored_columns=[cs.Y])
    return cols, domains, "late", params


@pytest.mark.parametrize("case", ["rectifier", "maxout_nesterov", "bf16"])
def test_deeplearning_card_vs_cpu_and_refit_bit_equal(dev, case):
    """DeepLearning on the card (no kernel: cuBLAS products with TF32 off,
    bf16 GEMMs from a batch of 16,384, plain torch) against the CPU plain
    fit from the same initial weights, as chip_smoke's
    ``dl_card_vs_cpu`` holds it (every step from the card's state on the
    card's design: pre-activations within their float32 bound, the
    update within DL_STEP_TOL / DL_BF16_STEP_TOL or a tie flip within
    the bound; a float32 fit replayed whole within DL_TOL and
    DL_PROB_TOL where nothing flips), a refit bit-equal, and no kernel
    launched."""
    import h2o3_tpu_torch as h2o
    cols, domains, y, params = dl_case(case)
    kernels.reset_counts()
    res = cs.dl_card_vs_cpu(lambda: h2o.DeepLearningEstimator(**params),
                            cols, domains, y, dev, case)
    print(f"{case}: {cs.dl_report(res)}")
    assert res["ok"], res["why"]
    assert not any(kernels.LAUNCHES.values())
    m_card = res["m_card"]
    assert all(t.is_cuda for l in m_card.net for t in l.values())
    refit = h2o.DeepLearningEstimator(**params).train(res["fr"], y=y)
    assert cs.same_net(refit, m_card)


def test_bf16_product_on_the_card(dev):
    """The bf16 product on the card (one bf16 GEMM with a float32
    result, ``torch.mm(..., out_dtype=)``) against the upcast product on
    the CPU: exact bf16 products summed in float32, and gradients that
    are bf16 values."""
    from h2o3_tpu_torch.models import deeplearning as dl
    g = torch.Generator().manual_seed(0)
    a = torch.randn(4096, 784, generator=g)
    b = torch.randn(784, 200, generator=g)
    up = torch.randn(4096, 200, generator=g)
    assert dl.bf16_route(dev) == "mm_out_dtype"
    outs = []
    for d in (dev, torch.device("cpu")):
        at, bt = (t.to(d).requires_grad_(True) for t in (a, b))
        out = dl._Bf16Product.apply(at, bt, dl.bf16_route(d))
        grads = torch.autograd.grad((out * up.to(d)).sum(), (at, bt))
        outs.append([out.detach().cpu()] + [t.cpu() for t in grads])
    scale = float(outs[1][0].abs().max())
    assert float((outs[0][0] - outs[1][0]).abs().max()) <= 1e-5 * scale
    a16, b16 = (t.to(torch.bfloat16).float().abs() for t in (a, b))
    # the float32 sums may round to the neighbouring bf16 value, or, where
    # they cancel, differ by their rounding: 2^-20 of the summed |terms|
    sums = (up.abs() @ b16.T, a16.T @ up.abs())
    for gc, gp, tot in zip(outs[0][1:], outs[1][1:], sums):
        assert torch.equal(gc, gc.to(torch.bfloat16).float())
        assert torch.all((gc - gp).abs()
                         <= 2 ** -7 * gp.abs() + 2 ** -20 * tot)


def unsupervised_case(case):
    """(columns, domains, response, estimator factory, card-vs-CPU
    check) of one small card-vs-CPU case of chip_smoke.py phase 24."""
    import h2o3_tpu_torch as h2o
    cols, domains = cs.airlines_arrays(8_000)
    if case == "kmeans":
        hcols, _, _ = cs.higgs_arrays(8_000)
        hcols.pop("y")
        return (hcols, {}, None, lambda: h2o.KMeansEstimator(**cs.KMEANS),
                cs.kmeans_card_vs_cpu)
    x_only = {k: v for k, v in cols.items() if k != cs.Y}
    if case in ("pca", "svd"):
        key = "std_deviation" if case == "pca" else "d"
        vec = "eigenvectors" if case == "pca" else "v"
        build = ((lambda: h2o.PCAEstimator(k=10)) if case == "pca"
                 else (lambda: h2o.SVDEstimator(nv=10,
                                                transform="standardize")))
        return (x_only, domains, None, build,
                lambda a, b, frs, label: cs.vectors_card_vs_cpu(
                    a.output[key], b.output[key], a.output[vec],
                    b.output[vec], label))
    if case == "glrm":
        return (cs.glrm_columns(cols, 8_000), domains, None,
                lambda: h2o.GLRMEstimator(**dict(cs.GLRM, max_iterations=20)),
                lambda a, b, frs, label: cs.glrm_card_vs_cpu(
                    a, b, frs, label, False))
    if case == "naivebayes":
        return (cols, domains, cs.Y,
                lambda: h2o.NaiveBayesEstimator(**cs.NB), cs.nb_card_vs_cpu)
    return (cs.te_columns(cols, 8_000), domains, cs.Y,
            lambda: h2o.TargetEncoderEstimator(**cs.TE), cs.te_card_vs_cpu)


@pytest.mark.parametrize("case", ["kmeans", "pca", "svd", "glrm",
                                  "naivebayes", "targetencoder"])
def test_unsupervised_card_vs_cpu_and_refit_bit_equal(dev, case):
    """KMeans, PCA, SVD, GLRM, Naive Bayes and the Target Encoder on the
    card (no kernel: cuBLAS products with TF32 off, cuSOLVER, fixed-point
    segment sums) against the CPU plain fit at the tolerances of
    chip_smoke.py phase 24, a refit bit-equal, and no kernel launched."""
    cols, domains, y, build, held = unsupervised_case(case)
    frs = cs.head_frames(cols, domains, len(next(iter(cols.values()))), dev)
    kw = {} if y is None else {"y": y}
    if case == "targetencoder":
        kw["x"] = list(cs.TE_COLS)
    kernels.reset_counts()
    ms = [build().train(f, **kw) for f in frs]
    assert not any(kernels.LAUNCHES.values())
    print(held(*ms, frs, case))
    if case == "targetencoder":
        again = build().train(frs[0], **kw)
        assert all(np.array_equal(again.enc_maps[c]["sum"],
                                  ms[0].enc_maps[c]["sum"])
                   for c in cs.TE_COLS)
    else:
        cs.refit_check(torch, build, ms[0],
                       lambda e: e.train(frs[0], **kw), case)


def glm_wrapper_case(case):
    """(columns, domains, y, x, build, held) of a phase 25 case at a
    small size."""
    import h2o3_tpu_torch as h2o
    if case in ("gam", "modelselection", "anovaglm"):
        cols, domains, _ = cs.higgs_arrays(8_000)
        x = list(cs.SEL_X)
        if case == "gam":
            return (cols, domains, "y", x,
                    lambda: h2o.GAMEstimator(**cs.GAM_HIGGS_HEAD),
                    cs.gam_card_vs_cpu)
        if case == "modelselection":
            return (cols, domains, "y", x,
                    lambda: h2o.ModelSelectionEstimator(mode="backward"),
                    lambda a, b, frs, label: cs.selection_card_vs_cpu(
                        a, b, label))
        return (cols, domains, "y", x, lambda: h2o.ANOVAGLMEstimator(),
                lambda a, b, frs, label: cs.anova_card_vs_cpu(a, b, label))
    if case == "rulefit":           # the tests' tie-free data
        cols, domains = cs.rule_columns(8_000)
        return (cols, domains, "y", None, lambda: h2o.RuleFitEstimator(
            seed=1, sample_rate=1.0, rule_generation_ntrees=10),
            cs.rulefit_card_vs_cpu)
    if case == "infogram":
        cols, domains = cs.infogram_columns(8_000)
        return (cols, domains, "y", None,
                lambda: h2o.InfogramEstimator(seed=1, ntrees=5),
                lambda a, b, frs, label: cs.infogram_card_vs_cpu(
                    a, b, label))
    cols, _ = cs.airlines_arrays(8_000)
    icols = {"DepTime": cols["DepTime"], "delay": cs.airlines_delay(8_000)}

    def held(a, b, frs, label):
        assert np.array_equal(a.tx, b.tx) and np.array_equal(a.ty, b.ty)
        return "thresholds EXACT"
    return (icols, {}, "delay", ["DepTime"],
            lambda: h2o.IsotonicRegressionEstimator(), held)


@pytest.mark.parametrize("case", ["gam", "rulefit", "modelselection",
                                  "anovaglm", "isotonic", "infogram"])
def test_glm_wrappers_card_vs_cpu_and_refit_bit_equal(dev, case):
    """GAM, RuleFit, ModelSelection, ANOVA-GLM, Isotonic Regression and
    Infogram on the card against the CPU plain fit at the tolerances of
    chip_smoke.py phase 25, a refit bit-equal; the tree fits of RuleFit
    and Infogram launch the level kernels, the others no kernel."""
    cols, domains, y, x, build, held = glm_wrapper_case(case)
    frs = cs.head_frames(cols, domains, len(next(iter(cols.values()))), dev)
    kernels.reset_counts()
    ms = [build().train(f, y=y, x=x) for f in frs]
    if case in ("rulefit", "infogram"):
        assert kernels.LAUNCHES["tree_hist"] > 0
        assert kernels.LAUNCHES["histogram"] == 0
    else:
        assert not any(kernels.LAUNCHES.values())
    print(held(*ms, frs, case))
    cs.refit_check(torch, build, ms[0], lambda e: e.train(frs[0], y=y, x=x),
                   case)


def models26_case(case):
    """(columns, domains, build, fit, held, fields) of a phase 26
    case at a small size: ``held(card model, CPU model, frames)`` holds
    the two at the CPU tests' tolerances."""
    import h2o3_tpu_torch as h2o
    if case == "coxph":
        cols, domains, _ = cs.cox_columns(5_000)
        return (cols, domains, lambda: h2o.CoxPHEstimator(**cs.COX),
                lambda e, f: e.train(f, y="event"),
                lambda a, b, frs: cs.cox_card_vs_cpu(a, b, case), ("coef",))
    if case == "psvm":
        cols, domains = cs.svm_columns(cs.N_PSVM_HEAD)
        return (cols, domains, lambda: h2o.PSVMEstimator(),
                lambda e, f: e.train(f, y="y"),
                lambda a, b, frs: cs.psvm_card_vs_cpu(a, b, frs, case),
                ("w_b", "pivot_rows", "Linv_t"))
    if case == "aggregator":
        cols, domains = cs.agg_columns(cs.N_AGG_HEAD)

        def held(a, b, frs):
            assert np.array_equal(a.exemplar_assignment,
                                  b.exemplar_assignment)
            return "assignment EXACT"
        return (cols, domains,
                lambda: h2o.AggregatorEstimator(target_num_exemplars=300),
                lambda e, f: e.train(f), held, ("exemplar_assignment",))
    cols, domains = cs.topic_columns()

    def held(a, b, frs):
        gap = cs.rel_gap(a.vectors, b.vectors,
                         floor=float(np.abs(b.vectors).max()))
        assert gap <= cs.W2V_REL
        return f"vectors {gap:.3g} of the largest"
    return (cols, domains, lambda: h2o.Word2VecEstimator(**cs.W2V_TOPIC),
            lambda e, f: e.train(f), held, ("vectors",))


@pytest.mark.parametrize("case", ["coxph", "psvm", "aggregator",
                                  "word2vec"])
def test_models26_card_vs_cpu_and_refit_bit_equal(dev, case):
    """CoxPH, PSVM, the Aggregator and Word2Vec on the card against the
    CPU plain fit at the tolerances of chip_smoke.py phase 26, a refit
    bit-equal, no kernel launched."""
    cols, domains, build, fit, held, fields = models26_case(case)
    frs = cs.head_frames(cols, domains, len(next(iter(cols.values()))), dev)
    kernels.reset_counts()
    ms = [fit(build(), f) for f in frs]
    assert not any(kernels.LAUNCHES.values())
    print(held(*ms, frs))
    cs.refit_check(torch, build, ms[0], lambda e: fit(e, frs[0]), case,
                   fields=fields)


def test_sort_join_and_quantiles_card_vs_cpu(dev):
    """``device_sort``'s permutation, ``device_join_index``'s pairs and
    the device-path quantiles on the card EXACTLY the CPU plain path's."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame import quantiles
    from h2o3_tpu_torch.ops.sort import device_join_index, device_sort
    cols, domains = cs.airlines_arrays(70_001)
    cols["rid"] = np.arange(70_001, dtype=np.int32)
    frs = cs.head_frames(cols, domains, 70_001, dev)
    perms = [device_sort(f, ["UniqueCarrier", "DepTime"], [True, False])
             .col("rid").to_numpy() for f in frs]
    assert np.array_equal(*perms)
    assert np.array_equal(perms[0], np.lexsort((-cols["DepTime"],
                                                cols["UniqueCarrier"])))
    r = np.random.RandomState(3)
    lk = r.randint(0, 2000, 30_000).astype(np.float32)
    rk = r.permutation(2000)[:1000].astype(np.float32)
    pairs = [device_join_index(torch.from_numpy(lk).to(d),
                               torch.from_numpy(rk).to(d), 30_000, 1000)
             for d in (dev, "cpu")]
    assert all(np.array_equal(a, b) for a, b in zip(*pairs))
    x = frs[0].col("DepTime"), frs[1].col("DepTime")
    ranks = np.arange(0, 70_001, 997, dtype=np.float64)
    got = [quantiles._values_at_ranks(
        torch.where(c.na_mask, 0.0, c.data), (~c.na_mask).float(), ranks,
        0.0, 2399.0, 4) for c in x]
    assert np.array_equal(*got)


def test_grid_launches_and_standalone_fits(dev):
    """Phase 27(a) at a small size: a 4-combo GBM grid's sequential walk
    launches each level kernel combos x trees x levels times, and every
    grid model is bit-equal (forest, training AUC) to a standalone fit of
    its combo; the deep levels of a depth-20 tree (the global-atomic
    histogram, routing records in global memory) EXACT."""
    import h2o3_tpu_torch as h2o
    r = np.random.RandomState(9)
    X = r.randn(N, 6).astype(np.float32)
    cols = {f"x{i}": X[:, i] for i in range(6)}
    cols["y"] = (X[:, 0] + 0.5 * r.randn(N) > 0).astype(np.int32)
    fr = h2o.Frame.from_numpy(cols, domains={"y": ["N", "Y"]}, device=dev)
    hyper = {"learn_rate": [0.05, 0.1], "min_rows": [5.0, 20.0]}
    fixed = dict(ntrees=5, max_depth=6, seed=1)
    kernels.reset_counts()
    grid = h2o.GridSearch(h2o.GBMEstimator, hyper, **fixed).train(fr, y="y")
    counts = dict(kernels.LAUNCHES)
    assert len(grid.models) == 4
    cs.check_launches(counts, {k: 4 * 5 * 6 for k in cs.LEVEL_KERNELS},
                      "grid")
    for m in grid.models:
        alone = h2o.GBMEstimator(**fixed, **m.output["grid_params"]).train(
            fr, y="y")
        assert cs.forests_equal(m.forest, alone.forest)
        assert m.training_metrics["AUC"] == alone.training_metrics["AUC"]
    bm = _bm(dev)
    cs.deep_levels(torch, dev, bm, bm.bins.contiguous(), bm.nbins_total)
