"""The split scan at the widths the ``tree_split`` kernel takes, on the
CPU: the port's plain ``split_plain`` (the version the kernel is held
against on the card) against the reference's ``_level_boundary``
(``h2o3_tpu/ops/pallas/treekernel.py``: sibling subtraction, the shared
``best_splits``, the split flags) on the same numpy inputs; the kernel's
decomposition (one candidate per (node, feature), reduced by the total
order ``better``) emulated with the plain scan; and the host plans of
the redesigned ``tree_split`` and ``tree_partition`` launches.

Stats are dyadic (small integers), so every float32 prefix sum is exact
in any order: integer outputs must be equal, and the float outputs (the
histogram, gains and child values) agree within 1e-6 relative — the
stated float32 tolerance, here met exactly."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from h2o3_tpu.ops.pallas import treekernel as ref_tk
from h2o3_tpu_torch.ops import kernels
from h2o3_tpu_torch.ops.kernels import treekernel as tk
from h2o3_tpu_torch.ops.split_scan import best_splits
from torch_threads import one_torch_thread  # noqa: F401 - autouse

OUT_NAMES = ("hist", "gain", "feat", "thresh", "na_left", "left_val",
             "right_val", "leftmask", "split", "cat_split")
FLOATS = {"hist", "gain", "left_val", "right_val"}


def _hists(r, Lh, F, B, empty=0.0):
    """(lh, prev) [Lh, F, B, 3] dyadic {w, w·g, w·h}: the left children
    and their parents; ``empty`` of the left cells hold no rows."""
    def side(p):
        w = r.randint(1, 5, (Lh, F, B)).astype(np.float32)
        w[r.rand(Lh, F, B) < p] = 0.0
        g = r.randint(-6, 7, (Lh, F, B)).astype(np.float32)
        h = r.randint(1, 4, (Lh, F, B)).astype(np.float32)
        return np.stack([w, w * g, w * h], axis=-1)
    left = side(empty)
    return left, left + side(0.0)


def _mtries(r, L, F, k, all_masked_every=0):
    cm = np.zeros((L, F), bool)
    for n in range(L):
        if not (all_masked_every and n % all_masked_every == 0):
            cm[n, r.choice(F, min(k, F), replace=False)] = True
    return cm


def _both(lh, prev, cm, is_cat, *, lam=0.0, min_rows=1.0, msi=1e-5,
          cons=None, depth_limit=30):
    """(reference outputs, port outputs) of one level d = 1."""
    Lh, F, B = lh.shape[0], lh.shape[1], lh.shape[2]
    L = 2 * Lh
    nb = np.full(F, B - 1, np.int32)
    lo = np.full(1, -np.inf, np.float32)
    hi = np.full(1, np.inf, np.float32)
    ref = ref_tk._level_boundary(
        jnp.asarray(lh.transpose(0, 3, 1, 2).reshape(Lh, 3 * F * B)),
        jnp.asarray(prev), jnp.asarray(cm.astype(np.int8)), jnp.asarray(nb),
        None if is_cat is None else jnp.asarray(is_cat),
        None if cons is None else jnp.asarray(cons),
        jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray([[min_rows, lam, msi]], jnp.float32),
        jnp.asarray([[depth_limit]], jnp.int32),
        d=1, n_nodes=L, n_bins=B, n_features=F)
    t = torch.from_numpy
    port = tk.split_plain(
        t(lh), t(prev), t(cm.astype(np.int8)), t(nb),
        None if is_cat is None else t(is_cat.astype(np.int8)),
        None if cons is None else t(cons.astype(np.int8)), t(lo), t(hi),
        torch.tensor([min_rows, lam, msi], dtype=torch.float32),
        torch.tensor([depth_limit], dtype=torch.int32), d=1, n_nodes=L,
        n_bins=B)
    return ref, port


def _assert_agree(ref, port):
    for name, a, b in zip(OUT_NAMES, ref, port):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name in FLOATS:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("B,F", [(3, 40), (65, 40), (126, 40), (257, 24),
                                 (1025, 40), (2049, 8)])
def test_split_plain_matches_reference_every_width(B, F):
    """Per-node mtries masks (a third of the columns), half the features
    categorical, empty bins, at every width the kernel takes: B = 3 (one
    warp), 65, 126, 257, 1025 (1024 threads a block) and 2049 (two bins a
    thread)."""
    r = np.random.RandomState(B)
    lh, prev = _hists(r, 4, F, B, empty=0.2)
    cm = _mtries(r, 8, F, max(1, F // 3))
    ref, port = _both(lh, prev, cm, np.arange(F) % 2 == 0)
    _assert_agree(ref, port)
    assert bool(port[9].any()), "some node splits on a categorical feature"


def test_split_plain_matches_reference_ties_across_features():
    """Identical histogram rows in every feature: the gains tie and the
    lowest flat index (feature 0) wins in both packages."""
    r = np.random.RandomState(51)
    lh, prev = _hists(r, 8, 1, 126)
    lh, prev = np.repeat(lh, 40, axis=1), np.repeat(prev, 40, axis=1)
    for is_cat in (None, np.ones(40, bool)):
        ref, port = _both(lh, prev, np.ones((1, 40), bool), is_cat)
        _assert_agree(ref, port)
        assert bool((port[2] == 0).all())


def test_split_plain_matches_reference_all_masked_nodes():
    """Every column masked on a quarter of the nodes: gain -inf, index 0
    (feature 0, t = 0, NA right) and that candidate's child values."""
    r = np.random.RandomState(52)
    lh, prev = _hists(r, 16, 40, 126, empty=0.1)
    cm = _mtries(r, 32, 40, 3, all_masked_every=4)
    ref, port = _both(lh, prev, cm, np.arange(40) % 3 == 0)
    _assert_agree(ref, port)
    masked = torch.from_numpy(~cm.any(1))
    assert bool(torch.isneginf(port[1][masked]).all())
    assert bool((port[2][masked] == 0).all() and
                (port[3][masked] == 0).all())


def test_split_plain_matches_reference_nan_keys():
    """NaN Newton keys (g = 0, h + λ + 1e-10 = 0) sort last; empty bins
    key to +inf; B = 257."""
    r = np.random.RandomState(53)
    lh, prev = _hists(r, 4, 12, 257, empty=0.3)
    nan_cells = r.rand(4, 12, 257) < 0.1
    for a in (lh, prev):
        a[..., 0][nan_cells] = 1.0
        a[..., 1][nan_cells] = 0.0
        a[..., 2][nan_cells] = np.float32(-1e-10)
    prev[..., 0][nan_cells] = 2.0
    ref, port = _both(lh, prev, np.ones((1, 12), bool),
                      np.arange(12) % 2 == 0, lam=0.0)
    _assert_agree(ref, port)


# ------------------------------------------- the kernel's decomposition


def _better(a, b):
    """csrc/treekernel.cu ``better`` on (gain, index) pairs."""
    an, bn = math.isnan(a[0]), math.isnan(b[0])
    if an or bn:
        return an and (not bn or a[1] < b[1])
    if a[0] != b[0]:
        return a[0] > b[0]
    return a[1] < b[1]


@pytest.mark.parametrize("case", ["mtries", "ties", "all_masked",
                                  "nan_keys"])
def test_per_feature_candidates_reduce_to_the_flat_argmax(case):
    """``tree_split`` scores each (node, feature) in a block of its own and
    the node's last block reduces the F candidates by ``better``. The
    plain scan of one feature at a time (the candidate a block publishes:
    a masked feature's is t = 0, NA right, gain -inf; a masked feature
    after another masked one publishes that index alone), reduced by
    ``better`` in any order, must give the whole scan's gain, feature,
    threshold, NA direction, child values and left set."""
    r = np.random.RandomState(54)
    L, F, B = 16, 12, 126
    hist = _hists(r, L, F, B, empty=0.2)[1]
    cm = np.ones((L, F), bool)
    lam = 0.0
    if case == "mtries":
        cm = _mtries(r, L, F, 3)
    elif case == "ties":
        hist = np.repeat(hist[:, :1], F, axis=1)
    elif case == "all_masked":
        cm = _mtries(r, L, F, 3, all_masked_every=2)
    else:
        cells = r.rand(L, F, B) < 0.2
        hist[..., 0][cells] = 1.0
        hist[..., 1][cells] = 0.0
        hist[..., 2][cells] = np.float32(-1e-10)
    is_cat = torch.from_numpy(np.arange(F) % 2 == 0)
    nb = torch.full((F,), B - 1, dtype=torch.int32)
    kw = dict(min_rows=torch.tensor(1.0), reg_lambda=torch.tensor(lam))
    h = torch.from_numpy(hist)
    cmt = torch.from_numpy(cm)
    whole = best_splits(h, nb, cmt, is_cat=is_cat, **kw)
    per = [best_splits(h[:, f:f + 1], nb[f:f + 1], cmt[:, f:f + 1],
                       is_cat=is_cat[f:f + 1], **kw) for f in range(F)]
    for n in range(L):
        cands = []
        for f, (g, _, t, nal, lv, rv, lm) in enumerate(per):
            if not cm[n, f] and not cm[n, :f].all():
                # masked after another masked feature: the block publishes
                # gain -inf at its t = 0 index and nothing else
                cands.append((-math.inf, f * (B - 1) * 2, 0.0, 0.0, None))
                continue
            idx = (f * (B - 1) + int(t[n])) * 2 + int(nal[n])
            cands.append((float(g[n]), idx, float(lv[n]), float(rv[n]),
                          lm[n]))
        for order in (cands, cands[::-1], r.permutation(F)):
            seq = order if isinstance(order, list) else [cands[i]
                                                         for i in order]
            win = seq[0]
            for c in seq[1:]:
                if _better(c, win):
                    win = c
            g, idx, lv, rv, lm = win
            assert idx // (2 * (B - 1)) == int(whole[1][n])
            assert (idx // 2) % (B - 1) == int(whole[2][n])
            assert idx % 2 == int(whole[3][n])
            np.testing.assert_array_equal(
                np.array([g, lv, rv], np.float32),
                np.array([whole[0][n], whole[4][n], whole[5][n]],
                         np.float32))
            assert torch.equal(lm, whole[6][n])


# ------------------------------------------------------- the host plans


@pytest.mark.parametrize("B", [3, 4, 33, 34, 65, 126, 200, 257, 1025, 1026,
                               2049, 4097])
def test_split_plan(B):
    """The bitonic sort over the next power of two of the B-1 value bins;
    a block of one thread a sort slot (at least a warp, at most 1024
    threads), whose runs cover the value bins; the left set's words; the
    shared memory as the kernel lays it out, within the budget."""
    p = tk.split_plan(B)
    bm = B - 1
    assert p.n_sort & (p.n_sort - 1) == 0 and bm <= p.n_sort < 2 * bm
    assert p.threads % 32 == 0 and 32 <= p.threads <= tk.SPLIT_THREADS
    assert p.threads == min(tk.SPLIT_THREADS, max(32, p.n_sort))
    assert p.threads * p.per >= bm > p.threads * p.per - p.threads
    assert p.per == 1 or p.threads == tk.SPLIT_THREADS
    assert p.words * 32 >= bm > p.words * 32 - 32
    assert p.smem == 4 * (3 * B + 3 * p.threads * p.per + 2 * p.n_sort
                          + 96) + 16 * 32
    assert p.smem <= tk.SPLIT_SMEM_BYTES
    if B <= 1025:
        assert p.per == 1 and p.smem <= 48 * 1024


def test_split_plan_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="at least 3 bins"):
        tk.split_plan(2)
    with pytest.raises(ValueError, match="shared memory"):
        tk.split_plan(20_000)


def test_split_scratch_grows_by_powers_of_two_per_stream():
    """``tree_split``'s scratch: zeroed int32 words, at least what the
    launch needs, allocated once per power-of-two size and per (device,
    stream), reused while large enough; the plan is computed once per
    width."""
    dev = torch.device("cpu")
    tk._SCRATCH.clear()
    a = [t.data_ptr() for t in tk.split_scratch(5, 50, 4, dev, 1)]
    got = tk.split_scratch(5, 50, 4, dev, 1)
    assert [t.numel() for t in got] == [64, 256, 256]
    assert all(int(t.abs().sum()) == 0 for t in got)
    got = tk.split_scratch(64, 60, 4, dev, 1)
    assert [t.data_ptr() for t in got] == a
    got = tk.split_scratch(65, 100, 3, dev, 1)
    assert [t.numel() for t in got] == [128, 512, 512]
    other = tk.split_scratch(5, 50, 4, dev, 2)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(other, got))
    tk._SCRATCH.clear()
    assert tk.split_plan(126) is tk.split_plan(126)


@pytest.mark.parametrize("n_rows", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 37,
                                    40_001, 40_002, 40_003, 5_000_000])
@pytest.mark.parametrize("nid_off", [0, 1, 2, 3])
def test_route_plan_covers_every_row_once(n_rows, nid_off):
    """The vector part starts where nid is 16-byte aligned and covers
    whole groups of four rows; the scalar head and tail (fewer than four
    rows each) cover the rest, every row exactly once; the stores are
    16 bytes wide only where out is aligned like nid."""
    base = 1 << 20
    nid_addr = base + 4 * nid_off
    for out_off in range(4):
        out_addr = base + 4 * out_off
        p = tk.route_plan(n_rows, 32, 126, nid_addr, out_addr, sms=132)
        assert 0 <= p.head < 4 and 0 <= p.tail < 4 and p.n_vec >= 0
        assert p.head + 4 * p.n_vec + p.tail == n_rows
        if p.n_vec:
            assert (nid_addr + 4 * p.head) % 16 == 0
        assert p.vec_out == (out_off == nid_off)
        if p.vec_out and p.n_vec:
            assert (out_addr + 4 * p.head) % 16 == 0
        if n_rows <= 64:
            rows = list(range(p.head))
            for u in range(p.n_vec):
                rows += range(p.head + 4 * u, p.head + 4 * u + 4)
            rows += range(n_rows - p.tail, n_rows)
            assert sorted(rows) == list(range(n_rows))


@pytest.mark.parametrize("L,B", [(1, 126), (32, 126), (512, 126),
                                 (8192, 126), (512, 1025), (8192, 1025)])
def test_route_plan_shared_memory(L, B):
    """An 8-byte record a node, then the left sets as bits (ceil((B-1)/32)
    words a node) where both fit the budget, else the records alone (the
    kernel reads the byte leftmask); the deepest bucket (L = 8192) at the
    flagship width still stages its bits."""
    p = tk.route_plan(1000, L, B, 0, 0, sms=132)
    words = -(-(B - 1) // 32)
    assert p.words == words
    assert p.bits_in_smem == (8 * L + 4 * L * words <= tk.ROUTE_SMEM_BYTES)
    assert p.smem == 8 * L + (4 * L * words if p.bits_in_smem else 0)
    assert p.smem <= tk.ROUTE_SMEM_BYTES
    if B == 126:
        assert p.bits_in_smem


def test_route_plan_refuses_too_many_nodes():
    with pytest.raises(ValueError, match="records exceed"):
        tk.route_plan(10, tk.ROUTE_SMEM_BYTES // 8 + 1, 126, 0, 0, sms=132)


@pytest.mark.parametrize("n_rows", [0, 5, 4 * 512, 4 * 512 + 4, 40_001,
                                    2_500_000, 5_000_000])
@pytest.mark.parametrize("L,B", [(1, 126), (512, 126), (8192, 1025)])
def test_route_plan_grid_is_one_wave(n_rows, L, B):
    """At most ROUTE_BLOCKS_PER_SM blocks an SM, fewer where two blocks'
    shared memory (and the 1 KB the runtime keeps a block) exceed an
    SM's; no more blocks than the 16-byte groups need at one a thread;
    at least one."""
    sms = 132
    p = tk.route_plan(n_rows, L, B, 0, 0, sms=sms)
    per_sm = 2 if 2 * (p.smem + 1024) <= kernels.SM_SMEM_BYTES else 1
    assert p.blocks == max(1, min(-(-p.n_vec // tk.ROUTE_THREADS),
                                  per_sm * sms))
    if n_rows >= 5_000_000:
        assert p.blocks == per_sm * sms
