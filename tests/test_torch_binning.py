"""Binning parity: the port's ``bin_frame`` against the reference's on the
same numpy columns — bins, nbins and edges exactly equal; padding rows
carry weight 0 in both."""

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.frame.binning import bin_frame as ref_bin_frame
from h2o3_tpu.frame.binning import rebin_for_scoring as ref_rebin
from h2o3_tpu_torch.frame.binning import bin_frame, rebin_for_scoring
from torch_threads import one_torch_thread  # noqa: F401 - autouse


def _frames(cols, categorical=(), domains=None):
    ref = h2o3_tpu.Frame.from_numpy(cols, categorical=categorical,
                                    domains=domains)
    port = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=categorical,
                                           domains=domains, device="cpu")
    return ref, port


def _mixed_cols(n=500, seed=0):
    r = np.random.RandomState(seed)
    x0 = r.randn(n)
    x0[r.rand(n) < 0.1] = np.nan
    x1 = r.randint(0, 40, n).astype(float)          # integral numeric
    codes = r.randint(0, 150, n)                    # > nbins_cats levels
    codes[r.rand(n) < 0.05] = -1                    # NA code
    return {"x0": x0, "x1": x1,
            "s": r.choice(["lo", "mid", "hi", None], n).astype(object),
            "k": codes, "z": np.round(r.randn(n) * 3, 1)}, \
        {"k": [f"L{i:03d}" for i in range(150)]}


def _case(name):
    """(ref_bm, port_bm, ref_frame, port_frame) for one case — the five
    edge cases of tests/test_tree_kernels.py plus a mixed frame."""
    r = np.random.RandomState
    if name == "mixed":
        cols, doms = _mixed_cols()
        fr, fp = _frames(cols, categorical=["s"], domains=doms)
        kw = dict(nbins=16, nbins_cats=64)
        feats = list(cols)
    elif name == "nbins1":
        fr, fp = _frames({"a": r(0).randn(64),
                          "b": np.arange(64, dtype=float)})
        kw, feats = dict(nbins=1), ["a", "b"]
    elif name == "single_row":
        fr, fp = _frames({"a": np.array([1.5]), "b": np.array([-2.0])})
        kw, feats = dict(nbins=8), ["a", "b"]
    elif name == "all_na":
        fr, fp = _frames({"a": np.full(50, np.nan), "b": r(1).randn(50)})
        kw, feats = dict(nbins=8), ["a", "b"]
    elif name == "constant":
        fr, fp = _frames({"a": np.full(50, 3.25), "b": r(2).randn(50)})
        kw, feats = dict(nbins=8), ["a", "b"]
    elif name == "unseen_levels":
        tr = {"c": r(3).choice(["a", "b"], 60), "x": r(4).randn(60)}
        sc = {"c": r(5).choice(["a", "b", "c", "d"], 40), "x": r(6).randn(40)}
        tr_r, tr_p = _frames(tr, categorical=["c"])
        sc_r, sc_p = _frames(sc, categorical=["c"])
        bm_r = ref_rebin(ref_bin_frame(tr_r, ["c", "x"], nbins=8), sc_r)
        bm_p = rebin_for_scoring(bin_frame(tr_p, ["c", "x"], nbins=8), sc_p)
        return bm_r, bm_p, sc_r, sc_p
    else:
        raise AssertionError(name)
    return (ref_bin_frame(fr, feats, **kw), bin_frame(fp, feats, **kw),
            fr, fp)


@pytest.mark.parametrize("case", ["mixed", "nbins1", "single_row", "all_na",
                                  "constant", "unseen_levels"])
def test_bin_frame_parity(case):
    bm_r, bm_p, fr, fp = _case(case)
    n = bm_r.nrows
    assert bm_p.nrows == n
    assert bm_p.nbins_total == bm_r.nbins_total
    bins_r = np.asarray(bm_r.bins)
    bins_p = bm_p.bins.numpy()
    assert bins_p.dtype == bins_r.dtype
    np.testing.assert_array_equal(bins_p[:n], bins_r[:n])
    np.testing.assert_array_equal(bm_p.nbins.numpy(), np.asarray(bm_r.nbins))
    np.testing.assert_array_equal(bm_p.edges.numpy(), np.asarray(bm_r.edges))
    np.testing.assert_array_equal(bm_p.is_cat, bm_r.is_cat)
    assert bm_p.domains == bm_r.domains
    # padding contract: rows past nrows have weight 0 in both packages
    w_r = np.asarray(fr.valid_weights())
    w_p = fp.valid_weights().numpy()
    assert w_p.shape[0] == bins_p.shape[0]
    np.testing.assert_array_equal(w_p[:n], w_r[:n])
    assert not w_p[n:].any() and not w_r[n:].any()


def test_frame_columns_match_reference():
    """Domains, NA masks and host views agree column for column."""
    cols, doms = _mixed_cols(n=300, seed=4)
    fr, fp = _frames(cols, categorical=["s"], domains=doms)
    for name in cols:
        cr, cp = fr.col(name), fp.col(name)
        assert cp.type == cr.type, name
        assert cp.domain == cr.domain, name
        np.testing.assert_array_equal(cp.to_numpy(), cr.to_numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(
            cp.na_mask.numpy()[:300], np.asarray(cr.na_mask)[:300])
