"""Data-parallel DRF, the XGBoost facade, Uplift DRF and the isolation
forests: the port's fits on W = 2 gloo ranks, each holding only its own
rows of a partitioned frame (``Frame.from_numpy_partitioned`` → ``train``
→ ``predict`` / ``model_performance``), held three ways:

- against the port's world-1 fit of the same rows: the bags are drawn as
  one device draws them and every sum of a tree is all-reduced, so the
  forests' integer fields are EXACT, sampled fits included (DRF's bag,
  column and per-node ``mtries`` draws, uplift's bag, the isolation
  forests' samples and decisions); the leaves of real-valued stats (a
  regression, the facade's gradients) within rtol 1e-5 (on the CPU a
  float32 histogram sums each rank's rows before the ranks'), metrics
  and scores within 1e-5;
- against the reference on a data = 2 CPU mesh, where the packages draw
  alike (no bagging, every column): integer fields EXACT, leaves within
  rtol 1e-5. The isolation trees grow from the reference's own draws
  and bags (the reference grows them on one device: its whole fits'
  tree loops can abort on a multi-device CPU mesh,
  tests/test_torch_extisofor.py): EXACT;
- rank against rank: the same model bit for bit, and ``predict``
  partitioned like its input.

The ranks run once for the module (``tests/torch_ranks.py``, a 120 s
join timeout), while this process fits the reference and the world-1
port."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.frame.binning import bin_frame as ref_bin_frame
from h2o3_tpu.models import extisofor as ref_ext
from h2o3_tpu.models import isofor as ref_iso
from h2o3_tpu.models.drf import DRFEstimator as RefDRF
from h2o3_tpu.models.uplift import UpliftDRFEstimator as RefUplift
from h2o3_tpu.models.xgboost import XGBoostEstimator as RefXGB
from h2o3_tpu.parallel import mesh as ref_mesh

import torch_ranks as tr
from test_torch_isofor import _one_device
from torch_threads import one_torch_thread  # noqa: F401 - autouse

INT_FIELDS = ("feat", "thresh", "na_left", "is_split", "cat_split",
              "left_words")
METRICS = {"drf": ("AUC", "logloss", "MSE", "mean_residual_deviance",
                   "mean_per_class_error"),
           "xgboost": ("AUC", "logloss", "MSE"),
           "uplift": ("auuc", "qini", "uplift_top_decile", "MSE"),
           "isofor": ("mean_score", "mean_length"),
           "extisofor": ("mean_score", "mean_length")}
REF = {"drf": RefDRF, "xgboost": RefXGB, "uplift": RefUplift}


def _ref_fit(case):
    kind, make, y, params = tr.TREE_CASES[case]
    cols, cats = make()
    old = ref_mesh.get_mesh()
    try:
        ref_mesh.set_global_mesh(ref_mesh.make_mesh(jax.devices("cpu")[:2],
                                                    2, 1))
        fr = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
        m = REF[kind](**params).train(fr, y=y)
        return m, m._score_raw(fr)
    finally:
        ref_mesh.set_global_mesh(old)


def _reference_draws():
    """The reference's isolation trees from its own draws and a bag (on
    one device), and the draws the ranks grow from."""
    cols, cats = tr.anomaly_cols()
    n = len(cols["x0"])
    r = np.random.RandomState(5)
    keeps = []
    for _ in range(2):
        keep = np.zeros(n, np.float32)
        keep[r.choice(n, tr.ISO_BAG, replace=False)] = 1.0
        keeps.append(keep)
    iso, ext = [], []
    with _one_device():
        fr = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
        bm = ref_bin_frame(fr, list(cols), nbins=64, nbins_cats=64,
                           histogram_type="uniform")
        X, _ = ref_ext._feature_matrix(fr, tr.ISO_NUM)
        lo, hi = jnp.min(X, axis=0), jnp.max(X, axis=0)
        for k, keep in enumerate(keeps):
            w = jnp.asarray(np.pad(keep, (0, bm.bins.shape[0] - n)))
            t = ref_iso._grow_random_tree(
                bm.bins, bm.nbins, w, jax.random.PRNGKey(k),
                depth=tr.ISO_DEPTH, B=bm.nbins_total)
            plen = np.asarray(ref_iso._tree_path_length(
                t, bm.bins, bm.nbins_total))[:n]
            iso.append(dict({f: np.array(getattr(t, f)) for f in
                             ("feat", "thresh", "na_left", "is_split",
                              "leaf_w", "leaf")}, keep=keep, plen=plen))
            w = jnp.asarray(np.pad(keep, (0, X.shape[0] - n)))
            t = ref_ext._grow_ext_tree(X, lo, hi, w, jax.random.PRNGKey(k),
                                       depth=tr.ISO_DEPTH, ext=2)
            ext.append(dict({f: np.array(getattr(t, f)) for f in
                             ("normals", "offsets", "is_split", "leaf")},
                            keep=keep))
    return iso, ext


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("trees")
    iso, ext = _reference_draws()
    with open(run_dir / "input.pkl", "wb") as f:
        pickle.dump({"iso_draws": iso, "ext_draws": ext}, f)
    join = tr.start_ranks("trees", run_dir)
    refs = {case: _ref_fit(case) for case in tr.TREE_REF_CASES}
    ports = {}
    for case, (kind, make, y, params) in tr.TREE_CASES.items():
        cols, cats = make()
        fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                             device="cpu")
        m = tr.tree_estimator(kind, params).train(fr, y=y)
        ports[case] = (m, m._score_raw(fr))
    return refs, ports, (iso, ext), join()


def _assert_forest(got, want, label, exact_leaves=False):
    for f, v in want.items():
        g = got[f]
        if f == "left_words":
            g = g.view(np.uint32) if v.dtype == np.uint32 else g
        if f in INT_FIELDS or exact_leaves or v.dtype == bool:
            np.testing.assert_array_equal(g, v, err_msg=f"{label}: '{f}'")
        else:
            np.testing.assert_allclose(g, v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{label}: '{f}'")


def _assert_scores(got, want, label):
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{label}: {k}")


def _assert_metrics(got, want, kind, label):
    for k in METRICS[kind]:
        if k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-5), \
                (label, k)


@pytest.mark.parametrize("case", list(tr.TREE_CASES))
def test_two_rank_fit_equals_world_one_fit(fits, case):
    _, ports, _, ranks = fits
    kind = tr.TREE_CASES[case][0]
    m_p, raw = ports[case]
    want = tr.forest_arrays(m_p)
    # the isolation forests' every field comes from integer counts or the
    # draws: EXACT; so are the binomial and multinomial DRF's 0/1 stats
    exact = kind in ("isofor", "extisofor") or case in (
        "drf_binomial", "drf_multinomial", "drf_sampled") or \
        kind == "uplift"
    for r, res in enumerate(ranks):
        c = res[case]
        _assert_forest(c["forest"], want, f"rank {r}", exact_leaves=exact)
        tm = tr._metrics(m_p)
        if exact:
            assert c["metrics"] == tm, r
        _assert_metrics(c["metrics"], tm, kind, f"rank {r}")
        _assert_scores(c["raw"], raw, f"rank {r}")
    assert ranks[0][case]["forest"]["is_split"].any()


@pytest.mark.parametrize("case", tr.TREE_REF_CASES)
def test_two_rank_fit_equals_reference_data2_fit(fits, case):
    refs, _, _, ranks = fits
    kind = tr.TREE_CASES[case][0]
    m_r, raw_r = refs[case]
    want = {f: np.asarray(getattr(m_r.forest, f))
            for f in m_r.forest._fields}
    for k in ("leaf_pt", "leaf_pc"):
        if hasattr(m_r, k):
            want[k] = np.asarray(getattr(m_r, k))
    for r, res in enumerate(ranks):
        c = res[case]
        got = dict(c["forest"])
        _assert_forest(got, want, f"rank {r} vs the reference")
        tm_r = m_r.training_metrics
        tm_r = tm_r.to_dict() if hasattr(tm_r, "to_dict") else dict(tm_r)
        _assert_metrics(c["metrics"], tm_r, kind, f"rank {r}")
        _assert_scores(c["raw"], raw_r, f"rank {r} vs the reference")


@pytest.mark.parametrize("case", list(tr.TREE_CASES))
def test_every_rank_holds_the_same_model(fits, case):
    _, _, _, (a, b) = fits
    for f, v in a[case]["forest"].items():
        np.testing.assert_array_equal(v, b[case]["forest"][f], err_msg=f)
    assert a[case]["metrics"] == b[case]["metrics"]
    assert a[case]["perf"] == b[case]["perf"]
    for k, v in a[case]["raw"].items():
        np.testing.assert_array_equal(v, b[case]["raw"][k], err_msg=k)
    # the fit reduced over the ranks (and counted what it reduced)
    coll = a[case]["collectives"]
    assert coll["all_reduce"] > 0 and coll["bytes"] > 0


@pytest.mark.parametrize("case", list(tr.TREE_CASES))
def test_predict_is_partitioned_like_its_input(fits, case):
    _, _, _, ranks = fits
    for res in ranks:
        c = res[case]
        lo, hi = c["span"]
        n = len(next(iter(c["raw"].values())))
        nl = max(min(hi, n) - lo, 0)
        for col, full in c["raw"].items():
            full = np.asarray(full, np.float64)
            np.testing.assert_allclose(c["pred"][col], full, rtol=1e-6,
                                       err_msg=col)
            assert c["pred_local"][col].shape == (hi - lo,)
            np.testing.assert_allclose(c["pred_local"][col][:nl],
                                       full[lo:lo + nl], rtol=1e-6,
                                       err_msg=col)


@pytest.mark.parametrize("kind", ["isofor", "extisofor"])
def test_isolation_trees_from_reference_draws_exact(fits, kind):
    """Each rank grows the reference's trees from its draws and bags on
    its own rows, the node counts all-reduced: every split, leaf count
    and path correction EXACT (and every row's path length, IF)."""
    _, _, (iso, ext), ranks = fits
    want_all = iso if kind == "isofor" else ext
    for r, res in enumerate(ranks):
        lo, hi = res["isofor"]["span"]
        for k, (got, want) in enumerate(zip(res["grown"][kind], want_all)):
            for f in ("is_split", "thresh", "leaf_w", "leaf"):
                if f in got:
                    np.testing.assert_array_equal(
                        got[f], want[f], err_msg=f"rank {r} tree {k}: {f}")
            if kind == "isofor":
                n = want["plen"].shape[0]
                nl = max(min(hi, n) - lo, 0)
                np.testing.assert_array_equal(got["plen"][:nl],
                                              want["plen"][lo:lo + nl])
            assert got["is_split"].sum() > 10
