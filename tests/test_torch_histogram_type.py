"""DRF's ``histogram_type`` in the PyTorch port (on the CPU) against the
reference package: the bin edges of every spelling, unsampled forests,
and the five DRF parameters both packages accept and leave inert.

Edges and integer forest fields must be EXACTLY equal (the binomial
response makes 0/1 stats); leaf values within rtol 1e-5."""

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.frame.binning import bin_frame as ref_bin_frame
from h2o3_tpu.models.drf import DRFEstimator as RefDRF
from h2o3_tpu_torch.frame.binning import bin_frame
from h2o3_tpu_torch.models.drf import edge_method
from h2o3_tpu_torch.models.tree import Tree

from tests.test_torch_gbm import _assert_forests
from torch_ranks import mixed_cols
from torch_threads import one_torch_thread  # noqa: F401 - autouse

SPELLINGS = ("auto", "QuantilesGlobal", "UniformAdaptive", "Random",
             "RoundRobin")
X = ["x0", "x1", "x2", "x3", "c"]


def _frames(n=700, seed=6):
    cols, cats = mixed_cols(n=n, seed=seed)
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=cats),
            h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                            device="cpu"))


@pytest.mark.parametrize("ht", SPELLINGS)
def test_edges_exact_for_every_spelling(ht):
    fr_r, fr_p = _frames()
    method = edge_method(ht)
    assert method == {"auto": "quantiles", "QuantilesGlobal": "quantiles",
                      "UniformAdaptive": "uniform", "Random": "random",
                      "RoundRobin": "roundrobin"}[ht]
    for nbins in (20, 64):
        b_r = ref_bin_frame(fr_r, X, nbins=nbins, histogram_type=method)
        b_p = bin_frame(fr_p, X, nbins=nbins, histogram_type=method)
        np.testing.assert_array_equal(b_p.edges.numpy(),
                                      np.asarray(b_r.edges))
        np.testing.assert_array_equal(b_p.nbins.numpy(),
                                      np.asarray(b_r.nbins))
        np.testing.assert_array_equal(
            b_p.bins.numpy(), np.asarray(b_r.bins)[:b_p.bins.shape[0]])
    # through the estimators: the same mapping in both packages
    kw = dict(ntrees=1, max_depth=3, seed=1, histogram_type=ht)
    m_r = RefDRF(**kw).train(fr_r, y="y")
    m_p = h2o3_tpu_torch.DRFEstimator(**kw).train(fr_p, y="y")
    np.testing.assert_array_equal(m_p.bm.edges.numpy(),
                                  np.asarray(m_r.bm.edges))


def test_uniform_and_random_edges_differ_from_quantiles():
    _, fr = _frames()
    e = {m: bin_frame(fr, X[:4], nbins=20, histogram_type=m).edges.numpy()
         for m in ("quantiles", "uniform", "random")}
    assert not np.array_equal(e["quantiles"], e["uniform"])
    assert not np.array_equal(e["uniform"], e["random"])
    d = np.diff(e["uniform"][0])
    np.testing.assert_allclose(d, d[0], rtol=1e-4)      # equal widths


@pytest.mark.parametrize("ht", ["UniformAdaptive", "Random"])
def test_unsampled_forest_exact(ht):
    fr_r, fr_p = _frames()
    kw = dict(ntrees=4, max_depth=6, seed=11, sample_rate=1.0, mtries=5,
              histogram_type=ht)
    m_r = RefDRF(**kw).train(fr_r, y="y")
    m_p = h2o3_tpu_torch.DRFEstimator(**kw).train(fr_p, y="y")
    _assert_forests(m_r, m_p)
    assert m_p.forest.is_split.sum() > 20
    np.testing.assert_allclose(m_p.predict(fr_p).col("p1").to_numpy(),
                               m_r.predict(fr_r).col("p1").to_numpy(),
                               atol=1e-6)


INERT = dict(stopping_rounds=3, stopping_metric="AUC",
             stopping_tolerance=0.1, binomial_double_trees=True,
             distribution="bernoulli")


def test_inert_parameters_change_nothing_in_both_packages():
    fr_r, fr_p = _frames(n=500, seed=4)
    kw = dict(ntrees=3, max_depth=5, seed=7)
    base_r = RefDRF(**kw).train(fr_r, y="y")
    set_r = RefDRF(**kw, **INERT).train(fr_r, y="y")
    for f in base_r.forest._fields:
        np.testing.assert_array_equal(np.asarray(getattr(set_r.forest, f)),
                                      np.asarray(getattr(base_r.forest, f)))
    base_p = h2o3_tpu_torch.DRFEstimator(**kw).train(fr_p, y="y")
    set_p = h2o3_tpu_torch.DRFEstimator(**kw, **INERT).train(fr_p, y="y")
    for f in Tree._fields:
        assert torch.equal(getattr(set_p.forest, f),
                           getattr(base_p.forest, f)), f
    assert set_p.training_metrics["AUC"] == base_p.training_metrics["AUC"]
