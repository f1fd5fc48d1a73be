"""Checkpoint-restart parity of the PyTorch port (on the CPU) against the
reference package: ``checkpoint=<model>`` on GBM and DRF.

A restart rebins the frame with the donor's edges, resumes from the
donor's forest and appends ``ntrees - prior_T`` trees, tree t of the new
part drawn as tree prior_T + t of one longer fit.

- A port restart from a reference model carried across
  (``models/convert.py``, its training params included) grows the
  reference restart's trees on tie-free data: integer fields EXACT,
  leaves within rtol 1e-5.
- DRF's trees do not depend on margins and its out-of-bag accumulators
  continue, so 4 → 8 trees is bit-equal to one 8-tree fit, forest and
  OOB metrics (the reference's contract, sampled bags and mtries draws
  included).
- GBM's restart resumes its margins as f0 + the donor forest, where one
  longer fit adds them tree by tree: the reference pins only the prefix
  (trees 1..4 are the donor's). On this tie-free data the splits of the
  whole forest also equal the longer fit's; its later leaves differ in
  the last bits, so they are held within rtol 1e-5."""

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models.drf import DRFEstimator as RefDRF
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu_torch.models.convert import (drf_model_from_arrays,
                                           gbm_model_from_arrays)
from h2o3_tpu_torch.models.tree import Tree

from test_torch_drf import _ref_arrays as _drf_arrays
from test_torch_gbm import INT_FIELDS, _assert_forests, _ref_arrays
from torch_ranks import mixed_cols, multi_cols
from torch_threads import one_torch_thread  # noqa: F401 - autouse

GBM_KW = dict(max_depth=4, seed=11, sample_rate=1.0)


def _frames(cols, cats):
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=cats),
            h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                            device="cpu"))


@pytest.fixture(scope="module")
def binomial():
    return _frames(*mixed_cols(seed=6))


def _bit_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in Tree._fields)


def test_gbm_restart_from_converted_reference_equals_reference(binomial):
    fr_r, fr_p = binomial
    part_r = RefGBM(ntrees=4, **GBM_KW).train(fr_r, y="y")
    res_r = RefGBM(ntrees=8, checkpoint=part_r, **GBM_KW).train(fr_r, y="y")
    donor = gbm_model_from_arrays(
        dict(_ref_arrays(part_r), params=part_r.params,
             init_f=part_r.output["init_f"]), device="cpu")
    res_p = h2o3_tpu_torch.GBMEstimator(ntrees=8, checkpoint=donor,
                                        **GBM_KW).train(fr_p, y="y")
    assert res_p.forest.feat.shape[0] == 8
    _assert_forests(res_r, res_p)
    assert res_p.f0 == res_r.f0
    assert res_p.output["init_f"] == res_r.output["init_f"]
    for k in ("AUC", "logloss", "MSE"):
        assert res_p.training_metrics[k] == pytest.approx(
            res_r.training_metrics[k], abs=1e-5), k


def test_drf_restart_from_converted_reference_equals_reference(binomial):
    """Unbagged, every column scored: deterministic in both packages."""
    fr_r, fr_p = binomial
    kw = dict(max_depth=5, seed=11, sample_rate=1.0, mtries=5)
    part_r = RefDRF(ntrees=3, **kw).train(fr_r, y="y")
    res_r = RefDRF(ntrees=6, checkpoint=part_r, **kw).train(fr_r, y="y")
    oob_sum, oob_cnt = part_r._oob
    donor = drf_model_from_arrays(
        dict(_drf_arrays(part_r), params=part_r.params, oob_sum=oob_sum,
             oob_cnt=oob_cnt), device="cpu")
    res_p = h2o3_tpu_torch.DRFEstimator(ntrees=6, checkpoint=donor,
                                        **kw).train(fr_p, y="y")
    _assert_forests(res_r, res_p)
    np.testing.assert_allclose(res_p.predict(fr_p).col("p1").to_numpy(),
                               res_r.predict(fr_r).col("p1").to_numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("case", ["binomial", "multinomial"])
def test_drf_checkpoint_4_to_8_bit_equal_to_one_fit(case):
    cols, cats = mixed_cols(seed=4) if case == "binomial" else \
        multi_cols(seed=3)
    _, fr = _frames(cols, cats)
    kw = dict(max_depth=6, seed=5)      # bagged, sqrt(F) mtries a node
    one = h2o3_tpu_torch.DRFEstimator(ntrees=8, **kw).train(fr, y="y")
    part = h2o3_tpu_torch.DRFEstimator(ntrees=4, **kw).train(fr, y="y")
    res = h2o3_tpu_torch.DRFEstimator(ntrees=8, checkpoint=part,
                                      **kw).train(fr, y="y")
    assert _bit_equal(res.forest, one.forest)
    for k in ("AUC", "logloss", "MSE"):
        assert res.training_metrics[k] == one.training_metrics[k], k
    for a, b in zip(res._oob, one._oob):
        assert torch.equal(a, b)


def test_gbm_checkpoint_prefix_and_longer_fit(binomial):
    _, fr = binomial
    # seed 5: no near-tie split on this data in either summation order
    kw = dict(GBM_KW, seed=5, sample_rate=0.8, col_sample_rate_per_tree=0.8)
    one = h2o3_tpu_torch.GBMEstimator(ntrees=8, **kw).train(fr, y="y")
    part = h2o3_tpu_torch.GBMEstimator(ntrees=4, **kw).train(fr, y="y")
    res = h2o3_tpu_torch.GBMEstimator(ntrees=8, checkpoint=part,
                                      **kw).train(fr, y="y")
    assert _bit_equal(Tree(*(a[:4] for a in res.forest)), part.forest)
    assert _bit_equal(Tree(*(a[:4] for a in one.forest)), part.forest)
    for f in INT_FIELDS:
        assert torch.equal(getattr(res.forest, f), getattr(one.forest, f)), f
    np.testing.assert_allclose(res.forest.leaf.numpy(),
                               one.forest.leaf.numpy(), rtol=1e-5,
                               atol=1e-7)
    assert res.training_metrics["AUC"] == pytest.approx(
        one.training_metrics["AUC"], abs=1e-6)


def test_gbm_multinomial_checkpoint_continues_class_trees():
    _, fr = _frames(*multi_cols(seed=3))
    one = h2o3_tpu_torch.GBMEstimator(ntrees=4, **GBM_KW).train(fr, y="y")
    part = h2o3_tpu_torch.GBMEstimator(ntrees=2, **GBM_KW).train(fr, y="y")
    res = h2o3_tpu_torch.GBMEstimator(ntrees=4, checkpoint=part,
                                      **GBM_KW).train(fr, y="y")
    assert res.forest.feat.shape[0] == 4 * 3
    for f in INT_FIELDS:
        assert torch.equal(getattr(res.forest, f), getattr(one.forest, f)), f
    assert res.training_metrics["logloss"] == pytest.approx(
        one.training_metrics["logloss"], rel=1e-5)


@pytest.mark.parametrize("algo,knob,value", [
    ("gbm", "max_depth", 5), ("gbm", "nbins", 32), ("gbm", "sample_rate", 0.7),
    ("gbm", "min_rows", 5.0), ("gbm", "nbins_cats", 64),
    ("drf", "mtries", 2), ("drf", "max_depth", 3), ("drf", "nbins", 32)])
def test_non_modifiable_fields_match_reference_errors(binomial, algo, knob,
                                                      value):
    fr_r, fr_p = binomial
    ref_cls, port_cls = ((RefGBM, h2o3_tpu_torch.GBMEstimator)
                         if algo == "gbm" else
                         (RefDRF, h2o3_tpu_torch.DRFEstimator))
    kw = dict(max_depth=4, seed=5)
    errors = []
    for cls, fr in ((ref_cls, fr_r), (port_cls, fr_p)):
        part = cls(ntrees=2, **kw).train(fr, y="y")
        with pytest.raises(ValueError) as ei:
            cls(ntrees=4, checkpoint=part,
                **dict(kw, **{knob: value})).train(fr, y="y")
        errors.append(str(ei.value))
    assert f"ERRR on field: _{knob}" in errors[1]
    assert "cannot be modified if checkpoint is provided" in errors[1]
    assert errors[1] == errors[0]


@pytest.mark.parametrize("change", ["ntrees", "response", "predictors",
                                    "distribution"])
def test_donor_checks_match_reference_errors(change):
    cols, cats = mixed_cols(n=300, seed=2)
    cols = dict(cols, z=(cols["y"] == "Y").astype(float) + cols["x0"])
    fr_r, fr_p = _frames(cols, cats)
    feats = ["x0", "x1", "x2", "x3", "c"]
    y = "z" if change == "distribution" else "y"
    errors = []
    for cls, fr in ((RefGBM, fr_r), (h2o3_tpu_torch.GBMEstimator, fr_p)):
        part = cls(ntrees=3, max_depth=3, seed=5).train(fr, y=y, x=feats)
        kw = dict(ntrees=3 if change == "ntrees" else 5, max_depth=3,
                  seed=5, checkpoint=part)
        if change == "distribution":
            kw["distribution"] = "laplace"
        with pytest.raises(ValueError) as ei:
            cls(**kw).train(fr, y="x1" if change == "response" else y,
                            x=feats[:-1] if change == "predictors"
                            else ["x0", "x2", "x3", "c"]
                            if change == "response" else feats)
        errors.append(str(ei.value))
    assert errors[1] == errors[0]


def test_checkpoint_by_key_or_wrong_model(binomial):
    _, fr = binomial
    with pytest.raises(ValueError, match="'model_key' not found"):
        h2o3_tpu_torch.GBMEstimator(ntrees=2, checkpoint="model_key").train(
            fr, y="y")
    donor = h2o3_tpu_torch.GBMEstimator(ntrees=1, max_depth=2).train(fr,
                                                                     y="y")
    by_key = h2o3_tpu_torch.GBMEstimator(ntrees=2, max_depth=2,
                                         checkpoint=donor.key).train(fr,
                                                                     y="y")
    by_obj = h2o3_tpu_torch.GBMEstimator(ntrees=2, max_depth=2,
                                         checkpoint=donor).train(fr, y="y")
    assert torch.equal(by_key.forest.leaf, by_obj.forest.leaf)
    drf = h2o3_tpu_torch.DRFEstimator(ntrees=1, max_depth=2).train(fr, y="y")
    with pytest.raises(ValueError, match="not a gbm model"):
        h2o3_tpu_torch.GBMEstimator(ntrees=2, checkpoint=drf).train(fr, y="y")
