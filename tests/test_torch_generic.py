"""The port's ``GenericEstimator`` (``h2o3_tpu_torch/models/generic.py``)
against the reference's: a MOJO the reference wrote and the one the port
writes of the same model carried across each import as a generic model
whose predictions and training metrics equal the reference generic
model's; and the construction without a frame (the reference's
``tests/test_genmodel.py`` ``test_generic_without_frame``)."""

import numpy as np
import pytest

import h2o3_tpu_torch as h2o
from h2o3_tpu_torch.models import get_builder
from h2o3_tpu_torch.models.generic import GenericEstimator, GenericModel

from torch_mojo_models import carried, cols, port_frame, ref_frame
from torch_threads import one_torch_thread  # noqa: F401 - autouse
from test_torch_isofor import _one_device

METRICS = ("AUC", "logloss", "MSE", "mean_per_class_error")


@pytest.fixture(scope="module")
def mojos(tmp_path_factory):
    """algo → (reference MOJO path, port MOJO path, the reference's
    generic predictions and training metrics on the scoring rows)."""
    from h2o3_tpu.models.generic import GenericEstimator as RefGeneric
    d = tmp_path_factory.mktemp("mojos")
    out = {}
    c = cols(n=200, seed=4)
    for algo in ("gbm", "glm", "deeplearning"):
        m_r, m_p = carried(algo)
        pr, pp = str(d / f"{algo}_r.zip"), str(d / f"{algo}_p.zip")
        m_r.download_mojo(pr)
        m_p.download_mojo(pp)
        with _one_device():
            fr = ref_frame(c)
            g = RefGeneric(path=pr).train(fr, y="y")
            pred = g.predict(fr)
            want = {n: pred.col(n).to_numpy() for n in pred.names}
            mets = {k: g.training_metrics[k] for k in METRICS}
        out[algo] = (pr, pp, want, mets)
    return out


@pytest.mark.parametrize("source", ["reference", "port"])
@pytest.mark.parametrize("algo", ["gbm", "glm", "deeplearning"])
def test_generic_model_matches_the_references(mojos, algo, source):
    pr, pp, want, mets = mojos[algo]
    fr = port_frame(cols(n=200, seed=4))
    g = GenericEstimator(path=pr if source == "reference" else pp).train(
        fr, y="y")
    assert isinstance(g, GenericModel) and g.output["source_algo"] == algo
    pred = g.predict(fr)
    assert pred.names == list(want)
    for n in pred.names:
        np.testing.assert_array_equal(pred.col(n).to_numpy(), want[n],
                                      err_msg=n)
    for k in METRICS:
        assert g.training_metrics[k] == pytest.approx(mets[k], rel=1e-6,
                                                      abs=1e-7), k
    assert h2o.DKV.get(g.key) is g


def test_generic_without_frame(mojos):
    _, pp, want, _ = mojos["gbm"]
    g = h2o.GenericEstimator(path=pp).train()
    assert h2o.DKV.get(g.key) is g and g.training_metrics is None
    out = g.predict(port_frame(cols(n=200, seed=4)))
    assert "p1" in out.names
    np.testing.assert_array_equal(out.col("p1").to_numpy(), want["p1"])
    job = h2o.GenericEstimator(path=pp).train(background=True)
    assert job.join().result.output["source_algo"] == "gbm"
    with pytest.raises(ValueError, match="requires path"):
        h2o.GenericEstimator()
    assert get_builder("generic") is GenericEstimator
