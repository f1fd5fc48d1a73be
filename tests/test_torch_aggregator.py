"""Aggregator in the PyTorch port (on the CPU) against the reference
package.

Both packages sweep the rows in the same order with the same float64
host norms and the same greedy host loop; only the batch's distances to
the exemplars so far come from another matrix product, which can flip a
decision only where a distance equals the radius to the last bit. On
the tests' continuous data the exemplar rows, counts, assignment, radius
escalation and the aggregated frame are EXACTLY the reference's. The
reference's fits run on a one-device mesh (``_one_device``)."""

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import aggregator as ref_agg

from test_torch_isofor import _one_device
from torch_threads import one_torch_thread  # noqa: F401 - autouse


def agg_cols(n=3001, seed=5):
    """Two Gaussian blobs in three columns and a categorical, with NAs
    (mean-imputed in the design)."""
    r = np.random.RandomState(seed)
    X = np.concatenate([r.randn(n // 2, 3), r.randn(n - n // 2, 3) + 3])
    X[r.rand(n) < 0.01, 1] = np.nan
    return {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
            "k": r.choice(["p", "q", "s"], n)}


def _fit(cols, **kw):
    with _one_device():
        m_r = ref_agg.AggregatorEstimator(**kw).train(
            h2o3_tpu.Frame.from_numpy(cols))
        agg_r = m_r.aggregated_frame
        out_r = {n: agg_r.col(n).to_numpy() for n in agg_r.names}
        doms_r = {n: agg_r.col(n).domain for n in agg_r.names}
    m_p = h2o3_tpu_torch.AggregatorEstimator(**kw).train(
        h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu"))
    return m_r, out_r, doms_r, m_p


@pytest.mark.parametrize("kw", [
    dict(target_num_exemplars=100),
    dict(target_num_exemplars=300, rel_tol_num_exemplars=0.2),
    dict(target_num_exemplars=150, transform="none")])
def test_exemplars_counts_assignment_exact(kw):
    cols = agg_cols()
    m_r, out_r, doms_r, m_p = _fit(cols, **kw)
    assert m_p.output["num_exemplars"] == m_r.output["num_exemplars"]
    np.testing.assert_array_equal(m_p.exemplar_assignment,
                                  m_r.exemplar_assignment)
    agg = m_p.aggregated_frame
    assert agg.names == list(out_r)
    for n in agg.names:
        np.testing.assert_array_equal(agg.col(n).to_numpy(), out_r[n])
        assert agg.col(n).domain == doms_r[n]
    assert agg.col("counts").to_numpy().sum() == len(cols["a"])
    assert m_p.output["num_exemplars"] <= kw["target_num_exemplars"]
    # the aggregated frame is stored under output["output_frame"], as
    # the reference stores it
    assert h2o3_tpu_torch.DKV.get(m_p.output["output_frame"]) is agg
    assert m_r.output["output_frame"] == m_r.aggregated_frame.key
    assert m_p.output["sweeps"] >= 1 and m_p.output["radius"] > 0


def test_at_most_target_rows_every_row_is_an_exemplar():
    cols = agg_cols(n=120)
    m_r, out_r, doms_r, m_p = _fit(cols, target_num_exemplars=200)
    agg = m_p.aggregated_frame
    assert agg.nrows == 120 and m_p.output["num_exemplars"] == 120
    np.testing.assert_array_equal(agg.col("counts").to_numpy(),
                                  np.ones(120))
    # the categorical comes back decoded into its levels
    assert agg.col("k").domain == doms_r["k"] == ["p", "q", "s"]
    np.testing.assert_array_equal(agg.col("k").to_numpy(), out_r["k"])
    np.testing.assert_array_equal(agg.col("a").to_numpy(), cols["a"])
    assert m_p.model_performance(agg) is None
    with pytest.raises(NotImplementedError):
        m_p.predict(agg)
