"""The port's serving tier (``h2o3_tpu_torch/serving``) on the CPU.

- Served rows are bit-identical to ``Model.predict`` on the same rows for
  GBM, DRF, GLM and DeepLearning × binomial, multinomial and regression
  (categorical NAs and unseen levels included), whatever the batch they
  ride in, as the reference holds its engine (``tests/test_serving.py``).
- Served rows equal the reference engine's for reference forests
  carried across (``models/convert.py``).
- A 16-thread storm on a fresh model warms each row bucket once.
- A full queue raises ``QueueSaturated`` rather than blocking; an
  expired deadline fails in the queue without a dispatch.
- Eviction, then re-registration; ``ServingUnsupported`` and the
  ``parse_rows`` errors.
"""

import threading
import time

import numpy as np
import pytest

import h2o3_tpu_torch as h2o
from h2o3_tpu_torch.core import request_ctx
from h2o3_tpu_torch.ml.calibration import Calibrator
from h2o3_tpu_torch.serving import batcher as batcher_mod
from h2o3_tpu_torch.serving.batcher import (MicroBatcher, PendingScore,
                                            QueueSaturated)
from h2o3_tpu_torch.serving.engine import ScoringEngine, buckets_for
from h2o3_tpu_torch.serving.rows import (ServingUnsupported, parse_rows,
                                         serving_schema)

from torch_mojo_models import carried, cols, port_frame
from torch_threads import one_torch_thread  # noqa: F401 - autouse

# the reference engine's dispatcher threads put keys the test thread's
# Scope cannot see (the reference's own serving tests opt out alike)
pytestmark = pytest.mark.allow_key_leak

N_ROWS = 240
ALGOS = ["gbm", "drf", "glm", "dl"]
KINDS = ["bin", "mul", "reg"]


def serving_cols(resp, n=N_ROWS, seed=14):
    """The reference's serving-test frame: numeric NAs, two categoricals
    and the response."""
    r = np.random.RandomState(seed)
    x1 = r.randn(n)
    x1[::17] = np.nan
    cols = {"x1": x1, "x2": r.randn(n) * 3 + 1,
            "x3": r.randint(0, 50, n).astype(np.float64),
            "c1": np.array([["a", "b", "c", "d"][i % 4] for i in range(n)],
                           dtype=object),
            "c2": np.array([["u", "v"][i % 2] for i in range(n)],
                           dtype=object)}
    cols["c1"][5::19] = None
    if resp == "bin":
        yv = (np.nan_to_num(x1) + cols["x2"] * 0.2 + r.randn(n) > 0.5)
        cols["y"] = np.array(["no", "yes"], dtype=object)[yv.astype(int)]
    elif resp == "mul":
        cols["y"] = np.array(["r", "g", "b"], dtype=object)[
            r.randint(0, 3, n)]
    else:
        cols["y"] = cols["x2"] * 0.5 + r.randn(n)
    return cols


def _frame(cols):
    return h2o.Frame.from_numpy(cols, device="cpu")


def _train(algo, kind):
    fr = _frame(serving_cols(kind))
    x = [c for c in fr.names if c != "y"]
    est = {"gbm": lambda: h2o.GBMEstimator(ntrees=5, max_depth=3, seed=1),
           "drf": lambda: h2o.DRFEstimator(ntrees=5, max_depth=3, seed=1),
           "glm": lambda: h2o.GLMEstimator(
               family={"bin": "binomial", "mul": "multinomial",
                       "reg": "gaussian"}[kind]),
           "dl": lambda: h2o.DeepLearningEstimator(hidden=[6], epochs=1,
                                                   seed=1)}[algo]()
    return est.train(fr, y="y", x=x), fr


def rows_of(model, cols, lo=0, hi=None):
    """JSON-shaped rows reproducing ``cols[lo:hi]`` (None at NA) in the
    model's serving schema."""
    hi = len(cols["x1"]) if hi is None else hi
    rows = []
    for i in range(lo, hi):
        r = {}
        for nm, dom in serving_schema(model):
            v = cols[nm][i]
            if v is None or (isinstance(v, float) and np.isnan(v)):
                r[nm] = None
            else:
                r[nm] = v if dom is not None else float(v)
        rows.append(r)
    return rows


def assert_bit_identical(base, out, what):
    assert sorted(base.names) == sorted(out), what
    for n in base.names:
        np.testing.assert_array_equal(
            np.asarray(out[n], np.float64), base.col(n).to_numpy(),
            err_msg=f"{what}/{n}")


@pytest.fixture
def engine():
    eng = ScoringEngine()
    yield eng
    eng.drain()


@pytest.fixture(scope="module")
def fitted():
    return {}


def _case(fitted, algo, kind):
    if (algo, kind) not in fitted:
        fitted[algo, kind] = _train(algo, kind)
    return fitted[algo, kind]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("algo", ALGOS)
def test_served_rows_bit_identical_to_predict(fitted, engine, algo, kind):
    m, fr = _case(fitted, algo, kind)
    cols = serving_cols(kind)
    cols["c1"][::31] = "never-seen"             # an unseen level: NA
    base = m.predict(_frame(cols))
    assert base.names[0] == "predict"
    out, domains, meta = engine.score_rows(m, rows_of(m, cols),
                                           device="cpu")
    assert meta["batch_rows"] == N_ROWS
    assert domains == m.predict_domains()
    assert_bit_identical(base, out, f"{algo}-{kind}")
    # the same rows in small requests land in other buckets and spots
    for lo in (0, 9, 77, 200):
        part, _, _ = engine.score_rows(m, rows_of(m, cols, lo, lo + 3))
        for n in base.names:
            np.testing.assert_array_equal(
                np.asarray(part[n], np.float64),
                base.col(n).to_numpy()[lo:lo + 3], err_msg=n)


def test_calibrated_probabilities_bit_identical(engine):
    m, _ = _train("gbm", "bin")
    m.calibrator = Calibrator("plattscaling", (1.3, -0.2))
    cols = serving_cols("bin")
    base = m.predict(_frame(cols))
    assert "cal_p1" in base.names
    out, _, _ = engine.score_rows(m, rows_of(m, cols), device="cpu")
    assert_bit_identical(base, out, "gbm-cal")


def test_unseen_level_scores_as_na(fitted, engine):
    m, _ = _case(fitted, "gbm", "bin")
    row = rows_of(m, serving_cols("bin"), 0, 1)[0]
    out_na, _, _ = engine.score_rows(m, [dict(row, c1=None)], device="cpu")
    out_un, _, _ = engine.score_rows(m, [dict(row, c1="zzz")])
    for k in out_na:
        np.testing.assert_array_equal(out_na[k], out_un[k])


@pytest.mark.parametrize("algo", ["gbm", "drf"])
def test_carried_forests_serve_as_the_reference_engine(engine, algo):
    from h2o3_tpu.serving.engine import engine as ref_engine
    from h2o3_tpu_torch.frame.frame import raw_columns
    m_r, m_p = carried(algo)
    c = {k: v for k, v in cols(n=24, seed=9).items()
         if k in ("x0", "x1", "x2", "g")}
    c["g"][:3] = "zzz"
    raw = raw_columns(port_frame(c), list(c))
    rows = [{k: (None if raw[k][i] is None or (isinstance(raw[k][i], float)
                                              and np.isnan(raw[k][i]))
                 else raw[k][i]) for k in c} for i in range(24)]
    try:
        want, want_dom, _ = ref_engine.score_rows(m_r, rows)
    finally:
        ref_engine.reset()
    got, got_dom, _ = engine.score_rows(m_p, rows, device="cpu")
    assert got_dom == want_dom
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_one_warm_up_per_bucket_under_a_storm(fitted, engine):
    m, _ = _train("gbm", "bin")                   # a fresh model
    cols = serving_cols("bin")
    rows = rows_of(m, cols, 0, 3)
    expect = m.predict(_frame(cols))
    errors = []
    start = threading.Barrier(16)

    def client():
        start.wait()
        for _ in range(4):
            try:
                out, _, _ = engine.score_rows(m, rows, device="cpu")
            except BaseException as e:   # noqa: BLE001 - asserted after
                errors.append(e)
                return
            for k in expect.names:
                if not np.array_equal(np.asarray(out[k], np.float64),
                                      expect.col(k).to_numpy()[:3]):
                    errors.append(AssertionError(f"{k} drifted"))
    threads = [threading.Thread(target=client) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0]
    st = engine.stats()["models"][m.key]
    assert st["warmups"] == {b: 1 for b in buckets_for(4096)}
    assert st["dispatches"] <= 64 and st["rows"] == 16 * 4 * 3
    assert sum(st["buckets"].values()) == st["dispatches"]


def test_queue_saturation_raises_not_blocks():
    started = threading.Event()

    def stuck(batch):
        started.set()
        time.sleep(2.0)
        for p in batch:
            p.finish(result=None)

    mb = MicroBatcher("sat-test", stuck, max_rows=4, wait_ms=0.0,
                      queue_depth=2)
    try:
        cols = {"x1": np.zeros(1)}
        mb.submit(PendingScore(cols, 1))
        assert started.wait(2.0)            # the dispatcher is stuck
        mb.submit(PendingScore(cols, 1))
        mb.submit(PendingScore(cols, 1))
        t0 = time.monotonic()
        with pytest.raises(QueueSaturated):
            mb.submit(PendingScore(cols, 1))
        assert time.monotonic() - t0 < 0.5
    finally:
        mb.close(join=False)


def test_expired_deadline_fails_in_the_queue():
    dispatched = []
    mb = MicroBatcher("dl-test", lambda b: dispatched.append(b),
                      max_rows=4, wait_ms=0.0, queue_depth=4)
    try:
        p = PendingScore({"x1": np.zeros(1)}, 1,
                         deadline=time.monotonic() - 1.0)
        mb.submit(p)
        assert p.wait(5.0)
        assert isinstance(p.error, request_ctx.DeadlineExceeded)
        assert not dispatched
    finally:
        mb.close()


def test_score_rows_honors_the_request_deadline(fitted, engine):
    m, _ = _case(fitted, "gbm", "reg")
    rows = rows_of(m, serving_cols("reg"), 0, 2)
    engine.register(m, device="cpu")
    with request_ctx.deadline_scope(time.monotonic() - 0.5):
        with pytest.raises(request_ctx.DeadlineExceeded):
            engine.score_rows(m, rows)


def test_drain_fails_queued_requests():
    release = threading.Event()

    def slow(batch):
        release.wait(2.0)
        for p in batch:
            p.finish(result=None)

    mb = MicroBatcher("drain-test", slow, max_rows=1, wait_ms=0.0,
                      queue_depth=4)
    first, queued = PendingScore({}, 1), PendingScore({}, 1)
    mb.submit(first)
    time.sleep(0.05)
    mb.submit(queued)
    release.set()
    mb.close()
    assert first.wait(2.0) and queued.wait(2.0)
    assert queued.error is None or isinstance(
        queued.error, batcher_mod.BatcherDraining)
    with pytest.raises(batcher_mod.BatcherDraining):
        mb.submit(PendingScore({}, 1))


def test_eviction_then_re_registration(fitted, engine):
    m, _ = _case(fitted, "drf", "mul")
    cols = serving_cols("mul")
    rows = rows_of(m, cols, 0, 5)
    first, _, _ = engine.score_rows(m, rows, device="cpu")
    assert engine.warm_models() == [m.key]
    assert engine.evict() == 1
    assert engine.warm_models() == []
    again, _, _ = engine.score_rows(m, rows)
    assert engine.warm_models() == [m.key]
    st = engine.stats()["models"][m.key]
    assert st["warmups"] == {b: 1 for b in buckets_for(4096)}
    for k in first:
        np.testing.assert_array_equal(first[k], again[k])


def test_offset_and_autoencoder_models_take_the_eager_path(engine):
    cols = serving_cols("reg")
    cols["off"] = np.linspace(-1, 1, N_ROWS)
    fr = _frame(cols)
    m = h2o.GLMEstimator(offset_column="off").train(
        fr, y="y", x=["x1", "x2", "c1"])
    sc = engine.register(m, device="cpu")
    assert sc.fallback_reason == "offset_column"
    assert ("off", None) in sc.schema
    rows = rows_of(m, cols, 0, 12)
    for i, r in enumerate(rows):
        r["off"] = float(cols["off"][i])
    out, _, _ = engine.score_rows(m, rows)
    np.testing.assert_allclose(out["predict"],
                               m.predict(fr).col("predict").to_numpy()[:12],
                               rtol=0, atol=1e-6)


def test_serving_unsupported_and_parse_errors(engine):
    fr = _frame(serving_cols("reg"))
    km = h2o.KMeansEstimator(k=2, seed=1).train(fr, x=["x1", "x2"])
    with pytest.raises(ServingUnsupported, match="kmeans"):
        engine.register(km, device="cpu")
    schema = [("x1", None), ("c1", ["a", "b"])]
    with pytest.raises(ValueError, match="non-empty JSON array"):
        parse_rows(schema, [])
    with pytest.raises(ValueError, match="not a JSON object"):
        parse_rows(schema, [{"x1": 1.0}, [1, 2]])
    with pytest.raises(ValueError, match="expects a number"):
        parse_rows(schema, [{"x1": "abc"}])
    got = parse_rows(schema, [{"x1": "2.5", "c1": "b"}, {"c1": "zz"}, {}])
    np.testing.assert_array_equal(got["x1"], [2.5, np.nan, np.nan])
    np.testing.assert_array_equal(got["c1"], [1, -1, -1])


def test_request_context_deadlines_and_job_cancellation():
    from h2o3_tpu_torch.core.job import Job, JobCancelledException
    assert request_ctx.current_deadline() is None
    assert request_ctx.remaining_s() is None
    request_ctx.cancel_point("idle")                # nothing to observe
    with request_ctx.deadline_scope(time.monotonic() + 60):
        assert 0 < request_ctx.remaining_s() <= 60
        with request_ctx.deadline_scope(None):      # cleared inside
            request_ctx.check_deadline("inner")
        with request_ctx.deadline_scope(time.monotonic() - 1):
            with pytest.raises(request_ctx.DeadlineExceeded, match="at x"):
                request_ctx.cancel_point("x")
    job = Job("ctx test")
    with request_ctx.job_scope(job, deadline=None):
        assert request_ctx.current_job() is job
        job.cancel()
        with pytest.raises(JobCancelledException):
            request_ctx.cancel_point("chunk")
    assert request_ctx.current_job() is None
    h2o.DKV.remove(job.key)
