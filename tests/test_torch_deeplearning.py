"""DeepLearning in the PyTorch port (on the CPU) against the reference
package.

The port draws its own random numbers, so the tests feed it the
reference's: the initial weights of ``_init_params`` (the port's
``init_params`` is replaced by one that returns them) and the dropout
masks of ``jax.random.bernoulli`` (handed to ``forward``). Without
dropout a whole fit then runs the same steps on the same batches.

What must be EXACT: the batch size and the bf16 switch of every row
count, each step's rate and momentum (captured inside the reference's
compiled step), and the rows the training metrics score. Float32 sums
run in another order in the two packages (XLA's dot against the CPU
BLAS), so the rest is held within tolerances set from a witness: the
same fit in the port in float64 (``test_float32_order_witness``) moves
the weights and probabilities by the same order as the reference does.
Every frame has 4,096 rows: the reference does not pad that count (its
batches near the end of an epoch would take its padding rows, ROADMAP
C), and the CPU's float32 sums do not depend on the thread count below
32,768 elements. torch runs on one thread here.

The reference runs on a one-device mesh (``_one_device``), as its fits
do in ``tests/test_torch_extisofor.py``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import deeplearning as ref_dl
from h2o3_tpu.models.deeplearning import \
    DeepLearningEstimator as RefDeepLearning
from h2o3_tpu_torch.models import deeplearning as dl
from h2o3_tpu_torch.models.convert import deeplearning_model_from_arrays
from h2o3_tpu_torch.models.deeplearning import DeepLearningEstimator
from h2o3_tpu_torch.parallel.mesh import LOCAL, padded_rows

from tests.test_torch_isofor import _one_device

N = 4096
NUM = ["x0", "x1", "x2", "x3", "x4"]
X_COLS = NUM + ["c0"]
# Tolerances, from the witness: the binomial fit in the port in float64
# is 3.5e-7 from its float32 fit (test_float32_order_witness), and every
# whole fit here lands within 1.8e-7 of the reference's (weights relative
# to max(1, max|W|)); one step within 1.5e-8.
WEIGHT_TOL = 2e-6        # a fit's weights: ~6x the witness
PROB_TOL = 1e-5          # a fit's probabilities and predictions
METRIC_TOL = 1e-5        # its metrics and scoring history, relative
STEP_TOL = 2e-7          # one step's weights: a few float32 ulps at |W| < 1
FWD_TOL = 1e-5           # forward outputs and losses, relative


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dl_cols(n=N, seed=0):
    """Five numerics (NAs in x2, x3 on a wide scale), a categorical with
    NAs, and binomial, 4-class and real responses of them."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 5)
    X[:, 3] = 50.0 + 20.0 * X[:, 3]
    c0 = r.choice(["red", "green", "blue"], n).astype(object)
    eta = (X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] * X[:, 4]
           + 0.02 * (X[:, 3] - 50) + 0.7 * (c0 == "green"))
    X[r.rand(n) < 0.05, 2] = np.nan
    c0[r.rand(n) < 0.03] = None
    cols = {f"x{i}": X[:, i] for i in range(5)}
    cols["c0"] = c0
    cols["yb"] = np.array(["no", "yes"], object)[
        (r.rand(n) < 1 / (1 + np.exp(-eta))).astype(int)]
    cols["ym"] = np.array(["a", "b", "c", "d"], object)[
        np.clip(np.floor(eta + 2 + 0.5 * r.randn(n)), 0, 3).astype(int)]
    cols["yr"] = 3.0 + 2.0 * np.tanh(eta) + 0.2 * r.randn(n)
    return cols


def frames(cols):
    """(reference frame on one device, port frame on the CPU)."""
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols)
    return fr_r, h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu")


def ref_init(seed, sizes, maxout):
    """The reference's initial weights of a fit with ``seed``."""
    key = jax.random.PRNGKey(seed if seed >= 0 else 0xD1)
    _, kinit = jax.random.split(key)
    return ref_dl._init_params(kinit, list(sizes), maxout)


def to_port(net, dtype=torch.float32):
    return [{k: torch.from_numpy(np.array(l[k])).to(dtype) for k in ("W", "b")}
            for l in net]


def to_np(net):
    return [{k: np.array(l[k].detach().cpu() if isinstance(l[k], torch.Tensor)
                         else l[k], np.float64) for k in ("W", "b")}
            for l in net]


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's fits start from the reference's initial weights."""
    def draw(gen, sizes, maxout, device):
        seed = draw.seed
        return [{k: v.to(device) for k, v in l.items()}
                for l in to_port(ref_init(seed, sizes, maxout))]
    draw.seed = 1
    monkeypatch.setattr(dl, "init_params", draw)
    return draw


def weight_gap(a, b) -> float:
    """Largest |a - b| over every W and b, relative to max(1, max|W|)."""
    a, b = to_np(a), to_np(b)
    scale = max(1.0, max(np.abs(l["W"]).max() for l in b))
    return max(np.abs(x[k] - y[k]).max() for x, y in zip(a, b)
               for k in ("W", "b")) / scale


def both_fit(cols, y, seed=1, x=X_COLS, **params):
    """The reference's fit and the port's, from the reference's draws,
    on the same columns."""
    fr_r, fr_p = frames(cols)
    with _one_device():
        m_r = RefDeepLearning(seed=seed, **params).train(fr_r, y=y, x=x)
    m_p = DeepLearningEstimator(seed=seed, **params).train(fr_p, y=y, x=x)
    return m_r, m_p, fr_r, fr_p


def design(cols, x=X_COLS):
    fr_r, fr_p = frames(cols)
    from h2o3_tpu.frame.datainfo import build_datainfo as ref_bdi
    from h2o3_tpu_torch.frame.datainfo import build_datainfo
    with _one_device():
        X_r = np.array(ref_bdi(fr_r, x).X)
    X_p = build_datainfo(fr_p, x).X
    np.testing.assert_allclose(X_p.numpy(), X_r, rtol=1e-6, atol=1e-6)
    return X_r, fr_r, fr_p


def ref_masks(key, shape_rows, widths, in_drop, hd):
    """The reference forward's keep masks for ``key``, in its order."""
    masks = []
    if in_drop > 0:
        key, sub = jax.random.split(key)
        masks.append(jax.random.bernoulli(sub, 1 - in_drop,
                                          (shape_rows, widths[0])))
    else:
        masks.append(None)
    for i, r in enumerate(hd):
        if r > 0:
            key, sub = jax.random.split(key)
            masks.append(jax.random.bernoulli(sub, 1 - r,
                                              (shape_rows, widths[i + 1])))
        else:
            masks.append(None)
    return [None if m is None else torch.from_numpy(np.array(m)).float()
            for m in masks]


# ---- the network ----------------------------------------------------------
@pytest.mark.parametrize("act", ["rectifier", "tanh", "maxout"])
@pytest.mark.parametrize("dropout", [False, True])
def test_forward_matches_the_reference(act, dropout):
    X_r, _, _ = design(dl_cols())
    sizes = [X_r.shape[1], 16, 8, 3]
    net_r = ref_init(5, sizes, act == "maxout")
    in_drop, hd = (0.2, (0.5, 0.3)) if dropout else (0.0, (0.0, 0.0))
    key = jax.random.PRNGKey(9)
    out_r = np.asarray(ref_dl._forward(net_r, jnp.asarray(X_r), act, key=key,
                                       input_dropout=in_drop,
                                       hidden_dropout=hd, train=True))
    masks = ref_masks(key, X_r.shape[0], [X_r.shape[1], 16, 8], in_drop, hd)
    out_p = dl.forward(to_port(net_r), torch.from_numpy(X_r), act,
                       masks=masks, input_dropout=in_drop,
                       hidden_dropout=hd).numpy()
    scale = np.abs(out_r).max()
    np.testing.assert_allclose(out_p, out_r, rtol=0, atol=FWD_TOL * scale)


def test_parse_activation_and_layer_shapes():
    assert dl.parse_activation("RectifierWithDropout") == \
        ref_dl._parse_activation("RectifierWithDropout") == \
        ("rectifier", True)
    for name in ("Tanh", "Maxout", "maxout_with_dropout", "Rectifier"):
        assert dl.parse_activation(name) == ref_dl._parse_activation(name)
    net_r = ref_init(3, [7, 6, 5, 2], True)
    assert dl.layer_shapes([7, 6, 5, 2], True) == \
        [tuple(l["W"].shape) for l in net_r]
    # the port's own draws: the same bounds and shapes, zero biases
    net_p = dl.init_params(torch.Generator().manual_seed(3), [7, 6, 5, 2],
                           True, "cpu")
    for lp, lr_, (fin, fout) in zip(net_p, net_r, [(7, 6), (6, 5), (5, 2)]):
        lim = np.sqrt(6.0 / (fin + fout))
        assert lp["W"].shape == lr_["W"].shape
        assert float(lp["W"].abs().max()) <= lim
        assert not lp["b"].any()


@pytest.mark.parametrize("case", ["softmax", "mse", "autoencoder"])
def test_loss_matches_the_reference_with_l1_l2(case):
    cols = dl_cols()
    X_r, fr_r, _ = design(cols)
    r = np.random.RandomState(4)
    w = (r.rand(N) < 0.9).astype(np.float32) * r.uniform(0.5, 2.0, N).astype(
        np.float32)
    if case == "softmax":
        y = r.randint(0, 3, N)
        out_dim, cat, y_p = 3, "softmax", torch.from_numpy(y.astype(np.int64))
    elif case == "mse":
        y = r.randn(N, 1).astype(np.float32)
        out_dim, cat, y_p = 1, "mse", torch.from_numpy(y)
    else:
        y = X_r
        out_dim, cat, y_p = X_r.shape[1], "mse", torch.from_numpy(X_r)
    net_r = ref_init(2, [X_r.shape[1], 16, 8, out_dim], False)
    for l1, l2 in ((0.0, 0.0), (1e-3, 1e-2)):
        v_r = float(ref_dl._loss(net_r, jnp.asarray(X_r), jnp.asarray(y),
                                 jnp.asarray(w), None, act="tanh",
                                 category=cat, input_dropout=0.0,
                                 hidden_dropout=(0.0, 0.0), l1=l1, l2=l2,
                                 nclasses=out_dim))
        v_p = float(dl.loss(to_port(net_r), torch.from_numpy(X_r), y_p,
                            torch.from_numpy(w), "tanh", cat, l1=l1, l2=l2))
        assert v_p == pytest.approx(v_r, rel=FWD_TOL), (l1, l2)


def _one_step_inputs(n=512, out_dim=3, maxout=False):
    X_r, _, _ = design(dl_cols())
    X = X_r[:n]
    y = np.random.RandomState(6).randint(0, out_dim, n)
    w = np.ones(n, np.float32)
    net_r = ref_init(7, [X.shape[1], 16, 8, out_dim], maxout)
    return X, y, w, net_r


def _port_step(net_r, opt_r, X, y, w, cfg, rate, ms):
    net = to_port(net_r)
    for l in net:
        for t in l.values():
            t.requires_grad_(True)
    opt = [{k: {s: (torch.from_numpy(np.array(v)) if np.ndim(v)
                    else np.float32(v)) for s, v in layer[k].items()}
            for k in ("W", "b")} for layer in opt_r]
    sched = dl.Schedule(rate, 1e-3, ms, 0.9, 1e4, X.shape[0])
    dl.train_steps(net, opt, torch.from_numpy(X), torch.from_numpy(
        y.astype(np.int64)), torch.from_numpy(w), None, cfg, sched, 0, 1,
        X.shape[0])
    return net, opt


@pytest.mark.parametrize("mode", ["adadelta", "nesterov", "momentum",
                                  "adadelta_bf16"])
def test_one_step_matches_the_reference(mode):
    X, y, w, net_r = _one_step_inputs(maxout=mode == "nesterov")
    act = "maxout" if mode == "nesterov" else "rectifier"
    adaptive = mode.startswith("adadelta")
    bf16 = mode.endswith("bf16")
    cfg = dl.StepConfig(act, "softmax", 0.0, (0.0, 0.0), 1e-4, 1e-3,
                        adaptive, 0.95, 1e-6, mode == "nesterov",
                        "upcast" if bf16 else None)
    if adaptive:
        opt_r = [{k: {"eg2": jnp.zeros_like(l[k]), "ex2": jnp.zeros_like(
            l[k])} for k in ("W", "b")} for l in net_r]
    else:
        opt_r = [{k: {"v": jnp.zeros_like(l[k]) + 0.01, "mu": jnp.float32(
            0.5)} for k in ("W", "b")} for l in net_r]
    rate, ms = 0.01, 0.5
    new_r, st_r = ref_dl._train_step_impl(
        net_r, opt_r, jnp.float32(rate), jnp.asarray(X), jnp.asarray(y),
        jnp.asarray(w), jax.random.PRNGKey(0), act=act, category="softmax",
        input_dropout=0.0, hidden_dropout=(0.0, 0.0), l1=1e-4, l2=1e-3,
        nclasses=3, adaptive=adaptive, rho=0.95, epsilon=1e-6,
        nesterov=mode == "nesterov", mu_now=jnp.float32(ms), bf16=bf16)
    new_p, st_p = _port_step(net_r, opt_r, X, y, w, cfg, rate, ms)
    moved = weight_gap(new_r, net_r)
    gap = weight_gap(new_p, new_r)
    assert moved > 1e-4
    assert gap <= STEP_TOL, (gap, moved)
    slots = ("eg2", "ex2") if adaptive else ("v",)
    for lp, lr_ in zip(st_p, st_r):
        for k in ("W", "b"):
            for s in slots:
                a, b = lp[k][s].numpy(), np.asarray(lr_[k][s])
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=STEP_TOL * max(np.abs(b).max(), 1e-30)
                    * 10, err_msg=f"{mode} {k} {s}")


def test_bf16_product_gradient_is_the_references():
    """bf16 operands, a float32 result, and JAX's transpose of that
    product: the cotangent times the bf16 operand in float32, rounded to
    bf16."""
    r = np.random.RandomState(2)
    a, b = r.randn(64, 40).astype(np.float32), r.randn(40, 8).astype(
        np.float32)
    g = r.randn(64, 8).astype(np.float32)

    def f(a, b):
        return jnp.sum(jax.lax.dot(a.astype(jnp.bfloat16),
                                   b.astype(jnp.bfloat16),
                                   preferred_element_type=jnp.float32) * g)
    out_r = jax.lax.dot(jnp.asarray(a).astype(jnp.bfloat16),
                        jnp.asarray(b).astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    ga_r, gb_r = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out_p = dl._Bf16Product.apply(at, bt, "upcast")
    ga_p, gb_p = torch.autograd.grad((out_p * torch.from_numpy(g)).sum(),
                                     (at, bt))
    assert dl.bf16_route(torch.device("cpu")) == "upcast"
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_r),
                               rtol=1e-6, atol=1e-5)
    # every gradient element is a bf16 value, as the reference's
    for gp, gr in ((ga_p, ga_r), (gb_p, gb_r)):
        gp = gp.numpy()
        assert (gp == gp.astype(jnp.bfloat16).astype(np.float32)).all()
        # the float32 sums may round to the neighbouring bf16 value
        np.testing.assert_allclose(gp, np.asarray(gr), rtol=2 ** -7,
                                   atol=1e-6)


# ---- the schedules and the chunk loop -------------------------------------
def test_chunk_of_steps_and_schedules_match_the_reference(monkeypatch):
    """20 steps of the reference's compiled chunk against the port's
    loop, across the end of an epoch: each step's rate and momentum (read
    inside the reference's step) bit-equal to the port's host schedule,
    the weights within the float32 order tolerance."""
    seen = []
    orig = ref_dl._train_step_impl

    def spy(*a, **kw):
        jax.debug.callback(lambda lr, mu: seen.append((np.asarray(lr),
                                                        np.asarray(mu))),
                           a[2], kw["mu_now"], ordered=True)
        return orig(*a, **kw)
    monkeypatch.setattr(ref_dl, "_train_step_impl", spy)
    X_r, _, _ = design(dl_cols())
    y = np.random.RandomState(8).randint(0, 3, N)
    w = np.ones(N, np.float32)
    net_r = ref_init(11, [X_r.shape[1], 16, 8, 3], False)
    opt_r = [{k: {"v": jnp.zeros_like(l[k]), "mu": jnp.float32(0.2)}
              for k in ("W", "b")} for l in net_r]
    # a distinctive rate compiles a fresh program, so the spy is traced
    sched = dl.Schedule(0.0123457, 3.7e-4, 0.2, 0.95, 150000.0, 240)
    step0, k = 13, 20           # rows 3120.. wrap past 4096 at step 17
    kw = dict(act="tanh", category="softmax", input_dropout=0.0,
              hidden_dropout=(0.0, 0.0), l1=0.0, l2=1e-4, nclasses=3,
              adaptive=False, rho=0.99, epsilon=1e-8, nesterov=True,
              bf16=False)
    with _one_device():
        new_r, _, _ = ref_dl._train_steps_fused(
            net_r, opt_r, jnp.asarray(X_r), jnp.asarray(y), jnp.asarray(w),
            jax.random.PRNGKey(0), jnp.float32(step0),
            jnp.int32((step0 * sched.batch) % N), jnp.float32(k), nsteps=25,
            batch=sched.batch, n=N, rate=sched.rate,
            rate_annealing=sched.rate_annealing,
            momentum_start=sched.momentum_start,
            momentum_stable=sched.momentum_stable,
            momentum_ramp=sched.momentum_ramp, **kw)
        jax.block_until_ready(new_r)
    lr_r = np.array([s[0] for s in seen[:k]], np.float32)
    mu_r = np.array([s[1] for s in seen[:k]], np.float32)
    lr_p, mu_p = sched.lr_mu(step0, k)
    np.testing.assert_array_equal(lr_p, lr_r)
    np.testing.assert_array_equal(mu_p, mu_r)
    assert len(np.unique(mu_p)) > 10          # the ramp is running
    net = to_port(net_r)
    for l in net:
        for t in l.values():
            t.requires_grad_(True)
    opt = dl.init_opt_state(net, False, 0.2)
    cfg = dl.StepConfig("tanh", "softmax", 0.0, (0.0, 0.0), 0.0, 1e-4, False,
                        0.99, 1e-8, True, None)
    dl.train_steps(net, opt, torch.from_numpy(X_r),
                   torch.from_numpy(y.astype(np.int64)), torch.from_numpy(w),
                   None, cfg, sched, step0, k, N)
    assert weight_gap(net, new_r) <= WEIGHT_TOL


def test_fma_f32_rounds_once():
    from fractions import Fraction
    r = np.random.RandomState(3)
    a, b = r.randn(2000).astype(np.float32), r.randn(2000).astype(np.float32)
    c = (r.randn(2000) * 10.0 ** r.randint(-8, 8, 2000)).astype(np.float32)
    want = np.array([np.float32(float(Fraction(float(x)) * Fraction(float(y))
                                      + Fraction(float(z))))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(dl.fma_f32(a, b, c), want)


@pytest.mark.parametrize("n", [100, 1500, 4096, 1_000_000, 1_048_576])
def test_batch_rule_and_bf16_switch_exact(n, monkeypatch):
    """The batch and the bf16 flag the reference's fit passes to its
    compiled chunk, against the port's rule on its own padded rows."""
    got = {}

    def capture(params, opt_state, *a, **kw):
        got.update(batch=kw["batch"], bf16=kw["bf16"])
        return params, opt_state, a[3]
    monkeypatch.setattr(ref_dl, "_train_steps_fused", capture)
    cols = {"x": np.arange(n, dtype=np.float64) % 7,
            "y": (np.arange(n) % 3 == 0).astype(np.float64)}
    with _one_device():
        fr = h2o3_tpu.Frame.from_numpy(cols)
        RefDeepLearning(hidden=[2], epochs=1e-9, stopping_rounds=0,
                        score_training_samples=100).train(fr, y="y")
    batch = dl.batch_size(n, padded_rows(n, LOCAL, 8), 1)
    assert batch == got["batch"]
    assert (batch >= dl.BF16_MIN_BATCH) == got["bf16"]
    assert got["bf16"] == (n >= 1_048_576)
    if n == 1_000_000:
        assert batch == 8192


# ---- whole fits ------------------------------------------------------------
FITS = {
    "binomial": ("yb", dict(hidden=[16, 8], epochs=6)),
    "multinomial": ("ym", dict(hidden=[16, 8], epochs=6,
                               activation="Maxout")),
    "regression": ("yr", dict(hidden=[16, 8], epochs=6, activation="Tanh",
                              adaptive_rate=False, rate=0.01,
                              momentum_start=0.5, momentum_stable=0.9,
                              momentum_ramp=20000, l1=1e-5, l2=1e-4)),
    "autoencoder": (None, dict(hidden=[4], epochs=6, autoencoder=True)),
}


def _pred_columns(fr):
    return {n: fr.col(n).to_numpy() for n in fr.names}


@pytest.mark.parametrize("case", list(FITS))
def test_whole_fit_matches_the_reference(case, reference_draws):
    y, params = FITS[case]
    m_r, m_p, fr_r, fr_p = both_fit(dl_cols(), y, **params)
    assert m_p._steps_trained == m_r._steps_trained
    assert [h["step"] for h in m_p.output["scoring_history"]] == \
        [h["step"] for h in m_r.output["scoring_history"]]
    for hp, hr in zip(m_p.output["scoring_history"],
                      m_r.output["scoring_history"]):
        assert hp["loss"] == pytest.approx(hr["loss"], rel=METRIC_TOL)
    assert weight_gap(m_p.net, m_r.net) <= WEIGHT_TOL
    tm_p, tm_r = m_p.training_metrics.to_dict(), m_r.training_metrics.to_dict()
    assert tm_p["nobs"] == tm_r["nobs"]
    for k in ("MSE", "logloss", "AUC", "r2", "mean_per_class_error"):
        if k in tm_r:
            assert tm_p[k] == pytest.approx(tm_r[k], rel=METRIC_TOL,
                                            abs=METRIC_TOL), k
    with _one_device():
        p_r = _pred_columns(m_r.predict(fr_r))
    p_p = _pred_columns(m_p.predict(fr_p))
    assert set(p_p) == set(p_r)
    for k in p_r:
        if k == "predict" and y is not None and case != "regression":
            # class labels agree except at a probability tie
            assert (p_p[k] != p_r[k]).mean() <= 0.002
            continue
        np.testing.assert_allclose(p_p[k], p_r[k], rtol=PROB_TOL,
                                   atol=PROB_TOL, err_msg=k)


def test_training_sample_rows_exact(reference_draws, monkeypatch):
    """The rows the training metrics score, drawn from the seed: the
    reference's mask (captured) equals the port's."""
    masks = []
    orig = ref_dl.DeepLearningModel.model_performance

    def capture(self, frame, mask_weights=None):
        masks.append(None if mask_weights is None
                     else np.asarray(mask_weights).copy())
        return orig(self, frame, mask_weights=mask_weights)
    monkeypatch.setattr(ref_dl.DeepLearningModel, "model_performance",
                        capture)
    reference_draws.seed = 77
    m_r, m_p, _, _ = both_fit(dl_cols(), "yb", seed=77, hidden=[8],
                              epochs=2, score_training_samples=1000)
    rows = dl.sample_rows(77 & 0xFFFF, N, 1000)
    np.testing.assert_array_equal(np.nonzero(masks[0])[0], rows)
    assert m_p.training_metrics["nobs"] == m_r.training_metrics["nobs"] \
        == len(rows) == 1000
    assert m_p.training_metrics["AUC"] == pytest.approx(
        m_r.training_metrics["AUC"], abs=METRIC_TOL)


def test_validation_frame_and_samples(reference_draws):
    cols, vcols = dl_cols(), dl_cols(seed=5)
    fr_r, fr_p = frames(cols)
    vr, vp = frames(vcols)
    kw = dict(hidden=[8], epochs=2, seed=1, score_validation_samples=700)
    with _one_device():
        m_r = RefDeepLearning(**kw).train(fr_r, y="yb", x=X_COLS,
                                          validation_frame=vr)
    m_p = DeepLearningEstimator(**kw).train(fr_p, y="yb", x=X_COLS,
                                            validation_frame=vp)
    assert m_p.validation_metrics["nobs"] == m_r.validation_metrics["nobs"]
    assert m_p.validation_metrics["AUC"] == pytest.approx(
        m_r.validation_metrics["AUC"], abs=METRIC_TOL)


def test_float32_order_witness(reference_draws):
    """The witness behind WEIGHT_TOL and PROB_TOL: the binomial fit of
    ``test_whole_fit_matches_the_reference`` run by the port in float64
    is as far from the port's float32 fit as the reference is."""
    y, params = FITS["binomial"]
    m_r, m_p, _, fr_p = both_fit(dl_cols(), y, **params)
    from h2o3_tpu_torch.frame.datainfo import build_datainfo
    di = build_datainfo(fr_p, X_COLS)
    X = di.X.double()
    codes = np.nan_to_num(fr_p.col(y).host_view()).astype(np.int64)
    w = torch.ones(N, dtype=torch.float64)
    net = [{k: v.detach().double().requires_grad_(True) for k, v in l.items()}
           for l in to_port(ref_init(1, [di.P, 16, 8, 2], False))]
    opt = dl.init_opt_state(net, True, 0.0)
    batch = dl.batch_size(N, N, 1)
    cfg = dl.StepConfig("rectifier", "softmax", 0.0, (0.0, 0.0), 0.0, 0.0,
                        True, 0.99, 1e-8, True, None)
    dl.train_steps(net, opt, X, torch.from_numpy(codes), w, None, cfg,
                   dl.Schedule(0.005, 1e-6, 0.0, 0.0, 1e6, batch), 0,
                   m_p._steps_trained, N)
    witness = weight_gap(m_p.net, net)
    gap = weight_gap(m_r.net, m_p.net)
    print(f"float32 fit vs float64: {witness:.3g}; reference vs port: "
          f"{gap:.3g}")
    assert gap <= WEIGHT_TOL and witness <= WEIGHT_TOL
    assert gap <= 20 * max(witness, 1e-7)


# ---- continuation and CV ---------------------------------------------------
def _ref_arrays(m):
    return dict(
        net=[{k: np.asarray(l[k]) for k in ("W", "b")} for l in m.net],
        di_stats=m.di_stats, features=m.features, act=m.act,
        standardize=m.standardize, resp_stats=m.resp_stats,
        output=m.output, params=m.params,
        opt_state=jax.tree_util.tree_map(np.asarray, m._opt_state),
        steps_trained=m._steps_trained)


@pytest.mark.parametrize("adaptive", [True, False])
def test_checkpoint_continues_a_reference_donor(adaptive, reference_draws):
    cols = dl_cols()
    fr_r, fr_p = frames(cols)
    kw = dict(hidden=[8, 8], seed=1, adaptive_rate=adaptive, rate=0.01,
              momentum_start=0.3, momentum_stable=0.8, momentum_ramp=5000)
    with _one_device():
        donor = RefDeepLearning(epochs=2, **kw).train(fr_r, y="yb",
                                                      x=X_COLS)
        cont_r = RefDeepLearning(epochs=4, checkpoint=donor, **kw).train(
            fr_r, y="yb", x=X_COLS)
        p_r = cont_r.predict(fr_r).col("p1").to_numpy()
    carried = deeplearning_model_from_arrays(_ref_arrays(donor))
    p_d = carried.predict(fr_p).col("p1").to_numpy()
    with _one_device():
        np.testing.assert_allclose(
            p_d, donor.predict(fr_r).col("p1").to_numpy(), rtol=PROB_TOL,
            atol=PROB_TOL)
    cont_p = DeepLearningEstimator(epochs=4, checkpoint=carried, **kw).train(
        fr_p, y="yb", x=X_COLS)
    assert cont_p._steps_trained == cont_r._steps_trained \
        > carried._steps_trained
    assert weight_gap(cont_p.net, cont_r.net) <= WEIGHT_TOL
    np.testing.assert_allclose(cont_p.predict(fr_p).col("p1").to_numpy(),
                               p_r, rtol=PROB_TOL, atol=PROB_TOL)
    # the donor is not changed by the continuation
    assert weight_gap(carried.net, donor.net) == 0.0


def test_checkpoint_continuation_equals_one_fit_and_checks_its_donor():
    """Port against port: 2 epochs then a continuation to 4 (dropout on:
    the generator state carries over) is the 4-epoch fit bit for bit;
    a changed layout, a fixed field or fewer epochs raise."""
    _, fr = frames(dl_cols())
    kw = dict(hidden=[8, 8], seed=5, activation="RectifierWithDropout",
              input_dropout_ratio=0.1)
    donor = DeepLearningEstimator(epochs=2, **kw).train(fr, y="yb", x=X_COLS)
    cont = DeepLearningEstimator(epochs=4, checkpoint=donor, **kw).train(
        fr, y="yb", x=X_COLS)
    straight = DeepLearningEstimator(epochs=4, **kw).train(fr, y="yb",
                                                           x=X_COLS)
    assert weight_gap(cont.net, straight.net) == 0.0
    for bad, field in ((dict(kw, hidden=[8, 4]), "_hidden"),
                       (dict(kw, activation="TanhWithDropout"),
                        "_activation"),
                       (dict(kw, standardize=False), "_standardize")):
        with pytest.raises(ValueError, match=field):
            DeepLearningEstimator(epochs=4, checkpoint=donor, **bad).train(
                fr, y="yb", x=X_COLS)
    with pytest.raises(ValueError, match="_epochs"):
        DeepLearningEstimator(epochs=2, checkpoint=donor, **kw).train(
            fr, y="yb", x=X_COLS)


@pytest.mark.parametrize("y,kw", [
    ("yb", dict(hidden=[8, 8], activation="RectifierWithDropout",
                input_dropout_ratio=0.1)),
    ("yr", dict(hidden=[8], activation="Maxout", adaptive_rate=False,
                momentum_start=0.5, momentum_stable=0.9,
                momentum_ramp=5000)),
    (None, dict(hidden=[4], autoencoder=True))])
def test_prepare_then_single_steps_is_the_fit(y, kw):
    """``prepare``'s state stepped one step at a time (as chip_smoke's
    card-vs-CPU replay steps it) ends on the estimator's fit bit for
    bit, dropout draws included; ``batch_start`` gives each step's
    rows."""
    _, fr = frames(dl_cols())
    est = DeepLearningEstimator(epochs=3, seed=2, **kw)
    model = est.train(fr, y=y, x=X_COLS)
    t = est.prepare(fr, model.features, y)
    assert (t.done, t.total) == (0, model._steps_trained)
    assert t.cfg.bf16 is None and t.sched.batch == dl.batch_size(N, N, 1)
    for k in range(t.total):
        dl.train_steps(t.net, t.opt, t.X, t.y, t.w, t.gen, t.cfg, t.sched,
                       k, 1, t.n)
    assert weight_gap(t.net, model.net) == 0.0
    starts = [dl.batch_start(k, t.sched.batch, N, N) for k in range(t.total)]
    assert starts[:3] == [0, t.sched.batch, 2 * t.sched.batch]
    assert all(0 <= s <= N - t.sched.batch for s in starts)


def test_three_fold_cv_matches_the_reference(reference_draws):
    kw = dict(hidden=[8], epochs=3, nfolds=3, fold_assignment="modulo")
    m_r, m_p, _, _ = both_fit(dl_cols(), "yb", **kw)
    cv_r, cv_p = (m.cross_validation_metrics for m in (m_r, m_p))
    for k in ("AUC", "logloss", "MSE"):
        assert cv_p[k] == pytest.approx(cv_r[k], rel=METRIC_TOL,
                                        abs=METRIC_TOL), k
    assert len(m_p._cv_models) == 3
    assert weight_gap(m_p.net, m_r.net) <= WEIGHT_TOL


# ---- the surface -----------------------------------------------------------
def test_parameters_unknown_inert_and_unported():
    with pytest.raises(ValueError, match="unknown DeepLearning params"):
        DeepLearningEstimator(hiddne=[3])
    assert DeepLearningEstimator.DEFAULTS == RefDeepLearning.DEFAULTS
    _, fr = frames(dl_cols())
    base = dict(hidden=[4], epochs=1, seed=2)
    a = DeepLearningEstimator(**base).train(fr, y="yb", x=X_COLS)
    # export_weights_and_biases: each layer's weights and biases as
    # frames under DKV keys, the same net as without it
    e = DeepLearningEstimator(export_weights_and_biases=True,
                              **base).train(fr, y="yb", x=X_COLS)
    assert weight_gap(a.net, e.net) == 0.0
    from h2o3_tpu_torch.core.kv import DKV
    for i, layer in enumerate(e.net):
        wf = DKV.get(e.output["weights_keys"][i])
        W = np.stack([wf.col(c).to_numpy() for c in wf.names])
        np.testing.assert_array_equal(W.astype(np.float32),
                                      layer["W"].cpu().numpy())
        b = DKV.get(e.output["biases_keys"][i]).col("C1").to_numpy()
        np.testing.assert_array_equal(b.astype(np.float32),
                                      layer["b"].cpu().numpy())
    b = DeepLearningEstimator(rate_decay=0.5, loss="CrossEntropy",
                              distribution="bernoulli", max_w2=10.0,
                              reproducible=True, score_interval=1.0,
                              train_samples_per_iteration=0,
                              **base).train(fr, y="yb", x=X_COLS)
    assert weight_gap(a.net, b.net) == 0.0


def test_weights_column_and_missing_response(reference_draws):
    cols = dl_cols()
    r = np.random.RandomState(12)
    cols["wt"] = r.uniform(0.2, 3.0, N)
    yb = cols["yb"].copy()
    yb[r.rand(N) < 0.05] = None
    cols["yb"] = yb
    m_r, m_p, _, _ = both_fit(cols, "yb", hidden=[8], epochs=3,
                              weights_column="wt")
    assert weight_gap(m_p.net, m_r.net) <= WEIGHT_TOL
    assert m_p.training_metrics["nobs"] == m_r.training_metrics["nobs"]


def test_partitioned_frame_raises():
    from h2o3_tpu_torch.models.model import require_local
    _, fr = frames(dl_cols(n=64))
    fr.mesh = SimpleNamespace(sharded=True)   # as a rank's frame of a mesh
    # DL trains on a partitioned frame (tests/test_torch_global_fit_glm_dl
    # .py); cross-validation and the autoencoder there are queued, and raise
    with pytest.raises(NotImplementedError, match="partitioned.*A #12′"):
        DeepLearningEstimator(hidden=[2], epochs=1, nfolds=2).train(fr,
                                                                    y="yb")
    with pytest.raises(NotImplementedError, match="partitioned.*A #12′"):
        DeepLearningEstimator(hidden=[2], epochs=1, autoencoder=True).train(
            fr)
    with pytest.raises(NotImplementedError, match="partitioned"):
        require_local(fr, "deeplearning")
