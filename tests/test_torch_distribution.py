"""The port's GBM distribution families against the reference's
(``h2o3_tpu/models/distribution.py``), on the CPU.

Each family's ``grad``, ``hess``, ``link_inv`` and ``deviance`` get the
same seeded numpy (y, f) in both packages and must agree within rtol
1e-6 (both compute in float32; the two libraries' ``exp``, ``log`` and
``pow`` may differ in the last bits). ``init_margin`` must be bit-equal:
the log-link priors reproduce the reference's float32 ``jnp.log``. The
shape parameters are held off their defaults too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.models import distribution as ref_dist
from h2o3_tpu_torch.core.udf import upload_custom_distribution
from h2o3_tpu_torch.models import distribution as dist
from torch_threads import one_torch_thread  # noqa: F401 - autouse

# (family, shape parameters): every family, and each shape parameter at
# its default and off it
CASES = [
    ("gaussian", {}), ("bernoulli", {}), ("poisson", {}), ("gamma", {}),
    ("tweedie", {}), ("tweedie", {"tweedie_power": 1.2}),
    ("tweedie", {"tweedie_power": 1.8}), ("laplace", {}),
    ("quantile", {}), ("quantile", {"quantile_alpha": 0.9}),
    ("quantile", {"quantile_alpha": 0.25}), ("huber", {}),
    ("huber", {"huber_alpha": 0.3}),
]
IDS = [f"{n}-{'-'.join(f'{v}' for v in kw.values()) or 'default'}"
       for n, kw in CASES]


def _inputs(name, n=4000, seed=0):
    """(y, f) float32 in the family's domain: y in {0, 1} for bernoulli,
    counts for poisson, positive for gamma, zero-inflated positive for
    tweedie, real otherwise; f a margin of moderate size."""
    r = np.random.RandomState(seed)
    f = r.uniform(-2.5, 2.5, n)
    if name == "bernoulli":
        y = (r.rand(n) < 0.4).astype(float)
    elif name == "poisson":
        y = r.poisson(np.exp(0.5 * f))
    elif name == "gamma":
        y = r.gamma(2.0, np.exp(0.5 * f) / 2.0)
    elif name == "tweedie":
        y = (r.rand(n) < 0.6) * r.gamma(2.0, np.exp(0.5 * f) / 2.0)
    else:
        y = f + r.standard_t(3, n)
    return y.astype(np.float32), f.astype(np.float32)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_family_functions_match_reference(name, kw):
    ref = ref_dist.get_distribution(name, **kw)
    port = dist.get_distribution(name, **kw)
    y, f = _inputs(name)
    yt, ft = torch.from_numpy(y), torch.from_numpy(f)
    for fn in ("grad", "hess", "deviance"):
        want = np.asarray(getattr(ref, fn)(jnp.asarray(y), jnp.asarray(f)))
        got = getattr(port, fn)(yt, ft)
        assert got.dtype == torch.float32, fn
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * max(1.0, np.abs(want).max()),
                                   err_msg=fn)
    np.testing.assert_allclose(port.link_inv(ft).numpy(),
                               np.asarray(ref.link_inv(jnp.asarray(f))),
                               rtol=1e-6, atol=1e-7)
    assert port.name == ref.name


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_init_margin_bit_equal(name, kw):
    """The prior f0 of a host mean, bit for bit: float32 log for the log
    links, float32 log-odds for bernoulli, the mean itself otherwise."""
    ref = ref_dist.get_distribution(name, **kw)
    port = dist.get_distribution(name, **kw)
    r = np.random.RandomState(3)
    means = np.concatenate([r.rand(200), r.uniform(0, 50, 200),
                            10.0 ** r.uniform(-9, 4, 200),
                            [0.0, 1e-7, 0.5, 1.0, 1.0 - 1e-9, 2.0, 1e6]])
    if name == "bernoulli":
        means = np.clip(means, 0.0, 1.0)
    got = [port.init_margin(float(m)) for m in means]
    want = [ref.init_margin(float(m)) for m in means]
    assert got == want


@pytest.mark.parametrize("lo,hi", [(-9, -3), (-3, 0), (0, 3), (3, 9)])
def test_log_f32_is_the_reference_log(lo, hi):
    """The host float32 log behind the priors equals the reference's
    ``float(jnp.log(m))`` on every sampled mean of a decade range."""
    r = np.random.RandomState(lo + 20)
    for m in 10.0 ** r.uniform(lo, hi, 2000):
        assert dist._log_f32(m) == float(jnp.log(m)), m


def test_distribution_cache_and_surface():
    """One instance per (name, shape parameter), as the reference caches
    them; estimator parameters pass through; custom takes its uploaded
    function (one instance per uploaded object) and raises without one;
    the algorithm-level names raise."""
    a = dist.get_distribution("tweedie", tweedie_power=1.3, ntrees=5)
    assert a is dist.get_distribution("Tweedie", tweedie_power=1.3)
    assert a is not dist.get_distribution("tweedie")
    assert dist.get_distribution("gamma") is dist.get_distribution("gamma")
    assert dist.get_distribution("quantile", quantile_alpha=0.5) is \
        dist.get_distribution("quantile")
    with pytest.raises(ValueError, match="custom_distribution_func"):
        dist.get_distribution("custom")

    class Twin:
        def gradient(self, y, f):
            return f - y

    ref = upload_custom_distribution(Twin)
    c = dist.get_distribution("custom", custom_distribution_func=ref)
    assert c is dist.get_distribution("custom", custom_distribution_func=ref)
    y, f = torch.tensor([1.0, -2.0]), torch.tensor([0.5, 0.5])
    assert torch.equal(c.grad(y, f), f - y)
    assert torch.equal(c.hess(y, f), torch.ones(2))
    assert c.init_margin(0.25) == 0.25 and torch.equal(c.link_inv(f), f)
    for name in ("auto", "multinomial"):
        with pytest.raises(ValueError, match="algorithm level"):
            dist.get_distribution(name)
    with pytest.raises(ValueError, match="unknown distribution"):
        dist.get_distribution("no_such_family")
