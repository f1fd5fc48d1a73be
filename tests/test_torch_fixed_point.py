"""64-bit fixed-point sums (``ops/fixed_point.py``) on the CPU, against
exact sums: the sums the card's fits take (the slab histograms' cells,
the leaf sums, the metrics' histograms) must give the same bits in any
order of their adds.

Held here: the exponent choice (a power of two, no overflow at the row
count, the same on every rank of a mesh), quantise and dequantise (exact
on dyadic and small-integer values, within the stated bound on real
values, closer to the exact sum than a float32 running sum), non-finite
values (NaN and infinities as the plain float sum gives them) and the
permutation invariance of ``index_sum``. The card's kernels are held to
the same on the card in ``tests/test_torch_cuda.py``."""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.ops import fixed_point as fp
from h2o3_tpu_torch.ops.segments import segment_sum

import torch_ranks as tr

ROWS = [1, 2, 3, 1000, 65_537, 1_000_001, 2 ** 21]
MAXIMA = [0.0, 1e-30, 0.37, 1.0, 4.0, 1e6, 3e38]


def _exact_sums(ids, vals, n):
    """Exact per-segment sums of float values (math.fsum), as floats;
    NaN/inf as a float sum gives them."""
    out = np.zeros((n, vals.shape[1]))
    for s in range(n):
        rows = vals[ids == s].astype(np.float64)
        for k in range(vals.shape[1]):
            col = rows[:, k]
            out[s, k] = col.sum() if not np.isfinite(col).all() \
                else math.fsum(col)
    return out


def _same(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.equal(a, b) or bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", ROWS)
def test_exponent_is_a_power_of_two_and_never_overflows(n, dtype):
    two = torch.tensor([[m, -m / 2] for m in MAXIMA], dtype=dtype).T
    # n rows, the two in turns: K = len(MAXIMA) columns
    vals = two[torch.arange(n) % 2]
    e = fp.exponents(vals)
    assert e.dtype == torch.int32
    nbits = (n - 1).bit_length()                  # ceil(log2 n)
    assert 2 ** nbits >= n > 2 ** (nbits - 1)
    for k, m in enumerate(MAXIMA):
        ek = int(e[k])
        assert float(fp.pow2(e[k:k + 1], dtype)[0]) == 2.0 ** ek
        assert float(fp.pow2(-e[k:k + 1], torch.float64)[0]) == 2.0 ** -ek
        amax = Fraction(float(torch.tensor(m, dtype=dtype)))
        # the largest rounded value n times over stays below 2^62
        q = round(amax * Fraction(2) ** ek)
        assert n * q < 2 ** fp.FIXED_BITS
        _, x = math.frexp(float(amax))
        if -126 < fp.FIXED_BITS - nbits - x < 126:
            # tight: the bound 2^(ceil log2 n + x + e) is exactly 2^62
            assert nbits + x + ek == fp.FIXED_BITS
    # quantise agrees with the exact rounding of v·2^e
    q = fp.quantize(two, e)
    for k, m in enumerate(MAXIMA):
        for i in range(2):
            v = Fraction(float(two[i, k]))
            assert int(q[i, k]) == round(v * Fraction(2) ** int(e[k]))


@pytest.mark.parametrize("n", [1, 7, 64, 400, 4096, 5000])
def test_index_sum_over_any_number_of_cells(n):
    # SPREAD // n copies of the cells (64 at 64 cells, one at 5000), with
    # every kind of non-finite value in some cells: the exact sums
    r = np.random.RandomState(6)
    rows = 30_000
    v = np.stack([r.randint(-9, 10, rows) / 4.0, r.randn(rows),
                  r.uniform(0.1, 0.2, rows)], 1).astype(np.float32)
    ids = r.randint(0, n, rows)
    for j, x in enumerate([np.nan, np.inf, -np.inf, np.inf, -np.inf]):
        v[j * 997, j % 3] = x
    got = fp.index_sum(torch.from_numpy(ids), torch.from_numpy(v), n)
    want = _exact_sums(ids, v, n)
    assert _same(got[:, 0], torch.from_numpy(want[:, 0]).float())
    fin = np.isfinite(want)
    assert _same(torch.isfinite(got), torch.from_numpy(fin))
    assert _same(got[~torch.from_numpy(fin)],
                 torch.from_numpy(want[~fin]).float())
    assert np.allclose(got.numpy()[fin], want[fin], rtol=1e-6, atol=1e-6)


def test_index_sum_refuses_2_to_the_31_rows():
    # the non-finite counts take 32 bits a kind; a view, never filled
    n = 2 ** 31
    with pytest.raises(ValueError, match="2\\^31"):
        fp.index_sum(torch.zeros(1, dtype=torch.int64).expand(n),
                     torch.zeros((1, 3)).expand(n, 3), 4)


@pytest.mark.parametrize("kind", ["small_int", "dyadic"])
def test_quantize_exact_on_dyadic_and_small_integer_values(kind):
    r = np.random.RandomState(1)
    n = 50_000
    if kind == "small_int":
        v = r.randint(-4, 5, (n, 3)).astype(np.float32)
    else:
        v = (r.randint(-512, 513, (n, 3)) / 8.0).astype(np.float32)
    ids = r.randint(0, 64, n)
    got = fp.index_sum(torch.from_numpy(ids), torch.from_numpy(v), 64)
    want = _exact_sums(ids, v, 64)
    # every value and every sum is a float32 exactly
    assert np.array_equal(got.numpy(), want.astype(np.float32))
    e = fp.exponents(torch.from_numpy(v))
    back = fp.dequantize(fp.quantize(torch.from_numpy(v), e), e,
                         torch.float32)
    assert torch.equal(back, torch.from_numpy(v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_real_values_within_the_bound(dtype):
    r = np.random.RandomState(2)
    n, S = 40_000, 16
    v = np.stack([r.randn(n) * 3, r.uniform(0.05, 0.25, n),
                  r.standard_cauchy(n)], 1)
    v = v.astype(np.float32).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    ids = r.randint(0, S, n)
    vals = torch.from_numpy(v)
    e = fp.exponents(vals)
    got = fp.index_sum(torch.from_numpy(ids), vals, S, e=e).numpy()
    want = _exact_sums(ids, v, S)
    cnt = np.bincount(ids, minlength=S)[:, None]
    mass = np.zeros((S, 3))
    np.add.at(mass, ids, np.abs(v))
    u = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -53
    # rounding each row by at most 2^-(e+1), then the sum once to the type
    bound = cnt * 2.0 ** -(e.numpy()[None, :] + 1.0) + u * np.abs(want) \
        + 2.0 ** -1000
    diff = np.abs(got - want)
    assert (diff <= bound).all()
    if dtype == torch.float32:
        # closer to the exact sum than the float32 summation bound
        assert (diff <= cnt * u * mass).all()


def test_nonfinite_values_poison_only_their_own_cell():
    r = np.random.RandomState(3)
    n = 3_000
    v = (r.randint(-8, 9, (n, 3)) / 4.0).astype(np.float32)
    ids = r.randint(0, 5, n)
    first = [np.flatnonzero(ids == s)[:2] for s in range(5)]
    v[first[0][0], 0] = np.nan                 # NaN
    v[first[1][0], 1] = np.inf                 # +inf
    v[first[2][0], 2] = -np.inf                # -inf
    v[first[3][0], 0], v[first[3][1], 0] = np.inf, -np.inf   # NaN
    v[first[4][0], 1], v[first[4][1], 1] = np.inf, np.inf    # +inf
    got = fp.index_sum(torch.from_numpy(ids), torch.from_numpy(v), 5)
    want = _exact_sums(ids, v, 5).astype(np.float32)
    assert _same(got, torch.from_numpy(want))
    assert int((~torch.isfinite(got)).sum()) == 5
    # the exponents ignore the non-finite values
    clean = np.where(np.isfinite(v), v, 0)
    assert torch.equal(fp.exponents(torch.from_numpy(v)),
                       fp.exponents(torch.from_numpy(clean)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_index_sum_is_the_same_in_any_row_order(dtype):
    r = np.random.RandomState(4)
    n = 20_000
    v = torch.from_numpy(r.randn(n, 3) * r.lognormal(0, 3, (n, 1))).to(dtype)
    v[17, 2] = float("nan")
    ids = torch.from_numpy(r.randint(0, 37, n))
    base = fp.index_sum(ids, v, 37)
    for seed in range(4):
        p = torch.from_numpy(np.random.RandomState(seed).permutation(n))
        assert _same(fp.index_sum(ids[p], v[p], 37), base)
    # a plain float running sum is not: reversed order changes some bits
    fwd = torch.zeros((37, 3), dtype=dtype).index_add_(0, ids, v)
    rev = torch.zeros((37, 3), dtype=dtype).index_add_(
        0, ids.flip(0), v.flip(0))
    assert not _same(fwd, rev)


def test_segment_sum_on_the_cpu_stays_float32_index_add():
    r = np.random.RandomState(5)
    v = torch.from_numpy(r.randn(5_000, 3).astype(np.float32))
    ids = torch.from_numpy(r.randint(0, 9, 5_000).astype(np.int32))
    want = torch.zeros((9, 3)).index_add_(0, ids.long(), v)
    assert torch.equal(segment_sum(ids, v, n_nodes=9), want)


def test_exponents_and_sums_the_same_on_every_rank(tmp_path):
    ranks = tr.run_ranks("fixed", tmp_path)
    v, ids = tr.fixed_cols()
    vals = torch.from_numpy(v)
    world = len(ranks)
    n_max = max(res["rows"] for res in ranks)
    assert len({res["rows"] for res in ranks}) > 1     # uneven shards
    # the exponents of n_max × world rows (zero rows add no maximum)
    want = fp.exponents(torch.cat([vals, torch.zeros(
        (n_max * world - len(v), 3))]))
    sums = fp.index_sum(torch.from_numpy(ids), vals, 6, e=want)
    for res in ranks:
        assert np.array_equal(res["exps"], want.numpy())
        # the ranks' int64 sums add up exactly to the one-process sum
        assert _same(torch.from_numpy(res["sums"]), sums)
