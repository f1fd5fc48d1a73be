"""Order-independent sums on the card: 64-bit fixed point.

On the card a float sum of many rows is made with atomic adds, whose
order changes from run to run, so two fits of the same model differ in
the last bits of their histograms and leaf sums, and a near-tie split
can flip. An integer sum does not depend on the order of its adds. So
every sum of real values that a fit takes on the card goes through 64-bit
fixed point (as XGBoost's GPU ``hist`` does, with its
``GradientPairInt64``):

- column k of a block of values gets a power-of-two scale 2^e_k, chosen
  so that (rows) × max|v_k| × 2^e_k < 2^62 (``exponents``): no sum of the
  rounded values can overflow;
- each value is rounded to the int64 round(v · 2^e_k) (``quantize``;
  exact, as the scale is a power of two), and the int64 values are
  summed in any order;
- the sum converts back once, as float(sum · 2^-e_k) (``dequantize``).

A value is held exactly when v · 2^e_k is an integer: small integers and
dyadic values always are, and so is every float32 value within a factor
2^(38 - ceil log2 rows) of the column's largest. A real value is rounded
by at most 2^-(e_k + 1), 2^-39 of max|v_k| at 5M rows: the fixed-point
sum is closer to the exact sum than a float32 running sum.

Fixed point cannot hold a NaN or an infinity. Non-finite values are
quantised to 0 and counted apart, in the same integer sums: a cell whose
count shows a NaN, or both infinities, is NaN; one with one infinity
only takes it; as the plain float sum would.

The histogram kernels (csrc/hist_slab.cuh) quantise and convert on the
card with the same rounding; ``index_sum`` is the same sum in plain
torch, for the leaf sums and the metrics' histograms.
"""

from __future__ import annotations

from typing import Optional

import torch

from h2o3_tpu_torch.parallel.map_reduce import all_reduce
from h2o3_tpu_torch.parallel.mesh import is_sharded

FIXED_BITS = 62
# cells × copies that index_sum spreads its adds over
SPREAD = 4096
# exponent ranges: 2^e stays a normal number of the values' type
_E_RANGE = {torch.float32: (-126, 126), torch.float64: (-1000, 1000)}


def exponents(vals: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """int32 [K] exponents e_k of the columns of ``vals`` [N, K] (float32
    or float64) such that n × max|finite v_k| × 2^e_k < 2^62, n the most
    rows any rank holds times the mesh's ranks. On a sharded ``mesh`` the
    maxima are taken over every rank (one MAX all-reduce), so every rank
    gets the same exponents. Computed on the values' device: no host
    sync."""
    if vals.dtype not in _E_RANGE:
        raise ValueError(f"fixed point takes float32 or float64, got "
                         f"{vals.dtype}")
    vals = vals.reshape(vals.shape[0], -1)
    f64 = dict(dtype=torch.float64, device=vals.device)
    if vals.shape[0]:
        amax = torch.where(torch.isfinite(vals), vals.abs(), 0).amax(0)
    else:
        amax = torch.zeros(vals.shape[1], **f64)
    # the maxima and the row count, in one collective (float64 holds
    # both exactly)
    red = torch.cat([amax.to(torch.float64),
                     torch.full((1,), vals.shape[0], **f64)])
    red = all_reduce(red, mesh, op="max")
    world = mesh.world_size if is_sharded(mesh) else 1
    n = red[-1:] * world
    _, nbits = torch.frexp((n - 1).clamp_min(0))   # ceil(log2 n)
    _, x = torch.frexp(red[:-1])                   # amax < 2^x (0 for 0)
    lo, hi = _E_RANGE[vals.dtype]
    return (FIXED_BITS - nbits - x).clamp(lo, hi).to(torch.int32)


def exponents_models(vals: torch.Tensor) -> torch.Tensor:
    """int32 [M, K] exponents of M models' value blocks ``vals``
    [M, N, K] at once: row m is ``exponents(vals[m])`` (one device, no
    mesh), the same integers, from one reduction."""
    lo, hi = _E_RANGE[vals.dtype]
    amax = torch.where(torch.isfinite(vals), vals.abs(), 0).amax(1) \
        if vals.shape[1] else vals.new_zeros(vals.shape[0], vals.shape[2])
    n = torch.full((1,), vals.shape[1], dtype=torch.float64,
                   device=vals.device)
    _, nbits = torch.frexp((n - 1).clamp_min(0))
    _, x = torch.frexp(amax.to(torch.float64))
    return (FIXED_BITS - nbits - x).clamp(lo, hi).to(torch.int32)


def pow2(e: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """2^e, exactly, built from its exponent bits (e within the type's
    normal range)."""
    if dtype == torch.float32:
        return ((e.to(torch.int32) + 127) << 23).view(torch.float32)
    if dtype == torch.float64:
        return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)
    raise ValueError(f"pow2: no {dtype}")


def quantize(vals: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """int64 round(v · 2^e) of each value (ties to even), 0 where v is
    not finite; ``e`` broadcasts over the last axis."""
    scaled = torch.where(torch.isfinite(vals), vals, 0) * pow2(e, vals.dtype)
    return torch.round(scaled).to(torch.int64)


def dequantize(acc: torch.Tensor, e: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """float(sum · 2^-e) of int64 sums, through float64."""
    return (acc.to(torch.float64) * pow2(-e, torch.float64)).to(dtype)


def index_sum(idx: torch.Tensor, vals: torch.Tensor, n: int, *,
              e: Optional[torch.Tensor] = None,
              mesh=None) -> torch.Tensor:
    """[n, K] (or [n] for [N] values) sums of the rows of ``vals`` by
    ``idx`` in [0, n), in fixed point: the same bits whatever order the
    adds take. ``e`` defaults to ``exponents(vals, mesh=mesh)``; on a
    sharded ``mesh`` the sums cover every rank's rows.

    One int64 ``index_add_`` takes each row's K rounded values and K
    non-finite counts: +inf adds 1, -inf 2^32 and NaN both, so a cell
    whose two counts are both set is NaN (fewer than 2^31 rows keep the
    counts apart). The adds of a row go to one of ``SPREAD // n`` copies
    of the cells, by row number, and the copies are summed after: many
    rows on few cells would otherwise queue on the same addresses.

    ``e`` of shape [G, K] gives G groups their own exponents: the rows
    are G equal blocks and the cells G equal blocks (M models' leaf sums
    in one call), and group g's sums are those of its block alone."""
    flat = vals.dim() == 1
    v = vals.reshape(vals.shape[0], -1)
    K = v.shape[1]
    world = mesh.world_size if is_sharded(mesh) else 1
    if v.shape[0] * world >= 2 ** 31:
        raise ValueError(f"index_sum: {v.shape[0]} rows a rank over "
                         f"{world} ranks reach 2^31")
    if e is None:
        e = exponents(v, mesh=mesh)
    e_cells = e
    if e.dim() == 2:
        e_cells = e.repeat_interleave(n // e.shape[0], 0)
        e = e.repeat_interleave(v.shape[0] // e.shape[0], 0)
    copies = max(1, SPREAD // max(n, 1))
    row = idx.to(torch.int64)
    if copies > 1:
        row = torch.arange(v.shape[0], device=v.device).remainder_(
            copies).add_(row * copies)
    nan = torch.isnan(v)
    count = ((v == torch.inf) | nan).to(torch.int64) \
        + (((v == -torch.inf) | nan).to(torch.int64) << 32)
    acc = torch.zeros((n * copies, 2 * K), dtype=torch.int64,
                      device=v.device)
    acc.index_add_(0, row, torch.cat([quantize(v, e), count], dim=1))
    acc = all_reduce(acc.view(n, copies, 2 * K).sum(1), mesh)
    pos, neg = acc[:, K:] & 0xFFFFFFFF, acc[:, K:] >> 32
    out = torch.where(pos > 0, torch.inf, -torch.inf).to(v.dtype)
    out = torch.where((pos > 0) & (neg > 0), torch.nan, out)
    out = torch.where((pos > 0) | (neg > 0), out,
                      dequantize(acc[:, :K], e_cells, v.dtype))
    return out.reshape(n) if flat else out
