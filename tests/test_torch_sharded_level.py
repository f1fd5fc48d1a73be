"""The sharded tree level: the port's ``fused_level`` on W = 2 gloo ranks
(each rank's histogram, the all-reduce, the split on the summed
histogram, each rank's routing; the plain versions of ``shard_hist``,
``tree_split`` and ``shard_partition`` on the CPU) against the
reference's ``fused_level`` on a 2-device data mesh in interpret mode,
which runs ``_hist_call`` → ``psum`` → ``_level_boundary`` →
``_partition_call``, levels 0..2.

Stats are dyadic (small integers), so every float32 sum is exact in any
order: the whole 10-tuple must be EXACTLY equal — the replicated outputs
on every rank, and ``new_nid`` concatenated across the ranks. The cases
are those of ``test_level_parity_with_pallas_kernel`` plus an uneven row
count (padding rows of zero weight in the NA bin). The ranks run once
for the module (``tests/torch_ranks.py``, a 120 s join timeout)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from h2o3_tpu.models.tree import TreeScalars as RefScalars
from h2o3_tpu.ops.pallas import treekernel as ref_tk

import torch_ranks as tr

OUT_NAMES = ("hist", "gain", "feat", "thresh", "na_left", "left_val",
             "right_val", "leftmask", "split", "new_nid")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.run_ranks("level", tmp_path_factory.mktemp("level"))


def _reference(case):
    bins, stats, B, is_cat, cons, lo, hi, masks, scal = tr.level_case(case)
    min_rows, lam, msi, dl = scal
    sc = RefScalars(jnp.float32(min_rows), jnp.float32(lam),
                    jnp.float32(msi), jnp.int32(dl))
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    nb = np.full(bins.shape[1], B - 1, np.int32)
    j = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731

    @jax.jit
    def sweep(bins, stats):
        outs, prev = [], None
        nid = jnp.zeros((bins.shape[0],), jnp.int32)
        for d in range(tr.LEVEL_DEPTH + 1):
            out = ref_tk.fused_level(
                bins, nid, stats, prev, jnp.asarray(masks[d]),
                jnp.asarray(nb), j(is_cat), j(cons), jnp.asarray(lo),
                jnp.asarray(hi), sc, d=d, n_nodes=2 ** d, n_bins=B,
                block_rows=64, mesh=mesh, interpret=True)
            outs.append(out)
            prev, nid = out[0], out[-1]
        return outs

    return [[np.asarray(x) for x in o]
            for o in sweep(jnp.asarray(bins), jnp.asarray(stats))]


@pytest.mark.parametrize("case", tr.LEVEL_CASES)
def test_sharded_level_equals_reference_two_shard_kernels(ranks, case):
    ref = _reference(case)
    for d, o_r in enumerate(ref):
        for r, res in enumerate(ranks):
            for name, a, b in zip(OUT_NAMES[:-1], o_r, res[case][d]):
                assert a.dtype == b.dtype, (case, d, r, name)
                np.testing.assert_array_equal(
                    b, a, err_msg=f"{case}: rank {r} level {d} '{name}'")
        nid = np.concatenate([res[case][d][-1] for res in ranks])
        np.testing.assert_array_equal(
            nid, o_r[-1], err_msg=f"{case}: level {d} new_nid")
    assert any(o[8].any() for o in ref), f"{case}: no split was made"
