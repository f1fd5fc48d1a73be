"""The port's row mesh on W = 2 gloo ranks on the CPU: the shard-homing
math, the map/reduce collectives, partitioned ingest and partitioned
binning (``parallel/mesh.py``, ``parallel/map_reduce.py``,
``frame/partition.py``, ``Frame.from_numpy_partitioned``,
``bin_frame``).

The ranks run once for the module (``tests/torch_ranks.py``, scenario
``mesh``, a 120 s join timeout); each test reads their results. A
partitioned frame must equal ``Frame.from_numpy`` of the concatenated
rows: the same domains and float64 host views on every rank, and the
same device bytes for each rank's rows, on an uneven row count."""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.frame.binning import bin_frame
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.parallel import mesh as mesh_mod

import torch_ranks as tr


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.run_ranks("mesh", tmp_path_factory.mktemp("mesh"))


@pytest.fixture(scope="module")
def whole():
    cols, cats, domains = tr.mesh_cols()
    return Frame.from_numpy(cols, categorical=cats, domains=domains,
                            device="cpu")


@pytest.mark.parametrize("n", [0, 1, 517, 528])
@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("block", [1, 8])
def test_padded_rows_bounds_tile_all_rows(n, world, block):
    meshes = [mesh_mod.Mesh(None, None, r, world) for r in range(world)]
    npad = mesh_mod.padded_rows(n, meshes[0], block)
    assert npad % (world * block) == 0 and n <= npad < n + world * block
    spans = [mesh_mod.partition_bounds(npad, m) for m in meshes]
    owned = [mesh_mod.owned_rows(n, m, block) for m in meshes]
    assert spans[0][0] == 0 and spans[-1][1] == npad
    assert owned[0][0] == 0 and owned[-1][1] == n
    for r in range(1, world):
        assert spans[r][0] == spans[r - 1][1]
        assert owned[r][0] == owned[r - 1][1]
    assert len({hi - lo for lo, hi in spans}) == 1
    for (lo, hi), (olo, ohi), m in zip(spans, owned, meshes):
        valid = mesh_mod.valid_mask(n, (lo, hi), torch.device("cpu"))
        assert valid.shape == (hi - lo,) and float(valid.sum()) == ohi - olo


def test_world_one_mesh_is_the_default():
    assert mesh_mod.get_mesh() is mesh_mod.LOCAL
    assert not mesh_mod.is_sharded(None)
    assert mesh_mod.padded_rows(517, None, 8) == 520
    assert mesh_mod.partition_bounds(520) == (0, 520)


def test_frame_reduce_sums_every_leaf(ranks):
    x = np.arange(104, dtype=np.float64)
    for res in ranks:
        red = res["reduce"]
        assert float(red["sum"][0]) == x.sum()
        assert float(red["sq"][0]) == (x * x).sum()
        assert int(red["n"][0]) == 104


def test_fetch_replicated_restores_row_order(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["fetch"], np.arange(104.0))
    np.testing.assert_array_equal(
        np.concatenate([r["map"] for r in ranks]), 2 * np.arange(104.0))


def test_partitioned_ingest_equals_from_numpy(ranks, whole):
    n = whole.nrows
    assert [r["span"] for r in ranks] == [(0, 264), (264, 528)]
    for res in ranks:
        lo, hi = res["span"]
        nl = max(min(hi, n) - lo, 0)
        assert res["npad"] == 528
        np.testing.assert_array_equal(
            res["valid"], (np.arange(lo, hi) < n).astype(np.float32))
        for name in whole.names:
            want, got = whole.col(name), res["cols"][name]
            assert got["type"] == want.type, name
            assert got["domain"] == want.domain, name
            assert got["nrows"] == n, name
            np.testing.assert_array_equal(got["host"], want.host_view(),
                                          err_msg=name)
            assert got["data"].dtype == want.data.numpy().dtype, name
            np.testing.assert_array_equal(
                got["data"][:nl], want.data.numpy()[lo:lo + nl], err_msg=name)
            np.testing.assert_array_equal(
                got["na"][:nl], want.na_mask.numpy()[lo:lo + nl],
                err_msg=name)
            assert got["na"][nl:].all() and not got["data"][nl:].any(), name
    # string and numeric categoricals really are in the frame
    assert whole.col("s").domain == ["blue", "green", "red", "zz"]
    assert whole.col("k").domain == ["-2.0", "1.5", "3.0", "10.0"]


def test_partitioned_binning_equals_whole(ranks, whole):
    bm = bin_frame(whole, ["a", "s", "k", "c"], nbins=8, nbins_cats=2)
    n = whole.nrows
    for res in ranks:
        lo, hi = res["span"]
        nl = max(min(hi, n) - lo, 0)
        assert res["B"] == bm.nbins_total
        np.testing.assert_array_equal(res["edges"], bm.edges.numpy())
        np.testing.assert_array_equal(res["nbins"], bm.nbins.numpy())
        np.testing.assert_array_equal(res["bins"][:nl],
                                      bm.bins.numpy()[lo:lo + nl])
        assert (res["bins"][nl:] == bm.nbins_total - 1).all()
