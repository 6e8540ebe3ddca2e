"""The port's ``ops/stream_scan.StreamedRuns`` (torch, on the CPU here)
against the JAX package's (``jax.jit`` on the CPU), answer for answer, on
``tests/test_stream_scan.py``'s planes and tiles, on planes of the
automerge-paper trace's runs, and on a ``np.memmap`` plane: ``live_total``,
every live rank, every order, and the out-of-range sentinels. Tolerance:
none (integers)."""
import random

import numpy as np
import pytest

from text_crdt_rust_tpu.ops.stream_scan import StreamedRuns as JaxStreamed
from text_crdt_rust_tpu.utils.testdata import (
    flatten_patches,
    load_testing_data,
    trace_path,
)
from text_crdt_rust_tpu_torch.ops.stream_scan import StreamedRuns

from test_sp_runs import runs_from_patches
from test_stream_scan import dense_reference, random_planes


def assert_same_answers(ordp, lenp, tile, ranks=None, orders=None):
    port = StreamedRuns(ordp, lenp, tile=tile, device="cpu")
    ref = JaxStreamed(ordp, lenp, tile=tile)
    total = ref.live_total()
    assert port.live_total() == total
    np.testing.assert_array_equal(port.carry, ref.carry)
    np.testing.assert_array_equal(port.omin, ref.omin)
    np.testing.assert_array_equal(port.omax, ref.omax)
    if ranks is None:
        ranks = range(0, total + 2)
    for r in ranks:
        assert port.position_of_live_rank(r) == \
            ref.position_of_live_rank(r), r
    starts = np.abs(np.asarray(ordp, np.int64)) - 1
    top = int((starts + np.asarray(lenp)).max(initial=0))
    if orders is None:
        orders = range(-2, top + 6)
    for o in orders:
        assert port.order_to_position(o) == ref.order_to_position(o), o
    return port


@pytest.mark.parametrize("tile", (8, 16, 64))
def test_matches_jax_on_random_planes(tile):
    ordp, lenp, _ = random_planes(random.Random(11), 37)
    port = assert_same_answers(ordp, lenp, tile)
    live, rank_map, pos_map = dense_reference(ordp, lenp)
    assert port.live_total() == live
    assert port.position_of_live_rank(live + 1) == (-1, 0)


@pytest.mark.parametrize("tile", (8, 3, 1))
def test_single_tile_and_exact_boundary(tile):
    ordp = np.asarray([1, -4, 6], np.int32)
    lenp = np.asarray([3, 2, 2], np.int32)
    port = assert_same_answers(ordp, lenp, tile)
    assert port.position_of_live_rank(4) == (2, 1)
    assert port.order_to_position(3) == -1
    assert port.order_to_position(5) == 3


@pytest.mark.parametrize("tile", (64, 1000))
def test_matches_jax_on_trace_runs(tile):
    data = load_testing_data(trace_path("sveltecomponent"))
    ordp, lenp = runs_from_patches(flatten_patches(data)[:1200])
    rng = random.Random(tile)
    total = int(np.where(ordp > 0, lenp, 0).sum())
    top = int((np.abs(ordp.astype(np.int64)) - 1 + lenp).max())
    assert_same_answers(ordp, lenp, tile,
                        ranks=rng.sample(range(1, total + 1), 150)
                        + [0, 1, total, total + 1],
                        orders=rng.sample(range(top), 150) + [top, -1])


def test_memmap_plane_and_upload_cache(tmp_path):
    """A plane on disk (``np.memmap``) answers as the same plane in memory
    and as the JAX package; repeated lookups in one tile upload it once."""
    ordp, lenp, _ = random_planes(random.Random(5), 400)
    mm = np.memmap(tmp_path / "planes", np.int32, "w+",
                   shape=(2, len(ordp)))
    mm[0], mm[1] = ordp, lenp
    mm.flush()
    port = assert_same_answers(mm[0], mm[1], tile=32)
    assert np.shares_memory(port.ordp, mm)    # no copy of the plane
    before = port.uploads
    for _ in range(5):
        port.position_of_live_rank(1)
    assert port.uploads - before <= 1


def test_device_is_the_callers():
    import torch
    ordp = np.asarray([1], np.int32)
    lenp = np.asarray([1], np.int32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamedRuns(ordp, lenp)
    with pytest.raises(ValueError, match="tile"):
        StreamedRuns(ordp, lenp, tile=0, device="cpu")
