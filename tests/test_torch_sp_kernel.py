"""S1's host side on the CPU: the refusals of its wrappers
(``parallel/sp_kernel.py``), and the port's ``SpDoc`` against the JAX
package's at nsp 1, 2 and 4 on seeded streams that reach every error path
(capacity, bad delete, order miss, the ``auto_reshard`` retry), and from a
JAX ``SpDoc``'s mid-stream state carried across by
``convert.sp_doc_from_numpy``.

The port's plain version is the segment driver: ``sp_apply.drive`` runs
``_Shard``'s segments and the collectives between them, the same driver
that runs S1 a segment at sp > 1 on the card, so these cases hold that
driver's order of segments and collectives to the JAX program. The kernel
itself runs only on the card (``tests/test_torch_cuda.py``). Tolerance:
none (integers).
"""
import jax
import numpy as np
import pytest
import torch

from text_crdt_rust_tpu.common import RemoteId, RemoteIns, RemoteTxn
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.utils.randedit import make_storm
from text_crdt_rust_tpu.utils.testdata import TestPatch
from text_crdt_rust_tpu_torch.ops import _kernels
from text_crdt_rust_tpu_torch.parallel import sp_kernel as SK
from text_crdt_rust_tpu_torch.parallel.launch import World
from text_crdt_rust_tpu_torch.parallel.sp_apply import SpReplay

import torch_world_jobs as jobs
from test_torch_sp_apply import (
    PLANES,
    ROOT,
    jax_script,
    local_ops,
    padded,
    port_ops,
    run_both,
)

I32 = torch.int32


@pytest.fixture(scope="module")
def world():
    with World(4, "gloo", "cpu", timeout=120) as w:
        yield w


# -- the wrappers' refusals ---------------------------------------------------


def _state(R=8, OTS=4, S=3):
    z = torch.zeros
    return (z(R, dtype=I32), z(R, dtype=I32), z(1, dtype=I32),
            z(OTS, dtype=I32), z(OTS, dtype=I32), z(OTS, dtype=I32),
            np.zeros((9, S), np.int32))


class _OneRank:
    sp = 1

    @staticmethod
    def index(axis):
        return 0


def test_s1_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="S1 runs on CUDA tensors"):
        SK.sp_replay_cuda(*_state())
    with pytest.raises(ValueError, match="S1 runs on CUDA tensors"):
        SK.KernelSegments(_OneRank(), *_state())


@pytest.mark.parametrize("R, OTS", [(SK.MAX_ROWS + 1, 4),
                                    (8, SK.MAX_ROWS + 1), (0, 4), (8, 0)])
def test_s1_refuses_geometry_before_any_build(monkeypatch, R, OTS):
    def no_build(*a, **k):
        raise AssertionError("built before the geometry check")

    monkeypatch.setattr(_kernels, "build", no_build)
    monkeypatch.setattr(_kernels, "library", no_build)
    one = torch.zeros(1, dtype=I32)
    plane = one.expand(R) if R else one[:0]
    tab = one.expand(OTS) if OTS else one[:0]
    with pytest.raises(ValueError, match=r"would need \d+ B a plane"):
        SK.sp_replay_cuda(plane, plane, one, tab, tab, tab,
                          np.zeros((9, 2), np.int32))


def test_s1_refuses_op_columns_of_another_shape():
    *st, cols = _state()
    with pytest.raises(ValueError, match=r"op columns \[9, S\]"):
        SK.sp_replay_cuda(*st, cols[:8])


def test_sp_replay_refuses_other_devices():
    st = [t.to("meta") for t in _state()[:6]]
    with pytest.raises(ValueError, match="no sp replay for device meta"):
        SpReplay(_OneRank(), 8, 4)(*st, *np.zeros((9, 2), np.int32))


# -- the segment driver against the JAX SpDoc, every error path -------------


def _capacity(nsp):
    ops, _ = local_ops([TestPatch(0, 0, "ab"), TestPatch(0, 0, "xy")] * 25)
    return 8, [("apply", ops)], False, "capacity"


def _bad_delete(nsp):
    ops, _ = local_ops([TestPatch(0, 0, "ab"), TestPatch(0, 5, "")])
    return 32, [("apply", ops)], False, "delete ran past the end"


def _order_miss(nsp):
    txns = [RemoteTxn(id=RemoteId("a", 0), parents=[],
                      ops=[RemoteIns(ROOT, ROOT, "ab")]),
            RemoteTxn(id=RemoteId("a", 2), parents=[],
                      ops=[RemoteIns(RemoteId("a", 1), ROOT, "cd")])]
    table = JB.AgentTable(["a"])
    ops, _ = JB.compile_remote_txns(txns, table, lmax=8, dmax=None)
    ops = jax.tree.map(lambda a: np.asarray(a).copy(), ops)
    ops.origin_left[1] = 90  # absent order
    return 16, [("apply", ops)], False, "order lookup missed"


def _auto_reshard(nsp):
    p1, content = [], ""
    for k in range(6):
        pos = 0 if k % 2 else len(content)
        p1.append(TestPatch(pos, 0, "ab"))
        content = content[:pos] + "ab" + content[pos:]
    ops1, nxt = local_ops(p1)
    ops2, _ = local_ops([TestPatch(pos, 0, "Q")
                         for pos in (1, 3, 5, 7, 9, 11)], start_order=nxt)
    # 14 rows a shard: the second stream overflows shard 0, which holds
    # every row of a fresh document; at sp > 1 the rebalance makes room,
    # at sp = 1 the retry fails again.
    return 14, [("apply", ops1), ("apply", ops2), ("read",)], True, None


#: Rows a shard for the chunked storm: a fresh document fills shard 0,
#: which overflows at sp > 1 and is rebalanced (sp = 1 holds it all).
STORM_ROWS = {1: 40, 2: 20, 4: 16}


def _storm_deletes(nsp):
    txns, _ = make_storm(4, 8, 3, seed=7, del_prob=0.4)
    table = JB.AgentTable(sorted({t.id.agent for t in txns}))
    script, assigner = [], None
    for at in range(0, len(txns), 8):
        ops, assigner = JB.compile_remote_txns(
            txns[at:at + 8], table, assigner=assigner, lmax=8, dmax=None)
        script.append(("apply", ops))
    return STORM_ROWS[nsp], script + [("read",)], True, None


ERROR_PATHS = {"capacity": _capacity, "bad-delete": _bad_delete,
               "order-miss": _order_miss, "auto-reshard": _auto_reshard,
               "storm-deletes-resharded": _storm_deletes}


@pytest.mark.parametrize("nsp", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(ERROR_PATHS))
def test_segment_driver_matches_jax(world, name, nsp):
    """Per-shard planes (every row), rows, tables, origin logs and each
    raised error's message equal the JAX ``SpDoc``'s."""
    R, script, auto, error = ERROR_PATHS[name](nsp)
    got = run_both(world, nsp, R, script, auto=auto)
    results = [g for g in got if g is not None]
    if error is not None:
        assert results[-1][0] == "error" and error in results[-1][1]
    elif name == "auto-reshard":
        if nsp == 1:
            assert results[-1][0] == "error" and "capacity" in results[-1][1]
        else:
            assert results[1][3] == 1, "the second stream must reshard"
    else:
        # The state stays int32 (S1 takes nothing else).
        assert results[-1]["dtypes"] == ["torch.int32"]
        assert all(r[0] == "ok" for r in results[:-1])
        assert (results[-2][3] > 0) == (nsp > 1), "a reshard at sp > 1"


# -- the JAX state carried across mid-stream ---------------------------------


@pytest.mark.parametrize("nsp", [2, 4])
def test_from_jax_mid_stream_state(world, nsp):
    """A JAX ``SpDoc``'s gathered state after all but the last block of a
    storm (a reshard spread its rows), loaded into the port's shards as it
    is, then the last block on both: equal."""
    R, script, _, _ = _storm_deletes(nsp)
    applies = [padded(e[1]) for e in script if e[0] == "apply"]
    half = len(applies) - 1
    jscript = ([("apply", o) for o in applies[:half]] + [("read",)]
               + [("apply", o) for o in applies[half:]] + [("read",)])
    want = jax_script(nsp, R, 1024, True, jscript)
    mid, end = want[half], want[-1]
    assert (mid["planes"]["rows"] > 0).sum() > 1, "rows on one shard only"
    got = world.run(jobs.sp_doc_job, nsp, R, 1024, True, [
        ("planes", mid["planes"], mid["ol_log"], mid["or_log"]), ("read",)]
        + [("apply", port_ops(o)) for o in applies[half:]] + [("read",)])
    for k in PLANES:
        np.testing.assert_array_equal(got[1]["planes"][k],
                                      mid["planes"][k].astype(np.int32),
                                      err_msg=k)
        np.testing.assert_array_equal(got[-1]["planes"][k],
                                      end["planes"][k].astype(np.int32),
                                      err_msg=k)
    np.testing.assert_array_equal(got[-1]["expand"], end["expand"])
    assert got[-1]["ol_log"] == end["ol_log"]
    assert got[-1]["or_log"] == end["or_log"]


def test_sp_doc_from_numpy_refuses_other_shapes(world):
    planes = {k: np.zeros(4 * 8 if k in ("ordp", "lenp") else 4,
                          np.int32) for k in PLANES}
    planes["oll"] = np.zeros(3, np.int32)
    with pytest.raises(RuntimeError, match="oll holds 3 entries"):
        world.run(jobs.sp_doc_job, 4, 8, 1, False, [("planes", planes)])
