"""S1's host side on the CPU: the refusals of its wrappers
(``parallel/sp_kernel.py``), and the port's ``SpDoc`` against the JAX
package's at nsp 1, 2 and 4 on seeded streams that reach every error path
(capacity, bad delete, order miss, the ``auto_reshard`` retry), and from a
JAX ``SpDoc``'s mid-stream state carried across by
``convert.sp_doc_from_numpy``.

S1 answers the plain version's row-level counts and clips through a tile
index of the rows (exact where every tile is sane and the totals stay
below 2^31, else a full pass); ``sp_kernel``'s plain model of those rules
is held equal to ``_Shard``'s row-level answers after every segment of
the card cases and of a trace prefix, loaded states with a live row of
negative length and live totals past 2^31 included, and ``_Shard``'s rows
at and past S1's extent stay zero throughout.

The port's plain version is the segment driver: ``sp_apply.drive`` runs
``_Shard``'s segments and the collectives between them, the same driver
that runs S1 a segment at sp > 1 on the card, so these cases hold that
driver's order of segments and collectives to the JAX program. The kernel
itself runs only on the card (``tests/test_torch_cuda.py``). Tolerance:
none (integers).
"""
import collections
import functools
import types

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
from text_crdt_rust_tpu_torch.parallel import sp_apply as TSA
from text_crdt_rust_tpu_torch.parallel.sp_apply import SpReplay
from text_crdt_rust_tpu_torch.parallel.sp_runs import cumsum32, sum32

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


def test_s1_index_scratch_is_sized_from_rows():
    """Four words (16 B) a 32-row tile, each array rounded up to whole
    int4s: any R that ``check_geometry`` takes, with no new limit (512 MiB
    at 2^30 rows)."""
    for R, words in ((1, 16), (32, 16), (33, 16), (129, 32),
                     (38_416, 4 * 1_204), (SK.MAX_ROWS, 4 << 25)):
        assert SK.index_words(R) == words
    assert 4 * SK.index_words(SK.MAX_ROWS) == 512 << 20


def _cpu_launches(monkeypatch):
    """Route S1's wrapper on CPU tensors to a stub that records each
    launch's arguments (nothing is built)."""
    calls = []

    def function(name, symbol, argtypes):
        assert (name, symbol) == ("sp_replay", "sp_replay_launch")

        def call(*args):
            assert len(args) == len(argtypes) == 28
            calls.append(args)
            return 0
        return call

    monkeypatch.setattr(_kernels, "function", function)
    monkeypatch.setattr(SK, "_require_cuda", lambda ts: ts[0].device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    return calls


def test_s1_passes_its_index_scratch_and_stats(monkeypatch):
    """Each launch gets the launch's own index scratch (``index_words(R)``
    int32, allocated from R) and the stats pointer, null on the main
    path."""
    calls = _cpu_launches(monkeypatch)
    *st, cols = _state(R=100, OTS=4, S=3)
    SK.sp_replay_cuda(*st, cols)
    stats = torch.zeros(SK.SP_STATS, dtype=torch.int64)
    SK.sp_replay_cuda(*st, cols, stats=stats)
    (main, counted) = calls
    assert main[12] is None and counted[12] == stats.data_ptr()
    run = SK._Launch(*st, cols, 1, 0)
    assert run.index.dtype == torch.int32
    assert run.index.shape == (SK.index_words(100),) == (16,)
    assert run.planes[0].shape == (100,)
    assert run.planes[0].untyped_storage().nbytes() == 4 * 100
    run.launch(run.st, [(SK.SEG_INIT, 0)])
    args = calls[-1]
    assert args[11] == run.index.data_ptr()
    assert args[13:19] == (100, 4, 3, 1, 0, 1)


@pytest.mark.parametrize("stats", [torch.zeros(3, dtype=torch.int64),
                                   torch.zeros(16, dtype=torch.int32)])
def test_s1_refuses_other_stats_before_any_build(monkeypatch, stats):
    def no_build(*a, **k):
        raise AssertionError("built before the stats check")

    monkeypatch.setattr(_kernels, "build", no_build)
    monkeypatch.setattr(_kernels, "library", no_build)
    monkeypatch.setattr(SK, "_require_cuda", lambda ts: ts[0].device)
    with pytest.raises(ValueError, match=r"stats must be a contiguous "
                                         r"int64 \[16\]"):
        SK.sp_replay_cuda(*_state(), stats=stats)


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


# -- S1's index rules against _Shard's row-level answers ---------------------


class _OneRankMesh:
    """The collectives of a one-rank ``sp`` group: the identity."""

    sp = 1
    device = torch.device("cpu")

    def __init__(self):
        self.calls = collections.Counter()

    def index(self, axis):
        return 0

    def all_gather(self, x, axis="sp"):
        return x.reshape(1, *x.shape).clone()

    def sum(self, x, axis="sp"):
        return x.clone()

    def bor(self, x, axis="sp"):
        return x.clone()


def _np(t):
    return t.cpu().numpy().astype(np.int32)


class _Checked(TSA._Shard):
    """``_Shard`` with ``sp_kernel``'s model of S1's index rules held to its
    row-level answers at every count, clip and total, and S1's extent
    tracked (E = max(ext, rows + 2), ext grown by each shift): every row at
    or past E must be zero after every segment."""

    def __init__(self, *args, log):
        super().__init__(*args)
        self.log = log
        self.ext = None

    def _E(self):
        return SK.extent(self.ext, int(self.nrows), self.R)

    def run(self, code, s):
        rows0 = int(self.nrows)
        if self.ext is None:
            nz = np.nonzero((_np(self.ordp) != 0) | (_np(self.lenp) != 0))[0]
            self.ext = int(nz[-1]) + 1 if len(nz) else 0
        E0 = self._E()
        super().run(code, s)
        grown = int(self.nrows) - rows0
        if grown > 0:
            self.ext = min(self.R, E0 + grown)
        E = self._E()
        past = int((_np(self.ordp)[E:] != 0).sum()
                   + (_np(self.lenp)[E:] != 0).sum())
        self.log["extent"].append((code, s, E, past))

    def _index(self, live):
        lv, raw, sane = SK.tile_index(_np(self.ordp), _np(self.lenp),
                                      self._E())
        return int((lv if live else raw).sum()), bool(sane.all())

    def _total(self, want, live):
        got = SK._i32(self._index(live)[0])
        self.log["checks"].append(("total", got == int(want), None))

    def _rank(self, X, live, strict):
        """S1's (row, exclusive prefix) of the count, against the row-level
        count the plain segment makes."""
        ordp, lenp = self.ordp, self.lenp
        v = torch.where(ordp > 0, lenp, 0) if live else lenp
        incl = cumsum32(v)
        hit = (incl <= X) if strict else (incl < X)
        i_r = int(sum32(hit & (self.idx < self.nrows)).clamp(max=self.R - 1))
        excl = SK._i32(int(incl[i_r]) - int(v[i_r]))
        row, ex, fast = SK.index_rank(_np(ordp), _np(lenp), int(self.nrows),
                                      self._E(), int(X), live, strict)
        self.log["checks"].append(("rank", (row, ex) == (i_r, excl), fast))

    def ld_total(self, s, op):
        super().ld_total(s, op)
        self._total(self.local[-1], True)

    def li_head(self, s, op):
        super().li_head(s, op)
        self._total(self.local[-1], True)

    def ri_total(self, s, op):
        super().ri_total(s, op)
        self._total(self.rawcum[-1], False)

    def ld_cover(self, s, op):
        super().ld_cover(s, op)
        carry = int(sum32(self.recv.reshape(-1)[:self.sidx]))
        covered, full, part, fast = SK.index_delete(
            _np(self.ordp), _np(self.lenp), self._E(), carry, op[1], op[2])
        cov = self.cov
        want_full = ((cov > 0) & (cov == self.lenp)).numpy()
        want_part = ((cov > 0) & (cov != self.lenp)).numpy()
        clips = {int(j): (int(self.cs[j]), int(self.ce[j]))
                 for j in np.nonzero(want_part)[0]}
        ok = (covered == int(sum32(cov)) and (full == want_full).all()
              and part == clips)
        self.log["checks"].append(("delete", bool(ok), fast))

    def li_splice(self, s, op):
        carry = int(sum32(self.recv[:self.sidx, 0]))
        self._rank(SK._i32(op[1] - carry), True, False)
        super().li_splice(s, op)

    def ri_run(self, s, op):
        self._rank(self.cursor - self.carry, False, True)
        super().ri_run(s, op)

    def ri_splice(self, s, op):
        c = torch.where(self.scanning, self.scan_start, self.cursor)
        self._rank(c - self.carry, False, False)
        super().ri_splice(s, op)


def _trace_case():
    from text_crdt_rust_tpu_torch import sp
    from text_crdt_rust_tpu_torch.parallel.sp_apply import OP_FIELDS
    ps, _ = sp.trace_patches(3000)
    _, parts, _ = sp.compile_sp(ps)
    blocks = [np.stack([np.asarray(getattr(p, f), np.uint32).view(np.int32)
                        for f in OP_FIELDS]) for p in parts]
    return 600, 64, blocks, None, False, 0


def _model_cases():
    import test_torch_cuda as card
    cases = {n: (f, card._SP_DOCS.get(n), card._SP_TABLES.get(n))
             for n, f in card.SP_CASES.items()}
    cases["trace-3000"] = (_trace_case, None, None)
    return cases


MODEL_CASES = sorted(_model_cases())
#: The cases whose states send S1 to its full pass: a live row of negative
#: length, a live total past 2^31 (tiles sane or not), a deleted row of
#: negative length on the remote path.
FULL_PASS = {"negative-live", "remote-full-pass", "wrapping-total",
             "wrapping-total-sane"}


@functools.lru_cache(maxsize=None)
def _checked_run(name):
    """The card case ``name`` (or the trace prefix) on ``_Checked`` at sp =
    1, block after block as ``sp_kernel_job`` commits them."""
    make, doc, tables = _model_cases()[name]
    R, OTS, streams, stale, reshard, _ = make()
    mesh = _OneRankMesh()
    z = lambda n, v=0: torch.full((n,), v, dtype=I32)
    st = [z(R), z(R), z(1), z(OTS, -2), z(OTS, -2), z(OTS)]
    if doc is not None:
        o, ln = doc[:2]
        st[0][:len(o)] = torch.from_numpy(np.asarray(o, np.int32))
        st[1][:len(o)] = torch.from_numpy(np.asarray(ln, np.int32))
        st[2][0] = len(o)
    if tables is not None:
        for k, t in enumerate(tables):
            st[3 + k][:len(t)] = torch.from_numpy(np.asarray(t, np.int32))
    if stale is not None:
        at, o, ln = stale
        st[0][at:at + len(o)] = torch.as_tensor(o, dtype=I32)
        st[1][at:at + len(o)] = torch.as_tensor(ln, dtype=I32)
    log = collections.defaultdict(list)
    for cols in streams:
        cols = np.ascontiguousarray(cols, np.int32)
        shard = _Checked(mesh, R, OTS, st[0], st[1], st[2][0], *st[3:],
                         cols, log=log)
        out = TSA.drive(shard, cols)
        if int(out[-1]):
            break
        st = [t.clone() for t in out[:6]]
        if reshard:
            r = int(st[2][0])
            for k in (0, 1):
                kept = st[k][:r].clone()
                st[k].zero_()
                st[k][:r] = kept
    return dict(log)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_index_model_matches_row_level(name):
    """Every total, live-rank and raw-rank count (with its row's prefix)
    and every local delete's covered count, wholly covered rows and
    partial rows with their clips, as S1 takes them through its tile index
    (or its full pass), equal ``_Shard``'s row-level answers; the full pass
    is taken exactly where a tile is not sane or a total passes 2^31."""
    checks = _checked_run(name)["checks"]
    bad = [c for c in checks if not c[1]]
    assert checks and not bad, bad[:5]
    kinds = collections.Counter(c[0] for c in checks)
    assert kinds["total"] > 0 and kinds["rank"] + kinds["delete"] > 0
    slow = sum(1 for c in checks if c[2] is False)
    if name in FULL_PASS:
        assert slow > 0, "the full pass was not reached"
    else:
        assert slow == 0, f"{slow} full passes on a sane state"


@pytest.mark.parametrize("name", MODEL_CASES)
def test_rows_past_the_extent_stay_zero(name):
    """S1's passes read rows [0, E) only: ``_Shard``'s rows at and past E
    (E = max(ext, rows + 2) within [1, R], ext the nonzero extent at the
    start grown by each shift) stay zero after every segment, the shifts
    at E = R and the stale rows past ``rows`` included."""
    ext = _checked_run(name)["extent"]
    assert ext
    assert [e for e in ext if e[3]] == []
