"""The port's mixed-stream blocked replay (A10, plain PyTorch version, on
the CPU) against the JAX package's Pallas kernel ``_mixed_kernel`` in
interpret mode, bit for bit, and the config-4 storm on
``engine="blocked-mixed"`` at smoke size.

The cases are those of ``tests/test_blocked_mixed.py`` (capacity 64-1,024,
K = 8-32, batch 8, chunk 128): the root tiebreak, two-peer merges,
fragmented and double remote deletes, local/remote convergence, the
interleaved storm (rebalances between remote lookups: stale hints, the
full-state fallback and its healing), the long chunked delete, a
local-only stream against A8, an unknown delete target and a remote
insert after an absent order (``err[2]``), and a storm of 40 peers (more
than 32 concurrent inserts at one origin).
Beside them, a plain-Python model of the CUDA kernel's windowed conflict
scan is held equal to ``integrate_cursor`` on every remote insert of
seeded storms.
Each case compiles its txns with the JAX package and replays the same
``OpTensors`` in both; ``signed``, ``rows``, ``ol``, ``orr`` and ``err``
compare in full. Tolerance: none, the state is integers.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from text_crdt_rust_tpu.common import (
    RemoteDel,
    RemoteId,
    RemoteIns,
    RemoteTxn,
)
from text_crdt_rust_tpu.models.sync import export_txns_since
from text_crdt_rust_tpu.ops import batch as JB
from text_crdt_rust_tpu.ops import blocked_mixed as JBM
from text_crdt_rust_tpu.utils.randedit import make_storm as jax_make_storm
from text_crdt_rust_tpu_torch import storm
from text_crdt_rust_tpu_torch.ops import blocked as TBL
from text_crdt_rust_tpu_torch.ops import blocked_mixed as TBM
from text_crdt_rust_tpu_torch.ops import span_arrays as TSA

from test_device_flat import oracle_from_patches, random_patches
from test_torch_blocked import (
    assert_blocked_equal,
    assert_flat_equal,
    compile_local,
    port_ops,
)

ROOT = RemoteId("ROOT", 0xFFFFFFFF)
GEOM = dict(batch=8, chunk=128)


def compile_txns(txns, lmax=4, dmax=16):
    table = JB.AgentTable()
    for t in txns:
        table.add(t.id.agent)
        for op in t.ops:
            if hasattr(op, "id"):
                table.add(op.id.agent)
    return JB.compile_remote_txns(txns, table, lmax=lmax, dmax=dmax)[0]


def _both(jops, capacity, block_k):
    jres = JBM.replay_mixed(jops, capacity=capacity, block_k=block_k,
                            interpret=True, **GEOM)
    tres = TBM.replay_mixed(port_ops(jops), capacity=capacity,
                            block_k=block_k, device="cpu", **GEOM)
    assert_blocked_equal(jres, tres)
    return jres, tres


def _oracle_text(txns):
    from text_crdt_rust_tpu.models.oracle import ListCRDT
    doc = ListCRDT()
    for t in txns:
        doc.apply_remote_txn(t)
    return doc.to_string()


def _two_peer(seed):
    rng = random.Random(seed)
    pa, _ = random_patches(rng, 40)
    pb, _ = random_patches(rng, 40)
    a = oracle_from_patches(pa, agent="peer-a")
    b = oracle_from_patches(pb, agent="peer-b")
    return export_txns_since(a, 0) + export_txns_since(b, 0)


def _fragmented_double():
    base = RemoteTxn(id=RemoteId("amy", 0), parents=[],
                     ops=[RemoteIns(ROOT, ROOT, "abcdef")])
    d1 = RemoteTxn(id=RemoteId("bob", 0), parents=[RemoteId("amy", 5)],
                   ops=[RemoteDel(RemoteId("amy", 1), 3)])
    d2 = RemoteTxn(id=RemoteId("cat", 0), parents=[RemoteId("amy", 5)],
                   ops=[RemoteDel(RemoteId("amy", 2), 3)])
    return [base, d1, d2]


def _convergence():
    patches, _ = random_patches(random.Random(5), 60)
    return export_txns_since(oracle_from_patches(patches, agent="conv"), 0)


def _interleaved():
    rng = random.Random(99)
    txns = []
    for name in ("ada", "bea", "cyd", "dot"):
        patches, _ = random_patches(rng, 25)
        txns.extend(export_txns_since(oracle_from_patches(patches,
                                                          agent=name), 0))
    return txns


def _long_delete():
    base = RemoteTxn(id=RemoteId("amy", 0), parents=[],
                     ops=[RemoteIns(ROOT, ROOT, "x" * 50)])
    kill = RemoteTxn(id=RemoteId("bob", 0), parents=[RemoteId("amy", 49)],
                     ops=[RemoteDel(RemoteId("amy", 5), 40)])
    return [base, kill]


def _tie_runs():
    """40 concurrent inserts at ROOT (ascending rank order in the
    document), then three agents that saw only the last of them insert
    before it: each loses the ties of the ranks above its own, so its scan
    pins scan_start and carries it past 32 positions (the CUDA kernel's
    sub-window) to the break at its origin-right."""
    peers = [f"p{i:02d}" for i in range(40)]
    txns = [RemoteTxn(id=RemoteId(n, 0), parents=[],
                      ops=[RemoteIns(ROOT, ROOT, "x")]) for n in peers]
    last = RemoteId(peers[-1], 0)
    txns += [RemoteTxn(id=RemoteId(n, 0), parents=[last],
                       ops=[RemoteIns(ROOT, last, "y")])
             for n in ("a", "p20x", "p35x")]
    return txns


CASES = {
    "root-tiebreak": lambda: ([
        RemoteTxn(id=RemoteId(name, 0), parents=[],
                  ops=[RemoteIns(ROOT, ROOT, text)])
        for name, text in [("zed", "zz"), ("amy", "aa"), ("mia", "mm")]],
        4, 64, 8),
    "two-peer-s3": lambda: (_two_peer(3), 4, 512, 16),
    "two-peer-s21": lambda: (_two_peer(21), 4, 512, 16),
    "fragmented-double-delete": lambda: (_fragmented_double(), 4, 64, 8),
    "local-remote-convergence": lambda: (_convergence(), 4, 512, 16),
    "storm-interleaved-peers": lambda: (_interleaved(), 4, 1024, 16),
    "long-remote-delete-chunked": lambda: (_long_delete(), 16, 128, 32),
    "storm-40-peers": lambda: (jax_make_storm(40, 2, 1, seed=7)[0], 4, 256,
                               16),
    "tie-runs-past-32": lambda: (_tie_runs(), 4, 256, 16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_matches_jax(name):
    txns, lmax, capacity, block_k = CASES[name]()
    jops = compile_txns(txns, lmax=lmax)
    jres, tres = _both(jops, capacity, block_k)
    assert not np.asarray(jres.err).any()
    assert TBL.lanes_equal(tres)
    td = assert_flat_equal(jops, jres, tres)
    assert TSA.to_string(td) == _oracle_text(txns)


def test_local_stream_equals_a8():
    jops = compile_local(random_patches(random.Random(13), 60)[0])
    jres, tres = _both(jops, 512, 16)
    a8 = TBL.replay_local(port_ops(jops), capacity=512, block_k=16,
                          device="cpu", **GEOM)
    for f in ("signed", "rows", "ol", "orr", "err"):
        assert np.array_equal(getattr(a8, f).numpy(),
                              getattr(tres, f).numpy()), f


def test_unknown_order_flags_err2():
    """A remote delete of orders no item has: the hinted block misses,
    the full-state search misses (``err[2]``), and the unresolved targets
    raise ``err[1]``; the post-error state is the JAX kernel's."""
    jops = compile_txns([_long_delete()[0]], lmax=16)
    fields = {f.name: np.asarray(getattr(jops, f.name))
              for f in dataclasses.fields(jops)}
    fields = {k: np.concatenate([v, np.zeros((1,) + v.shape[1:], v.dtype)])
              for k, v in fields.items()}
    fields["kind"][-1] = JB.KIND_REMOTE_DEL
    fields["del_len"][-1] = 3
    fields["del_target"][-1] = 90
    fields["rows_per_step"][-1] = 1
    bad = JB.OpTensors(**fields)
    jres, tres = _both(bad, 128, 32)
    err = tres.err.numpy()
    assert err[2].all() and err[1].all() and not err[0].any()
    with pytest.raises(RuntimeError, match="past the end"):
        tres.check()


def test_unchunked_remote_deletes_rejected():
    jops = compile_txns(_long_delete(), lmax=16, dmax=None)
    with pytest.raises(ValueError, match="<= 16 targets"):
        TBM.make_replayer_mixed(port_ops(jops), capacity=128, block_k=32,
                                device="cpu")


def test_run_storm_blocked_mixed_matches_the_oracle():
    run = storm.run_storm(4, 10, 2, engine="blocked-mixed", batch=8,
                          device="cpu")
    assert run.ok and TSA.to_string(run.doc) == run.stream.want
    res = run.result
    assert isinstance(res, TBL.BlockedResult) and TBL.lanes_equal(res)
    # bench.py's geometry: 80 chars -> capacity 512, K = 256.
    assert (res.signed.shape, res.block_k) == ((512, 8), 256)
    jres = JBM.replay_mixed(run.stream.ops, capacity=512, batch=8,
                            block_k=256, chunk=1024, interpret=True)
    assert_blocked_equal(jres, res)


def test_run_storm_blocked_mixed_replays_the_delete_storm():
    run = storm.run_storm(4, 10, 2, del_prob=0.35, engine="blocked-mixed",
                          batch=8, device="cpu")
    assert run.ok and TBL.lanes_equal(run.result)
    assert (np.asarray(run.stream.ops.kind) == JB.KIND_REMOTE_DEL).any()
    jres = JBM.replay_mixed(run.stream.ops, capacity=512, batch=8,
                            block_k=256, chunk=1024, interpret=True)
    assert_blocked_equal(jres, run.result)
    with pytest.raises(ValueError, match="unknown engine"):
        storm.make_storm_replayer(None, engine="flat", device="cpu")


def test_storm_cli_blocked_mixed(capsys):
    assert storm.main(["--rounds", "4", "--batch", "2", "--device", "cpu",
                       "--engine", "blocked-mixed"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and '"ok": true' in out[0]
    assert '"engine": "blocked-mixed"' in out[0]


def test_insert_after_an_absent_order_flags_err2():
    """A remote insert whose origin-left no item has: the left cursor's
    search of the whole state misses (``err[2]``) and clamps the cursor
    past the end; the post-error state is the JAX kernel's."""
    jops = compile_txns(_interleaved()[:12], lmax=4)
    fields = {f.name: np.asarray(getattr(jops, f.name)).copy()
              for f in dataclasses.fields(jops)}
    last = int(np.nonzero(fields["kind"] == JB.KIND_REMOTE_INS)[0][-1])
    fields["origin_left"][last] = 300
    jres, tres = _both(JB.OpTensors(**fields), 512, 16)
    err = tres.err.numpy()
    assert err[2].all() and not err[0].any() and not err[1].any()


# -- the CUDA kernel's windowed conflict scan, modelled on the CPU -------------

NONE, BRK, RESET, SET, UNKNOWN = range(5)


def _lowest(mask):
    return (mask & -mask).bit_length() - 1


def windowed_cursor(m, my_rank, o_left, o_right, width=32, trace=None):
    """The raw cursor a remote insert lands at, decided as
    ``blocked_mixed_replay.cu`` decides it: over ``m``'s ``raw_view``,
    ``width`` positions at a time, each position's flag computed on its
    own (the serial rule's break, a won tie that resets the scan, a lost
    tie that may pin ``scan_start``, or unknown when the item's
    origin-left is not in the view), the first break or unknown found by
    a mask, and the ties before it applied in order: after the last won
    tie, the first lost one pins ``scan_start``. An unknown position
    takes the serial step. Reads ``m`` and changes nothing. ``trace``,
    when a list, receives ``(window start, scanning, scan_start)`` after
    every window that ran to its end with more positions after it."""
    raw, _block, where = m.raw_view()
    n = len(raw)

    def cursor_after(o):
        if o == -1:
            return 0
        if 0 <= o < len(where) and where[o] >= 0:
            return where[o] + 1
        hit = ((m.sig == o + 1) | (m.sig == -(o + 1))).any(dim=1)
        rows = hit.nonzero()
        g = int(rows[0, 0]) if rows.numel() else m.CAP
        return m.raw_before_block(g // m.K) + g % m.K + 1

    lc = cursor_after(o_left)

    def origins(p):
        other = abs(raw[p]) - 1
        return other, [m.tab_read(t, other) for t in (m.oll, m.orl, m.rkl)]

    def flag(p):
        other, (left, right, rank) = origins(p)
        if left != -1 and not (0 <= left < len(where) and where[left] >= 0):
            return UNKNOWN
        olc = 0 if left == -1 else where[left] + 1
        cut = other == o_right or olc < lc
        eq = not cut and olc == lc
        gt = my_rank > rank
        if cut or (eq and not gt and o_right == right):
            return BRK
        if not eq:
            return NONE
        return RESET if gt else SET

    cursor = scan_start = lc
    scanning = False
    while cursor < n:
        flags = [flag(p) for p in range(cursor, min(cursor + width, n))]
        masks = {f: sum(1 << i for i, x in enumerate(flags) if x == f)
                 for f in (BRK, RESET, SET, UNKNOWN)}
        stop = masks[BRK] | masks[UNKNOWN]
        lim = _lowest(stop) if stop else len(flags)
        below = (1 << lim) - 1
        reset, lost = masks[RESET] & below, masks[SET] & below
        if reset:
            after = lost >> reset.bit_length() << reset.bit_length()
            scanning = after != 0
            if after:
                scan_start = cursor + _lowest(after)
        elif lost and not scanning:
            scanning, scan_start = True, cursor + _lowest(lost)
        base, cursor = cursor, cursor + lim
        if not stop:
            if trace is not None and cursor < n:
                trace.append((base, scanning, scan_start))
            continue
        if flags[lim] == BRK:
            break
        # The serial step at an unknown position, the whole-state search.
        other, (left, right, rank) = origins(cursor)
        olc = cursor_after(left)
        brk = other == o_right or olc < lc
        eq = not brk and olc == lc
        gt = my_rank > rank
        brk = brk or (eq and not gt and o_right == right)
        if eq and not gt and o_right != right and not scanning:
            scan_start = cursor
        if eq:
            scanning = False if gt else (
                scanning if o_right == right else True)
        if brk:
            break
        cursor += 1
    return scan_start if scanning else cursor


def _windowed_checks(monkeypatch, ops, capacity, block_k, edit=None):
    """Replays ``ops`` with the plain version, holding ``windowed_cursor``
    equal to ``integrate_cursor`` before every remote insert. Returns the
    inserts checked and the windows that ended with a tie run open."""
    seen, crossings = [], []

    class Checked(TBM._MixedOps):
        def integrate_cursor(self, my_rank, o_left, o_right):
            want = windowed_cursor(self, my_rank, o_left, o_right,
                                   trace=crossings)
            got = super().integrate_cursor(my_rank, o_left, o_right)
            assert got == want, (len(seen), got, want)
            seen.append(got)
            return got

    monkeypatch.setattr(TBM, "_MixedOps", Checked)
    rep = TBM.make_replayer_mixed(ops, capacity, batch=1, block_k=block_k,
                                  chunk=128, device="cpu")
    staged = rep.staged
    if edit is not None:
        oll = staged[9].clone()
        edit(oll)
        staged = staged[:9] + (oll,) + staged[10:]
    TBM.blocked_mixed_replay_plain(*staged, **rep.shape)
    return len(seen), [c for c in crossings if c[1]]


def _absent_left(oll):
    oll[5] = 70000  # past the tables
    oll[9] = 100    # inside them, no such item


def _storm_ops(peers, rounds, run_len, del_prob=0.0):
    return storm.make_storm_stream(peers, rounds, run_len, seed=7,
                                   del_prob=del_prob).ops


# name -> (ops, capacity, block_k, table edit, pinned runs past a window)
WINDOW_CASES = {
    "storm-4x10": lambda: (_storm_ops(4, 10, 2), 256, 16, None, False),
    "storm-16x20": lambda: (_storm_ops(16, 20, 4), 4096, 32, None, False),
    "delete-storm-6x20": lambda: (_storm_ops(6, 20, 3, 0.3), 1024, 16, None,
                                  False),
    "storm-40x3": lambda: (_storm_ops(40, 3, 1), 512, 16, None, False),
    "storm-48x4": lambda: (_storm_ops(48, 4, 2), 1024, 32, None, False),
    "tie-runs-past-32": lambda: (port_ops(compile_txns(_tie_runs())), 256,
                                 16, None, True),
    "absent-origin-left": lambda: (_storm_ops(4, 10, 2), 256, 16,
                                   _absent_left, False),
}


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_windowed_scan_equals_integrate_cursor(monkeypatch, name):
    ops, cap, k, edit, pinned = WINDOW_CASES[name]()
    inserts = int((np.asarray(ops.kind) == JB.KIND_REMOTE_INS).sum())
    checked, open_runs = _windowed_checks(monkeypatch, ops, cap, k, edit)
    assert checked == inserts > 0
    if pinned:
        # A tie run with scan_start pinned crosses a window boundary.
        assert open_runs


def test_window_width_does_not_change_the_cursor(monkeypatch):
    """The decision is the serial rule's at any window width: 1 (the
    serial walk itself), 7 and 32 agree on every insert of a storm."""
    sst = storm.make_storm_stream(40, 2, 1, seed=3)
    widths = []

    class Checked(TBM._MixedOps):
        def integrate_cursor(self, my_rank, o_left, o_right):
            widths.append({windowed_cursor(self, my_rank, o_left, o_right,
                                           width=w) for w in (1, 7, 32)})
            return super().integrate_cursor(my_rank, o_left, o_right)

    monkeypatch.setattr(TBM, "_MixedOps", Checked)
    rep = TBM.make_replayer_mixed(sst.ops, 256, batch=1, block_k=16,
                                  chunk=128, device="cpu")
    TBM.blocked_mixed_replay_plain(*rep.staged, **rep.shape)
    assert widths and all(len(w) == 1 for w in widths)


# -- the CUDA wrapper's limits (checked before any build or launch) ----------


def test_kernel_takes_k_up_to_2048_and_names_the_shared_memory_limit(
        monkeypatch):
    """K = 4,096 (and every K whose document fits) passes the wrapper's
    checks and reaches the build; a document past the limit is refused,
    naming the bytes."""
    from text_crdt_rust_tpu_torch.ops.blocked import SMEM_LIMIT

    class Reached(Exception):
        pass

    def reached(*args, **kw):
        raise Reached

    col = torch.zeros(4, dtype=torch.int32)
    tab = torch.zeros(8 * 128, dtype=torch.int32)
    shape = dict(steps=4, batch=8, capacity=8192, lmax=4, order_rows=8)
    monkeypatch.setattr(TBM._kernels, "function", reached)
    with pytest.raises(Reached):
        TBM.blocked_mixed_replay_cuda(*[col] * 9, tab, tab, tab,
                                      block_k=4096, **shape)
    with pytest.raises(ValueError, match=f"{SMEM_LIMIT} B of shared"):
        TBM.blocked_mixed_replay_cuda(
            *[col] * 9, tab, tab, tab, block_k=2048,
            **dict(shape, capacity=65536))
    # The storm's geometry keeps the view beside the document; a larger
    # document sends it to device memory.
    assert TBM.kernel_smem_bytes(32768, 128, 128, 104 * 128) == (225312,
                                                                 True)
    nbytes, in_smem = TBM.kernel_smem_bytes(49152, 192, 192, 104 * 128)
    assert not in_smem and nbytes <= SMEM_LIMIT
