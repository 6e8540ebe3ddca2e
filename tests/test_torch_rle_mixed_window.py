"""A plain-Python model of the CUDA kernel's fast YATA scan
(``ops/csrc/rle_mixed_replay.cu``: one pass over the window's blocks
only) held equal to the plain ``integrate_fast`` of
``ops/rle_mixed.py`` on every remote insert of seeded storms.

The plain scan classifies every row of the planes, keyed by the row's
logical slot from the ``lpp`` plane, and reduces three times. The
kernel keeps no ``lpp`` plane: every row of an allocated block holds its
block's current slot there, so the window (keys strictly between the
cursor's and o_right's) lies in the blocks ``blkord[l0..lT]``, a row of
slot l keyed l*K + row. It visits those rows once in key order, stops at
the first row that defeats the scan (the serial walk then decides), and
takes the first breaking sibling (kfb), the last lower-ranked sibling
before it (kll) and the first higher-ranked different-o_right sibling
after kll and before kfb (kss) as it goes.

Each test replays a storm with the plain version, its state subclassed so
that before every fast scan the model runs on the same state: the flag
must agree, and the cursor too where the flag is clear. The ``lpp``
invariant is checked directly at every scan. The plain version itself is
unchanged. Tolerance: none, the state is integers.
"""
import numpy as np
import pytest

from text_crdt_rust_tpu_torch import storm
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import rle_mixed as TRM

ROOT_I = TRM.ROOT_I


def window_scan(st, cursor0, my_rank, o_left, o_right):
    """The kernel's rule on the plain state ``st`` (lane 0): returns
    (cursor, flag, blocks the window spans)."""
    K = st.K
    BIGK = st.NBL * K + K
    n = st.total_of(st.cumraw)
    tpos = n if o_right == ROOT_I else st.pos_of_order(o_right)
    l0, _b0, i0, o_r0, _l_r0, off0 = st.run_at2(cursor0)
    key_lo = l0 * K + i0 - (1 if off0 == 0 else 0)
    key_hi = BIGK
    if tpos < n:
        lT, _bT, iT, _o, _l, offT = st.run_at2(tpos)
        key_hi = lT * K + iT + (0 if offT == 0 else 1)
    lo = key_lo + 1
    kfb, kll, kss, found, span = BIGK, -1, BIGK, False, 0
    if key_hi > lo:
        l_a, l_b = lo // K, min(st.nlog - 1, (key_hi - 1) // K)
        span = max(l_b - l_a + 1, 0)
        for l in range(l_a, l_b + 1):
            b = int(st.blkord[l, 0])
            rows = slice(b * K, (b + 1) * K)
            O, L = st.ordp[rows, 0].tolist(), st.lenp[rows, 0].tolist()
            OLP, ORP = st.olp[rows, 0].tolist(), st.orp[rows, 0].tolist()
            RKP = st.rkp[rows, 0].tolist()
            for r in range(max(0, lo - l * K), min(K, key_hi - l * K)):
                o = O[r]
                if o == 0:
                    continue
                key, h = l * K + r, abs(o) - 1
                olv, orv, rk = OLP[r], ORP[r], RKP[r]
                sib = olv == o_left
                chain = (not sib and h > 0 and olv == h - 1 and r > 0
                         and abs(O[r - 1]) - 1 + L[r - 1] - 1 == h - 1)
                if (not sib and not chain) or (
                        sib and (rk == my_rank or orv == -2)):
                    return None, True, span
                if found or not sib:
                    continue
                if rk > my_rank and orv == o_right:
                    kfb, found = key, True
                elif rk > my_rank:
                    if kss == BIGK:
                        kss = key
                else:
                    kll, kss = key, BIGK
    # The mid-run start and the cursor, as the plain scan takes them.
    kP = key_lo
    if off0 > 0 and cursor0 < tpos:
        order0 = min(max(abs(o_r0) - 1 + off0, 0), st.OT * TRM.LANES - 1)
        p_or, p_rk = int(st.orl[order0]), int(st.rkl[order0])
        p_gt = p_rk > my_rank
        if p_rk == my_rank:
            return None, True, span
        if p_gt and p_or == o_right:
            kfb = kP
        if not p_gt and kP < kfb and kll < 0:
            kll = kP
        if p_gt and p_or != o_right and kll < kP < kfb:
            kss = kP
    kwin = kss if kss < kfb else kfb
    if kwin >= BIGK:
        return tpos, False, span
    if kwin == kP:
        return cursor0, False, span
    l_w = min(max(kwin // K, 0), st.NBL - 1)
    b_w = int(st.blkord[l_w, 0])
    head = int(st.lenp[b_w * K:b_w * K + kwin % K, 0].sum())
    return st.sum_before_slot(st.raw, l_w) + head, False, span


def _lpp_holds(st):
    """Every row of every allocated block holds its block's slot."""
    K = st.K
    for l in range(st.nlog):
        b = int(st.blkord[l, 0])
        if not bool((st.lpp[b * K:(b + 1) * K, 0] == l).all()):
            return False
    return bool((st.ordp[st.nlog * K:] == 0).all())


def _checked_replay(monkeypatch, ops, capacity, block_k):
    seen = []

    class Checked(TRM._PlainMixed):
        def integrate_fast(self, cursor0, my_rank, o_left, o_right):
            assert _lpp_holds(self)
            want, want_flag, span = window_scan(self, cursor0, my_rank,
                                                o_left, o_right)
            got, flag = super().integrate_fast(cursor0, my_rank, o_left,
                                               o_right)
            assert flag == want_flag, len(seen)
            if not flag:
                assert got == want, (len(seen), got, want)
            seen.append((span, flag))
            return got, flag

    monkeypatch.setattr(TRM, "_PlainMixed", Checked)
    rep = TRM.make_replayer_rle_mixed(ops, capacity=capacity, batch=1,
                                      block_k=block_k, chunk=128,
                                      device="cpu")
    outs = TRM.rle_mixed_replay_plain(*rep.staged, **rep.shape)
    assert int(outs[7].max()) == 0
    return seen


def _storm(peers, rounds, run_len, del_prob, seed=7):
    return storm.make_storm_stream(peers, rounds, run_len, seed=seed,
                                   del_prob=del_prob).ops


# name -> (ops, block_k, the most blocks a window must span at least once)
WINDOW_CASES = {
    "insert-storm-16x40-k32": lambda: (_storm(16, 40, 4, 0.0), 32, 2),
    "delete-storm-16x40-k32": lambda: (_storm(16, 40, 4, 0.35), 32, 2),
    "delete-storm-16x100-k128": lambda: (_storm(16, 100, 4, 0.35), 128, 2),
    "multiblock-storm-16x40-k8": lambda: (_storm(16, 40, 4, 0.35, 11), 8,
                                          8),
    "storm-40x3-k8": lambda: (_storm(40, 3, 1, 0.0), 8, 4),
}


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_window_scan_equals_integrate_fast(monkeypatch, name):
    ops, k, most = WINDOW_CASES[name]()
    seen = _checked_replay(monkeypatch, ops, storm.storm_capacity(ops, k), k)
    inserts = int((np.asarray(ops.kind) == TB.KIND_REMOTE_INS).sum())
    assert len(seen) == inserts > 0
    assert max(span for span, _ in seen) >= most
    assert not all(flag for _, flag in seen)


def test_window_scan_sees_no_rows_outside_allocated_blocks(monkeypatch):
    """The rows a window may hold lie in allocated blocks: after a storm
    with splits, every row of the unallocated ones is empty and every
    allocated block's lpp rows name its slot."""
    ops = _storm(16, 40, 4, 0.35, 11)
    state = {}

    class Kept(TRM._PlainMixed):
        def __init__(self, *args):
            super().__init__(*args)
            state["st"] = self

    monkeypatch.setattr(TRM, "_PlainMixed", Kept)
    rep = TRM.make_replayer_rle_mixed(ops, capacity=storm.storm_capacity(
        ops, 8), batch=1, block_k=8, chunk=128, device="cpu")
    TRM.rle_mixed_replay_plain(*rep.staged, **rep.shape)
    st = state["st"]
    assert st.nlog > 8 and _lpp_holds(st)
