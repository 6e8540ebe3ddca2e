"""The reference against a plain list splice, character by character,
and against the plain string splice's text."""
import random

import numpy as np
import pytest

from portbench.generators import random_change, trace
from portbench.reference import splice


def naive(patches):
    """Every character as [order, live, ol, or] in one Python list."""
    doc, origins, nxt = [], {}, 0

    def live_index(p):          # list index of the p-th live char (1-based)
        seen = 0
        for i, c in enumerate(doc):
            seen += c[1]
            if c[1] and seen == p:
                return i
        raise ValueError("past the end")

    for pt in patches:
        if pt.del_len:
            i = live_index(pt.pos + 1)
            left = pt.del_len
            while left:
                if doc[i][1]:
                    doc[i][1] = False
                    left -= 1
                i += 1
        nxt += pt.del_len
        if pt.ins_content:
            at = 0 if pt.pos == 0 else live_index(pt.pos) + 1
            lo = splice.ROOT if pt.pos == 0 else doc[at - 1][0]
            ro = doc[at][0] if at < len(doc) else splice.ROOT
            for k in range(len(pt.ins_content)):
                o = nxt + k
                doc.insert(at + k, [o, True])
                origins[o] = (lo if k == 0 else o - 1, ro)
            nxt += len(pt.ins_content)
    signed = [c[0] + 1 if c[1] else -(c[0] + 1) for c in doc]
    return signed, origins


def _check(patches, text, monkeypatch, chunk):
    monkeypatch.setattr(splice, "CHUNK", chunk)
    exp = splice.replay(patches)
    signed, origins = naive(patches)
    assert exp.text == text
    assert exp.signed.tolist() == signed
    ins = np.flatnonzero(exp.inserted)
    assert sorted(origins) == ins.tolist()
    assert [(int(exp.ol[o]), int(exp.orr[o])) for o in ins] == \
        [origins[o] for o in ins]
    starts, lens = exp.runs()
    assert int(lens.sum()) == len(signed)
    expand = np.concatenate([np.sign(s) * (abs(s) + np.arange(n))
                             for s, n in zip(starts, lens)])
    assert expand.tolist() == signed


@pytest.mark.parametrize("seed", [1, 2, 3, 2**40 + 9])
@pytest.mark.parametrize("chunk", [2, 7, 1024])
def test_random_streams(seed, chunk, monkeypatch):
    h = random_change.random_change(random.Random(seed), 400)
    _check(h.patches, h.text, monkeypatch, chunk)


@pytest.mark.parametrize("name,n", [("automerge-paper", 3000),
                                    ("rustcode", 1500),
                                    ("sveltecomponent", 2500)])
def test_trace_prefixes(name, n, monkeypatch):
    h = trace.make({"trace": name, "patches": n}, seed=0)
    _check(h.patches, h.text, monkeypatch, 16)


def test_whole_trace_text():
    h = trace.make({"trace": "sveltecomponent"}, seed=0)
    exp = splice.replay(h.patches)
    assert exp.text == h.text
    assert len(exp.signed) == h.inserted
