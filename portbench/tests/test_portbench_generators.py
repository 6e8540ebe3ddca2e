"""The frozen generators: the trace loader draws what the port's own
loader draws; the random changes follow upstream's mix and stay frozen."""
import hashlib
import random

import pytest

from portbench.generators import random_change, trace
from text_crdt_rust_tpu_torch.utils import testdata


def _splice(patches):
    s = ""
    for p in patches:
        s = s[:p.pos] + p.ins_content + s[p.pos + p.del_len:]
    return s


@pytest.mark.parametrize("seed", [0, 42, 7000, 2**33 + 5])
def test_random_change_follows_upstreams_mix(seed):
    h = random_change.random_change(random.Random(seed), 3000)
    assert h.text == _splice(h.patches)
    n = 0
    ins = {True: [0, 0], False: [0, 0]}   # short text: [inserts, patches]
    for p in h.patches:
        assert (p.del_len == 0) != (p.ins_content == "")
        if p.ins_content:
            assert 1 <= len(p.ins_content) <= 3 and 0 <= p.pos <= n
            assert set(p.ins_content) <= set("abcdefghijklmnop_")
        else:
            assert 0 <= p.pos < n and 1 <= p.del_len <= min(10, n - p.pos)
        if n:
            ins[n < 100][0] += bool(p.ins_content)
            ins[n < 100][1] += 1
        n += len(p.ins_content) - p.del_len
    assert abs(ins[True][0] / ins[True][1] - 0.55) < 0.04


#: The first 16 hex digits of the SHA-256 of seed 7's 20,000 patches.
DIGEST = "90204f1c2e4588fd"


def test_random_change_is_frozen():
    """A change to the generator moves every random-edits cell: this
    digest of seed 7's stream has to be changed with it, on purpose."""
    h = random_change.make({"patches": 20000, "ins_weight": [0.55, 0.45],
                            "short_len": 100, "max_ins": 3, "max_del": 10,
                            "alphabet": "abcdefghijklmnop_"}, seed=7)
    text = "".join(f"{p.pos},{p.del_len},{p.ins_content};"
                   for p in h.patches)
    assert len(h.patches) == 20000
    assert hashlib.sha256(text.encode()).hexdigest()[:16] == DIGEST


@pytest.mark.parametrize("name", ["sveltecomponent", "rustcode"])
def test_trace_loader_matches_the_port(name):
    mine = trace.make({"trace": name}, seed=1)
    data = testdata.load_testing_data(testdata.trace_path(name))
    theirs = testdata.flatten_patches(data)
    assert mine.text == data.end_content
    assert [(p.pos, p.del_len, p.ins_content) for p in mine.patches] == \
        [(p.pos, p.del_len, p.ins_content) for p in theirs]


def test_trace_prefix_text_is_the_plain_splice():
    h = trace.make({"trace": "sveltecomponent", "patches": 500}, seed=3)
    assert len(h.patches) == 500
    assert h.text == _splice(h.patches)
