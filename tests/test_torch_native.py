"""The port's native engine (``text_crdt_rust_tpu_torch/models/native.py``
over its own copy of ``tcr_engine.cpp``) against the JAX package's
``models/native.NativeListCRDT`` and against the port's oracle: text,
merged spans, frontier, deletes, double deletes and the next order, all
equal, on seeded local fuzz, seeded remote txn streams (three-peer
histories, two-peer merges, concurrent-insert storms with double
deletes) and the whole sveltecomponent trace; and ``rope_replay`` against
the JAX package's and the plain string splice."""
import dataclasses
import random
from pathlib import Path

import numpy as np
import pytest

from text_crdt_rust_tpu import common as JC
from text_crdt_rust_tpu.common import LocalOp as JLocalOp
from text_crdt_rust_tpu.models import native as JN
from text_crdt_rust_tpu.models.oracle import ListCRDT as JListCRDT
from text_crdt_rust_tpu.models.sync import export_txns_since as j_export
from text_crdt_rust_tpu.models.sync import merge_into as j_merge_into
from text_crdt_rust_tpu.utils.randedit import make_storm as j_make_storm
from text_crdt_rust_tpu_torch import baseline, convert, northstar
from text_crdt_rust_tpu_torch.common import LocalOp
from text_crdt_rust_tpu_torch.models import native as TN
from text_crdt_rust_tpu_torch.models.oracle import ListCRDT
from text_crdt_rust_tpu_torch.native import build as TBUILD
from text_crdt_rust_tpu_torch.utils.randedit import make_two_peer_merge, \
    random_patches
from text_crdt_rust_tpu_torch.utils.testdata import flatten_patches, \
    load_testing_data, trace_path

REPO = Path(__file__).resolve().parent.parent
ALPHABET = "abcdefghijklmnop_"


def observables(doc):
    """Every compared field of a native document."""
    return dict(text=doc.to_string(), len=len(doc), spans=doc.doc_spans(),
                frontier=list(doc.frontier),
                deletes=doc.deletes_entries(),
                double_deletes=doc.double_deletes_entries(),
                next_order=doc.get_next_order())


def oracle_observables(orc):
    return dict(text=orc.to_string(), len=len(orc), spans=orc.doc_spans(),
                frontier=list(orc.frontier),
                deletes=[(e.op_order, e.target, e.length)
                         for e in orc.deletes],
                double_deletes=[(e.target, e.length, e.excess)
                                for e in orc.double_deletes],
                next_order=orc.get_next_order())


def assert_three_equal(tn, jn, orc):
    got = observables(tn)
    assert got == observables(jn)
    assert got == oracle_observables(orc)


def test_source_is_the_jax_package_copy():
    """The port's engine source is the JAX package's, byte for byte but
    for the comment that names the upstream file."""
    ours = Path(TBUILD.SRC).read_text().splitlines()
    theirs = (REPO / "text_crdt_rust_tpu/native/tcr_engine.cpp") \
        .read_text().splitlines()
    assert len(ours) == len(theirs) == 1162
    diff = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    assert diff == [2] and "src/list/doc.rs" in ours[2]
    assert Path(TBUILD.lib_path()).parent.name == "native"
    assert Path(TBUILD.build()).exists()


def test_smoke_matches():
    tn, jn, orc = TN.NativeListCRDT(), JN.NativeListCRDT(), ListCRDT()
    for d in (tn, jn, orc):
        a = d.get_or_create_agent_id("seph")
        d.local_insert(a, 0, "hi")
        d.local_insert(a, 1, "yooo")
        d.local_delete(a, 0, 3)
    assert_three_equal(tn, jn, orc)
    assert tn.get_agent_id("seph") == 0 and tn.get_agent_id("x") is None
    assert tn.memory_bytes() == jn.memory_bytes() > 0
    assert (tn.raw_len(), tn.num_spans()) == (jn.raw_len(), jn.num_spans())


@pytest.mark.parametrize("seed", range(6))
def test_local_fuzz(seed):
    rng = random.Random(seed)
    tn, jn, orc = TN.NativeListCRDT(), JN.NativeListCRDT(), ListCRDT()
    agents = [d.get_or_create_agent_id("seph") for d in (tn, jn, orc)]
    for step in range(300):
        doc_len = len(orc)
        if doc_len == 0 or rng.random() < 0.5:
            pos = rng.randint(0, doc_len)
            op = LocalOp(pos=pos, ins_content="".join(
                rng.choice(ALPHABET) for _ in range(rng.randint(1, 3))))
        elif rng.random() < 0.85:
            pos = rng.randint(0, doc_len - 1)
            op = LocalOp(pos=pos,
                         del_span=rng.randint(1, min(8, doc_len - pos)))
        else:
            pos = rng.randint(0, doc_len - 1)
            op = LocalOp(pos=pos, del_span=rng.randint(
                1, min(4, doc_len - pos)), ins_content="".join(
                rng.choice(ALPHABET) for _ in range(rng.randint(1, 2))))
        tn.apply_local_txn(agents[0], [op])
        jn.apply_local_txn(agents[1], [JLocalOp(
            pos=op.pos, ins_content=op.ins_content, del_span=op.del_span)])
        orc.apply_local_txn(agents[2], [op])
        if step % 41 == 0:
            assert_three_equal(tn, jn, orc)
    assert_three_equal(tn, jn, orc)
    orc.check()


def three_peer_txns(seed: int):
    """A concurrent three-peer history made with the JAX package's oracle
    (fragmented deletes, double deletes, cross merges), exported from
    peer 0."""
    rng = random.Random(5000 + seed)
    peers = []
    for nm in ("alice", "bob", "carol"):
        d = JListCRDT()
        d.get_or_create_agent_id(nm)
        peers.append(d)
    for _ in range(10):
        for d in peers:
            for _ in range(rng.randint(1, 3)):
                doc_len = len(d)
                if doc_len == 0 or rng.random() < 0.55:
                    d.local_insert(0, rng.randint(0, doc_len), "".join(
                        rng.choice(ALPHABET)
                        for _ in range(rng.randint(1, 2))))
                else:
                    pos = rng.randint(0, doc_len - 1)
                    d.local_delete(0, pos,
                                   rng.randint(1, min(6, doc_len - pos)))
        i, j = rng.sample(range(3), 2)
        j_merge_into(peers[i], peers[j])
        j_merge_into(peers[j], peers[i])
    for _ in range(2):
        for i in range(3):
            for j in range(3):
                if i != j:
                    j_merge_into(peers[i], peers[j])
    return j_export(peers[0], 0), peers[0].to_string()


def jax_txns(txns):
    """The JAX package's ``RemoteTxn``s of the port's."""
    def rid(r):
        return JC.RemoteId(agent=r.agent, seq=r.seq)

    def op(o):
        if hasattr(o, "ins_content"):
            return JC.RemoteIns(origin_left=rid(o.origin_left),
                                origin_right=rid(o.origin_right),
                                ins_content=o.ins_content)
        return JC.RemoteDel(id=rid(o.id), len=o.len)

    return [JC.RemoteTxn(id=rid(t.id), parents=[rid(p) for p in t.parents],
                         ops=[op(o) for o in t.ops]) for t in txns]


def remote_case(kind: str, key: int):
    """(JAX txns, the text they must give) of one remote scenario."""
    if kind == "peers":
        return three_peer_txns(key)
    if kind == "merge":
        txns, receiver = make_two_peer_merge(400 + key)
        return jax_txns(txns), receiver.to_string()
    # Concurrent inserts at one origin (the name tiebreak); with deletes,
    # peers delete spans others deleted too (double deletes).
    txns, receiver = j_make_storm(6, 12, 3, seed=key,
                                  del_prob=0.35 if kind == "dstorm" else 0)
    return txns, receiver.to_string()


@pytest.mark.parametrize("kind,key", [("peers", s) for s in range(4)]
                         + [("merge", s) for s in range(3)]
                         + [("storm", 7), ("dstorm", 7), ("dstorm", 11)])
def test_remote_streams(kind, key):
    jtxns, want = remote_case(kind, key)
    ttxns = convert.txns_from_dicts([dataclasses.asdict(t) for t in jtxns])
    tn, jn, orc = TN.NativeListCRDT(), JN.NativeListCRDT(), ListCRDT()
    for jt, tt in zip(jtxns, ttxns):
        tn.apply_remote_txn(tt)
        jn.apply_remote_txn(jt)
        orc.apply_remote_txn(tt)
    assert tn.to_string() == want
    assert_three_equal(tn, jn, orc)
    if kind == "dstorm":
        assert tn.double_deletes_entries(), "the storm double-deletes"
    assert baseline.native_remote_replay(ttxns).to_string() == want


def test_remote_refusals():
    """An unknown origin or delete target is refused, as in the JAX
    package."""
    jtxns, _ = remote_case("merge", 0)
    ttxns = convert.txns_from_dicts([dataclasses.asdict(t) for t in jtxns])
    late = [t for t in ttxns if t.id.agent == "bob"][-1]
    for mod in (TN, JN):
        doc = mod.NativeListCRDT()
        txn = late if mod is TN else jtxns[ttxns.index(late)]
        with pytest.raises(AssertionError):
            doc.apply_remote_txn(txn)


def test_sveltecomponent_trace():
    data = load_testing_data(trace_path("sveltecomponent"))
    patches = flatten_patches(data)
    tn = baseline.native_replay(patches)
    jn = JN.NativeListCRDT()
    jn.replay_trace(jn.get_or_create_agent_id("bench"),
                    *baseline.patch_lists(patches))
    assert tn.to_string() == data.end_content
    assert observables(tn) == observables(jn)
    assert tn.memory_bytes() == jn.memory_bytes()
    # The trace through the oracle, patch by patch, gives the same state.
    orc = ListCRDT(capacity=1024)
    a = orc.get_or_create_agent_id("bench")
    for p in patches:
        orc.apply_local_txn(a, [LocalOp(p.pos, p.ins_content, p.del_len)])
    assert observables(tn) == oracle_observables(orc)


@pytest.mark.parametrize("seed", range(4))
def test_rope_replay(seed):
    patches, content = random_patches(random.Random(seed), 600)
    cols = baseline.patch_columns(patches)
    assert TN.rope_replay(*cols) == JN.rope_replay(*cols) \
        == (len(content), content)
    assert content == northstar.apply_patches(patches)
    assert TN.rope_replay(*cols, want_content=False) == (len(content), None)
    assert baseline.rope_text(cols) == content


def test_rope_replay_refuses_a_bad_patch():
    for mod in (TN, JN):
        with pytest.raises(RuntimeError, match="out of range"):
            mod.rope_replay([5], [0], [1], np.asarray([65], np.uint32))
    # A delete-and-insert patch that grows the buffer (the JAX package's
    # regression case).
    cps = np.frombuffer(("a" * 4096 + "b" * 10).encode("utf-32-le"),
                        np.uint32)
    assert TN.rope_replay([0, 0], [0, 2], [4096, 10], cps) == \
        (4104, "b" * 10 + "a" * 4094)
