"""A1's workload bytes and operations from shapes alone."""
from portbench.roofline import a1


def test_counts_from_shapes():
    facts = {"groups": [
        {"documents": 512, "steps": 7352, "insert_steps": 5000,
         "runs": 12487, "char_ops": 259778}] * 20}
    nbytes, ops = a1.counts(facts)
    assert nbytes == 20 * (5 * 4 * 7352 + 512 * 8 * 12487 + 512 * 8 * 5000)
    assert ops == 10240 * 259778


def test_counts_do_not_depend_on_the_layout():
    g = {"documents": 4, "steps": 10, "insert_steps": 6, "runs": 7,
         "char_ops": 30}
    assert a1.counts({"groups": [dict(g, capacity=512, block_k=32)]}) == \
        a1.counts({"groups": [dict(g, capacity=4096, block_k=128)]})
