"""Kernel A1's workload: the bytes and operations a replay cannot do
without, counted from the workload and not from the port's layout.

Bytes: each doc group's five int32 op columns read once (position,
delete length, insert length, first order, rows a step); each document's
final state written once, as the fewest runs that spell it (the
reference's runs, two int32 each: order and length); each inserting
step's two origins written once a document (two int32). Operations: one
a character inserted or deleted, a document. The capacity, the block
size and the blocks the port allocates do not enter.
"""
from __future__ import annotations

COLUMNS = 5
INT = 4


def counts(facts: dict):
    """``(bytes, operations)`` of one replay: ``facts["groups"]`` lists
    each doc group's ``documents``, ``steps``, ``insert_steps``, ``runs``
    (the reference's final runs) and ``char_ops``."""
    nbytes = ops = 0
    for g in facts["groups"]:
        d = g["documents"]
        nbytes += COLUMNS * INT * g["steps"]
        nbytes += d * 2 * INT * g["runs"]
        nbytes += d * 2 * INT * g["insert_steps"]
        ops += d * g["char_ops"]
    return nbytes, ops
