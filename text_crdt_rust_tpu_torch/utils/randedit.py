"""Seeded synthetic edit streams for tests and the chip smoke run (the
port's counterpart of ``text_crdt_rust_tpu/utils/randedit.py``, drawn
from numpy generators so one seed gives both packages the same input).

``random_patches`` is the `make_random_change` analog (`doc.rs:544-569`):
each step inserts 1..max_ins chars at a random position or deletes
1..max_del chars, tracked against a plain string. ``prepend_bursts``
adds the backwards-contiguous insert bursts (the kevin prepend shape)
that W-row step fusion compiles into fused steps.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .testdata import TestPatch

ALPHABET = "abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ.,\n"


def _text(rng: np.random.Generator, n: int) -> str:
    return "".join(ALPHABET[i] for i in rng.integers(0, len(ALPHABET), n))


def random_patches(
    rng: np.random.Generator,
    steps: int,
    ins_prob: float = 0.6,
    max_ins: int = 5,
    max_del: int = 4,
) -> Tuple[List[TestPatch], str]:
    """Seeded random edit stream, tracked against a plain string."""
    content = ""
    patches = []
    for _ in range(steps):
        if not content or rng.random() < ins_prob:
            pos = int(rng.integers(0, len(content) + 1))
            ins = _text(rng, int(rng.integers(1, max_ins + 1)))
            patches.append(TestPatch(pos, 0, ins))
            content = content[:pos] + ins + content[pos:]
        else:
            pos = int(rng.integers(0, len(content)))
            span = min(int(rng.integers(1, max_del + 1)), len(content) - pos)
            patches.append(TestPatch(pos, span, ""))
            content = content[:pos] + content[pos + span:]
    return patches, content


def prepend_bursts(
    rng: np.random.Generator,
    bursts: int,
    max_burst: int = 12,
    max_run: int = 3,
    del_prob: float = 0.3,
) -> Tuple[List[TestPatch], str]:
    """Seeded stream of backwards insert bursts: each burst types
    2..max_burst equal-length runs at ONE position (each landing before
    the previous), separated now and then by a random delete."""
    content = ""
    patches = []
    for _ in range(bursts):
        if content and rng.random() < del_prob:
            pos = int(rng.integers(0, len(content)))
            span = min(int(rng.integers(1, 5)), len(content) - pos)
            patches.append(TestPatch(pos, span, ""))
            content = content[:pos] + content[pos + span:]
        pos = int(rng.integers(0, len(content) + 1))
        run = int(rng.integers(1, max_run + 1))
        for _ in range(int(rng.integers(2, max_burst + 1))):
            ins = _text(rng, run)
            patches.append(TestPatch(pos, 0, ins))
            content = content[:pos] + ins + content[pos:]
    return patches, content
