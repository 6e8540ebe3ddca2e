"""What an entry adapter hands the harness: the call the window drives,
and what the judge and the readers need to read its outputs."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import numpy as np


@dataclasses.dataclass
class Entry:
    replay: Callable[[], Any]        # one replay: the call the window makes
    results: Callable[[Any], list]   # its outputs, one set a doc group
    steps: List[Tuple[np.ndarray, np.ndarray]]  # each group's step columns
    #                                  (first order, inserted length)
    documents: int                   # documents one replay materialises
    counters: dict                   # the program's own counts, read once
