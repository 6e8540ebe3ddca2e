"""The history a generator hands to both sides: the patches in order and
the text they must end with."""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Patch:
    """Delete ``del_len`` characters at ``pos``, then insert
    ``ins_content`` at ``pos`` (positions in characters)."""

    pos: int
    del_len: int
    ins_content: str


@dataclasses.dataclass
class History:
    patches: List[Patch]
    text: str             # what the patches leave, stated by the source

    @property
    def inserted(self) -> int:
        return sum(len(p.ins_content) for p in self.patches)

    @property
    def deleted(self) -> int:
        return sum(p.del_len for p in self.patches)
