"""Seeded random edits in the mix of upstream's ``make_random_change``
(text-crdt-rust ``src/list/doc.rs:544-569``, transcribed in the repo's
``tests/test_oracle.py``), drawn from ``random.Random`` against a plain
string instead of the document. While the text is shorter than
``short_len`` characters a patch inserts with probability
``ins_weight[0]``, after that with ``ins_weight[1]``, and always while
the text is empty. An insert puts 1 to ``max_ins`` characters of
``alphabet`` at a uniform position in [0, len]; a delete removes 1 to
min(``max_del``, len - pos) characters from a uniform position in
[0, len). The whole stream comes from the seed."""
from __future__ import annotations

import random

from portbench.generators.history import History, Patch


def random_change(rng: random.Random, patches: int, ins_weight=(0.55, 0.45),
                  short_len: int = 100, max_ins: int = 3, max_del: int = 10,
                  alphabet: str = "abcdefghijklmnop_") -> History:
    text = ""
    out = []
    for _ in range(patches):
        n = len(text)
        weight = ins_weight[0] if n < short_len else ins_weight[1]
        if n == 0 or rng.random() < weight:
            pos = rng.randint(0, n)
            ins = "".join(rng.choice(alphabet)
                          for _ in range(rng.randint(1, max_ins)))
            out.append(Patch(pos, 0, ins))
            text = text[:pos] + ins + text[pos:]
        else:
            pos = rng.randint(0, n - 1)
            span = rng.randint(1, min(max_del, n - pos))
            out.append(Patch(pos, span, ""))
            text = text[:pos] + text[pos + span:]
    return History(patches=out, text=text)


def make(params: dict, seed: int) -> History:
    return random_change(random.Random(seed), params["patches"],
                         tuple(params["ins_weight"]), params["short_len"],
                         params["max_ins"], params["max_del"],
                         params["alphabet"])
