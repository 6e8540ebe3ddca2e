"""Faults planted under the timed path, and the control: each turns one
replay's outputs (one result set a doc group, the port's ``RleResult``)
into what a broken program would return. ``correct`` has to come out
false for every one (``tests/test_portbench_faults.py``, and on the card
``python3 -m portbench.control``).

- ``unchanged``: a step that returns its state unchanged: every document
  as the replay found it (empty), no origins.
- ``half_batch``: half of the documents left out: their columns as
  allocated (zero).
- ``altered_state``: one run of one document altered where it is
  produced (its length one longer).
- ``altered_origin``: one origin of one document altered.
- ``control``: the plain reference put in the program's place and
  computed with every order held in 16 bits, the step below the 32-bit
  orders the configuration states (packing the planes into int16 is the
  step that would tempt a later change).

The exchange between chips cannot be left out: no cell spans chips.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.splice import Expected


def _replace(res, **fields):
    return dataclasses.replace(res, **fields)


def unchanged(results):
    out = []
    for r in results:
        z = torch.zeros_like
        meta = z(r.meta)
        meta[0] = 1
        out.append(_replace(r, ordp=z(r.ordp), lenp=z(r.lenp),
                            blkord=z(r.blkord), rows=z(r.rows), meta=meta,
                            ol=z(r.ol), orr=z(r.orr), err=z(r.err)))
    return out


def half_batch(results):
    out = []
    for r in results:
        half = r.ordp.shape[1] // 2
        fields = {}
        for name in ("ordp", "lenp", "blkord", "rows", "meta", "ol", "orr"):
            t = getattr(r, name).clone()
            t[:, half:] = 0
            fields[name] = t
        out.append(_replace(r, **fields))
    return out


def altered_state(results):
    r = results[-1]
    lane = r.ordp.shape[1] - 1
    b = int(r.blkord[0, lane])
    lenp = r.lenp.clone()
    lenp[b * r.block_k, lane] += 1
    return results[:-1] + [_replace(r, lenp=lenp)]


def altered_origin(results):
    r = results[-1]
    ol = r.ol.clone()
    ins = torch.nonzero((r.ol != 0).any(1)).flatten()
    k = int(ins[-1]) if len(ins) else ol.shape[0] - 1
    ol[k, 0] ^= 1
    return results[:-1] + [_replace(r, ol=ol)]


def lower_precision(exp: Expected) -> Expected:
    """The reference's document and origins with every order held in 16
    bits: what the same splice computes when its orders are int16
    (orders past 32,767 wrap)."""
    o16 = ((np.abs(exp.signed) - 1).astype(np.int16) + np.int16(1)) \
        .astype(np.int16)
    signed = np.where(exp.signed > 0, o16, -o16).astype(np.int16)
    return dataclasses.replace(
        exp, signed=signed.astype(np.int64),
        ol=exp.ol.astype(np.int16).astype(np.uint32),
        orr=exp.orr.astype(np.int16).astype(np.uint32))


def as_outputs(exp: Expected, template, steps):
    """``exp`` written in A1's output layout, in place of the program's
    outputs ``template`` (one doc group): its runs in whole blocks from
    slot 0 (more blocks than the template's where they do not fit), every
    document the same, and each inserting step's origins from ``exp`` at
    the step's first order."""
    starts, lens = exp.runs()
    K = int(template.block_k)
    M = len(starts)
    NB = max(int(template.num_blocks), -(-M // K))
    CAP = K * NB
    dev = template.ordp.device
    B = template.ordp.shape[1]
    nb = max(1, -(-M // K))

    def col(values, rows, dtype=torch.int32):
        c = torch.zeros(rows, dtype=dtype)
        c[:len(values)] = torch.from_numpy(np.asarray(values)).to(dtype)
        return c.to(dev)[:, None].expand(rows, B)

    nbl = max(template.blkord.shape[0], NB)
    rows = [K] * (nb - 1) + [M - (nb - 1) * K]
    start, ilen = steps
    heads = np.asarray(start)[np.asarray(ilen) > 0]
    ol = np.zeros(len(start), np.int64)
    orr = np.zeros(len(start), np.int64)
    ol[np.asarray(ilen) > 0] = exp.ol[heads].view(np.int32)
    orr[np.asarray(ilen) > 0] = exp.orr[heads].view(np.int32)
    meta = torch.zeros_like(template.meta)
    meta[0] = nb
    return _replace(
        template, ordp=col(starts, CAP), lenp=col(lens, CAP),
        blkord=col(np.arange(nb), nbl), rows=col(rows, nbl), meta=meta,
        ol=col(ol, len(start)), orr=col(orr, len(start)),
        err=torch.zeros_like(template.err), num_blocks=NB)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_state": altered_state, "altered_origin": altered_origin}
