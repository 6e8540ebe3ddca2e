"""Block-wise read scans for documents larger than device memory
(counterpart of ``text_crdt_rust_tpu/ops/stream_scan.py``).

The run planes ``(±(order+1), len)`` stay on the host, of any length (a
``np.memmap`` works: nothing copies the whole plane), and the read-side
conversions (`README.md:20-26`) stream device-sized tiles through one torch
reduction each on the caller's device, with the scan carry (live characters
before the tile) kept on the host — the B-tree descent (`root.rs:54-88`)
with the top levels replaced by a host-side tile table:

- ``live_total`` and the per-tile carries: one host pass at construction
  (int64), with each tile's order envelope ``[omin, omax)``;
- ``position_of_live_rank``: a host search of the carry table picks the one
  tile that resolves the rank, one in-tile lookup on the device finishes;
  ``(-1, 0)`` when the rank is out of range;
- ``order_to_position``: the tiles whose envelope holds the order are
  searched in turn until the owning run is found; -1 when the order is
  unknown or a tombstone.

A tile goes up once and stays until another tile is needed (a one-entry
upload cache). Tiles are ``tile`` rows; the last pads with empty rows.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .blocked import _require

I32 = torch.int32


def _tile_rank(o: torch.Tensor, ln: torch.Tensor, rank1: int):
    """Resolve 1-based live rank ``rank1`` (known to land in this tile, so
    tile-local arithmetic fits int32) -> (tile-local row, 1-based offset
    within the run), 0-dim tensors."""
    lv = torch.where(o > 0, ln, 0)
    cum = torch.cumsum(lv, 0, dtype=I32)
    row = torch.sum(cum < rank1, dtype=I32)
    return row, rank1 - (cum[row] - lv[row])


def _tile_order(o: torch.Tensor, ln: torch.Tensor, order: int):
    """(found?, tile-local position or -1 when tombstoned), 0-dim tensors.

    A run row covers orders ``[abs(o)-1, abs(o)-1+len)`` (`span.rs:9-13`);
    the position counts live characters strictly before the item within
    this tile (`cursor.rs:147-190`)."""
    start = o.abs() - 1
    hit = (o != 0) & (order >= start) & (order < start + ln)
    lv = torch.where(o > 0, ln, 0)
    cum_before = torch.cumsum(lv, 0, dtype=I32) - lv
    n = o.shape[0]
    first = torch.where(hit, torch.arange(n, device=o.device), n).min()
    row = torch.where(first == n, 0, first)
    found = hit.any()
    live_run = found & (o[row] > 0)
    pos = torch.where(live_run, cum_before[row] + (order - start[row]), -1)
    return found, pos


class StreamedRuns:
    """Read-side scans over host-resident run planes of any length, ``tile``
    rows through the device at a time, on ``device`` (``None`` means CUDA;
    the CPU must be named)."""

    def __init__(self, ordp, lenp, tile: int = 1 << 20, device=None):
        _require(len(ordp) == len(lenp), "plane length mismatch")
        _require(tile >= 1, "tile must be positive")
        self.device = resolve_device(device)
        self.tile = int(tile)
        n = len(ordp)
        self.ntiles = max(1, -(-n // self.tile))
        # The caller's arrays as they are (np.asarray of a memmap is no
        # copy); only the last, partial tile pads, in device_tile().
        self.ordp = np.asarray(ordp)
        self.lenp = np.asarray(lenp)
        # Carry table: live characters BEFORE each tile, and each tile's
        # order envelope, so order lookups skip tiles that cannot hold the
        # order. Host int64; the in-tile cumsums on the device are int32,
        # so each tile's live total must fit int32.
        totals = np.empty(self.ntiles, np.int64)
        self.omin = np.empty(self.ntiles, np.int64)
        self.omax = np.empty(self.ntiles, np.int64)
        for t in range(self.ntiles):
            s = t * self.tile
            o = np.asarray(self.ordp[s:s + self.tile], np.int64)
            ln = np.asarray(self.lenp[s:s + self.tile], np.int64)
            totals[t] = int(np.where(o > 0, ln, 0).sum())
            _require(totals[t] < 2 ** 31,
                     f"tile {t} live total {totals[t]} overflows the int32 "
                     "in-tile cumsum; use a smaller tile")
            occ = np.abs(o)
            mask = occ > 0
            self.omin[t] = (occ[mask] - 1).min() if mask.any() else -1
            self.omax[t] = (occ[mask] - 1 + ln[mask]).max() \
                if mask.any() else -1
        self.carry = np.concatenate(([0], np.cumsum(totals)))
        self._cached_t = -1
        self._cached = None
        self.uploads = 0

    def device_tile(self, t: int):
        """Tile ``t``'s (ordp, lenp) on the device, uploaded unless it is
        the cached one (a one-entry cache: lookups mostly hit the tile they
        hit last, and each upload moves tile * 8 bytes)."""
        if self._cached_t != t:
            s = t * self.tile
            o = np.asarray(self.ordp[s:s + self.tile], np.int32)
            ln = np.asarray(self.lenp[s:s + self.tile], np.int32)
            if len(o) < self.tile:  # the last, partial tile only
                pad = self.tile - len(o)
                o = np.pad(o, (0, pad))
                ln = np.pad(ln, (0, pad))
            both = torch.from_numpy(np.stack([o, ln])).to(self.device)
            self._cached = (both[0], both[1])
            self._cached_t = t
            self.uploads += 1
        return self._cached

    def live_total(self) -> int:
        return int(self.carry[-1])

    def position_of_live_rank(self, rank1: int):
        """1-based live rank -> (global run row, 1-based in-run offset);
        ``(-1, 0)`` when ``rank1`` is out of range."""
        if rank1 < 1 or rank1 > self.live_total():
            return -1, 0
        t = int(np.searchsorted(self.carry[1:], rank1, side="left"))
        row, off = _tile_rank(*self.device_tile(t),
                              rank1 - int(self.carry[t]))
        return t * self.tile + int(row), int(off)

    def order_to_position(self, order: int) -> int:
        """CRDT order -> 0-based content position (live characters strictly
        before it), or -1 when the order is unknown or a tombstone — the
        contract of ``parallel.sp_runs``' ``order_to_position``."""
        for t in range(self.ntiles):
            # A tile whose [omin, omax) envelope misses the order never
            # goes up (most lookups touch one tile).
            if self.omax[t] < 0 or not (self.omin[t] <= order
                                        < self.omax[t]):
                continue
            found, pos = _tile_order(*self.device_tile(t), order)
            if bool(found):
                p = int(pos)
                return -1 if p < 0 else int(self.carry[t]) + p
        return -1


__all__ = ["StreamedRuns"]
