"""Plain reference of the SIM array's sort: the tree-node-skipping (TNS)
controller of the paper (§2.2, Supplementary S3/S4/S7/S12) over one bank
of N unsigned W-bit keys, binary digit planes, a k-deep LIFO that drops
its oldest node on overflow, and the "actual" reload rule of S12 (a
cycle spent on each drained node past the first).

The rules are those of the event oracle ``repro_torch/core/ref_tns.py``
(level_bits 1, unsigned, ascending), written over Python integers used
as bit sets (bit i = lane i) instead of numpy masks: the oracle takes
about 5 s a 1024-key bank on one core (its emitted count is re-summed
every cycle), this about 20 ms.  It imports nothing of the program.

The result of a bank: the emission order (ties: lowest index first),
the controller cycles, the digit reads and the redundant reload cycles.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class BankSort(NamedTuple):
    perm: List[int]
    cycles: int
    drs: int
    reload_cycles: int


def _columns(keys: np.ndarray, width: int) -> List[int]:
    """One bit set a digit column, most significant first: bit i of
    column c is digit c (from the MSB) of keys[i]."""
    u = keys.astype(np.uint64)
    cols = []
    for c in range(width):
        bits = ((u >> np.uint64(width - 1 - c)) & np.uint64(1)).astype(bool)
        cols.append(int.from_bytes(np.packbits(bits, bitorder="little")
                                   .tobytes(), "little"))
    return cols


def tns_bank(keys: np.ndarray, width: int, k: int) -> BankSort:
    """Sort one bank of unsigned keys (< 2**width) ascending."""
    n = int(keys.shape[0])
    if n and int(keys.max()) >> width:
        raise ValueError(f"a key needs more than {width} bits")
    cols = _columns(keys, width)
    alive = valid = (1 << n) - 1
    col, reload_pending = 0, False
    lifo: List[tuple] = []
    cycles = drs = reload_cycles = 0
    perm: List[int] = []
    limit = 4 * n * width + 64

    def emit(bit: int) -> None:
        nonlocal alive, valid
        perm.append(bit.bit_length() - 1)
        alive &= ~bit
        valid &= ~bit

    while alive:
        cycles += 1
        if cycles > limit:
            raise RuntimeError("TNS reference exceeded its cycle budget")
        if reload_pending:                      # phase 1: reload
            reload_pending = False
            popped = 0
            spent = False
            while True:
                if not lifo:
                    valid, col = alive, 0
                    break
                digit, status = lifo[-1]
                live = status & alive
                if live:
                    valid, col = live, digit
                    break
                lifo.pop()
                popped += 1
                if lifo and not (lifo[-1][1] & alive):
                    # S12 "actual": clearing another drained node costs
                    # this whole cycle
                    reload_pending = True
                    reload_cycles += 1
                    spent = True
                    break
            if spent:
                continue
        nv = valid.bit_count()
        if nv == 1:                             # phase 2: last number
            emit(valid)
            reload_pending = alive != 0
            continue
        if col >= width:                        # phase 3: repeat mode
            emit(valid & -valid)
            if not valid:
                reload_pending = alive != 0
            continue
        row = cols[col]                         # phase 4: digit read
        drs += 1
        ones = valid & row
        at_lsb = col == width - 1
        if ones and ones != valid:              # mixed: record, exclude 1s
            if k > 0:
                if len(lifo) == k:
                    lifo.pop(0)
                lifo.append((col + 1, valid))
            valid &= ~row
        nv = valid.bit_count()
        if nv == 1:                             # phase 5: post-exclusion
            emit(valid)
            reload_pending = alive != 0
            continue
        if at_lsb:
            emit(valid & -valid)
            col = width
            if not valid:
                reload_pending = alive != 0
            continue
        col += 1
    return BankSort(perm, cycles, drs, reload_cycles)


def sort_banks(x: np.ndarray, width: int, k: int, rows) -> dict:
    """The reference's answer for the given rows of a (B, N) batch:
    ``indices`` (R, N), ``values`` (R, N) in x's dtype, ``cycles``,
    ``drs``, ``reload_cycles`` (R,)."""
    out = [tns_bank(x[r], width, k) for r in rows]
    idx = np.asarray([o.perm for o in out], dtype=np.int64)
    return {"indices": idx,
            "values": np.take_along_axis(x[list(rows)], idx, axis=-1),
            "cycles": np.asarray([o.cycles for o in out], dtype=np.int64),
            "drs": np.asarray([o.drs for o in out], dtype=np.int64),
            "reload_cycles": np.asarray([o.reload_cycles for o in out],
                                        dtype=np.int64)}
