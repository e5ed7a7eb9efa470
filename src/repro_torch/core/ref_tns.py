"""Cycle-exact Python oracle for BTS / TNS / CA-TNS.

This module is the *reference semantics* of the paper's state controller
(Fig. 3a, Supplementary S3/S4/S7/S8/S12).  Every rule below was derived from
the paper's worked examples and is pinned by tests that reproduce the exact
published cycle counts:

* S3  BTS, 6 numbers, 4-bit ............................. 24 cycles
* S4  TNS  k=3, same dataset ............................ 10 cycles
* S6  TNS float16-like example .......................... 12 cycles
* S6  TNS two's complement example ......................  5 cycles
* S8.1 multi-bank k=1 (9,2,14,3) ........................  8 cycles
* S8.2 bit-slice 2+2 bits (2,3,9,14) ....................  7 cycles
* S8.3 multi-level ML-2-bit k=1 (2,3,9,14) ..............  5 cycles

Cycle semantics (one cycle = one pass through the controller):

1. *Reload phase* (only when the previous cycle emitted a min):  pop at most
   ONE drained LIFO node; if the new top is still drained the cycle is spent
   ("redundant cycle", S12 actual scenario).  Otherwise load the top node
   (valid = status & alive, digit = recorded index) or, with an empty LIFO,
   restart from the MSB with valid = alive.  `ideal_lifo=True` pops all
   drained nodes at once (S12 ideal scenario).
2. *Last-number check* (pre-DR, S7): a single valid number is emitted
   without any DR.
3. *Repeat mode*: past the LSB every remaining valid number is a duplicate
   of the emitted min; one is emitted per cycle (S4 cycles 9-10).
4. *Digit read* + all-0s/all-1s check; on a mixed read: state-record into
   the k-deep LIFO (binary records the NEXT column index; multi-level
   records the CURRENT index, S8.3) and number-exclude by the data-type
   polarity (S6).  A post-NE single survivor is emitted in the same cycle
   (S4 cycle 7); survivors at the LSB enter repeat mode after one emission.

The oracle is deliberately plain Python/numpy — it is the ground truth the
port's CUDA kernels are held against on the card, with no JAX in the
process.  It is a copy of ``repro.core.ref_tns`` over the port's own
``bitplane`` (the tests assert the two agree).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import bitplane as bp


@dataclasses.dataclass
class SortResult:
    perm: np.ndarray          # indices into the input, in emission order
    cycles: int               # total controller cycles (paper's latency unit)
    drs: int                  # digit reads actually performed
    reload_cycles: int = 0    # cycles spent only popping drained nodes
    values: Optional[np.ndarray] = None

    @property
    def drs_per_number(self) -> float:
        return self.drs / max(1, len(self.perm))


def _encode(values, width: int, fmt: str, level_bits: int) -> np.ndarray:
    """(D, N) digit matrix, most-significant digit first."""
    x = np.asarray(values)
    if level_bits == 1:
        planes = np.asarray(bp.to_bitplanes(x, width, fmt))
    else:
        if fmt != bp.UNSIGNED:
            raise ValueError("multi-level strategy supports unsigned data "
                             "(paper demonstrates ML on unsigned numbers)")
        planes = np.asarray(bp.to_digitplanes(x, width, fmt, level_bits))
    planes = bp.read_planes(planes, kind="bit" if level_bits == 1 else
                            "digit", level_bits=level_bits)
    return planes.astype(np.int64)


def _sign_plane(values, width: int, fmt: str) -> np.ndarray:
    x = np.asarray(values)
    u = np.asarray(bp.raw_bits(x, width, fmt)).astype(np.uint64)
    return ((u >> np.uint64(width - 1)) & np.uint64(1)).astype(bool)


def _exclude_value(col: int, fmt: str, ascending: bool, neg_pending: bool) -> int:
    """Which binary digit value gets excluded at this column (S6 polarity)."""
    if fmt == bp.UNSIGNED:
        return 1 if ascending else 0
    if fmt == bp.TWOS:
        if col == 0:  # sign bit also carries magnitude (-2^{n-1})
            return 0 if ascending else 1
        return 1 if ascending else 0
    # sign-magnitude / float: sign bit is polarity only
    if col == 0:
        return 0 if ascending else 1
    if ascending:
        # negatives first; within negatives bigger magnitude = smaller value
        return 0 if neg_pending else 1
    else:
        # positives first; within positives bigger magnitude = bigger value
        return 0 if neg_pending else 1


class _Lifo:
    """k-deep LIFO of (digit_index, status_mask); push on overflow drops the
    oldest entry ("k most recent tree nodes", §2.2.1)."""

    def __init__(self, k: int):
        self.k = k
        self.stack: List[Tuple[int, np.ndarray]] = []

    def push(self, digit: int, status: np.ndarray) -> None:
        if self.k <= 0:
            return
        if len(self.stack) == self.k:
            self.stack.pop(0)
        self.stack.append((digit, status.copy()))

    def top(self):
        return self.stack[-1] if self.stack else None

    def pop(self):
        return self.stack.pop() if self.stack else None

    def __len__(self):
        return len(self.stack)


class TnsMachine:
    """Single-array TNS controller stepped one cycle at a time.

    ``slice_cols``: optional (start, stop) restricting DRs to a digit-column
    slice — used by the bit-slice strategy, where emission becomes *group*
    emission (all survivors at the slice LSB leave together, S8.2).
    ``group_emit`` enables that behaviour.
    """

    def __init__(self, digits: np.ndarray, k: int, fmt: str, ascending: bool,
                 level_bits: int = 1, ideal_lifo: bool = False,
                 slice_cols: Optional[Tuple[int, int]] = None,
                 group_emit: bool = False,
                 sign_bits: Optional[np.ndarray] = None):
        self.digits = digits              # (D, N)
        self.ncols, self.n = digits.shape
        self.col_lo, self.col_hi = slice_cols or (0, self.ncols)
        self.k = k
        self.fmt = fmt
        self.ascending = ascending
        self.level_bits = level_bits
        self.ideal_lifo = ideal_lifo
        self.group_emit = group_emit
        self.sign_bits = sign_bits        # (N,) bool, for float/signmag phase
        self.lifo = _Lifo(k)
        self.alive = np.zeros(self.n, dtype=bool)
        self.valid = np.zeros(self.n, dtype=bool)
        self.col = self.col_lo
        self.reload_pending = False
        self.active = False               # has a working set
        self.cycles = 0
        self.drs = 0
        self.reload_cycles = 0
        self.emitted: List[np.ndarray] = []   # masks, singleton or group

    # -- working-set management ------------------------------------------
    def start(self, mask: np.ndarray) -> None:
        """Begin sorting the numbers in ``mask`` (fresh LIFO not reset —
        callers create a fresh machine per independent job)."""
        self.alive = mask.copy()
        self.valid = mask.copy()
        self.col = self.col_lo
        self.reload_pending = False
        self.active = True

    @property
    def done(self) -> bool:
        return self.active and not self.alive.any()

    @property
    def idle(self) -> bool:
        return not self.active or not self.alive.any()

    # -- helpers -----------------------------------------------------------
    def _neg_pending(self) -> bool:
        if self.sign_bits is None:
            return False
        if self.ascending:
            return bool((self.alive & self.sign_bits).any())
        return bool((self.alive & ~self.sign_bits).any())

    def _emit(self, mask: np.ndarray) -> None:
        self.emitted.append(mask.copy())
        self.alive &= ~mask
        self.valid &= ~mask

    def _emit_one(self) -> None:
        idx = int(np.flatnonzero(self.valid)[0])
        m = np.zeros(self.n, dtype=bool)
        m[idx] = True
        self._emit(m)

    # -- one controller cycle ----------------------------------------------
    def step(self) -> None:
        assert self.active and self.alive.any()
        self.cycles += 1

        # Phase 1: reload.
        if self.reload_pending:
            self.reload_pending = False
            popped = 0
            while True:
                top = self.lifo.top()
                if top is None:
                    self.valid = self.alive.copy()
                    self.col = self.col_lo
                    break
                digit, status = top
                live = status & self.alive
                if live.any():
                    self.valid = live
                    self.col = digit
                    break
                self.lifo.pop()
                popped += 1
                if not self.ideal_lifo and popped >= 1:
                    nxt = self.lifo.top()
                    if nxt is not None and not (nxt[1] & self.alive).any():
                        # S12 "actual": clearing another drained node costs
                        # this whole cycle.
                        self.reload_pending = True
                        self.reload_cycles += 1
                        return

        nv = int(self.valid.sum())

        # Phase 2: last-number check (S7) — no DR needed.
        if nv == 1:
            self._emit(self.valid.copy())
            self.reload_pending = self.alive.any()
            return

        # Phase 3: repeat mode past the LSB — duplicates drain 1/cycle (S4).
        if self.col >= self.col_hi:
            if self.group_emit:
                self._emit(self.valid.copy())
                self.reload_pending = self.alive.any()
            else:
                self._emit_one()
                if int(self.valid.sum()) == 0:
                    self.reload_pending = self.alive.any()
            return

        # Phase 4: digit read.
        row = self.digits[self.col]
        vals = row[self.valid]
        self.drs += 1
        mixed = bool((vals != vals[0]).any())
        at_lsb = self.col == self.col_hi - 1
        if mixed:
            if self.level_bits == 1:
                # binary tree: record NEXT column (S4)
                self.lifo.push(self.col + 1, self.valid)
                exc = _exclude_value(self.col, self.fmt, self.ascending,
                                     self._neg_pending())
                keep = self.valid & (row != exc)
            else:
                # multi-level: quad-tree — record CURRENT column (S8.3)
                self.lifo.push(self.col, self.valid)
                sel = vals.min() if self.ascending else vals.max()
                keep = self.valid & (row == sel)
            self.valid = keep

        nv = int(self.valid.sum())
        # Phase 5: post-NE checks.
        if nv == 1:
            self._emit(self.valid.copy())
            self.reload_pending = self.alive.any()
            return
        if at_lsb:
            if self.group_emit:
                self._emit(self.valid.copy())
                self.reload_pending = self.alive.any()
            else:
                # duplicates: emit one now, stay past LSB (S4 cycle 9)
                self._emit_one()
                self.col = self.col_hi
                if int(self.valid.sum()) == 0:
                    self.reload_pending = self.alive.any()
            return
        self.col += 1


def tns_sort(values, width: int, k: int, fmt: str = bp.UNSIGNED,
             ascending: bool = True, level_bits: int = 1,
             ideal_lifo: bool = False, max_cycles: Optional[int] = None,
             stop_after: Optional[int] = None) -> SortResult:
    """Full TNS sort of ``values`` on a single array (paper §2.2).
    ``stop_after`` emits only the first m extrema (§3.2 pruning use)."""
    x = np.asarray(values)
    n = x.shape[0]
    digits = _encode(x, width, fmt, level_bits)
    sign = _sign_plane(x, width, fmt) if fmt in (bp.SIGNMAG, bp.FLOAT) else None
    m = TnsMachine(digits, k, fmt, ascending, level_bits, ideal_lifo,
                   sign_bits=sign)
    m.start(np.ones(n, dtype=bool))
    limit = max_cycles or (4 * n * digits.shape[0] + 64)
    stop_n = n if stop_after is None else min(stop_after, n)
    while m.alive.any() and sum(int(e.sum()) for e in m.emitted) < stop_n:
        m.step()
        if m.cycles > limit:
            raise RuntimeError("TNS oracle exceeded cycle budget — bug")
    perm = np.concatenate([np.flatnonzero(e) for e in m.emitted])
    return SortResult(perm=perm, cycles=m.cycles, drs=m.drs,
                      reload_cycles=m.reload_cycles, values=x[perm])


def bts_sort(values, width: int, fmt: str = bp.UNSIGNED,
             ascending: bool = True) -> SortResult:
    """Bit-traversal sort baseline (prior art [42], S3): every min search
    restarts at the MSB and always walks to the LSB — N*W cycles."""
    x = np.asarray(values)
    n = x.shape[0]
    digits = _encode(x, width, fmt, 1)
    sign = _sign_plane(x, width, fmt) if fmt in (bp.SIGNMAG, bp.FLOAT) else None
    w = digits.shape[0]
    alive = np.ones(n, dtype=bool)
    perm: List[int] = []
    cycles = drs = 0
    while alive.any():
        valid = alive.copy()
        for col in range(w):
            cycles += 1
            drs += 1
            row = digits[col]
            vals = row[valid]
            if (vals != vals[0]).any():
                if fmt in (bp.SIGNMAG, bp.FLOAT):
                    neg_pending = bool((alive & sign).any()) if ascending \
                        else bool((alive & ~sign).any())
                else:
                    neg_pending = False
                exc = _exclude_value(col, fmt, ascending, neg_pending)
                valid &= row != exc
        idx = int(np.flatnonzero(valid)[0])   # duplicates: one per pass (S3)
        perm.append(idx)
        alive[idx] = False
    return SortResult(perm=np.array(perm), cycles=cycles, drs=drs,
                      values=x[np.array(perm)])


def multibank_sort(values, width: int, k: int, banks: int,
                   fmt: str = bp.UNSIGNED, ascending: bool = True) -> SortResult:
    """Multi-bank CA-TNS (§2.3.1).  Banks run synchronized DRs; the
    cross-array processor ORs the not-all-0s / not-all-1s / load signals, so
    the ensemble behaves cycle-for-cycle like one length-N TNS sorter:
    T_mb == T_TNS (eq. 2).  The oracle therefore runs basic TNS and verifies
    the partition is well-formed; the *frequency* benefit of smaller banks
    is applied by the cost model, not here."""
    n = len(np.asarray(values))
    if banks < 1 or banks > n:
        raise ValueError("banks must be in [1, N]")
    res = tns_sort(values, width, k, fmt, ascending)
    return res


def bitslice_sort(values, width: int, k: int, slice_widths: Sequence[int],
                  fmt: str = bp.UNSIGNED, ascending: bool = True,
                  level_bits: int = 1) -> SortResult:
    """Bit-slice CA-TNS (§2.3.2): pipelined sub-sorters over digit slices.

    Event-driven simulation: all sub-sorters advance once per global cycle.
    Sub-sorter 1 group-emits survivor sets at its slice LSB into a FIFO;
    downstream sorters refine groups (singletons pass through in one output
    cycle, per the S8.2 trace).  Total latency = cycle of the last emission.
    """
    if sum(slice_widths) * level_bits != width and sum(slice_widths) != width:
        raise ValueError("slice widths must sum to W")
    x = np.asarray(values)
    n = x.shape[0]
    digits = _encode(x, width, fmt, level_bits)
    sign = _sign_plane(x, width, fmt) if fmt in (bp.SIGNMAG, bp.FLOAT) else None
    # column offsets per slice
    offs = np.cumsum([0] + list(slice_widths))
    stages = len(slice_widths)

    fifos: List[deque] = [deque() for _ in range(stages)]  # fifos[i] feeds stage i
    all_machines: List[TnsMachine] = []

    def mk(s: int) -> TnsMachine:
        msorter = TnsMachine(digits, k, fmt, ascending, level_bits,
                             slice_cols=(int(offs[s]), int(offs[s + 1])),
                             group_emit=(s < stages - 1), sign_bits=sign)
        all_machines.append(msorter)
        return msorter

    stage0 = mk(0)
    stage0.start(np.ones(n, dtype=bool))
    # downstream stage state: current machine or None
    cur: List[Optional[TnsMachine]] = [None] * stages
    cur[0] = stage0
    outputs: List[np.ndarray] = []
    cycles = 0
    total_emitted = 0
    limit = 8 * n * width + 64
    while total_emitted < n:
        cycles += 1
        if cycles > limit:
            raise RuntimeError("bit-slice oracle exceeded cycle budget — bug")
        # Advance every stage once; emissions become visible to the consumer
        # stage on the NEXT global cycle (pushed to the FIFOs after all
        # stages have stepped — the paper's NE-FIFO hand-off, S8.2).
        new_groups: List[List[np.ndarray]] = [[] for _ in range(stages)]
        for s in range(stages):
            msorter = cur[s]
            last = s == stages - 1
            if msorter is None or msorter.idle:
                if s == 0 or not fifos[s]:
                    continue
                grp = fifos[s].popleft()
                if int(grp.sum()) == 1:
                    # singleton pass-through: one output cycle (S8.2 c6/c7)
                    if last:
                        outputs.append(grp)
                        total_emitted += 1
                    else:
                        new_groups[s].append(grp)
                    continue
                msorter = mk(s)
                msorter.start(grp)
                cur[s] = msorter
            before = len(msorter.emitted)
            msorter.step()
            for e in msorter.emitted[before:]:
                if last:
                    outputs.append(e)
                    total_emitted += int(e.sum())
                else:
                    new_groups[s].append(e)
            if msorter.idle and s > 0:
                cur[s] = None
        for s in range(stages - 1):
            fifos[s + 1].extend(new_groups[s])
    perm = np.concatenate([np.flatnonzero(e) for e in outputs])
    total_drs = sum(m.drs for m in all_machines)
    return SortResult(perm=perm, cycles=cycles, drs=total_drs, values=x[perm])


def verify_sorted(values, result: SortResult, ascending: bool = True) -> bool:
    x = np.asarray(values, dtype=np.float64)
    out = x[result.perm]
    ref = np.sort(x)
    if not ascending:
        ref = ref[::-1]
    return bool(np.allclose(out, ref)) and len(set(result.perm.tolist())) == len(x)
