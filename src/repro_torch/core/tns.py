"""Cycle-faithful TNS machines in PyTorch: the paper's state controller
(Fig. 3a), one controller cycle a step, with the phase structure of the
event-driven oracle :mod:`repro_torch.core.ref_tns`:

  reload (pop <=1 drained LIFO node / restart at MSB)
  -> last-number check -> repeat-mode drain -> digit read
  -> state-record (k-LIFO, drop-oldest) + number-exclude -> min check.

Each machine returns the emission permutation and the paper's latency
observables (cycles, digit reads, redundant reload cycles), which feed the
hardware cost model (:mod:`repro_torch.core.cost`).

Two machines, both plain PyTorch on the tensors' device (this controller
is a loop of small data-dependent steps, not one kernel):

* the single instance (:func:`tns_sort_planes`) keeps the controller's
  registers on the host and decides each phase there, reading one small
  vector of counts from the device a cycle;
* the batched machine (:func:`tns_sort_planes_batched`) steps B banks in
  lockstep, branch-free under per-bank masks, and asks the device whether
  any bank still runs once every ``unroll`` cycles.  A finished bank
  freezes, so the extra cycles of the last trip change nothing.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bitplane as bp
from repro_torch.kernels import backend
from repro_torch.kernels.fused_tns import pack_words, popcount

# controller cycles the batched machine runs between two looks at whether
# any bank still runs (each look waits for the device)
UNROLL = 32
# both batched machines pack two liveness counts into one integer with a
# 15-bit shift, so a bank holds fewer than 2^15 numbers
MAX_BATCH_N = 1 << 15
_BIG = 1 << 30
_WORD = 0xFFFFFFFF


class TnsOut(NamedTuple):
    perm: torch.Tensor            # (..., N) int32 emission order (-1 pad)
    cycles: torch.Tensor          # (...,) int32
    drs: torch.Tensor
    reload_cycles: torch.Tensor


def _exclude_value(col: int, fmt: str, ascending: bool,
                   neg_pending: bool) -> int:
    """Binary digit value excluded at ``col``, per S6."""
    if fmt == bp.UNSIGNED:
        return 1 if ascending else 0
    sign_exc = 0 if ascending else 1
    if fmt == bp.TWOS:
        return sign_exc if col == 0 else (1 if ascending else 0)
    # sign-magnitude / float
    return sign_exc if col == 0 else (0 if neg_pending else 1)


def _exclude_bit(col: torch.Tensor, fmt: str, ascending: bool,
                 neg_pending: torch.Tensor) -> torch.Tensor:
    """Per-bank form of :func:`_exclude_value`: True where the excluded
    digit is 1."""
    if fmt == bp.UNSIGNED:
        return torch.full_like(col, ascending, dtype=torch.bool)
    sign_exc = not ascending
    if fmt == bp.TWOS:
        return torch.where(col == 0, sign_exc, ascending)
    return torch.where(col == 0, sign_exc, ~neg_pending)


def _encode(x: np.ndarray, width: int, fmt: str, level_bits: int,
            banks: Optional[int] = None):
    """Program ``x`` into digit planes and read them once through the
    fault-injectable :func:`bitplane.read_planes`: (uint8 digits, sign
    plane or None), host arrays."""
    if level_bits == 1:
        digits = bp.to_bitplanes(x, width, fmt)
    else:
        digits = bp.to_digitplanes(x, width, fmt, level_bits)
    digits = bp.read_planes(digits, kind="bit" if level_bits == 1 else
                            "digit", level_bits=level_bits, banks=banks)
    sign = (bp.sign_plane(x, width, fmt)
            if fmt in (bp.SIGNMAG, bp.FLOAT) else None)
    return np.asarray(digits).astype(np.uint8), sign


def _to_device(digits: np.ndarray, sign: Optional[np.ndarray], dev):
    d = torch.from_numpy(np.ascontiguousarray(digits)).to(dev)
    s = None if sign is None else torch.from_numpy(
        np.ascontiguousarray(sign.astype(bool))).to(dev)
    return d, s


# ---------------------------------------------------------------------------
# The single instance: registers on the host, masks on the device.
# ---------------------------------------------------------------------------


def tns_sort_planes(digits: torch.Tensor,
                    sign_bits: Optional[torch.Tensor] = None, *, k: int,
                    fmt: str = bp.UNSIGNED, ascending: bool = True,
                    level_bits: int = 1, ideal_lifo: bool = False,
                    stop_after: Optional[int] = None) -> TnsOut:
    """Run TNS on a (D, N) digit-plane tensor on its device.
    ``stop_after`` emits only the first m min/max values (the paper's
    in-situ-pruning use, §3.2).  The outputs are 0-d / (N,) int32 tensors
    on the planes' device."""
    D, N = digits.shape
    dev = digits.device
    stop_n = N if stop_after is None else min(stop_after, N)
    limit = 4 * N * D + 64
    iota = torch.arange(N, device=dev)
    sdir = None
    if sign_bits is not None:
        sdir = sign_bits.bool() if ascending else ~sign_bits.bool()
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    alive = torch.ones(N, dtype=torch.bool, device=dev)
    valid = alive
    nv = acnt = N                 # counts of valid / alive (valid <= alive)
    col = 0
    lifo = []                     # [status mask, recorded digit], oldest first
    pending = False
    perm = torch.full((N,), -1, dtype=torch.int32, device=dev)
    out = cycles = drs = reload_cycles = 0

    while out < stop_n and cycles < limit:
        cycles += 1
        # ---------------- phase 1: reload ----------------
        if pending:
            pending = False
            if k == 0:
                valid, nv, col = alive, acnt, 0
            elif ideal_lifo:
                # pop every drained node at once (S12's idealised LIFO)
                cnts = []
                if lifo:
                    live = torch.stack([m for m, _ in lifo]) & alive
                    cnts = live.sum(dim=1).tolist()
                keep = [i + 1 for i, c in enumerate(cnts) if c]
                new_len = max(keep, default=0)
                del lifo[new_len:]
                if new_len:
                    valid, nv = live[new_len - 1], cnts[new_len - 1]
                    col = lifo[-1][1]
                else:
                    valid, nv, col = alive, acnt, 0
            elif not lifo:
                valid, nv, col = alive, acnt, 0
            else:
                # actual hardware (S12): pop at most one drained node a cycle
                n_stack = len(lifo)
                top = lifo[-1][0] & alive
                below = lifo[-2][0] & alive if n_stack > 1 else None
                c_top, c_below = torch.stack([
                    top.sum(),
                    zero if below is None else below.sum()]).tolist()
                drained0 = c_top == 0
                len1 = n_stack - 1 if drained0 else n_stack
                live1, c1 = (below, c_below) if drained0 else (top, c_top)
                del lifo[len1:]
                if drained0 and len1 > 0 and c1 == 0:
                    pending = True            # a redundant pop cycle
                    reload_cycles += 1
                    continue
                if len1:
                    valid, nv, col = live1, c1, lifo[-1][1]
                else:
                    valid, nv, col = alive, acnt, 0

        # ---------------- phases 2-5 ----------------
        if nv != 1 and col < D:
            # phases 4-5: digit read, state record, number exclude
            row = digits[col]
            drs += 1
            if level_bits == 1:
                c1s, c0s, neg = torch.stack([
                    (valid & (row == 1)).sum(), (valid & (row == 0)).sum(),
                    zero if sdir is None else (alive & sdir).sum()]).tolist()
                mixed = c1s > 0 and c0s > 0
                exc = _exclude_value(col, fmt, ascending, neg > 0)
                keep = valid & (row != exc)
                nk = nv - (c1s if exc == 1 else c0s)
                rec = col + 1         # binary tree: record the NEXT column
            else:
                row32 = row.to(torch.int32)
                dmin, dmax = torch.stack([
                    torch.where(valid, row32, _BIG).min(),
                    torch.where(valid, row32, -_BIG).max()]).tolist()
                mixed = dmin != dmax
                keep = valid & (row32 == (dmin if ascending else dmax))
                nk = int(keep.sum()) if mixed else nv
                rec = col             # quad tree: record the CURRENT column
            if mixed:
                if k > 0:
                    if len(lifo) >= k:
                        del lifo[0]   # drop-oldest
                    lifo.append([valid, rec])
                valid, nv = keep, nk
            if nv != 1:
                if col < D - 1:
                    col += 1
                    continue
                col = D               # duplicates at the LSB: repeat mode
        # the last number (phase 2) or the repeat-mode drain (phase 3):
        # emit the first member of valid; a reload follows once valid is
        # drained and numbers are left (for phase 2 valid held one)
        idx = torch.argmax(valid.to(torch.uint8))
        perm[out] = idx.to(torch.int32)
        onehot = iota == idx
        alive, valid = alive & ~onehot, valid & ~onehot
        out, acnt, nv = out + 1, acnt - 1, nv - 1
        pending = nv == 0 and acnt > 0

    as_t = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return TnsOut(perm, as_t(cycles), as_t(drs), as_t(reload_cycles))


def tns_sort(values, width: int, k: int, fmt: str = bp.UNSIGNED,
             ascending: bool = True, level_bits: int = 1,
             ideal_lifo: bool = False, stop_after: Optional[int] = None,
             device=None) -> TnsOut:
    """Encode ``values`` on the host (programming the memristor array),
    carry the planes to ``device`` (the card unless named) and run the
    single-instance machine there."""
    dev = backend.resolve_device(device)
    digits, sign = _encode(np.asarray(values), width, fmt, level_bits)
    d, s = _to_device(digits, sign, dev)
    return tns_sort_planes(d, s, k=k, fmt=fmt, ascending=ascending,
                           level_bits=level_bits, ideal_lifo=ideal_lifo,
                           stop_after=stop_after)


# ---------------------------------------------------------------------------
# The batched machine: B independent banks stepping in lockstep.
#
# The same state machine vectorised over a leading B axis, branch-free,
# each phase computed once under a per-bank mask, with the reference's
# cost-only transformations (cycle parity with the single instance is
# asserted by the tests):
#   * the k-LIFO is a ring buffer (head + length), so a drop-oldest push is
#     one masked write;
#   * running tallies (alive count, valid count) replace any()-searches,
#     since valid is always a subset of alive;
#   * emissions write an inverse permutation ``rank`` (rank[i] = emission
#     slot of element i), inverted into ``perm`` by one scatter at the end.
# ---------------------------------------------------------------------------


def _ring_slot(start, i, k):
    """Ring-buffer slot of depth ``i`` from the head ``start``
    (0 <= start + i < 2k)."""
    return (start + i) % k


def _registers(B: int, N: int, dev) -> SimpleNamespace:
    z = lambda: torch.zeros(B, dtype=torch.int64, device=dev)
    return SimpleNamespace(
        col=z(), start=z(), len=z(), out=z(), cyc=z(), drs=z(), rlc=z(),
        acnt=z() + N, nv=z() + N,
        pending=torch.zeros(B, dtype=torch.bool, device=dev))


def _reload(st, rp, take, count_pair, k: int):
    """Phase 1 of the actual hardware (S12), per bank: pop at most one
    drained node a cycle.  ``take(stack, slot)`` reads a ring level,
    ``count_pair(a, b)`` counts two masks' members at once.  Returns
    (spent, len_a, valid_a, col_a, nv_a)."""
    len0, start0 = st.len, st.start
    has0 = len0 > 0
    t0 = _ring_slot(start0, (len0 - 1).clamp(min=0), k)
    tb = _ring_slot(start0, (len0 - 2).clamp(min=0), k)
    live_top = take(st.lifo_mask, t0) & st.alive
    live_below = take(st.lifo_mask, tb) & st.alive
    cnt0, cntb = count_pair(live_top, live_below)
    drained0 = has0 & (cnt0 == 0)
    len1 = torch.where(drained0, len0 - 1, len0)
    has1 = len1 > 0
    live1 = torch.where(drained0[:, None], live_below, live_top)
    cnt1 = torch.where(drained0, cntb, cnt0)
    drained1 = has1 & (cnt1 == 0)
    spent = rp & drained0 & drained1
    ok = rp & ~spent
    t1 = _ring_slot(start0, (len1 - 1).clamp(min=0), k)
    valid_a = torch.where(ok[:, None],
                          torch.where(has1[:, None], live1, st.alive),
                          st.valid)
    nv_a = torch.where(ok, torch.where(has1, cnt1, st.acnt), st.nv)
    col_a = torch.where(ok & has1, take(st.lifo_digit, t1),
                        torch.where(ok, 0, st.col))
    len_a = torch.where(rp, len1, len0)
    return spent, len_a, valid_a, col_a, nv_a


def _push_and_finish(st, *, running, spent, rp, len_a, valid_a, col_a, nv_a,
                     change, keep, nk, rec, act, is_dr, D,
                     first_index, clear):
    """The state-record push into the ring, the emission and the next
    cycle's registers, shared by both batched steps.  ``first_index(m)``
    finds each bank's first member of m, ``clear(idx, emit)`` gives the
    (alive, valid)-shaped mask of the emitted element."""
    k = st.lifo_mask.shape[1]
    if k > 0:
        full = len_a >= k
        # push slot = (start + len) % k; when full that is the oldest
        # slot, which drop-oldest overwrites (the head then advances)
        slot = _ring_slot(st.start, len_a, k)
        at_slot = (st.iota_k[None, :] == slot[:, None]) & change[:, None]
        st.lifo_mask = torch.where(at_slot[:, :, None], valid_a[:, None, :],
                                   st.lifo_mask)
        st.lifo_digit = torch.where(at_slot, rec[:, None], st.lifo_digit)
        st.start = torch.where(change & full, _ring_slot(st.start, 1, k),
                               st.start)
        len_a = torch.where(change, (len_a + 1).clamp(max=k), len_a)
    st.len = len_a

    valid_b = torch.where(change[:, None], keep, valid_a)
    nv2 = torch.where(change, nk, nv_a)
    at_lsb = col_a == D - 1
    dr_rep = is_dr & (nv2 != 1) & at_lsb
    dr_desc = is_dr & (nv2 != 1) & ~at_lsb

    # every active bank emits but one that descends a column: phase 2 the
    # lone survivor, phase 3 the first of the repeat set, in both cases
    # the first member of valid_b
    emit = act & ~dr_desc
    idx = first_index(valid_b)
    st.rank = torch.where((st.iota_n == idx[:, None]) & emit[:, None],
                          st.out[:, None].to(torch.int32), st.rank)
    e = emit.to(torch.int64)
    gone = clear(idx, emit)
    st.alive = st.alive & ~gone
    st.valid = valid_b & ~gone
    acnt_n = st.acnt - e
    nv_c = nv2 - e

    # next cycle's reload request after an emission: valid drained and
    # numbers left (phase 2's valid held one number, so it always drains)
    st.pending = torch.where(emit, (nv_c == 0) & (acnt_n > 0),
                             torch.where(rp, spent, st.pending))
    st.col = torch.where(dr_desc, col_a + 1, torch.where(dr_rep, D, col_a))
    st.out = st.out + e
    st.acnt, st.nv = acnt_n, nv_c
    st.cyc = st.cyc + running.to(torch.int64)
    st.rlc = st.rlc + spent.to(torch.int64)
    st.drs = st.drs + is_dr.to(torch.int64)


def _make_batched_step(digits, sdir, fmt, ascending, level_bits, ideal_lifo,
                       stop_n, limit):
    """The generic batched step over (B, D, N) uint8 digit planes: binary
    or radix-2^n cells, actual or idealised LIFO."""
    B, D, N = digits.shape
    dev = digits.device
    rows = torch.arange(B, device=dev)
    iota_n = torch.arange(N, device=dev)
    no_bank = torch.zeros(B, dtype=torch.bool, device=dev)
    take = lambda stack, ti: stack[rows, ti]

    def neg_pending(alive):
        if sdir is None:
            return no_bank
        return (alive & sdir).any(dim=-1)

    def count_pair(a, b):
        return a.sum(dim=-1), b.sum(dim=-1)

    def first_index(m):
        return torch.argmax(m.to(torch.uint8), dim=-1)

    def clear(idx, emit):
        return (iota_n[None, :] == idx[:, None]) & emit[:, None]

    def step(st):
        k = st.lifo_mask.shape[1]
        running = (st.out < stop_n) & (st.cyc < limit)
        rp = st.pending & running
        spent = no_bank
        len_a, valid_a, col_a, nv_a = st.len, st.valid, st.col, st.nv
        if k == 0:
            valid_a = torch.where(rp[:, None], st.alive, st.valid)
            nv_a = torch.where(rp, st.acnt, st.nv)
            col_a = torch.where(rp, 0, st.col)
        elif ideal_lifo:
            # pop every drained node at once (S12's idealised LIFO)
            live_cnt = (st.lifo_mask & st.alive[:, None, :]).sum(dim=2)
            depth = st.iota_k[None, :] - st.start[:, None]
            depth = torch.where(depth < 0, depth + k, depth)
            keep_lv = (depth < st.len[:, None]) & (live_cnt > 0)
            new_len = torch.where(keep_lv, depth + 1, 0).amax(dim=1)
            has = new_len > 0
            ti = _ring_slot(st.start, (new_len - 1).clamp(min=0), k)
            live = take(st.lifo_mask, ti) & st.alive
            valid_a = torch.where(rp[:, None],
                                  torch.where(has[:, None], live, st.alive),
                                  st.valid)
            nv_a = torch.where(rp, torch.where(has, take(live_cnt, ti),
                                               st.acnt), st.nv)
            col_a = torch.where(rp & has, take(st.lifo_digit, ti),
                                torch.where(rp, 0, st.col))
            len_a = torch.where(rp, new_len, st.len)
        else:
            spent, len_a, valid_a, col_a, nv_a = _reload(
                st, rp, take, count_pair, k)

        act = running & ~spent
        is_dr = act & (nv_a != 1) & (col_a < D)
        row = digits[rows, col_a.clamp(0, D - 1)]           # (B, N) uint8
        if level_bits == 1:
            cnt1s = (valid_a & (row == 1)).sum(dim=-1)
            mixed = (cnt1s > 0) & (cnt1s < nv_a)
            exc = _exclude_bit(col_a, fmt, ascending, neg_pending(st.alive))
            keep = valid_a & (row != exc.to(torch.uint8)[:, None])
            nk = torch.where(exc, nv_a - cnt1s, cnt1s)
            rec = col_a + 1          # binary tree: record the NEXT column
        else:
            row32 = row.to(torch.int32)
            dmin = torch.where(valid_a, row32, _BIG).amin(dim=-1)
            dmax = torch.where(valid_a, row32, -_BIG).amax(dim=-1)
            mixed = dmin != dmax
            sel = dmin if ascending else dmax
            keep = valid_a & (row32 == sel[:, None])
            nk = keep.sum(dim=-1)
            rec = col_a              # quad tree: record the CURRENT column
        _push_and_finish(st, running=running, spent=spent, rp=rp,
                         len_a=len_a, valid_a=valid_a, col_a=col_a,
                         nv_a=nv_a, change=is_dr & mixed, keep=keep, nk=nk,
                         rec=rec, act=act, is_dr=is_dr, D=D,
                         first_index=first_index,
                         clear=clear)

    return step


def _bits32(w: torch.Tensor) -> torch.Tensor:
    """int64 values 0..2^32-1 -> the same 32 bits as int32."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _pack_bits(m: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (..., ceil(N/32)) int32 bits; bit j of word w is
    element w*32+j, pad bits 0."""
    return _bits32(pack_words(m))


def _make_packed_step(digitsW, signW, fmt, ascending, stop_n, limit, n_real):
    """The bit-parallel batched step (binary cells, actual LIFO): the
    N-wide masks and the digit planes live as 32-cell int32 words, the
    all-0s / all-1s periphery becomes a population count and number
    selection a count-trailing-zeros."""
    B, D, Wd = digitsW.shape
    dev = digitsW.device
    rows = torch.arange(B, device=dev)
    iota_w = torch.arange(Wd, device=dev)
    no_bank = torch.zeros(B, dtype=torch.bool, device=dev)
    take = lambda stack, ti: stack[rows, ti]
    sdir = None if signW is None else (signW if ascending else ~signW)

    def count(m):                                        # (B, Wd) -> (B,)
        return popcount(m).sum(dim=-1)

    def count_pair(a, b):
        packed = (popcount(a) + (popcount(b) << 15)).sum(dim=-1)
        return packed & 0x7FFF, packed >> 15

    def neg_pending(aliveW):
        # pad bits are never alive, so ~signW's pad bits do not count; a
        # non-zero word is a non-zero count
        if sdir is None:
            return no_bank
        return ((aliveW & sdir) != 0).any(dim=-1)

    def first_index(m):
        """Lowest set bit across the word row: the first valid cell.
        ctz(w) = popcount((w & -w) - 1) on the word widened to 64 bits;
        an all-zero row gives garbage, masked by ``emit`` downstream."""
        word = torch.argmax((m != 0).to(torch.uint8), dim=-1)
        w = m.gather(-1, word[:, None])[:, 0].to(torch.int64) & _WORD
        ctz = popcount(((w & -w) - 1) & _WORD)
        return word * 32 + ctz

    def clear(idx, emit):
        bit = _bits32(torch.ones_like(idx) << (idx % 32))
        hit = (iota_w[None, :] == (idx // 32)[:, None]) & emit[:, None]
        return torch.where(hit, bit[:, None], 0)

    def step(st):
        k = st.lifo_mask.shape[1]
        running = (st.out < stop_n) & (st.cyc < limit)
        rp = st.pending & running
        spent = no_bank
        len_a, valid_a, col_a, nv_a = st.len, st.valid, st.col, st.nv
        if k == 0:
            valid_a = torch.where(rp[:, None], st.alive, st.valid)
            nv_a = torch.where(rp, st.acnt, st.nv)
            col_a = torch.where(rp, 0, st.col)
        else:
            spent, len_a, valid_a, col_a, nv_a = _reload(
                st, rp, take, count_pair, k)

        act = running & ~spent
        is_dr = act & (nv_a != 1) & (col_a < D)
        row = digitsW[rows, col_a.clamp(0, D - 1)]          # (B, Wd)
        cnt1s = count(valid_a & row)
        mixed = (cnt1s > 0) & (cnt1s < nv_a)
        exc1 = _exclude_bit(col_a, fmt, ascending, neg_pending(st.alive))
        # keep the cells whose digit is not the excluded one: the plane
        # flips where the excluded digit is 1
        keep = valid_a & torch.where(exc1[:, None], ~row, row)
        nk = torch.where(exc1, nv_a - cnt1s, cnt1s)
        _push_and_finish(st, running=running, spent=spent, rp=rp,
                         len_a=len_a, valid_a=valid_a, col_a=col_a,
                         nv_a=nv_a, change=is_dr & mixed, keep=keep, nk=nk,
                         rec=col_a + 1, act=act, is_dr=is_dr, D=D,
                         first_index=first_index,
                         clear=clear)

    return step


def tns_sort_planes_batched(digits: torch.Tensor,
                            sign_bits: Optional[torch.Tensor] = None, *,
                            k: int, fmt: str = bp.UNSIGNED,
                            ascending: bool = True, level_bits: int = 1,
                            ideal_lifo: bool = False,
                            stop_after: Optional[int] = None,
                            unroll: int = UNROLL) -> TnsOut:
    """Run TNS on a (B, D, N) batch of digit-plane tensors on their device,
    B independent banks stepping their controllers in lockstep.  Each
    bank's cycle / DR / reload counts equal :func:`tns_sort_planes`'s;
    finished banks freeze while the others drain.  Every ``TnsOut`` field
    gains a leading B axis.  ``unroll`` controller cycles run between two
    looks at whether any bank still runs (no effect on the results)."""
    if level_bits > 8:
        raise ValueError("batched machine stores digits as uint8: "
                         "level_bits <= 8")
    B, D, N = digits.shape
    if N >= MAX_BATCH_N:
        raise ValueError("batched machine supports N < 32768 per bank")
    dev = digits.device
    stop_n = N if stop_after is None else min(stop_after, N)
    limit = 4 * N * D + 64
    st = _registers(B, N, dev)
    st.iota_n = torch.arange(N, device=dev)
    st.iota_k = torch.arange(max(k, 0), device=dev)
    st.rank = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    st.lifo_digit = torch.zeros((B, max(k, 0)), dtype=torch.int64,
                                device=dev)
    sign = None if sign_bits is None else sign_bits.bool()
    ones = torch.ones((B, N), dtype=torch.bool, device=dev)
    if level_bits == 1 and not ideal_lifo:
        digitsW = _pack_bits(digits != 0)
        st.alive = st.valid = _pack_bits(ones)
        st.lifo_mask = torch.zeros((B, max(k, 0), digitsW.shape[-1]),
                                   dtype=torch.int32, device=dev)
        signW = None if sign is None else _pack_bits(sign)
        step = _make_packed_step(digitsW, signW, fmt, ascending, stop_n,
                                 limit, N)
    else:
        st.alive = st.valid = ones
        st.lifo_mask = torch.zeros((B, max(k, 0), N), dtype=torch.bool,
                                   device=dev)
        sdir = None if sign is None else (sign if ascending else ~sign)
        step = _make_batched_step(digits.to(torch.uint8), sdir, fmt,
                                  ascending, level_bits, ideal_lifo, stop_n,
                                  limit)

    while bool(((st.out < stop_n) & (st.cyc < limit)).any()):
        for _ in range(max(1, unroll)):
            step(st)
    # rank -> perm: perm[b, rank[b, i]] = i (unemitted entries stay -1,
    # routed to a scratch column that is sliced away)
    src = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    tgt = torch.where(st.rank >= 0, st.rank, N).to(torch.int64)
    perm = torch.full((B, N + 1), -1, dtype=torch.int32, device=dev)
    perm = perm.scatter_(1, tgt, src)[:, :N]
    i32 = lambda t: t.to(torch.int32)
    return TnsOut(perm, i32(st.cyc), i32(st.drs), i32(st.rlc))


def tns_sort_batch(values, width: int, k: int, fmt: str = bp.UNSIGNED,
                   ascending: bool = True, level_bits: int = 1,
                   ideal_lifo: bool = False,
                   stop_after: Optional[int] = None, device=None,
                   unroll: int = UNROLL) -> TnsOut:
    """Encode a (B, N) host batch, carry it to ``device`` (the card unless
    named) and run the batched machine there."""
    x = np.asarray(values)
    if x.ndim != 2:
        raise ValueError(f"tns_sort_batch expects a (B, N) batch, "
                         f"got shape {x.shape}")
    dev = backend.resolve_device(device)
    digits, sign = _encode(x, width, fmt, level_bits)
    d, s = _to_device(digits, sign, dev)
    return tns_sort_planes_batched(d, s, k=k, fmt=fmt, ascending=ascending,
                                   level_bits=level_bits,
                                   ideal_lifo=ideal_lifo,
                                   stop_after=stop_after, unroll=unroll)
