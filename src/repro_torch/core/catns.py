"""Cross-array TNS (CA-TNS) strategies in PyTorch (paper §2.3).

* **Multi-bank** (§2.3.1): the dataset is sharded by numbers over banks;
  each bank runs the TNS controller on its local slice, and the paper's
  cross-array processor, which ORs the not-all-0s / not-all-1s / load
  signals across banks, becomes a sum or a min over the bank axis each
  cycle.  The banks are the leading axis of one tensor on one device.
  Cycle for cycle identical to basic TNS (eq. 2), which the tests assert.

* **Bit-slice** (§2.3.2): the pipelined cycle count is the event-driven
  oracle's (``ref_tns.bitslice_sort``); here is the paper's eq. (4)
  estimate.

* **Multi-level** (§2.3.3) is native to the machines (``level_bits > 1``
  in :mod:`repro_torch.core.tns`).

* **BTS** baseline (prior art [42]) on the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import bitplane as bp
from repro_torch.core import tns as tt
from repro_torch.kernels import backend

_BIG = 1 << 30


# ---------------------------------------------------------------------------
# BTS baseline (S3): every min search walks MSB -> LSB; N*W cycles.
# ---------------------------------------------------------------------------


def bts_sort_planes(digits: torch.Tensor,
                    sign_bits: Optional[torch.Tensor] = None, *,
                    fmt: str = bp.UNSIGNED,
                    ascending: bool = True) -> tt.TnsOut:
    """BTS over a (D, N) bit-plane tensor on its device: N min searches of
    D column steps each, with no decision taken on the host."""
    D, N = digits.shape
    dev = digits.device
    sdir = None
    if sign_bits is not None:
        sdir = sign_bits.bool() if ascending else ~sign_bits.bool()
    iota = torch.arange(N, device=dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    perm = torch.full((N,), -1, dtype=torch.int32, device=dev)
    excs = [tt._exclude_value(c, fmt, ascending, False) for c in range(D)]
    exc_neg = [tt._exclude_value(c, fmt, ascending, True) for c in range(D)]
    for out in range(N):
        # alive is fixed within a search, so is the pending-negative flag
        npend = (alive & sdir).any() if sdir is not None else None
        valid = alive
        for col in range(D):
            row = digits[col]
            mixed = (valid & (row == 1)).any() & (valid & (row == 0)).any()
            exc = excs[col]
            if npend is not None and excs[col] != exc_neg[col]:
                exc = torch.where(npend, exc_neg[col], excs[col])
            valid = torch.where(mixed, valid & (row != exc), valid)
        idx = torch.argmax(valid.to(torch.uint8))
        perm[out] = idx.to(torch.int32)
        alive = alive & (iota != idx)
    cycles = torch.tensor(N * D, dtype=torch.int32, device=dev)
    return tt.TnsOut(perm, cycles, cycles.clone(), torch.zeros_like(cycles))


def bts_sort(values, width: int, fmt: str = bp.UNSIGNED,
             ascending: bool = True, device=None) -> tt.TnsOut:
    dev = backend.resolve_device(device)
    digits, sign = tt._encode(np.asarray(values), width, fmt, 1)
    d, s = tt._to_device(digits, sign, dev)
    return bts_sort_planes(d, s, fmt=fmt, ascending=ascending)


# ---------------------------------------------------------------------------
# Multi-bank CA-TNS: banks on a leading tensor axis.
# ---------------------------------------------------------------------------


def multibank_sort_planes(digits: torch.Tensor,
                          sign_bits: Optional[torch.Tensor] = None, *,
                          banks: int, k: int, fmt: str = bp.UNSIGNED,
                          ascending: bool = True, level_bits: int = 1):
    """Synchronised multi-bank TNS over ``banks`` banks of the (D, N)
    planes on their device.  N must divide evenly by ``banks``.  Each bank
    holds its (Nl,) slice of the alive / valid masks and of every LIFO
    status record; the controller registers are shared (identical in
    every bank), and each control decision reduces the banks' local
    signals with a sum (the OR of not-all-0s / not-all-1s / load) or a min
    (the first emitted index, the multi-level digit extremes).  Returns
    (rank, cycles, drs, reload_cycles): ``rank[i]`` is the emission
    position of element i, the inverse permutation."""
    D, N = digits.shape
    if banks < 1 or N % banks:
        raise ValueError(f"pad N = {N} to a multiple of the bank count "
                         f"{banks}")
    dev = digits.device
    nl = N // banks
    # (banks, D, Nl): bank b holds numbers b*Nl .. (b+1)*Nl - 1
    local = digits.reshape(D, banks, nl).permute(1, 0, 2).to(torch.int32)
    sdir = None
    if sign_bits is not None:
        s = sign_bits.bool().reshape(banks, nl)
        sdir = s if ascending else ~s
    offset = torch.arange(banks, device=dev)[:, None] * nl    # (banks, 1)
    iota_l = torch.arange(nl, device=dev)[None, :]

    def gsum(m):
        """Cross-array sum: each bank's local count, then over banks."""
        return m.sum(dim=1).sum()

    def emit_global_first(mask, alive, valid, rank, out):
        """Emit the globally lowest-index member of ``mask`` (synchronised
        across banks, S8.1 cycle 4)."""
        local_first = torch.where(mask.any(dim=1),
                                  torch.argmax(mask.to(torch.uint8), dim=1),
                                  _BIG)
        gidx = (local_first[:, None] + offset).min()
        clear = (iota_l + offset) == gidx
        rank = torch.where(clear, out, rank)
        return alive & ~clear, valid & ~clear, rank

    alive = torch.ones((banks, nl), dtype=torch.bool, device=dev)
    valid = alive
    nv = acnt = N
    col = 0
    lifo = []
    pending = False
    rank = torch.full((banks, nl), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out = cycles = drs = reload_cycles = 0
    limit = 4 * N * D + 64
    while out < N and cycles < limit:
        cycles += 1
        if pending:
            pending = False
            if k == 0 or not lifo:
                valid, nv, col = alive, acnt, 0
            else:
                top = lifo[-1][0] & alive
                below = lifo[-2][0] & alive if len(lifo) > 1 else None
                c_top, c_below = torch.stack([
                    gsum(top),
                    zero if below is None else gsum(below)]).tolist()
                drained0 = c_top == 0        # the load check is synchronised
                len1 = len(lifo) - 1 if drained0 else len(lifo)
                live1, c1 = (below, c_below) if drained0 else (top, c_top)
                del lifo[len1:]
                if drained0 and len1 > 0 and c1 == 0:
                    pending = True
                    reload_cycles += 1
                    continue
                if len1:
                    valid, nv, col = live1, c1, lifo[-1][1]
                else:
                    valid, nv, col = alive, acnt, 0

        if nv == 1 or col >= D:
            # the last number (phase 2), or the repeat-mode drain (phase 3):
            # both emit the first member of valid
            alive, valid, rank = emit_global_first(valid, alive, valid, rank,
                                                   out)
            out, acnt, nv = out + 1, acnt - 1, nv - 1
            pending = nv == 0 and acnt > 0
            continue
        row = local[:, col]                               # (banks, Nl)
        drs += 1
        if level_bits == 1:
            c1s, c0s, neg = torch.stack([
                gsum(valid & (row == 1)), gsum(valid & (row == 0)),
                zero if sdir is None else gsum(alive & sdir)]).tolist()
            mixed = c1s > 0 and c0s > 0
            exc = tt._exclude_value(col, fmt, ascending, neg > 0)
            keep = valid & (row != exc)
            nk = nv - (c1s if exc == 1 else c0s)
            rec = col + 1
        else:
            dmin, dmax = torch.stack([
                torch.where(valid, row, _BIG).amin(dim=1).min(),
                torch.where(valid, row, -_BIG).amax(dim=1).max()]).tolist()
            mixed = dmin != dmax
            keep = valid & (row == (dmin if ascending else dmax))
            nk = int(gsum(keep)) if mixed else nv
            rec = col
        if mixed:
            if k > 0:
                if len(lifo) >= k:
                    del lifo[0]
                lifo.append([valid, rec])
            valid, nv = keep, nk
        if nv == 1 or col == D - 1:
            # the last number, or duplicates at the LSB: emit one
            alive, valid, rank = emit_global_first(valid, alive, valid, rank,
                                                   out)
            out, acnt, nv = out + 1, acnt - 1, nv - 1
            pending = nv == 0 and acnt > 0
            if nv > 0:
                col = D
        else:
            col += 1
    as_t = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return (rank.reshape(N), as_t(cycles), as_t(drs), as_t(reload_cycles))


def multibank_sort(values, width: int, k: int, *, banks: int,
                   fmt: str = bp.UNSIGNED, ascending: bool = True,
                   level_bits: int = 1, device=None) -> tt.TnsOut:
    """Encode ``values`` (read through ``read_planes`` with the bank
    layout), run the multi-bank machine on ``device`` (the card unless
    named) and return the forward permutation with the counts."""
    dev = backend.resolve_device(device)
    digits, sign = tt._encode(np.asarray(values), width, fmt, level_bits,
                              banks=banks)
    d, s = tt._to_device(digits, sign, dev)
    rank, cycles, drs, rl = multibank_sort_planes(
        d, s, banks=banks, k=k, fmt=fmt, ascending=ascending,
        level_bits=level_bits)
    perm = torch.empty_like(rank)
    perm[rank.long()] = torch.arange(rank.numel(), dtype=rank.dtype,
                                     device=dev)
    return tt.TnsOut(perm, cycles, drs, rl)


# ---------------------------------------------------------------------------
# Bit-slice: the eq. (4) latency estimate.
# ---------------------------------------------------------------------------


def bitslice_estimate_cycles(values, width: int, k: int, slice_widths,
                             fmt: str = bp.UNSIGNED, device=None) -> dict:
    """Paper eq. (4): T_bs ~= max_i T_TNS(N, W_i), estimated from
    per-slice TNS runs on the same dataset truncated to each slice; the
    exact pipelined count comes from ``ref_tns.bitslice_sort``."""
    x = np.asarray(values)
    u = bp.raw_bits(x, width, fmt).astype(np.uint64)
    offs = np.cumsum([0] + list(slice_widths))
    per_slice = []
    for i, w in enumerate(slice_widths):
        shift = np.uint64(width - offs[i + 1])
        part = ((u >> shift) & np.uint64((1 << w) - 1)).astype(np.uint32)
        out = tt.tns_sort(part, width=w, k=k, device=device)
        per_slice.append(int(out.cycles))
    return {"per_slice": per_slice, "estimate": max(per_slice)}
