"""Fused TNS pipeline: digit read -> tree-node-skipping descent -> winner
write-back, a whole sort per instance in one kernel launch.

The CUDA kernel ``csrc/fused_tns.cu`` replaces the Pallas kernel
``repro.kernels.fused_tns._fused_tns_kernel`` and computes the same
emission-episode model (that module's docstring derives it from the
paper's controller), bit-sliced: the digit columns are 32-lane words, one
warp holds a bank, and each episode's descent is a walk over columns with
a warp vote where the TPU kernel takes an argmin over per-lane keys.
:func:`fused_tns_rank_ref` is its plain PyTorch version in the same form,
over (B, W, ceil(N/32)) words with a Python loop, run for CPU tensors and
as the comparison point on the card.

Outputs are a rank ring (rank[i] = emission slot of element i, -1 if
never emitted) and a (B, 8) counter block; the wrappers invert the ring
into the forward permutation with a device scatter.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bitplane as bp
from repro_torch.kernels import _build, backend

# launches of the CUDA kernel in this process (a plain count: a run sets
# it to 0 and reads it back to show which path went through the kernel)
LAUNCHES = 0

# counter columns: the reference's five, then this port's work counters
_CYC, _DRS, _RLC, _UDR, _OUT, _EPI, _LANES = range(7)
_NCNT = 8
_FMT_CODE = {bp.UNSIGNED: 0, bp.TWOS: 1, bp.SIGNMAG: 2, bp.FLOAT: 3}
MAX_N = 1 << 15    # exclusive: a bank's columns fit one block's smem
MAX_WIDTH = 30     # the reference's bound: its keys are int32 words
_WORD = 0xFFFFFFFF  # the plain version's 32-bit words, held in int64


class FusedOut(NamedTuple):
    perm: torch.Tensor           # (B, N) int32 emission order (-1 pad)
    cycles: torch.Tensor         # (B,) int32 controller cycles
    drs: torch.Tensor            # (B,) int32 digit reads (all)
    reload_cycles: torch.Tensor  # (B,) int32 redundant reload cycles
    useful_drs: torch.Tensor     # (B,) int32 mixed reads (caused exclusion)
    episodes: torch.Tensor       # (B,) int32 emission episodes run
    lane_episodes: torch.Tensor  # (B,) int32 alive lanes summed over them


def _shl1(shift: torch.Tensor) -> torch.Tensor:
    """1 << shift, elementwise, in int64."""
    return torch.ones_like(shift, dtype=torch.int64) << shift.to(torch.int64)


def _flip_mask(fmt: str, ascending: bool, width: int,
               neg_pend: torch.Tensor) -> torch.Tensor:
    """Per-instance W-bit word whose bit ``W-1-c`` is the digit the
    machine KEEPS at column ``c`` (the winner's digit wherever some
    contender has it)."""
    msb = 1 << (width - 1)
    low = msb - 1
    if fmt == bp.UNSIGNED:
        v = 0 if ascending else (msb | low)
        return torch.full(neg_pend.shape, v, dtype=torch.int64,
                          device=neg_pend.device)
    if fmt == bp.TWOS:
        v = msb if ascending else low
        return torch.full(neg_pend.shape, v, dtype=torch.int64,
                          device=neg_pend.device)
    base = msb if ascending else 0
    return torch.where(neg_pend, base | low, base).to(torch.int64)


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(B, ..., N) bool -> (B, ..., ceil(N/32)) int64 holding 32-bit words:
    lane i is bit ``i & 31`` of word ``i >> 5``; pad bits are 0."""
    n = bits.shape[-1]
    nw = -(-n // 32)
    pad = bits.new_zeros(bits.shape[:-1] + (nw * 32 - n,))
    b = torch.cat([bits, pad], dim=-1).reshape(bits.shape[:-1] + (nw, 32))
    shift = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (b.to(torch.int64) << shift).sum(dim=-1)


def _lanes(words: torch.Tensor, n: int) -> torch.Tensor:
    """(B, nw) words -> (B, n) bool lanes (the inverse of ``pack_words``)."""
    shift = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words[..., None] >> shift) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n] != 0


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count (int64) of 32-bit words, held in int64 or carried
    as int32 bits."""
    if x.dtype == torch.int32:
        x = x.to(torch.int64) & _WORD
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _WORD) >> 24


def fused_tns_rank_ref(planes: torch.Tensor,
                       sign: Optional[torch.Tensor] = None, *, k: int,
                       fmt: str = bp.UNSIGNED, ascending: bool = True,
                       stop_n: int):
    """Plain version of the fused kernel: (rank (B, N) int32, counters
    (B, 8) int32) for (B, W, N) planes and ``stop_n`` emissions.

    It takes the kernel's steps on the kernel's data: every digit column
    as (B, ceil(N/32)) 32-bit words (held in int64), the alive and sign
    lanes as words, the LIFO's stored set for every column, and each
    episode's descent as a walk over the columns that narrows a candidate
    word set, with an any() or a count where the kernel takes a warp
    reduction.  Banks move in lockstep: a bank's columns before its resume
    column change nothing, and a bank that has emitted ``stop_n`` numbers
    keeps its state."""
    B, W, N = planes.shape
    dev = planes.device
    i64 = torch.int64
    col = pack_words(planes != 0)                    # (B, W, nw)
    ncol = ~col & _WORD
    stored = torch.zeros_like(col)     # the set that reached each column
    alive = pack_words(torch.ones((B, N), dtype=torch.bool, device=dev))
    signed = fmt in (bp.SIGNMAG, bp.FLOAT)
    if signed:
        sgn = (torch.zeros_like(alive) if sign is None
               else pack_words(sign != 0))
        sign_dir = sgn if ascending else ~sgn & _WORD
    iota_w = torch.arange(W, dtype=i64, device=dev)
    pos_w = W - 1 - iota_w                           # column c -> its bit
    rows = torch.arange(B, device=dev)
    zero = torch.zeros((B,), dtype=i64, device=dev)
    pathv, skipv, present = zero.clone(), zero.clone(), zero.clone()
    rank = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    out, cyc, drs, rlc, udr, epi, lanes = (zero.clone() for _ in range(7))

    def any_(words):
        return (words != 0).any(dim=-1)

    for _ in range(stop_n):
        running = out < stop_n
        if not bool(running.any()):
            break
        epi = epi + running.to(i64)
        lanes = lanes + torch.where(running, N - out, 0)

        # ---- reload: a present node is live iff its stored set still holds
        # an alive lane; the deepest live one is resumed with that set
        m0, col0 = alive, zero
        if k > 0:
            sets = stored & alive[:, None, :]
            size = popcount(sets).sum(dim=2)         # (B, W)
            live = (((present[:, None] >> pos_w) & 1) != 0) & (size > 0)
            c_res = torch.where(live, iota_w, -1).amax(dim=1)
            hit, at = c_res >= 0, c_res.clamp(min=0)
            m0 = torch.where(hit[:, None], sets[rows, at], alive)
            pos_res = W - 1 - c_res                  # c_res == -1 -> W
            below = _shl1(pos_res) - 1               # columns deeper
            drained = present & below
            spent = torch.where(running,
                                (popcount(drained) - 1).clamp(min=0), 0)
            present = torch.where(running, present & ~drained, present)
            # the resumed column holds the PRE-exclusion set: it becomes a
            # prefix hole; holes deeper belong to popped subtrees
            resume = torch.where(hit, _shl1(pos_res), 0)
            skipv = torch.where(running, (skipv & ~below) | resume, skipv)
            col0 = c_res + 1
            cyc = cyc + spent
            rlc = rlc + spent

        # ---- descent from col0 (no holes from there on): at each column
        # keep the lanes with the kept digit if any has it; the column is
        # mixed when some lanes have it and some do not
        if signed:
            neg_pend = any_(alive & sign_dir)
        else:
            neg_pend = torch.zeros((B,), dtype=torch.bool, device=dev)
        flipv = _flip_mask(fmt, ascending, W, neg_pend)
        kept = ((flipv[:, None] >> pos_w) & 1) != 0  # (B, W)
        m, some_kept, mixed = m0, [], []
        for c in range(W):
            z = m & torch.where(kept[:, c, None], col[:, c], ncol[:, c])
            anyz = any_(z)
            mix = (col0 <= c) & anyz & any_(m ^ z)
            if k > 0:
                stored[:, c] = torch.where(mix[:, None], m, stored[:, c])
            m = torch.where(mix[:, None], z, m)
            some_kept.append(anyz)
            mixed.append(mix)
        mixed = torch.stack(mixed, dim=1)
        bits = torch.ones_like(pos_w) << pos_w
        eb = (mixed * bits).sum(dim=1)
        dm = torch.where(mixed, iota_w, -1).amax(dim=1)  # deepest mixed
        # the winner's digit: the kept one where some lane had it
        wdig = ~((torch.stack(some_kept, dim=1) * bits).sum(dim=1) ^ flipv)
        t = popcount(m).sum(dim=1)                   # the winner tie set
        # deepest column still read: W-1 when the winner is a tie, else
        # the deepest mixed one
        cend = torch.where(t >= 2, W - 1, dm)
        ep_drs = torch.where(running, (cend - col0 + 1).clamp(min=0), 0)
        rm = torch.where(running & (cend >= col0),
                         _shl1(W - col0) - _shl1(W - 1 - cend), 0)
        ebits = eb & rm
        udr = udr + popcount(ebits)
        if k > 0:
            pathv = torch.where(running, (pathv & ~rm) | (wdig & rm), pathv)
            # pushes at the mixed columns; drop-oldest keeps the deepest
            # k, the k lowest set bits
            u, kept_k = present | ebits, zero
            for _j in range(min(k, W)):
                low = u & -u
                kept_k, u = kept_k | low, u ^ low
            present = torch.where(running, kept_k, present)

        # ---- emission: the first r winners, consecutive ranks, in index
        # order
        r = torch.where(running, torch.minimum(t, stop_n - out), 0)
        win = _lanes(m, N).to(i64)
        p = win.cumsum(dim=1) - win
        emit = (win != 0) & (p < r[:, None])
        rank = torch.where(emit, (out[:, None] + p).to(torch.int32), rank)
        alive = alive & ~pack_words(emit)
        out = out + r
        emit_cyc = torch.where(ep_drs == 0, torch.where(t > 1, r, 1),
                               (r - 1).clamp(min=0))
        cyc = cyc + torch.where(running, emit_cyc, 0) + ep_drs
        drs = drs + ep_drs

    cnt = torch.stack([cyc, drs, rlc, udr, out, epi, lanes, zero], dim=1)
    return rank, cnt.to(torch.int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_tns")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_tns_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.fused_tns_launch.restype = ctypes.c_int
    lib.fused_tns_error_string.argtypes = [ctypes.c_int]
    lib.fused_tns_error_string.restype = ctypes.c_char_p
    return lib


def _launch(planes, sign, *, k, fmt, ascending, stop_n):
    global LAUNCHES
    B, W, N = planes.shape
    rank = torch.empty((B, N), dtype=torch.int32, device=planes.device)
    cnt = torch.empty((B, _NCNT), dtype=torch.int32, device=planes.device)
    lib = _lib()
    with torch.cuda.device(planes.device):
        status = lib.fused_tns_launch(
            planes.data_ptr(), None if sign is None else sign.data_ptr(),
            rank.data_ptr(), cnt.data_ptr(), B, W, N, k, _FMT_CODE[fmt],
            int(ascending), stop_n, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("fused_tns launch failed: "
                           + lib.fused_tns_error_string(status).decode())
    LAUNCHES += 1
    return rank, cnt


def fused_tns_rank(planes: torch.Tensor, sign: Optional[torch.Tensor] = None,
                   *, k: int, fmt: str = bp.UNSIGNED, ascending: bool = True,
                   stop_after: Optional[int] = None):
    """The raw (rank ring, counter block) of the fused TNS controller over
    (B, W, N) uint8 planes and an optional (B, N) uint8 sign plane.  A
    CUDA tensor runs the kernel, a CPU tensor the plain version."""
    if not isinstance(planes, torch.Tensor) or planes.dtype != torch.uint8:
        raise TypeError("planes must be a uint8 tensor")
    if planes.ndim != 3:
        raise ValueError(f"planes must be (B, W, N), got {tuple(planes.shape)}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    B, W, N = planes.shape
    if not 1 <= W <= MAX_WIDTH:
        raise ValueError(f"digit keys are packed into int32 words: "
                         f"1 <= W <= {MAX_WIDTH}, got W={W}")
    if not 1 <= N < MAX_N:
        raise ValueError(f"fused TNS takes 1 <= N < {MAX_N}, got N={N}")
    if fmt not in _FMT_CODE:
        raise ValueError(f"unknown format {fmt!r}")
    if k < 0:
        raise ValueError(f"LIFO depth k must be >= 0, got {k}")
    if sign is not None:
        if sign.dtype != torch.uint8 or tuple(sign.shape) != (B, N):
            raise ValueError(f"sign must be a (B, N) = {(B, N)} uint8 tensor")
        if sign.device != planes.device or not sign.is_contiguous():
            raise ValueError("sign must be contiguous, on the planes' device")
    stop_n = N if stop_after is None else min(stop_after, N)
    stop_n = max(stop_n, 1)
    call = dict(k=k, fmt=fmt, ascending=ascending, stop_n=stop_n)
    if backend.uses_kernel(planes):
        return _launch(planes, sign, **call)
    return fused_tns_rank_ref(planes, sign, **call)


def rank_to_perm(rank: torch.Tensor) -> torch.Tensor:
    """Invert a (B, N) rank ring into the forward permutation (-1 pad for
    slots never filled), with one scatter on the ring's device."""
    B, N = rank.shape
    src = torch.arange(N, dtype=torch.int32, device=rank.device).expand(B, N)
    tgt = torch.where(rank >= 0, rank, N).to(torch.int64)
    perm = torch.full((B, N + 1), -1, dtype=torch.int32, device=rank.device)
    return perm.scatter_(1, tgt, src)[:, :N]


def fused_tns_planes(planes: torch.Tensor,
                     sign: Optional[torch.Tensor] = None, *, k: int,
                     fmt: str = bp.UNSIGNED, ascending: bool = True,
                     stop_after: Optional[int] = None) -> FusedOut:
    """Run the fused TNS controller on (B, W, N) bit-planes (MSB first, the
    physical array image) on their device.  Cycle / DR / reload counts
    match the paper's controller exactly; ``useful_drs`` counts only the
    mixed reads."""
    rank, cnt = fused_tns_rank(planes, sign, k=k, fmt=fmt,
                               ascending=ascending, stop_after=stop_after)
    return FusedOut(rank_to_perm(rank), cnt[:, _CYC], cnt[:, _DRS],
                    cnt[:, _RLC], cnt[:, _UDR], cnt[:, _EPI],
                    cnt[:, _LANES])


def fused_tns_sort(values, *, width: int, k: int, fmt: str = bp.UNSIGNED,
                   ascending: bool = True, level_bits: int = 1,
                   stop_after: Optional[int] = None,
                   device=None) -> FusedOut:
    """Encode a (B, N) host batch like programming the memristor array
    (through the fault-injectable ``bitplane.read_planes``), carry it to
    ``device`` (the card unless named) and run the fused controller."""
    if level_bits != 1:
        raise NotImplementedError(
            "fused TNS runs binary (level_bits=1) planes; multi-level "
            "stays on the while_loop machine")
    x = np.asarray(values)
    if x.ndim != 2:
        raise ValueError(f"fused_tns_sort expects a (B, N) batch, "
                         f"got shape {x.shape}")
    dev = backend.resolve_device(device)
    digits = bp.read_planes(bp.to_bitplanes(x, width, fmt), kind="bit",
                            level_bits=1)
    digits = (np.asarray(digits) != 0).astype(np.uint8)
    sign = (bp.sign_plane(x, width, fmt)
            if fmt in (bp.SIGNMAG, bp.FLOAT) else None)
    planes, sign_t = bp.planes_from_numpy(digits, sign, device=dev)
    return fused_tns_planes(planes, sign_t, k=k, fmt=fmt,
                            ascending=ascending, stop_after=stop_after)
