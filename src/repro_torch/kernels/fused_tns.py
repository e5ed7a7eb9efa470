"""Fused TNS pipeline: digit read -> tree-node-skipping descent -> winner
write-back, a whole sort per instance in one kernel launch.

The CUDA kernel ``csrc/fused_tns.cu`` replaces the Pallas kernel
``repro.kernels.fused_tns._fused_tns_kernel`` and replays the same
emission-episode model (that module's docstring derives it from the
paper's controller).  :func:`fused_tns_rank_ref` is its plain PyTorch
version: the same episodes over (B, N) int32 tensors with a Python loop,
run for CPU tensors and as the comparison point on the card.

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
MAX_N = 1 << 15    # exclusive: one instance's keys fill one block's smem
MAX_WIDTH = 30     # a lane's digit column is packed into one int32 key


class FusedOut(NamedTuple):
    perm: torch.Tensor           # (B, N) int32 emission order (-1 pad)
    cycles: torch.Tensor         # (B,) int32 controller cycles
    drs: torch.Tensor            # (B,) int32 digit reads (all)
    reload_cycles: torch.Tensor  # (B,) int32 redundant reload cycles
    useful_drs: torch.Tensor     # (B,) int32 mixed reads (caused exclusion)
    episodes: torch.Tensor       # (B,) int32 emission episodes run
    lane_episodes: torch.Tensor  # (B,) int32 alive lanes summed over them


def _bitlength(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int32 ``x`` (0 -> 0), from the float64
    exponent (exact for every int32)."""
    e = (x.double().view(torch.int64) >> 52) & 0x7FF
    return torch.where(x == 0, 0, e - 1022).to(torch.int32)


def _shl1(shift: torch.Tensor) -> torch.Tensor:
    """1 << shift, elementwise, in int32."""
    return torch.ones_like(shift, dtype=torch.int32) << shift.to(torch.int32)


def _flip_mask(fmt: str, ascending: bool, width: int,
               neg_pend: torch.Tensor) -> torch.Tensor:
    """Per-instance XOR mask turning the digit word into a key whose
    integer minimum is the machine's descent winner (bit ``W-1-c`` is the
    KEPT digit at column ``c``)."""
    msb = 1 << (width - 1)
    low = msb - 1
    if fmt == bp.UNSIGNED:
        v = 0 if ascending else (msb | low)
        return torch.full(neg_pend.shape, v, dtype=torch.int32,
                          device=neg_pend.device)
    if fmt == bp.TWOS:
        v = msb if ascending else low
        return torch.full(neg_pend.shape, v, dtype=torch.int32,
                          device=neg_pend.device)
    base = msb if ascending else 0
    return torch.where(neg_pend, base | low, base).to(torch.int32)


def fused_tns_rank_ref(planes: torch.Tensor,
                       sign: Optional[torch.Tensor] = None, *, k: int,
                       fmt: str = bp.UNSIGNED, ascending: bool = True,
                       stop_n: int):
    """Plain version of the fused kernel: (rank (B, N) int32, counters
    (B, 8) int32) for (B, W, N) planes and ``stop_n`` emissions."""
    B, W, N = planes.shape
    dev = planes.device
    i32 = torch.int32
    key = torch.zeros((B, N), dtype=i32, device=dev)
    for c in range(W):
        key = (key << 1) | (planes[:, c, :] != 0).to(i32)
    signed = fmt in (bp.SIGNMAG, bp.FLOAT)
    if signed:
        sgn = (torch.zeros((B, N), dtype=torch.bool, device=dev)
               if sign is None else sign != 0)
        sign_dir = sgn if ascending else ~sgn
    wmask = (1 << W) - 1
    imax = torch.iinfo(i32).max
    iota_w = torch.arange(W, dtype=i32, device=dev)
    alive = torch.ones((B, N), dtype=torch.bool, device=dev)
    zero = torch.zeros((B,), dtype=i32, device=dev)
    pathv, skipv = zero.clone(), zero.clone()
    present = torch.zeros((B, W), dtype=torch.bool, device=dev)
    rank = torch.full((B, N), -1, dtype=i32, device=dev)
    out, cyc, drs, rlc, udr, epi, lanes = (zero.clone() for _ in range(7))

    for _ in range(stop_n):
        running = out < stop_n
        if not bool(running.any()):
            break
        run2 = running[:, None]
        epi = epi + running.to(i32)
        lanes = lanes + torch.where(running, N - out, 0).to(i32)

        # ---- reload: pop drained nodes, resume the deepest live one
        if k > 0:
            md = (key ^ pathv[:, None]) & (~skipv & wmask)[:, None]
            depth = W - _bitlength(md)
            c_max = torch.where(alive, depth, 0).amax(dim=1)
            live_lvl = present & (iota_w <= c_max[:, None])
            c_res = torch.where(live_lvl, iota_w, -1).amax(dim=1).to(i32)
            drained = present & (iota_w > c_res[:, None])
            d = drained.sum(dim=1).to(i32)
            spent = torch.where(running, (d - 1).clamp(min=0), 0).to(i32)
            present = torch.where(
                run2, present & (iota_w <= c_res[:, None]), present)
            m0 = alive & (depth >= c_res[:, None])
            pos_res = W - 1 - c_res                 # c_res == -1 -> W
            keepm = ~(_shl1(pos_res) - 1)
            resume = torch.where(c_res >= 0, _shl1(pos_res), 0).to(i32)
            skipv = torch.where(running, (skipv & keepm) | resume, skipv)
            col0 = c_res + 1
            cyc = cyc + spent
            rlc = rlc + spent
        else:
            col0 = zero
            m0 = alive

        # ---- descent: argmin of key ^ flip over the resumed set
        if signed:
            neg_pend = (alive & sign_dir).any(dim=1)
        else:
            neg_pend = torch.zeros((B,), dtype=torch.bool, device=dev)
        flipv = _flip_mask(fmt, ascending, W, neg_pend)
        cmask = (~skipv & wmask)[:, None] if k > 0 else wmask
        ckey = torch.where(m0, (key ^ flipv[:, None]) & cmask, imax)
        kmin = ckey.amin(dim=1)
        isw = ckey == kmin[:, None]
        t = isw.sum(dim=1).to(i32)
        bl = _bitlength(ckey ^ kmin[:, None])
        loser = m0 & ~isw
        dm = torch.where(loser, W - bl, -1).amax(dim=1)
        cend = torch.where(t >= 2, W, dm).clamp(max=W - 1).to(i32)
        ep_drs = torch.where(running, (cend - col0 + 1).clamp(min=0),
                             0).to(i32)
        rm = torch.where(running & (cend >= col0),
                         _shl1(W - col0) - _shl1(W - 1 - cend), 0).to(i32)
        # OR of the losers' divergence bits: any over a one-hot of bl - 1
        hit = (loser[:, :, None] & ((bl - 1)[:, :, None] == iota_w)).any(1)
        ebits = (hit.to(i32) << iota_w).sum(dim=1).to(i32) & rm
        udr = udr + sum(((ebits >> j) & 1) for j in range(W))
        if k > 0:
            pathv = torch.where(
                running, (pathv & ~rm) | ((kmin ^ flipv) & rm), pathv)
            # pushes at the mixed columns; drop-oldest keeps the deepest k
            mixed_w = ((ebits[:, None] >> (W - 1 - iota_w)) & 1) != 0
            union = present | mixed_w
            sfx = union.flip(1).to(i32).cumsum(dim=1, dtype=i32).flip(1)
            present = torch.where(run2, union & (sfx <= k), present)

        # ---- emission: whole tie set, consecutive index-order ranks
        r = torch.minimum(t, (stop_n - out).clamp(min=0))
        isw_i = isw.to(i32)
        p = isw_i.cumsum(dim=1, dtype=i32) - isw_i
        emit_now = isw & (p < r[:, None]) & run2
        rank = torch.where(emit_now, out[:, None] + p, rank)
        alive = alive & ~emit_now
        out = out + torch.where(running, r, 0).to(i32)
        emit_cyc = torch.where(ep_drs == 0, torch.where(t > 1, r, 1),
                               (r - 1).clamp(min=0))
        cyc = cyc + torch.where(running, emit_cyc, 0).to(i32) + ep_drs
        drs = drs + ep_drs

    cnt = torch.stack([cyc, drs, rlc, udr, out, epi, lanes, zero], dim=1)
    return rank, cnt.to(i32)


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
