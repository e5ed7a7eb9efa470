"""Built-in sort engines of the port — importing this module registers
them.  Every engine returns the SAME permutation for the same input (ties
resolved by lowest index first, the hardware's emission order), and the
same permutation as the reference package's engine it ports:

    reference engine   port engine
    pallas-tns         fused-tns
    tns-oracle         tns-oracle
    pallas-topk        fused-topk
    radix              radix
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import bitplane as bp
from repro_torch.core import radix_select as rs
from repro_torch.core import ref_tns as rt
from repro_torch.kernels import fused_tns, radix_topk
from repro_torch.sort.registry import register
from repro_torch.sort.result import SortResult


def _finish(x, perm, *, engine, fmt, width, k=0, level_bits=1,
            stop_after=None, cycles=None, drs=None, reload_cycles=None,
            strategy=None) -> SortResult:
    perm = np.asarray(perm)
    if stop_after is not None:
        perm = perm[..., :stop_after]
    vals = np.take_along_axis(np.asarray(x), perm, axis=-1)
    asarr = lambda v: None if v is None else np.asarray(v)
    return SortResult(values=vals, indices=perm, engine=engine, fmt=fmt,
                      width=width, n=x.shape[-1], cycles=asarr(cycles),
                      drs=asarr(drs), reload_cycles=asarr(reload_cycles),
                      strategy=strategy, k=k, level_bits=level_bits)


@register("tns-oracle", mode="latency", strategy="tns",
          supports_stop_after=True,
          description="Python event-driven oracle (ground truth the fused "
                      "kernel is cycle-checked against); runs on the host")
def _tns_oracle(x, *, width, fmt, k, ascending, level_bits, stop_after,
                device, ideal_lifo=False):
    out = rt.tns_sort(x, width=width, k=k, fmt=fmt, ascending=ascending,
                      level_bits=level_bits, ideal_lifo=ideal_lifo,
                      stop_after=stop_after)
    return _finish(x, out.perm, engine="tns-oracle", fmt=fmt, width=width,
                   k=k, level_bits=level_bits,
                   cycles=out.cycles, drs=out.drs,
                   reload_cycles=out.reload_cycles, strategy="tns")


@register("fused-tns", mode="throughput", strategy="tns",
          supports_stop_after=True, supports_batch=True,
          description="Fused TNS pipeline: digit read + tree-node skipping "
                      "+ winner write-back in one CUDA kernel; cycle/DR "
                      "parity with the paper's controller")
def _fused_tns(x, *, width, fmt, k, ascending, level_bits, stop_after,
               device):
    if level_bits != 1:
        raise NotImplementedError(
            "fused-tns runs binary (level_bits=1) planes; multi-level "
            "stays on the 'ml' while_loop machine")
    xb = np.asarray(x)
    squeeze = xb.ndim == 1
    if squeeze:
        xb = xb[None]
    n = xb.shape[1]
    if n >= fused_tns.MAX_N:
        raise NotImplementedError(
            "fused-tns supports N < 32768 per bank (one bank's keys live "
            "in one thread block's shared memory)")
    if width > fused_tns.MAX_WIDTH:
        raise NotImplementedError(
            "fused-tns packs a lane's digit column into one int32 key; "
            "width <= 30 required (32-bit data stays on the while_loop "
            "machines)")
    out = fused_tns.fused_tns_sort(
        xb, width=width, k=k, fmt=fmt, ascending=ascending,
        stop_after=stop_after, device=device)
    perm, cycles, drs, rlc = (t.cpu().numpy() for t in (
        out.perm, out.cycles, out.drs, out.reload_cycles))
    if squeeze:
        perm, cycles, drs, rlc = perm[0], cycles[0], drs[0], rlc[0]
    return _finish(x, perm, engine="fused-tns", fmt=fmt, width=width,
                   k=k, stop_after=stop_after, cycles=cycles, drs=drs,
                   reload_cycles=rlc, strategy="tns")


# ---------------------------------------------------------------------------
# Throughput mode (vectorised digit-read machinery)
# ---------------------------------------------------------------------------


def _unsigned_keys(x, width, fmt, ascending) -> np.ndarray:
    keys = bp.sort_key(x, width, fmt)
    if not ascending:
        dt = keys.dtype
        keys = (((~keys.astype(np.uint64)) & np.uint64((1 << width) - 1))
                .astype(dt))
    return keys


@register("radix", mode="throughput", supports_stop_after=True,
          supports_batch=True,
          description="LSB-first counting radix sort over order-preserving "
                      "keys (stable, comparison-free); plain torch on the "
                      "device")
def _radix(x, *, width, fmt, k, ascending, level_bits, stop_after, device,
           r=None):
    keys = _unsigned_keys(x, width, fmt, ascending)
    rr = r or (8 if width % 8 == 0 else 4)
    # the walk covers the key's container, as the reference reads the
    # width from the key dtype
    perm = rs.radix_sort_keys(bp.keys_from_numpy(keys, device=device),
                              r=rr, width=keys.dtype.itemsize * 8)
    return _finish(x, perm.cpu().numpy(), engine="radix", fmt=fmt,
                   width=width, stop_after=stop_after)


@register("fused-topk", mode="throughput", supports_stop_after=True,
          supports_batch=True,
          description="Fused top-k kernel: the k smallest emitted in order, "
                      "as iterated radix-2^4 min-searches find them (CUDA "
                      "warp argmin)")
def _fused_topk(x, *, width, fmt, k, ascending, level_bits, stop_after,
                device):
    keys = _unsigned_keys(x, width, fmt, ascending).astype(np.uint32)
    m = x.shape[-1] if stop_after is None else min(stop_after, x.shape[-1])
    if m > 32:
        # the kernel runs m min-searches a row: a top-m engine, not a full
        # sorter (the router hot path is m <= 8)
        raise NotImplementedError(
            f"fused-topk extracts at most 32 minima per call (asked {m}); "
            "use stop_after, or the 'radix' engine for full sorts")
    kb = bp.keys_from_numpy(keys, device=device)
    squeeze = kb.ndim == 1
    if squeeze:
        kb = kb[None]
    _, idx = radix_topk.topk_keys(kb, m)
    idx = idx.cpu().numpy()
    if squeeze:
        idx = idx[0]
    return _finish(x, idx, engine="fused-topk", fmt=fmt, width=width)
