"""Built-in sort engines of the port — importing this module registers
them.  Every engine returns the SAME permutation for the same input (ties
resolved by lowest index first, the hardware's emission order), and the
same permutation as the reference package's engine it ports:

    reference engine   port engine
    tns                tns
    ml                 ml
    mb                 mb
    bts                bts
    bitslice           bitslice
    pallas-tns         fused-tns
    tns-oracle         tns-oracle
    pallas-topk        fused-topk
    radix              radix
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import bitplane as bp
from repro_torch.core import catns
from repro_torch.core import radix_select as rs
from repro_torch.core import ref_tns as rt
from repro_torch.core import tns as tt
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


# ---------------------------------------------------------------------------
# Latency mode (cycle-faithful controllers)
# ---------------------------------------------------------------------------


def _host(out: tt.TnsOut) -> tt.TnsOut:
    return tt.TnsOut(*(t.cpu().numpy() for t in out))


@register("tns", mode="latency", strategy="tns", supports_stop_after=True,
          supports_batch=True,
          description="Cycle-faithful TNS (plain torch on the device; "
                      "batched bit-parallel machine for (B, N) inputs)")
def _tns(x, *, width, fmt, k, ascending, level_bits, stop_after, device,
         ideal_lifo=False):
    call = dict(width=width, k=k, fmt=fmt, ascending=ascending,
                level_bits=level_bits, ideal_lifo=ideal_lifo,
                stop_after=stop_after, device=device)
    if x.ndim == 2 and x.shape[-1] < tt.MAX_BATCH_N:
        out = _host(tt.tns_sort_batch(x, **call))
    elif x.ndim == 2:
        # the batched machine's packed counts cap N per bank at 2^15;
        # larger banks run one instance after another
        outs = [_host(tt.tns_sort(x[b], **call)) for b in range(x.shape[0])]
        out = tt.TnsOut(*(np.stack([getattr(o, f) for o in outs])
                          for f in tt.TnsOut._fields))
    else:
        out = _host(tt.tns_sort(x, **call))
    return _finish(x, out.perm, engine="tns", fmt=fmt, width=width, k=k,
                   level_bits=level_bits, stop_after=stop_after,
                   cycles=out.cycles, drs=out.drs,
                   reload_cycles=out.reload_cycles, strategy="tns")


@register("ml", mode="latency", strategy="ml", supports_stop_after=True,
          supports_batch=True,
          description="Multi-level TNS (§2.3.3): radix-2^n cells, fewer "
                      "digit reads per number")
def _ml(x, *, width, fmt, k, ascending, level_bits, stop_after, device):
    lb = level_bits if level_bits > 1 else 4
    # a radix-2^n digit straddles the sign/exponent bits, so signed and
    # float formats are first linearised to order-preserving unsigned keys
    # (S6's exclusion polarity folded into the encoding)
    keys = bp.sort_key(x, width, fmt)
    res = _tns(keys, width=width, fmt=bp.UNSIGNED, k=k, ascending=ascending,
               level_bits=lb, stop_after=stop_after, device=device)
    res.values = np.take_along_axis(np.asarray(x), res.indices, axis=-1)
    res.engine, res.strategy, res.fmt = "ml", "ml", fmt
    return res


@register("mb", mode="latency", strategy="mb", supports_stop_after=True,
          supports_batch=True,
          description="Multi-bank CA-TNS (§2.3.1): cycle-identical to TNS "
                      "(eq. 2) at the multi-bank operating point; banks "
                      "shard N")
def _mb(x, *, width, fmt, k, ascending, level_bits, stop_after, device,
        banks=2):
    res = _tns(x, width=width, fmt=fmt, k=k, ascending=ascending,
               level_bits=level_bits, stop_after=stop_after, device=device)
    res.engine, res.strategy, res.banks = "mb", "mb", banks
    return res


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


@register("bts", mode="latency", strategy="bts",
          supports_stop_after=True,
          description="Bit-traversal sort baseline (prior art [42]): every "
                      "min search restarts at the MSB; N*W cycles")
def _bts(x, *, width, fmt, k, ascending, level_bits, stop_after, device):
    out = _host(catns.bts_sort(x, width=width, fmt=fmt, ascending=ascending,
                               device=device))
    m = x.shape[-1] if stop_after is None else min(stop_after, x.shape[-1])
    # BTS latency is exactly W cycles per emitted number (one DR a cycle),
    # so stopping after m numbers is m*W cycles
    return _finish(x, out.perm, engine="bts", fmt=fmt, width=width,
                   stop_after=stop_after, cycles=m * width, drs=m * width,
                   reload_cycles=0, strategy="bts")


@register("bitslice", mode="latency", strategy="bs",
          formats=(bp.UNSIGNED,),
          description="Bit-slice CA-TNS (§2.3.2): pipelined upper/lower "
                      "slice arrays (event-driven oracle on the host; "
                      "unsigned ascending)")
def _bitslice(x, *, width, fmt, k, ascending, level_bits, stop_after,
              device, slice_widths=None):
    if not ascending:
        raise NotImplementedError("bitslice oracle models ascending sorts")
    if slice_widths is None:
        slice_widths = [width // 2, width - width // 2]
    out = rt.bitslice_sort(x, width=width, k=max(k, 1),
                           slice_widths=list(slice_widths))
    # stop_after truncates the emission (cycles stay full-pipeline: the
    # slices drain concurrently, so early-stop savings are sub-linear)
    return _finish(x, out.perm, engine="bitslice", fmt=fmt, width=width,
                   k=k, stop_after=stop_after, cycles=out.cycles,
                   drs=out.drs, reload_cycles=out.reload_cycles,
                   strategy="bs")


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
