"""The sort-engine front door of the port::

    from repro_torch import sort
    res = sort.sort(x, k=4)                    # the "tns" machine, on the card
    res = sort.sort(x, engine="fused-tns", k=4)          # the CUDA kernel
    res = sort.sort(batch, engine="fused-tns", stop_after=8)   # (B, N)
    res = sort.sort(x, engine="fused-tns", device="cpu")  # plain versions
    vals, idx = sort.topk(logits, 6, engine="fused-topk")   # tensors
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bitplane as bp
from repro_torch.core import radix_select as rs
from repro_torch.kernels import backend
from repro_torch.runtime import spans
from repro_torch.sort.registry import available_engines, get_engine
from repro_torch.sort.result import SortResult


def _infer_fmt_width(x: np.ndarray, fmt: Optional[str],
                     width: Optional[int]) -> Tuple[str, int]:
    """Auto-encode: map the ndarray dtype onto the paper's data types
    (§2.2.2) — floats to IEEE bit-planes, signed ints to two's complement,
    unsigned ints to plain binary."""
    if fmt is None:
        if np.issubdtype(x.dtype, np.floating):
            fmt = bp.FLOAT
        elif np.issubdtype(x.dtype, np.signedinteger):
            fmt = bp.TWOS
        else:
            fmt = bp.UNSIGNED
    if width is None:
        if fmt == bp.FLOAT:
            width = 16 if x.dtype == np.float16 else 32
        else:
            w = x.dtype.itemsize * 8
            if w > 32:
                # numpy default container is 64-bit; shrink to the
                # smallest paper width that holds the data — never
                # silently truncate values that genuinely need > 32 bits
                amax = int(np.max(np.abs(x))) if x.size else 0
                need = amax.bit_length() + (1 if fmt != bp.UNSIGNED else 0)
                if need > 32:
                    raise ValueError(
                        f"values need {need} bits; pass width= explicitly "
                        "(64-bit keys are engine-dependent)")
                width = 8 if need <= 8 else 16 if need <= 16 else 32
            else:
                width = w
    return fmt, width


def sort(x, *, engine: str = "tns", fmt: Optional[str] = None,
         width: Optional[int] = None, k: int = 2, ascending: bool = True,
         level_bits: int = 1, stop_after: Optional[int] = None,
         device=None, **engine_kw) -> SortResult:
    """Sort ``x`` on a registered engine.

    ``x``: (N,) one dataset, or (B, N) — B independent datasets (batched
    engines run them in one kernel launch; others loop).  ``fmt`` /
    ``width`` auto-encode from the dtype when omitted.  ``stop_after=m``
    emits only the first m extrema (§3.2's pruning use).  Every engine
    returns the identical permutation (ties: lowest index first).

    ``device=None`` runs on the CUDA device and raises ``RuntimeError``
    without one; ``device="cpu"`` runs the kernels' plain PyTorch versions
    and the machines on the host.

    The default engine ``"tns"`` is the cycle-faithful controller machine
    (:mod:`repro_torch.core.tns`), plain torch on the device: the batched
    machine for a (B, N) input, the single instance for (N,).
    """
    spec = get_engine(engine)
    dev = backend.resolve_device(device)
    with spans.span("sort", dev):
        x = np.asarray(x)
        if x.ndim not in (1, 2):
            raise ValueError(f"x must be (N,) or (B, N), got shape {x.shape}")
        fmt, width = _infer_fmt_width(x, fmt, width)
        if fmt not in spec.formats:
            raise ValueError(f"engine {engine!r} does not support fmt {fmt!r}")
        call = dict(width=width, fmt=fmt, k=k, ascending=ascending,
                    level_bits=level_bits, stop_after=stop_after, device=dev,
                    **engine_kw)
        if x.ndim == 2 and not spec.supports_batch:
            parts = [spec.fn(x[b], **call) for b in range(x.shape[0])]
            stack = lambda f: (None if getattr(parts[0], f) is None else
                               np.stack([np.asarray(getattr(p, f))
                                         for p in parts]))
            p0 = parts[0]
            return SortResult(
                values=np.stack([p.values for p in parts]),
                indices=np.stack([p.indices for p in parts]),
                engine=p0.engine, fmt=fmt, width=width, n=x.shape[-1],
                cycles=stack("cycles"), drs=stack("drs"),
                reload_cycles=stack("reload_cycles"),
                strategy=p0.strategy, k=p0.k, level_bits=p0.level_bits,
                banks=p0.banks,
                # resilience observables aggregate across the batch: quality
                # is the worst instance (the degradation contract is per
                # emission), counters sum, degraded if any instance degraded
                quality=(None if p0.quality is None else
                         min(float(p.quality) for p in parts)),
                faults_injected=sum(p.faults_injected for p in parts),
                repairs=sum(p.repairs for p in parts),
                retries=sum(p.retries for p in parts),
                degraded=any(p.degraded for p in parts),
                extra_cycles=sum(p.extra_cycles for p in parts))
        return spec.fn(x, **call)


def engines():
    """name -> EngineSpec of everything registered."""
    return available_engines()


# ---------------------------------------------------------------------------
# In-model dispatchers (throughput mode) over tensors: the tensor's device
# decides where they run.
# ---------------------------------------------------------------------------

TOPK_ENGINES = ("radix", "fused-topk", "torch")


def topk(x: torch.Tensor, k: int, *, engine: str = "radix", r: int = 4
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the k LARGEST along the last axis,
    descending.  Engines: ``radix`` (iterated digit-plane min-search in
    plain torch, any rank), ``fused-topk`` (the fused CUDA kernel, the
    router hot path; the reference's ``pallas``), ``torch``
    (a stable ``torch.sort``, the comparison baseline; the reference's
    ``lax``)."""
    if engine == "torch":
        # a stable descending sort of the order-preserving keys, then the
        # first k: the keys order floats totally (-NaN < -inf < -0 < +0 <
        # inf < NaN) and ties go to the lowest index first, as in
        # ``jax.lax.top_k`` (torch.topk leaves ties in no set order)
        keys = x
        if x.dtype in bp.KEY_DTYPES:
            keys = bp.sort_key_t(x)[0].long() & 0xFFFFFFFF
        order = torch.sort(keys, dim=-1, descending=True, stable=True).indices
        i = order[..., :k]
        return rs.gather_values(x, i), i.to(torch.int32)
    if engine == "radix":
        return rs.topk_values(x, k, r=r)
    if engine == "fused-topk":
        from repro_torch.kernels import ops
        lead = tuple(x.shape[:-1])
        v, i = ops.topk(x.reshape(-1, x.shape[-1]), k, r=r)
        return v.reshape(lead + (k,)), i.reshape(lead + (k,))
    raise ValueError(f"unknown topk engine {engine!r}; "
                     f"expected one of {TOPK_ENGINES}")


def topk_mask(x: torch.Tensor, k, *, largest: bool = True,
              r: int = 8) -> torch.Tensor:
    """Boolean mask of the k best elements along the last axis (histogram
    radix-select; ``k`` may be a 0-d tensor — run-time tunable)."""
    keys, w = bp.sort_key_t(x)
    return rs.topk_threshold_mask(keys, k, r=r, smallest=not largest,
                                  width=w)


def prune_mask(x: torch.Tensor, k, *, r: int = 8) -> torch.Tensor:
    """True for the k smallest |x| (in-situ pruning, §3.2)."""
    return rs.prune_smallest_mask(x, k, r=r)
