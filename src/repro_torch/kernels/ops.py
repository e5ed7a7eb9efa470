"""Public entry points for the hand-written kernels (the counterpart of
``repro.kernels.ops``).  The tensor's device picks the implementation
(:mod:`repro_torch.kernels.backend`): a CUDA tensor launches the kernel, a
CPU tensor runs its plain version.  Keys are int32 tensors holding uint32
key bits (:mod:`repro_torch.core.bitplane`).

Every entry point takes plain tensors only: under a mesh each rank hands
the kernels its own local values, never a DTensor (a kernel launches on
raw pointers and knows nothing of placements).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.radix_select import gather_values
from repro_torch.kernels import bitplane_pack as _pack
from repro_torch.kernels import digit_read as _dr
from repro_torch.kernels import masked_matmul as _mm
from repro_torch.kernels import radix_topk as _topk


def _plain(*ts: torch.Tensor) -> None:
    for t in ts:
        if isinstance(t, DTensor):
            raise TypeError("the kernels take plain tensors: pass this "
                            "rank's local values, not a DTensor")


def topk(x: torch.Tensor, k: int, r: int = 4):
    """Comparison-free top-k (largest) along the last axis of a 2-D
    float32 / bfloat16 / int32 tensor: (values desc, int32 indices).  The
    MoE-router pipeline: pack the keys, invert them (the largest value is
    the smallest inverted key), take the k smallest, gather the values —
    two kernel launches on the card."""
    _plain(x)
    keys = _pack.pack_keys(x)
    _, idx = _topk.topk_keys(~keys, k, r=r)
    return gather_values(x, idx), idx


def min_search(planes: torch.Tensor, ascending: bool = True):
    """One DR min/max-search over (B, W, N) uint8 bit-planes."""
    _plain(planes)
    return _dr.min_search(planes, ascending=ascending)


def pack_keys(x: torch.Tensor) -> torch.Tensor:
    _plain(x)
    return _pack.pack_keys(x)


def unpack_keys_f32(keys: torch.Tensor) -> torch.Tensor:
    _plain(keys)
    return _pack.unpack_keys_f32(keys)


def pruned_matmul(x: torch.Tensor, w: torch.Tensor,
                  keep_mask: torch.Tensor) -> torch.Tensor:
    _plain(x, w, keep_mask)
    return _mm.pruned_matmul(x, w, keep_mask)
