"""Fused comparison-free top-k (the MoE-router hot spot): the k smallest
uint32 keys per row, emitted ascending with first-tie indices, as k
rounds of the paper's min-search over radix-2^r digit planes find them.

The CUDA kernel ``csrc/radix_topk.cu`` replaces the Pallas kernel
``repro.kernels.radix_topk._topk_kernel``; its plain version is
:func:`repro_torch.kernels.ref.topk_keys_ref`.  The kernel computes the
same function by a warp argmin a round on rows of up to ``WARP_MAX_N``
lanes and by a radix select beyond (``k <= SORT_CAP``; larger k takes the
digit rounds); :func:`repro_torch.kernels.ref.topk_keys_select_ref`
models the radix select on the host.  Keys are int32 tensors holding the
uint32 key bits (:mod:`repro_torch.core.bitplane`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, backend
from repro_torch.kernels.ref import topk_keys_ref

# launches of the CUDA kernel in this process (a plain count: a run sets
# it to 0 and reads it back to show which path went through the kernel)
LAUNCHES = 0

KEY_BITS = 32
# the kernel's form switch: one warp a row up to WARP_MAX_N lanes; a
# radix select beyond it for k up to SORT_CAP, digit rounds for larger k
WARP_MAX_N = 1024
SORT_CAP = 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("radix_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.radix_topk_launch.argtypes = [p, p, p, i, i, i, i, p]
    lib.radix_topk_launch.restype = ctypes.c_int
    lib.radix_topk_error_string.argtypes = [ctypes.c_int]
    lib.radix_topk_error_string.restype = ctypes.c_char_p
    lib.radix_topk_stage_limit.argtypes = []
    lib.radix_topk_stage_limit.restype = ctypes.c_int
    return lib


def stage_limit(device=None) -> int:
    """The widest row whose keys the radix select stages in shared memory
    on ``device`` (the current CUDA device by default); wider rows are read
    from global memory."""
    with torch.cuda.device(device):
        limit = _lib().radix_topk_stage_limit()
    if limit < 0:
        raise RuntimeError("radix_topk: cannot read the shared-memory limit")
    return limit


def _launch(keys: torch.Tensor, k: int, r: int):
    global LAUNCHES
    b, n = keys.shape
    out_key = torch.empty((b, k), dtype=torch.int32, device=keys.device)
    out_idx = torch.empty((b, k), dtype=torch.int32, device=keys.device)
    lib = _lib()
    with torch.cuda.device(keys.device):
        status = lib.radix_topk_launch(
            keys.data_ptr(), out_key.data_ptr(), out_idx.data_ptr(), b, n,
            k, r, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("radix_topk launch failed: "
                           + lib.radix_topk_error_string(status).decode())
    LAUNCHES += 1
    return out_key, out_idx


def topk_keys(keys: torch.Tensor, k: int, r: int = 4):
    """(min_keys, indices), each (B, k) int32, of the k smallest keys along
    the last axis of (B, N) int32 key bits, ascending; ties go to the
    lowest index.  The digit walk reads the shifts ``32-r, 32-2r, ...,
    >= 0``: for an ``r`` that does not divide 32 the low ``32 mod r`` bits
    are never read, and the returned keys lack them (as the reference
    kernel's do).  A CUDA tensor runs the kernel, a CPU tensor the plain
    version."""
    if not isinstance(keys, torch.Tensor) or keys.dtype != torch.int32:
        raise TypeError("keys must be an int32 tensor of uint32 key bits")
    if keys.ndim != 2:
        raise ValueError(f"keys must be (B, N), got {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    n = keys.shape[1]
    if not 1 <= k <= n:
        raise ValueError(f"topk_keys takes 1 <= k <= N, got k={k}, N={n}")
    if not 1 <= r <= 8:
        raise ValueError(f"topk_keys takes a radix 2^r with 1 <= r <= 8, "
                         f"got r={r}")
    if backend.uses_kernel(keys):
        return _launch(keys, k, r)
    return topk_keys_ref(keys, k, r)
