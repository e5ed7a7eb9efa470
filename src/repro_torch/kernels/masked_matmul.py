"""In-situ-pruned matrix product (paper §3.2 / Algorithm S2): the TNS-located
smallest-magnitude input lanes are masked to zero before the product,
``y = (x * keep_mask) @ w``, with the mask fused into the kernel's load of
x.

The CUDA kernel ``csrc/masked_matmul.cu`` replaces the Pallas kernel
``repro.kernels.masked_matmul._mm_kernel``; its plain version is
:func:`repro_torch.kernels.ref.pruned_matmul_ref`.  The wrapper picks one
of the kernel's three forms by dtype and shape (:func:`form_for`) and
counts each launch under its form in ``FORM_LAUNCHES`` (beside the total,
``LAUNCHES``):

- ``wgmma``: bfloat16 with K > 0, K and N multiples of 8 and x and w
  16-byte aligned (TMA's stride and alignment rules): TMA loads into a
  shared-memory ring, two consumer warpgroups on ``wgmma``;
- ``wmma``: every other bfloat16 shape, K = 0 included: 128 x 128 tiles
  on ``mma.sync``;
- ``ffma``: float32, on the CUDA cores (``wgmma`` has no float32 mode,
  and TF32 would not meet the float32 tolerance).

This is a choice by shape, not a fallback: a form that fails to build or
launch raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, backend
from repro_torch.kernels.ref import pruned_matmul_ref

# launches of the CUDA kernel in this process (a plain count: a run sets
# it to 0 and reads it back to show which path went through the kernel)
LAUNCHES = 0
# the same launches by form
FORM_LAUNCHES = {"wgmma": 0, "wmma": 0, "ffma": 0}
_FORM_CODE = {"ffma": 0, "wmma": 1, "wgmma": 2}
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("masked_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_matmul_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.masked_matmul_launch.restype = ctypes.c_int
    lib.masked_matmul_error_string.argtypes = [ctypes.c_int]
    lib.masked_matmul_error_string.restype = ctypes.c_char_p
    return lib


def form_for(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel form that serves ``x @ w``."""
    if x.dtype == torch.float32:
        return "ffma"
    k, n = w.shape
    if k > 0 and k % 8 == 0 and n % 8 == 0 and x.data_ptr() % 16 == 0 \
            and w.data_ptr() % 16 == 0:
        return "wgmma"
    return "wmma"


def _launch(x: torch.Tensor, w: torch.Tensor, keep: torch.Tensor):
    global LAUNCHES
    m, k = x.shape
    n = w.shape[1]
    form = form_for(x, w)
    # bool: the 0/1 bytes the kernel reads (the wgmma form two at a time)
    keep = keep.contiguous()
    if keep.data_ptr() % 16:
        keep = keep.clone()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        status = lib.masked_matmul_launch(
            x.data_ptr(), w.data_ptr(), keep.data_ptr(), y.data_ptr(),
            m, k, n, _FORM_CODE[form],
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("masked_matmul launch failed: "
                           + lib.masked_matmul_error_string(status).decode())
    LAUNCHES += 1
    FORM_LAUNCHES[form] += 1
    return y


def pruned_matmul(x: torch.Tensor, w: torch.Tensor,
                  keep_mask: torch.Tensor) -> torch.Tensor:
    """``(x * keep_mask) @ w`` — x: (M, K), w: (K, N), keep_mask: (K,)
    bool, the complement of the TNS-located prune set.  x and w share one
    dtype, float32 or bfloat16; the sum is kept in float32 and the result
    is in x's dtype.  A CUDA tensor runs the kernel, a CPU tensor the
    plain version."""
    for name, t in (("x", x), ("w", w), ("keep_mask", keep_mask)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share a dtype, float32 or bfloat16; "
                        f"got {x.dtype} and {w.dtype}")
    if keep_mask.dtype != torch.bool:
        raise TypeError("keep_mask must be a bool tensor")
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1] \
            or keep_mask.shape != (x.shape[1],):
        raise ValueError(f"shapes must be x (M, K), w (K, N), keep_mask "
                         f"(K,); got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(keep_mask.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if not (x.device == w.device == keep_mask.device):
        raise ValueError("x, w and keep_mask must be on one device")
    if backend.uses_kernel(x):
        return _launch(x, w, keep_mask)
    return pruned_matmul_ref(x, w, keep_mask)
