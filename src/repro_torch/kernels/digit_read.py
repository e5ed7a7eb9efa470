"""One digit-read min-search over raw bit-planes: the paper's periphery
(sense amplifiers + all-0's/1's check + number exclusion) for a complete
min/max-search iteration.

The CUDA kernel ``csrc/digit_read.cu`` replaces the Pallas kernel
``repro.kernels.digit_read._dr_kernel``; its plain version is
:func:`repro_torch.kernels.ref.min_search_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, backend
from repro_torch.kernels.ref import min_search_ref

# launches of the CUDA kernel in this process (a plain count: a run sets
# it to 0 and reads it back to show which path went through the kernel)
LAUNCHES = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("digit_read")
    p = ctypes.c_void_p
    lib.digit_read_launch.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, p]
    lib.digit_read_launch.restype = ctypes.c_int
    lib.digit_read_error_string.argtypes = [ctypes.c_int]
    lib.digit_read_error_string.restype = ctypes.c_char_p
    return lib


def _launch(planes: torch.Tensor, ascending: bool):
    global LAUNCHES
    b, w, n = planes.shape
    mask = torch.empty((b, n), dtype=torch.bool, device=planes.device)
    drs = torch.empty((b,), dtype=torch.int32, device=planes.device)
    lib = _lib()
    with torch.cuda.device(planes.device):
        status = lib.digit_read_launch(
            planes.data_ptr(), mask.data_ptr(), drs.data_ptr(), b, w, n,
            int(ascending), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("digit_read launch failed: "
                           + lib.digit_read_error_string(status).decode())
    LAUNCHES += 1
    return mask, drs


def min_search(planes: torch.Tensor, ascending: bool = True):
    """(min_mask, useful_drs) for (B, W, N) uint8 bit-planes.

    ``min_mask[b]`` marks every element attaining the min (the max when
    ``ascending=False``) — the survival numbers of one search iteration.
    A CUDA tensor runs the kernel, a CPU tensor the plain version."""
    if not isinstance(planes, torch.Tensor) or planes.dtype != torch.uint8:
        raise TypeError("planes must be a uint8 tensor")
    if planes.ndim != 3:
        raise ValueError(f"planes must be (B, W, N), got {tuple(planes.shape)}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    n = planes.shape[2]
    if not 1 <= n <= 65536:
        raise ValueError(f"min_search takes 1 <= N <= 65536, got N={n}")
    if backend.uses_kernel(planes):
        return _launch(planes, ascending)
    return min_search_ref(planes, ascending)
