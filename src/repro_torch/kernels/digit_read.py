"""One digit-read min-search over raw bit-planes: the paper's periphery
(sense amplifiers + all-0's/1's check + number exclusion) for a complete
min/max-search iteration.

The CUDA kernel ``csrc/digit_read.cu`` replaces the Pallas kernel
``repro.kernels.digit_read._dr_kernel``; its plain version is
:func:`repro_torch.kernels.ref.min_search_ref`.  The wrapper picks one of
the kernel's two forms by shape and counts each launch under its form in
``FORM_LAUNCHES`` (beside the total, ``LAUNCHES``):

- ``warp``: N <= ``WARP_MAX_N`` (2048) and W <= ``WARP_MAX_W`` (32), one
  warp a row, the columns as hit words in registers;
- ``block``: any other row up to 65536 lanes, one block a row.
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
# the same launches by form
FORM_LAUNCHES = {"warp": 0, "block": 0}
_FORM_CODE = {"warp": 0, "block": 1}
WARP_MAX_N, WARP_MAX_W = 2048, 32


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("digit_read")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.digit_read_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.digit_read_launch.restype = ctypes.c_int
    lib.digit_read_error_string.argtypes = [ctypes.c_int]
    lib.digit_read_error_string.restype = ctypes.c_char_p
    return lib


def form_for(w: int, n: int) -> str:
    """The kernel form that serves (B, w, n) planes."""
    return "warp" if n <= WARP_MAX_N and w <= WARP_MAX_W else "block"


def _launch(planes: torch.Tensor, ascending: bool):
    global LAUNCHES
    b, w, n = planes.shape
    form = form_for(w, n)
    mask = torch.empty((b, n), dtype=torch.bool, device=planes.device)
    drs = torch.empty((b,), dtype=torch.int32, device=planes.device)
    lib = _lib()
    with torch.cuda.device(planes.device):
        status = lib.digit_read_launch(
            planes.data_ptr(), mask.data_ptr(), drs.data_ptr(), b, w, n,
            int(ascending), _FORM_CODE[form],
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("digit_read launch failed: "
                           + lib.digit_read_error_string(status).decode())
    LAUNCHES += 1
    FORM_LAUNCHES[form] += 1
    return mask, drs


def min_search(planes: torch.Tensor, ascending: bool = True):
    """(min_mask, useful_drs) for (B, W, N) uint8 bit-planes.

    ``min_mask[b]`` is the survivor set of one search iteration's walk
    over the columns, as the reference kernel returns it: on 0/1 planes
    every element attaining the min (the max when ``ascending=False``).
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
