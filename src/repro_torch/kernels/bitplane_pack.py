"""Order-preserving sort-key packing: float32 / bfloat16 / int32 values to
uint32 keys whose unsigned order is the value order, and float32 keys back
to values — the "programming" transform the throughput engines consume.

The CUDA kernel ``csrc/bitplane_pack.cu`` replaces the Pallas kernels
``repro.kernels.bitplane_pack._pack_f32_kernel``, ``_unpack_f32_kernel``
and ``_pack_i32_kernel``; the plain versions are
:func:`repro_torch.kernels.ref.pack_keys_ref` and
:func:`~repro_torch.kernels.ref.unpack_keys_f32_ref`.  Keys are int32
tensors holding the uint32 key bits (:mod:`repro_torch.core.bitplane`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, backend
from repro_torch.kernels.ref import pack_keys_ref, unpack_keys_f32_ref

# launches of the CUDA kernel in this process (a plain count: a run sets
# it to 0 and reads it back to show which path went through the kernel)
LAUNCHES = 0

# the kernel's op codes, by input dtype
_PACK_OP = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_UNPACK_OP = 3


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("bitplane_pack")
    p = ctypes.c_void_p
    lib.bitplane_pack_launch.argtypes = [p, p, ctypes.c_int64, ctypes.c_int,
                                         p]
    lib.bitplane_pack_launch.restype = ctypes.c_int
    lib.bitplane_pack_error_string.argtypes = [ctypes.c_int]
    lib.bitplane_pack_error_string.restype = ctypes.c_char_p
    return lib


def _launch(src: torch.Tensor, op: int, out_dtype: torch.dtype):
    global LAUNCHES
    src = src.contiguous()
    out = torch.empty(src.shape, dtype=out_dtype, device=src.device)
    lib = _lib()
    with torch.cuda.device(src.device):
        status = lib.bitplane_pack_launch(
            src.data_ptr(), out.data_ptr(), src.numel(), op,
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("bitplane_pack launch failed: "
                           + lib.bitplane_pack_error_string(status).decode())
    LAUNCHES += 1
    return out


def pack_keys(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving uint32 keys (int32 bits, x's shape) of float32,
    bfloat16 or int32 ``x``; uint32 input is already a key and comes back
    as its int32 bits.  A CUDA tensor runs the kernel, a CPU tensor the
    plain version."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a tensor")
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype not in _PACK_OP:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if backend.uses_kernel(x):
        return _launch(x, _PACK_OP[x.dtype], torch.int32)
    return pack_keys_ref(x)


def unpack_keys_f32(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_keys` for float32: int32 key bits to float32
    values.  A CUDA tensor runs the kernel, a CPU tensor the plain
    version."""
    if not isinstance(keys, torch.Tensor) or keys.dtype != torch.int32:
        raise TypeError("keys must be an int32 tensor of uint32 key bits")
    if backend.uses_kernel(keys):
        return _launch(keys, _UNPACK_OP, torch.float32)
    return unpack_keys_f32_ref(keys)
