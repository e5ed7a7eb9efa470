"""Attention of one query token over a KV cache as it lies: the decode half
of :func:`repro_torch.models.layers.apply_attn`.

The CUDA kernel ``csrc/decode_attn.cu`` replaces no TPU kernel (the
reference leaves attention to XLA): it reads the ``(B, S, KV, hd)`` cache
in place, each filled k and v element once, where ``layers._sdpa`` would
re-lay the whole cache into its products' operands and run its float32
passes one by one.  Its plain version, :func:`decode_attention_ref`, is
``_sdpa``'s naive path for one query token, and the kernel keeps its
roundings: float32 scores divided by sqrt(hd), a float32 softmax over the
positions up to the row's own, the probabilities rounded to the cache's
type before a float32 value product, the output rounded once.

The kernel takes float32, bfloat16 and float16, a head size that is a
multiple of 8 up to 256, and up to 8 query heads a KV head; it cuts the
positions into chunks (the ``split`` form) only where the rows' KV heads
would not keep the card busy (:func:`split_for`).  Each launch is counted under
its form in ``FORM_LAUNCHES`` (beside the total, ``LAUNCHES``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build, backend

# calls that launched the CUDA kernel in this process, one a cached
# one-token attention call (a plain count: a run sets it to 0 and reads it
# back to show which path went through the kernel); a call is two
# launches, three in the split form
LAUNCHES = 0
# the same calls by form
FORM_LAUNCHES = {"whole": 0, "split": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM, MAX_GROUP = 256, 8
# (row, KV head) blocks of one query head that keep the card's memory busy
# (about 8 of 4 warps an SM of the H100's 132), and the fewest positions a
# chunk of the split form takes
FILL_BLOCKS, MIN_CHUNK = 1024, 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attn")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attn_launch.argtypes = [p, p, p, ll, ll, ll, ll, ll, ll, p, i,
                                       ll, p, p, p, i, i, i, i, i, i, i, i,
                                       ctypes.c_float, p]
    lib.decode_attn_launch.restype = ctypes.c_int
    lib.decode_attn_error_string.argtypes = [ctypes.c_int]
    lib.decode_attn_error_string.restype = ctypes.c_char_p
    return lib


def split_for(blocks: int, group: int, s: int) -> Tuple[int, int]:
    """(chunks, positions a chunk) for ``blocks`` (row, KV head) pairs of
    ``group`` query heads each over a cache of ``s`` positions.  A block
    does ``group`` times the score arithmetic a byte of k, so ``blocks *
    group >= FILL_BLOCKS`` keeps the card busy in one chunk; below that the
    positions are cut into enough chunks to make ``FILL_BLOCKS`` blocks,
    none shorter than ``MIN_CHUNK`` (one chunk below it)."""
    if blocks * group >= FILL_BLOCKS:
        return 1, s
    p = max(1, min(-(-FILL_BLOCKS // blocks), s // MIN_CHUNK))
    chunk = -(-s // p)
    return -(-s // chunk), chunk


def _check_kernel_inputs(q, k, v, positions, group: int) -> None:
    """Raise on what the kernel does not take."""
    hd = q.shape[-1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_attention on the card takes float32, "
                        f"bfloat16 or float16; got {q.dtype}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention on the card takes a head size "
                         f"that is a multiple of 8 up to {MAX_HEAD_DIM}; "
                         f"got {hd}")
    if group > MAX_GROUP:
        raise ValueError(f"decode_attention on the card takes up to "
                         f"{MAX_GROUP} query heads a KV head; got {group}")
    if positions.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"positions must be int32 or int64, got "
                        f"{positions.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("decode_attention's kernel has no backward")
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        size = t.element_size()
        if t.data_ptr() % 16 or any(st * size % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned at every 8 "
                             f"elements of a head (its strides "
                             f"{tuple(t.stride())})")


def _launch(q, k, v, positions):
    global LAUNCHES
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    dev = q.device
    if B * H == 0:              # a rank that holds no heads
        return torch.empty((B, 1, H, hd), dtype=q.dtype, device=dev)
    group = H // KV
    _check_kernel_inputs(q, k, v, positions, group)
    P, chunk = split_for(B * KV, group, S)
    q = q.contiguous()
    scores = torch.empty(B * KV * group * S, dtype=torch.float32, device=dev)
    part = torch.empty(B * KV * P * group * hd if P > 1 else 0,
                       dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        status = lib.decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *k.stride()[:3],
            *v.stride()[:3], positions.data_ptr(),
            int(positions.dtype == torch.int64), positions.stride(0),
            scores.data_ptr(), part.data_ptr() if P > 1 else None,
            out.data_ptr(), B, KV, group, S, hd, _DTYPE_CODE[q.dtype], P,
            chunk, math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("decode_attn launch failed: "
                           + lib.decode_attn_error_string(status).decode())
    LAUNCHES += 1
    FORM_LAUNCHES["split" if P > 1 else "whole"] += 1
    return out


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """Plain version: ``layers._sdpa``'s naive path for one query token,
    row b attending the cache positions up to ``positions[b]``
    (``_causal_mask`` with ``kv_len = positions + 1``)."""
    from repro_torch.models.layers import _sdpa     # layers imports this
    return _sdpa(q, k, v, True, q_pos=positions[:, None],
                 kv_len=positions + 1, impl="naive")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, hd) attention of q: (B, 1, H, hd) over the cache k, v:
    (B, S, KV, hd), query head i reading KV head i // (H / KV); row b
    attends positions 0 .. ``positions[b]`` (B,) (all S past the cache's
    end, none below 0, where every position weighs alike, as ``_sdpa``'s
    -1e30 mask gives); scores divided by sqrt(hd).  A CUDA tensor runs the
    kernel, a CPU tensor the plain version."""
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"shapes must be q (B, 1, H, hd), k and v (B, S, KV, "
                         f"hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[2] % max(k.shape[2], 1) or (q.shape[2] and not k.shape[2]):
        raise ValueError(f"{q.shape[2]} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    if positions.shape != (q.shape[0],):
        raise ValueError(f"positions must be (B,) = ({q.shape[0]},), got "
                         f"{tuple(positions.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share a dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device == positions.device):
        raise ValueError("q, k, v and positions must be on one device")
    if backend.uses_kernel(q):
        return _launch(q, k, v, positions)
    return decode_attention_ref(q, k, v, positions)
