"""Digit-plane encoding — the software image of the paper's 1T1R array.

A length-N dataset of W-bit numbers is stored as bit-planes: one axis
indexes *numbers*, the other *digit positions* (MSB first).  A digit read
(DR) reads one digit-column of all numbers at once.

Programming the array is an offline step, so the encoders are numpy, as
in the reference (``repro.core.bitplane``); :func:`planes_from_numpy`
carries the programmed image onto the device.  ``sort_key`` order equals
value order for every format, so one unsigned MSB-first walk sorts
everything.

Device keys (:func:`sort_key_t`, :func:`key_to_value_t`,
:func:`keys_from_numpy`) follow one convention: an unsigned key of up to
32 bits is carried in an **int32 tensor holding the same bits** (torch
has no ``>>``, ``~``, ``min`` or ``argmin`` for uint32).  A 32-bit key
``0xFFFFFFFF`` is the int32 ``-1``; 8- and 16-bit keys sit in the low
bits.  A dtype no longer tells a key's width, so the key functions
return it or take it.  Digit extraction ``(k >> s) & (2**r - 1)`` is
exact on these bits although ``>>`` is arithmetic, and ``~`` is the same
bit operation; raw keys are never compared with ``<`` or ``min`` — widen
them with ``& 0xFFFFFFFF`` to int64 first.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Data-type tags (paper §2.2.2 / S6).
UNSIGNED = "unsigned"
TWOS = "twos"
SIGNMAG = "signmag"
FLOAT = "float"  # IEEE-754: float16 (W=16) or float32 (W=32)

_FORMATS = (UNSIGNED, TWOS, SIGNMAG, FLOAT)


def _container(width: int):
    if width <= 8:
        return np.uint8
    if width <= 16:
        return np.uint16
    if width <= 32:
        return np.uint32
    if width <= 64:
        return np.uint64
    raise ValueError(f"unsupported width {width}")


def _mask(width: int) -> np.uint64:
    return np.uint64((1 << width) - 1)


def raw_bits(x, width: int, fmt: str) -> np.ndarray:
    """Raw W-bit pattern of ``x`` as unsigned ints — what is physically
    programmed into the 1T1R array (Fig. 2d)."""
    if fmt not in _FORMATS:
        raise ValueError(f"unknown format {fmt!r}")
    x = np.asarray(x)
    if fmt == UNSIGNED:
        u = x.astype(np.uint64) & _mask(width)
    elif fmt == TWOS:
        u = x.astype(np.int64).astype(np.uint64) & _mask(width)
    elif fmt == SIGNMAG:
        i = x.astype(np.int64)
        sign = (i < 0).astype(np.uint64)
        mag = np.abs(i).astype(np.uint64) & _mask(width - 1)
        u = (sign << np.uint64(width - 1)) | mag
    else:  # FLOAT
        if width == 16:
            u = x.astype(np.float16).view(np.uint16).astype(np.uint64)
        elif width == 32:
            u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
        else:
            raise ValueError("float format supports width 16 or 32 only")
    return u.astype(_container(width))


def to_bitplanes(x, width: int, fmt: str) -> np.ndarray:
    """Encode ``x`` (shape (..., N)) into a (..., W, N) uint8 digit-plane
    matrix.  Row 0 = MSB (the first column a DR visits).  Leading dims are
    independent datasets (one memristor bank each)."""
    u = raw_bits(x, width, fmt)
    shifts = np.arange(width - 1, -1, -1, dtype=u.dtype)
    return ((u[..., None, :] >> shifts[:, None])
            & u.dtype.type(1)).astype(np.uint8)


def to_digitplanes(x, width: int, fmt: str, level_bits: int) -> np.ndarray:
    """Radix-2**level_bits digit planes for the multi-level strategy
    (§2.3.3): (..., ceil(W/n), N) uint32, most-significant digit first."""
    pad = (-width) % level_bits
    width_p = width + pad
    u = raw_bits(x, width, fmt).astype(np.uint64)
    ndig = width_p // level_bits
    shifts = (np.arange(ndig - 1, -1, -1, dtype=np.uint64)
              * np.uint64(level_bits))
    digits = ((u[..., None, :] >> shifts[:, None])
              & np.uint64((1 << level_bits) - 1))
    return digits.astype(np.uint32)


def sign_plane(x, width: int, fmt: str) -> np.ndarray:
    """Boolean sign column (MSB) of ``x`` under ``fmt`` — the extra array
    line the sign-magnitude / float periphery watches (S6)."""
    u = raw_bits(x, width, fmt).astype(np.uint64)
    return ((u >> np.uint64(width - 1)) & np.uint64(1)).astype(bool)


def from_bitplanes(planes, fmt: str):
    """Decode a (W, N) digit-plane matrix back to values."""
    planes = np.asarray(planes)
    width = planes.shape[0]
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    u = np.sum(planes.astype(np.uint64) << shifts[:, None], axis=0)
    return from_raw_bits(u, width, fmt)


def from_raw_bits(u, width: int, fmt: str):
    u = np.asarray(u).astype(np.uint64) & _mask(width)
    if fmt == UNSIGNED:
        return u.astype(np.int64)
    if fmt == TWOS:
        sign = (u >> np.uint64(width - 1)) & np.uint64(1)
        return u.astype(np.int64) - (sign.astype(np.int64) << width)
    if fmt == SIGNMAG:
        sign = (u >> np.uint64(width - 1)) & np.uint64(1)
        mag = (u & _mask(width - 1)).astype(np.int64)
        return np.where(sign == 1, -mag, mag)
    if fmt == FLOAT:
        if width == 16:
            return u.astype(np.uint16).view(np.float16)
        if width == 32:
            return u.astype(np.uint32).view(np.float32)
    raise ValueError(f"unknown format {fmt!r}")


def sort_key(x, width: int, fmt: str) -> np.ndarray:
    """Map values to unsigned keys such that key order == value order."""
    u = raw_bits(x, width, fmt).astype(np.uint64)
    top = np.uint64(1 << (width - 1))
    allm = _mask(width)
    if fmt == UNSIGNED:
        key = u
    elif fmt == TWOS:
        key = u ^ top
    elif fmt in (SIGNMAG, FLOAT):
        sign = (u >> np.uint64(width - 1)) & np.uint64(1)
        key = np.where(sign == 1, u ^ allm, u ^ top)
    else:
        raise ValueError(fmt)
    return key.astype(_container(width))


def key_to_value(key, width: int, fmt: str):
    """Inverse of :func:`sort_key`."""
    k = np.asarray(key).astype(np.uint64)
    top = np.uint64(1 << (width - 1))
    allm = _mask(width)
    if fmt == UNSIGNED:
        u = k
    elif fmt == TWOS:
        u = k ^ top
    elif fmt in (SIGNMAG, FLOAT):
        sign_flag = (k >> np.uint64(width - 1)) & np.uint64(1)
        u = np.where(sign_flag == 0, k ^ allm, k ^ top)
    else:
        raise ValueError(fmt)
    return from_raw_bits(u, width, fmt)


def encode_array(x, width: int, fmt: str) -> Tuple[np.ndarray, np.ndarray]:
    """Convenience: (bitplanes, sort_keys) — the "programming" step that
    writes a dataset into the memristor array (paper Fig. 2d)."""
    return to_bitplanes(x, width, fmt), sort_key(x, width, fmt)


# ---------------------------------------------------------------------------
# Device sort keys for in-model use (throughput mode): the counterparts of
# the reference's ``sort_key_jnp`` / ``key_to_value_jnp``, under the
# int32-bits convention of the module docstring.
# ---------------------------------------------------------------------------

_SIGN32 = -(1 << 31)          # 0x80000000 as int32 bits

# dtype -> key width (bits) of its sort key
_KEY_WIDTH = {torch.float32: 32, torch.int32: 32, torch.uint32: 32,
              torch.float16: 16, torch.bfloat16: 16, torch.int16: 16,
              torch.uint16: 16, torch.uint8: 8}
KEY_DTYPES = frozenset(_KEY_WIDTH)


def flip_key_t(keys: torch.Tensor, width: int) -> torch.Tensor:
    """Key of the reversed order (the reference's ``~keys`` on a
    ``width``-bit unsigned dtype): every key bit flipped, the bits above
    ``width`` left clear."""
    return ~keys if width == 32 else keys ^ ((1 << width) - 1)


def sort_key_t(x: torch.Tensor):
    """``(keys, width)``: order-preserving unsigned keys of ``x`` as int32
    bits, and their width.  float32/int32/uint32 give 32-bit keys,
    float16/bfloat16/int16/uint16 16-bit, uint8 8-bit (the reference's
    ``sort_key_jnp``: floats flip every bit when negative, the sign bit
    otherwise; signed ints flip the sign bit)."""
    dt = x.dtype
    if dt not in _KEY_WIDTH:
        raise ValueError(f"unsupported dtype {dt}")
    width = _KEY_WIDTH[dt]
    if dt == torch.float32:
        u = x.view(torch.int32)
        return torch.where(u < 0, ~u, u ^ _SIGN32), width
    if dt in (torch.float16, torch.bfloat16):
        u = x.view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, u ^ 0xFFFF, u ^ 0x8000), width
    if dt == torch.int32:
        return x ^ _SIGN32, width
    if dt == torch.uint32:
        return x.view(torch.int32), width
    if dt == torch.int16:
        return (x.to(torch.int32) & 0xFFFF) ^ 0x8000, width
    return x.to(torch.int32), width           # uint16, uint8


def key_to_value_t(keys: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`sort_key_t`: int32-bit ``keys`` back to values of
    ``dtype`` (the key width is the dtype's)."""
    if dtype not in _KEY_WIDTH:
        raise ValueError(f"unsupported dtype {dtype}")
    if dtype == torch.float32:
        return torch.where(keys >= 0, ~keys, keys ^ _SIGN32).view(dtype)
    if dtype in (torch.float16, torch.bfloat16):
        k = keys & 0xFFFF
        u = torch.where(k < 0x8000, k ^ 0xFFFF, k ^ 0x8000)
        return _low16(u).view(dtype)
    if dtype == torch.int32:
        return keys ^ _SIGN32
    if dtype == torch.uint32:
        return keys.view(torch.uint32)
    if dtype == torch.int16:
        return _low16((keys & 0xFFFF) ^ 0x8000)
    return keys.to(dtype)                     # uint16, uint8


def _low16(u: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of int32 ``u`` (0..0xFFFF) as int16 bits."""
    return (u - ((u >> 15) & 1) * 0x10000).to(torch.int16)


def keys_from_numpy(a, *, device) -> torch.Tensor:
    """Carry the reference package's numpy inputs of the throughput path
    onto ``device``: unsigned keys of up to 32 bits become int32 bits (the
    module's convention), float32 stays as it is, bfloat16 is widened to
    float32 (exact), and a bool mask stays bool."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype in (np.uint8, np.uint16):
        a = a.astype(np.int32)
    elif a.dtype not in (np.float32, np.bool_):
        raise TypeError(f"no device key convention for {a.dtype}")
    # a copy: the tensor never aliases the caller's (maybe read-only) array
    return torch.from_numpy(np.array(a, order="C")).to(device)


def planes_from_numpy(planes: np.ndarray, sign: Optional[np.ndarray] = None,
                      *, device) -> tuple:
    """Carry a programmed array image onto ``device``: the (B, W, N) uint8
    bit-planes (as :func:`to_bitplanes` writes them) and the optional
    (B, N) sign plane become contiguous device tensors (planes uint8,
    sign uint8 or None).  The reference package's arrays of the same
    shapes are accepted as they are."""
    planes = np.asarray(planes)
    if planes.dtype != np.uint8:
        raise TypeError(f"planes must be uint8, got {planes.dtype}")
    if planes.ndim != 3:
        raise ValueError(f"planes must be (B, W, N), got {planes.shape}")
    p = torch.from_numpy(np.ascontiguousarray(planes)).to(device)
    if sign is None:
        return p, None
    sign = np.asarray(sign)
    if sign.dtype not in (np.bool_, np.uint8):
        raise TypeError(f"sign must be bool or uint8, got {sign.dtype}")
    if sign.shape != (planes.shape[0], planes.shape[2]):
        raise ValueError(f"sign must be (B, N) = "
                         f"{(planes.shape[0], planes.shape[2])}, "
                         f"got {sign.shape}")
    s = torch.from_numpy(np.ascontiguousarray(sign.astype(np.uint8)))
    return p, s.to(device)


# ---------------------------------------------------------------------------
# The device read path.  Engines route every digit-plane matrix they are
# about to consume through read_planes(); normally it is the identity, but
# a fault-injection context installs a hook here, so device non-idealities
# reach every engine through one interface.  The encoders above model
# *programming* the array, the hook models *reading* it.
# ---------------------------------------------------------------------------

_read_hook = None


def set_read_hook(fn):
    """Install ``fn(planes, *, kind, level_bits, banks) -> planes`` as the
    device read process; returns the previous hook (for restoration)."""
    global _read_hook
    prev = _read_hook
    _read_hook = fn
    return prev


def read_hook():
    """The installed read hook, or None: the array reads as programmed."""
    return _read_hook


def read_planes(planes, *, kind: str = "bit", level_bits: int = 1,
                banks: Optional[int] = None):
    """One device read of a stored (..., D, N) digit-plane matrix.
    Identity unless a fault-injection hook is installed.  ``kind`` is
    "bit" for binary planes or "digit" for radix-2^n digit planes;
    ``banks`` tells the hook the bank layout when the caller knows it."""
    hook = _read_hook
    if hook is None:
        return planes
    return hook(planes, kind=kind, level_bits=level_bits, banks=banks)
