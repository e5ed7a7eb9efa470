"""Checks of the result ``sort(engine="fused-tns")`` assembles on the keys'
device, shared by the CPU tests (``test_torch_fused_tns.py``) and the
card's (``test_torch_kernels_cuda.py``).  Imports no JAX.

The values are gathered on the keys' device by the emission order, and
values, permutation and counters land in host buffers of the result's own
(page-locked on the card).  Every field, dtype and shape must be those of
the same sort through a read hook that changes nothing, the values those
the indices pick from the input, the indices a stable argsort of the
host's sort keys, and a result held across later calls must not
change."""
import numpy as np
import torch

from repro_torch import sort
from repro_torch.core import bitplane as bp

FIELDS = ("indices", "values", "cycles", "drs", "reload_cycles")
# every container, each at a format and width sort() takes it at (the
# 32- and 64-bit ones at the kernel's 30 bits; float32 narrowed to
# FLOAT/16 on the host)
KEYS = {"uint8": (np.uint8, {}), "uint16": (np.uint16, {}),
        "int8": (np.int8, {}), "int16": (np.int16, {}),
        "int32": (np.int32, dict(width=30)),
        "uint32": (np.uint32, dict(width=30)),
        "float16": (np.float16, dict(fmt=bp.FLOAT, width=16)),
        "int64": (np.int64, dict(width=30)),
        "uint64": (np.uint64, dict(width=30)),
        "bool": (np.bool_, {}),
        "float32-at-16": (np.float32, dict(fmt=bp.FLOAT, width=16))}
SHAPES = [(40,), (3, 40)]
STOPS = [None, 8, "N"]          # "N": stop_after at the bank's length


def keys(dtype, shape, seed):
    """Random keys over the container's whole range with its extremes
    (min, max, 0, -1 and -0 where they exist) in every row; float16 also
    with +-inf, NaNs and subnormals; float32 with bit patterns that
    narrow to float16's extremes, to 0, and NaN payloads that torch's
    narrowing cast rounds otherwise than numpy's."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt == np.float16:
        x = rng.integers(0, 1 << 16, shape).astype(np.uint16).view(
            np.float16)
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                            6e-8, -6e-8, 65504, -65504], np.float16)
        special = np.concatenate([special, np.array(
            [0x7C01, 0xFE00], np.uint16).view(np.float16)])
    elif dt == np.float32:
        x = rng.integers(0, 1 << 32, shape).astype(np.uint32).view(
            np.float32)
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 65520.0,
                            -65519.0, 3e-8, -2.9e-8, 1e-30], np.float32)
        special = np.concatenate([special, np.array(
            [0x7F800001, 0xFFC00001, 0x7F801FFF], np.uint32).view(
                np.float32)])
    elif dt == np.bool_:
        x = rng.integers(0, 2, shape).astype(dt)
        special = np.array([False, True])
    else:
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, shape, endpoint=True,
                         dtype=np.uint64 if dt == np.uint64 else np.int64
                         ).astype(dt)
        special = np.array(sorted({info.min, info.max, 0, 1, info.min + 1,
                                   -1 if info.min else 2}), dt)
    x[..., :special.size] = special[:x.shape[-1]]
    return x


def bits(a):
    """The array's bits, so that NaNs and -0 compare as what they are."""
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def check_assembled(dtype, shape, stop, dev) -> None:
    container, fmt_width = KEYS[dtype]
    x = keys(container, shape, seed=len(dtype) + len(shape))
    if x.dtype.kind in "iu" and x.dtype.itemsize >= 4:
        # magnitudes within 29 bits
        x = x // (1 << (8 * x.dtype.itemsize - 29))
    x[..., 20:] = x[..., 3:4]       # a tie set across the word's edge
    kw = dict(engine="fused-tns", k=2, device=dev, **fmt_width,
              stop_after=shape[-1] if stop == "N" else stop)
    got = sort.sort(x, **kw)
    prev = bp.set_read_hook(lambda planes, **_: planes)
    try:
        want = sort.sort(x, **kw)
    finally:
        bp.set_read_hook(prev)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (type(a), a.dtype, a.shape) == (type(b), b.dtype, b.shape), f
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f)
    np.testing.assert_array_equal(
        bits(got.values), bits(np.take_along_axis(x, got.indices, axis=-1)))
    order = np.argsort(bp.sort_key(x, got.width, got.fmt), axis=-1,
                       kind="stable")
    np.testing.assert_array_equal(got.indices,
                                  order[..., :got.indices.shape[-1]])


def check_held(dev) -> None:
    # calls on other data, whose results are dropped at once, never write
    # into a result still held
    kw = dict(engine="fused-tns", k=2, device=dev)
    held = sort.sort(keys(np.uint8, (4, 96), seed=21), **kw)
    want = {f: np.array(getattr(held, f)) for f in FIELDS}
    for seed in range(4):
        sort.sort(keys(np.uint8, (4, 96), seed=seed), **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(held, f), want[f], err_msg=f)
    if dev.type == "cuda":          # they landed in page-locked memory
        assert torch.from_numpy(held.values).is_pinned()
        assert torch.from_numpy(held.indices).is_pinned()
