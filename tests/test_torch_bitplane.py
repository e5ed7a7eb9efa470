"""The port's bit-plane encoding against the reference package's, on the
same seeded numpy inputs: encodings, sort keys, the read hook and the
carry of a programmed array image onto a device."""
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro_torch.core import bitplane as bp

FMT_DATA = {
    bp.UNSIGNED: (lambda r, s: r.integers(0, 256, s).astype(np.uint8), 8),
    bp.TWOS: (lambda r, s: r.integers(-128, 128, s).astype(np.int8), 8),
    bp.SIGNMAG: (lambda r, s: r.integers(-2**14, 2**14, s), 16),
    bp.FLOAT: (lambda r, s: r.standard_normal(s).astype(np.float16), 16),
    "float32": (lambda r, s: r.standard_normal(s).astype(np.float32), 32),
}


def _data(name, shape=(3, 37), seed=0):
    gen, width = FMT_DATA[name]
    fmt = bp.FLOAT if name == "float32" else name
    return gen(np.random.default_rng(seed), shape), width, fmt


@pytest.mark.parametrize("name", list(FMT_DATA))
@pytest.mark.parametrize("fn", ["raw_bits", "to_bitplanes", "sign_plane",
                                "sort_key"])
def test_encoders_match_reference(name, fn):
    x, width, fmt = _data(name)
    got = getattr(bp, fn)(x, width, fmt)
    want = getattr(jbp, fn)(x, width, fmt)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(FMT_DATA))
def test_decoders_match_reference(name):
    x, width, fmt = _data(name)
    keys = bp.sort_key(x, width, fmt)
    planes = bp.to_bitplanes(x[0], width, fmt)
    raw = bp.raw_bits(x, width, fmt)
    for got, want in (
            (bp.key_to_value(keys, width, fmt),
             jbp.key_to_value(keys, width, fmt)),
            (bp.from_bitplanes(planes, fmt), jbp.from_bitplanes(planes, fmt)),
            (bp.from_raw_bits(raw, width, fmt),
             jbp.from_raw_bits(raw, width, fmt))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    # the round trips the reference guarantees
    np.testing.assert_array_equal(
        bp.key_to_value(keys, width, fmt).astype(np.float64),
        x.astype(np.float64))


@pytest.mark.parametrize("level_bits", [2, 3, 4])
def test_digitplanes_match_reference(level_bits):
    x, width, fmt = _data(bp.UNSIGNED)
    np.testing.assert_array_equal(
        bp.to_digitplanes(x, width, fmt, level_bits),
        jbp.to_digitplanes(x, width, fmt, level_bits))


@pytest.mark.parametrize("name", list(FMT_DATA))
def test_sort_key_order_is_value_order(name):
    x, width, fmt = _data(name, shape=(200,), seed=1)
    keys = bp.sort_key(x, width, fmt)
    order = np.argsort(keys, kind="stable")
    assert np.all(np.diff(x[order].astype(np.float64)) >= 0)


def test_read_hook_routes_every_read():
    x, width, fmt = _data(bp.TWOS)
    planes = bp.to_bitplanes(x, width, fmt)
    assert bp.read_planes(planes) is planes        # identity without a hook
    calls = []

    def flip_msb(p, *, kind, level_bits, banks):
        calls.append((kind, level_bits, banks))
        out = p.copy()
        out[..., 0, :] ^= 1
        return out

    prev = bp.set_read_hook(flip_msb)
    jprev = jbp.set_read_hook(flip_msb)
    try:
        got = bp.read_planes(planes, kind="bit", level_bits=1, banks=2)
        want = jbp.read_planes(planes, kind="bit", level_bits=1, banks=2)
    finally:
        assert bp.set_read_hook(prev) is flip_msb
        jbp.set_read_hook(jprev)
    np.testing.assert_array_equal(got, want)
    assert calls == [("bit", 1, 2), ("bit", 1, 2)]
    assert bp.read_planes(planes) is planes


@pytest.mark.parametrize("name", [bp.UNSIGNED, bp.SIGNMAG, bp.FLOAT])
def test_planes_from_numpy_carries_the_reference_image(name):
    x, width, fmt = _data(name)
    planes = jbp.to_bitplanes(x, width, fmt)
    sign = jbp.sign_plane(x, width, fmt)
    p, s = bp.planes_from_numpy(planes, sign, device="cpu")
    assert p.dtype == torch.uint8 and p.is_contiguous()
    assert s.dtype == torch.uint8 and tuple(s.shape) == sign.shape
    np.testing.assert_array_equal(p.numpy(), planes)
    np.testing.assert_array_equal(s.numpy(), sign.astype(np.uint8))
    p2, s2 = bp.planes_from_numpy(planes, device="cpu")
    assert s2 is None and torch.equal(p2, p)


@pytest.mark.parametrize("planes, sign, err", [
    (np.zeros((2, 8, 5), np.int32), None, TypeError),
    (np.zeros((8, 5), np.uint8), None, ValueError),
    (np.zeros((2, 8, 5), np.uint8), np.zeros((2, 4), bool), ValueError),
    (np.zeros((2, 8, 5), np.uint8), np.zeros((2, 5), np.float32), TypeError),
])
def test_planes_from_numpy_rejects_bad_images(planes, sign, err):
    with pytest.raises(err):
        bp.planes_from_numpy(planes, sign, device="cpu")


@pytest.mark.parametrize("name", list(FMT_DATA))
def test_encode_array_matches_reference(name):
    x, width, fmt = _data(name)
    got = bp.encode_array(x, width, fmt)
    want = jbp.encode_array(x, width, fmt)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
