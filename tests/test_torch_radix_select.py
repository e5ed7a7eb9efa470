"""The port's device sort keys, throughput selection primitives
(``repro_torch.core.radix_select``) and the ``topk`` / ``topk_mask`` /
``prune_mask`` facade against the reference package's, on the same seeded
numpy inputs, on the CPU.  Keys, indices, masks and permutations are
integers and are compared exactly; JAX's uint keys are compared as the
port's int32 bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.core import radix_select as jrs
from repro.sort import api as japi
from repro_torch.core import bitplane as bp
from repro_torch.core import radix_select as rs
from repro_torch.sort import api as tapi

# numpy dtype -> (generator, torch dtype); bfloat16 is made in JAX and
# carried as float32 -> torch.bfloat16, which is exact
DTYPES = {
    "float32": lambda r, s: (r.standard_normal(s) * 1e3).astype(np.float32),
    "float16": lambda r, s: r.standard_normal(s).astype(np.float16),
    "bfloat16": lambda r, s: np.asarray(jnp.asarray(
        r.standard_normal(s) * 1e3, dtype=jnp.bfloat16)),
    "int32": lambda r, s: r.integers(-2**31, 2**31 - 1, s, dtype=np.int32),
    "uint32": lambda r, s: r.integers(0, 2**32, s, dtype=np.uint32),
    "int16": lambda r, s: r.integers(-2**15, 2**15, s).astype(np.int16),
    "uint16": lambda r, s: r.integers(0, 2**16, s).astype(np.uint16),
    "uint8": lambda r, s: r.integers(0, 256, s).astype(np.uint8),
}


def _pair(name, shape, seed):
    """The same values as a JAX array and as a CPU tensor."""
    a = DTYPES[name](np.random.default_rng(seed), shape)
    if name == "bfloat16":
        return jnp.asarray(a), torch.from_numpy(
            a.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _bits(jkeys) -> np.ndarray:
    """JAX unsigned keys (uint8/16/32) as the port's int32 bits."""
    return np.asarray(jkeys).astype(np.uint32).view(np.int32)


def _floats(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ---------------------------------------------------------------- sort keys


@pytest.mark.parametrize("name", list(DTYPES))
def test_sort_key_matches_reference(name):
    jx, tx = _pair(name, (5, 33), seed=len(name))
    keys, width = bp.sort_key_t(tx)
    want = jbp.sort_key_jnp(jx)
    assert width == np.dtype(want.dtype).itemsize * 8
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), _bits(want))


@pytest.mark.parametrize("name", list(DTYPES))
def test_key_to_value_inverts_sort_key(name):
    jx, tx = _pair(name, (4, 17), seed=len(name) + 1)
    keys, _ = bp.sort_key_t(tx)
    back = bp.key_to_value_t(keys, tx.dtype)
    assert back.dtype == tx.dtype
    # bit for bit, so NaN-free floats and -0.0 compare exactly
    assert torch.equal(back.view(torch.uint8), tx.contiguous().view(
        torch.uint8))
    if name == "int16":
        return           # the reference's inverse stops at int32
    jback = jbp.key_to_value_jnp(jbp.sort_key_jnp(jx), jx.dtype)
    np.testing.assert_array_equal(
        back.float().numpy() if name == "bfloat16" else back.numpy(),
        np.asarray(jback).astype(np.float32) if name == "bfloat16"
        else np.asarray(jback))


def test_special_floats_keep_the_reference_bits_and_order():
    x = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-9, 7.25, np.inf, np.nan],
                 np.float32)
    keys, _ = bp.sort_key_t(torch.from_numpy(x))
    np.testing.assert_array_equal(keys.numpy(),
                                  _bits(jbp.sort_key_jnp(jnp.asarray(x))))
    wide = keys[:-1].to(torch.int64) & 0xFFFFFFFF
    assert bool((wide[1:] > wide[:-1]).all())
    back = bp.key_to_value_t(keys, torch.float32).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))


@pytest.mark.parametrize("width", [8, 16, 32])
def test_flip_key_is_the_reference_invert(width):
    dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[width]
    a = np.random.default_rng(width).integers(0, 2**width, 50).astype(dt)
    got = bp.flip_key_t(bp.keys_from_numpy(a, device="cpu"), width)
    np.testing.assert_array_equal(got.numpy(), _bits(~jnp.asarray(a)))


@pytest.mark.parametrize("a, dtype, want", [
    (np.array([0, 2**31, 2**32 - 1], np.uint32), torch.int32,
     [0, -2**31, -1]),
    (np.array([0, 65535], np.uint16), torch.int32, [0, 65535]),
    (np.array([7, 255], np.uint8), torch.int32, [7, 255]),
    (np.array([1.5, -2.0], np.float32), torch.float32, [1.5, -2.0]),
    (np.array([True, False]), torch.bool, [True, False]),
], ids=["uint32", "uint16", "uint8", "float32", "bool"])
def test_keys_from_numpy(a, dtype, want):
    t = bp.keys_from_numpy(a, device="cpu")
    assert t.dtype == dtype and t.tolist() == want
    a_copy = a.copy()
    t.zero_()
    np.testing.assert_array_equal(a, a_copy)     # never aliases the input


def test_keys_from_numpy_widens_bfloat16_and_refuses_the_rest():
    b = np.asarray(jnp.asarray([1.5, -3.0, 1e-3], dtype=jnp.bfloat16))
    t = bp.keys_from_numpy(b, device="cpu")
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), b.astype(np.float32))
    for bad in (np.zeros(3, np.uint64), np.zeros(3, np.float64),
                np.zeros(3, np.int32)):
        with pytest.raises(TypeError):
            bp.keys_from_numpy(bad, device="cpu")


@pytest.mark.parametrize("call", [
    lambda: bp.sort_key_t(torch.zeros(3, dtype=torch.float64)),
    lambda: bp.sort_key_t(torch.zeros(3, dtype=torch.int8)),
    lambda: bp.key_to_value_t(torch.zeros(3, dtype=torch.int32),
                              torch.int64),
], ids=["float64", "int8", "to-int64"])
def test_key_functions_refuse_unsupported_dtypes(call):
    with pytest.raises(ValueError, match="unsupported dtype"):
        call()


# ---------------------------------------------------- min search and top-k


@pytest.mark.parametrize("name, r", [("uint32", 4), ("uint32", 8),
                                     ("uint16", 4), ("uint8", 2),
                                     ("uint16", 1)])
def test_min_mask_matches_reference(name, r):
    jk, tk = _pair(name, (4, 40), seed=r)
    jk = jnp.asarray(np.asarray(jk) % 13)       # many ties
    keys, width = bp.sort_key_t(torch.from_numpy(np.array(jk)))
    valid = np.random.default_rng(r).random((4, 40)) > 0.3
    want = jrs.min_mask(jk, jnp.asarray(valid), r=r)
    got = rs.min_mask(keys, torch.from_numpy(valid), r=r, width=width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_min_mask_walks_8_bit_keys():
    a = np.random.default_rng(0).integers(0, 256, (3, 20)).astype(np.uint8)
    valid = np.ones((3, 20), bool)
    got = rs.min_mask(bp.keys_from_numpy(a, device="cpu"),
                      torch.from_numpy(valid), r=4, width=8)
    want = jrs.min_mask(jnp.asarray(a), jnp.asarray(valid), r=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="int32 key bits"):
        rs.min_mask(torch.from_numpy(a), torch.from_numpy(valid), r=4)


@pytest.mark.parametrize("k", [1, 4, 24])
@pytest.mark.parametrize("r", [2, 4, 8])
def test_extract_topk_matches_reference(k, r):
    a = np.random.default_rng(k * r).integers(0, 2**32, (3, 24),
                                              dtype=np.uint32)
    a[1] = 77                                    # an all-ties row
    a[2, 10:14] = a[2, 3]                        # a partial tie
    jv, ji = jrs.extract_topk(jnp.asarray(a), k, r=r)
    tv, ti = rs.extract_topk(bp.keys_from_numpy(a, device="cpu"), k, r=r)
    np.testing.assert_array_equal(tv.numpy(), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti[1].numpy(), np.arange(k))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("largest", [True, False])
def test_topk_values_matches_reference(dtype, largest):
    jx = jnp.asarray(_floats((4, 7, 160), seed=2), dtype=dtype)
    tx = torch.from_numpy(np.asarray(jx).astype(np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    jv, ji = jrs.topk_values(jx, 6, largest=largest)
    tv, ti = rs.topk_values(tx, 6, largest=largest)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv).astype(np.float32))
    assert ti.dtype == torch.int32


def test_topk_values_tie_handling_first_index():
    x = torch.tensor([[1.0, 5.0, 5.0, 0.0]])
    _, i = rs.topk_values(x, 2)
    assert i[0].tolist() == [1, 2]


# ------------------------------------------------------ threshold masks


@pytest.mark.parametrize("name", ["float32", "uint16", "uint8"])
@pytest.mark.parametrize("k", [1, 7, 30])
@pytest.mark.parametrize("smallest", [True, False])
def test_threshold_mask_matches_reference(name, k, smallest):
    jx, tx = _pair(name, (3, 40), seed=k)
    jx = jnp.asarray(np.asarray(jx)[:, :40])
    jx = jx.at[0, :12].set(jx[0, 5])             # ties at the threshold
    tx = torch.from_numpy(np.array(jx))
    jkeys = jbp.sort_key_jnp(jx)
    r = 4 if name == "uint8" else 8
    want = jrs.topk_threshold_mask(jkeys, k, r=r, smallest=smallest)
    keys, width = bp.sort_key_t(tx)
    got = rs.topk_threshold_mask(keys, k, r=r, smallest=smallest,
                                 width=width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(-1) == k).all()


def test_threshold_mask_takes_a_0d_tensor_k():
    # run-time tunable sparsity: k is traced in the reference, a 0-d
    # tensor here
    x = _floats(64, seed=1)
    f = jax.jit(lambda xs, kk: jrs.prune_smallest_mask(xs, kk))
    for k in (3, 17, 40):
        got = rs.prune_smallest_mask(torch.from_numpy(x),
                                     torch.tensor(k, dtype=torch.int32))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(f(jnp.asarray(x), jnp.int32(k))))
        assert int(got.sum()) == k


@pytest.mark.parametrize("k", [1, 5, 50])
def test_prune_and_logits_masks_match_reference(k):
    x = _floats((5, 100), seed=k)
    x[1, :30] = x[1, 0]                          # ties
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(
        rs.prune_smallest_mask(tx, k).numpy(),
        np.asarray(jrs.prune_smallest_mask(jnp.asarray(x), k)))
    np.testing.assert_array_equal(
        rs.topk_logits_mask(tx, k).numpy(),
        np.asarray(jrs.topk_logits_mask(jnp.asarray(x), k)))


def test_logits_mask_top1_is_argmax():
    x = _floats((5, 100), seed=2)
    m = rs.topk_logits_mask(torch.from_numpy(x), 1).numpy()
    np.testing.assert_array_equal(m.argmax(-1), x.argmax(-1))


# ------------------------------------------------------------ radix sort


@pytest.mark.parametrize("name", ["uint32", "uint16", "uint8"])
@pytest.mark.parametrize("r", [4, 8])
@pytest.mark.parametrize("descending", [False, True])
def test_radix_sort_keys_matches_reference(name, r, descending):
    jk, tk = _pair(name, (3, 45), seed=r)
    jk = jnp.asarray(np.asarray(jk) % 50)        # ties: stability shows
    keys, width = bp.sort_key_t(torch.from_numpy(np.array(jk)))
    want = jrs.radix_sort_keys(jk, r=r, descending=descending)
    got = rs.radix_sort_keys(keys, r=r, descending=descending, width=width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float16])
def test_sort_values_matches_reference(dtype):
    x = (_floats((2, 33), seed=4) * 100).astype(dtype)
    jv, jp = jrs.sort_values(jnp.asarray(x))
    tv, tp = rs.sort_values(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_sort_values_stability():
    _, p = rs.sort_values(torch.tensor([3, 1, 2, 1, 3, 1],
                                       dtype=torch.int32))
    assert p.tolist() == [1, 3, 5, 2, 0, 4]


@pytest.mark.parametrize("call", [
    lambda k: rs.min_mask(k, torch.ones(8, dtype=torch.bool), r=3),
    lambda k: rs.extract_topk(k, 2, r=5),
    lambda k: rs.topk_threshold_mask(k, 2, r=3),
    lambda k: rs.radix_sort_keys(k, r=6),
    lambda k: rs.radix_sort_keys(k.to(torch.int64)),
    lambda k: rs.radix_sort_keys(k, width=12),
], ids=["min_mask", "extract_topk", "threshold", "radix", "dtype", "width"])
def test_radix_that_does_not_divide_the_key_is_refused(call):
    # the reference asserts the same (w % r == 0) on these functions
    with pytest.raises(ValueError):
        call(torch.arange(8, dtype=torch.int32))


# ------------------------------------------------------------ the facade


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("engine, ref_engine", [("radix", "radix"),
                                                ("fused-topk", "pallas")])
def test_topk_engines_match_reference(engine, ref_engine, dtype):
    jx = jnp.asarray(_floats((2, 3, 60), seed=5), dtype=dtype)
    tx = torch.from_numpy(np.asarray(jx).astype(np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    jv, ji = japi.topk(jx, 4, engine=ref_engine)
    tv, ti = tapi.topk(tx, 4, engine=engine)
    assert tuple(ti.shape) == (2, 3, 4) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv).astype(np.float32))


def test_torch_engine_values_match_lax():
    x = _floats((6, 96), seed=6)
    tv, ti = tapi.topk(torch.from_numpy(x), 5, engine="torch")
    jv, _ = japi.topk(jnp.asarray(x), 5, engine="lax")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32


def test_topk_unknown_engine():
    with pytest.raises(ValueError, match="unknown topk engine 'pallas'"):
        tapi.topk(torch.zeros((2, 8)), 2, engine="pallas")
    assert tapi.TOPK_ENGINES == ("radix", "fused-topk", "torch")


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("k", [1, 9, 40])
def test_topk_mask_matches_reference(largest, k):
    x = _floats((4, 80), seed=k)
    got = tapi.topk_mask(torch.from_numpy(x), k, largest=largest)
    want = japi.topk_mask(jnp.asarray(x), k, largest=largest)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [0, 13, 64])
def test_prune_mask_matches_reference(k):
    x = _floats((3, 64), seed=k)
    got = tapi.prune_mask(torch.from_numpy(x), torch.tensor(k))
    want = japi.prune_mask(jnp.asarray(x), jnp.int32(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(-1) == k).all()
