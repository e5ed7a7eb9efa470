"""Value bits and tie order of the port's top-k and sort paths against the
reference package: bfloat16 NaN payloads survive every gather (a torch
gather on bfloat16 writes every NaN as 0xFFFF), and the ``torch`` top-k
engine gives ties lowest index first and orders NaN, infinities and
signed zeros as ``jax.lax.top_k`` does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import radix_select as jrs
from repro.sort import api as japi
from repro_torch.core import radix_select as trs
from repro_torch.sort import api as tapi

# bfloat16 bits: NaN 0x7FC0, 1.0, -2.0, NaN 0xFFC0, 0.5
BF16_BITS = np.array([[0x7FC0, 0x3F80, 0xC000, 0xFFC0, 0x3F00]], np.uint16)


def _bf16_pair(bits: np.ndarray):
    """The same bfloat16 bits as a JAX array and a torch tensor, both built
    from the int16 view (a cast to bfloat16 would rewrite NaN)."""
    j = jnp.asarray(bits.view(jnp.bfloat16))
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return j, t


def _value_bits(v) -> list:
    if isinstance(v, torch.Tensor):
        return (v.view(torch.int16).numpy().view(np.uint16)).tolist()
    return np.asarray(v).view(np.uint16).tolist()


def test_bf16_nan_bits_survive_sort_values():
    j, t = _bf16_pair(BF16_BITS)
    jv, ji = jrs.sort_values(j)
    tv, ti = trs.sort_values(t)
    assert _value_bits(tv) == _value_bits(jv) == [
        [0xFFC0, 0xC000, 0x3F00, 0x3F80, 0x7FC0]]
    assert ti.tolist() == np.asarray(ji).tolist()


@pytest.mark.parametrize("k", [1, 3, 5])
def test_bf16_nan_bits_survive_topk_values(k):
    j, t = _bf16_pair(BF16_BITS)
    jv, ji = jrs.topk_values(j, k)
    tv, ti = trs.topk_values(t, k)
    assert _value_bits(tv) == _value_bits(jv)
    assert ti.tolist() == np.asarray(ji).tolist()


@pytest.mark.parametrize("engine, ref_engine", [("radix", "radix"),
                                                ("fused-topk", "pallas"),
                                                ("torch", "lax")])
def test_bf16_nan_bits_survive_sort_topk(engine, ref_engine):
    j, t = _bf16_pair(BF16_BITS)
    jv, ji = japi.topk(j, 4, engine=ref_engine)
    tv, ti = tapi.topk(t, 4, engine=engine)
    assert _value_bits(tv) == _value_bits(jv)
    assert ti.tolist() == np.asarray(ji).tolist()
    assert _value_bits(tv)[0][0] == 0x7FC0      # NaN first, its own bits


NAN_ROW = [np.nan, 1, -np.nan, 2, np.inf, np.nan, -np.inf, 0.0, -0.0, 0.0]


@pytest.mark.parametrize("row, k", [
    ([1, 1, 1, 1, 0.5], 4),
    ([2, 1, 1, 1, 1], 3),
    ([0.0] * 40, 5),
    (NAN_ROW, 10),
    ([0.0, -0.0, 0.0, -0.0], 4),
], ids=["four-ties", "tie-set", "zeros", "nan-inf", "signed-zeros"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_torch_engine_order_matches_lax(row, k, dtype):
    a = np.array([row], dtype=dtype)
    jv, ji = japi.topk(jnp.asarray(a), k, engine="lax")
    tv, ti = tapi.topk(torch.from_numpy(a), k, engine="torch")
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.uint8),
                                  np.asarray(jv).view(np.uint8))


def test_torch_engine_order_matches_lax_on_ints_and_batches():
    a = np.random.default_rng(0).integers(-3, 3, (4, 3, 50)).astype(np.int32)
    jv, ji = japi.topk(jnp.asarray(a), 7, engine="lax")
    tv, ti = tapi.topk(torch.from_numpy(a), 7, engine="torch")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
