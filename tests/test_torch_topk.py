"""The port's key-pack, radix top-k and pruned-matmul modules against the
reference package's Pallas kernels (run in interpret mode, as
``tests/test_kernels.py`` runs them), on the same seeded numpy inputs.
On the CPU the wrappers run the kernels' plain PyTorch versions; the CUDA
kernels themselves are held against those on the card (tests marked
``cuda``, and ``chip_smoke.py``).  Keys and indices are compared exactly,
the matmul with ``tests/test_kernels.py``'s tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import radix_select as jrs
from repro.kernels import bitplane_pack as jpack
from repro.kernels import masked_matmul as jmm
from repro.kernels import ops as jops
from repro.kernels import radix_topk as jrt
from repro.kernels import ref as jref
from repro_torch.core import bitplane as bp
from repro_torch.kernels import (bitplane_pack, masked_matmul, ops,
                                 radix_topk, ref)


def _bits(jkeys) -> np.ndarray:
    """JAX uint32 keys as the port's int32 bits."""
    return np.asarray(jkeys).astype(np.uint32).view(np.int32)


def _keys(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


def _same_inputs(a, dtype):
    """A float array as a JAX array of ``dtype`` and the port's tensor of
    the same bits (bfloat16 through its 16-bit pattern, so NaN payloads
    survive; torch's float32 -> bfloat16 cast would rewrite them)."""
    j = jnp.asarray(a, dtype=dtype)
    if dtype == jnp.bfloat16:
        bits = np.array(j).view(np.int16)
        return j, torch.from_numpy(bits).view(torch.bfloat16)
    return j, bp.keys_from_numpy(np.asarray(j), device="cpu")


def _check_topk(keys, k, r, jax_fn):
    jk, ji = jax_fn(jnp.asarray(keys))
    tk, ti = radix_topk.topk_keys(bp.keys_from_numpy(keys, device="cpu"),
                                  k, r=r)
    assert tk.dtype == ti.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), _bits(jk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    return tk, ti


# ------------------------------------------------------------ radix top-k


@pytest.mark.parametrize("b,n", [(1, 8), (4, 60), (8, 160), (3, 257),
                                 (16, 128)])
@pytest.mark.parametrize("k", [1, 4, 6])
def test_topk_keys_matches_kernel(b, n, k):
    keys = _keys((b, n), seed=b * n + k)
    _check_topk(keys, k, 4,
                lambda j: jrt.topk_keys(j, k, r=4, interpret=True))


@pytest.mark.parametrize("r", [1, 3])
def test_topk_keys_other_radices_match_kernel(r):
    keys = _keys((3, 33), seed=r)
    keys[1] = 7                                  # an all-ties row
    keys[2, 5:9] = keys[2, 3]                    # a partial tie
    _check_topk(keys, 2, r,
                lambda j: jrt.topk_keys(j, 2, r=r, interpret=True))


@pytest.mark.parametrize("k", [1, 6, 33])
def test_topk_keys_r8_matches_reference_min_search(k):
    # the interpret-mode kernel at r=8 unrolls 256 presence reductions per
    # digit; the reference's own min-search (which it reproduces for every
    # r that divides 32) is held here instead
    keys = _keys((3, 33), seed=k)
    keys[1] = 7
    _check_topk(keys, k, 8, lambda j: jrs.extract_topk(j, k, r=8))


def test_topk_keys_k_equals_n_and_all_ties():
    keys = _keys((2, 8), seed=3)
    keys[1] = 12345
    _, ti = _check_topk(keys, 8, 4,
                        lambda j: jrt.topk_keys(j, 8, r=4, interpret=True))
    assert ti[1].tolist() == list(range(8))
    np.testing.assert_array_equal(
        np.sort(ti[0].numpy()), np.arange(8))


def test_topk_keys_r3_never_reads_the_low_two_bits():
    # a behaviour of the reference: range(32 - r, -1, -r) stops at shift 2
    # for r = 3, so keys equal above bit 2 tie (the first index wins) and
    # the emitted key has bits 0-1 clear
    keys = np.array([[0x1003, 0x1000, 0x1002, 0x2001, 0x0FFF]], np.uint32)
    tk, ti = _check_topk(keys, 3, 3,
                         lambda j: jrt.topk_keys(j, 3, r=3, interpret=True))
    assert ti[0].tolist() == [4, 0, 1]
    assert tk[0].tolist() == [0x0FFC, 0x1000, 0x1000]
    # with r = 4 every bit is read
    tk4, ti4 = radix_topk.topk_keys(bp.keys_from_numpy(keys, device="cpu"),
                                    3, r=4)
    assert ti4[0].tolist() == [4, 1, 2] and tk4[0].tolist() == [
        0x0FFF, 0x1000, 0x1002]


def test_duplicate_keys_tie_order():
    keys = torch.tensor([[7, 3, 3, 9, 3]], dtype=torch.int32)
    _, idx = radix_topk.topk_keys(keys, 3)
    assert idx[0].tolist() == [1, 2, 4]


@pytest.mark.parametrize("n,k", [(16385, 3), (50304, 2)])
def test_topk_keys_wide_rows_match_kernel(n, k):
    # rows wider than a block's registers hold (the card stages them in
    # shared memory or reads them from global memory); the reference takes
    # any N
    keys = _keys((2, n), seed=n)
    keys[1, n - 5:] = 0                          # ties at the ragged end
    _check_topk(keys, k, 4,
                lambda j: jrt.topk_keys(j, k, r=4, interpret=True))


def test_topk_keys_ref_is_the_reference_oracle_at_r4():
    keys = _keys((4, 60), seed=9)
    _check_topk(keys, 6, 4, lambda j: jref.topk_keys_ref(j, 6))


# ------------------------------------------- the radix select's plain model
# ``topk_keys_select_ref`` models, step for step, the radix select that the
# CUDA kernel runs on rows past its warp form; it must give what k rounds
# of the reference's min-search give, on every row shape the select meets.

_SELECT_R = (1, 3, 4, 5, 8)
_SELECT_CELLS = [(n, k, r)
                 for n in (1, 31, 32, 33, 160, 1024, 1025, 16385)
                 for k in sorted({1, 6, 32, n}) if k <= n
                 for r in _SELECT_R]


def _select_rows(n, k, seed):
    """Random keys; all ties; ``% 7``; a tie set at the threshold that
    straddles the k-th slot (k // 2 keys below it, up to 2k + 1 at it,
    spread over the row so that the set crosses warp, thread and register
    boundaries); keys that differ only in their low 4 bits (unread for
    r = 7, partly for r = 3, 5)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (5, n), dtype=np.uint32)
    a[1] = 0x9E3779B9
    a[2] %= 7
    a[3] = rng.integers(2**31, 2**32, n, dtype=np.uint32)
    pos = rng.permutation(n)
    a[3, pos[:k // 2]] = rng.integers(0, 1000, k // 2)
    a[3, pos[k // 2:k // 2 + 2 * k + 1]] = 1000
    a[4] = (rng.integers(0, 3, n) << 4 | rng.integers(0, 16, n)) + 0x7000
    return a


def _stable_order(keys, r):
    """(masked keys, indices) of a stable sort: what k rounds of min-search
    emit at k = N."""
    mask = ~((1 << (32 % r)) - 1) & 0xFFFFFFFF
    wide, idx = torch.sort(keys.long() & mask, dim=1, stable=True)
    return (wide - ((wide >> 31) << 32)).to(torch.int32), idx.to(torch.int32)


@pytest.mark.parametrize("n,k,r", _SELECT_CELLS,
                         ids=[f"N{n}-k{k}-r{r}" for n, k, r in _SELECT_CELLS])
def test_topk_keys_select_ref_matches_min_search(n, k, r):
    keys = bp.keys_from_numpy(_select_rows(n, k, seed=n * 7 + k + r),
                              device="cpu")
    got = ref.topk_keys_select_ref(keys, k, r)
    assert got[0].dtype == got[1].dtype == torch.int32
    if k == n and n > 160:
        # k rounds of the min-search over a row are its stable sort; their
        # first 32 are held to the min-search itself
        want = _stable_order(keys, r)
        head = ref.topk_keys_ref(keys, 32, r)
        assert torch.equal(got[0][:, :32], head[0])
        assert torch.equal(got[1][:, :32], head[1])
    else:
        want = ref.topk_keys_ref(keys, k, r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the JAX kernel in interpret mode unrolls k * (32 / r) * 2^r reductions,
# so it is run at k <= 6 over every N and every r that it takes; at r = 8
# its own min-search stands in, as in the test above
_SELECT_JAX_CELLS = [(1, 1, 3), (31, 6, 1), (32, 6, 5), (33, 6, 4),
                     (160, 6, 3), (1024, 1, 5), (1025, 6, 4), (1025, 1, 1),
                     (16385, 1, 3), (16385, 6, 1)]
_SELECT_R8_CELLS = [(1, 1), (32, 32), (160, 160), (1024, 6), (1025, 32),
                    (16385, 6)]


@pytest.mark.parametrize("n,k,r", _SELECT_JAX_CELLS,
                         ids=[f"N{n}-k{k}-r{r}" for n, k, r in
                              _SELECT_JAX_CELLS])
def test_topk_keys_select_ref_matches_kernel(n, k, r):
    a = _select_rows(n, k, seed=n + k * r)
    jk, ji = jrt.topk_keys(jnp.asarray(a), k, r=r, interpret=True)
    tk, ti = ref.topk_keys_select_ref(bp.keys_from_numpy(a, device="cpu"),
                                      k, r)
    np.testing.assert_array_equal(tk.numpy(), _bits(jk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n,k", _SELECT_R8_CELLS,
                         ids=[f"N{n}-k{k}" for n, k in _SELECT_R8_CELLS])
def test_topk_keys_select_ref_r8_matches_reference_min_search(n, k):
    a = _select_rows(n, k, seed=n + k)
    jk, ji = jrs.extract_topk(jnp.asarray(a), k, r=8)
    tk, ti = ref.topk_keys_select_ref(bp.keys_from_numpy(a, device="cpu"),
                                      k, 8)
    np.testing.assert_array_equal(tk.numpy(), _bits(jk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("r,want_idx,want_keys", [
    (3, [4, 0, 1], [0x0FFC, 0x1000, 0x1000]),
    (7, [4, 0, 1], [0x0FF0, 0x1000, 0x1000]),
    (4, [4, 1, 2], [0x0FFF, 0x1000, 0x1002]),
])
def test_topk_keys_select_ref_reads_only_the_read_bits(r, want_idx,
                                                       want_keys):
    # r = 3 never reads bits 0-1 and r = 7 bits 0-3: keys equal above them
    # tie (the first index wins) and are emitted with those bits clear
    keys = bp.keys_from_numpy(
        np.array([[0x1003, 0x1000, 0x1002, 0x2001, 0x0FFF]], np.uint32),
        device="cpu")
    tk, ti = ref.topk_keys_select_ref(keys, 3, r)
    assert ti[0].tolist() == want_idx and tk[0].tolist() == want_keys
    assert torch.equal(tk, ref.topk_keys_ref(keys, 3, r)[0])


def test_topk_keys_select_ref_passes_stop_once_the_prefix_is_taken():
    # distinct top bytes: the first pass finds the k-th key's bin holding
    # only it; all ties: every digit is read, then the first k in index
    # order
    distinct = torch.arange(256, dtype=torch.int64)[None] << 24
    stats = {}
    _, idx = ref.topk_keys_select_ref(
        torch.flip(distinct, [1]).to(torch.int32), 5, 4, stats)
    assert stats["passes"] == 1 and idx[0].tolist() == [
        255, 254, 253, 252, 251]
    stats = {}
    _, idx = ref.topk_keys_select_ref(
        torch.full((2, 40), 7, dtype=torch.int32), 6, 4, stats)
    assert stats["passes"] == 8 and idx.tolist() == [list(range(6))] * 2


# -------------------------------------------------------- key packing


def _pack_input(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == jnp.int32:
        a = rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int32)
        return jnp.asarray(a), torch.from_numpy(a)
    return _same_inputs(rng.standard_normal(shape) * 1e3, dtype)


@pytest.mark.parametrize("shape", [(7,), (33, 9), (4, 130, 3)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
def test_pack_matches_kernel(shape, dtype):
    jx, tx = _pack_input(dtype, shape, seed=len(shape))
    got = bitplane_pack.pack_keys(tx)
    assert got.dtype == torch.int32 and got.shape == tx.shape
    np.testing.assert_array_equal(
        got.numpy(), _bits(jpack.pack_keys(jx, interpret=True)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_special_values_keep_the_reference_bits(dtype):
    x = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-9, 7.25, np.inf, np.nan,
                  -np.nan], np.float32)
    jx, tx = _same_inputs(x, dtype)
    got = bitplane_pack.pack_keys(tx)
    np.testing.assert_array_equal(
        got.numpy(), _bits(jpack.pack_keys(jx, interpret=True)))
    wide = got[:7].to(torch.int64) & 0xFFFFFFFF        # -inf .. +inf
    assert bool((wide[1:] > wide[:-1]).all())


def test_unpack_inverts_pack_and_matches_kernel():
    x = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-9, 7.25, np.inf, np.nan],
                 np.float32)
    x = np.concatenate([x, np.random.default_rng(0).standard_normal(
        40).astype(np.float32)])
    keys = bitplane_pack.pack_keys(torch.from_numpy(x))
    back = bitplane_pack.unpack_keys_f32(keys)
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  x.view(np.uint32))
    want = jpack.unpack_keys_f32(jnp.asarray(keys.numpy().view(np.uint32)),
                                 interpret=True)
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_pack_passes_uint32_keys_through():
    a = _keys((3, 5), seed=1)
    t = torch.from_numpy(a)
    got = bitplane_pack.pack_keys(t)
    np.testing.assert_array_equal(got.numpy(), a.view(np.int32))


# ------------------------------------------------------ pruned matmul


@pytest.mark.parametrize("m,kdim,n", [(8, 16, 8), (100, 64, 72),
                                      (130, 257, 120)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_pruned_matmul_matches_kernel(m, kdim, n, dtype):
    rng = np.random.default_rng(m + kdim + n)
    jx, tx = _same_inputs(rng.standard_normal((m, kdim)), dtype)
    jw, tw = _same_inputs(rng.standard_normal((kdim, n)), dtype)
    keep = rng.random(kdim) > 0.3
    want = jmm.pruned_matmul(jx, jw, jnp.asarray(keep), interpret=True)
    got = masked_matmul.pruned_matmul(tx, tw, torch.from_numpy(keep))
    assert got.dtype == tx.dtype and got.shape == (m, n)
    bf = dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2 if bf else 1e-5,
                               atol=1e-2 if bf else 1e-5)


def test_full_prune_zeroes_output():
    out = masked_matmul.pruned_matmul(torch.ones((4, 32)),
                                      torch.ones((32, 16)),
                                      torch.zeros(32, dtype=torch.bool))
    assert float(out.abs().max()) == 0.0


def test_masked_lane_multiplies_not_selects():
    # x * mask: an inf in a masked lane gives NaN, as the reference's
    x = torch.tensor([[1.0, float("inf")]])
    w = torch.ones((2, 1))
    out = masked_matmul.pruned_matmul(x, w, torch.tensor([True, False]))
    want = jops.pruned_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                              jnp.asarray([True, False]), interpret=True)
    assert np.isnan(np.asarray(want)).all() and torch.isnan(out).all()


# ---------------------------------------------------------- ops.topk


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ops_topk_matches_reference(dtype):
    jx, tx = _same_inputs(np.random.default_rng(42).standard_normal((6, 96)),
                          dtype)
    jv, ji = jops.topk(jx, 4, interpret=True)
    tv, ti = ops.topk(tx, 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv).astype(np.float32))
    assert tv.dtype == tx.dtype


def test_ops_entry_points_reach_the_modules():
    planes = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (2, 8, 12), dtype=np.uint8))
    mask, drs = ops.min_search(planes)
    rmask, rdrs = ref.min_search_ref(planes)
    assert torch.equal(mask, rmask) and torch.equal(drs, rdrs)
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ops.unpack_keys_f32(ops.pack_keys(x)), x)
    keep = torch.tensor([True, False, True, True, False])
    w = torch.randn(5, 2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(ops.pruned_matmul(x, w, keep),
                       ref.pruned_matmul_ref(x, w, keep))


# ------------------------------------------------------------- guards


@pytest.mark.parametrize("call", [
    lambda: radix_topk.topk_keys(torch.zeros((2, 8), dtype=torch.int64), 2),
    lambda: radix_topk.topk_keys(torch.zeros(8, dtype=torch.int32), 2),
    lambda: radix_topk.topk_keys(
        torch.zeros((8, 2), dtype=torch.int32).t(), 2),
    lambda: radix_topk.topk_keys(torch.zeros((2, 8), dtype=torch.int32), 9),
    lambda: radix_topk.topk_keys(torch.zeros((2, 8), dtype=torch.int32), 0),
    lambda: radix_topk.topk_keys(torch.zeros((2, 8), dtype=torch.int32), 2,
                                 r=9),
    lambda: radix_topk.topk_keys(torch.zeros((1, 0), dtype=torch.int32), 1),
    lambda: bitplane_pack.pack_keys(torch.zeros(3, dtype=torch.float64)),
    lambda: bitplane_pack.unpack_keys_f32(torch.zeros(3)),
    lambda: masked_matmul.pruned_matmul(
        torch.zeros((2, 3)), torch.zeros((3, 2), dtype=torch.bfloat16),
        torch.ones(3, dtype=torch.bool)),
    lambda: masked_matmul.pruned_matmul(
        torch.zeros((2, 3)), torch.zeros((4, 2)),
        torch.ones(3, dtype=torch.bool)),
    lambda: masked_matmul.pruned_matmul(
        torch.zeros((2, 3)), torch.zeros((3, 2)), torch.ones(3)),
    lambda: masked_matmul.pruned_matmul(
        torch.zeros((3, 2)).t(), torch.zeros((3, 2)),
        torch.ones(3, dtype=torch.bool)),
], ids=["dtype", "ndim", "strided", "k>n", "k=0", "r", "n", "pack-dtype",
        "unpack-dtype", "mm-dtype", "mm-shape", "mm-mask", "mm-strided"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises((TypeError, ValueError)):
        call()
