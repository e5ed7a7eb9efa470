"""The port's fused TNS and digit-read modules against the reference
package's Pallas kernels (run in interpret mode), on the same seeded numpy
inputs.  On the CPU the wrappers run the kernels' plain PyTorch versions;
the CUDA kernels themselves are held against those on the card (tests
marked ``cuda``, and ``chip_smoke.py``).  Every output is an integer and
is compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.kernels import digit_read as jdr
from repro.kernels import fused_tns as jft
from repro_torch.core import bitplane as bp
from repro_torch.kernels import digit_read, fused_tns

FMT_DATA = {
    bp.UNSIGNED: (lambda r, s: r.integers(0, 256, s).astype(np.uint8), 8),
    bp.TWOS: (lambda r, s: r.integers(-128, 128, s).astype(np.int8), 8),
    bp.SIGNMAG: (lambda r, s: r.integers(-2**14, 2**14, s), 16),
    bp.FLOAT: (lambda r, s: r.standard_normal(s).astype(np.float16), 16),
}
FIELDS = ("perm", "cycles", "drs", "reload_cycles", "useful_drs")


def _batch(fmt, n, b, seed):
    gen, width = FMT_DATA[fmt]
    return gen(np.random.default_rng(seed), (b, n)), width


def _image(x, width, fmt):
    planes = jbp.to_bitplanes(x, width, fmt)
    sign = (jbp.sign_plane(x, width, fmt)
            if fmt in (bp.SIGNMAG, bp.FLOAT) else None)
    return planes, sign


def _check(x, width, fmt, *, k, stop_after, ascending=True):
    planes, sign = _image(x, width, fmt)
    want = jft.fused_tns_planes(
        jnp.asarray(planes), None if sign is None else jnp.asarray(sign),
        k=k, fmt=fmt, ascending=ascending, stop_after=stop_after,
        interpret=True)
    p, s = bp.planes_from_numpy(planes, sign, device="cpu")
    got = fused_tns.fused_tns_planes(p, s, k=k, fmt=fmt, ascending=ascending,
                                     stop_after=stop_after)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    return got


@pytest.mark.parametrize("fmt", list(FMT_DATA))
@pytest.mark.parametrize("n", [8, 24, 130])
@pytest.mark.parametrize("k", [0, 2])
def test_contract_grid(fmt, n, k):
    x, width = _batch(fmt, n, 3, seed=n + k)
    _check(x, width, fmt, k=k, stop_after=min(6, n))


@pytest.mark.parametrize("fmt", [bp.UNSIGNED, bp.FLOAT])
def test_full_sort(fmt):
    x, width = _batch(fmt, 12, 2, seed=5)
    got = _check(x, width, fmt, k=2, stop_after=None)
    keys = bp.sort_key(x, width, fmt)
    np.testing.assert_array_equal(got.perm.numpy(),
                                  np.argsort(keys, axis=1, kind="stable"))


@pytest.mark.parametrize("fmt", [bp.TWOS, bp.SIGNMAG])
def test_descending(fmt):
    x, width = _batch(fmt, 20, 2, seed=6)
    _check(x, width, fmt, k=2, stop_after=5, ascending=False)


def test_single_element():
    x, width = _batch(bp.UNSIGNED, 1, 2, seed=7)
    got = _check(x, width, bp.UNSIGNED, k=2, stop_after=None)
    assert got.perm.tolist() == [[0], [0]]


def test_all_ties_drain_in_index_order():
    x = np.zeros((2, 16), np.uint8)
    got = _check(x, 8, bp.UNSIGNED, k=2, stop_after=None)
    np.testing.assert_array_equal(got.perm.numpy(), np.tile(np.arange(16),
                                                            (2, 1)))
    assert got.useful_drs.tolist() == [0, 0]
    # partial tie set: only the first stop_after of the tie are emitted
    part = _check(x, 8, bp.UNSIGNED, k=2, stop_after=5)
    assert part.perm[0, :5].tolist() == [0, 1, 2, 3, 4]
    assert (part.perm[:, 5:] == -1).all()


def test_useful_drs_match_min_search_on_one_episode():
    # with stop_after=1 the fused controller runs exactly one min-search
    # episode, so its mixed-read count equals the digit-read search's
    x, width = _batch(bp.UNSIGNED, 64, 3, seed=8)
    planes, _ = _image(x, width, bp.UNSIGNED)
    got = _check(x, width, bp.UNSIGNED, k=2, stop_after=1)
    _, udr = digit_read.min_search(torch.from_numpy(planes))
    _, judr = jdr.min_search(jnp.asarray(planes), interpret=True)
    np.testing.assert_array_equal(got.useful_drs.numpy(), udr.numpy())
    np.testing.assert_array_equal(udr.numpy(), np.asarray(judr))


def test_work_counters():
    x, width = _batch(bp.SIGNMAG, 48, 3, seed=9)
    got = _check(x, width, bp.SIGNMAG, k=2, stop_after=12)
    assert (got.useful_drs <= got.drs).all()
    # each episode emits >= 1 number, and sees every lane still alive
    assert ((got.episodes >= 1) & (got.episodes <= 12)).all()
    assert (got.lane_episodes >= got.episodes * (48 - 12 + 1)).all()
    assert (got.lane_episodes <= got.episodes * 48).all()


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("shape", [(3, 8, 5), (2, 16, 130)])
def test_min_search_matches_reference(ascending, shape):
    b, w, n = shape
    x = np.random.default_rng(n).integers(0, 1 << w, (b, n))
    planes = jbp.to_bitplanes(x, w, bp.UNSIGNED)
    planes[0, :, :2] = planes[0, :, 2:3]               # a tie at the edge
    mask, drs = digit_read.min_search(torch.from_numpy(planes), ascending)
    jmask, jdrs = jdr.min_search(jnp.asarray(planes), ascending=ascending,
                                 interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(drs.numpy(), np.asarray(jdrs))
    assert drs.dtype == torch.int32 and mask.dtype == torch.bool


@pytest.mark.parametrize("call", [
    lambda: fused_tns.fused_tns_rank(torch.zeros((2, 8, 4), dtype=torch.int32),
                                     k=2),
    lambda: fused_tns.fused_tns_rank(torch.zeros((8, 4), dtype=torch.uint8),
                                     k=2),
    lambda: fused_tns.fused_tns_rank(
        torch.zeros((2, 4, 8), dtype=torch.uint8).transpose(1, 2), k=2),
    lambda: fused_tns.fused_tns_rank(torch.zeros((1, 31, 4),
                                                 dtype=torch.uint8), k=2),
    lambda: fused_tns.fused_tns_rank(torch.zeros((1, 8, 0),
                                                 dtype=torch.uint8), k=2),
    lambda: fused_tns.fused_tns_rank(torch.zeros((1, 8, 4),
                                                 dtype=torch.uint8), k=-1),
    lambda: fused_tns.fused_tns_rank(
        torch.zeros((1, 8, 4), dtype=torch.uint8), k=2, fmt=bp.FLOAT,
        sign=torch.zeros((1, 3), dtype=torch.uint8)),
    lambda: digit_read.min_search(torch.zeros((2, 8, 4), dtype=torch.int64)),
    lambda: digit_read.min_search(torch.zeros((1, 8, 0), dtype=torch.uint8)),
], ids=["dtype", "ndim", "strided", "width", "empty", "k", "sign",
        "dr-dtype", "dr-empty"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_sort_wrapper_guards():
    x = np.zeros((2, 4), np.uint8)
    with pytest.raises(NotImplementedError):
        fused_tns.fused_tns_sort(x, width=8, k=2, level_bits=2,
                                 device="cpu")
    with pytest.raises(ValueError):
        fused_tns.fused_tns_sort(x[0], width=8, k=2, device="cpu")


def test_rank_to_perm_inverts_the_ring():
    rank = torch.tensor([[2, 0, -1, 1], [-1, -1, 0, -1]], dtype=torch.int32)
    assert fused_tns.rank_to_perm(rank).tolist() == [[1, 3, 0, -1],
                                                     [2, -1, -1, -1]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", list(FMT_DATA))
def test_kernels_match_plain_versions_on_card(cuda_device, fmt):
    x, width = _batch(fmt, 130, 4, seed=10)
    planes, sign = _image(x, width, fmt)
    p, s = bp.planes_from_numpy(planes, sign, device=cuda_device)
    for k in (0, 2):
        for stop in (6, None):
            launches = fused_tns.LAUNCHES
            got = fused_tns.fused_tns_rank(p, s, k=k, fmt=fmt,
                                           stop_after=stop)
            assert fused_tns.LAUNCHES == launches + 1
            want = fused_tns.fused_tns_rank_ref(
                p, s, k=k, fmt=fmt, stop_n=130 if stop is None else stop)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    mask, drs = digit_read.min_search(p)
    rmask, rdrs = digit_read.min_search_ref(p)
    assert torch.equal(mask, rmask) and torch.equal(drs, rdrs)
