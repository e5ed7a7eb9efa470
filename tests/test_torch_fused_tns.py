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
from repro_torch.core import ref_tns
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


def _distinct(fmt, n, b, seed):
    """(b, n) values of ``fmt`` with n distinct sort keys a row (16 bits
    wide), so that every episode emits exactly one number."""
    rng = np.random.default_rng(seed)
    if fmt == bp.FLOAT:
        finite = np.flatnonzero((np.arange(1 << 16) >> 10) & 0x1F != 0x1F)
        pick = [rng.choice(finite, n, replace=False) for _ in range(b)]
        return np.stack(pick).astype(np.uint16).view(np.float16), 16
    lo, dtype = {bp.UNSIGNED: (0, np.uint16), bp.TWOS: (-2**15, np.int16),
                 bp.SIGNMAG: (1 - 2**15, np.int32)}[fmt]
    span = (1 << 16) - (1 if fmt == bp.SIGNMAG else 0)
    return np.stack([lo + rng.choice(span, n, replace=False)
                     for _ in range(b)]).astype(dtype), 16


def _check_oracle(x, width, fmt, *, k, stop_after, ascending=True,
                  distinct=False):
    """``_check`` (the JAX kernel in interpret mode, every field), then the
    port's event-driven oracle row by row, then the work counters: exact
    on distinct keys, within their bounds on ties."""
    got = _check(x, width, fmt, k=k, stop_after=stop_after,
                 ascending=ascending)
    n = x.shape[1]
    m = n if stop_after is None else min(stop_after, n)
    for b in range(x.shape[0]):
        o = ref_tns.tns_sort(x[b], width=width, k=k, fmt=fmt,
                             ascending=ascending, stop_after=stop_after)
        np.testing.assert_array_equal(got.perm[b, :m].numpy(), o.perm[:m])
        assert (int(got.cycles[b]), int(got.drs[b]),
                int(got.reload_cycles[b])) == (o.cycles, o.drs,
                                               o.reload_cycles), b
    eps, lanes = got.episodes, got.lane_episodes
    if distinct:
        assert (eps == m).all()
        assert (lanes == sum(n - e for e in range(m))).all()
    else:
        assert ((eps >= 1) & (eps <= m)).all()
        assert (lanes >= eps * (n - m + 1)).all()
        assert (lanes <= eps * n).all()
    assert (got.useful_drs <= got.drs).all()
    return got


@pytest.mark.parametrize("fmt", list(FMT_DATA))
@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 1025])
def test_word_boundaries(fmt, n):
    # lane i is bit i & 31 of word i >> 5: N around a word's edge, and
    # past one warp's 32 words (1025)
    b, stop = (2, 64) if n > 64 else (3, None)
    x, width = _distinct(fmt, n, b, seed=n)
    _check_oracle(x, width, fmt, k=2, stop_after=stop, distinct=True)


def test_tie_set_across_the_word_and_warp_edge():
    # a 15-lane tie set of the least key over lanes 1010..1024: its ranks
    # come from the exclusive scan across word 31 / 32
    x, width = _distinct(bp.UNSIGNED, 1025, 2, seed=11)
    x[:, :1010] |= 1
    x[:, 1010:] = 0
    got = _check_oracle(x, width, bp.UNSIGNED, k=2, stop_after=30)
    np.testing.assert_array_equal(got.perm[:, :15].numpy(),
                                  np.tile(np.arange(1010, 1025), (2, 1)))


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("k", [0, 1, 2, "W+1"])
@pytest.mark.parametrize("width", [1, 30])
def test_width_extremes(width, k, ascending):
    # W = 1: two keys, each a tie set spanning three words; W = 30: the
    # widest key the reference packs, with some duplicates
    rng = np.random.default_rng(width)
    x = rng.integers(0, 1 << width, (2, 70)).astype(np.uint32)
    x[1, 40:50] = x[1, 3]
    _check_oracle(x, width, bp.UNSIGNED, k=width + 1 if k == "W+1" else k,
                  stop_after=None, ascending=ascending)


@pytest.mark.parametrize("kind", ["all ties", "heavy duplicates"])
@pytest.mark.parametrize("k", [0, 1, 2, "W+1"])
@pytest.mark.parametrize("fmt", list(FMT_DATA))
def test_ties_every_format(fmt, k, kind):
    # tie sets of up to 70 lanes over three words; a stop point inside a
    # tie set emits only its first lanes, in index order
    gen, width = FMT_DATA[fmt]
    rng = np.random.default_rng(len(kind) + width)
    vals = gen(rng, (2, 3))
    if kind == "all ties":
        x = np.repeat(vals[:, :1], 70, axis=1)
    else:
        x = np.take_along_axis(vals, rng.integers(0, 3, (2, 70)), axis=1)
    kk = width + 1 if k == "W+1" else k
    asc = kk % 2 == 0
    for stop in (None, 45):
        _check_oracle(x, width, fmt, k=kk, stop_after=stop, ascending=asc)


@pytest.mark.parametrize("fmt", [bp.UNSIGNED, bp.FLOAT, bp.SIGNMAG])
@pytest.mark.parametrize("k", [0, 2])
def test_planes_with_bytes_outside_0_1(fmt, k):
    # a plane byte (and a sign byte) counts as a 1 wherever it is not 0, in
    # the reference kernel and in the port alike: bytes 2 and 255 among the
    # planes and the sign plane, both directions, a full sort and a top-7
    rng = np.random.default_rng(k + len(fmt))
    planes = rng.integers(0, 2, (3, 8, 40)).astype(np.uint8)
    odd = rng.random(planes.shape)
    planes[odd < 0.1] = 2
    planes[odd > 0.9] = 255
    sign = None
    if fmt != bp.UNSIGNED:
        sign = rng.integers(0, 2, (3, 40)).astype(np.uint8)
        sign[rng.random(sign.shape) < 0.2] = 255
    p, s = bp.planes_from_numpy(planes, sign, device="cpu")
    for ascending in (True, False):
        for stop in (None, 7):
            want = jft.fused_tns_planes(
                jnp.asarray(planes),
                None if sign is None else jnp.asarray(sign), k=k, fmt=fmt,
                ascending=ascending, stop_after=stop, interpret=True)
            got = fused_tns.fused_tns_planes(p, s, k=k, fmt=fmt,
                                             ascending=ascending,
                                             stop_after=stop)
            for f in FIELDS:
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                    err_msg=f"{f} ascending={ascending} stop={stop}")


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
