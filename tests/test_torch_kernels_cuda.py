"""The fused TNS, digit-read, key-pack, radix top-k, pruned-matmul and
decode-attention CUDA kernels against their plain PyTorch versions on the
card, and the
cycle-faithful machines (plain torch) on the card against their runs on
the host.  The file imports no JAX, so it runs on a machine with a card and
no JAX:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips."""
import numpy as np
import pytest
import torch

from repro_torch import sort as tsort
from repro_torch.core import bitplane as bp
from repro_torch.core import catns, tns
from repro_torch.core import radix_select as rs
from repro_torch.kernels import (bitplane_pack, decode_attn, digit_read,
                                 fused_tns, masked_matmul, ops, radix_topk,
                                 ref)
from repro_torch.runtime import faults

import _sort_assembly as assembly


def _keys(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1023, 1025, 4096])
@pytest.mark.parametrize("k", [0, 1, 2, 17])
def test_fused_tns_kernel_at_word_edges_on_card(cuda_device, n, k):
    # float16 keys (W = 16) with an all-ties row and a heavy-duplicates
    # row: rank ring and all 8 counters equal, top 6 and a full sort (top
    # 300 past 1025 lanes)
    x = np.random.default_rng(n + k).standard_normal((6, n)).astype(
        np.float16)
    x[1] = x[1, 0]
    x[2] = np.round(x[2])
    sign = bp.sign_plane(x, 16, "float")
    planes, sign = bp.planes_from_numpy(bp.to_bitplanes(x, 16, "float"),
                                        sign, device=cuda_device)
    for stop in (6, None if n <= 1025 else 300):
        launches = fused_tns.LAUNCHES
        got = fused_tns.fused_tns_rank(planes, sign, k=k, fmt="float",
                                       ascending=k % 2 == 0, stop_after=stop)
        assert fused_tns.LAUNCHES == launches + 1
        want = fused_tns.fused_tns_rank_ref(
            planes, sign, k=k, fmt="float", ascending=k % 2 == 0,
            stop_n=n if stop is None else min(stop, n))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _key_rows(dtype, n, seed):
    """Six rows of keys in ``dtype``'s container: random over its whole
    range led by its extremes (float16: -0, +-inf, NaN), all ties, a few
    values, the negative half (the top half unsigned), and zeros past the
    middle."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt == np.float16:
        x = rng.integers(0, 1 << 16, (6, n)).astype(np.uint16).view(dt)
        special = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, -1.0], dt)
    else:
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, (6, n), endpoint=True).astype(dt)
        special = np.array([info.min, info.max, 0, info.min + 1, 1], dt)
    x[0, :min(n, special.size)] = special[:n]
    x[1] = x[1, 0]
    x[2] = x[2, rng.integers(0, min(n, 3), n)]
    if dt.kind == "i":
        x[3] = np.where(x[3] < 0, x[3], -1 - x[3])
    elif dt.kind == "u":
        x[3] |= dt.type(1 << (8 * dt.itemsize - 1))
    else:
        x[3] = -np.abs(x[3])
    x[5, n // 2:] = 0
    return x


_ENCODE_CELLS = [("unsigned", np.uint8, 8), ("unsigned", np.uint32, 30),
                 ("unsigned", np.int16, 1), ("twos", np.int8, 8),
                 ("twos", np.uint16, 16), ("signmag", np.int32, 30),
                 ("signmag", np.int16, 12), ("float", np.float16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1023, 1024, 1025, 2049])
@pytest.mark.parametrize("fmt,dtype,width", _ENCODE_CELLS,
                         ids=[f"{f}-{np.dtype(d).name}-W{w}"
                              for f, d, w in _ENCODE_CELLS])
def test_fused_tns_device_encode_on_card(cuda_device, fmt, dtype, width, n):
    # the keys' bit-planes built on the card are the host's encode bit for
    # bit, every format and container; INT32_MIN under sign-magnitude,
    # float16 -0, +-inf, NaN
    x = _key_rows(dtype, n, seed=n + width)
    planes, sign = fused_tns.planes_from_keys(
        torch.from_numpy(x).to(cuda_device), width, fmt)
    assert planes.device.type == "cuda"
    assert np.array_equal(planes.cpu().numpy(),
                          bp.to_bitplanes(x, width, fmt))
    if fmt in ("signmag", "float"):
        assert np.array_equal(sign.cpu().numpy(),
                              bp.sign_plane(x, width, fmt).astype(np.uint8))
    else:
        assert sign is None


@pytest.mark.cuda
def test_fused_tns_sort_encodes_on_card_at_the_cells_size(cuda_device):
    # the benchmark's call: (4096, 1024) uint8 at W = 8, k = 2, unsigned;
    # sort() encodes on the card, launches the kernel once, and returns
    # the SortResult of the same sort through a hook that injects nothing
    # in every field, both ways
    x = np.random.default_rng(12).integers(0, 256, (4096, 1024)).astype(
        np.uint8)
    for ascending in (True, False):
        launches = fused_tns.LAUNCHES
        got = tsort.sort(x, engine="fused-tns", k=2, ascending=ascending)
        assert fused_tns.LAUNCHES == launches + 1
        with faults.inject(faults.FaultSpec()):
            want = tsort.sort(x, engine="fused-tns", k=2,
                              ascending=ascending)
        for f in ("indices", "values", "cycles", "drs", "reload_cycles"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert np.array_equal(tsort.sort(x, engine="fused-tns", k=2).indices,
                          np.argsort(x, axis=1, kind="stable"))


@pytest.mark.cuda
@pytest.mark.parametrize("stop", assembly.STOPS)
@pytest.mark.parametrize("shape", assembly.SHAPES, ids=["1d", "2d"])
@pytest.mark.parametrize("dtype", list(assembly.KEYS))
def test_sort_assembles_its_result_on_card(cuda_device, dtype, shape, stop):
    # the values gathered on the card by the permutation, the result back
    # in page-locked buffers: every container, in every field the sort's
    # through a hook that injects nothing
    assembly.check_assembled(dtype, shape, stop, cuda_device)


@pytest.mark.cuda
def test_a_held_result_keeps_its_pinned_arrays_on_card(cuda_device):
    assembly.check_held(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 3, 4, 8])
def test_topk_kernel_matches_plain_version_on_card(cuda_device, r):
    keys = bp.keys_from_numpy(_keys((16, 160), seed=r), device=cuda_device)
    keys[1] = 5
    launches = radix_topk.LAUNCHES
    got = radix_topk.topk_keys(keys, 6, r=r)
    assert radix_topk.LAUNCHES == launches + 1
    want = ref.topk_keys_ref(keys, 6, r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16385, 50304, 70000])
@pytest.mark.parametrize("r", [3, 8])
def test_topk_kernel_wide_rows_match_plain_version_on_card(cuda_device, n,
                                                           r):
    # past 16384 lanes a row's keys leave the registers: staged in shared
    # memory up to about 58K lanes, read from global memory beyond
    keys = bp.keys_from_numpy(_keys((4, n), seed=n + r), device=cuda_device)
    keys[1] = 5
    keys[2, n - 9:] = 0
    got = radix_topk.topk_keys(keys, 6, r=r)
    want = ref.topk_keys_ref(keys, 6, r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _edge_rows(n, k, seed):
    """Random keys; all ties; ``% 7``; a tie set at the threshold that
    straddles the k-th slot, spread over the row; keys that differ only in
    their low 4 bits; zeros at the ragged end."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (6, n), dtype=np.uint32)
    a[1] = 5
    a[2] %= 7
    a[3] = rng.integers(2**31, 2**32, n, dtype=np.uint32)
    pos = rng.permutation(n)
    a[3, pos[:k // 2]] = rng.integers(0, 1000, k // 2)
    a[3, pos[k // 2:k // 2 + 2 * k + 1]] = 1000
    a[4] = (rng.integers(0, 3, n) << 4 | rng.integers(0, 16, n)) + 0x7000
    a[5, n - 9:] = 0
    return a


# the kernel's form edges: the warp form's widest row and one past it, the
# widest row staged in shared memory and one past it (read from global
# memory), the select's largest k and one past it (the digit rounds)
_TOPK_EDGE_CELLS = [(n, k) for n in (1024, 1025, "limit", "limit+1")
                    for k in (1, 32, radix_topk.SORT_CAP,
                              radix_topk.SORT_CAP + 1)
                    if not (n == 1024 and k > 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", _TOPK_EDGE_CELLS,
                         ids=[f"N{n}-k{k}" for n, k in _TOPK_EDGE_CELLS])
def test_topk_kernel_at_its_form_edges_on_card(cuda_device, n, k):
    if isinstance(n, str):
        n = radix_topk.stage_limit(cuda_device) + (n == "limit+1")
    rows = _edge_rows(n, k, seed=n + k)
    if k > radix_topk.SORT_CAP:
        rows = rows[[1, 3]]        # the digit rounds: k rounds a row
    keys = bp.keys_from_numpy(rows, device=cuda_device)
    launches = radix_topk.LAUNCHES
    got = radix_topk.topk_keys(keys, k, r=4)
    assert radix_topk.LAUNCHES == launches + 1
    want = ref.topk_keys_ref(keys, k, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [160, 1024, 4099])
@pytest.mark.parametrize("r", [5, 6, 7])
def test_topk_kernel_reads_only_the_read_bits_on_card(cuda_device, n, r):
    # r = 5, 6 never read bits 0-1 and r = 7 bits 0-3; equal to the plain
    # version and to the select's plain model
    keys = bp.keys_from_numpy(_edge_rows(n, 32, seed=n * r),
                              device=cuda_device)
    got = radix_topk.topk_keys(keys, 32, r=r)
    for want in (ref.topk_keys_ref(keys, 32, r),
                 ref.topk_keys_select_ref(keys, 32, r)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool((got[0] & ((1 << (32 % r)) - 1)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_pack_kernel_matches_plain_version_on_card(cuda_device, dtype):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1027).astype(np.float32) * 1e3)
    x = (x.to(torch.int32) if dtype == torch.int32 else x.to(dtype)).to(
        cuda_device)
    launches = bitplane_pack.LAUNCHES
    got = bitplane_pack.pack_keys(x)
    assert bitplane_pack.LAUNCHES == launches + 1
    assert torch.equal(got, ref.pack_keys_ref(x))
    if dtype == torch.float32:
        assert torch.equal(bitplane_pack.unpack_keys_f32(got), x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain_version_on_card(cuda_device, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(130, 257, generator=g).to(dtype).to(cuda_device)
    w = torch.randn(257, 120, generator=g).to(dtype).to(cuda_device)
    keep = (torch.rand(257, generator=g) > 0.3).to(cuda_device)
    launches = masked_matmul.LAUNCHES
    form = "ffma" if dtype == torch.float32 else "wmma"   # K = 257
    forms = dict(masked_matmul.FORM_LAUNCHES)
    got = masked_matmul.pruned_matmul(x, w, keep)
    assert masked_matmul.LAUNCHES == launches + 1
    assert masked_matmul.FORM_LAUNCHES[form] == forms[form] + 1
    want = ref.pruned_matmul_ref(x, w, keep)
    # both within the float32-accumulation bound of the float64 product:
    # one float32 ulp per addition over K terms (acc), plus the output's
    # rounding, at most u * (|exact| + acc) with u the output type's unit
    # roundoff; the two sum in different orders, so a fixed tolerance
    # between them would be a tuned one
    xm = (x.double() * keep.double())
    exact = xm @ w.double()
    unit = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    acc = x.shape[1] * 2.0 ** -23 * (xm.abs() @ w.double().abs())
    tol = acc * (1 + unit) + unit * exact.abs()
    for y in (got, want):
        assert bool(((y.double() - exact).abs() <= tol).all())


def _within_bound(x, w, keep, y):
    """``y`` within the float32-accumulation bound of the float64 product
    (the bound of the test above), off the product's NaN entries, which
    must be NaN in ``y`` too."""
    x0 = torch.where(torch.isfinite(x), x, torch.zeros_like(x)).double()
    w0 = torch.where(torch.isfinite(w), w, torch.zeros_like(w)).double()
    exact = (x.double() * keep.double()) @ w.double()
    nan = torch.isnan(exact)
    assert torch.equal(torch.isnan(y), nan)
    xm = x0 * keep.double()
    exact0 = xm @ w0
    unit = 2.0 ** -8 if x.dtype == torch.bfloat16 else 2.0 ** -24
    acc = x.shape[1] * 2.0 ** -23 * (xm.abs() @ w0.abs())
    tol = acc * (1 + unit) + unit * exact0.abs()
    return bool(((y.double() - exact0).abs() <= tol)[~nan].all())


# the wgmma form's edges: M of one row, a warpgroup's 64 rows and one past,
# a ragged pair of tiles; N of one 16-byte chunk, one tile and one past;
# K of one chunk, one step and a chunk, 32 steps and a chunk
_MM_EDGE_CELLS = [(m, n, k) for m in (1, 64, 65, 130) for n in (8, 256, 264)
                  for k in (8, 72, 2056)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", _MM_EDGE_CELLS,
                         ids=[f"M{m}-N{n}-K{k}" for m, n, k in _MM_EDGE_CELLS])
def test_matmul_wgmma_form_at_its_edges_on_card(cuda_device, m, n, k):
    g = torch.Generator().manual_seed(m * n + k)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(cuda_device)
    w = torch.randn(k, n, generator=g).to(torch.bfloat16).to(cuda_device)
    keep = (torch.rand(k, generator=g) > 0.3).to(cuda_device)
    assert masked_matmul.form_for(x, w) == "wgmma"
    for mask in (keep, torch.zeros_like(keep), torch.ones_like(keep)):
        launches = dict(masked_matmul.FORM_LAUNCHES)
        got = masked_matmul.pruned_matmul(x, w, mask)
        assert masked_matmul.FORM_LAUNCHES["wgmma"] == launches["wgmma"] + 1
        assert _within_bound(x, w, mask, got)
        if not bool(mask.any()):
            assert not bool(got.abs().max())
    # deterministic: the same bits twice
    assert torch.equal(masked_matmul.pruned_matmul(x, w, keep),
                       masked_matmul.pruned_matmul(x, w, keep))


@pytest.mark.cuda
def test_matmul_nan_in_pruned_lanes_on_card(cuda_device):
    # NaN / infinity in pruned lanes of x and pruned rows of w: NaN in the
    # same rows and columns as the plain version's
    g = torch.Generator().manual_seed(3)
    x = torch.randn(130, 200, generator=g).to(torch.bfloat16)
    w = torch.randn(200, 264, generator=g).to(torch.bfloat16)
    keep = torch.rand(200, generator=g) > 0.3
    pruned = torch.nonzero(~keep).flatten()
    x[3, pruned[0]], x[70, pruned[4]] = float("nan"), float("-inf")
    w[pruned[1], 5], w[pruned[6], 200] = float("inf"), float("nan")
    x, w, keep = x.to(cuda_device), w.to(cuda_device), keep.to(cuda_device)
    got = masked_matmul.pruned_matmul(x, w, keep)
    want = ref.pruned_matmul_ref(x, w, keep)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(torch.isnan(got).sum()) == 2 * 264 + 2 * 130 - 4
    assert _within_bound(x, w, keep, got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 0, 16), (64, 64, 60)],
                         ids=["K0", "N60"])
def test_matmul_wmma_form_on_card(cuda_device, shape):
    # K = 0 (which no tensor map can describe: zeros) and N not a multiple
    # of 8 take the wmma form
    m, k, n = shape
    g = torch.Generator().manual_seed(k + n)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(cuda_device)
    w = torch.randn(k, n, generator=g).to(torch.bfloat16).to(cuda_device)
    keep = (torch.rand(k, generator=g) > 0.3).to(cuda_device)
    launches = dict(masked_matmul.FORM_LAUNCHES)
    got = masked_matmul.pruned_matmul(x, w, keep)
    assert masked_matmul.FORM_LAUNCHES["wmma"] == launches["wmma"] + 1
    assert _within_bound(x, w, keep, got)
    if k == 0:
        assert got.shape == (m, n) and not bool(got.abs().max())


_DR_EDGE_CELLS = [(n, w) for n in (1, 33, 512, 2048, 2049, 65536)
                  for w in (1, 16, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", _DR_EDGE_CELLS,
                         ids=[f"N{n}-W{w}" for n, w in _DR_EDGE_CELLS])
def test_digit_read_at_its_form_edges_on_card(cuda_device, n, w):
    # planes holding bytes 2 and 255 and an all-ties row, both directions:
    # mask and useful DRs equal to the plain version's
    rng = np.random.default_rng(n + w)
    planes = rng.integers(0, 2, (4, w, n)).astype(np.uint8)
    odd = rng.random(planes.shape)
    planes[odd < 0.03] = 2
    planes[odd > 0.97] = 255
    planes[1] = planes[1, :, :1]
    p = torch.from_numpy(planes).to(cuda_device)
    form = digit_read.form_for(w, n)
    for ascending in (True, False):
        launches = dict(digit_read.FORM_LAUNCHES)
        mask, drs = digit_read.min_search(p, ascending)
        assert digit_read.FORM_LAUNCHES[form] == launches[form] + 1
        rmask, rdrs = ref.min_search_ref(p, ascending)
        assert torch.equal(mask, rmask) and torch.equal(drs, rdrs)


@pytest.mark.cuda
def test_fused_tns_kernel_on_bytes_outside_0_1_on_card(cuda_device):
    # a plane or sign byte counts as a 1 wherever it is not 0
    rng = np.random.default_rng(11)
    planes = rng.integers(0, 2, (6, 16, 300)).astype(np.uint8)
    planes[rng.random(planes.shape) < 0.1] = 255
    planes[rng.random(planes.shape) < 0.1] = 2
    sign = rng.integers(0, 2, (6, 300)).astype(np.uint8)
    sign[rng.random(sign.shape) < 0.2] = 2
    p, s = bp.planes_from_numpy(planes, sign, device=cuda_device)
    for stop in (6, None):
        got = fused_tns.fused_tns_rank(p, s, k=2, fmt="float",
                                       stop_after=stop)
        want = fused_tns.fused_tns_rank_ref(
            p, s, k=2, fmt="float", stop_n=300 if stop is None else stop)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _on_host(out):
    return [t.cpu() for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(k=2), dict(k=0, stop_after=9),
                                dict(k=2, ideal_lifo=True),
                                dict(k=1, level_bits=4, ascending=False)],
                         ids=["packed", "packed-k0", "ideal", "ml"])
def test_machines_on_card_equal_their_host_runs(cuda_device, kw):
    x = np.random.default_rng(3).standard_normal((8, 200)).astype(
        np.float16)
    x[1] = x[1, 0]
    fmt = "unsigned" if kw.get("level_bits", 1) > 1 else "float"
    if fmt == "unsigned":
        x = bp.sort_key(x, 16, "float")
    call = dict(width=16, fmt=fmt, **kw)
    got = tns.tns_sort_batch(x, device=cuda_device, **call)
    assert got.perm.device.type == "cuda"
    want = tns.tns_sort_batch(x, device="cpu", **call)
    for g, w in zip(_on_host(got), want):
        assert torch.equal(g, w)
    for b in (0, 1):
        got1 = tns.tns_sort(x[b], device=cuda_device, **call)
        want1 = tns.tns_sort(x[b], device="cpu", **call)
        for g, w in zip(_on_host(got1), want1):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_catns_on_card_equals_its_host_runs(cuda_device):
    x = np.random.default_rng(4).integers(0, 256, 64).astype(np.uint8)
    for run in (lambda d: catns.multibank_sort(x, width=8, k=2, banks=4,
                                               device=d),
                lambda d: catns.bts_sort(x, width=8, device=d)):
        for g, w in zip(_on_host(run(cuda_device)), run("cpu")):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["resilient:tns", "resilient:fused-tns",
                                    "mb-ft"])
def test_faults_on_card_equal_their_host_runs(cuda_device, engine):
    x = np.random.default_rng(5).integers(0, 1 << 16, 64).astype(np.uint16)
    spec = faults.FaultSpec(ber=0.01, dead_banks=(1,), banks=4, seed=3)
    kw = dict(banks=4) if engine == "mb-ft" else {}
    res = []
    for dev in (None, "cpu"):
        with faults.inject(spec):
            res.append(tsort.sort(x, engine=engine, device=dev, **kw))
    got, want = res
    assert np.array_equal(got.indices, want.indices)
    for f in ("cycles", "quality", "faults_injected", "repairs", "retries",
              "degraded", "extra_cycles", "banks"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
def test_bf16_nan_bits_survive_gathers_on_card(cuda_device):
    bits = np.array([[0x7FC0, 0x3F80, 0xC000, 0xFFC0, 0x3F00]], np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    for fn in (lambda t: rs.sort_values(t)[0],
               lambda t: ops.topk(t, 4)[0],
               lambda t: tsort.topk(t, 4, engine="torch")[0]):
        got = fn(x.to(cuda_device)).cpu().view(torch.int16)
        assert torch.equal(got, fn(x).view(torch.int16))


def _fake_time():
    import itertools
    import types
    ticks = itertools.count()
    return types.SimpleNamespace(perf_counter=lambda: next(ticks) * 1e-4)


@pytest.mark.cuda
def test_serving_trace_on_card_equals_its_host_run(cuda_device,
                                                   monkeypatch):
    # the wall-time EWMA and the fused TNS prior are pinned, so that the
    # card run and the host run dispatch alike; the card run must launch
    # the top-k and key-pack kernels through fused-topk
    from repro_torch import serving
    from repro_torch.serving import dispatch, orchestrator
    monkeypatch.setattr(dispatch, "_fused_tns_wall_prior",
                        lambda device=None: 5.0)
    runs = []
    for dev in (cuda_device, "cpu"):
        monkeypatch.setattr(orchestrator, "time", _fake_time())
        trace = serving.make_trace(10, seed=0, n=48, mean_gap_us=0.05)
        orch = serving.Orchestrator(
            clock=serving.SimulatedClock(),
            cfg=serving.OrchestratorConfig(chunk=8), device=dev)
        launches = (radix_topk.LAUNCHES, bitplane_pack.LAUNCHES)
        rep = orch.run(trace)
        runs.append((rep, trace, (radix_topk.LAUNCHES - launches[0],
                                  bitplane_pack.LAUNCHES - launches[1])))
    (got, trace, card_launches), (want, host_trace, host_launches) = runs
    assert got["completed"] == 10 and got["failed"] == 0
    assert got["engines"].get("fused-topk", 0) > 0
    assert min(card_launches) > 0 and host_launches == (0, 0)
    got.pop("wall_ms"), want.pop("wall_ms")
    assert got == want
    for a, b in zip(trace, host_trace):
        assert (a.engine, a.status, a.cycles, a.finish_us) == \
            (b.engine, b.status, b.cycles, b.finish_us)
        assert np.array_equal(a.indices, b.indices)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.int8,
                                   np.float16])
def test_fused_topk_engine_keys_on_card(cuda_device, dtype):
    # float32 and integer payloads are packed on the card; float16 keys
    # come from the host
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((5, 300)) * 100).astype(dtype)
    x[1] = x[1, 0]
    packs = bitplane_pack.LAUNCHES
    for asc in (True, False):
        got = tsort.sort(x, engine="fused-topk", stop_after=17,
                         ascending=asc)
        want = tsort.sort(x, engine="fused-topk", stop_after=17,
                          ascending=asc, device="cpu")
        assert np.array_equal(got.indices, want.indices)
    assert (bitplane_pack.LAUNCHES > packs) == (dtype != np.float16)


@pytest.mark.cuda
def test_applications_on_card_equal_their_host_runs(cuda_device):
    from repro_torch import tree
    from repro_torch.graph import dijkstra
    from repro_torch.pruning import insitu
    for src, dst in [(0, 13), (15, 0)]:
        got = dijkstra.shortest_path(src, dst, engine="tns")
        want = dijkstra.shortest_path(src, dst, engine="tns", device="cpu")
        assert got.path == want.path == dijkstra.reference_shortest_path(
            src, dst)[1]
        assert (got.total_drs, got.total_cycles, got.fig5e_drs) == \
            (want.total_drs, want.total_cycles, want.fig5e_drs)
    w = np.random.default_rng(7).standard_normal(256)
    for ber in (0.0, 0.01):
        got = insitu.tns_prune(w, 0.3, ber=ber)
        want = insitu.tns_prune(w, 0.3, ber=ber, device="cpu")
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    wi = np.random.default_rng(8).standard_normal((2, 64, 96)).astype(
        np.float32)
    params = {"segments": [{"mlp": {"wi": wi, "wo": wi[:, :32]}}]}
    got_p, got = insitu.prune_params(
        tree.params_from_numpy(params, cuda_device), None, 0.3)
    want_p, want = insitu.prune_params(
        tree.params_from_numpy(params, "cpu"), None, 0.3)
    key = "['segments'][0]['mlp']['wi']"
    assert torch.equal(got["masks"][key].cpu(), want["masks"][key])
    assert got["weight_sparsity"] == want["weight_sparsity"]
    assert torch.equal(got_p["segments"][0]["mlp"]["wi"].cpu(),
                       want_p["segments"][0]["mlp"]["wi"])


@pytest.mark.cuda
def test_autotune_cell_on_card(cuda_device):
    from repro_torch.kernels import autotune
    launches = fused_tns.LAUNCHES
    table = autotune.sweep([dict(fmt="unsigned", width=16, n=256, m=8,
                                 b=4)], reps=2)
    assert fused_tns.LAUNCHES - launches == 3
    (key, row), = table.items()
    name = torch.cuda.get_device_name(0)
    assert key.startswith("unsigned|N256|m8|B4|" + name + "/sm_")
    assert row["us"] > 0
    assert autotune.nearest_cell("unsigned", 256, 8, 4, table=table) == key


@pytest.mark.cuda
def test_deepseek_v2_serves_through_the_router_kernels_on_card(cuda_device):
    # deepseek-v2 reduced (1 dense MLA layer, then 3 MoE MLA layers):
    # every MoE layer of every forward (the prefill and max_new - 1 decode
    # steps) routes through the key-pack and top-k kernels once
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = dataclasses.replace(
        configs.get_config("deepseek_v2_236b").reduced(n_layers=4),
        router_impl="pallas")
    moe_layers = cfg.n_layers - cfg.moe_layer_start
    before = (radix_topk.LAUNCHES, bitplane_pack.LAUNCHES)
    res = serve.serve(cfg, 2, 4, 5, top_k=8)
    forwards = 1 + (5 - 1)
    assert (radix_topk.LAUNCHES - before[0],
            bitplane_pack.LAUNCHES - before[1]) == \
        (moe_layers * forwards,) * 2
    assert res["tokens"].shape == (2, 9)
    assert ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all()


def _rel_err(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["attention", "mla-absorbed", "head"])
def test_matmul_f32_backward_on_card(cuda_device, site):
    # the float32-output product of bfloat16 operands (attention scores,
    # MLA's absorbed latent scores, the LM head) differentiated on the
    # card: every gradient in its operand's type, within 2e-2 (relative
    # norm) of the host's, which widens both operands; the forward
    # unchanged by the backward's wrapper (bit for bit the plain product)
    import dataclasses
    from repro_torch import configs, tree
    from repro_torch.models import layers as L
    arch = "deepseek_v2_236b" if site == "mla-absorbed" else "qwen2_moe_a2_7b"
    cfg = dataclasses.replace(configs.get_config(arch).reduced(n_layers=2),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(5)
    B, T = 2, 6
    x = torch.randn(B, T, cfg.d_model, generator=gen).to(torch.bfloat16)
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    if site == "head":
        params = L.init_embed(cfg, gen, torch.device("cpu"))
    elif site == "attention":
        params = L.init_attn(cfg, gen, torch.device("cpu"))
    else:
        params = L.init_mla(cfg, gen, torch.device("cpu"))

    def run(dev):
        p = tree.map_with_path(
            lambda _, t: t.to(dev).detach().requires_grad_(True), params)
        xi = x.to(dev).requires_grad_(True)
        if site == "head":
            out = L.lm_logits(p, xi)
        elif site == "attention":
            out, _ = L.apply_attn(p, xi, cfg, pos.to(dev))
        else:
            cache = L.init_mla_cache(cfg, B, T + 2, dev)
            out, _ = L.apply_mla(p, xi, cfg, pos.to(dev), cache)
        flat = [xi] + [t for _, t in tree.flatten_with_path(p)]
        gs = torch.autograd.grad(out.float().square().mean(), flat,
                                 allow_unused=True)
        return out.detach(), [(t, g) for t, g in zip(flat, gs)]

    out_d, gd = run(cuda_device)
    out_h, gh = run("cpu")
    assert _rel_err(out_d.cpu(), out_h) < 2e-2
    used = 0
    for (t, a), (_, b) in zip(gd, gh):
        assert (a is None) == (b is None)
        if a is None:
            continue
        used += 1
        assert a.dtype == t.dtype == b.dtype
        assert bool(torch.isfinite(a).all())
        assert _rel_err(a.cpu(), b) < 2e-2
    assert used >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_moe_train_step_on_card_matches_host(cuda_device, remat):
    # qwen2-moe reduced (4 MoE layers), float32, the fused router: 3 train
    # steps on the card == the host's within rtol 1e-5 (losses) and 1e-4
    # (gradient norms); the router kernels launch once a MoE layer a
    # forward, twice under remat "full" (the recompute)
    import dataclasses
    from repro_torch import configs, tree
    from repro_torch.data import pipeline as P
    from repro_torch.launch import steps
    from repro_torch.models import stacked as S
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw as A
    cfg = dataclasses.replace(
        configs.get_config("qwen2_moe_a2_7b").reduced(n_layers=4),
        router_impl="pallas")
    ocfg = A.AdamWConfig()
    shape = ShapeConfig("t", 16, 4, "train")
    p0 = S.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = tree.map_with_path(lambda _, t: t.to(dev, copy=True), p0)
        s = A.init(p, ocfg)
        step = steps.make_train_step(cfg, ocfg, remat=remat)
        out = []
        for i in range(3):
            x, y = P.host_batch(cfg, shape, i, device=dev)
            before = (radix_topk.LAUNCHES, bitplane_pack.LAUNCHES)
            p, s, m = step(p, s, x, y)
            launched = (radix_topk.LAUNCHES - before[0],
                        bitplane_pack.LAUNCHES - before[1])
            out.append((float(m["loss"]), float(m["grad_norm"]), launched))
        runs[dev.type] = out
    per_step = cfg.n_layers * (2 if remat == "full" else 1)
    for (ld, gd, nd), (lh, gh, nh) in zip(runs["cuda"], runs["cpu"]):
        assert nd == (per_step, per_step) and nh == (0, 0)
        assert abs(ld - lh) <= 1e-5 * abs(lh)
        assert abs(gd - gh) <= 1e-4 * abs(gh)


def _decode_inputs(dev, B, S, KV, group, hd, dtype, seed=0, pos=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((B, 1, KV * group, hd), (B, S, KV, hd),
                             (B, S, KV, hd)))
    if pos is None:      # each row its own position, the first 0, the last
        pos = torch.randint(0, S, (B,), generator=g, device=dev)   # S - 1
        pos[0], pos[-1] = 0, S - 1
    return q, k, v, pos


def _decode_bound(want, dtype):
    """The kernel's allowance against the plain version, by (row, head):
    both sum in float32 in another order (exp, sum and product orders; a
    probability that rounds the other way to the cache's type shifts the
    sum by ~2^-8 of one ~1/S weight), far below an output ulp; the one
    rounding to the output type can then put the two one ulp apart.  An
    entry far below its row's largest carries the sum's cancellation, so
    the ulp is taken at the (row, head)'s largest |output|.  float32
    keeps the orders' difference unrounded: 1e-5 of that largest."""
    top = want.float().abs().amax(-1, keepdim=True)
    if dtype == torch.float32:
        return 1e-5 * top
    bits = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    return torch.exp2(torch.floor(torch.log2(top.clamp(min=1e-30))) - bits)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,KV,group,hd,dtype,form", [
    (64, 2560, 16, 1, 128, torch.bfloat16, "whole"),  # qwen2-moe decode cell
    (64, 700, 16, 1, 64, torch.bfloat16, "whole"),
    (64, 700, 16, 1, 80, torch.bfloat16, "whole"),
    (32, 700, 16, 1, 256, torch.bfloat16, "split"),
    (64, 700, 8, 5, 128, torch.bfloat16, "whole"),    # qwen3-14b's group
    (64, 700, 8, 8, 128, torch.bfloat16, "whole"),    # llama-3.2-vision's
    (16, 900, 8, 8, 128, torch.float16, "whole"),
    (8, 600, 4, 4, 16, torch.float32, "split"),
    (2, 5000, 1, 8, 128, torch.bfloat16, "split"),
    (3, 4100, 2, 1, 128, torch.bfloat16, "split"),
])
def test_decode_attn_kernel_equals_plain_version_on_card(
        cuda_device, B, S, KV, group, hd, dtype, form):
    q, k, v, pos = _decode_inputs(cuda_device, B, S, KV, group, hd, dtype)
    split = decode_attn.split_for(B * KV, group, S)[0] > 1
    assert split == (form == "split")
    before = dict(decode_attn.FORM_LAUNCHES)
    got = decode_attn.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert decode_attn.FORM_LAUNCHES[form] == before[form] + 1
    want = decode_attn.decode_attention_ref(q, k, v, pos)
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    over = ((got.float() - want.float()).abs()
            - _decode_bound(want, dtype)).max().item()
    assert over <= 0, over


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,KV,group", [(64, 2560, 16, 1), (2, 3000, 2, 8)])
def test_decode_attn_never_reads_past_a_rows_position_on_card(
        cuda_device, B, S, KV, group):
    # rewound rows: NaN past each row's position gives the output of zeros
    # there, bit for bit (a row at -1 sees nothing and reads all S, so
    # every row here has a position)
    q, k, v, pos = _decode_inputs(cuda_device, B, S, KV, group, 128,
                                  torch.bfloat16, seed=1)
    past = (torch.arange(S, device=cuda_device)[None, :] > pos[:, None])
    past = past[:, :, None, None]
    nan = [t.masked_fill(past, float("nan")) for t in (k, v)]
    zero = [t.masked_fill(past, 0) for t in (k, v)]
    got = decode_attn.decode_attention(q, *nan, pos)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, decode_attn.decode_attention(q, *zero, pos))


@pytest.mark.cuda
def test_decode_attn_at_the_edges_of_a_row_on_card(cuda_device):
    # int64 positions past the cache's end (all of it), at -1 (nothing
    # filled: every position alike) and strided caches (a layer of a
    # stacked cache, a head-sliced view)
    q, k, v, _ = _decode_inputs(cuda_device, 4, 33, 2, 5, 80,
                                torch.bfloat16, seed=2)
    pos = torch.tensor([-1, 0, 32, 40], device=cuda_device)
    got = decode_attn.decode_attention(q, k, v, pos)
    want = decode_attn.decode_attention_ref(q, k, v, pos)
    assert bool(((got.float() - want.float()).abs()
                 <= _decode_bound(want, torch.bfloat16)).all())
    stack = torch.randn((3, 4, 33, 4, 80), device=cuda_device).to(
        torch.bfloat16)
    ks, vs = stack[1, :, :, 1:3], stack[2, :, :, :2]
    got = decode_attn.decode_attention(q, ks, vs, pos)
    want = decode_attn.decode_attention_ref(q, ks.contiguous(),
                                            vs.contiguous(), pos)
    assert bool(((got.float() - want.float()).abs()
                 <= _decode_bound(want, torch.bfloat16)).all())


@pytest.mark.cuda
def test_decode_attn_replays_in_a_cuda_graph_on_card(cuda_device):
    q, k, v, pos = _decode_inputs(cuda_device, 8, 600, 4, 2, 128,
                                  torch.bfloat16, seed=3)
    eager = decode_attn.decode_attention(q, k, v, pos)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        decode_attn.decode_attention(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attn.decode_attention(q, k, v, pos)
    pos += 7
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, decode_attn.decode_attention(q, k, v, pos))
    assert not torch.equal(out, eager)


@pytest.mark.cuda
def test_decode_attn_counters_through_apply_attn_on_card(cuda_device):
    # a cached one-token call counts B rows and B x S cache slots and
    # launches the kernel once; a prefill through the cache neither
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.runtime import spans
    cfg = dataclasses.replace(configs.get_config("qwen3_14b").reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    p = L.init_attn(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                    cuda_device)
    B, S = 3, 40
    cache = L.init_attn_cache(cfg, B, S, cuda_device)
    x = torch.randn((B, 5, cfg.d_model), device=cuda_device).to(
        torch.bfloat16)
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            launches = decode_attn.LAUNCHES
            L.apply_attn(p, x, cfg, torch.arange(5, device=cuda_device)
                         .expand(B, 5), cache)
            assert decode_attn.LAUNCHES == launches
            assert spans.report()["counters"] == {}
            for i in range(2):
                L.apply_attn(p, x[:, :1], cfg, torch.full(
                    (B, 1), 5 + i, device=cuda_device), cache)
            assert decode_attn.LAUNCHES == launches + 2
        assert spans.report()["counters"] == {
            "attn.decode_rows": 2 * B, "attn.cache_slots": 2 * B * S}
    finally:
        spans.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("hd,group,dtype,err", [
    (20, 1, torch.bfloat16, ValueError), (264, 1, torch.bfloat16, ValueError),
    (128, 16, torch.bfloat16, ValueError), (64, 1, torch.float64, TypeError)])
def test_decode_attn_refuses_on_card(cuda_device, hd, group, dtype, err):
    q, k, v, pos = _decode_inputs(cuda_device, 2, 16, 1, group, hd, dtype)
    with pytest.raises(err):
        decode_attn.decode_attention(q, k, v, pos)


@pytest.mark.cuda
def test_trace_gate_on_card(cuda_device):
    # every case on CUDA tensors: its shapes and dtypes those of the CPU
    # run, every kernel target launching its kernel
    from repro_torch.analysis import trace_gate
    before = {t: m.LAUNCHES for t, m in trace_gate.KERNEL_MODULES.items()}
    results = trace_gate.run_gate(device=cuda_device)
    bad = [r for r in results if not r.ok]
    assert bad == [], "\n".join(r.format() for r in bad)
    assert {r.how for r in results if not r.target.startswith("engine:")} \
        == {"card"}
    for target, mod in trace_gate.KERNEL_MODULES.items():
        assert mod.LAUNCHES > before[target], target


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bitplane_pack", "decode_attn",
                                  "digit_read", "fused_tns",
                                  "masked_matmul", "radix_topk"])
def test_cuda_lint_static_smem_equals_ptxas_on_card(cuda_device, name):
    from repro_torch.analysis import cuda_lint
    from repro_torch.kernels import _build
    rows = cuda_lint.compare_ptxas(_build.CSRC / f"{name}.cu",
                                   _build.ptxas_report(name))
    assert rows and any(r.lint is not None for r in rows)
    for r in rows:
        assert r.lint is None or r.lint == r.ptxas, r


@pytest.mark.cuda
def test_cuda_lint_limits_are_the_cards(cuda_device):
    from repro_torch.analysis import cuda_lint
    props = torch.cuda.get_device_properties(cuda_device)
    assert props.shared_memory_per_block_optin == cuda_lint.OPTIN_SMEM_LIMIT
    assert props.shared_memory_per_block == cuda_lint.STATIC_SMEM_LIMIT
