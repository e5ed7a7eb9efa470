"""The port's spans and counters (``repro_torch.runtime.spans``): off
without a profile (one shared null context, nothing recorded); under
``torch.profiler`` on the CPU, the sort's and a MoE decode step's spans as
host ops nested as the code nests them, never user annotations; the
counters from shapes; results bit-identical with the profile on and off.
The file imports no JAX.  Its test on the card takes the spans' device time
and finds nothing of them on the device's timeline:

    python -m pytest -q -m cuda tests/test_torch_spans.py

Without a card that test skips."""
import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, sort
from repro_torch.core import bitplane as bp
from repro_torch.launch import steps
from repro_torch.models import moe, sampling, stacked
from repro_torch.runtime import spans

SORT_SPANS = ("sort", "sort.encode", "sort.h2d", "sort.d2h", "sort.finish")
B = 3                      # decode rows


@pytest.fixture(autouse=True)
def empty_registry():
    spans.reset()
    yield
    spans.reset()


def _keys(seed, shape=(3, 40)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def _ours(prof):
    return [e for e in prof.events() if e.name.startswith(spans.PREFIX)]


def _parent(e):
    return e.cpu_parent.name if e.cpu_parent is not None else None


def test_off_without_a_profile():
    null = spans.span("a")
    assert spans.span("b", torch.zeros(1)) is null
    with null:
        spans.count("c", 3)
    sort.sort(_keys(0), engine="fused-tns", k=2, device="cpu")
    assert spans.report() == {"spans": {}, "counters": {}}


def test_sort_spans_nest_under_the_facade():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sort.sort(_keys(1), engine="fused-tns", k=2, device="cpu")
    ev = _ours(prof)
    assert sorted(e.name for e in ev) == sorted(
        spans.PREFIX + n for n in SORT_SPANS)
    for e in ev:
        assert not e.is_user_annotation
        assert e.device_type == DeviceType.CPU
        assert _parent(e) == (None if e.name == "repro_torch.sort"
                              else "repro_torch.sort")
    rep = spans.report()
    assert rep["counters"] == {}
    got = rep["spans"]
    assert {n: s["calls"] for n, s in got.items()} == dict.fromkeys(
        SORT_SPANS, 1)
    assert {n: s["parent"] for n, s in got.items()} == dict(
        dict.fromkeys(SORT_SPANS, "sort"), sort=None)
    assert all(s["device_ms"] is None for s in got.values())
    inner = sum(got[n]["host_ms"] for n in SORT_SPANS[1:])
    assert got["sort"]["host_self_ms"] == pytest.approx(
        got["sort"]["host_ms"] - inner, abs=1e-9)
    assert 0 < inner < got["sort"]["host_ms"]


def test_sort_spans_on_the_host_encode_path():
    # under a read hook the planes go to the host and back between the
    # encode and the kernel: the same spans, once each under the facade,
    # and no counter
    prev = bp.set_read_hook(lambda planes, **_: planes)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            sort.sort(_keys(1), engine="fused-tns", k=2, device="cpu")
    finally:
        bp.set_read_hook(prev)
    rep = spans.report()
    assert rep["counters"] == {}
    assert {n: (s["calls"], s["parent"]) for n, s in rep["spans"].items()
            } == dict(dict.fromkeys(SORT_SPANS[1:], (1, "sort")),
                      sort=(1, None))


def test_self_time_parent_and_counts_of_nested_spans():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with spans.span("outer"):
                spans.count("n", 5)
                for _ in range(3):
                    with spans.span("outer.inner"):
                        pass
    spans.count("n", 100)                       # the profile has ended
    got = spans.report()
    assert got["counters"] == {"n": 10}
    s, i = got["spans"]["outer"], got["spans"]["outer.inner"]
    assert (s["calls"], s["parent"], i["calls"], i["parent"]) == (
        2, None, 6, "outer")
    assert s["host_self_ms"] == pytest.approx(
        s["host_ms"] - i["host_ms"], abs=1e-9)
    assert i["host_self_ms"] == i["host_ms"]
    spans.reset()
    assert spans.report() == {"spans": {}, "counters": {}}


def test_sort_is_bit_identical_with_the_profile_on_and_off():
    x = _keys(2, (4, 96))
    off = sort.sort(x, engine="fused-tns", k=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        on = sort.sort(x, engine="fused-tns", k=2, device="cpu")
    for f in ("indices", "values", "cycles", "drs", "reload_cycles"):
        np.testing.assert_array_equal(getattr(on, f), getattr(off, f))


def _tiny_moe(factor):
    cfg = dataclasses.replace(
        configs.get_config("qwen2_moe_a2_7b").reduced(n_layers=2),
        moe_capacity_factor=factor)
    dev = torch.device("cpu")
    params = stacked.init_params(cfg, torch.Generator().manual_seed(0), dev)
    return cfg, params


def _decode(cfg, params, seed):
    """One decode step of B rows at position 2 over a fresh cache, then the
    sampler on its logits: (logits, tokens)."""
    cache = stacked.init_cache(cfg, B, 8, torch.device("cpu"))
    tok = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, 1)), dtype=torch.int32)
    pos = torch.full((B,), 2, dtype=torch.int32)
    logits, _ = steps.make_decode_step(cfg)(params, tok, pos, cache)
    drawn = sampling.sample_logits(logits[:, -1], torch.Generator()
                                   .manual_seed(seed), top_k=5)
    return logits, drawn


@pytest.mark.parametrize("factor", [None, 1.25])
def test_moe_decode_step_spans_and_counters(factor):
    cfg, params = _tiny_moe(factor)
    L, E, k = cfg.n_layers, cfg.n_routed_experts, cfg.moe_top_k
    assert cfg.moe_layer_start == 0            # every layer is a MoE layer
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode(cfg, params, 3)
    ev = _ours(prof)
    assert collections.Counter(e.name for e in ev) == {
        "repro_torch.attn": L, "repro_torch.moe": L,
        "repro_torch.moe.route": L, "repro_torch.moe.dispatch": L,
        "repro_torch.moe.experts": L, "repro_torch.sample": 1}
    assert not any(e.is_user_annotation for e in ev)
    for e in ev:
        if e.name.startswith("repro_torch.moe."):
            assert _parent(e) == "repro_torch.moe"
    # a decode step routes B tokens k ways into (E, B, C) slots a layer,
    # and attends B rows over the 8 slots of the cache a layer
    C = moe._capacity(1, k, E, factor)
    assert C == 8
    assert spans.report()["counters"] == {
        "moe.slots": L * E * B * C, "moe.assignments": L * B * k,
        "moe.assignments_held": L * B * k, "attn.decode_rows": L * B,
        "attn.cache_slots": L * B * 8}


def test_mla_spans_and_cache_counter():
    """deepseek-v2's layers: ``mla`` a layer with ``mla.attend`` inside it,
    on the prefill without a cache and on the decode step through one;
    ``mla.cache_slots`` counts the B x S cache positions a cached call
    reads, and the uncached forward none."""
    cfg = configs.get_config("deepseek_v2_236b").reduced(n_layers=2)
    params = stacked.init_params(cfg, torch.Generator().manual_seed(0),
                                 torch.device("cpu"))
    L, S = cfg.n_layers, 8
    tok = torch.ones((B, 4), dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stacked.forward(params, cfg, tok)
    ev = _ours(prof)
    names = collections.Counter(e.name for e in ev)
    assert names["repro_torch.mla"] == names["repro_torch.mla.attend"] == L
    assert all(_parent(e) == "repro_torch.mla" for e in ev
               if e.name == "repro_torch.mla.attend")
    assert "mla.cache_slots" not in spans.report()["counters"]
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _decode(cfg, params, 3)
    got = spans.report()
    assert got["spans"]["mla"]["calls"] == L
    assert got["spans"]["mla.attend"]["parent"] == "mla"
    assert got["counters"]["mla.cache_slots"] == L * B * S
    assert got["spans"]["moe.route"]["calls"] == L - cfg.moe_layer_start


def test_sort_dispatch_counts_its_slots():
    cfg, params = _tiny_moe(1.25)
    blk = params["segments"][0]
    layer = {"router": blk["moe"]["router"][0], "wi": blk["moe"]["wi"][0],
             "wo": blk["moe"]["wo"][0],
             "shared": {p: w[0] for p, w in blk["moe"]["shared"].items()}}
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4))
    with profile(activities=[ProfilerActivity.CPU]):
        moe.apply_moe(layer, x, cfg, dispatch="sort")
    n, k, E = 2 * 5, cfg.moe_top_k, cfg.n_routed_experts
    assert spans.report()["counters"] == {
        "moe.slots": E * moe._capacity(n, k, E, 1.25),
        "moe.assignments": n * k, "moe.assignments_held": n * k}


def test_decode_is_bit_identical_with_the_profile_on_and_off():
    cfg, params = _tiny_moe(1.25)
    off = _decode(cfg, params, 5)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _decode(cfg, params, 5)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])


@pytest.mark.cuda
def test_spans_take_device_time_and_put_nothing_on_the_device(monkeypatch):
    """On the card: each span of a sort call and of a MoE decode step takes
    its device time, no device event is named ``repro_torch.*``, and the
    device runs the same kernels with the spans as without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' events are CUDA events")
    dev = torch.device("cuda")
    cfg = configs.get_config("qwen2_moe_a2_7b").reduced(n_layers=2)
    params = stacked.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), dev)
    x = _keys(6, (64, 1024))
    tok = torch.ones((B, 1), dtype=torch.int32, device=dev)
    pos = torch.full((B,), 2, dtype=torch.int32, device=dev)

    def work():
        sort.sort(x, engine="fused-tns", k=2)
        cache = stacked.init_cache(cfg, B, 8, dev)
        logits, _ = steps.make_decode_step(cfg)(params, tok, pos, cache)
        sampling.sample_logits(logits[:, -1], torch.Generator(device=dev)
                               .manual_seed(1), top_k=5)
        torch.cuda.synchronize()

    def kernels(prof):
        return [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]

    work()                                       # builds and warms
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        work()
    on = kernels(prof)
    assert on and not [n for n in on if n.startswith(spans.PREFIX)]
    got = spans.report()["spans"]
    for name in ("sort", "sort.h2d", "sort.d2h", "attn", "moe",
                 "moe.route", "moe.dispatch", "moe.experts", "sample"):
        assert got[name]["device_ms"] > 0, name
    for name in ("sort.encode", "sort.finish"):
        assert got[name]["device_ms"] is None, name
    monkeypatch.setattr(spans, "span", lambda name, where=None: spans._NULL)
    with profile(activities=acts) as prof:
        work()
    assert sorted(kernels(prof)) == sorted(on)
