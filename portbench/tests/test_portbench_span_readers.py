"""The readers of the program's spans and counters (``metrics/<name>.py``
over ``repro_torch.runtime.spans``) on hand-built traces and a filled
registry, with known answers; each gives None where its spans are absent,
where the registry holds no device time (the CPU), and where the program
has no registry at all; and the wiring on the CPU: a traced run of the
tiny sort and decode cells reports what the CPU can read."""
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import run, trace
from portbench.tests import test_portbench_harness as harness
from repro_torch import runtime
from repro_torch.runtime import spans

P = spans.PREFIX
# (reader, span, divisor counter) of the readers of device time
DEVICE = [("attn_ms_per_step.decode", "attn", "steps"),
          ("moe_ms_per_step.decode", "moe", "steps"),
          ("experts_ms_per_step.decode", "moe.experts", "steps"),
          ("sampler_ms_per_step.decode", "sample", "steps"),
          ("attn_ms_per_round.prefill", "attn", "steps"),
          ("dispatch_ms_per_round.prefill", "moe.dispatch", "steps")]
# (reader, its spans) of the readers of host time in the sort
HOST = [("encode_ms_per_call.sort", ("sort.encode",)),
        ("copy_ms_per_call.sort", ("sort.h2d", "sort.d2h")),
        ("finish_ms_per_call.sort", ("sort.finish",))]


@pytest.fixture(autouse=True)
def empty_registry():
    spans.reset()
    yield
    spans.reset()


def _trace(host, counters):
    """A slice of 1000 us with one kernel, the given host ops (a, b, name)
    and one op outside the window."""
    return trace.Trace([(10.0, 20.0, "kernel")],
                       [(trace.WINDOW, 0.0, 1000.0)],
                       host + [(1500.0, 1600.0, P + "attn"),
                               (1500.0, 1600.0, P + "sort.encode")],
                       counters)


def _fill(calls: dict, device_ms: dict, counters=None):
    """Spans recorded under a CPU profile, then their device time as the
    card's events would have given it."""
    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in calls.items():
            for _ in range(n):
                with spans.span(name):
                    pass
        for name, n in (counters or {}).items():
            spans.count(name, n)
    for name, ms in device_ms.items():
        spans._device_ms[name] = spans._device_ms.get(name, 0.0) + ms


def _without_spans(monkeypatch):
    """The program as it was before it had spans: no such module."""
    monkeypatch.delattr(runtime, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)


@pytest.mark.parametrize("metric,spans_", HOST)
def test_host_readers(metric, spans_):
    read = trace.load_reader(metric)
    host = [(100.0 * i, 100.0 * i + 30.0 + i, P + s)
            for i, s in enumerate(spans_ * 2, start=1)]
    want = sum(b - a for a, b, _ in host) / 1e3 / 4
    assert read(_trace(host + [(0.0, 900.0, P + "sort")],
                       {"calls": 4})) == pytest.approx(want)
    assert read(_trace([(0.0, 900.0, P + "sort")], {"calls": 4})) is None
    assert read(_trace(host, {})) is None


@pytest.mark.parametrize("metric,span,unit", DEVICE)
def test_device_readers(metric, span, unit, monkeypatch):
    read = trace.load_reader(metric)
    host = [(10.0 * i, 10.0 * i + 5.0, P + span) for i in range(48)]
    t = _trace(host, {unit: 2})
    assert read(t) is None                      # nothing recorded
    _fill({span: 48}, {})
    assert read(t) is None                      # no device time: the CPU
    _fill({}, {span: 96.0})
    assert read(t) == pytest.approx(96.0 / 2)   # 48 calls, 2 ms each
    assert read(_trace([], {unit: 2})) is None
    assert read(_trace(host, {})) is None
    # a second run in the process: the registry's mean a call, times this
    # slice's calls
    _fill({span: 48}, {span: 288.0})
    assert read(t) == pytest.approx(4.0 * 48 / 2)
    _without_spans(monkeypatch)
    assert read(t) is None                      # a program without spans


def test_expert_slot_fill(monkeypatch):
    read = trace.load_reader("expert_slot_fill.decode")
    t = _trace([(5.0, 9.0, P + "moe")], {"steps": 16})
    assert read(t) is None
    _fill({"moe": 24}, {},
          {"moe.slots": 24 * 60 * 64 * 8, "moe.assignments": 24 * 64 * 4})
    assert read(t) == pytest.approx(100 * 256 / 30720)
    assert read(_trace([], {"steps": 16})) is None
    _fill({"moe": 24}, {},
          {"moe.slots": 24 * 60 * 64 * 8, "moe.assignments": 24 * 64 * 4})
    assert read(t) == pytest.approx(100 * 256 / 30720)
    _without_spans(monkeypatch)
    assert read(t) is None


def test_traced_tiny_cells_report_what_the_cpu_reads(harness_guard):
    bench = run.load_bench()
    _, cfg, mix = run.cell_inputs(bench, "sort-random-b4096")
    out = run.run("sort-random-b4096", 7, 1.0, True, "cpu", bench=bench,
                  cfg=harness._tiny_sort(cfg),
                  mix=harness._tiny_sort_mix(mix))["metrics"]
    for metric, _ in HOST:
        assert out[metric]["value"] > 0 and out[metric]["unit"] == "ms"
    bench, cfg, mix = harness._lm("qwen2moe-decode-b64")
    out = run.run("qwen2moe-decode-b64", 7, 1.0, True, "cpu", bench=bench,
                  cfg=cfg, mix=mix)["metrics"]
    # 4 rows route 2 ways into 8 experts of 8 slots a row
    assert out["expert_slot_fill.decode"] == {"value": 100 * 8 / 256,
                                              "unit": "%"}
    assert not {m for m, _, _ in DEVICE} & set(out)


@pytest.fixture
def harness_guard(monkeypatch):
    """The harness's guard off (this process loads the JAX package for
    other test files) and one thread, as in the harness's own tests."""
    monkeypatch.setattr(run, "forbidden_loaded", lambda modules=None: [])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
