"""The port's serving stack (``repro_torch.serving``, ``repro_torch.launch
.serve``) against the reference package's ``repro.serving`` on the CPU.

Everything is compared exactly, under the engine name map (``pallas-tns``
-> ``fused-tns``, ``pallas-topk`` -> ``fused-topk``, ``resilient:`` kept):
candidate lists in order, picks, estimates, the run summaries without
``wall_ms``, and every request's engine, status, indices, cycles and
finish time.  Two inputs of the dispatcher are pinned to one value in both
packages, since they are not part of what is compared:

* the ``wall`` objective's EWMA is fed ``time.perf_counter`` around each
  engine call, so each orchestrator module's ``time`` is replaced by one
  fake counter that advances 100 us a read;
* the fused TNS engine's wall prior comes from a measured table (the
  reference's ``BENCH_pallas_tns.json`` in interpret mode, the port's
  ``BENCH_torch_fused_tns.json`` per device), so both prior functions
  return ``WALL_PRIOR_US``.

The reference runs are shared through one module-scoped fixture.
"""
import itertools
import json
import time
import types
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from repro import serving as ref_serving
from repro.runtime import faults as ref_faults
from repro.serving import dispatch as ref_dispatch
from repro.serving import orchestrator as ref_orchestrator
from repro.sort.registry import available_engines as ref_engines
from repro_torch import serving
from repro_torch.core import bitplane as bp
from repro_torch.kernels import backend
from repro_torch.launch import serve as serve_cli
from repro_torch.runtime import faults
from repro_torch.serving import dispatch, orchestrator
from repro_torch.serving.metrics import percentile
from repro_torch.serving.request import ENERGY, WALL, Status, priority_key
from repro_torch.sort.registry import available_engines

CPU = "cpu"
WALL_PRIOR_US = 31.07
_NAME_MAP = {"pallas-tns": "fused-tns", "pallas-topk": "fused-topk"}


def port_name(ref_name):
    prefix = "resilient:" if ref_name.startswith("resilient:") else ""
    inner = ref_name[len(prefix):]
    return prefix + _NAME_MAP.get(inner, inner)


def _fake_time():
    ticks = itertools.count()
    return types.SimpleNamespace(perf_counter=lambda: next(ticks) * 1e-4)


@pytest.fixture
def pinned(monkeypatch):
    """Both packages' wall priors and orchestrator clocks pinned."""
    monkeypatch.setattr(ref_dispatch, "_pallas_tns_wall_prior",
                        lambda: WALL_PRIOR_US)
    monkeypatch.setattr(dispatch, "_fused_tns_wall_prior",
                        lambda device=None: WALL_PRIOR_US)
    monkeypatch.setattr(ref_orchestrator, "time", _fake_time())
    monkeypatch.setattr(orchestrator, "time", _fake_time())


def _req(pkg, rid=0, n=32, m=None, priority=0, arrival_us=0.0, seed=0,
         dtype=np.uint16, ascending=True, **budget_kw):
    rng = np.random.default_rng((seed, rid))
    if np.issubdtype(dtype, np.floating):
        x = rng.standard_normal(n).astype(dtype)
    else:
        x = rng.integers(0, 1 << 16, n).astype(dtype)
    return pkg.SortRequest(
        rid=rid, x=x, m=m, priority=priority, arrival_us=arrival_us,
        ascending=ascending, budget=pkg.SortBudget(**budget_kw))


# ---------------------------------------------------------------------------
# The three serving runs: continuous, one-shot, faulted.
# ---------------------------------------------------------------------------


def _trace(pkg, arm):
    if arm == "faulted":
        return pkg.make_trace(6, seed=1, n=32, mean_gap_us=0.05,
                              classes=("bulk-latency", "float-latency"),
                              quality_floor=0.99)
    return pkg.make_trace(6, seed=0, n=32, mean_gap_us=0.05)


def _serve(pkg, faults_mod, arm, **kw):
    trace = _trace(pkg, arm)
    if arm == "oneshot":
        return pkg.oneshot_loop(trace, **kw), trace
    orch = pkg.Orchestrator(clock=pkg.SimulatedClock(),
                            cfg=pkg.OrchestratorConfig(chunk=16), **kw)
    if arm == "faulted":
        with faults_mod.inject(faults_mod.FaultSpec(ber=0.01, seed=0)):
            return orch.run(trace), trace
    return orch.run(trace), trace


ARMS = ("continuous", "oneshot", "faulted")


@pytest.fixture(scope="module")
def reference_runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_dispatch, "_pallas_tns_wall_prior",
                   lambda: WALL_PRIOR_US)
        runs = {}
        for arm in ARMS:
            mp.setattr(ref_orchestrator, "time", _fake_time())
            runs[arm] = _serve(ref_serving, ref_faults, arm)
    return runs


@pytest.fixture(scope="module")
def port_runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "_fused_tns_wall_prior",
                   lambda device=None: WALL_PRIOR_US)
        runs = {}
        for arm in ARMS:
            mp.setattr(orchestrator, "time", _fake_time())
            runs[arm] = _serve(serving, faults, arm, device=CPU)
    return runs


def _comparable(report):
    rep = dict(report)
    rep.pop("wall_ms")
    return rep


@pytest.mark.parametrize("arm", ARMS)
def test_summary_matches_reference(reference_runs, port_runs, arm):
    want = _comparable(reference_runs[arm][0])
    want["engines"] = {port_name(k): v for k, v in want["engines"].items()}
    got = _comparable(port_runs[arm][0])
    assert got == want
    assert got["completed"] == got["accepted"] == 6 and got["failed"] == 0


@pytest.mark.parametrize("field", ["engine", "status", "indices", "cycles",
                                   "finish_us", "progress"])
@pytest.mark.parametrize("arm", ARMS)
def test_every_request_matches_reference(reference_runs, port_runs, arm,
                                         field):
    ref_trace, trace = reference_runs[arm][1], port_runs[arm][1]
    assert [r.rid for r in trace] == [r.rid for r in ref_trace]
    for ref_req, req in zip(ref_trace, trace):
        want, got = getattr(ref_req, field), getattr(req, field)
        if field == "engine":
            want = port_name(want)
        elif field == "status":
            want, got = want.value, got.value
        if field == "indices":
            np.testing.assert_array_equal(got, np.asarray(want))
        else:
            assert got == want, (arm, req.rid)


def test_runs_dispatch_the_renamed_engines(port_runs):
    # the equal summaries are not empty of renames: the clean trace sends
    # work to both fused engines, the faulted one only to verified ones
    engines = port_runs["continuous"][0]["engines"]
    assert engines.get("fused-topk", 0) > 0 and engines.get("fused-tns", 0)
    assert all(e.startswith("resilient:") or e == "mb-ft"
               for e in port_runs["faulted"][0]["engines"])


def test_indices_are_the_stable_argsort_prefix(port_runs):
    for arm in ARMS:
        for req in port_runs[arm][1]:
            fmt, width = req.fmt_width
            keys = bp.sort_key(req.x, width, fmt)
            order = np.argsort(keys if req.ascending else -keys.astype(
                np.int64), kind="stable")
            np.testing.assert_array_equal(req.indices, order[:req.target])


def test_same_trace_payload_bytes_as_reference():
    for seed in (0, 3):
        a = ref_serving.make_trace(12, seed=seed, n=24, mean_gap_us=0.5)
        b = serving.make_trace(12, seed=seed, n=24, mean_gap_us=0.5)
        for ra, rb in zip(a, b):
            assert ra.x.dtype == rb.x.dtype
            assert ra.x.tobytes() == rb.x.tobytes()
            assert (ra.rid, ra.m, ra.priority, ra.arrival_us,
                    vars(ra.budget)) == (rb.rid, rb.m, rb.priority,
                                         rb.arrival_us, vars(rb.budget))
            assert ra.fmt_width == rb.fmt_width
        assert ref_serving.trace_mix(a) == serving.trace_mix(b)


# ---------------------------------------------------------------------------
# Clock.
# ---------------------------------------------------------------------------


class TestClock:
    def test_simulated_advance(self):
        c = serving.SimulatedClock()
        assert c.now_us() == 0.0
        assert c.advance_us(2.5) == 2.5
        assert c.advance_cycles(400, 400e6) == pytest.approx(3.5)

    def test_negative_advance_raises(self):
        with pytest.raises(ValueError, match="negative"):
            serving.SimulatedClock().advance_us(-1.0)
        with pytest.raises(ValueError, match="freq_hz"):
            serving.SimulatedClock().advance_cycles(10, 0.0)

    def test_wall_clock_advances_itself(self):
        c = serving.WallClock()
        t0 = c.now_us()
        assert c.advance_us(1e9) <= c.now_us() + 1e6
        assert c.now_us() >= t0


# ---------------------------------------------------------------------------
# Priority keys + queue.
# ---------------------------------------------------------------------------


class TestRequestQueue:
    def test_priority_key_matches_reference(self):
        for rid, (prio, arr, now) in enumerate(
                [(0, 0.0, 1e12), (7, 0.0, 1e15), (3, 5000.0, 10_000.0),
                 (5, 12.5, 9999.0)]):
            a = _req(ref_serving, rid=rid, priority=prio, arrival_us=arr)
            b = _req(serving, rid=rid, priority=prio, arrival_us=arr)
            assert priority_key(b, now) == ref_serving.priority_key(a, now)
            assert priority_key(b, now) < (1 << 32)

    def test_pop_order_matches_reference(self):
        rng = np.random.default_rng(0)
        now = 50_000.0
        spec = [(int(rng.integers(0, 8)), float(rng.uniform(0, now)))
                for _ in range(12)]
        got, want = [], []
        for pkg, out, kw in ((serving, got, dict(device=CPU)),
                             (ref_serving, want, {})):
            q = pkg.RequestQueue(max_depth=64, **kw)
            for i, (prio, arr) in enumerate(spec):
                assert q.admit(_req(pkg, rid=i, priority=prio,
                                    arrival_us=arr), now).accepted
            out += [r.rid for r in q.pop_batch(5, now)]
            out += [r.rid for r in q.pop_batch(12, now)]
        keys = [priority_key(_req(serving, rid=i, priority=p,
                                  arrival_us=a), now)
                for i, (p, a) in enumerate(spec)]
        assert got == want == sorted(range(12), key=lambda i: (-keys[i], i))

    def test_backpressure_without_shedding(self):
        q = serving.RequestQueue(max_depth=2, shed_low_priority=False,
                                 device=CPU)
        assert q.admit(_req(serving, rid=0), 0.0).accepted
        assert q.admit(_req(serving, rid=1), 0.0).accepted
        late = _req(serving, rid=2, priority=7)
        d = q.admit(late, 0.0)
        assert not d.accepted and d.reason == "backpressure"
        assert late.status is Status.REJECTED
        assert late.reject_reason == "backpressure"

    def test_priority_shedding(self):
        q = serving.RequestQueue(max_depth=2, device=CPU)
        a, b = _req(serving, rid=0), _req(serving, rid=1)
        q.admit(a, 0.0), q.admit(b, 0.0)
        vip = _req(serving, rid=2, priority=5)
        d = q.admit(vip, 0.0)
        assert d.accepted and d.reason == "shed"
        assert d.shed is a          # equal keys: lowest index is the victim
        assert a.status is Status.REJECTED and a.reject_reason == "shed"
        assert {r.rid for r in q.peek_all()} == {1, 2}

    def test_shedding_refuses_equal_priority(self):
        q = serving.RequestQueue(max_depth=1, device=CPU)
        q.admit(_req(serving, rid=0, priority=3), 0.0)
        d = q.admit(_req(serving, rid=1, priority=3), 0.0)
        assert not d.accepted and d.shed is None

    def test_expire_removes_past_deadline(self):
        q = serving.RequestQueue(max_depth=8, device=CPU)
        r1 = _req(serving, rid=0, max_latency_us=5.0)
        r2 = _req(serving, rid=1)
        q.admit(r1, 0.0), q.admit(r2, 0.0)
        gone = q.expire(10.0)
        assert gone == [r1] and r1.status is Status.EXPIRED
        assert q.peek_all() == [r2]

    def test_where_filter(self):
        q = serving.RequestQueue(max_depth=8, device=CPU)
        for i in range(4):
            q.admit(_req(serving, rid=i, priority=i), 0.0)
        odd = q.pop_batch(4, 0.0, where=lambda r: r.rid % 2 == 1)
        assert [r.rid for r in odd] == [3, 1]
        assert q.depth == 2

    def test_queue_runs_on_the_card_unless_told(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.RequestQueue(max_depth=4)
        assert serving.RequestQueue(max_depth=4, device=CPU).device \
            == torch.device("cpu")


# ---------------------------------------------------------------------------
# Metrics.
# ---------------------------------------------------------------------------


class TestMetrics:
    @pytest.mark.parametrize("q", [1, 25, 50, 90, 99, 100])
    def test_percentile_matches_reference(self, q):
        xs = list(np.random.default_rng(q).exponential(3.0, 17))
        got = percentile(xs, q, device=CPU)
        assert got == ref_serving.percentile(xs, q)
        # ranked as float32, as the reference ranks them
        assert got == float(np.percentile(np.float32(xs), q,
                                          method="inverted_cdf"))

    def test_percentile_nearest_rank(self):
        xs = [5.0, 1.0, 9.0, 3.0, 7.0]
        assert percentile(xs, 50, device=CPU) == np.percentile(
            xs, 50, method="inverted_cdf")
        assert percentile(xs, 99, device=CPU) == 9.0
        assert percentile([], 50, device=CPU) is None
        assert percentile([4.0, None], 50, device=CPU) == 4.0

    def test_ewma(self):
        e = serving.Ewma(alpha=0.5)
        assert e.value is None
        e.update(10.0)
        e.update(20.0)
        assert e.value == pytest.approx(15.0)
        with pytest.raises(ValueError):
            serving.Ewma(alpha=0.0)


# ---------------------------------------------------------------------------
# Dispatcher.
# ---------------------------------------------------------------------------


REQUESTS = {
    "u16 full": dict(n=64),
    "u16 top8": dict(n=64, m=8),
    "u16 top32": dict(n=64, m=32),
    "u16 top33": dict(n=64, m=33),
    "f32 full": dict(n=64, dtype=np.float32),
    "f16 top4": dict(n=48, m=4, dtype=np.float16),
    "descending": dict(n=64, ascending=False),
    "energy": dict(n=64, objective=ENERGY),
    "wall top8": dict(n=64, m=8, objective=WALL),
    "wall full": dict(n=64, objective=WALL),
    "deadline": dict(n=64, m=4, max_latency_us=60.0),
    "infeasible": dict(n=64, max_latency_us=1e-9),
    "energy cap": dict(n=64, max_energy_nj=1e-9, objective=ENERGY),
}


def _dispatchers():
    return dispatch.Dispatcher(device=CPU), ref_serving.Dispatcher()


def _same_estimate(got, want):
    assert got.engine == port_name(want.engine)
    for f in ("latency_us", "energy_nj", "wall_us", "quality", "cycles",
              "freq_hz"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("what", sorted(REQUESTS))
def test_candidates_and_pick_match_reference(pinned, what, fault):
    d, rd = _dispatchers()
    req, ref_req = _req(serving, **REQUESTS[what]), \
        _req(ref_serving, **REQUESTS[what])
    spec = dict(ber=0.01, seed=0)
    with faults.inject(faults.FaultSpec(**spec)) if fault else \
            nullcontext(), \
            ref_faults.inject(ref_faults.FaultSpec(**spec)) if fault else \
            nullcontext():
        cands, ref_cands = d.candidates(req), rd.candidates(ref_req)
        assert cands == [port_name(n) for n in ref_cands]
        pick, ref_pick = d.select(req), rd.select(ref_req)
        for name, ref_n in zip(cands, ref_cands):
            _same_estimate(d.estimate(name, available_engines()[name], req),
                           rd.estimate(ref_n, ref_engines()[ref_n], ref_req))
    assert pick.engine == port_name(ref_pick.engine)
    assert (pick.feasible, pick.reason) == (ref_pick.feasible,
                                            ref_pick.reason)
    _same_estimate(pick.estimate, ref_pick.estimate)


def test_ewma_steering_matches_reference(pinned):
    # the same observations fed to both dispatchers move the same
    # estimates and picks, request after request
    d, rd = _dispatchers()
    rng = np.random.default_rng(5)
    names = [n for n in d.candidates(_req(serving, n=64))]
    for step in range(40):
        what = sorted(REQUESTS)[step % len(REQUESTS)]
        req = _req(serving, rid=step, **REQUESTS[what])
        ref_req = _req(ref_serving, rid=step, **REQUESTS[what])
        pick, ref_pick = d.select(req), rd.select(ref_req)
        assert pick.engine == port_name(ref_pick.engine), (step, what)
        engine = names[int(rng.integers(len(names)))]
        ref_engine = dispatch.reference_name(engine)
        obs = dict(emissions=int(rng.integers(1, 64)),
                   cycles=float(rng.integers(10, 10_000)),
                   wall_us=float(rng.exponential(50.0)),
                   quality=float(rng.uniform(0.9, 1.0)))
        d.observe(engine, **obs)
        rd.observe(ref_engine, **obs)


def test_tied_estimates_break_in_reference_order(pinned):
    # fused-tns and ml measured at the same wall time: under the port's
    # names fused-tns sorts first, under the reference's ml sorts before
    # pallas-tns — the pick must follow the reference
    d, rd = _dispatchers()
    for disp, names in ((d, ("fused-tns", "ml", "radix", "tns", "mb",
                             "bts", "bitslice")),
                        (rd, ("pallas-tns", "ml", "radix", "tns", "mb",
                              "bts", "bitslice"))):
        for name in names:
            wall = 5.0 if name in ("fused-tns", "pallas-tns", "ml") else 50.0
            disp.observe(name, emissions=1, wall_us=wall)
    req, ref_req = _req(serving, n=64, objective=WALL), \
        _req(ref_serving, n=64, objective=WALL)
    ests = {n: d.estimate(n, available_engines()[n], req)
            for n in d.candidates(req)}
    assert ests["fused-tns"].wall_us == ests["ml"].wall_us == min(
        e.wall_us for e in ests.values())
    assert min(["fused-tns", "ml"]) == "fused-tns"     # the trap
    assert rd.select(ref_req).engine == "ml"
    assert d.select(req).engine == "ml"


def test_reference_name_map():
    assert dispatch.reference_name("fused-tns") == "pallas-tns"
    assert dispatch.reference_name("resilient:fused-topk") == \
        "resilient:pallas-topk"
    assert dispatch.reference_name("mb-ft") == "mb-ft"
    assert sorted(map(dispatch.reference_name, available_engines())) == \
        sorted(ref_engines())


class TestDispatcher:
    def test_fused_topk_only_small_m(self):
        d = dispatch.Dispatcher(device=CPU)
        assert "fused-topk" in d.candidates(_req(serving, n=64, m=8))
        assert "fused-topk" in d.candidates(_req(serving, n=64, m=32))
        assert "fused-topk" not in d.candidates(_req(serving, n=64, m=33))
        assert "fused-topk" not in d.candidates(_req(serving, n=64))

    def test_fused_tns_needs_width_30_or_less(self):
        d = dispatch.Dispatcher(device=CPU)
        assert "fused-tns" in d.candidates(_req(serving, n=64))
        assert "fused-tns" not in d.candidates(
            _req(serving, n=64, dtype=np.float32))

    def test_energy_objective_picks_ml(self):
        pick = dispatch.Dispatcher(device=CPU).select(
            _req(serving, n=64, objective=ENERGY))
        assert pick.feasible and pick.engine == "ml"

    def test_fault_forces_verified_engines(self):
        d = dispatch.Dispatcher(device=CPU)
        with faults.inject(faults.FaultSpec(ber=0.01, seed=0)):
            cands = d.candidates(_req(serving, n=64, quality_floor=0.99))
            pick = d.select(_req(serving, n=64, quality_floor=0.99))
        assert "radix" not in cands and "fused-topk" not in cands
        assert pick.engine.startswith("resilient:") or pick.engine == "mb-ft"
        assert pick.feasible

    def test_wall_prior_reads_the_table_for_its_device(self, monkeypatch):
        from repro_torch.kernels import autotune
        table = {"float|N1024|m1|B64|cpu": {"us": 640.0},
                 "float|N256|m8|B64|cpu": {"us": 5120.0},
                 "float|N256|m32|B64|cpu": {"us": 2048.0},
                 "float|N1024|m1|B64|Some card/sm_90": {"us": 1.0}}
        monkeypatch.setattr(autotune, "default_table", lambda: table)
        # us per emission per instance: 10, 10, 1 -> median 10
        assert dispatch._fused_tns_wall_prior(CPU) == 10.0
        d = dispatch.Dispatcher(device=CPU)
        req = _req(serving, n=64, m=4, objective=WALL)
        est = d.estimate("fused-tns", available_engines()["fused-tns"], req)
        assert est.wall_us == 10.0 * 4
        monkeypatch.setattr(autotune, "default_table", lambda: {})
        assert dispatch._fused_tns_wall_prior(CPU) is None


@pytest.fixture
def empty_registry(monkeypatch):
    monkeypatch.setattr(dispatch, "available_engines", lambda: {})


def test_select_with_no_candidates_raises(empty_registry):
    d = dispatch.Dispatcher(device=CPU)
    with pytest.raises(ValueError, match="registry exhausted"):
        d.select(_req(serving, n=64))


# ---------------------------------------------------------------------------
# Orchestrator.
# ---------------------------------------------------------------------------


class TestOrchestrator:
    def _run(self, n_requests=6, **cfg_kw):
        trace = serving.make_trace(n_requests, seed=0, n=32,
                                   mean_gap_us=0.05)
        orch = serving.Orchestrator(
            clock=serving.SimulatedClock(),
            cfg=serving.OrchestratorConfig(chunk=16, **cfg_kw), device=CPU)
        return orch.run(trace)

    def test_deterministic_and_sleepless(self, monkeypatch, pinned):
        def no_sleep(_):
            raise AssertionError("serving loop called time.sleep")
        monkeypatch.setattr(time, "sleep", no_sleep)
        a = self._run()
        monkeypatch.setattr(orchestrator, "time", _fake_time())
        b = self._run()
        a.pop("wall_ms"), b.pop("wall_ms")
        assert a == b
        assert a["completed"] == a["accepted"] == 6
        assert a["sim_us"] > 0

    def test_full_completion_and_metrics(self):
        rep = self._run(n_requests=8)
        assert rep["completed"] == 8 and rep["failed"] == 0
        assert rep["p50_latency_us"] <= rep["p99_latency_us"]
        assert rep["peak_batch_occupancy"] >= 1
        assert sum(rep["engines"].values()) == 8
        assert rep["throughput_elems_per_us"] > 0

    def test_deadline_expiry_sheds_queued_request(self):
        clock = serving.SimulatedClock()
        orch = serving.Orchestrator(clock=clock, device=CPU)
        req = _req(serving, rid=0, max_latency_us=5.0)
        assert orch.submit(req)
        clock.advance_us(10.0)
        orch.tick()
        assert req.status is Status.EXPIRED
        assert orch.stats.expired == 1
        assert orch.queue.depth == 0 and not orch.batch

    def test_step_failure_cooldown_then_fail(self, monkeypatch):
        import repro_torch.sort as sort_mod

        def boom(*a, **kw):
            raise RuntimeError("injected step failure")
        orch = serving.Orchestrator(
            clock=serving.SimulatedClock(),
            cfg=serving.OrchestratorConfig(cooldown_ticks=2,
                                           max_step_retries=1), device=CPU)
        req = _req(serving, rid=0)
        orch.submit(req)
        monkeypatch.setattr(sort_mod, "sort", boom)
        orch.tick()                     # failure 1: run rule goes on cooldown
        assert orch._cooldown.get("run", 0) > 0
        occupancy_during_cooldown = len(orch.batch)
        orch.tick()                     # cooldown tick (run skipped)
        assert len(orch.batch) == occupancy_during_cooldown
        orch.tick()                     # retry > max_step_retries: fails
        assert req.status is Status.FAILED
        assert orch.stats.failed == 1 and not orch.batch

    def test_backpressure_counts_rejections(self):
        orch = serving.Orchestrator(
            clock=serving.SimulatedClock(),
            cfg=serving.OrchestratorConfig(queue_depth=1), device=CPU)
        assert orch.submit(_req(serving, rid=0, priority=3))
        assert not orch.submit(_req(serving, rid=1, priority=3))
        assert orch.stats.accepted == 1 and orch.stats.rejected == 1

    def test_engine_calls_run_on_the_orchestrators_device(self, monkeypatch):
        import repro_torch.sort as sort_mod
        real, seen = sort_mod.sort, []

        def spy(*a, **kw):
            seen.append(kw.get("device"))
            return real(*a, **kw)
        monkeypatch.setattr(sort_mod, "sort", spy)
        self._run(n_requests=3)
        serving.oneshot_loop(serving.make_trace(2, n=16), device=CPU)
        assert seen and set(seen) == {torch.device("cpu")}

    def test_orchestrator_runs_on_the_card_unless_told(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.Orchestrator()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.oneshot_loop(serving.make_trace(1, n=8))
        assert backend.resolve_device(CPU).type == "cpu"


# ---------------------------------------------------------------------------
# The serving CLI.
# ---------------------------------------------------------------------------


class TestServeCli:
    def test_main_on_cpu_matches_the_reference_run(self, reference_runs,
                                                   pinned, tmp_path,
                                                   capsys):
        out = tmp_path / "serve.json"
        serve_cli.main(["--device", "cpu", "--requests", "6", "--n", "32",
                        "--chunk", "16", "--mean-gap-us", "0.05", "--out",
                        str(out)])
        rep = json.loads(out.read_text())
        assert rep.pop("trace_mix") == serving.trace_mix(
            _trace(serving, "continuous"))
        want = _comparable(reference_runs["continuous"][0])
        want["engines"] = {port_name(k): v for k, v in
                           want["engines"].items()}
        assert _comparable(rep) == want
        text = capsys.readouterr().out
        assert "[serve] 6 completed / 6 accepted" in text
        assert f"[serve] wrote {out}" in text

    def test_main_with_faults(self, tmp_path):
        out = tmp_path / "faulted.json"
        serve_cli.main(["--device", "cpu", "--requests", "5", "--n", "16",
                        "--chunk", "16", "--fault-spec", "ber=0.01,seed=0",
                        "--out", str(out)])
        rep = json.loads(out.read_text())
        assert rep["completed"] == 5 and rep["failed"] == 0
        assert rep["fault_counters"]["faults_injected"] > 0
        assert all(e.startswith("resilient:") or e == "mb-ft"
                   for e in rep["engines"])

    def test_list_engines(self, capsys):
        serve_cli.main(["--list-engines"])
        lines = capsys.readouterr().out.splitlines()
        assert sorted(ln.split()[0] for ln in lines) == \
            sorted(available_engines())

    def test_oneshot_is_refused(self):
        with pytest.raises(SystemExit, match="A12"):
            serve_cli.main(["--oneshot"])

    def test_main_runs_on_the_card_unless_told(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_cli.main(["--requests", "1", "--n", "8"])

    def test_module_runs_as_a_script(self, tmp_path):
        import subprocess
        import sys
        from pathlib import Path
        root = Path(__file__).resolve().parents[1]
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--requests", "3", "--n", "16", "--chunk", "16"],
            capture_output=True, text=True, timeout=300, check=True,
            env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin",
                 "HOME": str(tmp_path)})
        assert "[serve] 3 completed / 3 accepted" in out.stdout
