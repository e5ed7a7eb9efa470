"""Production serving subsystem of the port: async request queue,
continuous batching, and budget-aware engine dispatch over the port's
sort registry.

    from repro_torch import serving

    trace = serving.make_trace(64, seed=0)
    orch = serving.Orchestrator(clock=serving.SimulatedClock())  # the card
    report = orch.run(trace)          # deterministic, cycle-grounded
    serving.Orchestrator(device="cpu")   # plain versions on the host

The pieces (each its own module of ``repro_torch.serving``):

* ``clock`` — simulated vs wall time sources;
* ``request`` — :class:`SortRequest` + :class:`SortBudget`;
* ``queue`` — admission control + priorities on the port's own sort
  facade;
* ``dispatch`` — budget-aware engine selection from Table-S5 operating
  points + live EWMA measurements;
* ``orchestrator`` — the continuous-batching tick loop (snapshot ->
  rules, cooldowns, single-flight) and the one-shot baseline;
* ``metrics`` — EWMA, percentiles, sustained-throughput stats;
* ``workload`` — deterministic synthetic traces.
"""
from repro_torch.serving.clock import SimulatedClock, WallClock
from repro_torch.serving.dispatch import Dispatch, Dispatcher, Estimate
from repro_torch.serving.metrics import Ewma, ServeStats, percentile
from repro_torch.serving.orchestrator import (Orchestrator,
                                              OrchestratorConfig, Rule,
                                              Snapshot, oneshot_loop)
from repro_torch.serving.queue import AdmitDecision, RequestQueue
from repro_torch.serving.request import (SortBudget, SortRequest, Status,
                                         priority_key)
from repro_torch.serving.workload import make_trace, trace_mix

__all__ = [
    "SimulatedClock", "WallClock", "Dispatch", "Dispatcher", "Estimate",
    "Ewma", "ServeStats", "percentile", "Orchestrator",
    "OrchestratorConfig", "Rule", "Snapshot", "oneshot_loop",
    "AdmitDecision", "RequestQueue", "SortBudget", "SortRequest",
    "Status", "priority_key", "make_trace", "trace_mix",
]
