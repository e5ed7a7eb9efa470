"""Serving metrics: per-engine EWMA trackers and sustained-throughput
statistics (p50/p99 latency, queue depth, batch occupancy, evictions per
tick).

Percentiles are computed on the port's own comparison-free machinery
(:func:`repro_torch.sort.sort` with the ``radix`` engine, on the device
the caller names) — the serving subsystem dogfoods the sort engines for
its own bookkeeping.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


class Ewma:
    """Exponentially-weighted moving average; first sample initializes."""

    def __init__(self, alpha: float = 0.3):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.value: Optional[float] = None
        self.n = 0

    def update(self, x: float) -> float:
        x = float(x)
        self.value = x if self.value is None else \
            self.alpha * x + (1.0 - self.alpha) * self.value
        self.n += 1
        return self.value

    def get(self, default: Optional[float] = None) -> Optional[float]:
        return default if self.value is None else self.value


def percentile(samples, q: float, *, device=None) -> Optional[float]:
    """q-th percentile (nearest-rank) of ``samples``, ranked by the sort
    facade on ``device`` (``None``: the card) rather than a comparison
    sort."""
    from repro_torch import sort as sort_engine
    arr = np.asarray([s for s in samples if s is not None], dtype=np.float64)
    if arr.size == 0:
        return None
    if arr.size == 1:
        return float(arr[0])
    res = sort_engine.sort(arr.astype(np.float32), engine="radix",
                           device=device)
    rank = min(arr.size - 1, max(0, int(np.ceil(q / 100.0 * arr.size)) - 1))
    return float(np.asarray(res.values)[rank])


@dataclasses.dataclass
class TickStats:
    tick: int
    now_us: float
    queue_depth: int
    batch_occupancy: int
    admitted: int = 0
    evicted_done: int = 0
    evicted_expired: int = 0
    engine: Optional[str] = None
    step_cycles: int = 0
    step_emissions: int = 0
    step_wall_us: float = 0.0


@dataclasses.dataclass
class ServeStats:
    """Accumulated over one orchestrator run; ``summary()`` is the run's
    report.  ``device`` ranks the latency percentiles."""
    ticks: List[TickStats] = dataclasses.field(default_factory=list)
    latencies_us: List[float] = dataclasses.field(default_factory=list)
    engine_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    accepted: int = 0
    rejected: int = 0
    completed: int = 0
    expired: int = 0
    failed: int = 0
    emitted_elements: int = 0
    device: object = None

    def count_engine(self, engine: str) -> None:
        self.engine_counts[engine] = self.engine_counts.get(engine, 0) + 1

    def summary(self, *, sim_us: float, wall_us: float) -> dict:
        nt = max(1, len(self.ticks))
        occ = [t.batch_occupancy for t in self.ticks]
        qd = [t.queue_depth for t in self.ticks]
        evictions = sum(t.evicted_done + t.evicted_expired
                        for t in self.ticks)
        return {
            "ticks": len(self.ticks),
            "sim_us": round(float(sim_us), 3),
            "wall_ms": round(float(wall_us) / 1e3, 3),
            "accepted": self.accepted,
            "rejected": self.rejected,
            "completed": self.completed,
            "expired": self.expired,
            "failed": self.failed,
            "emitted_elements": self.emitted_elements,
            "throughput_elems_per_us": round(
                self.emitted_elements / max(sim_us, 1e-9), 4),
            "requests_per_ms": round(
                self.completed / max(sim_us / 1e3, 1e-9), 4),
            "p50_latency_us": _round(percentile(
                self.latencies_us, 50, device=self.device)),
            "p99_latency_us": _round(percentile(
                self.latencies_us, 99, device=self.device)),
            "mean_batch_occupancy": round(float(np.mean(occ)) if occ else 0.0, 3),
            "peak_batch_occupancy": int(max(occ)) if occ else 0,
            "mean_queue_depth": round(float(np.mean(qd)) if qd else 0.0, 3),
            "evictions_per_tick": round(evictions / nt, 4),
            "engines": {k: self.engine_counts[k]
                        for k in sorted(self.engine_counts)},
        }


def _round(v: Optional[float], nd: int = 3) -> Optional[float]:
    return None if v is None else round(v, nd)
