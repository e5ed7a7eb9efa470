"""Synthetic serving traces: a deterministic mixed stream of sort
requests over the paper's data types and the budget axes the dispatcher
trades between.

Request classes (the mix is the reconfigurability story as traffic):

* ``bulk-energy``   — full unsigned sorts minimizing device energy (the
                      ML strategy's home turf);
* ``bulk-latency``  — full unsigned sorts minimizing device latency
                      (bit-slice / multi-bank territory);
* ``float-latency`` — full float sorts (formats rule out bit-slice);
* ``topm``          — small top-m extractions with tight latency
                      deadlines (BTS / TNS early-stop territory);
* ``wall``          — host-throughput requests (the vectorized engines);

Everything derives from one seed: arrivals, payloads, priorities and
budgets are reproducible run to run — the property the simulated-clock
determinism tests and the CI serve lane rely on.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import ENERGY, LATENCY, WALL, \
    SortBudget, SortRequest

CLASSES = ("bulk-energy", "bulk-latency", "float-latency", "topm", "wall")


def _payload(rng: np.random.Generator, klass: str, n: int) -> np.ndarray:
    if klass == "float-latency":
        return rng.standard_normal(n).astype(np.float32)
    return rng.integers(0, 1 << 16, n).astype(np.uint16)


def _budget(klass: str, n: int) -> SortBudget:
    if klass == "bulk-energy":
        return SortBudget(objective=ENERGY)
    if klass == "topm":
        # tight device deadline: early-stop engines or bust
        return SortBudget(max_latency_us=50.0 + 0.5 * n,
                          objective=LATENCY)
    if klass == "wall":
        return SortBudget(objective=WALL)
    return SortBudget(objective=LATENCY)


def make_trace(n_requests: int, *, seed: int = 0, n: int = 64,
               mean_gap_us: float = 2.0,
               classes: Sequence[str] = CLASSES,
               quality_floor: Optional[float] = None
               ) -> List[SortRequest]:
    """A mixed request trace with Poisson-ish arrivals (deterministic per
    seed).  All requests share length ``n`` so the continuous batcher has
    real packing opportunities; the class mix varies dtype, m, priority
    and budget.  ``quality_floor`` overrides every budget's floor (used
    with an active FaultSpec to force verified engines)."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    rng = np.random.default_rng(seed)
    reqs: List[SortRequest] = []
    t = 0.0
    for rid in range(n_requests):
        klass = classes[rid % len(classes)]
        t += float(rng.exponential(mean_gap_us))
        m = None
        if klass == "topm":
            m = int(rng.integers(2, min(9, n)))
        if klass == "wall":
            m = int(rng.integers(2, min(17, n)))
        budget = _budget(klass, n)
        if quality_floor is not None:
            budget = SortBudget(
                max_latency_us=budget.max_latency_us,
                max_energy_nj=budget.max_energy_nj,
                quality_floor=quality_floor,
                objective=budget.objective)
        reqs.append(SortRequest(
            rid=rid, x=_payload(rng, klass, n), m=m,
            priority=int(rng.integers(0, 8)), arrival_us=t,
            budget=budget))
    return reqs


def trace_mix(trace: Sequence[SortRequest]) -> Dict[str, int]:
    """(fmt, n, m-profile) histogram of a trace, for reports."""
    out: Dict[str, int] = {}
    for r in trace:
        fmt, width = r.fmt_width
        key = f"{fmt}{width}/n{r.n}/" + ("full" if r.m is None
                                         else f"top{r.m}")
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))
