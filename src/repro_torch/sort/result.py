"""Uniform result type for every sort engine: values + indices + the
paper's hardware observables, with the Table-S5-calibrated cost model
attached for latency/energy/area projections."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import cost as cost_model


@dataclasses.dataclass
class SortResult:
    """What every engine returns (host arrays).

    ``indices`` is the emission permutation: ``x[indices[..., i]]`` is the
    i-th output of the sort (ascending unless the call said otherwise).
    For ``stop_after=m`` only the first m entries are meaningful.  Batched
    calls carry a leading B axis on every array field and per-instance
    observables.
    """
    values: np.ndarray                 # sorted values, (..., M)
    indices: np.ndarray                # emission permutation, (..., M)
    engine: str
    fmt: str
    width: int
    n: int                             # dataset length per instance
    # hardware observables (latency-mode engines only; None otherwise)
    cycles: Optional[np.ndarray] = None        # (...,) int
    drs: Optional[np.ndarray] = None
    reload_cycles: Optional[np.ndarray] = None
    strategy: Optional[str] = None     # cost-model anchor (Table S5 key)
    k: int = 0
    level_bits: int = 1
    banks: int = 1                     # multi-bank configuration (§2.3.1)
    # resilience observables (defaults mean "ran on an ideal array"; the
    # "resilient:<engine>" wrappers and "mb-ft" set them)
    quality: Optional[float] = None    # sorting accuracy of the emission
    faults_injected: int = 0           # raw bit faults drawn during reads
    repairs: int = 0                   # repair mechanisms in the final run
    retries: int = 0                   # engine re-runs beyond the first
    degraded: bool = False             # True => best-effort, not verified
    extra_cycles: int = 0              # repair overhead cycles

    @property
    def batched(self) -> bool:
        return self.indices.ndim == 2

    @property
    def drs_per_number(self) -> Optional[float]:
        """Fig. 5e's metric: digit reads per sorted number (mean over the
        batch when batched)."""
        if self.drs is None:
            return None
        return float(np.mean(self.drs)) / max(1, self.indices.shape[-1])

    def metrics(self, *, banks: Optional[int] = None
                ) -> Optional[cost_model.SortMetrics]:
        """Project throughput/area/energy at this configuration's operating
        point (mean cycles over the batch; bank count from the call that
        produced this result unless overridden).  None for engines that
        report no cycle counts."""
        if self.cycles is None or self.strategy is None:
            return None
        point = cost_model.operating_point(
            self.strategy, n=self.n, w=self.width, k=self.k or None,
            level_bits=self.level_bits,
            banks=self.banks if banks is None else banks)
        return cost_model.sort_metrics(int(np.mean(self.cycles)), self.n,
                                       point)
