"""Request and budget types for the serving subsystem.

A :class:`SortRequest` is one unit of admitted work: a dataset to sort (or
extract the top-m of) plus a :class:`SortBudget` declaring what the caller
is willing to pay.  The budget speaks the cost model's language
(:mod:`repro_torch.core.cost`): device-time latency in microseconds,
energy in nanojoules, and a quality floor on the emission — the three
axes the paper's reconfigurability story trades between strategies.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import bitplane as bp

# Budget objectives: which axis the dispatcher minimizes after the
# constraints are satisfied.
LATENCY = "latency"      # device-time (cycles / f_clk at the op. point)
ENERGY = "energy"        # device energy (power x latency)
WALL = "wall"            # host wall-clock (throughput-mode engines play)
OBJECTIVES = (LATENCY, ENERGY, WALL)


@dataclasses.dataclass(frozen=True)
class SortBudget:
    """What one request is allowed to cost.  ``None`` means unconstrained.

    ``max_latency_us`` doubles as the request deadline: the orchestrator
    evicts a request that is still unfinished ``max_latency_us`` after
    arrival (graceful load-shedding under overload).
    """
    max_latency_us: Optional[float] = None   # device-time budget + deadline
    max_energy_nj: Optional[float] = None    # device-energy budget
    quality_floor: float = 1.0               # min acceptable emission quality
    objective: str = LATENCY                 # axis to minimize

    def __post_init__(self):
        if self.objective not in OBJECTIVES:
            raise ValueError(f"objective must be one of {OBJECTIVES}, "
                             f"got {self.objective!r}")
        if not (0.0 <= self.quality_floor <= 1.0):
            raise ValueError(f"quality_floor must be in [0, 1], "
                             f"got {self.quality_floor}")


class Status(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"      # admitted into the continuous batch
    DONE = "done"
    REJECTED = "rejected"    # admission control refused it (backpressure)
    EXPIRED = "expired"      # deadline passed before completion; evicted
    FAILED = "failed"        # engine kept erroring past the retry budget


@dataclasses.dataclass
class SortRequest:
    """One serving request plus its lifecycle bookkeeping.

    ``m`` is how many extrema the caller wants (``None`` = full sort);
    ``progress`` counts emissions already delivered by the continuous
    batch.  Identity/ordering bookkeeping is filled in by the queue and
    orchestrator, not the caller.
    """
    rid: int
    x: np.ndarray
    m: Optional[int] = None
    priority: int = 0                  # 0 (batch) .. 7 (interactive)
    arrival_us: float = 0.0
    ascending: bool = True
    budget: SortBudget = dataclasses.field(default_factory=SortBudget)
    # filled by the serving loop
    status: Status = Status.QUEUED
    engine: Optional[str] = None       # dispatcher's pick
    progress: int = 0                  # emissions delivered so far
    indices: Optional[np.ndarray] = None   # emission permutation so far
    cycles: int = 0                    # device cycles charged so far
    finish_us: Optional[float] = None
    reject_reason: Optional[str] = None

    def __post_init__(self):
        self.x = np.asarray(self.x)
        if self.x.ndim != 1:
            raise ValueError(f"request {self.rid}: x must be (N,), "
                             f"got shape {self.x.shape}")
        if not (0 <= self.priority <= 7):
            raise ValueError(f"request {self.rid}: priority must be 0..7")
        if self.m is not None and not (1 <= self.m <= self.n):
            raise ValueError(f"request {self.rid}: m={self.m} out of "
                             f"range for n={self.n}")

    @property
    def n(self) -> int:
        return int(self.x.shape[-1])

    @property
    def target(self) -> int:
        """Emissions needed before this request is finished."""
        return self.n if self.m is None else self.m

    @property
    def fmt_width(self) -> Tuple[str, int]:
        """The (fmt, width) the facade will auto-encode this dataset to."""
        from repro_torch.sort.api import _infer_fmt_width
        return _infer_fmt_width(self.x, None, None)

    @property
    def finished(self) -> bool:
        return self.progress >= self.target

    @property
    def deadline_us(self) -> Optional[float]:
        if self.budget.max_latency_us is None:
            return None
        return self.arrival_us + self.budget.max_latency_us

    def compat_key(self) -> Tuple:
        """Requests with equal keys can share one batched engine call:
        same encoding, length, direction, and dispatched engine."""
        fmt, width = self.fmt_width
        return (self.engine, fmt, width, self.n, self.ascending)

    def latency_us(self) -> Optional[float]:
        if self.finish_us is None:
            return None
        return self.finish_us - self.arrival_us


def priority_key(req: SortRequest, now_us: float,
                 age_scale_us: float = 1000.0) -> int:
    """Scheduler key, higher = more urgent: priority class in the top
    bits, waiting age in the low bits so equal-priority requests age
    toward the front (no starvation).  Encoded as a sortable uint32 so the
    queue can rank requests on the port's own sort engines."""
    age = max(0.0, now_us - req.arrival_us) / age_scale_us
    age_bits = min(int(age), (1 << 24) - 1)
    return (int(req.priority) << 24) | age_bits


def encode(fmt: str) -> str:
    """Human name of a bit-plane format (reports/tables)."""
    return {bp.UNSIGNED: "unsigned", bp.TWOS: "int",
            bp.SIGNMAG: "signmag", bp.FLOAT: "float"}.get(fmt, fmt)
