"""Admission-controlled request queue whose priority order runs on the
port's own sort engines.

The scheduler's "heap" is the paper's hardware: waiting requests are
ranked by encoding their (priority class, waiting age) into sortable
uint32 keys (:func:`repro_torch.serving.request.priority_key`) and
asking the sort facade for the top-m descending — the same
comparison-free top-k the engines serve to every other workload,
dogfooded as the scheduler.

Admission control gives the queue a hard depth bound: a full queue pushes
back.  A newcomer that outranks the worst queued request may shed it
(priority shedding, again located via the facade — a ``stop_after=1``
ascending min-search); otherwise the newcomer is rejected and the caller
sees backpressure.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.kernels import backend
from repro_torch.serving.request import SortRequest, Status, priority_key


@dataclasses.dataclass(frozen=True)
class AdmitDecision:
    accepted: bool
    reason: str = "ok"
    shed: Optional[SortRequest] = None   # victim evicted to make room


class RequestQueue:
    """Bounded priority queue over the sort facade.

    ``engine`` names the registry engine used to rank keys (any engine
    works — they all return the identical permutation; the default
    ``radix`` is the cheapest on host).  Ties in the key break by lowest
    queue index, i.e. FIFO within equal (priority, age) — the engines'
    emission-order guarantee doing scheduler work.  ``device`` is where
    the keys are ranked (``None``: the card).
    """

    def __init__(self, max_depth: int = 64, *, engine: str = "radix",
                 shed_low_priority: bool = True,
                 age_scale_us: float = 1000.0, device=None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.device = backend.resolve_device(device)
        self.max_depth = max_depth
        self.engine = engine
        self.shed_low_priority = shed_low_priority
        self.age_scale_us = age_scale_us
        self._items: List[SortRequest] = []

    def __len__(self) -> int:
        return len(self._items)

    @property
    def depth(self) -> int:
        return len(self._items)

    @property
    def full(self) -> bool:
        return len(self._items) >= self.max_depth

    def _keys(self, items: List[SortRequest], now_us: float) -> np.ndarray:
        return np.asarray(
            [priority_key(r, now_us, self.age_scale_us) for r in items],
            dtype=np.uint32)

    def admit(self, req: SortRequest, now_us: float) -> AdmitDecision:
        """Admission control: accept, shed a lower-priority victim, or
        reject with backpressure."""
        if not self.full:
            self._items.append(req)
            return AdmitDecision(True)
        if self.shed_low_priority:
            from repro_torch import sort as sort_engine
            keys = self._keys(self._items, now_us)
            res = sort_engine.sort(keys, engine=self.engine, stop_after=1,
                                   device=self.device)
            worst_i = int(np.asarray(res.indices).reshape(-1)[0])
            worst = self._items[worst_i]
            if priority_key(req, now_us, self.age_scale_us) \
                    > priority_key(worst, now_us, self.age_scale_us):
                victim = self._items.pop(worst_i)
                victim.status = Status.REJECTED
                victim.reject_reason = "shed"
                self._items.append(req)
                return AdmitDecision(True, "shed", shed=victim)
        req.status = Status.REJECTED
        req.reject_reason = "backpressure"
        return AdmitDecision(False, "backpressure")

    def pop_batch(self, m: int, now_us: float,
                  where: Optional[Callable[[SortRequest], bool]] = None
                  ) -> List[SortRequest]:
        """Remove and return up to ``m`` highest-priority requests (in
        priority order), optionally restricted to ``where``-compatible
        ones — the continuous batcher passes the open cohort's
        compatibility predicate."""
        if m < 1 or not self._items:
            return []
        if where is None:
            cand_idx = list(range(len(self._items)))
        else:
            cand_idx = [i for i, r in enumerate(self._items) if where(r)]
        if not cand_idx:
            return []
        cand = [self._items[i] for i in cand_idx]
        take = min(m, len(cand))
        if len(cand) == 1:
            order = [0]
        else:
            from repro_torch import sort as sort_engine
            keys = self._keys(cand, now_us)
            res = sort_engine.sort(keys, engine=self.engine,
                                   ascending=False, stop_after=take,
                                   device=self.device)
            order = [int(i) for i in np.asarray(res.indices).reshape(-1)]
        picked = [cand_idx[i] for i in order[:take]]
        out = [self._items[i] for i in picked]
        for i in sorted(picked, reverse=True):
            self._items.pop(i)
        return out

    def peek_all(self) -> List[SortRequest]:
        """Queued requests in insertion order (snapshots/tests)."""
        return list(self._items)

    def expire(self, now_us: float) -> List[SortRequest]:
        """Remove queued requests whose deadline already passed (they
        could never finish in time) — load shedding under overload."""
        expired = [r for r in self._items
                   if r.deadline_us is not None and now_us > r.deadline_us]
        for r in expired:
            r.status = Status.EXPIRED
            self._items.remove(r)
        return expired
