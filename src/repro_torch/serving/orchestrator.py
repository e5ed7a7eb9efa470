"""Continuous-batching serving orchestrator.

The loop follows the Revive orchestrator shape (snapshot -> prioritized
rules -> run, with cooldowns and single-flight): every tick builds an
immutable :class:`Snapshot` of the system, then walks an ordered rule
list —

  ``expire``  shed requests whose deadline already passed,
  ``evict``   free batch slots of finished sequences,
  ``admit``   pull compatible queued requests into the open slots
              (priority order via the queue's top-k facade),
  ``run``     one continuous-batching step: the whole cohort advances by
              up to ``chunk`` emissions in ONE engine dispatch (the
              batched TNS machine or kernel when the engine supports
              it),

— each rule firing only when its ``when`` predicate holds.  A failing
run-step puts the ``run`` rule on cooldown and eventually fails the
cohort; the single-flight guard keeps re-entrant ticks from double
dispatching.

Cycle accounting is lockstep, like the hardware: a batched step costs the
*maximum* per-instance incremental cycles (instances that finished early
idle), which is exactly why continuous batching beats a one-shot loop —
the one-shot driver pays the *sum*.  The simulated clock advances by that
device time at the cohort engine's Table-S5 operating point, so every
latency/throughput figure is deterministic and cycle-grounded.

Every engine call, the queue's ranking and the percentiles run on the
orchestrator's ``device`` (``None``: the card).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.kernels import backend
from repro_torch.serving.clock import SimulatedClock
from repro_torch.serving.dispatch import Dispatcher
from repro_torch.serving.metrics import ServeStats, TickStats
from repro_torch.serving.queue import RequestQueue
from repro_torch.serving.request import SortRequest, Status


@dataclasses.dataclass(frozen=True)
class OrchestratorConfig:
    max_batch: int = 8               # continuous-batch slots
    chunk: int = 8                   # emissions per sequence per tick
    tick_overhead_us: float = 0.05   # controller/periphery cost per tick
    cooldown_ticks: int = 2          # run-rule cooldown after a failure
    max_step_retries: int = 2        # failed steps before the cohort fails
    queue_depth: int = 64
    queue_engine: str = "radix"      # engine ranking the admission queue
    lifo_k: int = 4                  # k passed to latency-mode engines
    max_ticks: int = 100_000


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Immutable view of the system one tick observes."""
    tick: int
    now_us: float
    queue_depth: int
    batch: tuple                     # running SortRequests (read-only use)
    free_slots: int
    inflight: bool


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    when: Callable[[Snapshot], bool]
    run: Callable[[Snapshot], None]


class Orchestrator:
    """Admit -> batch -> step -> evict over the sort-engine registry."""

    def __init__(self, *, clock: Optional[SimulatedClock] = None,
                 dispatcher: Optional[Dispatcher] = None,
                 cfg: Optional[OrchestratorConfig] = None, device=None):
        self.cfg = cfg or OrchestratorConfig()
        self.device = backend.resolve_device(device)
        self.clock = clock or SimulatedClock()
        self.dispatcher = dispatcher or Dispatcher(lifo_k=self.cfg.lifo_k,
                                                   device=self.device)
        self.queue = RequestQueue(self.cfg.queue_depth,
                                  engine=self.cfg.queue_engine,
                                  device=self.device)
        self.stats = ServeStats(device=self.device)
        self.batch: List[SortRequest] = []
        self.done: List[SortRequest] = []
        self._tick_no = 0
        self._inflight = False
        self._cooldown: Dict[str, int] = {}
        self._step_retries = 0
        self._rules = [
            Rule("expire", self._when_expire, self._run_expire),
            Rule("evict", self._when_evict, self._run_evict),
            Rule("admit", self._when_admit, self._run_admit),
            Rule("run", self._when_run, self._run_step),
        ]
        self._tickstats: Optional[TickStats] = None

    # -- submission --------------------------------------------------------

    def submit(self, req: SortRequest) -> bool:
        """Admission-controlled entry; returns False on backpressure."""
        decision = self.queue.admit(req, self.clock.now_us())
        if decision.shed is not None:
            self.stats.rejected += 1
            self.done.append(decision.shed)
        if decision.accepted:
            self.stats.accepted += 1
        else:
            self.stats.rejected += 1
            self.done.append(req)
        return decision.accepted

    # -- the tick ----------------------------------------------------------

    def snapshot(self) -> Snapshot:
        return Snapshot(tick=self._tick_no, now_us=self.clock.now_us(),
                        queue_depth=self.queue.depth,
                        batch=tuple(self.batch),
                        free_slots=self.cfg.max_batch - len(self.batch),
                        inflight=self._inflight)

    def tick(self) -> TickStats:
        """One orchestrator cycle: snapshot, then each rule in priority
        order, honoring per-rule cooldowns."""
        self._tick_no += 1
        ts = TickStats(tick=self._tick_no, now_us=self.clock.now_us(),
                       queue_depth=self.queue.depth,
                       batch_occupancy=len(self.batch))
        self._tickstats = ts
        for name in list(self._cooldown):
            self._cooldown[name] -= 1
            if self._cooldown[name] <= 0:
                del self._cooldown[name]
        for rule in self._rules:
            if self._cooldown.get(rule.name, 0) > 0:
                continue
            snap = self.snapshot()
            if rule.when(snap):
                rule.run(snap)
        ts.queue_depth = self.queue.depth
        ts.batch_occupancy = len(self.batch)
        self.clock.advance_us(self.cfg.tick_overhead_us)
        self.stats.ticks.append(ts)
        return ts

    # -- rule: expire ------------------------------------------------------

    def _when_expire(self, snap: Snapshot) -> bool:
        dl = [r.deadline_us for r in snap.batch] + \
             [r.deadline_us for r in self.queue.peek_all()]
        return any(d is not None and snap.now_us > d for d in dl)

    def _run_expire(self, snap: Snapshot) -> None:
        for req in self.queue.expire(snap.now_us):
            self.stats.expired += 1
            self._tickstats.evicted_expired += 1
            self.done.append(req)
        for req in [r for r in self.batch
                    if r.deadline_us is not None
                    and snap.now_us > r.deadline_us and not r.finished]:
            req.status = Status.EXPIRED
            self.batch.remove(req)
            self.stats.expired += 1
            self._tickstats.evicted_expired += 1
            self.done.append(req)

    # -- rule: evict finished ---------------------------------------------

    def _when_evict(self, snap: Snapshot) -> bool:
        return any(r.finished for r in snap.batch)

    def _run_evict(self, snap: Snapshot) -> None:
        for req in [r for r in self.batch if r.finished]:
            self.batch.remove(req)
            self._tickstats.evicted_done += 1
            self.done.append(req)

    # -- rule: admit -------------------------------------------------------

    def _when_admit(self, snap: Snapshot) -> bool:
        return snap.free_slots > 0 and snap.queue_depth > 0

    def _run_admit(self, snap: Snapshot) -> None:
        now = snap.now_us
        free = self.cfg.max_batch - len(self.batch)
        if not self.batch:
            # seed a new cohort with the highest-priority request
            seed = self.queue.pop_batch(1, now)
            if not seed:
                return
            req = seed[0]
            pick = self.dispatcher.select(req)
            req.engine = pick.engine
            self._start(req)
            free -= 1
        cohort = self.batch[0]
        key = cohort.compat_key()

        def joins(r: SortRequest) -> bool:
            fmt, width = r.fmt_width
            if (cohort.engine, fmt, width, r.n, r.ascending) != key:
                return False
            # a joiner must independently be dispatched to the cohort's
            # engine — budgets stay per-request, packing never overrides
            return self.dispatcher.select(r).engine == cohort.engine

        if free > 0:
            for req in self.queue.pop_batch(free, now, where=joins):
                req.engine = cohort.engine
                self._start(req)

    def _start(self, req: SortRequest) -> None:
        req.status = Status.RUNNING
        self.batch.append(req)
        self.stats.count_engine(req.engine)
        self._tickstats.admitted += 1

    # -- rule: run one continuous-batching step ----------------------------

    def _when_run(self, snap: Snapshot) -> bool:
        return bool(snap.batch or self.batch) and not snap.inflight

    def _run_step(self, snap: Snapshot) -> None:
        from repro_torch import sort as sort_engine
        if self._inflight or not self.batch:
            return
        self._inflight = True
        try:
            members = list(self.batch)
            engine = members[0].engine
            targets = [min(r.target, r.progress + self.cfg.chunk)
                       for r in members]
            stop = max(targets)
            n = members[0].n
            # bucket the dispatch shape (as the reference package does to
            # bound its compiles): stop_after rounds up to a chunk
            # multiple (extra emissions are sliced off) and batchable
            # engines pad to the full slot count with repeated rows
            # (padded instances cost nothing on the simulated clock)
            stop = min(n, self.cfg.chunk *
                       -(-stop // self.cfg.chunk))
            if engine.endswith("fused-topk"):
                from repro_torch.sort.builtin_engines import FUSED_TOPK_MAX
                stop = min(stop, FUSED_TOPK_MAX, n)
            x = np.stack([r.x for r in members])
            from repro_torch.sort.registry import available_engines
            if available_engines()[engine].supports_batch \
                    and x.shape[0] < self.cfg.max_batch:
                pad = np.repeat(x[-1:], self.cfg.max_batch - x.shape[0],
                                axis=0)
                x = np.concatenate([x, pad], axis=0)
            t0 = time.perf_counter()
            try:
                res = sort_engine.sort(
                    x, engine=engine, k=self.cfg.lifo_k,
                    ascending=members[0].ascending,
                    stop_after=None if stop >= n else stop,
                    device=self.device)
            except Exception:
                self._step_retries += 1
                self._cooldown["run"] = self.cfg.cooldown_ticks
                if self._step_retries > self.cfg.max_step_retries:
                    for r in members:
                        r.status = Status.FAILED
                        self.stats.failed += 1
                        self.done.append(r)
                    self.batch.clear()
                    self._step_retries = 0
                return
            wall_us = (time.perf_counter() - t0) * 1e6
            self._step_retries = 0
            self._account(members, res, stop, wall_us)
        finally:
            self._inflight = False

    def _account(self, members: List[SortRequest], res, stop: int,
                 wall_us: float) -> None:
        """Charge cycles/emissions per member, advance the clock by the
        lockstep step time, and mark finished sequences."""
        engine = members[0].engine
        B = len(members)
        cyc = None
        if res.cycles is not None:
            cyc = np.asarray(res.cycles, dtype=np.int64).reshape(-1)
            if cyc.size == 1 and B > 1:
                cyc = np.repeat(cyc, B)
        idx = np.asarray(res.indices)
        if idx.ndim == 1:
            idx = idx[None, :]
        step_emissions = 0
        max_inc_cycles = 0
        max_new = 0
        for i, r in enumerate(members):
            new_stop = min(stop, r.target, idx.shape[-1])
            new = max(0, new_stop - r.progress)
            r.indices = idx[i, :new_stop].copy()
            inc = 0
            if cyc is not None:
                inc = max(0, int(cyc[i]) - r.cycles)
                r.cycles = int(cyc[i])
            r.progress = new_stop
            step_emissions += new
            max_inc_cycles = max(max_inc_cycles, inc)
            max_new = max(max_new, new)
            if new > 0:
                self.dispatcher.observe(
                    engine, emissions=new,
                    cycles=inc if cyc is not None else None,
                    wall_us=wall_us / B,
                    quality=res.quality)
        dt_us = self.dispatcher.step_time_us(
            engine, max_inc_cycles if cyc is not None else None,
            max_new, members[0].n)
        self.clock.advance_us(dt_us)
        now = self.clock.now_us()
        for r in members:
            if r.finished:
                r.status = Status.DONE
                r.finish_us = now
                self.stats.completed += 1
                self.stats.latencies_us.append(r.latency_us())
        ts = self._tickstats
        ts.engine = engine
        ts.step_cycles = max_inc_cycles
        ts.step_emissions = step_emissions
        ts.step_wall_us = wall_us
        self.stats.emitted_elements += step_emissions

    # -- driving a whole trace --------------------------------------------

    def run(self, trace: Sequence[SortRequest],
            max_ticks: Optional[int] = None) -> dict:
        """Serve ``trace`` (requests with arrival times) to completion on
        the simulated clock; returns the sustained-throughput summary."""
        limit = max_ticks or self.cfg.max_ticks
        pending = sorted(trace, key=lambda r: (r.arrival_us, r.rid))
        total = len(pending)
        i = 0
        wall0 = time.perf_counter()
        start_us = self.clock.now_us()
        while len(self.done) < total and self._tick_no < limit:
            now = self.clock.now_us()
            while i < len(pending) and pending[i].arrival_us <= now:
                self.submit(pending[i])
                i += 1
            idle = not self.batch and self.queue.depth == 0
            if idle and i < len(pending):
                # nothing to do until the next arrival: jump the clock
                self.clock.advance_us(
                    max(0.0, pending[i].arrival_us - now))
                continue
            self.tick()
        wall_us = (time.perf_counter() - wall0) * 1e6
        return self.stats.summary(sim_us=self.clock.now_us() - start_us,
                                  wall_us=wall_us)


def oneshot_loop(trace: Sequence[SortRequest], *,
                 dispatcher: Optional[Dispatcher] = None,
                 clock: Optional[SimulatedClock] = None,
                 tick_overhead_us: float = 0.05,
                 lifo_k: int = 4, device=None) -> dict:
    """The pre-orchestrator serving model, as the baseline: handle each
    request alone, in arrival order, one full engine call per request —
    no queue, no batching, no eviction.  Same dispatcher, same cost
    accounting, so the comparison isolates continuous batching."""
    from repro_torch import sort as sort_engine
    device = backend.resolve_device(device)
    dispatcher = dispatcher or Dispatcher(lifo_k=lifo_k, device=device)
    clock = clock or SimulatedClock()
    stats = ServeStats(device=device)
    start_us = clock.now_us()
    wall0 = time.perf_counter()
    for req in sorted(trace, key=lambda r: (r.arrival_us, r.rid)):
        if clock.now_us() < req.arrival_us:
            clock.advance_us(req.arrival_us - clock.now_us())
        pick = dispatcher.select(req)
        req.engine = pick.engine
        stats.count_engine(pick.engine)
        stats.accepted += 1
        t0 = time.perf_counter()
        res = sort_engine.sort(
            req.x, engine=pick.engine, k=lifo_k, ascending=req.ascending,
            stop_after=None if req.target >= req.n else req.target,
            device=device)
        wall_req = (time.perf_counter() - t0) * 1e6
        cycles = None if res.cycles is None else int(np.sum(res.cycles))
        req.cycles = cycles or 0
        req.progress = req.target
        req.indices = np.asarray(res.indices).reshape(-1)[:req.target]
        clock.advance_us(dispatcher.step_time_us(
            pick.engine, cycles, req.target, req.n) + tick_overhead_us)
        req.status = Status.DONE
        req.finish_us = clock.now_us()
        stats.completed += 1
        stats.latencies_us.append(req.latency_us())
        stats.emitted_elements += req.target
        dispatcher.observe(pick.engine, emissions=req.target,
                           cycles=cycles, wall_us=wall_req,
                           quality=res.quality)
    wall_us = (time.perf_counter() - wall0) * 1e6
    return stats.summary(sim_us=clock.now_us() - start_us, wall_us=wall_us)
