"""Verify-and-repair wrapper + fault-tolerant multi-bank execution.

Importing this module (the registry does it alongside the built-ins)
registers:

* ``"resilient:<engine>"`` for every already-registered engine — runs the
  inner engine, verifies the output with a comparison-free O(M·W)
  digit-plane monotonicity check, and on failure escalates through repair
  strategies: dead-bank re-programming (heartbeat-detected), re-read
  majority voting, Hamming parity-plane ECC, then full retries with
  exponential backoff (``faults.run_step_with_retries``).
  If everything fails it degrades gracefully: the best permutation seen is
  returned with ``degraded=True`` and its ``quality`` score instead of an
  exception.
* ``"mb-ft"`` — fault-tolerant multi-bank CA-TNS: a heartbeat probe of the
  bank set detects dead banks, their bit-slices are re-programmed onto the
  surviving banks, and the sort completes on the multi-bank machine over
  the survivors (banks on one device's tensor axis), or on the
  cycle-identical single-array machine (eq. 2) where the banks cannot
  split the input evenly, with the migration and repair overhead accounted
  in ``extra_cycles``.

Verification digit-reads are modeled ideal — the paper's periphery can
re-read at slow, high-margin sense settings — so a pass is trustworthy;
``quality`` is computed against ground truth and equals 1.0 whenever
verification passes on a full sort.  Faults are drawn on the host planes
(:mod:`repro_torch.runtime.faults`), so the repairs, retries and counts
are the same whatever device the inner engine runs on.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

import repro_torch.sort.builtin_engines  # noqa: F401  (wrap targets)
from repro_torch.core import bitplane as bp
from repro_torch.core import catns
from repro_torch.core import tns as tt
from repro_torch.runtime import faults
from repro_torch.runtime.faults import run_step_with_retries
from repro_torch.sort.registry import _REGISTRY, EngineSpec, register
from repro_torch.sort.result import SortResult

PREFIX = "resilient:"


# ---------------------------------------------------------------------------
# Comparison-free verification + the quality metric.
# ---------------------------------------------------------------------------


def _directed_keys(x, width: int, fmt: str, ascending: bool) -> np.ndarray:
    keys = bp.sort_key(np.asarray(x), width, fmt).astype(np.uint64)
    if not ascending:
        keys = (~keys) & np.uint64((1 << width) - 1)
    return keys


def _planes_le(a_planes: np.ndarray, b_planes: np.ndarray) -> np.ndarray:
    """Digit-wise a <= b for (W, M) bit-plane pairs: at the first (MSB
    side) differing digit, a must hold 0.  No value comparator anywhere —
    this is the check the paper's periphery can run with W digit reads."""
    diff = a_planes ^ b_planes
    any_diff = diff.any(axis=0)
    first = np.argmax(diff != 0, axis=0)
    a_first = a_planes[first, np.arange(a_planes.shape[1])]
    return ~any_diff | (a_first == 0)


def check_sorted(x, perm, *, width: int, fmt: str,
                 ascending: bool = True) -> bool:
    """Comparison-free O(M·W) verification of an emission permutation:
    ``perm`` must be a valid (prefix of a) permutation, digit-wise
    monotone, and — for a prefix — its last emission must not exceed any
    unemitted number.  Passing implies the emission is exactly sorted."""
    x = np.asarray(x)
    perm = np.asarray(perm).reshape(-1)
    n = x.shape[-1]
    m = perm.shape[0]
    if m == 0:
        return True
    if perm.min() < 0 or perm.max() >= n or np.unique(perm).size != m:
        return False
    keys = _directed_keys(x, width, fmt, ascending)
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    emitted = ((keys[perm][None, :] >> shifts[:, None]) & np.uint64(1)
               ).astype(np.uint8)
    if m > 1 and not bool(_planes_le(emitted[:, :-1], emitted[:, 1:]).all()):
        return False
    if m < n:
        rest = np.setdiff1d(np.arange(n), perm, assume_unique=False)
        rest_planes = ((keys[rest][None, :] >> shifts[:, None]) & np.uint64(1)
                       ).astype(np.uint8)
        last = np.broadcast_to(emitted[:, -1:], rest_planes.shape)
        if not bool(_planes_le(last, rest_planes).all()):
            return False
    return True


def emission_quality(x, perm, *, width: int, fmt: str,
                     ascending: bool = True) -> float:
    """Fraction of emission positions holding the correct value — the
    generalization of :func:`repro_torch.core.device_model.sorting_accuracy` to
    every data format, direction and prefix (Fig. S28's metric)."""
    x = np.asarray(x)
    perm = np.asarray(perm).reshape(-1)
    n = x.shape[-1]
    m = perm.shape[0]
    if m == 0:
        return 1.0
    keys = _directed_keys(x, width, fmt, ascending)
    expect = np.sort(keys)[:m]
    valid = (perm >= 0) & (perm < n)
    got = keys[np.clip(perm, 0, n - 1)]
    return float(np.mean(valid & (got == expect)))


# ---------------------------------------------------------------------------
# The repair ladder (shared by the wrapper and mb-ft).
# ---------------------------------------------------------------------------


def _burned_cycles(attempts: List[SortResult]) -> int:
    return sum(int(np.sum(np.asarray(a.cycles))) for a in attempts
               if a.cycles is not None)


def _repair_ladder(run: Callable[[faults.FaultSpec], SortResult],
                   check: Callable[[SortResult], bool],
                   qual: Callable[[SortResult], float],
                   base: faults.FaultSpec, *, remapped: bool,
                   first_attempt: SortResult
                   ) -> Tuple[SortResult, float, int, int, bool, int]:
    """Escalate through repair strategies until verification passes.

    Returns ``(result, quality, repairs, retries, degraded, burned)``
    where ``repairs`` counts the repair mechanisms active in the winning
    configuration, ``retries`` the engine re-runs beyond the first, and
    ``burned`` the cycles spent on failed attempts."""
    attempts = [first_attempt]
    retries = 0
    R = max(2, base.repair_reads)
    ladder = []
    if remapped:
        ladder.append(base)                      # re-programmed, plain read
    ladder.append(base.with_(redundant_reads=R))  # + majority voting
    ladder.append(base.with_(redundant_reads=R, parity_ecc=True))  # + ECC
    for spec in ladder:
        retries += 1
        res = run(spec)
        if check(res):
            repairs = (int(remapped) + int(spec.redundant_reads > 1)
                       + int(spec.parity_ecc))
            return res, 1.0, repairs, retries, False, _burned_cycles(attempts)
        attempts.append(res)
    final_spec = ladder[-1]

    def once():
        nonlocal retries
        retries += 1
        res = run(final_spec)
        if not check(res):
            attempts.append(res)
            raise RuntimeError("resilient sort: verification failed")
        return res

    try:
        res = run_step_with_retries(once, retries=base.max_retries,
                                    backoff_s=0.002, jitter=0.5,
                                    rng=np.random.default_rng(base.seed))
        repairs = int(remapped) + 2
        return res, 1.0, repairs, retries, False, _burned_cycles(attempts)
    except RuntimeError:
        best = max(attempts, key=qual)
        rest = [a for a in attempts if a is not best]
        return best, qual(best), int(remapped), retries, True, \
            _burned_cycles(rest)


def _migration_cost(n: int, banks: int, dead: List[int], width: int
                    ) -> Tuple[int, int]:
    """(numbers migrated, re-programming cycles): every number of a dead
    bank is rewritten into a surviving bank, one cycle per bit-plane write
    (the DC binary write of S1; write-verify effort for ML cells is the
    device model's business)."""
    per = -(-n // banks)
    migrated = sum(min(per, max(0, n - b * per)) for b in dead)
    return migrated, migrated * width


# ---------------------------------------------------------------------------
# The "resilient:<engine>" wrapper.
# ---------------------------------------------------------------------------


def make_resilient(inner_name: str) -> EngineSpec:
    """Register (idempotently) and return the ``resilient:<inner_name>``
    engine wrapping an already-registered engine."""
    name = PREFIX + inner_name
    if name in _REGISTRY:
        return _REGISTRY[name]
    if inner_name not in _REGISTRY:
        raise KeyError(f"cannot wrap unknown engine {inner_name!r}")
    inner = _REGISTRY[inner_name]
    register(name, mode=inner.mode, strategy=inner.strategy,
             formats=inner.formats,
             supports_stop_after=inner.supports_stop_after,
             supports_batch=False,
             description=f"verify-and-repair wrapper over {inner_name!r}: "
                         "monotonicity check, then dead-bank remap / "
                         "re-read voting / parity ECC / retries, degrading "
                         "gracefully")(_make_resilient_fn(inner))
    return _REGISTRY[name]


def _make_resilient_fn(inner: EngineSpec):
    def fn(x, *, width, fmt, k, ascending, level_bits, stop_after, device,
           **kw):
        x = np.asarray(x)
        call = dict(width=width, fmt=fmt, k=k, ascending=ascending,
                    level_bits=level_bits, stop_after=stop_after,
                    device=device, **kw)
        ctx = faults.current()
        counters = ctx.counters if ctx else faults.FaultCounters()
        faults0 = counters.faults_injected

        def run(spec: Optional[faults.FaultSpec]) -> SortResult:
            if spec is None:
                return inner.fn(x, **call)
            with faults.inject(spec, counters=counters):
                return inner.fn(x, **call)

        def check(res: SortResult) -> bool:
            return check_sorted(x, res.indices, width=width, fmt=fmt,
                                ascending=ascending)

        def qual(res: SortResult) -> float:
            return emission_quality(x, res.indices, width=width, fmt=fmt,
                                    ascending=ascending)

        def finalize(res, quality, repairs, retries, degraded, extra):
            res.engine = PREFIX + inner.name
            res.quality = float(quality)
            res.faults_injected = counters.faults_injected - faults0
            res.repairs = repairs
            res.retries = retries
            res.degraded = degraded
            res.extra_cycles = extra
            return res

        res = run(None)                # under the ambient spec, if any
        if check(res):
            return finalize(res, 1.0, 0, 0, False, 0)
        if ctx is None:
            # no fault process installed and still wrong: the inner engine
            # itself is broken — report honestly rather than loop
            return finalize(res, qual(res), 0, 0, True, 0)

        base = ctx.spec
        remapped = False
        extra = 0
        if base.dead_banks:
            dead = faults.probe_dead_banks(base)
            if dead:
                _, extra = _migration_cost(x.shape[-1], base.banks, dead,
                                           width)
                base = base.without_dead_banks()
                remapped = True
        best, quality, repairs, retries, degraded, burned = _repair_ladder(
            run, check, qual, base, remapped=remapped, first_attempt=res)
        return finalize(best, quality, repairs, retries, degraded,
                        extra + burned)

    return fn


# ---------------------------------------------------------------------------
# Fault-tolerant multi-bank execution (§2.3.1 + runtime faults.py wiring).
# ---------------------------------------------------------------------------


@register("mb-ft", mode="latency", strategy="mb", supports_stop_after=True,
          description="Fault-tolerant multi-bank CA-TNS: heartbeat "
                      "dead-bank detection, re-map of bit-slices onto "
                      "surviving banks, verify-and-repair for residual bit "
                      "errors")
def _mb_ft(x, *, width, fmt, k, ascending, level_bits, stop_after, device,
           banks=4):
    x = np.asarray(x)
    n = x.shape[-1]
    ctx = faults.current()
    counters = ctx.counters if ctx else faults.FaultCounters()
    faults0 = counters.faults_injected
    spec = ctx.spec if ctx else None

    dead: List[int] = []
    if spec is not None and spec.dead_banks:
        dead = faults.probe_dead_banks(spec, banks=banks)
    surviving = banks - len(dead)
    if surviving <= 0:
        raise RuntimeError(f"mb-ft: all {banks} banks dead")
    migrated, migration_cycles = (
        _migration_cost(n, banks, dead, width) if dead else (0, 0))
    base = spec.without_dead_banks() if (spec and dead) else spec

    def sort_once() -> SortResult:
        """One run on the surviving banks: the multi-bank machine when they
        split the dataset evenly, else the single-array machine, which is
        cycle-identical to it (eq. 2)."""
        use_banks = (x.ndim == 1 and surviving > 1 and stop_after is None
                     and n % surviving == 0)
        call = dict(width=width, k=k, fmt=fmt, ascending=ascending,
                    level_bits=level_bits, device=device)
        if use_banks:
            out = catns.multibank_sort(x, banks=surviving, **call)
        elif x.ndim == 2:
            out = tt.tns_sort_batch(x, stop_after=stop_after, **call)
        else:
            out = tt.tns_sort(x, stop_after=stop_after, **call)
        perm = out.perm.cpu().numpy()
        if stop_after is not None:
            perm = perm[..., :stop_after]
        vals = np.take_along_axis(x, perm, axis=-1)
        host = lambda t: t.cpu().numpy()
        return SortResult(values=vals, indices=perm, engine="mb-ft",
                          fmt=fmt, width=width, n=n,
                          cycles=host(out.cycles), drs=host(out.drs),
                          reload_cycles=host(out.reload_cycles),
                          strategy="mb", k=k, level_bits=level_bits,
                          banks=surviving)

    def run(sp: Optional[faults.FaultSpec]) -> SortResult:
        if sp is None:
            return sort_once()
        with faults.inject(sp, counters=counters):
            return sort_once()

    def check(res: SortResult) -> bool:
        if res.indices.ndim > 1:
            return all(check_sorted(x[b], res.indices[b], width=width,
                                    fmt=fmt, ascending=ascending)
                       for b in range(res.indices.shape[0]))
        return check_sorted(x, res.indices, width=width, fmt=fmt,
                            ascending=ascending)

    def qual(res: SortResult) -> float:
        if res.indices.ndim > 1:
            return float(np.mean([
                emission_quality(x[b], res.indices[b], width=width, fmt=fmt,
                                 ascending=ascending)
                for b in range(res.indices.shape[0])]))
        return emission_quality(x, res.indices, width=width, fmt=fmt,
                                ascending=ascending)

    def finalize(res, quality, repairs, retries, degraded, extra):
        res.quality = float(quality)
        res.faults_injected = counters.faults_injected - faults0
        res.repairs = repairs
        res.retries = retries
        res.degraded = degraded
        res.extra_cycles = extra
        if res.cycles is not None and extra:
            res.cycles = np.asarray(res.cycles) + extra
        return res

    res = run(base if dead else None)
    if check(res):
        return finalize(res, 1.0, int(bool(dead)), 0, False,
                        migration_cycles)
    if spec is None:
        return finalize(res, qual(res), 0, 0, True, 0)
    best, quality, repairs, retries, degraded, burned = _repair_ladder(
        run, check, qual, base if base is not None else faults.FaultSpec(),
        remapped=bool(dead), first_attempt=res)
    return finalize(best, quality, repairs, retries, degraded,
                    migration_cycles + burned)


# Wrap everything registered so far (built-ins + mb-ft).  Engines
# registered later get a wrapper lazily the first time
# "resilient:<name>" is requested from the registry.
for _name in sorted(n for n in _REGISTRY if not n.startswith(PREFIX)):
    make_resilient(_name)
