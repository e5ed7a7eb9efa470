"""Budget-aware engine dispatch: pick a registry engine per request from
its declared latency/energy/quality budget.

This is the quantity/type-dependent engine choice ADS-IMC argues for and
the hardware-sorting survey's engine taxonomy, run live: for every
candidate engine the dispatcher predicts

* device latency — predicted cycles at the engine's Table-S5 operating
  point (:func:`repro_torch.core.cost.operating_point`), where the
  cycles-per-emission prior is *derived from the published anchors*
  (``f_clk / throughput``) and then corrected by a live EWMA of measured
  cycles from completed work, so mispredicted workload shapes (e.g. TNS
  tree-build cost on tiny top-m requests) steer later dispatches;
* device energy — operating-point power x predicted latency;
* host wall time — EWMA of measured wall microseconds per emission
  (throughput-mode engines have no cycle model; this is their axis);
* emission quality — 1.0 on an ideal array; under an active
  :class:`repro_torch.runtime.faults.FaultSpec` the raw engines are
  discounted by a BER/dead-bank heuristic while ``resilient:*`` /
  ``mb-ft`` wrappers hold verified quality at a cycle premium,

then filters by the request's
:class:`~repro_torch.serving.request.SortBudget` and minimizes its
objective.  Infeasible budgets degrade to the least-violating engine
rather than failing the request.  Where two engines' estimates tie, the
pick goes to the engine whose name in the reference package comes first
(``fused-tns`` is the reference's ``pallas-tns``, ``fused-topk`` its
``pallas-topk``), so both packages pick the same engine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import cost as cost_model
from repro_torch.kernels import autotune, backend, fused_tns
from repro_torch.runtime import faults
from repro_torch.serving.metrics import Ewma
from repro_torch.serving.request import ENERGY, WALL, SortRequest
from repro_torch.sort.builtin_engines import FUSED_TOPK_MAX
from repro_torch.sort.registry import EngineSpec, available_engines

# Engines never dispatched to: the Python event-driven oracle exists to
# cycle-check the machines, not to serve traffic.
EXCLUDED = frozenset({"tns-oracle"})

# Host-wall priors (us per emission) before any measurement lands:
# latency-mode machines step on the host (eager torch), orders of
# magnitude slower than the vectorized throughput engines.
_WALL_PRIOR_US = {"latency": 100.0, "throughput": 1.0}

# The reference package's names of the engines the port renamed.
_REFERENCE_NAME = {"fused-tns": "pallas-tns", "fused-topk": "pallas-topk"}
_RESILIENT = "resilient:"


def reference_name(name: str) -> str:
    """The engine's name in the reference package (``resilient:`` kept):
    the tie-break order of :meth:`Dispatcher.select`."""
    prefix = _RESILIENT if name.startswith(_RESILIENT) else ""
    inner = name[len(prefix):]
    return prefix + _REFERENCE_NAME.get(inner, inner)


def _fused_tns_wall_prior(device=None) -> Optional[float]:
    """us per emission for ``fused-tns`` from the committed autotune
    table (``BENCH_torch_fused_tns.json``), so the dispatcher's first
    estimate reflects the kernel's *measured* cost on this device rather
    than the generic throughput prior.  Median over tuned cells of us
    amortized per emission per instance; None when no cell was tuned on
    this device."""
    suffix = f"|{autotune.device_tag(device)}"
    vals = []
    for key, row in autotune.default_table().items():
        if not key.endswith(suffix):
            continue
        try:
            m, b = (int(part[1:]) for part in key.split("|")[2:4])
            vals.append(float(row["us"]) / max(1, m * b))
        except (KeyError, ValueError, TypeError):
            continue
    if not vals:
        return None
    vals.sort()
    return vals[len(vals) // 2]


# Repair-ladder cycle premium assumed for resilient wrappers under an
# active fault process until the EWMA has real measurements.
_RESILIENT_PREMIUM = 2.0


@dataclasses.dataclass(frozen=True)
class Estimate:
    """Predicted cost of one engine for one request."""
    engine: str
    latency_us: float
    energy_nj: Optional[float]       # None: no device power model
    wall_us: float
    quality: float
    cycles: Optional[float]          # None: throughput-mode engine
    freq_hz: Optional[float]

    def axis(self, objective: str) -> float:
        if objective == ENERGY:
            return self.energy_nj if self.energy_nj is not None \
                else float("inf")
        if objective == WALL:
            return self.wall_us
        return self.latency_us


@dataclasses.dataclass(frozen=True)
class Dispatch:
    engine: str
    estimate: Estimate
    feasible: bool
    reason: str                      # "ok" | "best-effort"


def _strategy_banks(spec: EngineSpec) -> int:
    # the mb anchor is the 2-bank point (builtin default); mb-ft defaults
    # to a 4-bank layout
    if spec.name == "mb-ft":
        return 4
    return 2 if spec.strategy == "mb" else 1


def _anchor_cycles_per_number() -> Dict[str, float]:
    """cycles/number at the published anchors: f_clk / throughput."""
    pub = cost_model.table_s5_published()
    return {s: row["freq"] / (row["thpt"] * 1e6)
            for s, row in sorted(pub.items()) if s in cost_model.TABLE_S5}


class Dispatcher:
    """Per-request engine selection with live EWMA correction.
    ``device`` (``None``: the card) picks the autotune table's rows that
    give the ``fused-tns`` wall prior."""

    def __init__(self, *, ewma_alpha: float = 0.3, lifo_k: int = 4,
                 throughput_elem_us: float = 0.005, device=None):
        self.device = backend.resolve_device(device)
        self.lifo_k = lifo_k
        # deterministic device-time stand-in for throughput-mode engines
        # (they have no cycle model; this keeps the simulated clock and
        # their latency estimates in one deterministic domain)
        self.throughput_elem_us = throughput_elem_us
        self._anchor_cpn = _anchor_cycles_per_number()
        self._fused_tns_prior = _fused_tns_wall_prior(self.device)
        self._cpe: Dict[str, Ewma] = {}      # cycles per emission
        self._wpe: Dict[str, Ewma] = {}      # wall us per emission
        self._qual: Dict[str, Ewma] = {}     # observed emission quality
        self._alpha = ewma_alpha

    # -- live measurement feedback -----------------------------------------

    def observe(self, engine: str, *, emissions: int,
                cycles: Optional[float] = None,
                wall_us: Optional[float] = None,
                quality: Optional[float] = None) -> None:
        """Fold one completed step's measurements into the EWMAs."""
        if emissions <= 0:
            return
        if cycles is not None:
            self._ewma(self._cpe, engine).update(cycles / emissions)
        if wall_us is not None:
            self._ewma(self._wpe, engine).update(wall_us / emissions)
        if quality is not None:
            self._ewma(self._qual, engine).update(quality)

    def _ewma(self, table: Dict[str, Ewma], engine: str) -> Ewma:
        if engine not in table:
            table[engine] = Ewma(self._alpha)
        return table[engine]

    # -- prediction --------------------------------------------------------

    def _fault_spec(self) -> Optional[faults.FaultSpec]:
        ctx = faults.current()
        if ctx is not None and ctx.spec.faulty:
            return ctx.spec
        return None

    def _quality_estimate(self, name: str, spec: EngineSpec,
                          width: int) -> float:
        """Expected emission quality; the EWMA overrides the prior once
        real outcomes exist."""
        measured = self._qual.get(name)
        if measured is not None and measured.value is not None:
            return measured.value
        fspec = self._fault_spec()
        if fspec is None:
            return 1.0
        resilient = name.startswith("resilient:") or name == "mb-ft"
        if resilient:
            # verified unless the BER passes the repair ladder's edge
            return 1.0 if fspec.ber <= 0.1 else 0.8
        clean_bit = (1.0 - fspec.ber) * \
            (1.0 - fspec.stuck_zero - fspec.stuck_one)
        q = max(0.0, clean_bit) ** width
        dead = [b for b in fspec.dead_banks if 0 <= b < fspec.banks]
        if dead:
            q *= 1.0 - len(dead) / fspec.banks
        return q

    def _predicted_cycles(self, name: str, spec: EngineSpec,
                          req: SortRequest, width: int) -> Optional[float]:
        if spec.strategy is None:
            return None
        cpe = self._cpe.get(name)
        per_emission = cpe.value if cpe is not None and cpe.value is not None \
            else self._anchor_cpn[spec.strategy] * (width / 32.0)
        # the bit-slice pipeline drains fully regardless of stop_after;
        # everything else stops after the requested emissions
        emissions = req.n if spec.strategy == "bs" else req.target
        cycles = per_emission * emissions
        if (name.startswith("resilient:") or name == "mb-ft") \
                and self._fault_spec() is not None \
                and (cpe is None or cpe.value is None):
            cycles *= _RESILIENT_PREMIUM
        return cycles

    def estimate(self, name: str, spec: EngineSpec,
                 req: SortRequest) -> Estimate:
        fmt, width = req.fmt_width
        cycles = self._predicted_cycles(name, spec, req, width)
        freq = None
        if cycles is not None:
            point = cost_model.operating_point(
                spec.strategy, n=req.n, w=width, k=self.lifo_k,
                level_bits=4 if spec.strategy == "ml" else 1,
                banks=_strategy_banks(spec))
            freq = point.freq_hz
            latency_us = cycles / freq * 1e6
            energy_nj = point.power_w * (latency_us * 1e-6) * 1e9
        else:
            latency_us = req.target * self.throughput_elem_us
            energy_nj = None
        wpe = self._wpe.get(name)
        if wpe is not None and wpe.value is not None:
            wall_per = wpe.value
        elif name == "fused-tns" and self._fused_tns_prior is not None:
            wall_per = self._fused_tns_prior
        else:
            wall_per = _WALL_PRIOR_US[spec.mode]
        return Estimate(engine=name, latency_us=latency_us,
                        energy_nj=energy_nj,
                        wall_us=wall_per * req.target,
                        quality=self._quality_estimate(name, spec, width),
                        cycles=cycles, freq_hz=freq)

    # -- candidate filtering + selection -----------------------------------

    def candidates(self, req: SortRequest) -> List[str]:
        fmt, _ = req.fmt_width
        fault_active = self._fault_spec() is not None
        names = []
        for name, spec in sorted(available_engines().items(),
                                 key=lambda kv: reference_name(kv[0])):
            if name in EXCLUDED:
                continue
            resilient = name.startswith("resilient:") or name == "mb-ft"
            if resilient and not fault_active:
                continue   # pure verification overhead on an ideal array
            if fault_active and spec.strategy is None:
                # throughput engines bypass the bit-plane read path, so
                # they cannot model serving from a faulted array
                continue
            if resilient and name.startswith("resilient:") \
                    and name[len("resilient:"):] in EXCLUDED:
                continue
            if fmt not in spec.formats:
                continue
            if name.endswith("bitslice") and not req.ascending:
                continue
            if req.target < req.n and not spec.supports_stop_after:
                continue
            if name.endswith("fused-topk") and \
                    (req.m is None or req.target > FUSED_TOPK_MAX):
                continue
            if name.endswith("fused-tns") and \
                    req.fmt_width[1] > fused_tns.MAX_WIDTH:
                continue   # digit keys are packed into int32 words
            names.append(name)
        return names

    def select(self, req: SortRequest) -> Dispatch:
        """Pick the engine for ``req``: feasible under the budget and best
        on its objective, else the least-violating one (best effort)."""
        budget = req.budget
        cands = self.candidates(req)
        if not cands:
            raise ValueError(
                f"request {req.rid}: no engine serves fmt/width "
                f"{req.fmt_width} with m={req.m} (registry exhausted)")
        ests = {n: self.estimate(n, available_engines()[n], req)
                for n in cands}

        def violation(e: Estimate) -> float:
            v = 0.0
            if budget.max_latency_us is not None and \
                    e.latency_us > budget.max_latency_us:
                v = max(v, e.latency_us / budget.max_latency_us - 1.0)
            if budget.max_energy_nj is not None:
                if e.energy_nj is None:
                    v = max(v, float("inf"))
                elif e.energy_nj > budget.max_energy_nj:
                    v = max(v, e.energy_nj / budget.max_energy_nj - 1.0)
            if e.quality < budget.quality_floor:
                v = max(v, budget.quality_floor - e.quality)
            return v

        feasible = [n for n in cands if violation(ests[n]) == 0.0]
        if feasible:
            pick = min(feasible,
                       key=lambda n: (ests[n].axis(budget.objective),
                                      reference_name(n)))
            return Dispatch(pick, ests[pick], True, "ok")
        pick = min(cands, key=lambda n: (violation(ests[n]),
                                         ests[n].axis(budget.objective),
                                         reference_name(n)))
        return Dispatch(pick, ests[pick], False, "best-effort")

    # -- clock support -----------------------------------------------------

    def step_time_us(self, engine: str, cycles: Optional[float],
                     emissions: int, n: int) -> float:
        """Device time one step costs on the simulated clock: measured
        cycles at the operating point for latency engines, the
        deterministic stand-in rate for throughput engines."""
        spec = available_engines()[engine]
        if cycles is not None and spec.strategy is not None:
            point = cost_model.operating_point(
                spec.strategy, n=n, k=self.lifo_k,
                level_bits=4 if spec.strategy == "ml" else 1,
                banks=_strategy_banks(spec))
            return float(cycles) / point.freq_hz * 1e6
        return emissions * self.throughput_elem_us
