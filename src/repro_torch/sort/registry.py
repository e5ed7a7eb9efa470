"""Engine registry of the port: every sorting strategy registers one
callable behind a shared contract, and :func:`repro_torch.sort.sort`
dispatches by name.  This registry is the port's own; nothing here touches
the reference package's registry.

Engine contract (what ``repro_torch.analysis.trace_gate`` binds every
engine against)::

    fn(x, *, width, fmt, k, ascending, level_bits, stop_after, device)
        -> SortResult

``x`` is a host ndarray, shape (N,) or (B, N) when the engine declares
``supports_batch``; ``device`` is the resolved ``torch.device`` the engine
runs its kernels on.  An engine may take further keyword knobs of its own
(``ideal_lifo``, ``banks``, ``r``, ``slice_widths``), each by name, and
no ``**kw``: an unknown knob raises ``TypeError`` (a ``resilient:``
wrapper passes its knobs on to the engine it wraps, which raises).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import bitplane as bp

ALL_FORMATS = (bp.UNSIGNED, bp.TWOS, bp.SIGNMAG, bp.FLOAT)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    name: str
    fn: Callable
    mode: str                       # "latency" | "throughput"
    strategy: Optional[str]         # cost-model anchor key (Table S5) | None
    formats: Tuple[str, ...] = ALL_FORMATS
    supports_stop_after: bool = False
    supports_batch: bool = False
    description: str = ""

    @property
    def latency_mode(self) -> bool:
        return self.mode == "latency"


_REGISTRY: Dict[str, EngineSpec] = {}


def register(name: str, *, mode: str, strategy: Optional[str] = None,
             formats: Tuple[str, ...] = ALL_FORMATS,
             supports_stop_after: bool = False,
             supports_batch: bool = False, description: str = ""):
    """Decorator: register an engine under ``name``.  Re-registering a name
    replaces it."""
    if mode not in ("latency", "throughput"):
        raise ValueError(f"mode must be 'latency' or 'throughput', "
                         f"got {mode!r}")

    def deco(fn):
        _REGISTRY[name] = EngineSpec(
            name=name, fn=fn, mode=mode, strategy=strategy,
            formats=tuple(formats),
            supports_stop_after=supports_stop_after,
            supports_batch=supports_batch, description=description)
        return fn

    return deco


def get_engine(name: str) -> EngineSpec:
    _ensure_builtin()
    if name not in _REGISTRY and name.startswith("resilient:"):
        # engines registered after repro_torch.sort.resilient was imported
        # get their verify-and-repair wrapper built on first request
        inner = name[len("resilient:"):]
        if inner in _REGISTRY:
            from repro_torch.sort.resilient import make_resilient
            return make_resilient(inner)
    if name not in _REGISTRY:
        raise KeyError(f"unknown sort engine {name!r}; "
                       f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_engines() -> Dict[str, EngineSpec]:
    """name -> spec for every registered engine (built-ins included)."""
    _ensure_builtin()
    return dict(_REGISTRY)


def _ensure_builtin() -> None:
    # importing the module registers the built-in engines (deferred to
    # avoid a cycle at package import time); repro_torch.sort.resilient
    # then wraps each of them (and adds "mb-ft")
    import repro_torch.sort.builtin_engines  # noqa: F401
    import repro_torch.sort.resilient  # noqa: F401
