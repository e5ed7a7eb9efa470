"""The program's spans (``repro_torch.runtime.spans``) charged with the
device work they launched: each kernel, copy or fill the profiler links
to the host op that launched it (by its correlation id) counts, with its
own duration, toward every ``repro_torch.<span>`` range that encloses
that op.  So a span's figure is the device time of its own work, whether
the host ran ahead of the device or behind it; idle stretches and other
spans' work in between count nothing.

The latent-attention cells' traced run takes it from a profiled slice of
eager steps (``drivers/lm_mla.py``); their readers
(``metrics/*.dsv2decode.py``) read it from the trace's counters, each
None where the slice charged nothing to the span (the CPU, or a program
without the span)."""
from __future__ import annotations

from typing import Dict, Optional

PREFIX = "repro_torch."


def charge(events) -> Dict[str, float]:
    """{span: device ms} over the profiler's events (``prof.events()``):
    the durations of the device events linked to each host op, summed
    into every program span among the op and its ancestors."""
    out: Dict[str, float] = {}
    for e in events:
        if not e.kernels:
            continue
        us = sum(k.duration for k in e.kernels)
        p = e
        while p is not None:
            if p.name.startswith(PREFIX):
                name = p.name[len(PREFIX):]
                out[name] = out.get(name, 0.0) + us / 1e3
            p = p.cpu_parent
    return out


def ms(t, span: str) -> Optional[float]:
    """Device ms charged to ``span`` in the cell's eager slice."""
    got = t.counters.get("eager_span_ms") or {}
    return got.get(span) or None


def per_step(t, span: str) -> Optional[float]:
    """Device ms charged to ``span`` a step of the eager slice."""
    steps = t.counters.get("eager_steps")
    got = ms(t, span) if steps else None
    return None if got is None else got / steps


def counter(t, name: str) -> Optional[int]:
    """The program's counter ``name`` over the eager slice."""
    return (t.counters.get("eager_counters") or {}).get(name)
