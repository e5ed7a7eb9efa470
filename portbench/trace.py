"""The harness's spans and the profiler's device trace, reduced to what
the per-layer readers (``metrics/<name>.py``) take.

Spans are ``torch.profiler.record_function`` ranges named ``portbench.*``
that the drivers open around their calls into the program; they cost
nothing when the run is not traced.  Device activity is every CUDA event
of the profiler (kernels, copies, fills); a launch is a kernel.  Times
are in microseconds, on the profiler's one clock.
"""
from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
WINDOW = "portbench.window"


class Spans:
    """Opens the drivers' spans: profiler ranges when tracing, else none."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"portbench.{name}")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _covered(merged, a: float, b: float) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


class Trace:
    """One traced slice of a run: device events, the harness's spans, the
    host ops, and the cell's counters."""

    def __init__(self, device: List[Tuple[float, float, str]],
                 spans: List[Tuple[str, float, float]],
                 host: List[Tuple[float, float, str]], counters: Dict):
        self.device = device
        self.spans = spans
        self.host = host
        self.counters = counters
        win = [s for s in spans if s[0] == WINDOW]
        if not win:
            raise RuntimeError("the traced slice has no window span")
        self.t0, self.t1 = win[0][1], win[0][2]
        inside = [(max(a, self.t0), min(b, self.t1))
                  for a, b, _ in device if b > self.t0 and a < self.t1]
        self.busy = _union(inside)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernels(self, *names: str) -> List[Tuple[float, float, str]]:
        """Kernels (not copies or fills) inside the window, those whose
        name holds one of ``names`` when names are given."""
        return [e for e in self.device
                if self.t0 <= e[0] < self.t1
                and not e[2].startswith(("Memcpy", "Memset"))
                and (not names or any(n in e[2] for n in names))]

    def spans_named(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for n, a, b in self.spans
                if n == f"portbench.{name}"]

    def idle_in(self, a: float, b: float) -> float:
        """Microseconds of [a, b] in which nothing ran on the device."""
        return (b - a) - _covered(self.busy, a, b)

    def idle_share_pct(self) -> Optional[float]:
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> Dict:
        """The ten device operations that took most time, and the ten
        longest idle stretches summed by the innermost host op (or span)
        that was running at their middle."""
        by_op: Dict[str, float] = {}
        for a, b, name in self.device:
            if self.t0 <= a < self.t1:
                by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
        idle = []
        edge = self.t0
        for a, b in self.busy + [(self.t1, self.t1)]:
            if a > edge:
                idle.append(((a + edge) / 2, (a - edge) / 1e6))
            edge = max(edge, b)
        # one sweep over host ops by start time with a stack of the open
        # ones: at an idle stretch's middle, the top of the stack is the
        # innermost op still running
        points = sorted([(x, 0, y, n) for x, y, n in self.host
                         if n != WINDOW] +
                        [(m, 1, s, "") for m, s in idle])
        stack: List[Tuple[float, str]] = []
        gaps: Dict[str, float] = {}
        for t, is_gap, val, name in points:
            while stack and stack[-1][0] < t:
                stack.pop()
            if is_gap:
                key = stack[-1][1] if stack else "(no host op)"
                gaps[key] = gaps.get(key, 0.0) + val
            else:
                stack.append((val, name))
        top = lambda d: [[k[:120], v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def from_profiler(prof, counters: Dict) -> Trace:
    from torch.autograd import DeviceType
    device, spans, host = [], [], []
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # a span's annotation on the device's timeline is no work
            if not e.name.startswith("portbench."):
                device.append((a, b, e.name))
        else:
            host.append((a, b, e.name))
            if e.name.startswith("portbench."):
                spans.append((e.name, a, b))
    return Trace(sorted(device), spans, host, counters)


def load_reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``'s
    ``read(trace) -> float or None``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
