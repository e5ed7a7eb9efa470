"""The port's spans and counters, on the profiler's clock.

::

    from torch.profiler import profile, ProfilerActivity
    from repro_torch.runtime import spans

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = sort.sort(x, engine="fused-tns", k=2)
    spans.report()["spans"]["sort.encode"]   # calls, host / device ms, parent

A span marks a stretch of the port's work, named by its layer
(``sort.encode``, ``attn``, ``moe.experts``, ``sample``, ...); a counter
adds an integer the work computes from shapes (``moe.slots``).  Both are
on exactly while a ``torch.profiler`` profile records, and cost one
attribute read otherwise: ``span`` returns one shared null context and
``count`` returns.

While a profile records, a span opens a host range named
``repro_torch.<name>`` as a CPU op (``_RecordFunctionFast``, not a user
annotation, so the profiler puts nothing of it on the device's timeline),
times itself on the host clock, and, where ``where`` is a CUDA tensor or
device, records a pair of timing events on that device's current stream.
It never synchronises, reads a device value or launches a kernel.  The
event pairs are kept until :func:`report` resolves them, synchronising
once.  The registry holds only what was recorded while a profile ran,
summed since the last :func:`reset`.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()          # each thread's open spans, innermost last
_stats: Dict[str, list] = {}        # name -> [calls, host ns, self ns, parent]
_pending: List[tuple] = []          # (name, device, start event, end event)
_device_ms: Dict[str, float] = {}   # name -> resolved device ms
_counts: Dict[str, int] = {}


def _cuda_device(where) -> Optional[torch.device]:
    if isinstance(where, torch.Tensor):
        return where.device if where.is_cuda else None
    if where is None:
        return None
    dev = torch.device(where)
    return dev if dev.type == "cuda" else None


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event(stream) -> "torch.cuda.Event":
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "dev", "stream", "rf", "start", "t0", "child")

    def __init__(self, name: str, where):
        self.name, self.dev = name, _cuda_device(where)

    def __enter__(self):
        self.rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.rf.__enter__()
        _open().append(self)
        self.child = 0
        self.start = None
        if self.dev is not None:
            self.stream = torch.cuda.current_stream(self.dev)
            self.start = _event(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter_ns() - self.t0
        end = None
        if self.start is not None:
            end = _event(self.stream)
        stack = _open()
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child += host
        with _lock:
            s = _stats.setdefault(
                self.name, [0, 0, 0, parent.name if parent else None])
            s[0] += 1
            s[1] += host
            s[2] += host - self.child
            if end is not None:
                _pending.append((self.name, self.dev, self.start, end))
        self.rf.__exit__(*exc)
        return False


def span(name: str, where=None):
    """A context over the port's work named ``name``: the shared null
    context unless a profile records.  ``where`` (a tensor or a device)
    names the device the work runs on; on a CUDA one the span also takes
    the work's device time."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, where)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a profile records."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + int(n)


def report() -> Dict:
    """``{"spans": {name: {"calls", "host_ms", "host_self_ms",
    "device_ms", "parent"}}, "counters": {name: n}}`` over what was
    recorded since the last :func:`reset`.  Host ms run from a span's
    entry to its exit on the host clock; self ms leave out the child
    spans' stretches; device ms are the stream time between each call's
    two events (None for a span that recorded none: host work, or the
    CPU); ``parent`` is the span that enclosed the first call."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
    for dev in {d for _, d, _, _ in pending}:
        torch.cuda.synchronize(dev)
    with _lock:
        for name, _, a, b in pending:
            _device_ms[name] = _device_ms.get(name, 0.0) + a.elapsed_time(b)
        return {"spans": {n: {"calls": c, "host_ms": h / 1e6,
                              "host_self_ms": s / 1e6,
                              "device_ms": _device_ms.get(n), "parent": p}
                          for n, (c, h, s, p) in _stats.items()},
                "counters": dict(_counts)}


def reset() -> None:
    """Empty the registry; a span open across the reset is recorded when
    it closes."""
    with _lock:
        _stats.clear()
        _pending.clear()
        _device_ms.clear()
        _counts.clear()
