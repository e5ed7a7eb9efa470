"""Device time of the attention a decode step: the stream time inside the
program's ``attn`` spans (``models/layers.py::apply_attn``, one a layer: the
projections, RoPE, the cache write and read, the score and value
products), from ``repro_torch.runtime.spans.report()``, over the traced
steps.  Milliseconds."""

SPAN = "attn"


def read(t):
    steps = t.counters.get("steps")
    n = sum(1 for a, _, name in t.host
            if name == "repro_torch." + SPAN and t.t0 <= a < t.t1)
    if not steps or not n:
        return None
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    s = spans.report()["spans"].get(SPAN)
    if not s or s["device_ms"] is None:
        return None
    # the registry sums every profiled run of the process: its mean a
    # call, times this slice's calls
    return s["device_ms"] / s["calls"] * n / steps
