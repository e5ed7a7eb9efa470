"""Device time of the MoE einsum dispatch a prefill round: the stream time
inside the program's ``moe.dispatch`` spans (``models/moe.py::
_einsum_dispatch``, one a layer: the one-hot cumsum of the slots, the
dispatch and combine tensors, the tokens gathered into the expert
buffers), from ``repro_torch.runtime.spans.report()``, over the traced
rounds.  Milliseconds."""

SPAN = "moe.dispatch"


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
