"""Share of the expert buffers' slots that carry a routed token in decode:
the program's counters ``moe.assignments`` (tokens times top-k a MoE
call) over ``moe.slots`` (experts times capacity slots a call, every one
of which the expert products run over), from
``repro_torch.runtime.spans.report()``, each summed over the traced
steps.  %."""


def read(t):
    if not any(name == "repro_torch.moe" and t.t0 <= a < t.t1
               for a, _, name in t.host):
        return None
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    c = spans.report()["counters"]
    slots, routed = c.get("moe.slots"), c.get("moe.assignments")
    if not slots or routed is None:
        return None
    return 100.0 * routed / slots
