"""Kernel launches a decode step: the kernels the profiler saw in the
traced steps (copies and fills not counted), over the steps."""


def read(t):
    steps = t.counters.get("steps")
    ks = t.kernels()
    if not steps or not ks:
        return None
    return len(ks) / steps
