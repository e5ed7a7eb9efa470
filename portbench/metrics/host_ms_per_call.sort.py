"""Host time of a ``sort()`` call: the stretches inside the harness's
spans around ``repro_torch.sort.sort`` in which the device ran nothing
(the facade, the host encode, the copies' waits, the result's assembly),
summed and divided by the calls.  Milliseconds."""


def read(t):
    spans = t.spans_named("sort")
    if not spans:
        return None
    return sum(t.idle_in(a, b) for a, b in spans) / len(spans) / 1e3
