"""Host time of the result's assembly inside a ``sort()`` call: the
program's ``repro_torch.sort.finish`` ranges (``sort/builtin_engines.py::
_finish``: the values gathered by the permutation, the ``SortResult``) in
the traced slice, summed, over the calls.  Milliseconds."""

SPANS = ("repro_torch.sort.finish",)


def read(t):
    calls = t.counters.get("calls")
    got = [b - a for a, b, name in t.host
           if name in SPANS and t.t0 <= a < t.t1]
    if not calls or not got:
        return None
    return sum(got) / 1e3 / calls
