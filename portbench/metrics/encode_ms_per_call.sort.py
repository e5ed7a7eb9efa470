"""Host time of the encode inside a ``sort()`` call: the program's
``repro_torch.sort.encode`` ranges (``kernels/fused_tns.py::
fused_tns_sort``: the bit-planes, their read and the digit cast, in numpy)
in the traced slice, summed, over the calls.  Milliseconds."""

SPANS = ("repro_torch.sort.encode",)


def read(t):
    calls = t.counters.get("calls")
    got = [b - a for a, b, name in t.host
           if name in SPANS and t.t0 <= a < t.t1]
    if not calls or not got:
        return None
    return sum(got) / 1e3 / calls
