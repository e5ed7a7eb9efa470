"""Host time of the copies inside a ``sort()`` call: the program's
``repro_torch.sort.h2d`` ranges (the planes' pageable copy to the card) and
``repro_torch.sort.d2h`` ranges (the permutation and counters back,
waiting for the kernel first) in the traced slice, summed, over the
calls.  Milliseconds."""

SPANS = ("repro_torch.sort.h2d", "repro_torch.sort.d2h")


def read(t):
    calls = t.counters.get("calls")
    got = [b - a for a, b, name in t.host
           if name in SPANS and t.t0 <= a < t.t1]
    if not calls or not got:
        return None
    return sum(got) / 1e3 / calls
