"""Share of the held experts' buffer slots that carry a routed token in
decode: the program's counter ``moe.assignments_held`` (tokens times top-k
times the held share of the experts, from shapes: what the held experts
receive on average) over ``moe.slots`` (held experts times capacity slots a
call, every one of which the expert products run over), both over the
cell's eager slice.  %."""
from portbench import span_kernels


def read(t):
    slots = span_kernels.counter(t, "moe.slots")
    held = span_kernels.counter(t, "moe.assignments_held")
    if not slots or held is None:
        return None
    return 100.0 * held / slots
