"""Device time a decode step of the MoE routers (``models/moe.py::route``,
one a MoE layer: the float32 logits over all 160 experts, the two
selections through the SIM top-k, the top 3 of 8 groups and the top 6 of
the experts left, and the gates): the kernels launched inside the
program's ``moe.route`` spans, each by its own duration
(``portbench/span_kernels.py``), over the steps of the cell's eager
slice.  Milliseconds."""
from portbench import span_kernels


def read(t):
    return span_kernels.per_step(t, "moe.route")
