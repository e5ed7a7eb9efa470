"""Device time a decode step of the held experts' products
(``models/moe.py::_experts``, the GLU over every capacity slot of the 20
held experts' buffers): the kernels launched inside the program's
``moe.experts`` spans, each by its own duration
(``portbench/span_kernels.py``), over the steps of the cell's eager
slice.  Milliseconds."""
from portbench import span_kernels


def read(t):
    return span_kernels.per_step(t, "moe.experts")
