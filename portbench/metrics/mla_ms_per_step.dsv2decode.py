"""Device time a decode step of the MLA layers
(``models/layers.py::apply_mla``, one a layer: the query and latent
projections, YaRN RoPE, the cache write, the attention, the output
projection): the kernels launched inside the program's ``mla`` spans,
each by its own duration (``portbench/span_kernels.py``), over the steps
of the cell's eager slice.  Milliseconds."""
from portbench import span_kernels


def read(t):
    return span_kernels.per_step(t, "mla")
