"""Share of the latent cache's positions that the decode steps' attention
reads and that hold a token: the attended positions of the cell's eager
slice (each row's filled length, every MLA layer; counted by the driver
from its schedule) over the program's counter ``mla.cache_slots`` (B x S
of the cache a cached MLA call reads, from shapes) in that slice.  %."""
from portbench import span_kernels


def read(t):
    filled = t.counters.get("mla_attended_slots")
    slots = span_kernels.counter(t, "mla.cache_slots")
    if not filled or not slots:
        return None
    return 100.0 * filled / slots
