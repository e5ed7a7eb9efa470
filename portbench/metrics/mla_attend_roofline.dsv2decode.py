"""The latent attention's share of the HBM roofline: the bytes any form of
it must read, each attended cache position's latent and RoPE key (576 bf16
values a layer; ``accounting_mla.attend_bytes``, counted by the driver from
its schedule), over 3.35 TB/s, over the device time of the kernels launched
inside the program's ``mla.attend`` spans (``models/layers.py::apply_mla``:
``q_lat`` through the value up-projection; ``portbench/span_kernels.py``),
both over the cell's eager slice.  Percent."""
from portbench import peaks, span_kernels


def read(t):
    need = t.counters.get("mla_attend_bytes")
    ms = span_kernels.ms(t, "mla.attend") if need else None
    if not ms:
        return None
    return 100.0 * need / peaks.HBM_BYTES_PER_S / (ms / 1e3)
