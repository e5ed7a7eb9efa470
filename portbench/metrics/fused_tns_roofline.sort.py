"""The fused TNS kernel's share of its roofline: the least time the
card's bandwidth allows for the bytes a call needs
(``accounting.tns_call_bytes``: the digit planes in at one bit a digit,
the permutation and the per-bank counters out, each once), over the
kernel's device time per call by name.  Percent, against 3.35 TB/s.
There is no operation bound: the controller's work is not arithmetic."""
from portbench import accounting, peaks


def read(t):
    ks = t.kernels("fused_tns_kernel")
    c = t.counters
    if not ks or not c.get("calls"):
        return None
    per_call_s = sum(b - a for a, b, _ in ks) / 1e6 / c["calls"]
    need = accounting.tns_call_bytes(c["banks"], c["n"], c["width"])
    return 100.0 * need / peaks.HBM_BYTES_PER_S / per_call_s
