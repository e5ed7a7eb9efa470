"""This card's share of the model over the traced window, as a share of
the card's bf16 peak: ``accounting_mla.model_flops`` (2 x the active
parameters of the card's share a token, from the configuration's own
widths, plus the attention's products over the attended positions at the
model's expanded widths) of the tokens the traced steps computed (replays
of the step's CUDA graphs, as in the timed window), over the window, over
989 TFLOP/s.  Percent."""
from portbench import peaks


def read(t):
    flops = t.counters.get("model_flops")
    if not flops or t.window_s <= 0:
        return None
    return 100.0 * flops / t.window_s / peaks.BF16_FLOP_PER_S
