"""The model's share of the card's bf16 peak over the traced window:
``accounting.model_flops`` (2 x active parameters a token, from the
configuration's own widths) times the tokens the traced window computed,
over the window, over 989 TFLOP/s.  Percent."""
from portbench import peaks


def read(t):
    flops = t.counters.get("model_flops")
    if not flops or t.window_s <= 0:
        return None
    return 100.0 * flops / t.window_s / peaks.BF16_FLOP_PER_S
