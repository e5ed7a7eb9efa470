"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the denominators of every roofline and MFU share."""

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
