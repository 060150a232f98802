"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit).  A share of a peak is
taken against these numbers, never against a ceiling measured on the card
at hand, so that it reads the same on every card."""

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
