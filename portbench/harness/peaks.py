"""Published peaks of one NVIDIA H100 SXM5 (data sheet, 700 W, dense
rates without sparsity). Rooflines and mfu are stated against these,
with the card's name and power limit printed beside every run."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
