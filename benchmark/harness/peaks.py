"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), at its 700 W
power limit: the HBM bandwidth from NVIDIA's data sheet, and the INT32
issue rate from the Hopper architecture (132 SMs x 64 INT32 lanes a clock
at the 1,980 MHz boost clock)."""

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.980e9
