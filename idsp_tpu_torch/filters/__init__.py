"""Filters of the port: DF1 biquads, half-band, CIC, lowpass, PLL,
lock-in, and the kernels over them."""
