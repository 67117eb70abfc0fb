"""Filters of the port: DF1 biquads, half-band, CIC, lowpass, PLL,
lock-in, the structures beside the biquad (SVF, normal form, RPLL, WDF),
and the kernels over them."""
