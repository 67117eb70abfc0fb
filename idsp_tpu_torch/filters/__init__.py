"""Filters of the DDC chain: DF1 biquad, half-band decimators, kernels."""
