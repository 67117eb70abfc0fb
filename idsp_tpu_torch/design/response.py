"""Frequency-response evaluation on the unit circle (a copy of
`idsp_tpu.design.response`).

Equivalent of reference src/iir/response.rs: polynomial evaluation of
``H(z) = B(z^-1)/A(z^-1)`` at ``z = exp(-j 2 pi f)`` with the cookbook
sign convention; `freqz_ba5` adapts the internal ``[b0,b1,b2,a1,a2]``
recurrence convention (biquad.rs:96-116: stored a1/a2 are negated
literature values over 1<<F or 1.0).
"""

from __future__ import annotations

import numpy as np


def freqz(b, a, frequency):
    """H at z = exp(-j*2*pi*frequency); `frequency` relative to fs.

    Vectorized over `frequency` (response.rs:28-40).
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    f = np.asarray(frequency, dtype=np.float64)
    z = np.exp(-2j * np.pi * f)
    num = np.polynomial.polynomial.polyval(z, b)
    den = np.polynomial.polynomial.polyval(z, a)
    return num * np.conj(den) / (den.real**2 + den.imag**2)


def freqz_ba5(ba5, frequency, *, f_shift: int | None = None):
    """Response of internal `[b0,b1,b2,a1,a2]` coefficients
    (response.rs:40-46).  For fixed point pass `f_shift` = F so the
    implicit `1<<F` a0 is accounted for."""
    ba5 = np.asarray(ba5, dtype=np.float64)
    if f_shift is not None:
        ba5 = ba5 / float(1 << f_shift)
    b = ba5[..., :3]
    a = np.stack(
        [np.ones_like(ba5[..., 0]), -ba5[..., 3], -ba5[..., 4]], axis=-1
    )
    return freqz(b, a, frequency)
