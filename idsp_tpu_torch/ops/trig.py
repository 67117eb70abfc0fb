"""Fixed-point `cossin` (DDS/NCO) and `atan2`, port of
`idsp_tpu.ops.trig.cossin` and `.atan2`.

The octant-folded midpoint-LUT DDS of reference src/cossin.rs:14-67:
7-bit LUT with first-order interpolation, bit-exact with the reference.
The LUT access is a plain gather (``lut[idx]``); the TPU's select-chain
lookup was a workaround for slow TPU gathers and is not ported.  The
arithmetic runs in int64 and is wrapped to int32 at the end.

`atan2` is the reciprocal-LUT divider and odd-polynomial arctangent of
reference src/atan2.rs:6-82, bit-exact with the JAX package's gather
lookup; u32/u64 arithmetic runs in int64 with explicit masks.

Phase convention: 32-bit wrapping phase, i32::MIN = -pi.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import luts
from ..fxp import wrap32, wrap_i32

_ALIGN_MSB = 32 - 16 - 1  # 15: 16+1 bits cos/sin, 15 bits dphi
# Fixed point pi/4 in Q16, truncated like Rust's `as` cast (cossin.rs:39).
_PI4 = int(np.float64(np.pi / 4) * (1 << 16))


def cossin(phase: torch.Tensor):
    """(cos, sin) of an int32 phase tensor (any shape), int32 amplitude
    ~(1<<31 - 1<<15)."""
    depth = luts.COSSIN_DEPTH
    lut = torch.as_tensor(
        luts.cossin_table().astype(np.int64), device=phase.device
    )
    ph = phase.to(torch.int64)
    octant = ph & 0xFFFFFFFF  # the u32 bit pattern
    # Fold octants with phase inversion: phase = !phase when bit 29 set.
    ph = torch.where((octant & (1 << 29)) != 0, ~ph, ph)

    # Strip the octant bits, align the in-octant angle to
    # DEPTH + ALIGN_MSB bits (the u32 ``(p << 3) >> 10``).
    p = ((ph & 0x1FFFFFFF) << 3) >> (32 - depth - _ALIGN_MSB)
    idx = p >> _ALIGN_MSB
    p = p & ((1 << _ALIGN_MSB) - 1)
    # LUT entries are midpoint samples: interpolate about the midpoint.
    p = p - (1 << (_ALIGN_MSB - 1))
    dphi = (p * _PI4) >> 16

    packed = lut[idx]
    # Unpack the excess-encoded cos (extra bit: 1/2 < cos <= 1) and sin.
    cos = (packed & 0xFFFF) + (1 << 16)
    sin = packed >> 16

    dcos = (sin * dphi) >> depth
    dsin = (cos * dphi) >> (depth + 1)
    cos = (cos << (_ALIGN_MSB - 1)) - dcos
    sin = (sin << _ALIGN_MSB) + dsin

    # Unmap octants (gray-ish decode of the top three bits).
    octant = octant ^ (octant >> 1)
    swap = (octant & (1 << 29)) != 0
    cos, sin = torch.where(swap, sin, cos), torch.where(swap, cos, sin)
    cos = torch.where((octant & (1 << 30)) != 0, -cos, cos)
    sin = torch.where((octant & (1 << 31)) != 0, -sin, sin)
    return wrap_i32(cos), wrap_i32(sin)


# --- atan2 ------------------------------------------------------------------

_M32 = 0xFFFFFFFF
# 11th-order odd minimax polynomial for atan on the first octant, Q32<32>
# bit patterns (src/atan2.rs:33-40); ``csrc/atan2.cuh`` holds the same.
_ATANI = (0x0517C2CD, -0x06C6496B, 0x0FBDB021, -0x25B32E0A, 0x43B34C81,
          -0x3BC823DD)


def _mul_q31(x, y):
    """``(x*y) >> 31`` of two u32 (held in int64), low 32 bits: the
    unsigned Q31 multiply of src/atan2.rs:6-9.  y is split into 16-bit
    halves so no int64 product overflows; the floor is exact."""
    return ((x * (y >> 16) + ((x * (y & 0xFFFF)) >> 16)) >> 15) & _M32


def _clz32(x):
    """Leading zeros of u32 ``x`` (int64, 1 <= x < 2^32), exact: the
    binary exponent of x in float64."""
    _, e = torch.frexp(x.to(torch.float64))
    return 32 - e.to(torch.int64)


def _divi(y, x):
    """y/x in Q31 for 0 <= y <= x (u32 in int64): normalize x to [1, 2)
    in Q1.31, seed a reciprocal from the 16-entry base+slope LUT, one
    Newton step (src/atan2.rs:12-29)."""
    base_t, slope_t = luts.atan2_divi_table()
    base_t = torch.as_tensor(base_t.astype(np.int64), device=x.device)
    slope_t = torch.as_tensor(slope_t.astype(np.int64), device=x.device)
    x_safe = torch.where(x == 0, 1, x)
    shift = _clz32(x_safe)
    y = (y << shift) & _M32
    xn = (x_safe << shift) & _M32
    frac_bits = 31 - luts.ATAN2_DIVI_DEPTH  # 27
    rem = xn & ((1 << frac_bits) - 1)
    idx = ((xn << 1) & _M32) >> (1 + frac_bits)
    step = ((slope_t[idx] * rem) >> frac_bits) & _M32
    r0 = (base_t[idx] + step) & _M32  # wrapping u32 add
    r = _mul_q31(y, _mul_q31(r0, (-_mul_q31(xn, r0)) & _M32))
    return torch.where(x == 0, 0, r)


def _atani(x):
    """atan(x) on the first octant, x u32 Q31 in [0, 1] (in int64), by
    the odd polynomial in Q-format Horner form (src/atan2.rs:32-48).
    Returns u32 in int64."""
    x2 = wrap32((x * x) >> 32)
    r = torch.zeros_like(x2)
    for a in reversed(_ATANI):
        # Q32<32> multiply: widen, >> 32, truncate to i32; wrapping add
        r = wrap32(wrap32((r * x2) >> 32) + a)
    return ((r * x) >> 28) & _M32


def atan2(y, x):
    """Full-circle fixed-point atan2 of int32 tensors (src/atan2.rs:66-82).

    Octant reduction with saturating negation and an XOR unmap key, then
    the reciprocal-LUT division and the polynomial arctangent.  The
    circle maps to int32: i32::MIN = -pi (== +pi); exact on the axes
    (atan2(0, 1) = 0, atan2(1, 0) = 0x3fff_ffff).  Returns int32.
    """
    y, x = torch.broadcast_tensors(y.to(torch.int64), x.to(torch.int64))
    imin, imax = -(2**31), 2**31 - 1
    k = torch.zeros_like(y)

    neg_y = y < 0
    y = torch.where(neg_y, torch.where(y == imin, imax, -y), y)
    k = torch.where(neg_y, k ^ 0xFFFFFFFF, k)

    neg_x = x < 0
    x = torch.where(neg_x, torch.where(x == imin, imax, -x), x)
    k = torch.where(neg_x, k ^ 0x7FFFFFFF, k)

    swap = y > x
    y, x = torch.where(swap, x, y), torch.where(swap, y, x)
    k = torch.where(swap, k ^ 0x3FFFFFFF, k)

    return wrap_i32(_atani(_divi(y, x)) ^ k)
