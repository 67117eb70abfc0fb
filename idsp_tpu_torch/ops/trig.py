"""Fixed-point `cossin` (DDS/NCO), port of `idsp_tpu.ops.trig.cossin`.

The octant-folded midpoint-LUT DDS of reference src/cossin.rs:14-67:
7-bit LUT with first-order interpolation, bit-exact with the reference.
The LUT access is a plain gather (``lut[idx]``); the TPU's select-chain
lookup was a workaround for slow TPU gathers and is not ported.  The
arithmetic runs in int64 and is wrapped to int32 at the end.

Phase convention: 32-bit wrapping phase, i32::MIN = -pi.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import luts
from ..fxp import wrap_i32

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
