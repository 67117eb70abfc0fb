"""Build-time lookup tables, regenerated in Python (numpy).

Port of the part of `idsp_tpu.luts` the DDC chain and bank need: the
128-entry cos/sin midpoint LUT of the `cossin` NCO (reference
build.rs:8-41) and the 16-entry reciprocal seed LUT of `atan2`
(build.rs:43-67).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

COSSIN_DEPTH = 7
ATAN2_DIVI_DEPTH = 4


def _round(x: float) -> int:
    """Rust f64::round: half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


@lru_cache(maxsize=None)
def cossin_table() -> np.ndarray:
    """128-entry packed cos/sin midpoint LUT (build.rs:8-41).

    Entries sample (i + 0.5)/2^DEPTH of the first octant [0, pi/4).
    cos uses the excess-(2^16) encoding (0.5 < cos <= 1 on the octant):
    stored value is round((cos*2 - 1)*65535 - 1); sin is
    round(sin*65535).  Packed u32 = cos-excess u16 | sin u16 << 16.
    """
    amplitude = float(np.iinfo(np.uint16).max)  # 65535
    n = 1 << COSSIN_DEPTH
    out = np.empty(n, dtype=np.uint32)
    for i in range(n):
        z = math.pi / 4.0 * ((i + 0.5) / n)
        c = _round((math.cos(z) * 2.0 - 1.0) * amplitude - 1.0)
        s = _round(math.sin(z) * amplitude)
        out[i] = np.uint32(c) + (np.uint32(s) << np.uint32(16))
    return out


@lru_cache(maxsize=None)
def atan2_divi_table() -> tuple[np.ndarray, np.ndarray]:
    """16-entry reciprocal seed (base, slope) LUT of the atan2 divider
    (build.rs:43-67): base = round(2^31/x0) as u32, slope = the first
    difference of the reciprocal in Q31, as i32.  ``csrc/atan2.cuh``
    holds the same numbers."""
    q31 = float(1 << 31)
    n = 1 << ATAN2_DIVI_DEPTH
    base = np.empty(n, dtype=np.uint32)
    slope = np.empty(n, dtype=np.int32)
    for i in range(n):
        x0 = 1.0 + i / n
        x1 = 1.0 + (i + 1) / n
        base[i] = np.uint32(_round(q31 / x0))
        slope[i] = np.int32(_round((1.0 / x1 - 1.0 / x0) * q31))
    return base, slope
