"""Build-time lookup tables, regenerated in Python (numpy).

Port of the part of `idsp_tpu.luts` the DDC chain needs: the 128-entry
cos/sin midpoint LUT of the `cossin` NCO (reference build.rs:8-41).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

COSSIN_DEPTH = 7


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
