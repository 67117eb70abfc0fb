"""Audio-EQ-cookbook biquad coefficient builder (lowpass subset).

Port of the part of `idsp_tpu.design.coefficients.Filter` (reference
src/iir/coefficients.rs:24-40, 111-527) that the DDC chain's channel
filter ``Filter().critical_frequency(0.02).lowpass()`` needs.  Pure
float64 math; feed the result through `filters.biquad.from_cookbook`
and `quantize_ba`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

from .errors import DesignError


@dataclass(frozen=True)
class Filter:
    """Cookbook filter builder.

    * ``frequency``: angular critical frequency w0 in [0, pi]
    * ``gain``: linear passband gain
    * ``q``: quality factor (default 1/sqrt(2), critical)
    """

    frequency: float = 0.0
    gain: float = 1.0
    q: float = 1.0 / math.sqrt(2.0)

    def critical_frequency(self, f0: float) -> "Filter":
        return self.angular_critical_frequency(2.0 * math.pi * f0)

    def angular_critical_frequency(self, w0: float) -> "Filter":
        return replace(self, frequency=w0)

    def gain_linear(self, k: float) -> "Filter":
        return replace(self, gain=k)

    def validate(self) -> None:
        """Parameter checks (coefficients.rs:240-263)."""
        if not math.isfinite(self.frequency):
            raise DesignError.non_finite("frequency")
        if not (0.0 <= self.frequency <= math.pi):
            raise DesignError.out_of_range("frequency")
        if not math.isfinite(self.gain) or self.gain <= 0.0:
            raise DesignError.non_positive("gain")
        if not math.isfinite(self.q):
            raise DesignError.non_finite("q")
        if self.q <= 0.0:
            raise DesignError.non_positive("q")

    def _fcos_alpha(self) -> tuple[float, float]:
        fsin = math.sin(self.frequency)
        fcos = math.cos(self.frequency)
        return fcos, 0.5 * fsin * (1.0 / self.q)

    def lowpass(self) -> np.ndarray:
        """``[[b0, b1, b2], [a0, a1, a2]]`` (coefficients.rs:285-300)."""
        fcos, alpha = self._fcos_alpha()
        b = self.gain * 0.5 * (1.0 - fcos)
        return np.array(
            [[b, 2.0 * b, b], [1.0 + alpha, -2.0 * fcos, 1.0 - alpha]]
        )
