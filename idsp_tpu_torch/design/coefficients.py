"""Audio-EQ-cookbook biquad coefficient builders (a copy of
`idsp_tpu.design.coefficients`).

Equivalent of reference src/iir/coefficients.rs: the `Filter` builder
(frequency/gain/shelf/shape) producing cookbook ``[[b0,b1,b2],
[a0,a1,a2]]`` arrays for nine filter types, and the `WebAudio` builder
(Hz/detune-cents/Q/gain-dB).  Pure float64 numpy; feed the result
through `filters.biquad.from_cookbook` (+ `quantize_ba` for fixed
point).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace

import numpy as np

from .errors import DesignError


class FilterType(enum.Enum):
    """Standard audio/WebAudio biquad type (coefficients.rs:42-65)."""

    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    ALLPASS = "allpass"
    NOTCH = "notch"
    PEAKING = "peaking"
    LOWSHELF = "lowshelf"
    HIGHSHELF = "highshelf"
    IHO = "iho"  # integrator over harmonic oscillator


@dataclass(frozen=True)
class Shape:
    """Transition/corner shape: exactly one of q, bandwidth (octaves), or
    slope (coefficients.rs:6-22).  Default Q = 1/sqrt(2) (critical)."""

    kind: str = "q"
    value: float = 1.0 / math.sqrt(2.0)

    @staticmethod
    def q(value: float) -> "Shape":
        return Shape("q", value)

    @staticmethod
    def bandwidth(value: float) -> "Shape":
        return Shape("bandwidth", value)

    @staticmethod
    def slope(value: float) -> "Shape":
        return Shape("slope", value)


@dataclass(frozen=True)
class Filter:
    """Cookbook filter builder (coefficients.rs:24-40, 111-527).

    * ``frequency``: angular critical frequency w0 in [0, pi]
      (``frequency = pi`` is Nyquist)
    * ``gain``: linear passband gain
    * ``shelf``: linear shelf gain (peaking/shelf types only)
    * ``shape``: Q / bandwidth / slope
    """

    frequency: float = 0.0
    gain: float = 1.0
    shelf: float = 1.0
    shape: Shape = field(default_factory=Shape)

    # --- fluent setters (builder style, returning new instances) ---

    def frequency_of(self, critical: float, sample: float) -> "Filter":
        return self.critical_frequency(critical / sample)

    def critical_frequency(self, f0: float) -> "Filter":
        return self.angular_critical_frequency(2.0 * math.pi * f0)

    def angular_critical_frequency(self, w0: float) -> "Filter":
        return replace(self, frequency=w0)

    def gain_linear(self, k: float) -> "Filter":
        return replace(self, gain=k)

    def gain_db(self, k_db: float) -> "Filter":
        return self.gain_linear(10.0 ** (k_db / 20.0))

    def shelf_linear(self, a: float) -> "Filter":
        return replace(self, shelf=a)

    def shelf_db(self, a_db: float) -> "Filter":
        return self.shelf_linear(10.0 ** (a_db / 20.0))

    def q(self, q: float) -> "Filter":
        return replace(self, shape=Shape.q(q))

    def inverse_q(self, qi: float) -> "Filter":
        return self.q(1.0 / qi)

    def bandwidth(self, bw: float) -> "Filter":
        return replace(self, shape=Shape.bandwidth(bw))

    def shelf_slope(self, s: float) -> "Filter":
        return replace(self, shape=Shape.slope(s))

    # --- validation (coefficients.rs:240-263) ---

    def validate(self) -> None:
        if not math.isfinite(self.frequency):
            raise DesignError.non_finite("frequency")
        if not (0.0 <= self.frequency <= math.pi):
            raise DesignError.out_of_range("frequency")
        if not math.isfinite(self.gain) or self.gain <= 0.0:
            raise DesignError.non_positive("gain")
        if not math.isfinite(self.shelf) or self.shelf <= 0.0:
            raise DesignError.non_positive("shelf")
        if not math.isfinite(self.shape.value):
            raise DesignError.non_finite(self.shape.kind)
        if self.shape.kind in ("q", "slope") and self.shape.value <= 0.0:
            raise DesignError.non_positive(self.shape.kind)

    # --- internals (coefficients.rs:265-283) ---

    def _qi(self) -> float:
        s = self.shape
        if s.kind == "q":
            return 1.0 / s.value
        if s.kind == "bandwidth":
            return 2.0 * math.sinh(
                math.log(2.0) / 2.0 * s.value * self.frequency
                / math.sin(self.frequency)
            )
        # slope
        return math.sqrt(
            (self.shelf + 1.0 / self.shelf) * (1.0 / s.value - 1.0) + 2.0
        )

    def _fcos_alpha(self) -> tuple[float, float]:
        fsin = math.sin(self.frequency)
        fcos = math.cos(self.frequency)
        return fcos, 0.5 * fsin * self._qi()

    # --- the nine filter types (coefficients.rs:285-473) ---

    def lowpass(self) -> np.ndarray:
        fcos, alpha = self._fcos_alpha()
        b = self.gain * 0.5 * (1.0 - fcos)
        return np.array(
            [[b, 2.0 * b, b], [1.0 + alpha, -2.0 * fcos, 1.0 - alpha]]
        )

    def highpass(self) -> np.ndarray:
        fcos, alpha = self._fcos_alpha()
        b = self.gain * 0.5 * (1.0 + fcos)
        return np.array(
            [[b, -2.0 * b, b], [1.0 + alpha, -2.0 * fcos, 1.0 - alpha]]
        )

    def bandpass(self) -> np.ndarray:
        fcos, alpha = self._fcos_alpha()
        b = self.gain * alpha
        return np.array(
            [[b, 0.0, -b], [1.0 + alpha, -2.0 * fcos, 1.0 - alpha]]
        )

    def notch(self) -> np.ndarray:
        fcos, alpha = self._fcos_alpha()
        f2 = -2.0 * fcos
        return np.array(
            [
                [self.gain, f2 * self.gain, self.gain],
                [1.0 + alpha, f2, 1.0 - alpha],
            ]
        )

    def allpass(self) -> np.ndarray:
        fcos, alpha = self._fcos_alpha()
        f2 = -2.0 * fcos
        return np.array(
            [
                [
                    (1.0 - alpha) * self.gain,
                    f2 * self.gain,
                    (1.0 + alpha) * self.gain,
                ],
                [1.0 + alpha, f2, 1.0 - alpha],
            ]
        )

    def peaking(self) -> np.ndarray:
        fcos, alpha = self._fcos_alpha()
        s = math.sqrt(self.shelf)
        f2 = -2.0 * fcos
        return np.array(
            [
                [
                    (1.0 + alpha * s) * self.gain,
                    f2 * self.gain,
                    (1.0 - alpha * s) * self.gain,
                ],
                [1.0 + alpha / s, f2, 1.0 - alpha / s],
            ]
        )

    def lowshelf(self) -> np.ndarray:
        fcos, alpha = self._fcos_alpha()
        s = math.sqrt(self.shelf)
        tsa = 2.0 * math.sqrt(s) * alpha
        sp1 = s + 1.0
        sm1 = s - 1.0
        return np.array(
            [
                [
                    s * self.gain * (sp1 - sm1 * fcos + tsa),
                    2.0 * s * self.gain * (sm1 - sp1 * fcos),
                    s * self.gain * (sp1 - sm1 * fcos - tsa),
                ],
                [
                    sp1 + sm1 * fcos + tsa,
                    -2.0 * (sm1 + sp1 * fcos),
                    sp1 + sm1 * fcos - tsa,
                ],
            ]
        )

    def highshelf(self) -> np.ndarray:
        fcos, alpha = self._fcos_alpha()
        s = math.sqrt(self.shelf)
        tsa = 2.0 * math.sqrt(s) * alpha
        sp1 = s + 1.0
        sm1 = s - 1.0
        return np.array(
            [
                [
                    s * self.gain * (sp1 + sm1 * fcos + tsa),
                    -2.0 * s * self.gain * (sm1 + sp1 * fcos),
                    s * self.gain * (sp1 + sm1 * fcos - tsa),
                ],
                [
                    sp1 - sm1 * fcos + tsa,
                    2.0 * (sm1 - sp1 * fcos),
                    sp1 - sm1 * fcos - tsa,
                ],
            ]
        )

    def iho(self) -> np.ndarray:
        """Integrator-over-harmonic-oscillator: notch, integrating below,
        flat shelf gain above (coefficients.rs:458-473)."""
        fcos, alpha = self._fcos_alpha()
        fsin = 0.5 * math.sin(self.frequency)
        a = (1.0 + fcos) / (2.0 * self.shelf)
        return np.array(
            [
                [
                    self.gain * (1.0 + alpha),
                    -2.0 * self.gain * fcos,
                    self.gain * (1.0 - alpha),
                ],
                [a + fsin, -2.0 * a, a - fsin],
            ]
        )

    # --- dispatch (coefficients.rs:475-527) ---

    def build(self, typ: FilterType) -> np.ndarray:
        return getattr(self, typ.value)()

    def try_build(self, typ: FilterType) -> np.ndarray:
        self.validate()
        return self.build(typ)


@dataclass(frozen=True)
class WebAudio:
    """WebAudio-style builder (coefficients.rs:67-109, 529-616)."""

    typ: FilterType = FilterType.LOWPASS
    frequency_hz: float = 350.0
    sample_rate_hz: float = 48e3
    detune_cents: float = 0.0
    q: float = 1.0
    gain_db: float = 0.0

    def filter(self) -> Filter:
        f = Filter().frequency_of(
            self.frequency_hz * 2.0 ** (self.detune_cents / 1200.0),
            self.sample_rate_hz,
        )
        f = f.q(self.q)
        if self.typ in (
            FilterType.PEAKING,
            FilterType.LOWSHELF,
            FilterType.HIGHSHELF,
        ):
            f = f.shelf_db(self.gain_db)
        return f

    def validate(self) -> None:
        for name, value in [
            ("frequency_hz", self.frequency_hz),
            ("sample_rate_hz", self.sample_rate_hz),
            ("detune_cents", self.detune_cents),
            ("q", self.q),
            ("gain_db", self.gain_db),
        ]:
            if not math.isfinite(value):
                raise DesignError.non_finite(name)
        if self.sample_rate_hz <= 0.0:
            raise DesignError.non_positive("sample_rate_hz")
        if self.q <= 0.0:
            raise DesignError.non_positive("q")
        f = self.frequency_hz * 2.0 ** (self.detune_cents / 1200.0)
        if f < 0.0 or f > self.sample_rate_hz / 2.0:
            raise DesignError.out_of_range("computed_frequency_hz")

    def build(self) -> np.ndarray:
        return self.filter().build(self.typ)

    def try_build(self) -> np.ndarray:
        self.validate()
        return self.filter().try_build(self.typ)
