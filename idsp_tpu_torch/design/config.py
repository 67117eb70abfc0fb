"""Runtime control-plane configuration for biquads (a copy of
`idsp_tpu.design.config`).

Equivalent of reference src/iir/config.rs (the `miniconf` feature): a
tagged `BiquadConfig` union {Ba, Raw, Pid, Filter} of serializable
dataclasses with `build`/`try_build(units)` producing a clamped-biquad
parameter set (coefficients + offset + limits), with x/y/t unit
scaling.  Dict round-trip replaces the serde/miniconf tree; the DF1
atomic-coefficient-swap property means a rebuilt config can be applied
without touching state (biquad.rs:34-36).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .coefficients import Filter, FilterType, Shape
from .errors import DesignError
from .pid import ClampedCoeffs, Order, Pid, Units
from ..filters import biquad


@dataclass
class BaConfig:
    """Float cookbook coefficients before quantization
    (config.rs:19-41)."""

    ba: Any = field(
        default_factory=lambda: [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]
    )
    offset: float = 0.0
    min: float = -math.inf
    max: float = math.inf


@dataclass
class FilterConfig:
    """Standard biquad filter parameters (config.rs:43-82)."""

    typ: str = "lowpass"
    frequency: float = 0.0
    gain_db: float = 0.0
    shelf_db: float = 0.0
    shape: Shape = field(default_factory=Shape)
    offset: float = 0.0
    min: float = -math.inf
    max: float = math.inf


@dataclass
class GainsConfig:
    """Named PID gains (config.rs:84-115)."""

    i2: float = 0.0
    i: float = 0.0
    p: float = 0.0
    d: float = 0.0
    d2: float = 0.0

    def as_tuple(self) -> tuple:
        return (self.i2, self.i, self.p, self.d, self.d2)

    @staticmethod
    def splat(v: float) -> "GainsConfig":
        return GainsConfig(v, v, v, v, v)


@dataclass
class PidConfig:
    """PID controller configuration (config.rs:117-166)."""

    order: str = "I"
    gain: GainsConfig = field(default_factory=GainsConfig)
    limit: GainsConfig = field(default_factory=lambda: GainsConfig.splat(math.inf))
    setpoint: float = 0.0
    min: float = -math.inf
    max: float = math.inf


_TAGS = ("Ba", "Raw", "Pid", "Filter")


@dataclass
class RawConfig:
    """Raw machine-unit clamped-biquad parameters (the `Raw` variant)."""

    ba: Any = field(default_factory=lambda: [0.0, 0.0, 0.0, 0.0, 0.0])
    u: float = 0.0
    min: float = -math.inf
    max: float = math.inf


@dataclass
class BiquadConfig:
    """Tagged union {Ba, Raw, Pid, Filter} (config.rs:235-258)."""

    tag: str = "Ba"
    config: Any = field(default_factory=BaConfig)

    @staticmethod
    def from_tag(tag: str) -> "BiquadConfig":
        """String-tag construction with defaults (config.rs:277-295)."""
        if tag == "Ba":
            return BiquadConfig("Ba", BaConfig())
        if tag == "Raw":
            return BiquadConfig("Raw", RawConfig())
        if tag == "Pid":
            return BiquadConfig("Pid", PidConfig())
        if tag == "Filter":
            return BiquadConfig("Filter", FilterConfig())
        raise DesignError.out_of_range("tag")

    def _check_offset_limits(self, offset, lo, hi):
        """config.rs:310-326."""
        if not math.isfinite(offset):
            raise DesignError.non_finite("offset")
        if math.isnan(lo) or math.isnan(hi):
            raise DesignError.non_finite("output_limits")
        if lo > hi:
            raise DesignError.inverted_range("output_limits")

    def _check_units(self, units: Units, check_t: bool):
        """config.rs:328-345."""
        for name, value in [("x", units.x), ("y", units.y)] + (
            [("t", units.t)] if check_t else []
        ):
            if not math.isfinite(value):
                raise DesignError.non_finite(name)
            if value <= 0.0:
                raise DesignError.non_positive(name)

    def build(
        self, units: Units | None = None, *, f: int | None = None, validate=True
    ) -> ClampedCoeffs:
        """Build the clamped-biquad parameter set (config.rs:347-434).

        With ``f`` set, coefficients quantize to Q32<f> and offset/limits
        round-saturate to i32.
        """
        units = units or Units()
        yu = 1.0 / units.y
        yx = units.x * yu

        def finish(ba_cookbook, offset, lo, hi):
            if validate:
                self._check_offset_limits(offset, lo, hi)
            ba = np.asarray(ba_cookbook, np.float64).copy()
            ba[0] = ba[0] * yx
            ba5 = biquad.from_cookbook(ba)
            if f is not None:
                return ClampedCoeffs(
                    ba=biquad.quantize_ba(ba5, f),
                    u=_round_sat_i32(offset * yu),
                    min=_round_sat_i32(lo * yu),
                    max=_round_sat_i32(hi * yu),
                )
            return ClampedCoeffs(
                ba=ba5, u=offset * yu, min=lo * yu, max=hi * yu
            )

        if self.tag == "Ba":
            c: BaConfig = self.config
            if validate:
                self._check_units(units, False)
                for row in np.asarray(c.ba, np.float64):
                    if not np.all(np.isfinite(row)):
                        raise DesignError.non_finite("ba")
            return finish(c.ba, c.offset, c.min, c.max)

        if self.tag == "Raw":
            c = self.config
            ba = np.asarray(c.ba)
            return ClampedCoeffs(ba=ba, u=c.u, min=c.min, max=c.max)

        if self.tag == "Pid":
            c = self.config
            pid = Pid(
                order=Order[c.order] if isinstance(c.order, str) else c.order,
                gain=c.gain.as_tuple(),
                limit=c.limit.as_tuple(),
                setpoint=c.setpoint,
                min=c.min,
                max=c.max,
            )
            if validate:
                return pid.try_build(units, f=f)
            return pid.build(units, f=f)

        if self.tag == "Filter":
            c = self.config
            if validate:
                self._check_units(units, True)
            flt = (
                Filter()
                .gain_db(c.gain_db)
                .critical_frequency(c.frequency * units.t)
                .shelf_db(c.shelf_db)
            )
            flt = dataclasses.replace(flt, shape=c.shape)
            typ = FilterType(c.typ) if isinstance(c.typ, str) else c.typ
            ba = flt.try_build(typ) if validate else flt.build(typ)
            return finish(ba, c.offset, c.min, c.max)

        raise DesignError.out_of_range("tag")

    # --- dict (de)serialization: the serde/miniconf equivalent ---

    def to_dict(self) -> dict:
        def enc(x):
            if dataclasses.is_dataclass(x) and not isinstance(x, type):
                return {k: enc(v) for k, v in dataclasses.asdict(x).items()}
            if isinstance(x, np.ndarray):
                return x.tolist()
            return x

        return {self.tag: enc(self.config)}

    @staticmethod
    def from_dict(d: dict) -> "BiquadConfig":
        (tag, body), = d.items()
        cfg = BiquadConfig.from_tag(tag)
        c = cfg.config
        for k, v in body.items():
            if k == "shape" and isinstance(v, dict):
                v = Shape(**v)
            elif k in ("gain", "limit") and isinstance(v, dict):
                v = GainsConfig(**v)
            setattr(c, k, v)
        return cfg


def _round_sat_i32(v: float) -> int:
    if math.isnan(v):
        return 0
    if not math.isfinite(v):
        return (2**31 - 1) if v > 0 else -(2**31)
    v = math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5)
    return int(min(max(v, -(2**31)), 2**31 - 1))
