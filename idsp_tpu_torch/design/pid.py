"""PID controller coefficient synthesis (a copy of `idsp_tpu.design.pid`).

Equivalent of reference src/iir/pid.rs: per-`Action` gains and gain
limits over five actions (I2, I, P, D, D2), a feedback-term `Order`, and
the kernel-matrix coefficient synthesis that quantizes *gains* rather
than coefficients (pid.rs:265-316).  `Pid` + `Units` adds physical-unit
scaling, setpoint -> summing-junction offset, and output limits for a
clamped biquad (pid.rs:531-564).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, replace

import numpy as np

from .errors import DesignError
from ..fxp import from_float


class Action(enum.IntEnum):
    """PID action index (pid.rs:60-73)."""

    I2 = 0
    I = 1  # noqa: E741
    P = 2
    D = 3
    D2 = 4


class Order(enum.IntEnum):
    """Feedback term order (pid.rs:13-23): number of DC poles removed."""

    P = 2
    I = 1  # noqa: E741
    I2 = 0


def _quantizer(dtype, f):
    """Coefficient quantizer: identity for float dtypes, Q<f> round for
    fixed point (the 'quantize gains not coefficients' rule)."""
    if f is None:
        return lambda c: np.asarray(c, dtype=dtype)
    return lambda c: from_float(c, f).astype(np.int64)


@dataclass(frozen=True)
class PidBuilder:
    """PID -> biquad coefficient builder (pid.rs:39-316).

    ``gain[action]`` units are output/input * period^action_order;
    ``limit[action]`` units are output/input.
    """

    order: Order = Order.I
    gain: tuple = (0.0,) * 5
    limit: tuple = (math.inf,) * 5

    def with_gain(self, action: Action, value: float) -> "PidBuilder":
        g = list(self.gain)
        g[int(action)] = value
        return replace(self, gain=tuple(g))

    def with_limit(self, action: Action, value: float) -> "PidBuilder":
        l = list(self.limit)
        l[int(action)] = value
        return replace(self, limit=tuple(l))

    def kp(self, v):
        return self.with_gain(Action.P, v)

    def ki(self, v):
        return self.with_gain(Action.I, v)

    def ki2(self, v):
        return self.with_gain(Action.I2, v)

    def kd(self, v):
        return self.with_gain(Action.D, v)

    def kd2(self, v):
        return self.with_gain(Action.D2, v)

    def limit_i(self, v):
        return self.with_limit(Action.I, v)

    def limit_i2(self, v):
        return self.with_limit(Action.I2, v)

    def limit_d(self, v):
        return self.with_limit(Action.D, v)

    def limit_d2(self, v):
        return self.with_limit(Action.D2, v)

    def validate(self, period: float) -> None:
        """pid.rs:196-224."""
        if not math.isfinite(period):
            raise DesignError.non_finite("period")
        if period <= 0.0:
            raise DesignError.non_positive("period")
        for name, values in [("gain", self.gain), ("limit", self.limit)]:
            for v in values:
                if math.isnan(v):
                    raise DesignError.non_finite(name)
        for action in (Action.I2, Action.I, Action.D, Action.D2):
            gain = self.gain[int(action)]
            limit = self.limit[int(action)]
            if math.isfinite(limit):
                if limit == 0.0:
                    raise DesignError.non_positive("limit")
                if gain != 0.0 and math.copysign(1, gain) != math.copysign(1, limit):
                    raise DesignError.sign_mismatch("gain/limit")

    def build(self, period: float, *, f: int | None = None, dtype=np.float64):
        """Synthesize ``[b0,b1,b2,a1,a2]`` (pid.rs:265-316).

        Select the three actions starting at `order`, scale each gain by
        period^k, convert gains to per-limit feedback fractions, then
        assemble through the difference kernels [1], [1,-1], [1,-2,1].
        Gains — not coefficients — are quantized (``f`` set: Q<f> ints).
        """
        q = _quantizer(dtype, f)
        z = period ** (-int(self.order))
        gl = [[0.0, 0.0] for _ in range(3)]
        idx = list(enumerate(zip(self.gain, self.limit)))[int(self.order) :][:3]
        for slot, (i, (gain, limit)) in zip(reversed(range(3)), reversed(idx)):
            g = gain * z
            gl[slot][0] = g
            gl[slot][1] = 1.0 if i == int(Action.P) else g / limit
            z = z * period

        a0i = 1.0 / (gl[0][1] + gl[1][1] + gl[2][1])

        kernels = [[1, 0, 0], [1, -1, 0], [1, -2, 1]]
        ba = [[q(0.0), q(0.0)] for _ in range(3)]
        for gli, ki in zip(gl, kernels):
            gq = [q(gli[0] * a0i), q(gli[1] * a0i)]
            for j, kij in enumerate(ki):
                if kij > 0:
                    for _ in range(kij):
                        ba[j][0] = ba[j][0] + gq[0]
                        ba[j][1] = ba[j][1] - gq[1]
                else:
                    for _ in range(-kij):
                        ba[j][0] = ba[j][0] - gq[0]
                        ba[j][1] = ba[j][1] + gq[1]

        out = np.array(
            [ba[0][0], ba[1][0], ba[2][0], ba[1][1], ba[2][1]]
        )
        if f is not None:
            return out.astype(np.int32)
        return out.astype(dtype)

    def try_build(self, period: float, **kw):
        self.validate(period)
        return self.build(period, **kw)


@dataclass(frozen=True)
class Units:
    """Physical units per machine unit (pid.rs:348-382)."""

    t: float = 1.0
    x: float = 1.0
    y: float = 1.0


@dataclass(frozen=True)
class ClampedCoeffs:
    """A BiquadClamp parameter set: coefficients + offset + limits."""

    ba: np.ndarray
    u: float | int
    min: float | int
    max: float | int


@dataclass(frozen=True)
class Pid:
    """PID parameters with units (pid.rs:384-564)."""

    order: Order = Order.I
    gain: tuple = (0.0,) * 5
    limit: tuple = (math.inf,) * 5
    setpoint: float = 0.0
    min: float = -math.inf
    max: float = math.inf

    def kp(self, v):
        return self._g(Action.P, v)

    def ki(self, v):
        return self._g(Action.I, v)

    def ki2(self, v):
        return self._g(Action.I2, v)

    def kd(self, v):
        return self._g(Action.D, v)

    def kd2(self, v):
        return self._g(Action.D2, v)

    def _g(self, a, v):
        g = list(self.gain)
        g[int(a)] = v
        return replace(self, gain=tuple(g))

    def limit_of(self, a, v):
        l = list(self.limit)
        l[int(a)] = v
        return replace(self, limit=tuple(l))

    def with_setpoint(self, s):
        return replace(self, setpoint=s)

    def output_limits(self, lo, hi):
        return replace(self, min=lo, max=hi)

    def validate(self, units: Units) -> None:
        """pid.rs:500-519."""
        if self.min > self.max:
            raise DesignError.inverted_range("output_limits")
        for name, value in [("t", units.t), ("x", units.x), ("y", units.y)]:
            if not math.isfinite(value):
                raise DesignError.non_finite(name)
            if value <= 0.0:
                raise DesignError.non_positive(name)
        PidBuilder(order=self.order, gain=self.gain, limit=self.limit).validate(
            units.t
        )

    def build(self, units: Units, *, f: int | None = None, dtype=np.float64):
        """Unit-scaled clamped-biquad synthesis (pid.rs:543-564).

        Gains/limits are y/x-referred and sign-slaved to the P gain;
        setpoint maps to a summing-junction offset via the forward gain;
        output limits are y-referred.
        """
        yu = 1.0 / units.y
        yx = units.x * yu
        p = self.gain[int(Action.P)]
        gains = tuple(yx * math.copysign(g, p) for g in self.gain)
        limits = tuple(
            yx * math.copysign(math.inf if math.isnan(l) else l, p)
            for l in self.limit
        )
        ba = PidBuilder(order=self.order, gain=gains, limit=limits).build(
            units.t, f=f, dtype=dtype
        )
        # setpoint -> junction offset: u = -setpoint/x * forward_gain
        fg = float(ba[0] + ba[1] + ba[2])
        if f is not None:
            fg = fg / (1 << f)
        u = (-self.setpoint / units.x) * fg
        lo = self.min * yu
        hi = self.max * yu
        if f is not None:
            return ClampedCoeffs(
                ba=ba,
                u=int(round(u)),
                min=int(max(lo, -(2**31))) if math.isfinite(lo) else -(2**31),
                max=int(min(hi, 2**31 - 1)) if math.isfinite(hi) else 2**31 - 1,
            )
        return ClampedCoeffs(ba=ba, u=u, min=lo, max=hi)

    def try_build(self, units: Units, **kw):
        self.validate(units)
        return self.build(units, **kw)
