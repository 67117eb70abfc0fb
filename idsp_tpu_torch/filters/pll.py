"""Type-2, order-3 sampled-phase PLL (port of `idsp_tpu.filters.pll`,
reference src/pll.rs).

Wrapping i32/i64 arithmetic, Q32<32> lead-lag coefficients, a
wrap-clamped phase error (anti-windup during acquisition), a Nyquist
zero, a wide lead-lag state with first-order noise shaping and a DC pole
for the frequency.  i32 values are computed in int64 and wrapped back
explicitly (`fxp.wrap32`); the i64 words wrap as two's complement, as
in the JAX package.  The update is nonlinear (the clamp), so time is a
loop; channels are the trailing axes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import fxp
from ..ops import unwrap
from ..ops.unwrap import ClampWrapState


def coefficients_from_zpk(zero: float, pole: float, gain: float) -> np.ndarray:
    """``ba = [gain, -gain*zero, -(1-pole)]`` quantized to Q32<32> with
    the saturating f32 cast of the reference (pll.rs:41-48)."""
    vals = np.array(
        [np.float32(gain), np.float32(-gain * zero), np.float32(-(1.0 - pole))],
        dtype=np.float32,
    )
    return fxp.from_float(vals, 32)


def coefficients_from_bandwidth(bw: float, split: float = 4.0) -> np.ndarray:
    """Single-parameter loop design (pll.rs:50-57): ~1.5 dB peaking and
    62 deg margin at split=4."""
    a = np.float32(bw) * np.float32(2.0 * math.pi)
    z = np.float32(1.0) - a / np.float32(split)
    p = np.float32(1.0) - a * np.float32(split)
    k = -a * a * np.float32(split)
    return coefficients_from_zpk(float(z), float(p), float(k))


class PllState(NamedTuple):
    """pll.rs:61-87. All per-channel scalars (leading batch axes ok)."""

    clamp: ClampWrapState
    z0: torch.Tensor  # int32, after clamp
    y0: torch.Tensor  # int32, after Nyquist zero
    f0: torch.Tensor  # int64, lead-lag wide state
    f: torch.Tensor  # int64, DC pole (frequency accumulator)
    y: torch.Tensor  # int32, output phase


def init(shape=(), *, device) -> PllState:
    def z(dtype):
        return torch.zeros(tuple(shape), dtype=dtype, device=device)

    return PllState(
        clamp=unwrap.clamp_wrap_init(shape, device=device),
        z0=z(torch.int32), y0=z(torch.int32), f0=z(torch.int64),
        f=z(torch.int64), y=z(torch.int32),
    )


def frequency(state: PllState):
    """Current frequency estimate (pll.rs:84-86)."""
    return (state.f >> 32).to(torch.int32)


def ba_list(ba) -> list[int]:
    """``[b0, b1, a1]`` as Python ints."""
    return [int(v) for v in np.asarray(
        ba.cpu() if isinstance(ba, torch.Tensor) else ba).reshape(-1)[:3]]


def step(ba, state: PllState, x):
    """One update (pll.rs:90-107). x: wrapping i32 input phase.
    Returns (state, y)."""
    b0, b1, a1 = ba_list(ba)
    # advance the output phase (oscillator DC pole)
    y = fxp.wrap32(state.y.to(torch.int64) + (state.f >> 32))
    # wrap-clamped phase error, halved
    clamp, ze = unwrap.clamp_wrap_step(
        state.clamp, fxp.wrap32(x.to(torch.int64) + y))
    z0 = ze.to(torch.int64) >> 1
    # Nyquist zero
    y0 = fxp.wrap32(z0 + state.z0)
    # lead-lag with wide state and first-order noise shaping: a1 times
    # the state's high word plus the (unsigned) low word scaled back
    # (pll.rs:99-102)
    f0 = (state.f0 + b0 * y0 + b1 * state.y0.to(torch.int64)
          + a1 * (state.f0 >> 32) + ((a1 * (state.f0 & 0xFFFFFFFF)) >> 32))
    # DC pole
    f = state.f + f0
    y = y.to(torch.int32)
    return PllState(clamp=clamp, z0=z0.to(torch.int32), y0=y0.to(torch.int32),
                    f0=f0, f=f, y=y), y


def block(ba, state: PllState, xs):
    """`step` over time axis 0 of ``xs`` (t, ...) int32; channels on the
    trailing axes.  Returns (state, ys) with ys (t, ...) int32."""
    ys = torch.empty(xs.shape, dtype=torch.int32, device=xs.device)
    for i in range(xs.shape[0]):
        state, ys[i] = step(ba, state, xs[i])
    return state, ys
