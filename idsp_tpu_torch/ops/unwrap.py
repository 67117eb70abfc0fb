"""Phase wrap detection, unwrapping and wrap-to-saturation mapping (port
of `idsp_tpu.ops.unwrap`, reference src/unwrap.rs).

The block `Unwrapper` is a closed-form cumulative sum of wrapped
differences.  `ClampWrap` carries a tiny nonlinear state; it is the
phase detector of the PLL (src/pll.rs:64,94).  Phases are wrapping
int32; arithmetic runs in int64 and is wrapped back explicitly.  The
clamp indicator stays int8, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fxp import wrap32, wrap_i32

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def overflowing_sub(y, x):
    """Wrapped int32 difference ``y - x`` and the overflow signum in
    {-1, 0, +1} (src/unwrap.rs:73-80): ``(delta >= 0) - (y >= x)``,
    +1 on positive overflow, -1 on negative.  Returns (delta int32,
    wrap int8)."""
    y = y.to(torch.int64)
    x = x.to(torch.int64)
    delta = wrap32(y - x)
    wrap = (delta >= 0).to(torch.int8) - (y >= x).to(torch.int8)
    return delta.to(torch.int32), wrap


def saturating_scale(lo, hi, shift: int):
    """Monotone hi:lo recombination into one downscaled int32
    (src/unwrap.rs:90-101): ``(lo >> shift) + (hi << (32 - shift))``,
    wrapping, saturated when ``hi`` leaves the representable band."""
    if not 0 < shift <= 32:
        raise ValueError(f"shift must be in 1..32, got {shift}")
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    hi_range = -(1 << (shift - 1))
    mid = wrap32((lo >> shift) + wrap32(hi << (32 - shift)))
    return wrap_i32(torch.where(
        hi <= hi_range, _I32_MIN - hi_range,
        torch.where(wrap32(-hi) <= hi_range, hi_range - _I32_MIN, mid)))


def unwrap_diffs(x, y0):
    """Block `Unwrapper` (src/unwrap.rs:139-158) in closed form: the
    wrapped diffs ``dx[0] = x[0] - y0`` (y0 wrapped to int32), ``dx[i] =
    x[i] - x[i-1]``, and the extended phases ``y = y0 + cumsum(dx)``.

    Args:
      x: (..., n) wrapped int32 phase stream.
      y0: (...,) int64 extended phase before the block.

    Returns (dx int32, y int64); carry ``y[..., -1]`` into the next block.
    """
    y0 = y0.to(torch.int64)
    prev = torch.cat([wrap32(y0)[..., None], x[..., :-1].to(torch.int64)],
                     dim=-1)
    dx = wrap32(x.to(torch.int64) - prev)
    return dx.to(torch.int32), y0[..., None] + torch.cumsum(dx, dim=-1)


def wraps(y, s: int):
    """Rounded wrap count from the extended phase (src/unwrap.rs:119-127):
    ``(y >> s) + ((y >> (s-1)) & 1)``, wrapped to int32."""
    y = y.to(torch.int64)
    return wrap_i32((y >> s) + ((y >> (s - 1)) & 1))


class ClampWrapState(NamedTuple):
    """State of the wrap-to-saturation mapper (src/unwrap.rs:166-171)."""

    x0: torch.Tensor  # last input, int32
    clamp: torch.Tensor  # accumulated wrap indicator in {-1, 0, +1}, int8


def clamp_wrap_init(shape=(), *, device) -> ClampWrapState:
    return ClampWrapState(
        x0=torch.zeros(tuple(shape), dtype=torch.int32, device=device),
        clamp=torch.zeros(tuple(shape), dtype=torch.int8, device=device),
    )


def clamp_wrap_step(state: ClampWrapState, x):
    """One `ClampWrap::process` (src/unwrap.rs:184-194): saturate the
    output on a wrap until the matching un-wrap.  Returns (state, y)."""
    _, wrap = overflowing_sub(x, state.x0)
    # clamp += wrap, saturated into {-1, 0, 1} (the sign of the sum)
    clamp = torch.sign(state.clamp + wrap).to(torch.int8)
    x = x.to(torch.int32)
    y = torch.where(clamp < 0, _I32_MIN, torch.where(clamp > 0, _I32_MAX, x))
    return ClampWrapState(x0=x, clamp=clamp), y.to(torch.int32)


def clamp_wrap_block(state: ClampWrapState, xs):
    """`clamp_wrap_step` over time axis 0 of ``xs``.  Returns (state,
    ys) with ys int32 like xs."""
    ys = torch.empty(xs.shape, dtype=torch.int32, device=xs.device)
    for i in range(xs.shape[0]):
        state, ys[i] = clamp_wrap_step(state, xs[i])
    return state, ys
