"""Phase wrap detection and wrap-to-saturation mapping (port of the
`ClampWrap` part of `idsp_tpu.ops.unwrap`, reference src/unwrap.rs).

`ClampWrap` carries a tiny nonlinear state; it is the phase detector of
the PLL (src/pll.rs:64,94).  Phases are wrapping int32; arithmetic runs
in int64 and is wrapped back explicitly.  The clamp indicator stays
int8, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fxp import wrap32

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
