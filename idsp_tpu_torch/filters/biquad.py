"""DF1 biquad, fixed point and float (port of the DF1 part of
`idsp_tpu.filters.biquad`).

Coefficients are ``ba = [b0, b1, b2, a1, a2]`` in Q<f> with the
reference's sign convention (biquad.rs:96-116):

    y0 = (b0*x0 + b1*x1 + b2*x2 + a1*y1 + a2*y2) >> f

Five i32 x i32 products summed in int64 (wrapping), one truncating
arithmetic shift, one explicit wrap to int32.  The float DF1
(`df1_step`, `df1_process`) takes float coefficients and sums without
the shift.  The anti-windup form of the reference's production biquad
(`clamp_step`, `df1_clamp_process_q`; biquad.rs:394-404) adds an offset
and clamps each output before it is fed back.  State tensors have shape
(..., 2); x has shape (...,).  Time is axis 0 of a block.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import fxp


def from_cookbook(ba: np.ndarray) -> np.ndarray:
    """Normalize ``[[b0,b1,b2],[a0,a1,a2]]`` to ``[b0,b1,b2,a1,a2]/a0``
    with flipped feedback signs (biquad.rs:544-566)."""
    ba = np.asarray(ba, dtype=np.float64)
    inv_a0 = 1.0 / ba[..., 1, 0]
    return np.stack(
        [
            ba[..., 0, 0] * inv_a0,
            ba[..., 0, 1] * inv_a0,
            ba[..., 0, 2] * inv_a0,
            -ba[..., 1, 1] * inv_a0,
            -ba[..., 1, 2] * inv_a0,
        ],
        axis=-1,
    )


def quantize_ba(ba5: np.ndarray, f: int) -> np.ndarray:
    """Quantize normalized float coefficients to int32 Q<f> bits
    (round-half-away encode, num_traits_impl.rs:30-45)."""
    return fxp.from_float(ba5, f, dtype=np.int32)


class Df1State(NamedTuple):
    """[x1, x2] and [y1, y2] delay lines (biquad.rs:258-303)."""

    x: torch.Tensor  # (..., 2)
    y: torch.Tensor  # (..., 2)


def df1_init(shape=(), dtype=torch.int32, *, device) -> Df1State:
    return Df1State(
        x=torch.zeros(tuple(shape) + (2,), dtype=dtype, device=device),
        y=torch.zeros(tuple(shape) + (2,), dtype=dtype, device=device),
    )


def _ba_list(ba) -> list[int]:
    return [int(v) for v in np.asarray(
        ba.cpu() if isinstance(ba, torch.Tensor) else ba
    ).reshape(-1)[:5]]


def df1_step(ba, state: Df1State, x0):
    """Float DF1 step (biquad.rs:366-383): ``b0*x0 + b1*x1 + b2*x2 +
    a1*y1 + a2*y2``, each product and sum rounded on its own, left to
    right.  ``ba`` (..., 5) is a tensor of the state's dtype.  Returns
    (state, y0)."""
    y0 = (ba[..., 0] * x0 + ba[..., 1] * state.x[..., 0]
          + ba[..., 2] * state.x[..., 1] + ba[..., 3] * state.y[..., 0]
          + ba[..., 4] * state.y[..., 1])
    return (
        Df1State(
            x=torch.stack([x0, state.x[..., 0]], dim=-1),
            y=torch.stack([y0, state.y[..., 0]], dim=-1),
        ),
        y0,
    )


def df1_process(ba, state: Df1State, xs):
    """`df1_step` scanned over time axis 0 of ``xs`` (t, ...).  Returns
    (state, ys) with ys like xs."""
    ba = torch.as_tensor(ba, dtype=xs.dtype, device=xs.device)
    b0, b1, b2, a1, a2 = (ba[..., i] for i in range(5))
    x1, x2 = state.x[..., 0], state.x[..., 1]
    y1, y2 = state.y[..., 0], state.y[..., 1]
    ys = torch.empty_like(xs)
    for i in range(xs.shape[0]):
        x0 = xs[i]
        y0 = b0 * x0 + b1 * x1 + b2 * x2 + a1 * y1 + a2 * y2
        ys[i] = y0
        x1, x2, y1, y2 = x0, x1, y0, y1
    return Df1State(x=torch.stack([x1, x2], dim=-1),
                    y=torch.stack([y1, y2], dim=-1)), ys


def df1_step_q(ba, f: int, state: Df1State, x0):
    """One fixed-point DF1 step: 5 wide MACs, one truncating shift
    (biquad.rs:366-383).  Returns (state, y0)."""
    b0, b1, b2, a1, a2 = _ba_list(ba)
    x1, x2 = state.x[..., 0].to(torch.int64), state.x[..., 1].to(torch.int64)
    y1, y2 = state.y[..., 0].to(torch.int64), state.y[..., 1].to(torch.int64)
    acc = (b0 * x0.to(torch.int64) + b1 * x1 + b2 * x2
           + a1 * y1 + a2 * y2)
    y0 = fxp.quantize(acc, f)
    return (
        Df1State(
            x=torch.stack([x0, state.x[..., 0]], dim=-1),
            y=torch.stack([y0, state.y[..., 0]], dim=-1),
        ),
        y0,
    )


def clamp_params(u, lo, hi) -> tuple[int, int, int]:
    """``(u, lo, hi)`` of the integer anti-windup clamp as Python ints,
    each in the int32 range (the kernels take them as C ints)."""
    out = tuple(int(v) for v in (u, lo, hi))
    for name, v in zip(("u", "lo", "hi"), out):
        if not -(2**31) <= v < 2**31:
            raise ValueError(f"clamp {name} must be an int32, got {v}")
    return out


def clamp_step(step_out, u, lo, hi):
    """Offset + clamp at the summing junction, the clamped output written
    into the feedback state (biquad.rs:394-404): ``y0 = clip(y0 + u, lo,
    hi)`` replaces ``state.y[..., 0]``; the x-state is untouched.

    ``step_out`` is a ``(state, y0)`` step result, int or float.  For
    int32 ``y0 + u`` wraps as int32 addition does; the clip takes the max
    with ``lo`` first, then the min with ``hi`` (``jnp.clip``), so ``lo >
    hi`` gives ``hi``.  Returns (state, y0).
    """
    state, y0 = step_out
    if y0.dtype == torch.int32:
        v = fxp.wrap_i32(y0.to(torch.int64) + int(u))
    else:
        v = y0 + u
    y0 = torch.clamp(v, lo, hi)
    y = torch.stack([y0, state.y[..., 1]], dim=-1)
    return state._replace(y=y), y0


def df1_clamp_process_q(ba, f: int, state: Df1State, xs, *, u: int = 0,
                        lo: int, hi: int):
    """Scan ``clamp_step(df1_step_q(...), u, lo, hi)`` over time axis 0
    of ``xs`` (..., int32): the anti-windup DF1, bit-identical to the
    step-by-step scan.  Returns (state, ys) with ys like xs."""
    return df1_process_q(ba, f, state, xs, clamp=clamp_params(u, lo, hi))


def df1_process_q(ba, f: int, state: Df1State, xs, *, clamp=None):
    """Scan `df1_step_q` over time axis 0 of ``xs`` (..., int32).

    The feed-forward part ``b0*x0 + b1*x1 + b2*x2`` of every step is
    formed for the whole block at once; only the feedback ``a1*y1 +
    a2*y2`` is sequential.  Sums are int64, wrapping, so the split
    leaves every accumulator — and so every output — bit-identical to
    the step-by-step scan.  With ``clamp = (u, lo, hi)`` each output is
    `clamp_step`'s ``clip(y0 + u, lo, hi)`` (int32 ``+ u`` wrapping)
    before it is fed back.  Returns (state, ys) with ys like xs.
    """
    b0, b1, b2, a1, a2 = _ba_list(ba)
    if clamp is not None:
        u, lo, hi = clamp_params(*clamp)
    t = xs.shape[0]
    xw = torch.cat(
        [state.x[..., 1][None], state.x[..., 0][None], xs], dim=0
    ).to(torch.int64)
    ff = b0 * xw[2:] + b1 * xw[1:-1] + b2 * xw[:-2]
    y1 = state.y[..., 0].to(torch.int64)
    y2 = state.y[..., 1].to(torch.int64)
    ys = torch.empty_like(ff)
    for i in range(t):
        # the int32 output, held sign-extended in int64 for the next MACs
        if clamp is None:
            y0 = fxp.wrap32((ff[i] + a1 * y1 + a2 * y2) >> f)
        else:  # wrap32(wrap32(v) + u) == wrap32(v + u): one wrap
            y0 = torch.clamp(fxp.wrap32(((ff[i] + a1 * y1 + a2 * y2) >> f)
                                        + u), lo, hi)
        ys[i] = y0
        y1, y2 = y0, y1
    new_state = Df1State(
        x=torch.stack([xw[-1], xw[-2]], dim=-1).to(torch.int32),
        y=torch.stack([y1, y2], dim=-1).to(torch.int32),
    )
    return new_state, ys.to(torch.int32)
