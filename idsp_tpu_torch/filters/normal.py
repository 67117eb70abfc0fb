"""Normal-form (Rader-Gold, coupled) second-order section (port of
`idsp_tpu.filters.normal`).

The reference's src/iir/normal.rs: a conjugate-pole rotation update
(constant pole resolution across the plane, unlike direct forms near the
real axis) with a second-order FIR prefix.  The state is the DF1 layout
`Df1State`: ``x = [x1, x2]``, and ``y = [y0, y1]`` holds the I/Q
components of the rotating state (not DF1's ``[y1, y2]``).

The float step rounds each product and sum on its own, left to right;
the fixed-point step sums i32 x i32 products in int64 (wrapping), one
truncating ``>> f`` per output, then wraps to int32.  `block` and
`block_q` are the scans the kernels K36 and K35
(`normal_cuda.normal_bank_f32`, `normal_bank_q`) equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import fxp
from .biquad import Df1State, df1_init


def from_cookbook(ba: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(b[3], pole (re, im)) from cookbook ``[[b], [a]]`` coefficients
    (normal.rs:63-77): the conjugate roots of a0 z^2 + a1 z + a2."""
    ba = np.asarray(ba, dtype=np.float64)
    a0i = 1.0 / ba[1][0]
    b = np.array([ba[0][0] * a0i, ba[0][1] * a0i, ba[0][2] * a0i])
    p2 = -0.5 * ba[1][1]
    pq = ba[1][0] * ba[1][2] - p2**2
    assert pq >= 0.0, "poles must be complex-conjugate"
    p = np.array([p2 * a0i, np.sqrt(pq) * a0i])
    return b, p


def step(b, p, state: Df1State, x0):
    """One float update (normal.rs:38-58).

    y1' = b0 x0 + b1 x1 + b2 x2 + p_re*y1 - p_im*y0
    y0' = p_im*y1 + p_re*y0        (the emitted output)
    """
    y1 = (b[..., 0] * x0 + b[..., 1] * state.x[..., 0]
          + b[..., 2] * state.x[..., 1] + p[..., 0] * state.y[..., 1]
          - p[..., 1] * state.y[..., 0])
    y0 = p[..., 1] * state.y[..., 1] + p[..., 0] * state.y[..., 0]
    return (
        Df1State(x=torch.stack([x0, state.x[..., 0]], dim=-1),
                 y=torch.stack([y0, y1], dim=-1)),
        y0,
    )


def step_q(b, p, f: int, state: Df1State, x0, *, dtype=torch.int32):
    """Fixed-point variant: wide MACs (`fxp.mul_wide`), one truncating
    shift per output (the ``Q<i32, i64, F>`` instantiation of
    normal.rs:38-58; int16 and int64 through `fxp`'s accumulators)."""
    b = torch.as_tensor(b, device=x0.device)
    p = torch.as_tensor(p, device=x0.device)

    def mw(c, v):
        return fxp.mul_wide(c, v, dtype=dtype)

    acc1 = (mw(b[..., 0], x0) + mw(b[..., 1], state.x[..., 0])
            + mw(b[..., 2], state.x[..., 1]) + mw(p[..., 0], state.y[..., 1])
            - mw(p[..., 1], state.y[..., 0]))
    y1 = fxp.quantize(acc1, f, dtype=dtype)
    acc0 = mw(p[..., 1], state.y[..., 1]) + mw(p[..., 0], state.y[..., 0])
    y0 = fxp.quantize(acc0, f, dtype=dtype)
    return (
        Df1State(x=torch.stack([x0, state.x[..., 0]], dim=-1),
                 y=torch.stack([y0, y1], dim=-1)),
        y0,
    )


def init(shape=(), dtype=torch.float32, *, device) -> Df1State:
    return df1_init(shape, dtype, device=device)


def block(b, p, state: Df1State, xs):
    """`step` scanned over time axis 0 of ``xs``; b and p are rounded to
    the dtype of ``xs``.  Returns (state, ys)."""
    b = torch.as_tensor(b, dtype=xs.dtype, device=xs.device)
    p = torch.as_tensor(p, dtype=xs.dtype, device=xs.device)
    b0, b1, b2 = (b[..., i] for i in range(3))
    pre, pim = p[..., 0], p[..., 1]
    x1, x2 = state.x[..., 0], state.x[..., 1]
    y0, y1 = state.y[..., 0], state.y[..., 1]
    ys = torch.empty_like(xs)
    for i in range(xs.shape[0]):
        x0 = xs[i]
        y1n = b0 * x0 + b1 * x1 + b2 * x2 + pre * y1 - pim * y0
        y0 = pim * y1 + pre * y0
        y1 = y1n
        ys[i] = y0
        x1, x2 = x0, x1
    return Df1State(x=torch.stack([x1, x2], dim=-1),
                    y=torch.stack([y0, y1], dim=-1)), ys


def _ints(v) -> list[int]:
    a = v.cpu() if isinstance(v, torch.Tensor) else v
    return [int(u) for u in np.asarray(a).reshape(-1)]


def block_q(b, p, f: int, state: Df1State, xs):
    """`step_q` (int32) scanned over time axis 0 of ``xs`` (t, ...) int32,
    with one shared (3,) ``b`` and (2,) ``p``.  Returns (state, ys)."""
    b0, b1, b2 = _ints(b)[:3]
    pre, pim = _ints(p)[:2]
    i64 = torch.int64
    x1, x2 = state.x[..., 0].to(i64), state.x[..., 1].to(i64)
    y0, y1 = state.y[..., 0].to(i64), state.y[..., 1].to(i64)
    ys = torch.empty_like(xs)
    for i in range(xs.shape[0]):
        x0 = xs[i].to(i64)
        y1n = fxp.wrap32((b0 * x0 + b1 * x1 + b2 * x2 + pre * y1
                          - pim * y0) >> f)
        y0 = fxp.wrap32((pim * y1 + pre * y0) >> f)
        y1 = y1n
        ys[i] = y0
        x1, x2 = x0, x1
    i32 = torch.int32
    return Df1State(x=torch.stack([x1, x2], dim=-1).to(i32),
                    y=torch.stack([y0, y1], dim=-1).to(i32)), ys
