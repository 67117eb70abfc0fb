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

The fixed-point steps take ``ba`` as one shared ``(5,)`` set or as a
``(..., 5)`` array with one set per lane (the runtime-coefficient banks'
per-channel form); a shared set stays five Python ints, so the shared
path's arithmetic is that of the step-by-step scan.

The rest of the reference's biquad architectures (biquad.rs:258-538):
the float DF2T (`df2t_step`), the wide-state DF1 with int64 feedback
(`df1_wide_step`, the split-word ``a * y``), the error-feedback DF1
(`df1_dither_step`, scanned by `df1_dither_process`; its u32 error word
is held as int64 in ``[0, 2**32)``), each with its clamp step; the
interleaved cascade (`cascade_step`, `cascade_step_q`); and the float
block path `df1_block_float` (the feedback as an affine prefix scan).

The other storage types of the reference's precision ladder
(``dtype=`` of `df1_step_q` and `cascade_step_q`): Q16, int16 storage
with the sum wrapping in int32 (`df1_process_q(dtype=int16)`), and
Q64, int64 storage with the 128-bit sum of `fxp.I128` (`df1_step_q64`,
`df1_process_q64`).
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


def quantize_ba(ba5: np.ndarray, f: int, *, dtype=np.int32) -> np.ndarray:
    """Quantize normalized float coefficients to Q<f> bits of ``dtype``
    (int16, int32 or int64; round-half-away encode, saturating,
    num_traits_impl.rs:30-45)."""
    return fxp.from_float(ba5, f, dtype=dtype)


class Df1State(NamedTuple):
    """[x1, x2] and [y1, y2] delay lines (biquad.rs:258-303)."""

    x: torch.Tensor  # (..., 2)
    y: torch.Tensor  # (..., 2)


def df1_init(shape=(), dtype=torch.int32, *, device) -> Df1State:
    return Df1State(
        x=torch.zeros(tuple(shape) + (2,), dtype=dtype, device=device),
        y=torch.zeros(tuple(shape) + (2,), dtype=dtype, device=device),
    )


def proportional(k):
    """[k, 0, 0, 0, 0] (biquad.rs:185-198)."""
    ba = np.zeros(5, dtype=np.asarray(k).dtype)
    ba[0] = k
    return ba


def identity(dtype=np.float64):
    return proportional(np.asarray(1.0, dtype=dtype))


def hold(dtype=np.float64):
    """Ingest input, maintain output: [0,0,0,1,0] (biquad.rs:199-212)."""
    ba = np.zeros(5, dtype=dtype)
    ba[3] = 1.0
    return ba


def forward_gain(ba5):
    """b0+b1+b2 (biquad.rs:215-225)."""
    return ba5[..., 0] + ba5[..., 1] + ba5[..., 2]


def from_zpk(zeros, poles, gain, *, complex_zeros=False, complex_poles=False):
    """Biquad from a zero pair, pole pair, and gain (biquad.rs:590-619).

    Pairs are (x, y): real pairs give roots x and y; complex pairs give
    x +- jy.  Matches `Pair::coeff` + `from_zpk`.
    """

    def coeff(pair, is_complex):
        x, y = pair
        if is_complex:
            return x + x, x * x + y * y
        return x + y, x * y

    b = [c * gain for c in coeff(zeros, complex_zeros)]
    a = coeff(poles, complex_poles)
    return np.array([gain, -b[0], b[1], a[0], -a[1]], dtype=np.float64)


def _ba_list(ba) -> list[int]:
    return [int(v) for v in np.asarray(
        ba.cpu() if isinstance(ba, torch.Tensor) else ba
    ).reshape(-1)[:5]]


def _coefs(ba, device):
    """The five fixed-point coefficients of ``ba``: Python ints for one
    shared ``(5,)`` set, else int64 tensors of the lane shape ``...`` for a
    ``(..., 5)`` array (one set per lane, broadcast over time)."""
    if isinstance(ba, torch.Tensor):
        if ba.dim() <= 1:
            return _ba_list(ba)
        planes = ba.to(device=device, dtype=torch.int64)
    else:
        a = np.asarray(ba)
        if a.ndim <= 1:
            return _ba_list(a)
        planes = torch.from_numpy(a.astype(np.int64)).to(device)
    return [planes[..., i] for i in range(5)]


def df1_set_y(state: Df1State, y0) -> Df1State:
    """Bump-less transfer: seed both output taps (biquad.rs:295-302)."""
    y0 = torch.as_tensor(y0, dtype=state.y.dtype, device=state.y.device)
    return state._replace(y=torch.stack([y0, y0], dim=-1))


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


def _acc_wide(coefs, taps, dtype):
    """The five DF1 products of ``coefs`` and ``taps`` summed in the
    accumulator of ``dtype``: an int64 sum for int8-int32 (exact for
    int8/int16, whose quantize wraps it to the accumulator's width), an
    `fxp.I128` for int64."""
    if dtype == torch.int64:
        return sum(fxp.mul_wide(c, v, dtype=torch.int64)
                   for c, v in zip(coefs, taps))
    return sum(c * v.to(torch.int64) for c, v in zip(coefs, taps))


def df1_step_q(ba, f: int, state: Df1State, x0, *, dtype=torch.int32):
    """One fixed-point DF1 step: 5 wide MACs, one truncating shift
    (biquad.rs:366-383 with ``Q<T, A, f>`` coefficients).  ``ba`` is (5,)
    or (..., 5) per lane.  ``dtype`` is the storage type: int32 (int64
    sums), int16 (i16 x i16 products, the sum wrapping in int32, the
    shifted result wrapped to int16; the reference's Q16) or int64 (the
    128-bit `fxp.I128` sum; Q64).  Returns (state, y0)."""
    dtype = fxp.as_dtype(dtype)
    acc = _acc_wide(_coefs(ba, x0.device),
                    (x0, state.x[..., 0], state.x[..., 1],
                     state.y[..., 0], state.y[..., 1]), dtype)
    y0 = fxp.quantize(acc, f, dtype=dtype)
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


def _feed_forward(b0, b1, b2, sx, xs):
    """``(xw, ff)``: the inputs behind the x taps, ``xw`` (t + 2, ...) int64,
    and ``b0*x0 + b1*x1 + b2*x2`` of every row, int64 (wrapping)."""
    xw = torch.cat([sx[..., 1][None], sx[..., 0][None], xs],
                   dim=0).to(torch.int64)
    return xw, b0 * xw[2:] + b1 * xw[1:-1] + b2 * xw[:-2]


def df1_process_q(ba, f: int, state: Df1State, xs, *, clamp=None,
                  dtype=torch.int32):
    """Scan `df1_step_q` over time axis 0 of ``xs`` (..., ``dtype``).

    The feed-forward part ``b0*x0 + b1*x1 + b2*x2`` of every step is
    formed for the whole block at once; only the feedback ``a1*y1 +
    a2*y2`` is sequential.  Sums are int64, wrapping, so the split
    leaves every accumulator — and so every output — bit-identical to
    the step-by-step scan.  ``ba`` is (5,) shared or (..., 5), one set per
    lane.  With ``clamp = (u, lo, hi)`` each output is `clamp_step`'s
    ``clip(y0 + u, lo, hi)`` (int32 ``+ u`` wrapping) before it is fed
    back.  ``dtype`` is the storage type, int32 or int16 (the reference's
    Q16, ``Q<i16, i32, f>``: each sum wrapped to int32 before the shift,
    the output wrapped to int16; no clamp).  Returns (state, ys) with ys
    like xs.
    """
    dtype = fxp.as_dtype(dtype)
    if dtype not in (torch.int32, torch.int16):
        raise ValueError(f"df1_process_q stores int32 or int16, not {dtype}")
    if clamp is not None and dtype != torch.int32:
        raise ValueError("the clamp is for int32 storage")
    b0, b1, b2, a1, a2 = _coefs(ba, xs.device)
    if clamp is not None:
        u, lo, hi = clamp_params(*clamp)
    t = xs.shape[0]
    xw, ff = _feed_forward(b0, b1, b2, state.x, xs)
    y1 = state.y[..., 0].to(torch.int64)
    y2 = state.y[..., 1].to(torch.int64)
    ys = torch.empty_like(ff)
    for i in range(t):
        # the output, held sign-extended in int64 for the next MACs
        if dtype == torch.int16:
            y0 = fxp.wrap_bits(fxp.wrap32(ff[i] + a1 * y1 + a2 * y2) >> f,
                               16)
        elif clamp is None:
            y0 = fxp.wrap32((ff[i] + a1 * y1 + a2 * y2) >> f)
        else:  # wrap32(wrap32(v) + u) == wrap32(v + u): one wrap
            y0 = torch.clamp(fxp.wrap32(((ff[i] + a1 * y1 + a2 * y2) >> f)
                                        + u), lo, hi)
        ys[i] = y0
        y1, y2 = y0, y1
    new_state = Df1State(
        x=torch.stack([xw[-1], xw[-2]], dim=-1).to(dtype),
        y=torch.stack([y1, y2], dim=-1).to(dtype),
    )
    return new_state, ys.to(dtype)


# --- Q64 (int64 storage, 128-bit accumulator) --------------------------------


def df1_step_q64(ba, f: int, state: Df1State, x0):
    """Q64 DF1 step: int64 storage, the five products summed in 128 bits
    (`fxp.I128`), the low 64 bits of the truncating ``>> f`` (the
    reference's ``Q64<61>`` row, tests/embedded/README.md:63, ``Q<i64,
    i128, F>`` of dsp-fixedpoint/src/lib.rs:473-492).  Returns (state,
    y0)."""
    return df1_step_q(ba, f, state, x0, dtype=torch.int64)


def df1_process_q64(ba, f: int, state: Df1State, xs):
    """Scan `df1_step_q64` over time axis 0 of ``xs`` (..., int64).

    The 128-bit feed-forward sums of every row are formed for the block
    at once; the 128-bit sum wraps mod 2^128, so the split leaves every
    output bit-identical to the step-by-step scan.  Returns (state, ys
    int64)."""
    b0, b1, b2, a1, a2 = _coefs(ba, xs.device)
    xs = xs.to(torch.int64)
    xw = torch.cat([state.x[..., 1][None], state.x[..., 0][None], xs],
                   dim=0).to(torch.int64)
    ff = (fxp.mul_wide(b0, xw[2:], dtype=torch.int64)
          + fxp.mul_wide(b1, xw[1:-1], dtype=torch.int64)
          + fxp.mul_wide(b2, xw[:-2], dtype=torch.int64))
    y1 = state.y[..., 0].to(torch.int64)
    y2 = state.y[..., 1].to(torch.int64)
    ys = torch.empty_like(xs)
    for i in range(xs.shape[0]):
        acc = (fxp.I128(ff.hi[i], ff.lo[i])
               + fxp.mul_wide(a1, y1, dtype=torch.int64)
               + fxp.mul_wide(a2, y2, dtype=torch.int64))
        y0 = fxp.quantize(acc, f, dtype=torch.int64)
        ys[i] = y0
        y1, y2 = y0, y1
    new_state = Df1State(x=torch.stack([xw[-1], xw[-2]], dim=-1),
                         y=torch.stack([y1, y2], dim=-1))
    return new_state, ys


# --- DF2T (float) -----------------------------------------------------------


class Df2tState(NamedTuple):
    s: torch.Tensor  # (..., 2)


def df2t_init(shape=(), dtype=torch.float32, *, device) -> Df2tState:
    return Df2tState(s=torch.zeros(tuple(shape) + (2,), dtype=dtype,
                                   device=device))


def df2t_step(ba, state: Df2tState, x0):
    """DF2T step (biquad.rs:418-428)."""
    y0 = state.s[..., 0] + ba[..., 0] * x0
    s0 = state.s[..., 1] + ba[..., 1] * x0 + ba[..., 3] * y0
    s1 = ba[..., 2] * x0 + ba[..., 4] * y0
    return Df2tState(s=torch.stack([s0, s1], dim=-1)), y0


def df2t_clamp_step(ba, state: Df2tState, x0, u, lo, hi):
    """DF2T with offset+clamp at the junction (biquad.rs:430-440)."""
    y0 = torch.clamp(state.s[..., 0] + ba[..., 0] * x0 + u, lo, hi)
    s0 = state.s[..., 1] + ba[..., 1] * x0 + ba[..., 3] * y0
    s1 = ba[..., 2] * x0 + ba[..., 4] * y0
    return Df2tState(s=torch.stack([s0, s1], dim=-1)), y0


# --- DF1 wide (int64 feedback state) ----------------------------------------

_LO32 = 0xFFFFFFFF


class Df1WideState(NamedTuple):
    x: torch.Tensor  # (..., 2) int32
    y: torch.Tensor  # (..., 2) int64


def df1_wide_init(shape=(), *, device) -> Df1WideState:
    return Df1WideState(
        x=torch.zeros(tuple(shape) + (2,), dtype=torch.int32, device=device),
        y=torch.zeros(tuple(shape) + (2,), dtype=torch.int64, device=device),
    )


def check_wide_f(f: int) -> None:
    """The wide and dither steps shift left by ``32 - f``: 0 < f <= 32."""
    if not 0 < f <= 32:
        raise ValueError(f"f must be in (0, 32], got {f}")


def _split_mul(yw, a):
    """The split-word ``a * y`` of a wide feedback word: ``((y_lo as u64 *
    a) >> 32) + y_hi * a``, each product exact in int64."""
    return (((yw & _LO32) * a) >> 32) + (yw >> 32) * a


def df1_wide_step(ba, f: int, state: Df1WideState, x0):
    """Wide-state DF1 step (biquad.rs:456-472).

    The b*x products accumulate in int64; a*y uses the split-word
    multiply, keeping the full int64 output word in feedback.  The sum
    wraps, is shifted left by 32-f (wrapping), and the output is its high
    word.  ``ba`` is (5,) or (..., 5) per lane.  Returns (state, y0 int32).
    """
    check_wide_f(f)
    b0, b1, b2, a1, a2 = _coefs(ba, x0.device)
    y0w, y1w = state.y[..., 0], state.y[..., 1]
    acc = (b0 * x0.to(torch.int64) + b1 * state.x[..., 0].to(torch.int64)
           + b2 * state.x[..., 1].to(torch.int64)
           + _split_mul(y0w, a1) + _split_mul(y1w, a2)) << (32 - f)
    return (
        Df1WideState(x=torch.stack([x0, state.x[..., 0]], dim=-1),
                     y=torch.stack([acc, y0w], dim=-1)),
        (acc >> 32).to(torch.int32),
    )


def df1_wide_clamp_step(ba, f: int, state: Df1WideState, x0, u, lo, hi):
    """Clamped wide DF1 (biquad.rs:474-480): ``clip(y0 + u, lo, hi)``
    (int32 ``+ u`` wrapping) replaces the high word of the new feedback
    word; its low word is kept."""
    state, y0 = df1_wide_step(ba, f, state, x0)
    y0 = torch.clamp(fxp.wrap_i32(y0.to(torch.int64) + int(u)), lo, hi)
    y0w = (y0.to(torch.int64) << 32) | (state.y[..., 0] & _LO32)
    return state._replace(y=torch.stack([y0w, state.y[..., 1]], dim=-1)), y0


def df1_wide_process(ba, f: int, state: Df1WideState, xs, *, clamp=None):
    """Scan `df1_wide_step` (with ``clamp = (u, lo, hi)``:
    `df1_wide_clamp_step`) over time axis 0 of ``xs`` (..., int32).

    The feed-forward ``b0*x0 + b1*x1 + b2*x2`` of every step is formed
    for the whole block at once; only the feedback is sequential.  Sums
    wrap in int64, so every word is bit-identical to the step-by-step
    scan.  Returns (state, ys) with ys like xs.
    """
    check_wide_f(f)
    b0, b1, b2, a1, a2 = _coefs(ba, xs.device)
    if clamp is not None:
        u, lo, hi = clamp_params(*clamp)
    xw, ff = _feed_forward(b0, b1, b2, state.x, xs)
    y1w, y2w = state.y[..., 0], state.y[..., 1]
    ys = torch.empty_like(ff)
    for i in range(xs.shape[0]):
        acc = (ff[i] + _split_mul(y1w, a1) + _split_mul(y2w, a2)) << (32 - f)
        if clamp is None:
            y0 = acc >> 32
            y0w = acc
        else:
            y0 = torch.clamp(fxp.wrap32((acc >> 32) + u), lo, hi)
            y0w = (y0 << 32) | (acc & _LO32)
        ys[i] = y0
        y1w, y2w = y0w, y1w
    new_state = Df1WideState(
        x=torch.stack([xw[-1], xw[-2]], dim=-1).to(torch.int32),
        y=torch.stack([y1w, y2w], dim=-1),
    )
    return new_state, ys.to(torch.int32)


# --- DF1 dither (error feedback) --------------------------------------------


class Df1DitherState(NamedTuple):
    xy: Df1State  # int32 delay lines
    e: torch.Tensor  # (...,) the u32 error word, int64 in [0, 2**32)


def df1_dither_init(shape=(), *, device) -> Df1DitherState:
    return Df1DitherState(
        xy=df1_init(shape, torch.int32, device=device),
        e=torch.zeros(tuple(shape), dtype=torch.int64, device=device),
    )


def df1_dither_step(ba, f: int, state: Df1DitherState, x0):
    """DF1 with first-order error feedback (biquad.rs:511-530): the
    truncated fraction re-enters the accumulator next sample.  Returns
    (state, y0 int32)."""
    check_wide_f(f)
    b0, b1, b2, a1, a2 = _coefs(ba, x0.device)
    xy = state.xy
    acc = (state.e + b0 * x0.to(torch.int64)
           + b1 * xy.x[..., 0].to(torch.int64)
           + b2 * xy.x[..., 1].to(torch.int64)
           + a1 * xy.y[..., 0].to(torch.int64)
           + a2 * xy.y[..., 1].to(torch.int64)) << (32 - f)
    y0 = (acc >> 32).to(torch.int32)
    return (
        Df1DitherState(
            xy=Df1State(x=torch.stack([x0, xy.x[..., 0]], dim=-1),
                        y=torch.stack([y0, xy.y[..., 0]], dim=-1)),
            e=(acc & _LO32) >> (32 - f),
        ),
        y0,
    )


def df1_dither_clamp_step(ba, f: int, state: Df1DitherState, x0, u, lo, hi):
    """Clamped dithered DF1 (biquad.rs:532-538)."""
    state, y0 = df1_dither_step(ba, f, state, x0)
    y0 = torch.clamp(fxp.wrap_i32(y0.to(torch.int64) + int(u)), lo, hi)
    xy = state.xy._replace(y=torch.stack([y0, state.xy.y[..., 1]], dim=-1))
    return state._replace(xy=xy), y0


def df1_dither_process(ba, f: int, state: Df1DitherState, xs, *,
                       clamp=None):
    """Scan `df1_dither_step` (with ``clamp = (u, lo, hi)``:
    `df1_dither_clamp_step`) over time axis 0 of ``xs`` (..., int32).

    The feed-forward ``b0*x0 + b1*x1 + b2*x2`` of every row is formed for
    the block at once; the sums wrap in int64, so every output and error
    word is bit-identical to the step-by-step scan.  ``ba`` is (5,) or
    (..., 5) per lane.  Returns (state, ys int32)."""
    check_wide_f(f)
    b0, b1, b2, a1, a2 = _coefs(ba, xs.device)
    if clamp is not None:
        u, lo, hi = clamp_params(*clamp)
    xw, ff = _feed_forward(b0, b1, b2, state.xy.x, xs)
    y1 = state.xy.y[..., 0].to(torch.int64)
    y2 = state.xy.y[..., 1].to(torch.int64)
    e = state.e
    ys = torch.empty_like(ff)
    for i in range(xs.shape[0]):
        acc = (e + ff[i] + a1 * y1 + a2 * y2) << (32 - f)
        e = (acc & _LO32) >> (32 - f)
        y0 = acc >> 32
        if clamp is not None:
            y0 = torch.clamp(fxp.wrap32(y0 + u), lo, hi)
        ys[i] = y0
        y1, y2 = y0, y1
    new_state = Df1DitherState(
        xy=Df1State(x=torch.stack([xw[-1], xw[-2]], dim=-1).to(torch.int32),
                    y=torch.stack([y1, y2], dim=-1).to(torch.int32)),
        e=e)
    return new_state, ys.to(torch.int32)


# --- cascades ---------------------------------------------------------------


def cascade_init(n_stages: int, shape=(), dtype=torch.float32, *,
                 device) -> Df1State:
    """Interleaved cascade state: x (..., 2) + y (..., n_stages, 2)
    (biquad.rs:321-364 `DirectForm<T, N>`)."""
    return Df1State(
        x=torch.zeros(tuple(shape) + (2,), dtype=dtype, device=device),
        y=torch.zeros(tuple(shape) + (n_stages, 2), dtype=dtype,
                      device=device),
    )


def _cascade_step(ba, state: Df1State, x0, stage_out):
    """One sample through the cascade: stage i reads the previous stage's
    [y1, y2] as its x taps; ``stage_out(i, acc terms)`` forms y0."""
    cur = x0
    prev_x = state.x
    new_x = state.x
    ys = []
    for i in range(ba.shape[0]):
        y = state.y[..., i, :]
        y0 = stage_out(i, cur, prev_x, y)
        if i == 0:
            new_x = torch.stack([cur, prev_x[..., 0]], dim=-1)
        prev_x = y
        ys.append(torch.stack([y0, y[..., 0]], dim=-1))
        cur = y0
    return Df1State(x=new_x, y=torch.stack(ys, dim=-2)), cur


def cascade_step(ba, state: Df1State, x0):
    """One sample through an N-stage float cascade (biquad.rs:339-364).
    ``ba``: (n_stages, ..., 5) tensor of the state's dtype."""
    def out(i, cur, px, y):
        return (ba[i, ..., 0] * cur + ba[i, ..., 1] * px[..., 0]
                + ba[i, ..., 2] * px[..., 1] + ba[i, ..., 3] * y[..., 0]
                + ba[i, ..., 4] * y[..., 1])

    return _cascade_step(ba, state, x0, out)


def cascade_step_q(ba, f: int, state: Df1State, x0, *, dtype=torch.int32):
    """Fixed-point cascade step (the `sos` path, src/py.rs:51-74 /
    biquad.rs:339-364): each stage quantizes at its summing junction.
    ``ba``: (n_stages, ..., 5) Q<f> of the storage ``dtype`` (int16,
    int32 or int64, as `df1_step_q`)."""
    dtype = fxp.as_dtype(dtype)
    ba = torch.as_tensor(ba, dtype=torch.int64, device=x0.device)

    def out(i, cur, px, y):
        w = (cur, px[..., 0], px[..., 1], y[..., 0], y[..., 1])
        acc = _acc_wide([ba[i, ..., k] for k in range(5)], w, dtype)
        return fxp.quantize(acc, f, dtype=dtype)

    return _cascade_step(ba, state, x0, out)


# --- scan drivers and the float block path ----------------------------------


def process(step_fn, state, xs):
    """Scan ``step_fn(state, x) -> (state, y)`` over time axis 0 of xs;
    returns (state, ys) with the y tensors stacked on axis 0."""
    ys = []
    for i in range(xs.shape[0]):
        state, y = step_fn(state, xs[i])
        ys.append(y)
    return state, torch.stack(ys, dim=0)


def _affine_combine(a, b):
    """Compose affine maps s -> M s + v of the 2nd-order feedback (b after
    a), the 2x2 matrix and 2-vector as six component tensors."""
    a11, a12, a21, a22, u1, u2 = a
    b11, b12, b21, b22, w1, w2 = b
    return (
        b11 * a11 + b12 * a21,
        b11 * a12 + b12 * a22,
        b21 * a11 + b22 * a21,
        b21 * a12 + b22 * a22,
        b11 * u1 + b12 * u2 + w1,
        b21 * u1 + b22 * u2 + w2,
    )


def _prefix_scan(elems):
    """Inclusive prefix of `_affine_combine` over axis 0 (Hillis-Steele:
    log2(n) rounds of combining each element with the one d rows back)."""
    n = elems[0].shape[0]
    d = 1
    while d < n:
        head = tuple(e[:d] for e in elems)
        tail = _affine_combine(tuple(e[:-d] for e in elems),
                               tuple(e[d:] for e in elems))
        elems = tuple(torch.cat([h, t], dim=0) for h, t in zip(head, tail))
        d *= 2
    return elems


def df1_block_float(ba, state: Df1State, xs):
    """Float DF1 over a block: the feed-forward as a shifted-window sum,
    then the 2nd-order feedback as a prefix scan of affine maps.

    xs: (n, ...) time-major; ``ba`` (..., 5) a tensor of xs's dtype.
    Returns (state, ys) matching `df1_step` scanned over xs up to FP
    reassociation (the prefix combines in another order than the scan).
    """
    n = xs.shape[0]
    x1 = torch.cat([state.x[None, ..., 0], xs[:-1]], dim=0)
    x2 = torch.cat([state.x[None, ..., 1], state.x[None, ..., 0], xs[:-2]],
                   dim=0)[:n]
    v = ba[..., 0] * xs + ba[..., 1] * x1 + ba[..., 2] * x2
    a1 = torch.broadcast_to(ba[..., 3], v.shape)
    a2 = torch.broadcast_to(ba[..., 4], v.shape)
    one, zero = torch.ones_like(v), torch.zeros_like(v)
    m11, m12, m21, m22, v1, v2 = _prefix_scan((a1, a2, one, zero, v, zero))
    y1_0, y2_0 = state.y[..., 0], state.y[..., 1]
    ys = m11 * y1_0 + m12 * y2_0 + v1  # y[k]
    ys_prev = m21 * y1_0 + m22 * y2_0 + v2  # y[k-1]
    new_state = Df1State(
        x=torch.stack([xs[-1], xs[-2] if n >= 2 else state.x[..., 0]],
                      dim=-1),
        y=torch.stack([ys[-1], ys_prev[-1]], dim=-1),
    )
    return new_state, ys
