"""Unity-DC-gain 1st/2nd-order integer lowpass (port of
`idsp_tpu.filters.lowpass`, reference src/lowpass.rs).

i32 I/O with i64 state, the double update that creates a Nyquist zero
while keeping the LSB significant, and a saturating input subtraction.
The int64 sums wrap as in the JAX package (two's complement).

Gains (lowpass.rs:28-46): N=1 takes ``[k]``, k = pi*2^31*f0 (warped);
N=2 takes ``[k^2 >> 32, -k/q]``, q = 1/sqrt(2) for Butterworth.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


class LowpassState(NamedTuple):
    p: torch.Tensor  # (..., N) int64 wide state


def init(n: int, shape=(), *, device) -> LowpassState:
    if n not in (1, 2):
        raise ValueError(f"lowpass order must be 1 or 2, got {n}")
    return LowpassState(
        p=torch.zeros(tuple(shape) + (n,), dtype=torch.int64, device=device))


def gains1(f0: float) -> np.ndarray:
    """First-order gain ``[k]`` from the relative corner frequency
    (pre-warped, lowpass.rs:31-37)."""
    k = np.pi * (1 << 31) * f0
    return np.array([min(int(round(k)), (1 << 31) - 1)], dtype=np.int32)


def gains2(f0: float, q: float = 1.0 / np.sqrt(2.0)) -> np.ndarray:
    """Second-order gains ``[k^2 >> 32, -k/q]`` (lowpass.rs:39-41)."""
    k = np.pi * (1 << 31) * f0
    return np.array(
        [int(round(k * k / (1 << 32))), -int(round(k / q))], dtype=np.int32
    )


def _gains(k) -> list[int]:
    return [int(v) for v in np.asarray(
        k.cpu() if isinstance(k, torch.Tensor) else k).reshape(-1)]


def _sat_sub_i32(a, b):
    """``a - b`` of int32 values (held in int64) saturating in i32
    (lowpass.rs:55 `saturating_sub`)."""
    return torch.clamp(a - b, _I32_MIN, _I32_MAX)


def _step_words(k: list[int], p0, p1, x):
    """One sample (lowpass.rs:48-77) on the state words: p0, p1 int64
    (p1 None for N = 1), x int64 holding int32 values.  Returns
    (p0, p1, y) with y int64 holding the int32 output."""
    d = _sat_sub_i32(x, p0 >> 32) * k[0]
    if p1 is None:
        p0 = p0 + d
        return p0 + d, None, p0 >> 32
    d = d + (p1 >> 32) * k[1]
    p1 = p1 + d
    p0 = p0 + p1
    return p0 + p1, p1 + d, p0 >> 32


def _words(k, state: LowpassState):
    """Gains as ints and the state's words (p0, p1 or None), checked."""
    k = _gains(k)
    n = state.p.shape[-1]
    if n != len(k) or n not in (1, 2):
        raise ValueError(f"{len(k)} gains for a lowpass of order {n}")
    return k, state.p[..., 0], state.p[..., 1] if n == 2 else None


def _state(p0, p1) -> LowpassState:
    return LowpassState(
        p=p0[..., None] if p1 is None else torch.stack([p0, p1], dim=-1))


def step(k, state: LowpassState, x):
    """One sample (lowpass.rs:48-77). k: (N,) gains; x: (...,) int32.
    Returns (state, y int32)."""
    k, p0, p1 = _words(k, state)
    p0, p1, y = _step_words(k, p0, p1, x.to(torch.int64))
    return _state(p0, p1), y.to(torch.int32)


def block(k, state: LowpassState, xs):
    """`step` scanned over time axis 0 of ``xs`` (t, ...) int32, the
    state words carried as separate tensors.  Returns (state, ys) with
    ys (t, ...) int32."""
    k, p0, p1 = _words(k, state)
    xw = xs.to(torch.int64)
    ys = torch.empty_like(xw)
    for i in range(xs.shape[0]):
        p0, p1, ys[i] = _step_words(k, p0, p1, xw[i])
    return _state(p0, p1), ys.to(torch.int32)
