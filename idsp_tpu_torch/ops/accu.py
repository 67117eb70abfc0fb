"""Wrapping phase accumulator — closed form (port of `idsp_tpu.ops.accu`).

The reference `Accu` (src/accu.rs:15-62) is a per-sample ``state +=
step``; here the ramp is ``phase0 + step * (1..n)``, computed in int64
and wrapped to int32 (mod 2^32) explicitly.
"""

from __future__ import annotations

import torch

from ..fxp import wrap_i32


def _idx(n: int, device) -> torch.Tensor:
    return torch.arange(1, n + 1, dtype=torch.int64, device=device)


def ramp(state, step, n: int):
    """The next ``n`` accumulator outputs after ``state``:
    ``out[..., i] = state + step * (i + 1)``, wrapping; shape (..., n)."""
    state = state.to(torch.int64)
    step = step.to(torch.int64)
    return wrap_i32(state[..., None] + step[..., None] * _idx(n, state.device))


def advance(state, step, n: int):
    """State after ``n`` steps (wrapping): the carry for the next block."""
    return wrap_i32(state.to(torch.int64) + step.to(torch.int64) * n)


def ramp_t(state, step, n: int):
    """Time-major `ramp`: ``out[i, ...] = state + step * (i + 1)``."""
    state = state.to(torch.int64)
    step = step.to(torch.int64)
    idx = _idx(n, state.device).reshape((n,) + (1,) * state.ndim)
    return wrap_i32(state[None] + step[None] * idx)
