"""Array-in/array-out compatibility surface (port of `idsp_tpu.compat`).

The four entry points the reference exposes to Python via PyO3
(src/py.rs:1-109), on tensors:

* ``cossin(p)``: i32[N] phases -> i32[N, 2] (cos, sin)
* ``atan2(xy)``: i32[N, 2] [[x, y]] -> i32[N] angles
* ``sos(sos, xy)``: quantize (N, 6) f64 cookbook SOS rows to Q32<29>
  and filter an i32 array through the cascade: K24 `sos_bank_q`
* ``sos_clamp_wide(sos, xy)``: (N, 9) rows [b0,b1,b2,a0,a1,a2,u,min,
  max] through clamped wide-state DF1 stages: one K25 `df1_wide_bank`
  launch a stage

Each takes a required ``device``: the input goes there, a CUDA device
runs the kernels and the CPU their plain versions.  Time is axis 0; any
trailing shape is a bank of lanes (1-D input is one lane), which gives
each lane the bits it would get alone.  Results are tensors on
``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .filters import biquad
from .filters.biquad_cuda import df1_wide_bank, sos_bank_q
from .ops import trig


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device).to(torch.int32)


def cossin(p, *, device):
    """i32[N] -> i32[N, 2] (py.rs:10-28)."""
    c, s = trig.cossin(_i32(p, device))
    return torch.stack([c, s], dim=-1)


def atan2(xy, *, device):
    """i32[N, 2] of [x, y] -> i32[N] (py.rs:30-46): atan2(y, x)."""
    xy = _i32(xy, device)
    return trig.atan2(xy[..., 1], xy[..., 0])


def _round_sat_i32(v: float) -> int:
    v = float(np.trunc(v + np.copysign(0.5, v))) if np.isfinite(v) else v
    if np.isnan(v):
        return 0
    return int(np.clip(v, -(2**31), 2**31 - 1))


def _bank(xy, device):
    """(t, ...) int32 input as a contiguous (t, lanes) bank."""
    y = _i32(xy, device)
    return y.reshape(y.shape[0], -1).contiguous(), y.shape


def sos(sos_rows, xy, *, f: int = 29, device):
    """Quantize (N, 6) cookbook SOS rows to Q32<f> and filter the i32
    array through the stage-major DF1 cascade (py.rs:48-74).

    Returns the filtered array (the reference mutates in place).
    """
    rows = np.asarray(sos_rows, np.float64).reshape(-1, 6)
    ba_q = biquad.quantize_ba(biquad.from_cookbook(rows.reshape(-1, 2, 3)), f)
    y, shape = _bank(xy, device)
    states = [biquad.df1_init(y.shape[1:], device=device) for _ in ba_q]
    _, y = sos_bank_q(ba_q, states, y, f)
    return y.reshape(shape)


def sos_clamp_wide(sos_rows, xy, *, f: int = 29, device):
    """(N, 9) rows [b0,b1,b2,a0,a1,a2,u,min,max] through clamped
    wide-error-feedback DF1 stages (py.rs:76-108)."""
    rows = np.asarray(sos_rows, np.float64).reshape(-1, 9)
    ba_q = biquad.quantize_ba(biquad.from_cookbook(rows[:, :6].reshape(
        -1, 2, 3)), f)
    y, shape = _bank(xy, device)
    for i, stage in enumerate(ba_q):
        clamp = tuple(_round_sat_i32(v) for v in rows[i, 6:9])
        st = biquad.df1_wide_init(y.shape[1:], device=device)
        _, y = df1_wide_bank(stage, st, y, f, clamp=clamp)
    return y.reshape(shape)
