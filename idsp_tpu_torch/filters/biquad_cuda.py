"""K1, K11 and K18: the fixed-point DF1 biquad bank (port of
`idsp_tpu.filters.biquad_pallas.df1_bank_q`, `df1_bank_q_dec` and
`df1_clamp_bank_q`).

`df1_bank_q`, `df1_bank_q_dec` and `df1_clamp_bank_q` run the CUDA
kernels of ``csrc/df1_bank.cu`` for a CUDA tensor and their plain
PyTorch versions (``*_plain``) for a CPU tensor; any other device
raises.  K1 and K11 are bit-identical to `biquad.df1_process_q` (K11:
then ``ys[::d]``), K18 to `biquad.df1_clamp_process_q`.
"""

from __future__ import annotations

import torch

from .. import _ext
from .biquad import (
    Df1State,
    _ba_list,
    clamp_params,
    df1_clamp_process_q,
    df1_process_q,
)


def df1_bank_q_plain(ba, state: Df1State, xs, f: int = 29, *,
                     out_dtype=None):
    """Plain PyTorch version of `df1_bank_q`: the scan plus the cast."""
    state, ys = df1_process_q(ba, f, state, xs)
    return state, ys if out_dtype is None else ys.to(out_dtype)


def _launch(name, ba, state: Df1State, xs, f, out_dtype, d=None,
            clamp=None):
    """Validate and launch K1 (``d`` None), K11 or K18 (``clamp``) on a
    CUDA tensor."""
    if out_dtype not in (None, torch.int32, torch.float32):
        raise ValueError(f"out_dtype must be int32 or float32, got {out_dtype}")
    if not 0 < f < 64:
        raise ValueError(f"f must be in (0, 64), got {f}")
    t, c = xs.shape
    if d is not None:
        check_dec(t, d)
    dev = xs.device
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    _ext.require("state.x", state.x, dev, torch.int32, (c, 2))
    _ext.require("state.y", state.y, dev, torch.int32, (c, 2))
    f32 = out_dtype == torch.float32
    ys = torch.empty((t // (d or 1), c),
                     dtype=torch.float32 if f32 else torch.int32, device=dev)
    new_x = torch.empty_like(state.x)
    new_y = torch.empty_like(state.y)
    ptrs = (xs.data_ptr(), ys.data_ptr(), state.x.data_ptr(),
            state.y.data_ptr(), new_x.data_ptr(), new_y.data_ptr(), t, c)
    lib = _ext.library()
    with torch.cuda.device(dev):
        if clamp is not None:
            err = lib.idsp_df1_clamp_bank_q(*ptrs, f, *_ba_list(ba), *clamp,
                                            _ext.stream_ptr(dev))
        elif d is None:
            err = lib.idsp_df1_bank_q(*ptrs, f, int(f32), *_ba_list(ba),
                                      _ext.stream_ptr(dev))
        else:
            err = lib.idsp_df1_bank_q_dec(*ptrs, d, f, int(f32),
                                          *_ba_list(ba), _ext.stream_ptr(dev))
    _ext.check(err, name)
    return Df1State(x=new_x, y=new_y), ys


def df1_bank_q(ba, state: Df1State, xs, f: int = 29, *, out_dtype=None):
    """Fixed-point DF1 biquad over a bank of lanes.

    Args:
      ba: (5,) i32 Q<f> coefficients shared by all lanes.
      state: Df1State with x/y (c, 2) int32.
      xs: (t, c) int32.
      f: fractional bits, 0 < f < 64.
      out_dtype: None (int32) or torch.float32 (the cast is done in the
        kernel's store; the state stays exact int32).

    Returns (state, ys), bit-identical to `df1_process_q` scanned.
    """
    if xs.device.type == "cpu":
        return df1_bank_q_plain(ba, state, xs, f, out_dtype=out_dtype)
    out = _launch("df1_bank_q", ba, state, xs, f, out_dtype)
    df1_bank_q.launches += 1
    return out


df1_bank_q.launches = 0  # kernel launches since the last reset


def check_dec(t: int, d: int) -> None:
    if d < 1 or t % d:
        raise ValueError(f"need d >= 1 dividing t, got t={t}, d={d}")


def df1_bank_q_dec_plain(ba, state: Df1State, xs, f: int = 29, *,
                         d: int = 16, out_dtype=None):
    """Plain PyTorch version of `df1_bank_q_dec`: the scan, the kept
    rows 0, d, 2d, ..., the cast."""
    check_dec(xs.shape[0], d)
    state, ys = df1_process_q(ba, f, state, xs)
    ys = ys[::d].contiguous()
    return state, ys if out_dtype is None else ys.to(out_dtype)


def df1_bank_q_dec(ba, state: Df1State, xs, f: int = 29, *, d: int = 16,
                   out_dtype=None):
    """`df1_bank_q` keeping only the rows 0, d, 2d, ... of its output
    (``ys[::d]``, t % d == 0); the state carries the full-rate
    recurrence.  Returns (state, ys) with ys (t // d, c)."""
    if xs.device.type == "cpu":
        return df1_bank_q_dec_plain(ba, state, xs, f, d=d, out_dtype=out_dtype)
    out = _launch("df1_bank_q_dec", ba, state, xs, f, out_dtype, d)
    df1_bank_q_dec.launches += 1
    return out


df1_bank_q_dec.launches = 0  # kernel launches since the last reset


def df1_clamp_bank_q_plain(ba, state: Df1State, xs, f: int = 29, *,
                           u: int = 0, lo: int, hi: int):
    """Plain PyTorch version of `df1_clamp_bank_q`: the clamped scan."""
    return df1_clamp_process_q(ba, f, state, xs, u=u, lo=lo, hi=hi)


def df1_clamp_bank_q(ba, state: Df1State, xs, f: int = 29, *, u: int = 0,
                     lo: int, hi: int):
    """Fixed-point DF1 with summing-junction offset and output clamp
    (anti-windup, biquad.rs:394-404) over a bank of lanes: each output is
    ``clip(y0 + u, lo, hi)`` (int32 ``+ u`` wrapping, ``lo > hi`` gives
    ``hi``), and the clamped value is what the recurrence feeds back.

    Args as `df1_bank_q`, plus the int32 clamp ``u, lo, hi``; the output
    is int32.  Returns (state, ys), bit-identical to scanning
    ``clamp_step(df1_step_q(...))`` (`biquad.df1_clamp_process_q`).
    """
    if xs.device.type == "cpu":
        return df1_clamp_bank_q_plain(ba, state, xs, f, u=u, lo=lo, hi=hi)
    out = _launch("df1_clamp_bank_q", ba, state, xs, f, None,
                  clamp=clamp_params(u, lo, hi))
    df1_clamp_bank_q.launches += 1
    return out


df1_clamp_bank_q.launches = 0  # kernel launches since the last reset
