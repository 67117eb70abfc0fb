"""K1: the fixed-point DF1 biquad bank (port of
`idsp_tpu.filters.biquad_pallas.df1_bank_q`).

`df1_bank_q` runs the CUDA kernel of ``csrc/df1_bank.cu`` for a CUDA
tensor and its plain PyTorch version, `df1_bank_q_plain`, for a CPU
tensor; any other device raises.  Both are bit-identical to
`biquad.df1_process_q`.
"""

from __future__ import annotations

import torch

from .. import _ext
from .biquad import Df1State, _ba_list, df1_process_q


def df1_bank_q_plain(ba, state: Df1State, xs, f: int = 29, *,
                     out_dtype=None):
    """Plain PyTorch version of `df1_bank_q`: the scan plus the cast."""
    state, ys = df1_process_q(ba, f, state, xs)
    return state, ys if out_dtype is None else ys.to(out_dtype)


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
    if out_dtype not in (None, torch.int32, torch.float32):
        raise ValueError(f"out_dtype must be int32 or float32, got {out_dtype}")
    if not 0 < f < 64:
        raise ValueError(f"f must be in (0, 64), got {f}")
    t, c = xs.shape
    dev = xs.device
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    _ext.require("state.x", state.x, dev, torch.int32, (c, 2))
    _ext.require("state.y", state.y, dev, torch.int32, (c, 2))
    f32 = out_dtype == torch.float32
    ys = torch.empty((t, c), dtype=torch.float32 if f32 else torch.int32,
                     device=dev)
    new_x = torch.empty_like(state.x)
    new_y = torch.empty_like(state.y)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_df1_bank_q(
            xs.data_ptr(), ys.data_ptr(), state.x.data_ptr(),
            state.y.data_ptr(), new_x.data_ptr(), new_y.data_ptr(), t, c, f,
            int(f32), *_ba_list(ba), _ext.stream_ptr(dev),
        )
    _ext.check(err, "df1_bank_q")
    df1_bank_q.launches += 1
    return Df1State(x=new_x, y=new_y), ys


df1_bank_q.launches = 0  # kernel launches since the last reset
