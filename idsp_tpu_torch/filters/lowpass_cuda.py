"""K4: the integer lowpass bank (port of
`idsp_tpu.filters.lowpass_pallas.lowpass_bank`).

`lowpass_bank` runs the CUDA kernel of ``csrc/lowpass_bank.cu`` for a
CUDA tensor and its plain PyTorch version, `lowpass_bank_plain`, for a
CPU tensor; any other device raises.  Both are bit-identical to
`lowpass.block` followed by ``ys[::dec]``.
"""

from __future__ import annotations

import torch

from .. import _ext
from .lowpass import LowpassState, _gains, block


def _check_dec(t: int, dec: int) -> None:
    if dec < 1 or t % dec:
        raise ValueError(f"need dec >= 1 dividing t, got t={t}, dec={dec}")


def lowpass_bank_plain(k, state: LowpassState, xs, *, dec: int = 1):
    """Plain PyTorch version of `lowpass_bank`: the scan, then the kept
    rows 0, dec, 2*dec, ..."""
    _check_dec(xs.shape[0], dec)
    state, ys = block(k, state, xs)
    return state, ys[::dec].contiguous()


def lowpass_bank(k, state: LowpassState, xs, *, dec: int = 1):
    """Integer Lowpass<N> (N = 1 or 2) over a bank of lanes.

    Args:
      k: (N,) i32 gains (`lowpass.gains1` / `gains2`).
      state: LowpassState with p (c, N) int64.
      xs: (t, c) int32.
      dec: keep-1-in-dec output (== ``ys[::dec]``, t % dec == 0); the
        state carries the full-rate recurrence.

    Returns (state, ys) with ys (t // dec, c) int32.
    """
    if xs.device.type == "cpu":
        return lowpass_bank_plain(k, state, xs, dec=dec)
    gains = _gains(k)
    n = len(gains)
    if n not in (1, 2):
        raise ValueError(f"need 1 or 2 gains, got {n}")
    t, c = xs.shape
    _check_dec(t, dec)
    dev = xs.device
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    _ext.require("state.p", state.p, dev, torch.int64, (c, n))
    ys = torch.empty((t // dec, c), dtype=torch.int32, device=dev)
    p_out = torch.empty_like(state.p)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_lowpass_bank(
            xs.data_ptr(), ys.data_ptr(), state.p.data_ptr(),
            p_out.data_ptr(), t, c, n, dec, gains[0],
            gains[1] if n == 2 else 0, _ext.stream_ptr(dev),
        )
    _ext.check(err, "lowpass_bank")
    lowpass_bank.launches += 1
    return LowpassState(p=p_out), ys


lowpass_bank.launches = 0  # kernel launches since the last reset
