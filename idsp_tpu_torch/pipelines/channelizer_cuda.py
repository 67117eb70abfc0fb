"""K17: the one-kernel polyphase channelizer, FIR + cast + DFT (port of
`idsp_tpu.pipelines.channelizer_pallas.channelize_fused`).

`channelize_fused` runs the CUDA kernel of ``csrc/channelize.cu`` for
CUDA tensors and its plain PyTorch version, `channelize_fused_plain`,
for CPU tensors; any other device raises.  The plain version is the
kernel's function: the polyphase FIR in the kernel's tap order (tap 0
newest, each product and sum rounded on its own), the cast to the
twiddle dtype, then four ``(n, m) x (m, m)`` products with f32
accumulation combined as ``yr = ar wr - ai wi``, ``yi = ar wi + ai wr``
(channelizer_pallas.py:136-158).  Kernel and plain version hold the same
FIR output and twiddles bit for bit and differ only in the order of the
products' sums; the carried history is a copy of input rows.
"""

from __future__ import annotations

import torch

from .. import _ext
from .channelizer import (
    PlanesState,
    coefficients,
    full_f32_matmul,
    polyphase_fir,
    twiddles,
)

TWIDDLE_DTYPES = (torch.float32, torch.bfloat16)
MAX_TAPS = 16  # csrc/channelize.cu kMaxTaps


def _check(m: int, taps: int, twiddle_dtype) -> None:
    if twiddle_dtype not in TWIDDLE_DTYPES:
        raise ValueError(f"twiddle_dtype must be one of {TWIDDLE_DTYPES}, "
                         f"got {twiddle_dtype}")
    if not 2 <= taps <= MAX_TAPS:
        raise ValueError(f"need 2 <= taps <= {MAX_TAPS}, got {taps}")
    if m < 128 or m % 128:
        raise ValueError(f"m must be a multiple of 128, got {m}")


def channelize_fused_plain(state: PlanesState, zr, zi, proto=None, *, m: int,
                           taps: int = 8, twiddle_dtype=torch.bfloat16):
    """Plain PyTorch version of `channelize_fused`."""
    _check(m, taps, twiddle_dtype)
    coeff = torch.from_numpy(coefficients(proto, m, taps)).to(zr.device)
    accr, hist_r = polyphase_fir(state.hist_r, zr, coeff)
    acci, hist_i = polyphase_fir(state.hist_i, zi, coeff)
    wr, wi = (w.float() for w in twiddles(m, twiddle_dtype, zr.device))
    # bf16 x bf16 products are exact in f32: the f32 products of the
    # rounded operands, summed in f32
    ar = accr.to(twiddle_dtype).float()
    ai = acci.to(twiddle_dtype).float()
    with full_f32_matmul():
        yr = ar @ wr - ai @ wi
        yi = ar @ wi + ai @ wr
    return PlanesState(hist_r=hist_r, hist_i=hist_i), yr, yi


def channelize_fused(state: PlanesState, zr, zi, proto=None, *, m: int,
                     taps: int = 8, twiddle_dtype=torch.bfloat16):
    """Fused planes-layout analysis bank in one kernel.

    Args:
      state: `PlanesState` with hist planes (taps-1, m) f32.
      zr, zi: (n, m) f32 I/Q frame planes, n >= 1, m % 128 == 0.
      proto: (m*taps,) prototype (`channelizer.prototype` for None).
      taps: 2 <= taps <= 16.
      twiddle_dtype: torch.bfloat16 (tensor cores; the FIR output and the
        DFT matrix rounded to bf16) or torch.float32 (CUDA-core f32
        products).

    Returns (state, yr, yi) with yr, yi (n, m) f32.
    """
    if zr.device.type == "cpu":
        return channelize_fused_plain(state, zr, zi, proto, m=m, taps=taps,
                                      twiddle_dtype=twiddle_dtype)
    _check(m, taps, twiddle_dtype)
    n = zr.shape[0]
    h = taps - 1
    dev = zr.device
    if n < 1:
        raise ValueError("need at least one frame")
    _ext.require("zr", zr, dev, torch.float32, (n, m))
    _ext.require("zi", zi, dev, torch.float32, (n, m))
    _ext.require("state.hist_r", state.hist_r, dev, torch.float32, (h, m))
    _ext.require("state.hist_i", state.hist_i, dev, torch.float32, (h, m))
    coeff = torch.from_numpy(coefficients(proto, m, taps)).to(dev)
    wr, wi = twiddles(m, twiddle_dtype, dev)
    yr = torch.empty((n, m), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    hist_r = torch.empty_like(state.hist_r)
    hist_i = torch.empty_like(state.hist_i)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_channelize(
            zr.data_ptr(), zi.data_ptr(), state.hist_r.data_ptr(),
            state.hist_i.data_ptr(), coeff.data_ptr(), wr.data_ptr(),
            wi.data_ptr(), yr.data_ptr(), yi.data_ptr(), hist_r.data_ptr(),
            hist_i.data_ptr(), n, m, taps,
            int(twiddle_dtype == torch.bfloat16), _ext.stream_ptr(dev),
        )
    _ext.check(err, "channelize_fused")
    channelize_fused.launches += 1
    return PlanesState(hist_r=hist_r, hist_i=hist_i), yr, yi


channelize_fused.launches = 0  # kernel launches since the last reset
