"""K5: the PLL bank (port of `idsp_tpu.filters.pll_pallas.pll_bank`).

`pll_bank` runs the CUDA kernel of ``csrc/pll_bank.cu`` for a CUDA
tensor and its plain PyTorch version, `pll_bank_plain`, for a CPU
tensor; any other device raises.  Both are bit-identical to `pll.block`.

The kernel takes the seven state words as int32/int64 arrays: the int8
clamp indicator is widened for it and narrowed back, as the TPU kernel's
packed carry did (pll_pallas.py:127, 149).
"""

from __future__ import annotations

import torch

from .. import _ext
from ..ops.unwrap import ClampWrapState
from .pll import PllState, ba_list, block

_I32, _I64 = torch.int32, torch.int64
# kernel order of the state words (csrc/pll.cuh PllWords)
_WORD_DTYPES = (_I32, _I32, _I32, _I32, _I64, _I64, _I32)


def pll_words(state: PllState, c: int, device) -> list[torch.Tensor]:
    """The seven state words in the kernel's order (x0, clamp widened to
    int32, z0, y0, f0, f, y), each checked to be (c,) on ``device``."""
    words = [state.clamp.x0, state.clamp.clamp.to(_I32), state.z0,
             state.y0, state.f0, state.f, state.y]
    names = ("clamp.x0", "clamp.clamp", "z0", "y0", "f0", "f", "y")
    for name, w, dt in zip(names, words, _WORD_DTYPES):
        _ext.require(f"pll state {name}", w, device, dt, (c,))
    return words


def pll_state_from_words(words) -> PllState:
    """`PllState` of the kernel's seven output words (clamp back to int8)."""
    x0, cl, z0, y0, f0, f, y = words
    return PllState(clamp=ClampWrapState(x0=x0, clamp=cl.to(torch.int8)),
                    z0=z0, y0=y0, f0=f0, f=f, y=y)


def pll_bank_plain(ba, state: PllState, xs):
    """Plain PyTorch version of `pll_bank`: the scan."""
    return block(ba, state, xs)


def pll_bank(ba, state: PllState, xs):
    """Type-2 PLL over a bank of channels.

    Args:
      ba: (3,) Q32<32> lead-lag coefficients [b0, b1, a1]
        (`pll.coefficients_from_bandwidth`).
      state: PllState with (c,) leaves.
      xs: (t, c) int32 wrapping input phases.

    Returns (state, ys) with ys (t, c) int32, bit-identical to
    `pll.block`.
    """
    if xs.device.type == "cpu":
        return pll_bank_plain(ba, state, xs)
    t, c = xs.shape
    dev = xs.device
    _ext.require("xs", xs, dev, _I32, (t, c))
    w_in = pll_words(state, c, dev)
    w_out = [torch.empty_like(w) for w in w_in]
    ys = torch.empty((t, c), dtype=_I32, device=dev)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_pll_bank(
            xs.data_ptr(), ys.data_ptr(), _ext.pointers(w_in),
            _ext.pointers(w_out), t, c, *ba_list(ba), _ext.stream_ptr(dev),
        )
    _ext.check(err, "pll_bank")
    pll_bank.launches += 1
    return pll_state_from_words(w_out), ys


pll_bank.launches = 0  # kernel launches since the last reset
