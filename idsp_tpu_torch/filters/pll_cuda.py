"""K5: the PLL bank (port of `idsp_tpu.filters.pll_pallas.pll_bank`).

`pll_bank` runs the CUDA kernel of ``csrc/pll_bank.cu`` for a CUDA
tensor and its plain PyTorch version, `pll_bank_plain`, for a CPU
tensor; any other device raises.  Both are bit-identical to `pll.block`.
The kernel runs on the depth-0 pipeline of ``csrc/df1_ring.cuh``
(`pll_plan`): a CUDA block is a tile of 32 channels, producer warps copy
the phase rows into the serial warp's input ring, the serial warp runs
the PLL (its sums regrouped mod 2^32 and 2^64, ``csrc/pll.cuh``) into the
output ring, a store warp writes the rows.

The kernel takes the seven state words as they are, int32, int8 (the
clamp indicator) and int64 arrays; the TPU kernel's packed carry widened
the clamp to int32 and narrowed it back (pll_pallas.py:127, 149).
"""

from __future__ import annotations

import functools

import torch

from .. import _ext
from ..ops.unwrap import ClampWrapState
from .pipe_plan import PipePlan, pipe_plan
from .pll import PllState, ba_list, block

_I32, _I64 = torch.int32, torch.int64
# kernel order of the state words (csrc/pll.cuh PllWords)
_WORD_DTYPES = (_I32, torch.int8, _I32, _I32, _I64, _I64, _I32)
# K5's producer warps by default (and a store warp: 8 warps a block)
PLL_PRODUCERS = 5


def pll_plan(c: int, *, producers: int = PLL_PRODUCERS,
             **kw) -> PipePlan:
    """K5's plan over ``c`` channels (`pipe_plan.pipe_plan`): PLL_PRODUCERS
    producer warps by default, each a span of ceil(chunk / producers) rows
    of every chunk; one 32-bit word a row and channel in (the phase) and
    out (y), so PIPE_CHUNK rows a chunk in 3 slots by default; one CTA a
    tile.  Raises ValueError for a plan the kernel cannot run."""
    if kw.get("cluster", 1) != 1:
        raise ValueError("K5 runs one CTA a tile")
    return pipe_plan(c, producers=producers, **kw)


@functools.lru_cache(maxsize=None)
def _default_plan(c: int) -> PipePlan:
    return pll_plan(c)


def pll_words(state: PllState, c: int, device) -> list[torch.Tensor]:
    """The seven state words in the kernel's order (x0, clamp, z0, y0, f0,
    f, y), each checked to be (c,) on ``device``."""
    words = [state.clamp.x0, state.clamp.clamp, state.z0, state.y0,
             state.f0, state.f, state.y]
    names = ("clamp.x0", "clamp.clamp", "z0", "y0", "f0", "f", "y")
    for name, w, dt in zip(names, words, _WORD_DTYPES):
        _ext.require(f"pll state {name}", w, device, dt, (c,))
    return words


def pll_state_from_words(words) -> PllState:
    """`PllState` of the kernel's seven output words."""
    x0, cl, z0, y0, f0, f, y = words
    return PllState(clamp=ClampWrapState(x0=x0, clamp=cl), z0=z0, y0=y0,
                    f0=f0, f=f, y=y)


def pll_bank_plain(ba, state: PllState, xs):
    """Plain PyTorch version of `pll_bank`: the scan."""
    return block(ba, state, xs)


def pll_bank(ba, state: PllState, xs, *, _plan: PipePlan | None = None):
    """Type-2 PLL over a bank of channels.

    Args:
      ba: (3,) Q32<32> lead-lag coefficients [b0, b1, a1]
        (`pll.coefficients_from_bandwidth`).
      state: PllState with (c,) leaves.
      xs: (t, c) int32 wrapping input phases.

    Returns (state, ys) with ys (t, c) int32, bit-identical to
    `pll.block`.  The kernel's plan is `pll_plan`'s; no plan changes a
    value.
    """
    if xs.device.type == "cpu":
        return pll_bank_plain(ba, state, xs)
    if xs.dim() != 2:
        raise ValueError(f"xs must be (t, c), got {tuple(xs.shape)}")
    coefs = ba_list(ba)
    if len(coefs) != 3:
        raise ValueError(f"need 3 coefficients [b0, b1, a1], got "
                         f"{len(coefs)}")
    t, c = xs.shape
    plan = _default_plan(c) if _plan is None else _plan
    if plan.cluster != 1:
        raise ValueError("K5 runs one CTA a tile")
    dev = xs.device
    _ext.require("xs", xs, dev, _I32, (t, c))
    w_in = pll_words(state, c, dev)
    # the new words as views of three allocations (the host's work a call
    # bounds a launch of this size)
    x0, z0, y0, y = torch.empty((4, c), dtype=_I32, device=dev).unbind(0)
    f0, f = torch.empty((2, c), dtype=_I64, device=dev).unbind(0)
    w_out = [x0, torch.empty((c,), dtype=torch.int8, device=dev), z0, y0,
             f0, f, y]
    ys = torch.empty((t, c), dtype=_I32, device=dev)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_pll_bank(
            xs.data_ptr(), ys.data_ptr(), _ext.pointers(w_in),
            _ext.pointers(w_out), t, c, *coefs, plan.warps, plan.producers,
            plan.chunk, plan.ring, plan.smem, _ext.stream_ptr(dev),
        )
    _ext.check(err, "pll_bank")
    pll_bank.launches += 1
    return pll_state_from_words(w_out), ys


pll_bank.launches = 0  # kernel launches since the last reset
