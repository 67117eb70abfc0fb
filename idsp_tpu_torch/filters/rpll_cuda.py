"""K37: the RPLL bank (port of `idsp_tpu.filters.rpll_pallas.rpll_bank`).

`rpll_bank` runs the CUDA kernel of ``csrc/structures_bank.cu`` for a
CUDA tensor and its plain PyTorch version, `rpll_bank_plain`, for a CPU
tensor; any other device raises.  Both are bit-identical to
`rpll.block`.  The kernel works on native ``uint32_t``/``uint64_t``
words; the state crosses as the int32 bit patterns of `RpllState`.  It
runs on the depth-0 pipeline of ``csrc/df1_ring.cuh`` (`rpll_plan`): a
CUDA block is a tile of 32 lanes, producer warps write each row's x and dt
(the mask in bit 31) into the serial warp's input ring, the serial warp
runs the recurrence (and the last valid timestamp) into (phase,
frequency) words, a store warp writes the two planes.
"""

from __future__ import annotations

import torch

from .. import _ext
from .pipe_plan import PipePlan, pipe_plan
from .rpll import RpllConfig, RpllState, block, check_config

# K37's producer warps by default (and a store warp: 8 warps a block)
RPLL_PRODUCERS = 5


def rpll_plan(c: int, *, producers: int = RPLL_PRODUCERS, **kw) -> PipePlan:
    """K37's plan over ``c`` lanes (`pipe_plan.pipe_plan`): RPLL_PRODUCERS
    producer warps by default, each a span of ceil(chunk / producers) rows
    of every chunk; two 32-bit words a row and lane in and out
    (PIPE_CHUNK / 2 rows a chunk by default, 3 slots); one CTA a tile."""
    if kw.get("cluster", 1) != 1:
        raise ValueError("K37 runs one CTA a tile")
    return pipe_plan(c, producers=producers, win=2, wout=2, **kw)


def rpll_bank_plain(cfg: RpllConfig, state: RpllState, xs, valids):
    """Plain PyTorch version of `rpll_bank`: `rpll.block`."""
    return block(cfg, state, xs, valids)


def rpll_bank(cfg: RpllConfig, state: RpllState, xs, valids, *,
              _plan: PipePlan | None = None):
    """Reciprocal PLL over a bank of lanes, one timestamp stream a lane.

    Args:
      cfg: RpllConfig (dt2, shift_frequency, shift_phase), shared; 0 < sf
        < 64, sf <= 32 + dt2, dt2 and sp - dt2 below 32.
      state: RpllState with (c,) int32 fields (ff, f: u32 bit patterns).
      xs: (t, c) int32 timestamps.
      valids: (t, c) bool, a timestamp present.

    Returns (state, (phase, frequency)), both (t, c) int32,
    bit-identical to `rpll.block`.  The kernel's plan is `rpll_plan`'s; no
    plan changes a value.
    """
    check_config(cfg)
    if xs.device.type == "cpu":
        return rpll_bank_plain(cfg, state, xs, valids)
    t, c = xs.shape
    dev = xs.device
    plan = rpll_plan(c) if _plan is None else _plan
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    _ext.require("valids", valids, dev, torch.bool, (t, c))
    for name, w in zip(RpllState._fields, state):
        _ext.require(f"state.{name}", w, dev, torch.int32, (c,))
    out = RpllState(*(torch.empty_like(w) for w in state))
    phase, freq = torch.empty_like(xs), torch.empty_like(xs)
    with torch.cuda.device(dev):
        err = _ext.library().idsp_rpll_bank(
            xs.data_ptr(), valids.data_ptr(), phase.data_ptr(),
            freq.data_ptr(), *(w.data_ptr() for w in state),
            *(w.data_ptr() for w in out), t, c, cfg.dt2, cfg.shift_frequency,
            cfg.shift_phase, plan.warps, plan.producers, plan.chunk,
            plan.ring, plan.smem, _ext.stream_ptr(dev))
    _ext.check(err, "rpll_bank")
    rpll_bank.launches += 1
    return out, (phase, freq)


rpll_bank.launches = 0  # kernel launches since the last reset
