"""K37: the RPLL bank (port of `idsp_tpu.filters.rpll_pallas.rpll_bank`).

`rpll_bank` runs the CUDA kernel of ``csrc/structures_bank.cu`` for a
CUDA tensor and its plain PyTorch version, `rpll_bank_plain`, for a CPU
tensor; any other device raises.  Both are bit-identical to
`rpll.block`.  The kernel works on native ``uint32_t``/``uint64_t``
words; the state crosses as the int32 bit patterns of `RpllState`.
"""

from __future__ import annotations

import torch

from .. import _ext
from .rpll import RpllConfig, RpllState, block, check_config


def rpll_bank_plain(cfg: RpllConfig, state: RpllState, xs, valids):
    """Plain PyTorch version of `rpll_bank`: `rpll.block`."""
    return block(cfg, state, xs, valids)


def rpll_bank(cfg: RpllConfig, state: RpllState, xs, valids):
    """Reciprocal PLL over a bank of lanes, one timestamp stream a lane.

    Args:
      cfg: RpllConfig (dt2, shift_frequency, shift_phase), shared; 0 < sf
        < 64, sf <= 32 + dt2, dt2 and sp - dt2 below 32.
      state: RpllState with (c,) int32 fields (ff, f: u32 bit patterns).
      xs: (t, c) int32 timestamps.
      valids: (t, c) bool, a timestamp present.

    Returns (state, (phase, frequency)), both (t, c) int32,
    bit-identical to `rpll.block`.
    """
    check_config(cfg)
    if xs.device.type == "cpu":
        return rpll_bank_plain(cfg, state, xs, valids)
    t, c = xs.shape
    dev = xs.device
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
            cfg.shift_phase, _ext.stream_ptr(dev))
    _ext.check(err, "rpll_bank")
    rpll_bank.launches += 1
    return out, (phase, freq)


rpll_bank.launches = 0  # kernel launches since the last reset
