"""Reciprocal PLL: lock to noisy quantized timestamps (port of
`idsp_tpu.filters.rpll`).

The reference's src/rpll.rs: consumes optional timestamps of a reference
edge (at most one per update cycle of ``1 << dt2`` counter cycles) and
reconstructs the phase and frequency of the update rate relative to the
reference.  The `Option<timestamp>` input is a masked (value, valid)
stream (`masked.Masked`); the update is a sequential scan per lane.

The frequency words ``ff`` and ``f`` are unsigned 32-bit in the
reference.  This PyTorch's ``uint32`` has no add, shift or comparison, so
`RpllState` holds them as int32 bit patterns (as the JAX package's TPU
kernel carries them, and `convert` maps them from and to ``uint32``).
The step works on int64 copies: ``f >> dt2`` is a logical shift (the
word taken zero-extended), ``ff * dx`` the wrapping int64 product of the
two zero-extended words (the u64 product's bit pattern), the rounding
bias added mod 2^64 and the ``>> sf`` logical (`fxp._lsr`), keeping the
low 32 bits; ``dy`` is an arithmetic int32 shift.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import fxp
from ..masked import masked_update

_MASK32 = 0xFFFFFFFF


@dataclass(frozen=True)
class RpllConfig:
    """rpll.rs:20-36."""

    dt2: int  # log2 counter-rate / update-rate ratio
    shift_frequency: int  # log2 frequency-lock settling time (counter periods)
    shift_phase: int  # log2 phase-lock settling time

    def __post_init__(self):
        assert self.shift_frequency >= self.dt2
        assert self.shift_phase >= self.dt2


class RpllState(NamedTuple):
    """rpll.rs:12-18; every field int32 (ff, f: the u32 bit patterns)."""

    x: torch.Tensor  # previous timestamp
    ff: torch.Tensor  # frequency estimate (frequency loop), u32 bits
    f: torch.Tensor  # frequency estimate (freq + phase loop), u32 bits
    y: torch.Tensor  # phase estimate


def init(shape=(), *, device) -> RpllState:
    z = torch.zeros(tuple(shape), dtype=torch.int32, device=device)
    return RpllState(x=z, ff=z, f=z, y=z)


def check_config(cfg: RpllConfig) -> None:
    """The shifts the step supports: 0 < sf < 64 (a 64-bit shift), sf <=
    32 + dt2 (the reference phase ``1 << (32 + dt2 - sf)``), dt2 and
    sp - dt2 below 32 (32-bit shifts)."""
    dt2, sf, sp = cfg.dt2, cfg.shift_frequency, cfg.shift_phase
    if not (0 <= dt2 < 32 and 0 < sf < 64 and sf <= 32 + dt2
            and 0 <= sp - dt2 < 32):
        raise ValueError(f"unsupported RpllConfig {cfg}: needs 0 <= dt2 < "
                         "32, 0 < sf < 64, sf <= 32 + dt2, sp - dt2 < 32")


def _step64(cfg: RpllConfig, x, xp, ff, f, y, valid):
    """One update on int64 words: x, xp, y int32 values; ff, f u32 values
    in [0, 2^32).  Returns the new (xp, ff, f, y) in the same form."""
    dt2, sf, sp = cfg.dt2, cfg.shift_frequency, cfg.shift_phase
    # advance phase (rpll.rs:49): y += f, wrapping i32
    y = fxp.wrap32(y + f)
    # frequency lock (rpll.rs:52-60): the reference phase over dx at the
    # current estimate, rounded half up, against the ideal 2^(32+dt2)
    dx = (x - xp) & _MASK32
    p_sig = fxp._lsr(ff * dx + (1 << (sf - 1)), sf) & _MASK32
    p_ref = (1 << (32 + dt2 - sf)) & _MASK32
    ff2 = (ff + p_ref - p_sig) & _MASK32
    # phase lock (rpll.rs:62-71): predicted reference phase "now" (the
    # frequency estimate from before this update) against the estimate
    dt = (-x) & ((1 << dt2) - 1)
    y_ref = fxp.wrap32((f >> dt2) * dt)
    dy = fxp.wrap32(y_ref - y) >> (sp - dt2)
    f2 = (ff2 + dy) & _MASK32
    xp, ff, f = masked_update(valid, (x, ff2, f2), (xp, ff, f))
    return xp, ff, f, y


def _words(state: RpllState):
    i64 = torch.int64
    return (state.x.to(i64), state.ff.to(i64) & _MASK32,
            state.f.to(i64) & _MASK32, state.y.to(i64))


def _state(xp, ff, f, y) -> RpllState:
    return RpllState(*(fxp.wrap_i32(v) for v in (xp, ff, f, y)))


def step(cfg: RpllConfig, state: RpllState, x, valid):
    """One update cycle (rpll.rs:47-77). x: int32 timestamp, valid: bool.

    Returns (state, (phase, frequency)), both int32: the `Accu` of the
    estimate, the frequency the new ``f``'s bit pattern.
    """
    check_config(cfg)
    x = torch.as_tensor(x, dtype=torch.int32, device=state.x.device)
    valid = torch.as_tensor(valid, device=x.device).to(torch.bool)
    new = _state(*_step64(cfg, x.to(torch.int64), *_words(state), valid))
    return new, (new.y, new.f)


def block(cfg: RpllConfig, state: RpllState, xs, valids):
    """`step` scanned over update cycles (time on axis 0 of the int32
    timestamps ``xs`` and the bool ``valids``).  Returns (state, (phase,
    frequency)), both like xs."""
    check_config(cfg)
    xp, ff, f, y = _words(state)
    xs64 = xs.to(torch.int64)
    valids = valids.to(torch.bool)
    phase = torch.empty(xs.shape, dtype=torch.int32, device=xs.device)
    freq = torch.empty_like(xs64)  # u32 values, wrapped to int32 at the end
    for i in range(xs.shape[0]):
        xp, ff, f, y = _step64(cfg, xs64[i], xp, ff, f, y, valids[i])
        phase[i] = y
        freq[i] = f
    return _state(xp, ff, f, y), (phase, fxp.wrap_i32(freq))


def block_masked(cfg: RpllConfig, state: RpllState, m):
    """`block` taking the framework's `masked.Masked` event stream
    (timestamps where valid): the RPLL's input is an Option stream
    (rpll.rs:47: ``x: Option<i32>``)."""
    return block(cfg, state, m.value, m.valid)
