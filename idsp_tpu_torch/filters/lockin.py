"""Lock-in amplifier / demodulator (port of `idsp_tpu.filters.lockin`,
reference src/lockin.rs).

Mix the input with a local-oscillator IQ, then filter I and Q through
two states of one shared filter configuration.  The mixer runs on every
row at once; the filter is any stage (integer `lowpass`, `biquad`, ...).
The phase-input variant derives the LO from the `cossin` DDS at Q32<32>
(lockin.rs:30-39).
"""

from __future__ import annotations

import torch

from .. import fxp
from ..ops.trig import cossin
from . import biquad
from . import lowpass as lp


def mix(x, lo_re, lo_im, *, f: int = 32):
    """Demodulation mix: int32 sample times Q32<f> LO IQ, truncating
    (``i32 * Q32<32>`` apply semantics).  Returns int32 (i, q)."""
    x = x.to(torch.int32)
    return fxp.q_apply(lo_re, x, f), fxp.q_apply(lo_im, x, f)


def mix_phase(x, phase):
    """Mix against the DDS LO at the given wrapping phase
    (lockin.rs:30-39)."""
    lo_re, lo_im = cossin(phase)
    return mix(x, lo_re, lo_im)


def lockin_block(filter_block, states, xs, phases):
    """Generic lock-in: a filter stage ``filter_block(state, xs) ->
    (state, ys)`` shared by the I and Q lanes (the reference's
    `Lockin<C>`, lockin.rs:17-27).  xs, phases: (t, ...) time-major;
    states: (i_state, q_state).  Returns ((i_state, q_state), (i, q))."""
    i_in, q_in = mix_phase(xs, phases)
    si, sq = states
    si2, yi = filter_block(si, i_in)
    sq2, yq = filter_block(sq, q_in)
    return (si2, sq2), (yi, yq)


def lockin_lowpass_block(k, states, xs, phases):
    """Phase-input lock-in with the integer `Lowpass` (gains ``k``) as
    the filter."""
    return lockin_block(lambda s, x: lp.block(k, s, x), states, xs, phases)


def lockin_init_lowpass(n: int = 1, shape=(), *, device):
    """Two states of one shared lowpass configuration (I and Q lanes)."""
    return (lp.init(n, shape, device=device), lp.init(n, shape, device=device))


def lockin_biquad_q_block(ba, f: int, states, xs, phases):
    """Lock-in with a shared fixed-point biquad as the post-mix filter."""
    return lockin_block(lambda s, x: biquad.df1_process_q(ba, f, s, x),
                        states, xs, phases)
