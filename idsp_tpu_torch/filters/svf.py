"""Chamberlin state-variable filter, float (port of
`idsp_tpu.filters.svf`).

The reference's src/iir/svf.rs: simultaneous lowpass, highpass and
bandpass outputs (and band-reject = hp + lp) from a 3-word state, with
f = 2 sin(pi f0) and qi = 1/Q.  Each product and sum is rounded on its
own in the reference's order, as eager PyTorch does, so `block` is
bit-identical to the CUDA kernel K34 (`svf_cuda.svf_bank`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SvfState(NamedTuple):
    lp: torch.Tensor
    hp: torch.Tensor
    bp: torch.Tensor

    @property
    def br(self):
        """Band-reject output (svf.rs:19-22)."""
        return self.hp + self.lp


def init(shape=(), dtype=torch.float32, *, device) -> SvfState:
    z = torch.zeros(tuple(shape), dtype=dtype, device=device)
    return SvfState(lp=z, hp=z, bp=z)


def coefficients(f0: float, q: float) -> tuple[float, float]:
    """(f, qi) from relative frequency and Q (svf.rs:33-45)."""
    return 2.0 * math.sin(math.pi * f0), 1.0 / q


def step(f, qi, state: SvfState, x):
    """One update (svf.rs:47-60); all outputs available in the state.
    ``hp = (x - lp) - bp * qi``, left to right."""
    lp = state.bp * f + state.lp
    hp = x - lp - state.bp * qi
    bp = hp * f + state.bp
    return SvfState(lp=lp, hp=hp, bp=bp), lp


def block(f, qi, state: SvfState, xs):
    """`step` scanned over time axis 0 of ``xs``; f and qi are rounded to
    the state's dtype.  Returns (state, SvfState of (t, ...) tensors)."""
    dt, dev = state.lp.dtype, state.lp.device
    f = torch.as_tensor(f, dtype=dt, device=dev)
    qi = torch.as_tensor(qi, dtype=dt, device=dev)
    lp, bp = state.lp, state.bp
    hp = state.hp
    outs = SvfState(*(torch.empty(xs.shape, dtype=dt, device=dev)
                      for _ in range(3)))
    for i in range(xs.shape[0]):
        lp = bp * f + lp
        hp = xs[i] - lp - bp * qi
        bp = hp * f + bp
        outs.lp[i], outs.hp[i], outs.bp[i] = lp, hp, bp
    return SvfState(lp=lp, hp=hp, bp=bp), outs
