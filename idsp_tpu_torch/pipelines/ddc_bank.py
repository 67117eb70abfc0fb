"""Wideband multi-channel DDC bank with per-channel PLL carrier tracking
(port of `idsp_tpu.pipelines.ddc_bank`, the Lowpass variant).

BASELINE config #5: a wideband input stream ``x (t,) int32`` feeds c
digital downconverters (c = 1024 in the headline configuration), each
with its own NCO frequency word, a shared-gain integer `Lowpass<N>` on
I and Q, keep-1-in-d decimation, `atan2` of the kept I/Q, and a
per-channel PLL tracking the residual carrier phase.  Per block the
outputs are ``(yi_d, yq_d, y_pll, freq)``: (t/d, c) int32 each, and the
PLL frequency words (c,) int32.

Modes of `DdcBank` (ddc_bank.py:202-309 of the JAX package):

* ``scan`` — the oracle, all plain: exact `cossin` mix, `lowpass.block`
  on I and on Q, the kept rows, `atan2`, `pll.block`.
* ``exact`` — exact mix, K4 `lowpass_bank` with keep-1-in-d on the I|Q
  lanes, plain `atan2`, K5 `pll_bank`; bit-identical to ``scan``.
* ``fast`` — the SNR-gated coarse/fine fast-LO mix (fine length
  gcd(t, 128)), then as ``exact``.
* ``one_kernel`` — K6 `fastlo_ddc_bank_block_lp`: the whole stack in one
  kernel; bit-identical to ``fast`` when ``time_chunk`` equals the fast
  mix's fine length.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import fxp
from ..chain import exact_mix
from ..filters import lowpass, pll
from ..filters.ddc_bank_cuda import fastlo_ddc_bank_block_lp
from ..filters.lowpass import LowpassState
from ..filters.lowpass_cuda import lowpass_bank
from ..filters.pll import PllState
from ..filters.pll_cuda import pll_bank
from ..ops import accu
from ..ops.fastlo import fastlo_mix
from ..ops.trig import atan2, cossin

MODES = ("scan", "exact", "fast", "one_kernel")


class DdcBankState(NamedTuple):
    nco_phase: torch.Tensor  # (c,) int32
    lp_i: LowpassState  # p (c, N) int64
    lp_q: LowpassState
    pll: PllState  # (c,) leaves


def init(n_channels: int, lp_order: int = 2, *, device) -> DdcBankState:
    return DdcBankState(
        nco_phase=torch.zeros((n_channels,), dtype=torch.int32,
                              device=device),
        lp_i=lowpass.init(lp_order, (n_channels,), device=device),
        lp_q=lowpass.init(lp_order, (n_channels,), device=device),
        pll=pll.init((n_channels,), device=device),
    )


class DdcBank(nn.Module):
    """Stateless bank step ``forward(state, x) -> (state, outputs)``.

    Args:
      mode: one of `MODES`.
      steps: (c,) int32 channel frequency words; their device is the
        bank's device (a buffer: ``.to(device)`` moves it).
      lp_gains: (N,) i32 lowpass gains (`lowpass.gains2`, N = 2, in the
        headline configuration).
      pll_ba: (3,) Q32<32> PLL coefficients
        (`pll.coefficients_from_bandwidth`).
      decimate: keep-1-in-d (t % decimate == 0).
      time_chunk: ``one_kernel`` only: the kernel's chunk and the fine
        length of its fast-LO mix.
    """

    def __init__(self, mode: str, steps: torch.Tensor, lp_gains, pll_ba, *,
                 decimate: int = 16, time_chunk: int = 128):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.register_buffer("steps", steps.to(torch.int32))
        self.lp_gains = lowpass._gains(lp_gains)
        self.pll_ba = pll.ba_list(pll_ba)
        self.decimate = decimate
        self.time_chunk = time_chunk

    def init_state(self) -> DdcBankState:
        return init(self.steps.shape[0], len(self.lp_gains),
                    device=self.steps.device)

    def forward(self, state: DdcBankState, x: torch.Tensor):
        c = self.steps.shape[0]
        t = x.shape[0]
        d = self.decimate
        if t % d:
            raise ValueError(f"t={t} is not a multiple of decimate={d}")
        if self.mode == "one_kernel":
            lp_iq = LowpassState(p=torch.cat([state.lp_i.p, state.lp_q.p]))
            lp_iq, pll_state, phase, yiq_d, y_pll = fastlo_ddc_bank_block_lp(
                self.lp_gains, self.pll_ba, lp_iq, state.pll,
                state.nco_phase, self.steps, x, d=d,
                time_chunk=self.time_chunk,
            )
            lp_i, lp_q = LowpassState(p=lp_iq.p[:c]), LowpassState(p=lp_iq.p[c:])
            yi_d, yq_d = yiq_d[:, :c], yiq_d[:, c:]
        else:
            phase = accu.advance(state.nco_phase, self.steps, t)
            if self.mode == "fast":
                # the largest power-of-two fine-table length dividing t
                miq = fastlo_mix(x, state.nco_phase, self.steps,
                                 math.gcd(t, 128))
            else:
                miq = exact_mix(x, state.nco_phase, self.steps)
            if self.mode == "scan":
                lp_i, yi = lowpass.block(self.lp_gains, state.lp_i, miq[:, :c])
                lp_q, yq = lowpass.block(self.lp_gains, state.lp_q, miq[:, c:])
                yi_d, yq_d = yi[::d], yq[::d]
                pll_state, y_pll = pll.block(self.pll_ba, state.pll,
                                             atan2(yq_d, yi_d))
            else:
                lp_iq = LowpassState(
                    p=torch.cat([state.lp_i.p, state.lp_q.p]))
                lp_iq, yiq_d = lowpass_bank(self.lp_gains, lp_iq, miq, dec=d)
                lp_i = LowpassState(p=lp_iq.p[:c])
                lp_q = LowpassState(p=lp_iq.p[c:])
                yi_d, yq_d = yiq_d[:, :c], yiq_d[:, c:]
                pll_state, y_pll = pll_bank(
                    self.pll_ba, state.pll, atan2(yq_d, yi_d).contiguous())
        new_state = DdcBankState(nco_phase=phase, lp_i=lp_i, lp_q=lp_q,
                                 pll=pll_state)
        return new_state, (yi_d, yq_d, y_pll, pll.frequency(pll_state))


def make_tone_bank(steps, n: int, amplitude: int = 1 << 27, offsets=None, *,
                   device):
    """Fixture: the sum of one carrier per channel at ``steps + offsets``
    (what each channel's PLL should acquire), ``n`` samples, (n,) int32."""
    steps = np.asarray(steps, np.int64)
    if offsets is None:
        offsets = np.zeros_like(steps)
    freq = torch.from_numpy(
        (steps + np.asarray(offsets, np.int64)).astype(np.int32)).to(device)
    phases = accu.ramp(torch.zeros_like(freq), freq, n)  # (c, n)
    re, _ = cossin(phases)
    tones = (re.to(torch.int64) * amplitude) >> 31
    return fxp.wrap_i32(tones.sum(dim=0))
