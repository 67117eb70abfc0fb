"""Wideband multi-channel DDC bank with per-channel PLL carrier tracking
(port of `idsp_tpu.pipelines.ddc_bank`: the Lowpass and the biquad
variant).

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

`DdcBankBiquad` is the variant with the Q<f> DF1 biquad as the channel
filter on the 2c I|Q lanes (``ddc_bank_block_biquad``, ddc_bank.py:54-193
of the JAX package); its outputs are ``(yi_d, yq_d, freq)``.  Modes:

* ``scan`` — the oracle, all plain: exact mix, `df1_process_q`, the kept
  rows, `atan2`, `pll.block`.
* ``exact`` — exact mix, K11 `df1_bank_q_dec`, plain `atan2`, K5;
  bit-identical to ``scan``.
* ``fast`` — the fast-LO mix (fine length gcd(t, 128)), then as
  ``exact``.
* ``fast_fused`` — K12 `fastlo_df1_dec_bank` (mix, DF1, keep 1 in d),
  plain `atan2`, K5.
* ``one_kernel`` — K13 `fastlo_ddc_bank_block`: the whole stack in one
  kernel.

``fast_fused`` and ``one_kernel`` equal ``fast`` bit for bit when
``time_chunk`` equals the fast mix's fine length.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import fxp
from ..filters import lowpass, pll
from ..filters.biquad import Df1State, _ba_list, df1_init, df1_process_q
from ..filters.biquad_cuda import df1_bank_q_dec
from ..filters.ddc_bank_cuda import (
    fastlo_ddc_bank_block,
    fastlo_ddc_bank_block_lp,
    fastlo_df1_dec_bank,
)
from ..filters.ddc_cuda import exact_mix
from ..filters.lowpass import LowpassState
from ..filters.lowpass_cuda import lowpass_bank
from ..filters.pll import PllState
from ..filters.pll_cuda import pll_bank
from ..ops import accu
from ..ops.fastlo import fastlo_mix
from ..ops.trig import atan2, cossin

MODES = ("scan", "exact", "fast", "one_kernel")
BIQUAD_MODES = ("scan", "exact", "fast", "fast_fused", "one_kernel")


def _check_decimate(t: int, d: int) -> None:
    if t % d:
        raise ValueError(f"t={t} is not a multiple of decimate={d}")


def _mix(mode: str, x, phase0, steps):
    """The (t, 2c) I|Q mix of the unfused modes: in ``fast`` the fast-LO
    mix with the largest power-of-two fine length dividing t (up to 128),
    else the exact one."""
    if mode == "fast":
        return fastlo_mix(x, phase0, steps, math.gcd(x.shape[0], 128))
    return exact_mix(x, phase0, steps)


def _track(mode: str, pll_ba, pll_state: PllState, yi_d, yq_d):
    """atan2 of the kept rows, then the PLL: plain in ``scan``, K5
    `pll_bank` else.  Returns (pll_state, y_pll)."""
    ph = atan2(yq_d, yi_d)
    if mode == "scan":
        return pll.block(pll_ba, pll_state, ph)
    return pll_bank(pll_ba, pll_state, ph.contiguous())


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
        _check_decimate(t, d)
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
            miq = _mix(self.mode, x, state.nco_phase, self.steps)
            if self.mode == "scan":
                lp_i, yi = lowpass.block(self.lp_gains, state.lp_i, miq[:, :c])
                lp_q, yq = lowpass.block(self.lp_gains, state.lp_q, miq[:, c:])
                yi_d, yq_d = yi[::d], yq[::d]
            else:
                lp_iq = LowpassState(
                    p=torch.cat([state.lp_i.p, state.lp_q.p]))
                lp_iq, yiq_d = lowpass_bank(self.lp_gains, lp_iq, miq, dec=d)
                lp_i = LowpassState(p=lp_iq.p[:c])
                lp_q = LowpassState(p=lp_iq.p[c:])
                yi_d, yq_d = yiq_d[:, :c], yiq_d[:, c:]
            pll_state, y_pll = _track(self.mode, self.pll_ba, state.pll,
                                      yi_d, yq_d)
        new_state = DdcBankState(nco_phase=phase, lp_i=lp_i, lp_q=lp_q,
                                 pll=pll_state)
        return new_state, (yi_d, yq_d, y_pll, pll.frequency(pll_state))


class DdcBankBiquadState(NamedTuple):
    nco_phase: torch.Tensor  # (c,) int32
    bq: Df1State  # x/y (2c, 2) int32, I lanes then Q lanes
    pll: PllState  # (c,) leaves


def init_biquad(n_channels: int, *, device) -> DdcBankBiquadState:
    return DdcBankBiquadState(
        nco_phase=torch.zeros((n_channels,), dtype=torch.int32,
                              device=device),
        bq=df1_init((2 * n_channels,), device=device),
        pll=pll.init((n_channels,), device=device),
    )


class DdcBankBiquad(nn.Module):
    """Stateless biquad-bank step ``forward(state, x) -> (state,
    (yi_d, yq_d, freq))``: (t/d, c) int32 each and the PLL frequency
    words (c,) int32.

    Args:
      mode: one of `BIQUAD_MODES`.
      steps: (c,) int32 channel frequency words; their device is the
        bank's device (a buffer: ``.to(device)`` moves it).
      ba_q: (5,) i32 Q<f> DF1 coefficients.
      pll_ba: (3,) Q32<32> PLL coefficients
        (`pll.coefficients_from_bandwidth`).
      f: fractional bits of ``ba_q``.
      decimate: keep-1-in-d (t % decimate == 0).
      time_chunk: ``fast_fused`` and ``one_kernel`` only: the kernel's
        chunk and the fine length of its fast-LO mix.
    """

    def __init__(self, mode: str, steps: torch.Tensor, ba_q, pll_ba, *,
                 f: int = 29, decimate: int = 16, time_chunk: int = 128):
        super().__init__()
        if mode not in BIQUAD_MODES:
            raise ValueError(f"mode must be one of {BIQUAD_MODES}, got "
                             f"{mode!r}")
        self.mode = mode
        self.register_buffer("steps", steps.to(torch.int32))
        self.ba_q = _ba_list(ba_q)
        self.pll_ba = pll.ba_list(pll_ba)
        self.f = f
        self.decimate = decimate
        self.time_chunk = time_chunk

    def init_state(self) -> DdcBankBiquadState:
        return init_biquad(self.steps.shape[0], device=self.steps.device)

    def forward(self, state: DdcBankBiquadState, x: torch.Tensor):
        c = self.steps.shape[0]
        t = x.shape[0]
        d = self.decimate
        _check_decimate(t, d)
        phase = accu.advance(state.nco_phase, self.steps, t)
        if self.mode == "one_kernel":
            bq, pll_state, _, yiq_d = fastlo_ddc_bank_block(
                self.ba_q, self.pll_ba, state.bq, state.pll,
                state.nco_phase, self.steps, x, self.f, d=d,
                time_chunk=self.time_chunk)
        elif self.mode == "fast_fused":
            bq, _, yiq_d = fastlo_df1_dec_bank(
                self.ba_q, state.bq, state.nco_phase, self.steps, x, self.f,
                d=d, time_chunk=self.time_chunk)
        else:
            miq = _mix(self.mode, x, state.nco_phase, self.steps)
            if self.mode == "scan":
                bq, yiq = df1_process_q(self.ba_q, self.f, state.bq, miq)
                yiq_d = yiq[::d]
            else:
                bq, yiq_d = df1_bank_q_dec(self.ba_q, state.bq, miq, self.f,
                                           d=d)
        yi_d, yq_d = yiq_d[:, :c], yiq_d[:, c:]
        if self.mode != "one_kernel":
            pll_state, _ = _track(self.mode, self.pll_ba, state.pll, yi_d,
                                  yq_d)
        new_state = DdcBankBiquadState(nco_phase=phase, bq=bq, pll=pll_state)
        return new_state, (yi_d, yq_d, pll.frequency(pll_state))


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
