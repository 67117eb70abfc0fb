"""Real-input DDC / lock-in, float path (port of
`idsp_tpu.pipelines.ddc_lockin`, reference examples/ddc_lockin.rs;
BASELINE config #2).

Quadrature mix with a float LO, then a shared-coefficient lowpass over
the I/Q lanes (the reference's `Split::lanes()`: one configuration, two
states, here a trailing lane axis).

`DdcLockinBank` runs a bank of c such receivers on one shared input
stream, I lanes then Q lanes, ``(t, 2c)`` f32 out.  Modes:

* ``scan`` -- the composed reference of tests/test_structures_pallas.py:
  194-200: the LO plane straight from float64 phases mod tau (cast to
  f32, cos/sin in f32), the mix, the plain f32 DF1.
* ``kernel`` -- K16 `ddc_lockin_bank` (factored LO tables, one kernel);
  within 2e-5 of ``scan`` (the LO's f32 product rounding).

Acceptance gates (ddc_lockin.rs:104-110): the recovered DC IQ mean
within 3e-3 of [0.5 cos(phi), 0.5 sin(phi)], rms < 6e-3.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..design import Filter
from ..filters import biquad
from ..filters.ddc_lockin_cuda import ddc_lockin_bank

MODES = ("scan", "kernel")


def _lo(n0, t: int, lo_freqs, device):
    """(cos, sin) f32 LO planes (t, c) of rows n0 .. n0+t-1 from float64
    phases mod tau."""
    tau = 2.0 * math.pi
    i = float(n0) + torch.arange(t, dtype=torch.float64, device=device)
    w = torch.as_tensor(np.asarray(lo_freqs, np.float64), device=device)
    ph = torch.remainder(i[:, None] * (tau * w)[None], tau).to(torch.float32)
    return torch.cos(ph), torch.sin(ph)


def quadrature_mix(x, lo_freq: float):
    """``x[n] * exp(-j w n)`` in f32 (ddc_lockin.rs:22-33): (n, 2) I/Q
    lanes.  The phase ramp is closed form (float64 mod tau)."""
    c, s = _lo(0, x.shape[0], [lo_freq], x.device)
    return torch.stack([x * c[:, 0], -x * s[:, 0]], dim=-1)


def lowpass_ba(cutoff: float) -> np.ndarray:
    """The example's f32 lowpass [b0, b1, b2, a1, a2]."""
    return biquad.from_cookbook(
        Filter().critical_frequency(cutoff).lowpass()).astype(np.float32)


def ddc(x, lo_freq: float, cutoff: float):
    """mix -> shared-configuration I/Q lowpass (ddc_lockin.rs:35-42)."""
    iq = quadrature_mix(x, lo_freq)
    st = biquad.df1_init((2,), torch.float32, device=x.device)
    _, y = biquad.df1_process(lowpass_ba(cutoff), st, iq)
    return y


def tone(freq: float, phase: float, n: int, *, device):
    """``cos(tau*freq*i + phase)`` fixture (ddc_lockin.rs:58-62), f32."""
    i = np.arange(n, dtype=np.float64)
    return torch.from_numpy(
        np.cos(2.0 * np.pi * freq * i + phase).astype(np.float32)).to(device)


def run_ddc(n: int = 16384, *, device="cuda"):
    """The full example with the reference constants (ddc_lockin.rs:83-90),
    on ``device`` (the card unless the caller asks for another)."""
    lo_freq = 0.173
    phi = 0.37
    expected = np.array([0.5 * np.cos(phi), 0.5 * np.sin(phi)])
    x = tone(lo_freq, phi, n, device=device)
    y = ddc(x, lo_freq, 0.002).cpu().numpy().astype(np.float64)
    tail = y[12 * n // 16:]
    mean = tail.mean(axis=0)
    rms = float(np.sqrt(((tail - expected) ** 2).sum(axis=1).mean()))
    return {"mean": mean, "expected": expected, "rms": rms}


class DdcLockinBank(nn.Module):
    """Stateless lock-in bank ``forward(state, x, n0=0) -> (state, yiq)``:
    x (t,) f32 shared by all channels, yiq (t, 2c) f32, I lanes then Q
    lanes; ``n0`` is the absolute index of x[0] (LO phase across blocks).

    Args:
      mode: one of `MODES`.
      lo_freqs: (c,) relative LO frequencies.
      ba: (5,) f32 lowpass coefficients (`lowpass_ba`).
      time_chunk: ``kernel`` only: the LO tables' chunk.
      device: where `init_state` puts the state (the card unless the
        caller asks for another device).
    """

    def __init__(self, mode: str, lo_freqs, ba, *, time_chunk: int = 256,
                 device="cuda"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.lo_freqs = np.asarray(lo_freqs, np.float64)
        self.ba = np.asarray(ba, np.float32).reshape(-1)[:5]
        self.time_chunk = time_chunk
        self.device = torch.device(device)

    def init_state(self) -> biquad.Df1State:
        return biquad.df1_init((2 * len(self.lo_freqs),), torch.float32,
                               device=self.device)

    def forward(self, state: biquad.Df1State, x: torch.Tensor, n0=0):
        if self.mode == "kernel":
            return ddc_lockin_bank(self.ba, state, x, self.lo_freqs, n0,
                                   time_chunk=self.time_chunk)
        lc, ls = _lo(n0, x.shape[0], self.lo_freqs, x.device)
        xb = x[:, None]
        iq = torch.cat([xb * lc, -(xb * ls)], dim=1)
        return biquad.df1_process(self.ba, state, iq)
