"""Fixed-point FM discriminator receiver (port of
`idsp_tpu.pipelines.fm_disc`, reference examples/fm_disc.rs; BASELINE
config #1).

The DSP identity ``arg(x[n] * conj(x[n-1])) ~= dphi[n]`` with a Q32<30>
deemphasis biquad.  The discriminator (conjugate product, atan2, carrier
subtract) runs on every row at once; only the deemphasis biquad is
sequential.  Blocks stream with a small carry (`FmDiscState`).

`FmReceiver` modes:

* ``scan`` -- the oracle, all plain: `fm_receiver` (discriminator, then
  `biquad.df1_process_q`).
* ``composed`` -- the plain discriminator, then K26 `df1_bank_q_coef`,
  the runtime-coefficient DF1 bank, with the shared (5,) coefficients
  and ``f = 30``, as the JAX package runs it (fm_disc.py:75-86);
  bit-identical to ``scan``.
* ``kernel`` -- K15 `fm_disc_bank` with the exact angle; bit-identical
  to ``scan``.
* ``kernel_fast`` -- K15 with the f32 angle, SNR-gated.

Acceptance gates (fm_disc.rs:151-157): corr > 0.999, gain in (0.95,
1.05), rms < 5e-4.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..design import Filter
from ..filters import biquad
from ..filters.biquad_cuda import df1_bank_q_coef
from ..filters.fm_cuda import (
    FmDiscState, discriminate, fm_disc_bank, fm_disc_bank_plain, next_state,
    wrap_carrier,
)
from ..fxp import wrap_i32
from ..ops.trig import cossin

MODES = ("scan", "composed", "kernel", "kernel_fast")
__all__ = ["FmDiscState", "FmReceiver", "MODES", "deemphasis_coefficients",
           "fm_receiver", "fm_signal", "init_state", "lowpass_reference",
           "measure_fm", "run_fm_disc"]


def init_state(shape=(), *, device) -> FmDiscState:
    shape = tuple(shape)
    return FmDiscState(
        prev_re=torch.zeros(shape, dtype=torch.int32, device=device),
        prev_im=torch.zeros(shape, dtype=torch.int32, device=device),
        prev_valid=torch.zeros(shape, dtype=torch.bool, device=device),
        deemph=biquad.df1_init(shape, torch.int32, device=device),
    )


def deemphasis_coefficients(cutoff: float, f: int = 30) -> np.ndarray:
    """Q32<30> lowpass deemphasis, the reference's builder
    (fm_disc.rs:43-45)."""
    ba = Filter().critical_frequency(cutoff).lowpass()
    return biquad.quantize_ba(biquad.from_cookbook(ba), f)


def fm_receiver(state: FmDiscState, x_re, x_im, carrier, ba_q, f: int = 30):
    """One block of IQ (time on axis 0, optional channel axes after).

    Discriminator (fm_disc.rs:31-39), then the Q<f> DF1 deemphasis scan
    (fm_disc.rs:41-48): K15's plain version with the exact angle.
    Returns (state, y int32)."""
    return fm_disc_bank_plain(ba_q, state, x_re, x_im, carrier, f)


class FmReceiver(nn.Module):
    """Stateless FM receiver bank ``forward(state, re, im) -> (state,
    y)``, re/im/y (t, c) int32.

    Args:
      mode: one of `MODES`.
      ba_q: (5,) i32 Q<f> deemphasis coefficients.
      carrier: the carrier frequency word.
      channels: c, for `init_state`.
      f: fractional bits of ``ba_q``.
      device: where `init_state` puts the state (the card unless the
        caller asks for another device).
    """

    def __init__(self, mode: str, ba_q, carrier: int, channels: int, *,
                 f: int = 30, device="cuda"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.ba_q = biquad._ba_list(ba_q)
        self.carrier = wrap_carrier(carrier)
        self.channels = channels
        self.f = f
        self.device = torch.device(device)
        # K26's shared coefficients, on ``device`` (made at the first
        # ``composed`` call: a receiver for the card is built anywhere)
        self._ba_planes = None

    def init_state(self) -> FmDiscState:
        return init_state((self.channels,), device=self.device)

    def forward(self, state: FmDiscState, re: torch.Tensor, im: torch.Tensor):
        if self.mode == "scan":
            return fm_receiver(state, re, im, self.carrier, self.ba_q, self.f)
        if self.mode == "composed":
            dphi = discriminate(state, re, im, self.carrier)
            if self._ba_planes is None or self._ba_planes.device != dphi.device:
                self._ba_planes = torch.tensor(self.ba_q, dtype=torch.int32,
                                               device=dphi.device)
            deemph, y = df1_bank_q_coef(self._ba_planes, state.deemph, dphi,
                                        self.f)
            return next_state(state, re, im, deemph), y
        angle = "exact" if self.mode == "kernel" else "fast"
        return fm_disc_bank(self.ba_q, state, re, im, self.carrier, self.f,
                            angle=angle)


# --- fixture + metrics (fm_disc.rs:55-140) ----------------------------------


def fm_signal(carrier: int, deviation: int, message_freq: float, n: int, *,
              device):
    """Synthetic FM IQ via the cossin DDS (fm_disc.rs:57-74).

    The message is an f32 sine; the frequency of each sample is
    carrier + trunc(deviation * msg), its phase the wrapping cumsum.
    Returns ((re, im) int32, message f32)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    w = np.float32(2.0 * np.pi) * np.float32(message_freq)
    msg = torch.sin(torch.tensor(w, device=device) * i)
    dev = (msg * float(np.float32(deviation))).to(torch.int32)  # trunc
    freq = wrap_carrier(carrier) + dev.to(torch.int64)
    phase = wrap_i32(torch.cumsum(freq, 0))
    return cossin(phase), msg


def lowpass_reference(cutoff: float, x):
    """Float f32 DF1 lowpass of the message (fm_disc.rs:92-100), run
    where ``x`` lies."""
    ba = biquad.from_cookbook(
        Filter().critical_frequency(cutoff).lowpass()).astype(np.float32)
    st = biquad.df1_init((), torch.float32, device=x.device)
    _, y = biquad.df1_process(ba, st, x.to(torch.float32))
    return y


def measure_fm(y, m, skip: int):
    """corr / gain / rms metrics (fm_disc.rs:78-124) of numpy arrays."""
    y = np.asarray(y, np.float64)[skip:]
    m = np.asarray(m, np.float64)[skip:]
    gain = float((y * m).sum() / (m * m).sum())
    rms = float(np.sqrt(((y - gain * m) ** 2).sum()) / len(y))
    corr = float((y * m).sum()
                 / (np.sqrt((y * y).sum()) * np.sqrt((m * m).sum())))
    return {"corr": corr, "gain": gain, "rms": rms}


def run_fm_disc(n: int = 4096, kernel: str | None = None, *, device="cuda"):
    """The full example with the reference's constants (fm_disc.rs:126-140).

    ``kernel``: None = `fm_receiver`; "exact" = K15 (bit-identical);
    "fast" = K15 with the f32 angle (SNR-gated), the mono signal as a
    one-channel bank.  The receiver runs on ``device`` (the card unless
    the caller asks for another); the message's reference lowpass runs on
    the CPU.  Returns the `measure_fm` metrics.
    """
    carrier_u = 0x1934_1234
    deviation = 0x0450_0000
    message_freq = 0.004
    cutoff = 0.02
    scale = 2.0 * np.pi / 2.0**32

    (re, im), msg = fm_signal(carrier_u, deviation, message_freq, n,
                              device=device)
    ba_q = deemphasis_coefficients(cutoff)
    if kernel is None:
        _, y_bits = fm_receiver(init_state(device=device), re, im, carrier_u,
                                ba_q)
    else:
        _, y2 = fm_disc_bank(ba_q, init_state((1,), device=device),
                             re[:, None].contiguous(),
                             im[:, None].contiguous(), carrier_u,
                             angle=kernel)
        y_bits = y2[:, 0]
    y = y_bits.cpu().numpy().astype(np.float64) * scale
    m = lowpass_reference(
        cutoff, torch.from_numpy(msg.cpu().numpy() * np.float32(deviation
                                                               * scale)))
    return measure_fm(y, m.numpy(), 1024)
