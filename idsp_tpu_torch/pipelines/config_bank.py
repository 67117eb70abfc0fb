"""A bank of runtime-configured biquads: one `BiquadConfig` per channel.

The Stabilizer control plane builds each channel's clamped biquad from
its configuration (`design.config.BiquadConfig.build(units, f=29)`: Q<f>
coefficients, offset, limits) and retunes channels while the stream
runs.  `ConfigBank` stacks the channels' quantized coefficients into
(5, c) int32 planes and runs them through the runtime-coefficient DF1
banks: K27 `df1_clamp_bank_q_coef` (the offset and limits, shared by
every channel, as that kernel takes them) or, with ``clamp=False``, K26
`df1_bank_q_coef`.  A retune is a new planes tensor for the next block:
the state carries across it, and nothing is rebuilt (the DF1
atomic-swap property, biquad.rs:34-36).  Time is axis 0; state and
outputs as `df1_bank_q`'s.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..design.pid import ClampedCoeffs
from ..filters import biquad
from ..filters.biquad_cuda import (
    coef_planes, df1_bank_q_coef, df1_clamp_bank_q_coef,
)


def stack_coeffs(coeffs: Sequence[ClampedCoeffs]):
    """(5, c) int32 planes of c quantized `ClampedCoeffs`, and their
    common int32 (u, lo, hi); raises if the channels' offsets or limits
    differ (the clamped bank takes one triple)."""
    planes = np.stack([np.asarray(cc.ba) for cc in coeffs], axis=1)
    if planes.shape[0] != 5 or planes.dtype != np.int32:
        raise ValueError("need quantized coefficients (build with f=...): "
                         f"got {planes.dtype} planes of shape {planes.shape}")
    bounds = {(int(cc.u), int(cc.min), int(cc.max)) for cc in coeffs}
    if len(bounds) != 1:
        raise ValueError(f"channels differ in offset or limits: {bounds}")
    return planes, biquad.clamp_params(*bounds.pop())


class ConfigBank(nn.Module):
    """``forward(state, xs) -> (state, ys)`` over xs (t, c) int32, one
    configured biquad per channel.

    Args:
      coeffs: c `ClampedCoeffs` built with ``f`` (`BiquadConfig.build(...,
        f=f)` or `Pid.build(..., f=f)`), one per channel.
      f: their fractional bits.
      clamp: True runs K27 with the channels' shared (u, lo, hi); False
        runs K26 (coefficients only).
      device: where the planes and `init_state` live (the card unless the
        caller asks for another device).
    """

    def __init__(self, coeffs: Sequence[ClampedCoeffs], *, f: int = 29,
                 clamp: bool = True, device="cuda"):
        super().__init__()
        planes, self.bounds = stack_coeffs(coeffs)
        self.channels = planes.shape[1]
        self.f = f
        self.clamp = clamp
        self.device = torch.device(device)
        self.planes = coef_planes(planes, self.channels, self.device)

    def init_state(self) -> biquad.Df1State:
        return biquad.df1_init((self.channels,), device=self.device)

    def retune(self, channels, coeffs: Sequence[ClampedCoeffs]) -> None:
        """Give ``channels`` (indices) the coefficients of ``coeffs``
        from the next block on, in a new planes tensor; the other
        channels, and every channel's state, are untouched.  The new
        channels must share the bank's offset and limits when it clamps.
        """
        new, bounds = stack_coeffs(coeffs)
        if self.clamp and bounds != self.bounds:
            raise ValueError(f"retune bounds {bounds} differ from the "
                             f"bank's {self.bounds}")
        planes = self.planes.clone()
        idx = torch.as_tensor(channels, dtype=torch.long, device=self.device)
        planes[:, idx] = torch.from_numpy(new).to(self.device)
        self.planes = planes

    def forward(self, state: biquad.Df1State, xs: torch.Tensor):
        if not self.clamp:
            return df1_bank_q_coef(self.planes, state, xs, self.f)
        u, lo, hi = self.bounds
        return df1_clamp_bank_q_coef(self.planes, state, xs, self.f, u=u,
                                     lo=lo, hi=hi)
