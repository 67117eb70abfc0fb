"""Coarse/fine factored local oscillator (port of `idsp_tpu.ops.fastlo`).

For the ramp ``phase[n] = phase0 + step * n`` (wrapping i32, n = 1..t),
write ``n = a*k + b`` with ``b in [1, k]``:

    lo[n] = exp(j*w*(phase0 + step*a*k)) * exp(j*w*step*b)
          =        coarse[a]             *     fine[b-1]

with ``w = 2*pi/2^32``: ``t/k + k`` trig evaluations per channel
instead of ``t``.  The mix rounds to i32, so the integer biquad after
it is unchanged.  This is the SNR-gated fast path (reference DDS
spectral suite, src/cossin.rs:199-247), not a bit-exact one: f32
``cos``/``sin`` differ by ULPs between PyTorch and XLA.

Every f32 expression keeps the JAX package's operation order, one
rounding per operation, so the CUDA kernel that inlines the mix can be
written with ``__fmul_rn``/``__fadd_rn`` and match this code bit for
bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fxp import wrap_i32

# Gain-matching amplitude of the exact path: `cossin` phasors have
# amplitude ~(2^31 - 2^15) and the exact mix computes (lo * x) >> 32.
# Exact in f32 (16 significant bits).
AMPLITUDE = float(2**31 - 2**15) / 2**32

_RAD_PER_LSB = np.float32(np.pi / 2**31)


def round_half_away(v: torch.Tensor) -> torch.Tensor:
    """Round-half-away-from-zero on f32 via floor/where (fastlo.py:47-55)."""
    return torch.where(v >= 0, torch.floor(v + 0.5), -torch.floor(-v + 0.5))


def _angle_trig(phase_i32: torch.Tensor):
    """Unit f32 cos/sin of a wrapping-i32 phase (i32::MIN = -pi)."""
    ang = phase_i32.to(torch.float32) * torch.tensor(
        _RAD_PER_LSB, device=phase_i32.device
    )
    return torch.cos(ang), torch.sin(ang)


def fastlo_tables(phase0, steps, t: int, k: int):
    """Coarse/fine factor tables for the ramp ``phase0 + steps*n``.

    Args:
      phase0: (c,) i32 phase before the first sample.
      steps: (c,) i32 per-channel frequency words.
      t: total samples (t % k == 0).
      k: fine-table length (the kernel time chunk).

    Returns (ca, sa, cb, sb): coarse (t//k, c) and fine (k, c) f32
    unit-amplitude planes; ``lo[a*k + b] = (ca+j*sa)[a] * (cb+j*sb)[b-1]``.
    """
    if t % k:
        raise ValueError(f"t={t} is not a multiple of k={k}")
    dev = phase0.device
    phase0 = phase0.to(torch.int64)
    steps = steps.to(torch.int64)
    a = torch.arange(t // k, dtype=torch.int64, device=dev) * k
    b = torch.arange(1, k + 1, dtype=torch.int64, device=dev)
    coarse_ph = wrap_i32(phase0[None, :] + steps[None, :] * a[:, None])
    fine_ph = wrap_i32(steps[None, :] * b[:, None])
    ca, sa = _angle_trig(coarse_ph)
    cb, sb = _angle_trig(fine_ph)
    return ca, sa, cb, sb


def _lo_planes(ca, sa, cb, sb):
    """(t//k, k, c) LO planes from the factor tables (fastlo.py:130-131)."""
    lo_re = ca[:, None, :] * cb[None] - sa[:, None, :] * sb[None]
    lo_im = sa[:, None, :] * cb[None] + ca[:, None, :] * sb[None]
    return lo_re, lo_im


def fastlo_iq(phase0, steps, t: int, k: int = 128):
    """Full-rate unit-amplitude LO planes (lo_re, lo_im), each (t, c) f32."""
    lo_re, lo_im = _lo_planes(*fastlo_tables(phase0, steps, t, k))
    c = lo_re.shape[-1]
    return lo_re.reshape(t, c), lo_im.reshape(t, c)


def fastlo_mix_tables(x, tables):
    """Conjugate mix of ``x`` (t,) i32 with prebuilt factor tables:
    ``miq`` (t, 2c) i32, I lanes then Q lanes."""
    ca, sa, cb, sb = tables
    k, c = cb.shape
    t = x.shape[0]
    xh = x.to(torch.float32) * torch.tensor(
        np.float32(AMPLITUDE), device=x.device
    )
    xh = xh.reshape(t // k, k, 1)
    lo_re, lo_im = _lo_planes(ca, sa, cb, sb)
    mi = round_half_away(lo_re * xh).to(torch.int32).reshape(t, c)
    mq = round_half_away(-(lo_im * xh)).to(torch.int32).reshape(t, c)
    return torch.cat([mi, mq], dim=1)


def fastlo_mix(x, phase0, steps, k: int = 128):
    """Fast-path conjugate NCO mix: ``miq`` (t, 2c) i32, the drop-in for
    ``[q_apply(lo_re, x, 32) | q_apply(-lo_im, x, 32)]`` with rounded f32
    instead of truncated int64 sample arithmetic."""
    tables = fastlo_tables(phase0, steps, x.shape[0], k)
    return fastlo_mix_tables(x, tables)
