"""Wave-digital allpass filters, two-port adapter chains (port of
`idsp_tpu.filters.wdf`).

The reference's src/iir/wdf.rs: a chain of two-port adapters, each one
of eight architectures (A/B/B1/X/C/C1/D/Z) chosen so the quantized
coefficient lands in -0.5 <= a <= 0 (which just fits Q32<32>).  Combined
in complementary pairs they form cheap half-band IIR filters.

Per-sample dataflow (wdf.rs:155-171): stage i consumes [x_i, z_i] and
produces [w_i, x_{i+1}]; w_0 is the output, w_i (i >= 1) updates
z_{i-1} (each adapter reads the old z of its stage), and the final x_N
lands in z_{N-1}.

Arithmetic: int32, wrapping; the ``c * a`` apply is the high word of the
signed 64-bit product (the truncating Q32<32> `fxp.q_apply`).  The scans
hold the words as int64: ``c`` is wrapped to int32 before its product,
and every sum is a ring operation mod 2^32, so the other words wrap once,
where they leave the step (outputs and state), with the same result as
wrapping each sum.
"""

from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import numpy as np
import torch

from .. import fxp


class Tpa(IntEnum):
    """Two-port adapter architectures (wdf.rs:15-32), one nibble each."""

    Z = 0x0
    A = 0xA
    B = 0xB
    B1 = 0xE
    X = 0x1
    C = 0xC
    C1 = 0xF
    D = 0xD


def quantize(tpas: list[Tpa], g: np.ndarray) -> np.ndarray:
    """Quantize allpass pole coefficients per adapter type (wdf.rs:51-63):
    map g to a in [-0.5, 0] and encode as Q32<32>."""
    g = np.asarray(g, dtype=np.float64)
    a = np.empty_like(g)
    for i, t in enumerate(tpas):
        if t == Tpa.A:
            a[i] = g[i] - 1.0
        elif t in (Tpa.B, Tpa.B1):
            a[i] = -g[i]
        elif t in (Tpa.C, Tpa.C1):
            a[i] = g[i]
        elif t == Tpa.D:
            a[i] = -1.0 - g[i]
        else:
            a[i] = 0.0
        if not (-0.5 <= a[i] <= 0.0):
            raise ValueError(
                f"adapter {t.name} coefficient {a[i]} outside [-0.5, 0]"
            )
    return fxp.from_float(a, 32)


def nibbles(m: int, n: int) -> list[Tpa]:
    """Decode the packed configuration word (one nibble per stage, lowest
    nibble = stage 0, wdf.rs:104-113)."""
    out = []
    for _ in range(n):
        out.append(Tpa(m & 0xF) if (m & 0xF) in list(Tpa) else Tpa.Z)
        m >>= 4
    return out


def _adapt(tpa: Tpa, x0, x1, a):
    """One two-port adapter (wdf.rs:65-101) on int64 words holding int32
    values mod 2^32: ``c`` wrapped, then the high word of ``a * c``.
    Returns (w, next)."""

    def mul(c):
        return (a * fxp.wrap32(c)) >> 32

    if tpa == Tpa.A:
        c = x1 - x0
        y = mul(c) + x1
        return y + c, y
    if tpa == Tpa.B:
        c = x0 - x1
        y = mul(c) + x1
        return y, y + c
    if tpa == Tpa.B1:
        c = x0 - x1
        y = mul(c)
        return y + x1, y + x0
    if tpa == Tpa.X:
        return x1, x0
    if tpa == Tpa.C:
        c = x1 - x0
        y = mul(c) - x1
        return y, y + c
    if tpa == Tpa.C1:
        c = x1 - x0
        y = mul(c)
        return y - x1, y - x0
    if tpa == Tpa.D:
        c = x0 - x1
        y = mul(c) - x1
        return y + c, y
    return x0, x1  # Z: terminate


class WdfState(NamedTuple):
    z: torch.Tensor  # (..., N) int32


def init(n: int, shape=(), *, device) -> WdfState:
    return WdfState(z=torch.zeros(tuple(shape) + (n,), dtype=torch.int32,
                                  device=device))


def _coefs(a, n: int, device):
    """One shared (N,) set as Python ints, or a (..., N) array as int64
    tensors of the lane shape (one set per lane)."""
    if isinstance(a, torch.Tensor):
        if a.dim() <= 1:
            return [int(v) for v in a.cpu().reshape(-1)[:n]]
        planes = a.to(device=device, dtype=torch.int64)
    else:
        arr = np.asarray(a)
        if arr.ndim <= 1:
            return [int(v) for v in arr.reshape(-1)[:n]]
        planes = torch.from_numpy(arr.astype(np.int64)).to(device)
    return [planes[..., i] for i in range(n)]


def _chain(tpas, a, z, cur):
    """One sample through one adapter chain: ``z`` the stage's words (a
    list, updated in place), ``cur`` the input.  Returns the output w_0."""
    y = None
    for i, t in enumerate(tpas):
        w, cur = _adapt(t, cur, z[i], a[i])
        if i == 0:
            y = w
        else:
            z[i - 1] = w
    z[-1] = cur
    return y


def step(tpas: list[Tpa], a, state: WdfState, x):
    """One sample through the adapter chain (wdf.rs:155-171).  Returns
    (state, y int32)."""
    x = torch.as_tensor(x, dtype=torch.int32, device=state.z.device)
    a = _coefs(a, len(tpas), x.device)
    z = list(state.z.to(torch.int64).unbind(-1))
    y = _chain(tpas, a, z, x.to(torch.int64))
    return (WdfState(z=fxp.wrap_i32(torch.stack(z, dim=-1))),
            fxp.wrap_i32(y))


def block(tpas: list[Tpa], a, state: WdfState, xs):
    """`step` scanned over time axis 0 of ``xs`` (t, ...) int32.  Returns
    (state, ys int32)."""
    a = _coefs(a, len(tpas), xs.device)
    z = list(state.z.to(torch.int64).unbind(-1))
    xs64 = xs.to(torch.int64)
    ys = torch.empty_like(xs64)
    for i in range(xs.shape[0]):
        ys[i] = _chain(tpas, a, z, xs64[i])
        z = [fxp.wrap32(v) for v in z]
    return (WdfState(z=torch.stack(z, dim=-1).to(torch.int32)),
            fxp.wrap_i32(ys))


def chain_block(stages, states, xs):
    """Serial cascade of adapter chains (`[Wdf; K]` arrays in the
    reference's bench configs). stages: list of (tpas, a)."""
    new_states = []
    cur = xs
    for (tpas, a), st in zip(stages, states):
        st2, cur = block(tpas, a, st, cur)
        new_states.append(st2)
    return new_states, cur


def pair_block(branch0, branch1, states, xs):
    """Complementary allpass pair (`Pair` + `Add`/`Sub`,
    dsp-process/src/lib.rs:41-67, tests/embedded/src/bin/biquad.rs:
    120-173): the sum gives the (gain-2) lowpass, the difference the
    highpass.

    branch0/branch1: lists of (tpas, a) serial stages.
    Returns ((s0, s1), (sum, diff)), int32, wrapping."""
    s0, s1 = states
    s0, y0 = chain_block(branch0, s0, xs)
    s1, y1 = chain_block(branch1, s1, xs)
    y0, y1 = y0.to(torch.int64), y1.to(torch.int64)
    return (s0, s1), (fxp.wrap_i32(y0 + y1), fxp.wrap_i32(y0 - y1))
