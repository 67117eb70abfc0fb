"""Half-band FIR decimators (port of the decimation part of
`idsp_tpu.filters.hbf`, reference src/hbf.rs).

Each stage is a symmetric FIR over a tail-extended block
(overlap-save): the carried state is exactly the impulse-response tail
(hbf.rs:93-101).  Time runs on the last axis (``axis=-1``, channels
lead) or on the first (``axis=0``, time-major ``(t, c)``, the layout of
the fused DDC chain).

The f32 operation order is the JAX package's: ``acc += (b + a) *
tap[i]`` for i ascending (small taps first), then ``+ even`` — one
rounding per operation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: 140 dB-stopband half-band cascade taps (hbf.rs:308-349), lowest rate
#: first; stage i has one-sided tap count (23, 10, 5, 4, 3).
HBF_TAPS: tuple[np.ndarray, ...] = tuple(
    np.array(t, dtype=np.float32)
    for t in (
        [
            7.60375795e-07, -3.77494111e-06, 1.26458559e-05, -3.43188253e-05,
            8.10687478e-05, -1.72971467e-04, 3.40845059e-04, -6.29522864e-04,
            1.10128831e-03, -1.83933299e-03, 2.95124926e-03, -4.57290964e-03,
            6.87374176e-03, -1.00656257e-02, 1.44199840e-02, -2.03025100e-02,
            2.82462332e-02, -3.91128509e-02, 5.44795658e-02, -7.77002672e-02,
            1.17523452e-01, -2.06185388e-01, 6.34588695e-01,
        ],
        [
            -1.12811343e-05, 1.12724671e-04, -6.07439343e-04, 2.31904511e-03,
            -7.00322950e-03, 1.78225473e-02, -4.01209836e-02, 8.43315989e-02,
            -1.83189521e-01, 6.26346521e-01,
        ],
        [0.0007686, -0.00768669, 0.0386536, -0.14002434, 0.60828885],
        [-0.00261331, 0.02476858, -0.12112638, 0.59897111],
        [0.01186105, -0.09808109, 0.58622005],
    )
)


def fir_len(m: int, odd: bool) -> int:
    """Response length minus one: LEN = 2M - 1 + odd (hbf.rs:78)."""
    return 2 * m - 1 + int(odd)


def _sl(x, start: int, stop: int, axis: int, step: int = 1):
    """``x[start:stop:step]`` along ``axis`` (0 or -1)."""
    if axis == 0:
        return x[start:stop:step]
    return x[..., start:stop:step]


def symmetric_fir(taps, x_ext, *, odd: bool, sym: bool, axis: int = -1):
    """Linear-phase FIR over a tail-extended block (hbf.rs:46-68).

    ``x_ext`` has ``n + LEN`` samples on the time axis; returns n
    outputs ``y[j] = sum_i c[i]*(x[j+L-i] +/- x[j+i])`` (+ ``x[j+M]``
    for odd symmetric), taps small (far from center) to large.
    """
    taps = np.asarray(taps, dtype=np.float32)
    m = taps.shape[0]
    ln = fir_len(m, odd)
    n = x_ext.shape[axis] - ln
    acc = None
    for i in range(m):
        a = _sl(x_ext, i, i + n, axis)
        b = _sl(x_ext, ln - i, ln - i + n, axis)
        term = (b + a if sym else b - a) * float(taps[i])
        acc = term if acc is None else acc + term
    if odd and sym:
        acc = acc + _sl(x_ext, m, m + n, axis)
    return acc


class HbfDecState(NamedTuple):
    """Odd-sample FIR tail (2M-1) + even-sample delay tail (M-1)."""

    odd: torch.Tensor
    even: torch.Tensor


def hbf_dec_init(m: int, shape=(), dtype=torch.float32, axis: int = -1, *,
                 device) -> HbfDecState:
    shape = tuple(shape)
    lo, le = (2 * m - 1,), (max(m - 1, 0),)
    if axis == 0:
        return HbfDecState(
            odd=torch.zeros(lo + shape, dtype=dtype, device=device),
            even=torch.zeros(le + shape, dtype=dtype, device=device),
        )
    return HbfDecState(
        odd=torch.zeros(shape + lo, dtype=dtype, device=device),
        even=torch.zeros(shape + le, dtype=dtype, device=device),
    )


def hbf_dec_block(taps, state: HbfDecState, x, *, axis: int = -1):
    """Decimate-by-2 (hbf.rs:156-192): even samples bypass through a
    center-tap delay of M-1, odd samples run the symmetric FIR.

    x: 2n full-rate samples on the time axis; returns (state, n outputs).
    """
    n2 = x.shape[axis]
    dim = 0 if axis == 0 else x.dim() - 1
    even_new = _sl(x, 0, n2, axis, 2)
    odd_new = _sl(x, 1, n2, axis, 2)
    odd_ext = torch.cat([state.odd, odd_new], dim=dim)
    even_ext = torch.cat([state.even, even_new], dim=dim)
    y = symmetric_fir(taps, odd_ext, odd=False, sym=True, axis=axis)
    n = odd_new.shape[axis]
    y = y + _sl(even_ext, 0, n, axis)
    return (
        HbfDecState(
            odd=_sl(odd_ext, n, odd_ext.shape[axis], axis),
            even=_sl(even_ext, n, even_ext.shape[axis], axis),
        ),
        y,
    )


def hbf_dec_cascade_init(depth: int, shape=(), dtype=torch.float32,
                         taps=HBF_TAPS, axis: int = -1, *, device):
    """States for a 2**depth decimation cascade (highest rate first)."""
    return tuple(
        hbf_dec_init(len(taps[d]), shape, dtype, axis=axis, device=device)
        for d in reversed(range(depth))
    )


def hbf_dec_cascade(states, x, taps=HBF_TAPS, *, axis: int = -1):
    """Decimate by 2**depth (depth = len(states)), highest-rate stage
    first (hbf.rs:385-421): taps[depth-1] .. taps[0]."""
    depth = len(states)
    new_states = []
    cur = x
    for i, st in enumerate(states):
        st2, cur = hbf_dec_block(taps[depth - 1 - i], st, cur, axis=axis)
        new_states.append(st2)
    return tuple(new_states), cur
