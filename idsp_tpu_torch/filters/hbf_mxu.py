"""K22 and K23: the half-band rate-change cascades in their banded-matrix
form (port of the MXU half of `idsp_tpu.filters.hbf_pallas`:
`hbf_dec_cascade_mxu` and `hbf_int_cascade_mxu`).

On the TPU each stage was one product of a fixed banded Toeplitz
operator (`_hbf_dec_band_matrix`, `_hbf_int_band_matrix`) with a window
of ``[carry | block]`` rows, the carry being the stage's last ``kp``
input rows.  The port keeps the operator and the carry layout and fixes
the summation order itself: each output row is the sum of its band
row's nonzero entries times their window rows, in ascending column
order, one rounding per multiply and per add.

* K22 `hbf_dec_cascade_mxu`: decimate by 2**depth; stage i uses
  ``taps[depth-1-i]`` (highest rate first).  A decimating row has 2m+1
  entries: m taps on odd columns, the unit center, m taps mirrored.
* K23 `hbf_int_cascade_mxu`: interpolate by 2**depth; stage i uses
  ``taps[i]`` (lowest rate first).  Even output rows have 2m entries
  (the FIR), odd rows one unit entry (the M-delayed center copy,
  hbf.rs:208-236).

Both take and return the time-major (``axis=0``) `HbfDecState` /
`HbfIntState` tuples of `hbf` (the same as K7/K8), launch
``csrc/hbf_mxu.cu`` for CUDA tensors, run their plain PyTorch versions
(``*_plain``) for CPU tensors, and raise for any other device.  The
plain versions sum in the kernels' order (one torch multiply and one
add per band column, over all rows and lanes at once), so on the card
the two agree bit for bit.  That order is not the shift form's (K7 adds
mirrored pairs first), so these outputs and later-stage states are held
to K7/K8 and `hbf.hbf_*_cascade` within a tolerance, never bit for bit;
the stage-0 state is copies of the input and equal.

``block`` and ``sub`` size the kernel's tiles only (the time segment a
CUDA block owns, the rows a warp takes at a time); no value depends on
them.  ``precision`` names the TPU's ways to reach f32 on bf16 matrix
units: ``"split3"`` and ``"highest"`` both run the full f32 sum here;
``"default"`` (one bf16 pass, about 4.5e-3 relative on the TPU) is not
ported and raises NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from .hbf import HBF_TAPS, HbfDecState, HbfIntState
from .hbf_cuda import MAX_DEPTH, _launch, _split

PRECISIONS = ("split3", "highest")


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def dec_kp(m: int) -> int:
    """Rows of a decimation stage's carry slot: ceil8(4m-2)."""
    return _ceil8(4 * m - 2)


def int_kp(m: int) -> int:
    """Rows of an interpolation stage's carry slot: ceil8(2m-1)."""
    return _ceil8(2 * m - 1)


def _hbf_dec_band_matrix(taps, n_out: int, kp: int) -> np.ndarray:
    """(n_out, kp + 2*n_out) banded operator of one half-band dec-by-2
    stage over [zero pad | full-rate carry | block] rows
    (hbf_pallas.py:361): with the carry right-aligned in a ``kp``-row
    slot, o = kp - (4m-2),

        y[j] = sum_i tv[i] * (ext[o + 2j+2i+1] + ext[o + 2j+4m-1-2i])
               + ext[o + 2j+2m].
    """
    taps = np.asarray(taps, np.float64)
    m = taps.shape[0]
    o = kp - (4 * m - 2)
    w = np.zeros((n_out, kp + 2 * n_out), np.float32)
    for j in range(n_out):
        for i in range(m):
            w[j, o + 2 * j + 2 * i + 1] += np.float32(taps[i])
            w[j, o + 2 * j + 4 * m - 1 - 2 * i] += np.float32(taps[i])
        w[j, o + 2 * j + 2 * m] += 1.0
    return w


def _hbf_int_band_matrix(taps, su: int, kp: int) -> np.ndarray:
    """(2*su, kp + su) banded operator of one half-band int-by-2 stage
    window (hbf_pallas.py:594): the FIR in even rows, the M-delayed
    center tap in odd rows, over [zero pad | low-rate tail | window]."""
    taps = np.asarray(taps, np.float64)
    m = taps.shape[0]
    ln = 2 * m - 1
    o = kp - ln
    w = np.zeros((2 * su, kp + su), np.float32)
    for j in range(su):
        for i in range(m):
            w[2 * j, o + j + i] += np.float32(taps[i])
            w[2 * j, o + j + ln - i] += np.float32(taps[i])
        w[2 * j + 1, o + j + m] += 1.0
    return w


def _carry_from_state(st: HbfDecState, m: int, kp: int, c2: int):
    """HbfDecState (odd 2m-1, even m-1 rows) -> right-aligned (kp, c2)
    full-rate carry: carry[o+2r+1] = odd[r], carry[o+2m+2r] = even[r]
    (hbf_pallas.py:388); the other rows are never read and stay 0."""
    o = kp - (4 * m - 2)
    carry = torch.zeros((kp, c2), dtype=st.odd.dtype, device=st.odd.device)
    carry[o + 1:o + 4 * m - 2:2] = st.odd
    if m > 1:
        carry[o + 2 * m:o + 4 * m - 3:2] = st.even
    return carry


def _state_from_carry(carry, m: int, kp: int) -> HbfDecState:
    o = kp - (4 * m - 2)
    return HbfDecState(odd=carry[o + 1:o + 4 * m - 2:2],
                       even=carry[o + 2 * m:o + 4 * m - 3:2])


def _int_carry_from_state(st: HbfIntState, kp: int, c2: int):
    """HbfIntState x (2m-1 rows) right-aligned in a (kp, c2) slot
    (hbf_pallas.py:635-639)."""
    carry = torch.zeros((kp, c2), dtype=st.x.dtype, device=st.x.device)
    carry[kp - st.x.shape[0]:] = st.x
    return carry


def _int_state_from_carry(carry, m: int, kp: int) -> HbfIntState:
    return HbfIntState(x=carry[kp - (2 * m - 1):])


def dec_band_row(taps, kp: int):
    """(columns, weights) of band row 0 of `_hbf_dec_band_matrix`, in
    the order the kernel sums them: ascending columns, the m taps on
    odd columns, the unit center, the mirrored taps.  Row j is row 0
    shifted by 2j columns."""
    m = len(taps)
    o = kp - (4 * m - 2)
    cols = ([o + 1 + 2 * i for i in range(m)] + [o + 2 * m]
            + [o + 2 * m + 1 + 2 * k for k in range(m)])
    row = _hbf_dec_band_matrix(taps, 1, kp)[0]
    return cols, row[cols]


def int_band_row(taps, kp: int):
    """(columns, weights) of the even (FIR) row 0 of
    `_hbf_int_band_matrix`, ascending (taps, then mirrored taps), and
    the odd row's one unit column (the center copy).  Row pair j is row
    pair 0 shifted by j columns."""
    m = len(taps)
    o = kp - (2 * m - 1)
    cols = list(range(o, o + 2 * m))
    band = _hbf_int_band_matrix(taps, 1, kp)
    return cols, band[0, cols], o + m


def _sum_band(ext, cols, weights, n: int, step: int):
    """n rows of ``sum_k ext[cols[k] + step*j] * weights[k]``, k
    ascending, one rounding per multiply and add (the kernels' order)."""
    acc = None
    for col, w in zip(cols, weights):
        term = ext[col:col + step * (n - 1) + 1:step] * float(w)
        acc = term if acc is None else acc + term
    return acc


def _check_args(xs, block: int, sub: int, precision: str, mult: int):
    if xs.dtype != torch.float32 or xs.dim() != 2:
        raise ValueError(f"xs must be (t, c) float32, got {xs.dtype} "
                         f"{tuple(xs.shape)}")
    t = xs.shape[0]
    if t <= 0 or t % mult:
        raise ValueError(f"block length {t} must be a positive multiple of "
                         f"{mult}")
    if precision == "default":
        raise NotImplementedError(
            "precision='default' (one bf16 pass, ~4.5e-3 rel on the TPU) is "
            "not ported; 'split3' and 'highest' run the full f32 sum")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS} or "
                         f"'default', got {precision!r}")
    if block < mult or sub < 1:
        raise ValueError(f"block must be >= {mult} and sub >= 1, got "
                         f"{block}, {sub}")


def _stage_taps(states, taps, decimate: bool):
    """Each stage's taps in stage order: ``taps[depth-1-i]`` for the
    decimator (highest rate first), ``taps[i]`` for the interpolator."""
    depth = len(states)
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be 1..{MAX_DEPTH}, got {depth}")
    taps = HBF_TAPS if taps is None else taps
    order = range(depth - 1, -1, -1) if decimate else range(depth)
    return tuple(np.asarray(taps[i], np.float32) for i in order)


def hbf_dec_cascade_mxu_plain(states, xs, *, taps=None):
    """Plain PyTorch version of K22 `hbf_dec_cascade_mxu`: per stage the
    carry window (`_carry_from_state`) before the stage's input, then
    one shifted stride-2 slice times its weight per band column, summed
    in ascending column order; the new carry is the last ``kp`` rows."""
    stage_taps = _stage_taps(states, taps, True)
    c = xs.shape[1]
    new, cur = [], xs
    for st, tv in zip(states, stage_taps):
        m, kp = len(tv), dec_kp(len(tv))
        ext = torch.cat([_carry_from_state(st, m, kp, c), cur], dim=0)
        cols, weights = dec_band_row(tv, kp)
        cur = _sum_band(ext, cols, weights, cur.shape[0] // 2, 2)
        new.append(_state_from_carry(ext[ext.shape[0] - kp:], m, kp))
    return tuple(new), cur


def hbf_int_cascade_mxu_plain(states, xs, *, taps=None):
    """Plain PyTorch version of K23 `hbf_int_cascade_mxu`: per stage the
    right-aligned carry before the input, the even rows one shifted
    slice times its weight per band column (ascending), the odd rows
    the center column copied; the new carry is the last ``kp`` rows."""
    stage_taps = _stage_taps(states, taps, False)
    c = xs.shape[1]
    new, cur = [], xs
    for st, tv in zip(states, stage_taps):
        m, kp = len(tv), int_kp(len(tv))
        ext = torch.cat([_int_carry_from_state(st, kp, c), cur], dim=0)
        cols, weights, center = int_band_row(tv, kp)
        n = cur.shape[0]
        fir = _sum_band(ext, cols, weights, n, 1)
        cur = torch.stack([fir, ext[center:center + n]],
                          dim=1).flatten(0, 1)
        new.append(_int_state_from_carry(ext[ext.shape[0] - kp:], m, kp))
    return tuple(new), cur


def hbf_dec_cascade_mxu(states, xs, *, taps=None, block: int = 256,
                        sub: int = 32, precision: str = "split3"):
    """Decimate-by-2**depth half-band cascade in its banded-matrix form,
    one kernel, depth = len(states).

    Args:
      states: `HbfDecState`s in the axis=0 layout, highest-rate stage
        first (`hbf.hbf_dec_cascade_init(depth, (c,), axis=0, ...)`).
      xs: (t, c) f32 full-rate block, t % 2**depth == 0, any c.
      taps: the full tap table (default `HBF_TAPS`); stage i uses
        ``taps[depth-1-i]``.
      block: the full-rate rows of a CUDA block's time segment (lowered
        to a multiple of 2**depth, at most t); each segment also
        recomputes the cascade's halo before it.  A segment whose stage
        buffers exceed a block's shared memory is refused (RuntimeError).
      sub: output rows a warp takes at a time (at most its share of a
        stage).
      precision: ``"split3"`` or ``"highest"`` (both the full f32 sum);
        ``"default"`` raises NotImplementedError.

    Returns (new_states, y) with y (t // 2**depth, c) f32.
    """
    stage_taps = _stage_taps(states, taps, True)
    depth = len(stage_taps)
    r = 1 << depth
    _check_args(xs, block, sub, precision, r)
    if xs.device.type == "cpu":
        return hbf_dec_cascade_mxu_plain(states, xs, taps=taps)
    t = xs.shape[0]
    seg = min(block, t) // r * r
    rows = [(2 * len(tv) - 1, len(tv) - 1) for tv in stage_taps]
    packed, y = _launch("hbf_dec_mxu", [(s.odd, s.even) for s in states],
                        rows, xs, stage_taps, t >> depth, seg, sub)
    hbf_dec_cascade_mxu.launches += 1
    return tuple(HbfDecState(odd=o, even=e)
                 for o, e in _split(packed, rows)), y


hbf_dec_cascade_mxu.launches = 0  # kernel launches since the last reset


def hbf_int_cascade_mxu(states, xs, *, taps=None, block: int = 64,
                        sub: int = 32, precision: str = "split3"):
    """Interpolate-by-2**depth half-band cascade in its banded-matrix
    form, one kernel, depth = len(states).

    Args:
      states: `HbfIntState`s in the axis=0 layout, lowest-rate stage
        first (`hbf.hbf_int_cascade_init(depth, (c,), axis=0, ...)`).
      xs: (t, c) f32 low-rate block, t >= 1, any c.
      taps: the full tap table (default `HBF_TAPS`); stage i uses
        ``taps[i]``.
      block: the low-rate rows of a CUDA block's time segment (at most
        t); each segment also recomputes the cascade's halo before it.
        A segment whose stage buffers exceed a block's shared memory is
        refused (RuntimeError).
      sub: output row pairs a warp takes at a time (at most its share of
        a stage).
      precision: as for `hbf_dec_cascade_mxu`.

    Returns (new_states, y) with y (t * 2**depth, c) f32: per stage the
    FIR output in the even slots, the M-delayed input in the odd slots.
    """
    stage_taps = _stage_taps(states, taps, False)
    _check_args(xs, block, sub, precision, 1)
    if xs.device.type == "cpu":
        return hbf_int_cascade_mxu_plain(states, xs, taps=taps)
    depth = len(stage_taps)
    t = xs.shape[0]
    rows = [(2 * len(tv) - 1,) for tv in stage_taps]
    packed, y = _launch("hbf_int_mxu", [(s.x,) for s in states], rows, xs,
                        stage_taps, t << depth, min(block, t), sub)
    hbf_int_cascade_mxu.launches += 1
    return tuple(HbfIntState(x=x) for (x,) in _split(packed, rows)), y


hbf_int_cascade_mxu.launches = 0  # kernel launches since the last reset
