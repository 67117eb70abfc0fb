"""K22 and K23: the half-band rate-change cascades in their banded-matrix
form (port of the MXU half of `idsp_tpu.filters.hbf_pallas`:
`hbf_dec_cascade_mxu` and `hbf_int_cascade_mxu`).

On the TPU each stage was one product of a fixed banded Toeplitz
operator (`_hbf_dec_band_matrix`, `_hbf_int_band_matrix`) with a window
of ``[carry | block]`` rows, the carry being the stage's last ``kp``
input rows (hbf_pallas.py:567 and :749, the pallas_calls).  The port
keeps the operator, the carry layout and the precisions; each output row
is its band row's nonzero entries times their window rows.  On the card
(``csrc/hbf_mxu.cu``, whose note says what bounds each kernel and what
the design does about it) "split3" and "default" run the band product on
the tensor cores, a 16-row tile of a stage against one Toeplitz A tile,
over K7's walk of lane tiles x time ranges (`mma_chunk`, `mma_seg`),
and "highest" sums in f32 on the CUDA cores.  All are bound by device
memory at the roofline (xs read and y written once).

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
(``*_plain``) for CPU tensors, and raise for any other device.

``precision`` keeps the TPU's meaning (hbf_pallas.py:426-434):

* ``"split3"`` (the default): both operands split into bf16 parts, hi =
  bf16(v) and lo = bf16(v - hi) (round to nearest even), and three
  products Wh.Xh + Wh.Xl + Wl.Xh with f32 sums, about 4e-6 relative.  On
  the card: bf16 ``mma.sync`` on the tensor cores, three passes.
* ``"default"``: one bf16 pass Wh.Xh, about 4.5e-3 relative.  On the
  card: the same kernel, one pass.
* ``"highest"``: the band's f32 sum, about 2e-7 relative (Mosaic's own
  f32 decomposition on the TPU).  On the card: each multiply and add one
  rounding in ascending band column order on the CUDA cores, on K7's
  and K8's walks of lane tiles x time ranges (``csrc/hbf_cascade.cu``
  `hbf_dec_band_kernel`, `hbf_int_band_kernel`).

The plain versions compute the same products (a bf16 product is exact in
f32) and sum each pass in ascending band column order, the passes added
as ``(hh + hl) + lh``; K23's odd rows, the M-delayed center copies whose
band weight is 1, are ``xh + xl`` ("split3") or ``xh`` ("default"),
exact.  For "highest" the kernel and its plain version agree bit for
bit.  The tensor cores sum a k-step's products in their own order, so
for "split3" and "default" they agree within a tolerance that grows with
the depth: a last-bit difference in a stage's output can flip the bf16
rounding of the next stage's input.  The stage-0 state is copies of the
input in every precision.  Against K7/K8 and `hbf.hbf_*_cascade` (the
shift form, another summation order) every precision is held within a
tolerance, never bit for bit.

``block`` and ``sub`` size the kernels' tiles only; no value depends on
them, nor on the number of time ranges the kernels cut a call into (the
MMA kernels about MMA_BLOCKS_PER_SM blocks an SM, "highest" K7's and K8's
`default_ranges`; the private `_dec` / `_int` take the count, for the
tests).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _ext
from .hbf import HBF_TAPS, HbfDecState, HbfIntState
from .hbf_cuda import (
    LANES,
    MAX_DEPTH,
    _launch,
    _split,
    dec_range_plan,
    default_ranges,
    int_range_plan,
    pick_chunk,
)

PRECISIONS = ("split3", "default", "highest")
PASSES = {"split3": 3, "default": 1}  # bf16 products a band entry
# The kernels against their plain versions at depth 2-4, of the scale max
# |y| ("highest": bit for bit).  The tensor cores sum a k-step's products
# in their own order; a last-bit difference in a stage output can move
# the next stage's bf16 lo part by one of its ulps, about 2^-16 of the
# value ("split3"), or its hi part by one, up to 2^-7 ("default"); two such
# moves under the band's largest weights stay within 2^-15 / 2^-6.  At
# depth 1 only the sums' order differs: 1e-6.
KERNEL_TOL = {"highest": 0.0, "split3": 2.0 ** -15, "default": 2.0 ** -6}
# blocks an SM the MMA kernels' default range count fills at most (two fit
# at K22's default chunk; more ranges recompute more halo)
MMA_BLOCKS_PER_SM = 2
# K23 "highest"'s default chunk, K8's (`hbf_int_cascade_bank`'s
# time_chunk): 76 KB at depth 4 with HBF_TAPS, three blocks an SM (at 64
# rows one fits: 0.1892 ms of device time a launch at c = 1024 on the
# H100 against 0.1260 at 32, `probe_cascade --only cascade`, PERF.md §6)
INT_BAND_CHUNK = 32


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


def bf16_split(v):
    """(hi, lo) of an f32 tensor, each a bf16 value held in f32: hi =
    bf16(v), lo = bf16(v - hi), both rounded to nearest even (the TPU's
    split, `__float2bfloat16_rn` on the card)."""
    hi = v.to(torch.bfloat16).to(torch.float32)
    return hi, (v - hi).to(torch.bfloat16).to(torch.float32)


def _band(ext, cols, weights, n: int, step: int, precision: str):
    """A stage's band rows at ``precision``: the f32 sum ("highest"), or
    the bf16 passes, each summed ascending, added (hh + hl) + lh."""
    if precision == "highest":
        return _sum_band(ext, cols, weights, n, step)
    wh, wl = (p.numpy() for p in bf16_split(torch.from_numpy(
        np.asarray(weights, np.float32))))
    xh, xl = bf16_split(ext)
    hh = _sum_band(xh, cols, wh, n, step)
    if precision == "default":
        return hh
    return (hh + _sum_band(xl, cols, wh, n, step)) + _sum_band(
        xh, cols, wl, n, step)


def _center(rows, precision: str):
    """K23's odd rows, band weight 1: the rows as the passes see them."""
    if precision == "highest":
        return rows
    hi, lo = bf16_split(rows)
    return hi if precision == "default" else hi + lo


def _check_args(xs, block: int, sub: int, precision: str, mult: int):
    if xs.dtype != torch.float32 or xs.dim() != 2:
        raise ValueError(f"xs must be (t, c) float32, got {xs.dtype} "
                         f"{tuple(xs.shape)}")
    t = xs.shape[0]
    if t <= 0 or t % mult:
        raise ValueError(f"block length {t} must be a positive multiple of "
                         f"{mult}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
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


def hbf_dec_cascade_mxu_plain(states, xs, *, taps=None,
                              precision: str = "split3"):
    """Plain PyTorch version of K22 `hbf_dec_cascade_mxu`: per stage the
    carry window (`_carry_from_state`) before the stage's input, then per
    pass one shifted stride-2 slice times its weight per band column,
    summed in ascending column order (`_band`); the new carry is the last
    ``kp`` rows."""
    stage_taps = _stage_taps(states, taps, True)
    c = xs.shape[1]
    new, cur = [], xs
    for st, tv in zip(states, stage_taps):
        m, kp = len(tv), dec_kp(len(tv))
        ext = torch.cat([_carry_from_state(st, m, kp, c), cur], dim=0)
        cols, weights = dec_band_row(tv, kp)
        cur = _band(ext, cols, weights, cur.shape[0] // 2, 2, precision)
        new.append(_state_from_carry(ext[ext.shape[0] - kp:], m, kp))
    return tuple(new), cur


def hbf_int_cascade_mxu_plain(states, xs, *, taps=None,
                              precision: str = "split3"):
    """Plain PyTorch version of K23 `hbf_int_cascade_mxu`: per stage the
    right-aligned carry before the input, the even rows the band's FIR
    row per pass (`_band`, ascending columns), the odd rows the center
    column as the passes see it (`_center`); the new carry is the last
    ``kp`` rows."""
    stage_taps = _stage_taps(states, taps, False)
    c = xs.shape[1]
    new, cur = [], xs
    for st, tv in zip(states, stage_taps):
        m, kp = len(tv), int_kp(len(tv))
        ext = torch.cat([_int_carry_from_state(st, kp, c), cur], dim=0)
        cols, weights, center = int_band_row(tv, kp)
        n = cur.shape[0]
        fir = _band(ext, cols, weights, n, 1, precision)
        cur = torch.stack([fir, _center(ext[center:center + n], precision)],
                          dim=1).flatten(0, 1)
        new.append(_int_state_from_carry(ext[ext.shape[0] - kp:], m, kp))
    return tuple(new), cur


def mma_chunk(block: int, t: int, q: int) -> int:
    """The MMA kernels' chunk: ``block`` lowered to a multiple of q (16
    output rows of every stage: 16 << depth full-rate rows for K22, 16
    low-rate rows for K23), at least q and at most t rounded up to q."""
    return max(q, min(block, -(-t // q) * q) // q * q)


def mma_seg(rows: int, ranges: int) -> int:
    """Rows a range owns (last-stage output rows for K22, input rows for
    K23) for at most ``ranges`` ranges: a multiple of 16, so that every
    stage's tiles start at multiples of 16 rows of the call."""
    if ranges < 1:
        raise ValueError(f"ranges must be >= 1, got {ranges}")
    return -(-(-(-rows // ranges)) // 16) * 16


@functools.lru_cache(maxsize=None)
def _fit(dec: bool, ms: tuple, tc: int, passes: int, device: torch.device):
    """Blocks of the MMA kernel that fit an SM of ``device`` (the CUDA
    occupancy calculator; it depends only on these arguments)."""
    with torch.cuda.device(device):
        fit = _ext.library().idsp_hbf_mma_occupancy(
            int(dec), len(ms), (ctypes.c_int * len(ms))(*ms), tc, passes)
    if fit < 0:
        _ext.check(-fit, "hbf_mma_occupancy")
    return fit


def mma_ranges(dec: bool, stage_taps, tc: int, passes: int, rows: int,
               c: int, device: torch.device) -> int:
    """The MMA kernels' default range count: at most MMA_BLOCKS_PER_SM
    blocks, and no more than fit (the kernel's occupancy at chunk tc), on
    every SM with ceil(c / LANES) lane tiles, so that the blocks run in
    one wave (a second, nearly empty one costs as much as the first); at
    least one, at most one a row."""
    if device.type != "cuda":
        raise ValueError(f"xs must be on a CUDA device, got {device}")
    fit = _fit(dec, tuple(len(tv) for tv in stage_taps), tc, passes, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = max(1, min(MMA_BLOCKS_PER_SM, fit))
    return max(1, min(rows, per_sm * sms // -(-c // LANES)))


def _count(fn, precision: str) -> None:
    """One launch of ``fn``'s kernel at ``precision``: ``launches`` counts
    "split3" (the round trip's), ``default_launches`` and
    ``highest_launches`` the others."""
    if precision == "split3":
        fn.launches += 1
    else:
        setattr(fn, f"{precision}_launches",
                getattr(fn, f"{precision}_launches") + 1)


def _dec(states, xs, taps, block, sub, precision, ranges):
    stage_taps = _stage_taps(states, taps, True)
    depth = len(stage_taps)
    r = 1 << depth
    _check_args(xs, block, sub, precision, r)
    if xs.device.type == "cpu":
        return hbf_dec_cascade_mxu_plain(states, xs, taps=taps,
                                         precision=precision)
    t, c = xs.shape
    rows = [(2 * len(tv) - 1, len(tv) - 1) for tv in stage_taps]
    tails = [(s.odd, s.even) for s in states]
    if precision == "highest":  # K7's walk, the band order (`_sum_band`)
        ms = [len(tv) for tv in stage_taps]
        plan = dec_range_plan(ms, t, default_ranges(t >> depth, c, xs.device)
                              if ranges is None else ranges)
        packed, y = _launch("hbf_dec_band", tails, rows, xs, stage_taps,
                            t >> depth, pick_chunk(t, block, r), plan.seg,
                            plan.halo, extra=(plan.stage_halo,))
    else:
        n_out, tc = t >> depth, mma_chunk(block, t, 16 << depth)
        seg = mma_seg(n_out, mma_ranges(True, stage_taps, tc,
                                        PASSES[precision], n_out, c,
                                        xs.device)
                      if ranges is None else ranges)
        packed, y = _launch("hbf_dec_mma", tails, rows, xs, stage_taps,
                            n_out, tc, sub, seg, PASSES[precision])
    _count(hbf_dec_cascade_mxu, precision)
    return tuple(HbfDecState(odd=o, even=e)
                 for o, e in _split(packed, rows)), y


def _int(states, xs, taps, block, sub, precision, ranges):
    stage_taps = _stage_taps(states, taps, False)
    if block is None:
        block = INT_BAND_CHUNK if precision == "highest" else 64
    _check_args(xs, block, sub, precision, 1)
    if xs.device.type == "cpu":
        return hbf_int_cascade_mxu_plain(states, xs, taps=taps,
                                         precision=precision)
    depth = len(stage_taps)
    t, c = xs.shape
    rows = [(2 * len(tv) - 1,) for tv in stage_taps]
    tails = [(s.x,) for s in states]
    if precision == "highest":  # K8's walk, the band order (`_sum_band`)
        ms = [len(tv) for tv in stage_taps]
        plan = int_range_plan(ms, t, default_ranges(t, c, xs.device)
                              if ranges is None else ranges)
        packed, y = _launch("hbf_int_band", tails, rows, xs, stage_taps,
                            t << depth, pick_chunk(t, block, 1), plan.seg,
                            plan.halo, extra=(plan.stage_halo,))
    else:
        tc = mma_chunk(block, t, 16)
        seg = mma_seg(t, mma_ranges(False, stage_taps, tc, PASSES[precision],
                                    t, c, xs.device)
                      if ranges is None else ranges)
        packed, y = _launch("hbf_int_mma", tails, rows, xs, stage_taps,
                            t << depth, tc, sub, seg, PASSES[precision])
    _count(hbf_int_cascade_mxu, precision)
    return tuple(HbfIntState(x=x) for (x,) in _split(packed, rows)), y


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
      block: the full-rate rows a CUDA block takes at a time: "split3"
        and "default" `mma_chunk` (a multiple of 16 * 2**depth);
        "highest" the chunk of K7's walk (`hbf_cuda.pick_chunk`: lowered
        to a multiple of 2**depth and to t), each range of time walked
        from its exact halo (`dec_range_plan`, `default_ranges`).  Sizes
        shared memory: a launch that would exceed a block's is refused
        (RuntimeError).
      sub: output rows a warp takes at a time ("split3" and "default":
        whole 16-row tiles, at most a warp's share of a stage); "highest"
        deals a stage's rows to the warps in groups of four and takes no
        ``sub``.
      precision: ``"split3"`` (three bf16 passes), ``"default"`` (one) or
        ``"highest"`` (the f32 sum); see the module docstring.

    Returns (new_states, y) with y (t // 2**depth, c) f32.
    """
    return _dec(states, xs, taps, block, sub, precision, None)


hbf_dec_cascade_mxu.launches = 0  # "split3" launches since the last reset
hbf_dec_cascade_mxu.default_launches = 0
hbf_dec_cascade_mxu.highest_launches = 0


def hbf_int_cascade_mxu(states, xs, *, taps=None, block: int | None = None,
                        sub: int = 32, precision: str = "split3"):
    """Interpolate-by-2**depth half-band cascade in its banded-matrix
    form, one kernel, depth = len(states).

    Args:
      states: `HbfIntState`s in the axis=0 layout, lowest-rate stage
        first (`hbf.hbf_int_cascade_init(depth, (c,), axis=0, ...)`).
      xs: (t, c) f32 low-rate block, t >= 1, any c.
      taps: the full tap table (default `HBF_TAPS`); stage i uses
        ``taps[i]``.
      block: the low-rate rows a CUDA block takes at a time: "split3"
        and "default" `mma_chunk` (a multiple of 16; 64 by default);
        "highest" the chunk of K8's walk (`hbf_cuda.pick_chunk`: lowered
        to t; INT_BAND_CHUNK by default), each range of time walked from
        its exact halo (`int_range_plan`, `default_ranges`).  Sizes
        shared memory: a launch that would exceed a block's is refused
        (RuntimeError).
      sub: output row pairs a warp takes at a time ("split3" and
        "default": whole 16-pair tiles, at most a warp's share of a
        stage); "highest" deals a stage's pairs to the warps in groups of
        four and takes no ``sub``.
      precision: as for `hbf_dec_cascade_mxu`.

    Returns (new_states, y) with y (t * 2**depth, c) f32: per stage the
    FIR output in the even slots, the M-delayed input in the odd slots.
    """
    return _int(states, xs, taps, block, sub, precision, None)


hbf_int_cascade_mxu.launches = 0  # "split3" launches since the last reset
hbf_int_cascade_mxu.default_launches = 0
hbf_int_cascade_mxu.highest_launches = 0
