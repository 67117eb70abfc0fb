"""K7 and K8: the half-band rate-change cascades in one kernel each (port
of `idsp_tpu.filters.hbf_pallas.hbf_dec_cascade_bank` and
`hbf_int_cascade_bank`).

Both run ``csrc/hbf_cascade.cu`` for CUDA tensors and their plain
PyTorch versions (``*_plain``) for CPU tensors; any other device raises.
They take and return the time-major (``axis=0``) states of `hbf`, so
they drop in for `hbf.hbf_dec_cascade` / `hbf.hbf_int_cascade`:

* K7: `HbfDecState`s, highest-rate stage first; stage i uses
  ``taps[depth-1-i]``.
* K8: `HbfIntState`s, lowest-rate stage first; stage i uses ``taps[i]``.

The kernels' f32 operations are the plain versions' in the same order,
one rounding each, so on the card they agree bit for bit.  The kernels
cut the block of time into ranges, one CUDA block per lane tile and
range, each range warmed up on its halo recomputed from the input
(`dec_range_plan`, `int_range_plan`).  No value depends on the time
chunk or on the number of ranges: every output is the same sum in the
same order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _ext
from .hbf import (
    HBF_TAPS,
    HbfDecState,
    HbfIntState,
    hbf_dec_cascade,
    hbf_int_cascade,
)

MAX_DEPTH, MAX_TAPS = 4, 32
LANES = 32  # lanes of a tile (kLanes of csrc/hbf_tile.cuh)
BLOCKS_PER_SM = 4  # CUDA blocks an SM at the default number of ranges


def pick_chunk(t: int, want: int, mult: int) -> int:
    """The kernels' time chunk: ``want`` lowered to at most ``t`` and to
    a multiple of ``mult`` (a chunk need not divide ``t``)."""
    if t <= 0 or t % mult:
        raise ValueError(f"block length {t} must be a positive multiple "
                         f"of {mult}")
    tc = min(want, t) // mult * mult
    if tc < mult:
        raise ValueError(f"time_chunk {want} is below {mult}")
    return tc


class RangePlan(NamedTuple):
    """How K7/K8 cut a block of time into ranges.

    Range k owns rows ``[k*seg, min((k+1)*seg, rows))`` of the last
    stage's output (K7) or of the input (K8); ``scale`` input rows make
    one such row.  Its CUDA block starts ``halo`` input rows before the
    range (not before row 0: there the carried tails come in), and stage
    d computes its output rows (K7) or row pairs (K8) from
    ``stage_halo[d]`` before the range's first on, the least that the
    range's outputs need.
    """

    rows: int
    seg: int
    ranges: int
    halo: int
    stage_halo: tuple[int, ...]
    scale: int

    def span(self, k: int) -> tuple[int, int, int]:
        """Range k's input rows: (walk start, start, stop)."""
        start = k * self.seg * self.scale
        stop = min((k + 1) * self.seg, self.rows) * self.scale
        return max(0, start - self.halo), start, stop


def _plan(rows, ranges, halo, stage_halo, scale):
    if ranges < 1:
        raise ValueError(f"ranges must be >= 1, got {ranges}")
    seg = -(-rows // ranges)
    return RangePlan(rows, seg, -(-rows // seg), halo, tuple(stage_halo),
                     scale)


def dec_range_plan(ms, t: int, ranges: int) -> RangePlan:
    """K7's plan for stage tap counts ``ms`` (stage order, highest rate
    first) over t full-rate rows in at most ``ranges`` ranges of output
    rows.  Output j of a stage reads its input rows 2j-4m+3 .. 2j+1, so
    stage d starts h[d] = 2*h[d+1] + 4m[d+1]-3 output rows early
    (h[depth-1] = 0); the input halo, 2*h[0] + 4m[0]-3 rows, is rounded
    up to whole last-stage rows (907 to 912 for `HBF_TAPS` at depth 4)."""
    depth = len(ms)
    r = 1 << depth
    if t <= 0 or t % r:
        raise ValueError(f"block length {t} must be a positive multiple "
                         f"of {r}")
    h = [0] * depth
    for d in range(depth - 2, -1, -1):
        h[d] = 2 * h[d + 1] + 4 * ms[d + 1] - 3
    halo = -(-(2 * h[0] + 4 * ms[0] - 3) // r) * r
    return _plan(t >> depth, ranges, halo, h, r)


def int_range_plan(ms, t: int, ranges: int) -> RangePlan:
    """K8's plan for stage tap counts ``ms`` (stage order, lowest rate
    first) over t input rows in at most ``ranges`` ranges.  Output pair j
    of a stage is the FIR of its input rows j-2m+1 .. j in row 2j and the
    input row j-m+1 in row 2j+1, so a stage whose first needed output
    row is odd needs no FIR of that row's pair.  With g[d] the input rows
    stage d needs before the range (g[depth-1] = 2m-1, g[d] =
    floor(g[d+1] / 2) + 2m[d]-1), the input halo is g[0] (57 for
    `HBF_TAPS` at depth 4) and stage d starts ceil(g[d+1] / 2) pairs
    early, at the pair of its first needed row."""
    depth = len(ms)
    if t <= 0:
        raise ValueError(f"block length {t} must be positive")
    g = [0] * depth
    g[-1] = 2 * ms[-1] - 1
    for d in range(depth - 2, -1, -1):
        g[d] = g[d + 1] // 2 + 2 * ms[d] - 1
    h = [-(-g[d + 1] // 2) for d in range(depth - 1)] + [0]
    return _plan(t, ranges, g[0], h, 1)


def default_ranges(rows: int, c: int, device: torch.device) -> int:
    """Ranges enough for BLOCKS_PER_SM blocks on every SM of the card
    with ceil(c / LANES) lane tiles, at most one a row (`chip_smoke.py`
    phase 6 times 1, 2, 4 and 8 an SM)."""
    if device.type != "cuda":
        raise ValueError(f"xs must be on a CUDA device, got {device}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-c // LANES)
    return max(1, min(rows, -(-BLOCKS_PER_SM * sms // tiles)))


def _chunked(fn, states, xs, time_chunk):
    """``fn(states, xs)`` over consecutive chunks of ``time_chunk`` rows
    (the whole block if None), outputs concatenated."""
    if xs.dtype != torch.float32 or xs.dim() != 2:
        raise ValueError(f"xs must be (t, c) float32, got {xs.dtype} "
                         f"{tuple(xs.shape)}")
    if time_chunk is None:
        return fn(states, xs)
    if time_chunk <= 0 or xs.shape[0] % time_chunk:
        raise ValueError(f"time_chunk {time_chunk} must divide "
                         f"t={xs.shape[0]}")
    ys = []
    for x in xs.split(time_chunk, dim=0):
        states, y = fn(states, x)
        ys.append(y)
    return states, torch.cat(ys, dim=0)


def _launch(name, tails, packed_rows, xs, stage_taps, y_rows, *sizes,
            extra=()):
    """Validate and launch ``idsp_<name>`` (K7, K8, and K22, K23 of
    `hbf_mxu`), which takes ``xs, tails_in, tails_out, y, t, c, *sizes,
    depth, ms, taps, *extra, stream``, ``extra`` host int arrays; returns
    the packed new tails and y.  A tile whose buffers exceed a block's
    shared memory is refused by the launch (RuntimeError)."""
    depth = len(stage_taps)
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be 1..{MAX_DEPTH}, got {depth}")
    ms = [len(tv) for tv in stage_taps]
    if max(ms) > MAX_TAPS:
        raise ValueError(f"at most {MAX_TAPS} one-sided taps per stage")
    t, c = xs.shape
    dev = xs.device
    _ext.require("xs", xs, dev, torch.float32, (t, c))
    for d, (tail, rows) in enumerate(zip(tails, packed_rows)):
        for part, want in zip(tail, rows):
            _ext.require(f"states[{d}]", part, dev, torch.float32, (want, c))
    tails_in = torch.cat([p for tail in tails for p in tail], dim=0)
    tails_out = torch.empty_like(tails_in)
    y = torch.empty((y_rows, c), dtype=torch.float32, device=dev)
    ms_c = (ctypes.c_int * depth)(*ms)
    flat = np.concatenate(stage_taps).astype(np.float32)
    taps_c = (ctypes.c_float * len(flat))(*flat.tolist())
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = getattr(lib, f"idsp_{name}")(
            xs.data_ptr(), tails_in.data_ptr(), tails_out.data_ptr(),
            y.data_ptr(), t, c, *sizes, depth, ms_c, taps_c,
            *[(ctypes.c_int * len(v))(*v) for v in extra],
            _ext.stream_ptr(dev))
    _ext.check(err, name)
    return tails_out, y


def _split(packed, rows):
    """Packed (sum rows, c) tails -> per-stage row groups."""
    out, r0 = [], 0
    for stage in rows:
        parts = []
        for n in stage:
            parts.append(packed[r0:r0 + n])
            r0 += n
        out.append(parts)
    return out


def _dec_taps(states, taps):
    depth = len(states)
    return tuple(np.asarray(taps[depth - 1 - i], np.float32)
                 for i in range(depth))


def hbf_dec_cascade_bank_plain(states, xs, *, taps=None, time_chunk=None):
    """Plain PyTorch version of `hbf_dec_cascade_bank`:
    `hbf.hbf_dec_cascade(states, xs, taps, axis=0)`, chunk by chunk if
    ``time_chunk`` is given (the same words either way)."""
    taps = HBF_TAPS if taps is None else taps
    return _chunked(lambda s, x: hbf_dec_cascade(s, x, taps, axis=0),
                    tuple(states), xs, time_chunk)


def hbf_dec_cascade_bank(states, xs, *, taps=None, time_chunk: int = 256,
                         ranges: int | None = None):
    """Decimate-by-2**depth half-band cascade in one kernel,
    depth = len(states).

    Args:
      states: `HbfDecState`s in the axis=0 layout, highest-rate stage
        first (`hbf.hbf_dec_cascade_init(depth, (c,), axis=0, ...)`).
      xs: (t, c) f32 full-rate block, t % 2**depth == 0.
      taps: the full tap table (default `HBF_TAPS`); stage i uses
        ``taps[depth-1-i]``.
      time_chunk: the full-rate rows a CUDA block takes at a time,
        lowered to a multiple of 2**depth and to t; sizes shared memory
        only (256: 114 KB at depth 4 with HBF_TAPS, two blocks an SM).
      ranges: the most time ranges to cut t into (`dec_range_plan`);
        default `default_ranges`.  Changes no value.

    Returns (new_states, y) with y (t // 2**depth, c) f32.
    """
    if xs.device.type == "cpu":
        return hbf_dec_cascade_bank_plain(states, xs, taps=taps)
    stage_taps = _dec_taps(states, HBF_TAPS if taps is None else taps)
    depth = len(stage_taps)
    t, c = xs.shape
    tc = pick_chunk(t, time_chunk, 1 << depth)
    ms = [len(tv) for tv in stage_taps]
    plan = dec_range_plan(ms, t, default_ranges(t >> depth, c, xs.device)
                          if ranges is None else ranges)
    rows = [(2 * m - 1, m - 1) for m in ms]
    packed, y = _launch("hbf_dec_cascade", [(s.odd, s.even) for s in states],
                        rows, xs, stage_taps, t >> depth, tc, plan.seg,
                        plan.halo, extra=(plan.stage_halo,))
    hbf_dec_cascade_bank.launches += 1
    new = tuple(HbfDecState(odd=o, even=e) for o, e in _split(packed, rows))
    return new, y


hbf_dec_cascade_bank.launches = 0  # kernel launches since the last reset


def hbf_int_cascade_bank_plain(states, xs, *, taps=None, time_chunk=None):
    """Plain PyTorch version of `hbf_int_cascade_bank`:
    `hbf.hbf_int_cascade(states, xs, taps, axis=0)`, chunk by chunk if
    ``time_chunk`` is given (the same words either way)."""
    taps = HBF_TAPS if taps is None else taps
    return _chunked(lambda s, x: hbf_int_cascade(s, x, taps, axis=0),
                    tuple(states), xs, time_chunk)


def hbf_int_cascade_bank(states, xs, *, taps=None, time_chunk: int = 32,
                         ranges: int | None = None):
    """Interpolate-by-2**depth half-band cascade in one kernel,
    depth = len(states).

    Args:
      states: `HbfIntState`s in the axis=0 layout, lowest-rate stage
        first (`hbf.hbf_int_cascade_init(depth, (c,), axis=0, ...)`).
      xs: (t, c) f32 low-rate block.
      taps: the full tap table (default `HBF_TAPS`); stage i uses
        ``taps[i]``.
      time_chunk: the low-rate rows a CUDA block takes at a time, lowered
        to t; sizes shared memory only, which doubles per stage (32: 76 KB
        at depth 4 with HBF_TAPS, three blocks an SM).
      ranges: the most time ranges to cut t into (`int_range_plan`);
        default `default_ranges`.  Changes no value.

    Returns (new_states, y) with y (t * 2**depth, c) f32: per stage the
    FIR output in the even slots, the M-delayed input in the odd slots.
    """
    if xs.device.type == "cpu":
        return hbf_int_cascade_bank_plain(states, xs, taps=taps)
    taps = HBF_TAPS if taps is None else taps
    depth = len(states)
    stage_taps = tuple(np.asarray(taps[i], np.float32) for i in range(depth))
    t, c = xs.shape
    tc = pick_chunk(t, time_chunk, 1)
    ms = [len(tv) for tv in stage_taps]
    plan = int_range_plan(ms, t, default_ranges(t, c, xs.device)
                          if ranges is None else ranges)
    rows = [(2 * m - 1,) for m in ms]
    packed, y = _launch("hbf_int_cascade", [(s.x,) for s in states], rows,
                        xs, stage_taps, t << depth, tc, plan.seg, plan.halo,
                        extra=(plan.stage_halo,))
    hbf_int_cascade_bank.launches += 1
    new = tuple(HbfIntState(x=x) for (x,) in _split(packed, rows))
    return new, y


hbf_int_cascade_bank.launches = 0  # kernel launches since the last reset
