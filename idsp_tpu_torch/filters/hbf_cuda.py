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
one rounding each, so on the card they agree bit for bit.  No value
depends on the time chunk: every output is the same sum in the same
order, so the chunk only sizes the kernel's shared memory.
"""

from __future__ import annotations

import ctypes

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


def pick_chunk(t: int, want: int, mult: int) -> int:
    """The largest multiple of ``mult`` that divides ``t`` and is at
    most ``want`` (the kernels walk whole chunks)."""
    if t <= 0 or t % mult:
        raise ValueError(f"block length {t} must be a positive multiple "
                         f"of {mult}")
    for tc in range(min(want, t) // mult * mult, 0, -mult):
        if t % tc == 0:
            return tc
    raise ValueError(f"time_chunk {want} is below {mult}")


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


def _launch(name, tails, packed_rows, xs, stage_taps, y_rows, *sizes):
    """Validate and launch ``idsp_<name>`` (K7, K8, and K22, K23 of
    `hbf_mxu`), which takes ``xs, tails_in, tails_out, y, t, c, *sizes,
    depth, ms, taps, stream``; returns the packed new tails and y.  A
    tile whose buffers exceed a block's shared memory is refused by the
    launch (RuntimeError)."""
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


def hbf_dec_cascade_bank(states, xs, *, taps=None, time_chunk: int = 512):
    """Decimate-by-2**depth half-band cascade in one kernel,
    depth = len(states).

    Args:
      states: `HbfDecState`s in the axis=0 layout, highest-rate stage
        first (`hbf.hbf_dec_cascade_init(depth, (c,), axis=0, ...)`).
      xs: (t, c) f32 full-rate block, t % 2**depth == 0.
      taps: the full tap table (default `HBF_TAPS`); stage i uses
        ``taps[depth-1-i]``.
      time_chunk: the kernel's chunk, lowered to the largest multiple of
        2**depth that divides t; sizes shared memory only.

    Returns (new_states, y) with y (t // 2**depth, c) f32.
    """
    if xs.device.type == "cpu":
        return hbf_dec_cascade_bank_plain(states, xs, taps=taps)
    stage_taps = _dec_taps(states, HBF_TAPS if taps is None else taps)
    depth = len(stage_taps)
    t = xs.shape[0]
    tc = pick_chunk(t, time_chunk, 1 << depth)
    rows = [(2 * len(tv) - 1, len(tv) - 1) for tv in stage_taps]
    packed, y = _launch("hbf_dec_cascade", [(s.odd, s.even) for s in states],
                        rows, xs, stage_taps, t >> depth, tc)
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


def hbf_int_cascade_bank(states, xs, *, taps=None, time_chunk: int = 64):
    """Interpolate-by-2**depth half-band cascade in one kernel,
    depth = len(states).

    Args:
      states: `HbfIntState`s in the axis=0 layout, lowest-rate stage
        first (`hbf.hbf_int_cascade_init(depth, (c,), axis=0, ...)`).
      xs: (t, c) f32 low-rate block.
      taps: the full tap table (default `HBF_TAPS`); stage i uses
        ``taps[i]``.
      time_chunk: the kernel's chunk in low-rate rows, lowered to the
        largest divisor of t; sizes shared memory only, which doubles
        per stage (64 keeps depth 4 with HBF_TAPS at 133 KB per block).

    Returns (new_states, y) with y (t * 2**depth, c) f32: per stage the
    FIR output in the even slots, the M-delayed input in the odd slots.
    """
    if xs.device.type == "cpu":
        return hbf_int_cascade_bank_plain(states, xs, taps=taps)
    taps = HBF_TAPS if taps is None else taps
    depth = len(states)
    stage_taps = tuple(np.asarray(taps[i], np.float32) for i in range(depth))
    t = xs.shape[0]
    tc = pick_chunk(t, time_chunk, 1)
    rows = [(2 * len(tv) - 1,) for tv in stage_taps]
    packed, y = _launch("hbf_int_cascade", [(s.x,) for s in states], rows,
                        xs, stage_taps, t << depth, tc)
    hbf_int_cascade_bank.launches += 1
    new = tuple(HbfIntState(x=x) for (x,) in _split(packed, rows))
    return new, y


hbf_int_cascade_bank.launches = 0  # kernel launches since the last reset
