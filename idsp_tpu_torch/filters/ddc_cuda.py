"""K2 and K3: the fused DDC cascade (port of the fused-cascade family of
`idsp_tpu.filters.ddc_pallas`).

* `df1_hbf_cascade_bank` (K2): Q<f> DF1 bank + 2**depth half-band
  decimation in one kernel.
* `fastlo_ddc_cascade_bank` (K3): K2 with the coarse/fine fast-LO
  conjugate mix computed in the kernel: the whole headline chain, which
  reads only ``x (t,)`` and small LO tables.

Both run ``csrc/ddc_cascade.cu`` for CUDA tensors and their plain
PyTorch versions (``*_plain``) for CPU tensors; any other device
raises.  Carried state follows the JAX package: `Df1State` (2c, 2) and
one (3m-2, 2c) f32 tail per stage (`hbf1_tail_init`), ``2m-1`` odd
rows then ``m-1`` even rows, stages highest rate first.

The plain versions are the unfused composition: DF1 scan, f32 cast,
`hbf.hbf_dec_block` per stage with each tail unpacked into its
`HbfDecState`.  Time chunking does not change any value of K2, so its
plain version runs the whole block at once; K3's fine table has length
``time_chunk``, so its plain version builds the same tables.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _ext
from ..ops import accu
from ..ops.fastlo import fastlo_mix_tables, fastlo_tables
from .biquad import Df1State, _ba_list, df1_process_q
from .hbf import HBF_TAPS, HbfDecState, hbf_dec_block


def hbf1_tail_init(c2: int, m: int = 5, *, device):
    """Zero tail for a fused cascade stage: (2m-1) odd-sample FIR rows +
    (m-1) even-sample delay rows, packed (3m-2, c2) f32."""
    return torch.zeros((3 * m - 2, c2), dtype=torch.float32, device=device)


def _default_taps(taps):
    """Stages as f32 arrays; by default the decimate-by-8 cascade,
    highest rate first: HBF_TAPS[2], [1], [0].  depth = len(taps)."""
    if taps is None:
        taps = (HBF_TAPS[2], HBF_TAPS[1], HBF_TAPS[0])
    return tuple(np.asarray(tv, dtype=np.float32) for tv in taps)


def df1_hbf_cascade_bank_plain(ba, state: Df1State, tails, xs, f: int = 29,
                               *, taps=None):
    """Plain PyTorch version of `df1_hbf_cascade_bank`."""
    taps = _default_taps(taps)
    state, ys = df1_process_q(ba, f, state, xs)
    y = ys.to(torch.float32)
    new_tails = []
    for tv, tail in zip(taps, tails):
        ln = 2 * len(tv) - 1
        st, y = hbf_dec_block(
            tv, HbfDecState(odd=tail[:ln], even=tail[ln:]), y, axis=0
        )
        new_tails.append(torch.cat([st.odd, st.even], dim=0))
    return state, tuple(new_tails), y


def _launch_cascade(ba, state, tails, taps, f, t, c2, tc, dev, *, xs=None,
                    x=None, tables=(None,) * 4):
    """Validate and launch ``idsp_ddc_cascade`` (K2 if xs, K3 if x)."""
    depth = len(taps)
    if not 1 <= depth <= 4:
        raise ValueError(f"depth must be 1..4, got {depth}")
    if len(tails) != depth:
        raise ValueError(f"need {depth} tails, got {len(tails)}")
    if not 0 < f < 64:
        raise ValueError(f"f must be in (0, 64), got {f}")
    if tc <= 0 or t % tc or tc % (1 << depth):
        raise ValueError(f"need t % time_chunk == 0 and time_chunk % "
                         f"{1 << depth} == 0, got t={t}, time_chunk={tc}")
    ms = [len(tv) for tv in taps]
    if max(ms) > 32:
        raise ValueError("at most 32 one-sided taps per stage")
    for d, (tail, m) in enumerate(zip(tails, ms)):
        _ext.require(f"tails[{d}]", tail, dev, torch.float32, (3 * m - 2, c2))
    _ext.require("state.x", state.x, dev, torch.int32, (c2, 2))
    _ext.require("state.y", state.y, dev, torch.int32, (c2, 2))
    tails_in = torch.cat(list(tails), dim=0)
    tails_out = torch.empty_like(tails_in)
    new_x = torch.empty_like(state.x)
    new_y = torch.empty_like(state.y)
    y = torch.empty((t >> depth, c2), dtype=torch.float32, device=dev)
    ms_c = (ctypes.c_int * depth)(*ms)
    taps_flat = np.concatenate(taps).astype(np.float32)
    taps_c = (ctypes.c_float * len(taps_flat))(*taps_flat.tolist())
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_ddc_cascade(
            None if xs is None else xs.data_ptr(),
            None if x is None else x.data_ptr(),
            *[None if tb is None else tb.data_ptr() for tb in tables],
            state.x.data_ptr(), state.y.data_ptr(), new_x.data_ptr(),
            new_y.data_ptr(), tails_in.data_ptr(), tails_out.data_ptr(),
            y.data_ptr(), t, c2, tc, f, *_ba_list(ba), depth, ms_c, taps_c,
            _ext.stream_ptr(dev),
        )
    _ext.check(err, "ddc_cascade")
    rows = np.cumsum([0] + [3 * m - 2 for m in ms])
    new_tails = tuple(tails_out[a:b] for a, b in zip(rows[:-1], rows[1:]))
    return Df1State(x=new_x, y=new_y), new_tails, y


def df1_hbf_cascade_bank(ba, state: Df1State, tails, xs, f: int = 29, *,
                         taps=None, time_chunk: int = 128):
    """Fused Q<f> DF1 biquad bank + 2**depth half-band decimation,
    depth = len(taps).

    Args:
      ba: (5,) i32 Q<f> coefficients.
      state: Df1State with x/y (c2, 2) int32.
      tails: per-stage (3*m_d-2, c2) f32 tails (`hbf1_tail_init`).
      xs: (t, c2) int32.
      taps: per-stage one-sided taps, highest rate first (default
        HBF_TAPS[2], [1], [0]).
      time_chunk: rows per chunk of the kernel (t % time_chunk == 0,
        time_chunk % 2**depth == 0); sets its shared-memory size only.

    Returns (state, tails, y) with y (t / 2**depth, c2) f32.
    """
    if xs.device.type == "cpu":
        return df1_hbf_cascade_bank_plain(ba, state, tails, xs, f, taps=taps)
    taps = _default_taps(taps)
    t, c2 = xs.shape
    _ext.require("xs", xs, xs.device, torch.int32, (t, c2))
    out = _launch_cascade(ba, state, tails, taps, f, t, c2, time_chunk,
                          xs.device, xs=xs)
    df1_hbf_cascade_bank.launches += 1
    return out


df1_hbf_cascade_bank.launches = 0  # kernel launches since the last reset


def fastlo_ddc_cascade_bank_plain(ba, state: Df1State, tails, phase0, steps,
                                  x, f: int = 29, *, taps=None,
                                  time_chunk: int = 128):
    """Plain PyTorch version of `fastlo_ddc_cascade_bank`: the fast-LO
    mix from factor tables with fine length ``time_chunk``, then the
    plain cascade."""
    t = x.shape[0]
    tables = fastlo_tables(phase0, steps, t, time_chunk)
    miq = fastlo_mix_tables(x, tables)
    state, tails, y = df1_hbf_cascade_bank_plain(
        ba, state, tails, miq, f, taps=taps
    )
    return state, tails, accu.advance(phase0, steps, t), y


def fastlo_ddc_cascade_bank(ba, state: Df1State, tails, phase0, steps, x,
                            f: int = 29, *, taps=None,
                            time_chunk: int = 128):
    """The whole headline DDC chain in one kernel: fast-LO conjugate mix
    + DF1 bank + half-band decimation cascade.

    Args:
      phase0: (c,) i32 NCO phase before the first sample.
      steps: (c,) i32 per-channel frequency words.
      x: (t,) i32 wideband input; lanes are I|Q (c2 = 2c).
      time_chunk: the kernel's chunk AND the fine-table length of the
        mix, so it changes the mix's rounding: pass the value the
        compared run used (the JAX package's default is 128).

    Returns (state, tails, new_phase0, y) with y (t/2**depth, 2c) f32 and
    ``new_phase0 = phase0 + steps*t`` (wrapping).
    """
    if x.device.type == "cpu":
        return fastlo_ddc_cascade_bank_plain(
            ba, state, tails, phase0, steps, x, f, taps=taps,
            time_chunk=time_chunk,
        )
    taps = _default_taps(taps)
    t = x.shape[0]
    c = phase0.shape[0]
    dev = x.device
    _ext.require("x", x, dev, torch.int32, (t,))
    _ext.require("phase0", phase0, dev, torch.int32, (c,))
    _ext.require("steps", steps, dev, torch.int32, (c,))
    tables = fastlo_tables(phase0, steps, t, time_chunk)
    new_state, new_tails, y = _launch_cascade(
        ba, state, tails, taps, f, t, 2 * c, time_chunk, dev, x=x,
        tables=tables,
    )
    fastlo_ddc_cascade_bank.launches += 1
    return new_state, new_tails, accu.advance(phase0, steps, t), y


fastlo_ddc_cascade_bank.launches = 0  # kernel launches since the last reset
