"""K16: the float DDC / lock-in bank (port of
`idsp_tpu.filters.ddc_pallas.ddc_lockin_bank`).

`ddc_lockin_bank` runs the CUDA kernel of ``csrc/ddc_lockin.cu`` (on
``csrc/df1_ring.cuh``'s depth-0 pipeline, its plan `lockin_plan`) for CUDA
tensors and its plain PyTorch version, `ddc_lockin_bank_plain`, for CPU
tensors; any other device raises.  Both mix with the LO factored into
coarse (per chunk of ``time_chunk`` rows) and fine (in chunk) tables
from `lockin_tables`, so they agree bit for bit; the factorisation (and
so the LO's f32 rounding) depends on ``time_chunk``, the kernel's own
chunk (its plan's) on nothing but shared memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _ext
from ..ops.fastlo import factor_pairs
from .biquad import Df1State, df1_process
from .pipe_plan import PipePlan, pipe_plan

# K16's producer warps by default (and a store warp: 16 warps a block;
# with 8 the producers set the pace, PERF.md §6)
LOCKIN_PRODUCERS = 11


def lockin_plan(c: int, *, producers: int = LOCKIN_PRODUCERS,
                **kw) -> PipePlan:
    """K16's plan over ``c`` channels, 2c I|Q lanes (`pipe_plan.pipe_plan`):
    LOCKIN_PRODUCERS producer warps by default, each a span of ceil(chunk
    / producers) rows of every chunk (the LO, the mix and the feed-forward
    sum W); one 32-bit word a row and lane in (W) and out (y), so
    PIPE_CHUNK rows a chunk in 3 slots by default; one CTA a tile."""
    if kw.get("cluster", 1) != 1:
        raise ValueError("K16 runs one CTA a tile")
    if c < 1:
        raise ValueError(f"need c >= 1 channels, got {c}")
    return pipe_plan(2 * c, producers=producers, **kw)


def lockin_tables(lo_freqs, n0, t: int, tc: int, *, device):
    """Factored LO tables (ddc_pallas.py:1424-1438): phases in float64
    modulo tau, ``ka = n0 + k*tc`` per chunk k and ``b`` in the chunk, cast
    to f32, then ``cos``/``sin`` in f32.

    Args:
      lo_freqs: (c,) relative LO frequencies (cycles per sample).
      n0: absolute sample index of the block's first row (LO phase
        continuity across blocks).
      t, tc: rows of the block and of a chunk (t % tc == 0).

    Returns (ca, sa, cb, sb): (t/tc, c) coarse and (tc, c) fine, f32.
    """
    if tc < 1 or t % tc:
        raise ValueError(f"need t % time_chunk == 0, got t={t}, "
                         f"time_chunk={tc}")
    tau = 2.0 * math.pi
    f64 = torch.float64
    if isinstance(lo_freqs, torch.Tensor):
        lo_freqs = lo_freqs.detach().cpu().numpy()
    wt = torch.from_numpy(np.asarray(lo_freqs, np.float64) * tau)
    if torch.device(device).type == "cuda":
        # from pinned memory, a copy that does not wait on the stream (from
        # pageable memory it would wait for the kernel launched before it)
        wt = wt.pin_memory().to(device, non_blocking=True)
    else:
        wt = wt.to(device)
    ka = float(n0) + torch.arange(t // tc, dtype=f64, device=device) * tc
    pa = torch.remainder(ka[:, None] * wt[None], tau).to(torch.float32)
    pb = torch.remainder(torch.arange(tc, dtype=f64, device=device)[:, None]
                         * wt[None], tau).to(torch.float32)
    return torch.cos(pa), torch.sin(pa), torch.cos(pb), torch.sin(pb)


def _ba_f32(ba) -> np.ndarray:
    return np.asarray(ba.cpu() if isinstance(ba, torch.Tensor) else ba,
                      np.float32).reshape(-1)[:5]


def ddc_lockin_bank_plain(ba, state: Df1State, x, lo_freqs, n0=0, *,
                          time_chunk: int = 256):
    """Plain PyTorch version of `ddc_lockin_bank`: the factored LO of every
    row at once, the mix, then the f32 DF1 scan."""
    t = x.shape[0]
    c = len(lo_freqs)
    ca, sa, cb, sb = lockin_tables(lo_freqs, n0, t, time_chunk,
                                   device=x.device)
    ca, sa = ca[:, None], sa[:, None]  # (t/tc, 1, c) against (tc, c)
    lo_re = (ca * cb - sa * sb).reshape(t, c)
    lo_im = (sa * cb + ca * sb).reshape(t, c)
    xb = x.to(torch.float32)[:, None]
    miq = torch.cat([xb * lo_re, -(xb * lo_im)], dim=1)
    return df1_process(_ba_f32(ba), state, miq)


def ddc_lockin_bank(ba, state: Df1State, x, lo_freqs, n0=0, *,
                    time_chunk: int = 256, _plan: PipePlan | None = None):
    """The ddc_lockin example (examples/ddc_lockin.rs:27-42) as one kernel
    over a channel bank: f32 quadrature mix with the factored LO, then the
    shared-coefficient f32 DF1 lowpass on the I|Q lanes.

    Args:
      ba: (5,) f32 coefficients [b0, b1, b2, a1, a2].
      state: Df1State f32 with x/y (2c, 2), I lanes then Q lanes.
      x: (t,) f32 real input, shared by all channels.
      lo_freqs: (c,) relative LO frequencies.
      n0: absolute sample index of x[0] (phase continuity).
      time_chunk: rows per chunk of the LO factorisation (t % time_chunk
        == 0): the fine table's length.

    Returns (state, yiq) with yiq (t, 2c) f32.  The kernel's plan is
    `lockin_plan`'s; no plan changes a value.
    """
    if x.device.type == "cpu":
        return ddc_lockin_bank_plain(ba, state, x, lo_freqs, n0,
                                     time_chunk=time_chunk)
    t = x.shape[0]
    c = len(lo_freqs)
    plan = lockin_plan(c) if _plan is None else _plan
    dev = x.device
    _ext.require("x", x, dev, torch.float32, (t,))
    _ext.require("state.x", state.x, dev, torch.float32, (2 * c, 2))
    _ext.require("state.y", state.y, dev, torch.float32, (2 * c, 2))
    tables = factor_pairs(lockin_tables(lo_freqs, n0, t, time_chunk,
                                        device=dev))
    new_x = torch.empty_like(state.x)
    new_y = torch.empty_like(state.y)
    ys = torch.empty((t, 2 * c), dtype=torch.float32, device=dev)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_ddc_lockin(
            x.data_ptr(), *[tb.data_ptr() for tb in tables],
            state.x.data_ptr(), state.y.data_ptr(), new_x.data_ptr(),
            new_y.data_ptr(), ys.data_ptr(), t, c, time_chunk,
            *[float(v) for v in _ba_f32(ba)], plan.warps, plan.producers,
            plan.chunk, plan.ring, plan.smem, _ext.stream_ptr(dev),
        )
    _ext.check(err, "ddc_lockin_bank")
    ddc_lockin_bank.launches += 1
    return Df1State(x=new_x, y=new_y), ys


ddc_lockin_bank.launches = 0  # kernel launches since the last reset
