"""K2, K3, K14 and K19-K21: the fused DDC kernels (port of the
fused-cascade family and `ddc_mix_df1_bank` of
`idsp_tpu.filters.ddc_pallas`).

* `df1_hbf_cascade_bank` (K2): Q<f> DF1 bank + 2**depth half-band
  decimation in one kernel; `df1_hbf1_bank` (K20) and `df1_hbf12_bank`
  (K21) are its depth-1 and depth-2 forms with the JAX package's
  signatures, defaults and return shapes.
* `df1_clamp_hbf_cascade_bank` (K19): K2 with the anti-windup DF1
  (offset and clamp before feedback, `biquad.clamp_step`).
* `fastlo_ddc_cascade_bank` (K3): K2 with the coarse/fine fast-LO
  conjugate mix computed in the kernel: the whole headline chain, which
  reads only ``x (t,)`` and small LO tables; ``clamp=(u, lo, hi)`` runs
  the anti-windup DF1 as K19 does.
* `ddc_mix_df1_bank` (K14): the exact `cossin` conjugate mix
  (`exact_mix`) fused into the DF1 bank, bit-identical to mixing first.

K2, K3 and K19-K21 run ``csrc/ddc_cascade.cu``, K14
``csrc/ddc_mix_df1.cu``, for CUDA tensors, and their plain PyTorch
versions (``*_plain``) for CPU tensors; any other device raises.  One
kernel serves K2, K3 and K19-K21: a CUDA block is a tile of lanes with
one DF1 warp, producer warps that feed it (K2 the xs rows, K3 the mixed
rows) and FIR warps that run the half-band stages, chunks of rows
passing between them through mbarrier rings in shared memory
(`launch_plan`).  K14 (and K15, `fm_cuda`) run the same DF1 warp
(``csrc/df1_ring.cuh``) at depth 0: producer warps mix the rows into its
input ring, a store warp writes its output ring to y (`mix_plan`).
Carried state follows the JAX package: `Df1State` (2c, 2) and one
(3m-2, 2c) f32 tail per stage (`hbf1_tail_init`), ``2m-1`` odd rows
then ``m-1`` even rows, stages highest rate first.

The plain versions are the unfused composition: K2/K3 and K19-K21 the
DF1 scan (clamped for K19 and K3's ``clamp=``), f32 cast,
`hbf.hbf_dec_block` per stage with each tail unpacked into its
`HbfDecState`; K14 `exact_mix`, the DF1 scan and the cast.  Time
chunking does not change any value of K2, so its plain version runs the
whole block at once; K3's fine table has length ``time_chunk``, so its
plain version builds the same tables.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _ext, fxp
from ..ops import accu
from ..ops.fastlo import factor_pairs, fastlo_mix_tables, fastlo_tables
from ..ops.trig import cossin
from .biquad import Df1State, _ba_list, clamp_params, df1_process_q
from .biquad_cuda import df1_bank_q_plain
from .hbf import HBF_TAPS, HbfDecState, hbf_dec_block
from .pipe_plan import PipePlan, pipe_plan


LANES = 32  # lanes of a tile (csrc/ddc_cascade.cu kLanes)
MAX_SMEM = 232448  # bytes of shared memory a block may have
MAX_WARPS = 16  # warps of a block
MIN_FIR = 4  # FIR warps of a block, at least
# rows a chunk, slots a ring (the most), warps a block, K3's mix warps (the
# most): the FIR warps wait at a barrier a stage, so the late stages of a
# 128-row chunk leave most of them idle.  On an H100 (700 W) 256-row chunks
# (2 slots for the chain's taps) took K2 from 1.04 to 0.84 ms, 12 warps beat
# 8 and matched 16, and 4 mix warps took K3 from 1.69 to 1.18 ms (PERF.md
# §6; `python3 -m idsp_tpu_torch.probe_cascade`)
CHUNK, RING, WARPS, PRODUCERS = 256, 4, 12, 4


def cascade_smem(ms, chunk: int, ring: int) -> int:
    """Shared memory of a launch (csrc/ddc_cascade.cu `smem_bytes`): 32
    bytes of mbarriers a slot, the input ring (``ring`` slots of ``chunk``
    rows x LANES int32), the FIR buffers (stage 0: its 4m-3 carried rows
    and ``ring`` slots of ``chunk`` rows; stage d >= 1: its 4m-3 carried
    rows and chunk >> d rows), f32 rows of LANES."""
    rows = sum(4 * m - 3 + (ring * chunk if d == 0 else chunk >> d)
               for d, m in enumerate(ms))
    return 32 * ring + (ring * chunk + rows) * LANES * 4


class CascadePlan(NamedTuple):
    """How the kernel runs a launch: a CUDA block is a tile of LANES lanes
    and ``warps`` warps: warp 0
    the DF1, the others of its scheduler (warp % 4 == 0) idle, of the rest
    ``producers`` that feed the DF1 (K2: xs rows by cp.async; K3: the mix)
    and ``fir_warps`` that run the stages; chunks of ``chunk`` rows pass
    through rings of ``ring`` slots, ``smem`` bytes in all."""

    warps: int
    producers: int
    chunk: int
    ring: int
    smem: int
    tiles: int  # CUDA blocks: tiles of LANES over the launch's lanes

    @property
    def fir_warps(self) -> int:
        return self.warps - self.warps // 4 - self.producers


def launch_plan(ms, c2: int, *, fastlo: bool = False,
                time_chunk: int = 128, warps: int | None = None,
                producers: int | None = None,
                chunk: int | None = None,
                ring: int | None = None) -> CascadePlan:
    """The plan of a launch over ``c2`` lanes whose stages have ``ms``
    one-sided taps each (highest rate first; depth = len(ms)); ``fastlo``
    for K3, whose producer count divides ``time_chunk`` (the fine length)
    and the chunk (a rule of this plan; the producers' spans of
    fastlo.cuh `fastlo_mix_rows` do not need it).

    WARPS warps, 1 producer (K3: the most of 4, 2, 1
    up to PRODUCERS that divides time_chunk), a chunk of CHUNK
    rows (at least stage 0's 4m-3 carried rows, a multiple of 2**depth)
    and the most of RING .. 2 slots that fit MAX_SMEM, unless given; a
    chunk too large for 2 slots is halved while it stays above the carried
    rows.  Raises ValueError for a plan the kernel cannot run."""
    ms = [int(m) for m in ms]
    depth = len(ms)
    if c2 < 1 or (fastlo and c2 % 2):
        raise ValueError(f"need c2 >= 1 lanes (even for K3), got {c2}")
    if not 1 <= depth <= 4:
        raise ValueError(f"depth must be 1..4, got {depth}")
    if not all(1 <= m <= 32 for m in ms):
        raise ValueError(f"one-sided taps must be 1..32 a stage, got {ms}")
    wp = WARPS if warps is None else warps
    if producers is not None:
        pr = producers
    else:
        pr = next(p for p in (4, 2, 1)
                  if p <= PRODUCERS and time_chunk % p == 0) if fastlo else 1
    if pr not in (1, 2, 4) or (fastlo and time_chunk % pr) or (
            not fastlo and pr != 1):
        raise ValueError(f"producers must be 1, 2 or 4 and divide "
                         f"time_chunk (K2: 1), got {pr}")
    if wp % 4 or not 8 <= wp <= MAX_WARPS or wp - wp // 4 - pr < MIN_FIR:
        raise ValueError(f"warps must be 8, 12 or 16 and leave {MIN_FIR} "
                         f"FIR warps, got {wp} ({pr} producers)")
    step = max(1 << depth, pr)  # 2**depth and the producers divide chunk
    least = -(-(4 * ms[0] - 3) // step) * step
    ch = max(CHUNK, least) if chunk is None else chunk
    if ch < least or ch % step:
        raise ValueError(f"chunk must be a multiple of {step} of at least "
                         f"{least} rows, got {ch}")

    def fits(c):
        return [r for r in range(RING, 1, -1)
                if cascade_smem(ms, c, r) <= MAX_SMEM]

    if ring is None:
        while not fits(ch) and chunk is None and ch // 2 >= least and \
                (ch // 2) % step == 0:
            ch //= 2
        if not fits(ch):
            raise ValueError(f"no ring of 2+ slots of {ch} rows fits "
                             f"{MAX_SMEM} bytes for taps {ms}")
        rg = fits(ch)[0]
    else:
        rg = ring
    if rg < 2:
        raise ValueError(f"ring must have 2+ slots, got {rg}")
    smem = cascade_smem(ms, ch, rg)
    if smem > MAX_SMEM:
        raise ValueError(f"{smem} bytes of shared memory, more than "
                         f"{MAX_SMEM}")
    return CascadePlan(warps=wp, producers=pr, chunk=ch, ring=rg,
                       smem=smem, tiles=-(-c2 // LANES))


MIX_PRODUCERS = 5  # K14's mix warps (5 + a store warp: 8 warps a block)


def mix_plan(c2: int, *, producers: int = MIX_PRODUCERS, **kw) -> PipePlan:
    """K14's plan over ``c2`` I|Q lanes (`pipe_plan.pipe_plan`;
    MIX_PRODUCERS mix warps by default, one CTA a tile)."""
    plan = pipe_plan(c2, producers=producers, **kw)
    if plan.cluster != 1:
        raise ValueError("K14 runs one CTA a tile")
    return plan


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
                               *, taps=None, clamp=None):
    """Plain PyTorch version of `df1_hbf_cascade_bank` (with ``clamp=(u,
    lo, hi)``, of `df1_clamp_hbf_cascade_bank`)."""
    taps = _default_taps(taps)
    state, ys = df1_process_q(ba, f, state, xs, clamp=clamp)
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
                    x=None, tables=(None, None), clamp=None,
                    plan: CascadePlan | None = None):
    """Validate and launch ``idsp_ddc_cascade`` (K2 if xs, K3 if x and the
    factor tables as `ops.fastlo.factor_pairs` packs them; the clamped DF1
    with ``clamp=(u, lo, hi)``) with ``plan`` (`launch_plan`'s by
    default).  A plan the kernel refuses raises RuntimeError, having
    launched nothing."""
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
    if plan is None:
        plan = launch_plan(ms, c2, fastlo=x is not None, time_chunk=tc)
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
            y.data_ptr(), t, c2, tc, f, *_ba_list(ba), depth,
            int(clamp is not None), *(clamp or (0, 0, 0)), ms_c, taps_c,
            plan.warps, plan.producers, plan.chunk, plan.ring, plan.smem,
            _ext.stream_ptr(dev),
        )
    _ext.check(err, "ddc_cascade")
    rows = np.cumsum([0] + [3 * m - 2 for m in ms])
    new_tails = tuple(tails_out[a:b] for a, b in zip(rows[:-1], rows[1:]))
    return Df1State(x=new_x, y=new_y), new_tails, y


def df1_hbf_cascade_bank(ba, state: Df1State, tails, xs, f: int = 29, *,
                         taps=None, time_chunk: int = 128, _plan=None):
    """Fused Q<f> DF1 biquad bank + 2**depth half-band decimation,
    depth = len(taps).

    Args:
      ba: (5,) i32 Q<f> coefficients.
      state: Df1State with x/y (c2, 2) int32.
      tails: per-stage (3*m_d-2, c2) f32 tails (`hbf1_tail_init`).
      xs: (t, c2) int32.
      taps: per-stage one-sided taps, highest rate first (default
        HBF_TAPS[2], [1], [0]).
      time_chunk: checked (t % time_chunk == 0, time_chunk % 2**depth ==
        0) and otherwise unused: the kernel's chunk is its plan's
        (`launch_plan`), and no chunk changes a value.

    Returns (state, tails, y) with y (t / 2**depth, c2) f32.
    """
    if xs.device.type == "cpu":
        return df1_hbf_cascade_bank_plain(ba, state, tails, xs, f, taps=taps)
    taps = _default_taps(taps)
    t, c2 = xs.shape
    _ext.require("xs", xs, xs.device, torch.int32, (t, c2))
    out = _launch_cascade(ba, state, tails, taps, f, t, c2, time_chunk,
                          xs.device, xs=xs, plan=_plan)
    df1_hbf_cascade_bank.launches += 1
    return out


df1_hbf_cascade_bank.launches = 0  # kernel launches since the last reset


def df1_clamp_hbf_cascade_bank_plain(ba, state: Df1State, tails, xs,
                                     f: int = 29, *, u: int = 0, lo: int,
                                     hi: int, taps=None):
    """Plain PyTorch version of `df1_clamp_hbf_cascade_bank`: the clamped
    scan, the f32 cast, `hbf_dec_block` per stage."""
    return df1_hbf_cascade_bank_plain(ba, state, tails, xs, f, taps=taps,
                                      clamp=(u, lo, hi))


def df1_clamp_hbf_cascade_bank(ba, state: Df1State, tails, xs, f: int = 29,
                               *, u: int = 0, lo: int, hi: int, taps=None,
                               time_chunk: int = 128, _plan=None):
    """`df1_hbf_cascade_bank` with the anti-windup DF1 of the reference's
    production biquad (biquad.rs:394-404): each DF1 output is ``clip(y0 +
    u, lo, hi)`` (int32 ``+ u`` wrapping, ``lo > hi`` gives ``hi``)
    before it is fed back and decimated.

    Args as `df1_hbf_cascade_bank`, plus the int32 clamp ``u, lo, hi``.
    Returns (state, tails, y) with y (t / 2**depth, c2) f32.
    """
    if xs.device.type == "cpu":
        return df1_clamp_hbf_cascade_bank_plain(ba, state, tails, xs, f, u=u,
                                                lo=lo, hi=hi, taps=taps)
    clamp = clamp_params(u, lo, hi)
    taps = _default_taps(taps)
    t, c2 = xs.shape
    _ext.require("xs", xs, xs.device, torch.int32, (t, c2))
    out = _launch_cascade(ba, state, tails, taps, f, t, c2, time_chunk,
                          xs.device, xs=xs, clamp=clamp, plan=_plan)
    df1_clamp_hbf_cascade_bank.launches += 1
    return out


df1_clamp_hbf_cascade_bank.launches = 0  # kernel launches since the last reset


def _stage_taps(taps, stage: int):
    return HBF_TAPS[stage] if taps is None else taps


def df1_hbf1_bank_plain(ba, state: Df1State, tail, xs, f: int = 29, *,
                        taps=None):
    """Plain PyTorch version of `df1_hbf1_bank`."""
    state, tails, y2 = df1_hbf_cascade_bank_plain(
        ba, state, (tail,), xs, f, taps=(_stage_taps(taps, 2),))
    return state, tails[0], y2


def df1_hbf1_bank(ba, state: Df1State, tail, xs, f: int = 29, *, taps=None,
                  time_chunk: int = 512):
    """Q<f> DF1 bank + one half-band decimate-by-2 stage in one kernel:
    K2 at depth 1.

    Args:
      tail: one (3m-2, c2) f32 carried tail (`hbf1_tail_init`).
      taps: the stage's one-sided taps (default HBF_TAPS[2], the first
        stage of the decimate-by-8 cascade).
      time_chunk: checked (t % time_chunk == 0, even), as for
        `df1_hbf_cascade_bank`.
    Other args as `df1_hbf_cascade_bank`.

    Returns (state, tail, y2) with y2 (t/2, c2) f32.
    """
    if xs.device.type == "cpu":
        return df1_hbf1_bank_plain(ba, state, tail, xs, f, taps=taps)
    t, c2 = xs.shape
    _ext.require("xs", xs, xs.device, torch.int32, (t, c2))
    state, tails, y2 = _launch_cascade(
        ba, state, (tail,), _default_taps((_stage_taps(taps, 2),)), f, t, c2,
        time_chunk, xs.device, xs=xs)
    df1_hbf1_bank.launches += 1
    return state, tails[0], y2


df1_hbf1_bank.launches = 0  # kernel launches since the last reset


def df1_hbf12_bank_plain(ba, state: Df1State, tail1, tail2, xs, f: int = 29,
                         *, taps1=None, taps2=None):
    """Plain PyTorch version of `df1_hbf12_bank`."""
    state, tails, y4 = df1_hbf_cascade_bank_plain(
        ba, state, (tail1, tail2), xs, f,
        taps=(_stage_taps(taps1, 2), _stage_taps(taps2, 1)))
    return state, tails[0], tails[1], y4


def df1_hbf12_bank(ba, state: Df1State, tail1, tail2, xs, f: int = 29, *,
                   taps1=None, taps2=None, time_chunk: int = 512):
    """Q<f> DF1 bank + two half-band decimate-by-2 stages in one kernel:
    K2 at depth 2, quarter-rate output.

    Args:
      tail1, tail2: the stages' (3m-2, c2) f32 carried tails.
      taps1, taps2: the stages' one-sided taps (default HBF_TAPS[2] and
        HBF_TAPS[1], the first two stages of the decimate-by-8 cascade).
      time_chunk: checked (t % time_chunk == 0, time_chunk % 4 == 0), as
        for `df1_hbf_cascade_bank`.
    Other args as `df1_hbf_cascade_bank`.

    Returns (state, tail1, tail2, y4) with y4 (t/4, c2) f32.
    """
    if xs.device.type == "cpu":
        return df1_hbf12_bank_plain(ba, state, tail1, tail2, xs, f,
                                    taps1=taps1, taps2=taps2)
    t, c2 = xs.shape
    _ext.require("xs", xs, xs.device, torch.int32, (t, c2))
    taps = _default_taps((_stage_taps(taps1, 2), _stage_taps(taps2, 1)))
    state, tails, y4 = _launch_cascade(ba, state, (tail1, tail2), taps, f, t,
                                       c2, time_chunk, xs.device, xs=xs)
    df1_hbf12_bank.launches += 1
    return state, tails[0], tails[1], y4


df1_hbf12_bank.launches = 0  # kernel launches since the last reset


def fastlo_ddc_cascade_bank_plain(ba, state: Df1State, tails, phase0, steps,
                                  x, f: int = 29, *, clamp=None, taps=None,
                                  time_chunk: int = 128):
    """Plain PyTorch version of `fastlo_ddc_cascade_bank`: the fast-LO
    mix from factor tables with fine length ``time_chunk``, then the
    plain cascade (clamped with ``clamp``)."""
    t = x.shape[0]
    tables = fastlo_tables(phase0, steps, t, time_chunk)
    miq = fastlo_mix_tables(x, tables)
    state, tails, y = df1_hbf_cascade_bank_plain(
        ba, state, tails, miq, f, taps=taps, clamp=clamp
    )
    return state, tails, accu.advance(phase0, steps, t), y


def fastlo_ddc_cascade_bank(ba, state: Df1State, tails, phase0, steps, x,
                            f: int = 29, *, clamp=None, taps=None,
                            time_chunk: int = 128, _plan=None):
    """The whole headline DDC chain in one kernel: fast-LO conjugate mix
    + DF1 bank + half-band decimation cascade.

    Args:
      phase0: (c,) i32 NCO phase before the first sample.
      steps: (c,) i32 per-channel frequency words.
      x: (t,) i32 wideband input; lanes are I|Q (c2 = 2c).
      clamp: optional int32 ``(u, lo, hi)``: the anti-windup DF1 of
        `df1_clamp_hbf_cascade_bank`.
      time_chunk: the fine-table length of the mix (t % time_chunk ==
        0, time_chunk % 2**depth == 0), so it changes the mix's rounding:
        pass the value the compared run used (the JAX package's default
        is 128).  The kernel's own chunk is its plan's (`launch_plan`).

    Returns (state, tails, new_phase0, y) with y (t/2**depth, 2c) f32 and
    ``new_phase0 = phase0 + steps*t`` (wrapping).
    """
    if x.device.type == "cpu":
        return fastlo_ddc_cascade_bank_plain(
            ba, state, tails, phase0, steps, x, f, clamp=clamp, taps=taps,
            time_chunk=time_chunk,
        )
    clamp = None if clamp is None else clamp_params(*clamp)
    taps = _default_taps(taps)
    t = x.shape[0]
    c = phase0.shape[0]
    dev = x.device
    _ext.require("x", x, dev, torch.int32, (t,))
    _ext.require("phase0", phase0, dev, torch.int32, (c,))
    _ext.require("steps", steps, dev, torch.int32, (c,))
    tables = factor_pairs(fastlo_tables(phase0, steps, t, time_chunk))
    new_state, new_tails, y = _launch_cascade(
        ba, state, tails, taps, f, t, 2 * c, time_chunk, dev, x=x,
        tables=tables, clamp=clamp, plan=_plan,
    )
    fastlo_ddc_cascade_bank.launches += 1
    if clamp is not None:
        fastlo_ddc_cascade_bank.clamp_launches += 1
    return new_state, new_tails, accu.advance(phase0, steps, t), y


fastlo_ddc_cascade_bank.launches = 0  # kernel launches since the last reset
fastlo_ddc_cascade_bank.clamp_launches = 0  # of them with ``clamp``


def exact_mix(x: torch.Tensor, phase0: torch.Tensor, steps: torch.Tensor):
    """Conjugate NCO mix with the exact `cossin` LO: (t, 2c) int32, I
    lanes then Q lanes; sample n mixed with phase ``phase0 + steps*n``,
    n = 1..t."""
    lo_re, lo_im = cossin(accu.ramp_t(phase0, steps, x.shape[0]))
    xi = x[:, None]
    mi = fxp.q_apply(lo_re, xi, 32)
    mq = fxp.q_apply(-lo_im, xi, 32)
    return torch.cat([mi, mq], dim=1)


def ddc_mix_df1_bank_plain(ba, state: Df1State, phase0, steps, x,
                           f: int = 29, *, out_dtype=None):
    """Plain PyTorch version of `ddc_mix_df1_bank`: `exact_mix`, the DF1
    scan, the cast."""
    state, ys = df1_bank_q_plain(ba, state, exact_mix(x, phase0, steps), f,
                                 out_dtype=out_dtype)
    return state, accu.advance(phase0, steps, x.shape[0]), ys


def ddc_mix_df1_bank(ba, state: Df1State, phase0, steps, x, f: int = 29, *,
                     out_dtype=None, _plan: PipePlan | None = None):
    """Exact-LO conjugate NCO mix + Q<f> DF1 bank in one kernel.

    Args:
      ba: (5,) i32 Q<f> coefficients.
      state: Df1State with x/y (2c, 2) int32, I lanes then Q lanes.
      phase0: (c,) i32 NCO phase before the first sample: row i of the
        block mixes with ``cossin(phase0 + steps*(i+1))``, wrapping.
      steps: (c,) i32 per-channel frequency words.
      x: (t,) i32 wideband input.
      out_dtype: None (int32) or torch.float32 (the state stays exact).

    Returns (state, new_phase0, yiq) with yiq (t, 2c), bit-identical to
    `exact_mix` then `df1_bank_q`.  The kernel's plan is `mix_plan`'s; no
    plan changes a value.
    """
    if x.device.type == "cpu":
        return ddc_mix_df1_bank_plain(ba, state, phase0, steps, x, f,
                                      out_dtype=out_dtype)
    if out_dtype not in (None, torch.int32, torch.float32):
        raise ValueError(f"out_dtype must be int32 or float32, got {out_dtype}")
    if not 0 < f < 64:
        raise ValueError(f"f must be in (0, 64), got {f}")
    t = x.shape[0]
    c = phase0.shape[0]
    dev = x.device
    plan = mix_plan(2 * c) if _plan is None else _plan
    _ext.require("x", x, dev, torch.int32, (t,))
    _ext.require("phase0", phase0, dev, torch.int32, (c,))
    _ext.require("steps", steps, dev, torch.int32, (c,))
    _ext.require("state.x", state.x, dev, torch.int32, (2 * c, 2))
    _ext.require("state.y", state.y, dev, torch.int32, (2 * c, 2))
    f32 = out_dtype == torch.float32
    ys = torch.empty((t, 2 * c), dtype=torch.float32 if f32 else torch.int32,
                     device=dev)
    new_x = torch.empty_like(state.x)
    new_y = torch.empty_like(state.y)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_ddc_mix_df1(
            x.data_ptr(), phase0.data_ptr(), steps.data_ptr(),
            state.x.data_ptr(), state.y.data_ptr(), new_x.data_ptr(),
            new_y.data_ptr(), ys.data_ptr(), t, c, f, int(f32),
            *_ba_list(ba), plan.warps, plan.producers, plan.chunk,
            plan.ring, plan.smem, _ext.stream_ptr(dev),
        )
    _ext.check(err, "ddc_mix_df1_bank")
    ddc_mix_df1_bank.launches += 1
    return Df1State(x=new_x, y=new_y), accu.advance(phase0, steps, t), ys


ddc_mix_df1_bank.launches = 0  # kernel launches since the last reset
