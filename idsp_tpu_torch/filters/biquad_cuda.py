"""The DF1 biquad banks (port of `idsp_tpu.filters.biquad_pallas`): K1
`df1_bank_q`, K11 `df1_bank_q_dec`, K18 `df1_clamp_bank_q`, K24
`sos_bank_q`, K25 `df1_wide_bank`, K26 `df1_bank_q_coef`, K27
`df1_clamp_bank_q_coef`, and the rest of the precision ladder: K28
`df1_bank_q16`, K29 `df1_bank_q64`, K30 `df1_bank_f32`, K31
`df1_dither_bank`, K32 `df1_wide_bank_coef` and K33
`df1_dither_bank_coef`.

Each runs its CUDA kernel (K1, K11, K18, K26, K27 ``csrc/df1_bank.cu``;
K24, K25 and K32 ``csrc/biquad_bank.cu``; K28-K31 and K33
``csrc/biquad_precision.cu``; K1, K11, K18 and K25-K33 on the depth-0
pipeline of ``csrc/df1_ring.cuh``, `df1_plan`, `wide_plan`, `q16_plan`,
`q64_plan`, `f32_plan` and `dither_plan`; K24 on a chain of such blocks
over a
thread-block cluster, `pipe_plan.sos_plan`) for a CUDA tensor and its
plain PyTorch version
(``*_plain``) for a CPU tensor; any other device raises.  K1 and K11
are bit-identical to `biquad.df1_process_q` (K11: then ``ys[::d]``), K18 to
`biquad.df1_clamp_process_q`, K24 to chaining `df1_process_q` stage by
stage, K25 to `biquad.df1_wide_process`, K26 and K27 to K1 and K18 with
one coefficient set per lane, K28 to `biquad.df1_process_q` with
``dtype=int16``, K29 to `biquad.df1_process_q64`, K30 to
`biquad.df1_process`, K31 to `biquad.df1_dither_process`, K32 and K33 to
K25 and K31 with one coefficient set per lane.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _ext
from .biquad import (
    Df1DitherState,
    Df1State,
    Df1WideState,
    _ba_list,
    check_wide_f,
    clamp_params,
    df1_clamp_process_q,
    df1_dither_process,
    df1_process,
    df1_process_q,
    df1_process_q64,
    df1_wide_process,
)
from .pipe_plan import SOS_MAX_STAGES, PipePlan, SosPlan, pipe_plan, sos_plan

# The producer warps of K1, K11, K18, K25-K27 and K31-K33 by default (and
# a store warp: 12 warps a block; with 5 the producers' loads set K31's
# pace, PERF.md §6)
DF1_PRODUCERS = 8
# K29's producer warps by default (and a store warp: 8 warps a block)
Q64_PRODUCERS = 5
# K28's and K30's producer warps by default (and a store warp: 12 warps a
# block; with 5 the producers set their pace, PERF.md §6)
Q16_PRODUCERS = 8
DITHER_PRODUCERS = DF1_PRODUCERS  # K31's and K33's name for it


def df1_bank_q_plain(ba, state: Df1State, xs, f: int = 29, *,
                     out_dtype=None):
    """Plain PyTorch version of `df1_bank_q`: the scan plus the cast."""
    state, ys = df1_process_q(ba, f, state, xs)
    return state, ys if out_dtype is None else ys.to(out_dtype)


def df1_plan(c: int, *, producers: int = DF1_PRODUCERS, **kw) -> PipePlan:
    """The plan over ``c`` lanes (`pipe_plan.pipe_plan`) of K1, K11, K18,
    K26, K27 and (as `dither_plan`, `wide_plan`) K31, K33, K25 and K32, a
    serial warp over the same words: DF1_PRODUCERS producer warps by
    default, each a span of ceil(chunk / producers) rows of every chunk;
    two 32-bit words a row and lane in (the feed-forward sum mod 2^64), one
    out (y), so PIPE_CHUNK rows a chunk in 2 slots by default; one CTA a
    tile."""
    if kw.get("cluster", 1) != 1:
        raise ValueError("K1, K11, K18, K25-K27 and K31-K33 run one CTA a "
                         "tile")
    return pipe_plan(c, producers=producers, win=2, wout=1, **kw)


dither_plan = df1_plan  # K31's and K33's name for it
wide_plan = df1_plan  # K25's and K32's


def _plan_args(plan: PipePlan) -> tuple:
    """A depth-0 plan as its C entry takes it, after the old arguments."""
    return plan.warps, plan.producers, plan.chunk, plan.ring, plan.smem


def _launch(name, ba, state: Df1State, xs, f, out_dtype, d=None,
            clamp=None, plan=None):
    """Validate and launch K1 (``d`` None), K11 or K18 (``clamp``) on a
    CUDA tensor at ``plan`` (`df1_plan`'s by default)."""
    if out_dtype not in (None, torch.int32, torch.float32):
        raise ValueError(f"out_dtype must be int32 or float32, got {out_dtype}")
    check_f(f)
    t, c = xs.shape
    if d is not None:
        check_dec(t, d)
    shape = _plan_args(df1_plan(c) if plan is None else plan)
    dev = xs.device
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    _ext.require("state.x", state.x, dev, torch.int32, (c, 2))
    _ext.require("state.y", state.y, dev, torch.int32, (c, 2))
    f32 = out_dtype == torch.float32
    ys = torch.empty((t // (d or 1), c),
                     dtype=torch.float32 if f32 else torch.int32, device=dev)
    new_x = torch.empty_like(state.x)
    new_y = torch.empty_like(state.y)
    ptrs = (xs.data_ptr(), ys.data_ptr(), state.x.data_ptr(),
            state.y.data_ptr(), new_x.data_ptr(), new_y.data_ptr(), t, c)
    lib = _ext.library()
    with torch.cuda.device(dev):
        if clamp is not None:
            err = lib.idsp_df1_clamp_bank_q(*ptrs, f, *_ba_list(ba), *clamp,
                                            *shape, _ext.stream_ptr(dev))
        elif d is None:
            err = lib.idsp_df1_bank_q(*ptrs, f, int(f32), *_ba_list(ba),
                                      *shape, _ext.stream_ptr(dev))
        else:
            err = lib.idsp_df1_bank_q_dec(*ptrs, d, f, int(f32),
                                          *_ba_list(ba), *shape,
                                          _ext.stream_ptr(dev))
    _ext.check(err, name)
    return Df1State(x=new_x, y=new_y), ys


def check_f(f: int) -> None:
    """A Q32<f> DF1 shifts its int64 sum right by f: 0 < f < 64."""
    if not 0 < f < 64:
        raise ValueError(f"f must be in (0, 64), got {f}")


def df1_bank_q(ba, state: Df1State, xs, f: int = 29, *, out_dtype=None,
               _plan: PipePlan | None = None):
    """Fixed-point DF1 biquad over a bank of lanes.

    Args:
      ba: (5,) i32 Q<f> coefficients shared by all lanes.
      state: Df1State with x/y (c, 2) int32.
      xs: (t, c) int32.
      f: fractional bits, 0 < f < 64.
      out_dtype: None (int32) or torch.float32 (the cast is done in the
        kernel's store; the state stays exact int32).

    Returns (state, ys), bit-identical to `df1_process_q` scanned.  The
    kernel's plan is `df1_plan`'s; no plan changes a value.
    """
    if xs.device.type == "cpu":
        return df1_bank_q_plain(ba, state, xs, f, out_dtype=out_dtype)
    out = _launch("df1_bank_q", ba, state, xs, f, out_dtype, plan=_plan)
    df1_bank_q.launches += 1
    return out


df1_bank_q.launches = 0  # kernel launches since the last reset


def check_dec(t: int, d: int) -> None:
    if d < 1 or t % d:
        raise ValueError(f"need d >= 1 dividing t, got t={t}, d={d}")


def df1_bank_q_dec_plain(ba, state: Df1State, xs, f: int = 29, *,
                         d: int = 16, out_dtype=None):
    """Plain PyTorch version of `df1_bank_q_dec`: the scan, the kept
    rows 0, d, 2d, ..., the cast."""
    check_dec(xs.shape[0], d)
    state, ys = df1_process_q(ba, f, state, xs)
    ys = ys[::d].contiguous()
    return state, ys if out_dtype is None else ys.to(out_dtype)


def df1_bank_q_dec(ba, state: Df1State, xs, f: int = 29, *, d: int = 16,
                   out_dtype=None, _plan: PipePlan | None = None):
    """`df1_bank_q` keeping only the rows 0, d, 2d, ... of its output
    (``ys[::d]``, t % d == 0); the state carries the full-rate
    recurrence.  Returns (state, ys) with ys (t // d, c).  The kernel's
    plan is `df1_plan`'s."""
    if xs.device.type == "cpu":
        return df1_bank_q_dec_plain(ba, state, xs, f, d=d, out_dtype=out_dtype)
    out = _launch("df1_bank_q_dec", ba, state, xs, f, out_dtype, d,
                  plan=_plan)
    df1_bank_q_dec.launches += 1
    return out


df1_bank_q_dec.launches = 0  # kernel launches since the last reset


def df1_clamp_bank_q_plain(ba, state: Df1State, xs, f: int = 29, *,
                           u: int = 0, lo: int, hi: int):
    """Plain PyTorch version of `df1_clamp_bank_q`: the clamped scan."""
    return df1_clamp_process_q(ba, f, state, xs, u=u, lo=lo, hi=hi)


def df1_clamp_bank_q(ba, state: Df1State, xs, f: int = 29, *, u: int = 0,
                     lo: int, hi: int, _plan: PipePlan | None = None):
    """Fixed-point DF1 with summing-junction offset and output clamp
    (anti-windup, biquad.rs:394-404) over a bank of lanes: each output is
    ``clip(y0 + u, lo, hi)`` (int32 ``+ u`` wrapping, ``lo > hi`` gives
    ``hi``), and the clamped value is what the recurrence feeds back.

    Args as `df1_bank_q`, plus the int32 clamp ``u, lo, hi``; the output
    is int32.  Returns (state, ys), bit-identical to scanning
    ``clamp_step(df1_step_q(...))`` (`biquad.df1_clamp_process_q`).  The
    kernel's plan is `df1_plan`'s.
    """
    if xs.device.type == "cpu":
        return df1_clamp_bank_q_plain(ba, state, xs, f, u=u, lo=lo, hi=hi)
    out = _launch("df1_clamp_bank_q", ba, state, xs, f, None,
                  clamp=clamp_params(u, lo, hi), plan=_plan)
    df1_clamp_bank_q.launches += 1
    return out


df1_clamp_bank_q.launches = 0  # kernel launches since the last reset


# --- K24: the N-stage SOS cascade --------------------------------------------


def _stage_table(ba_stages) -> np.ndarray:
    """(N, 5) int64 coefficients of an (N, 5) array or tensor."""
    a = ba_stages.cpu() if isinstance(ba_stages, torch.Tensor) else ba_stages
    return np.asarray(a).astype(np.int64).reshape(-1, 5)


def sos_bank_q_plain(ba_stages, states, xs, f: int = 29):
    """Plain PyTorch version of `sos_bank_q`: `df1_process_q` chained
    stage by stage."""
    out, y = [], xs
    for ba, st in zip(_stage_table(ba_stages), states, strict=True):
        st, y = df1_process_q(ba, f, st, y)
        out.append(st)
    return out, y


@functools.lru_cache(maxsize=None)
def _max_clusters(device: torch.device, cluster: int, halves: int,
                  warps: int, smem: int) -> int:
    """K24's clusters of ``cluster`` CTAs (``halves`` ranks, ``warps`` warps
    and ``smem`` bytes each) that ``device`` holds at once
    (cudaOccupancyMaxActiveClusters; it depends only on these
    arguments)."""
    with torch.cuda.device(device):
        n = _ext.library().idsp_sos_max_clusters(cluster, halves, warps,
                                                 smem)
    if n < 0:
        _ext.check(-n, "sos_max_clusters")
    return n


def sos_launch_plan(c: int, n: int, device: torch.device) -> SosPlan:
    """K24's default plan on ``device`` (`pipe_plan.sos_plan`): its SMs,
    and a cluster shape only where the card holds every tile's cluster at
    once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sos_plan(c, n, sms=sms, co_resident=lambda p: _max_clusters(
        device, p.cluster, p.halves, p.warps, p.smem))


def sos_bank_q(ba_stages, states, xs, f: int = 29, *,
               _plan: SosPlan | None = None):
    """N-stage fixed-point SOS cascade over a bank of lanes, every stage
    advanced each row (the reference's `sos` path, py.rs:51-74).

    Args:
      ba_stages: (N, 5) i32 Q<f> coefficients, one row per stage.
      states: N `Df1State`s, x/y (c, 2) int32 each.
      xs: (t, c) int32.
      f: fractional bits, 0 < f < 64.

    Returns (states, ys): a list of N `Df1State`s and ys (t, c) int32,
    bit-identical to chaining `df1_process_q` stage-major.  A cascade of
    more than SOS_MAX_STAGES stages runs as successive launches over
    groups of stages, each at `sos_launch_plan`'s plan (a given ``_plan``
    is for a cascade of at most SOS_MAX_STAGES); no plan changes a value.
    """
    table = _stage_table(ba_stages)
    if len(states) != len(table):
        raise ValueError(f"{len(table)} stages but {len(states)} states")
    if xs.device.type == "cpu":
        return sos_bank_q_plain(table, states, xs, f)
    check_f(f)
    t, c = xs.shape
    if c < 1:
        raise ValueError(f"need lanes >= 1, got {c}")
    if _plan is not None and (_plan.stages != len(table) or
                              _plan != sos_plan(
                                  c, _plan.stages, group=_plan.group,
                                  halves=_plan.halves,
                                  producers=_plan.producers,
                                  warps=_plan.warps, chunk=_plan.chunk,
                                  ring=_plan.ring)):
        raise ValueError(f"the plan is not one of {len(table)} stages over "
                         f"{c} lanes")
    dev = xs.device
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    for i, st in enumerate(states):
        _ext.require(f"states[{i}].x", st.x, dev, torch.int32, (c, 2))
        _ext.require(f"states[{i}].y", st.y, dev, torch.int32, (c, 2))
    out, y = [], xs
    for g in range(0, len(table), SOS_MAX_STAGES):
        group = table[g:g + SOS_MAX_STAGES]
        n = len(group)
        plan = sos_launch_plan(c, n, dev) if _plan is None else _plan
        sx = torch.stack([st.x for st in states[g:g + n]])
        sy = torch.stack([st.y for st in states[g:g + n]])
        nx, ny = torch.empty_like(sx), torch.empty_like(sy)
        ys = torch.empty_like(xs)
        ba = (ctypes.c_int32 * (5 * n))(*group.reshape(-1).tolist())
        with torch.cuda.device(dev):
            err = _ext.library().idsp_sos_bank_q(
                y.data_ptr(), ys.data_ptr(), sx.data_ptr(), sy.data_ptr(),
                nx.data_ptr(), ny.data_ptr(), t, c, f, n, ba, plan.group,
                plan.halves, *_plan_args(plan), _ext.stream_ptr(dev))
        _ext.check(err, "sos_bank_q")
        sos_bank_q.launches += 1
        out += [Df1State(x=nx[i], y=ny[i]) for i in range(n)]
        y = ys
    return out, y


sos_bank_q.launches = 0  # kernel launches since the last reset


# --- K25: the wide-state DF1 -------------------------------------------------


def df1_wide_bank_plain(ba, state: Df1WideState, xs, f: int = 29, *,
                        clamp=None):
    """Plain PyTorch version of `df1_wide_bank`: the wide scan."""
    return df1_wide_process(ba, f, state, xs, clamp=clamp)


def _launch_wide(name, ba, state: Df1WideState, xs, f, clamp, planes=None,
                 plan=None):
    """Validate and launch K25 (``planes`` None) or K32 at ``plan``
    (`wide_plan`'s by default)."""
    check_wide_f(f)
    cl = (0, 0, 0) if clamp is None else clamp_params(*clamp)
    t, c = xs.shape
    shape = _plan_args(wide_plan(c) if plan is None else plan)
    dev = xs.device
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    _ext.require("state.x", state.x, dev, torch.int32, (c, 2))
    _ext.require("state.y", state.y, dev, torch.int64, (c, 2))
    ys = torch.empty_like(xs)
    nx, ny = torch.empty_like(state.x), torch.empty_like(state.y)
    ptrs = (xs.data_ptr(), ys.data_ptr(), state.x.data_ptr(),
            state.y.data_ptr(), nx.data_ptr(), ny.data_ptr())
    lib = _ext.library()
    with torch.cuda.device(dev):
        if planes is None:
            err = lib.idsp_df1_wide_bank(*ptrs, t, c, f, *_ba_list(ba),
                                         int(clamp is not None), *cl, *shape,
                                         _ext.stream_ptr(dev))
        else:
            err = lib.idsp_df1_wide_bank_coef(
                *ptrs, planes.data_ptr(), t, c, f, int(clamp is not None),
                *cl, *shape, _ext.stream_ptr(dev))
    _ext.check(err, name)
    return Df1WideState(x=nx, y=ny), ys


def df1_wide_bank(ba, state: Df1WideState, xs, f: int = 29, *, clamp=None,
                  _plan: PipePlan | None = None):
    """Wide-state DF1 (int64 feedback words) over a bank of lanes
    (biquad.rs:456-472; with ``clamp = (u, lo, hi)`` the clamped form,
    :474-480).

    Args:
      ba: (5,) i32 Q<f> coefficients shared by all lanes.
      state: `Df1WideState`, x (c, 2) int32 and y (c, 2) int64.
      xs: (t, c) int32.
      f: fractional bits, 0 < f <= 32 (the sum is shifted left by 32 - f).
      clamp: None or int32 (u, lo, hi): ``clip(y0 + u, lo, hi)`` is the
        output and replaces the high word of the fed-back word.

    Returns (state, ys int32), bit-identical to scanning `df1_wide_step`
    (`df1_wide_clamp_step`).  ``launches`` counts both forms.  The
    kernel's plan is `wide_plan`'s; no plan changes a value.
    """
    if xs.device.type == "cpu":
        return df1_wide_bank_plain(ba, state, xs, f, clamp=clamp)
    out = _launch_wide("df1_wide_bank", ba, state, xs, f, clamp, plan=_plan)
    df1_wide_bank.launches += 1
    return out


df1_wide_bank.launches = 0  # kernel launches since the last reset


# --- K26, K27: runtime (per-lane) coefficients -------------------------------


def _lane_coefs(ba_planes):
    """(5,) stays a shared set; (5, c) planes become (c, 5), one set per
    lane, as the plain scan takes them."""
    if isinstance(ba_planes, torch.Tensor):
        return ba_planes if ba_planes.dim() == 1 else ba_planes.T
    a = np.asarray(ba_planes)
    return a if a.ndim == 1 else a.T


def coef_planes(ba_planes, c: int, device) -> torch.Tensor:
    """Runtime coefficients as contiguous (5, c) int32 planes on
    ``device``: a shared (5,) set is broadcast over the lanes."""
    p = torch.as_tensor(ba_planes, dtype=torch.int32, device=device)
    if tuple(p.shape) == (5,):
        p = p[:, None].expand(5, c)
    if tuple(p.shape) != (5, c):
        raise ValueError(f"coefficients must be (5,) or (5, {c}), got "
                         f"{tuple(p.shape)}")
    return p.contiguous()


def df1_bank_q_coef_plain(ba_planes, state: Df1State, xs, f: int = 29):
    """Plain PyTorch version of `df1_bank_q_coef`."""
    return df1_process_q(_lane_coefs(ba_planes), f, state, xs)


def _launch_coef(name, ba_planes, state: Df1State, xs, f, clamp=None,
                 plan=None):
    """Validate and launch K26 (``clamp`` None) or K27 on a CUDA tensor at
    ``plan`` (`df1_plan`'s by default)."""
    check_f(f)
    t, c = xs.shape
    shape = _plan_args(df1_plan(c) if plan is None else plan)
    dev = xs.device
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    _ext.require("state.x", state.x, dev, torch.int32, (c, 2))
    _ext.require("state.y", state.y, dev, torch.int32, (c, 2))
    planes = coef_planes(ba_planes, c, dev)
    ys = torch.empty_like(xs)
    nx, ny = torch.empty_like(state.x), torch.empty_like(state.y)
    ptrs = (xs.data_ptr(), ys.data_ptr(), state.x.data_ptr(),
            state.y.data_ptr(), nx.data_ptr(), ny.data_ptr(),
            planes.data_ptr(), t, c, f)
    lib = _ext.library()
    with torch.cuda.device(dev):
        if clamp is None:
            err = lib.idsp_df1_bank_q_coef(*ptrs, *shape,
                                           _ext.stream_ptr(dev))
        else:
            err = lib.idsp_df1_clamp_bank_q_coef(*ptrs, *clamp, *shape,
                                                 _ext.stream_ptr(dev))
    _ext.check(err, name)
    return Df1State(x=nx, y=ny), ys


def df1_bank_q_coef(ba_planes, state: Df1State, xs, f: int = 29, *,
                    _plan: PipePlan | None = None):
    """Fixed-point DF1 bank with runtime coefficients: a retune is a new
    coefficient tensor, and nothing is rebuilt.

    Args:
      ba_planes: (5,) i32 Q<f> coefficients shared by all lanes (the
        reference's atomic swap, biquad.rs:34-36), or (5, c) planes, one
        set per lane.
      state, xs, f: as `df1_bank_q`.

    Returns (state, ys int32), bit-identical to `df1_process_q` with the
    lanes' coefficients (to `df1_bank_q` for a shared set).  The kernel's
    plan is `df1_plan`'s.
    """
    if xs.device.type == "cpu":
        return df1_bank_q_coef_plain(ba_planes, state, xs, f)
    out = _launch_coef("df1_bank_q_coef", ba_planes, state, xs, f,
                       plan=_plan)
    df1_bank_q_coef.launches += 1
    return out


df1_bank_q_coef.launches = 0  # kernel launches since the last reset


def df1_clamp_bank_q_coef_plain(ba_planes, state: Df1State, xs,
                                f: int = 29, *, u: int = 0, lo: int,
                                hi: int):
    """Plain PyTorch version of `df1_clamp_bank_q_coef`."""
    return df1_clamp_process_q(_lane_coefs(ba_planes), f, state, xs, u=u,
                               lo=lo, hi=hi)


def df1_clamp_bank_q_coef(ba_planes, state: Df1State, xs, f: int = 29, *,
                          u: int = 0, lo: int, hi: int,
                          _plan: PipePlan | None = None):
    """`df1_bank_q_coef` with the anti-windup clamp of `df1_clamp_bank_q`
    (int32 ``u, lo, hi``, fixed per call: they are range constants, not
    tuning targets, biquad.rs:121-157).  Returns (state, ys int32),
    bit-identical to `df1_clamp_process_q` with the lanes' coefficients.
    The kernel's plan is `df1_plan`'s.
    """
    if xs.device.type == "cpu":
        return df1_clamp_bank_q_coef_plain(ba_planes, state, xs, f, u=u,
                                           lo=lo, hi=hi)
    out = _launch_coef("df1_clamp_bank_q_coef", ba_planes, state, xs, f,
                       clamp=clamp_params(u, lo, hi), plan=_plan)
    df1_clamp_bank_q_coef.launches += 1
    return out


df1_clamp_bank_q_coef.launches = 0  # kernel launches since the last reset


# --- K28-K33: the rest of the precision ladder -------------------------------


def check_q16_f(f: int) -> None:
    """Q16 shifts its int32 sum right by f: 0 < f < 32."""
    if not 0 < f < 32:
        raise ValueError(f"f must be in (0, 32), got {f}")


def check_q64_f(f: int) -> None:
    """Q64 keeps the low word of its 128-bit sum >> f: 32 < f < 64, the
    JAX kernel's domain (the reference's row is Q64<61>)."""
    if not 32 < f < 64:
        raise ValueError(f"f must be in (32, 64), got {f}")


def _check_planes(ba_planes, c: int) -> None:
    shape = tuple(ba_planes.shape if isinstance(ba_planes, torch.Tensor)
                  else np.shape(ba_planes))
    if shape not in ((5,), (5, c)):
        raise ValueError(f"coefficients must be (5,) or (5, {c}), got "
                         f"{shape}")


def _launch_typed(name, fn, coefs, state, xs, dtype, f=None):
    """Validate and launch K28 (int16), K29 (int64) or K30 (float32);
    ``coefs`` holds the coefficients and the plan's arguments."""
    t, c = xs.shape
    dev = xs.device
    _ext.require("xs", xs, dev, dtype, (t, c))
    _ext.require("state.x", state.x, dev, dtype, (c, 2))
    _ext.require("state.y", state.y, dev, dtype, (c, 2))
    ys = torch.empty_like(xs)
    nx, ny = torch.empty_like(state.x), torch.empty_like(state.y)
    size = (t, c) if f is None else (t, c, f)
    with torch.cuda.device(dev):
        err = fn(xs.data_ptr(), ys.data_ptr(), state.x.data_ptr(),
                 state.y.data_ptr(), nx.data_ptr(), ny.data_ptr(), *size,
                 *coefs, _ext.stream_ptr(dev))
    _ext.check(err, name)
    return Df1State(x=nx, y=ny), ys


def df1_bank_q16_plain(ba, state: Df1State, xs, f: int = 13):
    """Plain PyTorch version of `df1_bank_q16`."""
    check_q16_f(f)
    return df1_process_q(ba, f, state, xs, dtype=torch.int16)


def q16_plan(c: int, *, producers: int = Q16_PRODUCERS, **kw) -> PipePlan:
    """The plan over ``c`` lanes (`pipe_plan.pipe_plan`) of K28 and (as
    `f32_plan`) K30: Q16_PRODUCERS producer warps by default, each a span
    of ceil(chunk / producers) rows of every chunk; one 32-bit word a row
    and lane each way (K28: the feed-forward sum mod 2^32 in, y0
    sign-extended out, of which the store warp writes the low half; K30:
    f32 words, as K36's `normal_cuda.normal_plan(c, f32=True)`), so
    PIPE_CHUNK rows a chunk in PIPE_RING slots by default; one CTA a
    tile."""
    if kw.get("cluster", 1) != 1:
        raise ValueError("K28 and K30 run one CTA a tile")
    return pipe_plan(c, producers=producers, win=1, wout=1, **kw)


f32_plan = q16_plan  # K30's name for it


def df1_bank_q16(ba, state: Df1State, xs, f: int = 13, *,
                 _plan: PipePlan | None = None):
    """Q16<f> DF1 over a bank of lanes (the reference's ``Q16<13>`` row,
    tests/embedded/README.md:62): int16 storage, each product and the
    five-term sum in int32 (wrapping), one truncating shift, wrap to int16.

    Args:
      ba: (5,) int16 Q<f> coefficients shared by all lanes.
      state: Df1State with x/y (c, 2) int16.
      xs: (t, c) int16.
      f: fractional bits, 0 < f < 32.

    Returns (state, ys int16), bit-identical to scanning
    ``biquad.df1_step_q(ba, f, s, x, dtype=int16)``.  The kernel's plan is
    `q16_plan`'s; no plan changes a value.
    """
    check_q16_f(f)
    if xs.device.type == "cpu":
        return df1_bank_q16_plain(ba, state, xs, f)
    plan = q16_plan(xs.shape[1]) if _plan is None else _plan
    out = _launch_typed("df1_bank_q16", _ext.library().idsp_df1_bank_q16,
                        [*_ba_list(ba), *_plan_args(plan)], state, xs,
                        torch.int16, f)
    df1_bank_q16.launches += 1
    return out


df1_bank_q16.launches = 0  # kernel launches since the last reset


def df1_bank_q64_plain(ba, state: Df1State, xs, f: int = 61):
    """Plain PyTorch version of `df1_bank_q64`."""
    check_q64_f(f)
    return df1_process_q64(ba, f, state, xs)


def q64_plan(c: int, *, producers: int = Q64_PRODUCERS, **kw) -> PipePlan:
    """K29's plan over ``c`` lanes (`pipe_plan.pipe_plan`): Q64_PRODUCERS
    producer warps by default, each a span of ceil(chunk / producers) rows
    of every chunk; four 32-bit words a row and lane in (the feed-forward
    sum), two out (y), so PIPE_CHUNK / 2 rows a chunk in 2 slots by
    default; one CTA a tile."""
    if kw.get("cluster", 1) != 1:
        raise ValueError("K29 runs one CTA a tile")
    return pipe_plan(c, producers=producers, win=4, wout=2, **kw)


def df1_bank_q64(ba, state: Df1State, xs, f: int = 61, *,
                 _plan: PipePlan | None = None):
    """Q64<f> DF1 over a bank of lanes (the reference's ``Q64<61>`` row,
    tests/embedded/README.md:63): int64 storage, the five products summed
    in 128 bits, the low 64 bits of the truncating shift.

    Args:
      ba: (5,) int64 Q<f> coefficients shared by all lanes.
      state: Df1State with x/y (c, 2) int64.
      xs: (t, c) int64.
      f: fractional bits, 32 < f < 64.

    Returns (state, ys int64), bit-identical to `df1_process_q64`.  The
    kernel's plan is `q64_plan`'s; no plan changes a value.
    """
    check_q64_f(f)
    if xs.device.type == "cpu":
        return df1_bank_q64_plain(ba, state, xs, f)
    plan = q64_plan(xs.shape[1]) if _plan is None else _plan
    out = _launch_typed("df1_bank_q64", _ext.library().idsp_df1_bank_q64,
                        [*_ba_list(ba), *_plan_args(plan)], state, xs,
                        torch.int64, f)
    df1_bank_q64.launches += 1
    return out


df1_bank_q64.launches = 0  # kernel launches since the last reset


def _f32_coefs(ba) -> list[float]:
    """The five coefficients rounded to float32, as Python floats."""
    a = ba.cpu() if isinstance(ba, torch.Tensor) else ba
    return [float(v) for v in np.asarray(a, np.float64).reshape(-1)[:5]
            .astype(np.float32)]


def df1_bank_f32_plain(ba, state: Df1State, xs):
    """Plain PyTorch version of `df1_bank_f32`: the float scan."""
    return df1_process(_f32_coefs(ba), state, xs)


def df1_bank_f32(ba, state: Df1State, xs, *, _plan: PipePlan | None = None):
    """Float DF1 over a bank of lanes, sequential: each product and sum
    rounded on its own, left to right, as `biquad.df1_process` (unlike the
    reassociating `df1_block_float`).

    Args:
      ba: (5,) float coefficients shared by all lanes (rounded to f32).
      state: Df1State with x/y (c, 2) float32.
      xs: (t, c) float32.

    Returns (state, ys float32), bit-identical to `df1_process`.  The
    kernel's plan is `f32_plan`'s; no plan changes a value.
    """
    if xs.device.type == "cpu":
        return df1_bank_f32_plain(ba, state, xs)
    plan = f32_plan(xs.shape[1]) if _plan is None else _plan
    out = _launch_typed("df1_bank_f32", _ext.library().idsp_df1_bank_f32,
                        [*_f32_coefs(ba), *_plan_args(plan)], state, xs,
                        torch.float32)
    df1_bank_f32.launches += 1
    return out


df1_bank_f32.launches = 0  # kernel launches since the last reset


def _launch_dither(name, ba, state: Df1DitherState, xs, f, clamp,
                   planes=None, plan=None):
    """Validate and launch K31 (``planes`` None) or K33 at ``plan``
    (`dither_plan`'s by default)."""
    check_wide_f(f)
    cl = (0, 0, 0) if clamp is None else clamp_params(*clamp)
    t, c = xs.shape
    plan = dither_plan(c) if plan is None else plan
    dev = xs.device
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    _ext.require("state.xy.x", state.xy.x, dev, torch.int32, (c, 2))
    _ext.require("state.xy.y", state.xy.y, dev, torch.int32, (c, 2))
    _ext.require("state.e", state.e, dev, torch.int64, (c,))
    ys = torch.empty_like(xs)
    nx, ny = torch.empty_like(state.xy.x), torch.empty_like(state.xy.y)
    ne = torch.empty_like(state.e)
    ptrs = (xs.data_ptr(), ys.data_ptr(), state.xy.x.data_ptr(),
            state.xy.y.data_ptr(), state.e.data_ptr(), nx.data_ptr(),
            ny.data_ptr(), ne.data_ptr())
    shape = _plan_args(plan)
    lib = _ext.library()
    with torch.cuda.device(dev):
        if planes is None:
            err = lib.idsp_df1_dither_bank(*ptrs, t, c, f, *_ba_list(ba),
                                           int(clamp is not None), *cl,
                                           *shape, _ext.stream_ptr(dev))
        else:
            err = lib.idsp_df1_dither_bank_coef(
                *ptrs, planes.data_ptr(), t, c, f, int(clamp is not None),
                *cl, *shape, _ext.stream_ptr(dev))
    _ext.check(err, name)
    return Df1DitherState(xy=Df1State(x=nx, y=ny), e=ne), ys


def df1_dither_bank_plain(ba, state: Df1DitherState, xs, f: int = 29, *,
                          clamp=None):
    """Plain PyTorch version of `df1_dither_bank`."""
    return df1_dither_process(ba, f, state, xs, clamp=clamp)


def df1_dither_bank(ba, state: Df1DitherState, xs, f: int = 29, *,
                    clamp=None, _plan: PipePlan | None = None):
    """Error-feedback (noise-shaping) DF1 over a bank of lanes
    (biquad.rs:511-530; with ``clamp = (u, lo, hi)`` the clamped form,
    :532-538).

    Args:
      ba: (5,) i32 Q<f> coefficients shared by all lanes.
      state: `Df1DitherState`: xy x/y (c, 2) int32, e (c,) int64 holding
        the u32 error word.
      xs: (t, c) int32.
      f: fractional bits, 0 < f <= 32 (the sum is shifted left by 32 - f).
      clamp: None or int32 (u, lo, hi): ``clip(y0 + u, lo, hi)`` (int32
        ``+ u`` wrapping) is the output and is fed back.

    Returns (state, ys int32), bit-identical to scanning `df1_dither_step`
    (`df1_dither_clamp_step`).  ``launches`` counts both forms.  The
    kernel's plan is `dither_plan`'s; no plan changes a value.
    """
    if xs.device.type == "cpu":
        return df1_dither_bank_plain(ba, state, xs, f, clamp=clamp)
    out = _launch_dither("df1_dither_bank", ba, state, xs, f, clamp,
                         plan=_plan)
    df1_dither_bank.launches += 1
    return out


df1_dither_bank.launches = 0  # kernel launches since the last reset


def df1_wide_bank_coef_plain(ba_planes, state: Df1WideState, xs,
                             f: int = 29, *, clamp=None):
    """Plain PyTorch version of `df1_wide_bank_coef`."""
    _check_planes(ba_planes, xs.shape[1])
    return df1_wide_process(_lane_coefs(ba_planes), f, state, xs,
                            clamp=clamp)


def df1_wide_bank_coef(ba_planes, state: Df1WideState, xs, f: int = 29, *,
                       clamp=None, _plan: PipePlan | None = None):
    """`df1_wide_bank` with runtime coefficients: a shared (5,) set or
    (5, c) planes, one set per lane.  Returns (state, ys int32),
    bit-identical to `df1_wide_process` with the lanes' coefficients (to
    `df1_wide_bank` for a shared set).  ``launches`` counts both forms.
    The kernel's plan is `wide_plan`'s, as K25's."""
    _check_planes(ba_planes, xs.shape[1])
    if xs.device.type == "cpu":
        return df1_wide_bank_coef_plain(ba_planes, state, xs, f, clamp=clamp)
    check_wide_f(f)
    planes = coef_planes(ba_planes, xs.shape[1], xs.device)
    out = _launch_wide("df1_wide_bank_coef", None, state, xs, f, clamp,
                       planes, _plan)
    df1_wide_bank_coef.launches += 1
    return out


df1_wide_bank_coef.launches = 0  # kernel launches since the last reset


def df1_dither_bank_coef_plain(ba_planes, state: Df1DitherState, xs,
                               f: int = 29, *, clamp=None):
    """Plain PyTorch version of `df1_dither_bank_coef`."""
    _check_planes(ba_planes, xs.shape[1])
    return df1_dither_process(_lane_coefs(ba_planes), f, state, xs,
                              clamp=clamp)


def df1_dither_bank_coef(ba_planes, state: Df1DitherState, xs, f: int = 29,
                         *, clamp=None, _plan: PipePlan | None = None):
    """`df1_dither_bank` with runtime coefficients: a shared (5,) set or
    (5, c) planes, one set per lane.  Returns (state, ys int32),
    bit-identical to `df1_dither_process` with the lanes' coefficients
    (to `df1_dither_bank` for a shared set).  ``launches`` counts both
    forms.  The kernel's plan is `dither_plan`'s, as K31's."""
    _check_planes(ba_planes, xs.shape[1])
    if xs.device.type == "cpu":
        return df1_dither_bank_coef_plain(ba_planes, state, xs, f,
                                          clamp=clamp)
    planes = coef_planes(ba_planes, xs.shape[1], xs.device)
    out = _launch_dither("df1_dither_bank_coef", None, state, xs, f, clamp,
                         planes, _plan)
    df1_dither_bank_coef.launches += 1
    return out


df1_dither_bank_coef.launches = 0  # kernel launches since the last reset
