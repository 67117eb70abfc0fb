"""K6, K12 and K13: the BASELINE #5 per-channel stack in one kernel
(port of `fastlo_ddc_bank_block_lp`, `fastlo_df1_dec_bank` and
`fastlo_ddc_bank_block` of `idsp_tpu.filters.ddc_pallas`).

* `fastlo_ddc_bank_block_lp` (K6): fast-LO mix, `Lowpass<N>` on I and Q,
  keep 1 in d, atan2, PLL;
* `fastlo_df1_dec_bank` (K12): fast-LO mix, Q<f> DF1 on I and Q, keep 1
  in d (the biquad bank's front end); with ``clamp=(u, lo, hi)`` the
  anti-windup DF1 (offset and clamp before feedback);
* `fastlo_ddc_bank_block` (K13): K12, then atan2 and the PLL.

Each runs ``csrc/ddc_bank.cu`` for CUDA tensors (one kernel on
``csrc/df1_ring.cuh``'s depth-0 pipeline, its plan `bank_plan`; K6's
serial warp the Lowpass<N> of ``csrc/lowpass.cuh``, K12/K13's the DF1) and
its plain PyTorch version (``*_plain``) for CPU tensors;
any other device raises.  The plain versions are the
unfused composition: the fast-LO mix from factor tables with fine length
``time_chunk``, the filter bank's plain version with keep-1-in-d on the
I|Q lanes, `trig.atan2` of the kept rows and `pll_bank_plain`.  The
kernels compute the same values (the mix in the same f32 operation
order, the rest exact integer arithmetic).

The time chunk is the fine-table length of the mix, so it changes the
mix's rounding.  The JAX kernel clamps the chunk it is asked for through
its TPU memory model (`_pick_time_chunk`); this port runs the chunk it
is given.  The kernel's own pipeline chunk is its plan's and changes no
value.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..ops import accu
from ..ops.fastlo import factor_pairs, fastlo_mix_tables, fastlo_tables
from ..ops.trig import atan2
from .biquad import Df1State, _ba_list, clamp_params, df1_process_q
from .lowpass import LowpassState, _gains
from .lowpass_cuda import lowpass_bank_plain
from .pipe_plan import PipePlan, pipe_plan
from .pll import PllState, ba_list
from .pll_cuda import pll_bank_plain, pll_state_from_words, pll_words

# K6's and K12/K13's mix warps by default (and the back-end warp: 12
# warps a block)
BANK_PRODUCERS = 8


def bank_plan(c: int, *, producers: int = BANK_PRODUCERS,
              **kw) -> PipePlan:
    """K6's, K12's and K13's plan over ``c`` channels (`pipe_plan.pipe_plan`
    over their 2c I|Q lanes): a tile is the I and the Q lanes of 16 channels,
    so ``tiles`` is ceil(c / 16); BANK_PRODUCERS mix warps by default,
    each a span of ceil(chunk / producers) rows of every chunk; one word a
    row and lane in (the mixed sample) and out (the filter's y), so
    PIPE_CHUNK rows a chunk in 3 slots by default; one CTA a tile.  Raises
    ValueError for a plan the kernel cannot run."""
    if c < 1:
        raise ValueError(f"need c >= 1 channels, got {c}")
    if kw.get("cluster", 1) != 1:
        raise ValueError("K6, K12 and K13 run one CTA a tile")
    return pipe_plan(2 * c, producers=producers, **kw)


def _check_chunking(t: int, d: int, time_chunk: int) -> None:
    if d < 1 or time_chunk < 1 or t % time_chunk or time_chunk % d:
        raise ValueError("need t % time_chunk == 0 and time_chunk % d == 0, "
                         f"got t={t}, time_chunk={time_chunk}, d={d}")


def fastlo_ddc_bank_block_lp_plain(lp_gains, pll_ba, lp_state: LowpassState,
                                   pll_state: PllState, phase0, steps, x, *,
                                   d: int = 16, time_chunk: int = 128):
    """Plain PyTorch version of `fastlo_ddc_bank_block_lp`."""
    t = x.shape[0]
    c = phase0.shape[0]
    _check_chunking(t, d, time_chunk)
    miq = fastlo_mix_tables(x, fastlo_tables(phase0, steps, t, time_chunk))
    lp_state, yiq_d = lowpass_bank_plain(lp_gains, lp_state, miq, dec=d)
    ph = atan2(yiq_d[:, c:], yiq_d[:, :c])
    pll_state, y_pll = pll_bank_plain(pll_ba, pll_state, ph)
    return (lp_state, pll_state, accu.advance(phase0, steps, t), yiq_d,
            y_pll)


def fastlo_ddc_bank_block_lp(lp_gains, pll_ba, lp_state: LowpassState,
                             pll_state: PllState, phase0, steps, x, *,
                             d: int = 16, time_chunk: int = 128,
                             _plan: PipePlan | None = None):
    """Fast-LO mix + Lowpass<N> I|Q bank + keep-1-in-d + atan2 + PLL,
    one kernel per block.

    Args:
      lp_gains: (N,) i32 gains, N = 1 or 2 (`lowpass.gains1` / `gains2`).
      pll_ba: (3,) Q32<32> PLL coefficients [b0, b1, a1].
      lp_state: LowpassState with p (2c, N) int64, I lanes then Q lanes.
      pll_state: PllState with (c,) leaves.
      phase0: (c,) i32 NCO phase before the first sample.
      steps: (c,) i32 per-channel frequency words.
      x: (t,) i32 wideband input.
      d: decimation (keep rows 0, d, 2d, ...).
      time_chunk: the fine-table length of the mix (t % time_chunk == 0,
        time_chunk % d == 0); the JAX package's default is 128.

    Returns (lp_state, pll_state, new_phase0, yiq_d, y_pll): yiq_d
    (t/d, 2c) i32, y_pll (t/d, c) i32 and ``new_phase0 = phase0 +
    steps*t`` (wrapping).  The kernel's plan is `bank_plan`'s, as K12's;
    no plan changes a value.
    """
    if x.device.type == "cpu":
        return fastlo_ddc_bank_block_lp_plain(
            lp_gains, pll_ba, lp_state, pll_state, phase0, steps, x, d=d,
            time_chunk=time_chunk)
    gains = _gains(lp_gains)
    n = len(gains)
    if n not in (1, 2):
        raise ValueError(f"need 1 or 2 lowpass gains, got {n}")
    t = x.shape[0]
    c = phase0.shape[0]
    dev = x.device
    _check_chunking(t, d, time_chunk)
    plan = bank_plan(c) if _plan is None else _plan
    _ext.require("x", x, dev, torch.int32, (t,))
    _ext.require("phase0", phase0, dev, torch.int32, (c,))
    _ext.require("steps", steps, dev, torch.int32, (c,))
    _ext.require("lp_state.p", lp_state.p, dev, torch.int64, (2 * c, n))
    w_in = pll_words(pll_state, c, dev)
    w_out = [torch.empty_like(w) for w in w_in]
    coarse, fine = factor_pairs(fastlo_tables(phase0, steps, t, time_chunk))
    lp_out = torch.empty_like(lp_state.p)
    yiq = torch.empty((t // d, 2 * c), dtype=torch.int32, device=dev)
    ypll = torch.empty((t // d, c), dtype=torch.int32, device=dev)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_ddc_bank_lp(
            x.data_ptr(), coarse.data_ptr(), fine.data_ptr(),
            lp_state.p.data_ptr(), lp_out.data_ptr(), _ext.pointers(w_in),
            _ext.pointers(w_out), yiq.data_ptr(), ypll.data_ptr(), t, c,
            time_chunk, d, n, gains[0], gains[1] if n == 2 else 0,
            *ba_list(pll_ba), plan.warps, plan.producers, plan.chunk,
            plan.ring, plan.smem, _ext.stream_ptr(dev),
        )
    _ext.check(err, "fastlo_ddc_bank_block_lp")
    fastlo_ddc_bank_block_lp.launches += 1
    return (LowpassState(p=lp_out), pll_state_from_words(w_out),
            accu.advance(phase0, steps, t), yiq, ypll)


fastlo_ddc_bank_block_lp.launches = 0  # kernel launches since the last reset


def fastlo_df1_dec_bank_plain(ba, state: Df1State, phase0, steps, x,
                              f: int = 29, *, d: int = 16, clamp=None,
                              time_chunk: int = 128):
    """Plain PyTorch version of `fastlo_df1_dec_bank`."""
    t = x.shape[0]
    _check_chunking(t, d, time_chunk)
    miq = fastlo_mix_tables(x, fastlo_tables(phase0, steps, t, time_chunk))
    state, yiq = df1_process_q(ba, f, state, miq, clamp=clamp)
    return state, accu.advance(phase0, steps, t), yiq[::d].contiguous()


def fastlo_ddc_bank_block_plain(ba, pll_ba, state: Df1State,
                                pll_state: PllState, phase0, steps, x,
                                f: int = 29, *, d: int = 16,
                                time_chunk: int = 128):
    """Plain PyTorch version of `fastlo_ddc_bank_block`."""
    c = phase0.shape[0]
    state, phase, yiq_d = fastlo_df1_dec_bank_plain(
        ba, state, phase0, steps, x, f, d=d, time_chunk=time_chunk)
    pll_state, _ = pll_bank_plain(pll_ba, pll_state,
                                  atan2(yiq_d[:, c:], yiq_d[:, :c]))
    return state, pll_state, phase, yiq_d


def _launch_df1(name, ba, state: Df1State, phase0, steps, x, f, d,
                time_chunk, pll_ba=None, pll_state=None, clamp=None,
                plan=None):
    """Validate and launch ``idsp_ddc_bank_df1`` at ``plan`` (`bank_plan`'s
    by default): K12 without a PLL state (the anti-windup DF1 with
    ``clamp``), K13 with one.  Returns (state, pll words or None,
    yiq_d)."""
    if not 0 < f < 64:
        raise ValueError(f"f must be in (0, 64), got {f}")
    t = x.shape[0]
    c = phase0.shape[0]
    dev = x.device
    _check_chunking(t, d, time_chunk)
    plan = bank_plan(c) if plan is None else plan
    _ext.require("x", x, dev, torch.int32, (t,))
    _ext.require("phase0", phase0, dev, torch.int32, (c,))
    _ext.require("steps", steps, dev, torch.int32, (c,))
    _ext.require("state.x", state.x, dev, torch.int32, (2 * c, 2))
    _ext.require("state.y", state.y, dev, torch.int32, (2 * c, 2))
    w_in = w_out = None
    pk = [0, 0, 0]
    if pll_state is not None:
        w_in = pll_words(pll_state, c, dev)
        w_out = [torch.empty_like(w) for w in w_in]
        pk = ba_list(pll_ba)
    coarse, fine = factor_pairs(fastlo_tables(phase0, steps, t, time_chunk))
    new_x = torch.empty_like(state.x)
    new_y = torch.empty_like(state.y)
    yiq = torch.empty((t // d, 2 * c), dtype=torch.int32, device=dev)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_ddc_bank_df1(
            x.data_ptr(), coarse.data_ptr(), fine.data_ptr(),
            state.x.data_ptr(), state.y.data_ptr(),
            new_x.data_ptr(), new_y.data_ptr(),
            None if w_in is None else _ext.pointers(w_in),
            None if w_out is None else _ext.pointers(w_out), yiq.data_ptr(),
            t, c, time_chunk, d, f, *_ba_list(ba), *pk,
            int(clamp is not None), *(clamp or (0, 0, 0)), plan.warps,
            plan.producers, plan.chunk, plan.ring, plan.smem,
            _ext.stream_ptr(dev),
        )
    _ext.check(err, name)
    return Df1State(x=new_x, y=new_y), w_out, yiq


def fastlo_df1_dec_bank(ba, state: Df1State, phase0, steps, x, f: int = 29,
                        *, d: int = 16, clamp=None, time_chunk: int = 128,
                        _plan: PipePlan | None = None):
    """Fast-LO conjugate mix + Q<f> DF1 on the I|Q lanes + keep-1-in-d,
    one kernel per block: the full-rate mixed stream never reaches
    device memory.

    Args:
      ba: (5,) i32 Q<f> DF1 coefficients.
      state: Df1State with x/y (2c, 2) int32, I lanes then Q lanes.
      phase0: (c,) i32 NCO phase before the first sample.
      steps: (c,) i32 per-channel frequency words.
      x: (t,) i32 wideband input.
      d: decimation (keep rows 0, d, 2d, ...).
      clamp: optional int32 ``(u, lo, hi)``: each DF1 output is ``clip(y0
        + u, lo, hi)`` (``+ u`` wrapping) before it is fed back
        (biquad.rs:394-404).
      time_chunk: the fine-table length of the mix (t % time_chunk == 0,
        time_chunk % d == 0); the JAX package's default is 128.

    Returns (state, new_phase0, yiq_d): yiq_d (t/d, 2c) i32 and
    ``new_phase0 = phase0 + steps*t`` (wrapping).  The kernel's plan is
    `bank_plan`'s; no plan changes a value.
    """
    if x.device.type == "cpu":
        return fastlo_df1_dec_bank_plain(ba, state, phase0, steps, x, f, d=d,
                                         clamp=clamp, time_chunk=time_chunk)
    clamp = None if clamp is None else clamp_params(*clamp)
    state_out, _, yiq = _launch_df1("fastlo_df1_dec_bank", ba, state, phase0,
                                    steps, x, f, d, time_chunk, clamp=clamp,
                                    plan=_plan)
    fastlo_df1_dec_bank.launches += 1
    if clamp is not None:
        fastlo_df1_dec_bank.clamp_launches += 1
    return state_out, accu.advance(phase0, steps, x.shape[0]), yiq


fastlo_df1_dec_bank.launches = 0  # kernel launches since the last reset
fastlo_df1_dec_bank.clamp_launches = 0  # of them with ``clamp``


def fastlo_ddc_bank_block(ba, pll_ba, state: Df1State, pll_state: PllState,
                          phase0, steps, x, f: int = 29, *, d: int = 16,
                          time_chunk: int = 128,
                          _plan: PipePlan | None = None):
    """`fastlo_df1_dec_bank`, then per kept row `atan2(Q, I)` and one
    PLL step, one kernel per block.

    Args as `fastlo_df1_dec_bank`, plus:
      pll_ba: (3,) Q32<32> PLL coefficients [b0, b1, a1].
      pll_state: PllState with (c,) leaves.

    Returns (state, pll_state, new_phase0, yiq_d); the PLL's output
    phases are not kept (the JAX wrapper drops them too).  The kernel's
    plan is `bank_plan`'s, as K12's.
    """
    if x.device.type == "cpu":
        return fastlo_ddc_bank_block_plain(
            ba, pll_ba, state, pll_state, phase0, steps, x, f, d=d,
            time_chunk=time_chunk)
    state_out, w_out, yiq = _launch_df1(
        "fastlo_ddc_bank_block", ba, state, phase0, steps, x, f, d,
        time_chunk, pll_ba, pll_state, plan=_plan)
    fastlo_ddc_bank_block.launches += 1
    return (state_out, pll_state_from_words(w_out),
            accu.advance(phase0, steps, x.shape[0]), yiq)


fastlo_ddc_bank_block.launches = 0  # kernel launches since the last reset
