"""K15: the whole fixed-point FM receiver over a channel bank (port of
`idsp_tpu.filters.fm_pallas.fm_disc_bank`).

`fm_disc_bank` runs the CUDA kernel of ``csrc/fm_disc.cu`` for CUDA
tensors and its plain PyTorch version, `fm_disc_bank_plain`, for CPU
tensors; any other device raises.  The kernel is K14's depth-0 pipeline
(``csrc/df1_ring.cuh``): a CUDA block is a tile of 32 channels, producer
warps compute dphi into the DF1 warp's input ring, a store warp writes
its output ring to y (`disc_plan`).  The plain version is the unfused
composition: the discriminator of every row at once (`disc_rows`, or
`disc_rows_fast` for ``angle="fast"``), row 0 masked until the stream's
first sample has passed, then the Q<f> DF1 scan.  With
``angle="exact"`` it is `pipelines.fm_disc.fm_receiver`, bit-identical to
the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _ext
from ..fxp import wrap_i32
from ..ops import complex as cplx
from ..ops.trig import atan2, atan2_f32_word
from .biquad import Df1State, _ba_list, df1_process_q
from .pipe_plan import PipePlan, pipe_plan

ANGLES = ("exact", "fast")
DISC_PRODUCERS = 8  # dphi warps (8 + a store warp: 12 warps a block)
# CTAs a tile by angle: the exact angle's dphi warps took 1.33x the DF1
# warp's time on one SM's three other schedulers (H100, PERF.md §6), so a
# partner CTA's warps compute spans too; the f32 angle keeps up alone
DISC_CLUSTER = {"exact": 2, "fast": 1}


def disc_plan(c: int, angle: str = "exact", *,
              producers: int = DISC_PRODUCERS, cluster: int | None = None,
              **kw) -> PipePlan:
    """K15's plan over ``c`` channels (`pipe_plan.pipe_plan`): DISC_PRODUCERS
    dphi warps and DISC_CLUSTER[angle] CTAs a tile by default, each dphi
    warp -- the partner CTA's too -- a span of ceil(chunk /
    plan.all_producers) rows of every chunk."""
    _check_angle(angle)
    return pipe_plan(c, producers=producers, cluster=(
        DISC_CLUSTER[angle] if cluster is None else cluster), **kw)


class FmDiscState(NamedTuple):
    """Block-streaming carry: previous IQ sample + deemphasis biquad."""

    prev_re: torch.Tensor  # int32
    prev_im: torch.Tensor  # int32
    prev_valid: torch.Tensor  # bool: False before the first sample
    deemph: Df1State


def wrap_carrier(carrier) -> int:
    """The carrier frequency word as a Python int in the int32 range."""
    return (int(carrier) + 2**31) % 2**32 - 2**31


def disc_rows(a_re, a_im, b_re, b_im, carrier: int):
    """Exact discriminator: ``arg(a * conj(b)) - carrier``, int32.

    The conjugate negation wraps in int32 before widening (``-(-2^31) =
    -2^31``), the product is `complex.mul_q` at Q32<32> (int64 sums,
    wrapping, the high word), the angle `trig.atan2`, the subtraction
    wraps."""
    nim = wrap_i32(-b_im.to(torch.int64))
    z_re, z_im = cplx.mul_q(a_re, a_im, b_re, nim, 32)
    return wrap_i32(atan2(z_im, z_re).to(torch.int64) - carrier)


def disc_rows_fast(a_re, a_im, b_re, b_im, carrier: int):
    """f32 discriminator (``angle="fast"``): the conjugate product in f32,
    each operation rounded on its own, and `atan2_f32_word`.  Within a few
    hundred LSB of `disc_rows`."""
    f32 = torch.float32
    ar, ai = a_re.to(f32), a_im.to(f32)
    br, bi = b_re.to(f32), b_im.to(f32)
    z_re = ar * br + ai * bi
    z_im = ai * br - ar * bi
    return wrap_i32(atan2_f32_word(z_im, z_re).to(torch.int64) - carrier)


def _check_angle(angle: str) -> None:
    if angle not in ANGLES:
        # never demote the bit-exact path silently
        raise ValueError(f"angle must be one of {ANGLES}, got {angle!r}")


def discriminate(state: FmDiscState, re, im, carrier: int,
                 angle: str = "exact"):
    """dphi of a block (time on axis 0; fm_disc.rs:31-39): each sample
    times the conjugate of the one before (row 0's from the carry),
    `atan2`, minus the carrier; row 0 masked to 0 until the stream's first
    sample has passed."""
    _check_angle(angle)
    b_re = torch.cat([state.prev_re[None], re[:-1]])
    b_im = torch.cat([state.prev_im[None], im[:-1]])
    disc = disc_rows if angle == "exact" else disc_rows_fast
    dphi = disc(re, im, b_re, b_im, wrap_carrier(carrier))
    return torch.cat([torch.where(state.prev_valid, dphi[0], 0)[None],
                      dphi[1:]])


def next_state(state: FmDiscState, re, im, deemph: Df1State) -> FmDiscState:
    """The carry after a block: its last sample, valid, and the deemphasis
    state."""
    return FmDiscState(prev_re=re[-1].clone(), prev_im=im[-1].clone(),
                       prev_valid=torch.ones_like(state.prev_valid),
                       deemph=deemph)


def fm_disc_bank_plain(ba, state: FmDiscState, re, im, carrier: int,
                       f: int = 30, *, angle: str = "exact"):
    """Plain PyTorch version of `fm_disc_bank` (any shape with time on
    axis 0)."""
    dphi = discriminate(state, re, im, carrier, angle)
    deemph, y = df1_process_q(ba, f, state.deemph, dphi)
    return next_state(state, re, im, deemph), y


def fm_disc_bank(ba, state: FmDiscState, re, im, carrier: int, f: int = 30,
                 *, angle: str = "exact", _plan: PipePlan | None = None):
    """The whole FM receiver in one kernel over a channel bank.

    Args:
      ba: (5,) i32 Q<f> deemphasis coefficients
        (`pipelines.fm_disc.deemphasis_coefficients`).
      state: `FmDiscState` with (c,) fields and Df1State x/y (c, 2).
      re, im: (t, c) int32 IQ planes, time-major, t >= 1.
      carrier: the carrier frequency word (taken modulo 2^32).
      f: fractional bits of ``ba``, 0 < f < 64.
      angle: "exact" (bit-identical to `fm_receiver`) or "fast" (the f32
        discriminator, SNR-gated).

    Returns (state, y) with y (t, c) int32.  The kernel's plan is
    `disc_plan`'s; no plan changes a value.
    """
    if re.device.type == "cpu":
        return fm_disc_bank_plain(ba, state, re, im, carrier, f, angle=angle)
    _check_angle(angle)
    if not 0 < f < 64:
        raise ValueError(f"f must be in (0, 64), got {f}")
    t, c = re.shape
    if t < 1:
        raise ValueError("need at least one row")
    dev = re.device
    plan = disc_plan(c, angle) if _plan is None else _plan
    _ext.require("re", re, dev, torch.int32, (t, c))
    _ext.require("im", im, dev, torch.int32, (t, c))
    _ext.require("state.prev_re", state.prev_re, dev, torch.int32, (c,))
    _ext.require("state.prev_im", state.prev_im, dev, torch.int32, (c,))
    _ext.require("state.prev_valid", state.prev_valid, dev, torch.bool, (c,))
    _ext.require("state.deemph.x", state.deemph.x, dev, torch.int32, (c, 2))
    _ext.require("state.deemph.y", state.deemph.y, dev, torch.int32, (c, 2))
    prev_re = torch.empty_like(state.prev_re)
    prev_im = torch.empty_like(state.prev_im)
    valid = torch.empty_like(state.prev_valid)
    new_x = torch.empty_like(state.deemph.x)
    new_y = torch.empty_like(state.deemph.y)
    ys = torch.empty((t, c), dtype=torch.int32, device=dev)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_fm_disc_bank(
            re.data_ptr(), im.data_ptr(), state.prev_re.data_ptr(),
            state.prev_im.data_ptr(), state.prev_valid.data_ptr(),
            state.deemph.x.data_ptr(), state.deemph.y.data_ptr(),
            prev_re.data_ptr(), prev_im.data_ptr(), valid.data_ptr(),
            new_x.data_ptr(), new_y.data_ptr(), ys.data_ptr(), t, c,
            wrap_carrier(carrier), int(angle == "fast"), f, *_ba_list(ba),
            plan.warps, plan.producers, plan.cluster, plan.chunk,
            plan.ring, plan.smem, _ext.stream_ptr(dev),
        )
    _ext.check(err, "fm_disc_bank")
    fm_disc_bank.launches += 1
    return FmDiscState(prev_re=prev_re, prev_im=prev_im, prev_valid=valid,
                       deemph=Df1State(x=new_x, y=new_y)), ys


fm_disc_bank.launches = 0  # kernel launches since the last reset
