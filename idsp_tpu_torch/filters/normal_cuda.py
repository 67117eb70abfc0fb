"""K35 and K36: the normal-form banks (port of
`idsp_tpu.filters.normal_pallas`: `normal_bank_q`, `normal_bank_f32`).

Each runs its CUDA kernel of ``csrc/structures_bank.cu`` for a CUDA
tensor and its plain PyTorch version (``*_plain``) for a CPU tensor; any
other device raises.  K35 is bit-identical to scanning `normal.step_q`
(`normal.block_q`), K36 to `normal.block` with float32 coefficients (the
kernel rounds each product and sum on its own, in the plain version's
order).  The state is a `Df1State` with x/y of shape (c, 2): ``x = [x1,
x2]``, ``y = [y0, y1]`` the rotating I/Q pair.

Both kernels run on the depth-0 pipeline of ``csrc/df1_ring.cuh``
(`normal_plan`): a CUDA block is a tile of 32 lanes, producer warps write
each row's feed-forward sum into the serial warp's input ring (K35: W =
b0 x0 + b1 x1 + b2 x2 mod 2^64 as two 32-bit words; K36: (b0 x0 + b1 x1) +
b2 x2 rounded as the plain version rounds it), the serial warp runs the
2x2 rotation of y0 and y1 into the output ring, a store warp writes the
rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _ext
from .biquad import Df1State
from .biquad_cuda import _f32_coefs, _launch_typed, _plan_args, check_f
from .normal import block, block_q
from .pipe_plan import PipePlan, pipe_plan

_I32_MIN = -(2**31)
# the producer warps of K35 and K36 by default (and a store warp: 12 warps
# a block; with 5, K36's producers set its pace, PERF.md §6)
NORMAL_PRODUCERS = 8


def normal_plan(c: int, *, f32: bool = False,
                producers: int = NORMAL_PRODUCERS, **kw) -> PipePlan:
    """K35's (or, with ``f32``, K36's) plan over ``c`` lanes
    (`pipe_plan.pipe_plan`): NORMAL_PRODUCERS producer warps by default,
    each a span of ceil(chunk / producers) rows of every chunk; K35 two
    32-bit words a row and lane in (W mod 2^64) and one out (y0), so
    PIPE_CHUNK rows a chunk in 2 slots by default, as
    `biquad_cuda.df1_plan`; K36 one word each way, 3 slots, as
    `svf_cuda.svf_plan`; one CTA a tile."""
    if kw.get("cluster", 1) != 1:
        raise ValueError("K35 and K36 run one CTA a tile")
    return pipe_plan(c, producers=producers, win=1 if f32 else 2, wout=1,
                     **kw)


def _coefs(b, p) -> np.ndarray:
    """[b0, b1, b2, p_re, p_im] as one numpy array."""
    return np.concatenate([
        np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v).reshape(-1)
        [:n] for v, n in ((b, 3), (p, 2))])


def _q_coefs(b, p) -> list[int]:
    """The five coefficients as Python ints; ``p_im == INT32_MIN`` has no
    int32 negation and is refused, as the JAX kernel refuses it."""
    coefs = [int(v) for v in _coefs(b, p)]
    if coefs[4] == _I32_MIN:
        raise ValueError("p_im == INT32_MIN has no negation")
    return coefs


def normal_bank_q_plain(b, p, state: Df1State, xs, f: int = 29):
    """Plain PyTorch version of `normal_bank_q`: the scan of `step_q`."""
    _q_coefs(b, p)
    check_f(f)
    return block_q(b, p, f, state, xs)


def normal_bank_q(b, p, state: Df1State, xs, f: int = 29, *,
                  _plan: PipePlan | None = None):
    """Fixed-point normal-form section over a bank of lanes.

    Args:
      b: (3,) int32 Q<f> FIR prefix coefficients, shared by all lanes.
      p: (2,) int32 Q<f> pole (re, im); ``p_im == INT32_MIN`` is refused.
      state: Df1State with x/y (c, 2) int32 (y the I/Q pair).
      xs: (t, c) int32.
      f: fractional bits, 0 < f < 64.

    Returns (state, ys (t, c) int32), bit-identical to scanning
    `normal.step_q`: the y1 sum of five i32 x i32 products and the y0 sum
    of two, each wrapping mod 2^64, one truncating ``>> f``, wrap to int32.
    The kernel's plan is `normal_plan`'s; no plan changes a value.
    """
    if xs.device.type == "cpu":
        return normal_bank_q_plain(b, p, state, xs, f)
    coefs = _q_coefs(b, p)
    check_f(f)
    plan = normal_plan(xs.shape[1]) if _plan is None else _plan
    out = _launch_typed("normal_bank_q", _ext.library().idsp_normal_bank_q,
                        [*coefs, *_plan_args(plan)], state, xs, torch.int32,
                        f)
    normal_bank_q.launches += 1
    return out


normal_bank_q.launches = 0  # kernel launches since the last reset


def normal_bank_f32_plain(b, p, state: Df1State, xs):
    """Plain PyTorch version of `normal_bank_f32`: the float scan."""
    k = _f32_coefs(_coefs(b, p))
    return block(k[:3], k[3:], state, xs)


def normal_bank_f32(b, p, state: Df1State, xs, *,
                    _plan: PipePlan | None = None):
    """Float normal-form section over a bank of lanes (normal.rs:38-58):
    ``y1' = b0 x0 + b1 x1 + b2 x2 + p_re y1 - p_im y0`` left to right,
    then ``y0' = p_im y1 + p_re y0``, each product and sum rounded on its
    own.

    Args:
      b, p: (3,) and (2,) float coefficients (rounded to float32).
      state: Df1State with x/y (c, 2) float32.
      xs: (t, c) float32.

    Returns (state, ys (t, c) float32), bit-identical to `normal.block`.
    The kernel's plan is `normal_plan(c, f32=True)`'s; no plan changes a
    value.
    """
    if xs.device.type == "cpu":
        return normal_bank_f32_plain(b, p, state, xs)
    coefs = _f32_coefs(_coefs(b, p))
    plan = normal_plan(xs.shape[1], f32=True) if _plan is None else _plan
    out = _launch_typed("normal_bank_f32",
                        _ext.library().idsp_normal_bank_f32,
                        [*coefs, *_plan_args(plan)], state, xs,
                        torch.float32)
    normal_bank_f32.launches += 1
    return out


normal_bank_f32.launches = 0  # kernel launches since the last reset
