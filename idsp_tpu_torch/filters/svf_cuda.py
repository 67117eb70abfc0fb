"""K34: the SVF bank (port of `idsp_tpu.filters.svf_pallas.svf_bank`).

`svf_bank` runs the CUDA kernel of ``csrc/structures_bank.cu`` for a
CUDA tensor and its plain PyTorch version, `svf_bank_plain`, for a CPU
tensor; any other device raises.  Both are bit-identical to the matching
field of `svf.block`: the kernel rounds each product and sum on its own
(``__fmul_rn``, ``__fadd_rn``, ``__fsub_rn``) in the plain version's
order.  The kernel runs on the depth-0 pipeline of ``csrc/df1_ring.cuh``
(`svf_plan`): a CUDA block is a tile of 32 lanes, producer warps copy the
x rows into the serial warp's input ring, the serial warp runs the
recurrence into the output ring, a store warp writes the rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _ext
from .pipe_plan import PipePlan, pipe_plan
from .svf import SvfState, block

OUTPUTS = ("lp", "hp", "bp", "br")
# K34's producer warps by default (and a store warp: 8 warps a block)
SVF_PRODUCERS = 5


def svf_plan(c: int, *, producers: int = SVF_PRODUCERS, **kw) -> PipePlan:
    """K34's plan over ``c`` lanes (`pipe_plan.pipe_plan`): SVF_PRODUCERS
    producer warps by default, each a span of ceil(chunk / producers) rows
    of every chunk; one 32-bit word a row and lane in (x) and out (the
    output), so PIPE_CHUNK rows a chunk in 3 slots by default; one CTA a
    tile."""
    if kw.get("cluster", 1) != 1:
        raise ValueError("K34 runs one CTA a tile")
    return pipe_plan(c, producers=producers, **kw)


def _check_output(output: str) -> int:
    if output not in OUTPUTS:
        raise ValueError(f"output must be one of {OUTPUTS}, got {output!r}")
    return OUTPUTS.index(output)


def _f32(v) -> float:
    return float(np.float32(v))


def svf_bank_plain(f, qi, state: SvfState, xs, *, output: str = "lp"):
    """Plain PyTorch version of `svf_bank`: the scan, then the output."""
    _check_output(output)
    state, outs = block(_f32(f), _f32(qi), state, xs)
    return state, outs.br if output == "br" else getattr(outs, output)


def svf_bank(f, qi, state: SvfState, xs, *, output: str = "lp",
             _plan: PipePlan | None = None):
    """Float Chamberlin SVF over a bank of lanes.

    Args:
      f, qi: floats (`svf.coefficients`) shared by all lanes, rounded to
        float32.
      state: SvfState with lp/hp/bp of shape (c,) float32.
      xs: (t, c) float32.
      output: the response to emit: "lp", "hp", "bp" or "br" = hp + lp
        (svf.rs:19-22).  The new state carries all three responses.

    Returns (state, ys (t, c) float32), bit-identical to the field of
    `svf.block` (``br``: ``hp + lp``).  The kernel's plan is `svf_plan`'s;
    no plan changes a value.
    """
    sel = _check_output(output)
    if xs.device.type == "cpu":
        return svf_bank_plain(f, qi, state, xs, output=output)
    t, c = xs.shape
    plan = svf_plan(c) if _plan is None else _plan
    dev = xs.device
    _ext.require("xs", xs, dev, torch.float32, (t, c))
    for name, w in zip(SvfState._fields, state):
        _ext.require(f"state.{name}", w, dev, torch.float32, (c,))
    out = SvfState(*(torch.empty_like(w) for w in state))
    ys = torch.empty_like(xs)
    with torch.cuda.device(dev):
        err = _ext.library().idsp_svf_bank(
            xs.data_ptr(), ys.data_ptr(), *(w.data_ptr() for w in state),
            *(w.data_ptr() for w in out), t, c, sel, _f32(f), _f32(qi),
            plan.warps, plan.producers, plan.chunk, plan.ring, plan.smem,
            _ext.stream_ptr(dev))
    _ext.check(err, "svf_bank")
    svf_bank.launches += 1
    return out, ys


svf_bank.launches = 0  # kernel launches since the last reset
