"""Hand parameters and state between the JAX package and the port.

The JAX package's values cross as numpy arrays (``np.asarray`` of a jax
array), so this module needs no jax.  NamedTuples are matched by field
names: ``(x, y)`` is a `Df1State`, ``(odd, even)`` an `HbfDecState`,
``(x,)`` an `HbfIntState`, ``(p,)`` a `LowpassState`, ``(x0, clamp)`` a
`ClampWrapState`, the PLL fields a `PllState`, ``(nco_phase, lp_i,
lp_q, pll)`` a `DdcBankState`, ``(nco_phase, bq, pll)`` a
`DdcBankBiquadState`, ``(combs, integrators, zoh)`` a
`CicState`, ``(dec, int_)`` a `RateConvState`, ``(prev_re, prev_im,
prev_valid, deemph)`` an `FmDiscState`, ``(hist_r, hist_i)`` a
`PlanesState` and ``(hist,)`` a channelizer `BankState`; ``(x, y)`` with
an int32 x and an int64 y is a `Df1WideState`, ``(xy, e)`` a
`Df1DitherState` (its u32 error word crosses as int64 in ``[0, 2**32)``
and comes back as uint32), ``(s,)`` a `Df2tState`; an int16 or int64
``(x, y)`` is a Q16 or Q64 `Df1State`, and an ``I128`` accumulator
crosses as `fxp.I128` (its uint64 low word held as the int64 bit
pattern) and comes back as ``(hi int64, lo uint64)``; tuples
(per-stage tails, cascade states, the ``(df1_state, dec_i, dec_q,
phase0)`` state of every `chain.DdcChain` mode, e.g. ``fold``'s single
tail and two-stage cascade) and lists (an SOS cascade's N `Df1State`s)
keep their structure and ``None`` stays ``None``.  `to_planes` makes
runtime coefficients (5,) or (5, c) the kernels' planes, and
`clamped_coeffs` carries a design `ClampedCoeffs` over.  Dtypes cross unchanged (the
PLL's clamp indicator stays int8, FM's validity bool, a float
`Df1State` f32).

The structures: ``(lp, hp, bp)`` is an `SvfState`, ``(x, ff, f, y)`` an
`RpllState`, ``(z,)`` a `WdfState` and ``(valid, value)`` a
`masked.Masked`; normal-form states are `Df1State`s already.  This
PyTorch's ``uint32`` has no add, shift or comparison, so the port's
`RpllState` holds the u32 words ``ff`` and ``f`` as int32 bit patterns:
a JAX ``uint32`` crosses as that view (``0xFFFFFFFF`` is -1) and comes
back as ``uint32``.
"""

from __future__ import annotations

import numpy as np
import torch

from .design.pid import ClampedCoeffs
from .fxp import I128
from .filters.biquad import Df1DitherState, Df1State, Df1WideState, Df2tState
from .filters.biquad_cuda import coef_planes
from .filters.cic import CicState
from .filters.fm_cuda import FmDiscState
from .filters.hbf import HbfDecState, HbfIntState
from .filters.lowpass import LowpassState
from .filters.pll import PllState
from .filters.rpll import RpllState
from .filters.svf import SvfState
from .filters.wdf import WdfState
from .masked import Masked
from .ops.unwrap import ClampWrapState
from .pipelines.channelizer import BankState, PlanesState
from .pipelines.ddc_bank import DdcBankBiquadState, DdcBankState
from .pipelines.rate_conversion import RateConvState

_STATES = {
    cls._fields: cls
    for cls in (Df1State, Df1DitherState, Df2tState, HbfDecState, HbfIntState, LowpassState,
                ClampWrapState, PllState, DdcBankState, DdcBankBiquadState,
                CicState, RateConvState, FmDiscState, PlanesState, BankState,
                SvfState, RpllState, WdfState, Masked)
}


def _is_wide(obj) -> bool:
    return (np.asarray(obj.x).dtype == np.int32
            and np.asarray(obj.y).dtype == np.int64)


def to_torch(obj, device):
    """Numpy arrays (in tuples, lists / state NamedTuples) -> port
    tensors."""
    if obj is None:
        return None
    if type(obj).__name__ == "I128":  # (hi int64, lo uint64) limbs
        return I128(*(to_torch(v, device) for v in obj))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = _STATES[tuple(obj._fields)]
        if cls is Df1State and _is_wide(obj):
            cls = Df1WideState
        if cls is RpllState:  # the u32 words as their int32 bit patterns
            return cls(*(to_torch(np.asarray(v).view(np.int32), device)
                         for v in obj))
        return cls(*(to_torch(v, device) for v in obj))
    if isinstance(obj, list):
        return [to_torch(v, device) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_torch(v, device) for v in obj)
    # np.array copies: the tensor owns writable memory
    a = np.array(obj)
    if a.dtype == np.uint32:  # torch's uint32 has few ops: int64 holds it
        a = a.astype(np.int64)
    elif a.dtype == np.uint64:  # an I128's low word: its bit pattern
        a = a.view(np.int64)
    return torch.from_numpy(a).to(device)


def to_planes(ba, c: int, device) -> torch.Tensor:
    """(5,) or (5, c) runtime coefficients -> (5, c) int32 planes."""
    return coef_planes(np.asarray(ba), c, device)


def clamped_coeffs(cc) -> ClampedCoeffs:
    """A JAX-side design `ClampedCoeffs` as the port's (numpy
    coefficients, the offset and limits as they are)."""
    return ClampedCoeffs(ba=np.array(cc.ba), u=cc.u, min=cc.min, max=cc.max)


def from_jax(ba_q, df1_state, tails, phase0, steps, device):
    """The JAX package's coefficients and chain state as port tensors.

    Args:
      ba_q: (5,) int32 Q<f> coefficients.
      df1_state: a `Df1State` of numpy arrays (x, y each (lanes, 2)).
      tails: per-stage tails — (3m-2, lanes) arrays from
        `hbf1_tail_init`, or `HbfDecState`s — or None.
      phase0, steps: (c,) int32 phase words.
      device: the torch device of the result.

    Returns (ba_q, df1_state, tails, phase0, steps) on ``device``.
    """
    return tuple(to_torch(v, device)
                 for v in (ba_q, df1_state, tails, phase0, steps))


def to_numpy(obj):
    """Port tensors (in tuples / state NamedTuples) -> numpy arrays."""
    if obj is None:
        return None
    if isinstance(obj, I128):  # the JAX package's (hi int64, lo uint64)
        return (to_numpy(obj.hi), to_numpy(obj.lo).view(np.uint64))
    if isinstance(obj, Df1DitherState):
        return Df1DitherState(to_numpy(obj.xy),
                              to_numpy(obj.e).astype(np.uint32))
    if isinstance(obj, RpllState):
        return RpllState(to_numpy(obj.x), to_numpy(obj.ff).view(np.uint32),
                         to_numpy(obj.f).view(np.uint32), to_numpy(obj.y))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, list):
        return [to_numpy(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_numpy(v) for v in obj)
    return obj.detach().cpu().numpy()
