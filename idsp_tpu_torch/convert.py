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
`PlanesState` and ``(hist,)`` a channelizer `BankState`; tuples
(per-stage tails, cascade states, the ``(df1_state, dec_i, dec_q,
phase0)`` state of every `chain.DdcChain` mode, e.g. ``fold``'s single
tail and two-stage cascade) keep their structure and ``None`` stays
``None``.  Dtypes cross unchanged (the
PLL's clamp indicator stays int8, FM's validity bool, a float
`Df1State` f32).
"""

from __future__ import annotations

import numpy as np
import torch

from .filters.biquad import Df1State
from .filters.cic import CicState
from .filters.fm_cuda import FmDiscState
from .filters.hbf import HbfDecState, HbfIntState
from .filters.lowpass import LowpassState
from .filters.pll import PllState
from .ops.unwrap import ClampWrapState
from .pipelines.channelizer import BankState, PlanesState
from .pipelines.ddc_bank import DdcBankBiquadState, DdcBankState
from .pipelines.rate_conversion import RateConvState

_STATES = {
    cls._fields: cls
    for cls in (Df1State, HbfDecState, HbfIntState, LowpassState,
                ClampWrapState, PllState, DdcBankState, DdcBankBiquadState,
                CicState, RateConvState, FmDiscState, PlanesState, BankState)
}


def to_torch(obj, device):
    """Numpy arrays (in tuples / state NamedTuples) -> port tensors."""
    if obj is None:
        return None
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = _STATES[tuple(obj._fields)]
        return cls(*(to_torch(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return tuple(to_torch(v, device) for v in obj)
    # np.array copies: the tensor owns writable memory
    return torch.from_numpy(np.array(obj)).to(device)


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
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return tuple(to_numpy(v) for v in obj)
    return obj.detach().cpu().numpy()
