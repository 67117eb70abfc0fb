"""Multi-stage rate-conversion cascade, BASELINE config #4 (port of
`idsp_tpu.pipelines.rate_conversion`).

16x half-band decimation followed by 16x half-band interpolation, and a
CIC + half-band composite decimator for non-power-of-two factors, all
streaming with carried overlap-save tails.

* `round_trip` / `round_trip_t`: the round trip, time last or time-major
  ``(t, c)``; with ``use_kernel=True`` the time-major one runs K7
  `hbf_dec_cascade_bank` then K8 `hbf_int_cascade_bank`, with
  ``use_kernel="mxu"`` the banded-matrix cascades K22
  `hbf_dec_cascade_mxu` then K23 `hbf_int_cascade_mxu`.
* `cic_hbf_decimate` / `cic_hbf_decimate_t`: CIC by (rate+1), then the
  half-band cascade; with a true ``use_kernel`` (``"mxu"`` included, as
  in the JAX package) K9 `cic_dec_bank` then K7.
* `RoundTrip`: the time-major round trip as a module, modes ``scan``
  (the plain composition, the oracle), ``kernel`` (K7 then K8) and
  ``mxu`` (K22 then K23).

Quality gates (tests/test_rate_ddc_bank.py:11-54): a passband tone
survives the round trip at unity gain, content above the decimated
Nyquist is suppressed by >= 98 dB, the composite's DC gain is the CIC's
gain times 2 per half-band stage.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..filters import cic, hbf
from ..filters.cic_cuda import cic_dec_bank
from ..filters.hbf_cuda import hbf_dec_cascade_bank, hbf_int_cascade_bank
from ..filters.hbf_mxu import hbf_dec_cascade_mxu, hbf_int_cascade_mxu

MODES = ("scan", "kernel", "mxu")
_USE_KERNEL = {"scan": False, "kernel": True, "mxu": "mxu"}


class RateConvState(NamedTuple):
    dec: tuple  # half-band decimation cascade states (`HbfDecState`s)
    int_: tuple  # half-band interpolation cascade states (`HbfIntState`s)


def init(depth: int = 4, shape=(), dtype=torch.float32, taps=hbf.HBF_TAPS,
         *, device) -> RateConvState:
    """Time-last states (channels lead)."""
    return RateConvState(
        dec=hbf.hbf_dec_cascade_init(depth, shape, dtype, taps,
                                     device=device),
        int_=hbf.hbf_int_cascade_init(depth, shape, dtype, taps,
                                      device=device),
    )


def round_trip(state: RateConvState, x, taps=hbf.HBF_TAPS):
    """Decimate by 2**depth then interpolate back, (..., t) -> (..., t).

    The interpolator cascade has DC gain 2**depth; the output is divided
    by it, so the round trip is unity-gain in the passband.
    """
    depth = len(state.dec)
    st_dec, low = hbf.hbf_dec_cascade(state.dec, x, taps)
    st_int, y = hbf.hbf_int_cascade(state.int_, low, taps)
    return RateConvState(dec=st_dec, int_=st_int), y / (1 << depth)


def init_t(depth: int = 4, shape=(), dtype=torch.float32,
           taps=hbf.HBF_TAPS, *, device) -> RateConvState:
    """Time-major (t, c) states, for `round_trip_t`."""
    return RateConvState(
        dec=hbf.hbf_dec_cascade_init(depth, shape, dtype, taps, axis=0,
                                     device=device),
        int_=hbf.hbf_int_cascade_init(depth, shape, dtype, taps, axis=0,
                                      device=device),
    )


def round_trip_t(state: RateConvState, x, taps=hbf.HBF_TAPS, *,
                 use_kernel=False):
    """Time-major round trip: x (t, c) f32 -> (state, (t, c)).

    ``use_kernel=True`` runs the two cascades as K7 and K8 (one launch
    each way, the stages' intermediates on chip), ``"mxu"`` as K22 and
    K23 (the banded-matrix form, its outputs within 5e-5 of the scale of
    the others); ``False`` the plain stage-by-stage composition.
    """
    depth = len(state.dec)
    if use_kernel == "mxu":
        st_dec, low = hbf_dec_cascade_mxu(state.dec, x, taps=taps)
        st_int, y = hbf_int_cascade_mxu(state.int_, low, taps=taps)
    elif use_kernel:
        st_dec, low = hbf_dec_cascade_bank(state.dec, x, taps=taps)
        st_int, y = hbf_int_cascade_bank(state.int_, low, taps=taps)
    else:
        st_dec, low = hbf.hbf_dec_cascade(state.dec, x, taps, axis=0)
        st_int, y = hbf.hbf_int_cascade(state.int_, low, taps, axis=0)
    return RateConvState(dec=st_dec, int_=st_int), y / (1 << depth)


def group_delay(depth: int, taps=hbf.HBF_TAPS) -> int:
    """Total round-trip delay in input samples: each linear-phase stage
    delays by half its response length at its own rate."""
    d = 0.0
    # decimation stages run highest rate first: taps[depth-1] .. taps[0]
    rate = 1
    for i in range(depth):
        t = taps[depth - 1 - i]
        d += hbf.fir_len(len(t), False) / 2 * rate * 2
        rate *= 2
    # interpolation mirrors it
    rate = 1 << depth
    for i in range(depth):
        t = taps[i]
        d += hbf.fir_len(len(t), False) / 2 * rate / 2 * 2
        rate //= 2
    return int(round(d))


def cic_hbf_decimate(cic_state: cic.CicState, hbf_states, x, cic_rate: int,
                     hbf_depth: int, taps=hbf.HBF_TAPS):
    """Composite non-power-of-two decimator, time last: CIC by
    (cic_rate+1) first (wide transition band at the high rate), then the
    half-band cascade for the clean transition (hbf.rs:27).  ``hbf_depth``
    is ``len(hbf_states)``, kept for the JAX package's signature."""
    cic_state, mid = cic.decimate_block(cic_state, x, cic_rate)
    hbf_states, y = hbf.hbf_dec_cascade(hbf_states, mid.to(torch.float32),
                                        taps)
    return (cic_state, hbf_states), y


def cic_hbf_decimate_t(cic_state: cic.CicState, hbf_states, x,
                       cic_rate: int, hbf_depth: int, taps=hbf.HBF_TAPS, *,
                       use_kernel=False):
    """Time-major composite decimator, x (t, c) int32.

    ``use_kernel=True`` runs the CIC integrators as K9 and the half-band
    cascade as K7; the CIC leg is bit-identical to the plain path and so
    is the half-band leg on the card.  Any true ``use_kernel``, ``"mxu"``
    included, takes that path (as the JAX package does).
    """
    if use_kernel:
        cic_state, mid = cic_dec_bank(cic_state, x, cic_rate)
        hbf_states, y = hbf_dec_cascade_bank(
            hbf_states, mid.to(torch.float32), taps=taps)
    else:
        cic_state, mid = cic.decimate_block(cic_state, x, cic_rate, axis=0)
        hbf_states, y = hbf.hbf_dec_cascade(
            hbf_states, mid.to(torch.float32), taps, axis=0)
    return (cic_state, hbf_states), y


class RoundTrip(nn.Module):
    """Stateless time-major round trip ``forward(state, x) -> (state, y)``,
    x and y (t, lanes) f32, t a multiple of 2**depth.

    Args:
      mode: ``scan`` (the plain composition, the oracle), ``kernel`` (K7
        then K8) or ``mxu`` (K22 then K23).
      depth: half-band stages each way (2**depth down, then up).
      lanes: channels c.
      taps: the half-band tap table (`hbf.HBF_TAPS`, or
        `hbf.HBF_TAPS_98`).
      device: where `init_state` puts the state (the card unless the
        caller asks for another device).
    """

    def __init__(self, mode: str, depth: int = 4, lanes: int = 512, *,
                 taps=hbf.HBF_TAPS, device="cuda"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.depth = depth
        self.lanes = lanes
        self.taps = taps
        self.device = torch.device(device)

    def init_state(self) -> RateConvState:
        return init_t(self.depth, (self.lanes,), taps=self.taps,
                      device=self.device)

    def forward(self, state: RateConvState, x: torch.Tensor):
        return round_trip_t(state, x, self.taps,
                            use_kernel=_USE_KERNEL[self.mode])
