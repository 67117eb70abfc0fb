"""The headline DDC chain as a module (port of `bench.py`'s
``make_chain``/``make_state``, bench.py:58-285).

Per block, a real wideband stream ``x (t,) int32`` and ``c`` channel
frequency words go through:

1. a per-channel conjugate NCO mix into ``2c`` I|Q lanes,
2. a Q32<29> DF1 biquad on every lane,
3. a three-stage half-band decimate-by-8 (taps HBF_TAPS[2], [1], [0]),

giving ``(t/8, 2c)`` f32.  Modes:

* ``scan`` — the oracle, all plain: `cossin` mix, `df1_process_q`,
  time-last `hbf_dec_cascade` per I and Q (bench.py:213-236).
* ``split`` — exact mix, K1 `df1_bank_q` (f32 out), time-major HBF.
* ``fused`` — K14 `ddc_mix_df1_bank` (the exact mix in the DF1 kernel,
  f32 out), time-major HBF; bit-identical to ``split``.
* ``fold`` — exact mix, K20 `df1_hbf1_bank` (DF1 + half-band stage 1),
  time-major HBF stages 2-3 (bench.py:151-173).
* ``fold2`` — exact mix, K21 `df1_hbf12_bank` (DF1 + stages 1-2),
  time-major HBF stage 3 (bench.py:125-150).
* ``fold3`` — exact mix, K2 `df1_hbf_cascade_bank`.
* ``fold3_fastlo`` — the plain fast-LO mix `fastlo_mix`, then K2
  (bench.py:81-99): SNR-gated, not bit-exact.
* ``fastlo_fused`` — K3 `fastlo_ddc_cascade_bank`: the whole chain in
  one kernel with the SNR-gated fast LO.

``scan``, ``split``, ``fused``, ``fold``, ``fold2`` and ``fold3`` carry
bit-identical integer state.  (bench.py's ``pallas`` mode, a TPU
experiment, is not ported.)
State is ``(df1_state, dec_i, dec_q, phase0)`` as in bench.py
(bench.py:240-285): ``fold`` carries the stage-1 tail in ``dec_q`` and
the two-stage `HbfDecState` cascade in ``dec_i``; ``fold2`` the stage-1
and stage-2 tails in ``dec_q`` and the stage-3 `HbfDecState` in
``dec_i``.  The output is ``(zi, zq)``, (c, t/8) each for ``scan`` and
(t/8, c) each otherwise.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .filters.biquad import df1_init, df1_process_q
from .filters.biquad_cuda import df1_bank_q
from .filters.ddc_cuda import (  # noqa: F401 (exact_mix: part of this API)
    ddc_mix_df1_bank,
    df1_hbf1_bank,
    df1_hbf12_bank,
    df1_hbf_cascade_bank,
    exact_mix,
    fastlo_ddc_cascade_bank,
    hbf1_tail_init,
)
from .filters.hbf import (
    HBF_TAPS,
    hbf_dec_block,
    hbf_dec_cascade,
    hbf_dec_cascade_init,
    hbf_dec_init,
)
from .ops import accu
from .ops.fastlo import fastlo_mix

MODES = ("scan", "split", "fused", "fold", "fold2", "fold3", "fold3_fastlo",
         "fastlo_fused")


class DdcChain(nn.Module):
    """Stateless chain step ``forward(state, x) -> (state, (zi, zq))``.

    Args:
      mode: one of `MODES`.
      steps: (c,) int32 channel frequency words; their device is the
        chain's device (a buffer: ``.to(device)`` moves it).
      ba_q: (5,) int32 Q<f> DF1 coefficients.
      f: fractional bits of ``ba_q``.
      time_chunk: chunk of the fused kernels (``fold``, ``fold2``,
        ``fold3``, ``fold3_fastlo``, ``fastlo_fused``); for
        ``fold3_fastlo`` and ``fastlo_fused`` also the fine-table length
        of the mix.
    """

    def __init__(self, mode: str, steps: torch.Tensor, ba_q, *, f: int = 29,
                 time_chunk: int = 128):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.register_buffer("steps", steps.to(torch.int32))
        self.ba_q = [int(v) for v in np.asarray(ba_q).reshape(-1)]
        self.f = f
        self.time_chunk = time_chunk

    def init_state(self):
        """Zero state for this mode (bench.py:240-285)."""
        c = self.steps.shape[0]
        dev = self.steps.device
        bq = df1_init((2 * c,), device=dev)
        phase0 = torch.zeros((c,), dtype=torch.int32, device=dev)
        if self.mode in ("fold3", "fold3_fastlo", "fastlo_fused"):
            tails = tuple(hbf1_tail_init(2 * c, m, device=dev)
                          for m in (5, 10, 23))
            return (bq, None, tails, phase0)
        if self.mode == "fold2":
            return (bq, hbf_dec_init(len(HBF_TAPS[0]), (2 * c,), axis=0,
                                     device=dev),
                    (hbf1_tail_init(2 * c, 5, device=dev),
                     hbf1_tail_init(2 * c, 10, device=dev)), phase0)
        if self.mode == "fold":
            return (bq, hbf_dec_cascade_init(2, (2 * c,), axis=0, device=dev),
                    hbf1_tail_init(2 * c, device=dev), phase0)
        if self.mode in ("split", "fused"):
            return (bq, hbf_dec_cascade_init(3, (2 * c,), axis=0, device=dev),
                    None, phase0)
        return (bq, hbf_dec_cascade_init(3, (c,), device=dev),
                hbf_dec_cascade_init(3, (c,), device=dev), phase0)

    def forward(self, state, x: torch.Tensor):
        bq_iq, dec_i, dec_q, phase0 = state
        c = self.steps.shape[0]
        t = x.shape[0]
        if self.mode == "fastlo_fused":
            bq_iq, tails, phase0, y8 = fastlo_ddc_cascade_bank(
                self.ba_q, bq_iq, dec_q, phase0, self.steps, x, self.f,
                time_chunk=self.time_chunk,
            )
            return (bq_iq, dec_i, tails, phase0), (y8[:, :c], y8[:, c:])
        if self.mode == "fused":
            bq_iq, phase0, yiq = ddc_mix_df1_bank(
                self.ba_q, bq_iq, phase0, self.steps, x, self.f,
                out_dtype=torch.float32)
            dec_i, ziq = hbf_dec_cascade(dec_i, yiq, axis=0)
            return (bq_iq, dec_i, dec_q, phase0), (ziq[:, :c], ziq[:, c:])
        if self.mode == "fold3_fastlo":
            miq = fastlo_mix(x, phase0, self.steps, self.time_chunk)
        else:
            miq = exact_mix(x, phase0, self.steps)
        phase0 = accu.advance(phase0, self.steps, t)
        if self.mode == "fold":
            bq_iq, tail, y2 = df1_hbf1_bank(self.ba_q, bq_iq, dec_q, miq,
                                            self.f,
                                            time_chunk=self.time_chunk)
            dec_i, ziq = hbf_dec_cascade(dec_i, y2, axis=0)
            return (bq_iq, dec_i, tail, phase0), (ziq[:, :c], ziq[:, c:])
        if self.mode == "fold2":
            bq_iq, tail1, tail2, y4 = df1_hbf12_bank(
                self.ba_q, bq_iq, *dec_q, miq, self.f,
                time_chunk=self.time_chunk)
            dec_i, ziq = hbf_dec_block(HBF_TAPS[0], dec_i, y4, axis=0)
            return ((bq_iq, dec_i, (tail1, tail2), phase0),
                    (ziq[:, :c], ziq[:, c:]))
        if self.mode in ("fold3", "fold3_fastlo"):
            bq_iq, tails, y8 = df1_hbf_cascade_bank(
                self.ba_q, bq_iq, dec_q, miq, self.f,
                time_chunk=self.time_chunk,
            )
            return (bq_iq, dec_i, tails, phase0), (y8[:, :c], y8[:, c:])
        if self.mode == "split":
            bq_iq, yiq = df1_bank_q(self.ba_q, bq_iq, miq, self.f,
                                    out_dtype=torch.float32)
            dec_i, ziq = hbf_dec_cascade(dec_i, yiq, axis=0)
            return (bq_iq, dec_i, dec_q, phase0), (ziq[:, :c], ziq[:, c:])
        bq_iq, yiq = df1_process_q(self.ba_q, self.f, bq_iq, miq)
        fi = yiq[:, :c].to(torch.float32).T  # (c, t) for the time-last HBF
        fq = yiq[:, c:].to(torch.float32).T
        dec_i, zi = hbf_dec_cascade(dec_i, fi)
        dec_q, zq = hbf_dec_cascade(dec_q, fq)
        return (bq_iq, dec_i, dec_q, phase0), (zi, zq)
