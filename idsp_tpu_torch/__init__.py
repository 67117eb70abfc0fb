"""idsp_tpu_torch — the DDC, rate-conversion, FM, lock-in and
channelizer paths of `idsp_tpu` on PyTorch and CUDA.

A second package beside `idsp_tpu` (the JAX reference, which stays as
it is).  It carries these main paths with the same numerics and the same
public layouts:

* the headline DDC chain `bench.py` measures (`chain.DdcChain`, every
  mode of bench.py but its TPU-only ``pallas``) — per-channel conjugate
  NCO mix, Q32<29> DF1 biquad, three-stage half-band decimate-by-8 —
  and the anti-windup (clamped) DF1 of the reference's production
  biquad, alone (`df1_clamp_bank_q`) and fused with the cascade
  (`df1_clamp_hbf_cascade_bank`, the ``clamp=`` of the fast-LO kernels);
* the BASELINE #5 DDC bank (`pipelines.ddc_bank.DdcBank`, Lowpass
  variant, and `DdcBankBiquad`, Q<f> DF1 variant) — per-channel mix,
  the channel filter on I and Q, keep 1 in d, `atan2`, per-channel PLL;
* the BASELINE #4 rate conversion (`pipelines.rate_conversion`,
  `RoundTrip`) — half-band decimate by 16 then interpolate by 16, in
  the shift form (K7/K8) or the banded-matrix form
  (`hbf_dec_cascade_mxu`, `hbf_int_cascade_mxu`), and the CIC +
  half-band composite decimator;
* BASELINE #1, the FM discriminator bank (`pipelines.fm_disc`,
  `FmReceiver`) — conjugate product, atan2, carrier subtract, Q32<30>
  deemphasis DF1;
* BASELINE #2, the float lock-in DDC bank (`pipelines.ddc_lockin`,
  `DdcLockinBank`) — factored f32 LO mix, f32 DF1 on the I|Q lanes;
* BASELINE #3, the polyphase channelizer (`pipelines.channelizer`) —
  8-tap polyphase FIR over m-branch frames, DFT as matrix products or
  FFT;
* the Stabilizer IIR control path — the reference's Python surface
  (`compat`: `cossin`, `atan2`, the SOS cascade `sos` on K24
  `sos_bank_q`, the clamped wide-state stages `sos_clamp_wide` on K25
  `df1_wide_bank`), the coefficient design and control plane (`design`:
  cookbook `Filter`, `WebAudio`, `Pid`, `BiquadConfig`) and the
  runtime-coefficient DF1 banks (K26 `df1_bank_q_coef`, K27
  `df1_clamp_bank_q_coef`) that apply a retune without rebuilding;
* the rest of the reference's biquad precision ladder — Q16<13> (K28
  `df1_bank_q16`), Q64<61> (K29 `df1_bank_q64`, 128-bit sums on
  `fxp.I128`), f32 (K30 `df1_bank_f32`), the noise-shaping DF1 (K31
  `df1_dither_bank`) and the runtime-coefficient wide and dither banks
  (K32 `df1_wide_bank_coef`, K33 `df1_dither_bank_coef`);
* the filter structures beside the biquad and the Option-stream
  calculus they use (`masked`): the Chamberlin SVF (`filters.svf`, K34
  `svf_bank`), the normal-form section (`filters.normal`, K35
  `normal_bank_q`, K36 `normal_bank_f32`), the reciprocal PLL over
  masked timestamps (`filters.rpll`, K37 `rpll_bank`) and the
  wave-digital allpass chains and complementary pairs (`filters.wdf`, K38
  `wdf_bank`, K39 `wdf_chain_bank`, K40 `wdf_pair_bank`);
* the scale-out layer over `torch.distributed` (`parallel`): meshes,
  multi-process start-up, time-sharded halos (K41
  `halo_exchange_prev_rdma`, a CUDA IPC peer put), the sharded float and
  fixed-point DF1s and half-band decimator, channel sharding, pipelined
  SOS cascades, and the tensor-parallel `channelizer.channelize_tp`.

Layouts: time-major ``(t, 2c)`` lanes, I in ``[0, c)`` and Q in
``[c, 2c)``; ``Df1State.x/.y`` of shape ``(lanes, 2)``;
``LowpassState.p`` ``(lanes, N)`` int64; `PllState` with ``(c,)``
leaves; fused-cascade tails ``(3m-2, lanes)`` f32, ``2m-1`` odd rows
then ``m-1`` even rows per stage; `HbfIntState.x` ``(2m-1, lanes)``;
`CicState` with combs ``(c, N, M)``, integrators ``(c, N)`` and zoh
``(c,)``, all int32; `FmDiscState` with ``(c,)`` leaves; channelizer
`PlanesState` history planes ``(taps-1, m)`` f32; `SvfState` and
`RpllState` with ``(c,)`` leaves (the RPLL's u32 words as int32 bit
patterns); `WdfState.z` ``(c, N)`` int32.

Every Pallas kernel on those paths is a hand-written CUDA C++ kernel
(``csrc/*.cu``, built with nvcc for ``sm_90a`` at first use).  Each
kernel wrapper runs its plain PyTorch version for a CPU tensor and
launches the kernel (or raises) for a CUDA tensor.

Integer semantics: i32 x i32 products and accumulators in int64,
explicit wrap back to int32 (`fxp.wrap_i32`), truncating ``>> f``; the
int16 base sums in 32 bits, the int64 base in 128 (`fxp.I128`).

Importing this package imports torch and numpy only — never jax.
"""

from . import compat, design, fxp, luts, masked  # noqa: F401
from . import parallel  # noqa: F401
from .ops import accu, fastlo, trig  # noqa: F401
from .ops.trig import cossin  # noqa: F401
from .filters import cic, hbf, normal, rpll, svf, wdf  # noqa: F401
from .filters.biquad_cuda import (  # noqa: F401
    df1_bank_f32, df1_bank_q16, df1_bank_q64, df1_bank_q_coef,
    df1_bank_q_dec, df1_clamp_bank_q, df1_clamp_bank_q_coef,
    df1_dither_bank, df1_dither_bank_coef, df1_wide_bank,
    df1_wide_bank_coef, sos_bank_q,
)
from .filters.ddc_bank_cuda import (  # noqa: F401
    fastlo_ddc_bank_block, fastlo_df1_dec_bank,
)
from .filters.ddc_cuda import (  # noqa: F401
    ddc_mix_df1_bank, df1_clamp_hbf_cascade_bank, df1_hbf1_bank,
    df1_hbf12_bank,
)
from .filters.ddc_lockin_cuda import ddc_lockin_bank  # noqa: F401
from .filters.fm_cuda import fm_disc_bank  # noqa: F401
from .filters.normal_cuda import (  # noqa: F401
    normal_bank_f32, normal_bank_q,
)
from .filters.rpll_cuda import rpll_bank  # noqa: F401
from .filters.svf_cuda import svf_bank  # noqa: F401
from .filters.wdf_cuda import (  # noqa: F401
    wdf_bank, wdf_chain_bank, wdf_pair_bank,
)
from .filters.hbf_mxu import (  # noqa: F401
    hbf_dec_cascade_mxu, hbf_int_cascade_mxu,
)
from .pipelines import (  # noqa: F401
    channelizer, ddc_lockin, fm_disc, rate_conversion,
)
from .pipelines.channelizer_cuda import channelize_fused  # noqa: F401
from .pipelines.ddc_lockin import DdcLockinBank  # noqa: F401
from .pipelines.fm_disc import FmReceiver  # noqa: F401
from .pipelines.ddc_bank import (  # noqa: F401
    DdcBankBiquad, DdcBankBiquadState, init_biquad,
)
from .pipelines.rate_conversion import RoundTrip  # noqa: F401

__all__ = ["DdcBankBiquad", "DdcBankBiquadState", "DdcLockinBank",
           "FmReceiver", "RoundTrip", "accu", "channelize_fused",
           "channelizer", "cic", "compat", "cossin", "ddc_lockin",
           "ddc_lockin_bank", "ddc_mix_df1_bank", "design",
           "df1_bank_f32", "df1_bank_q16", "df1_bank_q64",
           "df1_bank_q_coef", "df1_bank_q_dec", "df1_clamp_bank_q",
           "df1_clamp_bank_q_coef", "df1_clamp_hbf_cascade_bank",
           "df1_dither_bank", "df1_dither_bank_coef", "df1_hbf12_bank",
           "df1_hbf1_bank", "df1_wide_bank", "df1_wide_bank_coef", "fastlo",
           "fastlo_ddc_bank_block", "fastlo_df1_dec_bank", "fm_disc",
           "fm_disc_bank", "fxp", "hbf", "hbf_dec_cascade_mxu",
           "hbf_int_cascade_mxu", "init_biquad", "luts", "masked",
           "normal", "normal_bank_f32", "normal_bank_q", "parallel",
           "rate_conversion",
           "rpll", "rpll_bank", "sos_bank_q", "svf", "svf_bank", "trig",
           "wdf", "wdf_bank", "wdf_chain_bank", "wdf_pair_bank"]

__version__ = "0.1.0"
