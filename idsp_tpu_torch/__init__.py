"""idsp_tpu_torch — the DDC and rate-conversion paths of `idsp_tpu` on
PyTorch and CUDA.

A second package beside `idsp_tpu` (the JAX reference, which stays as
it is).  It carries three main paths with the same numerics and the same
public layouts:

* the headline DDC chain `bench.py` measures (`chain.DdcChain`) —
  per-channel conjugate NCO mix, Q32<29> DF1 biquad, three-stage
  half-band decimate-by-8;
* the BASELINE #5 DDC bank (`pipelines.ddc_bank.DdcBank`, Lowpass
  variant, and `DdcBankBiquad`, Q<f> DF1 variant) — per-channel mix,
  the channel filter on I and Q, keep 1 in d, `atan2`, per-channel PLL;
* the BASELINE #4 rate conversion (`pipelines.rate_conversion`,
  `RoundTrip`) — half-band decimate by 16 then interpolate by 16, and
  the CIC + half-band composite decimator.

Layouts: time-major ``(t, 2c)`` lanes, I in ``[0, c)`` and Q in
``[c, 2c)``; ``Df1State.x/.y`` of shape ``(lanes, 2)``;
``LowpassState.p`` ``(lanes, N)`` int64; `PllState` with ``(c,)``
leaves; fused-cascade tails ``(3m-2, lanes)`` f32, ``2m-1`` odd rows
then ``m-1`` even rows per stage; `HbfIntState.x` ``(2m-1, lanes)``;
`CicState` with combs ``(c, N, M)``, integrators ``(c, N)`` and zoh
``(c,)``, all int32.

Every Pallas kernel on those paths is a hand-written CUDA C++ kernel
(``csrc/*.cu``, built with nvcc for ``sm_90a`` at first use).  Each
kernel wrapper runs its plain PyTorch version for a CPU tensor and
launches the kernel (or raises) for a CUDA tensor.

Integer semantics: i32 x i32 products and accumulators in int64,
explicit wrap back to int32 (`fxp.wrap_i32`), truncating ``>> f``.

Importing this package imports torch and numpy only — never jax.
"""

from . import fxp, luts  # noqa: F401
from .ops import accu, fastlo, trig  # noqa: F401
from .ops.trig import cossin  # noqa: F401
from .filters import cic, hbf  # noqa: F401
from .filters.biquad_cuda import df1_bank_q_dec  # noqa: F401
from .filters.ddc_bank_cuda import (  # noqa: F401
    fastlo_ddc_bank_block, fastlo_df1_dec_bank,
)
from .filters.ddc_cuda import ddc_mix_df1_bank  # noqa: F401
from .pipelines import rate_conversion  # noqa: F401
from .pipelines.ddc_bank import (  # noqa: F401
    DdcBankBiquad, DdcBankBiquadState, init_biquad,
)
from .pipelines.rate_conversion import RoundTrip  # noqa: F401

__all__ = ["DdcBankBiquad", "DdcBankBiquadState", "RoundTrip", "accu", "cic",
           "cossin", "ddc_mix_df1_bank", "df1_bank_q_dec", "fastlo",
           "fastlo_ddc_bank_block", "fastlo_df1_dec_bank", "fxp", "hbf",
           "init_biquad", "luts", "rate_conversion", "trig"]

__version__ = "0.1.0"
