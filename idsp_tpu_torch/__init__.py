"""idsp_tpu_torch — the DDC paths of `idsp_tpu` on PyTorch and CUDA.

A second package beside `idsp_tpu` (the JAX reference, which stays as
it is).  It carries two main paths with the same numerics and the same
public layouts:

* the headline DDC chain `bench.py` measures (`chain.DdcChain`) —
  per-channel conjugate NCO mix, Q32<29> DF1 biquad, three-stage
  half-band decimate-by-8;
* the BASELINE #5 DDC bank, Lowpass variant
  (`pipelines.ddc_bank.DdcBank`) — per-channel mix, `Lowpass<2>` on I
  and Q, keep 1 in d, `atan2`, per-channel PLL.

Layouts: time-major ``(t, 2c)`` lanes, I in ``[0, c)`` and Q in
``[c, 2c)``; ``Df1State.x/.y`` of shape ``(lanes, 2)``;
``LowpassState.p`` ``(lanes, N)`` int64; `PllState` with ``(c,)``
leaves; fused-cascade tails ``(3m-2, lanes)`` f32, ``2m-1`` odd rows
then ``m-1`` even rows per stage.

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

__all__ = ["accu", "cossin", "fastlo", "fxp", "luts", "trig"]

__version__ = "0.1.0"
