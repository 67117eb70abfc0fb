"""idsp_tpu_torch — the headline DDC chain of `idsp_tpu` on PyTorch and CUDA.

A second package beside `idsp_tpu` (the JAX reference, which stays as
it is).  It carries the main path `bench.py` measures — per-channel
conjugate NCO mix, Q32<29> DF1 biquad, three-stage half-band
decimate-by-8 — with the same numerics and the same public layouts:

* time-major ``(t, 2c)`` lanes, I in ``[0, c)`` and Q in ``[c, 2c)``;
* ``Df1State.x/.y`` of shape ``(lanes, 2)``;
* fused-cascade tails ``(3m-2, lanes)`` f32, ``2m-1`` odd rows then
  ``m-1`` even rows per stage.

Every Pallas kernel on that path is a hand-written CUDA C++ kernel
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
