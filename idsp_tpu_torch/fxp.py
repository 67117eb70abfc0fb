"""Fixed-point (Q-format) tensor numerics, int32 base.

Port of the int32 part of `idsp_tpu.fxp` (reference
dsp-fixedpoint/src/lib.rs, ops.rs).  Q-format values are plain integer
tensors plus a static fractional-bit count ``f``:

* widening multiply in int64, then a *truncating* arithmetic right
  shift (ops.rs:145-153, lib.rs:297-327);
* float -> Q encodes with round-half-away-from-zero and saturates
  (num_traits_impl.rs:30-62);
* wrapping two's-complement arithmetic, made explicit: results are
  brought back to int32 by `wrap_i32` (mask and cast), never by an
  int32 multiply that overflows.

The int64 base (the I128 limb accumulator) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_HALF32 = 1 << 31


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor into the int32 range,
    kept as int64 (the low 32 bits, sign-extended)."""
    return ((v + _HALF32) & _MASK32) - _HALF32


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an integer tensor to int32 (low 32 bits)."""
    return wrap32(v.to(torch.int64)).to(torch.int32)


def shs(x, f: int):
    """Signed shift: positive ``f`` shifts left, negative shifts right
    (arithmetic, truncating toward -inf), `Shift::shs` (lib.rs:60-90)."""
    if f >= 0:
        return x << f
    return x >> (-f)


def mul_wide(a, b):
    """Widening i32 x i32 -> int64 product without the quantizing shift
    (``Q::mul_wide``, lib.rs:302-313)."""
    return a.to(torch.int64) * b.to(torch.int64)


def quantize(acc, f: int):
    """int64 accumulator -> int32: truncating shift by ``f``, then wrap
    (``Q::quantize``, lib.rs:286-300)."""
    return wrap_i32(shs(acc, -f))


def q_mul(a, b, f: int):
    """``Q<f> * Q<f'> -> Q<f>``: int64 product, truncating ``>> f``,
    wrap to int32 (ops.rs:145-153)."""
    return quantize(mul_wide(a, b), f)


def q_apply(c, x, f: int):
    """Apply Q-format gain ``c`` (f fractional bits) to raw integer
    ``x``: ``(c * x) >> f`` wrapped to int32 (lib.rs:315-327)."""
    return q_mul(c, x, f)


def round_half_away(x):
    """Rust ``f64::round``: round half away from zero (numpy)."""
    return np.trunc(x + np.copysign(0.5, x))


def from_float(value, f: int, *, dtype=np.int32):
    """Encode float(s) as Q<f> bits with round-half-away-from-zero,
    saturating at the type bounds (NaN -> 0) like Rust's ``as`` casts
    (num_traits_impl.rs:30-45).  Returns a numpy array (static
    coefficient path)."""
    np_dtype = np.dtype(dtype)
    info = np.iinfo(np_dtype)
    v = np.asarray(value, dtype=np.float64) * np.float64(2.0) ** f
    v = round_half_away(v)
    v = np.where(np.isnan(v), 0.0, v)
    v = np.clip(v, float(info.min), float(info.max))
    return v.astype(np_dtype)
