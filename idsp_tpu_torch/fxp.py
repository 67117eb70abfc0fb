"""Fixed-point (Q-format) tensor numerics.

Port of `idsp_tpu.fxp` (reference dsp-fixedpoint/src/lib.rs, ops.rs).
Q-format values are plain integer tensors plus a static fractional-bit
count ``f``:

* widening multiply, then a *truncating* arithmetic right shift
  (ops.rs:145-153, lib.rs:297-327);
* float -> Q encodes with round-half-away-from-zero and saturates
  (num_traits_impl.rs:30-62);
* wrapping two's-complement arithmetic, made explicit: an int8, int16 or
  int32 result is formed in int64 and brought back by a mask and a cast
  (`wrap32`, `wrap_i32`, `wrap_bits`), never by a narrow multiply that
  overflows.

The base types are int8, int16, int32 and int64 (``dtype=``, a torch or
numpy dtype), each with the accumulator twice its width.  int64 has no
wider torch dtype: its 128-bit accumulator is an `I128`, a pair of int64
tensors ``(hi, lo)`` whose ``lo`` holds the unsigned low word's bit
pattern, with the carries of the JAX package's ``(hi i64, lo u64)``
pair.  torch's uint64 has few CPU kernels, so the low word stays int64:
an unsigned compare is a compare of both sides with the sign bit
flipped, a logical right shift an arithmetic one and a mask.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_HALF32 = 1 << 31
_I64_MIN = -(2**63)

# base dtype -> (its width in bits, the accumulator dtype or None)
_INT_INFO = {
    torch.int8: (8, torch.int16),
    torch.int16: (16, torch.int32),
    torch.int32: (32, torch.int64),
    # int64's accumulator is the I128 limb pair, not a dtype
    torch.int64: (64, None),
}
_NP_TO_TORCH = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}


def as_dtype(dtype) -> torch.dtype:
    """A torch integer dtype from a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor into the int32 range,
    kept as int64 (the low 32 bits, sign-extended)."""
    return ((v + _HALF32) & _MASK32) - _HALF32


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an integer tensor to int32 (low 32 bits)."""
    return wrap32(v.to(torch.int64)).to(torch.int32)


def wrap_bits(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor into ``bits`` bits, kept
    as int64 (the low bits, sign-extended); 64 bits is the identity."""
    if bits >= 64:
        return v
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def widen_dtype(dtype) -> torch.dtype:
    """The accumulator dtype of a base integer dtype (int32 -> int64).

    Raises ValueError for int64: its accumulator is the `I128` limb pair
    (`mul_wide` returns one; `q_mul` handles it inside), not a dtype.
    """
    acc = _INT_INFO[as_dtype(dtype)][1]
    if acc is None:
        raise ValueError(
            "int64 has no native accumulator dtype; its 128-bit products"
            " are emulated in limbs (mul_wide returns a (hi, lo) pair)"
        )
    return acc


# --- the 128-bit accumulator of the int64 base ------------------------------


class I128(tuple):
    """A 128-bit accumulator: the pair ``(hi, lo)`` of int64 tensors,
    ``lo`` the unsigned low word's bit pattern.

    The int64 `mul_wide` returns this.  ``+``, ``-`` and unary ``-`` do
    the limb arithmetic with carries, as the JAX package's ``I128`` does:
    a bare tuple would concatenate under the accumulate-then-`quantize`
    pattern of every `mul_wide` call site.
    """

    __slots__ = ()

    def __new__(cls, hi, lo):
        return tuple.__new__(cls, (hi, lo))

    @property
    def hi(self):
        return self[0]

    @property
    def lo(self):
        return self[1]

    def __add__(self, other):
        return i128_add(self, other)

    __radd__ = __add__

    def __neg__(self):
        return i128_neg(self)

    def __sub__(self, other):
        return i128_add(self, i128_neg(other))

    def __rsub__(self, other):
        return i128_add(i128_neg(self), other)


def _ult(a, b):
    """Unsigned ``a < b`` of int64 bit patterns."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def _lsr(v, s: int):
    """Logical right shift of int64 bit patterns by 0 < s < 64."""
    return (v >> s) & ((1 << (64 - s)) - 1)


def i128_add(a, b):
    """Limb add of two ``(hi, lo)`` pairs with the carry out of the low
    word (accepts 0 for ``sum()``)."""
    if isinstance(b, int) and b == 0:
        return a if isinstance(a, I128) else I128(*a)
    if isinstance(a, int) and a == 0:
        return b if isinstance(b, I128) else I128(*b)
    ahi, alo = a
    bhi, blo = b
    lo = alo + blo
    return I128(ahi + bhi + _ult(lo, alo).to(torch.int64), lo)


def i128_neg(a):
    """Two's-complement negate of a ``(hi, lo)`` pair (accepts 0)."""
    if isinstance(a, int) and a == 0:
        return 0
    ahi, alo = a
    return I128(-ahi - (alo != 0).to(torch.int64), -alo)


def _mul_i64_wide(a, b):
    """Full signed 128-bit product of two int64 tensors as an `I128`.

    32-bit limbs of the unsigned product (each limb product exact mod
    2^64, the int64 bit pattern of the u64 one), then the two's-complement
    correction ``hi -= (a < 0 ? b : 0) + (b < 0 ? a : 0)``: the JAX
    package's `_mul_i64_wide`, step for step.
    """
    dev = _device(a, b)
    a = torch.as_tensor(a, dtype=torch.int64, device=dev)
    b = torch.as_tensor(b, dtype=torch.int64, device=dev)
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a & _MASK32, _lsr(a, 32)
    b0, b1 = b & _MASK32, _lsr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = _lsr(p00, 32) + (p01 & _MASK32) + (p10 & _MASK32)
    lo = (p00 & _MASK32) | (mid << 32)
    hi = p11 + _lsr(p01, 32) + _lsr(p10, 32) + _lsr(mid, 32)
    zero = torch.zeros_like(hi)
    hi = hi - torch.where(a < 0, b, zero) - torch.where(b < 0, a, zero)
    return I128(hi, lo)


def _shr_i128_to_i64(hi, lo, f: int):
    """Low 64 bits of the truncating arithmetic right shift of a ``(hi,
    lo)`` 128-bit value by ``f`` (negative: a left shift)."""
    if f == 0:
        return lo
    if f < 0:
        s = -f
        return lo << s if s < 64 else torch.zeros_like(lo)
    if f < 64:
        return _lsr(lo, f) | (hi << (64 - f))
    return hi >> min(f - 64, 63)


def shs(x, f: int):
    """Signed shift: positive ``f`` shifts left, negative shifts right
    (arithmetic, truncating toward -inf), `Shift::shs` (lib.rs:60-90)."""
    if f >= 0:
        return x << f
    return x >> (-f)


def _bits(dtype) -> int:
    return _INT_INFO[as_dtype(dtype)][0]


def _device(*vs):
    """The device of the first tensor among ``vs`` (None if none is): a
    Python int operand joins its tensor partner there."""
    return next((v.device for v in vs if isinstance(v, torch.Tensor)), None)


def _wide(v, device=None):
    """``v`` (a tensor or a Python int) as an int64 tensor."""
    return torch.as_tensor(v, device=device).to(torch.int64)


def mul_wide(a, b, *, dtype=torch.int32):
    """Widening multiply without the quantizing shift (``Q::mul_wide``,
    lib.rs:302-313).  int8/int16/int32: the product in the accumulator
    dtype (int16/int32/int64), exact; int64: the `I128` product, whose
    ``+`` is the carrying 128-bit add."""
    dtype = as_dtype(dtype)
    if dtype == torch.int64:
        return _mul_i64_wide(a, b)
    acc = widen_dtype(dtype)
    if acc == torch.int64:  # the int32 base: the product as it always ran
        return a.to(torch.int64) * b.to(torch.int64)
    dev = _device(a, b)
    return (_wide(a, dev) * _wide(b, dev)).to(acc)


def quantize(acc, f: int, *, dtype=torch.int32):
    """Accumulator -> base: truncating shift by ``f``, then wrap
    (``Q::quantize`` = ``trunc`` + ``down``, lib.rs:286-300).  The
    accumulator wraps in its own width first (a sum of int16 products
    wraps in int32); for int64 ``acc`` is the `I128` of `mul_wide`."""
    dtype = as_dtype(dtype)
    if dtype == torch.int64:
        hi, lo = acc
        return _shr_i128_to_i64(hi, lo, f)
    if dtype == torch.int32:
        return wrap_i32(shs(acc, -f))
    bits = _bits(dtype)
    v = wrap_bits(_wide(acc), 2 * bits)
    return wrap_bits(shs(v, -f), bits).to(dtype)


def q_mul(a, b, f: int, *, dtype=torch.int32):
    """``Q<f> * Q<f'> -> Q<f>``: the widened product, truncating ``>> f``,
    wrapped to ``dtype`` (ops.rs:145-153)."""
    return quantize(mul_wide(a, b, dtype=dtype), f, dtype=dtype)


def q_apply(c, x, f: int, *, dtype=torch.int32):
    """Apply Q-format gain ``c`` (f fractional bits) to raw integer
    ``x``: ``(c * x) >> f`` wrapped to ``dtype`` (lib.rs:315-327)."""
    return q_mul(c, x, f, dtype=dtype)


def _div_trunc(n, d):
    """Integer division truncating toward zero with XLA's answers where C
    has none: ``n / 0 == -1`` and ``INT64_MIN / -1 == INT64_MIN``."""
    zero = d == 0
    over = (n == _I64_MIN) & (d == -1)
    safe = torch.where(zero | over, torch.ones_like(d), d)
    q = torch.div(n, safe, rounding_mode="trunc")
    return torch.where(zero, torch.full_like(q, -1), q)


def q_div(a, b, f_rhs: int, *, dtype=torch.int32):
    """``Q<f> / Q<f1> -> Q<f>`` (ops.rs:163-178).

    For f1 > 0: widen the numerator, shift it left by f1 (wrapping in the
    accumulator), divide by the widened denominator, narrow.  For f1 <= 0:
    shift the numerator right by -f1 and divide in the base width.  The
    division truncates toward zero (Rust ``/``, ``lax.div``; torch's
    ``//`` floors).  int64 with f1 > 0 needs a 128-bit numerator and
    raises NotImplementedError, as the JAX package does.
    """
    dtype = as_dtype(dtype)
    bits = _bits(dtype)
    dev = _device(a, b)
    a = torch.as_tensor(a, device=dev).to(dtype).to(torch.int64)
    b = torch.as_tensor(b, device=dev).to(dtype).to(torch.int64)
    if f_rhs > 0:
        if dtype == torch.int64:
            raise NotImplementedError(
                "q_div with dtype=int64 and f_rhs > 0 needs a 128-bit "
                "numerator; rescale the operands or use f_rhs <= 0"
            )
        num = wrap_bits(shs(a, f_rhs), 2 * bits)
        q = wrap_bits(_div_trunc(num, b), 2 * bits)
    else:
        q = _div_trunc(shs(a, f_rhs), b)
    return wrap_bits(q, bits).to(dtype)


def q_sum(x, axis=None):
    """Sum of Q values: the raw bits summed, wrapping, at the same scale
    and dtype (ops.rs:219-224 ``iter::Sum``)."""
    x = torch.as_tensor(x)
    s = (x.to(torch.int64).sum() if axis is None
         else x.to(torch.int64).sum(dim=axis))
    return wrap_bits(s, _bits(x.dtype)).to(x.dtype)


def scale(x, f_from: int, f_to: int):
    """Rescale raw bits between fractional-bit counts (``Q::scale``,
    lib.rs:248-260): a truncating signed shift by ``f_to - f_from``, a
    left shift wrapping in the dtype."""
    x = torch.as_tensor(x)
    if x.dtype == torch.int64:
        return shs(x, f_to - f_from)
    return wrap_bits(shs(x.to(torch.int64), f_to - f_from),
                     _bits(x.dtype)).to(x.dtype)


def round_half_away(x):
    """Rust ``f64::round``: round half away from zero (numpy)."""
    return np.trunc(x + np.copysign(0.5, x))


def from_float(value, f: int, *, dtype=np.int32):
    """Encode float(s) as Q<f> bits with round-half-away-from-zero,
    saturating at the type bounds (NaN -> 0) like Rust's ``as`` casts
    (num_traits_impl.rs:30-45).  Returns a numpy array (static
    coefficient path).  The clip is against the bounds as float64, as
    the JAX package has it: int64's upper bound rounds to 2^63."""
    np_dtype = _np_dtype(dtype)
    info = np.iinfo(np_dtype)
    v = np.asarray(value, dtype=np.float64) * np.float64(2.0) ** f
    v = round_half_away(v)
    v = np.where(np.isnan(v), 0.0, v)
    v = np.clip(v, float(info.min), float(info.max))
    return v.astype(np_dtype)


def to_float(bits, f: int, *, float_dtype=torch.float64):
    """Exact Q<f> -> float scaling (``as_f64``, lib.rs:378-393)."""
    return torch.as_tensor(bits).to(float_dtype) * (2.0 ** -f)


def delta(f: int) -> float:
    """Step between adjacent representable values (``Q::DELTA``)."""
    return 2.0 ** -f


def q_min(dtype=torch.int32) -> int:
    return int(torch.iinfo(as_dtype(dtype)).min)


def q_max(dtype=torch.int32) -> int:
    return int(torch.iinfo(as_dtype(dtype)).max)


def saturating_neg_i32(x):
    """-x with i32::MIN saturating to i32::MAX (the atan2 octant fold,
    src/atan2.rs:67-79)."""
    return (-x.to(torch.int64)).clamp(max=2**31 - 1).to(torch.int32)


# --- wire formats (dsp-fixedpoint/src/serde.rs) ------------------------------


def _numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def q_to_wire(bits, f: int, *, mode: str = "raw"):
    """Serialize Q<f> raw bits for a config or checkpoint wire format
    (serde.rs:12-110): ``"raw"`` the raw integer bits, ``"f32"`` /
    ``"f64"`` the scaled float.  Returns a numpy array."""
    bits = np.asarray(_numpy(bits))
    if mode == "raw":
        return bits
    if mode == "f32":
        return (bits.astype(np.float64) * 2.0 ** -f).astype(np.float32)
    if mode == "f64":
        return bits.astype(np.float64) * 2.0 ** -f
    raise ValueError(f"unknown wire mode {mode!r}")


def q_from_wire(wire, f: int, *, mode: str = "raw", dtype=np.int32):
    """Deserialize a wire value back to Q<f> raw bits (numpy): raw mode
    wraps to the storage dtype; the float modes re-encode with
    round-half-away and saturation (serde.rs:42-110,
    num_traits_impl.rs:30-62)."""
    np_dtype = _np_dtype(dtype)
    wire = _numpy(wire)
    if mode == "raw":
        return np.asarray(wire).astype(np.int64).astype(np_dtype)
    if mode in ("f32", "f64"):
        return from_float(np.asarray(wire, np.float64), f, dtype=dtype)
    raise ValueError(f"unknown wire mode {mode!r}")
