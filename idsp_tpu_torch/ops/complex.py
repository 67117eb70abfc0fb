"""Complex arithmetic on (re, im) pairs (port of `idsp_tpu.ops.complex`,
reference src/complex.rs).

Complex tensors are (re, im) tuples of real tensors.  The fixed-point
late-quantize multiply (complex.rs:117-153) is the hot path of the FM
discriminator: i32 operands, int64 products and sums (wrapping), one
truncating shift at the end, wrapped to int32.
"""

from __future__ import annotations

import torch

from .. import fxp
from .trig import atan2, cossin


def mul(a_re, a_im, b_re, b_im):
    """True complex multiply, elementwise (complex.rs:106-115)."""
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


def conj(re, im):
    return re, -im


def mul_q(a_re, a_im, b_re, b_im, f: int):
    """Mixed ``Complex<Q<f>> * Complex<T>`` late-quantize multiply
    (complex.rs:117-134): the four products accumulate in int64
    (wrapping), the truncating ``>> f`` happens once per component.
    Returns int32 (re, im)."""
    ar = fxp.mul_wide(a_re, b_re)
    ai = fxp.mul_wide(a_im, b_im)
    br = fxp.mul_wide(a_re, b_im)
    bi = fxp.mul_wide(a_im, b_re)
    return fxp.quantize(ar - ai, f), fxp.quantize(br + bi, f)


def norm_sqr_i32(re, im):
    """|z|^2 of int32 parts as int64 (complex.rs:204-217); 2^63 wraps to
    -2^63 as in the JAX package."""
    re = re.to(torch.int64)
    im = im.to(torch.int64)
    return re * re + im * im


def from_angle_i32(angle):
    """Unit complex from a wrapping int32 angle via the DDS
    (complex.rs:237-240)."""
    return cossin(angle)


def arg_i32(re, im):
    """Angle of (re, im), int32 circle convention 1<<31 == pi
    (complex.rs:254-256)."""
    return atan2(im, re)


# --- float helpers (complex.rs:173-202) -------------------------------------


def from_angle(angle):
    """Unit complex from a float angle in radians."""
    return torch.cos(angle), torch.sin(angle)


def arg(re, im):
    """Float angle of (re, im)."""
    return torch.atan2(im, re)


def norm_sqr(re, im):
    return re * re + im * im


def div(a_re, a_im, b_re, b_im):
    """Complex division via conjugate multiply (complex.rs:193-198)."""
    n = norm_sqr(b_re, b_im)
    rr, ri = mul(a_re, a_im, b_re, -b_im)
    return rr / n, ri / n


def ilog2_i32(re, im):
    """Integer log2 of |z|^2 (complex.rs:219-224): the position of the
    highest set bit of the int64 `norm_sqr_i32` read as u64, -1 for 0.

    torch has no count-leading-zeros, so this is a binary search over
    the bit position on int64: a negative value (|z|^2 = 2^63 wrapped)
    has bit 63 set."""
    ns = norm_sqr_i32(re, im)
    v = ns.clamp(min=0)
    r = torch.zeros_like(ns)
    for s in (32, 16, 8, 4, 2, 1):
        hi = (v >> s) != 0
        r = torch.where(hi, r + s, r)
        v = torch.where(hi, v >> s, v)
    r = torch.where(ns == 0, -1, r)
    return torch.where(ns < 0, 63, r).to(torch.int32)
