"""Port parity for the biquad precision ladder: the rest of `fxp` (the
`I128` accumulator of the int64 base, `q_div`, `q_sum`, `scale`, the wire
formats, ...), the int16 and int64 DF1 steps and cascades of
`filters.biquad`, and the plain versions of K28 `df1_bank_q16`, K29
`df1_bank_q64`, K30 `df1_bank_f32`, K31 `df1_dither_bank`, K32
`df1_wide_bank_coef` and K33 `df1_dither_bank_coef`, against `idsp_tpu`.

Integer results are held bit for bit: the JAX package's functions and
scans, its Pallas kernels in interpret mode (as tests/test_biquad_pallas.py
runs them), and the C golden model (`idsp_tpu.golden`,
native/golden.c) for Q16 and Q64.  The f32 DF1 is held bit for bit
against JAX's `df1_process` run under ``jax.disable_jit`` (jitted XLA may
contract a multiply-add into an FMA; eager PyTorch rounds each
operation), and within F32_ULPS ULP of the output scale against the
interpret-mode kernel, whose jitted body may contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu import fxp as jfxp
from idsp_tpu import golden
from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import biquad_pallas as jbp

from idsp_tpu_torch import fxp
from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.filters import biquad
from idsp_tpu_torch.filters.biquad_cuda import (
    df1_bank_f32,
    df1_bank_f32_plain,
    df1_bank_q16,
    df1_bank_q16_plain,
    df1_bank_q64,
    df1_bank_q64_plain,
    df1_dither_bank,
    df1_dither_bank_coef,
    df1_dither_bank_coef_plain,
    df1_dither_bank_plain,
    df1_wide_bank_coef,
    df1_wide_bank_coef_plain,
)

CPU = torch.device("cpu")
C, T, BLOCKS = 128, 192, 3
# jitted XLA contracts multiply-adds into FMAs: each step may differ by an
# ULP or two, which the feedback carries on (5 ULP seen at this shape);
# the repo's FMA gate of 16 ULP of the output scale, as the chain's
F32_ULPS = 16
I64_EDGES = np.array([0, 1, -1, 2, -2, 2**31, -(2**31), 2**32 - 1, 2**32,
                      -(2**32), 2**62, -(2**62), 2**63 - 1, -(2**63),
                      -(2**63) + 1, 0x5555555555555555, -0x5555555555555555],
                     dtype=np.int64)


def _i(rng, shape, bits, dtype=None):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
    a = rng.integers(lo, hi, size=shape, dtype=np.int64)
    return a.astype(dtype or f"int{bits}")


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    """Bit-for-bit equality of (nested) port tensors and JAX arrays."""
    for g, w in zip(jax.tree_util.tree_leaves(to_numpy(got)),
                    jax.tree_util.tree_leaves(want), strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _ba(fc, f, dtype, kind="lowpass"):
    ba5 = jbiquad.from_cookbook(getattr(JFilter().critical_frequency(fc),
                                        kind)())
    return jbiquad.quantize_ba(ba5, f, dtype=dtype)


def _u64(lo):
    return np.asarray(lo).view(np.uint64)


# --- fxp: the I128 accumulator -----------------------------------------------


def _pairs(rng, n):
    """(hi, lo) pairs with carries across the low word: random words and
    words near 0 and 2^64."""
    hi = rng.integers(-(2**63), 2**63, size=n, dtype=np.int64)
    lo = np.concatenate([
        rng.integers(-(2**63), 2**63, size=n - 8, dtype=np.int64),
        np.array([0, 1, -1, -2, 2**63 - 1, -(2**63), 5, -5], np.int64)])
    return hi, lo


def test_i128_add_neg_sub_equal_jax():
    rng = np.random.default_rng(1)
    ahi, alo = _pairs(rng, 64)
    bhi, blo = _pairs(rng, 64)
    bhi, blo = bhi[::-1].copy(), blo[::-1].copy()
    a, b = fxp.I128(_t(ahi), _t(alo)), fxp.I128(_t(bhi), _t(blo))
    ja = jfxp.I128(jnp.asarray(ahi), jnp.asarray(_u64(alo)))
    jb = jfxp.I128(jnp.asarray(bhi), jnp.asarray(_u64(blo)))
    for got, want in ((a + b, ja + jb), (a - b, ja - jb), (-a, -ja),
                      (b - a, jb - ja), (sum([a, b, a]), sum([ja, jb, ja])),
                      (0 - a, 0 - ja), (fxp.i128_add(0, (b.hi, b.lo)), jb)):
        assert isinstance(got, fxp.I128)
        _eq(got, tuple(want))
    assert fxp.i128_neg(0) == 0 and jfxp.i128_neg(0) == 0
    # the carry out of the low word, against Python integers
    s = to_numpy(a + b)
    for k in range(64):
        want = (((int(ahi[k]) + int(bhi[k])) << 64) + int(_u64(alo)[k])
                + int(_u64(blo)[k]))
        assert ((int(s[0][k]) << 64) + int(s[1][k]) - want) % 2**128 == 0


def test_mul_i64_wide_at_edges_equals_jax_and_python():
    rng = np.random.default_rng(2)
    a = np.concatenate([np.repeat(I64_EDGES, len(I64_EDGES)),
                        rng.integers(-(2**63), 2**63, 256, dtype=np.int64)])
    b = np.concatenate([np.tile(I64_EDGES, len(I64_EDGES)),
                        rng.integers(-(2**63), 2**63, 256, dtype=np.int64)])
    got = fxp._mul_i64_wide(_t(a), _t(b))
    _eq(got, tuple(jfxp._mul_i64_wide(jnp.asarray(a), jnp.asarray(b))))
    lo = _u64(got.lo.numpy())
    for k in range(len(a)):
        v = (int(got.hi[k]) << 64) | int(lo[k])
        assert v == int(a[k]) * int(b[k]), (a[k], b[k])


@pytest.mark.parametrize("f", [-3, 0, 31, 61, 64, 70, 63, 130])
def test_shr_i128_to_i64_equals_jax(f):
    rng = np.random.default_rng(3)
    hi, lo = _pairs(rng, 128)
    got = fxp._shr_i128_to_i64(_t(hi), _t(lo), f)
    want = jfxp._shr_i128_to_i64(jnp.asarray(hi), jnp.asarray(_u64(lo)), f)
    _eq(got, want)


def test_widen_dtype_and_bounds_equal_jax():
    for name in ("int8", "int16", "int32"):
        assert str(fxp.widen_dtype(getattr(torch, name))).removeprefix(
            "torch.") == jfxp.widen_dtype(getattr(jnp, name)).name
        assert fxp.widen_dtype(np.dtype(name)) == fxp.widen_dtype(
            getattr(torch, name))
    for mod in (torch, np):
        with pytest.raises(ValueError):
            fxp.widen_dtype(mod.int64)
    for name in ("int8", "int16", "int32", "int64"):
        assert fxp.q_min(getattr(torch, name)) == jfxp.q_min(getattr(jnp, name))
        assert fxp.q_max(getattr(torch, name)) == jfxp.q_max(getattr(jnp, name))
    assert fxp.q_min() == jfxp.q_min() and fxp.q_max() == jfxp.q_max()
    for f in (0, 13, 29, 61, -3):
        assert fxp.delta(f) == jfxp.delta(f)


@pytest.mark.parametrize("bits", [8, 16, 32, 64])
def test_q_mul_mul_wide_quantize_equal_jax(bits):
    rng = np.random.default_rng(4)
    a, b = _i(rng, 512, bits), _i(rng, 512, bits)
    if bits == 64:
        a[:len(I64_EDGES)] = I64_EDGES
        b[:len(I64_EDGES)] = I64_EDGES[::-1]
    td, jd = getattr(torch, f"int{bits}"), getattr(jnp, f"int{bits}")
    for f in (0, 1, bits // 2, bits - 3, bits + 5):
        _eq(fxp.q_mul(_t(a), _t(b), f, dtype=td),
            jfxp.q_mul(jnp.asarray(a), jnp.asarray(b), f, dtype=jd))
        _eq(fxp.q_apply(_t(a), _t(b), f, dtype=td),
            jfxp.q_apply(jnp.asarray(a), jnp.asarray(b), f, dtype=jd))
    wide = fxp.mul_wide(_t(a), _t(b), dtype=td)
    jwide = jfxp.mul_wide(jnp.asarray(a), jnp.asarray(b), dtype=jd)
    _eq(wide, tuple(jwide) if bits == 64 else jwide)
    # the accumulate-then-quantize MAC: three products summed, wrapping
    acc = wide + wide + wide
    jacc = jwide + jwide + jwide
    for f in (0, 3, bits - 1):
        _eq(fxp.quantize(acc, f, dtype=td), jfxp.quantize(jacc, f, dtype=jd))


@pytest.mark.parametrize("bits, f_rhs", [(16, 3), (16, 0), (16, -2),
                                         (32, 5), (32, 0), (32, -4),
                                         (64, 0), (64, -7)])
def test_q_div_truncates_toward_zero_as_jax(bits, f_rhs):
    rng = np.random.default_rng(5)
    a = _i(rng, 256, bits)
    b = _i(rng, 256, bits) >> (bits // 2)
    signs = np.array([7, -7, 7, -7, 0, 1, -1], np.int64)
    a[:7] = signs
    b[:7] = np.array([2, 2, -2, -2, 3, -3, 3], np.int64)
    a[7] = -(2 ** (bits - 1))
    b[7] = -1  # the one quotient that overflows: XLA's answer
    b[b == 0] = 1
    td, jd = getattr(torch, f"int{bits}"), getattr(jnp, f"int{bits}")
    _eq(fxp.q_div(_t(a), _t(b), f_rhs, dtype=td),
        jfxp.q_div(jnp.asarray(a), jnp.asarray(b), f_rhs, dtype=jd))


def test_q_div_int64_with_fraction_bits_raises():
    with pytest.raises(NotImplementedError):
        fxp.q_div(_t(np.array([1], np.int64)), _t(np.array([1], np.int64)),
                  3, dtype=torch.int64)
    with pytest.raises(NotImplementedError):
        jfxp.q_div(jnp.array([1], jnp.int64), jnp.array([1], jnp.int64), 3,
                   dtype=jnp.int64)


@pytest.mark.parametrize("bits", [8, 16, 32, 64])
def test_q_sum_scale_to_float_equal_jax(bits):
    rng = np.random.default_rng(6)
    x = _i(rng, (64, 8), bits)
    for axis in (None, 0, 1, -1):
        _eq(fxp.q_sum(_t(x), axis=axis), jfxp.q_sum(jnp.asarray(x), axis=axis))
    for f_from, f_to in ((29, 31), (31, 29), (13, 13), (0, bits - 1)):
        _eq(fxp.scale(_t(x), f_from, f_to),
            jfxp.scale(jnp.asarray(x), f_from, f_to))
    for fd, jfd in ((torch.float64, jnp.float64), (torch.float32,
                                                   jnp.float32)):
        for f in (0, 13, bits - 1):
            _eq(fxp.to_float(_t(x), f, float_dtype=fd),
                jfxp.to_float(jnp.asarray(x), f, float_dtype=jfd))


def test_saturating_neg_i32_equals_jax():
    rng = np.random.default_rng(7)
    x = _i(rng, 256, 32)
    x[:4] = [-(2**31), 2**31 - 1, 0, -1]
    _eq(fxp.saturating_neg_i32(_t(x)), jfxp.saturating_neg_i32(jnp.asarray(x)))


@pytest.mark.parametrize("bits", [16, 32, 64])
@pytest.mark.parametrize("mode", ["raw", "f32", "f64"])
def test_wire_round_trips_equal_jax(bits, mode):
    rng = np.random.default_rng(8)
    x = _i(rng, 128, bits)
    if bits == 64 and mode != "raw":
        x >>= 12  # exact in f64 below 2^53, as the wire note says
    f = bits - 3
    td, jd = getattr(torch, f"int{bits}"), getattr(jnp, f"int{bits}")
    w = fxp.q_to_wire(_t(x), f, mode=mode)
    jw = jfxp.q_to_wire(x, f, mode=mode)
    assert w.dtype == jw.dtype
    np.testing.assert_array_equal(w, jw)
    back = fxp.q_from_wire(w, f, mode=mode, dtype=td)
    np.testing.assert_array_equal(back, jfxp.q_from_wire(jw, f, mode=mode,
                                                         dtype=jd))
    if mode != "f32":
        np.testing.assert_array_equal(back, x)
    with pytest.raises(ValueError):
        fxp.q_to_wire(_t(x), f, mode="hex")
    with pytest.raises(ValueError):
        fxp.q_from_wire(w, f, mode="hex", dtype=td)


@pytest.mark.parametrize("dtype", ["int16", "int64"])
def test_from_float_saturates_as_jax(dtype):
    v = np.array([0.5, -0.5, 1.5, -2.5, 1e30, -1e30, np.nan, 3.999, -4.0,
                  0.9999999999], np.float64)
    for f in (0, 13, 61):
        got = fxp.from_float(v, f, dtype=getattr(torch, dtype))
        want = jfxp.from_float(v, f, dtype=getattr(jnp, dtype))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(biquad.quantize_ba(v, f, dtype=dtype),
                                      jbiquad.quantize_ba(v, f, dtype=dtype))


# --- filters.biquad: Q16 and Q64 -----------------------------------------------


def _jscan(step, st, xs):
    return jax.lax.scan(step, st, jnp.asarray(xs))


@pytest.mark.parametrize("per_lane", [False, True])
def test_df1_step_q_int16_equals_jax(per_lane):
    rng = np.random.default_rng(9)
    ba = (_i(rng, (C, 5), 16) >> 2 if per_lane
          else _ba(0.1, 13, np.int16))
    jst = jbiquad.Df1State(x=jnp.asarray(_i(rng, (C, 2), 16)),
                           y=jnp.asarray(_i(rng, (C, 2), 16)))
    st = to_torch(jst, CPU)
    for _ in range(2):
        xs = _i(rng, (64, C), 16)
        jst, jys = _jscan(lambda s, x: jbiquad.df1_step_q(
            jnp.asarray(ba), 13, s, x, dtype=jnp.int16), jst, xs)
        st, ys = biquad.process(lambda s, x: biquad.df1_step_q(
            ba, 13, s, x, dtype=torch.int16), st, _t(xs))
        _eq((st, ys), (jst, jys))


def test_df1_process_q16_equals_scan_and_golden():
    rng = np.random.default_rng(10)
    ba = _ba(0.1, 13, np.int16)
    x = _i(rng, 1024, 16)
    st0 = biquad.df1_init((), torch.int16, device=CPU)
    _, y = biquad.df1_process_q(ba, 13, st0, _t(x), dtype=torch.int16)
    _, yg = golden.biquad_df1_q16(ba, 13, np.zeros(4, np.int16), x)
    np.testing.assert_array_equal(y.numpy(), yg)
    st = biquad.Df1State(x=_t(_i(rng, (C, 2), 16)), y=_t(_i(rng, (C, 2), 16)))
    xs = _t(_i(rng, (T, C), 16))
    want = biquad.process(lambda s, v: biquad.df1_step_q(
        ba, 13, s, v, dtype=torch.int16), st, xs)
    got = biquad.df1_process_q(ba, 13, st, xs, dtype=torch.int16)
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        assert g.dtype == w.dtype == torch.int16
        assert torch.equal(g, w)


@pytest.mark.parametrize("coefs", ["lowpass", "full_range"])
def test_df1_process_q64_equals_jax_and_golden(coefs):
    rng = np.random.default_rng(11)
    if coefs == "lowpass":
        ba, f, top = _ba(0.02, 61, np.int64), 61, 62
    else:
        ba, f, top = rng.integers(-(2**63), 2**63, 5, dtype=np.int64), 47, 64
    jst = jbiquad.df1_init((C,), jnp.int64)
    st = to_torch(jst, CPU)
    for _ in range(2):
        xs = _i(rng, (96, C), top, np.int64)
        jst, jys = jbiquad.df1_process_q64(jnp.asarray(ba), f, jst,
                                           jnp.asarray(xs))
        st, ys = biquad.df1_process_q64(ba, f, st, _t(xs))
        _eq((st, ys), (jst, jys))
    x = _i(rng, 256, top, np.int64)
    _, y = biquad.df1_process_q64(ba, f, biquad.df1_init(
        (), torch.int64, device=CPU), _t(x))
    _, yg = golden.biquad_df1_q64(ba, f, np.zeros(4, np.int64), x)
    np.testing.assert_array_equal(y.numpy(), yg)
    # the step form, scanned
    st0 = biquad.df1_init((8,), torch.int64, device=CPU)
    xs = _i(rng, (16, 8), top, np.int64)
    got = biquad.process(lambda s, v: biquad.df1_step_q64(ba, f, s, v), st0,
                         _t(xs))
    want = _jscan(lambda s, v: jbiquad.df1_step_q64(jnp.asarray(ba), f, s, v),
                  jbiquad.df1_init((8,), jnp.int64), xs)
    _eq(got, want)


@pytest.mark.parametrize("bits, f", [(16, 13), (64, 61)])
def test_cascade_step_q_equals_jax(bits, f):
    rng = np.random.default_rng(12)
    dt = f"int{bits}"
    ba = np.stack([_ba(fc, f, dt) for fc in (0.05, 0.1, 0.2)])
    jst = jbiquad.cascade_init(3, (16,), getattr(jnp, dt))
    st = to_torch(jst, CPU)
    top = 14 if bits == 16 else 55
    xs = _i(rng, (48, 16), top + 1, dt)
    jst, jys = _jscan(lambda s, x: jbiquad.cascade_step_q(
        jnp.asarray(ba), f, s, x, dtype=getattr(jnp, dt)), jst, xs)
    st, ys = biquad.process(lambda s, x: biquad.cascade_step_q(
        ba, f, s, x, dtype=getattr(torch, dt)), st, _t(xs))
    _eq((st, ys), (jst, jys))


@pytest.mark.parametrize("clamp", [None, (99, -(2**26), 2**26)])
@pytest.mark.parametrize("per_lane", [False, True])
def test_df1_dither_process_equals_jax_scan(clamp, per_lane):
    rng = np.random.default_rng(13)
    ba = (_i(rng, (C, 5), 32) >> 2 if per_lane else _ba(0.1, 29, np.int32))
    jst = jbiquad.Df1DitherState(
        xy=jbiquad.Df1State(x=jnp.asarray(_i(rng, (C, 2), 32)),
                            y=jnp.asarray(_i(rng, (C, 2), 32))),
        e=jnp.asarray(rng.integers(0, 2**32, C, dtype=np.uint64).astype(
            np.uint32)))
    st = to_torch(jst, CPU)
    for _ in range(2):
        xs = _i(rng, (64, C), 32)
        if clamp is None:
            jst, jys = _jscan(lambda s, x: jbiquad.df1_dither_step(
                jnp.asarray(ba), 29, s, x), jst, xs)
        else:
            u, lo, hi = (jnp.int32(v) for v in clamp)
            jst, jys = _jscan(lambda s, x: jbiquad.df1_dither_clamp_step(
                jnp.asarray(ba), 29, s, x, u, lo, hi), jst, xs)
        st, ys = biquad.df1_dither_process(ba, 29, st, _t(xs), clamp=clamp)
        _eq((st, ys), (jst, jys))


# --- K28-K33 plain versions against the interpret-mode JAX kernels -----------


def _blocks(bank, jbank, st, jst, make_x, blocks=BLOCKS):
    """``bank`` (the port's wrapper, CPU tensors) against ``jbank`` (the
    JAX kernel) over carried blocks, bit for bit."""
    for _ in range(blocks):
        xs = make_x()
        jst, jys = jbank(jst, jnp.asarray(xs))
        st, ys = bank(st, _t(xs))
        _eq((st, ys), (jst, jys))
    return st


def test_df1_bank_q16_plain_equals_jax_kernel():
    rng = np.random.default_rng(14)
    ba = _ba(0.05, 13, np.int16)
    jst = jbiquad.Df1State(x=jnp.asarray(_i(rng, (C, 2), 16)),
                           y=jnp.asarray(_i(rng, (C, 2), 16)))
    _blocks(lambda s, x: df1_bank_q16(ba, s, x, 13),
            lambda s, x: jbp.df1_bank_q16(jnp.asarray(ba), s, x, 13,
                                          time_chunk=64, interpret=True),
            to_torch(jst, CPU), jst, lambda: _i(rng, (T, C), 16))


def test_df1_bank_q64_plain_equals_jax_kernel():
    rng = np.random.default_rng(15)
    ba = _ba(0.05, 61, np.int64)
    jst = jbiquad.Df1State(x=jnp.asarray(_i(rng, (C, 2), 56, np.int64)),
                           y=jnp.asarray(_i(rng, (C, 2), 56, np.int64)))
    _blocks(lambda s, x: df1_bank_q64(ba, s, x, 61),
            lambda s, x: jbp.df1_bank_q64(jnp.asarray(ba), s, x, 61,
                                          time_chunk=64, interpret=True),
            to_torch(jst, CPU), jst, lambda: _i(rng, (64, C), 56, np.int64))


def test_df1_bank_f32_plain_equals_jax_df1_process_and_kernel():
    rng = np.random.default_rng(16)
    ba5 = np.asarray(jbiquad.from_cookbook(
        JFilter().critical_frequency(0.1).lowpass()))
    ba32 = ba5.astype(np.float32)
    jst = jbiquad.Df1State(
        x=jnp.asarray(rng.normal(size=(C, 2)).astype(np.float32)),
        y=jnp.asarray(rng.normal(size=(C, 2)).astype(np.float32)))
    st, kst = to_torch(jst, CPU), jst
    for _ in range(BLOCKS):
        xs = rng.normal(size=(T, C)).astype(np.float32)
        with jax.disable_jit():
            jst, jys = jbiquad.df1_process(jnp.asarray(ba32), jst,
                                           jnp.asarray(xs))
        kst, kys = jbp.df1_bank_f32(ba5, kst, jnp.asarray(xs),
                                    time_chunk=64, interpret=True)
        st, ys = df1_bank_f32(ba5, st, _t(xs))
        _eq((st, ys), (jst, jys))
        scale = float(np.abs(np.asarray(kys)).max())
        bound = F32_ULPS * float(np.spacing(np.float32(scale)))
        assert np.abs(ys.numpy() - np.asarray(kys)).max() <= bound
        # the kernel's state follows its own outputs: compare it, then
        # carry each side's own
        assert np.abs(to_numpy(st).y - np.asarray(kst.y)).max() <= bound


@pytest.mark.parametrize("clamp", [None, (99, -(2**26), 2**26)])
def test_df1_dither_bank_plain_equals_jax_kernel(clamp):
    rng = np.random.default_rng(17)
    ba = _ba(0.1, 29, np.int32)
    jst = jbiquad.Df1DitherState(
        xy=jbiquad.Df1State(x=jnp.asarray(_i(rng, (C, 2), 32)),
                            y=jnp.asarray(_i(rng, (C, 2), 32))),
        e=jnp.asarray(rng.integers(0, 2**32, C, dtype=np.uint64).astype(
            np.uint32)))
    _blocks(lambda s, x: df1_dither_bank(ba, s, x, 29, clamp=clamp),
            lambda s, x: jbp.df1_dither_bank(jnp.asarray(ba), s, x, 29,
                                             clamp=clamp, time_chunk=64,
                                             interpret=True),
            to_torch(jst, CPU), jst, lambda: _i(rng, (T, C), 32))


def _planes(rng, shared):
    if shared:
        return _ba(0.1, 29, np.int32)
    fcs = rng.uniform(0.01, 0.3, C)
    return np.stack([_ba(fc, 29, np.int32) for fc in fcs], axis=1)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("clamp", [None, (-5, -(2**27), 2**27)])
def test_df1_wide_bank_coef_plain_equals_jax_kernel(shared, clamp):
    rng = np.random.default_rng(18)
    planes = _planes(rng, shared)
    jst = jbiquad.Df1WideState(
        x=jnp.asarray(_i(rng, (C, 2), 32)),
        y=jnp.asarray(rng.integers(-(2**62), 2**62, (C, 2), dtype=np.int64)))
    _blocks(lambda s, x: df1_wide_bank_coef(_t(planes), s, x, 29,
                                            clamp=clamp),
            lambda s, x: jbp.df1_wide_bank_coef(jnp.asarray(planes), s, x,
                                                29, clamp=clamp,
                                                time_chunk=64, interpret=True),
            to_torch(jst, CPU), jst, lambda: _i(rng, (T, C), 32))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("clamp", [None, (-5, -(2**27), 2**27)])
def test_df1_dither_bank_coef_plain_equals_jax_kernel(shared, clamp):
    rng = np.random.default_rng(19)
    planes = _planes(rng, shared)
    jst = jbiquad.Df1DitherState(
        xy=jbiquad.Df1State(x=jnp.asarray(_i(rng, (C, 2), 32)),
                            y=jnp.asarray(_i(rng, (C, 2), 32))),
        e=jnp.asarray(rng.integers(0, 2**32, C, dtype=np.uint64).astype(
            np.uint32)))
    _blocks(lambda s, x: df1_dither_bank_coef(planes, s, x, 29, clamp=clamp),
            lambda s, x: jbp.df1_dither_bank_coef(jnp.asarray(planes), s, x,
                                                  29, clamp=clamp,
                                                  time_chunk=64,
                                                  interpret=True),
            to_torch(jst, CPU), jst, lambda: _i(rng, (T, C), 32))


def test_coef_banks_with_a_shared_set_equal_their_static_twins():
    rng = np.random.default_rng(20)
    ba = _ba(0.1, 29, np.int32)
    xs = _t(_i(rng, (T, C), 32))
    wide = biquad.Df1WideState(x=_t(_i(rng, (C, 2), 32)),
                               y=_t(rng.integers(-(2**62), 2**62, (C, 2))))
    dither = biquad.Df1DitherState(
        xy=biquad.Df1State(x=_t(_i(rng, (C, 2), 32)),
                           y=_t(_i(rng, (C, 2), 32))),
        e=_t(rng.integers(0, 2**32, C)))
    from idsp_tpu_torch.filters.biquad_cuda import df1_wide_bank

    for clamp in (None, (7, -(2**25), 2**25)):
        for got, want in (
                (df1_wide_bank_coef(ba, wide, xs, 29, clamp=clamp),
                 df1_wide_bank(ba, wide, xs, 29, clamp=clamp)),
                (df1_dither_bank_coef(ba, dither, xs, 29, clamp=clamp),
                 df1_dither_bank(ba, dither, xs, 29, clamp=clamp))):
            for g, w in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                assert torch.equal(g, w)


def test_plain_versions_keep_the_input_device():
    """Every result of the plain versions lies on the input's device, with
    coefficients given as numpy (Python ints inside): checked on the meta
    device, which runs the same ops without values."""
    meta = torch.device("meta")
    c, t = 8, 4

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=meta)

    planes = np.ones((5, c), np.int32)
    dither = biquad.Df1DitherState(
        xy=biquad.Df1State(x=z((c, 2), torch.int32), y=z((c, 2),
                                                         torch.int32)),
        e=z((c,), torch.int64))
    wide = biquad.Df1WideState(x=z((c, 2), torch.int32),
                               y=z((c, 2), torch.int64))
    outs = [
        df1_bank_q16_plain(_ba(0.1, 13, np.int16), biquad.Df1State(
            x=z((c, 2), torch.int16), y=z((c, 2), torch.int16)),
            z((t, c), torch.int16)),
        df1_bank_q64_plain(_ba(0.1, 61, np.int64), biquad.Df1State(
            x=z((c, 2), torch.int64), y=z((c, 2), torch.int64)),
            z((t, c), torch.int64)),
        df1_bank_f32_plain(np.ones(5), biquad.Df1State(
            x=z((c, 2), torch.float32), y=z((c, 2), torch.float32)),
            z((t, c), torch.float32)),
        df1_dither_bank_plain(_ba(0.1, 29, np.int32), dither,
                        z((t, c), torch.int32), clamp=(0, -9, 9)),
        df1_dither_bank_coef_plain(planes, dither, z((t, c), torch.int32)),
        df1_wide_bank_coef_plain(planes, wide, z((t, c), torch.int32)),
        biquad.cascade_step_q(np.ones((2, 5), np.int64), 61,
                              biquad.cascade_init(2, (c,), torch.int64,
                                                  device=meta),
                              z((c,), torch.int64), dtype=torch.int64),
        fxp.q_div(7, z((c,), torch.int32), 3),
        fxp.mul_wide(3, z((c,), torch.int16), dtype=torch.int16),
    ]
    for leaf in jax.tree_util.tree_leaves(outs):
        assert leaf.device == meta


def test_precision_banks_reject_bad_input():
    st16 = biquad.df1_init((C,), torch.int16, device=CPU)
    st64 = biquad.df1_init((C,), torch.int64, device=CPU)
    x16 = torch.zeros((4, C), dtype=torch.int16)
    x64 = torch.zeros((4, C), dtype=torch.int64)
    with pytest.raises(ValueError):  # Q64: 32 < f < 64
        df1_bank_q64(_ba(0.1, 61, np.int64), st64, x64, 20)
    with pytest.raises(ValueError):  # Q16: 0 < f < 32
        df1_bank_q16(_ba(0.1, 13, np.int16), st16, x16, 32)
    dither = biquad.df1_dither_init((C,), device=CPU)
    x32 = torch.zeros((4, C), dtype=torch.int32)
    with pytest.raises(ValueError):  # the shift 32 - f
        df1_dither_bank(_ba(0.1, 29, np.int32), dither, x32, 33)
    with pytest.raises(ValueError):  # planes (5,) or (5, c)
        df1_dither_bank_coef(np.zeros((5, C - 1), np.int32), dither, x32, 29)
    with pytest.raises(ValueError):
        df1_wide_bank_coef(np.zeros((4,), np.int32),
                           biquad.df1_wide_init((C,), device=CPU), x32, 29)


# --- convert -----------------------------------------------------------------


def test_convert_round_trips_precision_states():
    rng = np.random.default_rng(21)
    q16 = jbiquad.Df1State(x=jnp.asarray(_i(rng, (C, 2), 16)),
                           y=jnp.asarray(_i(rng, (C, 2), 16)))
    q64 = jbiquad.Df1State(x=jnp.asarray(_i(rng, (C, 2), 64)),
                           y=jnp.asarray(_i(rng, (C, 2), 64)))
    dither = jbiquad.Df1DitherState(
        xy=jbiquad.Df1State(x=jnp.asarray(_i(rng, (C, 2), 32)),
                            y=jnp.asarray(_i(rng, (C, 2), 32))),
        e=jnp.asarray(np.array([0, 1, 2**32 - 1] + [2**31] * (C - 3),
                               np.uint32)))
    for st, cls, dt in ((q16, biquad.Df1State, torch.int16),
                        (q64, biquad.Df1State, torch.int64),
                        (dither, biquad.Df1DitherState, torch.int32)):
        got = to_torch(st, CPU)
        assert type(got) is cls  # a Q64 state is not a wide one
        assert jax.tree_util.tree_leaves(got)[0].dtype == dt
        _eq(got, st)
    assert to_torch(dither, CPU).e.dtype == torch.int64
    assert to_numpy(to_torch(dither, CPU)).e.dtype == np.uint32
    # an I128 crosses as (hi int64, lo uint64) and back
    hi, lo = _pairs(rng, 16)
    j = jfxp.I128(jnp.asarray(hi), jnp.asarray(_u64(lo)))
    p = to_torch(j, CPU)
    assert isinstance(p, fxp.I128) and p.lo.dtype == torch.int64
    back = to_numpy(p)
    assert back[1].dtype == np.uint64
    _eq(p, tuple(j))
    np.testing.assert_array_equal(back[1], np.asarray(j.lo))
