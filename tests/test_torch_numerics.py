"""Port parity: fixed-point numerics, NCO, coefficients, fast-LO tables.

Each case feeds the same numpy input (from ``default_rng(seed)``) to
`idsp_tpu` and `idsp_tpu_torch` and compares: integer paths bit for
bit, the f32 fast-LO tables to a measured ULP bound.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu import fxp as jfxp
from idsp_tpu import luts as jluts
from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import hbf as jhbf
from idsp_tpu.ops import accu as jaccu
from idsp_tpu.ops import fastlo as jfastlo
from idsp_tpu.ops.trig import cossin as jcossin

from idsp_tpu_torch import fxp, luts, profiling
from idsp_tpu_torch.design import DesignError, Filter
from idsp_tpu_torch.filters import biquad, hbf
from idsp_tpu_torch.ops import accu, fastlo
from idsp_tpu_torch.ops.trig import cossin


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_import_leaves_jax_out():
    code = ("import sys, idsp_tpu_torch, idsp_tpu_torch.chain, "
            "idsp_tpu_torch.convert, idsp_tpu_torch.profiling, "
            "idsp_tpu_torch.pipelines.ddc_bank, "
            "idsp_tpu_torch.filters.ddc_bank_cuda; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_union_length_and_timers_need_cuda():
    assert profiling.union_length([]) == 0.0
    assert profiling.union_length([(5, 7), (0, 2), (1, 3), (6, 6.5)]) == 5.0
    if not torch.cuda.is_available():
        step = lambda s: (s,)  # noqa: E731
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.measure_rate(step, None)
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.busy_share(step, None)


@pytest.mark.parametrize("name, short", [
    ("(anonymous namespace)::hbf_dec_cascade_kernel(float const*, int)",
     "hbf_dec_cascade_kernel"),
    ("(anonymous namespace)::cic_bank_kernel<3>(int const*, int*)",
     "cic_bank_kernel<3>"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_profiler_event_short_name(name, short):
    assert profiling.short_name(name) == short


def test_ab_time_loads_a_second_copy_of_the_port():
    """`ab_time.load_tree` imports a checkout's package under a name of
    its own: distinct modules, its own build root, the same words."""
    import importlib
    from pathlib import Path

    from idsp_tpu_torch import ab_time
    from idsp_tpu_torch.filters.biquad_cuda import df1_bank_q

    root = Path(__file__).resolve().parent.parent
    try:
        ab_time.load_tree(str(root), "ab_test_copy")
        other = importlib.import_module("ab_test_copy.filters.biquad_cuda")
        ext = importlib.import_module("ab_test_copy._ext")
        assert other.df1_bank_q is not df1_bank_q
        assert ext.BUILD_ROOT == root / "build" / "idsp_tpu_torch"
        rng = np.random.default_rng(5)
        ba = biquad.quantize_ba(biquad.from_cookbook(
            Filter().critical_frequency(0.02).lowpass()), 29)
        st = biquad.df1_init((4,), device="cpu")
        xs = _t(_i32(rng, (64, 4), -(2**27), 2**27))
        got = other.df1_bank_q(ba, st, xs, 29)
        want = df1_bank_q(ba, st, xs, 29)
        for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
            assert torch.equal(a, b)
    finally:
        for k in [k for k in sys.modules if k.split(".")[0] == "ab_test_copy"]:
            del sys.modules[k]


def test_copied_constants_equal_reference():
    np.testing.assert_array_equal(luts.cossin_table(), jluts.cossin_table())
    assert luts.COSSIN_DEPTH == jluts.COSSIN_DEPTH
    assert len(hbf.HBF_TAPS) == len(jhbf.HBF_TAPS)
    for a, b in zip(hbf.HBF_TAPS, jhbf.HBF_TAPS):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert fastlo.AMPLITUDE == jfastlo.AMPLITUDE
    assert np.float32(fastlo.AMPLITUDE) == fastlo.AMPLITUDE  # exact in f32


@pytest.mark.parametrize("f", [0, 15, 29, 31, 32])
def test_q_mul_q_apply_quantize_bitexact(f):
    rng = np.random.default_rng(100 + f)
    a, b = _i32(rng, (4096,)), _i32(rng, (4096,))
    a[:4] = [2**31 - 1, -(2**31), -(2**31), 0]
    b[:4] = [2**31 - 1, -(2**31), 2**31 - 1, -1]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a), _t(b)
    np.testing.assert_array_equal(
        fxp.q_mul(ta, tb, f).numpy(), np.asarray(jfxp.q_mul(ja, jb, f)))
    np.testing.assert_array_equal(
        fxp.q_apply(ta, tb, f).numpy(), np.asarray(jfxp.q_apply(ja, jb, f)))
    wide = fxp.mul_wide(ta, tb)
    np.testing.assert_array_equal(wide.numpy(),
                                  np.asarray(jfxp.mul_wide(ja, jb)))
    np.testing.assert_array_equal(
        fxp.quantize(wide, f).numpy(),
        np.asarray(jfxp.quantize(jfxp.mul_wide(ja, jb), f)))
    np.testing.assert_array_equal(fxp.shs(ta, -f).numpy(),
                                  np.asarray(jfxp.shs(ja, -f)))


def test_from_float_and_round_half_away_match():
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.normal(0, 3, 1000), [0.5, -0.5, 1.5, -2.5, 4.0,
                                                 np.nan, 1e12, -1e12]])
    np.testing.assert_array_equal(fxp.round_half_away(v),
                                  jfxp.round_half_away(v))
    for f in (0, 16, 29, 31):
        np.testing.assert_array_equal(fxp.from_float(v, f),
                                      jfxp.from_float(v, f))


def test_wrap_i32_is_mod_2_32():
    v = torch.tensor([0, 2**31, -(2**31) - 1, 2**32 + 5, -(2**40) + 7,
                      2**62 + 3], dtype=torch.int64)
    want = np.array([0, 2**31, -(2**31) - 1, 2**32 + 5, -(2**40) + 7,
                     2**62 + 3], dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(fxp.wrap_i32(v).numpy(), want)


def test_ramp_advance_bitexact():
    rng = np.random.default_rng(2)
    st, step = _i32(rng, (16,)), _i32(rng, (16,))
    n = 777
    np.testing.assert_array_equal(
        accu.ramp(_t(st), _t(step), n).numpy(),
        np.asarray(jaccu.ramp(jnp.asarray(st), jnp.asarray(step), n)))
    np.testing.assert_array_equal(
        accu.ramp_t(_t(st), _t(step), n).numpy(),
        np.asarray(jaccu.ramp_t(jnp.asarray(st), jnp.asarray(step), n)))
    np.testing.assert_array_equal(
        accu.advance(_t(st), _t(step), 2**33 + 5).numpy(),
        np.asarray(jaccu.advance(jnp.asarray(st), jnp.asarray(step),
                                 2**33 + 5)))


@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_cossin_bitexact(kind):
    rng = np.random.default_rng(3)
    if kind == "random":
        ph = _i32(rng, (64, 257))
    else:
        base = np.array([-(2**31), 2**31 - 1, 0, 1, -1], dtype=np.int64)
        octs = np.arange(8, dtype=np.int64) << 29
        ph = ((base[:, None] + octs[None, :] + np.arange(-3, 4)[:, None, None])
              .reshape(-1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    cos, sin = cossin(_t(ph))
    jcos, jsin = jcossin(jnp.asarray(ph), lookup="gather")
    assert cos.dtype == sin.dtype == torch.int32
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


def test_lowpass_coefficients_bitexact():
    want = [1944375, 3888751, 1944375, 978551887, -449458477]
    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.02).lowpass()), 29)
    jba = jbiquad.quantize_ba(
        jbiquad.from_cookbook(JFilter().critical_frequency(0.02).lowpass()),
        29)
    assert ba.dtype == np.int32
    assert ba.tolist() == want == np.asarray(jba).tolist()
    for fc in (0.001, 0.1, 0.37):
        np.testing.assert_array_equal(
            Filter().critical_frequency(fc).lowpass(),
            JFilter().critical_frequency(fc).lowpass())


def test_filter_validation():
    Filter().critical_frequency(0.02).validate()
    with pytest.raises(DesignError):
        Filter().critical_frequency(0.6).validate()
    with pytest.raises(DesignError):
        Filter().gain_linear(0.0).validate()


def test_fastlo_tables_within_measured_ulps():
    # f32 cos/sin of the same f32 angle differ between PyTorch's CPU
    # kernels and XLA's (the wrapped int32 phases and the f32 angles are
    # identical): measured worst case 2**-24 absolute, one ULP of a
    # value in [0.5, 1), over seeds 0-4 at c=128, t=4096.  Gate at
    # 2**-23.
    rng = np.random.default_rng(4)
    c, t, k = 128, 1024, 128
    p0, st = _i32(rng, (c,)), _i32(rng, (c,), 1 << 24, 1 << 30)
    ours = fastlo.fastlo_tables(_t(p0), _t(st), t, k)
    ref = jfastlo.fastlo_tables(jnp.asarray(p0), jnp.asarray(st), t, k)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        d = np.abs(a.numpy().astype(np.float64) - np.asarray(b, np.float64))
        assert d.max() <= 2.0**-23, d.max()


def test_fastlo_iq_and_mix_within_measured_ulps():
    # The LO planes inherit the tables' ULP differences through one f32
    # complex multiply: measured worst case 3 * 2**-24 (seeds 0-4, c=128,
    # t=2048); gate 2**-22.  The mix rounds lo * x * AMPLITUDE (|.| <
    # 2**30 for full-range x) to int32: measured worst case 192 LSB,
    # 1.5 f32 ULPs at 2**30 (128 LSB); gate 4 ULPs.  About 10 % of the
    # mixed samples differ at all.
    rng = np.random.default_rng(5)
    c, t, k = 128, 2048, 128
    p0, st = _i32(rng, (c,)), _i32(rng, (c,), 1 << 24, 1 << 30)
    x = _i32(rng, (t,))
    lo = fastlo.fastlo_iq(_t(p0), _t(st), t, k)
    jlo = jfastlo.fastlo_iq(jnp.asarray(p0), jnp.asarray(st), t, k)
    for a, b in zip(lo, jlo):
        assert tuple(a.shape) == b.shape == (t, c)
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 2.0**-22
    miq = fastlo.fastlo_mix(_t(x), _t(p0), _t(st), k)
    jmiq = jfastlo.fastlo_mix(jnp.asarray(x), jnp.asarray(p0),
                              jnp.asarray(st), k)
    assert miq.dtype == torch.int32 and tuple(miq.shape) == (t, 2 * c)
    d = np.abs(miq.numpy().astype(np.int64) - np.asarray(jmiq, np.int64))
    assert d.max() <= 4 * np.spacing(np.float32(2**30)), d.max()
