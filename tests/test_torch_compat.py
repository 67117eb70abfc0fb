"""Port parity for the Stabilizer IIR control path: the rest of
`filters.biquad` (DF2T, wide, dither and their clamp steps, cascades,
per-lane coefficients, `df1_block_float`, the coefficient helpers), the
plain versions of K24 `sos_bank_q`, K25 `df1_wide_bank`, K26
`df1_bank_q_coef` and K27 `df1_clamp_bank_q_coef`, `compat` and the
per-channel config bank (`pipelines.config_bank`), against `idsp_tpu`.

The JAX side runs its Pallas entry points with ``interpret=True``, as
tests/test_biquad_pallas.py does; the port's wrappers get CPU tensors
and run their plain versions.  Every integer result is held bit for bit;
the wide and dither steps also against the C golden model
(`idsp_tpu.golden`, native/golden.c:155-190) at full-range inputs and
gains near +-2.  Float steps run JAX under ``jax.disable_jit`` (jitted XLA
may contract a multiply-add into an FMA; eager PyTorch rounds each
operation) and are then held bit for bit too; `df1_block_float` reorders
its sums, and is held within the JAX test's 1e-9
(tests/test_biquad.py:93-105).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu import compat as jcompat
from idsp_tpu import golden
from idsp_tpu.design import Filter as JFilter
from idsp_tpu.design import Units as JUnits
from idsp_tpu.design.config import (
    BiquadConfig as JBiquadConfig,
    FilterConfig as JFilterConfig,
    GainsConfig as JGainsConfig,
    PidConfig as JPidConfig,
)
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import biquad_pallas as jbp

from idsp_tpu_torch import compat
from idsp_tpu_torch.convert import clamped_coeffs, to_numpy, to_planes, to_torch
from idsp_tpu_torch.filters import biquad
from idsp_tpu_torch.filters.biquad_cuda import (
    df1_bank_q_coef,
    df1_clamp_bank_q_coef,
    df1_wide_bank,
    sos_bank_q,
)
from idsp_tpu_torch.pipelines.config_bank import ConfigBank, stack_coeffs

CPU = torch.device("cpu")
I32_MIN = -(2**31)


@pytest.fixture(autouse=True)
def fresh_coef_jit_caches():
    """After each test, empties the jit caches of the JAX K26/K27 entry
    points this file calls, as a fresh process has them: JAX's own retune
    test (tests/test_biquad_pallas.py) counts a new cache entry at the
    shapes these tests use, on the same worker."""
    yield
    jbp._df1_bank_q_coef_impl.clear_cache()
    jbp._df1_clamp_bank_q_coef_impl.clear_cache()


def _i32(rng, shape, lo=I32_MIN, hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _i64(rng, shape, lo=-(2**62), hi=2**62):
    return rng.integers(lo, hi, size=shape, dtype=np.int64)


def _ba_q(fc, f=29, kind="lowpass"):
    return jbiquad.quantize_ba(jbiquad.from_cookbook(
        getattr(JFilter().critical_frequency(fc), kind)()), f)


def _eq(got, want):
    """Bit-for-bit equality of (nested) port tensors and JAX arrays."""
    for g, w in zip(jax.tree_util.tree_leaves(to_numpy(got)),
                    jax.tree_util.tree_leaves(want), strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _jscan(step, st, xs):
    return jax.lax.scan(step, st, jnp.asarray(xs))


def _scan(step, st, xs):
    return biquad.process(step, st, torch.from_numpy(np.asarray(xs)))


# --- coefficient helpers -----------------------------------------------------


def test_coefficient_helpers_equal_jax():
    for k in (np.float64(3.0), np.float32(-0.5), np.int32(7)):
        np.testing.assert_array_equal(biquad.proportional(k),
                                      jbiquad.proportional(k))
        assert biquad.proportional(k).dtype == jbiquad.proportional(k).dtype
    np.testing.assert_array_equal(biquad.identity(), jbiquad.identity())
    np.testing.assert_array_equal(biquad.hold(np.float32),
                                  jbiquad.hold(np.float32))
    ba = np.random.default_rng(1).normal(size=(4, 5))
    np.testing.assert_array_equal(biquad.forward_gain(ba),
                                  jbiquad.forward_gain(ba))
    for zeros, poles, kw in (((0.5, 0.5), (0.1, 0.2), {}),
                             ((0.3, 0.9), (0.7, 0.2),
                              {"complex_zeros": True, "complex_poles": True}),
                             ((-1.0, 0.25), (0.95, 0.1),
                              {"complex_poles": True})):
        np.testing.assert_array_equal(
            biquad.from_zpk(zeros, poles, 2.5, **kw),
            jbiquad.from_zpk(zeros, poles, 2.5, **kw))


def test_df1_set_y_equals_jax():
    rng = np.random.default_rng(2)
    jst = jbiquad.Df1State(x=jnp.asarray(_i32(rng, (8, 2))),
                           y=jnp.asarray(_i32(rng, (8, 2))))
    y0 = _i32(rng, (8,))
    _eq(biquad.df1_set_y(to_torch(jst, CPU), torch.from_numpy(y0)),
        jbiquad.df1_set_y(jst, jnp.asarray(y0)))


# --- float steps -------------------------------------------------------------


def _float_ba(rng, lanes):
    """Per-lane stable float coefficients (..., 5) (lowpasses)."""
    return np.stack([jbiquad.from_cookbook(
        JFilter().critical_frequency(fc).q(q).lowpass())
        for fc, q in zip(rng.uniform(0.01, 0.4, lanes),
                         rng.uniform(0.5, 3.0, lanes))])


@pytest.mark.parametrize("clamp", [False, True])
def test_df2t_steps_equal_jax(clamp):
    rng = np.random.default_rng(3)
    c, t = 16, 64
    ba = _float_ba(rng, c)
    xs = rng.normal(size=(t, c))
    u, lo, hi = 0.25, -0.6, 0.7
    jba, tba = jnp.asarray(ba), torch.from_numpy(ba)
    if clamp:
        def jstep(s, x):
            return jbiquad.df2t_clamp_step(jba, s, x, u, lo, hi)

        def tstep(s, x):
            return biquad.df2t_clamp_step(tba, s, x, u, lo, hi)
    else:
        def jstep(s, x):
            return jbiquad.df2t_step(jba, s, x)

        def tstep(s, x):
            return biquad.df2t_step(tba, s, x)
    with jax.disable_jit():
        want = _jscan(jstep, jbiquad.df2t_init((c,), jnp.float64), xs)
    got = _scan(tstep, biquad.df2t_init((c,), torch.float64, device=CPU), xs)
    _eq(got, want)


def test_float_cascade_step_equals_jax():
    rng = np.random.default_rng(4)
    c, t, n = 8, 48, 3
    ba = np.stack([_float_ba(rng, c) for _ in range(n)])  # (n, c, 5)
    xs = rng.normal(size=(t, c))
    with jax.disable_jit():
        want = _jscan(lambda s, x: jbiquad.cascade_step(jnp.asarray(ba), s, x),
                      jbiquad.cascade_init(n, (c,), jnp.float64), xs)
    got = _scan(lambda s, x: biquad.cascade_step(torch.from_numpy(ba), s, x),
                biquad.cascade_init(n, (c,), torch.float64, device=CPU), xs)
    _eq(got, want)


def test_df1_block_float_matches_jax_and_scan():
    rng = np.random.default_rng(5)
    ba = jbiquad.from_cookbook(np.array([[0.3, 0.2, 0.1], [1.0, -0.4, 0.2]]))
    for n in (1, 2, 257):
        xs = rng.normal(size=(n, 4))
        st = biquad.Df1State(x=torch.from_numpy(rng.normal(size=(4, 2))),
                             y=torch.from_numpy(rng.normal(size=(4, 2))))
        jst = jbiquad.Df1State(*(jnp.asarray(v.numpy()) for v in st))
        got = biquad.df1_block_float(torch.from_numpy(ba), st,
                                     torch.from_numpy(xs))
        want = jbiquad.df1_block_float(jnp.asarray(ba), jst, jnp.asarray(xs))
        seq = biquad.df1_process(ba, st, torch.from_numpy(xs))
        for ref in (want, to_numpy(seq)):
            np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(got[0].y.numpy(), np.asarray(ref[0].y),
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_array_equal(got[0].x.numpy(),
                                          np.asarray(ref[0].x))


# --- fixed-point steps -------------------------------------------------------


def _extreme_ba(rng, f):
    """Coefficients across the Q<f> range: gains near +-2 included."""
    top = min(2**31 - 1, 2 * (1 << f))
    ba = _i32(rng, (5,), -top, top + 1)
    ba[rng.integers(0, 5)] = top if rng.random() < 0.5 else -top
    return ba


@pytest.mark.parametrize("per_lane", [False, True])
def test_df1_step_q_per_lane_equals_jax(per_lane):
    rng = np.random.default_rng(6)
    c, t = 64, 40
    ba = (np.stack([_ba_q(fc) for fc in np.linspace(0.02, 0.3, c)])
          if per_lane else _ba_q(0.1))
    xs = _i32(rng, (t, c))
    jst = jbiquad.Df1State(x=jnp.asarray(_i32(rng, (c, 2))),
                           y=jnp.asarray(_i32(rng, (c, 2))))
    want = jbiquad.df1_process_q(jnp.asarray(ba), 29, jst, jnp.asarray(xs))
    st = to_torch(jst, CPU)
    _eq(biquad.df1_process_q(ba, 29, st, torch.from_numpy(xs)), want)
    _eq(biquad.df1_process_q(torch.from_numpy(ba), 29, st,
                             torch.from_numpy(xs)), want)
    _eq(_scan(lambda s, x: biquad.df1_step_q(ba, 29, s, x), st, xs), want)


@pytest.mark.parametrize("clamp", [None, (-777, -(2**27), 2**27),
                                   (2**31 - 9, I32_MIN, 2**31 - 1)])
@pytest.mark.parametrize("f", [29, 32, 16])
def test_wide_steps_equal_jax(f, clamp):
    rng = np.random.default_rng(7 + f)
    c, t = 32, 64
    ba = jnp.asarray(_extreme_ba(rng, f))
    xs = _i32(rng, (t, c))
    jst = jbiquad.Df1WideState(x=jnp.asarray(_i32(rng, (c, 2))),
                               y=jnp.asarray(_i64(rng, (c, 2))))
    st = to_torch(jst, CPU)
    assert isinstance(st, biquad.Df1WideState) and st.y.dtype == torch.int64
    if clamp is None:
        want = _jscan(lambda s, x: jbiquad.df1_wide_step(ba, f, s, x), jst, xs)
        got = _scan(lambda s, x: biquad.df1_wide_step(ba, f, s, x), st, xs)
    else:
        u, lo, hi = (jnp.int32(v) for v in clamp)
        want = _jscan(lambda s, x: jbiquad.df1_wide_clamp_step(
            ba, f, s, x, u, lo, hi), jst, xs)
        got = _scan(lambda s, x: biquad.df1_wide_clamp_step(
            np.asarray(ba), f, s, x, *clamp), st, xs)
    _eq(got, want)
    _eq(biquad.df1_wide_process(np.asarray(ba), f, st, torch.from_numpy(xs),
                                clamp=clamp), want)


@pytest.mark.parametrize("clamp", [None, (321, -(2**26), 2**26)])
@pytest.mark.parametrize("f", [29, 32, 1])
def test_dither_steps_equal_jax(f, clamp):
    rng = np.random.default_rng(20 + f)
    c, t = 32, 64
    ba = jnp.asarray(_extreme_ba(rng, f))
    xs = _i32(rng, (t, c))
    jst = jbiquad.Df1DitherState(
        xy=jbiquad.Df1State(x=jnp.asarray(_i32(rng, (c, 2))),
                            y=jnp.asarray(_i32(rng, (c, 2)))),
        e=jnp.asarray(rng.integers(0, 2**32, size=(c,)).astype(np.uint32)))
    st = to_torch(jst, CPU)
    assert st.e.dtype == torch.int64
    if clamp is None:
        want = _jscan(lambda s, x: jbiquad.df1_dither_step(ba, f, s, x), jst,
                      xs)
        got = _scan(lambda s, x: biquad.df1_dither_step(ba, f, s, x), st, xs)
    else:
        u, lo, hi = (jnp.int32(v) for v in clamp)
        want = _jscan(lambda s, x: jbiquad.df1_dither_clamp_step(
            ba, f, s, x, u, lo, hi), jst, xs)
        got = _scan(lambda s, x: biquad.df1_dither_clamp_step(
            np.asarray(ba), f, s, x, *clamp), st, xs)
    _eq(got, want)


def test_wide_and_dither_steps_reject_bad_f():
    st = biquad.df1_wide_init((2,), device=CPU)
    x = torch.zeros(2, dtype=torch.int32)
    for f in (0, 33):
        with pytest.raises(ValueError):
            biquad.df1_wide_step(_ba_q(0.1), f, st, x)
        with pytest.raises(ValueError):
            biquad.df1_dither_step(_ba_q(0.1), f,
                                   biquad.df1_dither_init((2,), device=CPU), x)


@pytest.mark.parametrize("f", [29, 32, 8])
def test_wide_and_dither_equal_golden_at_extremes(f):
    """Full-range inputs and states, coefficients up to +-2 in Q<f>."""
    rng = np.random.default_rng(40 + f)
    t = 300
    for _ in range(4):
        ba = _extreme_ba(rng, f)
        xs = _i32(rng, (t,))
        xs[:8] = [I32_MIN, 2**31 - 1] * 4
        xst, yst = _i32(rng, (2,)), _i64(rng, (2,), -(2**63), 2**63 - 1)
        gx, gy, gys = golden.biquad_df1_wide(ba, f, xst.copy(), yst.copy(), xs)
        st, ys = biquad.df1_wide_process(
            ba, f, biquad.Df1WideState(x=torch.from_numpy(xst),
                                       y=torch.from_numpy(yst)),
            torch.from_numpy(xs))
        np.testing.assert_array_equal(ys.numpy(), gys)
        np.testing.assert_array_equal(st.x.numpy(), gx)
        np.testing.assert_array_equal(st.y.numpy(), gy)

        sxy, e0 = _i32(rng, (4,)), int(rng.integers(0, 2**32))
        g_state, g_e, g_ys = golden.biquad_df1_dither(ba, f, sxy.copy(), e0, xs)
        dst = biquad.Df1DitherState(
            xy=biquad.Df1State(x=torch.from_numpy(sxy[:2].copy()),
                               y=torch.from_numpy(sxy[2:].copy())),
            e=torch.tensor(e0, dtype=torch.int64))
        dst, d_ys = biquad.process(
            lambda s, x: biquad.df1_dither_step(ba, f, s, x), dst,
            torch.from_numpy(xs))
        np.testing.assert_array_equal(d_ys.numpy(), g_ys)
        np.testing.assert_array_equal(
            np.concatenate([dst.xy.x.numpy(), dst.xy.y.numpy()]), g_state)
        assert int(dst.e) == int(g_e)


def test_fixed_point_cascade_step_equals_jax():
    rng = np.random.default_rng(8)
    c, t = 16, 64
    ba = np.stack([_ba_q(fc) for fc in (0.05, 0.1, 0.2)])  # (3, 5)
    xs = _i32(rng, (t, c), -(2**24), 2**24)
    jst = jbiquad.cascade_init(3, (c,), jnp.int32)
    want = _jscan(lambda s, x: jbiquad.cascade_step_q(jnp.asarray(ba), 29, s,
                                                      x), jst, xs)
    got = _scan(lambda s, x: biquad.cascade_step_q(ba, 29, s, x),
                to_torch(jst, CPU), xs)
    _eq(got, want)
    # the interleaved cascade is the SOS chain: its output is K24's
    _, ys = sos_bank_q(ba, [biquad.df1_init((c,), device=CPU)] * 3,
                       torch.from_numpy(xs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(want[1]))


# --- K24-K27 plain versions against the interpret-mode JAX kernels ----------


@pytest.mark.parametrize("n", [1, 3])
def test_sos_bank_q_plain_equals_jax_kernel(n):
    rng = np.random.default_rng(9)
    c, t = 128, 256
    bas = np.stack([_ba_q(fc) for fc in (0.05, 0.1, 0.15)[:n]])
    xs = _i32(rng, (t, c), -(2**24), 2**24)
    jsts = [jbiquad.Df1State(x=jnp.asarray(_i32(rng, (c, 2))),
                             y=jnp.asarray(_i32(rng, (c, 2), -(2**26), 2**26)))
            for _ in range(n)]
    want = jbp.sos_bank_q(bas, jsts, jnp.asarray(xs), 29, time_chunk=128,
                          interpret=True)
    got = sos_bank_q(bas, to_torch(jsts, CPU), torch.from_numpy(xs), 29)
    assert isinstance(got[0], list) and len(got[0]) == n
    _eq(got, want)


@pytest.mark.parametrize("clamp", [None, (-777, -(2**27), 2**27)])
def test_df1_wide_bank_plain_equals_jax_kernel(clamp):
    rng = np.random.default_rng(12)
    c, t = 128, 256
    ba = _ba_q(0.1)
    xs = _i32(rng, (t, c))
    jst = jbiquad.Df1WideState(x=jnp.asarray(_i32(rng, (c, 2))),
                               y=jnp.asarray(_i64(rng, (c, 2))))
    want = jbp.df1_wide_bank(ba, jst, jnp.asarray(xs), 29, clamp=clamp,
                             time_chunk=128, interpret=True)
    got = df1_wide_bank(ba, to_torch(jst, CPU), torch.from_numpy(xs), 29,
                        clamp=clamp)
    _eq(got, want)
    if clamp is not None:  # the clamp engaged
        ys = got[1].numpy()
        assert ((ys == clamp[1]) | (ys == clamp[2])).mean() > 0.01


def _ba_pc(c, f=29):
    """(5, c) per-channel lowpass planes, as tests/test_biquad_pallas.py."""
    return np.stack([_ba_q(fc, f) for fc in np.linspace(0.02, 0.3, c)],
                    axis=1)


@pytest.mark.parametrize("clamp", [None, (321, -(2**28), 2**28)])
@pytest.mark.parametrize("shared", [True, False])
def test_coef_banks_plain_equal_jax_kernels(shared, clamp):
    rng = np.random.default_rng(16)
    c, t = 128, 256
    ba = _ba_q(0.1) if shared else _ba_pc(c)
    xs = _i32(rng, (t, c))
    jst = jbiquad.Df1State(x=jnp.asarray(_i32(rng, (c, 2))),
                           y=jnp.asarray(_i32(rng, (c, 2))))
    st = to_torch(jst, CPU)
    if clamp is None:
        want = jbp.df1_bank_q_coef(jnp.asarray(ba), jst, jnp.asarray(xs), 29,
                                   time_chunk=128, interpret=True)
        for b in (ba, torch.from_numpy(ba), to_planes(ba, c, CPU)):
            _eq(df1_bank_q_coef(b, st, torch.from_numpy(xs), 29), want)
    else:
        u, lo, hi = clamp
        want = jbp.df1_clamp_bank_q_coef(jnp.asarray(ba), jst,
                                         jnp.asarray(xs), 29, u=u, lo=lo,
                                         hi=hi, time_chunk=128,
                                         interpret=True)
        for b in (ba, to_planes(ba, c, CPU)):
            _eq(df1_clamp_bank_q_coef(b, st, torch.from_numpy(xs), 29, u=u,
                                      lo=lo, hi=hi), want)


@pytest.mark.parametrize("clamped", [False, True])
def test_coef_banks_retune_continuity_equals_jax(clamped):
    """Two blocks, the coefficients swapped between them: the state
    carries across the swap, as in JAX's kernel."""
    rng = np.random.default_rng(17)
    c, t = 128, 128
    xs1, xs2 = _i32(rng, (t, c)), _i32(rng, (t, c))
    ba_a, ba_b = _ba_pc(c), np.roll(_ba_pc(c), 37, axis=1)
    cl = dict(u=5, lo=-(2**29), hi=2**29) if clamped else {}
    jfn = jbp.df1_clamp_bank_q_coef if clamped else jbp.df1_bank_q_coef
    fn = df1_clamp_bank_q_coef if clamped else df1_bank_q_coef
    jst = jbiquad.df1_init((c,), jnp.int32)
    j1 = jfn(jnp.asarray(ba_a), jst, jnp.asarray(xs1), 29, time_chunk=64,
             interpret=True, **cl)
    j2 = jfn(jnp.asarray(ba_b), j1[0], jnp.asarray(xs2), 29, time_chunk=64,
             interpret=True, **cl)
    s1 = fn(ba_a, to_torch(jst, CPU), torch.from_numpy(xs1), 29, **cl)
    s2 = fn(ba_b, s1[0], torch.from_numpy(xs2), 29, **cl)
    _eq(s1, j1)
    _eq(s2, j2)


def test_coef_planes_reject_bad_shape():
    st = biquad.df1_init((8,), device=CPU)
    xs = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        to_planes(np.zeros((5, 7), np.int32), 8, CPU)
    with pytest.raises(ValueError):
        sos_bank_q(np.zeros((2, 5), np.int32), [st], xs)


# --- compat ------------------------------------------------------------------


def test_compat_cossin_atan2_equal_jax():
    rng = np.random.default_rng(30)
    p = np.concatenate([_i32(rng, (500,)), [I32_MIN, 0, 2**31 - 1, 2**30]])
    p = p.astype(np.int32)
    want = np.asarray(jcompat.cossin(p))
    got = compat.cossin(p, device=CPU)
    assert got.shape == (p.size, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    xy = _i32(rng, (400, 2))
    xy[:4] = [[0, 0], [I32_MIN, I32_MIN], [2**31 - 1, 0], [0, I32_MIN]]
    np.testing.assert_array_equal(compat.atan2(xy, device=CPU).numpy(),
                                  np.asarray(jcompat.atan2(xy)))


def _sos_rows(n):
    fcs = (0.05, 0.12, 0.2, 0.3)
    kinds = ("lowpass", "notch", "bandpass", "highpass")
    return np.stack([np.concatenate(getattr(
        JFilter().critical_frequency(fc), k)()) for fc, k in zip(fcs[:n],
                                                                  kinds)])


@pytest.mark.parametrize("shape", [(200,), (200, 4), (64, 3, 5)])
@pytest.mark.parametrize("n", [1, 4])
def test_compat_sos_equals_jax(n, shape):
    rng = np.random.default_rng(31)
    rows = _sos_rows(n)
    x = _i32(rng, shape, -(2**24), 2**24)
    got = compat.sos(rows, x, device=CPU)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcompat.sos(rows,
                                                                      x)))
    if len(shape) == 2:  # each lane gets the bits it gets alone
        for ch in range(shape[1]):
            np.testing.assert_array_equal(
                got[:, ch].numpy(),
                compat.sos(rows, x[:, ch], device=CPU).numpy())


@pytest.mark.parametrize("shape", [(300,), (300, 4)])
def test_compat_sos_clamp_wide_equals_jax(shape):
    rng = np.random.default_rng(32)
    rows6 = _sos_rows(2)
    rows = np.concatenate([rows6, [[1234.4, -(2.0**27), 2.0**27],
                                   [-0.5, -(2.0**40), 1e9 + 0.5]]], axis=1)
    x = _i32(rng, shape)
    got = compat.sos_clamp_wide(rows, x, device=CPU)
    want = np.asarray(jcompat.sos_clamp_wide(rows, x))
    np.testing.assert_array_equal(got.numpy(), want)
    identity = np.array([[1.0, 0, 0, 1.0, 0, 0, 0, -(2.0**31), 2.0**31 - 1]])
    np.testing.assert_array_equal(
        compat.sos_clamp_wide(identity, x, device=CPU).numpy(), x)


# --- leg (c): the per-channel config bank ------------------------------------

LIMITS = dict(offset=0.0, min=-(2.0**28), max=2.0**28)


def _jax_configs(c, seed):
    """c JAX `BiquadConfig`s sharing one offset and limits: Filter
    lowpass / notch / bandpass at spread frequencies, Pid "I" and "PI"."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(c):
        fc = float(rng.uniform(0.005, 0.2))
        kind = k % 5
        if kind < 3:
            typ = ("lowpass", "notch", "bandpass")[kind]
            out.append(JBiquadConfig("Filter", JFilterConfig(
                typ=typ, frequency=fc, **LIMITS)))
        else:
            gain = (JGainsConfig(i=fc * 1e-2) if kind == 3 else
                    JGainsConfig(i=fc * 1e-2, p=0.5))
            out.append(JBiquadConfig("Pid", JPidConfig(
                order="I", gain=gain, min=LIMITS["min"],
                max=LIMITS["max"])))
    return out


@pytest.mark.parametrize("clamp", [True, False])
def test_config_bank_leg_equals_jax_kernel(clamp):
    c, t = 128, 128
    rng = np.random.default_rng(33)
    units = JUnits()
    jcc = [cfg.build(units, f=29) for cfg in _jax_configs(c, 1)]
    retuned = np.arange(0, c, 2)
    jnew = [cfg.build(units, f=29) for cfg in _jax_configs(len(retuned), 2)]
    ba_a = np.stack([cc.ba for cc in jcc], axis=1)
    ba_b = ba_a.copy()
    ba_b[:, retuned] = np.stack([cc.ba for cc in jnew], axis=1)
    (u, lo, hi) = (jcc[0].u, jcc[0].min, jcc[0].max)
    assert (u, lo, hi) == (0, -(2**28), 2**28)

    bank = ConfigBank([clamped_coeffs(cc) for cc in jcc], clamp=clamp,
                      device=CPU)
    xs = [_i32(rng, (t, c), -(2**29), 2**29) for _ in range(2)]
    jst = jbiquad.df1_init((c,), jnp.int32)
    st = bank.init_state()
    for b, ba in enumerate((ba_a, ba_b)):
        if clamp:
            jst, jy = jbp.df1_clamp_bank_q_coef(
                jnp.asarray(ba), jst, jnp.asarray(xs[b]), 29, u=u, lo=lo,
                hi=hi, time_chunk=64, interpret=True)
        else:
            jst, jy = jbp.df1_bank_q_coef(jnp.asarray(ba), jst,
                                          jnp.asarray(xs[b]), 29,
                                          time_chunk=64, interpret=True)
        if b == 1:
            bank.retune(retuned, [clamped_coeffs(cc) for cc in jnew])
        st, y = bank(st, torch.from_numpy(xs[b]))
        _eq((st, y), (jst, jy))
    if clamp:
        ys = y.numpy()
        assert ((ys == lo) | (ys == hi)).any()


def test_config_bank_rejects_mixed_bounds():
    a = JBiquadConfig("Filter", JFilterConfig(typ="lowpass", frequency=0.1,
                                              **LIMITS)).build(f=29)
    b = JBiquadConfig("Filter", JFilterConfig(typ="lowpass", frequency=0.1,
                                              min=-5.0, max=5.0)).build(f=29)
    with pytest.raises(ValueError):
        stack_coeffs([clamped_coeffs(a), clamped_coeffs(b)])
    with pytest.raises(ValueError):
        stack_coeffs([clamped_coeffs(JBiquadConfig("Filter", JFilterConfig(
            typ="lowpass", frequency=0.1)).build())])  # float, not Q<f>
    bank = ConfigBank([clamped_coeffs(a)] * 4, device=CPU)
    with pytest.raises(ValueError):
        bank.retune([0], [clamped_coeffs(b)])


def test_convert_round_trips_new_states():
    rng = np.random.default_rng(34)
    wide = jbiquad.Df1WideState(x=jnp.asarray(_i32(rng, (4, 2))),
                                y=jnp.asarray(_i64(rng, (4, 2))))
    dither = jbiquad.Df1DitherState(
        xy=jbiquad.Df1State(x=jnp.asarray(_i32(rng, (4, 2))),
                            y=jnp.asarray(_i32(rng, (4, 2)))),
        e=jnp.asarray(np.array([0, 1, 2**31, 2**32 - 1], np.uint32)))
    sos = [jbiquad.df1_init((4,), jnp.int32) for _ in range(3)]
    for obj, cls in ((wide, biquad.Df1WideState),
                     (dither, biquad.Df1DitherState),
                     (jbiquad.df2t_init((4,), jnp.float64), biquad.Df2tState)):
        t = to_torch(obj, CPU)
        assert type(t) is cls
        _eq(t, obj)
        assert type(to_numpy(t)) is cls
    t = to_torch(sos, CPU)
    assert isinstance(t, list) and all(type(s) is biquad.Df1State for s in t)
    _eq(t, sos)
    assert to_numpy(to_torch(dither, CPU)).e.dtype == np.uint32
