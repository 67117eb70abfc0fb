"""Port parity for the filter structures beside the biquad: the SVF
(`filters.svf`, K34 `svf_bank`), the normal form (`filters.normal`, K35
`normal_bank_q`, K36 `normal_bank_f32`), the reciprocal PLL
(`filters.rpll`, K37 `rpll_bank`) and the wave-digital allpass chains
(`filters.wdf`, K38 `wdf_bank`, K39 `wdf_chain_bank`, K40
`wdf_pair_bank`), against `idsp_tpu`.

The same seeded numpy inputs go through both packages.  Integer results
are held bit for bit: the JAX package's functions and scans, its Pallas
kernels in interpret mode (as tests/test_structures_pallas.py and
tests/test_biquad_pallas.py run them) and, for the RPLL, the C golden
model (`idsp_tpu.golden.rpll`, native/golden.c) at shifts below, at and
above 32.  The f32 scans are held bit for bit against JAX run under
``jax.disable_jit`` (jitted XLA may contract a multiply-add into an FMA;
eager PyTorch rounds each operation), and within F32_ULPS ULP of the
output scale against the interpret-mode kernels, whose jitted bodies may
contract.  On the CPU each wrapper runs its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu import fxp as jfxp
from idsp_tpu import golden
from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import normal as jnormal
from idsp_tpu.filters import rpll as jrpll
from idsp_tpu.filters import svf as jsvf
from idsp_tpu.filters import wdf as jwdf
from idsp_tpu.filters.normal_pallas import normal_bank_f32 as jnormal_bank_f32
from idsp_tpu.filters.normal_pallas import normal_bank_q as jnormal_bank_q
from idsp_tpu.filters.rpll_pallas import rpll_bank as jrpll_bank
from idsp_tpu.filters.svf_pallas import svf_bank as jsvf_bank
from idsp_tpu.filters.wdf_pallas import wdf_bank as jwdf_bank
from idsp_tpu.filters.wdf_pallas import wdf_chain_bank as jwdf_chain_bank
from idsp_tpu.filters.wdf_pallas import wdf_pair_bank as jwdf_pair_bank

from idsp_tpu_torch import fxp
from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.design import Filter
from idsp_tpu_torch.filters import biquad, normal, rpll, svf, wdf
from idsp_tpu_torch.filters.normal_cuda import (
    normal_bank_f32,
    normal_bank_f32_plain,
    normal_bank_q,
    normal_bank_q_plain,
)
from idsp_tpu_torch.filters.rpll_cuda import rpll_bank, rpll_bank_plain
from idsp_tpu_torch.filters.svf_cuda import svf_bank, svf_bank_plain
from idsp_tpu_torch.filters.wdf_cuda import (
    wdf_bank,
    wdf_bank_plain,
    wdf_chain_bank,
    wdf_chain_bank_plain,
    wdf_pair_bank,
    wdf_pair_bank_plain,
)

CPU = torch.device("cpu")
C, T = 128, 256
# jitted XLA contracts multiply-adds into FMAs: each step may differ by an
# ULP or two, which the feedback carries on (3 ULP of the output scale
# seen at this shape); the repo's FMA gate of 16 ULP of the scale
F32_ULPS = 16
E = 24  # rows of the eager JAX scans (op by op: slow)

# the reference's bench configs (tests/embedded/src/bin/biquad.rs:120-173)
CA7 = ([(0xAD, 2, [-0.9, 0.9]), (0xAD, 2, [-0.6, 0.7])],
       [(0xAD, 2, [-0.7, 0.6]), (0xA, 1, [0.8])])
CA19 = ([(0x1, 1, [0.0]), (0x1C, 2, [-0.226119, 0.0]),
         (0x1D, 2, [-0.602422, 0.0]), (0x1D, 2, [-0.83932, 0.0]),
         (0x1D, 2, [-0.950847, 0.0])],
        [(0x1C, 2, [-0.063978, 0.0]), (0x1C, 2, [-0.423068, 0.0]),
         (0x1D, 2, [-0.741327, 0.0]), (0x1D, 2, [-0.905567, 0.0]),
         (0x1D, 2, [-0.984721, 0.0])])


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


def _ulps(got, want, ulps=F32_ULPS):
    """|got - want| within ``ulps`` f32 ULP of the output scale."""
    g = got.double().numpy()
    w = np.asarray(want, np.float64)
    scale = max(float(np.abs(w).max()), 1e-30)
    assert np.abs(g - w).max() <= ulps * 2.0**-24 * scale


def _i32(rng, shape, lim=2**31):
    return rng.integers(-lim, lim, size=shape, dtype=np.int64).astype(
        np.int32)


def _stages(spec):
    """[(tpas, a)] of (nibble word, adapters, g) triples, for each package."""
    jb = [(jwdf.nibbles(m, n), jwdf.quantize(jwdf.nibbles(m, n), g))
          for m, n, g in spec]
    pb = [(wdf.nibbles(m, n), wdf.quantize(wdf.nibbles(m, n), g))
          for m, n, g in spec]
    return jb, pb


# --- SVF (K34) ----------------------------------------------------------------


def _svf_state(rng, c):
    return jsvf.SvfState(*(jnp.asarray(rng.normal(size=c).astype(np.float32))
                           for _ in range(3)))


def test_svf_coefficients_and_step_equal_jax():
    f, qi = svf.coefficients(0.04, 1.3)
    assert (f, qi) == jsvf.coefficients(0.04, 1.3)
    rng = np.random.default_rng(1)
    jst = _svf_state(rng, 16)
    x = rng.normal(size=16).astype(np.float32)
    f32, qi32 = np.float32(f), np.float32(qi)
    js, jy = jsvf.step(f32, qi32, jst, jnp.asarray(x))
    s, y = svf.step(torch.tensor(f32), torch.tensor(qi32),
                    to_torch(jst, CPU), _t(x))
    _eq((s, y), (js, jy))
    _eq(s.br, js.br)


def test_svf_block_equals_jax_eager():
    rng = np.random.default_rng(2)
    f, qi = svf.coefficients(0.01, 0.7)
    jst = _svf_state(rng, 64)
    xs = rng.normal(size=(E, 64)).astype(np.float32)
    with jax.disable_jit():
        js, jouts = jsvf.block(f, qi, jst, jnp.asarray(xs), unroll=1)
    s, outs = svf.block(f, qi, to_torch(jst, CPU), _t(xs))
    _eq((s, outs), (js, jouts))


@pytest.mark.parametrize("output", ["lp", "hp", "bp", "br"])
def test_svf_bank_plain_vs_interpret_kernel(output):
    rng = np.random.default_rng(11)
    f, qi = svf.coefficients(0.04, 1.3)
    xs = rng.normal(size=(T, C)).astype(np.float32)
    jst = _svf_state(rng, C)
    js, jys = jsvf_bank(f, qi, jst, jnp.asarray(xs), output=output,
                        time_chunk=128, interpret=True)
    st = to_torch(jst, CPU)
    s, ys = svf_bank_plain(f, qi, st, _t(xs), output=output)
    _ulps(ys, jys)
    for a, b in zip(s, js, strict=True):
        _ulps(a, b)
    s2, ys2 = svf_bank(f, qi, st, _t(xs), output=output)
    assert torch.equal(ys2, ys) and all(map(torch.equal, s2, s))
    # the plain version is the eager scan's field, bit for bit
    s, ys = svf_bank_plain(f, qi, st, _t(xs[:E]), output=output)
    with jax.disable_jit():
        jse, jouts = jsvf.block(np.float32(f), np.float32(qi), jst,
                                jnp.asarray(xs[:E]), unroll=1)
    _eq((s, ys), (jse, jouts.br if output == "br"
                  else getattr(jouts, output)))


def test_svf_bank_refuses_unknown_output():
    st = svf.init((4,), device=CPU)
    with pytest.raises(ValueError):
        svf_bank(0.1, 1.0, st, torch.zeros((8, 4)), output="notch")


def test_svf_gates():
    """The SVF lowpass suppresses the high band and passes the low one,
    and br == hp + lp (tests/test_structures.py:11-32), on 4 lanes."""
    f, qi = svf.coefficients(0.02, 1.0 / np.sqrt(2.0))
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(2048, 4)).astype(np.float32)
    st = svf.init((4,), device=CPU)
    _, outs = svf.block(f, qi, st, _t(xs))
    _, br = svf_bank(f, qi, st, _t(xs), output="br")
    assert torch.equal(br, outs.hp + outs.lp)
    w = np.hanning(2048)[:, None]
    spec = np.abs(np.fft.rfft(outs.lp.numpy() * w, axis=0))
    spec_in = np.abs(np.fft.rfft(xs * w, axis=0))
    n = spec.shape[0]
    ratio = spec / np.maximum(spec_in, 1e-9)
    assert (ratio[int(0.3 * n):].mean(axis=0) < 0.1).all()
    lo = ratio[1:int(0.02 * n)].mean(axis=0)
    assert ((0.5 < lo) & (lo < 1.5)).all()


# --- normal form (K35, K36) ---------------------------------------------------


def _normal_q(f=29, dtype=np.int32):
    b, p = jnormal.from_cookbook(JFilter().critical_frequency(0.06).lowpass())
    return (np.asarray(jfxp.from_float(jnp.asarray(b), f, dtype=dtype)),
            np.asarray(jfxp.from_float(jnp.asarray(p), f, dtype=dtype)))


def test_normal_from_cookbook_equals_jax():
    for fc in (0.01, 0.06, 0.2):
        b, p = normal.from_cookbook(Filter().critical_frequency(fc).lowpass())
        jb, jp = jnormal.from_cookbook(
            JFilter().critical_frequency(fc).lowpass())
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(p, jp)


@pytest.mark.parametrize("bits", [16, 32, 64])
def test_normal_step_q_equals_jax(bits):
    """Eight chained steps of `step_q` at int16 (int32 sums), int32 (int64)
    and int64 (128-bit `fxp.I128` sums), bit for bit."""
    dt = {16: np.int16, 32: np.int32, 64: np.int64}[bits]
    tdt = {16: torch.int16, 32: torch.int32, 64: torch.int64}[bits]
    f = bits - 3
    b, p = _normal_q(f, dt)
    rng = np.random.default_rng(bits)
    lim = 2 ** (bits - 3)

    def r(shape):
        return rng.integers(-lim, lim, size=shape, dtype=np.int64).astype(dt)

    jst = jnormal.init((8,), dt)._replace(x=jnp.asarray(r((8, 2))),
                                          y=jnp.asarray(r((8, 2))))
    st = to_torch(jst, CPU)
    for _ in range(8):
        x = r(8)
        jst, jy = jnormal.step_q(jnp.asarray(b), jnp.asarray(p), f, jst,
                                 jnp.asarray(x), dtype=dt)
        st, y = normal.step_q(b, p, f, st, _t(x), dtype=tdt)
        _eq((st, y), (jst, jy))


def test_normal_bank_q_plain_equals_interpret_kernel():
    rng = np.random.default_rng(12)
    b, p = _normal_q()
    xs = _i32(rng, (T, C), 2**27)
    jst = jnormal.init((C,), jnp.int32)._replace(
        x=jnp.asarray(_i32(rng, (C, 2), 2**27)),
        y=jnp.asarray(_i32(rng, (C, 2), 2**27)))
    want = jnormal_bank_q(b, p, jst, jnp.asarray(xs), 29, time_chunk=128,
                          interpret=True)
    st = to_torch(jst, CPU)
    _eq(normal_bank_q_plain(b, p, st, _t(xs), 29), want)
    _eq(normal_bank_q(b, p, st, _t(xs), 29), want)
    # the scan of `step_q` with the coefficients as tensors
    s, ys = st, []
    for i in range(16):
        s, y = normal.step_q(_t(b), _t(p), 29, s, _t(xs[i]))
        ys.append(y)
    _eq((s, torch.stack(ys)), normal_bank_q_plain(b, p, st, _t(xs[:16]), 29))


def test_normal_bank_q_refuses_p_im_min_and_f():
    b, p = _normal_q()
    st = normal.init((4,), torch.int32, device=CPU)
    xs = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        normal_bank_q(b, np.array([p[0], -(2**31)], np.int32), st, xs, 29)
    with pytest.raises(ValueError):
        normal_bank_q(b, p, st, xs, 64)


def test_normal_f32_equals_jax_eager_and_interpret_kernel():
    b, p = jnormal.from_cookbook(JFilter().critical_frequency(0.06).lowpass())
    b, p = b.astype(np.float32), p.astype(np.float32)
    rng = np.random.default_rng(13)
    xs = rng.normal(size=(T, C)).astype(np.float32)
    jst = jnormal.init((C,), jnp.float32)._replace(
        x=jnp.asarray(rng.normal(size=(C, 2)).astype(np.float32)),
        y=jnp.asarray(rng.normal(size=(C, 2)).astype(np.float32)))
    st = to_torch(jst, CPU)
    with jax.disable_jit():
        want = jnormal.block(jnp.asarray(b), jnp.asarray(p), jst,
                             jnp.asarray(xs[:E]), unroll=1)
    _eq(normal_bank_f32_plain(b, p, st, _t(xs[:E])), want)
    got = normal_bank_f32_plain(b, p, st, _t(xs))
    _eq(normal_bank_f32(b, p, st, _t(xs)), to_numpy(got))
    ks, kys = jnormal_bank_f32(b, p, jst, jnp.asarray(xs), time_chunk=128,
                               interpret=True)
    _ulps(got[1], kys)
    _ulps(got[0].y, ks.y)


def test_normal_matches_df1_float():
    """The normal form implements the DF1's transfer function for a
    complex-pole lowpass (tests/test_structures.py:35-59)."""
    ba_ck = Filter().critical_frequency(0.05).lowpass()
    b, p = normal.from_cookbook(ba_ck)
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.normal(size=(1024, 3)))
    _, yn = normal.block(b, p, normal.init((3,), torch.float64, device=CPU),
                         xs)
    _, yd = biquad.df1_process(
        torch.from_numpy(biquad.from_cookbook(ba_ck)),
        biquad.df1_init((3,), torch.float64, device=CPU), xs)
    ratio = ((np.abs(np.fft.rfft(yn.numpy()[200:], axis=0)) + 1e-9)
             / (np.abs(np.fft.rfft(yd.numpy()[200:], axis=0)) + 1e-9))
    med = np.median(ratio, axis=0)
    assert (np.median(np.abs(ratio / med - 1.0), axis=0) < 0.2).all()


# --- RPLL (K37) ---------------------------------------------------------------


def _rpll_streams(cfg, c, t, rng):
    """4 operating points tiled over the lanes (the kernel's config is
    shared, the timestamp streams differ per lane), as
    tests/test_structures_pallas.py:90-121 makes them."""
    xs = np.zeros((t, c), np.int32)
    valids = np.zeros((t, c), bool)
    for k, period in enumerate((333, 217, 1024, 89)):
        tt = 0
        nxt = np.int32(100 + 7 * k)
        for i in range(t):
            if np.int32(tt - nxt) >= 0:
                xs[i, k::4] = nxt
                valids[i, k::4] = True
                nxt = np.int32(nxt + period + rng.integers(-3, 4))
            tt = np.int32(tt + (1 << cfg.dt2))
    return xs, valids


def test_rpll_config_and_checks():
    with pytest.raises(AssertionError):
        rpll.RpllConfig(dt2=8, shift_frequency=7, shift_phase=9)
    with pytest.raises(AssertionError):
        rpll.RpllConfig(dt2=8, shift_frequency=9, shift_phase=7)
    for bad in (rpll.RpllConfig(8, 41, 9), rpll.RpllConfig(8, 9, 40),
                rpll.RpllConfig(32, 40, 40)):
        with pytest.raises(ValueError):
            rpll_bank(bad, rpll.init((4,), device=CPU),
                      torch.zeros((8, 4), dtype=torch.int32),
                      torch.zeros((8, 4), dtype=torch.bool))


def test_rpll_block_equals_jax_and_interpret_kernel():
    rng = np.random.default_rng(14)
    cfg = rpll.RpllConfig(dt2=8, shift_frequency=12, shift_phase=11)
    jcfg = jrpll.RpllConfig(dt2=8, shift_frequency=12, shift_phase=11)
    xs, valids = _rpll_streams(cfg, C, T, rng)
    jst = jrpll.init((C,))
    want = jrpll.block(jcfg, jst, jnp.asarray(xs), jnp.asarray(valids))
    kern = jrpll_bank(jcfg, jst, jnp.asarray(xs), jnp.asarray(valids),
                      time_chunk=128, interpret=True)
    for a, b in zip(jax.tree_util.tree_leaves(kern),
                    jax.tree_util.tree_leaves(want), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    st = to_torch(jst, CPU)
    got = rpll_bank_plain(cfg, st, _t(xs), _t(valids))
    _eq(got, want)
    _eq(rpll_bank(cfg, st, _t(xs), _t(valids)), want)
    # one step, and two halves against one block
    s1, out1 = rpll.step(cfg, st, _t(xs[0]), _t(valids[0]))
    _eq((s1, out1), jrpll.step(jcfg, jst, jnp.asarray(xs[0]),
                               jnp.asarray(valids[0])))
    h = T // 2
    sa, (ya, fa) = rpll.block(cfg, st, _t(xs[:h]), _t(valids[:h]))
    sb, (yb, fb) = rpll.block(cfg, sa, _t(xs[h:]), _t(valids[h:]))
    _eq((sb, (torch.cat([ya, yb]), torch.cat([fa, fb]))), want)


@pytest.mark.parametrize("sf", [9, 12, 32, 36, 40])
def test_rpll_equals_golden_and_jax(sf):
    """Full-range timestamps and state, a timestamp in 3 of 10 cycles: the
    port's scan equals the C golden model lane by lane and JAX's scan, at
    shifts below, at and above 32 (the TPU kernel's three cases)."""
    rng = np.random.default_rng(sf)
    c, t = 16, 128
    cfg = rpll.RpllConfig(dt2=8, shift_frequency=sf, shift_phase=11)
    xs = _i32(rng, (t, c))
    valids = rng.random((t, c)) < 0.3
    jst = jrpll.RpllState(
        x=jnp.asarray(_i32(rng, c)),
        ff=jnp.asarray(rng.integers(0, 2**32, c).astype(np.uint32)),
        f=jnp.asarray(rng.integers(0, 2**32, c).astype(np.uint32)),
        y=jnp.asarray(_i32(rng, c)))
    st, (ph, fr) = rpll_bank_plain(cfg, to_torch(jst, CPU), _t(xs),
                                   _t(valids))
    words = np.stack([np.asarray(v).view(np.int32) for v in jst], axis=1)
    for lane in range(c):
        g_st, g_ph, g_fr = golden.rpll(8, sf, 11, words[lane].copy(),
                                       xs[:, lane].copy(),
                                       valids[:, lane].copy())
        np.testing.assert_array_equal(ph.numpy()[:, lane], g_ph)
        np.testing.assert_array_equal(fr.numpy()[:, lane], g_fr)
        np.testing.assert_array_equal(
            [int(w[lane]) for w in st], g_st)
    _eq((st, (ph, fr)), jrpll.block(
        jrpll.RpllConfig(dt2=8, shift_frequency=sf, shift_phase=11), jst,
        jnp.asarray(xs), jnp.asarray(valids)))


def test_rpll_default_scenario():
    """The reference's default scenario (rpll.rs:208-213; dt2 8, shifts
    9/8, period 333, noise 0) on the port's scan, within the limits of
    tests/test_loops.py:262-266."""
    cfg = rpll.RpllConfig(dt2=8, shift_frequency=9, shift_phase=8)
    period, first, n = 333, 111, 1 << 14
    t_settle = (1 << (cfg.shift_frequency - cfg.dt2 + 4)) + (
        1 << (cfg.shift_phase - cfg.dt2 + 4))
    rows = t_settle + n
    tt = np.arange(rows, dtype=np.int64) << cfg.dt2
    # noise 0: a timestamp in the first cycle whose time reaches it
    xs = np.zeros(rows, np.int32)
    valids = np.zeros(rows, bool)
    nxt = first
    dphase = np.zeros(rows, np.int64)
    for i in range(rows):
        if tt[i] - nxt >= 0:
            xs[i], valids[i] = nxt, True
            nxt += period
        dphase[i] = tt[i] - nxt
    _, (ys, fs) = rpll.block(cfg, rpll.init((1,), device=CPU),
                             _t(xs[:, None]), _t(valids[:, None]))
    ys = ys.numpy()[t_settle:, 0].astype(np.int64)
    fs = fs.numpy()[t_settle:, 0].astype(np.int64)
    y_err = (ys - dphase[t_settle:] * 2.0**32 / period) / 2.0**32
    y_err -= np.round(y_err)
    f_err = ((fs & 0xFFFFFFFF).astype(np.float64) * period
             - (1 << (32 + cfg.dt2))) / 2.0 ** (32 + cfg.dt2)
    m = [f_err.mean(), f_err.std() / np.sqrt(n), y_err.mean(),
         y_err.std() / np.sqrt(n)]
    for val, lim in zip(m, [1e-11, 4e-8, 2e-8, 2e-8]):
        assert abs(val) <= lim, m


# --- WDF (K38-K40) ------------------------------------------------------------

ALL_TYPES = [0xA, 0xB, 0xE, 0x1, 0xC, 0xF, 0xD, 0x0]
ALL_G = [0.7, 0.3, 0.2, 0.0, -0.3, -0.45, -0.8, 0.0]


def test_wdf_quantize_and_nibbles_equal_jax():
    for m, n in ((0xAD, 2), (0x1C, 2), (0x1D, 3), (0x1234_5678_9ABC_DEF0, 16)):
        assert [int(v) for v in wdf.nibbles(m, n)] == [
            int(v) for v in jwdf.nibbles(m, n)]
    tp, jtp = ([mod.Tpa(v) for v in ALL_TYPES] for mod in (wdf, jwdf))
    np.testing.assert_array_equal(wdf.quantize(tp, ALL_G),
                                  jwdf.quantize(jtp, ALL_G))
    with pytest.raises(ValueError):
        wdf.quantize([wdf.Tpa.A], [0.2])  # a = -0.8 outside [-0.5, 0]


@pytest.mark.parametrize("per_lane", [False, True])
def test_wdf_block_every_adapter_type_equals_jax(per_lane):
    """A chain of all eight adapter types, full-range input and state,
    every add wrapping: `step` and `block` bit for bit; with
    ``per_lane`` one coefficient set per lane (a (c, N) array)."""
    rng = np.random.default_rng(5 + per_lane)
    c = 64
    tp, jtp = ([mod.Tpa(v) for v in ALL_TYPES] for mod in (wdf, jwdf))
    a = wdf.quantize(tp, ALL_G)
    if per_lane:
        a = np.stack([wdf.quantize(tp, np.array(ALL_G) * s)
                      for s in rng.uniform(0.9, 1.0, c)])
    xs = _i32(rng, (96, c))
    jst = jwdf.WdfState(z=jnp.asarray(_i32(rng, (c, 8))))
    st = to_torch(jst, CPU)
    _eq(wdf.step(tp, a, st, _t(xs[0])),
        jwdf.step(jtp, jnp.asarray(a), jst, jnp.asarray(xs[0])))
    _eq(wdf.block(tp, a, st, _t(xs)),
        jwdf.block(jtp, jnp.asarray(a), jst, jnp.asarray(xs)))


def _wdf_case(kind, rng):
    """(port call, JAX interpret-kernel call) of one K38-K40 case on the
    same seeded input and random carried state."""
    xs = _i32(rng, (T, C), 2**24)
    spec = CA19 if kind.endswith("19") else CA7
    (jb0, b0), (jb1, b1) = _stages(spec[0]), _stages(spec[1])
    z = [[_i32(rng, (C, n)) for _, n, _ in br] for br in spec]
    js = [[jwdf.WdfState(z=jnp.asarray(v)) for v in br] for br in z]
    ps = [[wdf.WdfState(z=_t(v)) for v in br] for br in z]
    kw = {"time_chunk": 128, "interpret": True}
    if kind == "bank":
        (jtp, ja), (tp, a) = jb0[0], b0[0]
        return ((wdf_bank_plain, wdf_bank), (tp, a, ps[0][0], _t(xs)),
                lambda: jwdf_bank(jtp, ja, js[0][0], jnp.asarray(xs), **kw))
    if kind.startswith("chain"):
        return ((wdf_chain_bank_plain, wdf_chain_bank), (b0, ps[0], _t(xs)),
                lambda: jwdf_chain_bank(jb0, js[0], jnp.asarray(xs), **kw))
    return ((wdf_pair_bank_plain, wdf_pair_bank), (b0, b1, ps, _t(xs)),
            lambda: jwdf_pair_bank(jb0, jb1, js, jnp.asarray(xs), **kw))


@pytest.mark.parametrize("kind", ["bank", "chain-ca7", "chain-ca19",
                                  "pair-ca7", "pair-ca19"])
def test_wdf_kernels_plain_equal_interpret_kernels(kind):
    """K38 (ca-7's first chain), K39 (ca-7's and ca-19's branch 0) and K40
    (both pairs) plain, and the wrappers on the CPU, against the JAX
    package's interpret-mode kernels, bit for bit."""
    rng = np.random.default_rng(len(kind))
    fns, args, jax_call = _wdf_case(kind, rng)
    want = jax_call()
    for fn in fns:
        _eq(fn(*args), want)


def test_wdf_allpass_is_allpass():
    """|H| = 1 at all frequencies (tests/test_structures.py:62-77)."""
    tpas = wdf.nibbles(0xAD, 2)
    a = wdf.quantize(tpas, [-0.9, 0.9])
    rng = np.random.default_rng(2)
    xs = (rng.normal(size=(4096, 2)) * (1 << 24)).astype(np.int32)
    _, ys = wdf_bank(tpas, a, wdf.init(2, (2,), device=CPU), _t(xs))
    w = np.hanning(4096 - 512)[:, None]
    sx = np.abs(np.fft.rfft(xs[512:].astype(np.float64) * w, axis=0))
    sy = np.abs(np.fft.rfft(ys.numpy()[512:].astype(np.float64) * w, axis=0))
    ratio = sy[10:-10] / np.maximum(sx[10:-10], 1.0)
    assert (np.abs(np.median(ratio, axis=0) - 1.0) < 0.05).all()


def test_wdf_ca7_complementary_halfband():
    """wdf-ca-7: the sum is a half-band lowpass, the difference the
    highpass, |L|^2 + |H|^2 ~ 4|X|^2 (tests/test_structures.py:80-114)."""
    (_, b0), (_, b1) = _stages(CA7[0]), _stages(CA7[1])
    sts = ([wdf.init(2, (2,), device=CPU), wdf.init(2, (2,), device=CPU)],
           [wdf.init(2, (2,), device=CPU), wdf.init(1, (2,), device=CPU)])
    rng = np.random.default_rng(3)
    xs = (rng.normal(size=(4096, 2)) * (1 << 22)).astype(np.int32)
    _, (lp, hp) = wdf_pair_bank(b0, b1, sts, _t(xs))
    w = np.hanning(4096 - 512)[:, None]

    def power(v):
        return np.abs(np.fft.rfft(np.asarray(v, np.float64)[512:] * w,
                                  axis=0)) ** 2

    sl, sh, sx = power(lp.numpy()), power(hp.numpy()), power(xs)
    m = sl.shape[0]
    assert (sl[:m // 4].sum(0) > 10 * sl[3 * m // 4:].sum(0)).all()
    assert (sh[3 * m // 4:].sum(0) > 2 * sh[:m // 4].sum(0)).all()
    total = (sl + sh)[10:m - 10] / np.maximum(4 * sx[10:m - 10], 1.0)
    assert (np.abs(np.median(total, axis=0) - 1.0) < 0.1).all()


def test_wdf_ca19_halfband_response():
    """wdf-ca-19 (Gazsi 1985 Example 5): unit DC gain after the pair's /2,
    passband ripple within +-1e-5 dB, stopband below -75 dB
    (tests/test_structures.py:150-200)."""
    (_, b0), (_, b1) = _stages(CA19[0]), _stages(CA19[1])
    sts = tuple([wdf.init(n, (1,), device=CPU) for _, n, _ in br]
                for br in CA19)
    x = np.zeros((4096, 1), np.int32)
    x[0] = 1 << 27
    _, (ysum, _) = wdf_pair_bank(b0, b1, sts, _t(x))
    mag = np.abs(np.fft.rfft(ysum.numpy()[:, 0].astype(np.float64)
                             / (1 << 28)))
    f = np.linspace(0, 0.5, len(mag))
    pb, sb = mag[f < 0.20], mag[f > 0.30]
    assert abs(mag[0] - 1.0) < 1e-5
    assert 20 * np.log10(pb.max()) < 1e-5
    assert 20 * np.log10(pb.min()) > -1e-5
    assert 20 * np.log10(sb.max()) < -75.0


# --- convert ------------------------------------------------------------------


def test_convert_structure_states_round_trip():
    rng = np.random.default_rng(9)
    jsv = _svf_state(rng, 8)
    jr = jrpll.RpllState(
        x=jnp.asarray(_i32(rng, 8)),
        ff=jnp.asarray(np.array([0, 1, 2**31, 2**32 - 1] * 2, np.uint32)),
        f=jnp.asarray(rng.integers(0, 2**32, 8).astype(np.uint32)),
        y=jnp.asarray(_i32(rng, 8)))
    jw = jwdf.WdfState(z=jnp.asarray(_i32(rng, (8, 3))))
    sv, r, w = (to_torch(v, CPU) for v in (jsv, jr, jw))
    assert isinstance(sv, svf.SvfState) and isinstance(r, rpll.RpllState)
    assert isinstance(w, wdf.WdfState)
    # the u32 words as int32 bit patterns: 2^32 - 1 is -1
    assert r.ff.dtype == torch.int32 and r.ff.tolist()[:4] == [
        0, 1, -(2**31), -1]
    for got, want in ((sv, jsv), (r, jr), (w, jw)):
        back = to_numpy(got)
        for g, v in zip(back, want, strict=True):
            assert g.dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(g, np.asarray(v))


def test_plain_versions_keep_the_input_device():
    """Every result of the plain versions lies on the input's device, with
    numpy coefficients: checked on the meta device, which runs the same
    ops without values."""
    meta = torch.device("meta")
    c, t = 8, 4

    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=meta)

    b, p = _normal_q()
    (_, b0), (_, b1) = _stages(CA7[0]), _stages(CA7[1])
    sts = ([wdf.init(2, (c,), device=meta), wdf.init(2, (c,), device=meta)],
           [wdf.init(2, (c,), device=meta), wdf.init(1, (c,), device=meta)])
    outs = [
        svf_bank_plain(0.1, 1.0, svf.init((c,), device=meta),
                       z((t, c), torch.float32), output="br"),
        normal_bank_q_plain(b, p, normal.init((c,), torch.int32,
                                              device=meta), z((t, c)), 29),
        normal_bank_f32_plain(b, p, normal.init((c,), device=meta),
                              z((t, c), torch.float32)),
        rpll_bank_plain(rpll.RpllConfig(8, 12, 11),
                        rpll.init((c,), device=meta), z((t, c)),
                        z((t, c), torch.bool)),
        wdf_pair_bank_plain(b0, b1, sts, z((t, c))),
    ]
    leaves = jax.tree_util.tree_leaves(outs)
    assert leaves and all(v.device == meta for v in leaves)
    assert fxp.wrap_i32(z(3, torch.int64)).device == meta
