"""Port parity: DF1 biquad bank (K1), half-band cascade, fused cascades
(K2, K3) against `idsp_tpu`.

The JAX side runs its Pallas entry points with ``interpret=True``, as
its own tests do; the port's wrappers get CPU tensors and so run their
plain PyTorch versions.  c2 = 128..256 lanes (the JAX kernels need
lanes % 128 == 0), 3 consecutive blocks so carried state is exercised.
Tolerances are the JAX package's own: integer state and outputs bit
for bit; f32 FIR outputs within 16 * spacing(max |DF1 output|)
(tests/test_biquad_pallas.py:875-879), since XLA may contract the FIR's
multiply-adds into FMAs where PyTorch rounds each operation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import hbf as jhbf
from idsp_tpu.filters.biquad_pallas import df1_bank_q as j_df1_bank_q
from idsp_tpu.filters.ddc_pallas import (
    df1_hbf_cascade_bank as j_df1_hbf_cascade_bank,
    fastlo_ddc_cascade_bank as j_fastlo_ddc_cascade_bank,
    hbf1_tail_init as j_hbf1_tail_init,
)

from idsp_tpu_torch.convert import from_jax, to_numpy, to_torch
from idsp_tpu_torch.filters import biquad, hbf
from idsp_tpu_torch.filters.biquad_cuda import df1_bank_q, df1_bank_q_plain
from idsp_tpu_torch.filters.ddc_cuda import (
    df1_hbf_cascade_bank,
    fastlo_ddc_cascade_bank,
)

CPU = torch.device("cpu")
TAPS3 = tuple(jhbf.HBF_TAPS[2 - d] for d in range(3))


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _ba_q(fc=0.02):
    return jbiquad.quantize_ba(
        jbiquad.from_cookbook(JFilter().critical_frequency(fc).lowpass()), 29)


def _fir_bound(ys):
    return 16 * np.spacing(np.float32(np.abs(np.asarray(ys)).max()))


def test_df1_scan_and_bank_bitexact_vs_jax_kernel():
    c, t = 128, 512
    rng = np.random.default_rng(10)
    ba = _ba_q(0.1)
    jst = jbiquad.Df1State(x=jnp.asarray(_i32(rng, (c, 2))),
                           y=jnp.asarray(_i32(rng, (c, 2))))
    st = to_torch(jst, CPU)
    st_bank = st
    for _ in range(3):
        xs = _i32(rng, (t, c))
        jst, jys = j_df1_bank_q(jnp.asarray(ba), jst, jnp.asarray(xs), 29,
                                time_chunk=128, unroll=4, interpret=True)
        st, ys = biquad.df1_process_q(ba, 29, st, torch.from_numpy(xs))
        st_bank, ys_bank = df1_bank_q(ba, st_bank, torch.from_numpy(xs), 29)
        for got_st, got_ys in ((st, ys), (st_bank, ys_bank)):
            assert got_ys.dtype == torch.int32
            np.testing.assert_array_equal(got_ys.numpy(), np.asarray(jys))
            np.testing.assert_array_equal(got_st.x.numpy(), np.asarray(jst.x))
            np.testing.assert_array_equal(got_st.y.numpy(), np.asarray(jst.y))


def test_df1_bank_f32_out_and_step_match_scan():
    c, t = 16, 64
    rng = np.random.default_rng(11)
    ba = _ba_q(0.05)
    st0 = biquad.Df1State(x=torch.from_numpy(_i32(rng, (c, 2))),
                          y=torch.from_numpy(_i32(rng, (c, 2))))
    xs = torch.from_numpy(_i32(rng, (t, c)))
    st_a, ys_a = biquad.df1_process_q(ba, 29, st0, xs)
    st_b, ys_b = df1_bank_q_plain(ba, st0, xs, 29, out_dtype=torch.float32)
    assert ys_b.dtype == torch.float32
    np.testing.assert_array_equal(ys_b.numpy(), ys_a.numpy().astype(np.float32))
    st = st0
    for i in range(t):  # the literal step-by-step scan
        st, y0 = biquad.df1_step_q(ba, 29, st, xs[i])
        np.testing.assert_array_equal(y0.numpy(), ys_a[i].numpy())
    np.testing.assert_array_equal(st.x.numpy(), st_a.x.numpy())
    np.testing.assert_array_equal(st.y.numpy(), st_b.y.numpy())


def test_df1_gain_extremes_bitexact():
    # saturated coefficients and extreme inputs: 5-term int64 sums that
    # wrap, f = 30 (tests/test_biquad_pallas.py:46)
    c, t = 128, 256
    ba = np.array([2**31 - 1, -(2**31), 0x1234_5678, -0x0765_4321, 1],
                  np.int64).astype(np.int32)
    xs = np.tile(
        np.array([2**31 - 1, -(2**31), 0, 1, -1, 0x7FFF, -0x8000],
                 np.int64).astype(np.int32), (t // 7 + 1,)
    )[:t, None].repeat(c, axis=1)
    jst = jbiquad.df1_init((c,), jnp.int32)
    _, jys = j_df1_bank_q(jnp.asarray(ba), jst, jnp.asarray(xs), 30,
                          time_chunk=128, interpret=True)
    _, ys = df1_bank_q(ba, biquad.df1_init((c,), device=CPU),
                       torch.from_numpy(xs), 30)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))


@pytest.mark.parametrize("axis", [0, -1])
def test_hbf_dec_cascade_within_fma_bound(axis):
    c, t = 64, 512
    rng = np.random.default_rng(12 + axis)
    jstates = jhbf.hbf_dec_cascade_init(3, (c,), axis=axis)
    states = to_torch(jstates, CPU)
    j_cascade = jax.jit(lambda s, x: jhbf.hbf_dec_cascade(s, x, axis=axis))
    for _ in range(3):
        x = rng.normal(0, 2**27, size=(t, c) if axis == 0 else (c, t))
        x = x.astype(np.float32)
        jstates, jy = j_cascade(jstates, jnp.asarray(x))
        states, y = hbf.hbf_dec_cascade(states, torch.from_numpy(x),
                                        axis=axis)
        bound = _fir_bound(x)
        assert tuple(y.shape) == jy.shape
        assert np.abs(y.numpy() - np.asarray(jy)).max() <= bound
        for s, js in zip(states, jstates):
            assert np.abs(s.odd.numpy() - np.asarray(js.odd)).max() <= bound
            assert np.abs(s.even.numpy() - np.asarray(js.even)).max() <= bound


def test_df1_hbf_cascade_plain_vs_jax_kernel():
    c2, t = 128, 512
    rng = np.random.default_rng(13)
    ba = _ba_q(0.02)
    jst = jbiquad.df1_init((c2,), jnp.int32)
    jtails = tuple(j_hbf1_tail_init(c2, len(tv)) for tv in TAPS3)
    st, tails = to_torch((jst, jtails), CPU)
    for _ in range(3):
        xs = _i32(rng, (t, c2), -(2**27), 2**27)
        jst, jtails, jy = j_df1_hbf_cascade_bank(
            jnp.asarray(ba), jst, jtails, jnp.asarray(xs), 29, taps=TAPS3,
            time_chunk=128, interpret=True)
        # the DF1 output scale bounds every FIR value downstream
        _, ys = biquad.df1_process_q(ba, 29, st, torch.from_numpy(xs))
        bound = _fir_bound(ys.numpy())
        st, tails, y = df1_hbf_cascade_bank(ba, st, tails,
                                            torch.from_numpy(xs), 29)
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
        np.testing.assert_array_equal(st.y.numpy(), np.asarray(jst.y))
        assert tuple(y.shape) == jy.shape == (t // 8, c2)
        assert np.abs(y.numpy() - np.asarray(jy)).max() <= bound
        for a, b in zip(to_numpy(tails), jtails):
            assert a.shape == b.shape
            assert np.abs(a - np.asarray(b)).max() <= bound


def test_fastlo_cascade_plain_vs_jax_kernel():
    # Gates of tests/test_biquad_pallas.py:987-998: phase exact, x-state
    # within 32 LSB (the f32 mix rounds differently where XLA contracts
    # a*b - c*d into an FMA), output rms difference < 1e-5 of the rms.
    c, t, tc = 128, 512, 128
    c2 = 2 * c
    rng = np.random.default_rng(14)
    ba = _ba_q(0.02)
    p0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    jst = jbiquad.df1_init((c2,), jnp.int32)
    jtails = tuple(j_hbf1_tail_init(c2, len(tv)) for tv in TAPS3)
    _, st, tails, ph, stp = from_jax(ba, jst, jtails, p0, steps, CPU)
    jph = jnp.asarray(p0)
    for _ in range(3):
        x = _i32(rng, (t,), -(2**27), 2**27)
        jst, jtails, jph, jy = j_fastlo_ddc_cascade_bank(
            jnp.asarray(ba), jst, jtails, jph, jnp.asarray(steps),
            jnp.asarray(x), 29, taps=TAPS3, time_chunk=tc, interpret=True)
        st, tails, ph, y = fastlo_ddc_cascade_bank(
            ba, st, tails, ph, stp, torch.from_numpy(x), 29, time_chunk=tc)
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jph))
        dx = st.x.numpy().astype(np.int64) - np.asarray(jst.x, np.int64)
        assert np.abs(dx).max() <= 32, np.abs(dx).max()
        ya = np.asarray(jy, np.float64)
        yb = y.numpy().astype(np.float64)
        rms_sig = np.sqrt((ya**2).mean()) + 1.0
        rms_d = np.sqrt(((ya - yb) ** 2).mean())
        assert rms_d < 1e-5 * rms_sig, (rms_d, rms_sig)


def test_convert_round_trip():
    rng = np.random.default_rng(15)
    jst = jbiquad.Df1State(x=jnp.asarray(_i32(rng, (8, 2))),
                           y=jnp.asarray(_i32(rng, (8, 2))))
    dec = jhbf.hbf_dec_cascade_init(2, (8,), axis=0)
    ba, st, tails, p0, steps = from_jax(_ba_q(), jst, dec, _i32(rng, (4,)),
                                        _i32(rng, (4,)), CPU)
    assert isinstance(st, biquad.Df1State) and st.x.dtype == torch.int32
    assert all(isinstance(s, hbf.HbfDecState) for s in tails)
    back = to_numpy(st)
    np.testing.assert_array_equal(back.x, np.asarray(jst.x))
    np.testing.assert_array_equal(back.y, np.asarray(jst.y))
    for s, js in zip(to_numpy(tails), dec):
        np.testing.assert_array_equal(s.odd, np.asarray(js.odd))
        np.testing.assert_array_equal(s.even, np.asarray(js.even))
