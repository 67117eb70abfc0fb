"""Port parity for the anti-windup (clamped) DF1 and the depth-1/2 fused
cascades: `biquad.clamp_step`, K18 `df1_clamp_bank_q`, K19
`df1_clamp_hbf_cascade_bank`, the ``clamp=`` of K3
`fastlo_ddc_cascade_bank` and K12 `fastlo_df1_dec_bank`, K20
`df1_hbf1_bank` and K21 `df1_hbf12_bank`.

The JAX side runs its Pallas entry points with ``interpret=True``, as its
own tests do (tests/test_biquad_pallas.py:132-155, 662-827, 882-1055);
the port's wrappers get CPU tensors and so run their plain PyTorch
versions.  Tolerances are the JAX package's own:

* `clamp_step`, K18 and the integer state of K19-K21 bit for bit (the
  offset wraps as int32 addition; ``lo > hi`` gives ``hi``);
* f32 FIR outputs within k * spacing(max |DF1 output|): K19 16, K20 4,
  K21 8 (its stage-2 tail 4), since XLA may contract the FIR's
  multiply-adds into FMAs where PyTorch rounds each operation;
* the fast-LO forms (K3, K12 with ``clamp=``) within the fast-mix gates of
  tests/test_biquad_pallas.py:1049-1055: x-state within 32 LSB, output
  rms difference < 1e-5 of the rms (the f32 mix rounds differently where
  XLA contracts ``a*b - c*d``; the clamp is 1-Lipschitz).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import hbf as jhbf
from idsp_tpu.filters.biquad_pallas import (
    df1_clamp_bank_q as j_df1_clamp_bank_q,
)
from idsp_tpu.filters.ddc_pallas import (
    df1_clamp_hbf_cascade_bank as j_df1_clamp_hbf_cascade_bank,
    df1_hbf1_bank as j_df1_hbf1_bank,
    df1_hbf12_bank as j_df1_hbf12_bank,
    fastlo_ddc_cascade_bank as j_fastlo_ddc_cascade_bank,
    fastlo_df1_dec_bank as j_fastlo_df1_dec_bank,
    hbf1_tail_init as j_hbf1_tail_init,
)

from idsp_tpu_torch.convert import from_jax, to_numpy, to_torch
from idsp_tpu_torch.filters import biquad
from idsp_tpu_torch.filters.biquad_cuda import df1_clamp_bank_q
from idsp_tpu_torch.filters.ddc_bank_cuda import fastlo_df1_dec_bank
from idsp_tpu_torch.filters.ddc_cuda import (
    df1_clamp_hbf_cascade_bank,
    df1_hbf1_bank,
    df1_hbf12_bank,
    fastlo_ddc_cascade_bank,
)

CPU = torch.device("cpu")
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
# (u, lo, hi) of tests/test_biquad_pallas.py:896, where the clamp engages
# on the peaks of the DF1 output
CLAMP_PEAKS = (1 << 10, -(1 << 26), 1 << 26)
# on a mixed stream the lowpass output is smaller: these bounds engage
# there (a few % of the rows at 0.02)
CLAMP_MIXED = (1 << 10, -(1 << 23), 1 << 23)


def _i32(rng, shape, lo=I32_MIN, hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _ba_q(fc):
    return jbiquad.quantize_ba(
        jbiquad.from_cookbook(JFilter().critical_frequency(fc).lowpass()), 29)


def _bound(k, ys):
    return k * np.spacing(np.float32(np.abs(np.asarray(ys)).max()))


def _pinned(ys, lo, hi):
    """Share of outputs pinned at a bound: > 0 proves the clamp engaged."""
    ys = np.asarray(ys)
    return float(((ys == lo) | (ys == hi)).mean())


def _fast_gates(sx, sx_ref, y, y_ref):
    """tests/test_biquad_pallas.py:1049-1055."""
    dx = np.asarray(sx, np.int64) - np.asarray(sx_ref, np.int64)
    assert np.abs(dx).max() <= 32, np.abs(dx).max()
    ya = np.asarray(y_ref, np.float64)
    yb = np.asarray(y, np.float64)
    rms_sig = np.sqrt((ya**2).mean()) + 1.0
    rms_d = np.sqrt(((ya - yb) ** 2).mean())
    assert rms_d < 1e-5 * rms_sig, (rms_d, rms_sig)


CLAMP_CASES = {
    "peaks": (12345, -(2**28), 2**28),  # test_biquad_pallas.py:140
    "wrap": (I32_MAX - 7, I32_MIN, I32_MAX),  # y0 + u overflows int32
    "lo_gt_hi": (0, 1 << 20, -(1 << 20)),  # jnp.clip: every output is hi
}


@pytest.mark.parametrize("case", sorted(CLAMP_CASES))
def test_clamp_step_int32_bitexact_vs_jax(case):
    u, lo, hi = CLAMP_CASES[case]
    c = 256
    rng = np.random.default_rng(60)
    ba = _ba_q(0.1)
    jst = jbiquad.Df1State(x=jnp.asarray(_i32(rng, (c, 2))),
                           y=jnp.asarray(_i32(rng, (c, 2))))
    st = to_torch(jst, CPU)
    for _ in range(4):
        x = _i32(rng, (c,))
        jst, jy = jbiquad.clamp_step(
            jbiquad.df1_step_q(jnp.asarray(ba), 29, jst, jnp.asarray(x)),
            jnp.int32(u), jnp.int32(lo), jnp.int32(hi))
        st, y = biquad.clamp_step(
            biquad.df1_step_q(ba, 29, st, torch.from_numpy(x)), u, lo, hi)
        assert y.dtype == torch.int32
        for got, want in ((y, jy), (st.x, jst.x), (st.y, jst.y)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "lo_gt_hi":
        assert (y == hi).all()


def test_clamp_step_float64_offset_and_inf_bounds():
    # BiquadClamp doctests (biquad.rs:125-156, tests/test_biquad.py:108-117):
    # u, min and max act at the summing junction
    ba = torch.zeros(5, dtype=torch.float64)
    st = biquad.df1_init((), torch.float64, device=CPU)
    x0 = torch.tensor(0.0, dtype=torch.float64)
    for (u, lo, hi), want in (((5.0, -np.inf, np.inf), 5.0),
                              ((0.0, 5.0, np.inf), 5.0),
                              ((0.0, -np.inf, -5.0), -5.0)):
        jst, jy = jbiquad.clamp_step(
            jbiquad.df1_step(jnp.asarray(np.zeros(5)),
                             jbiquad.df1_init((), jnp.float64),
                             jnp.float64(0.0)), u, lo, hi)
        new, y = biquad.clamp_step(biquad.df1_step(ba, st, x0), u, lo, hi)
        assert y.dtype == torch.float64
        assert float(y) == want == float(jy)
        np.testing.assert_array_equal(new.y.numpy(), np.asarray(jst.y))


def test_clamped_scan_equals_step_by_step():
    # df1_clamp_process_q (the block form with the feed-forward sums made
    # at once) against the literal scan of clamp_step(df1_step_q(...))
    c, t = 16, 96
    rng = np.random.default_rng(61)
    ba = _ba_q(0.05)
    for u, lo, hi in CLAMP_CASES.values():
        st0 = biquad.Df1State(x=torch.from_numpy(_i32(rng, (c, 2))),
                              y=torch.from_numpy(_i32(rng, (c, 2))))
        xs = torch.from_numpy(_i32(rng, (t, c)))
        st_b, ys_b = biquad.df1_clamp_process_q(ba, 29, st0, xs, u=u, lo=lo,
                                                hi=hi)
        st = st0
        for i in range(t):
            st, y0 = biquad.clamp_step(biquad.df1_step_q(ba, 29, st, xs[i]),
                                       u, lo, hi)
            np.testing.assert_array_equal(y0.numpy(), ys_b[i].numpy())
        np.testing.assert_array_equal(st.x.numpy(), st_b.x.numpy())
        np.testing.assert_array_equal(st.y.numpy(), st_b.y.numpy())


@pytest.mark.parametrize("case", ["peaks", "wrap"])
def test_df1_clamp_bank_q_plain_bitexact_vs_jax_kernel(case):
    """K18's plain version against the interpret-mode JAX kernel."""
    u, lo, hi = CLAMP_CASES[case]
    c, t = 128, 512
    rng = np.random.default_rng(62)
    ba = _ba_q(0.1)
    jst = jbiquad.Df1State(x=jnp.asarray(_i32(rng, (c, 2))),
                           y=jnp.asarray(_i32(rng, (c, 2))))
    st = to_torch(jst, CPU)
    for _ in range(3):
        xs = _i32(rng, (t, c))
        jst, jys = j_df1_clamp_bank_q(jnp.asarray(ba), jst, jnp.asarray(xs),
                                      29, u=u, lo=lo, hi=hi, time_chunk=128,
                                      interpret=True)
        st, ys = df1_clamp_bank_q(ba, st, torch.from_numpy(xs), 29, u=u,
                                  lo=lo, hi=hi)
        assert ys.dtype == torch.int32
        for got, want in ((ys, jys), (st.x, jst.x), (st.y, jst.y)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("depth", [1, 3])
def test_df1_clamp_hbf_cascade_plain_vs_jax_kernel(depth):
    """K19's plain version against the interpret-mode JAX kernel: state
    bit for bit, outputs and tails within 16 ULP of the DF1 scale, and the
    clamp engaged (inputs in +-2^28 put the peaks past 2^26)."""
    u, lo, hi = CLAMP_PEAKS
    c2, t = 128, 512
    taps = tuple(jhbf.HBF_TAPS[2 - d] for d in range(depth))
    rng = np.random.default_rng(63)
    ba = _ba_q(0.02)
    jst = jbiquad.df1_init((c2,), jnp.int32)
    jtails = tuple(j_hbf1_tail_init(c2, len(tv)) for tv in taps)
    st, tails = to_torch((jst, jtails), CPU)
    pinned = 0.0
    for _ in range(3):
        xs = _i32(rng, (t, c2), -(2**28), 2**28)
        _, ys = biquad.df1_clamp_process_q(ba, 29, st, torch.from_numpy(xs),
                                           u=u, lo=lo, hi=hi)
        pinned = max(pinned, _pinned(ys.numpy(), lo, hi))
        jst, jtails, jy = j_df1_clamp_hbf_cascade_bank(
            jnp.asarray(ba), jst, jtails, jnp.asarray(xs), 29, u=u, lo=lo,
            hi=hi, taps=taps, time_chunk=128, interpret=True)
        st, tails, y = df1_clamp_hbf_cascade_bank(
            ba, st, tails, torch.from_numpy(xs), 29, u=u, lo=lo, hi=hi,
            taps=taps)
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
        np.testing.assert_array_equal(st.y.numpy(), np.asarray(jst.y))
        bound = _bound(16, ys.numpy())
        assert tuple(y.shape) == jy.shape == (t >> depth, c2)
        assert np.abs(y.numpy() - np.asarray(jy)).max() <= bound
        for a, b in zip(to_numpy(tails), jtails):
            assert a.shape == b.shape
            assert np.abs(a - np.asarray(b)).max() <= bound
    assert pinned > 0


def test_fastlo_cascade_clamp_plain_vs_jax_kernel():
    """K3's ``clamp=`` (plain) against the interpret-mode JAX kernel at a
    chunk JAX keeps (t = 512, time chunk 128), with the fast-mix gates."""
    u, lo, hi = CLAMP_MIXED
    c, t, tc = 128, 512, 128
    c2 = 2 * c
    taps = tuple(jhbf.HBF_TAPS[2 - d] for d in range(3))
    rng = np.random.default_rng(64)
    ba = _ba_q(0.02)
    p0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    jst = jbiquad.df1_init((c2,), jnp.int32)
    jtails = tuple(j_hbf1_tail_init(c2, len(tv)) for tv in taps)
    _, st, tails, ph, stp = from_jax(ba, jst, jtails, p0, steps, CPU)
    jph = jnp.asarray(p0)
    for _ in range(3):
        x = _i32(rng, (t,), -(2**27), 2**27)
        jst, jtails, jph, jy = j_fastlo_ddc_cascade_bank(
            jnp.asarray(ba), jst, jtails, jph, jnp.asarray(steps),
            jnp.asarray(x), 29, clamp=(u, lo, hi), taps=taps, time_chunk=tc,
            interpret=True)
        st, tails, ph, y = fastlo_ddc_cascade_bank(
            ba, st, tails, ph, stp, torch.from_numpy(x), 29,
            clamp=(u, lo, hi), time_chunk=tc)
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jph))
        _fast_gates(st.x.numpy(), jst.x, y.numpy(), jy)
        # the clamped DF1 state: pinned words prove the clamp engaged
        assert _pinned(np.asarray(jst.y), lo, hi) > 0


def test_fastlo_df1_dec_bank_clamp_plain_vs_jax_kernel():
    """K12's ``clamp=`` (plain) against the interpret-mode JAX kernel at
    c = 128, d = 16, time chunk 128, the bank's lowpass at 0.004."""
    u, lo, hi = (1 << 10, -(1 << 22), 1 << 22)
    c, t, d = 128, 256, 16
    rng = np.random.default_rng(65)
    ba = _ba_q(0.004)
    phase0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    jst, jph = jbiquad.df1_init((2 * c,), jnp.int32), jnp.asarray(phase0)
    st, ph = biquad.df1_init((2 * c,), device=CPU), torch.from_numpy(phase0)
    pinned = 0.0
    for _ in range(3):
        x = _i32(rng, (t,), -(2**27), 2**27)
        jst, jph, jy = j_fastlo_df1_dec_bank(
            ba, jst, jph, jnp.asarray(steps), jnp.asarray(x), 29, d=d,
            clamp=(u, lo, hi), time_chunk=128, interpret=True)
        st, ph, y = fastlo_df1_dec_bank(
            ba, st, ph, torch.from_numpy(steps), torch.from_numpy(x), 29, d=d,
            clamp=(u, lo, hi), time_chunk=128)
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jph))
        assert y.dtype == torch.int32 and tuple(y.shape) == (t // d, 2 * c)
        _fast_gates(st.x.numpy(), jst.x, y.numpy(), jy)
        pinned = max(pinned, _pinned(y.numpy(), lo, hi))
    assert pinned > 0


def test_df1_hbf1_bank_plain_vs_jax_kernel():
    """K20's plain version against the interpret-mode JAX kernel
    (tests/test_biquad_pallas.py:662-708): integer state and the stage-1
    tail bit for bit, output within 4 ULP of the DF1 scale."""
    c2, t = 128, 256
    m = len(jhbf.HBF_TAPS[2])
    rng = np.random.default_rng(66)
    ba = _ba_q(0.02)
    jst, jtail = jbiquad.df1_init((c2,), jnp.int32), j_hbf1_tail_init(c2, m)
    st, tail = to_torch((jst, jtail), CPU)
    for _ in range(3):
        xs = _i32(rng, (t, c2), -(2**27), 2**27)
        jst, jtail, jy2 = j_df1_hbf1_bank(jnp.asarray(ba), jst, jtail,
                                          jnp.asarray(xs), 29, time_chunk=64,
                                          unroll=4, interpret=True)
        _, ys = biquad.df1_process_q(ba, 29, st, torch.from_numpy(xs))
        st, tail, y2 = df1_hbf1_bank(ba, st, tail, torch.from_numpy(xs), 29,
                                     time_chunk=64)
        for got, want in ((st.x, jst.x), (st.y, jst.y), (tail, jtail)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tuple(y2.shape) == jy2.shape == (t // 2, c2)
        assert np.abs(y2.numpy() - np.asarray(jy2)).max() <= _bound(
            4, ys.numpy())


def test_df1_hbf12_bank_plain_vs_jax_kernel():
    """K21's plain version against the interpret-mode JAX kernel
    (tests/test_biquad_pallas.py:778-827): integer state and the stage-1
    odd tail bit for bit, the stage-2 tail within 4 and the output within
    8 ULP of the DF1 scale."""
    c2, t = 128, 256
    m1, m2 = len(jhbf.HBF_TAPS[2]), len(jhbf.HBF_TAPS[1])
    rng = np.random.default_rng(67)
    ba = _ba_q(0.02)
    jst = jbiquad.df1_init((c2,), jnp.int32)
    jt1, jt2 = j_hbf1_tail_init(c2, m1), j_hbf1_tail_init(c2, m2)
    st, t1, t2 = to_torch((jst, jt1, jt2), CPU)
    for _ in range(3):
        xs = _i32(rng, (t, c2), -(2**27), 2**27)
        jst, jt1, jt2, jy4 = j_df1_hbf12_bank(jnp.asarray(ba), jst, jt1, jt2,
                                              jnp.asarray(xs), 29,
                                              time_chunk=64, interpret=True)
        _, ys = biquad.df1_process_q(ba, 29, st, torch.from_numpy(xs))
        st, t1, t2, y4 = df1_hbf12_bank(ba, st, t1, t2, torch.from_numpy(xs),
                                        29, time_chunk=64)
        for got, want in ((st.x, jst.x), (st.y, jst.y),
                          (t1[:2 * m1 - 1], jt1[:2 * m1 - 1])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert np.abs(t2.numpy() - np.asarray(jt2)).max() <= _bound(
            4, ys.numpy())
        assert tuple(y4.shape) == jy4.shape == (t // 4, c2)
        assert np.abs(y4.numpy() - np.asarray(jy4)).max() <= _bound(
            8, ys.numpy())


def test_clamp_wrappers_reject_bounds_outside_int32():
    st = biquad.df1_init((128,), device=CPU)
    xs = torch.zeros((16, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        df1_clamp_bank_q(_ba_q(0.1), st, xs, 29, u=2**31, lo=0, hi=1)
    with pytest.raises(ValueError):
        biquad.df1_clamp_process_q(_ba_q(0.1), 29, st, xs, lo=I32_MIN - 1,
                                   hi=0)
