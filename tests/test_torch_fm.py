"""Port parity for BASELINE #1, the FM discriminator
(`idsp_tpu_torch.pipelines.fm_disc`), and the modules under it:
`ops.complex`, the rest of `ops.unwrap`, `trig.atan2_f32_word` and the
plain version of K15 `fm_disc_bank`.

* The integer complex ops, unwrap and `fm_receiver` against the JAX
  package bit for bit, including +-2^31 inputs (the conjugate product's
  sums reach 2^63 there).
* K15's plain version with ``angle="exact"`` against JAX `fm_receiver`
  bit for bit over two carried blocks (the JAX kernel is bit-identical
  to `fm_receiver`, tests/test_structures_pallas.py:124-169; its
  interpret-mode run is in the slow lane), and ``angle="fast"`` within
  1024 LSB of exact (:250-289).
* `atan2_f32_word` within a few LSB of JAX's (XLA may contract the
  Horner steps into FMAs) and within 1e-6 rad of the ideal angle
  (:232-247).
* The reference example's gates (fm_disc.rs:151-157) on the three
  receiver forms, and `FmReceiver`'s modes against each other.

The port's wrappers get CPU tensors here, so they run their plain
versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.ops import complex as jcplx
from idsp_tpu.ops import unwrap as junwrap
from idsp_tpu.filters.ddc_pallas import atan2_f32_word as j_atan2_f32_word
from idsp_tpu.pipelines import fm_disc as jfm

from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.filters.fm_cuda import fm_disc_bank, fm_disc_bank_plain
from idsp_tpu_torch.ops import complex as cplx
from idsp_tpu_torch.ops import unwrap
from idsp_tpu_torch.ops.trig import atan2_f32_word
from idsp_tpu_torch.pipelines import fm_disc
from idsp_tpu_torch.pipelines.fm_disc import MODES, FmReceiver

CPU = torch.device("cpu")
CARRIER = 0x1934_1234  # the example's carrier (< 2^31)
EXTREMES = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 1],
                    dtype=np.int32)


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _parts(rng, n=4000):
    """Four int32 operands: random, then every pair of extremes."""
    a = [_i32(rng, n) for _ in range(4)]
    ext = np.array(np.meshgrid(*[EXTREMES] * 4)).reshape(4, -1)
    return [np.concatenate([v, e]).astype(np.int32) for v, e in zip(a, ext)]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --- ops.complex -------------------------------------------------------------


@pytest.mark.parametrize("f", [0, 16, 31, 32])
def test_mul_q_matches_jax(f):
    parts = _parts(np.random.default_rng(1))
    want = jcplx.mul_q(*[jnp.asarray(p) for p in parts], f)
    got = cplx.mul_q(*_t(*parts), f)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)


def test_norm_sqr_and_ilog2_match_jax():
    rng = np.random.default_rng(2)
    re = np.concatenate([_i32(rng, 3000), EXTREMES.repeat(6)])
    im = np.concatenate([_i32(rng, 3000), np.tile(EXTREMES, 6)])
    # small magnitudes: every bit position of the log
    re = np.concatenate([re, (1 << rng.integers(0, 31, 500)).astype(np.int32)])
    im = np.concatenate([im, np.zeros(500, np.int32)])
    tr, ti = _t(re, im)
    _eq(cplx.norm_sqr_i32(tr, ti), jcplx.norm_sqr_i32(re, im))
    _eq(cplx.ilog2_i32(tr, ti), jcplx.ilog2_i32(re, im))


def test_angle_ops_match_jax():
    rng = np.random.default_rng(3)
    a, b = _i32(rng, 5000), _i32(rng, 5000)
    a[:6], b[:6] = EXTREMES, EXTREMES[::-1]
    ta, tb = _t(a, b)
    for g, w in zip(cplx.from_angle_i32(ta), jcplx.from_angle_i32(a)):
        _eq(g, w)
    _eq(cplx.arg_i32(ta, tb), jcplx.arg_i32(jnp.asarray(a), jnp.asarray(b)))


def test_float_complex_helpers_match_jax():
    rng = np.random.default_rng(4)
    a = [rng.normal(size=1000).astype(np.float32) for _ in range(4)]
    ta = _t(*a)
    ja = [jnp.asarray(v) for v in a]
    for got, want in (
            (cplx.mul(*ta), jcplx.mul(*ja)),
            (cplx.conj(*ta[:2]), jcplx.conj(*ja[:2])),
            (cplx.div(*ta), jcplx.div(*ja)),
            (cplx.from_angle(ta[0]), jcplx.from_angle(ja[0])),
            ((cplx.arg(*ta[:2]),), (jcplx.arg(*ja[:2]),)),
            ((cplx.norm_sqr(*ta[:2]),), (jcplx.norm_sqr(*ja[:2]),))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                       atol=1e-6)


# --- ops.unwrap (the rest of it) ----------------------------------------------


@pytest.mark.parametrize("shift", [1, 8, 31, 32])
def test_saturating_scale_matches_jax(shift):
    rng = np.random.default_rng(5)
    lo = np.concatenate([_i32(rng, 2000), np.tile(EXTREMES, 6)])
    hi = np.concatenate([_i32(rng, 1000), _i32(rng, 1000, -4, 4),
                         EXTREMES.repeat(6)])
    _eq(unwrap.saturating_scale(*_t(lo, hi), shift),
        junwrap.saturating_scale(lo, hi, shift))


def test_unwrap_diffs_wraps_and_clamp_block_match_jax():
    rng = np.random.default_rng(6)
    x = _i32(rng, (3, 500))
    y0 = rng.integers(-(2**40), 2**40, size=3, dtype=np.int64)
    dx, y = unwrap.unwrap_diffs(*_t(x, y0))
    jdx, jy = junwrap.unwrap_diffs(x, y0)
    _eq(dx, jdx)
    _eq(y, jy)
    for s in (1, 16, 32):
        _eq(unwrap.wraps(y, s), junwrap.wraps(jy, s))
    xs = _i32(rng, (400, 8))
    st = unwrap.clamp_wrap_init((8,), device=CPU)
    jst = junwrap.clamp_wrap_init((8,))
    st, ys = unwrap.clamp_wrap_block(st, torch.from_numpy(xs))
    jst, jys = junwrap.clamp_wrap_block(jst, jnp.asarray(xs))
    _eq(ys, jys)
    _eq(st.clamp, jst.clamp)
    _eq(st.x0, jst.x0)


# --- atan2_f32_word -----------------------------------------------------------


def _angle_grid(seed, n=20000):
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(np.log(1e3), np.log(2**62), size=n))
    ang = rng.uniform(-np.pi, np.pi, size=n)
    y = (mag * np.sin(ang)).astype(np.float32)
    x = (mag * np.cos(ang)).astype(np.float32)
    # the axes, the diagonals and zero
    axes = np.array([0, 1, -1, 0, 0, 1, -1, 1, -1], np.float32) * 2.0**40
    axes2 = np.array([0, 0, 0, 1, -1, 1, 1, -1, -1], np.float32) * 2.0**40
    return np.concatenate([y, axes]), np.concatenate([x, axes2])


def test_atan2_f32_word_matches_jax():
    y, x = _angle_grid(7)
    got = atan2_f32_word(*_t(y, x)).numpy().astype(np.int64)
    want = np.asarray(j_atan2_f32_word(jnp.asarray(y), jnp.asarray(x)),
                      np.int64)
    d = np.abs((got - want + 2**31) % 2**32 - 2**31)
    assert d.max() <= 8, d.max()


def test_atan2_f32_word_error_bound():
    y, x = _angle_grid(8)
    w = atan2_f32_word(*_t(y, x)).numpy()
    got = w.astype(np.float64) * np.pi / 2**31
    want = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    err = np.abs(np.angle(np.exp(1j * (got - want))))
    assert err.max() < 1e-6, err.max()


# --- fm_receiver and K15's plain version ------------------------------------


def _random_iq(seed, c, t):
    rng = np.random.default_rng(seed)
    re, im = _i32(rng, (t, c)), _i32(rng, (t, c))
    re[:4], im[:4] = -(2**31), -(2**31)  # the conjugate product's 2^63
    re[4:8, ::2] = 2**31 - 1
    return re, im


def test_fm_receiver_and_kernel_plain_match_jax_over_blocks():
    c, t = 128, 512
    re, im = _random_iq(31, c, t)
    ba = jfm.deemphasis_coefficients(0.02)
    np.testing.assert_array_equal(fm_disc.deemphasis_coefficients(0.02), ba)
    j_st = jfm.init_state((c,))
    # both port paths start from the JAX state, mid-stream after block 0
    st = st_k = None
    for lo, hi in ((0, t // 4), (t // 4, t // 2), (t // 2, t)):
        if st is None and lo > 0:
            st = st_k = to_torch(j_st, CPU)
        j_st, jy = jfm.fm_receiver(j_st, jnp.asarray(re[lo:hi]),
                                   jnp.asarray(im[lo:hi]), jnp.int32(CARRIER),
                                   jnp.asarray(ba))
        if st is None:
            continue
        xr, xi = _t(re[lo:hi], im[lo:hi])
        st, y = fm_disc.fm_receiver(st, xr, xi, CARRIER, ba)
        st_k, yk = fm_disc_bank(ba, st_k, xr, xi, CARRIER)
        _eq(y, jy)
        _eq(yk, jy)
    for got in (st, st_k):
        for g, w in zip(to_numpy(tuple(got)), (j_st.prev_re, j_st.prev_im,
                                               j_st.prev_valid, j_st.deemph)):
            if isinstance(g, tuple):
                _eq(g[0], w.x)
                _eq(g[1], w.y)
            else:
                _eq(g, w)


def test_fm_first_sample_masked_and_mono_shape():
    # the stream's first sample outputs dphi 0 (a state without a previous
    # sample), the receiver takes a mono (t,) stream too
    t = 64
    re, im = _random_iq(32, 1, t)
    ba = jfm.deemphasis_coefficients(0.02)
    _, jy = jfm.fm_receiver(jfm.init_state(), jnp.asarray(re[:, 0]),
                            jnp.asarray(im[:, 0]), jnp.int32(CARRIER),
                            jnp.asarray(ba))
    st, y = fm_disc.fm_receiver(fm_disc.init_state(device=CPU),
                                *_t(re[:, 0], im[:, 0]), CARRIER, ba)
    _eq(y, jy)
    assert bool(st.prev_valid)


def test_fm_fast_angle_tracks_exact():
    c, t = 128, 512
    rng = np.random.default_rng(33)
    ang = rng.uniform(-np.pi, np.pi, size=(t, c))
    mag = rng.uniform(2**28, 2**30, size=(t, c))
    re = torch.from_numpy((mag * np.cos(ang)).astype(np.int32))
    im = torch.from_numpy((mag * np.sin(ang)).astype(np.int32))
    ba = fm_disc.deemphasis_coefficients(0.02)
    st_e = st_f = fm_disc.init_state((c,), device=CPU)
    for lo, hi in ((0, t // 2), (t // 2, t)):
        st_e, y_e = fm_disc_bank_plain(ba, st_e, re[lo:hi], im[lo:hi],
                                       CARRIER)
        st_f, y_f = fm_disc_bank_plain(ba, st_f, re[lo:hi], im[lo:hi],
                                       CARRIER, angle="fast")
        d = (y_f.to(torch.int64) - y_e.to(torch.int64)).abs().max()
        assert int(d) <= 1024, int(d)
    _eq(st_f.prev_re, st_e.prev_re)
    with pytest.raises(ValueError):
        fm_disc_bank_plain(ba, st_e, re, im, CARRIER, angle="approx")


def test_fm_receiver_modes_agree():
    c, t = 64, 256
    re, im = _t(*_random_iq(34, c, t))
    ba = fm_disc.deemphasis_coefficients(0.02)
    outs = {}
    for m in MODES:
        mod = FmReceiver(m, ba, CARRIER, c, device=CPU)
        st = mod.init_state()
        ys = []
        for lo in (0, t // 2):
            st, y = mod(st, re[lo:lo + t // 2], im[lo:lo + t // 2])
            ys.append(y)
        outs[m] = (st, torch.cat(ys))
    for m in ("composed", "kernel"):
        _eq(outs[m][1], outs["scan"][1])
        _eq(outs[m][0].deemph.y, outs["scan"][0].deemph.y)
    d = (outs["kernel_fast"][1].to(torch.int64)
         - outs["kernel"][1].to(torch.int64)).abs().max()
    # random full-scale IQ: the f32 product of tiny-magnitude conjugate
    # products loses the angle, so this gate is loose; the tight one is
    # test_fm_fast_angle_tracks_exact
    assert int(d) < 2**31
    with pytest.raises(ValueError):
        FmReceiver("fast", ba, CARRIER, c, device=CPU)


@pytest.mark.parametrize("kernel", [None, "exact", "fast"])
def test_run_fm_disc_passes_reference_gates(kernel):
    r = fm_disc.run_fm_disc(kernel=kernel, device=CPU)
    assert r["corr"] > 0.999
    assert 0.95 < r["gain"] < 1.05
    assert r["rms"] < 5e-4


def test_fm_signal_matches_jax():
    (re, im), msg = fm_disc.fm_signal(CARRIER, 0x0450_0000, 0.004, 4096,
                                      device=CPU)
    (jre, jim), jmsg = jfm.fm_signal(CARRIER, 0x0450_0000, 0.004, 4096)
    np.testing.assert_allclose(msg.numpy(), np.asarray(jmsg), atol=1e-6)
    # a sine that rounds one ULP apart can move trunc(deviation * msg) by
    # one step; the phase drifts by at most a few such steps
    d = np.abs((re.numpy().astype(np.int64) - np.asarray(jre, np.int64)))
    assert d.max() < 2**12, d.max()
    # the f32 DF1's poles sit near 1 and XLA may contract its steps into
    # FMAs: ~20 ULP after 4096 steps
    np.testing.assert_allclose(
        fm_disc.lowpass_reference(0.02, msg).numpy(),
        np.asarray(jfm.lowpass_reference(0.02, jmsg)), rtol=1e-5, atol=1e-6)
