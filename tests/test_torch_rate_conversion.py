"""Port parity for BASELINE #4, rate conversion: half-band interpolation,
CIC, the plain versions of K7-K10 and `pipelines.rate_conversion`
against `idsp_tpu`.

Tolerances are the JAX package's own:

* CIC: wrapping int32 arithmetic, state and outputs bit for bit, also
  against the interpret-mode Pallas kernels `cic_dec_bank` /
  `cic_int_bank` (tests/test_cic_pallas.py);
* half-band f32 FIR outputs and carried tails within 16 *
  spacing(max |y|) (tests/test_hbf_pallas.py:23-27): XLA may contract a
  multiply-add into an FMA where PyTorch rounds each operation;
  stage-0 tails are copies of the input and equal bit for bit;
* the depth-4 round trip within 32 * spacing
  (tests/test_hbf_pallas.py:151); the composite decimator's CIC state
  bit for bit, its output within 16 * spacing
  (tests/test_rate_ddc_bank.py:302-333);
* the three quality gates of tests/test_rate_ddc_bank.py:11-54 at their
  own sizes, on the port.

The JAX half-band kernels' interpret-mode tests are slow-marked, and
JAX holds those kernels to `hbf.hbf_*_cascade(axis=0)`; so do these
tests for K7/K8's plain versions.  The port's wrappers get CPU tensors
here and run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import cic as jcic
from idsp_tpu.filters import hbf as jhbf
from idsp_tpu.filters.cic_pallas import (
    cic_dec_bank as j_cic_dec_bank,
    cic_int_bank as j_cic_int_bank,
)
from idsp_tpu.pipelines import rate_conversion as jrc

from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.filters import cic, hbf
from idsp_tpu_torch.filters.cic_cuda import (
    cic_dec_bank,
    cic_dec_bank_plain,
    cic_int_bank,
    cic_int_bank_plain,
)
from idsp_tpu_torch.filters.hbf_cuda import (
    hbf_dec_cascade_bank,
    hbf_dec_cascade_bank_plain,
    hbf_int_cascade_bank,
    hbf_int_cascade_bank_plain,
    pick_chunk,
)
from idsp_tpu_torch.pipelines import rate_conversion as rc
from idsp_tpu_torch.pipelines.rate_conversion import RateConvState, RoundTrip

CPU = torch.device("cpu")
CIC_CASES = [(3, 1, 15), (2, 2, 3), (4, 1, 4)]


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _f32(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _ulp_gate(have, want, k):
    """|have - want| <= k * spacing(max |want|) (tests/test_hbf_pallas.py)."""
    have, want = np.asarray(have), np.asarray(want)
    assert have.shape == want.shape, (have.shape, want.shape)
    scale = np.float32(max(np.abs(want).max(), 1.0))
    err = np.abs(have.astype(np.float64) - want).max()
    assert err <= k * np.spacing(scale), (err, k * np.spacing(scale))


def _eq(have, want):
    for a, b in zip(jax.tree.leaves(to_numpy(have)), jax.tree.leaves(want),
                    strict=True):
        b = np.asarray(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _int_states_gate(states, jstates, k=16):
    np.testing.assert_array_equal(states[0].x.numpy(),
                                  np.asarray(jstates[0].x))
    for s, js in zip(states[1:], jstates[1:], strict=True):
        _ulp_gate(s.x.numpy(), js.x, k)


def _dec_states_gate(states, jstates, k=16):
    np.testing.assert_array_equal(states[0].odd.numpy(),
                                  np.asarray(jstates[0].odd))
    np.testing.assert_array_equal(states[0].even.numpy(),
                                  np.asarray(jstates[0].even))
    for s, js in zip(states[1:], jstates[1:], strict=True):
        _ulp_gate(s.odd.numpy(), js.odd, k)
        _ulp_gate(s.even.numpy(), js.even, k)


# --- half-band interpolation ------------------------------------------------


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_hbf_int_cascade_vs_jax(depth, axis):
    c, t = 12, 96
    rng = np.random.default_rng(40 + depth)
    jstates = jhbf.hbf_int_cascade_init(depth, (c,), axis=axis)
    states = to_torch(jstates, CPU)
    j_cascade = jax.jit(lambda s, x: jhbf.hbf_int_cascade(s, x, axis=axis))
    for _ in range(3):
        x = _f32(rng, (t, c) if axis == 0 else (c, t))
        jstates, jy = j_cascade(jstates, jnp.asarray(x))
        states, y = hbf.hbf_int_cascade(states, torch.from_numpy(x),
                                        axis=axis)
        assert y.dtype == torch.float32
        _ulp_gate(y.numpy(), jy, 16)
    _int_states_gate(states, jstates)


@pytest.mark.parametrize("axis", [0, -1])
def test_hbf_int_block_vs_jax(axis):
    c, n = 8, 40
    rng = np.random.default_rng(45)
    taps = jhbf.HBF_TAPS[1]
    jst = jhbf.hbf_int_init(len(taps), (c,), axis=axis)
    st = to_torch(jst, CPU)
    for _ in range(2):
        x = _f32(rng, (n, c) if axis == 0 else (c, n))
        jst, jy = jhbf.hbf_int_block(taps, jst, jnp.asarray(x), axis=axis)
        st, y = hbf.hbf_int_block(taps, st, torch.from_numpy(x), axis=axis)
        _ulp_gate(y.numpy(), jy, 16)
        # the odd output slots are the M-delayed input: exact copies
        odd = y[1::2] if axis == 0 else y[..., 1::2]
        jodd = np.asarray(jy)[1::2] if axis == 0 else np.asarray(jy)[:, 1::2]
        np.testing.assert_array_equal(odd.numpy(), jodd)
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_hbf_response_lengths_match_jax(depth):
    assert hbf.hbf_dec_response_length(depth) == \
        jhbf.hbf_dec_response_length(depth)
    assert hbf.hbf_int_response_length(depth) == \
        jhbf.hbf_int_response_length(depth)
    assert rc.group_delay(depth) == jrc.group_delay(depth)


# --- CIC ------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("n,m,rate", CIC_CASES)
def test_cic_blocks_bitexact_vs_jax(n, m, rate, axis):
    c = 8
    r = rate + 1
    t = 12 * r
    rng = np.random.default_rng(50 + n + axis)
    lim = 2**31 // jcic.gain(rate, n, m) // 4
    shape = (t, c) if axis == 0 else (c, t)
    jdec = jint = jcic.init(n, m, (c,))
    dec = itp = to_torch(jdec, CPU)
    assert isinstance(dec, cic.CicState)
    for _ in range(3):
        x = _i32(rng, shape)  # full range: the decimator wraps by design
        jdec, jy = jcic.decimate_block(jdec, jnp.asarray(x), rate, axis=axis)
        dec, y = cic.decimate_block(dec, torch.from_numpy(x), rate, axis=axis)
        _eq((dec, y), (jdec, jy))
        xl = _i32(rng, shape, -lim, lim)
        jint, jyi = jcic.interpolate_block(jint, jnp.asarray(xl), rate,
                                           axis=axis)
        itp, yi = cic.interpolate_block(itp, torch.from_numpy(xl), rate,
                                        axis=axis)
        _eq((itp, yi), (jint, jyi))


@pytest.mark.parametrize("n,m,rate", CIC_CASES)
def test_cic_step_mirrors_equal_blocks(n, m, rate):
    c, r = 4, rate + 1
    t = 5 * r
    rng = np.random.default_rng(55 + n)
    x = torch.from_numpy(_i32(rng, (c, t)))
    st0 = cic.init(n, m, (c,), device=CPU)
    blk_st, blk_y = cic.decimate_block(st0, x, rate)
    st, index, ys = st0, 0, []
    for k in range(t):
        st, index, (emit, y) = cic.decimate_step(st, x[:, k], index, rate)
        if bool(emit):
            ys.append(y)
    _eq((st, torch.stack(ys, dim=-1)), to_numpy((blk_st, blk_y)))

    lim = 2**31 // cic.gain(rate, n, m) // 4
    xl = torch.from_numpy(_i32(rng, (c, 5), -lim, lim))
    blk_st, blk_y = cic.interpolate_block(st0, xl, rate)
    st, index, ys = st0, 0, []
    for k in range(5 * r):
        valid = k % r == 0
        st, index, y = cic.interpolate_step(
            st, (xl[:, k // r], valid), index, rate)
        ys.append(y)
    _eq((st, torch.stack(ys, dim=-1)), to_numpy((blk_st, blk_y)))


def test_cic_helpers_match_jax():
    for rate, n, m in ((15, 3, 1), (3, 2, 2), (4, 4, 1), (0, 1, 1)):
        assert cic.gain(rate, n, m) == jcic.gain(rate, n, m)
        assert cic.gain_log2(rate, n, m) == jcic.gain_log2(rate, n, m)
        assert cic.response_length(rate, n) == jcic.response_length(rate, n)
    want = jcic.settle_interpolate(7, 3, 2, jnp.asarray([5, -3], jnp.int32),
                                   (2,))
    got = cic.settle_interpolate(7, 3, 2, [5, -3], (2,), device=CPU)
    _eq(got, want)
    with pytest.raises(NotImplementedError):
        cic.settle_decimate(7, 3, 1, 0)


# --- K9 / K10 plain versions against the interpret-mode JAX kernels ---------


@pytest.mark.parametrize("n,m,rate", CIC_CASES)
def test_cic_bank_plain_vs_jax_kernels(n, m, rate):
    c = 128  # the JAX kernels take c % 128 == 0
    r = rate + 1
    rng = np.random.default_rng(60 + n)
    jdec = jint = jcic.init(n, m, (c,))
    dec = itp = to_torch(jdec, CPU)
    lim = 2**31 // jcic.gain(rate, n, m) // 4
    for _ in range(2):
        x = _i32(rng, (16 * r, c))  # whole rows of the kernel's unroll 4
        jdec, jy = j_cic_dec_bank(jdec, jnp.asarray(x), rate,
                                  time_chunk=16 * r, interpret=True)
        dec, y = cic_dec_bank(dec, torch.from_numpy(x), rate)
        _eq((dec, y), (jdec, jy))
        xl = _i32(rng, (8, c), -lim, lim)
        jint, jyi = j_cic_int_bank(jint, jnp.asarray(xl), rate,
                                   time_chunk=8 * r, interpret=True)
        itp, yi = cic_int_bank(itp, torch.from_numpy(xl), rate)
        assert tuple(yi.shape) == (8 * r, c)
        _eq((itp, yi), (jint, jyi))


# --- K7 / K8 plain versions -----------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_hbf_cascade_bank_plain_vs_jax(depth):
    c, t = 16, 256
    rng = np.random.default_rng(70 + depth)
    jdec = jhbf.hbf_dec_cascade_init(depth, (c,), axis=0)
    jint = jhbf.hbf_int_cascade_init(depth, (c,), axis=0)
    dec, itp = to_torch((jdec, jint), CPU)
    j_dec = jax.jit(lambda s, x: jhbf.hbf_dec_cascade(s, x, axis=0))
    j_int = jax.jit(lambda s, x: jhbf.hbf_int_cascade(s, x, axis=0))
    for _ in range(3):
        x = _f32(rng, (t, c))
        jdec, jy = j_dec(jdec, jnp.asarray(x))
        dec, y = hbf_dec_cascade_bank(dec, torch.from_numpy(x))
        assert tuple(y.shape) == (t >> depth, c)
        _ulp_gate(y.numpy(), jy, 16)
        xl = _f32(rng, (t >> depth, c))
        jint, jyi = j_int(jint, jnp.asarray(xl))
        itp, yi = hbf_int_cascade_bank(itp, torch.from_numpy(xl))
        assert tuple(yi.shape) == (t, c)
        _ulp_gate(yi.numpy(), jyi, 16)
    _dec_states_gate(dec, jdec)
    _int_states_gate(itp, jint)


def test_hbf_cascade_bank_plain_chunking_changes_no_word():
    c, t, depth = 8, 512, 4
    rng = np.random.default_rng(75)
    x = torch.from_numpy(_f32(rng, (t, c)))
    dec0 = hbf.hbf_dec_cascade_init(depth, (c,), axis=0, device=CPU)
    a = hbf_dec_cascade_bank_plain(dec0, x, time_chunk=64)
    b = hbf_dec_cascade_bank_plain(dec0, x, time_chunk=256)
    _eq(a, to_numpy(b))
    _eq(a, to_numpy(hbf_dec_cascade_bank_plain(dec0, x)))
    int0 = hbf.hbf_int_cascade_init(depth, (c,), axis=0, device=CPU)
    xl = x[: t >> depth].contiguous()
    a = hbf_int_cascade_bank_plain(int0, xl, time_chunk=4)
    b = hbf_int_cascade_bank_plain(int0, xl, time_chunk=16)
    _eq(a, to_numpy(b))
    _eq(a, to_numpy(hbf_int_cascade_bank_plain(int0, xl)))


def test_pick_chunk():
    assert pick_chunk(32768, 512, 16) == 512
    assert pick_chunk(48, 512, 16) == 48
    assert pick_chunk(96, 64, 16) == 48
    assert pick_chunk(2048, 64, 1) == 64
    assert pick_chunk(100, 64, 1) == 50
    with pytest.raises(ValueError):
        pick_chunk(100, 512, 16)


# --- the slice as a whole ---------------------------------------------------


def test_round_trip_t_depth4_vs_jax():
    c, t = 16, 512
    rng = np.random.default_rng(80)
    jst = jrc.init_t(4, (c,))
    st = to_torch(jax.tree.map(np.asarray, jst), CPU)
    assert isinstance(st, RateConvState)
    modes = {m: (RoundTrip(m, 4, c, device=CPU), st) for m in ("scan",
                                                             "kernel")}
    j_rt = jax.jit(jrc.round_trip_t)
    for _ in range(2):
        x = _f32(rng, (t, c))
        jst, jy = j_rt(jst, jnp.asarray(x))
        for m, (mod, s) in modes.items():
            s, y = mod(s, torch.from_numpy(x))
            modes[m] = (mod, s)
            assert tuple(y.shape) == (t, c)
            _ulp_gate(y.numpy(), jy, 32)
    # within the port, scan and kernel modes run the same plain code here
    _eq(modes["kernel"][1], to_numpy(modes["scan"][1]))


def test_round_trip_time_last_vs_jax():
    c, t = 4, 256
    rng = np.random.default_rng(81)
    jst = jrc.init(3, (c,))
    st = to_torch(jax.tree.map(np.asarray, jst), CPU)
    j_rt = jax.jit(jrc.round_trip)
    for _ in range(2):
        x = _f32(rng, (c, t))
        jst, jy = j_rt(jst, jnp.asarray(x))
        st, y = rc.round_trip(st, torch.from_numpy(x))
        _ulp_gate(y.numpy(), jy, 32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_cic_hbf_decimate_t_vs_jax(use_kernel):
    # tests/test_rate_ddc_bank.py:302-333: CIC by 4, then HBF by 4
    cic_rate, depth, c, t = 3, 2, 16, 16 * 64
    rng = np.random.default_rng(82)
    jcs = jcic.init(3, 1, (c,))
    jhs = jhbf.hbf_dec_cascade_init(depth, (c,), axis=0)
    cs, hs = to_torch((jcs, jhs), CPU)
    j_dec = jax.jit(jrc.cic_hbf_decimate_t, static_argnums=(3, 4))
    for _ in range(2):
        x = _i32(rng, (t, c), -(2**20), 2**20)
        (jcs, jhs), jy = j_dec(jcs, jhs, jnp.asarray(x), cic_rate, depth)
        (cs, hs), y = rc.cic_hbf_decimate_t(cs, hs, torch.from_numpy(x),
                                            cic_rate, depth,
                                            use_kernel=use_kernel)
        assert tuple(y.shape) == (t // 16, c)
        _eq(cs, jcs)
        _ulp_gate(y.numpy(), jy, 16)


def test_cic_hbf_decimate_time_last_vs_jax():
    cic_rate, depth, c, t = 4, 2, 4, 20 * 16
    rng = np.random.default_rng(83)
    jcs, jhs = jcic.init(3, 1, (c,)), jhbf.hbf_dec_cascade_init(depth, (c,))
    cs, hs = to_torch((jcs, jhs), CPU)
    x = _i32(rng, (c, t), -(2**20), 2**20)
    j_dec = jax.jit(jrc.cic_hbf_decimate, static_argnums=(3, 4))
    (jcs, jhs), jy = j_dec(jcs, jhs, jnp.asarray(x), cic_rate, depth)
    (cs, hs), y = rc.cic_hbf_decimate(cs, hs, torch.from_numpy(x), cic_rate,
                                      depth)
    _eq(cs, jcs)
    _ulp_gate(y.numpy(), jy, 16)


def test_gate_round_trip_tone():
    # tests/test_rate_ddc_bank.py:11-25 on the port
    depth, n = 4, 1 << 14
    f = 0.4 / (1 << depth) * 0.5
    x = np.cos(2 * np.pi * f * np.arange(n)).astype(np.float32)
    st = rc.init(depth, device=CPU)
    st, y = rc.round_trip(st, torch.from_numpy(x))
    p_in = (x[4096:].astype(np.float64) ** 2).mean()
    p_out = (y.numpy()[4096:].astype(np.float64) ** 2).mean()
    assert abs(p_out / p_in - 1.0) < 1e-3


def test_gate_stopband_kill():
    # tests/test_rate_ddc_bank.py:28-38 on the port
    depth, n = 2, 1 << 13
    x = np.cos(2 * np.pi * 0.35 * np.arange(n)).astype(np.float32)
    st = rc.init(depth, device=CPU)
    st, y = rc.round_trip(st, torch.from_numpy(x))
    p_out = (y.numpy()[2048:].astype(np.float64) ** 2).mean()
    assert p_out < 0.5 * 10 ** (-98 / 10)


def test_gate_composite_dc_gain():
    # tests/test_rate_ddc_bank.py:41-54 on the port
    cic_rate, depth, n = 4, 2, 20 * 64
    x = torch.full((n,), 1000, dtype=torch.int32)
    cs = cic.init(3, 1, device=CPU)
    hs = hbf.hbf_dec_cascade_init(depth, device=CPU)
    (cs, hs), y = rc.cic_hbf_decimate(cs, hs, x, cic_rate, depth)
    g = cic.gain(cic_rate, 3, 1) * (1 << depth)
    assert abs(float(y[-1]) / (1000 * g) - 1.0) < 1e-3


# --- state conversion, devices, bad input ---------------------------------


@pytest.mark.parametrize("which", ["cic", "hbf_int", "rate_conv"])
def test_convert_round_trips(which):
    rng = np.random.default_rng(90)
    c = 8
    if which == "cic":
        ref = jcic.init(3, 2, (c,))
        ref = jcic.CicState(*(jnp.asarray(_i32(rng, v.shape)) for v in ref))
    elif which == "hbf_int":
        ref = jhbf.HbfIntState(x=jnp.asarray(_f32(rng, (19, c))))
    else:
        ref = jax.tree.map(lambda v: jnp.asarray(_f32(rng, v.shape)),
                           jrc.init_t(4, (c,)))
    port = to_torch(jax.tree.map(np.asarray, ref), CPU)
    assert type(port).__name__ == type(ref).__name__
    _eq(port, ref)
    back = to_numpy(port)
    assert type(back).__name__ == type(ref).__name__
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_round_trip_module_defaults_to_the_card():
    # the entry point runs on the card unless the caller asks for the CPU
    assert RoundTrip("kernel").device == torch.device("cuda")
    assert RoundTrip("scan", device="cpu").init_state().dec[0].odd.device \
        == CPU


def test_rejects_bad_input():
    st = cic.init(3, 1, (4,), device=CPU)
    with pytest.raises(ValueError):  # int64 input
        cic_dec_bank(st, torch.zeros((32, 4), dtype=torch.int64), 15)
    with pytest.raises(ValueError):  # int64 input
        cic_int_bank_plain(st, torch.zeros((2, 4), dtype=torch.int64), 15)
    with pytest.raises(ValueError):  # t % R != 0
        cic_dec_bank_plain(st, torch.zeros((30, 4), dtype=torch.int32), 15)
    dec = hbf.hbf_dec_cascade_init(2, (4,), axis=0, device=CPU)
    with pytest.raises(ValueError):  # int32 where f32 is wanted
        hbf_dec_cascade_bank(dec, torch.zeros((32, 4), dtype=torch.int32))
    st_t = rc.init_t(2, (4,), device=CPU)
    x = torch.zeros((32, 4))
    with pytest.raises(NotImplementedError, match="items 16-17"):
        rc.round_trip_t(st_t, x, use_kernel="mxu")
    with pytest.raises(NotImplementedError, match="items 16-17"):
        rc.cic_hbf_decimate_t(st, dec, torch.zeros((32, 4), dtype=torch.int32), 3,
                              2, use_kernel="mxu")
    with pytest.raises(ValueError):
        RoundTrip("mxu")
