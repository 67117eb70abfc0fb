"""Port parity for the rest of `filters/hbf.py` (HBF_TAPS_98,
HBF_PASSBAND, `fir_init`/`fir_block`) and for the banded-matrix ("MXU")
half-band cascades K22/K23 (`filters/hbf_mxu.py`) against `idsp_tpu`.

Tolerances are the JAX package's own:

* tap tables, band operators and carry packing: equal (numpy copies);
* `fir_block`: the same f32 operations in the same order as the JAX
  function run eagerly, so equal bit for bit;
* the HBF_TAPS_98 cascade: > 98 dB stopband, < 0.001 dB passband ripple
  (tests/test_hbf.py:64-78);
* K22/K23's plain versions against the interpret-mode JAX kernels
  `hbf_dec_cascade_mxu` / `hbf_int_cascade_mxu` at their default
  precision "split3": outputs and later-stage carries within 1e-5 /
  5e-5 of the output scale, the stage-0 carry (copies of the input)
  equal (tests/test_hbf_pallas.py:180-241).  Both split each f32
  operand into bf16 parts and add three products; the sums' order
  differs, hence a tolerance and not bit equality (the precisions
  themselves: tests/test_torch_hbf_mxu_precision.py);
* streaming (two half blocks against one) and the tile sizes: bit for
  bit;
* the mxu round trip against JAX's within 5e-5 of the scale
  (tests/test_hbf_pallas.py:244-256).

The wrappers get CPU tensors here and run their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import hbf as jhbf
from idsp_tpu.filters import hbf_pallas as jp
from idsp_tpu.pipelines import rate_conversion as jrc

from idsp_tpu_torch.filters import hbf, hbf_mxu
from idsp_tpu_torch.filters.hbf_mxu import (
    hbf_dec_cascade_mxu,
    hbf_dec_cascade_mxu_plain,
    hbf_int_cascade_mxu,
    hbf_int_cascade_mxu_plain,
)
from idsp_tpu_torch.pipelines import rate_conversion as rc
from idsp_tpu_torch.pipelines.rate_conversion import RoundTrip

CPU = torch.device("cpu")
TAPS = {"140dB": hbf.HBF_TAPS, "98dB": hbf.HBF_TAPS_98}


def _f32(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _within(have, want, tol):
    have = np.asarray(have, np.float64)
    want = np.asarray(want, np.float64)
    assert have.shape == want.shape, (have.shape, want.shape)
    err = np.abs(have - want).max()
    assert err < tol, (err, tol)


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# --- the rest of hbf.py ------------------------------------------------------


def test_taps_98_and_passband_equal_jax():
    assert len(hbf.HBF_TAPS_98) == len(jhbf.HBF_TAPS_98)
    for a, b in zip(hbf.HBF_TAPS_98, jhbf.HBF_TAPS_98, strict=True):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert hbf.HBF_PASSBAND == jhbf.HBF_PASSBAND


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("odd,sym", [(True, True), (False, True),
                                     (True, False), (False, False)])
def test_fir_block_matches_jax(odd, sym, axis):
    # tests/test_hbf.py:121-139's four types, streamed over two blocks from
    # a random tail, time last and time-major
    rng = np.random.default_rng(11)
    taps = _f32(rng, (4,))
    c, n = 5, 40
    shape = (hbf.fir_len(4, odd), c) if axis == 0 else (
        c, hbf.fir_len(4, odd))
    st0 = _f32(rng, shape)
    st = torch.from_numpy(st0)
    jst = jnp.asarray(st0)
    for _ in range(2):
        x = _f32(rng, (n, c) if axis == 0 else (c, n))
        st, y = hbf.fir_block(taps, st, torch.from_numpy(x), odd=odd,
                              sym=sym, axis=axis)
        jst, jy = jhbf.fir_block(taps, jst, jnp.asarray(x), odd=odd, sym=sym,
                                 axis=axis)
        np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    init = hbf.fir_init(4, odd, (c,), axis=axis, device=CPU)
    assert tuple(init.shape) == jhbf.fir_init(4, odd, (c,), axis=axis).shape
    assert init.device == CPU and not bool(init.any())


@pytest.mark.parametrize("odd,sym", [(True, True), (False, True),
                                     (True, False), (False, False)])
def test_fir_block_impulse_symmetry(odd, sym):
    # tests/test_hbf.py:121-139 on the port: the full impulse response is
    # symmetric or antisymmetric
    taps = np.array([0.25, 0.5], np.float32)
    x = torch.zeros(16)
    x[0] = 1.0
    _, y = hbf.fir_block(taps, hbf.fir_init(2, odd, device=CPU), x, odd=odd,
                         sym=sym)
    h = y.numpy()[:hbf.fir_len(2, odd) + 1]
    np.testing.assert_allclose(h, h[::-1] if sym else -h[::-1], atol=1e-7)


@pytest.mark.parametrize("mode", ["scan", "mxu"])
def test_taps_98_spectrum(mode):
    # hbf.rs:247-256 (tests/test_hbf.py:64-78): > 98 dB stopband and
    # < 0.001 dB ripple, through the plain cascade and through K23's plain
    # version summing in f32 ("highest"; JAX's bf16x3 "split3" lands just
    # above the 98 dB line on this impulse:
    # test_torch_hbf_mxu_precision.py)
    depth = 4
    r = hbf.hbf_int_response_length(depth, taps=hbf.HBF_TAPS_98)
    x = torch.zeros(((r >> depth) + 1, 1))
    x[0] = 1.0
    states = hbf.hbf_int_cascade_init(depth, (1,), taps=hbf.HBF_TAPS_98,
                                      axis=0, device=CPU)
    if mode == "scan":
        _, y = hbf.hbf_int_cascade(states, x, taps=hbf.HBF_TAPS_98, axis=0)
    else:
        _, y = hbf_int_cascade_mxu(states, x, taps=hbf.HBF_TAPS_98,
                                   precision="highest")
    y = y[:, 0].double().numpy() / (1 << depth)
    y = np.concatenate([y, np.zeros((5 << 10) - len(y))])
    p = 10.0 * np.log10(np.abs(np.fft.fft(y)) ** 2 + 1e-300)
    f = len(p) / (1 << depth)
    assert np.abs(p[:int(np.floor(f * hbf.HBF_PASSBAND))]).max() < 1e-3
    assert p[int(np.ceil(f * (1 - hbf.HBF_PASSBAND))):len(p) // 2].max() \
        < -98.0


# --- band operators and carry packing ----------------------------------------


@pytest.mark.parametrize("name", sorted(TAPS))
def test_band_matrices_equal_jax(name):
    for tv in TAPS[name]:
        m = len(tv)
        for su in (1, 8, 16, 32):
            kp = hbf_mxu.dec_kp(m)
            np.testing.assert_array_equal(
                hbf_mxu._hbf_dec_band_matrix(tv, su, kp),
                jp._hbf_dec_band_matrix(tv, su, kp))
            kp = hbf_mxu.int_kp(m)
            np.testing.assert_array_equal(
                hbf_mxu._hbf_int_band_matrix(tv, su, kp),
                jp._hbf_int_band_matrix(tv, su, kp))
        # the kernel's summation order covers exactly the band's nonzero
        # entries, ascending, with the band's weights
        kp = hbf_mxu.dec_kp(m)
        cols, w = hbf_mxu.dec_band_row(tv, kp)
        row = jp._hbf_dec_band_matrix(tv, 1, kp)[0]
        assert cols == list(np.flatnonzero(row))
        np.testing.assert_array_equal(w, row[cols])
        kp = hbf_mxu.int_kp(m)
        cols, w, center = hbf_mxu.int_band_row(tv, kp)
        band = jp._hbf_int_band_matrix(tv, 1, kp)
        assert cols == list(np.flatnonzero(band[0]))
        np.testing.assert_array_equal(w, band[0, cols])
        assert [center] == list(np.flatnonzero(band[1]))


@pytest.mark.parametrize("m", [2, 3, 5, 23])
def test_carry_packing_equals_jax(m):
    rng = np.random.default_rng(12)
    c = 7
    odd, even = _f32(rng, (2 * m - 1, c)), _f32(rng, (m - 1, c))
    kp = hbf_mxu.dec_kp(m)
    assert kp == -(-(4 * m - 2) // 8) * 8
    carry = hbf_mxu._carry_from_state(
        hbf.HbfDecState(torch.from_numpy(odd), torch.from_numpy(even)), m,
        kp, c)
    jcarry = jp._carry_from_state(
        jhbf.HbfDecState(jnp.asarray(odd), jnp.asarray(even)), m, kp, c)
    np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))
    st = hbf_mxu._state_from_carry(carry, m, kp)
    np.testing.assert_array_equal(st.odd.numpy(), odd)
    np.testing.assert_array_equal(st.even.numpy(), even)
    # the interpolation carry: st.x right-aligned in a kp-row slot
    # (hbf_pallas.py:635-651)
    x = _f32(rng, (2 * m - 1, c))
    kp = hbf_mxu.int_kp(m)
    slot = hbf_mxu._int_carry_from_state(hbf.HbfIntState(torch.from_numpy(x)),
                                         kp, c)
    want = np.zeros((kp, c), np.float32)
    want[kp - (2 * m - 1):] = x
    np.testing.assert_array_equal(slot.numpy(), want)
    np.testing.assert_array_equal(
        hbf_mxu._int_state_from_carry(slot, m, kp).x.numpy(), x)


# --- K22 / K23 plain versions against the interpret-mode JAX kernels ---------


def test_dec_cascade_mxu_matches_jax():
    t, c, depth = 256, 128, 3
    x = _f32(np.random.default_rng(3), (t, c))
    jst, jy = jp.hbf_dec_cascade_mxu(
        jhbf.hbf_dec_cascade_init(depth, (c,), axis=0), jnp.asarray(x),
        block=64, interpret=True)
    st, y = hbf_dec_cascade_mxu(
        hbf.hbf_dec_cascade_init(depth, (c,), axis=0, device=CPU),
        torch.from_numpy(x), block=64)
    sc = float(np.abs(np.asarray(jy)).max())
    _within(y.numpy(), jy, 1e-5 * sc)
    np.testing.assert_array_equal(st[0].odd.numpy(), np.asarray(jst[0].odd))
    np.testing.assert_array_equal(st[0].even.numpy(), np.asarray(jst[0].even))
    for a, b in zip(st[1:], jst[1:], strict=True):
        _within(a.odd.numpy(), b.odd, 1e-5 * sc)
        _within(a.even.numpy(), b.even, 1e-5 * sc)
    # and against the port's shift-form cascade, the same gate
    _, y_ref = hbf.hbf_dec_cascade(
        hbf.hbf_dec_cascade_init(depth, (c,), axis=0, device=CPU),
        torch.from_numpy(x), axis=0)
    _within(y.numpy(), y_ref.numpy(), 1e-5 * sc)


def test_int_cascade_mxu_matches_jax():
    t, c, depth = 64, 128, 3
    x = _f32(np.random.default_rng(3), (t, c))
    jst, jy = jp.hbf_int_cascade_mxu(
        jhbf.hbf_int_cascade_init(depth, (c,), axis=0), jnp.asarray(x),
        block=32, sub=16, interpret=True)
    st, y = hbf_int_cascade_mxu(
        hbf.hbf_int_cascade_init(depth, (c,), axis=0, device=CPU),
        torch.from_numpy(x), block=32, sub=16)
    sc = float(np.abs(np.asarray(jy)).max())
    _within(y.numpy(), jy, 5e-5 * sc)
    np.testing.assert_array_equal(st[0].x.numpy(), np.asarray(jst[0].x))
    for a, b in zip(st[1:], jst[1:], strict=True):
        _within(a.x.numpy(), b.x, 5e-5 * sc)
    _, y_ref = hbf.hbf_int_cascade(
        hbf.hbf_int_cascade_init(depth, (c,), axis=0, device=CPU),
        torch.from_numpy(x), axis=0)
    _within(y.numpy(), y_ref.numpy(), 5e-5 * sc)


@pytest.mark.parametrize("name", sorted(TAPS))
@pytest.mark.parametrize("kind", ["dec", "int"])
def test_mxu_streaming_and_tiles_exact(kind, name):
    # two half blocks == one block, bit for bit, from a random carried
    # state; the tile sizes change no value
    rng = np.random.default_rng(13)
    taps, depth, c = TAPS[name], 4, 9
    if kind == "dec":
        t, fn = 512, hbf_dec_cascade_mxu
        st0 = tuple(hbf.HbfDecState(*(torch.from_numpy(_f32(rng, v.shape))
                                      for v in s))
                    for s in hbf.hbf_dec_cascade_init(depth, (c,), taps=taps,
                                                      axis=0, device=CPU))
    else:
        t, fn = 48, hbf_int_cascade_mxu
        st0 = tuple(hbf.HbfIntState(torch.from_numpy(_f32(rng, s.x.shape)))
                    for s in hbf.hbf_int_cascade_init(depth, (c,), taps=taps,
                                                      axis=0, device=CPU))
    x = torch.from_numpy(_f32(rng, (t, c)))
    st, y = fn(st0, x, taps=taps)
    sa, ya = fn(st0, x[:t // 2], taps=taps, block=32, sub=8)
    sb, yb = fn(sa, x[t // 2:], taps=taps, block=1024, sub=1)
    _equal((st, y), (sb, torch.cat([ya, yb])))
    plain = hbf_dec_cascade_mxu_plain if kind == "dec" else \
        hbf_int_cascade_mxu_plain
    _equal(plain(st0, x, taps=taps), (st, y))


def test_round_trip_mxu_matches_jax():
    t, c, depth = 256, 128, 4
    x = _f32(np.random.default_rng(5), (t, c))
    _, jy = jrc.round_trip_t(jrc.init_t(depth, (c,)), jnp.asarray(x),
                             use_kernel="mxu", interpret=True)
    sc = max(float(np.abs(np.asarray(jy)).max()), 1e-9)
    _, y = rc.round_trip_t(rc.init_t(depth, (c,), device=CPU),
                           torch.from_numpy(x), use_kernel="mxu")
    _within(y.numpy(), jy, 5e-5 * sc)
    mod = RoundTrip("mxu", depth, c, device=CPU)
    st, y_mod = mod(mod.init_state(), torch.from_numpy(x))
    _equal(y_mod, y)
    # the decimator's stage-0 carry is copies of the input: equal to scan's
    # (the interpolator's stage 0 copies the decimated rows, which differ)
    scan = RoundTrip("scan", depth, c, device=CPU)
    st_s, y_s = scan(scan.init_state(), torch.from_numpy(x))
    _equal(st.dec[0], st_s.dec[0])
    _within(y.numpy(), y_s.numpy(), 5e-5 * sc)


def test_round_trip_mxu_taps_98():
    # RoundTrip's taps= reaches both cascades in every mode
    t, c, depth = 128, 4, 4
    x = torch.from_numpy(_f32(np.random.default_rng(6), (t, c)))
    ys = {}
    for m in ("scan", "kernel", "mxu"):
        mod = RoundTrip(m, depth, c, taps=hbf.HBF_TAPS_98, device=CPU)
        st, ys[m] = mod(mod.init_state(), x)
        assert st.dec[-1].odd.shape[0] == 2 * len(hbf.HBF_TAPS_98[0]) - 1
    sc = float(ys["scan"].abs().max())
    _within(ys["mxu"].numpy(), ys["scan"].numpy(), 5e-5 * sc)
    _equal(ys["kernel"], ys["scan"])
    y140 = RoundTrip("mxu", depth, c, device=CPU)(
        RoundTrip("mxu", depth, c, device=CPU).init_state(), x)[1]
    assert not torch.equal(y140, ys["mxu"])


@pytest.mark.parametrize("precision", hbf_mxu.PRECISIONS)
def test_precision_modes(precision):
    # every precision runs (its plain version on CPU tensors); any other
    # name raises ValueError
    st = hbf.hbf_dec_cascade_init(2, (4,), axis=0, device=CPU)
    x = torch.from_numpy(_f32(np.random.default_rng(7), (32, 4)))
    _equal(hbf_dec_cascade_mxu(st, x, precision=precision),
           hbf_dec_cascade_mxu_plain(st, x, precision=precision))
    ist = hbf.hbf_int_cascade_init(2, (4,), axis=0, device=CPU)
    _equal(hbf_int_cascade_mxu(ist, x, precision=precision),
           hbf_int_cascade_mxu_plain(ist, x, precision=precision))
    with pytest.raises(ValueError):
        hbf_int_cascade_mxu(ist, x, precision="bf16")
    with pytest.raises(ValueError):
        hbf_dec_cascade_mxu(st, x, precision="bf16")


def test_mxu_rejects_bad_input():
    st = hbf.hbf_dec_cascade_init(2, (4,), axis=0, device=CPU)
    with pytest.raises(ValueError):  # t % 4 != 0
        hbf_dec_cascade_mxu(st, torch.zeros((30, 4)))
    with pytest.raises(ValueError):  # int32 input
        hbf_dec_cascade_mxu(st, torch.zeros((32, 4), dtype=torch.int32))
    with pytest.raises(ValueError):  # a segment below 2**depth rows
        hbf_dec_cascade_mxu(st, torch.zeros((32, 4)), block=2)
    with pytest.raises(ValueError):  # depth 5
        hbf_dec_cascade_mxu(hbf.hbf_dec_cascade_init(
            5, (4,), axis=0, device=CPU), torch.zeros((64, 4)))
    ist = hbf.hbf_int_cascade_init(2, (4,), axis=0, device=CPU)
    with pytest.raises(ValueError):  # sub 0
        hbf_int_cascade_mxu(ist, torch.zeros((8, 4)), sub=0)
    with pytest.raises(ValueError):  # no rows
        hbf_int_cascade_mxu(ist, torch.zeros((0, 4)))
