"""The three precisions of K22/K23's plain versions
(`filters/hbf_mxu.py`) against JAX and against numpy references.

``precision`` keeps the TPU's meaning (idsp_tpu/filters/hbf_pallas.py
:426-434): "split3" is three bf16 products Wh.Xh + Wh.Xl + Wl.Xh with
f32 sums, "default" one bf16 pass Wh.Xh, "highest" the band's f32 sum.
Inputs are made with numpy from a seed, c small, both tap tables, depths
1-4, from a random carried state.  The scale is max |y|.  Tolerances:

* "split3" against the interpret-mode JAX kernels at "split3": the same
  products summed in another order, so 1e-6 at depth 1; at depths 2-4 a
  last-bit difference in a stage output can move the next stage's lo
  part by one of its ulps, about 2^-16 of the value, and two such moves
  under the band's largest weights stay within 2^-15 of the scale;
* "default" against an explicit numpy one-pass emulation (both operands
  rounded to bf16, nearest even; the exact products summed in float64,
  rounded once a stage): 1e-6 at depth 1, where only the sums' order
  differs, 2^-6 at depths 2-4, where a last-bit difference in a stage
  output can flip the bf16 rounding of the next stage's input (a weight
  up to 1 times 2^-8).  JAX's CPU path is no reference for "default":
  XLA's f32 dot on the CPU does not round its operands;
* against the float64 truth (the band of float64 taps in float64):
  "highest" 1e-6, "split3" 2^-15 (hi + lo is within 2^-17 of a stage's
  input and of a weight; K23's center rows pass that error on at every
  stage: up to 1.7e-5 measured at depth 4), "default" 1e-2;
* "highest": bit for bit against the f32 sums of the port before the
  precisions (ascending band columns, one rounding a multiply and an
  add), within 1e-6 of the interpret-mode JAX kernels at "highest";
* K23's odd rows (the center copies, band weight 1): exactly ``xh + xl``
  ("split3") or ``xh`` ("default"); the stage-0 carries are the input;
* two half blocks against one, and the wrappers' ``block``/``sub``: bit
  for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import hbf as jhbf
from idsp_tpu.filters import hbf_pallas as jp

from idsp_tpu_torch.filters import hbf, hbf_mxu
from idsp_tpu_torch.filters.hbf_mxu import (
    hbf_dec_cascade_mxu,
    hbf_dec_cascade_mxu_plain,
    hbf_int_cascade_mxu,
    hbf_int_cascade_mxu_plain,
)

CPU = torch.device("cpu")
TAPS = {"140dB": (hbf.HBF_TAPS, jhbf.HBF_TAPS),
        "98dB": (hbf.HBF_TAPS_98, jhbf.HBF_TAPS_98)}
DEPTHS = (1, 2, 3, 4)


def _bf16(a):
    """float32 -> nearest-even bf16, held in float32 (numpy bit trick)."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _stage_taps(taps, depth, kind):
    order = range(depth - 1, -1, -1) if kind == "dec" else range(depth)
    return [np.asarray(taps[i], np.float64) for i in order]


def _band(tv, kind):
    """A stage's band row: K22 4m-1 entries (taps on even entries, the
    unit center at 2m-1, mirrored taps), K23's FIR row 2m."""
    m = len(tv)
    if kind == "dec":
        b = np.zeros(4 * m - 1)
        b[0:2 * m:2] = tv
        b[2 * m:4 * m - 1:2] = tv[::-1]
        b[2 * m - 1] = 1.0
        return b
    return np.concatenate([tv, tv[::-1]])


def _window(state, m, kind):
    """The carried rows before the block (K22: 4m-2 full-rate rows, the
    even rows below 2m 0; K23: 2m-1 rows), numpy."""
    if kind == "dec":
        odd, even = (np.asarray(v) for v in state)
        w = np.zeros((4 * m - 2,) + odd.shape[1:], odd.dtype)
        w[1::2] = odd
        w[2 * m::2] = even
        return w
    return np.asarray(state[0])


def _reference(states, x, taps, depth, kind, mode):
    """numpy cascade: ``mode`` "default" (bf16 operands, exact products
    summed in float64, one f32 rounding a stage) or "truth" (float64
    taps and data).  Returns (y, [stage windows after the block])."""
    cur = np.asarray(x, np.float64 if mode == "truth" else np.float32)
    tails = []
    for st, tv in zip(states, _stage_taps(taps, depth, kind)):
        m = len(tv)
        if mode == "truth":
            band = _band(tv, kind)
            ext = np.concatenate([_window(st, m, kind).astype(np.float64),
                                  cur])
            data = ext
        else:
            band = _bf16(_band(tv.astype(np.float32), kind)).astype(
                np.float64)
            ext = np.concatenate([_window(st, m, kind), cur])
            data = _bf16(ext).astype(np.float64)
        n = cur.shape[0]
        if kind == "dec":
            n //= 2
            out = sum(band[v] * data[1 + v:1 + v + 2 * n:2]
                      for v in range(4 * m - 1))
        else:
            fir = sum(band[v] * data[v:v + n] for v in range(2 * m))
            out = np.stack([fir, data[m:m + n]], axis=1).reshape(
                (2 * n,) + fir.shape[1:])
        if mode != "truth":
            out = out.astype(np.float32)
        tails.append(ext[ext.shape[0] - (4 * m - 2 if kind == "dec"
                                          else 2 * m - 1):])
        cur = out
    return cur, tails


def _rand_states(rng, depth, c, taps, kind):
    if kind == "dec":
        return tuple(hbf.HbfDecState(*(torch.from_numpy(
            rng.normal(size=tuple(v.shape)).astype(np.float32)) for v in s))
            for s in hbf.hbf_dec_cascade_init(depth, (c,), taps=taps,
                                              axis=0, device=CPU))
    return tuple(hbf.HbfIntState(torch.from_numpy(
        rng.normal(size=tuple(s.x.shape)).astype(np.float32)))
        for s in hbf.hbf_int_cascade_init(depth, (c,), taps=taps, axis=0,
                                          device=CPU))


def _plain(kind):
    return hbf_dec_cascade_mxu_plain if kind == "dec" else \
        hbf_int_cascade_mxu_plain


def _case(kind, depth, name, c=16, seed=0):
    taps = TAPS[name][0]
    rng = np.random.default_rng(100 * depth + seed + (kind == "int"))
    t = 8 << depth if kind == "dec" else 24
    st = _rand_states(rng, depth, c, taps, kind)
    x = rng.normal(size=(t, c)).astype(np.float32)
    return taps, st, x


def _rel(have, want, scale):
    return float(np.abs(np.asarray(have, np.float64)
                        - np.asarray(want, np.float64)).max()) / scale


def _jax_states(states, kind):
    if kind == "dec":
        return tuple(jhbf.HbfDecState(jnp.asarray(s.odd.numpy()),
                                      jnp.asarray(s.even.numpy()))
                     for s in states)
    return tuple(jhbf.HbfIntState(jnp.asarray(s.x.numpy())) for s in states)


def _jax(kind, states, x, depth, name, precision):
    jtaps = TAPS[name][1]
    jst = _jax_states(states, kind)
    if kind == "dec":
        return jp.hbf_dec_cascade_mxu(jst, jnp.asarray(x), taps=jtaps,
                                      block=x.shape[0], sub=8,
                                      precision=precision, interpret=True)
    return jp.hbf_int_cascade_mxu(jst, jnp.asarray(x), taps=jtaps,
                                  block=x.shape[0], sub=8,
                                  precision=precision, interpret=True)


def _flat(states):
    return [np.asarray(v) for s in states for v in s]


@pytest.mark.parametrize("name", sorted(TAPS))
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("kind", ["dec", "int"])
def test_split3_matches_jax(kind, depth, name):
    taps, st, x = _case(kind, depth, name, c=128)
    jst, jy = _jax(kind, st, x, depth, name, "split3")
    new, y = _plain(kind)(st, torch.from_numpy(x), taps=taps,
                          precision="split3")
    sc = float(np.abs(np.asarray(jy)).max())
    tol = 1e-6 if depth == 1 else 2.0 ** -15
    assert _rel(y.numpy(), jy, sc) <= tol
    for a, b in zip(_flat(new), _flat(jst), strict=True):
        assert _rel(a, b, sc) <= tol
    # the stage-0 carry is copies of the input, in JAX as here
    for a, b in zip(_flat(new[:1]), _flat(jst[:1]), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(TAPS))
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("kind", ["dec", "int"])
def test_default_matches_bf16_emulation(kind, depth, name):
    taps, st, x = _case(kind, depth, name)
    want, tails = _reference(st, x, taps, depth, kind, "default")
    new, y = _plain(kind)(st, torch.from_numpy(x), taps=taps,
                          precision="default")
    sc = float(np.abs(want).max())
    tol = 1e-6 if depth == 1 else 2.0 ** -6
    assert _rel(y.numpy(), want, sc) <= tol
    # the carries: the last rows of each stage's input
    for s, tail, tv in zip(new, tails, _stage_taps(taps, depth, kind)):
        m = len(tv)
        parts = ((s.odd, tail[1::2]), (s.even, tail[2 * m::2])) \
            if kind == "dec" else ((s.x, tail),)
        for have, want_rows in parts:
            np.testing.assert_allclose(have.numpy(), want_rows, rtol=0,
                                       atol=tol * sc)


@pytest.mark.parametrize("name", sorted(TAPS))
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("kind", ["dec", "int"])
@pytest.mark.parametrize("precision,tol", [("highest", 1e-6),
                                           ("split3", 2.0 ** -15),
                                           ("default", 1e-2)])
def test_against_float64_truth(kind, depth, name, precision, tol):
    taps, st, x = _case(kind, depth, name, seed=7)
    want, _ = _reference(st, x, taps, depth, kind, "truth")
    _, y = _plain(kind)(st, torch.from_numpy(x), taps=taps,
                        precision=precision)
    assert _rel(y.numpy(), want, float(np.abs(want).max())) <= tol


def _f32_sums(states, x, taps, depth, kind):
    """The port's plain sums before the precisions: per stage the band's
    nonzero columns in ascending order, one f32 multiply and add each."""
    cur = x
    new = []
    for st, tv in zip(states, _stage_taps(taps, depth, kind)):
        tv = tv.astype(np.float32)
        m = len(tv)
        if kind == "dec":
            kp = hbf_mxu.dec_kp(m)
            ext = torch.cat([hbf_mxu._carry_from_state(st, m, kp,
                                                       x.shape[1]), cur])
            cols, w = hbf_mxu.dec_band_row(tv, kp)
            n, step = cur.shape[0] // 2, 2
        else:
            kp = hbf_mxu.int_kp(m)
            ext = torch.cat([hbf_mxu._int_carry_from_state(
                st, kp, x.shape[1]), cur])
            cols, w, center = hbf_mxu.int_band_row(tv, kp)
            n, step = cur.shape[0], 1
        acc = None
        for col, wv in zip(cols, w):
            term = ext[col:col + step * (n - 1) + 1:step] * float(wv)
            acc = term if acc is None else acc + term
        if kind == "int":
            acc = torch.stack([acc, ext[center:center + n]],
                              dim=1).flatten(0, 1)
        new.append(ext[ext.shape[0] - kp:])
        cur = acc
    return new, cur


@pytest.mark.parametrize("name", sorted(TAPS))
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("kind", ["dec", "int"])
def test_highest_unchanged(kind, depth, name):
    taps, st, x = _case(kind, depth, name, c=128)
    xt = torch.from_numpy(x)
    new, y = _plain(kind)(st, xt, taps=taps, precision="highest")
    carries, want = _f32_sums(st, xt, taps, depth, kind)
    assert torch.equal(y, want)
    for s, cr, tv in zip(new, carries, _stage_taps(taps, depth, kind)):
        m = len(tv)
        if kind == "dec":
            got = hbf_mxu._carry_from_state(s, m, hbf_mxu.dec_kp(m),
                                            x.shape[1])
            o = hbf_mxu.dec_kp(m) - (4 * m - 2)
            assert torch.equal(got[o + 1::2], cr[o + 1::2])
        else:
            assert torch.equal(s.x, cr[cr.shape[0] - (2 * m - 1):])
    _, jy = _jax(kind, st, x, depth, name, "highest")
    assert _rel(y.numpy(), jy, float(np.abs(np.asarray(jy)).max())) <= 1e-6


@pytest.mark.parametrize("name", sorted(TAPS))
@pytest.mark.parametrize("precision", ["split3", "default"])
def test_int_center_rows_exact(precision, name):
    # depth 1: the odd rows are the input's center copies, split
    taps, st, x = _case("int", 1, name)
    _, y = hbf_int_cascade_mxu(st, torch.from_numpy(x), taps=taps,
                               precision=precision)
    m = len(taps[0])
    ext = np.concatenate([np.asarray(st[0].x), x])
    xh = _bf16(ext)
    xl = _bf16(ext - xh)
    want = xh if precision == "default" else xh + xl
    np.testing.assert_array_equal(y.numpy()[1::2], want[m:m + x.shape[0]])


@pytest.mark.parametrize("name", sorted(TAPS))
@pytest.mark.parametrize("precision", hbf_mxu.PRECISIONS)
@pytest.mark.parametrize("kind", ["dec", "int"])
def test_stage0_carry_is_the_input(kind, precision, name):
    taps, st, x = _case(kind, 4, name)
    new, _ = _plain(kind)(st, torch.from_numpy(x), taps=taps,
                          precision=precision)
    m = len(_stage_taps(taps, 4, kind)[0])
    if kind == "dec":
        tail = np.concatenate([_window(st[0], m, kind), x])[-(4 * m - 2):]
        np.testing.assert_array_equal(new[0].odd.numpy(), tail[1::2])
        np.testing.assert_array_equal(new[0].even.numpy(), tail[2 * m::2])
    else:
        tail = np.concatenate([_window(st[0], m, kind), x])[-(2 * m - 1):]
        np.testing.assert_array_equal(new[0].x.numpy(), tail)


@pytest.mark.parametrize("name", sorted(TAPS))
@pytest.mark.parametrize("precision", ["split3", "default"])
@pytest.mark.parametrize("kind", ["dec", "int"])
def test_streaming_and_tiles_exact(kind, precision, name):
    taps, st, x = _case(kind, 4, name, c=9, seed=3)
    t = x.shape[0]
    fn = hbf_dec_cascade_mxu if kind == "dec" else hbf_int_cascade_mxu
    xt = torch.from_numpy(x)
    whole = fn(st, xt, taps=taps, precision=precision)
    sa, ya = fn(st, xt[:t // 2], taps=taps, block=32, sub=8,
                precision=precision)
    sb, yb = fn(sa, xt[t // 2:], taps=taps, block=1024, sub=1,
                precision=precision)
    assert torch.equal(whole[1], torch.cat([ya, yb]))
    for a, b in zip(_flat(whole[0]), _flat(sb), strict=True):
        np.testing.assert_array_equal(a, b)
    plain = _plain(kind)(st, xt, taps=taps, precision=precision)
    assert torch.equal(plain[1], whole[1])


def test_split3_impulse_stopband_matches_jax():
    # K23's HBF_TAPS_98 impulse response (tests/test_torch_hbf_mxu.py's
    # test_taps_98_spectrum): bf16x3 rounds each stage's input and weights
    # to about 16 bits, and JAX's "split3" and the port's both land just
    # above the 98 dB line (-97.92 dB), so the 98 dB gate runs "highest"
    depth, c = 4, 128
    r = hbf.hbf_int_response_length(depth, taps=hbf.HBF_TAPS_98)
    x = np.zeros((-(-((r >> depth) + 1) // 8) * 8, c), np.float32)
    x[0] = 1.0
    st = hbf.hbf_int_cascade_init(depth, (c,), taps=hbf.HBF_TAPS_98, axis=0,
                                  device=CPU)
    _, jy = jp.hbf_int_cascade_mxu(
        jhbf.hbf_int_cascade_init(depth, (c,), taps=jhbf.HBF_TAPS_98,
                                  axis=0),
        jnp.asarray(x), taps=jhbf.HBF_TAPS_98, block=8, sub=8,
        precision="split3", interpret=True)
    _, y = hbf_int_cascade_mxu(st, torch.from_numpy(x), taps=hbf.HBF_TAPS_98)
    jy = np.asarray(jy)
    assert _rel(y.numpy(), jy, float(np.abs(jy).max())) <= 1e-6

    def stopband(v):
        v = np.asarray(v)[:, 0].astype(np.float64) / (1 << depth)
        v = np.concatenate([v, np.zeros((5 << 10) - len(v))])
        p = 10.0 * np.log10(np.abs(np.fft.fft(v)) ** 2 + 1e-300)
        f = len(p) / (1 << depth)
        return p[int(np.ceil(f * (1 - hbf.HBF_PASSBAND))):len(p) // 2].max()

    for v in (jy, y.numpy()):
        assert -98.0 < stopband(v) < -97.8
