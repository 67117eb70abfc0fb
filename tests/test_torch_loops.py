"""Port parity: the building blocks of the DDC bank (BASELINE #5) and the
plain versions of its bank kernels K4 `lowpass_bank` and K5 `pll_bank`.

Each case feeds the same numpy input (``default_rng(seed)``) to
`idsp_tpu` and `idsp_tpu_torch`; everything here is integer arithmetic
and must match bit for bit: `atan2` (against the JAX gather lookup),
`clamp_wrap_step`, `lowpass.step/block` (N = 1, 2, saturating input),
`pll.step/block` from a nonzero state over carried blocks, the gain and
coefficient designs, the atan2 seed table (and its copy in
``csrc/atan2.cuh``).  The JAX kernels run with ``interpret=True``, as
their own tests run them; the port's wrappers get CPU tensors and so run
their plain versions.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu import luts as jluts
from idsp_tpu.filters import lowpass as jlowpass
from idsp_tpu.filters import pll as jpll
from idsp_tpu.filters.lowpass_pallas import lowpass_bank as j_lowpass_bank
from idsp_tpu.filters.pll_pallas import pll_bank as j_pll_bank
from idsp_tpu.ops import trig as jtrig
from idsp_tpu.ops import unwrap as junwrap

from idsp_tpu_torch import luts
from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.filters import lowpass, pll
from idsp_tpu_torch.filters.lowpass_cuda import lowpass_bank
from idsp_tpu_torch.filters.pll_cuda import pll_bank
from idsp_tpu_torch.ops import trig, unwrap

CPU = torch.device("cpu")
CSRC = Path(__file__).resolve().parent.parent / "idsp_tpu_torch" / "csrc"
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_tree_equal(port, ref):
    """Every leaf of a port result (tensors, states) equals the JAX
    result's, dtype included."""
    got = jax.tree.leaves(to_numpy(port))
    want = [np.asarray(v) for v in jax.tree.leaves(ref)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _random_pll_state(rng, c):
    """A nonzero JAX `PllState` over c channels (every word random)."""
    return jpll.PllState(
        clamp=junwrap.ClampWrapState(
            x0=jnp.asarray(_i32(rng, (c,))),
            clamp=jnp.asarray(rng.integers(-1, 2, size=(c,)).astype(np.int8)),
        ),
        z0=jnp.asarray(_i32(rng, (c,))),
        y0=jnp.asarray(_i32(rng, (c,))),
        f0=jnp.asarray(rng.integers(-(2**62), 2**62, size=(c,),
                                    dtype=np.int64)),
        f=jnp.asarray(rng.integers(-(2**62), 2**62, size=(c,),
                                   dtype=np.int64)),
        y=jnp.asarray(_i32(rng, (c,))),
    )


def test_atan2_divi_table_matches_jax():
    assert luts.ATAN2_DIVI_DEPTH == jluts.ATAN2_DIVI_DEPTH
    for got, want in zip(luts.atan2_divi_table(), jluts.atan2_divi_table()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_atan2_cuh_tables_match_luts():
    """The base/slope seed table and the polynomial of csrc/atan2.cuh
    are the numbers of `luts.atan2_divi_table` and `trig._ATANI`."""
    src = (CSRC / "atan2.cuh").read_text()

    def array(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        return [int(v.strip().rstrip("u"), 0) for v in body.split(",")]

    base, slope = luts.atan2_divi_table()
    assert array("kBase") == [int(v) for v in base]
    assert array("kSlope") == [int(v) for v in slope]
    assert array("kAtani") == list(trig._ATANI)
    assert list(trig._ATANI) == [int(v) for v in jtrig._ATANI]


def _edge_pairs():
    e = np.array([0, 1, -1, 2, -2, 1000, -1000, 2**30, -(2**30), I32_MAX,
                  I32_MIN, I32_MAX - 1, I32_MIN + 1], dtype=np.int64)
    y, x = np.meshgrid(e, e)  # axes, diagonals, i32::MIN/MAX, 0
    return y.ravel().astype(np.int32), x.ravel().astype(np.int32)


@pytest.mark.parametrize("case", ["random", "edges", "small"])
def test_atan2_bitexact_vs_jax(case):
    rng = np.random.default_rng(50)
    if case == "random":
        y, x = _i32(rng, (50000,)), _i32(rng, (50000,))
    elif case == "edges":
        y, x = _edge_pairs()
    else:  # small magnitudes: deep normalization shifts
        y, x = _i32(rng, (20000,), -300, 300), _i32(rng, (20000,), -300, 300)
    want = np.asarray(jtrig.atan2(jnp.asarray(y), jnp.asarray(x),
                                  lookup="gather"))
    got = trig.atan2(_t(y), _t(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_clamp_wrap_step_bitexact_vs_jax():
    c, t = 64, 200
    rng = np.random.default_rng(51)
    xs = _i32(rng, (t, c))
    # wrap edges: a step across +pi, back, and across -pi
    xs[10] = I32_MAX - 5
    xs[11] = I32_MIN + 5
    xs[12] = I32_MAX
    xs[13] = I32_MIN
    xs[14] = I32_MAX
    jst = junwrap.ClampWrapState(
        x0=jnp.asarray(_i32(rng, (c,))),
        clamp=jnp.asarray(rng.integers(-1, 2, size=(c,)).astype(np.int8)))
    st = to_torch(jax.tree.map(np.asarray, jst), CPU)
    assert st.clamp.dtype == torch.int8
    for i in range(t):
        jst, jy = junwrap.clamp_wrap_step(jst, jnp.asarray(xs[i]))
        st, y = unwrap.clamp_wrap_step(st, _t(xs[i]))
        _assert_tree_equal((st, y), (jst, jy))
    d, w = unwrap.overflowing_sub(_t(xs[12]), _t(xs[11]))
    jd, jw = junwrap.overflowing_sub(jnp.asarray(xs[12]), jnp.asarray(xs[11]))
    _assert_tree_equal((d, w), (jd, jw))


@pytest.mark.parametrize("n", [1, 2])
def test_lowpass_block_bitexact_vs_jax(n):
    c, t = 64, 300
    rng = np.random.default_rng(52 + n)
    k = jlowpass.gains1(0.01) if n == 1 else jlowpass.gains2(0.02)
    p = rng.integers(-(2**40), 2**40, size=(c, n), dtype=np.int64)
    xs = _i32(rng, (t, c), -(2**28), 2**28)
    jst, jys = jlowpass.block(jnp.asarray(k), jlowpass.LowpassState(
        p=jnp.asarray(p)), jnp.asarray(xs))
    st, ys = lowpass.block(k, lowpass.LowpassState(p=_t(p)), _t(xs))
    _assert_tree_equal((st, ys), (jst, jys))
    jst1, jy1 = jlowpass.step(jnp.asarray(k), jlowpass.LowpassState(
        p=jnp.asarray(p)), jnp.asarray(xs[0]))
    st1, y1 = lowpass.step(k, lowpass.LowpassState(p=_t(p)), _t(xs[0]))
    _assert_tree_equal((st1, y1), (jst1, jy1))


@pytest.mark.parametrize("n", [1, 2])
def test_lowpass_block_saturating_input(n):
    """Extreme inputs and state exercise the saturating subtraction
    (tests/test_biquad_pallas.py:441-461)."""
    c, t = 32, 128
    k = jlowpass.gains1(0.2) if n == 1 else jlowpass.gains2(0.2)
    col = np.tile(np.array([I32_MAX, I32_MIN, I32_MAX, 0], np.int64)
                  .astype(np.int32), t // 4)
    xs = np.broadcast_to(col[:, None], (t, c)).copy()
    p = np.full((c, n), -(2**55), np.int64)
    jst, jys = jlowpass.block(jnp.asarray(k), jlowpass.LowpassState(
        p=jnp.asarray(p)), jnp.asarray(xs))
    st, ys = lowpass.block(k, lowpass.LowpassState(p=_t(p)), _t(xs))
    _assert_tree_equal((st, ys), (jst, jys))


@pytest.mark.parametrize("f0", [1e-4, 0.001, 0.004, 0.02, 0.2])
def test_lowpass_gains_match_jax(f0):
    for got, want in ((lowpass.gains1(f0), jlowpass.gains1(f0)),
                      (lowpass.gains2(f0), jlowpass.gains2(f0)),
                      (lowpass.gains2(f0, 1.0), jlowpass.gains2(f0, 1.0)),
                      (lowpass.gains1(0.49), jlowpass.gains1(0.49))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bw", [7e-5, 1e-3, 1e-2, 2e-2, 5e-2])
def test_pll_coefficients_match_jax(bw):
    for split in (2.0, 4.0):
        got = pll.coefficients_from_bandwidth(bw, split)
        want = jpll.coefficients_from_bandwidth(bw, split)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pll.coefficients_from_zpk(0.9, 0.5, 1e-3),
                                  jpll.coefficients_from_zpk(0.9, 0.5, 1e-3))


def test_pll_block_from_nonzero_state_two_blocks():
    c, t = 64, 256
    rng = np.random.default_rng(54)
    ba = jpll.coefficients_from_bandwidth(2e-2, 4.0)
    jst = _random_pll_state(rng, c)
    st = to_torch(jax.tree.map(np.asarray, jst), CPU)
    for _ in range(2):
        xs = _i32(rng, (t, c))
        jst, jys = jpll.block(jnp.asarray(ba), jst, jnp.asarray(xs))
        st, ys = pll.block(ba, st, _t(xs))
        _assert_tree_equal((st, ys), (jst, jys))
        _assert_tree_equal(pll.frequency(st), jpll.frequency(jst))


def test_pll_block_tracks_phase_ramp_like_jax():
    """Chained blocks on a wrapping frequency ramp
    (tests/test_biquad_pallas.py:343-370): acquisition with wraps."""
    c, t = 16, 256
    ba = jpll.coefficients_from_bandwidth(5e-2, 4.0)
    step = np.int64(0x8765437).astype(np.int32)
    ph = (np.arange(1, 2 * t + 1, dtype=np.int64) * step) & 0xFFFFFFFF
    ph = np.where(ph >= 2**31, ph - 2**32, ph).astype(np.int32)
    xs = np.tile(ph[:, None], (1, c))
    jst, st = jpll.init((c,)), pll.init((c,), device=CPU)
    for b in range(2):
        blk = xs[b * t:(b + 1) * t]
        jst, jys = jpll.block(jnp.asarray(ba), jst, jnp.asarray(blk))
        st, ys = pll.block(ba, st, _t(blk))
        _assert_tree_equal((st, ys), (jst, jys))


@pytest.mark.parametrize("n,dec", [(2, 16), (1, 16), (2, 1)])
def test_lowpass_bank_plain_bitexact_vs_jax_kernel(n, dec):
    """K4's plain version against the interpret-mode Pallas kernel over
    two carried blocks (tests/test_biquad_pallas.py:1086-1105)."""
    c, t = 128, 512
    rng = np.random.default_rng(55 + n)
    k = jlowpass.gains1(0.01) if n == 1 else jlowpass.gains2(0.01)
    jst = jlowpass.init(n, (c,))
    st = lowpass.init(n, (c,), device=CPU)
    for _ in range(2):
        xs = _i32(rng, (t, c), -(2**27), 2**27)
        jst, jys = j_lowpass_bank(k, jst, jnp.asarray(xs), time_chunk=128,
                                  dec=dec, interpret=True)
        st, ys = lowpass_bank(k, st, _t(xs), dec=dec)
        assert tuple(ys.shape) == (t // dec, c)
        _assert_tree_equal((st, ys), (jst, jys))


def test_pll_bank_plain_bitexact_vs_jax_kernel():
    """K5's plain version against the interpret-mode Pallas kernel from a
    nonzero state (tests/test_biquad_pallas.py:326-340)."""
    c, t = 128, 256
    rng = np.random.default_rng(57)
    ba = jpll.coefficients_from_bandwidth(1e-2, 4.0)
    jst = _random_pll_state(rng, c)
    st = to_torch(jax.tree.map(np.asarray, jst), CPU)
    xs = _i32(rng, (t, c))
    jst, jys = j_pll_bank(jnp.asarray(ba), jst, jnp.asarray(xs),
                          time_chunk=128, interpret=True)
    st, ys = pll_bank(ba, st, _t(xs))
    _assert_tree_equal((st, ys), (jst, jys))


def test_bank_wrappers_reject_bad_input():
    st = lowpass.init(2, (8,), device=CPU)
    with pytest.raises(ValueError):  # 100 % 16 != 0
        lowpass_bank(lowpass.gains2(0.01), st, torch.zeros(
            (100, 8), dtype=torch.int32), dec=16)
    with pytest.raises(ValueError):  # one gain for an order-2 state
        lowpass.block(lowpass.gains1(0.01), st, torch.zeros(
            (4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        lowpass.init(3, (8,), device=CPU)
