"""Port parity for the biquad variant of the BASELINE #5 DDC bank
(`idsp_tpu_torch.pipelines.ddc_bank.DdcBankBiquad`) and the plain
versions of its kernels K11-K13 and of the fused exact-LO front end K14.

* ``scan`` and ``exact`` against JAX ``ddc_bank_block_biquad(lo_mode=
  "exact")`` over carried blocks: every output and state word bit for
  bit.
* ``fast``, ``fast_fused`` and ``one_kernel`` against JAX's same mode,
  within the gates of tests/test_biquad_pallas.py:1149-1155: DF1 x-state
  |d| <= 32, rms of the output difference < 1e-5 of the signal's (plus
  one), the NCO phase equal.  The fast mix rounds f32 products, and XLA
  and PyTorch round ``cos``/``sin`` of the LO tables differently by an
  ULP, so the fast paths are gated, not bit-exact, across frameworks.
* K11's plain version equals JAX `df1_bank_q_dec` bit for bit; K12's
  and K13's pass the same gates against `fastlo_df1_dec_bank` and
  `fastlo_ddc_bank_block`; K14's equals `ddc_mix_df1_bank` bit for bit
  (i32 and f32 output, new phase).
* ``fast_fused`` and ``one_kernel`` equal ``fast`` bit for bit within the
  port at the same fine length.
* PLL acquisition of 16 tones in the biquad bank, gated as
  tests/test_rate_ddc_bank.py:226-281 gates it.

The JAX kernels run with ``interpret=True`` on the CPU; the port's
wrappers get CPU tensors, so they run their plain versions.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import pll as jpll
from idsp_tpu.filters.biquad_pallas import df1_bank_q_dec as j_df1_bank_q_dec
from idsp_tpu.filters.ddc_pallas import (
    ddc_mix_df1_bank as j_ddc_mix_df1_bank,
    fastlo_ddc_bank_block as j_fastlo_ddc_bank_block,
    fastlo_df1_dec_bank as j_fastlo_df1_dec_bank,
)
from idsp_tpu.pipelines import ddc_bank as jddc_bank

from idsp_tpu_torch import luts
from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.filters import biquad, pll
from idsp_tpu_torch.filters.biquad_cuda import df1_bank_q_dec
from idsp_tpu_torch.filters.ddc_bank_cuda import (
    fastlo_ddc_bank_block,
    fastlo_df1_dec_bank,
)
from idsp_tpu_torch.filters.ddc_cuda import ddc_mix_df1_bank
from idsp_tpu_torch.pipelines import ddc_bank
from idsp_tpu_torch.pipelines.ddc_bank import (
    BIQUAD_MODES,
    DdcBankBiquad,
    DdcBankBiquadState,
)

CPU = torch.device("cpu")
CSRC = Path(__file__).resolve().parent.parent / "idsp_tpu_torch" / "csrc"
D = 16


def _ba_q(fc):
    return tuple(int(v) for v in jbiquad.quantize_ba(
        jbiquad.from_cookbook(JFilter().critical_frequency(fc).lowpass()), 29))


BA_Q = _ba_q(0.004)  # the suite's bank filter (benches/suite.py:1034-1042)
PLL_BA = tuple(int(v) for v in jpll.coefficients_from_bandwidth(2e-2, 4.0))


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _leaves(x):
    return [np.asarray(v) for v in jax.tree.leaves(x)]


def _assert_equal(port, ref):
    """Every leaf of a port result equals the JAX result's, dtype too."""
    got, want = _leaves(to_numpy(port)), _leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _assert_fast_gates(sx, sx_ref, y, y_ref):
    """tests/test_biquad_pallas.py:1149-1155."""
    dx = np.asarray(sx, np.int64) - np.asarray(sx_ref, np.int64)
    assert np.abs(dx).max() <= 32, np.abs(dx).max()
    ya = np.asarray(y_ref, np.float64)
    yb = np.asarray(y, np.float64)
    rms_sig = np.sqrt((ya**2).mean()) + 1.0
    rms_d = np.sqrt(((ya - yb) ** 2).mean())
    assert rms_d < 1e-5 * rms_sig, (rms_d, rms_sig)


def _bank_inputs(seed, c, t, blocks=2):
    rng = np.random.default_rng(seed)
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    xs = [_i32(rng, (t,), -(2**27), 2**27) for _ in range(blocks)]
    return steps, xs


def _jax_bank(mode, steps, xs):
    """JAX `ddc_bank_block_biquad` over the blocks: per block (state,
    outputs) as numpy."""
    st = jddc_bank.init_biquad(steps.shape[0])
    runs = []
    for x in xs:
        st, out = jddc_bank.ddc_bank_block_biquad(
            st, jnp.asarray(x), jnp.asarray(steps), BA_Q, PLL_BA,
            decimate=D, lo_mode=mode, time_chunk=128, interpret=True)
        runs.append(jax.tree.map(np.asarray, (st, out)))
    return runs


def _port_bank(mode, steps, xs, time_chunk=128):
    bank = DdcBankBiquad(mode, torch.from_numpy(steps), BA_Q, PLL_BA,
                         decimate=D, time_chunk=time_chunk)
    st = bank.init_state()
    runs = []
    for x in xs:
        st, out = bank(st, torch.from_numpy(x))
        runs.append((st, out))
    return runs


@pytest.fixture(scope="module")
def exact_ref():
    steps, xs = _bank_inputs(80, 64, 512)
    return steps, xs, _jax_bank("exact", steps, xs)


@pytest.mark.parametrize("mode", ["scan", "exact"])
def test_exact_modes_bitexact_vs_jax(exact_ref, mode):
    steps, xs, ref = exact_ref
    for (st, out), (jst, jout) in zip(_port_bank(mode, steps, xs), ref):
        assert isinstance(st, DdcBankBiquadState)
        _assert_equal(out, jout)
        _assert_equal(st, jst)


@pytest.mark.parametrize("mode", ["fast", "fast_fused", "one_kernel"])
def test_fast_modes_track_jax_same_mode(mode):
    steps, xs = _bank_inputs(81, 128, 256)
    ref = _jax_bank(mode, steps, xs)
    for (st, out), (jst, jout) in zip(_port_bank(mode, steps, xs), ref):
        np.testing.assert_array_equal(st.nco_phase.numpy(), jst.nco_phase)
        _assert_fast_gates(st.bq.x.numpy(), jst.bq.x,
                           torch.cat(out[:2], 1).numpy(),
                           np.concatenate(jout[:2], 1))
        assert out[2].dtype == torch.int32 and out[2].shape == (128,)


@pytest.mark.parametrize("d,out_dtype", [(16, None), (12, None),
                                         (16, torch.float32)])
def test_df1_bank_q_dec_plain_equals_jax_kernel(d, out_dtype):
    """K11's plain version against the interpret-mode JAX kernel."""
    c, t = 128, 384
    rng = np.random.default_rng(82)
    jst = jbiquad.df1_init((c,), jnp.int32)
    st = biquad.df1_init((c,), device=CPU)
    jdt = None if out_dtype is None else jnp.float32
    for _ in range(2):
        xs = _i32(rng, (t, c), -(2**27), 2**27)
        jst, jy = j_df1_bank_q_dec(BA_Q, jst, jnp.asarray(xs), 29, d=d,
                                   interpret=True, out_dtype=jdt)
        st, y = df1_bank_q_dec(BA_Q, st, torch.from_numpy(xs), 29, d=d,
                               out_dtype=out_dtype)
        _assert_equal((st, y), (jst, jy))


def test_fastlo_df1_dec_bank_plain_tracks_jax_kernel():
    """K12's plain version against the interpret-mode JAX kernel."""
    c, t = 128, 256
    rng = np.random.default_rng(83)
    phase0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    jst, jph = jbiquad.df1_init((2 * c,), jnp.int32), jnp.asarray(phase0)
    st, ph = biquad.df1_init((2 * c,), device=CPU), torch.from_numpy(phase0)
    for _ in range(2):
        x = _i32(rng, (t,), -(2**27), 2**27)
        jst, jph, jy = j_fastlo_df1_dec_bank(
            BA_Q, jst, jph, jnp.asarray(steps), jnp.asarray(x), 29, d=D,
            time_chunk=128, interpret=True)
        st, ph, y = fastlo_df1_dec_bank(BA_Q, st, ph, torch.from_numpy(steps),
                                        torch.from_numpy(x), 29, d=D,
                                        time_chunk=128)
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jph))
        _assert_fast_gates(st.x.numpy(), jst.x, y.numpy(), jy)


def test_fastlo_ddc_bank_block_plain_tracks_jax_kernel():
    """K13's plain version against the interpret-mode JAX kernel; the
    PLL frequency words within the gate of tests/test_torch_ddc_bank.py
    (median |df| / 2^32 < 64)."""
    c, t = 128, 256
    rng = np.random.default_rng(84)
    phase0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    jcarry = (jbiquad.df1_init((2 * c,), jnp.int32), jpll.init((c,)),
              jnp.asarray(phase0))
    carry = (biquad.df1_init((2 * c,), device=CPU), pll.init((c,), device=CPU),
             torch.from_numpy(phase0))
    for _ in range(2):
        x = _i32(rng, (t,), -(2**27), 2**27)
        jst, jpst, jph, jy = j_fastlo_ddc_bank_block(
            BA_Q, jnp.asarray(PLL_BA), *jcarry, jnp.asarray(steps),
            jnp.asarray(x), 29, d=D, time_chunk=128, interpret=True)
        st, pst, ph, y = fastlo_ddc_bank_block(
            BA_Q, PLL_BA, *carry, torch.from_numpy(steps),
            torch.from_numpy(x), 29, d=D, time_chunk=128)
        jcarry, carry = (jst, jpst, jph), (st, pst, ph)
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jph))
        _assert_fast_gates(st.x.numpy(), jst.x, y.numpy(), jy)
        df = np.abs(pst.f.numpy() - np.asarray(jpst.f, np.int64)) / 2**32
        assert np.median(df) < 64.0, np.median(df)


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_ddc_mix_df1_bank_plain_equals_jax_kernel(out_dtype):
    """K14's plain version against the interpret-mode JAX kernel (its
    select-chain LUT lookup): state, new phase and output bit for bit."""
    c, t = 128, 256
    rng = np.random.default_rng(85)
    phase0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    x = _i32(rng, (t,))  # full range: the mix's products at their extremes
    st0 = jbiquad.Df1State(x=jnp.asarray(_i32(rng, (2 * c, 2))),
                           y=jnp.asarray(_i32(rng, (2 * c, 2), -(2**28),
                                              2**28)))
    want = j_ddc_mix_df1_bank(
        BA_Q, st0, jnp.asarray(phase0), jnp.asarray(steps), jnp.asarray(x),
        29, time_chunk=128, lookup="select", interpret=True,
        out_dtype=jnp.int32 if out_dtype is None else jnp.float32)
    got = ddc_mix_df1_bank(BA_Q, to_torch(jax.tree.map(np.asarray, st0), CPU),
                           torch.from_numpy(phase0), torch.from_numpy(steps),
                           torch.from_numpy(x), 29, out_dtype=out_dtype)
    _assert_equal(got, want)


def test_cossin_cuh_table_matches_luts():
    """The LUT of csrc/cossin.cuh is `luts.cossin_table`."""
    src = (CSRC / "cossin.cuh").read_text()
    body = re.search(r"kCosSinLut\[128\] = \{([^}]*)\}", src).group(1)
    table = [int(v.strip().rstrip("u"), 0) for v in body.split(",")]
    assert table == [int(v) for v in luts.cossin_table()]


@pytest.mark.parametrize("mode,time_chunk", [
    ("fast_fused", 128), ("fast_fused", 32), ("one_kernel", 128),
    ("one_kernel", 32)])
def test_fused_modes_equal_fast_within_port(mode, time_chunk):
    """``fast_fused`` and ``one_kernel`` with time_chunk k equal the
    fast-LO composition with fine length k bit for bit:
    DdcBankBiquad("fast") at t = k (its fine length is gcd(t, 128))."""
    steps, xs = _bank_inputs(86, 32, time_chunk, blocks=3)
    fast = _port_bank("fast", steps, xs)
    fused = _port_bank(mode, steps, xs, time_chunk=time_chunk)
    for got, want in zip(fused, fast):
        _assert_equal(got, to_numpy(want))


def _tones(c):
    """tests/test_rate_ddc_bank.py:226-251: 16 tones with offsets on the
    grid, the other channels tuned to empty spectrum."""
    rng = np.random.default_rng(2)
    grid = 1 << 26
    tone_steps = ((np.arange(16) + 8) * grid).astype(np.int64).astype(
        np.int32)
    offsets = rng.integers(-(1 << 16), 1 << 16, size=16,
                           dtype=np.int64).astype(np.int32)
    steps = np.zeros(c, np.int32)
    steps[:16] = tone_steps
    steps[16:] = (((np.arange(c - 16) + 40) * grid) & 0xFFFFFFFF).astype(
        np.int64).astype(np.int32)
    x = ddc_bank.make_tone_bank(tone_steps, 1 << 15, amplitude=1 << 26,
                                offsets=offsets, device=CPU)
    return steps, x, -(offsets.astype(np.int64) * D)


def _freq(mode, steps, x):
    bank = DdcBankBiquad(mode, torch.from_numpy(steps), _ba_q(0.001), PLL_BA,
                         decimate=D)
    _, (_, _, freq) = bank(bank.init_state(), x)
    return freq.numpy().astype(np.int64)[:16]


def _wrap(v):
    return (v + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("mode", ["exact", "one_kernel"])
def test_biquad_bank_acquires_offsets(mode):
    """The 16-tone acquisition of tests/test_rate_ddc_bank.py:57-84 on
    the biquad bank, gated as the JAX package gates this bank's lock
    (:279, median |freq error| < 2^18; the Lowpass<2> bank's tighter
    bounds of :83-84 are that filter's)."""
    steps, x, want = _tones(20)
    err = np.abs(_wrap(_freq(mode, steps, x) - want))
    assert np.median(err) < 1 << 18, err


def test_biquad_fast_fused_tracks_exact():
    """tests/test_rate_ddc_bank.py:278-281: ``fast_fused`` drives the
    PLLs to the operating point of ``exact``."""
    steps, x, want = _tones(20)
    f_exact, f_fused = _freq("exact", steps, x), _freq("fast_fused", steps, x)
    assert np.median(np.abs(_wrap(f_fused - want))) < 1 << 18
    assert np.median(np.abs(_wrap(f_fused - f_exact))) < 1 << 12


def test_convert_round_trips_biquad_state():
    rng = np.random.default_rng(87)
    c = 8
    st = jddc_bank.init_biquad(c)
    ref = st._replace(
        nco_phase=jnp.asarray(_i32(rng, (c,))),
        bq=jbiquad.Df1State(x=jnp.asarray(_i32(rng, (2 * c, 2))),
                            y=jnp.asarray(_i32(rng, (2 * c, 2)))),
        pll=st.pll._replace(clamp=st.pll.clamp._replace(clamp=jnp.asarray(
            np.array([-1, 0, 1, 1, 0, -1, 1, -1], np.int8)))))
    port = to_torch(jax.tree.map(np.asarray, ref), CPU)
    assert isinstance(port, DdcBankBiquadState)
    assert isinstance(port.bq, biquad.Df1State)
    _assert_equal(port, ref)
    back = to_numpy(port)
    assert type(back).__name__ == "DdcBankBiquadState"
    assert port.pll.clamp.clamp.dtype == torch.int8
    _assert_equal(to_torch(back, CPU), ref)


def test_biquad_bank_rejects_bad_input():
    steps = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        DdcBankBiquad("fused", steps, BA_Q, PLL_BA)
    assert "fast_fused" in BIQUAD_MODES
    bank = DdcBankBiquad("exact", steps, BA_Q, PLL_BA)
    with pytest.raises(ValueError):  # t % 16 != 0
        bank(bank.init_state(), torch.zeros((100,), dtype=torch.int32))
    for mode in ("fast_fused", "one_kernel"):
        one = DdcBankBiquad(mode, steps, BA_Q, PLL_BA, time_chunk=24)
        with pytest.raises(ValueError):  # time_chunk % 16 != 0
            one(one.init_state(), torch.zeros((96,), dtype=torch.int32))
