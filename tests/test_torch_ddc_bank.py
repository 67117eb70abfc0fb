"""Port parity for the BASELINE #5 DDC bank (`idsp_tpu_torch.pipelines.
ddc_bank`) and the plain version of its one-kernel stack K6.

* ``scan`` and ``exact`` against JAX ``ddc_bank_block(lo_mode="exact")``
  over carried blocks: every output and every state word bit for bit.
* ``fast`` and ``one_kernel`` against JAX ``lo_mode="fast"``, and K6's
  plain version against the JAX composition of
  tests/test_biquad_pallas.py:1330-1339, within that test's gates
  (:1350-1358): phase words equal, |dy| <= 16, median |df|/2^32 < 64.
  The fast mix rounds f32 products, and XLA and PyTorch round
  ``cos``/``sin`` of the LO tables differently by an ULP, so the fast
  paths are gated, not bit-exact, across frameworks.
* ``one_kernel`` equals ``fast`` bit for bit within the port (same
  fine-table length).
* PLL acquisition of tests/test_rate_ddc_bank.py:57-84 in ``exact`` and
  ``one_kernel``.

JAX's `ddc_bank_block` runs its scans on the CPU (its kernels only on a
TPU), and the port's wrappers get CPU tensors, so they run their plain
versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import lowpass as jlowpass
from idsp_tpu.filters import pll as jpll
from idsp_tpu.ops.fastlo import fastlo_mix as j_fastlo_mix
from idsp_tpu.ops.trig import atan2 as jatan2
from idsp_tpu.pipelines import ddc_bank as jddc_bank

from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.filters import lowpass, pll
from idsp_tpu_torch.filters.ddc_bank_cuda import fastlo_ddc_bank_block_lp
from idsp_tpu_torch.pipelines import ddc_bank
from idsp_tpu_torch.pipelines.ddc_bank import DdcBank, DdcBankState

CPU = torch.device("cpu")
LP_GAINS = tuple(int(v) for v in jlowpass.gains2(0.004))
PLL_BA = tuple(int(v) for v in jpll.coefficients_from_bandwidth(2e-2, 4.0))
D = 16


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _leaves(x):
    return [np.asarray(v) for v in jax.tree.leaves(x)]


def _assert_equal(port, ref):
    """Every leaf of a port result (tensors, states) equals the JAX
    result's, dtype included."""
    _assert_leaves_equal(_leaves(to_numpy(port)), _leaves(ref))


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _assert_fast_gates(yd, yd_ref, f, f_ref):
    """tests/test_biquad_pallas.py:1350-1358."""
    dy = np.abs(np.asarray(yd, np.int64) - np.asarray(yd_ref, np.int64))
    assert dy.max() <= 16, dy.max()
    df = np.abs(np.asarray(f, np.int64) - np.asarray(f_ref, np.int64)) / 2**32
    assert np.median(df) < 64.0, np.median(df)


def _setup(seed, c):
    rng = np.random.default_rng(seed)
    steps = rng.integers(1 << 24, 1 << 30, size=(c,)).astype(np.int32)
    return rng, steps


@pytest.mark.parametrize("mode", ["scan", "exact"])
def test_exact_modes_bitexact_vs_jax(mode):
    c, t = 128, 1024
    rng, steps = _setup(70, c)
    jstate = jddc_bank.init(c)
    bank = DdcBank(mode, torch.from_numpy(steps), LP_GAINS, PLL_BA,
                   decimate=D)
    state = to_torch(jax.tree.map(np.asarray, jstate), CPU)
    assert isinstance(state, DdcBankState)
    for _ in range(2):
        x = _i32(rng, (t,), -(2**27), 2**27)
        jstate, jout = jddc_bank.ddc_bank_block(
            jstate, jnp.asarray(x), jnp.asarray(steps), LP_GAINS, PLL_BA,
            decimate=D, lo_mode="exact")
        state, out = bank(state, torch.from_numpy(x))
        _assert_equal(out, jout)
        _assert_equal(state, jstate)


@pytest.mark.parametrize("mode", ["fast", "one_kernel"])
def test_fast_modes_track_jax_fast(mode):
    c, t = 128, 1024
    rng, steps = _setup(71, c)
    jstate = jddc_bank.init(c)
    bank = DdcBank(mode, torch.from_numpy(steps), LP_GAINS, PLL_BA,
                   decimate=D, time_chunk=128)
    state = to_torch(jax.tree.map(np.asarray, jstate), CPU)
    for _ in range(2):
        x = _i32(rng, (t,), -(2**27), 2**27)
        jstate, (jyi, jyq, _, _) = jddc_bank.ddc_bank_block(
            jstate, jnp.asarray(x), jnp.asarray(steps), LP_GAINS, PLL_BA,
            decimate=D, lo_mode="fast")
        state, (yi, yq, y_pll, freq) = bank(state, torch.from_numpy(x))
        np.testing.assert_array_equal(state.nco_phase.numpy(),
                                      np.asarray(jstate.nco_phase))
        _assert_fast_gates(torch.cat([yi, yq], 1).numpy(),
                           np.concatenate([jyi, jyq], 1),
                           state.pll.f.numpy(), np.asarray(jstate.pll.f))
        assert tuple(y_pll.shape) == (t // D, c) and freq.dtype == torch.int32


def test_one_kernel_plain_tracks_jax_composition():
    """K6's plain version against the JAX composition fastlo_mix (k=128)
    -> lowpass.block -> [::16] -> atan2 -> pll.block
    (tests/test_biquad_pallas.py:1326-1358)."""
    c, t = 128, 1024
    c2 = 2 * c
    rng = np.random.default_rng(61)
    phase0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    x = _i32(rng, (t,), -(2**27), 2**27)
    jk = jnp.asarray(np.asarray(LP_GAINS, np.int64).astype(np.int32))
    lp_a, pst_a, ph_a = jlowpass.init(2, (c2,)), jpll.init((c,)), phase0
    for _ in range(2):
        miq = j_fastlo_mix(jnp.asarray(x), ph_a, jnp.asarray(steps), 128)
        lp_a, yiq = jlowpass.block(jk, lp_a, miq)
        yd = yiq[::D]
        pst_a, _ = jpll.block(jnp.asarray(PLL_BA), pst_a,
                              jatan2(yd[:, c:], yd[:, :c]))
        ph_a = ph_a + jnp.asarray(steps) * jnp.int32(t)

    lp_b = lowpass.init(2, (c2,), device=CPU)
    pst_b = pll.init((c,), device=CPU)
    ph_b = torch.from_numpy(phase0)
    for _ in range(2):
        lp_b, pst_b, ph_b, yd_b, _ = fastlo_ddc_bank_block_lp(
            LP_GAINS, PLL_BA, lp_b, pst_b, ph_b, torch.from_numpy(steps),
            torch.from_numpy(x), d=D, time_chunk=128)
    np.testing.assert_array_equal(ph_b.numpy(), np.asarray(ph_a))
    _assert_fast_gates(yd_b.numpy(), yd, pst_b.f.numpy(), pst_a.f)


@pytest.mark.parametrize("time_chunk", [128, 32])
def test_one_kernel_equals_fast_mode_within_port(time_chunk):
    """``one_kernel`` with time_chunk k equals the fast-LO composition
    with fine length k bit for bit: DdcBank("fast") at t = k (its fine
    length is gcd(t, 128))."""
    c = 32
    rng, steps = _setup(72, c)
    fast = DdcBank("fast", torch.from_numpy(steps), LP_GAINS, PLL_BA)
    one = DdcBank("one_kernel", torch.from_numpy(steps), LP_GAINS, PLL_BA,
                  time_chunk=time_chunk)
    s_fast, s_one = fast.init_state(), one.init_state()
    for _ in range(3):
        x = torch.from_numpy(_i32(rng, (time_chunk,), -(2**27), 2**27))
        s_fast, o_fast = fast(s_fast, x)
        s_one, o_one = one(s_one, x)
        _assert_equal((s_one, o_one), to_numpy((s_fast, o_fast)))


@pytest.mark.parametrize("mode", ["exact", "one_kernel"])
def test_bank_acquires_offsets(mode):
    """tests/test_rate_ddc_bank.py:57-84 on the port: each of 16
    channels' PLL acquires its carrier offset despite the 15 other
    tones in the band."""
    c, n = 16, 1 << 15
    rng = np.random.default_rng(0)
    grid = 1 << 26
    steps = ((np.arange(c) + 8) * grid).astype(np.int64).astype(np.int32)
    offsets = rng.integers(-(1 << 16), 1 << 16, size=c,
                           dtype=np.int64).astype(np.int32)
    x = ddc_bank.make_tone_bank(steps, n, amplitude=1 << 26, offsets=offsets,
                                device=CPU)
    bank = DdcBank(mode, torch.from_numpy(steps), lowpass.gains2(0.001),
                   PLL_BA, decimate=D)
    _, (_, _, _, freq) = bank(bank.init_state(), x)
    want = -(offsets.astype(np.int64) * D)
    err = (freq.numpy().astype(np.int64) - want + 2**31) % 2**32 - 2**31
    assert np.median(np.abs(err)) < 1 << 16, err
    assert np.abs(err).max() < (1 << 31) * 1e-4, err


def test_make_tone_bank_matches_jax():
    rng = np.random.default_rng(73)
    steps = _i32(rng, (8,), 1 << 24, 1 << 30)
    offsets = _i32(rng, (8,), -(1 << 16), 1 << 16)
    got = ddc_bank.make_tone_bank(steps, 512, amplitude=1 << 26,
                                  offsets=offsets, device=CPU)
    want = jddc_bank.make_tone_bank(steps, 512, amplitude=1 << 26,
                                    offsets=offsets)
    _assert_equal(got, want)


@pytest.mark.parametrize("which", ["bank", "lowpass", "pll"])
def test_convert_round_trips(which):
    rng = np.random.default_rng(74)
    c = 8
    if which == "lowpass":
        ref = jlowpass.LowpassState(p=jnp.asarray(
            rng.integers(-(2**62), 2**62, size=(c, 2), dtype=np.int64)))
    else:
        st = jddc_bank.init(c)
        st = st._replace(pll=st.pll._replace(clamp=st.pll.clamp._replace(
            clamp=jnp.asarray(np.array([-1, 0, 1, 1, 0, -1, 1, -1],
                                       np.int8)))))
        ref = st if which == "bank" else st.pll
    port = to_torch(jax.tree.map(np.asarray, ref), CPU)
    assert type(port).__name__ == type(ref).__name__
    _assert_equal(port, ref)
    back = to_numpy(port)
    assert type(back).__name__ == type(ref).__name__
    _assert_leaves_equal(_leaves(back), _leaves(ref))
    if which != "lowpass":
        pst = port.pll if which == "bank" else port
        assert pst.clamp.clamp.dtype == torch.int8


def test_bank_rejects_bad_input():
    steps = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        DdcBank("fused", steps, LP_GAINS, PLL_BA)
    bank = DdcBank("exact", steps, LP_GAINS, PLL_BA)
    with pytest.raises(ValueError):  # t % 16 != 0
        bank(bank.init_state(), torch.zeros((100,), dtype=torch.int32))
    one = DdcBank("one_kernel", steps, LP_GAINS, PLL_BA, time_chunk=24)
    with pytest.raises(ValueError):  # time_chunk % 16 != 0
        one(one.init_state(), torch.zeros((96,), dtype=torch.int32))
