"""Port parity for the whole headline DDC chain (`idsp_tpu_torch.chain`).

The JAX reference is the ``scan`` composition of bench.py:213-236
(exact `cossin` mix, `df1_process_q`, time-last `hbf_dec_cascade`),
written out here because bench.py builds it inside ``main()``.  Each
port mode runs 3 consecutive blocks on CPU tensors (plain versions):
integer state (DF1 state, phase) bit for bit, outputs within
16 * spacing(max |DF1 output|) (the JAX package's FIR bound).  The
fast-LO chains are held to the coherent-carrier SNR gate of
tests/test_chain_snr.py:75-126.  Modes ``fused``, ``fold`` and ``fold2``
are also held to bench.py's own steps (bench.py:199-212, 125-173: the
interpret-mode JAX kernels `ddc_mix_df1_bank`, `df1_hbf1_bank`,
`df1_hbf12_bank`, then the time-major HBF): state bit for bit, outputs
within the same FIR bound.  ``fold3_fastlo`` is held to bench.py's
``fold3_fastlo`` step (:81-99) within the fast-mix gates of
tests/test_biquad_pallas.py:987-998 (the two frameworks' f32 mixes differ
by ULPs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu import fxp as jfxp
from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import hbf as jhbf
from idsp_tpu.filters.ddc_pallas import ddc_mix_df1_bank as j_ddc_mix_df1_bank
from idsp_tpu.filters.ddc_pallas import df1_hbf1_bank as j_df1_hbf1_bank
from idsp_tpu.filters.ddc_pallas import df1_hbf12_bank as j_df1_hbf12_bank
from idsp_tpu.filters.ddc_pallas import (
    df1_hbf_cascade_bank as j_df1_hbf_cascade_bank,
    hbf1_tail_init as j_hbf1_tail_init,
)
from idsp_tpu.ops.fastlo import fastlo_mix as j_fastlo_mix
from idsp_tpu.ops.trig import cossin as jcossin

from idsp_tpu_torch.chain import MODES, DdcChain
from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.filters import biquad, hbf
from idsp_tpu_torch.ops import accu
from idsp_tpu_torch.ops.trig import cossin

BA_Q = jbiquad.quantize_ba(
    jbiquad.from_cookbook(JFilter().critical_frequency(0.02).lowpass()), 29)


def _jax_mix(x, phase0, steps):
    """bench.py's exact conjugate mix (:213-221): (t, 2c) I|Q."""
    t = x.shape[0]
    idx = (jnp.arange(1, t + 1, dtype=jnp.int64) & 0xFFFFFFFF).astype(
        jnp.int32)
    phases = phase0[None, :] + steps[None, :] * idx[:, None]
    lo_re, lo_im = jcossin(phases, lookup="gather")
    xi = x[:, None]
    mi = jfxp.q_apply(lo_re, xi, 32)
    mq = jfxp.q_apply(-lo_im, xi, 32)
    return jnp.concatenate([mi, mq], axis=1)


def _jax_scan_block(state, x, steps):
    """bench.py:213-236 (mode "scan") for one block."""
    bq_iq, dec_i, dec_q, phase0 = state
    t, c = x.shape[0], steps.shape[0]
    miq = _jax_mix(x, phase0, steps)
    bq_iq, yiq = jbiquad.df1_process_q(jnp.asarray(BA_Q), 29, bq_iq, miq,
                                       unroll=8)
    phase0 = phase0 + steps * jnp.int32(t)
    fi = yiq[:, :c].astype(jnp.float32).T
    fq = yiq[:, c:].astype(jnp.float32).T
    dec_i, zi = jhbf.hbf_dec_cascade(dec_i, fi)
    dec_q, zq = jhbf.hbf_dec_cascade(dec_q, fq)
    return (bq_iq, dec_i, dec_q, phase0), (zi, zq), yiq


def _jax_fused_block(state, x, steps):
    """bench.py:199-212 (mode "fused") for one block."""
    bq_iq, dec_i, dec_q, phase0 = state
    c = steps.shape[0]
    bq_iq, phase0, yiq = j_ddc_mix_df1_bank(
        BA_Q, bq_iq, phase0, steps, x, 29, time_chunk=512,
        out_dtype=jnp.float32, interpret=True)
    dec_i, ziq = jhbf.hbf_dec_cascade(dec_i, yiq, axis=0)
    return (bq_iq, dec_i, dec_q, phase0), (ziq[:, :c], ziq[:, c:]), yiq


def _jax_fold_block(mode, state, x, steps):
    """bench.py:151-173 (mode "fold") and :125-150 ("fold2") for one
    block, the JAX kernels in interpret mode."""
    bq_iq, dec_i, dec_q, phase0 = state
    c, t = steps.shape[0], x.shape[0]
    miq = _jax_mix(x, phase0, steps)
    if mode == "fold":
        bq_iq, dec_q, y2 = j_df1_hbf1_bank(BA_Q, bq_iq, dec_q, miq, 29,
                                           time_chunk=128, unroll=4,
                                           interpret=True)
        dec_i, ziq = jhbf.hbf_dec_cascade(dec_i, y2, axis=0)
    else:
        bq_iq, tail1, tail2, y4 = j_df1_hbf12_bank(
            BA_Q, bq_iq, *dec_q, miq, 29, time_chunk=128, unroll=4,
            interpret=True)
        dec_i, ziq = jhbf.hbf_dec_block(jhbf.HBF_TAPS[0], dec_i, y4, axis=0)
        dec_q = (tail1, tail2)
    phase0 = phase0 + steps * jnp.int32(t)
    return (bq_iq, dec_i, dec_q, phase0), (ziq[:, :c], ziq[:, c:])


def _jax_fold_state(mode, c):
    """bench.py:252-272: the JAX package's zero state of ``mode``."""
    bq = jbiquad.df1_init((2 * c,), jnp.int32)
    phase0 = jnp.zeros((c,), jnp.int32)
    if mode == "fold":
        return (bq, jhbf.hbf_dec_cascade_init(2, (2 * c,), axis=0),
                j_hbf1_tail_init(2 * c), phase0)
    return (bq, jhbf.hbf_dec_init(len(jhbf.HBF_TAPS[0]), (2 * c,), axis=0),
            (j_hbf1_tail_init(2 * c, 5), j_hbf1_tail_init(2 * c, 10)), phase0)


@pytest.mark.parametrize("mode", ["scan", "split", "fused", "fold", "fold2",
                                  "fold3"])
def test_exact_modes_match_jax_scan(mode):
    c, t = 128, 512
    rng = np.random.default_rng(20)
    steps = rng.integers(1 << 24, 1 << 30, size=(c,)).astype(np.int32)
    chain = DdcChain(mode, torch.from_numpy(steps), BA_Q)
    state = chain.init_state()
    jstate = (jbiquad.df1_init((2 * c,), jnp.int32),
              jhbf.hbf_dec_cascade_init(3, (c,)),
              jhbf.hbf_dec_cascade_init(3, (c,)),
              jnp.zeros((c,), jnp.int32))
    jstep = jax.jit(_jax_scan_block)
    for _ in range(3):
        x = rng.integers(-(2**27), 2**27, size=(t,)).astype(np.int32)
        jstate, (jzi, jzq), yiq = jstep(jstate, jnp.asarray(x),
                                        jnp.asarray(steps))
        state, (zi, zq) = chain(state, torch.from_numpy(x))
        np.testing.assert_array_equal(state[0].x.numpy(),
                                      np.asarray(jstate[0].x))
        np.testing.assert_array_equal(state[0].y.numpy(),
                                      np.asarray(jstate[0].y))
        np.testing.assert_array_equal(state[3].numpy(),
                                      np.asarray(jstate[3]))
        if mode != "scan":  # time-major outputs
            zi, zq = zi.T, zq.T
        bound = 16 * np.spacing(np.float32(np.abs(np.asarray(yiq)).max()))
        for got, want in ((zi, jzi), (zq, jzq)):
            assert tuple(got.shape) == want.shape == (c, t // 8)
            assert np.abs(got.numpy() - np.asarray(want)).max() <= bound


def test_fused_matches_jax_fused_step():
    c, t = 128, 256
    rng = np.random.default_rng(21)
    steps = rng.integers(1 << 24, 1 << 30, size=(c,)).astype(np.int32)
    chain = DdcChain("fused", torch.from_numpy(steps), BA_Q)
    state = chain.init_state()
    jstate = (jbiquad.df1_init((2 * c,), jnp.int32),
              jhbf.hbf_dec_cascade_init(3, (2 * c,), axis=0), None,
              jnp.zeros((c,), jnp.int32))
    for _ in range(2):
        x = rng.integers(-(2**27), 2**27, size=(t,)).astype(np.int32)
        jstate, (jzi, jzq), yiq = _jax_fused_block(jstate, jnp.asarray(x),
                                                   jnp.asarray(steps))
        state, (zi, zq) = chain(state, torch.from_numpy(x))
        for got, want in ((state[0].x, jstate[0].x), (state[0].y, jstate[0].y),
                          (state[3], jstate[3])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        bound = 16 * np.spacing(np.float32(np.abs(np.asarray(yiq)).max()))
        for got, want in ((zi, jzi), (zq, jzq)):
            assert tuple(got.shape) == want.shape == (t // 8, c)
            assert np.abs(got.numpy() - np.asarray(want)).max() <= bound
        for got, want in zip(state[1], jstate[1]):  # HBF tails
            assert np.abs(got.odd.numpy() - np.asarray(want.odd)).max() <= bound
            assert np.abs(got.even.numpy()
                          - np.asarray(want.even)).max() <= bound


@pytest.mark.parametrize("mode", ["fold", "fold2"])
def test_fold_modes_match_jax_bench_step(mode):
    c, t = 128, 256
    rng = np.random.default_rng(22)
    steps = rng.integers(1 << 24, 1 << 30, size=(c,)).astype(np.int32)
    chain = DdcChain(mode, torch.from_numpy(steps), BA_Q)
    jstate = _jax_fold_state(mode, c)
    state = to_torch(jstate, torch.device("cpu"))
    for _ in range(2):
        x = rng.integers(-(2**27), 2**27, size=(t,)).astype(np.int32)
        # the DF1 output scale bounds every FIR value downstream
        miq = np.array(_jax_mix(jnp.asarray(x), jstate[3],
                                jnp.asarray(steps)))
        _, yiq = biquad.df1_process_q(BA_Q, 29, state[0],
                                      torch.from_numpy(miq))
        bound = 16 * np.spacing(np.float32(yiq.abs().max().item()))
        jstate, (jzi, jzq) = _jax_fold_block(mode, jstate, jnp.asarray(x),
                                             jnp.asarray(steps))
        state, (zi, zq) = chain(state, torch.from_numpy(x))
        for got, want in ((state[0].x, jstate[0].x), (state[0].y, jstate[0].y),
                          (state[3], jstate[3])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in ((zi, jzi), (zq, jzq)):
            assert tuple(got.shape) == want.shape == (t // 8, c)
            assert np.abs(got.numpy() - np.asarray(want)).max() <= bound
        # carried tails and HBF states: stage-1 tail rows are DF1 outputs
        # (bit for bit), the later ones FIR outputs (within the bound)
        tails = [np.asarray(v) for v in jax.tree.leaves(jstate[1:3])]
        port = [np.asarray(v) for v in jax.tree.leaves(to_numpy(state[1:3]))]
        assert [a.shape for a in port] == [b.shape for b in tails]
        for a, b in zip(port, tails):
            assert np.abs(a - b).max() <= bound


def test_fold3_fastlo_tracks_jax_bench_step():
    # bench.py:81-99 against the port with the fast-mix gates of
    # tests/test_biquad_pallas.py:987-998: phase exact, x-state within 32
    # LSB, output rms difference < 1e-5 of the rms
    c, t = 128, 512
    rng = np.random.default_rng(23)
    steps = rng.integers(1 << 24, 1 << 30, size=(c,)).astype(np.int32)
    chain = DdcChain("fold3_fastlo", torch.from_numpy(steps), BA_Q)
    state = chain.init_state()
    jst = jbiquad.df1_init((2 * c,), jnp.int32)
    jtails = tuple(j_hbf1_tail_init(2 * c, m) for m in (5, 10, 23))
    jph = jnp.zeros((c,), jnp.int32)
    for _ in range(3):
        x = rng.integers(-(2**27), 2**27, size=(t,)).astype(np.int32)
        miq = j_fastlo_mix(jnp.asarray(x), jph, jnp.asarray(steps), 128)
        jst, jtails, jy8 = j_df1_hbf_cascade_bank(
            BA_Q, jst, jtails, miq, 29, time_chunk=128, unroll=4,
            interpret=True)
        jph = jph + jnp.asarray(steps) * jnp.int32(t)
        state, (zi, zq) = chain(state, torch.from_numpy(x))
        np.testing.assert_array_equal(state[3].numpy(), np.asarray(jph))
        dx = state[0].x.numpy().astype(np.int64) - np.asarray(jst.x, np.int64)
        assert np.abs(dx).max() <= 32, np.abs(dx).max()
        ya = np.asarray(jy8, np.float64)
        yb = torch.cat([zi, zq], dim=1).double().numpy()
        rms_sig = np.sqrt((ya**2).mean()) + 1.0
        rms_d = np.sqrt(((ya - yb) ** 2).mean())
        assert rms_d < 1e-5 * rms_sig, (rms_d, rms_sig)


def _carrier_snr(mode):
    """A clean carrier at f0 + offset mixed down at f0 lands on FFT bin 3
    of a 2048-sample slice of the decimated output (coherent sampling):
    (SNR dB, peak bin, expected bin)."""
    t, c = 1 << 15, 4
    f0_step = np.int32(0x4000_0000)
    off_step = np.int32(3 << 18)
    phases_in = accu.ramp(torch.tensor(123, dtype=torch.int32),
                          torch.tensor(f0_step + off_step), t)
    re_in, _ = cossin(phases_in)
    x = ((re_in.to(torch.int64) * (1 << 27)) >> 31).to(torch.int32)
    chain = DdcChain(mode, torch.full((c,), int(f0_step), dtype=torch.int32),
                     BA_Q)
    _, (zi, zq) = chain(chain.init_state(), x)
    z = zi[:, 0].double().numpy() + 1j * zq[:, 0].double().numpy()
    z = z[1024:1024 + 2048]
    n = len(z)
    spec = np.abs(np.fft.fft(z)) ** 2
    peak = int(np.argmax(spec))
    sig = slice(max(peak - 1, 0), peak + 2)
    p_sig = spec[sig].sum()
    return (10 * np.log10(p_sig / (spec.sum() - p_sig)), peak,
            int(round(int(off_step) * 8 / 2**32 * n)) % n)


def test_fold3_fastlo_chain_snr():
    snr_db, peak, expect_bin = _carrier_snr("fold3_fastlo")
    assert min(abs(peak - expect_bin), 2048 - abs(peak - expect_bin)) <= 2
    assert snr_db > 80.0, snr_db


@pytest.mark.parametrize("mode", ["fold", "fold2"])
def test_convert_fold_states_round_trip(mode):
    """The JAX package's ``fold``/``fold2`` chain state crosses to the
    port with its structure (Df1State, HbfDecState(s), tail(s), phase)
    and back word for word, and starts the port's chain."""
    c = 8
    rng = np.random.default_rng(24)
    jstate = jax.tree.map(
        lambda v: jnp.asarray(rng.integers(-(2**20), 2**20, size=v.shape)
                              .astype(np.asarray(v).dtype)),
        _jax_fold_state(mode, c))
    state = to_torch(jstate, torch.device("cpu"))
    want = DdcChain(mode, torch.arange(1, c + 1, dtype=torch.int32),
                    BA_Q).init_state()
    assert isinstance(state[0], biquad.Df1State)
    assert jax.tree.structure(to_numpy(state)) == jax.tree.structure(
        to_numpy(want))
    dec_i = state[1] if mode == "fold2" else state[1][0]
    assert isinstance(dec_i, hbf.HbfDecState)
    for a, b in zip(jax.tree.leaves(to_numpy(state)), jax.tree.leaves(jstate)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    chain = DdcChain(mode, torch.arange(1, c + 1, dtype=torch.int32), BA_Q)
    state, (zi, zq) = chain(state, torch.zeros(256, dtype=torch.int32))
    assert tuple(zi.shape) == tuple(zq.shape) == (32, c)


def test_fastlo_fused_chain_snr():
    # A clean carrier at f0 + offset mixed down at f0 lands on FFT bin 3
    # of a 2048-sample slice of the decimated output (coherent sampling).
    t, c = 1 << 15, 4
    f0_step = np.int32(0x4000_0000)
    off_step = np.int32(3 << 18)
    phases_in = accu.ramp(torch.tensor(123, dtype=torch.int32),
                          torch.tensor(f0_step + off_step), t)
    re_in, _ = cossin(phases_in)
    x = ((re_in.to(torch.int64) * (1 << 27)) >> 31).to(torch.int32)
    chain = DdcChain("fastlo_fused", torch.full((c,), int(f0_step),
                                                dtype=torch.int32), BA_Q)
    _, (zi, zq) = chain(chain.init_state(), x)
    z = zi[:, 0].double().numpy() + 1j * zq[:, 0].double().numpy()
    z = z[1024:1024 + 2048]
    n = len(z)
    spec = np.abs(np.fft.fft(z)) ** 2
    peak = int(np.argmax(spec))
    expect_bin = int(round(int(off_step) * 8 / 2**32 * n)) % n
    assert min(abs(peak - expect_bin), n - abs(peak - expect_bin)) <= 2
    sig = slice(max(peak - 1, 0), peak + 2)
    p_sig = spec[sig].sum()
    snr_db = 10 * np.log10(p_sig / (spec.sum() - p_sig))
    assert snr_db > 80.0, snr_db


def test_chain_state_shapes_and_unknown_mode():
    steps = torch.arange(1, 9, dtype=torch.int32)
    assert "pallas" not in MODES  # bench.py's TPU experiment
    for mode in MODES:
        bq, dec_i, dec_q, phase0 = DdcChain(mode, steps, BA_Q).init_state()
        assert tuple(bq.x.shape) == tuple(bq.y.shape) == (16, 2)
        assert phase0.dtype == torch.int32 and tuple(phase0.shape) == (8,)
        if mode in ("fold3", "fold3_fastlo", "fastlo_fused"):
            assert [tuple(tl.shape) for tl in dec_q] == [(13, 16), (28, 16),
                                                          (67, 16)]
        if mode == "fold":  # stage-1 tail; stages 2-3 as HbfDecStates
            assert tuple(dec_q.shape) == (13, 16)
            assert [(tuple(s.odd.shape), tuple(s.even.shape))
                    for s in dec_i] == [((19, 16), (9, 16)),
                                        ((45, 16), (22, 16))]
        if mode == "fold2":  # stage-1 and -2 tails; stage 3's HbfDecState
            assert [tuple(tl.shape) for tl in dec_q] == [(13, 16), (28, 16)]
            assert (tuple(dec_i.odd.shape),
                    tuple(dec_i.even.shape)) == ((45, 16), (22, 16))
    with pytest.raises(ValueError):
        DdcChain("pallas", steps, BA_Q)
