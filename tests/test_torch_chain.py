"""Port parity for the whole headline DDC chain (`idsp_tpu_torch.chain`).

The JAX reference is the ``scan`` composition of bench.py:213-236
(exact `cossin` mix, `df1_process_q`, time-last `hbf_dec_cascade`),
written out here because bench.py builds it inside ``main()``.  Each
port mode runs 3 consecutive blocks on CPU tensors (plain versions):
integer state (DF1 state, phase) bit for bit, outputs within
16 * spacing(max |DF1 output|) (the JAX package's FIR bound).  The
fast-LO chain is held to the coherent-carrier SNR gate of
tests/test_chain_snr.py:75-126.
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
from idsp_tpu.ops.trig import cossin as jcossin

from idsp_tpu_torch.chain import MODES, DdcChain
from idsp_tpu_torch.ops import accu
from idsp_tpu_torch.ops.trig import cossin

BA_Q = jbiquad.quantize_ba(
    jbiquad.from_cookbook(JFilter().critical_frequency(0.02).lowpass()), 29)


def _jax_scan_block(state, x, steps):
    """bench.py:213-236 (mode "scan") for one block."""
    bq_iq, dec_i, dec_q, phase0 = state
    t, c = x.shape[0], steps.shape[0]
    idx = (jnp.arange(1, t + 1, dtype=jnp.int64) & 0xFFFFFFFF).astype(
        jnp.int32)
    phases = phase0[None, :] + steps[None, :] * idx[:, None]
    lo_re, lo_im = jcossin(phases, lookup="gather")
    xi = x[:, None]
    mi = jfxp.q_apply(lo_re, xi, 32)
    mq = jfxp.q_apply(-lo_im, xi, 32)
    miq = jnp.concatenate([mi, mq], axis=1)
    bq_iq, yiq = jbiquad.df1_process_q(jnp.asarray(BA_Q), 29, bq_iq, miq,
                                       unroll=8)
    phase0 = phase0 + steps * jnp.int32(t)
    fi = yiq[:, :c].astype(jnp.float32).T
    fq = yiq[:, c:].astype(jnp.float32).T
    dec_i, zi = jhbf.hbf_dec_cascade(dec_i, fi)
    dec_q, zq = jhbf.hbf_dec_cascade(dec_q, fq)
    return (bq_iq, dec_i, dec_q, phase0), (zi, zq), yiq


@pytest.mark.parametrize("mode", ["scan", "split", "fold3"])
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
    for mode in MODES:
        bq, dec_i, dec_q, phase0 = DdcChain(mode, steps, BA_Q).init_state()
        assert tuple(bq.x.shape) == tuple(bq.y.shape) == (16, 2)
        assert phase0.dtype == torch.int32 and tuple(phase0.shape) == (8,)
        if mode in ("fold3", "fastlo_fused"):
            assert [tuple(tl.shape) for tl in dec_q] == [(13, 16), (28, 16),
                                                          (67, 16)]
    with pytest.raises(ValueError):
        DdcChain("fused", steps, BA_Q)
