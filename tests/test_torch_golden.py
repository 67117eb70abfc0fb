"""The port against the independent C golden model and the DDS gates.

`native/golden.c` (through `idsp_tpu.golden`) is a scalar C
implementation of the reference semantics; the port's integer paths
must equal it bit for bit, as the JAX package's do
(tests/test_golden.py).  The port's f32 fast LO is held to the
reference's DDS spectral gates (src/cossin.rs:199-247), as
tests/test_fastlo.py holds the JAX package's f32 tables.
"""

import numpy as np
import pytest
import torch

from idsp_tpu import golden, testing

from idsp_tpu_torch import fxp
from idsp_tpu_torch.design import Filter
from idsp_tpu_torch.filters import biquad
from idsp_tpu_torch.ops import fastlo
from idsp_tpu_torch.ops.trig import cossin


def _rand_i32(rng, n):
    return rng.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(
        np.int32)


def test_cossin_and_q_mul_bitexact_vs_golden():
    rng = np.random.default_rng(40)
    p = np.concatenate([
        _rand_i32(rng, 4096),
        np.array([0, 1, -1, 2**31 - 1, -(2**31), 1 << 29, -(1 << 29), 1 << 30],
                 np.int64).astype(np.int32),
    ])
    c, s = cossin(torch.from_numpy(p))
    cg, sg = golden.cossin(p)
    np.testing.assert_array_equal(c.numpy(), cg)
    np.testing.assert_array_equal(s.numpy(), sg)
    a, b = _rand_i32(rng, 4096), _rand_i32(rng, 4096)
    for f in (1, 15, 29, 31):
        np.testing.assert_array_equal(
            fxp.q_mul(torch.from_numpy(a), torch.from_numpy(b), f).numpy(),
            golden.q_mul(a, b, f))


@pytest.mark.parametrize("fc, f", [(0.02, 29), (0.07, 29), (0.2, 30)])
def test_df1_scan_bitexact_vs_golden(fc, f):
    # random nonzero state, full-range input, two blocks carried
    rng = np.random.default_rng(41)
    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(fc).lowpass()), f)
    st_g = _rand_i32(rng, 4) >> 4  # [x1, x2, y1, y2]
    st = biquad.Df1State(x=torch.from_numpy(st_g[:2].copy()),
                         y=torch.from_numpy(st_g[2:].copy()))
    for _ in range(2):
        x = _rand_i32(rng, 1024) >> 2
        st, y = biquad.df1_process_q(ba, f, st, torch.from_numpy(x))
        st_g, yg = golden.biquad_df1_q(ba, f, st_g, x)
        np.testing.assert_array_equal(y.numpy(), yg)
        np.testing.assert_array_equal(
            np.concatenate([st.x.numpy(), st.y.numpy()]), st_g)


def test_fastlo_passes_dds_gates():
    # A unit tone at bin 7 of 2**16 samples through the port's f32
    # factored LO: strongest spur < -120.4 dBc, SFDR > 118 dB, SNR >
    # 106 dB (the gates of tests/test_fastlo.py:79-91).
    n_log2, k_tone = 16, 7
    n = 1 << n_log2
    step = int(np.int32(k_tone << (32 - n_log2)))
    lo_re, lo_im = fastlo.fastlo_iq(torch.tensor([-step], dtype=torch.int32),
                                    torch.tensor([step], dtype=torch.int32),
                                    n, 128)
    z = lo_re[:, 0].double().numpy() + 1j * lo_im[:, 0].double().numpy()
    power = testing.complex_fft_power(z)
    mask = np.ones(power.shape[0], dtype=bool)
    mask[k_tone] = False
    strongest = float(np.max(np.where(mask, power, -np.inf)))
    assert testing.db(strongest / power[k_tone]) < -120.4
    m = testing.dds_metrics(z.real, k_tone, n_log2)
    assert m.sfdr_db > 118.0, m
    assert m.snr_db > 106.0, m
