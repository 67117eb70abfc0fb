"""Port parity for BASELINE #2, the real-input DDC / lock-in
(`idsp_tpu_torch.pipelines.ddc_lockin`), and the modules under it:
`filters.lockin`, the float DF1 (`biquad.df1_step`, `df1_process`) and
the plain version of K16 `ddc_lockin_bank`.

* The integer lock-in (`mix`, `mix_phase`, the lowpass and Q-biquad
  lock-ins) against the JAX package bit for bit.
* The float DF1 against JAX run op by op (``jax.disable_jit``) bit for
  bit: each product and sum rounds on its own in both.  Compiled, XLA
  contracts the step into FMAs, so against the jitted scan each step is
  held (from JAX's own trajectory) within 8 ULP of its largest term.
* K16's plain version against the interpret-mode JAX kernel over two
  blocks carried by ``n0`` (c = 128, t = 4096, time chunk 256), and the
  lock-in gates (tests/test_structures_pallas.py:214-229).  XLA contracts
  the kernel's DF1 into FMAs where the port rounds every operation, and
  the lowpass at 0.002 (poles at radius ~0.991) carries a difference of
  one rounding per step up to ~3e-5 at the tone's 0.5 (measured), so
  across the two packages the bound is 5e-5.  Within the port, where
  both run the same DF1, `DdcLockinBank` ``kernel`` is held within 2e-5
  of ``scan``, the JAX package's own bound for its kernel against its
  composition (:211-212); `run_ddc`'s gates (tests/test_pipelines.py:
  20-24).

The port's wrappers get CPU tensors here, so they run their plain
versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import lockin as jlockin
from idsp_tpu.filters import lowpass as jlowpass
from idsp_tpu.filters.ddc_pallas import ddc_lockin_bank as j_ddc_lockin_bank
from idsp_tpu.pipelines import ddc_lockin as jdl

from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.filters import biquad, lockin, lowpass
from idsp_tpu_torch.filters.ddc_lockin_cuda import (
    ddc_lockin_bank,
    ddc_lockin_bank_plain,
    lockin_tables,
)
from idsp_tpu_torch.pipelines import ddc_lockin
from idsp_tpu_torch.pipelines.ddc_lockin import DdcLockinBank

CPU = torch.device("cpu")
BA = jbiquad.from_cookbook(
    JFilter().critical_frequency(0.002).lowpass()).astype(np.float32)


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --- filters.lockin (integer) -------------------------------------------------


def test_mix_and_mix_phase_match_jax():
    rng = np.random.default_rng(10)
    x, ph = _i32(rng, (300, 4)), _i32(rng, (300, 4))
    lo_re, lo_im = _i32(rng, (300, 4)), _i32(rng, (300, 4))
    for f in (16, 32):
        for g, w in zip(lockin.mix(*map(torch.from_numpy, (x, lo_re, lo_im)),
                                   f=f),
                        jlockin.mix(x, lo_re, lo_im, f=f)):
            _eq(g, w)
    for g, w in zip(lockin.mix_phase(torch.from_numpy(x), torch.from_numpy(ph)),
                    jlockin.mix_phase(x, ph)):
        _eq(g, w)


def test_lowpass_and_biquad_lockins_match_jax():
    rng = np.random.default_rng(11)
    c, t = 8, 256
    xs = _i32(rng, (t, c), -(2**28), 2**28)
    phases = _i32(rng, (t, c))
    k = jlowpass.gains2(0.01)
    np.testing.assert_array_equal(lowpass.gains2(0.01), k)
    jst = jlockin.lockin_init_lowpass(2, (c,))
    st = lockin.lockin_init_lowpass(2, (c,), device=CPU)
    jst, (ji, jq) = jlockin.lockin_lowpass_block(k, jst, xs, phases)
    st, (ti, tq) = lockin.lockin_lowpass_block(
        k, st, torch.from_numpy(xs), torch.from_numpy(phases))
    _eq(ti, ji)
    _eq(tq, jq)
    _eq(st[1].p, jst[1].p)

    ba_q = jbiquad.quantize_ba(jbiquad.from_cookbook(
        JFilter().critical_frequency(0.01).lowpass()), 29)
    jst = (jbiquad.df1_init((c,), jnp.int32),) * 2
    st = (biquad.df1_init((c,), device=CPU),) * 2
    jst, (ji, jq) = jlockin.lockin_biquad_q_block(ba_q, 29, jst, xs, phases)
    st, (ti, tq) = lockin.lockin_biquad_q_block(
        ba_q, 29, st, torch.from_numpy(xs), torch.from_numpy(phases))
    _eq(ti, ji)
    _eq(tq, jq)
    _eq(st[0].y, jst[0].y)


# --- the float DF1 ----------------------------------------------------------


def _f32_state(rng, lanes):
    return (rng.normal(size=(lanes, 2)).astype(np.float32),
            rng.normal(size=(lanes, 2)).astype(np.float32))


def test_df1_process_float_matches_jax_op_by_op():
    rng = np.random.default_rng(12)
    lanes, t = 32, 48
    x = rng.normal(size=(t, lanes)).astype(np.float32)
    sx, sy = _f32_state(rng, lanes)
    with jax.disable_jit():
        jst, jy = jbiquad.df1_process(
            jnp.asarray(BA), jbiquad.Df1State(jnp.asarray(sx), jnp.asarray(sy)),
            jnp.asarray(x))
    st, y = biquad.df1_process(BA, biquad.Df1State(*map(torch.from_numpy,
                                                        (sx, sy))),
                               torch.from_numpy(x))
    _eq(y, jy)
    _eq(st.x, jst.x)
    _eq(st.y, jst.y)
    # df1_step: one step, op by op in both
    with jax.disable_jit():
        jst1, jy1 = jbiquad.df1_step(
            jnp.asarray(BA), jbiquad.Df1State(jnp.asarray(sx), jnp.asarray(sy)),
            jnp.asarray(x[0]))
    st1, y1 = biquad.df1_step(torch.from_numpy(BA),
                              biquad.Df1State(*map(torch.from_numpy, (sx, sy))),
                              torch.from_numpy(x[0]))
    _eq(y1, jy1)
    _eq(st1.y, jst1.y)


@pytest.mark.parametrize("fc", [0.002, 0.2])
def test_df1_process_float_tracks_jitted_jax(fc):
    ba = jbiquad.from_cookbook(
        JFilter().critical_frequency(fc).lowpass()).astype(np.float32)
    rng = np.random.default_rng(13)
    lanes, t = 64, 1024
    x = rng.normal(size=(t, lanes)).astype(np.float32)
    z = np.zeros((lanes, 2), np.float32)
    _, jy = jbiquad.df1_process(jnp.asarray(ba),
                                jbiquad.Df1State(jnp.asarray(z), jnp.asarray(z)),
                                jnp.asarray(x))
    jy = np.asarray(jy)
    # each step from JAX's own trajectory
    xp = np.concatenate([np.zeros((2, lanes), np.float32), x])
    yp = np.concatenate([np.zeros((2, lanes), np.float32), jy])
    sx = np.stack([xp[1:-1], xp[:-2]], -1)
    sy = np.stack([yp[1:-1], yp[:-2]], -1)
    _, y = biquad.df1_step(torch.from_numpy(ba),
                           biquad.Df1State(*map(torch.from_numpy, (sx, sy))),
                           torch.from_numpy(x))
    terms = np.stack([ba[0] * x, ba[1] * sx[..., 0], ba[2] * sx[..., 1],
                      ba[3] * sy[..., 0], ba[4] * sy[..., 1]])
    ulp = np.spacing(np.abs(terms).max(axis=0))
    assert (np.abs(y.numpy() - jy) <= 8 * ulp).all()


# --- K16 and the lock-in bank -------------------------------------------------


def _tone_bank(c=128, t=4096, k_tone=40, phi=0.37):
    lo_fs = np.linspace(0.05, 0.45, c)
    i = np.arange(t, dtype=np.float64)
    x = np.cos(2 * np.pi * lo_fs[k_tone] * i + phi).astype(np.float32)
    return lo_fs, x


def _gates(y, c, t, k_tone=40, phi=0.37):
    tail = y[3 * t // 4:].astype(np.float64)
    mean_i = tail[:, k_tone].mean()
    mean_q = tail[:, c + k_tone].mean()
    exp_i, exp_q = 0.5 * np.cos(phi), 0.5 * np.sin(phi)
    assert abs(mean_i - exp_i) < 3e-3 and abs(mean_q - exp_q) < 3e-3
    rms = np.sqrt(((tail[:, k_tone] - exp_i) ** 2
                   + (tail[:, c + k_tone] - exp_q) ** 2).mean())
    assert rms < 6e-3
    off = np.abs(tail[:, :c]).mean(axis=0)
    off = np.concatenate([off[:k_tone - 3], off[k_tone + 4:]])
    assert off.max() < 0.05


def test_ddc_lockin_plain_matches_jax_kernel_and_gates():
    c, t = 128, 4096
    lo_fs, x = _tone_bank(c, t)
    h = t // 2
    jst = jbiquad.df1_init((2 * c,), jnp.float32)
    st = None
    ys, jys = [], []
    for n0 in (0, h):
        jst, jy = j_ddc_lockin_bank(BA, jst, jnp.asarray(x[n0:n0 + h]), lo_fs,
                                    n0, time_chunk=256, interpret=True)
        if st is None:  # both packages start from the same zero state
            st = to_torch(jbiquad.df1_init((2 * c,), jnp.float32), CPU)
        st, y = ddc_lockin_bank(BA, st, torch.from_numpy(x[n0:n0 + h]),
                                lo_fs, n0, time_chunk=256)
        ys.append(y.numpy())
        jys.append(np.asarray(jy))
    y, jy = np.concatenate(ys), np.concatenate(jys)
    assert np.abs(y - jy).max() < 5e-5  # FMA contraction, see the docstring
    np.testing.assert_allclose(to_numpy(st).y, np.asarray(jst.y), atol=5e-5)
    _gates(y, c, t)


def test_ddc_lockin_bank_modes_and_block_continuity():
    c, t = 128, 4096
    lo_fs, x = _tone_bank(c, t)
    xt = torch.from_numpy(x)
    outs = {}
    for m in ddc_lockin.MODES:
        bank = DdcLockinBank(m, lo_fs, BA, time_chunk=256, device=CPU)
        st = bank.init_state()
        ys = []
        for n0 in (0, 1024, 2048, 3072):  # four blocks carried by n0
            st, y = bank(st, xt[n0:n0 + 1024], n0)
            ys.append(y)
        outs[m] = torch.cat(ys).numpy()
    assert np.abs(outs["kernel"] - outs["scan"]).max() < 2e-5
    _gates(outs["kernel"], c, t)
    # the kernel's chunking is invisible in one block against four
    one = ddc_lockin_bank_plain(BA, biquad.df1_init((2 * c,), torch.float32,
                                                    device=CPU),
                                xt, lo_fs, 0, time_chunk=256)[1].numpy()
    _eq(outs["kernel"], one)
    with pytest.raises(ValueError):
        DdcLockinBank("fast", lo_fs, BA, device=CPU)


def test_lockin_tables_factor_the_lo():
    lo_fs = np.linspace(0.05, 0.45, 16)
    ca, sa, cb, sb = lockin_tables(lo_fs, 1000, 512, 64, device=CPU)
    assert ca.shape == (8, 16) and cb.shape == (64, 16)
    n = 1000 + np.arange(512, dtype=np.float64)
    want = np.exp(1j * 2 * np.pi * n[:, None] * lo_fs[None])
    got = ((ca[:, None] + 1j * sa[:, None]).numpy().astype(np.complex128)
           * (cb + 1j * sb).numpy()[None]).reshape(512, 16)
    assert np.abs(got - want).max() < 1e-6
    with pytest.raises(ValueError):
        lockin_tables(lo_fs, 0, 500, 64, device=CPU)


def test_quadrature_mix_ddc_and_run_ddc_match_jax():
    x = ddc_lockin.tone(0.173, 0.37, 2048, device=CPU)
    jx = jdl.tone(0.173, 0.37, 2048)
    _eq(x, jx)
    np.testing.assert_allclose(ddc_lockin.quadrature_mix(x, 0.173).numpy(),
                               np.asarray(jdl.quadrature_mix(jx, 0.173)),
                               atol=1e-6)
    np.testing.assert_allclose(ddc_lockin.ddc(x, 0.173, 0.002).numpy(),
                               np.asarray(jdl.ddc(jx, 0.173, 0.002)),
                               atol=5e-5)  # FMA contraction, as above
    r = ddc_lockin.run_ddc(device=CPU)
    assert abs(r["mean"][0] - r["expected"][0]) < 3e-3
    assert abs(r["mean"][1] - r["expected"][1]) < 3e-3
    assert r["rms"] < 6e-3
