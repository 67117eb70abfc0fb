"""Port parity for BASELINE #3, the polyphase channelizer
(`idsp_tpu_torch.pipelines.channelizer`) and the plain version of K17
`channelize_fused`.

* `prototype` and the DFT matrix equal to the JAX package's.
* `channelize_planes` (``dft="matmul"`` at f32 and bf16, ``"fft"``) and
  `channelize` against JAX within 2e-5 of the output scale: f32 sums run
  in another order in torch.matmul / torch.fft than in XLA (the JAX
  package's own fused-vs-planes bound, tests/test_pipelines.py:163-167);
  the carried history bit for bit.
* K17's plain version against the interpret-mode JAX kernel (m = 128,
  n = 64) within 2e-5 of the scale at f32 and bf16, history bit for bit;
  ``impl="fused"`` routes to it.
* Streaming equals one-shot bit for bit; the bf16 >= 10x bin-power gate
  and the channel-routing gates of tests/test_pipelines.py:27-53 and
  :100-140, the 1024-channel one included.

The port's wrappers get CPU tensors here, so they run their plain
versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.pipelines import channelizer as jchz
from idsp_tpu.pipelines import channelizer_pallas as jchp

from idsp_tpu_torch.convert import to_numpy, to_torch
from idsp_tpu_torch.pipelines import channelizer as chz
from idsp_tpu_torch.pipelines.channelizer_cuda import (
    channelize_fused,
    channelize_fused_plain,
)

CPU = torch.device("cpu")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _planes(seed, n, m):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, m)).astype(np.float32),
            rng.normal(size=(n, m)).astype(np.float32))


def _close(got, want, scale):
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= 2e-5 * scale


def test_prototype_and_dft_matrix_match_jax():
    for m, taps in ((4, 8), (64, 8), (1024, 8), (128, 4)):
        np.testing.assert_array_equal(chz.prototype(m, taps),
                                      jchz.prototype(m, taps))
    np.testing.assert_array_equal(chz._dft_matrix(256), jchz._dft_matrix(256))


@pytest.mark.parametrize("dft,tw", [("matmul", "f32"), ("matmul", "bf16"),
                                    ("fft", "f32")])
def test_channelize_planes_matches_jax_over_blocks(dft, tw):
    m, taps, n = 64, 8, 48
    zr, zi = _planes(1, 2 * n, m)
    tdt, jdt = DTYPES[tw]
    jst = jchz.init_planes(m, taps)
    st = None
    for lo in (0, n):
        if st is None:
            st = to_torch(jst, CPU)
        jst, jyr, jyi = jchz.channelize_planes(
            jst, jnp.asarray(zr[lo:lo + n]), jnp.asarray(zi[lo:lo + n]), m=m,
            taps=taps, dft=dft, twiddle_dtype=jdt)
        st, yr, yi = chz.channelize_planes(
            st, torch.from_numpy(zr[lo:lo + n]),
            torch.from_numpy(zi[lo:lo + n]), m=m, taps=taps, dft=dft,
            twiddle_dtype=tdt)
        scale = float(np.abs(np.asarray(jyr)).max())
        _close(yr, jyr, scale)
        _close(yi, jyi, scale)
    for g, w in zip(to_numpy(st), jst):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_channelize_frames_matches_jax_and_planes():
    m, taps, n = 64, 8, 32
    x = np.random.default_rng(3).normal(size=(n, m, 2)).astype(np.float32)
    jst, jy = jchz.channelize(jchz.init(m, taps), jnp.asarray(x), m=m,
                              taps=taps)
    st, y = chz.channelize(chz.init(m, taps, device=CPU), torch.from_numpy(x),
                           m=m, taps=taps)
    _close(y, jy, float(np.abs(np.asarray(jy)).max()))
    np.testing.assert_array_equal(to_numpy(st).hist, np.asarray(jst.hist))
    # the frame layout is the planes path, word for word
    pst, yr, yi = chz.channelize_planes(
        chz.init_planes(m, taps, device=CPU), torch.from_numpy(x[..., 0]),
        torch.from_numpy(x[..., 1]), m=m, taps=taps)
    assert torch.equal(yr, y[..., 0]) and torch.equal(yi, y[..., 1])
    assert torch.equal(pst.hist_r, st.hist[..., 0])


@pytest.mark.parametrize("tw", ["f32", "bf16"])
def test_fused_plain_matches_jax_kernel(tw):
    m, taps, n = 128, 8, 64
    zr, zi = _planes(7, n, m)
    tdt, jdt = DTYPES[tw]
    rng = np.random.default_rng(8)
    hist = jchz.PlanesState(
        hist_r=jnp.asarray(rng.normal(size=(taps - 1, m)).astype(np.float32)),
        hist_i=jnp.asarray(rng.normal(size=(taps - 1, m)).astype(np.float32)))
    jst, jyr, jyi = jchp.channelize_fused(
        hist, jnp.asarray(zr), jnp.asarray(zi), m=m, taps=taps,
        twiddle_dtype=jdt, interpret=True)
    st, yr, yi = channelize_fused(
        to_torch(hist, CPU), torch.from_numpy(zr), torch.from_numpy(zi), m=m,
        taps=taps, twiddle_dtype=tdt)
    scale = float(np.abs(np.asarray(jyr)).max())
    _close(yr, jyr, scale)
    _close(yi, jyi, scale)
    np.testing.assert_array_equal(st.hist_r.numpy(), zr[n - (taps - 1):])
    np.testing.assert_array_equal(st.hist_i.numpy(), np.asarray(jst.hist_i))
    # impl="fused" is this function; the planes path agrees within 2e-5
    st0 = to_torch(hist, CPU)
    _, fr, fi = chz.channelize_planes(
        st0, torch.from_numpy(zr), torch.from_numpy(zi), m=m, taps=taps,
        twiddle_dtype=tdt, impl="fused")
    assert torch.equal(fr, yr) and torch.equal(fi, yi)
    _, pr, pi = chz.channelize_planes(
        st0, torch.from_numpy(zr), torch.from_numpy(zi), m=m, taps=taps,
        twiddle_dtype=tdt)
    _close(pr, yr, scale)
    _close(pi, yi, scale)


def test_fused_plain_short_block_history():
    # n < taps - 1: the new history keeps rows of the old one
    m, taps = 128, 8
    rng = np.random.default_rng(9)
    h = [torch.from_numpy(rng.normal(size=(taps - 1, m)).astype(np.float32))
         for _ in range(2)]
    zr, zi = (torch.from_numpy(v) for v in _planes(10, 3, m))
    st, _, _ = channelize_fused_plain(chz.PlanesState(*h), zr, zi, m=m,
                                      taps=taps)
    assert torch.equal(st.hist_r, torch.cat([h[0][3:], zr]))
    assert torch.equal(st.hist_i, torch.cat([h[1][3:], zi]))
    with pytest.raises(ValueError):
        channelize_fused_plain(chz.PlanesState(*h), zr, zi, m=m,
                               twiddle_dtype=torch.float16)
    with pytest.raises(ValueError):
        chz.channelize_planes(chz.PlanesState(*h), zr, zi, m=m, dft="fft",
                              impl="fused")


@pytest.mark.parametrize("fused", [False, True])
def test_streaming_equals_one_shot(fused):
    m, taps, nfr = 128, 8, 128
    x = chz.tone(17 / m, m * nfr, device=CPU)
    zr, zi = chz.planes_from_stream(x[..., 0], x[..., 1], m)
    kw = dict(m=m, taps=taps, twiddle_dtype=torch.float32)
    fn = channelize_fused if fused else chz.channelize_planes
    _, yr1, yi1 = fn(chz.init_planes(m, taps, device=CPU), zr, zi, **kw)
    st, ya_r, ya_i = fn(chz.init_planes(m, taps, device=CPU), zr[:nfr // 2],
                        zi[:nfr // 2], **kw)
    _, yb_r, yb_i = fn(st, zr[nfr // 2:], zi[nfr // 2:], **kw)
    assert torch.equal(torch.cat([ya_r, yb_r]), yr1)
    assert torch.equal(torch.cat([ya_i, yb_i]), yi1)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_passes_bin_power_gate(fused):
    m, taps, nfr, ch = 128, 8, 128, 17
    x = chz.tone(ch / m, m * nfr, device=CPU)
    zr, zi = chz.planes_from_stream(x[..., 0], x[..., 1], m)
    fn = channelize_fused if fused else chz.channelize_planes
    _, yr, yi = fn(chz.init_planes(m, taps, device=CPU), zr, zi, m=m,
                   taps=taps, twiddle_dtype=torch.bfloat16)
    p = (yr.double() ** 2 + yi.double() ** 2)[32:].mean(0).numpy()
    assert int(np.argmax(p)) == ch
    assert p[ch] > 10.0 * np.delete(p, ch).max()


def test_channelizer_routes_center_tones():
    for freq, want in [(0.0, 0), (0.25, 1), (0.5, 2), (0.75, 3)]:
        p = chz.channel_powers(freq, device=CPU)
        assert int(np.argmax(p)) == want, (freq, p)
        assert p[want] > 10.0 * np.delete(p, want).max(), (freq, p)


def test_channelizer_wideband_64_and_fft():
    m = 64
    for ch in (0, 7, 31, 63):
        p = chz.channel_powers(ch / m, m=m, taps=8, n=m * 512, device=CPU)
        assert int(np.argmax(p)) == ch
        assert p[ch] > 10.0 * np.delete(p, ch).max()
    n = 512
    x = chz.frames_from_stream(chz.tone(5.0 / m, n * m, device=CPU), m)
    st = chz.init(m, 8, device=CPU)
    _, y_mm = chz.channelize(st, x, m=m, taps=8)
    _, y_ff = chz.channelize(st, x, m=m, taps=8, dft="fft")
    a, b = y_mm.double().numpy(), y_ff.double().numpy()
    assert np.abs(a - b).max() < 1e-5 * np.abs(a).max()


def test_channelizer_wideband_1024():
    m = 1024
    p = chz.channel_powers(100 / m, m=m, taps=8, n=m * 160, device=CPU)
    assert int(np.argmax(p)) == 100
    assert p[100] > 1e4 * np.delete(p, 100).max()


def test_stream_layouts():
    x = torch.arange(2 * 24, dtype=torch.float32).reshape(24, 2)
    assert chz.frames_from_stream(x, 8).shape == (3, 8, 2)
    zr, zi = chz.planes_from_stream(x[:, 0], x[:, 1], 8)
    assert zr.shape == (3, 8) and torch.equal(zr[1], x[8:16, 0])
    with pytest.raises(ValueError):
        chz.frames_from_stream(x, 5)
    np.testing.assert_array_equal(chz.tone(0.1, 64, device=CPU).numpy(),
                                  np.asarray(jchz.tone(0.1, 64)))
