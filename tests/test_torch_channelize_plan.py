"""K17's launch plan, pre-tiled twiddles and cached coefficients
(`idsp_tpu_torch.pipelines.channelizer_cuda`), and its plain version
against the JAX package's interpret-mode kernel at the plan's new shapes.

* `launch_plan`: the grid covers every frame and column once; the cluster
  is the largest divisor of the m / 128 column tiles up to 8 (m = 1280:
  5); the shared memory of every plan it picks fits in 227 KB; 128 frames
  a CTA unless 64 are forced, 4 stages a ring where they fit and fewer
  where not; a forced depth may exceed the limit (the card refuses it).
* `tiled_twiddles`, un-tiled in numpy, equal `_dft_matrix`'s planes in
  the dtype; the kernel's -(ai wi) negates a bf16 product, exact.
* `default_coefficients` equals ``coefficients(None, m, taps)``, made once.
* `channelize_fused_plain` against JAX's interpret-mode `channelize_fused`
  at m = 384, n = 104 (a cluster of 3 on the card) and m = 2048, n = 16
  (the FIR done by two clusters) within 2e-5 of the scale, history bit
  for bit (tests/test_torch_channelizer.py holds m = 128).  At bf16 only
  a row where the JAX kernel's FIR words cast to a neighbouring bf16
  value may miss, and there the JAX outputs are the plain product of its
  own FIR words within 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.pipelines import channelizer as jchz
from idsp_tpu.pipelines import channelizer_pallas as jchp

from idsp_tpu_torch.convert import to_torch
from idsp_tpu_torch.pipelines import channelizer as chz
from idsp_tpu_torch.pipelines import channelizer_cuda as cc

CPU = torch.device("cpu")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
NS = (1, 5, 100, 1024, 16384, 100000)


@pytest.mark.parametrize("tw", ["f32", "bf16"])
@pytest.mark.parametrize("m", [128, 384, 1024, 1280, 2048])
def test_plan_grid_covers_every_frame_and_column_once(m, tw):
    tdt = DTYPES[tw][0]
    for n in NS:
        for frames in (64, 128):
            p = cc.launch_plan(n, m, 8, tdt, frames=frames)
            cols, tiles = p.grid
            assert cols * cc.COLUMNS == m
            assert (tiles - 1) * p.frames < n <= tiles * p.frames
            assert cols % p.cluster == 0
            assert p.frames in (64, 128)


@pytest.mark.parametrize("m,want", [(128, 1), (256, 2), (384, 3), (512, 4),
                                    (768, 6), (1024, 8), (1152, 3),
                                    (1280, 5), (1408, 1), (2048, 8),
                                    (3072, 8)])
def test_cluster_is_largest_divisor_up_to_8(m, want):
    assert cc.cluster_size(m) == want
    p = cc.launch_plan(1024, m, 8, torch.bfloat16)
    assert p.cluster == want


@pytest.mark.parametrize("tw", ["f32", "bf16"])
def test_every_picked_plan_fits_in_shared_memory(tw):
    tdt = DTYPES[tw][0]
    for m in range(128, 2049, 128):
        for taps in range(2, cc.MAX_TAPS + 1):
            for n in NS:
                for frames in (64, 128):
                    p = cc.launch_plan(n, m, taps, tdt, frames=frames)
                    assert p.smem <= cc.SMEM_MAX == 227 * 1024
                    assert 2 <= p.stages <= cc.STAGES
                    assert p.smem == cc.smem_bytes(p.frames, p.cluster,
                                                   p.stages, taps, tdt)
                    # the deepest rings that fit
                    assert p.stages == cc.STAGES or cc.smem_bytes(
                        p.frames, p.cluster, p.stages + 1, taps,
                        tdt) > cc.SMEM_MAX


def test_plan_takes_128_frames_and_the_deepest_rings_that_fit():
    for tdt in (torch.bfloat16, torch.float32):
        for n in NS:
            assert cc.launch_plan(n, 1024, 8, tdt).frames == 128
        # the main path: 8 x 8 CTAs at n = 1024, four stages a ring
        p = cc.launch_plan(1024, 1024, 8, tdt)
        assert (p.grid, p.cluster, p.stages) == ((8, 8), 8, 4)
        assert cc.launch_plan(16384, 1024, 8, tdt).grid == (8, 128)
        # a forced depth is taken as asked, even one the card refuses
        big = cc.launch_plan(16384, 1024, 16, tdt, stages=8)
        assert big.stages == 8 and big.smem > cc.SMEM_MAX
    # a cluster of one stages its whole frame tile: three stages fit
    assert cc.launch_plan(1024, 128, 16, torch.bfloat16).stages == 3
    with pytest.raises(ValueError):
        cc.launch_plan(64, 1024, 8, torch.bfloat16, frames=96)
    with pytest.raises(ValueError):
        cc.launch_plan(64, 96, 8, torch.bfloat16)


def _untile(tiles: np.ndarray, m: int, bf16: bool) -> list:
    """The (wr, wi) planes, [k][j], back from the kernel's tile order."""
    ck = 32 if bf16 else 16
    t = tiles.reshape(m // 128, m // ck, 2, -1)
    planes = []
    for p in range(2):
        if bf16:  # [ct][kc][jg][kg][jr][ke]
            x = t[:, :, p].reshape(m // 128, m // ck, 16, ck // 8, 8, 8)
            x = x.transpose(1, 3, 5, 0, 2, 4)  # kc, kg, ke, ct, jg, jr
        else:  # [ct][kc][k][j]
            x = t[:, :, p].reshape(m // 128, m // ck, ck, 128)
            x = x.transpose(1, 2, 0, 3)  # kc, k, ct, j
        planes.append(x.reshape(m, m))
    return planes


@pytest.mark.parametrize("tw", ["f32", "bf16"])
@pytest.mark.parametrize("m", [128, 384])
def test_tiled_twiddles_untile_to_the_dft_matrix(m, tw):
    tdt = DTYPES[tw][0]
    tiles = cc.tiled_twiddles(m, tdt, CPU)
    assert tiles.dtype == tdt and tiles.is_contiguous()
    assert tiles[0, 0].numel() * tiles.element_size() == \
        cc.TWIDDLE_TILE_BYTES
    got = _untile(tiles.float().numpy(), m, tdt == torch.bfloat16)
    w = chz._dft_matrix(m)
    for g, part in zip(got, (np.real, np.imag)):
        want = torch.from_numpy(part(w).astype(np.float32)).to(tdt).float()
        np.testing.assert_array_equal(g, want.numpy())
    assert cc.tiled_twiddles(m, tdt, CPU) is tiles  # made once
    # the kernel's yr += ai (-wi): the negated bf16 product is exact
    wi = torch.from_numpy(got[1]).to(tdt)
    a = torch.from_numpy(np.random.default_rng(2).normal(
        size=(m,)).astype(np.float32)).to(tdt)
    prod = a.float()[:, None] * wi.float()
    assert torch.equal(a.float()[:, None] * (-wi).float(), -prod)


@pytest.mark.parametrize("m,taps", [(1024, 8), (384, 16), (128, 2)])
def test_default_coefficients_are_cached_and_equal(m, taps):
    got = cc.default_coefficients(m, taps, CPU)
    np.testing.assert_array_equal(got.numpy(),
                                  chz.coefficients(None, m, taps))
    assert got.dtype == torch.float32 and tuple(got.shape) == (taps, m)
    assert cc.default_coefficients(m, taps, CPU) is got


def _jax_kernel_fir(hist, z, coeff) -> np.ndarray:
    """The JAX kernel's FIR words: its tap loop (channelizer_pallas.py,
    the kernel body) under `jax.jit`, where XLA on the CPU may fuse a
    product and a sum into one rounding."""
    taps, h, n = coeff.shape[0], hist.shape[0], z.shape[0]

    def fir(ext, co):
        acc = None
        for tap in range(taps):
            t = ext[h - tap:h - tap + n] * co[tap:tap + 1]
            acc = t if acc is None else acc + t
        return acc

    return np.array(jax.jit(fir)(jnp.concatenate([hist, jnp.asarray(z)]),
                                   jnp.asarray(coeff)))


def _product(ar, ai, m, tdt):
    """The plain version's DFT of FIR words (ar, ai), cast to ``tdt``."""
    wr, wi = (w.float() for w in chz.twiddles(m, tdt, CPU))
    ar, ai = (torch.from_numpy(x).to(tdt).float() for x in (ar, ai))
    with chz.full_f32_matmul():
        return (ar @ wr - ai @ wi).numpy(), (ar @ wi + ai @ wr).numpy()


@pytest.mark.parametrize("tw", ["f32", "bf16"])
@pytest.mark.parametrize("m,n", [(384, 104), (2048, 16)])
def test_fused_plain_matches_jax_kernel_at_new_shapes(m, n, tw):
    """Within 2e-5 of the scale.  At bf16 a row may miss only where the
    JAX kernel's FIR words, which XLA may round otherwise than the
    port's single-rounding words, cast to a neighbouring bf16 value; the
    JAX outputs then equal the plain product of its own words."""
    taps = 8
    tdt, jdt = DTYPES[tw]
    rng = np.random.default_rng(m + n)
    zr, zi = (rng.normal(size=(n, m)).astype(np.float32) for _ in range(2))
    hist = jchz.PlanesState(*(jnp.asarray(rng.normal(
        size=(taps - 1, m)).astype(np.float32)) for _ in range(2)))
    jst, jyr, jyi = jchp.channelize_fused(
        hist, jnp.asarray(zr), jnp.asarray(zi), m=m, taps=taps,
        twiddle_dtype=jdt, interpret=True)
    jyr, jyi = np.asarray(jyr), np.asarray(jyi)
    st0 = to_torch(hist, CPU)
    st, yr, yi = cc.channelize_fused_plain(
        st0, torch.from_numpy(zr), torch.from_numpy(zi), m=m, taps=taps,
        twiddle_dtype=tdt)
    scale = float(max(np.abs(jyr).max(), np.abs(jyi).max()))
    off = np.zeros(n, bool)
    for got, want in ((yr, jyr), (yi, jyi)):
        off |= np.abs(got.numpy() - want).max(1) > 2e-5 * scale
    if tw == "f32":
        assert not off.any()
    else:
        coeff = cc.default_coefficients(m, taps, CPU)
        flipped = np.zeros(n, bool)
        jfir = []
        for h, z in ((hist.hist_r, zr), (hist.hist_i, zi)):
            ours = chz.polyphase_fir(to_torch(h, CPU), torch.from_numpy(z),
                                     coeff)[0].to(tdt).view(torch.int16)
            jfir.append(_jax_kernel_fir(h, z, coeff.numpy()))
            theirs = torch.from_numpy(jfir[-1]).to(tdt).view(torch.int16)
            step = (ours.int() - theirs.int()).abs().numpy()
            assert step.max() <= 1  # neighbouring bf16 values
            flipped |= (step == 1).any(1)
        assert not (off & ~flipped).any()
        for got, want in zip(_product(*jfir, m, tdt), (jyr, jyi)):
            assert np.abs(got - want).max() <= 2e-5 * scale
    np.testing.assert_array_equal(st.hist_r.numpy(), np.asarray(jst.hist_r))
    np.testing.assert_array_equal(st.hist_i.numpy(), np.asarray(jst.hist_i))
