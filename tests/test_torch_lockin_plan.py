"""K16 `ddc_lockin_bank`: its launch plan (`filters/ddc_lockin_cuda.py`
`lockin_plan`) and a CPU model of its schedule (``csrc/ddc_lockin.cu`` on
``csrc/df1_ring.cuh``'s depth-0 pipeline), held against the plain version
and the JAX package.

The kernel runs a CUDA block of one tile of 32 of the 2c I|Q lanes:
producer warps, each a span of every chunk, form each row's factored LO,
the mix and the feed-forward sum W = (b0 x0 + b1 x1) + b2 x2 into the
serial warp's input ring (a span's first rows take x1 and x2 from the mix
of the rows before it, the block's first from the state); the serial
warp, which holds y1 and y2, forms a2 y2 a row ahead and runs (W + a1 y1)
+ a2 y2; a store warp writes the f32 rows.  These tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory at
  512, 100, 16 and 1 channels, and the plans and calls it refuses before
  the library is asked for; a time chunk above the old kernel's 8192-row
  staging limit is no longer refused;
* a model of the schedule (tests/torch_pipe_model.py `lockin_model`: the
  producers by spans, the serial warp, the store warp, the slots and
  parities chunk by chunk, the roles interleaved at random, numpy float32)
  equals `ddc_lockin_bank_plain` bit for bit over carried blocks: at span
  and chunk edges, t = time_chunk, time chunks other than the pipeline's
  chunk (one above 8192), t = 1 and 0, a nonzero carried state, n0 > 0;
* at c = 128 the model equals the JAX package's composition of the same
  function run op by op (``jax.disable_jit``: the same factor tables, the
  mix, `biquad.df1_process`) bit for bit; the JAX kernel builds its own
  tables, whose cos/sin round an ULP apart from PyTorch's, and XLA
  contracts its DF1 into FMAs, so against the interpret-mode kernel the
  model is held within 5e-5, as tests/test_torch_lockin.py holds the
  plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters.ddc_pallas import ddc_lockin_bank as j_ddc_lockin_bank

from idsp_tpu_torch import _ext
from idsp_tpu_torch.filters import biquad, ddc_lockin_cuda
from idsp_tpu_torch.filters.ddc_lockin_cuda import (
    LOCKIN_PRODUCERS,
    ddc_lockin_bank_plain,
    lockin_plan,
    lockin_tables,
)
from idsp_tpu_torch.filters.pipe_plan import (
    LANES,
    MAX_PIPE_SMEM,
    PIPE_CHUNK,
    PIPE_RING,
    pipe_smem,
)
from torch_pipe_model import lockin_model

CPU = torch.device("cpu")
BA = jbiquad.from_cookbook(
    JFilter().critical_frequency(0.002).lowpass()).astype(np.float32)
BA_WIDE = jbiquad.from_cookbook(
    JFilter().critical_frequency(0.2).lowpass()).astype(np.float32)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------


@pytest.mark.parametrize("c", [512, 100, 16, 1])
def test_lockin_plan_defaults(c, no_library):
    """LOCKIN_PRODUCERS producer warps and the store warp beside the serial
    warp in 16 warps; one word a row and lane each way, so PIPE_CHUNK-row
    chunks in the PIPE_RING slots that fit; 2c lanes in tiles of 32; one
    CTA a tile."""
    p = lockin_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        16, LOCKIN_PRODUCERS, PIPE_CHUNK, PIPE_RING, 1)
    assert (p.win, p.wout) == (1, 1)
    assert p.tiles == -(-2 * c // LANES)
    assert p.smem == pipe_smem(256, 3) == 196704 <= MAX_PIPE_SMEM
    forced = lockin_plan(c, producers=2, chunk=24, ring=5)
    assert (forced.warps, forced.chunk, forced.smem) == (
        4, 24, pipe_smem(24, 5))


@pytest.mark.parametrize("kw,match", [
    (dict(producers=0), "producers"),
    (dict(warps=8, producers=6), "warps"),    # 7 roles in 6 places
    (dict(warps=20), "warps"),
    (dict(cluster=2), "one CTA"),
    (dict(chunk=0), "chunk"),
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=512, ring=3), "more than"),
    (dict(chunk=2048), "no ring"),
])
def test_lockin_plan_refuses_what_the_kernel_cannot_run(kw, match,
                                                        no_library):
    with pytest.raises(ValueError, match=match):
        lockin_plan(512, **kw)
    with pytest.raises(ValueError, match="channels"):
        lockin_plan(0)


def test_wrapper_refuses_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched; a time chunk above 8192 rows goes on to
    the library."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    c = 20
    lo = np.linspace(0.1, 0.2, c)
    st = biquad.df1_init((2 * c,), torch.float32, device=meta)
    x = torch.zeros((1000,), device=meta)
    n0 = ddc_lockin_cuda.ddc_lockin_bank.launches
    with pytest.raises(ValueError, match="time_chunk"):
        ddc_lockin_cuda.ddc_lockin_bank(BA, st, x, lo)  # 1000 % 256
    with pytest.raises(ValueError, match="time_chunk"):
        ddc_lockin_cuda.ddc_lockin_bank(BA, st, x, lo, time_chunk=0)
    with pytest.raises(ValueError, match="one CTA"):
        ddc_lockin_cuda.ddc_lockin_bank(BA, st, x[:512], lo,
                                        _plan=lockin_plan(c, cluster=2))
    assert ddc_lockin_cuda.ddc_lockin_bank.launches == n0
    big = torch.zeros((16384,), device=meta)
    with pytest.raises(AssertionError, match="library was asked"):
        ddc_lockin_cuda.ddc_lockin_bank(BA, st, big, lo, time_chunk=16384)


# ---- a model of the kernel's schedule ---------------------------------------


def _state(rng, c, scale=1.0):
    return biquad.Df1State(
        x=torch.from_numpy((rng.normal(size=(2 * c, 2)) * scale).astype(
            np.float32)),
        y=torch.from_numpy((rng.normal(size=(2 * c, 2)) * scale).astype(
            np.float32)))


def _same(got, want):
    (gs, gy), (ws, wy) = got, want
    assert gy.dtype == wy.dtype == torch.float32
    assert torch.equal(gy.view(torch.int32), wy.view(torch.int32))
    assert torch.equal(gs.x.view(torch.int32), ws.x.view(torch.int32))
    assert torch.equal(gs.y.view(torch.int32), ws.y.view(torch.int32))


LOCKIN_CASES = [
    # (c, t, time_chunk, n0, plan keywords)
    (16, 256, 256, 0, {}),                                  # t = time_chunk
    (20, 240, 48, 1000, dict(chunk=44, ring=2, producers=3)),  # t % chunk
    (3, 96, 8, 17, dict(chunk=24, producers=5)),            # tc < span
    (9, 60, 12, 5, dict(chunk=7, ring=4, producers=4)),     # 2-row spans
    (40, 130, 13, 0, dict(chunk=32, ring=4, producers=11, warps=16)),
    (5, 64, 64, 3, dict(chunk=1, ring=2)),                  # empty spans
    (4, 1, 1, 9, dict(chunk=8)),                            # t = 1
    (2, 0, 4, 0, {}),                                       # no rows
    (1, 8200, 8200, 77, dict(chunk=64, ring=3)),            # tc > 8192
]


@pytest.mark.parametrize("c,t,tc,n0,kw", LOCKIN_CASES)
def test_lockin_model_equals_plain(c, t, tc, n0, kw):
    """Two carried blocks from a random state (n0 carried too), the
    wideband lowpass at 0.2 and x ~ N(0, 1)."""
    rng = np.random.default_rng(600 + c + t)
    plan = lockin_plan(c, **kw)
    lo = rng.uniform(0.01, 0.49, c)
    st = ps = _state(rng, c)
    for blk in range(2):
        x = torch.from_numpy(rng.normal(size=t).astype(np.float32))
        st, y = lockin_model(BA_WIDE, st, x, lo, n0 + blk * t, plan,
                             time_chunk=tc, seed=blk)
        ps, py = ddc_lockin_bank_plain(BA_WIDE, ps, x, lo, n0 + blk * t,
                                       time_chunk=tc)
        _same((st, y), (ps, py))


def test_lockin_model_equals_jax_op_by_op():
    """At c = 128, from a random state, the lock-in lowpass at 0.002: the
    model against the JAX package's composition of the same function on
    the same factor tables, run op by op (each product and sum rounds on
    its own there too): state and output bit for bit."""
    c, t, tc, n0 = 128, 288, 96, 4096
    rng = np.random.default_rng(61)
    lo = np.linspace(0.05, 0.45, c)
    st = _state(rng, c)
    x = rng.normal(size=t).astype(np.float32)
    got = lockin_model(BA, st, torch.from_numpy(x), lo, n0,
                       lockin_plan(c, chunk=80), time_chunk=tc)
    ca, sa, cb, sb = (jnp.asarray(v.numpy())
                      for v in lockin_tables(lo, n0, t, tc, device=CPU))
    with jax.disable_jit():
        lo_re = (ca[:, None] * cb - sa[:, None] * sb).reshape(t, c)
        lo_im = (sa[:, None] * cb + ca[:, None] * sb).reshape(t, c)
        xb = jnp.asarray(x)[:, None]
        miq = jnp.concatenate([xb * lo_re, -(xb * lo_im)], axis=1)
        jst, jy = jbiquad.df1_process(
            jnp.asarray(BA), jbiquad.Df1State(jnp.asarray(st.x.numpy()),
                                              jnp.asarray(st.y.numpy())),
            miq)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jy))
    np.testing.assert_array_equal(got[0].x.numpy(), np.asarray(jst.x))
    np.testing.assert_array_equal(got[0].y.numpy(), np.asarray(jst.y))


def test_lockin_model_tracks_jax_kernel():
    """At c = 128 over two blocks carried by n0 (t = 4096, time chunk
    256), one tone: the model against the interpret-mode JAX kernel within
    5e-5 (the bound and its reason: tests/test_torch_lockin.py)."""
    c, t = 128, 4096
    lo = np.linspace(0.05, 0.45, c)
    i = np.arange(t, dtype=np.float64)
    x = np.cos(2 * np.pi * lo[40] * i + 0.37).astype(np.float32)
    h = t // 2
    jst = jbiquad.df1_init((2 * c,), jnp.float32)
    st = biquad.df1_init((2 * c,), torch.float32, device=CPU)
    ys, jys = [], []
    for n0 in (0, h):
        jst, jy = j_ddc_lockin_bank(BA, jst, jnp.asarray(x[n0:n0 + h]), lo,
                                    n0, time_chunk=256, interpret=True)
        st, y = lockin_model(BA, st, torch.from_numpy(x[n0:n0 + h]), lo, n0,
                             lockin_plan(c), time_chunk=256, seed=n0)
        ys.append(y.numpy())
        jys.append(np.asarray(jy))
    assert np.abs(np.concatenate(ys) - np.concatenate(jys)).max() < 5e-5
    np.testing.assert_allclose(st.y.numpy(), np.asarray(jst.y), atol=5e-5)
