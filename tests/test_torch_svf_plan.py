"""K34 `svf_bank`'s launch plan (`filters/svf_cuda.py` `svf_plan`) and a
CPU model of its schedule (``csrc/structures_bank.cu`` on
``csrc/df1_ring.cuh``'s depth-0 pipeline), held against the plain version
and the JAX package.

The kernel runs a CUDA block of one 32-lane tile: producer warps, each a
span of every chunk, that copy the x rows into the serial warp's input
ring a batch ahead; the serial warp, which holds lp, hp and bp, runs the
Chamberlin update (bp qi beside bp f, off its chain; bp f, + lp, x - lp,
- bp qi, hp f, + bp on it, each rounded on its own) into the output ring;
a store warp that writes the f32 rows.  These tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory at
  1024, 200, 50 and 1 lanes (one word a row and lane each way: 256-row
  chunks in 3 slots), and the plans and calls it refuses before the
  library is asked for;
* a model of the schedule (tests/torch_pipe_model.py `svf_model`: the
  producers by spans, the serial warp, the store warp, the slots and
  parities chunk by chunk, the roles interleaved at random, numpy float32
  with one rounding an operation) equals `svf_bank_plain` bit for bit over
  carried blocks for all four outputs: at chunk edges, t = 1 and t under a
  chunk;
* at c = 128 the model equals JAX's eager `svf.block` (under
  ``jax.disable_jit``) bit for bit, and stays within
  tests/test_torch_structures.py's F32_ULPS of the output scale of the
  interpret-mode `svf_pallas.svf_bank`, whose jitted body may contract a
  multiply-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import svf as jsvf
from idsp_tpu.filters.svf_pallas import svf_bank as jsvf_bank

from idsp_tpu_torch import _ext
from idsp_tpu_torch.filters import svf, svf_cuda
from idsp_tpu_torch.filters.pipe_plan import (
    LANES,
    MAX_PIPE_SMEM,
    PIPE_RING,
    pipe_smem,
)
from idsp_tpu_torch.filters.svf_cuda import (
    OUTPUTS,
    SVF_PRODUCERS,
    svf_bank_plain,
    svf_plan,
)
from torch_pipe_model import svf_model

F32_ULPS = 16  # tests/test_torch_structures.py's bound


def _f32(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _state(rng, c):
    return svf.SvfState(*(_f32(rng, (c,)) for _ in range(3)))


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------


@pytest.mark.parametrize("c", [1024, 200, 50, 1])
def test_svf_plan_defaults(c, no_library):
    """SVF_PRODUCERS producer warps and the store warp beside the serial
    warp in 8 warps; one word a row and lane each way, so 256-row chunks
    in PIPE_RING slots (196704 bytes); one CTA a tile."""
    p = svf_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        8, SVF_PRODUCERS, 256, PIPE_RING, 1)
    assert (p.win, p.wout) == (1, 1)
    assert p.tiles == -(-c // LANES)
    assert p.smem == pipe_smem(256, PIPE_RING, 1, 1) == 196704
    assert p.smem <= MAX_PIPE_SMEM
    forced = svf_plan(c, producers=11, warps=16, chunk=64, ring=14)
    assert (forced.warps, forced.chunk, forced.ring) == (16, 64, 14)
    assert forced.smem == 32 * 14 + 14 * 64 * LANES * 4 * 2 <= MAX_PIPE_SMEM
    assert svf_plan(c, producers=1).warps == 4


@pytest.mark.parametrize("kw,match", [
    (dict(producers=0), "producers"),
    (dict(cluster=2), "one CTA"),
    (dict(warps=8, producers=6), "warps"),   # 7 roles in 6 places
    (dict(warps=20), "warps"),               # more than 16
    (dict(chunk=0), "chunk"),
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=256, ring=4), "more than"),
    (dict(chunk=1024), "no ring"),
])
def test_svf_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        svf_plan(1024, **kw)
    with pytest.raises(ValueError, match="lanes"):
        svf_plan(0)


def test_wrapper_refuses_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    st = svf.init((64,), device=meta)
    xs = torch.zeros((8, 64), dtype=torch.float32, device=meta)
    n0 = svf_cuda.svf_bank.launches
    with pytest.raises(ValueError, match="output"):
        svf_cuda.svf_bank(0.1, 1.0, st, xs, output="notch")
    with pytest.raises(ValueError, match="lanes"):
        svf_cuda.svf_bank(0.1, 1.0, st, xs[:, :0])
    with pytest.raises(ValueError, match="more than"):
        svf_cuda.svf_bank(0.1, 1.0, st, xs,
                          _plan=svf_plan(64, chunk=256, ring=4))
    with pytest.raises(ValueError, match="warps"):
        svf_cuda.svf_bank(0.1, 1.0, st, xs,
                          _plan=svf_plan(64, warps=4, producers=3))
    assert svf_cuda.svf_bank.launches == n0


# ---- a model of the kernel's schedule ---------------------------------------


def _same(got, want):
    (gs, gy), (ws, wy) = got, want
    assert gy.dtype == wy.dtype == torch.float32
    assert torch.equal(gy, wy)
    for a, b in zip(gs, ws, strict=True):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)


SVF_CASES = [
    # (c, t, plan keywords)
    (16, 40, dict(chunk=64)),                              # t under a chunk
    (20, 48, dict(chunk=48, ring=2)),                      # t = one chunk
    (37, 3 * 20 + 9, dict(chunk=20, ring=2, producers=3)),  # spans 7, 7, 6
    (8, 5 * 24 + 7, dict(chunk=24, ring=3, producers=5)),   # span 5
    (40, 100, dict(chunk=16, ring=4)),                     # spans 4 / 0
    (36, 70, dict(chunk=8, ring=7, producers=11, warps=16)),
    (12, 30, dict(chunk=1, ring=2)),                       # empty spans
    (5, 1, dict(chunk=8)),                                 # t = 1
]


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("c,t,kw", SVF_CASES)
def test_k34_schedule_model_equals_plain(c, t, kw, output):
    """Two carried blocks from a random state, x ~ N(0, 1), a resonant
    bandpass (f0 0.04, Q 1.3, as the structure tests) and a wide one (f0
    0.2, Q 0.6) on the second; c = 20, 36, 37 and 40 are not multiples of
    the 32-lane tile."""
    rng = np.random.default_rng(340 + c + len(output))
    plan = svf_plan(c, **kw)
    st = ps = _state(rng, c)
    for blk, (f0, q) in enumerate(((0.04, 1.3), (0.2, 0.6))):
        f, qi = svf.coefficients(f0, q)
        xs = _f32(rng, (t, c))
        got = svf_model(f, qi, st, xs, plan, output=output, seed=blk)
        want = svf_bank_plain(f, qi, ps, xs, output=output)
        _same(got, want)
        st, ps = got[0], want[0]


def test_k34_br_is_hp_plus_lp():
    """The serial warp's br (hp + lp, off its chain) is the sum of its own
    hp and lp outputs, rounded once."""
    c, t = 33, 50
    rng = np.random.default_rng(34)
    f, qi = svf.coefficients(0.1, 0.9)
    st, xs = _state(rng, c), _f32(rng, (t, c))
    plan = svf_plan(c, chunk=16, ring=2)
    outs = {o: svf_model(f, qi, st, xs, plan, output=o)[1]
            for o in ("hp", "lp", "br")}
    assert torch.equal(outs["br"], outs["hp"] + outs["lp"])


# ---- against the JAX package -------------------------------------------------


def _jstate(st):
    return jsvf.SvfState(*(jnp.asarray(w.numpy()) for w in st))


@pytest.mark.parametrize("output", OUTPUTS)
def test_schedule_model_equals_jax(output):
    """c = 128 over two carried blocks at 64-row chunks: the model equals
    JAX's eager `svf.block` (its field; ``br`` = hp + lp) bit for bit, and
    the interpret-mode JAX kernel within F32_ULPS of the output scale."""
    c, t, e = 128, 192, 24
    rng = np.random.default_rng(128 + len(output))
    f, qi = svf.coefficients(0.04, 1.3)
    plan = svf_plan(c, chunk=64)
    st = _state(rng, c)
    jst, kst = _jstate(st), _jstate(st)
    for blk in range(2):
        xs = rng.normal(size=(t, c)).astype(np.float32)
        # eager JAX, op by op: the first e rows of the block
        mst, mys = svf_model(f, qi, st, torch.from_numpy(xs[:e]), plan,
                             output=output, seed=blk)
        with jax.disable_jit():
            jse, jouts = jsvf.block(np.float32(f), np.float32(qi), jst,
                                    jnp.asarray(xs[:e]), unroll=1)
        want = jouts.br if output == "br" else getattr(jouts, output)
        np.testing.assert_array_equal(mys.numpy(), np.asarray(want))
        for a, b in zip(mst, jse, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the whole block against the interpret-mode kernel
        st, ys = svf_model(f, qi, st, torch.from_numpy(xs), plan,
                           output=output, seed=blk)
        kst, kys = jsvf_bank(f, qi, kst, jnp.asarray(xs), output=output,
                             time_chunk=64, interpret=True)
        for got, ref in ((ys, kys), *zip(st, kst, strict=True)):
            w = np.asarray(ref, np.float64)
            scale = max(float(np.abs(w).max()), 1e-30)
            assert np.abs(got.double().numpy() - w).max() <= \
                F32_ULPS * 2.0**-24 * scale
        jst = _jstate(st)
