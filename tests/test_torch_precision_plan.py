"""K28 `df1_bank_q16`'s and K30 `df1_bank_f32`'s launch plans
(`filters/biquad_cuda.py` `q16_plan`, `f32_plan`) and CPU models of their
schedules (``csrc/biquad_precision.cu`` on ``csrc/df1_ring.cuh``'s depth-0
pipeline), held against the plain versions and the JAX package.

The kernels run a CUDA block of one 32-lane tile: producer warps, each a
span of every chunk, that write each row's feed-forward sum into the
serial warp's input ring (K28: W = b0 x0 + b1 x1 + b2 x2 mod 2^32, each
product the coefficient times the sign-extended int16 row; K30: (b0 x0 +
b1 x1) + b2 x2, each product and sum rounded on its own); the serial
warp, which holds y1 and y2, forms V = W + a2 y2 (K30: a2 y2) a row ahead
and runs the rest of the step (K28: V + a1 y1 and one arithmetic shift,
the coefficients scaled by 2^s, s = max(16 - f, 0), so the shift by f + s
is the plain step's int16 wrap of sum >> f; K30: (W + a1 y1) + a2 y2); a
store warp that writes the rows (K28: each word's low 16 bits).  These
tests show:

* the plans' warps, roles, chunk, ring depth, tiles and shared memory at
  1024, 200, 50 and 1 lanes (one word a row and lane each way: 256-row
  chunks in 3 slots), and the plans and calls the wrappers refuse before
  the library is asked for;
* the regrouped Q16 step: int32(2^s acc) >> (f + s) equals the plain
  step's int16 wrap of int32(acc) >> f for every f in 1..31;
* models of the schedules (tests/torch_pipe_model.py `q16_model`,
  `f32_model`: the producers by spans, the serial warp, the store warp,
  the slots and parities chunk by chunk, the roles interleaved at random;
  numpy words mod 2^32 for K28, numpy float32 with one rounding an
  operation for K30) equal `df1_bank_q16_plain` / `df1_bank_f32_plain` bit
  for bit over carried blocks: at chunk edges, t = 1 and 2, t under a
  chunk, c not a multiple of 32 or of 8, K28 at f 1, 13, 16, 17 and 31
  with coefficients, x and state at int16's edges, where the int32 sum
  wraps, several role-interleaving seeds;
* at c = 128 the K28 model equals the interpret-mode JAX `df1_bank_q16`
  bit for bit; the K30 model equals JAX's eager `df1_process` (under
  ``jax.disable_jit``) bit for bit, and stays within
  tests/test_torch_precision.py's F32_ULPS of the output scale of the
  interpret-mode `df1_bank_f32`, whose jitted body may contract a
  multiply-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import biquad_pallas as jbp

from idsp_tpu_torch import _ext
from idsp_tpu_torch.filters import biquad, biquad_cuda
from idsp_tpu_torch.filters.biquad_cuda import (
    Q16_PRODUCERS,
    df1_bank_f32_plain,
    df1_bank_q16_plain,
    f32_plan,
    q16_plan,
)
from idsp_tpu_torch.filters.pipe_plan import (
    LANES,
    MAX_PIPE_SMEM,
    PIPE_RING,
    pipe_smem,
)
from torch_pipe_model import f32_model, q16_model, q16_scale

F32_ULPS = 16  # tests/test_torch_precision.py's bound
I16_EDGES = np.array([-(2**15), -(2**15) + 1, -(2**14), -1, 0, 1, 2**14,
                      2**15 - 1], np.int16)
PLANS = {"q16": q16_plan, "f32": f32_plan}


def _i16(rng, shape, lim=2**15):
    return rng.integers(-lim, lim, size=shape).astype(np.int16)


def _q16_state(rng, c, lim=2**15):
    return biquad.Df1State(x=torch.from_numpy(_i16(rng, (c, 2), lim)),
                           y=torch.from_numpy(_i16(rng, (c, 2), lim)))


def _f32(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _f32_state(rng, c):
    return biquad.Df1State(x=_f32(rng, (c, 2)), y=_f32(rng, (c, 2)))


def _lowpass(fc=0.1):
    """The suite's lowpass (float64 coefficients)."""
    return np.asarray(jbiquad.from_cookbook(
        JFilter().critical_frequency(fc).lowpass()))


def _q16_ba(fc=0.1, f=13):
    """The lowpass at ``fc`` as Q16<f> int16 words."""
    return jbiquad.quantize_ba(_lowpass(fc), f, dtype=np.int16)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plans ---------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(PLANS))
@pytest.mark.parametrize("c", [1024, 200, 50, 1])
def test_plan_defaults(c, kind, no_library):
    """Q16_PRODUCERS producer warps and the store warp beside the serial
    warp in 12 warps; one word a row and lane each way, so
    256-row chunks in PIPE_RING slots (196704 bytes); one CTA a tile."""
    p = PLANS[kind](c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        12, Q16_PRODUCERS, 256, PIPE_RING, 1)
    assert (p.win, p.wout) == (1, 1)
    assert p.tiles == -(-c // LANES)
    assert p.smem == pipe_smem(256, PIPE_RING, 1, 1) == 196704 <= \
        MAX_PIPE_SMEM
    forced = PLANS[kind](c, producers=11, warps=16, chunk=64, ring=14)
    assert (forced.warps, forced.chunk, forced.ring) == (16, 64, 14)
    assert forced.smem == 32 * 14 + 14 * 64 * LANES * 4 * 2 <= MAX_PIPE_SMEM
    assert PLANS[kind](c, producers=1).warps == 4
    assert PLANS[kind](c, chunk=128).ring == PIPE_RING


@pytest.mark.parametrize("kind", sorted(PLANS))
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
def test_plans_refuse_what_the_kernels_cannot_run(kw, match, kind,
                                                  no_library):
    with pytest.raises(ValueError, match=match):
        PLANS[kind](1024, **kw)
    with pytest.raises(ValueError, match="lanes"):
        PLANS[kind](0)


def test_wrappers_refuse_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernels cannot run raises ValueError before
    anything is built or launched: K28's f outside 1..31, a plan the
    kernels cannot run, no lanes."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    calls = {
        "q16": (torch.int16, lambda st, xs, **kw: biquad_cuda.df1_bank_q16(
            _q16_ba(), st, xs, 13, **kw)),
        "f32": (torch.float32, lambda st, xs, **kw: biquad_cuda.df1_bank_f32(
            _lowpass(), st, xs, **kw)),
    }
    wrappers = (biquad_cuda.df1_bank_q16, biquad_cuda.df1_bank_f32)
    n0 = [w.launches for w in wrappers]
    for kind, (dt, call) in calls.items():
        st = biquad.df1_init((64,), dt, device=meta)
        xs = torch.zeros((8, 64), dtype=dt, device=meta)
        with pytest.raises(ValueError, match="lanes"):
            call(st, xs[:, :0])
        with pytest.raises(ValueError, match="more than"):
            call(st, xs, _plan=PLANS[kind](64, chunk=256, ring=4))
        with pytest.raises(ValueError, match="warps"):
            call(st, xs, _plan=PLANS[kind](64, warps=4, producers=3))
    st = biquad.df1_init((64,), torch.int16, device=meta)
    xs = torch.zeros((8, 64), dtype=torch.int16, device=meta)
    for f in (0, 32):
        with pytest.raises(ValueError, match="f must be"):
            biquad_cuda.df1_bank_q16(_q16_ba(), st, xs, f)
    assert [w.launches for w in wrappers] == n0


# ---- the regrouped Q16 step -------------------------------------------------


@pytest.mark.parametrize("f", range(1, 32))
def test_the_scaled_shift_equals_the_int16_wrap(f):
    """The plain step keeps int16(int32(acc) >> f), acc the five-term sum
    mod 2^32; the serial warp (coefficients scaled by 2^s, `q16_scale`)
    takes int32(2^s acc mod 2^32) >> (f + s), sign-extended: the same value
    for every acc."""
    s, sh = q16_scale(f)
    assert sh == max(f, 16) and s == sh - f
    rng = np.random.default_rng(f)
    edges = np.array([0, 1, 2**15 - 1, 2**15, 2**31 - 1, 2**31, 2**32 - 1],
                     np.uint64)
    acc = np.concatenate([edges, rng.integers(0, 2**32, 4000,
                                              dtype=np.uint64)])
    plain = (acc.astype(np.uint32).view(np.int32) >> np.int32(f)).astype(
        np.int16)
    scaled = ((acc << np.uint64(s)) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32).view(np.int32) >> np.int32(sh)
    assert scaled.min() >= -(2**15) and scaled.max() < 2**15
    np.testing.assert_array_equal(scaled, plain.astype(np.int32))


# ---- models of the kernels' schedules ----------------------------------------


def _same(got, want, dtype):
    (gs, gy), (ws, wy) = got, want
    assert gy.dtype == wy.dtype == dtype
    assert gy.shape == wy.shape
    assert torch.equal(gy, wy)
    for a, b in ((gs.x, ws.x), (gs.y, ws.y)):
        assert a.dtype == b.dtype == dtype
        assert torch.equal(a, b)


CASES = [
    # (c, t, plan keywords)
    (16, 40, dict(chunk=64)),                              # t under a chunk
    (20, 48, dict(chunk=48, ring=2)),                      # t = one chunk
    (37, 3 * 20 + 9, dict(chunk=20, ring=2, producers=3)),  # spans 7, 7, 6
    (8, 5 * 24 + 7, dict(chunk=24, ring=3, producers=5)),   # span 5
    (40, 100, dict(chunk=16, ring=4)),                     # spans 2 / 0
    (36, 70, dict(chunk=8, ring=7, producers=11, warps=16)),
    (12, 30, dict(chunk=1, ring=2)),                       # empty spans
    (5, 1, dict(chunk=8)),                                 # t = 1
    (3, 2, dict(chunk=1, producers=11, warps=16)),         # rows 0 and 1
    (44, 2, dict(chunk=16)),                               # t = 2
]


@pytest.mark.parametrize("c,t,kw", CASES)
def test_k28_schedule_model_equals_plain(c, t, kw):
    """Two carried blocks from a random state, the Q16<13> lowpass at 0.1
    and then at 0.02 on x in +-2^14; c = 5, 20, 36, 37, 44 are not
    multiples of 8 or of the 32-lane tile."""
    rng = np.random.default_rng(280 + c + t)
    plan = q16_plan(c, **kw)
    st = ps = _q16_state(rng, c, 2**14)
    for blk, fc in enumerate((0.1, 0.02)):
        ba = _q16_ba(fc)
        xs = torch.from_numpy(_i16(rng, (t, c), 2**14))
        got = q16_model(ba, 13, st, xs, plan, seed=blk)
        want = df1_bank_q16_plain(ba, ps, xs, 13)
        _same(got, want, torch.int16)
        st, ps = got[0], want[0]


@pytest.mark.parametrize("c,t,kw", CASES)
def test_k30_schedule_model_equals_plain(c, t, kw):
    """Two carried blocks from a random state, x ~ N(0, 1), the lowpass at
    0.1 and then at 0.02 (float32 coefficients)."""
    rng = np.random.default_rng(300 + c + t)
    plan = f32_plan(c, **kw)
    st = ps = _f32_state(rng, c)
    for blk, fc in enumerate((0.1, 0.02)):
        ba = _lowpass(fc)
        xs = _f32(rng, (t, c))
        got = f32_model(ba, st, xs, plan, seed=blk)
        want = df1_bank_f32_plain(ba, ps, xs)
        _same(got, want, torch.float32)
        st, ps = got[0], want[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("f", [1, 13, 16, 17, 31])
def test_k28_schedule_model_at_every_shift(f, seed):
    """f 1, 13, 16, 17 and 31 (both scale regimes, their edges at 15 / 16
    and 16 / 17): full-range int16 coefficients, x and state, so the
    five-term int32 sums wrap; two carried blocks at 16-row chunks, the
    roles interleaved by three seeds."""
    c, t = 37, 3 * 16 + 5
    rng = np.random.default_rng(100 * f + seed)
    plan = q16_plan(c, chunk=16, ring=3, producers=2)
    st = ps = _q16_state(rng, c)
    for blk in range(2):
        ba = _i16(rng, 5)
        xs = torch.from_numpy(_i16(rng, (t, c)))
        got = q16_model(ba, f, st, xs, plan, seed=seed + 3 * blk)
        want = df1_bank_q16_plain(ba, ps, xs, f)
        _same(got, want, torch.int16)
        st, ps = got[0], want[0]


@pytest.mark.parametrize("f", [1, 13, 16, 17, 31])
def test_k28_schedule_model_where_the_sum_wraps(f):
    """Coefficients, x and state at int16's edges: every coefficient
    -2^15, every row of the first chunk and the state -2^15, so each of the
    five products is 2^30 and their sum passes 2^31 (wraps in int32); the
    other rows at int16's edges."""
    c, t = 33, 40
    rng = np.random.default_rng(16 + f)
    ba = np.full(5, -(2**15), np.int16)
    xs = rng.choice(I16_EDGES, (t, c))
    xs[:8] = -(2**15)
    assert 5 * (2**15) ** 2 >= 2**31
    st = biquad.Df1State(x=torch.full((c, 2), -(2**15), dtype=torch.int16),
                         y=torch.full((c, 2), -(2**15), dtype=torch.int16))
    plan = q16_plan(c, chunk=8, ring=2, producers=3)
    x = torch.from_numpy(xs)
    _same(q16_model(ba, f, st, x, plan), df1_bank_q16_plain(ba, st, x, f),
          torch.int16)


# ---- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("f,full", [(13, False), (17, True), (31, True)])
def test_k28_model_equals_interpret_jax_kernel(f, full):
    """c = 128 over two carried blocks at 64-row chunks: the model equals
    the interpret-mode JAX `df1_bank_q16` (time chunk 64) bit for bit,
    state and output.  At f = 13 the Q16<13> lowpass at 0.05, x and state
    in +-2^14; at f = 17 and 31 full-range int16 coefficients, x and state,
    whose int32 sums wrap."""
    c, t = 128, 192
    rng = np.random.default_rng(128 + f)
    lim = 2**15 if full else 2**14
    ba = _i16(rng, 5) if full else _q16_ba(0.05, f)
    plan = q16_plan(c, chunk=64)
    st = _q16_state(rng, c, lim)
    jst = jbiquad.Df1State(x=jnp.asarray(st.x.numpy()),
                           y=jnp.asarray(st.y.numpy()))
    for blk in range(2):
        xs = _i16(rng, (t, c), lim)
        st, ys = q16_model(ba, f, st, torch.from_numpy(xs), plan, seed=blk)
        jst, jys = jbp.df1_bank_q16(jnp.asarray(ba), jst, jnp.asarray(xs),
                                    f, time_chunk=64, interpret=True)
        np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
        np.testing.assert_array_equal(st.y.numpy(), np.asarray(jst.y))


def test_k30_model_equals_jax_eager_and_interpret_kernel():
    """c = 128 over two carried blocks at 64-row chunks: the model equals
    JAX's eager `df1_process` (op by op, under ``jax.disable_jit``) bit for
    bit, and the interpret-mode JAX kernel within F32_ULPS of the output
    scale, output and state."""
    c, t = 128, 192
    rng = np.random.default_rng(30)
    ba5 = _lowpass()
    ba32 = ba5.astype(np.float32)
    plan = f32_plan(c, chunk=64)
    st = _f32_state(rng, c)

    def jstate(s):
        return jbiquad.Df1State(x=jnp.asarray(s.x.numpy()),
                                y=jnp.asarray(s.y.numpy()))

    kst = jstate(st)
    for blk in range(2):
        xs = rng.normal(size=(t, c)).astype(np.float32)
        with jax.disable_jit():
            jse, jys = jbiquad.df1_process(jnp.asarray(ba32), jstate(st),
                                           jnp.asarray(xs))
        st, ys = f32_model(ba5, st, torch.from_numpy(xs), plan, seed=blk)
        np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(jse.x))
        np.testing.assert_array_equal(st.y.numpy(), np.asarray(jse.y))
        kst, kys = jbp.df1_bank_f32(ba5, kst, jnp.asarray(xs),
                                    time_chunk=64, interpret=True)
        scale = float(np.abs(np.asarray(kys)).max())
        bound = F32_ULPS * float(np.spacing(np.float32(scale)))
        assert np.abs(ys.numpy() - np.asarray(kys)).max() <= bound
        assert np.abs(st.y.numpy() - np.asarray(kst.y)).max() <= bound
        kst = jstate(st)
