"""K35 `normal_bank_q`'s and K36 `normal_bank_f32`'s launch plan
(`filters/normal_cuda.py` `normal_plan`) and a CPU model of their schedule
(``csrc/structures_bank.cu`` on ``csrc/df1_ring.cuh``'s depth-0 pipeline),
held against the plain versions and the JAX package.

The kernels run a CUDA block of one 32-lane tile: producer warps, each a
span of every chunk, that write each row's feed-forward sum into the
serial warp's input ring (K35: W = b0 x0 + b1 x1 + b2 x2 mod 2^64 as two
32-bit words, K1's producers; K36: (b0 x0 + b1 x1) + b2 x2, each product
and sum rounded on its own); the serial warp, which holds y0 and y1, runs
the 2x2 rotation (K35: W + p_re y1 - p_im y0 and p_im y1 + p_re y0 mod
2^64, each shifted right by f; K36: (s + p_re y1) - p_im y0 and p_im y1 +
p_re y0, rounded one by one); a store warp that writes the y0 rows.  These
tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory at
  1024, 200, 50 and 1 lanes (K35: two words a row and lane in, one out,
  256-row chunks in 2 slots; K36: one word each way, 3 slots), and the
  plans and calls the wrappers refuse before the library is asked for;
* the serial warp's shift: bits [f, f + 32) of the sum (one funnel shift)
  for f <= 32, the high word shifted right by f - 32 for f > 32, equal the
  low word of the arithmetic shift for every f in 1..63;
* a model of the schedule (tests/torch_pipe_model.py `normal_model`: the
  producers by spans, the serial warp, the store warp, the slots and
  parities chunk by chunk, the roles interleaved at random; numpy uint64
  words for K35, numpy float32 with one rounding an operation for K36)
  equals `normal_bank_q_plain` / `normal_bank_f32_plain` bit for bit over
  carried blocks: at chunk edges, t = 1 and t under a chunk, f 1, 29, 32,
  33 and 63, sums that wrap mod 2^64 (coefficients and state at int32's
  edges, p_im = INT32_MIN + 1), several role-interleaving seeds;
* at c = 128 the K35 model equals the interpret-mode JAX `normal_bank_q`
  bit for bit; the K36 model equals JAX's eager `normal.block` (under
  ``jax.disable_jit``) bit for bit, and stays within
  tests/test_torch_structures.py's F32_ULPS of the output scale of the
  interpret-mode `normal_bank_f32`, whose jitted body may contract a
  multiply-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu import fxp as jfxp
from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import normal as jnormal
from idsp_tpu.filters.normal_pallas import normal_bank_f32 as jnormal_bank_f32
from idsp_tpu.filters.normal_pallas import normal_bank_q as jnormal_bank_q

from idsp_tpu_torch import _ext
from idsp_tpu_torch.filters import biquad, normal_cuda
from idsp_tpu_torch.filters.normal_cuda import (
    NORMAL_PRODUCERS,
    normal_bank_f32_plain,
    normal_bank_q_plain,
    normal_plan,
)
from idsp_tpu_torch.filters.pipe_plan import (
    LANES,
    MAX_PIPE_SMEM,
    PIPE_RING,
    pipe_smem,
)
from torch_pipe_model import _shift_q, normal_model

F32_ULPS = 16  # tests/test_torch_structures.py's bound
I32_MIN = -(2**31)
I32_EDGES = np.array([I32_MIN, I32_MIN + 1, -(2**30), -1, 0, 1, 2**30,
                      2**31 - 1], np.int32)


def _i32(rng, shape, lo=I32_MIN, hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _q_state(rng, c, lim=2**31):
    return biquad.Df1State(x=torch.from_numpy(_i32(rng, (c, 2), -lim, lim)),
                           y=torch.from_numpy(_i32(rng, (c, 2), -lim, lim)))


def _f32(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _f32_state(rng, c):
    return biquad.Df1State(x=_f32(rng, (c, 2)), y=_f32(rng, (c, 2)))


def _cookbook(fc=0.06):
    """The structure tests' normal-form lowpass: (b, p) as float64."""
    return jnormal.from_cookbook(JFilter().critical_frequency(fc).lowpass())


def _q_coefs(f=29, fc=0.06):
    """The lowpass at ``fc`` in Q<f> int32 words (b (3,), p (2,))."""
    b, p = _cookbook(fc)
    return (np.asarray(jfxp.from_float(jnp.asarray(b), f, dtype=jnp.int32)),
            np.asarray(jfxp.from_float(jnp.asarray(p), f, dtype=jnp.int32)))


def _f32_coefs(fc=0.06):
    b, p = _cookbook(fc)
    return b.astype(np.float32), p.astype(np.float32)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------


@pytest.mark.parametrize("c", [1024, 200, 50, 1])
def test_k35_plan_defaults(c, no_library):
    """NORMAL_PRODUCERS producer warps and the store warp beside the
    serial warp in 12 warps; two words a row and lane in and one out, so
    256-row chunks in the 2 slots that fit (196672 bytes); one CTA a
    tile."""
    p = normal_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        12, NORMAL_PRODUCERS, 256, 2, 1)
    assert (p.win, p.wout) == (2, 1)
    assert p.tiles == -(-c // LANES)
    assert p.smem == pipe_smem(256, 2, 2, 1) == 196672 <= MAX_PIPE_SMEM
    assert normal_plan(c, chunk=128).ring == 3
    forced = normal_plan(c, producers=11, warps=16, chunk=64, ring=9)
    assert (forced.warps, forced.chunk, forced.ring) == (16, 64, 9)
    assert forced.smem == 32 * 9 + 9 * 64 * LANES * 4 * 3 <= MAX_PIPE_SMEM
    assert normal_plan(c, producers=1).warps == 4


@pytest.mark.parametrize("c", [1024, 200, 50, 1])
def test_k36_plan_defaults(c, no_library):
    """NORMAL_PRODUCERS producer warps and the store warp beside the
    serial warp in 12 warps; one word a row and lane each way, so 256-row
    chunks in PIPE_RING slots (196704 bytes); one CTA a tile."""
    p = normal_plan(c, f32=True)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        12, NORMAL_PRODUCERS, 256, PIPE_RING, 1)
    assert (p.win, p.wout) == (1, 1)
    assert p.tiles == -(-c // LANES)
    assert p.smem == pipe_smem(256, PIPE_RING, 1, 1) == 196704
    forced = normal_plan(c, f32=True, producers=11, warps=16, chunk=64,
                         ring=14)
    assert (forced.warps, forced.chunk, forced.ring) == (16, 64, 14)
    assert forced.smem == 32 * 14 + 14 * 64 * LANES * 4 * 2 <= MAX_PIPE_SMEM


@pytest.mark.parametrize("f32", [False, True])
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
def test_normal_plan_refuses_what_the_kernel_cannot_run(kw, match, f32,
                                                        no_library):
    with pytest.raises(ValueError, match=match):
        normal_plan(1024, f32=f32, **kw)
    with pytest.raises(ValueError, match="lanes"):
        normal_plan(0, f32=f32)


def test_wrappers_refuse_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernels cannot run raises ValueError before
    anything is built or launched: K35's f outside 1..63 and p_im ==
    INT32_MIN, a plan the kernels cannot run, no lanes."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    bq, pq = _q_coefs()
    bf, pf = _f32_coefs()
    calls = {
        torch.int32: lambda st, xs, **kw: normal_cuda.normal_bank_q(
            bq, pq, st, xs, **kw),
        torch.float32: lambda st, xs, **kw: normal_cuda.normal_bank_f32(
            bf, pf, st, xs, **kw),
    }
    wrappers = (normal_cuda.normal_bank_q, normal_cuda.normal_bank_f32)
    n0 = [w.launches for w in wrappers]
    for dt, call in calls.items():
        st = biquad.df1_init((64,), dt, device=meta)
        xs = torch.zeros((8, 64), dtype=dt, device=meta)
        f32 = dt == torch.float32
        with pytest.raises(ValueError, match="lanes"):
            call(st, xs[:, :0])
        with pytest.raises(ValueError, match="more than"):
            call(st, xs, _plan=normal_plan(64, f32=f32, chunk=256, ring=4))
        with pytest.raises(ValueError, match="warps"):
            call(st, xs, _plan=normal_plan(64, f32=f32, warps=4,
                                           producers=3))
    st = biquad.df1_init((64,), torch.int32, device=meta)
    xs = torch.zeros((8, 64), dtype=torch.int32, device=meta)
    for f in (0, 64):
        with pytest.raises(ValueError, match="f must be"):
            normal_cuda.normal_bank_q(bq, pq, st, xs, f)
    with pytest.raises(ValueError, match="negation"):
        normal_cuda.normal_bank_q(bq, np.array([pq[0], I32_MIN], np.int32),
                                  st, xs)
    assert [w.launches for w in wrappers] == n0


# ---- the serial warp's shift ----------------------------------------------


@pytest.mark.parametrize("f", range(1, 64))
def test_the_shift_equals_the_low_word_of_the_arithmetic_shift(f):
    """The plain step keeps the low word of int64(acc) >> f; the serial
    warp (the model's `_shift_q`) takes bits [f, f + 32) of acc (the funnel
    shift, the high word at f = 32) for f <= 32 and int32(high word) >> (f
    - 32) for f > 32: the same word for every acc."""
    rng = np.random.default_rng(f)
    edges = np.array([0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
                      2**64 - 1], np.uint64)
    acc = np.concatenate([edges, rng.integers(0, 2**64, 4000,
                                              dtype=np.uint64)])
    want = (acc.view(np.int64) >> np.int64(f)).astype(np.int32)
    np.testing.assert_array_equal(_shift_q(acc, f), want)


# ---- a model of the kernel's schedule ---------------------------------------


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
    (40, 100, dict(chunk=16, ring=4)),                     # spans 4 / 0
    (36, 70, dict(chunk=8, ring=7, producers=11, warps=16)),
    (12, 30, dict(chunk=1, ring=2)),                       # empty spans
    (5, 1, dict(chunk=8)),                                 # t = 1
    (3, 2, dict(chunk=1, producers=11, warps=16)),         # rows 0 and 1
]


@pytest.mark.parametrize("c,t,kw", CASES)
def test_k35_schedule_model_equals_plain(c, t, kw):
    """Two carried blocks from a random state, the Q29 lowpass at 0.06 and
    then at 0.2 on x in +-2^27; c = 20, 36, 37 and 40 are not multiples of
    the 32-lane tile."""
    rng = np.random.default_rng(350 + c + t)
    plan = normal_plan(c, **kw)
    st = ps = _q_state(rng, c, 2**27)
    for blk, fc in enumerate((0.06, 0.2)):
        b, p = _q_coefs(29, fc)
        xs = torch.from_numpy(_i32(rng, (t, c), -(2**27), 2**27))
        got = normal_model(b, p, st, xs, plan, f=29, seed=blk)
        want = normal_bank_q_plain(b, p, ps, xs, 29)
        _same(got, want, torch.int32)
        st, ps = got[0], want[0]


@pytest.mark.parametrize("c,t,kw", CASES)
def test_k36_schedule_model_equals_plain(c, t, kw):
    """Two carried blocks from a random state, x ~ N(0, 1), the lowpass at
    0.06 and then at 0.2 (float32 coefficients)."""
    rng = np.random.default_rng(360 + c + t)
    plan = normal_plan(c, f32=True, **kw)
    st = ps = _f32_state(rng, c)
    for blk, fc in enumerate((0.06, 0.2)):
        b, p = _f32_coefs(fc)
        xs = _f32(rng, (t, c))
        got = normal_model(b, p, st, xs, plan, seed=blk)
        want = normal_bank_f32_plain(b, p, ps, xs)
        _same(got, want, torch.float32)
        st, ps = got[0], want[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("f", [1, 29, 32, 33, 63])
def test_k35_schedule_model_at_every_shift(f, seed):
    """f 1, 29, 32, 33 and 63 (both shifts, their edges at 32 and 33):
    full-range coefficients (p_im = INT32_MIN + 1 on the first block), x
    and state, so the five-term sums pass 2^63 and wrap; two carried blocks
    at 16-row chunks, the roles interleaved by three seeds."""
    c, t = 37, 3 * 16 + 5
    rng = np.random.default_rng(100 * f + seed)
    plan = normal_plan(c, chunk=16, ring=3, producers=2)
    st = ps = _q_state(rng, c)
    for blk in range(2):
        b = _i32(rng, 3, I32_MIN + 1)
        p = _i32(rng, 2, I32_MIN + 1)
        if blk == 0:
            p[1] = I32_MIN + 1
        xs = torch.from_numpy(_i32(rng, (t, c)))
        got = normal_model(b, p, st, xs, plan, f=f, seed=seed + 3 * blk)
        want = normal_bank_q_plain(b, p, ps, xs, f)
        _same(got, want, torch.int32)
        st, ps = got[0], want[0]


@pytest.mark.parametrize("f", [1, 32, 33, 63])
def test_k35_schedule_model_where_the_sum_wraps(f):
    """Coefficients, x and state at int32's edges: b at -2^31, p = (-2^31,
    -2^31 + 1), every row of the first chunk and state at -2^31, so the y1
    sum's five products pass 2^63 (checked with Python integers)."""
    c, t = 33, 40
    rng = np.random.default_rng(24 + f)
    b = np.full(3, I32_MIN, np.int32)
    p = np.array([I32_MIN, I32_MIN + 1], np.int32)
    xs = rng.choice(I32_EDGES, (t, c))
    xs[:8] = I32_MIN
    st = biquad.Df1State(x=torch.full((c, 2), I32_MIN, dtype=torch.int32),
                         y=torch.full((c, 2), I32_MIN, dtype=torch.int32))
    assert 4 * (2**31) ** 2 + (2**31) * (2**31 - 1) >= 2**63
    plan = normal_plan(c, chunk=8, ring=2, producers=3)
    x = torch.from_numpy(xs)
    _same(normal_model(b, p, st, x, plan, f=f),
          normal_bank_q_plain(b, p, st, x, f), torch.int32)


# ---- against the JAX package -------------------------------------------------


def _jstate(st):
    return jnormal.init((st.x.shape[0],), jnp.int32)._replace(
        x=jnp.asarray(st.x.numpy()), y=jnp.asarray(st.y.numpy()))


@pytest.mark.parametrize("f,full", [(29, False), (31, True)])
def test_k35_model_equals_interpret_jax_kernel(f, full):
    """c = 128 over two carried blocks at 64-row chunks: the model equals
    the interpret-mode JAX `normal_bank_q` (time chunk 128; it takes 0 < f
    < 32) bit for bit, state and output.  At f = 29 the lowpass at 0.06, x
    and state in +-2^27; at f = 31 full-range coefficients (p_im = INT32_MIN
    + 1), x and state, whose sums wrap."""
    c, t = 128, 256
    rng = np.random.default_rng(128 + f)
    lim = 2**31 if full else 2**27
    if full:
        b, p = _i32(rng, 3, I32_MIN + 1), _i32(rng, 2, I32_MIN + 1)
        p[1] = I32_MIN + 1
    else:
        b, p = _q_coefs(f)
    plan = normal_plan(c, chunk=64)
    st = _q_state(rng, c, lim)
    jst = _jstate(st)
    for blk in range(2):
        xs = _i32(rng, (t, c), -lim, lim)
        st, ys = normal_model(b, p, st, torch.from_numpy(xs), plan, f=f,
                              seed=blk)
        jst, jys = jnormal_bank_q(b, p, jst, jnp.asarray(xs), f,
                                  time_chunk=128, interpret=True)
        np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
        np.testing.assert_array_equal(st.y.numpy(), np.asarray(jst.y))


def test_k36_model_equals_jax_eager_and_interpret_kernel():
    """c = 128 over two carried blocks at 64-row chunks: the model equals
    JAX's eager `normal.block` (op by op, the first E rows of a block) bit
    for bit, and the interpret-mode JAX kernel within F32_ULPS of the
    output scale."""
    c, t, e = 128, 192, 24
    rng = np.random.default_rng(36)
    b, p = _f32_coefs()
    plan = normal_plan(c, f32=True, chunk=64)
    st = _f32_state(rng, c)

    def jstate(s):
        return jnormal.init((c,), jnp.float32)._replace(
            x=jnp.asarray(s.x.numpy()), y=jnp.asarray(s.y.numpy()))

    kst = jstate(st)
    for blk in range(2):
        xs = rng.normal(size=(t, c)).astype(np.float32)
        mst, mys = normal_model(b, p, st, torch.from_numpy(xs[:e]), plan,
                                seed=blk)
        with jax.disable_jit():
            jse, jys = jnormal.block(jnp.asarray(b), jnp.asarray(p),
                                     jstate(st), jnp.asarray(xs[:e]),
                                     unroll=1)
        np.testing.assert_array_equal(mys.numpy(), np.asarray(jys))
        np.testing.assert_array_equal(mst.x.numpy(), np.asarray(jse.x))
        np.testing.assert_array_equal(mst.y.numpy(), np.asarray(jse.y))
        st, ys = normal_model(b, p, st, torch.from_numpy(xs), plan, seed=blk)
        kst, kys = jnormal_bank_f32(b, p, kst, jnp.asarray(xs),
                                    time_chunk=64, interpret=True)
        for got, ref in ((ys, kys), (st.y, kst.y)):
            w = np.asarray(ref, np.float64)
            scale = max(float(np.abs(w).max()), 1e-30)
            assert np.abs(got.double().numpy() - w).max() <= \
                F32_ULPS * 2.0**-24 * scale
        kst = jstate(st)

