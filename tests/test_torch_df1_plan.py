"""K1 `df1_bank_q`'s, K11 `df1_bank_q_dec`'s, K18 `df1_clamp_bank_q`'s,
K26 `df1_bank_q_coef`'s and K27 `df1_clamp_bank_q_coef`'s launch plan
(`filters/biquad_cuda.py` `df1_plan`) and a CPU model of their schedule
(``csrc/df1_bank.cu`` on ``csrc/df1_ring.cuh``'s depth-0 pipeline), held
against the plain versions and the interpret-mode JAX kernels.

The kernel runs a CUDA block of one 32-lane tile: producer warps, each a
span of every chunk, that write each row's feed-forward sum W = b0 x0 +
b1 x1 + b2 x2 mod 2^64 (two 32-bit words) into the serial warp's input
ring; the serial warp, which holds y1 and y2, adds a2 y2 (off its chain)
and a1 y1, keeps the low word of the sum >> f and clamps (K18, K27),
feeding the clamped value back; a store warp that writes the kept rows
(K11: block row % d == 0) as int32 or (K1) f32.  These tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory at
  1024, 200, 50 and 1 lanes (2 words a row and lane in, 1 out: 256-row
  chunks in 2 slots), and the plans and calls it refuses before the
  library is asked for;
* the serial warp's shift: bits [f, f + 32) of the sum (one funnel shift)
  for f <= 32, the high word shifted right by f - 32 for f > 32, equal the
  low word of the arithmetic shift for every f in 1..63;
* a model of the schedule (tests/torch_pipe_model.py `df1w_model`: the
  producers by spans, the serial warp, the store warp keeping rows by the
  block's row, the slots and parities chunk by chunk, the roles
  interleaved at random, numpy uint64 words) equals the five plain
  versions bit for bit over carried blocks: at chunk edges, t = 1 and t
  under a chunk, f from 1 to 63, sums that wrap mod 2^64, the clamp
  engaged, K11's kept rows where the chunk is not a multiple of d,
  per-lane and shared coefficient planes;
* at c = 128 the plain versions equal the interpret-mode JAX kernels
  `biquad_pallas.df1_bank_q`, `df1_bank_q_dec`, `df1_clamp_bank_q`,
  `df1_bank_q_coef` and `df1_clamp_bank_q_coef` bit for bit.
"""

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
    DF1_PRODUCERS,
    df1_bank_q_coef_plain,
    df1_bank_q_dec_plain,
    df1_bank_q_plain,
    df1_clamp_bank_q_coef_plain,
    df1_clamp_bank_q_plain,
    df1_plan,
)
from idsp_tpu_torch.filters.pipe_plan import LANES, MAX_PIPE_SMEM, pipe_smem
from torch_pipe_model import df1w_model

CLAMP = (1 << 10, -(1 << 23), 1 << 23)
I32_EDGES = np.array([-(2**31), -(2**31) + 1, -(2**30), -1, 0, 1, 2**30,
                      2**31 - 1], np.int32)


@pytest.fixture(autouse=True)
def fresh_coef_jit_caches():
    """After each test, empties the jit caches of the JAX K26/K27 entry
    points, as a fresh process has them (JAX's own retune test counts a
    new cache entry at c = t = 128 on the same worker)."""
    yield
    jbp._df1_bank_q_coef_impl.clear_cache()
    jbp._df1_clamp_bank_q_coef_impl.clear_cache()


def _ba(fc=0.1, f=29):
    """The suite's Q<f> lowpass at ``fc`` (int32 words)."""
    ba5 = jbiquad.from_cookbook(JFilter().critical_frequency(fc).lowpass())
    return jbiquad.quantize_ba(ba5, f)


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _state(rng, c, lim=2**31):
    return biquad.Df1State(x=torch.from_numpy(_i32(rng, (c, 2), -lim, lim)),
                           y=torch.from_numpy(_i32(rng, (c, 2), -lim, lim)))


def _coefs(rng, f, shape=(5,)):
    """Coefficients in +-2^(f + 1) (full range from f = 30 on), as the
    card's edge checks draw them."""
    top = min(2**31 - 1, 2 << f)
    return rng.integers(-top, top + 1, shape).astype(np.int32)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------


@pytest.mark.parametrize("c", [1024, 200, 50, 1])
def test_df1_plan_defaults(c, no_library):
    """DF1_PRODUCERS producer warps and the store warp beside the serial
    warp in 12 warps; two words a row and lane in and one out, so 256-row
    chunks in the 2 slots that fit (196672 bytes: one CTA an SM); one CTA a
    tile, 64 tiles at 2048 lanes; 128-row chunks hold 3 slots."""
    p = df1_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        12, DF1_PRODUCERS, 256, 2, 1)
    assert (p.win, p.wout) == (2, 1)
    assert p.tiles == -(-c // LANES)
    assert p.smem == pipe_smem(256, 2, 2, 1) == 196672 <= MAX_PIPE_SMEM
    assert 2 * p.smem > MAX_PIPE_SMEM
    assert df1_plan(2048).tiles == 64
    assert df1_plan(c, chunk=128).ring == 3
    assert df1_plan(c, chunk=64, ring=9).smem == 32 * 9 + 9 * 64 * 32 * 12
    one = df1_plan(c, producers=11, warps=16, chunk=1)
    assert (one.warps, one.producers, one.ring) == (16, 11, 3)


@pytest.mark.parametrize("kw,match", [
    (dict(producers=0), "producers"),
    (dict(warps=8, producers=6), "warps"),   # 7 roles in 6 places
    (dict(warps=20), "warps"),               # more than 16
    (dict(cluster=2), "one CTA"),
    (dict(chunk=0), "chunk"),
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=256, ring=3), "more than"),
    (dict(chunk=512), "no ring"),
])
def test_df1_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        df1_plan(1024, **kw)
    with pytest.raises(ValueError, match="lanes"):
        df1_plan(0)


def _calls(st, planes):
    """The five entry points as ``call(xs=, f=, **kw)``."""
    ba = _ba()
    clamp = dict(u=CLAMP[0], lo=CLAMP[1], hi=CLAMP[2])
    return {
        "K1": lambda **kw: biquad_cuda.df1_bank_q(ba, st, **kw),
        "K11": lambda **kw: biquad_cuda.df1_bank_q_dec(ba, st, d=4, **kw),
        "K18": lambda **kw: biquad_cuda.df1_clamp_bank_q(ba, st, **clamp,
                                                         **kw),
        "K26": lambda **kw: biquad_cuda.df1_bank_q_coef(planes, st, **kw),
        "K27": lambda **kw: biquad_cuda.df1_clamp_bank_q_coef(
            planes, st, **clamp, **kw),
    }


WRAPPERS = (biquad_cuda.df1_bank_q, biquad_cuda.df1_bank_q_dec,
            biquad_cuda.df1_clamp_bank_q, biquad_cuda.df1_bank_q_coef,
            biquad_cuda.df1_clamp_bank_q_coef)


@pytest.mark.parametrize("kernel", ["K1", "K11", "K18", "K26", "K27"])
def test_wrappers_refuse_before_the_library(kernel, no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched: f outside 1..63, a plan the kernel
    cannot run, no lanes."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    st = biquad.df1_init((64,), device=meta)
    xs = torch.zeros((8, 64), dtype=torch.int32, device=meta)
    planes = torch.zeros((5, 64), dtype=torch.int32, device=meta)
    call = _calls(st, planes)[kernel]
    n0 = [w.launches for w in WRAPPERS]
    for f in (0, 64):
        with pytest.raises(ValueError, match="f must be"):
            call(xs=xs, f=f)
    with pytest.raises(ValueError, match="more than"):
        call(xs=xs, f=29, _plan=df1_plan(64, chunk=256, ring=3))
    with pytest.raises(ValueError, match="warps"):
        call(xs=xs, f=29, _plan=df1_plan(64, warps=4, producers=3))
    with pytest.raises(ValueError, match="lanes|coefficients"):
        call(xs=xs[:, :0], f=29)
    assert [w.launches for w in WRAPPERS] == n0


def test_wrappers_refuse_their_own_arguments(no_library, monkeypatch):
    """K11's d must divide t, K1's and K11's out_dtype be int32 or f32,
    K26's planes be (5,) or (5, c): each raises before the library."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    st = biquad.df1_init((64,), device=meta)
    xs = torch.zeros((8, 64), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="dividing t"):
        biquad_cuda.df1_bank_q_dec(_ba(), st, xs, d=3)
    with pytest.raises(ValueError, match="dividing t"):
        biquad_cuda.df1_bank_q_dec(_ba(), st, xs, d=0)
    for fn in (biquad_cuda.df1_bank_q, biquad_cuda.df1_bank_q_dec):
        with pytest.raises(ValueError, match="out_dtype"):
            fn(_ba(), st, xs, out_dtype=torch.int64)
    planes = torch.zeros((5, 3), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="coefficients"):
        biquad_cuda.df1_bank_q_coef(planes, st, xs)


# ---- the serial warp's shift ----------------------------------------------


@pytest.mark.parametrize("f", range(1, 64))
def test_the_shift_equals_the_low_word_of_the_arithmetic_shift(f):
    """The plain step keeps the low word of int64(acc) >> f; the serial
    warp takes bits [f, f + 32) of acc (`__funnelshift_rc`, the high word
    at f = 32) for f <= 32 and int32(high word) >> (f - 32) for f > 32:
    the same word for every acc."""
    rng = np.random.default_rng(f)
    edges = [0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1]
    accs = [int(v) for v in rng.integers(0, 2**64, 2000, dtype=np.uint64)]
    for acc in edges + accs:
        signed = acc - 2**64 if acc >= 2**63 else acc
        want = (signed >> f) % 2**32
        lo, hi = acc % 2**32, acc >> 32
        if f <= 32:
            got = ((hi << 32 | lo) >> f) % 2**32  # the funnel shift
        else:
            hi_s = hi - 2**32 if hi >= 2**31 else hi
            got = (hi_s >> (f - 32)) % 2**32
        assert got == want


# ---- a model of the kernel's schedule ---------------------------------------


def _same(got, want):
    (gs, gy), (ws, wy) = got, want
    assert gy.dtype == wy.dtype
    assert gy.shape == wy.shape
    assert torch.equal(gy, wy)
    assert torch.equal(gs.x, ws.x)
    assert torch.equal(gs.y, ws.y)


DF1_CASES = [
    # (c, t, plan keywords)
    (16, 40, dict(chunk=64)),                              # t under a chunk
    (20, 48, dict(chunk=48, ring=2)),                      # t = one chunk
    (37, 3 * 20 + 10, dict(chunk=20, ring=2, producers=3)),  # spans 7, 7, 6
    (8, 5 * 24 + 6, dict(chunk=24, ring=3, producers=5)),   # span 5
    (40, 100, dict(chunk=16, ring=4)),                     # spans 4 / 0
    (36, 70, dict(chunk=32, ring=2, producers=1)),
    (12, 30, dict(chunk=1, ring=2)),                       # empty spans
    (5, 1, dict(chunk=8)),                                 # t = 1
    (3, 2, dict(chunk=1, producers=11, warps=16)),         # rows 0 and 1
]

KINDS = ["K1", "K1 f32", "K11", "K18", "K26", "K26 shared", "K27"]


def _model(kind, ba, f, st, xs, plan, seed, d=2):
    """`df1w_model` as ``kind`` runs it on one block."""
    dt = torch.float32 if kind == "K1 f32" else None
    clamp = CLAMP if kind in ("K18", "K27") else None
    return df1w_model(ba, f, st, xs, plan, clamp=clamp,
                      d=d if kind == "K11" else 1, out_dtype=dt, seed=seed)


def _plain(kind, ba, f, st, xs, d=2):
    """The plain version of ``kind`` on one block."""
    u, lo, hi = CLAMP
    if kind in ("K1", "K1 f32"):
        return df1_bank_q_plain(ba, st, xs, f, out_dtype=torch.float32
                                if kind == "K1 f32" else None)
    if kind == "K11":
        return df1_bank_q_dec_plain(ba, st, xs, f, d=d)
    if kind == "K18":
        return df1_clamp_bank_q_plain(ba, st, xs, f, u=u, lo=lo, hi=hi)
    planes = torch.from_numpy(np.asarray(ba))
    if kind.startswith("K26"):
        return df1_bank_q_coef_plain(planes, st, xs, f)
    return df1_clamp_bank_q_coef_plain(planes, st, xs, f, u=u, lo=lo, hi=hi)


def _coef_for(kind, rng, c, fc=0.1, f=29):
    """A lowpass set for ``kind``: (5,) or, for K26/K27, (5, c) planes."""
    if kind in ("K26", "K27"):
        return np.stack([_ba(v, f) for v in rng.uniform(0.01, 0.3, c)],
                        axis=1)
    return _ba(fc, f)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("c,t,kw", DF1_CASES)
def test_schedule_model_equals_plain(c, t, kw, kind):
    """Two carried blocks from a random state, the suite's Q29 lowpass
    (K26/K27: per-lane lowpass planes) on x in +-2^30, where CLAMP pins
    outputs; K11 keeps 1 row in 2 (1 in 1 at t = 1).  c = 20, 36, 37 and
    40 are not multiples of the 32-lane tile."""
    rng = np.random.default_rng(2100 + c + KINDS.index(kind))
    plan = df1_plan(c, **kw)
    ba = _coef_for(kind, rng, c)
    st = ps = _state(rng, c, 2**30)
    outs = []
    for blk in range(2):
        xs = torch.from_numpy(_i32(rng, (t, c), -(2**30), 2**30))
        d = 2 if t % 2 == 0 else 1
        got = _model(kind, ba, 29, st, xs, plan, blk, d)
        want = _plain(kind, ba, 29, ps, xs, d)
        _same(got, want)
        st, ps = got[0], want[0]
        outs.append(got[1])
    if kind in ("K18", "K27") and t > 2:
        y = torch.cat(outs)
        assert bool(((y == CLAMP[1]) | (y == CLAMP[2])).any())


@pytest.mark.parametrize("f", [1, 2, 16, 29, 31, 32, 33, 40, 62, 63])
@pytest.mark.parametrize("kind", ["K1", "K18", "K27"])
def test_schedule_model_at_every_shift(f, kind):
    """f from 1 to 63 (both shifts, their edges at 32 and 33),
    coefficients in +-2^(f + 1), full-range x and state, two carried
    blocks at 16-row chunks."""
    c, t = 37, 3 * 16 + 5
    rng = np.random.default_rng(60 + f)
    shape = (5, c) if kind == "K27" else (5,)
    ba = _coefs(rng, f, shape)
    plan = df1_plan(c, chunk=16, ring=3, producers=2)
    st = ps = _state(rng, c)
    for blk in range(2):
        xs = torch.from_numpy(_i32(rng, (t, c)))
        got = _model(kind, ba, f, st, xs, plan, blk)
        want = _plain(kind, ba, f, ps, xs)
        _same(got, want)
        st, ps = got[0], want[0]


@pytest.mark.parametrize("d,chunk", [(3, 16), (5, 7), (16, 24), (1, 8),
                                     (7, 64)])
def test_k11_keeps_the_blocks_rows_across_chunk_edges(d, chunk):
    """K11's kept rows follow the block's row index where the chunk is not
    a multiple of d (and where it is, and d = 1, and a chunk past t), f32
    and int32, over two carried blocks: the model == the plain version."""
    c, t = 33, 7 * d * 3
    rng = np.random.default_rng(1100 + d + chunk)
    plan = df1_plan(c, chunk=chunk, ring=3 if chunk <= 128 else 2,
                    producers=3)
    ba = _ba()
    st = ps = _state(rng, c, 2**28)
    for blk, dt in enumerate((None, torch.float32)):
        xs = torch.from_numpy(_i32(rng, (t, c), -(2**28), 2**28))
        got = df1w_model(ba, 29, st, xs, plan, d=d, out_dtype=dt, seed=blk)
        want = df1_bank_q_dec_plain(ba, ps, xs, 29, d=d, out_dtype=dt)
        _same(got, want)
        assert got[1].shape == (t // d, c)
        st, ps = got[0], want[0]


def test_schedule_model_where_the_sum_wraps():
    """Coefficients, x and state at int32's edges: rows whose five products
    pass 2^63 (checked with Python integers), f = 1, 32, 33 and 63,
    clamped and not, the f32 output too."""
    c, t = 33, 40
    rng = np.random.default_rng(21)
    ba = np.array([-(2**31)] * 5, np.int32)
    xs = rng.choice(I32_EDGES, (t, c))
    xs[0] = -(2**31)
    st = biquad.Df1State(x=torch.full((c, 2), -(2**31), dtype=torch.int32),
                         y=torch.full((c, 2), -(2**31), dtype=torch.int32))
    assert 5 * (2**31) ** 2 >= 2**63  # row 0 of every lane
    plan = df1_plan(c, chunk=8, ring=2, producers=3)
    wide = (2**31 - 9, -(2**31), 2**31 - 1)
    x = torch.from_numpy(xs)
    for f in (1, 32, 33, 63):
        _same(df1w_model(ba, f, st, x, plan), df1_bank_q_plain(ba, st, x, f))
        _same(df1w_model(ba, f, st, x, plan, out_dtype=torch.float32),
              df1_bank_q_plain(ba, st, x, f, out_dtype=torch.float32))
        _same(df1w_model(ba, f, st, x, plan, clamp=wide),
              df1_clamp_bank_q_plain(ba, st, x, f, u=wide[0], lo=wide[1],
                                     hi=wide[2]))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("c,t,kw", [DF1_CASES[i] for i in (0, 2, 6, 7)])
def test_coef_schedule_model_retuned_between_blocks(c, t, kw, shared):
    """K26 then K27: the producers' b0-b2 and the serial warp's a1, a2
    from (5, c) planes (a shared set broadcast), retuned between the two
    carried blocks, clamped in the second; a shared set equals K1 / K18."""
    rng = np.random.default_rng(260 + c + shared)
    plan = df1_plan(c, **kw)
    st = ps = _state(rng, c, 2**26)
    for blk, clamp in enumerate((None, CLAMP)):
        if shared:
            planes = _ba(0.05 + 0.1 * blk)
        else:
            planes = np.stack([_ba(fc) for fc in rng.uniform(0.01, 0.3, c)],
                              axis=1)
        xs = torch.from_numpy(_i32(rng, (t, c), -(2**26), 2**26))
        got = df1w_model(planes, 29, st, xs, plan, clamp=clamp, seed=blk)
        want = _plain("K26" if clamp is None else "K27", planes, 29, ps, xs)
        _same(got, want)
        if shared:
            _same(got, _plain("K1" if clamp is None else "K18", planes, 29,
                              ps, xs))
        st, ps = got[0], want[0]


# ---- the plain versions against the interpret-mode JAX kernels ---------------


def _jstate(st):
    return jbiquad.Df1State(x=jnp.asarray(st.x.numpy()),
                            y=jnp.asarray(st.y.numpy()))


def _jeq(st, ys, jst, jys):
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
    np.testing.assert_array_equal(st.y.numpy(), np.asarray(jst.y))


@pytest.mark.parametrize("kind", ["K1", "K1 f32", "K11", "K18", "K26",
                                  "K26 shared", "K27"])
def test_plain_equals_interpret_kernel(kind):
    """The plain version against the interpret-mode JAX kernel at c = 128,
    t = 128, 64-row time chunks (K11: d = 16), over two carried blocks
    from a random state: outputs and state bit for bit; K18 and K27 with
    the clamp engaged; and the schedule model at 32-row chunks beside
    them."""
    c, t = 128, 128
    rng = np.random.default_rng(2121 + KINDS.index(kind))
    ba = (_coef_for(kind, rng, c) if kind != "K26 shared" else _ba(0.2))
    st = _state(rng, c, 2**27)
    jst = _jstate(st)
    u, lo, hi = CLAMP
    plan = df1_plan(c, chunk=32)
    outs = []
    for blk in range(2):
        xs = _i32(rng, (t, c), -(2**27), 2**27)
        jx, x = jnp.asarray(xs), torch.from_numpy(xs)
        jba = jnp.asarray(ba)
        if kind in ("K1", "K1 f32"):
            jst, jys = jbp.df1_bank_q(
                ba, jst, jx, 29, time_chunk=64, interpret=True,
                out_dtype=jnp.float32 if kind == "K1 f32" else None)
        elif kind == "K11":
            jst, jys = jbp.df1_bank_q_dec(ba, jst, jx, 29, d=16,
                                          time_chunk=64, interpret=True)
        elif kind == "K18":
            jst, jys = jbp.df1_clamp_bank_q(ba, jst, jx, 29, u=u, lo=lo,
                                            hi=hi, time_chunk=64,
                                            interpret=True)
        elif kind.startswith("K26"):
            jst, jys = jbp.df1_bank_q_coef(jba, jst, jx, 29, time_chunk=64,
                                           interpret=True)
        else:
            jst, jys = jbp.df1_clamp_bank_q_coef(jba, jst, jx, 29, u=u,
                                                 lo=lo, hi=hi, time_chunk=64,
                                                 interpret=True)
        want = _plain(kind, ba, 29, st, x, d=16)
        model = _model(kind, ba, 29, st, x, plan, blk, d=16)
        _jeq(*want, jst, jys)
        _same(model, want)
        st = want[0]
        outs.append(want[1])
    if kind in ("K18", "K27"):
        y = torch.cat(outs)
        assert bool(((y == lo) | (y == hi)).any())
