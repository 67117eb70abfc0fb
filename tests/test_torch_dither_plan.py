"""K31 `df1_dither_bank`'s and K33 `df1_dither_bank_coef`'s launch plan
(`filters/biquad_cuda.py` `dither_plan`) and a CPU model of their schedule
(``csrc/biquad_precision.cu`` on ``csrc/df1_ring.cuh``'s depth-0
pipeline), held against the plain versions and the interpret-mode JAX
kernels.

The kernel runs a CUDA block of one 32-lane tile: producer warps, each a
span of every chunk, that write each row's feed-forward sum W = b0 x0 +
b1 x1 + b2 x2 mod 2^64 (two 32-bit words) into the serial warp's input
ring; the serial warp, which holds y1, y2 and the error word e, adds a2
y2 (off its chain), a1 y1 and e, takes y0 as bits [f, f + 32) of the sum
and the next e as its low f bits, and clamps; a store warp that writes
the int32 rows.  These tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory at
  1024, 200, 50 and 1 lanes (2 words a row and lane in, 1 out: 256-row
  chunks in 2 slots), and the plans and calls it refuses before the
  library is asked for;
* the serial warp's split of the shifted sum: the high word of acc << (32
  - f) is bits [f, f + 32) of acc (one funnel shift), and (u32)(acc << (32
  - f)) >> (32 - f) is acc's low f bits, for every f in 1..32;
* a model of the schedule (tests/torch_pipe_model.py `dither_model`: the
  producers by spans, the serial warp, the store warp, the slots and
  parities chunk by chunk, the roles interleaved at random, numpy uint64
  words) equals `df1_dither_bank_plain` / `df1_dither_bank_coef_plain` bit
  for bit over carried blocks: at chunk edges, t = 1 and t under a chunk,
  f from 1 to 32, sums that wrap mod 2^64, the clamp engaged, per-lane and
  shared coefficient planes;
* at c = 128 the model equals the interpret-mode JAX kernels
  `biquad_pallas.df1_dither_bank` and `df1_dither_bank_coef` bit for bit.
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
    DITHER_PRODUCERS,
    df1_dither_bank_coef_plain,
    df1_dither_bank_plain,
    dither_plan,
)
from idsp_tpu_torch.filters.pipe_plan import LANES, MAX_PIPE_SMEM, pipe_smem
from torch_pipe_model import dither_model

CLAMP = (1 << 10, -(1 << 23), 1 << 23)
I32_EDGES = np.array([-(2**31), -(2**31) + 1, -(2**30), -1, 0, 1, 2**30,
                      2**31 - 1], np.int32)


def _ba(fc=0.1, f=29):
    """The suite's Q<f> lowpass at ``fc`` (int32 words)."""
    ba5 = jbiquad.from_cookbook(JFilter().critical_frequency(fc).lowpass())
    return jbiquad.quantize_ba(ba5, f)


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _state(rng, c, lim=2**31):
    return biquad.Df1DitherState(
        xy=biquad.Df1State(x=torch.from_numpy(_i32(rng, (c, 2), -lim, lim)),
                           y=torch.from_numpy(_i32(rng, (c, 2), -lim, lim))),
        e=torch.from_numpy(rng.integers(0, 2**32, c)))


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------


@pytest.mark.parametrize("c", [1024, 200, 50, 1])
def test_dither_plan_defaults(c, no_library):
    """DITHER_PRODUCERS producer warps and the store warp beside the serial
    warp in 12 warps; two words a row and lane in and one out, so 256-row
    chunks in the 2 slots that fit (196672 bytes); one CTA a tile; 128-row
    chunks hold 3 slots."""
    p = dither_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        12, DITHER_PRODUCERS, 256, 2, 1)
    assert (p.win, p.wout) == (2, 1)
    assert p.tiles == -(-c // LANES)
    assert p.smem == pipe_smem(256, 2, 2, 1) == 196672 <= MAX_PIPE_SMEM
    assert dither_plan(c, chunk=128).ring == 3
    assert dither_plan(c, chunk=64, ring=9).smem == 32 * 9 + 9 * 64 * 32 * 12
    one = dither_plan(c, producers=11, warps=16, chunk=1)
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
def test_dither_plan_refuses_what_the_kernel_cannot_run(kw, match,
                                                       no_library):
    with pytest.raises(ValueError, match=match):
        dither_plan(1024, **kw)
    with pytest.raises(ValueError, match="lanes"):
        dither_plan(0)


def test_wrappers_refuse_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched, for K31 and K33."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    st = biquad.df1_dither_init((64,), device=meta)
    xs = torch.zeros((8, 64), dtype=torch.int32, device=meta)
    planes = torch.zeros((5, 64), dtype=torch.int32, device=meta)
    n0 = (biquad_cuda.df1_dither_bank.launches,
          biquad_cuda.df1_dither_bank_coef.launches)
    for call in (
            lambda **kw: biquad_cuda.df1_dither_bank(_ba(), st, **kw),
            lambda **kw: biquad_cuda.df1_dither_bank_coef(planes, st, **kw)):
        with pytest.raises(ValueError, match="f must be"):
            call(xs=xs, f=33)
        with pytest.raises(ValueError, match="f must be"):
            call(xs=xs, f=0)
        with pytest.raises(ValueError, match="more than"):
            call(xs=xs, f=29, _plan=dither_plan(64, chunk=256, ring=3))
        with pytest.raises(ValueError, match="warps"):
            call(xs=xs, f=29, _plan=dither_plan(64, warps=4, producers=3))
    with pytest.raises(ValueError, match="lanes"):
        biquad_cuda.df1_dither_bank(_ba(), st, xs[:, :0])
    with pytest.raises(ValueError, match="coefficients"):
        biquad_cuda.df1_dither_bank_coef(planes[:, :3], st, xs)
    assert (biquad_cuda.df1_dither_bank.launches,
            biquad_cuda.df1_dither_bank_coef.launches) == n0


# ---- the serial warp's split of the shifted sum -------------------------------


@pytest.mark.parametrize("f", range(1, 33))
def test_funnel_shift_and_low_bits_equal_the_shifted_sum(f):
    """The plain step shifts acc left by 32 - f (mod 2^64) and takes the
    high word as y0 and the low word >> (32 - f) as e; the serial warp
    takes bits [f, f + 32) of acc (`__funnelshift_rc`, the high word at
    f = 32) and acc & (2^f - 1): the same words for every acc."""
    rng = np.random.default_rng(f)
    edges = [0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1]
    accs = [int(v) for v in rng.integers(0, 2**64, 2000, dtype=np.uint64)]
    for acc in edges + accs:
        shifted = (acc << (32 - f)) % 2**64
        y_plain, e_plain = shifted >> 32, (shifted % 2**32) >> (32 - f)
        lo, hi = acc % 2**32, acc >> 32
        y_kernel = ((hi << 32 | lo) >> min(f, 32)) % 2**32  # funnel shift
        e_kernel = lo & ((1 << f) - 1)  # the host's mask
        assert (y_kernel, e_kernel) == (y_plain, e_plain)


# ---- a model of the kernel's schedule ---------------------------------------


def _same(got, want):
    (gs, gy), (ws, wy) = got, want
    assert gy.dtype == wy.dtype == torch.int32
    assert torch.equal(gy, wy)
    assert torch.equal(gs.xy.x, ws.xy.x)
    assert torch.equal(gs.xy.y, ws.xy.y)
    assert gs.e.dtype == ws.e.dtype == torch.int64
    assert torch.equal(gs.e, ws.e)


DITHER_CASES = [
    # (c, t, plan keywords)
    (16, 40, dict(chunk=64)),                              # t under a chunk
    (20, 48, dict(chunk=48, ring=2)),                      # t = one chunk
    (37, 3 * 20 + 9, dict(chunk=20, ring=2, producers=3)),  # spans 7, 7, 6
    (8, 5 * 24 + 7, dict(chunk=24, ring=3, producers=5)),   # span 5
    (40, 100, dict(chunk=16, ring=4)),                     # spans 4 / 0
    (36, 70, dict(chunk=32, ring=2, producers=1)),
    (12, 30, dict(chunk=1, ring=2)),                       # empty spans
    (5, 1, dict(chunk=8)),                                 # t = 1
    (3, 2, dict(chunk=1, producers=11, warps=16)),         # rows 0 and 1
]


@pytest.mark.parametrize("kind", ["lowpass", "clamped", "full"])
@pytest.mark.parametrize("c,t,kw", DITHER_CASES)
def test_k31_schedule_model_equals_plain(c, t, kw, kind):
    """Two carried blocks from a random state: the suite's Q29 lowpass on
    x in +-2^24 (unclamped, and clamped with CLAMP on x in +-2^30, where
    the clamp pins outputs); full-range coefficients, x and state at f =
    31, where the sums wrap.  c = 20, 36, 37 and 40 are not multiples of
    the 32-lane tile."""
    rng = np.random.default_rng(700 + c + len(kind))
    plan = dither_plan(c, **kw)
    clamp = CLAMP if kind == "clamped" else None
    if kind == "full":
        ba, f, lim, st = _i32(rng, (5,)), 31, 2**31, _state(rng, c)
    else:
        ba, f = _ba(), 29
        lim = 2**30 if kind == "clamped" else 2**24
        st = _state(rng, c, lim)
    ps, outs = st, []
    for blk in range(2):
        xs = torch.from_numpy(_i32(rng, (t, c), -lim, lim))
        got = dither_model(ba, f, st, xs, plan, clamp=clamp, seed=blk)
        want = df1_dither_bank_plain(ba, ps, xs, f, clamp=clamp)
        _same(got, want)
        st, ps = got[0], want[0]
        outs.append(got[1])
    if kind == "clamped" and t > 2:
        y = torch.cat(outs)
        assert bool(((y == CLAMP[1]) | (y == CLAMP[2])).any())


@pytest.mark.parametrize("f", [1, 2, 8, 16, 24, 30, 32])
def test_k31_schedule_model_at_every_shift(f):
    """f from 1 to 32 (the two ends of the funnel shift and of e's mask),
    coefficients in +-2^(f + 1) (as the card tests draw them), full-range
    x and state, clamped and not, two carried blocks."""
    c, t = 37, 3 * 16 + 5
    rng = np.random.default_rng(80 + f)
    top = min(2**31 - 1, 2 << f)
    ba = rng.integers(-top, top + 1, 5).astype(np.int32)
    plan = dither_plan(c, chunk=16, ring=3, producers=2)
    for clamp in (None, CLAMP):
        st = ps = _state(rng, c)
        for blk in range(2):
            xs = torch.from_numpy(_i32(rng, (t, c)))
            got = dither_model(ba, f, st, xs, plan, clamp=clamp, seed=blk)
            want = df1_dither_bank_plain(ba, ps, xs, f, clamp=clamp)
            _same(got, want)
            st, ps = got[0], want[0]


def test_k31_schedule_model_where_the_sum_wraps():
    """Coefficients, x and state at int32's edges: rows whose five products
    and e pass 2^63 (checked with Python integers), f = 32 and 1."""
    c, t = 33, 40
    rng = np.random.default_rng(31)
    ba = np.array([-(2**31)] * 5, np.int32)
    xs = rng.choice(I32_EDGES, (t, c))
    xs[0] = -(2**31)
    st = biquad.Df1DitherState(
        xy=biquad.Df1State(x=torch.full((c, 2), -(2**31), dtype=torch.int32),
                           y=torch.full((c, 2), -(2**31), dtype=torch.int32)),
        e=torch.full((c,), 2**32 - 1, dtype=torch.int64))
    exact = 5 * (2**31) ** 2 + 2**32 - 1  # row 0 of every lane
    assert exact >= 2**63
    plan = dither_plan(c, chunk=8, ring=2, producers=3)
    for f in (32, 1):
        for clamp in (None, (2**31 - 9, -(2**31), 2**31 - 1)):
            got = dither_model(ba, f, st, torch.from_numpy(xs), plan,
                               clamp=clamp)
            want = df1_dither_bank_plain(ba, st, torch.from_numpy(xs), f,
                                         clamp=clamp)
            _same(got, want)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("c,t,kw", [DITHER_CASES[i] for i in (0, 2, 6, 7)])
def test_k33_schedule_model_equals_plain(c, t, kw, shared):
    """K33: the producers' b0-b2 and the serial warp's a1, a2 from (5, c)
    planes (a shared set broadcast), retuned between the two carried
    blocks, clamped in the second."""
    rng = np.random.default_rng(330 + c + shared)
    plan = dither_plan(c, **kw)
    st = ps = _state(rng, c, 2**24)
    for blk, clamp in enumerate((None, CLAMP)):
        if shared:
            planes = _ba(0.05 + 0.1 * blk)
        else:
            planes = np.stack([_ba(fc) for fc in rng.uniform(0.01, 0.3, c)],
                              axis=1)
        xs = torch.from_numpy(_i32(rng, (t, c), -(2**24), 2**24))
        got = dither_model(planes, 29, st, xs, plan, clamp=clamp, seed=blk)
        want = df1_dither_bank_coef_plain(torch.from_numpy(planes), ps, xs,
                                          29, clamp=clamp)
        _same(got, want)
        if shared:
            _same(got, df1_dither_bank_plain(planes, ps, xs, 29,
                                             clamp=clamp))
        st, ps = got[0], want[0]


# ---- against the interpret-mode JAX kernels ---------------------------------


def _jstate(st):
    return jbiquad.Df1DitherState(
        xy=jbiquad.Df1State(x=jnp.asarray(st.xy.x.numpy()),
                            y=jnp.asarray(st.xy.y.numpy())),
        e=jnp.asarray(st.e.numpy().astype(np.uint32)))


@pytest.mark.parametrize("coef", ["k31", "k33"])
@pytest.mark.parametrize("clamp", [None, (99, -(2**26), 2**26)])
def test_schedule_model_equals_interpret_kernel(coef, clamp):
    """The roles at 64-row chunks against the interpret-mode JAX kernel
    (K31: the suite's Q29 lowpass; K33: per-lane lowpass planes) over two
    carried blocks from a random state: outputs and state bit for bit."""
    c, t = 128, 192
    rng = np.random.default_rng(31 if coef == "k31" else 33)
    ba = (_ba() if coef == "k31" else
          np.stack([_ba(fc) for fc in rng.uniform(0.01, 0.3, c)], axis=1))
    plan = dither_plan(c, chunk=64)
    st = _state(rng, c, 2**27)
    jst = _jstate(st)
    jfn = jbp.df1_dither_bank if coef == "k31" else jbp.df1_dither_bank_coef
    for blk in range(2):
        xs = _i32(rng, (t, c), -(2**27), 2**27)
        jst, jys = jfn(jnp.asarray(ba), jst, jnp.asarray(xs), 29,
                       clamp=clamp, time_chunk=64, interpret=True)
        st, ys = dither_model(ba, 29, st, torch.from_numpy(xs), plan,
                              clamp=clamp, seed=blk)
        np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(st.xy.x.numpy(), np.asarray(jst.xy.x))
    np.testing.assert_array_equal(st.xy.y.numpy(), np.asarray(jst.xy.y))
    np.testing.assert_array_equal(st.e.numpy(),
                                  np.asarray(jst.e).astype(np.int64))
