"""K25 `df1_wide_bank`'s and K32 `df1_wide_bank_coef`'s launch plan
(`filters/biquad_cuda.py` `wide_plan`) and a CPU model of their schedule
(``csrc/biquad_bank.cu`` on ``csrc/df1_ring.cuh``'s depth-0 pipeline),
held against the plain versions and the interpret-mode JAX kernels.

The kernel runs a CUDA block of one 32-lane tile: producer warps, each a
span of every chunk, write each row's feed-forward sum W = b0 x0 + b1 x1
+ b2 x2 mod 2^64 (two 32-bit words) into the serial warp's input ring;
the serial warp holds y1 and y2 as int64 feedback words, adds
split_mul(y2, a2) (off its chain) and split_mul(y1, a1), shifts the sum
left by 32 - f (two funnel shifts), takes the high word as y0 and, clamped,
replaces it with clip(y0 + u, lo, hi); a store warp writes the rows.  These
tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory at
  1024, 200, 50 and 1 lanes (K1's shape: 256-row chunks in 2 slots), and
  the plans and calls it refuses before the library is asked for;
* the serial warp's split product: umulhi(y_lo, A) less y_lo where a < 0,
  sign-extended, plus y_hi a, equals ((y_lo as u64 * a) >> 32) + y_hi a
  for every a and y, edges too; its two funnel shifts equal the int64
  shift left by 32 - f for f in 1..32;
* a model of the schedule (tests/torch_pipe_model.py `wide_model`: the
  producers by spans, the serial warp's words, the store warp, the slots
  and parities chunk by chunk, the roles interleaved at random, numpy
  uint64 words) equals the plain versions bit for bit over carried
  blocks: at chunk edges, t = 1 and t under a chunk, f from 1 to 32, sums
  that wrap mod 2^64, y words near +-2^63, the clamp engaged and with lo >
  hi, per-lane and shared coefficient planes;
* at c = 128 the plain versions equal the interpret-mode JAX kernels
  `biquad_pallas.df1_wide_bank` and `df1_wide_bank_coef` bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import biquad_pallas as jbp

from idsp_tpu_torch import _ext
from idsp_tpu_torch.design import Filter
from idsp_tpu_torch.filters import biquad, biquad_cuda
from idsp_tpu_torch.filters.biquad_cuda import (
    DF1_PRODUCERS,
    df1_wide_bank_coef_plain,
    df1_wide_bank_plain,
    wide_plan,
)
from idsp_tpu_torch.filters.pipe_plan import LANES, MAX_PIPE_SMEM, pipe_smem
from torch_pipe_model import wide_model, wide_split_mul

CLAMP = (1 << 10, -(1 << 23), 1 << 23)
LO_OVER_HI = (5, 1 << 20, -(1 << 20))  # jnp.clip gives hi


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _i64(rng, shape):
    return rng.integers(-(2**63), 2**63 - 1, size=shape, dtype=np.int64)


def _state(rng, c, lim=2**31):
    return biquad.Df1WideState(
        x=torch.from_numpy(_i32(rng, (c, 2), -lim, lim)),
        y=torch.from_numpy(_i64(rng, (c, 2))))


def _ba(fc=0.1, f=29):
    """The suite's Q<f> lowpass at ``fc`` (int32 words)."""
    return biquad.quantize_ba(biquad.from_cookbook(
        Filter().critical_frequency(fc).lowpass()), f)


def _coefs(rng, f, shape=(5,)):
    """Coefficients in +-2^(f + 1) (full range from f = 30 on)."""
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
def test_wide_plan_defaults(c, no_library):
    """DF1_PRODUCERS producer warps and the store warp beside the serial
    warp in 12 warps; two words a row and lane in and one out, so 256-row
    chunks in the 2 slots that fit (196672 bytes: one CTA an SM); one CTA a
    tile."""
    p = wide_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        12, DF1_PRODUCERS, 256, 2, 1)
    assert (p.win, p.wout) == (2, 1)
    assert p.tiles == -(-c // LANES)
    assert p.smem == pipe_smem(256, 2, 2, 1) == 196672 <= MAX_PIPE_SMEM
    assert p == biquad_cuda.df1_plan(c)
    assert wide_plan(c, chunk=128).ring == 3
    one = wide_plan(c, producers=11, warps=16, chunk=1)
    assert (one.warps, one.producers, one.ring) == (16, 11, 3)


@pytest.mark.parametrize("kw,match", [
    (dict(producers=0), "producers"),
    (dict(warps=8, producers=6), "warps"),
    (dict(warps=20), "warps"),
    (dict(cluster=2), "one CTA"),
    (dict(chunk=0), "chunk"),
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=256, ring=3), "more than"),
    (dict(chunk=512), "no ring"),
])
def test_wide_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        wide_plan(1024, **kw)
    with pytest.raises(ValueError, match="lanes"):
        wide_plan(0)


@pytest.mark.parametrize("kernel", ["K25", "K25 clamped", "K32",
                                    "K32 shared"])
def test_wide_wrappers_refuse_before_the_library(kernel, no_library,
                                                 monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched: f outside 1..32, a plan the kernel
    cannot run, planes of another shape, no lanes."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    st = biquad.df1_wide_init((64,), device=meta)
    xs = torch.zeros((8, 64), dtype=torch.int32, device=meta)
    clamp = CLAMP if kernel == "K25 clamped" else None
    if kernel.startswith("K25"):
        def call(x, f, **kw):
            return biquad_cuda.df1_wide_bank(_ba(), st, x, f, clamp=clamp,
                                             **kw)
    else:
        planes = torch.zeros((5,) if kernel == "K32 shared" else (5, 64),
                             dtype=torch.int32, device=meta)

        def call(x, f, **kw):
            return biquad_cuda.df1_wide_bank_coef(planes, st, x, f, **kw)
    wrappers = (biquad_cuda.df1_wide_bank, biquad_cuda.df1_wide_bank_coef)
    n0 = [w.launches for w in wrappers]
    for f in (0, 33):
        with pytest.raises(ValueError, match="f must be"):
            call(xs, f)
    with pytest.raises(ValueError, match="more than"):
        call(xs, 29, _plan=wide_plan(64, chunk=256, ring=3))
    with pytest.raises(ValueError, match="warps"):
        call(xs, 29, _plan=wide_plan(64, warps=4, producers=3))
    with pytest.raises(ValueError, match="lanes|coefficients"):
        call(xs[:, :0], 29)
    if kernel.startswith("K32"):
        bad = torch.zeros((5, 3), dtype=torch.int32, device=meta)
        with pytest.raises(ValueError, match="coefficients"):
            biquad_cuda.df1_wide_bank_coef(bad, st, xs, 29)
    assert [w.launches for w in wrappers] == n0


# ---- the serial warp's arithmetic -------------------------------------------


def _split_mul_plain(y, a):
    """((y_lo as u64 * a) >> 32) + y_hi * a with Python integers."""
    lo, hi = y % 2**32, y >> 32
    return ((lo * a) >> 32) + hi * a


def test_the_split_product_equals_the_plain_one():
    """umulhi(y_lo, A) - y_lo [a < 0] as 32 bits, sign-extended, plus y_hi
    a onto the addend, mod 2^64, equals the plain split product plus the
    addend for coefficients and words at their edges and at random."""
    rng = np.random.default_rng(25)
    a_edges = [-(2**31), -(2**31) + 1, -(2**30), -1, 0, 1, 2**30,
               2**31 - 1]
    y_edges = [-(2**63), -(2**63) + 1, -(2**32), -(2**31), -1, 0, 1,
               2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1]
    a = np.array(a_edges + list(_i32(rng, 3000)), np.int64)
    y = np.array(y_edges + list(_i64(rng, len(a) - len(y_edges))), np.int64)
    ys = np.concatenate([np.repeat(y_edges, len(a_edges)), y])
    as_ = np.concatenate([np.tile(a_edges, len(y_edges)), a])
    add = _i64(rng, len(ys))
    with np.errstate(over="ignore"):
        got = wide_split_mul(ys.view(np.uint64), as_.view(np.uint64),
                             add.view(np.uint64)).view(np.int64)
    for g, yv, av, ad in zip(got, ys, as_, add):
        want = (int(ad) + _split_mul_plain(int(yv), int(av))) % 2**64
        assert int(g) % 2**64 == want


@pytest.mark.parametrize("f", range(1, 33))
def test_the_funnel_shifts_equal_the_shift_left(f):
    """The new high word bits [32 - s, 64 - s) of acc (`__funnelshift_l`)
    and the new low word (acc's low word) << s, s = 32 - f, equal the high
    and low words of acc << s mod 2^64."""
    rng = np.random.default_rng(f)
    s = 32 - f
    edges = [0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1]
    accs = [int(v) for v in rng.integers(0, 2**64, 2000, dtype=np.uint64)]
    for acc in edges + accs:
        lo, hi = acc % 2**32, acc >> 32
        new_hi = ((hi << 32 | lo) << s >> 32) % 2**32  # the funnel shift
        new_lo = (lo << s) % 2**32
        want = (acc << s) % 2**64
        assert new_hi << 32 | new_lo == want


# ---- a model of the kernel's schedule ---------------------------------------


def _same(got, want):
    (gs, gy), (ws, wy) = got, want
    assert gy.dtype == wy.dtype and gy.shape == wy.shape
    assert torch.equal(gy, wy)
    assert torch.equal(gs.x, ws.x)
    assert torch.equal(gs.y, ws.y)


WIDE_CASES = [
    # (c, t, plan keywords)
    (16, 40, dict(chunk=64)),                              # t under a chunk
    (20, 48, dict(chunk=48, ring=2)),                      # t = one chunk
    (37, 3 * 20 + 10, dict(chunk=20, ring=2, producers=3)),
    (8, 5 * 24 + 6, dict(chunk=24, ring=3, producers=5)),
    (40, 100, dict(chunk=16, ring=4)),
    (12, 30, dict(chunk=1, ring=2)),                       # empty spans
    (5, 1, dict(chunk=8)),                                 # t = 1
    (3, 2, dict(chunk=1, producers=11, warps=16)),         # rows 0 and 1
]
KINDS = ["K25", "K25 clamped", "K25 lo > hi", "K32", "K32 shared",
         "K32 clamped"]


def _run(kind, ba, f, st, xs, plan=None, seed=0):
    """``kind``'s model (with a plan) or plain version (without)."""
    clamp = (CLAMP if kind.endswith("clamped") else
             LO_OVER_HI if kind.endswith("hi") else None)
    if plan is not None:
        return wide_model(ba, f, st, xs, plan, clamp=clamp, seed=seed)
    if kind.startswith("K32"):
        return df1_wide_bank_coef_plain(ba, st, xs, f, clamp=clamp)
    return df1_wide_bank_plain(ba, st, xs, f, clamp=clamp)


def _coef_for(kind, rng, c, f=29):
    if kind in ("K32", "K32 clamped"):
        return np.stack([_ba(fc, f) for fc in rng.uniform(0.01, 0.3, c)],
                        axis=1)
    return _ba(0.1, f)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("c,t,kw", WIDE_CASES)
def test_schedule_model_equals_plain(c, t, kw, kind):
    """Two carried blocks from a random state (x in +-2^30, y full-range
    int64 words), the suite's Q29 lowpass (K32: per-lane planes or the
    shared set); c = 20, 37 and 40 are not multiples of the 32-lane tile;
    CLAMP pins outputs, LO_OVER_HI pins every one at its hi."""
    rng = np.random.default_rng(2500 + c + KINDS.index(kind))
    plan = wide_plan(c, **kw)
    ba = _coef_for(kind, rng, c)
    st = ps = _state(rng, c, 2**30)
    outs = []
    for blk in range(2):
        xs = torch.from_numpy(_i32(rng, (t, c), -(2**30), 2**30))
        got = _run(kind, ba, 29, st, xs, plan, seed=blk)
        want = _run(kind, ba, 29, ps, xs)
        _same(got, want)
        st, ps = got[0], want[0]
        outs.append(got[1])
    y = torch.cat(outs)
    if kind.endswith("clamped") and t > 2:
        assert bool(((y == CLAMP[1]) | (y == CLAMP[2])).any())
    if kind.endswith("hi"):
        assert bool((y == LO_OVER_HI[2]).all())


@pytest.mark.parametrize("f", [1, 2, 15, 16, 29, 31, 32])
@pytest.mark.parametrize("kind", ["K25", "K25 clamped", "K32 clamped"])
def test_schedule_model_at_every_shift(f, kind):
    """f from 1 to 32 (32: no shift; 1: 31 bits), coefficients in
    +-2^(f + 1), full-range x and state, two carried blocks at 16-row
    chunks."""
    c, t = 37, 3 * 16 + 5
    rng = np.random.default_rng(80 + f)
    shape = (5, c) if kind.startswith("K32") else (5,)
    ba = _coefs(rng, f, shape)
    plan = wide_plan(c, chunk=16, ring=3, producers=2)
    st = ps = _state(rng, c)
    for blk in range(2):
        xs = torch.from_numpy(_i32(rng, (t, c)))
        got = _run(kind, ba, f, st, xs, plan, seed=blk)
        want = _run(kind, ba, f, ps, xs)
        _same(got, want)
        st, ps = got[0], want[0]


def test_schedule_model_where_the_sum_wraps():
    """Coefficients and x at -2^31, y words at int64's edges: sums that
    wrap mod 2^64, low words >= 2^31 with negative coefficients, at f = 1,
    16 and 32, clamped and not, per-lane and shared."""
    c, t = 33, 40
    rng = np.random.default_rng(26)
    ba = np.full((5,), -(2**31), np.int32)
    xs = rng.choice(np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 1],
                             np.int32), (t, c))
    xs[0] = -(2**31)
    ends = np.array([-(2**63), -(2**63) + 1, -(2**32) + 5, -1, 0,
                     2**31 + 7, 2**63 - 1], np.int64)
    st = biquad.Df1WideState(
        x=torch.full((c, 2), -(2**31), dtype=torch.int32),
        y=torch.from_numpy(rng.choice(ends, (c, 2))))
    plan = wide_plan(c, chunk=8, ring=2, producers=3)
    x = torch.from_numpy(xs)
    wide = (2**31 - 9, -(2**31), 2**31 - 1)
    planes = np.tile(ba[:, None], (1, c))
    for f in (1, 16, 32):
        for clamp in (None, wide):
            _same(wide_model(ba, f, st, x, plan, clamp=clamp, seed=f),
                  df1_wide_bank_plain(ba, st, x, f, clamp=clamp))
            _same(wide_model(planes, f, st, x, plan, clamp=clamp),
                  df1_wide_bank_coef_plain(planes, st, x, f, clamp=clamp))


# ---- the plain versions against the interpret-mode JAX kernels ---------------


@pytest.mark.parametrize("kind", KINDS)
def test_plain_equals_interpret_kernel(kind):
    """The plain version against the interpret-mode JAX kernel at c = 128,
    t = 128, 64-row time chunks, over two carried blocks from a random
    state (full-range x and int64 y): outputs and state bit for bit; the
    clamp engaged; and the schedule model at 32-row chunks beside them."""
    c, t = 128, 128
    rng = np.random.default_rng(2525 + KINDS.index(kind))
    ba = _coef_for(kind, rng, c)
    st = _state(rng, c)
    jst = jbiquad.Df1WideState(x=jnp.asarray(st.x.numpy()),
                               y=jnp.asarray(st.y.numpy()))
    clamp = (CLAMP if kind.endswith("clamped") else
             LO_OVER_HI if kind.endswith("hi") else None)
    plan = wide_plan(c, chunk=32)
    for blk in range(2):
        xs = _i32(rng, (t, c))
        if kind.startswith("K32"):
            jst, jys = jbp.df1_wide_bank_coef(
                jnp.asarray(ba), jst, jnp.asarray(xs), 29, clamp=clamp,
                time_chunk=64, interpret=True)
        else:
            jst, jys = jbp.df1_wide_bank(ba, jst, jnp.asarray(xs), 29,
                                         clamp=clamp, time_chunk=64,
                                         interpret=True)
        want = _run(kind, ba, 29, st, torch.from_numpy(xs))
        np.testing.assert_array_equal(want[1].numpy(), np.asarray(jys))
        np.testing.assert_array_equal(want[0].x.numpy(), np.asarray(jst.x))
        np.testing.assert_array_equal(want[0].y.numpy(), np.asarray(jst.y))
        _same(_run(kind, ba, 29, st, torch.from_numpy(xs), plan, seed=blk),
              want)
        st = want[0]
