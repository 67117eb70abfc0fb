"""K4 `lowpass_bank` and K6 `fastlo_ddc_bank_block_lp`: their launch plans
(`filters/lowpass_cuda.py` `lowpass_plan`, `filters/ddc_bank_cuda.py`
`bank_plan`) and CPU models of their schedules (``csrc/lowpass_bank.cu``
and ``csrc/ddc_bank.cu`` on ``csrc/df1_ring.cuh``'s depth-0 pipeline, the
serial warp ``csrc/lowpass.cuh`` `LpSerial`), held against the plain
versions and the interpret-mode JAX kernel.

K4's CUDA block is a tile of 32 lanes: producer warps copy x by spans
into the serial warp's input ring, the serial warp runs the Lowpass<N>
with its sums regrouped mod 2^64 -- e = x -sat (p0 >> 32), E = e k0, D =
(p1 >> 32) k1, y = (p0 + p1 + D + E) >> 32, p0 = (p0 + 2 p1 + 2 D) + 2 E,
p1 = (p1 + 2 D) + 2 E -- and the store warp keeps the block's rows r with
r % dec == 0.  K6's block is K12/K13's tile of 16 channels' I and Q lanes
(mix warps, the same serial warp on the paired state rows, a back end
that writes the kept rows, atan2 of two kept rows at once and the PLL's
steps with their outputs).  These tests show:

* the plans' warps, roles, chunk, ring depth, tiles and shared memory at
  2048, 200, 50 and 1 lanes (K4) or channels (K6), and the plans and
  calls they refuse before the library is asked for;
* the regrouped step equals the plain step at int64's and int32's edges
  (the subtract saturating both ways, the sums wrapping, e k0 = 2^62);
* the models (tests/torch_pipe_model.py `lowpass_model`, `bank_model`
  with ``lp_gains``; roles interleaved at random over the mbarrier
  parities) equal `lowpass_bank_plain` and
  `fastlo_ddc_bank_block_lp_plain` bit for bit over carried blocks at
  N = 1 and 2: dec 1, 3 and 16 with chunks that are not multiples of dec,
  t = 0, 1, under a chunk and not a multiple of it, 2-11 producers; d = 1,
  chunks under d, c not a multiple of 16, one channel, time chunks of 8
  to 512 against pipeline chunks of 8 to 256; states at int64's edges and
  gains at int32's;
* K6's plain version tracks the interpret-mode JAX kernel at c = 128
  within the fast-LO gates of tests/test_torch_ddc_bank_biquad.py, its PLL
  output too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import lowpass as jlowpass
from idsp_tpu.filters import pll as jpll
from idsp_tpu.filters.ddc_pallas import (
    fastlo_ddc_bank_block_lp as j_fastlo_ddc_bank_block_lp,
)

from idsp_tpu_torch import _ext
from idsp_tpu_torch.filters import ddc_bank_cuda, lowpass, lowpass_cuda, pll
from idsp_tpu_torch.filters.ddc_bank_cuda import (
    BANK_PRODUCERS,
    bank_plan,
    fastlo_ddc_bank_block_lp_plain,
)
from idsp_tpu_torch.filters.lowpass_cuda import (
    LP_PRODUCERS,
    lowpass_bank_plain,
    lowpass_plan,
)
from idsp_tpu_torch.filters.pipe_plan import (
    MAX_PIPE_SMEM,
    PIPE_CHUNK,
    PIPE_RING,
    pipe_smem,
)
from idsp_tpu_torch.filters.pll_cuda import pll_bank_plain
from idsp_tpu_torch.ops.fastlo import fastlo_mix_tables, fastlo_tables
from torch_pipe_model import PAIR, bank_model, lowpass_model, lp_rows

PLL_BA = tuple(int(v) for v in jpll.coefficients_from_bandwidth(2e-2, 4.0))
# the #5 bank's gains and gains at int32's ends (e k0 reaches 2^62)
BANK_GAINS = {1: lowpass.gains1(0.01), 2: lowpass.gains2(0.004)}
EDGE_GAINS = {1: np.array([-(2**31)], np.int32),
              2: np.array([-(2**31), 2**31 - 1], np.int32)}
GAINS = {"bank": BANK_GAINS, "edge": EDGE_GAINS,
         "mixed": {1: np.array([-(2**30)], np.int32),
                   2: np.array([2**31 - 1, -(2**31)], np.int32)}}
I64 = (-(2**63), 2**63 - 1)


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _edge_words(rng, shape):
    """int64 words within 2^40 of int64's ends, or of 0, each third."""
    base = rng.choice(np.array([I64[0], 0, I64[1]], np.int64), shape)
    off = rng.integers(0, 2**40, shape, dtype=np.int64)
    return np.where(base < 0, base + off, base - off)


def _edge_x(rng, shape):
    """int32 x, a third of it at int32's ends."""
    x = _i32(rng, shape)
    ends = rng.choice(np.array([-(2**31), 2**31 - 1], np.int32), shape)
    return np.where(rng.random(shape) < 1 / 3, ends, x).astype(np.int32)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plans ------------------------------------------------------------


@pytest.mark.parametrize("c", [2048, 200, 50, 1])
def test_lowpass_plan_defaults(c, no_library):
    """LP_PRODUCERS copy warps and the store warp beside the serial warp in
    8 warps; one word a row and lane each way, so PIPE_CHUNK-row chunks in
    the PIPE_RING slots that fit; ceil(c / 32) tiles."""
    p = lowpass_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        8, LP_PRODUCERS, PIPE_CHUNK, PIPE_RING, 1)
    assert (p.win, p.wout, p.tiles) == (1, 1, -(-c // 32))
    assert p.smem == pipe_smem(256, 3) == 196704 <= MAX_PIPE_SMEM
    forced = lowpass_plan(c, producers=11, chunk=40, ring=5)
    assert (forced.warps, forced.chunk, forced.smem) == (
        16, 40, pipe_smem(40, 5))


@pytest.mark.parametrize("c", [2048, 200, 50, 1])
def test_k6_plan_is_the_bank_plan(c, no_library):
    """K6 runs K12/K13's plan: BANK_PRODUCERS mix warps and the back end
    in 12 warps, a tile the I and Q lanes of 16 channels."""
    p = bank_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        12, BANK_PRODUCERS, PIPE_CHUNK, PIPE_RING, 1)
    assert p.tiles == -(-c // PAIR) == -(-2 * c // 32)
    assert p.smem == pipe_smem(256, 3)


@pytest.mark.parametrize("kw,match", [
    (dict(producers=0), "producers"),
    (dict(warps=4, producers=4), "warps"),    # 6 roles in 3 places
    (dict(warps=20), "warps"),
    (dict(cluster=2), "one CTA"),
    (dict(chunk=0), "chunk"),
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=512, ring=3), "more than"),
    (dict(chunk=2048), "no ring"),
])
def test_plans_refuse_what_the_kernels_cannot_run(kw, match, no_library):
    for plan in (lowpass_plan, bank_plan):
        with pytest.raises(ValueError, match=match):
            plan(1024, **kw)
    with pytest.raises(ValueError, match="lanes"):
        lowpass_plan(0)
    with pytest.raises(ValueError, match="channels"):
        bank_plan(0)


def test_wrappers_refuse_before_the_library(no_library, monkeypatch):
    """On the kernels' path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched, K4's and K6's."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    n0 = (lowpass_cuda.lowpass_bank.launches,
          ddc_bank_cuda.fastlo_ddc_bank_block_lp.launches)
    st = lowpass.init(2, (40,), device=meta)
    xs = torch.zeros((256, 40), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="gains"):
        lowpass_cuda.lowpass_bank(np.array([1, 2, 3], np.int32), st, xs)
    with pytest.raises(ValueError):  # 256 % 3
        lowpass_cuda.lowpass_bank(BANK_GAINS[2], st, xs, dec=3)
    with pytest.raises(ValueError, match="lanes"):
        lowpass_cuda.lowpass_bank(BANK_GAINS[2], st, xs[:, :0])
    c = 20
    lp = lowpass.init(2, (2 * c,), device=meta)
    pst = pll.init((c,), device=meta)
    ph = torch.zeros((c,), dtype=torch.int32, device=meta)
    x = torch.zeros((256,), dtype=torch.int32, device=meta)

    def k6(gains=BANK_GAINS[2], x=x, ph=ph, **kw):
        return ddc_bank_cuda.fastlo_ddc_bank_block_lp(
            gains, PLL_BA, lp, pst, ph, ph, x, **kw)

    with pytest.raises(ValueError, match="gains"):
        k6(gains=np.array([1, 2, 3], np.int32))
    with pytest.raises(ValueError, match="time_chunk"):
        k6(x=x[:200])  # 200 % 128
    with pytest.raises(ValueError, match="time_chunk"):
        k6(d=16, time_chunk=24)  # 24 % 16
    with pytest.raises(ValueError, match="time_chunk"):
        k6(time_chunk=0)
    with pytest.raises(ValueError, match="channels"):
        k6(ph=ph[:0])
    assert (lowpass_cuda.lowpass_bank.launches,
            ddc_bank_cuda.fastlo_ddc_bank_block_lp.launches) == n0


# ---- the regrouped step -----------------------------------------------------


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("gains", list(GAINS))
def test_regrouped_step_equals_plain_step(n, gains):
    """`lp_rows` (the serial warp's regrouped sums) == `lowpass.block` bit
    for bit over 64 rows of 4096 lanes at int64's edges, x a third at
    int32's ends: the subtract saturates both ways and the plain sums wrap
    (counted on the first row in Python integers)."""
    rng = np.random.default_rng(7 + n)
    k = GAINS[gains][n]
    c = 4096
    st = lowpass.LowpassState(p=torch.from_numpy(_edge_words(rng, (c, n))))
    xs = _edge_x(rng, (64, c))
    want_st, want = lowpass.block(k, st, torch.from_numpy(xs))
    p = [st.p[:, 0].numpy().view(np.uint64).copy(),
         st.p[:, 1].numpy().view(np.uint64).copy() if n == 2 else None]
    with np.errstate(over="ignore"):
        got = lp_rows([int(v) for v in k], p, xs.astype(np.int64))
    np.testing.assert_array_equal(got.astype(np.int32), want.numpy())
    got_p = np.stack([v for v in p if v is not None], 1).view(np.int64)
    np.testing.assert_array_equal(got_p, want_st.p.numpy())
    hi0 = st.p[:, 0].numpy() >> 32
    diff = xs[0].astype(np.int64) - hi0
    assert (diff > 2**31 - 1).any() and (diff < -(2**31)).any()
    if gains != "bank":  # some plain int64 sum of the first row wraps
        e = np.clip(diff, -(2**31), 2**31 - 1)
        if gains == "edge":
            assert any(abs(int(v) * int(k[0])) == 2**62 for v in e)
        ks = [int(v) for v in k]
        wraps = False
        for lane in range(c):
            p0 = int(st.p[lane, 0])
            d = int(e[lane]) * ks[0]
            if n == 1:
                sums = [p0 + d, p0 + 2 * d]
            else:
                p1 = int(st.p[lane, 1])
                d += (p1 >> 32) * ks[1]
                sums = [p1 + d, p0 + p1 + d, p0 + 2 * (p1 + d), p1 + 2 * d]
            wraps |= any(not I64[0] <= v <= I64[1] for v in sums)
        assert wraps


# ---- K4: a model of the kernel's schedule -------------------------------------

LP_CASES = [
    # (c, t, dec, plan keywords)
    (40, 320, 16, dict(chunk=24, ring=2)),     # chunk % dec != 0
    (33, 99, 3, dict(chunk=40, ring=3)),       # t % chunk = 19; 33 lanes
    (5, 1, 1, {}),                             # t = 1
    (20, 100, 1, {}),                          # t under a chunk
    (64, 256, 16, dict(chunk=64, producers=3)),
    (50, 7 * 32 + 8, 1, dict(chunk=32, producers=11, warps=16)),
    (3, 48, 3, dict(chunk=5, ring=4, producers=2)),  # 3-row spans
    (10, 0, 4, {}),                            # no rows
]


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("kind", ["bank", "edge"])
@pytest.mark.parametrize("c,t,dec,kw", LP_CASES)
def test_lowpass_model_equals_plain(c, t, dec, kw, kind, n):
    """Two carried blocks: the #5 bank's gains, x in +-2^27 and a random
    state, or gains at int32's ends (e k0 = 2^62), states at int64's edges
    and x a third at int32's ends."""
    rng = np.random.default_rng(600 + c + t + n)
    plan = lowpass_plan(c, **kw)
    k = GAINS[kind][n]
    if kind == "bank":
        st = lowpass.LowpassState(p=torch.from_numpy(rng.integers(
            -(2**58), 2**58, (c, n), dtype=np.int64)))
    else:
        st = lowpass.LowpassState(p=torch.from_numpy(_edge_words(rng,
                                                                 (c, n))))
    ps = st
    for blk in range(2):
        xs = torch.from_numpy(_i32(rng, (t, c), -(2**27), 2**27)
                              if kind == "bank" else _edge_x(rng, (t, c)))
        st, ys = lowpass_model(k, st, xs, plan, dec=dec, seed=blk)
        ps, pys = lowpass_bank_plain(k, ps, xs, dec=dec)
        assert torch.equal(st.p, ps.p)
        assert ys.dtype == pys.dtype and torch.equal(ys, pys)


# ---- K6: a model of the kernel's schedule -------------------------------------

K6_CASES = [
    # (c, t, d, time_chunk, plan keywords)
    (16, 256, 16, 32, dict(chunk=64, ring=2)),     # time chunk under chunk
    (17, 256, 4, 128, dict(chunk=96, ring=3)),     # 17 channels; t % chunk
    (3, 96, 16, 48, dict(chunk=8, ring=4)),        # chunks under d
    (20, 40, 1, 8, dict(chunk=16, ring=2)),        # every row kept
    (1, 64, 4, 16, dict(chunk=12, producers=1)),   # one channel
    (9, 512, 8, 512, dict(chunk=256, producers=11, warps=16)),
    (5, 384, 16, 128, dict(chunk=160, producers=3)),
    (6, 0, 16, 128, {}),                           # no rows
]


def _same(got, want):
    for a, b in zip(got, want, strict=True):
        if isinstance(a, tuple):  # a state
            for u, v in zip(torch.utils._pytree.tree_leaves(a),
                            torch.utils._pytree.tree_leaves(b), strict=True):
                assert u.dtype == v.dtype and torch.equal(u, v)
        else:
            assert a.dtype == b.dtype == torch.int32
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("kind", ["bank", "edge"])
@pytest.mark.parametrize("c,t,d,tc,kw", K6_CASES)
def test_k6_model_equals_plain(c, t, d, tc, kw, kind, n):
    """Two carried blocks of x in +-2^27, full-range phases and steps, a
    PLL state that has run: the #5 bank's gains and a random state, or
    gains at int32's ends and states at int64's edges (the subtract
    saturates on the mixed stream)."""
    rng = np.random.default_rng(700 + c + t + n)
    plan = bank_plan(c, **kw)
    k = GAINS[kind][n]
    if kind == "bank":
        st = lowpass.LowpassState(p=torch.from_numpy(rng.integers(
            -(2**58), 2**58, (2 * c, n), dtype=np.int64)))
    else:
        st = lowpass.LowpassState(p=torch.from_numpy(
            _edge_words(rng, (2 * c, n))))
    pst, _ = pll_bank_plain(PLL_BA, pll.init((c,), device="cpu"),
                            torch.from_numpy(_i32(rng, (7, c))))
    ph = torch.from_numpy(_i32(rng, (c,)))
    steps = torch.from_numpy(_i32(rng, (c,)))
    ps, ppst = st, pst
    for blk in range(2):
        x = torch.from_numpy(_i32(rng, (t,), -(2**27), 2**27))
        if kind != "bank" and blk == 0 and c >= 5 and t:  # it saturates
            m0 = fastlo_mix_tables(x, fastlo_tables(ph, steps, t, tc))[0]
            diff = m0.numpy().astype(np.int64) - (st.p[:, 0].numpy() >> 32)
            assert (diff > 2**31 - 1).any() and (diff < -(2**31)).any()
        got = bank_model(None, None, st, ph, steps, x, plan, d=d,
                         time_chunk=tc, pll_ba=PLL_BA, pll_state=pst,
                         lp_gains=k, seed=blk)
        ps, ppst, pph, py, pyp = fastlo_ddc_bank_block_lp_plain(
            k, PLL_BA, ps, ppst, ph, steps, x, d=d, time_chunk=tc)
        _same(got, (ps, ppst, py, pyp))
        st, pst = got[:2]
        ph = pph


def test_k6_plain_tracks_jax_kernel():
    """At c = 128, t = 256, time chunk 128, d = 16, over two carried
    blocks, K6's plain version against the interpret-mode JAX kernel
    within the gates of K13's (tests/test_torch_ddc_bank_biquad.py): the
    Lowpass state's high words and yiq within 16 (the mix's LO tables
    round an ULP apart across the frameworks), yiq's rms difference under
    1e-5 of the signal's, the PLL frequency words within a median of 64
    cycles and its output phases within a median of 2^-16 of a turn."""
    c, t, d, tc = 128, 256, 16, 128
    rng = np.random.default_rng(85)
    k = BANK_GAINS[2]
    phase0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    jcarry = (jlowpass.init(2, (2 * c,)), jpll.init((c,)),
              jnp.asarray(phase0))
    carry = (lowpass.init(2, (2 * c,), device="cpu"),
             pll.init((c,), device="cpu"), torch.from_numpy(phase0))
    for _ in range(2):
        x = _i32(rng, (t,), -(2**27), 2**27)
        jlp, jpst, jph, jy, jyp = j_fastlo_ddc_bank_block_lp(
            jnp.asarray(k), jnp.asarray(PLL_BA), *jcarry,
            jnp.asarray(steps), jnp.asarray(x), n=2, d=d, time_chunk=tc,
            interpret=True)
        lp, pst, ph, y, yp = fastlo_ddc_bank_block_lp_plain(
            k, PLL_BA, *carry, torch.from_numpy(steps), torch.from_numpy(x),
            d=d, time_chunk=tc)
        jcarry, carry = (jlp, jpst, jph), (lp, pst, ph)
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jph))
        dp = (lp.p.numpy() >> 32) - (np.asarray(jlp.p, np.int64) >> 32)
        assert np.abs(dp).max() <= 16, np.abs(dp).max()
        ya = np.asarray(jy, np.float64)
        yb = y.numpy().astype(np.float64)
        assert np.abs(ya - yb).max() <= 16, np.abs(ya - yb).max()
        rms_sig = np.sqrt((ya**2).mean()) + 1.0
        assert np.sqrt(((ya - yb) ** 2).mean()) < 1e-5 * rms_sig
        df = np.abs(pst.f.numpy() - np.asarray(jpst.f, np.int64)) / 2**32
        assert np.median(df) < 64.0, np.median(df)
        dyp = (yp.numpy().astype(np.int64) - np.asarray(jyp, np.int64)
               + 2**31) % 2**32 - 2**31
        assert np.median(np.abs(dyp)) < 2**16, np.median(np.abs(dyp))
