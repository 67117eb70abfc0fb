"""K24 `sos_bank_q`'s launch plan (`filters/pipe_plan.py` `sos_plan`) and a
CPU model of its schedule (``csrc/biquad_bank.cu`` on
``csrc/df1_ring.cuh``'s `run_chain`), held against the plain version and
the interpret-mode JAX kernel.

The kernel runs a tile of 32 lanes as a chain of ceil(N / g) ranks over a
thread-block cluster, one or two ranks a CTA, rank j running stages [j g,
(j + 1) g), each a depth-0 block: producer warps by spans form the rank's
first stage's
feed-forward sum W = b0 x0 + b1 x1 + b2 x2 mod 2^64 (rank 0 from xs, a
later rank from its x ring, which the rank before's store warp fills with
its last stage's rows, two rows ahead of each chunk); the serial warp
runs the rank's stages, each later stage's x0 the stage before's y0; the
last rank's store warp writes ys.  These tests show:

* the plan: the first of one stage a CTA, two one-stage ranks a CTA, g =
  2, 3, ... stages a CTA that puts the tiles' clusters on the card's SMs
  one CTA an SM (and that the card holds at once, where asked), g = N
  where none does, at 1024, 2048, 200, 50 and 1 lanes for N = 1-8 and
  several SM counts; roles, chunk, ring and shared memory (the x ring in a
  cluster of 2+ or a CTA of two ranks); the plans and calls it refuses
  before the library is asked for;
* a model of the schedule (tests/torch_pipe_model.py `sos_model`: every
  rank's producers, serial and store warps, the x slots with their two
  rows ahead, the slots and parities chunk by chunk, the roles of all
  ranks interleaved at random, numpy uint64 words) equals the plain
  version bit for bit over carried blocks: at chunk edges, t = 1, t
  under a chunk, t = 0, N = 1, 2, 3, 4 and 8 at g = 1, 2 and N and at two
  one-stage ranks a CTA, chunks of 1-4 rows, f 1-63, sums that wrap mod
  2^64;
* at c = 128 the plain version equals the interpret-mode JAX kernel
  `biquad_pallas.sos_bank_q` bit for bit.
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
from idsp_tpu_torch.filters.biquad_cuda import sos_bank_q_plain
from idsp_tpu_torch.filters.pipe_plan import (
    CHAIN_WARPS,
    LANES,
    MAX_CLUSTER,
    MAX_PIPE_SMEM,
    SOS_MAX_STAGES,
    chain_smem,
    pipe_smem,
    sos_plan,
)
from torch_pipe_model import sos_model


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _states(rng, c, n, lim=2**31):
    return [biquad.Df1State(x=torch.from_numpy(_i32(rng, (c, 2), -lim, lim)),
                            y=torch.from_numpy(_i32(rng, (c, 2), -lim, lim)))
            for _ in range(n)]


def _lowpass(n, f=29):
    """n Q<f> lowpasses at spread frequencies, (n, 5) int32."""
    return np.stack([biquad.quantize_ba(biquad.from_cookbook(
        Filter().critical_frequency(fc).lowpass()), f)
        for fc in np.linspace(0.03, 0.3, n)])


def _coefs(rng, n, f):
    """(n, 5) coefficients in +-2^(f + 1) (full range from f = 30 on)."""
    top = min(2**31 - 1, 2 << f)
    return rng.integers(-top, top + 1, (n, 5)).astype(np.int32)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------


def _expected(c, n, sms):
    """(g, halves) the plan must take: the first of one stage a rank and a
    CTA, one stage a rank and two ranks a CTA, g = 2, 3, ... stages a CTA,
    whose tiles' CTAs fit sms; else (n, 1)."""
    tiles = -(-c // LANES)
    shapes = [(1, 1), (1, 2)] + [(g, 1) for g in range(2, n)]
    for g, h in shapes:
        if g < n and tiles * -(-(-(-n // g)) // h) <= sms:
            return g, h
    return n, 1


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("c", [1024, 2048, 200, 50, 1])
def test_sos_plan_picks_the_first_shape_that_fits(c, sms, no_library):
    """For N = 1-8: the first of one stage a CTA, two one-stage ranks a
    CTA, g = 2, 3, ... stages a CTA whose tiles' CTAs fit the SMs, one CTA
    an SM; the plan's shape: with one rank a CTA, 8 producers and the store
    warp in 12 warps, 128-row chunks in 3 slots with the x ring (197520
    bytes), 256-row chunks in 2 slots for one CTA a tile (K1's 196672);
    with two, 4 producers and a store warp each on schedulers 1 and 3 of 20
    warps, 64-row chunks in 3 slots (198432 bytes); each more than half an
    SM's shared memory."""
    for n in range(1, SOS_MAX_STAGES + 1):
        p = sos_plan(c, n, sms=sms)
        assert (p.group, p.halves) == _expected(c, n, sms)
        ranks = -(-n // p.group)
        assert p.cluster == -(-ranks // p.halves) <= MAX_CLUSTER
        assert (p.stages, p.tiles) == (n, -(-c // LANES))
        if p.halves == 2:
            assert (p.warps, p.producers, p.chunk, p.ring) == (20, 4, 64, 3)
            assert p.smem == chain_smem(64, 3, p.cluster, 2) == 198432
            assert p.smem == 2 * (pipe_smem(64, 3, 2, 1) + 3 * (16 + 66 * 128))
        elif p.cluster > 1:
            assert (p.warps, p.producers, p.chunk, p.ring) == (12, 8, 128, 3)
            assert p.smem == chain_smem(128, 3, p.cluster) == 197520
            assert p.smem == pipe_smem(128, 3, 2, 1) + 3 * (16 + 130 * 128)
        else:
            assert (p.chunk, p.ring, p.smem) == (256, 2, 196672)
        assert MAX_PIPE_SMEM >= p.smem > MAX_PIPE_SMEM // 2


def test_sos_plan_at_the_published_widths(no_library):
    """Where every cluster fits, 4 stages at 1024 lanes take one stage a
    CTA, a cluster of 4 over 128 CTAs; the card holds only 30 clusters of 4
    (`co_resident`), so it takes two one-stage ranks a CTA, clusters of 2
    over 64 CTAs; so at 2048 lanes (128 CTAs); 8 stages at 1024 lanes,
    where clusters of 4 do not fit, g = 3, clusters of 3."""
    def co(plan):
        return {4: 30, 3: 39, 2: 66}.get(plan.cluster, 132)

    p = sos_plan(1024, 4, sms=132)
    assert (p.group, p.halves, p.cluster, p.tiles * p.cluster) == (1, 1, 4,
                                                                   128)
    p = sos_plan(1024, 4, sms=132, co_resident=co)
    assert (p.group, p.halves, p.cluster, p.tiles * p.cluster) == (1, 2, 2,
                                                                   64)
    p = sos_plan(2048, 4, sms=132, co_resident=co)
    assert (p.group, p.halves, p.cluster, p.tiles * p.cluster) == (1, 2, 2,
                                                                   128)
    p = sos_plan(1024, 8, sms=132, co_resident=co)
    assert (p.group, p.halves, p.cluster) == (3, 1, 3)
    # more tiles than SMs: one CTA a tile
    assert sos_plan(8192, 4, sms=132).group == 4


def test_sos_plan_takes_the_next_shape_where_clusters_do_not_fit(no_library):
    """Where the card holds fewer clusters at once than the tiles, the
    plan takes the next shape; the query sees each candidate plan."""
    seen = []

    def co(plan):
        seen.append((plan.group, plan.halves, plan.cluster))
        return {(4, 1): 30, (2, 2): 10, (2, 1): 66}[plan.cluster, plan.halves]

    p = sos_plan(1024, 4, sms=132, co_resident=co)
    assert (p.group, p.halves, p.cluster) == (2, 1, 2)
    assert seen == [(1, 1, 4), (1, 2, 2), (2, 1, 2)]
    p = sos_plan(1024, 4, sms=132, co_resident=lambda plan: 0)
    assert (p.group, p.cluster) == (4, 1)  # one CTA a tile always runs
    p = sos_plan(1024, 4, sms=132, co_resident=lambda plan: 32)
    assert (p.group, p.halves) == (1, 1)


@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_sos_plan_forced_groups(n, no_library):
    """A given g is taken as it is, whatever the SMs: clusters of
    ceil(N / g), the last rank's stages fewer where g does not divide N;
    with two one-stage ranks a CTA, clusters of ceil(N / 2), a CTA's second
    rank unused where N is odd."""
    for g in range(1, n + 1):
        p = sos_plan(50, n, group=g)
        assert (p.group, p.halves, p.cluster) == (g, 1, -(-n // g))
        assert n - (p.cluster - 1) * g in range(1, g + 1)
    p = sos_plan(50, n, group=1, chunk=16, ring=5, producers=2)
    assert (p.chunk, p.ring, p.warps) == (16, 5, 4)
    assert p.smem == chain_smem(16, 5, p.cluster)
    p = sos_plan(50, n, group=1, halves=2)
    assert (p.halves, p.cluster, p.warps, p.producers) == (2, -(-n // 2), 20,
                                                            4)
    p = sos_plan(50, n, group=1, halves=2, producers=1, warps=8, chunk=8)
    assert (p.warps, p.ring, p.smem) == (8, 3, chain_smem(8, 3, p.cluster, 2))


@pytest.mark.parametrize("kw,match", [
    (dict(group=1, producers=0), "producers"),
    (dict(group=1, producers=9), "warps"),      # 10 roles in 9 places
    (dict(group=1, warps=16, producers=11), "warps"),  # more than 12
    (dict(group=1, warps=8, producers=6), "warps"),
    (dict(group=1, halves=2, producers=5), "warps"),   # 12 roles in 10
    (dict(group=1, halves=2, producers=2, warps=8), "warps"),
    (dict(group=1, halves=2, warps=24), "warps"),      # more than 20
    (dict(group=1, halves=2, producers=0), "producers"),
    (dict(group=2, halves=2), "halves"),  # two ranks a CTA: one stage each
    (dict(group=1, halves=3), "halves"),
    (dict(chunk=0, group=1), "chunk"),
    (dict(ring=1, group=1), "2\\+ slots"),
    (dict(chunk=256, ring=2, group=1), "more than"),
    (dict(chunk=128, ring=2, group=1, halves=2), "more than"),
    (dict(chunk=1024, group=1), "no ring"),
    (dict(group=0), "group"),
    (dict(group=5), "group"),
    (dict(), "SMs"),
])
def test_sos_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        sos_plan(1024, 4, **kw)
    for n in (0, SOS_MAX_STAGES + 1):
        with pytest.raises(ValueError, match="stages"):
            sos_plan(1024, n, sms=132)
    with pytest.raises(ValueError, match="lanes"):
        sos_plan(0, 4, sms=132)
    assert CHAIN_WARPS == 12


def test_sos_wrapper_refuses_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched: f outside 1..63, a plan of another
    stage count, lane count or shape than its own, no lanes, a state
    count that is not the stage count."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    sts = [biquad.df1_init((64,), device=meta) for _ in range(3)]
    xs = torch.zeros((8, 64), dtype=torch.int32, device=meta)
    ba = _lowpass(3)
    n0 = biquad_cuda.sos_bank_q.launches
    for f in (0, 64):
        with pytest.raises(ValueError, match="f must be"):
            biquad_cuda.sos_bank_q(ba, sts, xs, f, _plan=sos_plan(64, 3,
                                                                  group=1))
    for plan in (sos_plan(64, 2, group=1), sos_plan(96, 3, group=1),
                 sos_plan(64, 3, group=1)._replace(smem=1),
                 sos_plan(64, 3, group=1)._replace(cluster=1),
                 sos_plan(64, 3, group=2)._replace(group=4)):
        with pytest.raises(ValueError, match="plan|group"):
            biquad_cuda.sos_bank_q(ba, sts, xs, 29, _plan=plan)
    with pytest.raises(ValueError, match="lanes"):
        biquad_cuda.sos_bank_q(ba, sts, xs[:, :0], 29)
    with pytest.raises(ValueError, match="states"):
        biquad_cuda.sos_bank_q(ba, sts[:2], xs, 29)
    assert biquad_cuda.sos_bank_q.launches == n0


# ---- a model of the kernel's schedule ---------------------------------------


def _same(got, want):
    (gs, gy), (ws, wy) = got, want
    assert gy.dtype == wy.dtype and gy.shape == wy.shape
    assert torch.equal(gy, wy)
    assert len(gs) == len(ws)
    for a, b in zip(gs, ws):
        assert torch.equal(a.x, b.x)
        assert torch.equal(a.y, b.y)


SOS_CASES = [
    # (c, t, n, g, plan keywords)
    (16, 40, 4, 1, dict(chunk=64)),                          # t under a chunk
    (20, 48, 3, 1, dict(chunk=48, ring=2)),                  # t = one chunk
    (37, 3 * 20 + 10, 3, 2, dict(chunk=20, ring=2, producers=3)),
    (8, 5 * 12 + 6, 8, 1, dict(chunk=12, ring=3, producers=5)),  # 8 CTAs
    (40, 70, 8, 2, dict(chunk=16, ring=4)),
    (33, 60, 4, 4, dict(chunk=16, ring=2, producers=2)),     # one CTA
    (36, 50, 2, 1, dict(chunk=16, ring=2, producers=1)),
    (12, 30, 3, 1, dict(chunk=1, ring=2)),                   # one-row chunks
    (5, 1, 4, 1, dict(chunk=8)),                             # t = 1
    (3, 2, 8, 3, dict(chunk=1, producers=8)),                # rows 0 and 1
    (7, 0, 3, 1, dict(chunk=8)),                             # t = 0
    # 8 stages in one CTA over chunks of 4 rows and 1 row
    (9, 23, 8, 8, dict(chunk=4, ring=3)),
    (9, 23, 8, 8, dict(chunk=1, ring=8)),
    (9, 19, 6, 3, dict(chunk=1, ring=3, producers=2)),
    (9, 7, 5, 5, dict(chunk=2, ring=3)),
    # two one-stage ranks a CTA (the links between them in the CTA)
    (16, 40, 4, 1, dict(halves=2, chunk=16)),
    (9, 23, 3, 1, dict(halves=2, chunk=4, ring=3)),  # a rank unused
    (33, 60, 8, 1, dict(halves=2, chunk=8, producers=2)),
    (20, 50, 4, 1, dict(halves=2, chunk=16, producers=1, warps=12)),
    (5, 1, 2, 1, dict(halves=2, chunk=8)),
]


@pytest.mark.parametrize("c,t,n,g,kw", SOS_CASES)
def test_schedule_model_equals_plain(c, t, n, g, kw):
    """Two carried blocks from a random state, lowpass stages on x in
    +-2^28; c = 20, 36, 37 and 40 are not multiples of the 32-lane tile,
    and a rank's last stage group is short where g does not divide N."""
    rng = np.random.default_rng(2200 + c + 10 * n + g)
    plan = sos_plan(c, n, group=g, **kw)
    ba = _lowpass(n)
    st = ps = _states(rng, c, n, 2**28)
    for blk in range(2):
        xs = torch.from_numpy(_i32(rng, (t, c), -(2**28), 2**28))
        got = sos_model(ba, 29, st, xs, plan, seed=blk)
        want = sos_bank_q_plain(ba, ps, xs, 29)
        _same(got, want)
        st, ps = got[0], want[0]


@pytest.mark.parametrize("f", [1, 2, 16, 31, 32, 33, 40, 62, 63])
@pytest.mark.parametrize("n,g", [(3, 1), (4, 2), (8, 8)])
def test_schedule_model_at_every_shift(f, n, g):
    """f from 1 to 63 (both shifts, their edges at 32 and 33),
    coefficients in +-2^(f + 1), full-range x and state, two carried
    blocks at 16-row chunks."""
    c, t = 37, 3 * 16 + 5
    rng = np.random.default_rng(70 + f + n)
    ba = _coefs(rng, n, f)
    plan = sos_plan(c, n, group=g, chunk=16, ring=3, producers=2)
    st = ps = _states(rng, c, n)
    for blk in range(2):
        xs = torch.from_numpy(_i32(rng, (t, c)))
        got = sos_model(ba, f, st, xs, plan, seed=blk)
        want = sos_bank_q_plain(ba, ps, xs, f)
        _same(got, want)
        st, ps = got[0], want[0]


def test_schedule_model_where_the_sum_wraps():
    """Coefficients, x and state at int32's edges: rows whose five products
    pass 2^63, at f = 1, 32, 33 and 63, over a cluster of 3 and one CTA."""
    c, t = 33, 40
    rng = np.random.default_rng(24)
    ba = np.full((3, 5), -(2**31), np.int32)
    edges = np.array([-(2**31), -(2**31) + 1, -(2**30), -1, 0, 1, 2**30,
                      2**31 - 1], np.int32)
    xs = rng.choice(edges, (t, c))
    xs[0] = -(2**31)
    low = torch.full((c, 2), -(2**31), dtype=torch.int32)
    st = [biquad.Df1State(x=low, y=low.clone()) for _ in range(3)]
    assert 5 * (2**31) ** 2 >= 2**63
    x = torch.from_numpy(xs)
    for f in (1, 32, 33, 63):
        for g in (1, 3):
            plan = sos_plan(c, 3, group=g, chunk=8, ring=2, producers=3)
            _same(sos_model(ba, f, st, x, plan, seed=f),
                  sos_bank_q_plain(ba, st, x, f))


# ---- the plain version against the interpret-mode JAX kernel ----------------


@pytest.mark.parametrize("n", [2, 4])
def test_plain_equals_interpret_kernel(n):
    """The plain version against the interpret-mode JAX kernel at c = 128,
    t = 128, 64-row time chunks, over two carried blocks from a random
    state: outputs and every stage's state bit for bit; the schedule model
    at 32-row chunks and g = 1 beside them."""
    c, t = 128, 128
    rng = np.random.default_rng(2222 + n)
    ba = _lowpass(n)
    st = _states(rng, c, n, 2**26)
    jst = [jbiquad.Df1State(x=jnp.asarray(s.x.numpy()),
                            y=jnp.asarray(s.y.numpy())) for s in st]
    plan = sos_plan(c, n, group=1, chunk=32)
    for blk in range(2):
        xs = _i32(rng, (t, c), -(2**24), 2**24)
        jst, jys = jbp.sos_bank_q(ba, jst, jnp.asarray(xs), 29,
                                  time_chunk=64, interpret=True)
        want = sos_bank_q_plain(ba, st, torch.from_numpy(xs), 29)
        np.testing.assert_array_equal(want[1].numpy(), np.asarray(jys))
        for s, js in zip(want[0], jst):
            np.testing.assert_array_equal(s.x.numpy(), np.asarray(js.x))
            np.testing.assert_array_equal(s.y.numpy(), np.asarray(js.y))
        _same(sos_model(ba, 29, st, torch.from_numpy(xs), plan, seed=blk),
              want)
        st = want[0]
