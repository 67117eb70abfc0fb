"""K12 `fastlo_df1_dec_bank` (and its ``clamp=``) and K13
`fastlo_ddc_bank_block`: their launch plan (`filters/ddc_bank_cuda.py`
`bank_plan`) and a CPU model of their schedule (``csrc/ddc_bank.cu`` on
``csrc/df1_ring.cuh``'s depth-0 pipeline), held against the plain
versions and the interpret-mode JAX kernels.

The kernel runs a CUDA block of one tile of 16 channels: lane lid < 16 is
the I lane of channel 16 * tile + lid, lane lid >= 16 its Q lane; mix
warps, each a span of every chunk, write the fast-LO mix
(K3's producer, fastlo.cuh) into the DF1 warp's input ring; the DF1 warp
(clamped for ``clamp=``) writes its output ring; a back-end warp in the
store warp's place writes the kept rows (block rows r with r % d == 0) to
yiq and, for K13, takes atan2(Q, I) of two kept rows at once and steps the
PLL over them.  These tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory at
  1024, 200, 17, 16 and 1 channels, and the plans and calls it refuses
  before the library is asked for;
* a model of the schedule (tests/torch_pipe_model.py `bank_model`: the
  paired lane map, the producers' spans, the DF1 warp, the back
  end, the slots and parities chunk by chunk, the roles interleaved at
  random) equals `fastlo_df1_dec_bank_plain`, its ``clamp=`` form and
  `fastlo_ddc_bank_block_plain` bit for bit over carried blocks: pipeline
  chunks other than the time chunk and not multiples of d, chunks under
  d, t not a multiple of the chunk, c not a multiple of 16, d = 1, t = 0,
  the clamp engaged, int64 sums that wrap;
* at c = 128 the model tracks the interpret-mode JAX kernels within the
  fast-LO gates of tests/test_torch_ddc_bank_biquad.py (the mix's LO
  tables round an ULP apart across the frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import pll as jpll
from idsp_tpu.filters.ddc_pallas import (
    fastlo_ddc_bank_block as j_fastlo_ddc_bank_block,
    fastlo_df1_dec_bank as j_fastlo_df1_dec_bank,
)

from idsp_tpu_torch import _ext
from idsp_tpu_torch.filters import biquad, ddc_bank_cuda, pll
from idsp_tpu_torch.filters.ddc_bank_cuda import (
    BANK_PRODUCERS,
    bank_plan,
    fastlo_ddc_bank_block_plain,
    fastlo_df1_dec_bank_plain,
)
from idsp_tpu_torch.filters.pipe_plan import (
    MAX_PIPE_SMEM,
    PIPE_CHUNK,
    PIPE_RING,
    pipe_smem,
)
from idsp_tpu_torch.filters.pll_cuda import pll_bank_plain
from idsp_tpu_torch.ops.fastlo import fastlo_mix_tables, fastlo_tables
from torch_pipe_model import PAIR, bank_model, pair_lanes

CLAMP = (1 << 10, -(1 << 23), 1 << 23)  # engages on the mixed stream
PLL_BA = tuple(int(v) for v in jpll.coefficients_from_bandwidth(2e-2, 4.0))
BA = jbiquad.quantize_ba(
    jbiquad.from_cookbook(JFilter().critical_frequency(0.02).lowpass()), 29)


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------


@pytest.mark.parametrize("c", [1024, 200, 17, 16, 1])
def test_bank_plan_defaults(c, no_library):
    """BANK_PRODUCERS mix warps and the back end beside the DF1 warp in 12
    warps; one word a row and lane each way, so PIPE_CHUNK-row chunks in
    the PIPE_RING slots that fit; a tile is 16 channels' I and Q lanes, so
    ceil(c / 16) tiles."""
    p = bank_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        12, BANK_PRODUCERS, PIPE_CHUNK, PIPE_RING, 1)
    assert (p.win, p.wout) == (1, 1)
    assert p.tiles == -(-c // PAIR) == -(-2 * c // 32)
    assert p.smem == pipe_smem(256, 3) == 196704 <= MAX_PIPE_SMEM
    forced = bank_plan(c, producers=3, chunk=24, ring=4)
    assert (forced.warps, forced.chunk, forced.smem) == (
        8, 24, pipe_smem(24, 4))


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
def test_bank_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        bank_plan(1024, **kw)
    with pytest.raises(ValueError, match="channels"):
        bank_plan(0)


def test_wrappers_refuse_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched, for K12, its clamp form and K13."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    c = 20
    st = biquad.df1_init((2 * c,), device=meta)
    pst = pll.init((c,), device=meta)
    ph = torch.zeros((c,), dtype=torch.int32, device=meta)
    x = torch.zeros((256,), dtype=torch.int32, device=meta)
    n0 = (ddc_bank_cuda.fastlo_df1_dec_bank.launches,
          ddc_bank_cuda.fastlo_ddc_bank_block.launches)
    for call in (
            lambda **kw: ddc_bank_cuda.fastlo_df1_dec_bank(
                BA, st, ph, ph, **kw),
            lambda **kw: ddc_bank_cuda.fastlo_df1_dec_bank(
                BA, st, ph, ph, clamp=CLAMP, **kw),
            lambda **kw: ddc_bank_cuda.fastlo_ddc_bank_block(
                BA, PLL_BA, st, pst, ph, ph, **kw)):
        with pytest.raises(ValueError, match="f must be"):
            call(x=x, f=64)
        with pytest.raises(ValueError, match="time_chunk"):
            call(x=x[:200], f=29)  # 200 % 128
        with pytest.raises(ValueError, match="time_chunk"):
            call(x=x, f=29, d=16, time_chunk=24)  # 24 % 16
        with pytest.raises(ValueError, match="time_chunk"):
            call(x=x, f=29, d=16, time_chunk=0)
    assert (ddc_bank_cuda.fastlo_df1_dec_bank.launches,
            ddc_bank_cuda.fastlo_ddc_bank_block.launches) == n0


# ---- a model of the kernel's schedule ---------------------------------------


def test_pair_lanes_cover_every_lane_once():
    """The paired map puts every I|Q lane of c channels on one model lane
    and a channel's I and Q lanes in one tile, 16 lanes apart."""
    for c in (1, 15, 16, 17, 40, 128):
        ch, is_q, live, row = pair_lanes(c)
        assert sorted(row[live]) == list(range(2 * c))
        assert (row[live & is_q] - row[live & ~is_q] == c).all()
        lane = np.arange(len(ch))
        assert (lane[live & is_q] - lane[live & ~is_q] == PAIR).all()
        assert live.sum() == 2 * c


def _same(got, want):
    for a, b in zip(got, want, strict=True):
        if isinstance(a, biquad.Df1State):
            assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
        elif isinstance(a, tuple):  # a PllState
            for u, v in zip(torch.utils._pytree.tree_leaves(a),
                            torch.utils._pytree.tree_leaves(b), strict=True):
                assert u.dtype == v.dtype and torch.equal(u, v)
        else:
            assert a.dtype == b.dtype == torch.int32
            assert torch.equal(a, b)


BANK_CASES = [
    # (c, t, d, time_chunk, plan keywords)
    (16, 256, 16, 32, dict(chunk=24, ring=2)),     # chunk % d != 0, != tc
    (17, 192, 4, 64, dict(chunk=40, ring=3)),      # t % chunk = 32; 17 ch
    (5, 96, 8, 96, dict(chunk=12, ring=2, producers=2)),
    (3, 96, 16, 48, dict(chunk=8, ring=4)),        # chunks under d
    (20, 40, 1, 8, dict(chunk=16, ring=2)),        # every row kept
    (40, 256, 16, 128, {}),                        # the default plan
    (1, 64, 4, 16, dict(chunk=12, ring=3, producers=1)),  # one live lane
    (9, 120, 8, 24, dict(chunk=24, producers=5)),
    (7, 180, 4, 12, dict(chunk=40, producers=3)),  # 14-row spans, tc 12
    (5, 170, 1, 17, dict(chunk=30, producers=3)),  # a batch's last row
    (6, 0, 16, 128, dict(chunk=16)),               # no rows
]


def _pll_start(rng, c):
    """A PLL state that has run: the plain PLL over a few random phases."""
    st, _ = pll_bank_plain(PLL_BA, pll.init((c,), device="cpu"),
                           torch.from_numpy(_i32(rng, (7, c))))
    return st


@pytest.mark.parametrize("kind", ["k12", "k12_clamp", "k13"])
@pytest.mark.parametrize("c,t,d,tc,kw", BANK_CASES)
def test_bank_model_equals_plain(c, t, d, tc, kw, kind):
    """Two carried blocks, the suite's range of x and a random state."""
    rng = np.random.default_rng(500 + c + t)
    plan = bank_plan(c, **kw)
    clamp = CLAMP if kind == "k12_clamp" else None
    st = biquad.Df1State(
        x=torch.from_numpy(_i32(rng, (2 * c, 2), -(2**27), 2**27)),
        y=torch.from_numpy(_i32(rng, (2 * c, 2), -(2**26), 2**26)))
    pst = _pll_start(rng, c) if kind == "k13" else None
    ph = torch.from_numpy(_i32(rng, (c,)))
    steps = torch.from_numpy(_i32(rng, (c,)))  # every LO octant
    ps, ppst = st, pst
    for blk in range(2):
        x = torch.from_numpy(_i32(rng, (t,), -(2**27), 2**27))
        st0 = ps
        st, pst, y = bank_model(BA, 29, st, ph, steps, x, plan, d=d,
                                time_chunk=tc, clamp=clamp, pll_ba=PLL_BA,
                                pll_state=pst, seed=blk)
        if kind == "k13":
            ps, ppst, pph, py = fastlo_ddc_bank_block_plain(
                BA, PLL_BA, ps, ppst, ph, steps, x, 29, d=d, time_chunk=tc)
            _same((st, pst, y), (ps, ppst, py))
        else:
            ps, pph, py = fastlo_df1_dec_bank_plain(
                BA, ps, ph, steps, x, 29, d=d, clamp=clamp, time_chunk=tc)
            _same((st, y), (ps, py))
        if clamp is not None and t:  # the clamp moved the state
            free = fastlo_df1_dec_bank_plain(BA, st0, ph, steps, x, 29, d=d,
                                             time_chunk=tc)[0]
            assert not torch.equal(free.y, ps.y), "the clamp never engaged"
        ph = pph


@pytest.mark.parametrize("kind", ["k12", "k13"])
def test_bank_model_equals_plain_where_the_sum_wraps(kind):
    """Coefficients and state at int32's edges, full-range x: the DF1's
    five-term int64 sum wraps (its first row passes 2^63 on some lanes,
    counted in Python integers), at chunks other than the time chunk and
    not multiples of d, at f = 29 and 45."""
    rng = np.random.default_rng(77)
    c, t, d, tc = 18, 160, 8, 32
    edges = np.array([-(2**31), 2**31 - 1], np.int32)
    ba = np.full(5, -(2**31), np.int32)
    plan = bank_plan(c, chunk=20, ring=3)
    st = biquad.Df1State(x=torch.from_numpy(rng.choice(edges, (2 * c, 2))),
                         y=torch.from_numpy(rng.choice(edges, (2 * c, 2))))
    pst = _pll_start(rng, c) if kind == "k13" else None
    ph = torch.from_numpy(_i32(rng, (c,)))
    steps = torch.from_numpy(_i32(rng, (c,)))
    x = torch.from_numpy(_i32(rng, (t,)))
    x0 = fastlo_mix_tables(x, fastlo_tables(ph, steps, t, tc))[0]
    b = [int(v) for v in ba]
    first = [b[0] * int(x0[k]) + b[1] * int(st.x[k, 0])
             + b[2] * int(st.x[k, 1]) + b[3] * int(st.y[k, 0])
             + b[4] * int(st.y[k, 1]) for k in range(2 * c)]
    assert any(abs(v) >= 2**63 for v in first)
    for f in (29, 45):
        got = bank_model(ba, f, st, ph, steps, x, plan, d=d, time_chunk=tc,
                         pll_ba=PLL_BA, pll_state=pst)
        if kind == "k13":
            want = fastlo_ddc_bank_block_plain(ba, PLL_BA, st, pst, ph,
                                               steps, x, f, d=d,
                                               time_chunk=tc)
            _same(got, (want[0], want[1], want[3]))
        else:
            want = fastlo_df1_dec_bank_plain(ba, st, ph, steps, x, f, d=d,
                                             time_chunk=tc)
            _same((got[0], got[2]), (want[0], want[2]))


@pytest.mark.parametrize("kind", ["k12", "k13"])
def test_bank_model_tracks_jax_kernels(kind):
    """At c = 128 (the JAX kernel takes channels in 128s) the model, on
    its default plan's roles with 48-row chunks, against the interpret-mode
    JAX kernel, within tests/test_torch_ddc_bank_biquad.py's gates: the
    DF1 x-state within 32, the rms output difference under 1e-5 of the
    signal's; the PLL frequency words within a median of 64 cycles."""
    c, t, d, tc = 128, 256, 16, 128
    rng = np.random.default_rng(84)
    phase0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    plan = bank_plan(c, chunk=48)
    jst = jbiquad.df1_init((2 * c,), jnp.int32)
    jpst, jph = jpll.init((c,)), jnp.asarray(phase0)
    st = biquad.df1_init((2 * c,), device="cpu")
    pst = pll.init((c,), device="cpu") if kind == "k13" else None
    ph = torch.from_numpy(phase0)
    for blk in range(2):
        x = _i32(rng, (t,), -(2**27), 2**27)
        if kind == "k13":
            jst, jpst, jph, jy = j_fastlo_ddc_bank_block(
                BA, jnp.asarray(PLL_BA), jst, jpst, jph, jnp.asarray(steps),
                jnp.asarray(x), 29, d=d, time_chunk=tc, interpret=True)
        else:
            jst, jph, jy = j_fastlo_df1_dec_bank(
                BA, jst, jph, jnp.asarray(steps), jnp.asarray(x), 29, d=d,
                time_chunk=tc, interpret=True)
        st, pst, y = bank_model(BA, 29, st, ph, torch.from_numpy(steps),
                                torch.from_numpy(x), plan, d=d,
                                time_chunk=tc, pll_ba=PLL_BA, pll_state=pst,
                                seed=blk)
        ph = torch.from_numpy(np.array(jph))
        dx = st.x.numpy().astype(np.int64) - np.asarray(jst.x, np.int64)
        assert np.abs(dx).max() <= 32, np.abs(dx).max()
        ya = np.asarray(jy, np.float64)
        yb = y.numpy().astype(np.float64)
        rms_sig = np.sqrt((ya**2).mean()) + 1.0
        assert np.sqrt(((ya - yb) ** 2).mean()) < 1e-5 * rms_sig
        if kind == "k13":
            df = np.abs(pst.f.numpy() - np.asarray(jpst.f, np.int64)) / 2**32
            assert np.median(df) < 64.0, np.median(df)
