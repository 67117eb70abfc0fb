"""The launch plan of K2, K3 and K19-K21 (`filters/ddc_cuda.py`
`launch_plan`), a CPU model of the kernel's schedule
(``csrc/ddc_cascade.cu``) held against the plain versions and the
interpret-mode JAX kernels, and the DF1 sum in the kernel's order; the
same for K14 (`mix_plan`, ``csrc/ddc_mix_df1.cu`` on ``csrc/df1_ring.cuh``'s
depth-0 pipeline).

The kernel runs a CUDA block of one lane tile: a DF1 warp, producer warps
that feed it (K2: the xs rows; K3: the fast-LO mix) and FIR warps that
take each chunk through the half-band stages; chunks pass through an
int32 input ring and stage 0's f32 ring, each slot with a full and an
empty mbarrier.  These tests show:

* the plan's warps, producers, chunk, ring depth, tiles and shared
  memory for the chain's taps at depths 1-3 and `HBF_TAPS` /
  `HBF_TAPS_98` at depths 1-4, c2 from 2 to 2048; a plan the kernel
  cannot run raises ValueError before the library is built;
* a model of the kernel's schedule -- each role the kernel's sequence of
  barrier waits and arrivals chunk by chunk, the roles interleaved in a
  seeded random order, the barriers' phase parities as the PTX defines
  them, every row at the buffer position the kernel computes (stage 0's
  slots behind its carried rows, K7's layout for the later stages, the
  moves and the packed tails) -- equals `df1_hbf_cascade_bank_plain`,
  `df1_clamp_hbf_cascade_bank_plain` and `fastlo_ddc_cascade_bank_plain`
  bit for bit at a kernel chunk other than the caller's time chunk (K3:
  the fine length), and the interpret-mode JAX kernels within the bounds
  of tests/test_torch_clamp.py and tests/test_torch_chain.py;
* the DF1 sum with a1*y1 added last (`df1.cuh` `output_y1_last`), formed
  in wrapping int64, equals `df1.cuh`'s order and JAX `df1_process_q`
  bit for bit with full-range int32 coefficients and states, where the
  sum wraps, with and without the clamp;
* K14's plan (warps, mix and store warps, chunk, ring, shared memory) and
  its refusals; a model of its schedule (tests/torch_pipe_model.py: mix
  warps by row index mod their count, the DF1 warp, store warps, slots
  and parities chunk by chunk) equals `ddc_mix_df1_bank_plain` bit for
  bit, int32 and f32, over two carried blocks, at t under a chunk, one
  chunk and several chunks and a tail, c2 not a multiple of 32, and the
  interpret-mode JAX kernel at c = 128, t = 256.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.design import Filter as JFilter
from idsp_tpu.filters import biquad as jbiquad
from idsp_tpu.filters import hbf as jhbf
from idsp_tpu.filters.ddc_pallas import (
    ddc_mix_df1_bank as j_ddc_mix_df1_bank,
    df1_clamp_hbf_cascade_bank as j_df1_clamp_hbf_cascade_bank,
    df1_hbf_cascade_bank as j_df1_hbf_cascade_bank,
    fastlo_ddc_cascade_bank as j_fastlo_ddc_cascade_bank,
    hbf1_tail_init as j_hbf1_tail_init,
)

from idsp_tpu_torch import _ext, fxp
from idsp_tpu_torch.filters import biquad, ddc_cuda
from idsp_tpu_torch.filters.ddc_cuda import (
    CHUNK,
    LANES,
    MAX_SMEM,
    MIX_PRODUCERS,
    RING,
    WARPS,
    cascade_smem,
    ddc_mix_df1_bank_plain,
    df1_clamp_hbf_cascade_bank_plain,
    df1_hbf_cascade_bank_plain,
    fastlo_ddc_cascade_bank_plain,
    launch_plan,
    mix_plan,
)
from idsp_tpu_torch.filters.pipe_plan import (
    MAX_PIPE_SMEM,
    PIPE_CHUNK,
    PIPE_RING,
    pipe_smem,
)
from idsp_tpu_torch.filters.hbf import HBF_TAPS, HBF_TAPS_98
from idsp_tpu_torch.ops.fastlo import AMPLITUDE, fastlo_tables
from idsp_tpu_torch.ops.trig import cossin
from torch_pipe_model import Bar as _Bar
from torch_pipe_model import df1_rows as _df1_rows
from torch_pipe_model import mix_rows, pipe_model, run_roles

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
CHAIN = (HBF_TAPS[2], HBF_TAPS[1], HBF_TAPS[0])  # the chain's (5, 10, 23)
CLAMP = (1 << 10, -(1 << 23), 1 << 23)  # engages on the mixed stream


def _cascade(table, depth):
    """``depth`` stages of a tap table, highest rate (fewest taps) first."""
    return tuple(table[depth - 1 - d] for d in range(depth))


def _ms(taps):
    return [len(tv) for tv in taps]


def _i32(rng, shape, lo=I32_MIN, hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


BA = jbiquad.quantize_ba(
    jbiquad.from_cookbook(JFilter().critical_frequency(0.02).lowpass()), 29)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------

TAP_SETS = ([("chain", d, CHAIN[:d]) for d in (1, 2, 3)]
            + [("HBF_TAPS", d, _cascade(HBF_TAPS, d)) for d in (1, 2, 3, 4)]
            + [("HBF_TAPS_98", d, _cascade(HBF_TAPS_98, d))
               for d in (1, 2, 3, 4)])


@pytest.mark.parametrize("fastlo", [False, True])
@pytest.mark.parametrize("name,depth,taps", TAP_SETS,
                         ids=[f"{n}-{d}" for n, d, _ in TAP_SETS])
def test_plan_every_tap_set(name, depth, taps, fastlo, no_library):
    ms = _ms(taps)
    for c2 in (2, 4, 50, 200, 512, 1024, 2048):
        p = launch_plan(ms, c2, fastlo=fastlo)
        assert p.warps == WARPS
        assert p.producers == (4 if fastlo else 1)
        assert p.fir_warps == WARPS - WARPS // 4 - p.producers >= 4
        assert p.tiles == -(-c2 // LANES)
        assert p.chunk % (1 << depth) == 0 and p.chunk % p.producers == 0
        assert p.chunk >= max(128, 4 * ms[0] - 3)
        assert 2 <= p.ring <= RING
        assert p.smem == cascade_smem(ms, p.chunk, p.ring) <= MAX_SMEM
        # the most slots that fit
        assert p.ring == RING or cascade_smem(ms, p.chunk,
                                              p.ring + 1) > MAX_SMEM


def test_plan_chain_numbers(no_library):
    """The chain's plan and the kernel's sum by hand: 32 bytes of barriers
    a slot, 2 x 256 int32 input rows, stage 0's 17 carried rows and 2 x
    256 rows, stage 1's 37 + 128, stage 2's 89 + 64, rows of 32 words (a
    third slot would take 236 KB)."""
    p = launch_plan([5, 10, 23], 1024)
    assert (p.chunk, p.ring, p.warps, p.tiles) == (CHUNK, 2, 12, 32)
    assert p.smem == 32 * 2 + (2 * 256 + 17 + 512 + 37 + 128 + 89 + 64) * 128
    assert p.smem == 174016
    assert cascade_smem([5, 10, 23], 256, 3) > MAX_SMEM
    k3 = launch_plan([5, 10, 23], 2048, fastlo=True)
    assert (k3.producers, k3.fir_warps, k3.tiles, k3.smem) == (4, 5, 64,
                                                               p.smem)
    # the producers divide the fine length: one for an odd one, four asked
    assert launch_plan([5], 64, fastlo=True, time_chunk=6).producers == 2
    assert launch_plan([5], 64, fastlo=True, time_chunk=2).producers == 2
    assert launch_plan([5, 10, 23], 64, fastlo=True,
                       producers=2).fir_warps == 7


def test_plan_forced_shapes(no_library):
    p = launch_plan([5, 10, 23], 200, warps=8, chunk=24, ring=2)
    assert (p.warps, p.fir_warps, p.chunk, p.ring, p.tiles) == (
        8, 5, 24, 2, 7)
    assert p.smem == cascade_smem([5, 10, 23], 24, 2)
    big = launch_plan([32, 32, 32, 32], 64)  # 125 carried rows a stage
    assert big.chunk == 256 and big.ring >= 2 and big.smem <= MAX_SMEM
    with pytest.raises(ValueError, match="no ring"):
        launch_plan([32, 32, 32, 32], 64, chunk=512)


@pytest.mark.parametrize("kw,match", [
    (dict(chunk=20), "multiple of 8"),          # not a multiple of 2^3
    (dict(chunk=8), "at least 24"),             # under stage 0's 17 rows
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=1024, ring=4), "more than"),    # 590 KB of rings
    (dict(warps=10), "warps"),
    (dict(warps=20), "warps"),
    (dict(producers=2), "producers"),           # K2 has one
])
def test_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        launch_plan([5, 10, 23], 1024, **kw)


def test_plan_refuses_bad_producers(no_library):
    with pytest.raises(ValueError, match="producers"):
        launch_plan([5, 10, 23], 64, fastlo=True, producers=3)
    with pytest.raises(ValueError, match="producers"):
        launch_plan([5], 64, fastlo=True, time_chunk=6,
                    producers=4)  # 4 does not divide 6


def test_plan_refuses_bad_taps_and_lanes(no_library):
    with pytest.raises(ValueError, match="depth"):
        launch_plan([5] * 5, 64)
    with pytest.raises(ValueError, match="one-sided taps"):
        launch_plan([33], 64)
    with pytest.raises(ValueError, match="c2"):
        launch_plan([5], 0)
    with pytest.raises(ValueError, match="c2"):
        launch_plan([5], 7, fastlo=True)  # I|Q lanes come in pairs


def test_wrappers_refuse_before_the_library(no_library, monkeypatch):
    """On the kernel's path (a tensor that is not on the CPU: here on the
    meta device, its device checks passed over) a call no plan can run
    raises ValueError before anything is built or launched."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    c2, t = 64, 256
    st = biquad.df1_init((c2,), device=meta)
    xs = torch.zeros((t, c2), dtype=torch.int32, device=meta)
    taps33 = (np.ones(33, np.float32),)
    n0 = ddc_cuda.df1_hbf_cascade_bank.launches
    with pytest.raises(ValueError, match="at most 32"):
        ddc_cuda.df1_hbf_cascade_bank(
            BA, st, (torch.zeros((97, c2), device=meta),), xs, taps=taps33)
    tails = tuple(torch.zeros((3 * m - 2, c2), device=meta)
                  for m in (5, 10, 23))
    with pytest.raises(ValueError, match="time_chunk"):
        ddc_cuda.df1_hbf_cascade_bank(BA, st, tails, xs, time_chunk=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        ddc_cuda.df1_hbf_cascade_bank(
            BA, st, tails, xs, _plan=launch_plan([5, 10, 23], c2, chunk=20))
    assert ddc_cuda.df1_hbf_cascade_bank.launches == n0
    # K14: an output type, a shift or a plan it cannot run
    ph = torch.zeros((c2 // 2,), dtype=torch.int32, device=meta)
    x = torch.zeros((t,), dtype=torch.int32, device=meta)
    n0 = ddc_cuda.ddc_mix_df1_bank.launches
    with pytest.raises(ValueError, match="out_dtype"):
        ddc_cuda.ddc_mix_df1_bank(BA, st, ph, ph, x, out_dtype=torch.int64)
    with pytest.raises(ValueError, match="f must be"):
        ddc_cuda.ddc_mix_df1_bank(BA, st, ph, ph, x, 64)
    with pytest.raises(ValueError, match="lanes"):
        ddc_cuda.ddc_mix_df1_bank(BA, st, ph[:0], ph[:0], x)
    assert ddc_cuda.ddc_mix_df1_bank.launches == n0


# ---- a model of the kernel's schedule ---------------------------------------


def _dec_tail(tail, m, r):
    """Carried row r (input row r - (4m-3)) from a packed tail
    (hbf_tile.cuh `dec_tail`)."""
    if r % 2 == 0:
        return tail[r // 2]
    if r >= 2 * m - 1:
        return tail[2 * m - 1 + (r - 2 * m + 1) // 2]
    return torch.zeros_like(tail[0])


def _dec_packed(m, r):
    return 2 * r if r < 2 * m - 1 else 2 * r - 2 * m + 1


def _mix_rows(x, tables, tc, r0, rows):
    """K3's producers: rows r0 .. r0 + rows - 1 mixed with the coarse
    factor of row // tc and the fine factor of row % tc, fastlo.cuh's f32
    operations (the rounding trunc(v + copysign(0.5, v)))."""
    ca, sa, cb, sb = tables
    r = torch.arange(r0, r0 + rows)
    cq, fr = r // tc, r % tc
    xh = (x[r].to(torch.float32) * np.float32(AMPLITUDE))[:, None]
    ca, sa, cb, sb = ca[cq], sa[cq], cb[fr], sb[fr]
    vi = (ca * cb - sa * sb) * xh
    vq = -((sa * cb + ca * sb) * xh)

    def rnd(v):
        return torch.trunc(v + torch.copysign(torch.tensor(0.5), v)).to(
            torch.int32)

    return torch.cat([rnd(vi), rnd(vq)], dim=1)


def _model(ba, f, state, tails, taps, t, c2, plan, *, xs=None, x=None,
           tables=None, tc=None, clamp=None, seed=0):
    """K2 (xs) or K3 (x, tables, tc) as the kernel schedules it: the
    producer, the DF1 warp and the FIR warps as coroutines that yield
    before each mbarrier wait, run in a seeded random order among those
    whose wait passes.  Returns (state, tails, y)."""
    depth, ms = len(taps), _ms(taps)
    K, R = plan.chunk, plan.ring
    carry = [4 * m - 3 for m in ms]
    nan = float("nan")
    buf = [torch.full((carry[d] + (R * K if d == 0 else K >> d), c2), nan)
           for d in range(depth)]
    ring = torch.full((R, K, c2), -1, dtype=torch.int32)
    full_in, empty_in = [_Bar(1) for _ in range(R)], [_Bar(1) for _ in range(R)]
    full0, empty0 = [_Bar(1) for _ in range(R)], [_Bar(1) for _ in range(R)]
    y = torch.full((t >> depth, c2), nan)
    tails_out = [None] * depth
    for d in range(depth):
        for r in range(carry[d]):
            buf[d][r] = _dec_tail(tails[d], ms[d], r)
    w = [torch.tensor(np.asarray(tv, np.float32)) for tv in taps]
    chunks = [(cs, min(cs + K, t)) for cs in range(0, t, K)]
    s = [state.x[:, 0].to(torch.int64), state.x[:, 1].to(torch.int64),
         state.y[:, 0].to(torch.int64), state.y[:, 1].to(torch.int64)]

    def producer():
        for q, (cs, ce) in enumerate(chunks):
            k, ph = q % R, (q // R) & 1
            yield lambda: empty_in[k].passes(ph ^ 1)
            ring[k, :ce - cs] = (xs[cs:ce] if x is None else
                                 _mix_rows(x, tables, tc, cs, ce - cs))
            full_in[k].arrive()

    def df1():
        for q, (cs, ce) in enumerate(chunks):
            k, ph = q % R, (q // R) & 1
            yield lambda: full_in[k].passes(ph)
            yield lambda: empty0[k].passes(ph ^ 1)
            ys = _df1_rows(ba, f, s, ring[k, :ce - cs], clamp)
            buf[0][carry[0] + k * K:carry[0] + k * K + ce - cs] = ys.to(
                torch.float32)
            full0[k].arrive()
            empty_in[k].arrive()

    def sd(d, k, cs):  # stage d's input row v at row sd + v of its buffer
        return carry[0] + k * K - cs if d == 0 else carry[d] - (cs >> d)

    def fir():
        k_last = cs_last = 0
        for q, (cs, ce) in enumerate(chunks):
            k, ph = q % R, (q // R) & 1
            more = ce < t
            yield lambda: full0[k].passes(ph)
            for d in range(depth):
                m, si = ms[d], sd(d, k, cs)
                j = torch.arange(cs >> (d + 1), ce >> (d + 1))
                lo, hi = 2 * j - 4 * m + 3 + si, 2 * j + 1 + si
                b = buf[d]
                acc = (b[hi] + b[lo]) * w[d][0]
                for i in range(1, m):
                    acc = acc + (b[hi - 2 * i] + b[lo + 2 * i]) * w[d][i]
                out = acc + b[lo + 2 * m - 1]
                if d + 1 < depth:
                    buf[d + 1][sd(d + 1, k, cs) + j] = out
                else:
                    y[j] = out
                if d == 0:
                    if k > 0:
                        empty0[k - 1].arrive()
                    if more and k == R - 1:
                        b[:carry[0]] = b[R * K:R * K + carry[0]].clone()
                        empty0[k].arrive()
                elif more:
                    n = (ce - cs) >> d
                    b[:carry[d]] = b[n:n + carry[d]].clone()
            k_last, cs_last = k, cs
        for d in range(depth):
            sl = sd(d, k_last, cs_last) + (t >> d) - carry[d]
            tails_out[d] = torch.stack([buf[d][sl + _dec_packed(ms[d], r)]
                                        for r in range(3 * ms[d] - 2)])

    run_roles([producer(), df1(), fir()], seed)
    x1, x2, y1, y2 = s
    new = biquad.Df1State(
        x=torch.stack([x1, x2], 1).to(torch.int32),
        y=torch.stack([y1, y2], 1).to(torch.int32))
    return new, tuple(tails_out), y


def _same(got, want):
    for a, b in zip(got, want, strict=True):
        if isinstance(a, biquad.Df1State):
            assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
        elif isinstance(a, tuple):
            _same(a, b)
        else:
            assert a.shape == b.shape
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _start(rng, taps, c2):
    st = biquad.Df1State(x=torch.from_numpy(_i32(rng, (c2, 2), -(2**26),
                                                 2**26)),
                         y=torch.from_numpy(_i32(rng, (c2, 2), -(2**26),
                                                 2**26)))
    tails = tuple(torch.from_numpy(
        (rng.normal(size=(3 * len(tv) - 2, c2)) * 1e6).astype(np.float32))
        for tv in taps)
    return st, tails


K2_CASES = [
    # (taps, c2, t, chunk, ring, clamp)
    (CHAIN, 8, 256, 64, 2, None),             # caller chunk 128, kernel 64
    (CHAIN, 6, 5 * 24 + 8, 24, 3, None),      # t not a multiple of 3 x 24
    (CHAIN, 4, 24, 24, 4, None),              # t = one chunk
    (CHAIN, 4, 8, 24, 2, None),               # t under a chunk
    (CHAIN, 4, 0, 24, 2, None),               # no rows: tails pass through
    (CHAIN, 8, 256, 32, 3, CLAMP),            # K19
    (CHAIN[:1], 8, 136, 20, 2, None),         # K20
    (CHAIN[:2], 8, 200, 20, 4, (5, 100, -100)),  # K21, lo > hi: clamp to hi
    (_cascade(HBF_TAPS_98, 4), 4, 256, 64, 2, None),
    (_cascade(HBF_TAPS, 4), 4, 192, 16, 3, None),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("taps,c2,t,chunk,ring,clamp", K2_CASES)
def test_schedule_model_equals_plain_k2_k19(taps, c2, t, chunk, ring, clamp,
                                            seed):
    rng = np.random.default_rng(100 + seed)
    plan = launch_plan(_ms(taps), c2, chunk=chunk, ring=ring)
    st, tails = _start(rng, taps, c2)
    ps, pt = st, tails
    for _ in range(2):  # two carried blocks
        xs = torch.from_numpy(_i32(rng, (t, c2), -(2**27), 2**27))
        st, tails, y = _model(BA, 29, st, tails, taps, t, c2, plan, xs=xs,
                              clamp=clamp, seed=seed)
        if clamp is None:
            ps, pt, py = df1_hbf_cascade_bank_plain(BA, ps, pt, xs, 29,
                                                    taps=taps)
        else:
            u, lo, hi = clamp
            ps, pt, py = df1_clamp_hbf_cascade_bank_plain(
                BA, ps, pt, xs, 29, u=u, lo=lo, hi=hi, taps=taps)
        _same((st, tails, y), (ps, pt, py))


@pytest.mark.parametrize("tc,chunk,ring", [(32, 64, 2), (128, 48, 3),
                                           (8, 24, 2)])
@pytest.mark.parametrize("clamp", [None, CLAMP])
def test_schedule_model_equals_plain_k3(tc, chunk, ring, clamp):
    """K3 with a fine length other than the kernel's chunk."""
    rng = np.random.default_rng(7)
    c, t = 4, 384
    c2 = 2 * c
    plan = launch_plan([5, 10, 23], c2, fastlo=True, chunk=chunk, ring=ring)
    st, tails = _start(rng, CHAIN, c2)
    ps, pt = st, tails
    ph = torch.from_numpy(_i32(rng, (c,)))
    steps = torch.from_numpy(_i32(rng, (c,), 1 << 24, 1 << 30))
    pph = ph
    for _ in range(2):
        x = torch.from_numpy(_i32(rng, (t,), -(2**30), 2**30))
        tables = fastlo_tables(ph, steps, t, tc)
        st, tails, y = _model(BA, 29, st, tails, CHAIN, t, c2, plan, x=x,
                              tables=tables, tc=tc, clamp=clamp)
        ph = ph + steps * t
        ps, pt, pph, py = fastlo_ddc_cascade_bank_plain(
            BA, ps, pt, pph, steps, x, 29, clamp=clamp, taps=CHAIN,
            time_chunk=tc)
        _same((st, tails, y), (ps, pt, py))


def _bound(k, ys):
    return k * np.spacing(np.float32(np.abs(np.asarray(ys)).max()))


@pytest.mark.parametrize("clamp", [None, (1 << 10, -(1 << 26), 1 << 26)])
def test_schedule_model_vs_jax_kernels(clamp):
    """K2 / K19 as modelled against the interpret-mode JAX kernels: state
    bit for bit, outputs and tails within 16 ULP of the DF1 scale (the
    bound of tests/test_torch_clamp.py and tests/test_torch_chain.py)."""
    c2, t = 128, 256  # the JAX kernels take lanes in 128s
    rng = np.random.default_rng(61)
    plan = launch_plan([5, 10, 23], c2, chunk=64, ring=2)
    jst = jbiquad.df1_init((c2,), jnp.int32)
    jtails = tuple(j_hbf1_tail_init(c2, len(tv)) for tv in CHAIN)
    st = biquad.df1_init((c2,), device=torch.device("cpu"))
    tails = tuple(torch.zeros((3 * len(tv) - 2, c2)) for tv in CHAIN)
    for _ in range(2):
        xs = _i32(rng, (t, c2), -(2**28), 2**28)
        _, ys = biquad.df1_process_q(BA, 29, st, torch.from_numpy(xs),
                                     clamp=clamp)
        if clamp is None:
            jst, jtails, jy = j_df1_hbf_cascade_bank(
                jnp.asarray(BA), jst, jtails, jnp.asarray(xs), 29,
                taps=CHAIN, time_chunk=128, interpret=True)
        else:
            u, lo, hi = clamp
            jst, jtails, jy = j_df1_clamp_hbf_cascade_bank(
                jnp.asarray(BA), jst, jtails, jnp.asarray(xs), 29, u=u,
                lo=lo, hi=hi, taps=CHAIN, time_chunk=128, interpret=True)
        st, tails, y = _model(BA, 29, st, tails, CHAIN, t, c2, plan,
                              xs=torch.from_numpy(xs), clamp=clamp)
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
        np.testing.assert_array_equal(st.y.numpy(), np.asarray(jst.y))
        bound = _bound(16, ys.numpy())
        assert tuple(y.shape) == jy.shape
        assert np.abs(y.numpy() - np.asarray(jy)).max() <= bound
        for a, b in zip(tails, jtails):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= bound


def test_schedule_model_k3_vs_jax_kernel():
    """K3 as modelled (kernel chunk 64, fine length 128) against the
    interpret-mode JAX kernel with the fast-mix gates of
    tests/test_biquad_pallas.py:1049-1055 (the two frameworks' f32 mixes
    differ by ULPs)."""
    c, t, tc = 128, 256, 128  # the JAX kernel takes channels in 128s
    c2 = 2 * c
    rng = np.random.default_rng(62)
    plan = launch_plan([5, 10, 23], c2, fastlo=True, chunk=64, ring=3)
    p0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    jst = jbiquad.df1_init((c2,), jnp.int32)
    jtails = tuple(j_hbf1_tail_init(c2, len(tv)) for tv in CHAIN)
    st = biquad.df1_init((c2,), device=torch.device("cpu"))
    tails = tuple(torch.zeros((3 * len(tv) - 2, c2)) for tv in CHAIN)
    jph, ph = jnp.asarray(p0), torch.from_numpy(p0)
    stp = torch.from_numpy(steps)
    for _ in range(2):
        x = _i32(rng, (t,), -(2**27), 2**27)
        jst, jtails, jph, jy = j_fastlo_ddc_cascade_bank(
            jnp.asarray(BA), jst, jtails, jph, jnp.asarray(steps),
            jnp.asarray(x), 29, taps=CHAIN, time_chunk=tc, interpret=True)
        st, tails, y = _model(BA, 29, st, tails, CHAIN, t, c2, plan,
                              x=torch.from_numpy(x),
                              tables=fastlo_tables(ph, stp, t, tc), tc=tc)
        ph = ph + stp * t
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jph))
        dx = st.x.numpy().astype(np.int64) - np.asarray(jst.x, np.int64)
        assert np.abs(dx).max() <= 32, np.abs(dx).max()
        ya = np.asarray(jy, np.float64)
        yb = y.double().numpy()
        rms_sig = np.sqrt((ya**2).mean()) + 1.0
        assert np.sqrt(((ya - yb) ** 2).mean()) < 1e-5 * rms_sig


# ---- the DF1 sum in the kernel's order --------------------------------------


def _wrap64(v):
    """Python int -> int64 two's complement."""
    return (v + 2**63) % 2**64 - 2**63


@pytest.mark.parametrize("clamp", [None, (I32_MAX - 7, I32_MIN, I32_MAX),
                                   (12345, -(2**28), 2**28)])
def test_df1_sum_with_a1_y1_last_is_bitexact(clamp):
    """Full-range int32 coefficients, states and inputs (five products
    near 2^62: the sum wraps int64): the kernel's order, df1.cuh's order
    (b0 x0 + b1 x1 + b2 x2 + a1 y1 + a2 y2, checked exactly in Python
    integers) and JAX `df1_process_q` (clamped: `clamp_step` scanned)
    give the same words."""
    rng = np.random.default_rng(5)
    lanes, t = 256, 64
    ba = _i32(rng, (5,))
    ba[:2] = [I32_MIN, I32_MAX]  # the extremes
    x0 = _i32(rng, (lanes, 2))
    y0 = _i32(rng, (lanes, 2))
    xs = _i32(rng, (t, lanes))
    s = [torch.from_numpy(v).to(torch.int64)
         for v in (x0[:, 0], x0[:, 1], y0[:, 0], y0[:, 1])]
    ys = _df1_rows(ba, 29, s, torch.from_numpy(xs), clamp)

    # df1.cuh's order in exact integers, wrapped once at the end
    b0, b1, b2, a1, a2 = (int(v) for v in ba)
    want = np.zeros((t, lanes), np.int64)
    wrapped = 0
    for ln in range(lanes):
        x1, x2, y1, y2 = (int(x0[ln, 0]), int(x0[ln, 1]), int(y0[ln, 0]),
                          int(y0[ln, 1]))
        for r in range(t):
            xv = int(xs[r, ln])
            acc = b0 * xv + b1 * x1 + b2 * x2 + a1 * y1 + a2 * y2
            wrapped += acc != _wrap64(acc)
            v = _wrap64(_wrap64(acc) >> 29)
            v = (v + 2**31) % 2**32 - 2**31  # the low 32 bits
            if clamp is not None:
                u, lo, hi = clamp
                v = (v + u + 2**31) % 2**32 - 2**31
                v = min(max(v, lo), hi)
            x2, x1, y2, y1 = x1, xv, y1, v
            want[r, ln] = v
    assert wrapped > 0
    np.testing.assert_array_equal(ys.numpy(), want)

    jst = jbiquad.Df1State(x=jnp.asarray(x0), y=jnp.asarray(y0))
    jba = jnp.asarray(ba)
    if clamp is None:
        _, jys = jbiquad.df1_process_q(jba, 29, jst, jnp.asarray(xs))
    else:
        u, lo, hi = clamp
        _, jys = jax.lax.scan(
            lambda st, xv: jbiquad.clamp_step(
                jbiquad.df1_step_q(jba, 29, st, xv), u, lo, hi),
            jst, jnp.asarray(xs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))


# ---- K14: the depth-0 pipeline ----------------------------------------------


def test_mix_plan_defaults(no_library):
    """MIX_PRODUCERS mix warps and a store warp in the fewest warps that
    hold them beside the DF1 warp's scheduler, PIPE_CHUNK rows, the most
    slots that fit: 3 of 256 rows, 32 bytes of barriers a slot and two
    rings of 128-byte rows (a fourth slot would take 256 KB)."""
    for c2 in (2, 50, 100, 1024, 2048):
        p = mix_plan(c2)
        assert (p.warps, p.producers, p.chunk, p.ring) == (
            8, MIX_PRODUCERS, PIPE_CHUNK, PIPE_RING)
        assert p.producers + 1 <= p.warps - p.warps // 4
        assert p.tiles == -(-c2 // LANES)
        assert p.smem == pipe_smem(p.chunk, p.ring) <= MAX_PIPE_SMEM
    assert pipe_smem(256, 3) == 32 * 3 + 2 * 3 * 256 * 128 == 196704
    assert pipe_smem(256, 4) > MAX_PIPE_SMEM == MAX_SMEM - 1024
    # the fewest warps: 3 roles a scheduler off the DF1 warp's
    assert [mix_plan(64, producers=p).warps for p in (1, 2, 3, 5, 8, 11)] == [
        4, 4, 8, 8, 12, 16]
    assert mix_plan(64, chunk=384).ring == 2
    forced = mix_plan(200, warps=16, producers=3, chunk=24, ring=4)
    assert (forced.warps, forced.tiles, forced.smem) == (
        16, 7, pipe_smem(24, 4))


@pytest.mark.parametrize("kw,match", [
    (dict(producers=0), "producers"),
    (dict(producers=12), "warps"),            # 13 roles: 20 warps
    (dict(warps=8, producers=6), "warps"),    # 7 roles in 6 places
    (dict(warps=6), "warps"),
    (dict(warps=20, producers=13), "warps"),
    (dict(chunk=0), "chunk"),
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=512, ring=3), "more than"),   # 393 KB of rings
    (dict(chunk=2048), "no ring"),
    (dict(cluster=2), "one CTA"),               # K15's partner CTA only
    (dict(cluster=3), "cluster"),
])
def test_mix_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        mix_plan(1024, **kw)
    with pytest.raises(ValueError, match="lanes"):
        mix_plan(0)


def _wrap32(v):
    return ((v + 2**31) % 2**32 - 2**31).to(torch.int32)


def _k14_produce(x, phase0, steps):
    """K14's mix warps, row by row as the kernel forms it: the LO of row i
    at phase0 + steps*(i+1) (wrapping), g = cos (I) or -sin (Q, int32
    negation), the high word of the exact product g*x (`__mulhi`)."""
    i64 = torch.int64

    def produce(r0, idx):
        rows = (r0 + idx).to(i64)
        ph = _wrap32(phase0.to(i64)[None, :]
                     + steps.to(i64)[None, :] * (rows[:, None] + 1))
        co, si = cossin(ph)
        g = torch.cat([co.to(i64), _wrap32(-si.to(i64)).to(i64)], dim=1)
        return ((g * x[rows].to(i64)[:, None]) >> 32).to(torch.int32)

    return produce


K14_CASES = [
    # (c, t, plan keywords): lanes 2c
    (16, 40, dict(chunk=64)),                               # t under a chunk
    (20, 48, dict(chunk=48, ring=2)),                       # t = one chunk
    (25, 3 * 32 + 13, dict(chunk=32, ring=2, producers=3)),
    (8, 5 * 24 + 7, dict(chunk=24, ring=3)),                # 5 mix warps
    (36, 200, dict(chunk=16, ring=4, producers=1)),
    (40, 130, dict(chunk=20, ring=2, producers=11)),
    (6, 0, dict(chunk=16)),                                 # no rows
]


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("c,t,kw", K14_CASES)
def test_k14_schedule_model_equals_plain(c, t, kw, out_dtype):
    """Two carried blocks; c2 = 40, 50, 72 and 80 are not multiples of the
    32-lane tile, c2 = 50 takes 4-byte stores."""
    rng = np.random.default_rng(300 + c)
    plan = mix_plan(2 * c, **kw)
    st = biquad.Df1State(x=torch.from_numpy(_i32(rng, (2 * c, 2))),
                         y=torch.from_numpy(_i32(rng, (2 * c, 2), -(2**28),
                                                 2**28)))
    ph = torch.from_numpy(_i32(rng, (c,)))
    steps = torch.from_numpy(_i32(rng, (c,)))  # every LO octant
    ps, pph = st, ph
    for blk in range(2):
        x = torch.from_numpy(_i32(rng, (t,)))
        st, y = pipe_model(BA, 29, st, t, 2 * c, plan,
                           _k14_produce(x, ph, steps), mix_rows,
                           out_dtype=out_dtype or torch.int32, seed=blk)
        ph = _wrap32(ph.to(torch.int64) + steps.to(torch.int64) * t)
        ps, pph, py = ddc_mix_df1_bank_plain(BA, ps, pph, steps, x, 29,
                                             out_dtype=out_dtype)
        _same((st, ph, y), (ps, pph, py))


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_k14_schedule_model_vs_jax_kernel(out_dtype):
    """K14 as modelled (the default plan's roles, 64-row chunks) against
    the interpret-mode JAX kernel, as tests/test_torch_ddc_bank_biquad.py
    holds the plain version: state, phase and output bit for bit."""
    c, t = 128, 256  # the JAX kernel takes channels in 128s
    rng = np.random.default_rng(86)
    phase0 = _i32(rng, (c,))
    steps = _i32(rng, (c,), 1 << 24, 1 << 30)
    x = _i32(rng, (t,))
    sx, sy = _i32(rng, (2 * c, 2)), _i32(rng, (2 * c, 2), -(2**28), 2**28)
    jst, jph, jy = j_ddc_mix_df1_bank(
        jnp.asarray(BA), jbiquad.Df1State(x=jnp.asarray(sx),
                                          y=jnp.asarray(sy)),
        jnp.asarray(phase0), jnp.asarray(steps), jnp.asarray(x), 29,
        time_chunk=128, lookup="select", interpret=True,
        out_dtype=jnp.int32 if out_dtype is None else jnp.float32)
    st, y = pipe_model(
        BA, 29, biquad.Df1State(x=torch.from_numpy(sx),
                                y=torch.from_numpy(sy)), t, 2 * c,
        mix_plan(2 * c, chunk=64),
        _k14_produce(torch.from_numpy(x), torch.from_numpy(phase0),
                     torch.from_numpy(steps)), mix_rows,
        out_dtype=out_dtype or torch.int32)
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
    np.testing.assert_array_equal(st.y.numpy(), np.asarray(jst.y))
    np.testing.assert_array_equal(
        fxp.wrap_i32(torch.from_numpy(phase0).to(torch.int64)
                     + torch.from_numpy(steps).to(torch.int64) * t).numpy(),
        np.asarray(jph))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
