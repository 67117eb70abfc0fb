"""K37 `rpll_bank`'s launch plan (`filters/rpll_cuda.py` `rpll_plan`) and a
CPU model of its schedule (``csrc/structures_bank.cu`` on
``csrc/df1_ring.cuh``'s depth-0 pipeline), held against the plain version
and the interpret-mode JAX kernel.

The kernel runs a CUDA block of one 32-lane tile: producer warps, each a
span of every chunk, that write each row's (x, dt | valid << 31) into the
serial warp's input ring, the serial warp that carries the last valid
timestamp and runs the ff / f / y chain into (phase, frequency) words,
and a store warp that writes the two planes.  These tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory at
  1024, 200, 50 and 1 lanes, and the plans and calls it refuses before
  the library is asked for;
* a model of the schedule (tests/torch_pipe_model.py: the producers by
  spans, the serial warp, the store warp, the slots and parities chunk by chunk, the
  roles interleaved at random), with the kernel's words and arithmetic
  (the product's `>> sf` in the regime the host picks), equals
  `rpll_bank_plain` bit for bit over carried blocks: at chunk edges, t = 1
  and t under a chunk, a whole chunk without a valid row, every row
  valid, timestamps that wrap around 2^32, and sf below, at and above 32;
* at c = 128 the model equals the interpret-mode JAX kernel
  `rpll_pallas.rpll_bank` bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import rpll as jrpll
from idsp_tpu.filters.rpll_pallas import rpll_bank as jrpll_bank

from idsp_tpu_torch import _ext
from idsp_tpu_torch.filters import rpll, rpll_cuda
from idsp_tpu_torch.filters.pipe_plan import (
    LANES,
    MAX_PIPE_SMEM,
    PIPE_RING,
    pipe_smem,
)
from idsp_tpu_torch.filters.rpll_cuda import (
    RPLL_PRODUCERS,
    rpll_bank_plain,
    rpll_plan,
)
from torch_pipe_model import pipe_run, span_rows

U32 = np.uint64(0xFFFFFFFF)


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------


@pytest.mark.parametrize("c", [1024, 200, 50, 1])
def test_rpll_plan_defaults(c, no_library):
    """RPLL_PRODUCERS producer warps and the store warp beside the serial
    warp in 8 warps; two words a row and lane each way, so 128-row chunks
    in PIPE_RING slots (196704 bytes); one CTA a tile."""
    p = rpll_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        8, RPLL_PRODUCERS, 128, PIPE_RING, 1)
    assert (p.win, p.wout) == (2, 2)
    assert p.tiles == -(-c // LANES)
    assert p.smem == pipe_smem(128, PIPE_RING, 2, 2) == 196704
    assert p.smem <= MAX_PIPE_SMEM
    forced = rpll_plan(c, producers=11, warps=16, chunk=64, ring=7)
    assert (forced.warps, forced.chunk, forced.ring) == (16, 64, 7)
    assert rpll_plan(c, producers=1).warps == 4
    assert forced.smem == 32 * 7 + 7 * 64 * LANES * 4 * 4 <= MAX_PIPE_SMEM


@pytest.mark.parametrize("kw,match", [
    (dict(producers=0), "producers"),
    (dict(cluster=2), "one CTA"),
    (dict(warps=8, producers=6), "warps"),   # 7 roles in 6 places
    (dict(chunk=0), "chunk"),
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=64, ring=8), "more than"),
    (dict(chunk=512), "no ring"),
])
def test_rpll_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        rpll_plan(1024, **kw)
    with pytest.raises(ValueError, match="lanes"):
        rpll_plan(0)


def test_wrapper_refuses_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    st = rpll.init((64,), device=meta)
    xs = torch.zeros((8, 64), dtype=torch.int32, device=meta)
    v = torch.zeros((8, 64), dtype=torch.bool, device=meta)
    n0 = rpll_cuda.rpll_bank.launches
    with pytest.raises(ValueError, match="unsupported"):
        rpll_cuda.rpll_bank(rpll.RpllConfig(8, 41, 11), st, xs, v)
    with pytest.raises(ValueError, match="lanes"):
        rpll_cuda.rpll_bank(rpll.RpllConfig(8, 12, 11), st, xs[:, :0],
                            v[:, :0])
    with pytest.raises(ValueError, match="warps"):
        rpll_cuda.rpll_bank(rpll.RpllConfig(8, 12, 11), st, xs, v,
                            _plan=rpll_plan(64, warps=4, producers=3))
    assert rpll_cuda.rpll_bank.launches == n0


# ---- a model of the kernel's schedule ---------------------------------------


def _model(cfg, state, xs, valids, plan, seed):
    """K37 as the kernel runs it: the producers' words, the serial warp's
    last valid timestamp and u32 / u64 arithmetic (numpy words), the two
    planes from the output words; returns (RpllState, (phase, freq)) like
    `rpll_bank_plain`."""
    t, c = xs.shape
    dt2, sf, sp = cfg.dt2, cfg.shift_frequency, cfg.shift_phase
    mask = np.uint64((1 << dt2) - 1)
    bias = np.uint64(1 << (sf - 1))
    p_ref = np.uint64((1 << (32 + dt2 - sf)) & 0xFFFFFFFF)
    x = xs.numpy().astype(np.uint32).astype(np.uint64)
    v = valids.numpy().astype(np.uint64)
    x_prev = state.x.numpy().astype(np.uint32).astype(np.uint64)
    ff, f, y = (w.numpy().astype(np.uint32).astype(np.uint64)
                for w in (state.ff, state.f, state.y))

    def produce(r0, idx):  # every row on its own
        xr, vr = x[r0 + idx], v[r0 + idx]
        return np.stack([xr, ((np.uint64(2**32) - xr) & mask) | (vr << 31)],
                        axis=-1).astype(np.int64)

    def serial(words):
        nonlocal x_prev, ff, f, y
        out = np.empty((len(words), c, 2), np.int64)
        for j, w in enumerate(words.astype(np.uint64)):
            xr, dtv = w[:, 0], w[:, 1]
            valid = (dtv >> np.uint64(31)) == 1
            dx = (xr - x_prev) & U32
            x_prev = np.where(valid, xr, x_prev)
            y = (y + f) & U32
            p64 = ff * dx + bias  # mad.wide.u32, mod 2^64
            hi = p64 >> np.uint64(32)
            if sf < 32:  # the funnel shift of the product's words
                p_sig = (((hi << np.uint64(32)) | (p64 & U32))
                         >> np.uint64(sf)) & U32
            elif sf == 32:
                p_sig = hi
            else:
                p_sig = hi >> np.uint64(sf - 32)
            ff2 = (ff + ((p_ref - p_sig) & U32)) & U32
            y_ref = ((f >> np.uint64(dt2)) * (dtv & np.uint64(0x7FFFFFFF))
                     ) & U32
            d = ((y_ref - y) & U32).astype(np.uint32).view(np.int32)
            dy = (d >> (sp - dt2)).astype(np.int64).astype(np.uint64) & U32
            f2 = (ff2 + dy) & U32
            ff = np.where(valid, ff2, ff)
            f = np.where(valid, f2, f)
            out[j, :, 0], out[j, :, 1] = y, f
        return out

    words = pipe_run(t, c, plan, produce, span_rows, serial, seed=seed)

    def i32(w):
        return torch.from_numpy(np.asarray(w, np.uint64).astype(np.uint32)
                                .view(np.int32))

    new = rpll.RpllState(x=i32(x_prev), ff=i32(ff), f=i32(f), y=i32(y))
    return new, (i32(words[..., 0]), i32(words[..., 1]))


def _same(got, want):
    (gs, (gp, gf)), (ws, (wp, wf)) = got, want
    assert torch.equal(gp, wp)
    assert torch.equal(gf, wf)
    for a, b in zip(gs, ws, strict=True):
        assert torch.equal(a, b)


def _streams(rng, t, c, kind):
    """(xs, valids) of a block: random timestamps 1 in 4 valid, rising
    timestamps that wrap around 2^32 (steps up to 2^28), every row valid,
    or a chunk-long gap without a valid row."""
    if kind == "wrapping":
        xs = np.cumsum(rng.integers(0, 2**28, (t, c)), 0) + \
            rng.integers(0, 2**32, c)
        xs = xs.astype(np.uint64).astype(np.uint32).view(np.int32)
    else:
        xs = _i32(rng, (t, c))
    valids = rng.random((t, c)) < (1.0 if kind == "all valid" else 0.25)
    if kind == "gap":
        valids[t // 4: t // 4 + 24] = False
    return torch.from_numpy(xs), torch.from_numpy(valids)


K37_CASES = [
    # (c, t, plan keywords, stream kind)
    (16, 40, dict(chunk=64), "random"),                   # t under a chunk
    (20, 48, dict(chunk=48, ring=2), "random"),           # t = one chunk
    (37, 3 * 20 + 9, dict(chunk=20, ring=2, producers=3), "wrapping"),
    (8, 5 * 24 + 7, dict(chunk=24, ring=3, producers=1), "all valid"),
    (40, 100, dict(chunk=16, ring=4), "gap"),             # a whole chunk
    (36, 70, dict(chunk=8, ring=7, producers=11, warps=16), "gap"),
    (12, 30, dict(chunk=1, ring=2), "random"),            # empty spans
    (5, 1, dict(chunk=8), "random"),                      # t = 1
]


@pytest.mark.parametrize("sf", [9, 12, 32, 36, 40])
@pytest.mark.parametrize("c,t,kw,kind", K37_CASES)
def test_k37_schedule_model_equals_plain(c, t, kw, kind, sf):
    """Two carried blocks from a random state (x, ff, f and y full range);
    c = 20, 36, 37 and 40 are not multiples of the 32-lane tile."""
    rng = np.random.default_rng(500 + c + sf)
    cfg = rpll.RpllConfig(dt2=8, shift_frequency=sf, shift_phase=11)
    plan = rpll_plan(c, **kw)
    st = rpll.RpllState(*(torch.from_numpy(_i32(rng, (c,)))
                          for _ in range(4)))
    ps = st
    for blk in range(2):
        xs, valids = _streams(rng, t, c, kind)
        got = _model(cfg, st, xs, valids, plan, seed=blk)
        want = rpll_bank_plain(cfg, ps, xs, valids)
        _same(got, want)
        st, ps = got[0], want[0]


def test_k37_gap_keeps_the_last_valid_timestamp():
    """A block whose only valid row is in its first chunk, a block without
    one, then a valid row: dx of that row is taken against the first
    block's timestamp, across chunks and blocks."""
    c, t = 32, 64
    cfg = rpll.RpllConfig(dt2=8, shift_frequency=12, shift_phase=11)
    plan = rpll_plan(c, chunk=16)
    rng = np.random.default_rng(7)
    st = ps = rpll.init((c,), device=torch.device("cpu"))
    for blk, row in enumerate((3, None, 50)):
        xs = torch.from_numpy(_i32(rng, (t, c)))
        valids = torch.zeros((t, c), dtype=torch.bool)
        if row is not None:
            valids[row] = True
            last = xs[row]
        got = _model(cfg, st, xs, valids, plan, seed=blk)
        want = rpll_bank_plain(cfg, ps, xs, valids)
        _same(got, want)
        st, ps = got[0], want[0]
        assert torch.equal(st.x, last)


def test_k37_schedule_model_equals_interpret_kernel():
    """The default plan's roles at 64-row chunks against the interpret-mode
    JAX kernel over two carried blocks, from the state the JAX package
    starts a stream with: outputs and state bit for bit."""
    c, t = 128, 192
    rng = np.random.default_rng(37)
    cfg = rpll.RpllConfig(dt2=8, shift_frequency=12, shift_phase=11)
    jcfg = jrpll.RpllConfig(dt2=8, shift_frequency=12, shift_phase=11)
    plan = rpll_plan(c, chunk=64)
    jst = jrpll.init((c,))
    st = rpll.init((c,), device=torch.device("cpu"))
    for blk in range(2):
        xs, valids = _streams(rng, t, c, "wrapping")
        jst, (jph, jfr) = jrpll_bank(jcfg, jst, jnp.asarray(xs.numpy()),
                                     jnp.asarray(valids.numpy()),
                                     time_chunk=64, interpret=True)
        st, (ph, fr) = _model(cfg, st, xs, valids, plan, seed=blk)
        for got, want in ((ph, jph), (fr, jfr)):  # u32 or i32 bit patterns
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want).view(np.uint32))
    for got, want in zip(st, (jst.x, jst.ff, jst.f, jst.y), strict=True):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
