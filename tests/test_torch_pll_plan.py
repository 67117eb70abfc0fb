"""K5 `pll_bank`: its launch plan (`filters/pll_cuda.py` `pll_plan`) and a
CPU model of its schedule (``csrc/pll_bank.cu`` on ``csrc/df1_ring.cuh``'s
depth-0 pipeline, the serial warp ``csrc/pll.cuh`` `PllSerial`), held
against the plain version and the interpret-mode JAX kernel.

K5's CUDA block is a tile of 32 channels: producer warps copy the phase
rows by spans into the serial warp's input ring, the serial warp runs the
PLL with its sums regrouped mod 2^32 and 2^64 -- a = x + y, b = a - x0,
V = (f0 + b1 y0 + a1 hi(f0)) + (a1 lo(f0)) >> 32 and W = f + V off the
chain; xi = a + hi(f), delta = b + hi(f), s = cl + wrap, y0 picked by s's
sign among three candidates and f = b0 y0 + W on it -- and the store warp
writes every row.  These tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory at
  1024, 200, 50 and 1 channels, and the plans and calls it refuses before
  the library is asked for;
* the regrouped step (tests/torch_pipe_model.py `pll_rows`) equals
  `pll.step` bit for bit at the edges: every sum wrapping (int32 and
  int64), s taking each of -2..2, a1 = INT32_MIN and a1 > 0, f0's low
  word 0xFFFFFFFF;
* the model of the schedule (`pll_model`; roles interleaved at random over
  the mbarrier parities) equals `pll_bank_plain` bit for bit over carried
  blocks: t = 0, 1, under a chunk and not a multiple of it, 2-11
  producers, c not a multiple of 4 or of the tile;
* `pll_bank_plain` equals the interpret-mode JAX kernel
  (`idsp_tpu.filters.pll_pallas.pll_bank`) at c = 128 from a random state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.filters import pll as jpll
from idsp_tpu.filters.pll_pallas import pll_bank as j_pll_bank

from idsp_tpu_torch import _ext
from idsp_tpu_torch.convert import to_numpy
from idsp_tpu_torch.filters import pll, pll_cuda
from idsp_tpu_torch.filters.pipe_plan import (
    MAX_PIPE_SMEM,
    PIPE_CHUNK,
    PIPE_RING,
    pipe_smem,
)
from idsp_tpu_torch.filters.pll_cuda import (
    PLL_PRODUCERS,
    pll_bank_plain,
    pll_plan,
)
from idsp_tpu_torch.ops.unwrap import ClampWrapState
from torch_pipe_model import pll_model, pll_rows, pll_state, pll_words

I32 = (-(2**31), 2**31 - 1)
I64 = (-(2**63), 2**63 - 1)
# the #5 bank's loop, coefficients at int32's ends (a1 = INT32_MIN, a1 > 0)
COEFS = {"bank": tuple(int(v) for v in
                       pll.coefficients_from_bandwidth(2e-2, 4.0)),
         "edge": (I32[0], I32[1], I32[0]),
         "mixed": (I32[1], I32[0], 2**30 + 12345),
         "wide": tuple(int(v) for v in
                       pll.coefficients_from_bandwidth(0.2, 2.0))}


def _i32(rng, shape, lo=I32[0], hi=I32[1] + 1):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _edge_i64(rng, shape):
    """int64 words within 2^40 of int64's ends, or of 0, each third."""
    base = rng.choice(np.array([I64[0], 0, I64[1]], np.int64), shape)
    off = rng.integers(0, 2**40, shape, dtype=np.int64)
    return np.where(base < 0, base + off, base - off)


def _state(rng, c, kind):
    """A PLL state: "run" the plain PLL's state after 7 random rows from
    zero; "edge" f and f0 at int64's edges (a quarter of f0's low words
    0xFFFFFFFF), cl -1, 0 or 1, x0 within 2^8 of a wrap, the rest full
    range."""
    if kind == "run":
        return pll_bank_plain(COEFS["bank"], pll.init((c,), device="cpu"),
                              torch.from_numpy(_i32(rng, (7, c))))[0]
    f0 = _edge_i64(rng, (c,))
    f0 = np.where(rng.random(c) < 0.25, f0 | 0xFFFFFFFF, f0)
    end = rng.choice(np.array(I32, np.int64), c)
    near = end - np.sign(end) * rng.integers(0, 256, c)
    x0 = np.where(rng.random(c) < 0.5, near, _i32(rng, (c,))).astype(np.int32)

    def t(v):
        return torch.from_numpy(np.asarray(v))

    return pll.PllState(
        clamp=ClampWrapState(x0=t(x0), clamp=t(rng.integers(
            -1, 2, c).astype(np.int8))),
        z0=t(_i32(rng, (c,))), y0=t(_i32(rng, (c,))), f0=t(f0),
        f=t(_edge_i64(rng, (c,))), y=t(_i32(rng, (c,))))


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan ---------------------------------------------------------------


@pytest.mark.parametrize("c", [1024, 200, 50, 1])
def test_pll_plan_defaults(c, no_library):
    """PLL_PRODUCERS copy warps and the store warp beside the serial warp
    in 8 warps; one word a row and channel each way, so PIPE_CHUNK-row
    chunks in the PIPE_RING slots that fit; ceil(c / 32) tiles."""
    p = pll_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        8, PLL_PRODUCERS, PIPE_CHUNK, PIPE_RING, 1)
    assert (p.win, p.wout, p.tiles) == (1, 1, -(-c // 32))
    assert p.smem == pipe_smem(256, 3) == 196704 <= MAX_PIPE_SMEM
    forced = pll_plan(c, producers=11, chunk=40, ring=5)
    assert (forced.warps, forced.chunk, forced.smem) == (
        16, 40, pipe_smem(40, 5))
    assert pll_plan(c, producers=2).warps == 4


@pytest.mark.parametrize("kw,match", [
    (dict(producers=0), "producers"),
    (dict(warps=4, producers=3), "warps"),    # 5 roles in 3 places
    (dict(warps=20), "warps"),
    (dict(cluster=2), "one CTA"),
    (dict(chunk=0), "chunk"),
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=512, ring=3), "more than"),
    (dict(chunk=2048), "no ring"),
])
def test_pll_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        pll_plan(1024, **kw)
    with pytest.raises(ValueError, match="lanes"):
        pll_plan(0)


def test_wrapper_refuses_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    n0 = pll_cuda.pll_bank.launches
    st = pll.init((40,), device=meta)
    xs = torch.zeros((256, 40), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="coefficients"):
        pll_cuda.pll_bank(COEFS["bank"][:2], st, xs)
    with pytest.raises(ValueError, match="lanes"):
        pll_cuda.pll_bank(COEFS["bank"], st, xs[:, :0])
    with pytest.raises(ValueError, match=r"\(t, c\)"):
        pll_cuda.pll_bank(COEFS["bank"], st, xs[0])
    with pytest.raises(ValueError, match="one CTA"):
        pll_cuda.pll_bank(COEFS["bank"], st, xs,
                          _plan=pll_plan(40)._replace(cluster=2))
    assert pll_cuda.pll_bank.launches == n0


# ---- the regrouped step -------------------------------------------------------


def _plain_sums_wrap(k, st, x):
    """Whether, on the row x from st, a plain int32 sum (y + hi(f), x + y,
    xi - x0, the Nyquist zero) and a plain int64 sum (the lead-lag's four
    adds, f + f0) wrap in some lane (Python integers)."""
    b0, b1, a1 = k
    w32 = w64 = False
    for lane in range(len(x)):
        f, f0 = int(st.f[lane]), int(st.f0[lane])
        y = int(st.y[lane]) + (f >> 32)
        xi = int(x[lane]) + ((y + 2**31) % 2**32 - 2**31)
        w32 |= not I32[0] <= y <= I32[1] or not I32[0] <= xi <= I32[1]
        xi = (xi + 2**31) % 2**32 - 2**31
        d = xi - int(st.clamp.x0[lane])
        w32 |= not I32[0] <= d <= I32[1]
        z0 = xi >> 1  # the unclamped path's Nyquist zero
        w32 |= not I32[0] <= z0 + int(st.z0[lane]) <= I32[1]
        y0n = (z0 + int(st.z0[lane]) + 2**31) % 2**32 - 2**31
        sums, acc = [], f0
        for term in (b0 * y0n, b1 * int(st.y0[lane]), a1 * (f0 >> 32),
                     (a1 * (f0 % 2**32)) >> 32):
            acc += term
            sums.append(acc)
        sums.append(f + (acc + 2**63) % 2**64 - 2**63)
        w64 |= any(not I64[0] <= v <= I64[1] for v in sums)
    return w32 and w64


@pytest.mark.parametrize("coefs", list(COEFS))
def test_regrouped_step_equals_plain_step(coefs):
    """`pll_rows` (the serial warp's regrouped sums) == `pll.block` bit for
    bit over 64 rows of 2048 channels from edge states and full-range x:
    every output row and state word, s taking each of -2..2, plain sums
    wrapping in int32 and int64 (the first row, in Python integers)."""
    rng = np.random.default_rng(11 + len(coefs))
    k = COEFS[coefs]
    c = 2048
    st = _state(rng, c, "edge")
    xs = _i32(rng, (64, c))
    want_st, want = pll.block(np.asarray(k), st, torch.from_numpy(xs))
    s = pll_words(st)
    with np.errstate(over="ignore"):
        got, seen = pll_rows(k, s, xs.astype(np.int64))
    np.testing.assert_array_equal(got.astype(np.int32), want.numpy())
    for a, b in zip(torch.utils._pytree.tree_leaves(pll_state(s)),
                    torch.utils._pytree.tree_leaves(want_st), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert set(np.unique(seen)) == {-2, -1, 0, 1, 2}
    assert _plain_sums_wrap(k, st, xs[0])
    if coefs == "edge":
        assert k[2] == I32[0]
    assert ((st.f0.numpy() & 0xFFFFFFFF) == 0xFFFFFFFF).any()


# ---- K5: a model of the kernel's schedule -------------------------------------

PLL_CASES = [
    # (c, t, plan keywords)
    (40, 320, dict(chunk=24, ring=2)),            # t % chunk = 8
    (33, 99, dict(chunk=40, ring=3)),             # 33 channels
    (5, 1, {}),                                   # t = 1
    (20, 100, {}),                                # t under a chunk
    (64, 256, dict(chunk=64, producers=3)),
    (50, 7 * 32 + 8, dict(chunk=32, producers=11, warps=16)),
    (3, 48, dict(chunk=5, ring=4, producers=2)),  # 3-row spans
    (10, 0, {}),                                  # no rows
]


@pytest.mark.parametrize("kind", ["run", "edge"])
@pytest.mark.parametrize("c,t,kw", PLL_CASES)
def test_pll_model_equals_plain(c, t, kw, kind):
    """Two carried blocks: the #5 bank's loop from a state that has run on
    full-range phases, or coefficients at int32's ends from edge
    states."""
    rng = np.random.default_rng(900 + c + t)
    plan = pll_plan(c, **kw)
    k = COEFS["bank" if kind == "run" else "edge"]
    st = ps = _state(rng, c, kind)
    for blk in range(2):
        xs = torch.from_numpy(_i32(rng, (t, c)))
        st, ys = pll_model(k, st, xs, plan, seed=blk)
        ps, pys = pll_bank_plain(np.asarray(k), ps, xs)
        for a, b in zip(torch.utils._pytree.tree_leaves((st, ys)),
                        torch.utils._pytree.tree_leaves((ps, pys)),
                        strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("bw", [1e-2, 2e-2])
def test_pll_bank_plain_equals_jax_kernel(bw):
    """At c = 128 from a random state (x0 next to wraps, f and f0 at
    int64's edges) over two carried blocks of full-range phases: the plain
    version == the interpret-mode JAX kernel bit for bit."""
    c, t = 128, 256
    rng = np.random.default_rng(int(bw * 1e4))
    ba = jpll.coefficients_from_bandwidth(bw, 4.0)
    st = _state(rng, c, "edge")
    jst = jax.tree.map(jnp.asarray, to_numpy(st))
    for _ in range(2):
        xs = _i32(rng, (t, c))
        jst, jys = j_pll_bank(jnp.asarray(ba), jst, jnp.asarray(xs),
                              time_chunk=128, interpret=True)
        st, ys = pll_bank_plain(ba, st, torch.from_numpy(xs))
        got = jax.tree.leaves(to_numpy((st, ys)))
        want = [np.asarray(v) for v in jax.tree.leaves((jst, jys))]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
