"""K29 `df1_bank_q64`'s launch plan (`filters/biquad_cuda.py` `q64_plan`)
and a CPU model of its schedule (``csrc/biquad_precision.cu`` on
``csrc/df1_ring.cuh``'s depth-0 pipeline), held against the plain version
and the interpret-mode JAX kernel.

The kernel runs a CUDA block of one 32-lane tile: producer warps, each a
span of every chunk, that write each row's feed-forward sum b0 x0 + b1 x1
+ b2 x2 mod 2^128 (four 32-bit limbs) into the serial warp's input ring;
the serial warp, which holds y1 and y2, adds a2 y2 (off its chain) and
a1 y1 and shifts, into int64 words; a store warp that writes the
rows.  These tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory at
  1024, 200, 50 and 1 lanes (16 words a row and lane in, 8 out: 128-row
  chunks in 2 slots, or 64-row chunks in 3 or 4), and the plans and calls
  it refuses before the library is asked for;
* a model of the schedule (tests/torch_pipe_model.py: the producers by
  spans, the serial warp, the store warp, the slots and parities chunk by
  chunk, the roles interleaved at random), with the kernel's limb
  arithmetic (`df1.cuh` `mac_q64`: four 32 x 32 -> 64 products, column
  sums, the sign corrections, numpy uint64 words), equals
  `df1_bank_q64_plain` bit for bit over carried blocks: at chunk edges,
  t = 1 and t under a chunk, spans that do not divide the chunk, and
  coefficients, x and y near +-2^63, where the 128-bit sum wraps;
* `mac_q64`'s limb arithmetic equals the signed 128-bit product and sum
  (Python integers) at the edges of int64;
* at c = 128 the model equals the interpret-mode JAX kernel
  `biquad_pallas.df1_bank_q64` bit for bit.
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
    Q64_PRODUCERS,
    df1_bank_q64_plain,
    q64_plan,
)
from idsp_tpu_torch.filters.pipe_plan import LANES, MAX_PIPE_SMEM, pipe_smem
from torch_pipe_model import pipe_run, span_rows

U32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)
EDGES = np.array([-(2**63), -(2**63) + 1, -(2**62), -(2**32), -1, 0, 1,
                  2**31, 2**32 - 1, 2**62, 2**63 - 1], np.int64)


def _ba(fc=0.1, f=61):
    """The suite's Q64<f> lowpass at ``fc``."""
    ba5 = jbiquad.from_cookbook(JFilter().critical_frequency(fc).lowpass())
    return jbiquad.quantize_ba(ba5, f, dtype=np.int64)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------


@pytest.mark.parametrize("c", [1024, 200, 50, 1])
def test_q64_plan_defaults(c, no_library):
    """Q64_PRODUCERS producer warps and the store warp beside the serial
    warp in 8 warps; four words a row and lane in and two out, so 128-row
    chunks in the 2 slots that fit (196672 bytes); one CTA a tile; 64-row
    chunks hold 3 or 4 slots."""
    p = q64_plan(c)
    assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
        8, Q64_PRODUCERS, 128, 2, 1)
    assert (p.win, p.wout) == (4, 2)
    assert p.tiles == -(-c // LANES)
    assert p.smem == pipe_smem(128, 2, 4, 2) == 196672 <= MAX_PIPE_SMEM
    assert q64_plan(c, chunk=64).ring == 3
    assert q64_plan(c, chunk=64, ring=4).smem == 32 * 4 + 4 * 64 * 32 * 24
    one = q64_plan(c, producers=11, warps=16, chunk=1)
    assert (one.warps, one.producers, one.ring) == (16, 11, 3)


@pytest.mark.parametrize("kw,match", [
    (dict(producers=0), "producers"),
    (dict(warps=8, producers=6), "warps"),   # 7 roles in 6 places
    (dict(cluster=2), "one CTA"),
    (dict(chunk=0), "chunk"),
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=128, ring=3), "more than"),
    (dict(chunk=256), "no ring"),
])
def test_q64_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        q64_plan(1024, **kw)
    with pytest.raises(ValueError, match="lanes"):
        q64_plan(0)


def test_wrapper_refuses_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    st = biquad.df1_init((64,), torch.int64, device=meta)
    xs = torch.zeros((8, 64), dtype=torch.int64, device=meta)
    n0 = biquad_cuda.df1_bank_q64.launches
    with pytest.raises(ValueError, match="f must be"):
        biquad_cuda.df1_bank_q64(_ba(), st, xs, 32)
    with pytest.raises(ValueError, match="lanes"):
        biquad_cuda.df1_bank_q64(_ba(), st, xs[:, :0])
    with pytest.raises(ValueError, match="more than"):
        biquad_cuda.df1_bank_q64(_ba(), st, xs, 61,
                                 _plan=q64_plan(64, chunk=128, ring=3))
    assert biquad_cuda.df1_bank_q64.launches == n0


# ---- the kernel's limb arithmetic ---------------------------------------------


def mac_q64(lo, hi, c, y):
    """`df1.cuh` `mac_q64` on numpy uint64 words: (hi:lo) + c * y mod
    2^128, c a Python int64 coefficient, y a uint64 array of int64 bits:
    four 32 x 32 -> 64 products side by side, the column sums, the sign
    correction in the high product's addend."""
    cb = np.uint64(c & 0xFFFFFFFFFFFFFFFF)
    neg = np.uint64(0xFFFFFFFFFFFFFFFF if c < 0 else 0)
    yl, yh = y & U32, y >> S32
    cl, ch = cb & U32, cb >> S32
    sign = np.where((y >> np.uint64(63)) == 1,
                    np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64(0))
    corr = (cb & sign) + (y & neg)
    p00 = yl * cl + (lo & U32)
    p01, p10 = yl * ch, yh * cl
    p11 = yh * ch + (hi - corr)
    m = (p00 >> S32) + (lo >> S32) + (p01 & U32) + (p10 & U32)
    hi = p11 + (p01 >> S32) + (p10 >> S32) + (m >> S32)
    return (m << S32) | (p00 & U32), hi


def test_mac_q64_limbs_equal_the_128_bit_sum():
    rng = np.random.default_rng(3)
    ys = np.concatenate([EDGES, rng.integers(-(2**63), 2**63, 200,
                                             dtype=np.int64)])
    cs = [int(v) for v in EDGES] + [int(v) for v in rng.integers(
        -(2**63), 2**63, 20, dtype=np.int64)]
    lo = rng.integers(0, 2**64, ys.size, dtype=np.uint64)
    hi = rng.integers(0, 2**64, ys.size, dtype=np.uint64)
    for c in cs:
        got_lo, got_hi = mac_q64(lo, hi, c, ys.view(np.uint64))
        for i in range(ys.size):
            want = ((int(hi[i]) << 64 | int(lo[i])) + c * int(ys[i])) % 2**128
            assert (int(got_hi[i]) << 64 | int(got_lo[i])) == want


# ---- a model of the kernel's schedule ---------------------------------------


def _model(ba, f, state, xs, plan, seed):
    """K29 as the kernel runs it: the producers' feed-forward limbs, the
    serial warp's W + a2 y2, then a1 y1 and the funnel shifts; returns
    (Df1State, ys int64) like `df1_bank_q64_plain`."""
    t, c = xs.shape
    b0, b1, b2, a1, a2 = (int(v) for v in ba)
    # rows -2, -1 of the block from the state, then xs
    xw = np.concatenate([state.x[:, 1].numpy()[None],
                         state.x[:, 0].numpy()[None], xs.numpy()]
                        ).view(np.uint64)
    y1 = state.y[:, 0].numpy().view(np.uint64).copy()
    y2 = state.y[:, 1].numpy().view(np.uint64).copy()
    sh = np.uint64(f - 32)

    def produce(r0, idx):
        g = r0 + idx + 2  # rows of xw
        lo, hi = mac_q64(np.zeros((len(idx), c), np.uint64),
                         np.zeros((len(idx), c), np.uint64), b0, xw[g])
        lo, hi = mac_q64(lo, hi, b1, xw[g - 1])
        lo, hi = mac_q64(lo, hi, b2, xw[g - 2])
        return np.stack([lo & U32, lo >> S32, hi & U32, hi >> S32],
                        axis=-1).astype(np.int64)

    def serial(words):
        nonlocal y1, y2
        out = np.empty((len(words), c, 2), np.int64)
        for j, w in enumerate(words.astype(np.uint64)):
            lo, hi = mac_q64(w[:, 1] << S32 | w[:, 0], w[:, 3] << S32 | w[:, 2],
                             a2, y2)  # W + a2 y2, off the chain
            lo, hi = mac_q64(lo, hi, a1, y1)
            mid = ((hi & U32) << S32) | (lo >> S32)
            low = (mid >> sh) & U32                          # funnel shift
            high = (hi >> sh) & U32                          # funnel shift
            y2, y1 = y1, (high << S32) | low
            out[j, :, 0], out[j, :, 1] = low, high
        return out

    words = pipe_run(t, c, plan, produce, span_rows, serial, seed=seed)
    ys = (words[..., 1].astype(np.uint64) << S32 |
          words[..., 0].astype(np.uint64)).view(np.int64)
    new = biquad.Df1State(
        x=torch.from_numpy(np.stack([xw[-1], xw[-2]], 1).view(np.int64)),
        y=torch.from_numpy(np.stack([y1, y2], 1).view(np.int64)))
    return new, torch.from_numpy(ys)


def _same(got, want):
    (gs, gy), (ws, wy) = got, want
    assert torch.equal(gy, wy)
    assert torch.equal(gs.x, ws.x)
    assert torch.equal(gs.y, ws.y)


def _i64(rng, shape, kind):
    """int64 words: full range, or the edges of int64 (sums that wrap)."""
    if kind == "edges":
        return rng.choice(EDGES, shape)
    return rng.integers(-(2**63), 2**63, shape, dtype=np.int64)


K29_CASES = [
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


@pytest.mark.parametrize("kind", ["lowpass", "full", "edges"])
@pytest.mark.parametrize("c,t,kw", K29_CASES)
def test_k29_schedule_model_equals_plain(c, t, kw, kind):
    """Two carried blocks from a random state: the suite's Q64<61>
    lowpass with x and state in +-2^55; full-range coefficients, x and
    state at f = 47; int64's edges everywhere at f = 33.  c = 20, 36, 37
    and 40 are not multiples of the 32-lane tile."""
    rng = np.random.default_rng(600 + c + len(kind))
    f = {"lowpass": 61, "full": 47, "edges": 33}[kind]
    if kind == "lowpass":
        ba = _ba()

        def ints(shape):
            return rng.integers(-(2**55), 2**55, shape, dtype=np.int64)
    else:
        ba = _i64(rng, (5,), kind)

        def ints(shape):
            return _i64(rng, shape, kind)
    plan = q64_plan(c, **kw)
    st = biquad.Df1State(x=torch.from_numpy(ints((c, 2))),
                         y=torch.from_numpy(ints((c, 2))))
    ps = st
    for blk in range(2):
        xs = torch.from_numpy(ints((t, c)))
        got = _model(ba, f, st, xs, plan, seed=blk)
        want = df1_bank_q64_plain(ba, ps, xs, f)
        _same(got, want)
        st, ps = got[0], want[0]


def test_k29_schedule_model_equals_interpret_kernel():
    """The default plan's roles at 64-row chunks against the interpret-mode
    JAX kernel over two carried blocks from a random state (x and y in
    +-2^55, the Q64<61> lowpass at 0.05): outputs and state bit for bit."""
    c, t = 128, 192
    rng = np.random.default_rng(29)
    ba = _ba(0.05)
    plan = q64_plan(c, chunk=64)
    jst = jbiquad.Df1State(
        x=jnp.asarray(rng.integers(-(2**55), 2**55, (c, 2), np.int64)),
        y=jnp.asarray(rng.integers(-(2**55), 2**55, (c, 2), np.int64)))
    st = biquad.Df1State(x=torch.from_numpy(np.array(jst.x)),
                         y=torch.from_numpy(np.array(jst.y)))
    for blk in range(2):
        xs = rng.integers(-(2**55), 2**55, (t, c), dtype=np.int64)
        jst, jys = jbp.df1_bank_q64(jnp.asarray(ba), jst, jnp.asarray(xs),
                                    61, time_chunk=64, interpret=True)
        st, ys = _model(ba, 61, st, torch.from_numpy(xs), plan, seed=blk)
        np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
    np.testing.assert_array_equal(st.y.numpy(), np.asarray(jst.y))
