"""K15 `fm_disc_bank`'s launch plan (`filters/fm_cuda.py` `disc_plan`) and
a CPU model of its schedule (``csrc/fm_disc.cu`` on ``csrc/df1_ring.cuh``'s
depth-0 pipeline), held against the plain version and JAX `fm_receiver`.

The kernel runs a CUDA block (the exact angle: a cluster of 2) of one
32-channel tile: dphi warps that each compute a span of every chunk's rows
into the DF1 warp's input ring (the row before the span loaded once, each
row's previous one kept), the DF1 warp, and a store warp that writes
its output ring to y.  These tests show:

* the plan's warps, roles, chunk, ring depth, tiles and shared memory,
  and the plans and calls it refuses before the library is asked for;
* a model of the schedule (tests/torch_pipe_model.py: the dphi warps by
  spans, the DF1 warp, the store warp, the slots and parities chunk by
  chunk, the roles interleaved at random; with a cluster of 2 the partner
  CTA's warps, their own empty barriers released by the DF1 warp only for
  the chunks they have still to fill) equals `fm_disc_bank_plain` bit
  for bit over two carried blocks, for the exact and the fast angle, with
  rows of -2^31 (the conjugate product's sums reach 2^63), ``prev_valid``
  mixed across the channels, t under a chunk, one chunk and several
  chunks and a tail, spans that do not divide the chunk, c not a multiple
  of 32;
* with the exact angle the model equals JAX `fm_receiver` bit for bit
  (the JAX kernel equals `fm_receiver`, tests/test_structures_pallas.py;
  its interpret-mode run stays in the slow lane, tests/test_torch_fm.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idsp_tpu.pipelines import fm_disc as jfm

from idsp_tpu_torch import _ext
from idsp_tpu_torch.filters import fm_cuda
from idsp_tpu_torch.filters.biquad import Df1State
from idsp_tpu_torch.filters.fm_cuda import (
    DISC_CLUSTER,
    DISC_PRODUCERS,
    FmDiscState,
    disc_plan,
    disc_rows,
    disc_rows_fast,
    fm_disc_bank_plain,
    wrap_carrier,
)
from idsp_tpu_torch.filters.pipe_plan import (
    LANES,
    MAX_PIPE_SMEM,
    PIPE_CHUNK,
    PIPE_RING,
    pipe_smem,
)
from idsp_tpu_torch.pipelines import fm_disc
from torch_pipe_model import pipe_model, span_rows

CPU = torch.device("cpu")
CARRIER = 0x1934_1234  # the example's carrier (< 2^31)
BA = fm_disc.deemphasis_coefficients(0.02)


def _i32(rng, shape, lo=-(2**31), hi=2**31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_ext, "library", refuse)


# ---- the plan -------------------------------------------------------------


def test_disc_plan_defaults(no_library):
    """DISC_PRODUCERS dphi warps and a store warp in 12 warps, PIPE_CHUNK
    rows, PIPE_RING slots (196704 bytes a CTA); the exact angle a cluster
    of 2 CTAs a tile (the partner's 12 warps producers too: spans of 13
    rows), the fast angle one CTA (spans of 32)."""
    for angle, cluster in (("exact", 2), ("fast", 1)):
        assert DISC_CLUSTER[angle] == cluster
        for c in (1, 50, 100, 512, 1024):
            p = disc_plan(c, angle)
            assert (p.warps, p.producers, p.chunk, p.ring, p.cluster) == (
                12, DISC_PRODUCERS, PIPE_CHUNK, PIPE_RING, cluster)
            assert p.producers + 1 == p.warps - p.warps // 4
            assert p.all_producers == DISC_PRODUCERS + (cluster - 1) * 12
            assert p.tiles == -(-c // LANES)
            assert p.smem == pipe_smem(p.chunk, p.ring) == 196704
            assert p.smem <= MAX_PIPE_SMEM
    assert [len(span_rows(w, 256, disc_plan(64, "fast")))
            for w in range(8)] == [32] * 8
    assert [len(span_rows(w, 256, disc_plan(64)))
            for w in range(20)] == [13] * 19 + [9]
    # a span of ceil(20 / 3) = 7 rows: 7, 7, 6; of a 9-row tail: 7, 2, 0
    p = disc_plan(64, producers=3, chunk=20, ring=2, cluster=1)
    assert [len(span_rows(w, 20, p)) for w in range(3)] == [7, 7, 6]
    assert [len(span_rows(w, 9, p)) for w in range(3)] == [7, 2, 0]


@pytest.mark.parametrize("kw,match", [
    (dict(producers=0), "producers"),
    (dict(producers=12), "warps"),
    (dict(warps=12, producers=9), "warps"),   # 10 roles in 9 places
    (dict(chunk=0), "chunk"),
    (dict(ring=1), "2\\+ slots"),
    (dict(chunk=512, ring=3), "more than"),
    (dict(chunk=1024), "no ring"),
    (dict(cluster=3), "cluster"),
])
def test_disc_plan_refuses_what_the_kernel_cannot_run(kw, match, no_library):
    with pytest.raises(ValueError, match=match):
        disc_plan(512, **kw)
    with pytest.raises(ValueError, match="angle"):
        disc_plan(512, "approx")


def test_wrapper_refuses_before_the_library(no_library, monkeypatch):
    """On the kernel's path (tensors on the meta device, the device checks
    passed over) a call the kernel cannot run raises ValueError before
    anything is built or launched."""
    monkeypatch.setattr(_ext, "require", lambda *a: None)
    meta = torch.device("meta")
    st = fm_disc.init_state((64,), device=meta)
    re = torch.zeros((8, 64), dtype=torch.int32, device=meta)
    n0 = fm_cuda.fm_disc_bank.launches
    with pytest.raises(ValueError, match="angle"):
        fm_cuda.fm_disc_bank(BA, st, re, re, CARRIER, angle="approx")
    with pytest.raises(ValueError, match="f must be"):
        fm_cuda.fm_disc_bank(BA, st, re, re, CARRIER, 64)
    with pytest.raises(ValueError, match="at least one row"):
        fm_cuda.fm_disc_bank(BA, st, re[:0], re[:0], CARRIER)
    with pytest.raises(ValueError, match="lanes"):
        fm_cuda.fm_disc_bank(BA, st, re[:, :0], re[:, :0], CARRIER)
    assert fm_cuda.fm_disc_bank.launches == n0


# ---- a model of the kernel's schedule ---------------------------------------


def _k15_produce(state, re, im, carrier, angle):
    """K15's dphi warps, row by row: each row times the conjugate of the
    one before it (row 0's from the carried state), the angle, minus the
    carrier; row 0 of the stream 0 where no sample has passed."""
    disc = disc_rows if angle == "exact" else disc_rows_fast
    b_re = torch.cat([state.prev_re[None], re[:-1]])
    b_im = torch.cat([state.prev_im[None], im[:-1]])

    def produce(r0, idx):
        rows = r0 + idx
        d = disc(re[rows], im[rows], b_re[rows], b_im[rows],
                 wrap_carrier(carrier))
        return torch.where((rows == 0)[:, None] & ~state.prev_valid[None, :],
                           torch.zeros_like(d), d)

    return produce


def _model(state, re, im, plan, angle, seed):
    t, c = re.shape
    deemph, y = pipe_model(BA, 30, state.deemph, t, c, plan,
                           _k15_produce(state, re, im, CARRIER, angle),
                           span_rows, seed=seed)
    return FmDiscState(prev_re=re[-1].clone(), prev_im=im[-1].clone(),
                       prev_valid=torch.ones_like(state.prev_valid),
                       deemph=deemph), y


def _iq(rng, t, c):
    re, im = _i32(rng, (t, c)), _i32(rng, (t, c))
    re[: t // 8], im[: t // 8] = -(2**31), -(2**31)  # sums of 2^63
    re[t // 8: t // 4, ::2] = 2**31 - 1
    return torch.from_numpy(re), torch.from_numpy(im)


def _same(got, want):
    gs, gy = got
    ws, wy = want
    assert torch.equal(gy, wy)
    for a, b in ((gs.prev_re, ws.prev_re), (gs.prev_im, ws.prev_im),
                 (gs.prev_valid, ws.prev_valid), (gs.deemph.x, ws.deemph.x),
                 (gs.deemph.y, ws.deemph.y)):
        assert torch.equal(a, b)


K15_CASES = [
    # (c, t, plan keywords)
    (16, 40, dict(chunk=64)),                             # t under a chunk
    (20, 48, dict(chunk=48, ring=2)),                     # t = one chunk
    (37, 3 * 20 + 9, dict(chunk=20, ring=2, producers=3)),
    (8, 5 * 24 + 7, dict(chunk=24, ring=3, producers=5)),  # span 5
    (40, 100, dict(chunk=16, ring=4)),                    # spans of 2 or 1
    (36, 70, dict(chunk=32, ring=2, producers=1)),
    (12, 30, dict(chunk=1, ring=2)),                      # empty spans
    (5, 1, dict(chunk=8)),                                # t = 1
]


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("angle", ["exact", "fast"])
@pytest.mark.parametrize("c,t,kw", K15_CASES)
def test_k15_schedule_model_equals_plain(c, t, kw, angle, cluster):
    """Two carried blocks from a random carried sample, ``prev_valid``
    mixed, one CTA a tile or a cluster of 2 (the partner's warps' spans
    after the home producers', its own empty barriers); c = 20, 36, 37 and
    40 are not multiples of the 32-channel tile, c = 37 and 5 take 4-byte
    stores."""
    rng = np.random.default_rng(400 + c)
    plan = disc_plan(c, angle, cluster=cluster, **kw)
    st = FmDiscState(
        prev_re=torch.from_numpy(_i32(rng, (c,))),
        prev_im=torch.from_numpy(_i32(rng, (c,))),
        prev_valid=torch.from_numpy(rng.integers(0, 2, c).astype(bool)),
        deemph=Df1State(x=torch.from_numpy(_i32(rng, (c, 2))),
                        y=torch.from_numpy(_i32(rng, (c, 2), -(2**28),
                                                2**28))))
    ps = st
    for blk in range(2):
        re, im = _iq(rng, t, c)
        got = _model(st, re, im, plan, angle, seed=blk)
        want = fm_disc_bank_plain(BA, ps, re, im, CARRIER, angle=angle)
        _same(got, want)
        st, ps = got[0], want[0]


def test_k15_schedule_model_equals_jax_fm_receiver():
    """The exact angle as modelled (the default plan's roles, 64-row
    chunks, spans of 8) against JAX `fm_receiver` over three blocks from
    the stream's start: output and carried state bit for bit."""
    c, t = 128, 192
    rng = np.random.default_rng(31)
    plan = disc_plan(c, chunk=64)  # a cluster of 2: spans of 4 rows
    j_st = jfm.init_state((c,))
    st = fm_disc.init_state((c,), device=CPU)
    for _ in range(3):
        re, im = _iq(rng, t, c)
        j_st, jy = jfm.fm_receiver(j_st, jnp.asarray(re.numpy()),
                                   jnp.asarray(im.numpy()),
                                   jnp.int32(CARRIER), jnp.asarray(BA))
        st, y = _model(st, re, im, plan, "exact", seed=0)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    for got, want in ((st.prev_re, j_st.prev_re), (st.prev_im, j_st.prev_im),
                      (st.prev_valid, j_st.prev_valid),
                      (st.deemph.x, j_st.deemph.x),
                      (st.deemph.y, j_st.deemph.y)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
