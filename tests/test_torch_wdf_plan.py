"""The launch plan of K38-K40 (`filters/wdf_cuda.py` `launch_plan`) and a
CPU model of the kernel's stage-warp pipeline (``csrc/wdf_bank.cu``),
held against the plain versions.

The kernel runs a CUDA block of 32 lanes with one warp per serial stage
(branch 0's, then branch 1's), a loader warp and a store warp; chunks of
rows pass from warp to warp through rings of shared-memory slots, each
slot with a full and an empty mbarrier.  These tests show:

* the plan's warps, stage kinds (the specialised loop of each of the
  suite's (N, M) stages, the generic loop for any other), chunk, ring
  depth and shared memory for wdf-ca-7, wdf-ca-19, single chains,
  unequal pairs and 24 adapters, and that a 25th adapter is refused;
* a model of the kernel's schedule -- each warp the kernel's sequence of
  barrier waits and arrivals, chunk by chunk, its stage's z carried
  between chunks, the warps interleaved in a seeded random order, the
  barriers' phase parities as the PTX defines them -- completes and
  equals `wdf.pair_block` / `wdf.chain_block` bit for bit, across chunk
  edges, at t = 1 and t < chunk.
"""

import numpy as np
import pytest
import torch

from idsp_tpu_torch.filters import wdf
from idsp_tpu_torch.filters.wdf_cuda import (
    CHUNK,
    DEPTH,
    LANES,
    MAX_SMEM,
    SMEM_BUDGET,
    SPECIALISED,
    WDF_MAX,
    launch_plan,
    ring_bytes,
    stage_key,
    stage_kind,
)

CA7 = ([(0xAD, 2, [-0.9, 0.9]), (0xAD, 2, [-0.6, 0.7])],
       [(0xAD, 2, [-0.7, 0.6]), (0xA, 1, [0.8])])
CA19 = ([(0x1, 1, [0.0]), (0x1C, 2, [-0.226119, 0.0]),
         (0x1D, 2, [-0.602422, 0.0]), (0x1D, 2, [-0.83932, 0.0]),
         (0x1D, 2, [-0.950847, 0.0])],
        [(0x1C, 2, [-0.063978, 0.0]), (0x1C, 2, [-0.423068, 0.0]),
         (0x1D, 2, [-0.741327, 0.0]), (0x1D, 2, [-0.905567, 0.0]),
         (0x1D, 2, [-0.984721, 0.0])])
EVERY = [wdf.Tpa(v) for v in (0xA, 0xB, 0xE, 0x1, 0xC, 0xF, 0xD, 0x0)]
EVERY_G = [0.7, 0.3, 0.2, 0.0, -0.3, -0.45, -0.8, 0.0]
# a coefficient of each type inside its [-0.5, 0] range (`wdf.quantize`)
G_OF = {wdf.Tpa.A: 0.7, wdf.Tpa.B: 0.3, wdf.Tpa.B1: 0.2, wdf.Tpa.C: -0.3,
        wdf.Tpa.C1: -0.45, wdf.Tpa.D: -0.8}


def _stages(spec):
    return [(wdf.nibbles(m, n), wdf.quantize(wdf.nibbles(m, n), g))
            for m, n, g in spec]


def _types(branches):
    return [[tp for tp, _ in br] for br in branches]


def _random_branch(rng, lens):
    out = []
    for n in lens:
        tp = [wdf.Tpa(int(v)) for v in rng.choice(
            [0xA, 0xB, 0xE, 0x1, 0xC, 0xF, 0xD, 0x0], size=int(n))]
        out.append((tp, wdf.quantize(tp, [G_OF.get(t, 0.0) for t in tp])))
    return out


# --- the plan -----------------------------------------------------------------


def test_plan_wdf_ca7():
    plan = launch_plan(_types([_stages(b) for b in CA7]))
    assert plan.stages == (2, 2) and plan.warps == 6
    assert plan.keys == ((2, 0xAD), (2, 0xAD), (2, 0xAD), (1, 0xA))
    assert plan.kinds == (3, 3, 3, 2)
    assert (plan.chunk, plan.depth) == (CHUNK, DEPTH) == (64, 4)
    # 5 rings x 4 slots x (two 8-byte barriers + 64 rows x 32 lanes x 4 B)
    assert plan.smem == 5 * 4 * (16 + 64 * LANES * 4) == 164160


def test_plan_wdf_ca19():
    plan = launch_plan(_types([_stages(b) for b in CA19]))
    assert plan.stages == (5, 5) and plan.warps == 12
    assert plan.kinds == (1, 4, 5, 5, 5, 4, 4, 5, 5, 5)
    # 11 rings of 4 or 3 slots do not fit, of 2 do
    assert (plan.chunk, plan.depth) == (64, 2)
    assert plan.smem == 11 * 2 * 8208 == 180576 <= SMEM_BUDGET


@pytest.mark.parametrize("spec,stages,kinds", [
    ([CA7[0][:1]], (1, 0), (3,)),  # K38: wdf-ca-7's first chain
    ([CA19[0]], (5, 0), (1, 4, 5, 5, 5)),  # K39: wdf-ca-19's branch 0
    ([CA19[1][:1], CA7[1]], (1, 2), (4, 3, 2)),  # unequal pair
    ([CA19[0], CA7[1][1:]], (5, 1), (1, 4, 5, 5, 5, 2)),
])
def test_plan_chains_and_unequal_pairs(spec, stages, kinds):
    plan = launch_plan(_types([_stages(b) for b in spec]))
    assert plan.stages == stages and plan.warps == sum(stages) + 2
    assert plan.kinds == kinds
    assert plan.smem == ring_bytes(sum(stages), plan.chunk, plan.depth)


def test_plan_24_adapters():
    one = [wdf.Tpa.D]
    # 24 stages of one adapter: no depth of 64 rows fits, 2 slots of 32 do
    plan = launch_plan([[one] * 12, [one] * 12])
    assert plan.warps == 26 and plan.kinds == (0,) * 24
    assert (plan.chunk, plan.depth) == (32, 2)
    assert plan.smem == 25 * 2 * 4112 == 205600 <= SMEM_BUDGET
    # one stage of 24 adapters: one stage warp, the generic loop
    plan = launch_plan([[EVERY * 3]])
    assert plan.warps == 3 and plan.kinds == (0,) and plan.depth == 4
    assert plan.keys == ((24, stage_key(EVERY * 3)[1]),)


@pytest.mark.parametrize("branches", [
    [[[wdf.Tpa.D]] * 25],
    [[[wdf.Tpa.D, wdf.Tpa.X]] * 6, [[wdf.Tpa.D]] * 13],
    [[EVERY * 3 + [wdf.Tpa.A]]],
])
def test_plan_refuses_a_25th_adapter(branches):
    assert sum(len(tp) for br in branches for tp in br) == WDF_MAX + 1
    with pytest.raises(ValueError):
        launch_plan(branches)


@pytest.mark.parametrize("branches", [[], [[]], [[[]]], [[[wdf.Tpa.A]]] * 3,
                                      [[[wdf.Tpa.A]], []]])
def test_plan_refuses_empty_or_three_branches(branches):
    with pytest.raises(ValueError):
        launch_plan(branches)


def test_every_suite_stage_is_specialised():
    suite = {stage_key(tp) for spec in (CA7, CA19) for br in spec
             for tp, _ in _stages(br)}
    assert suite == set(SPECIALISED)
    for spec in (CA7, CA19):
        for br in spec:
            for tp, _ in _stages(br):
                assert stage_kind(tp) == SPECIALISED.index(stage_key(tp)) + 1
    assert stage_key(wdf.nibbles(0x1D, 2)) == (2, 0x1D)  # D in nibble 0


def test_other_stages_take_the_generic_loop():
    for tp in ([wdf.Tpa.D], [wdf.Tpa.A, wdf.Tpa.D], EVERY,
               [wdf.Tpa.X, wdf.Tpa.C]):
        assert stage_kind(tp) == 0
    plan = launch_plan(_types([_stages(b) for b in CA19]), generic=True)
    assert plan.kinds == (0,) * 10


def test_plan_forced_chunk_and_depth():
    types = _types([_stages(b) for b in CA19])
    plan = launch_plan(types, chunk=5)
    assert (plan.chunk, plan.depth) == (5, 4)
    assert plan.smem == ring_bytes(10, 5, 4) == 11 * 4 * (16 + 5 * 128)
    plan = launch_plan(types, chunk=7, depth=1)
    assert (plan.chunk, plan.depth) == (7, 1)
    # a plan past a block's shared memory, which the kernel refuses
    assert launch_plan(types, chunk=128, depth=8).smem > MAX_SMEM
    with pytest.raises(ValueError):
        launch_plan(types, chunk=0)


# --- a model of the kernel's schedule ----------------------------------------


class _Barrier:
    """An mbarrier: ``count`` arrivals complete the current phase; the
    phase of parity p has completed when the current phase's parity is
    not p (a fresh barrier: parity 1 passes, parity 0 waits)."""

    def __init__(self, count):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self):
        assert self.pending > 0
        self.pending -= 1
        if self.pending == 0:
            self.pending, self.phase = self.count, self.phase ^ 1

    def done(self, parity):
        return self.phase != parity


def _model(branches, states, xs, chunk, depth, seed):
    """The kernel's schedule on the CPU: every warp a generator of its
    barrier waits (it yields the barrier and parity it waits on) and
    arrivals, as ``csrc/wdf_bank.cu`` orders them -- the loader, each
    stage warp taking its chunk through `wdf.block` with its z carried,
    the store warp with the pair's butterfly -- in a seeded random order
    of the runnable warps.  Returns (per-branch states, outputs)."""
    t = xs.shape[0]
    flat = [st for br in branches for st in br]
    z = [s.z for sts in states for s in sts]
    s0, stages, nb = len(branches[0]), len(flat), len(branches)
    rings = stages + 1
    full = [[_Barrier(LANES) for _ in range(depth)] for _ in range(rings)]
    empty = [[_Barrier(LANES * (nb if r == 0 else 1))
              for _ in range(depth)] for r in range(rings)]
    slots = [[None] * depth for _ in range(rings)]
    chunks = -(-t // chunk)
    ys = [torch.empty_like(xs) for _ in branches]
    y0 = stages - nb + 1  # branch b's last stage writes ring y0 + b

    def arrive_all(bar):
        for _ in range(LANES):
            bar.arrive()

    def loader():
        for q in range(chunks):
            k, ph = q % depth, (q // depth) & 1
            yield empty[0][k], ph ^ 1
            slots[0][k] = xs[q * chunk:(q + 1) * chunk]
            arrive_all(full[0][k])

    def stage(s):
        b1 = s >= s0
        last = stages - 1 if b1 else s0 - 1
        inp = 0 if s == (s0 if b1 else 0) else (s - 1 if b1 else s)
        out = (s if b1 else s + 1) if s != last else y0 + int(b1)
        tpas, a = flat[s]
        for q in range(chunks):
            k, ph = q % depth, (q // depth) & 1
            yield full[inp][k], ph
            yield empty[out][k], ph ^ 1
            st, slots[out][k] = wdf.block(tpas, a, wdf.WdfState(z=z[s]),
                                          slots[inp][k])
            z[s] = st.z
            arrive_all(full[out][k])
            arrive_all(empty[inp][k])

    def store():
        for q in range(chunks):
            k, ph = q % depth, (q // depth) & 1
            for b in range(nb):
                yield full[y0 + b][k], ph
            rows = slice(q * chunk, min(t, (q + 1) * chunk))
            if nb == 1:
                ys[0][rows] = slots[y0][k]
            else:  # the butterfly, wrapping
                u, v = (slots[y0 + b][k].to(torch.int64) for b in range(2))
                ys[0][rows], ys[1][rows] = _wrap(u + v), _wrap(u - v)
            for b in range(nb):
                arrive_all(empty[y0 + b][k])

    rng = np.random.default_rng(seed)
    warps = [stage(s) for s in range(stages)] + [loader(), store()]
    waiting = [None] * len(warps)  # (barrier, parity) each warp waits on
    live = list(range(len(warps)))
    while live:
        ready = [w for w in live
                 if waiting[w] is None or waiting[w][0].done(waiting[w][1])]
        assert ready, "the schedule deadlocks"
        w = ready[rng.integers(len(ready))]
        try:
            waiting[w] = next(warps[w])
        except StopIteration:
            live.remove(w)
    it = iter(z)
    new = [[wdf.WdfState(z=next(it)) for _ in br] for br in branches]
    return new, ys


def _wrap(v):
    """int64 -> int32 mod 2^32."""
    return ((v + 2**31) % 2**32 - 2**31).to(torch.int32)


def _i32(rng, shape, lim=2**31):
    return torch.from_numpy(rng.integers(-lim, lim, size=shape).astype(
        np.int32))


def _hold(branches, c, t, chunk, depth, seed):
    rng = np.random.default_rng(seed)
    states = [[wdf.WdfState(z=_i32(rng, (c, len(tp)))) for tp, _ in br]
              for br in branches]
    xs = _i32(rng, (t, c))
    new, ys = _model(branches, states, xs, chunk, depth, seed)
    if len(branches) == 1:
        want_s, want_y = wdf.chain_block(branches[0], states[0], xs)
        got_s, got_y = new[0], ys[0]
    else:
        want_s, want_y = wdf.pair_block(branches[0], branches[1],
                                        tuple(states), xs)
        got_s, got_y = tuple(new), tuple(ys)
    flat_got = [s.z for br in (got_s if len(branches) > 1 else [got_s])
                for s in br]
    flat_want = [s.z for br in (want_s if len(branches) > 1 else [want_s])
                 for s in br]
    for a, b in zip(flat_got, flat_want, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(got_y if isinstance(got_y, tuple) else (got_y,),
                    want_y if isinstance(want_y, tuple) else (want_y,),
                    strict=True):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)


@pytest.mark.parametrize("t,chunk,depth", [
    (70, 8, 4),  # chunk edges, a short last chunk
    (64, 8, 2),  # whole chunks, every slot reused
    (1, 32, 4),  # t = 1
    (5, 32, 4),  # t < chunk
    (40, 3, 1),  # one slot a ring
])
@pytest.mark.parametrize("spec", ["ca7", "ca19"])
def test_pipeline_model_equals_pair_block(spec, t, chunk, depth):
    branches = [_stages(b) for b in (CA7 if spec == "ca7" else CA19)]
    _hold(branches, 3, t, chunk, depth, seed=t + chunk)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_model_unequal_pairs_and_chains(seed):
    rng = np.random.default_rng(seed)
    b0 = _random_branch(rng, rng.integers(1, 4, size=rng.integers(1, 4)))
    b1 = _random_branch(rng, rng.integers(1, 3, size=rng.integers(1, 6)))
    _hold([b0, b1], 2, 45, int(rng.integers(1, 9)), 3, seed)
    _hold([b1], 2, 45, 7, 2, seed)
    _hold([[(EVERY, wdf.quantize(EVERY, EVERY_G))]], 2, 20, 6, 4, seed)


@pytest.mark.parametrize("kernel", ["wdf_bank", "wdf_chain_bank",
                                    "wdf_pair_bank"])
def test_short_coefficient_set_raises_before_launch(kernel, monkeypatch):
    """K38-K40 on the kernel's path (tensors on the meta device) with a
    stage given fewer coefficients than adapters raise ValueError and
    launch nothing: the flat coefficient list would otherwise hand the
    stage its neighbour's coefficients (the plain version and JAX raise
    for the same call)."""
    from idsp_tpu_torch import _ext
    from idsp_tpu_torch.filters import wdf_cuda

    def refuse():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_ext, "library", refuse)
    meta = torch.device("meta")
    c, t = 8, 16
    xs = torch.zeros((t, c), dtype=torch.int32, device=meta)
    da = [wdf.Tpa.D, wdf.Tpa.A]
    short = (da, wdf.quantize(da, [-0.9, 0.9])[:1])  # 1 coefficient for 2
    full = ([wdf.Tpa.A], wdf.quantize([wdf.Tpa.A], [0.8]))

    def zero(stages):
        return [wdf.init(len(tp), (c,), device=meta) for tp, _ in stages]

    fn = getattr(wdf_cuda, kernel)
    n0 = fn.launches
    with pytest.raises(ValueError, match="needs 2 coefficients, got 1"):
        if kernel == "wdf_bank":
            fn(*short, zero([short])[0], xs)
        elif kernel == "wdf_chain_bank":
            fn([full, short], zero([full, short]), xs)
        else:
            fn([full], [short, full], (zero([full]), zero([short, full])),
               xs)
    assert fn.launches == n0
