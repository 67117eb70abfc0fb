"""A CPU model of the serial warp's mbarrier rings (``csrc/df1_ring.cuh``),
shared by the schedule tests of K2/K3 (tests/test_torch_ddc_cascade_plan.py),
K14/K15 (that file and tests/test_torch_fm_plan.py), K37
(tests/test_torch_rpll_plan.py), K29 (tests/test_torch_q64_plan.py), K31/K33
(tests/test_torch_dither_plan.py) and K34 (tests/test_torch_svf_plan.py),
with the producer and serial-warp arithmetic of K31/K33 (`dither_model`)
and K34 (`svf_model`).

Each role of a CUDA block is a coroutine that yields a test before each
mbarrier wait; the roles run in a seeded random order among those whose
wait passes, and the work between two waits runs at once.  The barriers'
phase parities follow the PTX: a wait on parity p passes while the
current phase's parity is not p, so a fresh barrier's wait on 1 passes.
"""

import numpy as np
import torch


class Bar:
    """An mbarrier: ``count`` arrivals complete a phase; a wait on parity
    p passes while the current phase's parity is not p (a fresh barrier's
    wait on parity 1 passes)."""

    def __init__(self, count):
        self.count, self.pending, self.done = count, count, 0

    def arrive(self, n=1):
        self.pending -= n
        assert self.pending >= 0
        if self.pending == 0:
            self.done += 1
            self.pending = self.count

    def passes(self, parity):
        return self.done % 2 != parity


def df1_rows(ba, f, s, xs, clamp):
    """The DF1 warp's rows: a1*y1 added last, int64 wrapping, then the
    clamp; ``s`` the (x1, x2, y1, y2) int64 lane vectors, updated."""
    b0, b1, b2, a1, a2 = (int(v) for v in ba)
    x1, x2, y1, y2 = s
    out = []
    for x0 in xs.to(torch.int64):
        pre = b0 * x0 + b1 * x1 + b2 * x2 + a2 * y2
        y0 = ((pre + a1 * y1) >> f).to(torch.int32)
        if clamp is not None:
            u, lo, hi = clamp
            y0 = torch.minimum(torch.maximum(y0 + u, torch.tensor(lo)),
                               torch.tensor(hi))  # int32 + u wraps
        x2, x1, y2, y1 = x1, x0, y1, y0.to(torch.int64)
        out.append(y0)
    s[:] = [x1, x2, y1, y2]
    return torch.stack(out) if out else torch.zeros((0, xs.shape[1]),
                                                     dtype=torch.int32)


def run_roles(roles, seed):
    """Runs the coroutines ``roles`` to their ends in a seeded random order
    among those whose pending wait passes; fails on a deadlock."""
    rng = np.random.default_rng(seed)
    waits = [next(g, None) for g in roles]
    while any(wt is not None for wt in waits):
        ready = [i for i, wt in enumerate(waits) if wt is not None and wt()]
        assert ready, "the schedule deadlocked"
        i = ready[rng.integers(len(ready))]
        waits[i] = next(roles[i], None)


def mix_rows(pw, rows, plan):
    """K14's producer pw: its rows of a chunk, index mod the producers."""
    return list(range(pw, rows, plan.producers))


def span_rows(pw, rows, plan):
    """K15's producer pw (the partner CTA's warps after the home CTA's
    producers): its span of a chunk, ceil(chunk / all producers) rows."""
    span = -(-plan.chunk // plan.all_producers)
    lo = min(pw * span, rows)
    return list(range(lo, min(lo + span, rows)))


def pipe_run(t, lanes, plan, produce, rows_of, serial, *, seed=0):
    """A depth-0 launch (``run_pipe``) as the kernel schedules it:
    ``plan.all_producers`` producer roles, the serial warp and the store
    warp over rings of ``plan.ring`` slots of ``plan.chunk`` rows of
    ``lanes`` x ``plan.win`` (input) or x ``plan.wout`` (output) words.
    Producer pw fills the rows ``rows_of(pw, rows, plan)`` of each chunk
    with ``produce(r0, idx)`` ((len(idx), lanes, win) words of the rows r0
    + idx of the block); the serial warp turns each chunk's input rows
    into its output rows with ``serial(words)`` ((rows, lanes, win) ->
    (rows, lanes, wout)), keeping its state; the store warp copies the
    output slot's rows to y.  With a cluster of 2 the producers from
    ``plan.producers`` on are the partner CTA's warps: each waits on the
    partner's own copy of the slot's empty barrier, which the serial warp
    arrives on only for a chunk the partner has still to fill, and
    arrives once on the home slot's full barrier.  Slots start as garbage,
    so a row read before it is written shows.  Returns y, (t, lanes,
    wout) int64 words."""
    K, R, P = plan.chunk, plan.ring, plan.all_producers
    win, wout = getattr(plan, "win", 1), getattr(plan, "wout", 1)
    gen = np.random.default_rng(seed)
    ring_in = gen.integers(-2**31, 2**31, (R, K, lanes, win))
    ring_out = gen.integers(-2**31, 2**31, (R, K, lanes, wout))
    full_in = [Bar(P) for _ in range(R)]
    empty_in = [Bar(1) for _ in range(R)]
    full_out = [Bar(1) for _ in range(R)]
    empty_out = [Bar(1) for _ in range(R)]
    empty_peer = [Bar(1) for _ in range(R)]  # the partner CTA's copies
    y = np.full((t, lanes, wout), -1, dtype=np.int64)
    written = np.zeros(t, dtype=np.int64)
    chunks = [(cs, min(cs + K, t)) for cs in range(0, t, K)]

    def producer(pw):
        empty = empty_in if pw < plan.producers else empty_peer
        for q, (cs, ce) in enumerate(chunks):
            k, ph = q % R, (q // R) & 1
            yield lambda: empty[k].passes(ph ^ 1)
            idx = rows_of(pw, ce - cs, plan)
            if idx:
                ring_in[k, idx] = produce(cs, np.asarray(idx))
            full_in[k].arrive()

    def serial_warp():
        for q, (cs, ce) in enumerate(chunks):
            k, ph = q % R, (q // R) & 1
            yield lambda: full_in[k].passes(ph)
            yield lambda: empty_out[k].passes(ph ^ 1)
            ring_out[k, :ce - cs] = serial(ring_in[k, :ce - cs].copy())
            full_out[k].arrive()
            empty_in[k].arrive()
            if P > plan.producers and q + R < len(chunks):
                empty_peer[k].arrive()

    def store():
        for q, (cs, ce) in enumerate(chunks):
            k, ph = q % R, (q // R) & 1
            yield lambda: full_out[k].passes(ph)
            y[cs:ce] = ring_out[k, :ce - cs]
            written[cs:ce] += 1
            empty_out[k].arrive()

    run_roles([producer(pw) for pw in range(P)] + [serial_warp(), store()],
              seed)
    assert bool((written == 1).all()), "a row was stored twice or never"
    return y


def pipe_model(ba, f, state, t, lanes, plan, produce, rows_of, *,
               out_dtype=torch.int32, seed=0):
    """`pipe_run` with the DF1 warp as the serial warp (K14, K15): one
    int32 word a row and lane each way; ``produce(r0, idx)`` gives the
    DF1's int32 inputs ((len(idx), lanes) tensors).  Returns (Df1State,
    y (t, lanes) of ``out_dtype``)."""
    from idsp_tpu_torch.filters.biquad import Df1State

    s = [state.x[:, 0].to(torch.int64), state.x[:, 1].to(torch.int64),
         state.y[:, 0].to(torch.int64), state.y[:, 1].to(torch.int64)]

    def words(r0, idx):
        return produce(r0, torch.from_numpy(idx)).numpy()[..., None]

    def df1(rows):
        return df1_rows(ba, f, s, torch.from_numpy(rows[..., 0]),
                        None).numpy()[..., None]

    y = pipe_run(t, lanes, plan, words, rows_of, df1, seed=seed)
    x1, x2, y1, y2 = s
    new = Df1State(x=torch.stack([x1, x2], 1).to(torch.int32),
                   y=torch.stack([y1, y2], 1).to(torch.int32))
    return new, torch.from_numpy(y[..., 0]).to(torch.int32).to(out_dtype)


U32 = np.uint64(0xFFFFFFFF)


def _u64(a):
    """int64 words as uint64 (their bits), where sums wrap mod 2^64."""
    return np.asarray(a, np.int64).view(np.uint64)


def dither_model(ba, f, state, xs, plan, *, clamp=None, seed=0):
    """K31 (``ba`` (5,)) or K33 (``ba`` (5, c) planes) as the kernel runs
    it (``csrc/biquad_precision.cu``): the producers' W = b0 x0 + b1 x1 +
    b2 x2 mod 2^64 as two 32-bit words a row and lane (rows -1, -2 of the
    block from the state), the serial warp's V = W + a2 y2 (off its chain),
    acc = a1 y1 + (V + e) mod 2^64, y0 bits [f, f + 32) of acc (the funnel
    shift), the next e acc's low f bits, then the clamp; numpy uint64
    words.  Returns (Df1DitherState, ys int32) like
    `df1_dither_bank_plain`."""
    from idsp_tpu_torch.filters.biquad import Df1DitherState, Df1State

    t, c = xs.shape
    coef = np.asarray(ba, np.int64)
    coef = np.broadcast_to(coef.reshape(5, -1), (5, c))
    b0, b1, b2, a1, a2 = (_u64(v) for v in coef)
    xw = _u64(np.concatenate([state.xy.x[:, 1].numpy()[None],
                              state.xy.x[:, 0].numpy()[None],
                              xs.numpy()]).astype(np.int64))
    y1 = _u64(state.xy.y[:, 0].numpy().astype(np.int64)).copy()
    y2 = _u64(state.xy.y[:, 1].numpy().astype(np.int64)).copy()
    e = state.e.numpy().astype(np.uint64)
    emask = np.uint64((1 << f) - 1)

    def produce(r0, idx):
        g = r0 + idx + 2  # rows of xw
        w = b0 * xw[g] + b1 * xw[g - 1] + b2 * xw[g - 2]
        return np.stack([w & U32, w >> np.uint64(32)], axis=-1).astype(
            np.int64)

    def serial(words):
        nonlocal y1, y2, e
        out = np.empty((len(words), c, 1), np.int64)
        for j, w in enumerate(words.astype(np.uint64) & U32):
            v = (w[:, 1] << np.uint64(32) | w[:, 0]) + a2 * y2  # off the chain
            acc = a1 * y1 + (v + e)
            y0 = ((acc >> np.uint64(f)) & U32).astype(np.uint32).view(np.int32)
            e = acc & emask
            if clamp is not None:
                u, lo, hi = clamp
                y0 = np.clip((y0.astype(np.int64) + u).astype(np.int32),
                             lo, hi).astype(np.int32)
            y2, y1 = y1, _u64(y0.astype(np.int64))
            out[j, :, 0] = y0
        return out

    with np.errstate(over="ignore"):
        words = pipe_run(t, c, plan, produce, span_rows, serial, seed=seed)
    new = Df1DitherState(
        xy=Df1State(
            x=torch.from_numpy(np.stack([xw[-1], xw[-2]], 1).view(
                np.int64).astype(np.int32)),
            y=torch.from_numpy(np.stack([y1, y2], 1).view(np.int64).astype(
                np.int32))),
        e=torch.from_numpy(e.astype(np.int64)))
    return new, torch.from_numpy(words[..., 0].astype(np.int32))


SVF_OUTPUTS = ("lp", "hp", "bp", "br")


def svf_model(f, qi, state, xs, plan, *, output="lp", seed=0):
    """K34 as the kernel runs it (``csrc/structures_bank.cu``): the
    producers copy x, the serial warp forms bp qi beside bp f, then lp =
    bp f + lp, hp = (x - lp) - bp qi, bp = hp f + bp, and br = hp + lp, in
    numpy float32, each product and sum rounded on its own; the words are
    the f32 bits.  Returns (SvfState, ys f32) like `svf_bank_plain`."""
    from idsp_tpu_torch.filters.svf import SvfState

    t, c = xs.shape
    f, qi = np.float32(f), np.float32(qi)
    lp, hp, bp = (w.numpy().astype(np.float32) for w in state)
    xb = xs.numpy().astype(np.float32).view(np.int32)
    sel = SVF_OUTPUTS.index(output)

    def produce(r0, idx):
        return xb[r0 + idx][..., None].astype(np.int64)

    def serial(words):
        nonlocal lp, hp, bp
        out = np.empty((len(words), c, 1), np.int64)
        for j, w in enumerate(words[..., 0]):
            x = w.astype(np.int32).view(np.float32)
            bf, bq = bp * f, bp * qi  # bq off the chain
            lp = bf + lp
            hp = (x - lp) - bq
            bp = hp * f + bp
            y = (lp, hp, bp, hp + lp)[sel]
            out[j, :, 0] = y.astype(np.float32).view(np.int32)
        return out

    words = pipe_run(t, c, plan, produce, span_rows, serial, seed=seed)
    ys = words[..., 0].astype(np.int32).view(np.float32)
    new = SvfState(*(torch.from_numpy(np.array(v, np.float32))
                     for v in (lp, hp, bp)))
    return new, torch.from_numpy(ys)
