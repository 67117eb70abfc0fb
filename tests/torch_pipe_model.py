"""A CPU model of the serial warp's mbarrier rings (``csrc/df1_ring.cuh``),
shared by the schedule tests of K2/K3 (tests/test_torch_ddc_cascade_plan.py),
K14/K15 (that file and tests/test_torch_fm_plan.py), K37
(tests/test_torch_rpll_plan.py), K29 (tests/test_torch_q64_plan.py), K31/K33
(tests/test_torch_dither_plan.py), K34 (tests/test_torch_svf_plan.py),
K12/K13 (tests/test_torch_ddc_bank_plan.py) and K16
(tests/test_torch_lockin_plan.py), with the producer and serial-warp
arithmetic of K31/K33 (`dither_model`), K1, K11, K18, K26 and K27
(`df1w_model`, tests/test_torch_df1_plan.py), K25/K32 (`wide_model`,
tests/test_torch_wide_plan.py), K34 (`svf_model`), K12/K13 and K6
(`bank_model`, with its back end; K6 with the Lowpass serial warp), K16
(`lockin_model`), K4 (`lowpass_model`, tests/test_torch_lowpass_plan.py),
K5 (`pll_model`, tests/test_torch_pll_plan.py),
K35/K36 (`normal_model`, tests/test_torch_normal_plan.py) and K28/K30
(`q16_model`, `f32_model`, tests/test_torch_precision_plan.py);
and K24's chain of such blocks over a cluster (`sos_model`,
tests/test_torch_sos_plan.py).

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


def pipe_run(t, lanes, plan, produce, rows_of, serial, *, seed=0,
             back=None):
    """A depth-0 launch (``run_pipe``) as the kernel schedules it:
    ``plan.all_producers`` producer roles, the serial warp and the store
    warp over rings of ``plan.ring`` slots of ``plan.chunk`` rows of
    ``lanes`` x ``plan.win`` (input) or x ``plan.wout`` (output) words.
    Producer pw fills the rows ``rows_of(pw, rows, plan)`` of each chunk
    with ``produce(r0, idx)`` ((len(idx), lanes, win) words of the rows r0
    + idx of the block); the serial warp turns each chunk's input rows
    into its output rows with ``serial(words)`` ((rows, lanes, win) ->
    (rows, lanes, wout)), keeping its state; the store warp copies the
    output slot's rows to y, or, with ``back``, calls ``back(r0, words)``
    on them (K12/K13's back-end warp in its place).  With a cluster of 2 the producers from
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
            if back is None:
                y[cs:ce] = ring_out[k, :ce - cs]
            else:
                back(cs, ring_out[k, :ce - cs].copy())
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


def _w_feed(ba, sx, xs):
    """The DF1 producers of K1, K11, K18, K26, K27 and K31/K33: ``ba`` (5,)
    or (5, c) planes as uint64 lane vectors, the rows x2, x1 (the state
    ``sx``) and xs as uint64 words ``xw`` (t + 2, c), and produce(r0, idx),
    each row's W = b0 x0 + b1 x1 + b2 x2 mod 2^64 as two 32-bit words.
    Returns ((a1, a2), xw, produce)."""
    c = xs.shape[1]
    coef = np.broadcast_to(np.asarray(ba, np.int64).reshape(5, -1), (5, c))
    b0, b1, b2, a1, a2 = (_u64(v) for v in coef)
    xw = _u64(np.concatenate([sx[:, 1].numpy()[None], sx[:, 0].numpy()[None],
                              xs.numpy()]).astype(np.int64))

    def produce(r0, idx):
        g = r0 + idx + 2  # rows of xw
        with np.errstate(over="ignore"):
            w = b0 * xw[g] + b1 * xw[g - 1] + b2 * xw[g - 2]
        return np.stack([w & U32, w >> np.uint64(32)], axis=-1).astype(
            np.int64)

    return (a1, a2), xw, produce


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
    (a1, a2), xw, produce = _w_feed(ba, state.xy.x, xs)
    y1 = _u64(state.xy.y[:, 0].numpy().astype(np.int64)).copy()
    y2 = _u64(state.xy.y[:, 1].numpy().astype(np.int64)).copy()
    e = state.e.numpy().astype(np.uint64)
    emask = np.uint64((1 << f) - 1)

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


def df1w_model(ba, f, state, xs, plan, *, clamp=None, d=1, out_dtype=None,
               seed=0):
    """K1 (``ba`` (5,)), K11 (``d`` > 1), K18 (``clamp``), K26 and K27
    (``ba`` (5, c) planes) as the kernel runs them (``csrc/df1_bank.cu``
    on df1_ring.cuh's `Df1WSerial` without the dither term): the producers'
    W = b0 x0 + b1 x1 + b2 x2 mod 2^64 as two 32-bit words a row and lane
    (rows -1, -2 of the block from the state), the serial warp's V = W + a2
    y2 (off its chain), acc = a1 y1 + V mod 2^64, y0 the low word of acc >>
    f -- for f <= 32 bits [f, f + 32) of acc (the funnel shift), for f >
    32 the high word shifted right by f - 32, sign-filled --, then the
    clamp, fed back; the store warp keeps the rows at block row % d == 0
    (``back``) and converts to ``out_dtype`` (f32: round to nearest);
    numpy uint64 words.  Returns (Df1State, ys) like the plain versions."""
    from idsp_tpu_torch.filters.biquad import Df1State

    t, c = xs.shape
    (a1, a2), xw, produce = _w_feed(ba, state.x, xs)
    y1 = _u64(state.y[:, 0].numpy().astype(np.int64)).copy()
    y2 = _u64(state.y[:, 1].numpy().astype(np.int64)).copy()

    def serial(words):
        nonlocal y1, y2
        out = np.empty((len(words), c, 1), np.int64)
        for j, w in enumerate(words.astype(np.uint64) & U32):
            v = (w[:, 1] << np.uint64(32) | w[:, 0]) + a2 * y2  # off the chain
            acc = a1 * y1 + v
            if f <= 32:
                y0 = ((acc >> np.uint64(f)) & U32).astype(np.uint32).view(
                    np.int32)
            else:
                hi = (acc >> np.uint64(32)).astype(np.uint32).view(np.int32)
                y0 = hi >> np.int32(f - 32)
            if clamp is not None:
                u, lo, hi_ = clamp
                y0 = np.clip((y0.astype(np.int64) + u).astype(np.int32),
                             lo, hi_).astype(np.int32)
            y2, y1 = y1, _u64(y0.astype(np.int64))
            out[j, :, 0] = y0
        return out

    kept = np.zeros((t // d, c), np.int64)

    def back(r0, words):
        r = np.arange(len(words))
        keep = (r0 + r) % d == 0
        kept[(r0 + r[keep]) // d] = words[keep, :, 0]

    with np.errstate(over="ignore"):
        pipe_run(t, c, plan, produce, span_rows, serial, seed=seed,
                 back=back)
    ys = kept.astype(np.int32)
    new = Df1State(
        x=torch.from_numpy(np.stack([xw[-1], xw[-2]], 1).view(
            np.int64).astype(np.int32)),
        y=torch.from_numpy(np.stack([y1, y2], 1).view(np.int64).astype(
            np.int32)))
    ys = torch.from_numpy(ys.astype(np.float32) if out_dtype == torch.float32
                          else ys)
    return new, ys


def _i32_bits(w):
    """The low 32 bits of uint64 words as int32."""
    return (w & U32).astype(np.uint32).view(np.int32)


def _sext(v):
    """int32 (or int64) values as the uint64 bits of their int64."""
    return np.asarray(v).astype(np.int64).view(np.uint64)


def wide_split_mul(y, a, add):
    """add + split_mul(y, a) as the wide serial warp forms it
    (``csrc/df1_ring.cuh`` `split_mul`), numpy uint64 words: the low
    product umulhi(y_lo, A) + y_lo * neg (A the unsigned reading of a, neg
    0 or -1 where a < 0) kept as 32 bits, sign-extended, beside y_hi a
    (y_hi the signed high word) multiplied onto add; mod 2^64."""
    a_s = np.asarray(a).view(np.int64)
    lo = y & U32
    neg = np.where(a_s < 0, U32, np.uint64(0))
    low = ((lo * (a & U32)) >> np.uint64(32)) + lo * neg
    hi = _i32_bits(y >> np.uint64(32)).astype(np.int64)
    return add + (hi * a_s).view(np.uint64) + _sext(_i32_bits(low))


def wide_model(ba, f, state, xs, plan, *, clamp=None, seed=0):
    """K25 (``ba`` (5,)) or K32 (``ba`` (5, c) planes) as the kernel runs
    it (``csrc/biquad_bank.cu`` on df1_ring.cuh's `Df1WideSerial`): the
    producers' W = b0 x0 + b1 x1 + b2 x2 mod 2^64 as two 32-bit words a row
    and lane (rows -1, -2 of the block from the state), the serial warp's
    V = W + split_mul(y2, a2) (off its chain), acc = V + split_mul(y1, a1)
    (`wide_split_mul`), the new high word bits [32 - s, 64 - s) of acc and
    the new low word acc's low word << s (s = 32 - f, the funnel shifts),
    y0 the high word; clamped, clip(y0 + u, lo, hi) (int32 + u wrapping)
    replaces it; numpy uint64 words.  Returns (Df1WideState, ys int32) like
    `df1_wide_bank_plain`."""
    from idsp_tpu_torch.filters.biquad import Df1WideState

    t, c = xs.shape
    (a1, a2), xw, produce = _w_feed(ba, state.x, xs)
    y1 = _u64(state.y[:, 0].numpy()).copy()
    y2 = _u64(state.y[:, 1].numpy()).copy()
    sh = np.uint64(32 - f)

    def serial(words):
        nonlocal y1, y2
        out = np.empty((len(words), c, 1), np.int64)
        for j, w in enumerate(words.astype(np.uint64) & U32):
            v = wide_split_mul(y2, a2, w[:, 1] << np.uint64(32) | w[:, 0])
            acc = wide_split_mul(y1, a1, v)
            hi = ((acc << sh) >> np.uint64(32)) & U32
            lo = ((acc & U32) << sh) & U32
            y0 = _i32_bits(hi)
            if clamp is not None:
                u, cl_lo, cl_hi = clamp
                y0 = np.clip((y0.astype(np.int64) + u).astype(np.int32),
                             cl_lo, cl_hi).astype(np.int32)
                hi = y0.view(np.uint32).astype(np.uint64)
            y2, y1 = y1, hi << np.uint64(32) | lo
            out[j, :, 0] = y0
        return out

    with np.errstate(over="ignore"):
        words = pipe_run(t, c, plan, produce, span_rows, serial, seed=seed)
    new = Df1WideState(
        x=torch.from_numpy(np.stack([xw[-1], xw[-2]], 1).view(
            np.int64).astype(np.int32)),
        y=torch.from_numpy(np.stack([y1, y2], 1).view(np.int64).copy()))
    return new, torch.from_numpy(words[..., 0].astype(np.int32))


def _shift_q(acc, f):
    """The low word of int64(acc) >> f as the serial warps take it: bits
    [f, f + 32) of acc for f <= 32, the high word shifted right by f - 32,
    sign-filled, for f > 32; uint64 words in, int32 out."""
    if f <= 32:
        return _i32_bits(acc >> np.uint64(f))
    return _i32_bits(acc >> np.uint64(32)) >> np.int32(f - 32)


def sos_model(ba, f, states, xs, plan, *, seed=0):
    """K24 as the kernel runs it (``csrc/biquad_bank.cu`` on df1_ring.cuh's
    `run_chain`): a tile a chain of ceil(N / g) ranks (g =
    ``plan.group``; ``plan.halves`` a CTA, which changes no value or
    schedule), rank j running stages [j g, (j + 1) g), every rank a
    depth-0 block -- ``plan.producers`` producers by spans, the serial
    warp, the store warp -- over rings of ``plan.ring`` slots of
    ``plan.chunk`` rows that start as garbage.  Rank 0's producers form
    stage 0's W = b0 x0 + b1 x1 + b2 x2 mod 2^64 from xs (rows -1, -2 from
    the state); a later rank's from its x slot: rows r + 2, r + 1, r for
    the chunk's row r, rows 0 and 1 the two rows before the chunk, which
    the rank before's store warp writes with the chunk's rows into an x
    slot that the rank's producers released (one arrival each on the rank
    before's x empty barrier, for a chunk it has still to fill), then
    arrives on the x slot's full barrier; the rank's producer 0 keeps block
    rows t - 1, t - 2 as its first stage's x state.  The serial warp runs
    its first stage as a1 y1 + (W + a2 y2), each later one as a1 y1 + (b0 x0
    + (b1 x1 + b2 x2 + a2 y2)), x0 the stage before's y0, each shifted by
    `_shift_q`; the last rank's store warp writes ys.  The roles of all
    ranks interleave at random (`run_roles`); numpy uint64 words.  Returns
    (states, ys int32) like `sos_bank_q_plain`."""
    from idsp_tpu_torch.filters.biquad import Df1State

    t, c = xs.shape
    table = np.asarray(ba, np.int64).reshape(-1, 5)
    n, g = len(table), plan.group
    G = -(-n // g)  # the chain's ranks, plan.halves a CTA
    assert plan.cluster == -(-G // plan.halves)
    K, R, P = plan.chunk, plan.ring, plan.producers
    span = -(-K // P)
    coef = [[_u64(np.full(c, v, np.int64)) for v in row] for row in table]
    st = [[_u64(s.x[:, 0].numpy().astype(np.int64)),
           _u64(s.x[:, 1].numpy().astype(np.int64)),
           _u64(s.y[:, 0].numpy().astype(np.int64)),
           _u64(s.y[:, 1].numpy().astype(np.int64))] for s in states]
    first_x = [None] * n  # each rank's first stage's x state out
    gen = np.random.default_rng(seed)
    chunks = [(cs, min(cs + K, t)) for cs in range(0, t, K)]
    ring_in = [gen.integers(0, 2**32, (R, K, c, 2)).astype(np.uint64)
               for _ in range(G)]
    ring_out = [gen.integers(0, 2**32, (R, K, c)).astype(np.uint64)
                for _ in range(G)]
    xring = [gen.integers(0, 2**32, (R, K + 2, c)).astype(np.uint64)
             for _ in range(G)]
    full_in = [[Bar(P) for _ in range(R)] for _ in range(G)]
    empty_in = [[Bar(1) for _ in range(R)] for _ in range(G)]
    full_out = [[Bar(1) for _ in range(R)] for _ in range(G)]
    empty_out = [[Bar(1) for _ in range(R)] for _ in range(G)]
    x_full = [[Bar(1) for _ in range(R)] for _ in range(G)]
    x_empty = [[Bar(P) for _ in range(R)] for _ in range(G)]  # the next's
    xw = _u64(np.concatenate([states[0].x[:, 1].numpy()[None],
                              states[0].x[:, 0].numpy()[None],
                              xs.numpy()]).astype(np.int64))
    y = np.full((t, c), -1, np.int64)
    written = np.zeros(t, np.int64)

    def w_of(b, x0, x1, x2):
        b0, b1, b2 = coef[b][:3]
        return (b0 * x0 + b1 * x1 + b2 * x2) & ~np.uint64(0)

    def producer(j, pw):
        s0 = j * g
        x1, x2 = st[s0][0].copy(), st[s0][1].copy()
        for q, (cs, ce) in enumerate(chunks):
            k, ph = q % R, (q // R) & 1
            rows = ce - cs
            yield lambda: empty_in[j][k].passes(ph ^ 1)
            if j > 0:
                yield lambda: x_full[j][k].passes(ph)
            lo = min(pw * span, rows)
            for r in range(lo, min(lo + span, rows)):
                if j == 0:
                    x = (xw[cs + r + 2], xw[cs + r + 1], xw[cs + r])
                else:
                    x = tuple(_sext(_i32_bits(xring[j][k, r + 2 - i]))
                              for i in range(3))
                w = w_of(s0, *x)
                ring_in[j][k, r] = np.stack([w & U32, w >> np.uint64(32)], -1)
            if j > 0 and ce == t:
                x1, x2 = xring[j][k, rows + 1].copy(), xring[j][k, rows].copy()
            full_in[j][k].arrive()
            if j > 0 and q + R < len(chunks):
                x_empty[j - 1][k].arrive()
        if pw == 0:
            first_x[s0] = (xw[-1], xw[-2]) if j == 0 else (x1, x2)

    def serial(j):
        s0 = j * g
        ss = range(s0, min(s0 + g, n))
        for q, (cs, ce) in enumerate(chunks):
            k, ph = q % R, (q // R) & 1
            yield lambda: full_in[j][k].passes(ph)
            yield lambda: empty_out[j][k].passes(ph ^ 1)
            for r in range(ce - cs):
                w = ring_in[j][k, r]
                v = None
                for s in ss:
                    x1, x2, y1, y2 = st[s]
                    b0, b1, b2, a1, a2 = coef[s]
                    if s == s0:
                        acc = a1 * y1 + ((w[:, 1] << np.uint64(32) | w[:, 0])
                                         + a2 * y2)
                    else:
                        acc = a1 * y1 + (b0 * v + (b1 * x1 + b2 * x2
                                                   + a2 * y2))
                    y0 = _sext(_shift_q(acc, f))
                    st[s] = [v if s > s0 else x1, x1 if s > s0 else x2,
                             y0, y1]
                    v = y0
                ring_out[j][k, r] = v & U32
            full_out[j][k].arrive()
            empty_in[j][k].arrive()

    def store(j):
        if j + 1 < G:  # into the next rank's x ring
            s1 = (j + 1) * g
            x1, x2 = st[s1][0].copy(), st[s1][1].copy()
        for q, (cs, ce) in enumerate(chunks):
            k, ph = q % R, (q // R) & 1
            rows = ce - cs
            yield lambda: full_out[j][k].passes(ph)
            if j + 1 < G:
                yield lambda: x_empty[j][k].passes(ph ^ 1)
                xring[j + 1][k, 0], xring[j + 1][k, 1] = x2, x1
                xring[j + 1][k, 2:rows + 2] = ring_out[j][k, :rows]
                x2 = ring_out[j][k, rows - 2].copy() if rows >= 2 else x1
                x1 = ring_out[j][k, rows - 1].copy()
                empty_out[j][k].arrive()
                x_full[j + 1][k].arrive()
            else:
                y[cs:ce] = ring_out[j][k, :rows].astype(np.int64)
                written[cs:ce] += 1
                empty_out[j][k].arrive()

    roles = []
    for j in range(G):
        roles += [producer(j, pw) for pw in range(P)]
        roles += [serial(j), store(j)]
    with np.errstate(over="ignore"):
        run_roles(roles, seed)
    assert bool((written == 1).all()), "a row was stored twice or never"
    out = []
    for s in range(n):
        x1, x2 = first_x[s] if first_x[s] is not None else st[s][:2]
        out.append(Df1State(
            x=torch.from_numpy(np.stack([x1, x2], 1).view(np.int64).astype(
                np.int32)),
            y=torch.from_numpy(np.stack(st[s][2:], 1).view(np.int64).astype(
                np.int32))))
    return out, torch.from_numpy(_i32_bits(y.view(np.uint64)).copy())


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


def normal_model(b, p, state, xs, plan, *, f=None, seed=0):
    """K35 (``f`` its Q<f> shift) or K36 (``f`` None) as the kernel runs it
    (``csrc/structures_bank.cu``).  K35: the producers' W = b0 x0 + b1 x1
    + b2 x2 mod 2^64 as two 32-bit words a row and lane (`_w_feed`, rows
    -1, -2 of the block from the state), the serial warp's acc1 = W + p_re
    y1 + (-p_im) y0 and acc0 = p_im y1 + p_re y0 mod 2^64, y1' and y0' the
    low words of acc >> f (`_shift_q`: the funnel shift for f <= 32, the
    high word's arithmetic shift above); numpy uint64 words.  K36: the
    producers' s = (b0 x0 + b1 x1) + b2 x2, the serial warp's y1' = (s +
    p_re y1) - p_im y0 and y0' = p_im y1 + p_re y0, numpy float32 with one
    rounding an operation; the words are the f32 bits.  Returns (Df1State,
    ys) like `normal_bank_q_plain` / `normal_bank_f32_plain`."""
    from idsp_tpu_torch.filters.biquad import Df1State

    t, c = xs.shape
    if f is None:
        b0, b1, b2 = (np.float32(v) for v in np.asarray(b).reshape(-1)[:3])
        p_re, p_im = (np.float32(v) for v in np.asarray(p).reshape(-1)[:2])
        xf = np.concatenate([state.x[:, 1].numpy()[None],
                             state.x[:, 0].numpy()[None],
                             xs.numpy()]).astype(np.float32)
        y0, y1 = (state.y[:, i].numpy().astype(np.float32) for i in (0, 1))

        def produce(r0, idx):
            g = r0 + idx + 2  # rows of xf
            s = (b0 * xf[g] + b1 * xf[g - 1]) + b2 * xf[g - 2]
            return s.view(np.int32)[..., None].astype(np.int64)

        def serial(words):
            nonlocal y0, y1
            out = np.empty((len(words), c, 1), np.int64)
            for j, w in enumerate(words[..., 0]):
                s = w.astype(np.int32).view(np.float32)
                y1n = (s + p_re * y1) - p_im * y0
                y0 = p_im * y1 + p_re * y0
                y1 = y1n
                out[j, :, 0] = y0.view(np.int32)
            return out

        words = pipe_run(t, c, plan, produce, span_rows, serial, seed=seed)
        new = Df1State(x=torch.from_numpy(np.stack([xf[-1], xf[-2]], 1)),
                       y=torch.from_numpy(np.stack([y0, y1], 1)))
        return new, torch.from_numpy(
            words[..., 0].astype(np.int32).view(np.float32))

    coefs = [int(v) for v in np.asarray(b).reshape(-1)[:3]] + [0, 0]
    _, xw, produce = _w_feed(coefs, state.x, xs)
    p_re, p_im = (_sext(int(v)) for v in np.asarray(p).reshape(-1)[:2])
    n_im = _sext(-int(np.asarray(p).reshape(-1)[1]))
    y0 = _sext(state.y[:, 0].numpy()).copy()
    y1 = _sext(state.y[:, 1].numpy()).copy()

    def serial_q(words):
        nonlocal y0, y1
        out = np.empty((len(words), c, 1), np.int64)
        for j, w in enumerate(words.astype(np.uint64) & U32):
            wide = w[:, 1] << np.uint64(32) | w[:, 0]
            acc1 = n_im * y0 + (p_re * y1 + wide)
            acc0 = p_im * y1 + p_re * y0
            y1, y0 = _sext(_shift_q(acc1, f)), _sext(_shift_q(acc0, f))
            out[j, :, 0] = _i32_bits(y0)
        return out

    with np.errstate(over="ignore"):
        words = pipe_run(t, c, plan, produce, span_rows, serial_q, seed=seed)
    new = Df1State(
        x=torch.from_numpy(np.stack([xw[-1], xw[-2]], 1).view(
            np.int64).astype(np.int32)),
        y=torch.from_numpy(np.stack([_i32_bits(y0), _i32_bits(y1)], 1)))
    return new, torch.from_numpy(words[..., 0].astype(np.int32))


def lp_rows(k, p, xs):
    """The Lowpass serial warp's rows (``csrc/lowpass.cuh`` `lp_step`):
    e = x - (p0 >> 32) saturating in int32, E = e k0; N = 1: y = (p0 + E)
    >> 32, p0 = (p0 + E) + E; N = 2: q = (p1 + (p1 >> 32) k1) + E, y = (p0
    + q) >> 32, p0 = p0 + q + q, p1 = q + q - p1; numpy uint64 words, the
    sums wrapping mod 2^64.  ``k`` the N gains, ``p`` [p0, p1 or None]
    uint64 lane vectors, updated; ``xs`` (rows, lanes) int64 words of
    int32 values.  Returns y (rows, lanes) int64."""
    k0 = np.int64(k[0])
    p0, p1 = p
    out = np.empty(xs.shape, np.int64)
    for j, x in enumerate(np.asarray(xs, np.int64)):
        h0 = _i32_bits(p0 >> np.uint64(32)).astype(np.int64)
        E = _u64(np.clip(x - h0, -(2**31), 2**31 - 1) * k0)
        if p1 is None:
            y = p0 + E
            p0 = y + E
        else:
            h = _i32_bits(p1 >> np.uint64(32)).astype(np.int64)
            q = p1 + _u64(h * np.int64(k[1])) + E
            y = p0 + q
            p0 = p0 + q + q
            p1 = q + q - p1
        out[j] = _i32_bits(y >> np.uint64(32))
    p[:] = [p0, p1]
    return out


def _lp_words(state, rows=None):
    """A LowpassState's p0 and p1 (or None) as uint64 lane vectors, of the
    state rows ``rows`` (all by default; 0 where a row is negative)."""
    p = state.p.numpy().astype(np.int64)
    if rows is not None:
        p = np.where((rows >= 0)[:, None], p[np.maximum(rows, 0)], 0)
    return [_u64(p[:, 0]).copy(),
            _u64(p[:, 1]).copy() if p.shape[1] == 2 else None]


def lowpass_model(k, state, xs, plan, *, dec=1, seed=0):
    """K4 as the kernel runs it (``csrc/lowpass_bank.cu``): the producers
    copy x by spans, the serial warp runs `lp_rows`, the store warp keeps
    the block's rows r with r % dec == 0 whatever the chunk
    (df1_ring.cuh `keep_store`).  Returns (LowpassState, ys int32) like
    `lowpass_bank_plain`."""
    from idsp_tpu_torch.filters.lowpass import LowpassState

    t, c = xs.shape
    k = [int(v) for v in np.asarray(k).reshape(-1)]
    p = _lp_words(state)
    xw = xs.numpy().astype(np.int64)

    def produce(r0, idx):
        return xw[r0 + idx][..., None]

    def serial(words):
        return lp_rows(k, p, words[..., 0])[..., None]

    kept = np.zeros((t // dec, c), np.int64)
    once = np.zeros(t // dec, np.int64)

    def back(r0, words):
        r = np.arange(len(words))
        keep = (r0 + r) % dec == 0
        kept[(r0 + r[keep]) // dec] = words[keep, :, 0]
        once[(r0 + r[keep]) // dec] += 1

    with np.errstate(over="ignore"):
        pipe_run(t, c, plan, produce, span_rows, serial, seed=seed,
                 back=back)
    assert bool((once == 1).all()), "a kept row written twice or never"
    new = LowpassState(p=torch.from_numpy(np.stack(
        [v for v in p if v is not None], 1).view(np.int64).copy()))
    return new, torch.from_numpy(kept.astype(np.int32))


def _w32(v):
    """int64 values wrapped to int32's range (the low 32 bits, signed)."""
    return (np.asarray(v, np.int64) + 2**31) % 2**32 - 2**31


def pll_rows(k, s, xs):
    """The PLL serial warp's rows (``csrc/pll.cuh`` `PllLane::step_grouped`)
    in numpy words: off the chain t = x0 ^ INT32_MIN, s1 = cl + (x0 < 0 ?
    -1 : 1), the candidates (INT32_MIN >> 1) + z0 and (INT32_MAX >> 1) + z0
    and each flag's pick among them, V = ((a1 hi(f0) + f0m) + umulhi(a1,
    lo(f0))) + b1 y0 (f0m: f0 with lo(f0) cleared where a1 < 0) and W = f +
    V; on it, with h = hi(f), xi = (x + y) + h, flag = (xi < t) != (x0 <
    0), s = s1 where flag else cl, y0 the
    candidate of s's sign ((xi >> 1) + z0 at 0), f = b0 y0 + W; then f0 =
    b0 y0 + V, y += h, x0 = xi, cl = clip(s, -1, 1), z0 = y0 - z0; int32
    words wrapped, int64 ones as uint64 sums mod 2^64.  ``k`` (b0, b1, a1),
    ``s`` the dict of lane vectors x0, cl, z0, y0, y (int64 holding int32)
    and f0, f (uint64), updated; ``xs`` (rows, lanes) int64 words of int32
    values.  Returns y (rows, lanes) int64 and s's values a row (rows,
    lanes), for the tests' coverage."""
    b0, b1, a1 = (np.int64(v) for v in k)
    x0, cl, z0, y0, y, f0, f = (s[n] for n in ("x0", "cl", "z0", "y0", "y",
                                               "f0", "f"))
    out = np.empty(xs.shape, np.int64)
    seen = np.empty(xs.shape, np.int64)
    for j, x in enumerate(np.asarray(xs, np.int64)):
        t = _w32(x0 + 2**31)  # x0 ^ INT32_MIN
        xneg = x0 < 0
        s1 = cl + np.where(xneg, -1, 1)
        ca, cb = _w32(z0 - 2**30), _w32(z0 + 2**30 - 1)
        k1, k0 = np.where(s1 < 0, ca, cb), np.where(cl < 0, ca, cb)
        f0hi = _i32_bits(f0 >> np.uint64(32)).astype(np.int64)
        f0m = f0 & ~U32 if a1 < 0 else f0  # lo(f0) cleared where a1 < 0
        uh = (np.uint64(int(a1) & 0xFFFFFFFF) * (f0 & U32)) >> np.uint64(32)
        v = ((_u64(a1 * f0hi) + f0m) + uh) + _u64(b1 * y0)
        w = f + v
        h = _i32_bits(f >> np.uint64(32)).astype(np.int64)
        xi = _w32(_w32(x + y) + h)
        flag = (xi < t) != xneg
        cx = _w32((xi >> 1) + z0)
        y0n = np.where(np.where(flag, s1 == 0, cl == 0), cx,
                       np.where(flag, k1, k0))
        st = np.where(flag, s1, cl)
        f = _u64(b0 * y0n) + w
        f0 = _u64(b0 * y0n) + v
        y = _w32(y + h)
        x0, cl, z0, y0 = xi, np.clip(st, -1, 1), _w32(y0n - z0), y0n
        out[j], seen[j] = y, st
    s.update(x0=x0, cl=cl, z0=z0, y0=y0, y=y, f0=f0, f=f)
    return out, seen


def pll_words(state):
    """A PllState's words as `pll_rows`' dict of numpy lane vectors."""
    def i64(v):
        return v.numpy().astype(np.int64)

    return {"x0": i64(state.clamp.x0), "cl": i64(state.clamp.clamp),
            "z0": i64(state.z0), "y0": i64(state.y0), "y": i64(state.y),
            "f0": _u64(i64(state.f0)).copy(), "f": _u64(i64(state.f)).copy()}


def pll_state(s):
    """`pll_words`' inverse: the PllState of a dict of lane vectors."""
    from idsp_tpu_torch.filters.pll import PllState
    from idsp_tpu_torch.ops.unwrap import ClampWrapState

    def t(v, dt):
        return torch.from_numpy(np.asarray(v).astype(dt))

    return PllState(
        clamp=ClampWrapState(x0=t(s["x0"], np.int32), clamp=t(s["cl"],
                                                               np.int8)),
        z0=t(s["z0"], np.int32), y0=t(s["y0"], np.int32),
        f0=t(s["f0"].view(np.int64), np.int64),
        f=t(s["f"].view(np.int64), np.int64), y=t(s["y"], np.int32))


def pll_model(ba, state, xs, plan, *, seed=0):
    """K5 as the kernel runs it (``csrc/pll_bank.cu``): the producers copy
    the phases by spans, the serial warp runs `pll_rows`, the store warp
    writes every row.  Returns (PllState, ys int32) like
    `pll_bank_plain`."""
    t, c = xs.shape
    k = [int(v) for v in np.asarray(ba).reshape(-1)[:3]]
    s = pll_words(state)
    xw = xs.numpy().astype(np.int64)

    def produce(r0, idx):
        return xw[r0 + idx][..., None]

    def serial(words):
        return pll_rows(k, s, words[..., 0])[0][..., None]

    with np.errstate(over="ignore"):
        y = pipe_run(t, c, plan, produce, span_rows, serial, seed=seed)
    return pll_state(s), torch.from_numpy(y[..., 0].astype(np.int32))


PAIR = 16  # channels of a K12/K13 tile


def pair_lanes(c):
    """K12/K13's paired lane map over ceil(c / PAIR) tiles of 32 lanes:
    model lane L is lane lid = L % 32 of tile L // 32, channel ch = PAIR *
    (L // 32) + lid % PAIR, its I lane (lid < PAIR) or its Q lane; row is
    the lane's state row and yiq column (I: ch, Q: c + ch); a lane of a
    channel past c is dead.  Returns (ch, is_q, live, row) numpy arrays."""
    lane = np.arange(-(-c // PAIR) * 2 * PAIR)
    lid = lane % (2 * PAIR)
    ch = lane // (2 * PAIR) * PAIR + lid % PAIR
    is_q = lid >= PAIR
    return ch, is_q, ch < c, np.where(is_q, c + ch, ch)


def bank_model(ba, f, state, phase0, steps, x, plan, *, d, time_chunk,
               clamp=None, pll_ba=None, pll_state=None, lp_gains=None,
               seed=0):
    """K12 (``pll_state`` None; with ``clamp`` the anti-windup DF1) or K13
    as the kernel runs it (``csrc/ddc_bank.cu``): the paired lane map
    (`pair_lanes`); the mix warps by spans, row r with the coarse factor
    r // ``time_chunk`` and the fine factor r % ``time_chunk`` (fastlo.cuh
    `fastlo_mix_rows`: numpy float32 operations, the rounding trunc(v +
    copysign(0.5, v)), the LO as u*cb -+ v*sb with u, v = ca, sa (I) or sa,
    ca (Q), 0 on a dead lane); the DF1 warp on the paired state
    rows; the back-end warp in the store warp's place: a chunk's kept rows
    -- block rows r with r % d == 0 -- to yiq, then for K13 atan2(Q, I) of
    two kept rows at once (the second row index clamped to the chunk's
    last) and one PLL step each, the second only where it is in the
    chunk.  Returns (Df1State, PllState or None, yiq int32) like
    `fastlo_df1_dec_bank_plain` / `fastlo_ddc_bank_block_plain`.  With
    ``lp_gains`` (K6; ``ba``, ``f`` and ``clamp`` unused) ``state`` is a
    LowpassState (2c, N), the serial warp is `lp_rows` on the paired
    lanes' state rows and the back end also writes each PLL step's output
    to y_pll at row (r0 + r) // d; returns (LowpassState, PllState, yiq
    int32, y_pll int32) like `fastlo_ddc_bank_block_lp_plain`'s."""
    from idsp_tpu_torch.filters.biquad import Df1State
    from idsp_tpu_torch.filters.pll_cuda import pll_bank_plain
    from idsp_tpu_torch.ops.fastlo import AMPLITUDE, fastlo_tables
    from idsp_tpu_torch.ops.trig import atan2

    t, c, tc, P = x.shape[0], phase0.shape[0], time_chunk, plan.producers
    ch, is_q, live, row = pair_lanes(c)
    lanes = len(ch)
    chs, rows_live = np.where(live, ch, 0), np.where(live, row, 0)
    ca, sa, cb, sb = (v.numpy() for v in fastlo_tables(phase0, steps, t, tc))
    xn = x.numpy()
    amp, half = np.float32(AMPLITUDE), np.float32(0.5)
    def produce(r0, idx):
        out = np.zeros((len(idx), lanes), np.int64)
        for j, r in enumerate(idx):
            cq, fr = divmod(r0 + int(r), tc)
            xh = np.float32(xn[r0 + r]) * amp
            u = np.where(is_q, sa[cq, chs], ca[cq, chs])
            w = np.where(is_q, ca[cq, chs], sa[cq, chs])
            p, q = u * cb[fr, chs], w * sb[fr, chs]
            v = (p + np.where(is_q, q, -q)) * xh
            v = np.where(is_q, -v, v)
            m = np.trunc(v + np.copysign(half, v)).astype(np.int64)
            out[j] = np.where(live, m, 0)
        return out[..., None]

    def lanes_of(v):
        return torch.from_numpy(np.where(live, v.numpy()[rows_live], 0))

    if lp_gains is None:
        s = [lanes_of(state.x[:, 0].to(torch.int64)),
             lanes_of(state.x[:, 1].to(torch.int64)),
             lanes_of(state.y[:, 0].to(torch.int64)),
             lanes_of(state.y[:, 1].to(torch.int64))]

        def serial(words):
            return df1_rows(ba, f, s, torch.from_numpy(words[..., 0]),
                            clamp).numpy()[..., None]
    else:
        k = [int(v) for v in np.asarray(lp_gains).reshape(-1)]
        lp = _lp_words(state, np.where(live, row, -1))

        def serial(words):
            with np.errstate(over="ignore"):
                return lp_rows(k, lp, words[..., 0])[..., None]

    yiq = np.zeros((t // d, 2 * c), np.int64)
    ypll = np.zeros((t // d, c), np.int64)
    kept_once = np.zeros(t // d, np.int64)
    i_lanes, q_lanes = live & ~is_q, live & is_q  # each in channel order
    pll = [pll_state]

    def back(r0, words):
        n = len(words)
        kept = np.arange((-r0) % d, n, d)
        yiq[np.ix_((r0 + kept) // d, row[live])] = words[kept][:, live, 0]
        kept_once[(r0 + kept) // d] += 1
        if pll_state is None:
            return
        for r in range((-r0) % d, n, 2 * d):
            pair = [r, min(r + d, n - 1)]
            w = words[pair, :, 0].astype(np.int32)
            ang = atan2(torch.from_numpy(w[:, q_lanes]),
                        torch.from_numpy(w[:, i_lanes]))
            two = r + d < n
            pll[0], yp = pll_bank_plain(pll_ba, pll[0], ang[:2 if two else 1])
            ypll[(r0 + r) // d] = yp[0].numpy()
            if two:
                ypll[(r0 + r) // d + 1] = yp[1].numpy()

    pipe_run(t, lanes, plan, produce, span_rows, serial, seed=seed,
             back=back)
    assert bool((kept_once == 1).all()), "a kept row written twice or never"
    if lp_gains is not None:
        from idsp_tpu_torch.filters.lowpass import LowpassState

        words = np.stack([v for v in lp if v is not None], 1).view(np.int64)
        p_new = state.p.clone()
        p_new[torch.from_numpy(row[live])] = torch.from_numpy(words[live])
        return (LowpassState(p=p_new), pll[0],
                torch.from_numpy(yiq.astype(np.int32)),
                torch.from_numpy(ypll.astype(np.int32)))
    sx, sy = state.x.clone(), state.y.clone()
    at, on = torch.from_numpy(row[live]), torch.from_numpy(live)
    for j, v in enumerate(s):
        (sx if j < 2 else sy)[at, j % 2] = v[on].to(torch.int32)
    return (Df1State(x=sx, y=sy), pll[0],
            torch.from_numpy(yiq.astype(np.int32)))


def lockin_model(ba, state, x, lo_freqs, n0, plan, *, time_chunk, seed=0):
    """K16 as the kernel runs it (``csrc/ddc_lockin.cu``) over the 2c I|Q
    lanes: the producers by spans form each row's LO as u*cb -+ v*sb (u, v
    = ca, sa for I, sa, ca for Q), the mix x*lo (negated for Q) and W =
    (b0 x0 + b1 x1) + b2 x2, a span's two rows before from their own mix
    (rows -1, -2 of the block: the state's x); the serial warp's y0 = (W +
    a1 y1) + a2 y2, a2 y2 formed a row ahead; numpy float32, each product
    and sum rounded on its own, the words the f32 bits.  Returns
    (Df1State, ys f32) like `ddc_lockin_bank_plain`."""
    from idsp_tpu_torch.filters.biquad import Df1State
    from idsp_tpu_torch.filters.ddc_lockin_cuda import _ba_f32, lockin_tables

    t, c, tc = x.shape[0], len(lo_freqs), time_chunk
    ca, sa, cb, sb = (v.numpy() for v in lockin_tables(
        lo_freqs, n0, t, tc, device=torch.device("cpu")))
    is_q = np.arange(2 * c) >= c
    ch = np.arange(2 * c) % c
    xn = x.numpy().astype(np.float32)
    b0, b1, b2, a1, a2 = (np.float32(v) for v in _ba_f32(ba))
    x1, x2 = (state.x[:, j].numpy().astype(np.float32) for j in (0, 1))
    y1, y2 = (state.y[:, j].numpy().astype(np.float32) for j in (0, 1))

    def mix(g):  # the mixed samples of block row g >= -2
        if g < 0:
            return x1 if g == -1 else x2
        k, b = divmod(g, tc)
        u = np.where(is_q, sa[k, ch], ca[k, ch])
        v = np.where(is_q, ca[k, ch], sa[k, ch])
        p, q = u * cb[b, ch], v * sb[b, ch]
        m = np.float32(xn[g]) * (p + np.where(is_q, q, -q))
        return np.where(is_q, -m, m)

    def produce(r0, idx):
        g = r0 + idx  # a span: consecutive rows
        m = [mix(int(g[0]) - 2), mix(int(g[0]) - 1)] + [mix(int(v))
                                                        for v in g]
        w = np.stack([(b0 * m[j + 2] + b1 * m[j + 1]) + b2 * m[j]
                      for j in range(len(g))])
        return w.view(np.int32).astype(np.int64)[..., None]

    def serial(words):
        nonlocal y1, y2
        out = np.empty((len(words), 2 * c, 1), np.int64)
        v = a2 * y2
        for j, w in enumerate(words[..., 0]):
            y0 = (w.astype(np.int32).view(np.float32) + a1 * y1) + v
            v = a2 * y1  # off the chain
            y2, y1 = y1, y0
            out[j, :, 0] = y0.view(np.int32)
        return out

    words = pipe_run(t, 2 * c, plan, produce, span_rows, serial, seed=seed)
    new = Df1State(x=torch.from_numpy(np.stack([mix(t - 1), mix(t - 2)], 1)),
                   y=torch.from_numpy(np.stack([y1, y2], 1)))
    return new, torch.from_numpy(words[..., 0].astype(np.int32).view(
        np.float32))


U16 = np.uint64(0xFFFF)


def q16_scale(f):
    """K28's scale of its coefficients and its shift (``csrc/
    biquad_precision.cu`` `idsp_df1_bank_q16`): s = max(16 - f, 0) and sh
    = f + s, so int32(2^s sum) >> sh keeps bits [f, f + 16) of the sum
    sign-extended (f < 16), or is int32(sum) >> f, already in int16 (f >=
    16)."""
    s = max(16 - f, 0)
    return s, f + s


def q16_model(ba, f, state, xs, plan, *, seed=0):
    """K28 as the kernel runs it (``csrc/biquad_precision.cu``): the
    coefficients times 2^s mod 2^32 (`q16_scale`); the producers' W = b0 x0
    + b1 x1 + b2 x2 mod 2^32, one word a row and lane, each product the
    coefficient times the sign-extended int16 row (rows -1, -2 of the block
    from the state); the serial warp's V = W + a2 y2 (off its chain), acc =
    V + a1 y1 mod 2^32, y0 = int32(acc) >> sh, held sign-extended and fed
    back; the store warp writes each word's low 16 bits; numpy uint64
    words masked to 32 bits.  Returns (Df1State, ys int16) like
    `df1_bank_q16_plain`."""
    from idsp_tpu_torch.filters.biquad import Df1State

    t, c = xs.shape
    s, sh = q16_scale(f)
    b0, b1, b2, a1, a2 = ((_sext(int(v)) << np.uint64(s)) & U32
                          for v in np.asarray(ba).reshape(-1)[:5])
    xw = _sext(np.concatenate([state.x[:, 1].numpy()[None],
                               state.x[:, 0].numpy()[None], xs.numpy()]))
    y1 = _sext(state.y[:, 0].numpy()).copy()
    y2 = _sext(state.y[:, 1].numpy()).copy()

    def produce(r0, idx):
        g = r0 + idx + 2  # rows of xw
        w = (b0 * xw[g] + b1 * xw[g - 1] + b2 * xw[g - 2]) & U32
        return w.astype(np.int64)[..., None]

    def serial(words):
        nonlocal y1, y2
        out = np.empty((len(words), c, 1), np.int64)
        for j, w in enumerate(words[..., 0].astype(np.uint64) & U32):
            v = w + a2 * y2  # off the chain
            acc = (v + a1 * y1) & U32
            y0 = _i32_bits(acc) >> np.int32(sh)
            y2, y1 = y1, _sext(y0)
            out[j, :, 0] = y0
        return out

    with np.errstate(over="ignore"):
        words = pipe_run(t, c, plan, produce, span_rows, serial, seed=seed)
    ys = (words[..., 0].astype(np.uint64) & U16).astype(np.uint16).view(
        np.int16)

    def i16(v):
        return (v & U16).astype(np.uint16).view(np.int16)

    new = Df1State(x=torch.from_numpy(np.stack([i16(xw[-1]), i16(xw[-2])],
                                               1)),
                   y=torch.from_numpy(np.stack([i16(y1), i16(y2)], 1)))
    return new, torch.from_numpy(ys.copy())


def f32_model(ba, state, xs, plan, *, seed=0):
    """K30 as the kernel runs it (``csrc/biquad_precision.cu`` on
    df1_ring.cuh's `f32_feed` and `Df1F32Serial`): the coefficients
    rounded to float32; the producers' W = (b0 x0 + b1 x1) + b2 x2 (rows
    -1, -2 of the block from the state); the serial warp's y0 = (W + a1 y1)
    + a2 y2, a2 y2 formed a row ahead; numpy float32, each product and sum
    rounded on its own, the words the f32 bits.  Returns (Df1State, ys
    f32) like `df1_bank_f32_plain`."""
    from idsp_tpu_torch.filters.biquad import Df1State

    t, c = xs.shape
    b0, b1, b2, a1, a2 = (np.float32(v) for v in np.asarray(
        ba, np.float64).reshape(-1)[:5])
    xf = np.concatenate([state.x[:, 1].numpy()[None],
                         state.x[:, 0].numpy()[None],
                         xs.numpy()]).astype(np.float32)
    y1, y2 = (state.y[:, j].numpy().astype(np.float32) for j in (0, 1))
    v = a2 * y2  # the next row's a2 y2

    def produce(r0, idx):
        g = r0 + idx + 2  # rows of xf
        w = (b0 * xf[g] + b1 * xf[g - 1]) + b2 * xf[g - 2]
        return w.view(np.int32).astype(np.int64)[..., None]

    def serial(words):
        nonlocal y1, y2, v
        out = np.empty((len(words), c, 1), np.int64)
        for j, w in enumerate(words[..., 0]):
            y0 = (w.astype(np.int32).view(np.float32) + a1 * y1) + v
            v = a2 * y1  # off the chain
            y2, y1 = y1, y0
            out[j, :, 0] = y0.view(np.int32)
        return out

    words = pipe_run(t, c, plan, produce, span_rows, serial, seed=seed)
    new = Df1State(x=torch.from_numpy(np.stack([xf[-1], xf[-2]], 1)),
                   y=torch.from_numpy(np.stack([y1, y2], 1)))
    return new, torch.from_numpy(words[..., 0].astype(np.int32).view(
        np.float32))
