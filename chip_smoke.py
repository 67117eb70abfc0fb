#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`idsp_tpu_torch`) on one NVIDIA GPU.

Builds the CUDA kernels from ``idsp_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version, drives the main paths -- the
headline DDC chain (`DdcChain`), the BASELINE #5 DDC bank in its Lowpass
(`DdcBank`) and biquad (`DdcBankBiquad`) variants and the BASELINE #4
rate conversion (`RoundTrip`, the CIC + half-band composite decimator,
CIC interpolation) -- through their kernel modes, checks the results and
times kernels, chain, banks and rate conversion.
Phases, each reported on its own line:

1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
2. the kernel build (nvcc, sm_90a, one process per source) and its time;
3. each kernel against its plain version over 3 carried blocks, t=32768:
   K1 `df1_bank_q`, K2 `df1_hbf_cascade_bank`, K3
   `fastlo_ddc_cascade_bank` at c=512 channels (1024 I|Q lanes); K4
   `lowpass_bank` (dec 16), K5 `pll_bank` (t/16 rows) and K6
   `fastlo_ddc_bank_block_lp` at c=1024 (2048 lanes), d=16; K7
   `hbf_dec_cascade_bank` (depth 4, (32768, 512) f32), K8
   `hbf_int_cascade_bank` (depth 4, (2048, 512) f32), K9 `cic_dec_bank`
   (N=3, R=16, (32768, 512) i32 in +-2^16) and K10 `cic_int_bank`
   ((2048, 512) i32 in +-2^10); K11 `df1_bank_q_dec`, K12
   `fastlo_df1_dec_bank` and K13 `fastlo_ddc_bank_block` at c=1024,
   d=16, time chunk 128; K14 `ddc_mix_df1_bank` (f32 out, x and steps
   full range) at c=512 and 1024; state, tails and outputs bit for bit
   (tolerance 0);
4. the main paths, each with every launch counter reset just before it
   and read just after:
   * `DdcChain` in ``split`` (K1), ``fused`` (K14), ``fold3`` (K2) and
     ``fastlo_fused`` (K3) over 3 blocks of a coherent carrier at c=512,
     and ``scan``, ``split``, ``fused`` at c=1024; ``split``/``fold3``
     integer state bit for bit against the ``scan`` oracle (outputs
     within 16 ULP of the output scale), ``fused`` output equal to
     ``split``'s and its state to ``scan``'s at both widths,
     ``fastlo_fused`` > 80 dB SNR on the expected bin;
   * `DdcBank` in ``scan``, ``exact`` (K4, K5), ``fast`` (K4, K5) and
     ``one_kernel`` (K6) over 3 blocks at its published width (c=1024,
     t=32768, d=16, gains2(0.004), PLL bandwidth 2e-2, x uniform in
     +-2^27, steps uniform in [2^24, 2^30)); ``exact`` equals ``scan``
     and ``one_kernel`` (time chunk 128) equals ``fast`` (fine length
     128) on every output and state word; then PLL acquisition
     (tests/test_rate_ddc_bank.py:57-84: 16 tones with offsets, gains2
     (0.001), one block) inside the 1024-channel bank in ``exact`` and
     ``one_kernel``, gated by that test's bounds;
   * `DdcBankBiquad` in ``scan``, ``exact`` (K11, K5), ``fast`` (K11,
     K5), ``fast_fused`` (K12, K5) and ``one_kernel`` (K13) over 3 blocks
     at the same width with the suite's Q29 lowpass at 0.004
     (benches/suite.py:1034-1042); ``exact`` equals ``scan``, and
     ``fast_fused`` and ``one_kernel`` equal ``fast``, on every output and
     state word; the same 16 tones with the lowpass at 0.001 lock in
     ``exact`` and ``one_kernel``, and ``fast_fused`` tracks ``exact``
     (the gates of tests/test_rate_ddc_bank.py:278-281);
   * BASELINE #4 at the suite's widths (benches/suite.py:796-851,
     c=512, t=32768): `RoundTrip` (depth 4, x ~ N(0, 1)) in ``scan`` and
     ``kernel`` (K7, K8), `cic_hbf_decimate_t` (CIC N=3 by 4, then
     half-band by 4; x in +-2^20) plain and with K9 + K7, and CIC
     interpolation (N=3, R=16, x in +-2^10) plain and with K10, over 3
     blocks: ``kernel`` within 32 ULP of ``scan``, the CIC state and the
     CIC interpolation bit for bit, the composite output within 16 ULP;
     then the quality gates of tests/test_rate_ddc_bank.py:11-54 in
     kernel mode, each lane with its own tone or level;
5. every kernel's launch counter > 0 from its main path's run;
6. CUDA-event times of each kernel and its plain version, of the plain
   layers around them (exact mix, time-major HBF, fast mix, atan2),
   chain rates at c=512 and c=1024 and bank rates at c=1024, in c*t
   full-rate samples/s, t=32768 (K14 and chain ``fused`` at c=512 and
   1024; K11-K13 and the biquad bank's five modes at c=1024); K7-K10 at
   c=512 and 1024 beside their
   library yardsticks (grouped `F.conv1d` per half-band stage, TF32
   off; chained `torch.cumsum` and `torch.diff` for the CIC),
   round-trip and composite
   rates at c=512 and 1024; for each kernel mode, the device's busy
   share (`torch.profiler` device time over the CUDA-event block time)
   with each device event's span count and time; the run's wall time.
   Each kernel's roofline bound (bytes over 3.35 TB/s or operations over
   the CUDA-core peak per instruction, the larger) is computed from the
   shapes; for the recurrences the log line adds an estimated latency
   floor, which the `kernels` line leaves out (it is not measured).

Any failure raises (non-zero exit).  Without a CUDA device it exits
non-zero before any result.  The last line is
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time

import numpy as np

T = 32768
BLOCKS = 3
C_MAIN, C_WIDE = 512, 1024
TC = 128  # fused-kernel time chunk (and fine-table length of the fast LO)
F0_STEP = 0x4000_0000  # LO at fs/4
OFF_STEP = 3 << 18  # carrier offset: bin 3 of a 2048-sample slice at t/8
C_BANK, DEC = 1024, 16  # BASELINE #5 (benches/suite.py:1016-1089)
C_RATE, DEPTH, CIC_R = 512, 4, 16  # BASELINE #4 (benches/suite.py:796-851)

# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the
# memory rate and its operations over the CUDA cores' peak for their
# type.  Rates of one H100 SXM at 700 W, per instruction: 3.35 TB/s and
# 67 Tflop/s f32 outside the tensor cores (NVIDIA's data sheet, which
# counts an FMA as two flops); the kernels issue every f32 multiply and
# add on its own (`__fmul_rn`, `__fadd_rn`, one instruction each), so
# f32 is taken at 128 lanes x 132 SMs x 1.98 GHz = 33.5e12 per second;
# int32 at 64 INT32 lanes per SM (Hopper whitepaper), 16.7e12.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
I32_OPS_PER_S = 16.7e12
# An estimate, not a measurement, printed on the log line only: the
# latency floor of a serial recurrence, its dependent operations per step
# (read off the source; each 64-bit operation counted once) at an assumed
# 4 cycles each (the fixed-latency ALU pipes) at the SM's maximum clock.
CYCLES_PER_DEPENDENT_OP = 4
BUSY_ITERS = 5  # chained blocks under the profiler per busy-share reading
M_DEC3, M_DEC4, M_INT4 = (5, 10, 23), (4, 5, 10, 23), (23, 10, 5, 4)


def fir_dec_ops(t, ms):
    """f32 operations of a decimation cascade per lane: 3m per output
    (m pair adds, m products, m-1 sums, the center add)."""
    return sum((t >> (d + 1)) * 3 * m for d, m in enumerate(ms))


def fir_int_ops(t, ms):
    """f32 operations of an interpolation cascade per lane: 3m-1 per FIR
    output, one FIR output per stage input row (the center is a copy)."""
    return sum((t << d) * (3 * m - 1) for d, m in enumerate(ms))


def work(name, c, t=T):
    """(bytes, f32 ops, int32 ops, serial steps, dependent ops per step)
    of one call of a kernel at the shapes phase 6 times it: c channels
    (2c I|Q lanes for K1-K6 and K11-K14, c lanes for K7-K10), t full-rate
    rows.  Operation counts are read off the kernels' sources."""
    c2 = 2 * c
    tails3 = 2 * 4 * sum(3 * m - 2 for m in M_DEC3) * c2
    tables = 2 * 4 * (t // TC + TC) * c  # fast-LO factor tables
    if name == "df1_bank_q":  # 5 products, 4 adds, shift, convert
        return 8 * t * c2 + 32 * c2, 0, 11 * t * c2, t, 3
    if name == "df1_hbf_cascade_bank":
        return (4 * t * c2 + 4 * (t // 8) * c2 + tails3 + 32 * c2,
                fir_dec_ops(t, M_DEC3) * c2, 11 * t * c2, t, 3)
    if name == "fastlo_ddc_cascade_bank":  # + 6 f32 ops of mix per sample
        return (4 * t + tables + 4 * (t // 8) * c2 + tails3 + 32 * c2,
                (6 * t + fir_dec_ops(t, M_DEC3)) * c2, 11 * t * c2, t, 3)
    if name == "lowpass_bank":  # Lowpass<2>: 9 int ops per sample
        return (4 * t * c2 + 4 * (t // DEC) * c2 + 32 * c2, 0,
                9 * t * c2, t, 8)
    if name == "pll_bank":  # about 25 int ops per kept row
        rows = t // DEC
        return 8 * rows * c + 72 * c, 0, 25 * rows * c, rows, 12
    if name == "fastlo_ddc_bank_block_lp":  # mix, 2 lowpasses, atan2+PLL
        return (4 * t + tables + 12 * (t // DEC) * c + 32 * c2 + 80 * c,
                6 * t * c2, 9 * t * c2 + 55 * (t // DEC) * c, t, 8)
    if name == "df1_bank_q_dec":  # K1's DF1, t/d rows out
        return 4 * t * c2 + 4 * (t // DEC) * c2 + 32 * c2, 0, 11 * t * c2, t, 3
    if name == "fastlo_df1_dec_bank":  # mix, 2 DF1s, t/d rows out
        return (4 * t + tables + 8 * (t // DEC) * c + 32 * c2, 6 * t * c2,
                11 * t * c2, t, 3)
    if name == "fastlo_ddc_bank_block":  # K12, then atan2 + PLL
        return (4 * t + tables + 8 * (t // DEC) * c + 32 * c2 + 72 * c,
                6 * t * c2, 11 * t * c2 + 55 * (t // DEC) * c, t, 3)
    if name == "ddc_mix_df1_bank":  # per channel and row: the LO 38 (once,
        # though the kernel's I and Q lanes each make it), then per lane
        # the mix 2 and the DF1 11
        return (4 * t + 8 * c + 4 * t * c2 + 32 * c2, 0,
                (38 + 2 * 2 + 2 * 11) * t * c, t, 3)
    if name == "hbf_dec_cascade_bank":
        return (4 * t * c + 4 * (t >> DEPTH) * c
                + 2 * 4 * sum(3 * m - 2 for m in M_DEC4) * c,
                fir_dec_ops(t, M_DEC4) * c, 0, 0, 0)
    if name == "hbf_int_cascade_bank":  # t low-rate rows in
        low = t >> DEPTH
        return (4 * low * c + 4 * t * c
                + 2 * 4 * sum(2 * m - 1 for m in M_INT4) * c,
                fir_int_ops(low, M_INT4) * c, 0, 0, 0)
    # K9/K10 as phase 6 times them, through the wrapper: the kernel's N = 3
    # wrapping adds per fast row and the plain combs' 3 subtractions per
    # slow row; state read and written once (integrators and combs, (c, 3)
    # each) and the zoh row written
    slow, state = t // CIC_R, 52 * c
    if name == "cic_dec_bank":
        return 4 * t * c + 4 * slow * c + state, 0, 3 * (t + slow) * c, t, 1
    if name == "cic_int_bank":  # t // R slow rows in, t fast rows out
        return 4 * slow * c + 4 * t * c + state, 0, 3 * (t + slow) * c, t, 1
    raise KeyError(name)


def bounds(name, c, sm_mhz):
    """(bound_ms, bound_by, estimated latency floor ms or None) of
    `work`."""
    nbytes, f32_ops, i32_ops, steps, chain = work(name, c)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(f32_ops / F32_OPS_PER_S, i32_ops / I32_OPS_PER_S)
    floor = (steps * chain * CYCLES_PER_DEPENDENT_OP / (sm_mhz * 1e6) * 1e3
             if steps else None)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", floor)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def leaves(x):
    if isinstance(x, tuple):
        for v in x:
            yield from leaves(v)
    else:
        yield x


def compare(name, got, want):
    """Largest |got - want| over all tensors of two (nested) results;
    raises unless they are equal bit for bit."""
    pairs = list(zip(leaves(got), leaves(want), strict=True))
    for g, w in pairs:
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
    err = max(max_abs(g, w) for g, w in pairs)
    if not all(bool((g == w).all()) for g, w in pairs):
        raise AssertionError(f"{name}: kernel differs from plain "
                             f"(max |d| {err})")
    return err


def snr_db(z):
    """Coherent-carrier SNR and peak bin of a 2048-sample complex slice."""
    spec = np.abs(np.fft.fft(z)) ** 2
    peak = int(np.argmax(spec))
    sig = slice(max(peak - 1, 0), peak + 2)
    p_sig = spec[sig].sum()
    return 10 * np.log10(p_sig / (spec.sum() - p_sig)), peak


def sm_clock_mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()
    return float(out[0])


def log_busy(timings, key, c, sec, card, step, state, *args):
    """Phase 6: one mode's busy share (`profiling.busy_share` over
    BUSY_ITERS blocks), with each device event's span count and device ms
    per block: a kernel launched k times per block shows k * BUSY_ITERS
    spans unless the profiler lost some of its records."""
    from idsp_tpu_torch.profiling import busy_share

    busy, window, by_name = busy_share(step, state, *args, iters=BUSY_ITERS)
    timings["busy_share"].setdefault(key, {})[c] = {
        "device_ms": busy * 1e3, "profiled_ms": window * 1e3,
        "ms": sec * 1e3,
        "spans": {k: [n, s * 1e3] for k, (n, s) in by_name.items()}}
    spans = ", ".join(f"{k} x{n} {s * 1e3:.3f} ms" for k, (n, s) in sorted(
        by_name.items(), key=lambda kv: -kv[1][1]))
    log(f"phase 6 c={c} {key} busy: device {busy * 1e3:.3f} ms of "
        f"{window * 1e3:.3f} ms/block under the profiler (share "
        f"{busy / window:.4f}; of the unprofiled block {busy / sec:.4f}); "
        f"spans in {BUSY_ITERS} blocks: {spans}  [{card}]")


def rate_inputs(dev, rng):
    """Input makers of the BASELINE #4 phases: (normal, ints)."""
    import torch

    def normal(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            dev)

    def ints(shape, lim):
        return torch.from_numpy(rng.integers(
            -lim, lim, size=shape, dtype=np.int64).astype(np.int32)).to(dev)

    return normal, ints


def check_rate_kernels(dev, rng, errs):
    """Phase 3 for K7-K10: each kernel against its plain version over
    BLOCKS carried blocks at c = C_RATE lanes, tolerance 0."""
    import torch
    from idsp_tpu_torch.filters import cic, hbf
    from idsp_tpu_torch.filters.cic_cuda import (
        cic_dec_bank, cic_dec_bank_plain, cic_int_bank, cic_int_bank_plain,
    )
    from idsp_tpu_torch.filters.hbf_cuda import (
        hbf_dec_cascade_bank, hbf_dec_cascade_bank_plain,
        hbf_int_cascade_bank, hbf_int_cascade_bank_plain,
    )

    normal, ints = rate_inputs(dev, rng)
    c, low, rate = C_RATE, T >> DEPTH, CIC_R - 1
    cases = (
        ("K7", hbf_dec_cascade_bank, hbf_dec_cascade_bank_plain,
         hbf.hbf_dec_cascade_init(DEPTH, (c,), axis=0, device=dev),
         lambda: (normal((T, c)),)),
        ("K8", hbf_int_cascade_bank, hbf_int_cascade_bank_plain,
         hbf.hbf_int_cascade_init(DEPTH, (c,), axis=0, device=dev),
         lambda: (normal((low, c)),)),
        ("K9", cic_dec_bank, cic_dec_bank_plain,
         cic.init(3, 1, (c,), device=dev),
         lambda: (ints((T, c), 2**16), rate)),
        ("K10", cic_int_bank, cic_int_bank_plain,
         cic.init(3, 1, (c,), device=dev),
         lambda: (ints((low, c), 2**10), rate)),
    )
    for tag, kern, plain, st, make_args in cases:
        name = kern.__name__
        err = 0.0
        for _ in range(BLOCKS):
            args = make_args()
            got = kern(st, *args)
            want = plain(st, *args)
            torch.cuda.synchronize()
            err = max(err, compare(name, got, want))
            st = got[0]
        errs[name] = err
        log(f"phase 3 {tag} {name} == plain over {BLOCKS} blocks (c={c}, "
            f"x {tuple(args[0].shape)}): max |d| {err}")


def ulp_bound(ref, k):
    """k * spacing(max |ref|) in f32 (tests/test_hbf_pallas.py:23-27)."""
    scale = np.float32(max(float(ref.abs().max()), 1.0))
    return k * float(np.spacing(scale))


def rate_main_path(dev, rng, wrappers):
    """Phase 4 for BASELINE #4: the round trip, the composite decimator
    and CIC interpolation, plain and through K7-K10, then the quality
    gates in kernel mode.  Returns the launch counts of the run."""
    import torch
    from idsp_tpu_torch.filters import cic, hbf
    from idsp_tpu_torch.filters.cic_cuda import cic_int_bank
    from idsp_tpu_torch.pipelines import rate_conversion as rc
    from idsp_tpu_torch.pipelines.rate_conversion import RoundTrip

    normal, ints = rate_inputs(dev, rng)
    c, rate = C_RATE, CIC_R - 1
    rt_x = [normal((T, c)) for _ in range(BLOCKS)]
    comp_x = [ints((T, c), 2**20) for _ in range(BLOCKS)]
    int_x = [ints((T // CIC_R, c), 2**10) for _ in range(BLOCKS)]

    for w in wrappers:
        w.launches = 0
    rt = {}
    for m in ("scan", "kernel"):
        mod = RoundTrip(m, DEPTH, c, device=dev)
        st, outs = mod.init_state(), []
        for xb in rt_x:
            st, y = mod(st, xb)
            outs.append((st, y))
        rt[m] = outs
    comp = {}
    for uk in (False, True):
        cs = cic.init(3, 1, (c,), device=dev)
        hs = hbf.hbf_dec_cascade_init(2, (c,), axis=0, device=dev)
        outs = []
        for xb in comp_x:
            (cs, hs), y = rc.cic_hbf_decimate_t(cs, hs, xb, 3, 2,
                                                use_kernel=uk)
            outs.append((cs, hs, y))
        comp[uk] = outs
    itp = {}
    for kern in (False, True):
        st, outs = cic.init(3, 1, (c,), device=dev), []
        for xb in int_x:
            if kern:
                st, y = cic_int_bank(st, xb, rate)
            else:
                st, y = cic.interpolate_block(st, xb, rate, axis=0)
            outs.append((st, y))
        itp[kern] = outs
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    log(f"phase 4 main path: RoundTrip (scan, kernel), cic_hbf_decimate_t "
        f"(plain, kernel), CIC interpolation (plain, kernel) x {BLOCKS} "
        f"blocks at c={c}, t={T}; launches {counts}")

    worst = bound = 0.0
    for (st, y), (st_r, y_r) in zip(rt["kernel"], rt["scan"]):
        if tuple(y.shape) != (T, c) or not bool(torch.isfinite(y).all()):
            raise AssertionError("RoundTrip kernel: bad output")
        bound = ulp_bound(y_r, 32)
        for a, b in zip(leaves((st, y)), leaves((st_r, y_r)), strict=True):
            worst = max(worst, max_abs(a, b))
        if worst > bound:
            raise AssertionError(f"RoundTrip kernel off scan by {worst} > "
                                 f"{bound}")
    log(f"phase 4 RoundTrip kernel vs scan over {BLOCKS} blocks: max |d| "
        f"{worst} (outputs and tails; gate 32 ULP = {bound})")
    worst = 0.0
    for b, ((cs, hs, y), (cs_r, hs_r, y_r)) in enumerate(
            zip(comp[True], comp[False])):
        compare(f"composite CIC state, block {b}", cs, cs_r)
        if tuple(y.shape) != (T // 16, c) or not bool(
                torch.isfinite(y).all()):
            raise AssertionError("composite decimator: bad output")
        bound = ulp_bound(y_r, 16)
        for a, r in zip(leaves((hs, y)), leaves((hs_r, y_r)), strict=True):
            worst = max(worst, max_abs(a, r))
        if worst > bound:
            raise AssertionError(f"composite decimator off plain by {worst} "
                                 f"> {bound}")
    log(f"phase 4 cic_hbf_decimate_t kernel: CIC state bit-exact vs plain; "
        f"max |d| of tails and output {worst} (gate 16 ULP = {bound})")
    for b, (got, want) in enumerate(zip(itp[True], itp[False])):
        compare(f"CIC interpolation, block {b}", got, want)
    log(f"phase 4 CIC interpolation kernel == plain on every output and "
        f"state word over {BLOCKS} blocks")

    # quality gates (tests/test_rate_ddc_bank.py:11-54), kernel mode, one
    # tone or level per lane
    lane = np.arange(c)
    n = 1 << 14
    f = (77 + lane * 153 // (c - 1)) / 12288  # whole periods from 4096 on
    x = np.cos(2 * np.pi * f[None] * np.arange(n)[:, None]
               + 2 * np.pi * lane[None] / c).astype(np.float32)
    mod = RoundTrip("kernel", 4, c, device=dev)
    _, y = mod(mod.init_state(), torch.from_numpy(x).to(dev))
    y = y.double().cpu().numpy()
    ratio = (y[4096:] ** 2).mean(0) / (x[4096:].astype(np.float64) ** 2).mean(0)
    tone = float(np.abs(ratio - 1).max())
    n = 1 << 13
    f = np.linspace(0.15, 0.45, c)
    x = np.cos(2 * np.pi * f[None] * np.arange(n)[:, None]).astype(np.float32)
    mod = RoundTrip("kernel", 2, c, device=dev)
    _, y = mod(mod.init_state(), torch.from_numpy(x).to(dev))
    stop = float((y.double().cpu().numpy()[2048:] ** 2).mean(0).max())
    level = 1000 + lane
    x = torch.from_numpy(np.broadcast_to(
        level[None], (20 * 64, c)).astype(np.int32).copy()).to(dev)
    (_, _), y = rc.cic_hbf_decimate_t(
        cic.init(3, 1, (c,), device=dev),
        hbf.hbf_dec_cascade_init(2, (c,), axis=0, device=dev), x, 4, 2,
        use_kernel=True)
    gain = cic.gain(4, 3, 1) * 4
    dc = float(np.abs(y[-1].double().cpu().numpy() / (level * gain) - 1).max())
    torch.cuda.synchronize()
    if not (tone < 1e-3 and stop < 0.5 * 10 ** (-98 / 10) and dc < 1e-3):
        raise AssertionError(f"rate-conversion gates: tone {tone}, stopband "
                             f"{stop}, DC {dc}")
    log(f"phase 4 rate-conversion gates on {c} lanes (kernel mode): round-"
        f"trip tone power |ratio - 1| max {tone:.3e} < 1e-3; depth-2 "
        f"stopband power max {stop:.3e} < {0.5 * 10 ** (-98 / 10):.3e}; "
        f"composite DC gain |err| max {dc:.3e} < 1e-3")
    return counts


def library_calls(x, low, xi, xl):
    """PyTorch library compositions of K7-K10's functions, timed as
    yardsticks (never used by the port), from a zero state: per
    half-band stage one grouped `F.conv1d` on time-last data (stride 2
    for decimation; two output channels per lane, FIR and center, for
    interpolation); for the CIC, N chained `torch.cumsum` for the
    integrators and N `torch.diff` for the combs at the slow rate.
    Returns name -> fn(_) -> output in the kernel's layout."""
    import torch
    import torch.nn.functional as F
    from idsp_tpu_torch.filters.hbf import HBF_TAPS

    c, dev = x.shape[1], x.device

    def dec_weight(tv):
        m = len(tv)
        h = np.zeros(4 * m - 1, np.float32)
        h[0:2 * m:2] = tv
        h[4 * m - 2:2 * m - 1:-2] = tv
        h[2 * m - 1] = 1.0
        return torch.from_numpy(h).to(dev).repeat(c, 1, 1)

    def int_weight(tv):
        m = len(tv)
        w = np.zeros((2, 2 * m), np.float32)
        w[0, :m] = tv
        w[0, 2 * m - 1:m - 1:-1] = tv
        w[1, m] = 1.0
        return torch.from_numpy(w).to(dev).repeat(c, 1)[:, None]

    dec = [(dec_weight(HBF_TAPS[DEPTH - 1 - i]),
            torch.zeros((1, c, 4 * len(HBF_TAPS[DEPTH - 1 - i]) - 3),
                        device=dev)) for i in range(DEPTH)]
    itp = [(int_weight(HBF_TAPS[i]),
            torch.zeros((1, c, 2 * len(HBF_TAPS[i]) - 1), device=dev))
           for i in range(DEPTH)]
    xt, lowt = x.T.contiguous()[None], low.T.contiguous()[None]

    def hbf_dec(_):
        cur = xt
        for w, hist in dec:
            cur = F.conv1d(torch.cat([hist, cur], -1), w, stride=2, groups=c)
        return cur[0].T

    def hbf_int(_):
        cur = lowt
        for w, hist in itp:
            y = F.conv1d(torch.cat([hist, cur], -1), w, groups=c)
            cur = y.view(1, c, 2, -1).transpose(2, 3).reshape(1, c, -1)
        return cur[0].T

    zero_row = torch.zeros((1, c), dtype=torch.int32, device=dev)

    def combs(cur):
        for _ in range(3):
            cur = torch.diff(cur, dim=0, prepend=zero_row)
        return cur

    def cic_dec(_):
        cur = xi
        for _ in range(3):
            cur = torch.cumsum(cur, 0, dtype=torch.int32)
        return combs(cur[::CIC_R])

    def cic_int(_):
        cur = torch.repeat_interleave(combs(xl), CIC_R, 0)
        for _ in range(3):
            cur = torch.cumsum(cur, 0, dtype=torch.int32)
        return cur

    return {"hbf_dec_cascade_bank": hbf_dec, "hbf_int_cascade_bank": hbf_int,
            "cic_dec_bank": cic_dec, "cic_int_bank": cic_int}


def time_rate(dev, rng, card, timings):
    """Phase 6 for BASELINE #4: K7-K10 beside their plain versions and
    library yardsticks, round-trip and composite rates, busy shares."""
    import torch
    from idsp_tpu_torch.filters import cic, hbf
    from idsp_tpu_torch.filters.cic_cuda import (
        cic_dec_bank, cic_dec_bank_plain, cic_int_bank, cic_int_bank_plain,
    )
    from idsp_tpu_torch.filters.hbf_cuda import (
        hbf_dec_cascade_bank, hbf_dec_cascade_bank_plain,
        hbf_int_cascade_bank, hbf_int_cascade_bank_plain,
    )
    from idsp_tpu_torch.pipelines import rate_conversion as rc
    from idsp_tpu_torch.pipelines.rate_conversion import RoundTrip
    from idsp_tpu_torch.profiling import measure_rate

    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions in f32
    normal, ints = rate_inputs(dev, rng)
    rate = CIC_R - 1
    timings["rate_samples_per_s"] = {}
    for c in (C_RATE, C_WIDE):
        x, low = normal((T, c)), normal((T >> DEPTH, c))
        xi, xl = ints((T, c), 2**16), ints((T // CIC_R, c), 2**10)
        dec0 = hbf.hbf_dec_cascade_init(DEPTH, (c,), axis=0, device=dev)
        int0 = hbf.hbf_int_cascade_init(DEPTH, (c,), axis=0, device=dev)
        cic0 = cic.init(3, 1, (c,), device=dev)
        cases = {
            "hbf_dec_cascade_bank": (
                lambda s: hbf_dec_cascade_bank(s, x),
                lambda s: hbf_dec_cascade_bank_plain(s, x), dec0),
            "hbf_int_cascade_bank": (
                lambda s: hbf_int_cascade_bank(s, low),
                lambda s: hbf_int_cascade_bank_plain(s, low), int0),
            "cic_dec_bank": (lambda s: cic_dec_bank(s, xi, rate),
                             lambda s: cic_dec_bank_plain(s, xi, rate), cic0),
            "cic_int_bank": (lambda s: cic_int_bank(s, xl, rate),
                             lambda s: cic_int_bank_plain(s, xl, rate), cic0),
        }
        libs = library_calls(x, low, xi, xl)
        for name, (kern, plain, st) in cases.items():
            lib_out = libs[name](None).double()
            ker_out = kern(st)[1].double()
            torch.cuda.synchronize()
            lib_d = float((lib_out - ker_out).abs().max())
            k_s, _ = measure_rate(kern, st, iters=20, trials=3)
            p_s, _ = measure_rate(plain, st, iters=5, trials=3)
            l_s, _ = measure_rate(libs[name], None, iters=10, trials=3,
                                  stateful=False)
            timings["kernels"].setdefault(name, {})[c] = {
                "ms": k_s * 1e3, "plain_ms": p_s * 1e3,
                "library_ms": l_s * 1e3}
            log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms, plain "
                f"{p_s * 1e3:.4f} ms, library {l_s * 1e3:.4f} ms (max |d| "
                f"library vs kernel {lib_d:.3e}, scale "
                f"{float(ker_out.abs().max()):.3e})  [{card}]")

        def comp(s, xb, uk):
            return rc.cic_hbf_decimate_t(s[0], s[1], xb, 3, 2, use_kernel=uk)

        xc = ints((T, c), 2**20)
        comp0 = (cic0, hbf.hbf_dec_cascade_init(2, (c,), axis=0, device=dev))
        runs = {f"round_trip_{m}": (RoundTrip(m, DEPTH, c, device=dev), None)
                for m in ("scan", "kernel")}
        runs["composite_plain"] = (lambda s, xb: comp(s, xb, False), comp0)
        runs["composite_kernel"] = (lambda s, xb: comp(s, xb, True), comp0)
        for name, (step, st) in runs.items():
            st = step.init_state() if st is None else st
            xb = xc if name.startswith("composite") else x
            sec, _ = measure_rate(step, st, xb, iters=10, trials=3)
            rate_s = c * T / sec
            timings["rate_samples_per_s"].setdefault(name, {})[c] = rate_s
            log(f"phase 6 c={c} {name}: {sec * 1e3:.4f} ms/block, "
                f"{rate_s:.6e} samples/s (c*t)  [{card}]")
            if "kernel" in name:
                log_busy(timings, name, c, sec, card, step, st, xb)


def hold(name, kern, plain, carry, make_x):
    """Phase 3: ``kern`` against ``plain`` over BLOCKS carried blocks,
    tolerance 0.  Both are called as ``fn(*carry, x)``; the first
    len(carry) results are the next carry.  Returns the largest |d|."""
    import torch

    err = 0.0
    for _ in range(BLOCKS):
        x = make_x()
        got = kern(*carry, x)
        want = plain(*carry, x)
        torch.cuda.synchronize()
        err = max(err, compare(name, got, want))
        carry = got[:len(carry)]
    return err


def check_biquad_kernels(dev, i32, errs, ba, ba_bank, pll_ba):
    """Phase 3 for K11-K14 at full width: K11-K13 at c = C_BANK (d = 16,
    time chunk TC), K14 at c = C_MAIN and C_WIDE with f32 output."""
    from idsp_tpu_torch.filters import biquad, pll
    from idsp_tpu_torch.filters.biquad_cuda import (
        df1_bank_q_dec, df1_bank_q_dec_plain,
    )
    from idsp_tpu_torch.filters.ddc_bank_cuda import (
        fastlo_ddc_bank_block, fastlo_ddc_bank_block_plain,
        fastlo_df1_dec_bank, fastlo_df1_dec_bank_plain,
    )
    from idsp_tpu_torch.filters.ddc_cuda import (
        ddc_mix_df1_bank, ddc_mix_df1_bank_plain,
    )
    import torch

    def df1_state(lanes):
        return biquad.Df1State(x=i32((lanes, 2), -(2**27), 2**27),
                               y=i32((lanes, 2), -(2**27), 2**27))

    def wide():
        return i32((T,), -(2**27), 2**27)

    c, cb2 = C_BANK, 2 * C_BANK
    steps = i32((c,), 1 << 24, 1 << 30)
    kw = {"d": DEC, "time_chunk": TC}
    errs["df1_bank_q_dec"] = hold(
        "df1_bank_q_dec",
        lambda s, xs: df1_bank_q_dec(ba_bank, s, xs, 29, d=DEC),
        lambda s, xs: df1_bank_q_dec_plain(ba_bank, s, xs, 29, d=DEC),
        (df1_state(cb2),), lambda: i32((T, cb2)))
    errs["fastlo_df1_dec_bank"] = hold(
        "fastlo_df1_dec_bank",
        lambda s, ph, x: fastlo_df1_dec_bank(ba_bank, s, ph, steps, x, 29,
                                             **kw),
        lambda s, ph, x: fastlo_df1_dec_bank_plain(ba_bank, s, ph, steps, x,
                                                   29, **kw),
        (df1_state(cb2), i32((c,))), wide)
    errs["fastlo_ddc_bank_block"] = hold(
        "fastlo_ddc_bank_block",
        lambda s, p, ph, x: fastlo_ddc_bank_block(ba_bank, pll_ba, s, p, ph,
                                                  steps, x, 29, **kw),
        lambda s, p, ph, x: fastlo_ddc_bank_block_plain(
            ba_bank, pll_ba, s, p, ph, steps, x, 29, **kw),
        (df1_state(cb2), pll.init((c,), device=dev), i32((c,))), wide)
    log(f"phase 3 K11 df1_bank_q_dec, K12 fastlo_df1_dec_bank, K13 "
        f"fastlo_ddc_bank_block == plain over {BLOCKS} blocks (c={c}, "
        f"t={T}, d={DEC}, time_chunk={TC}): max |d| "
        f"{errs['df1_bank_q_dec']}, {errs['fastlo_df1_dec_bank']}, "
        f"{errs['fastlo_ddc_bank_block']}")
    err = 0.0
    for c in (C_MAIN, C_WIDE):
        stp = i32((c,))  # full-range frequency words: every LO octant
        err = max(err, hold(
            "ddc_mix_df1_bank",
            lambda s, ph, x: ddc_mix_df1_bank(ba, s, ph, stp, x, 29,
                                              out_dtype=torch.float32),
            lambda s, ph, x: ddc_mix_df1_bank_plain(
                ba, s, ph, stp, x, 29, out_dtype=torch.float32),
            (df1_state(2 * c), i32((c,))), lambda: i32((T,))))
    errs["ddc_mix_df1_bank"] = err
    log(f"phase 3 K14 ddc_mix_df1_bank (f32 out) == plain over {BLOCKS} "
        f"blocks at c={C_MAIN} and {C_WIDE} (x full range): max |d| {err}")


def biquad_bank_main_path(dev, i32, rng, ba_bank, pll_ba, wrappers):
    """Phase 4 for the biquad DDC bank (`DdcBankBiquad`, c = C_BANK) in
    its five modes over BLOCKS blocks, then the 16-tone acquisition.
    Returns (launch counts, banks, inputs)."""
    import torch
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.pipelines.ddc_bank import (
        BIQUAD_MODES, DdcBankBiquad, make_tone_bank,
    )

    steps = i32((C_BANK,), 1 << 24, 1 << 30)
    banks = {m: DdcBankBiquad(m, steps, ba_bank, pll_ba, decimate=DEC,
                              time_chunk=TC) for m in BIQUAD_MODES}
    xs = [i32((T,), -(2**27), 2**27) for _ in range(BLOCKS)]
    for w in wrappers:
        w.launches = 0
    runs = {}
    for m, bank in banks.items():
        state, outs = bank.init_state(), []
        for xb in xs:
            state, out = bank(state, xb)
            outs.append((state, out))
        runs[m] = outs
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    log(f"phase 4 main path: DdcBankBiquad {BIQUAD_MODES} x {BLOCKS} blocks "
        f"at c={C_BANK}, t={T}, d={DEC}; launches {counts}")
    for m, ref in (("exact", "scan"), ("fast_fused", "fast"),
                   ("one_kernel", "fast")):
        for b, (got, want) in enumerate(zip(runs[m], runs[ref])):
            compare(f"DdcBankBiquad {m} vs {ref}, block {b}", got, want)
        log(f"phase 4 DdcBankBiquad {m} == {ref} on I, Q, freq and every "
            f"state word over {BLOCKS} blocks")
    for m in BIQUAD_MODES:
        yi, yq, freq = runs[m][-1][1]
        shapes = [tuple(v.shape) for v in (yi, yq, freq)]
        if shapes != [(T // DEC, C_BANK)] * 2 + [(C_BANK,)]:
            raise AssertionError(f"DdcBankBiquad {m}: output shapes {shapes}")

    # 16 tones in the 1024-channel bank (tests/test_rate_ddc_bank.py:
    # 57-84), the filter and gates of the biquad bank's own test (:226-281)
    n_tones = 16
    acq_rng = np.random.default_rng(2)
    acq_steps = rng.integers(1 << 24, 1 << 30, size=(C_BANK,)).astype(np.int32)
    acq_steps[:n_tones] = ((np.arange(n_tones) + 8) * (1 << 26)).astype(
        np.int64).astype(np.int32)
    offsets = acq_rng.integers(-(1 << 16), 1 << 16, size=n_tones,
                               dtype=np.int64).astype(np.int32)
    acq_x = make_tone_bank(acq_steps[:n_tones], T, amplitude=1 << 26,
                           offsets=offsets, device=dev)
    want_f = -(offsets.astype(np.int64) * DEC)
    ba_acq = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.001).lowpass()), 29)
    freqs = {}
    for m in ("exact", "fast_fused", "one_kernel"):
        bank = DdcBankBiquad(m, torch.from_numpy(acq_steps).to(dev), ba_acq,
                             pll_ba, decimate=DEC, time_chunk=TC)
        _, (_, _, freq) = bank(bank.init_state(), acq_x)
        freqs[m] = freq[:n_tones].cpu().numpy().astype(np.int64)

    def wrap(v):
        return np.abs((v + 2**31) % 2**32 - 2**31)

    for m in ("exact", "one_kernel"):
        err = wrap(freqs[m] - want_f)
        if not np.median(err) < 1 << 18:
            raise AssertionError(f"DdcBankBiquad {m}: PLL acquisition error "
                                 f"median {np.median(err)}")
        log(f"phase 4 DdcBankBiquad {m} acquisition: {n_tones} tones locked, "
            f"|freq err| median {float(np.median(err))} < {1 << 18}, max "
            f"{int(err.max())}")
    track = float(np.median(wrap(freqs["fast_fused"] - freqs["exact"])))
    lock = float(np.median(wrap(freqs["fast_fused"] - want_f)))
    if not (track < 1 << 12 and lock < 1 << 18):
        raise AssertionError(f"DdcBankBiquad fast_fused: median |freq - "
                             f"exact| {track}, |freq err| {lock}")
    log(f"phase 4 DdcBankBiquad fast_fused tracks exact: median |freq - "
        f"exact| {track} < {1 << 12}, |freq err| median {lock} < {1 << 18}")
    return counts, banks, xs


def main():
    wall0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")

    from idsp_tpu_torch import _ext
    from idsp_tpu_torch.chain import DdcChain, exact_mix
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.filters.biquad_cuda import (
        df1_bank_q, df1_bank_q_dec, df1_bank_q_dec_plain, df1_bank_q_plain,
    )
    from idsp_tpu_torch.filters.ddc_cuda import (
        ddc_mix_df1_bank, ddc_mix_df1_bank_plain,
        df1_hbf_cascade_bank, df1_hbf_cascade_bank_plain,
        fastlo_ddc_cascade_bank, fastlo_ddc_cascade_bank_plain,
        hbf1_tail_init,
    )
    from idsp_tpu_torch.filters import lowpass, pll
    from idsp_tpu_torch.filters.ddc_bank_cuda import (
        fastlo_ddc_bank_block, fastlo_ddc_bank_block_lp,
        fastlo_ddc_bank_block_lp_plain, fastlo_ddc_bank_block_plain,
        fastlo_df1_dec_bank, fastlo_df1_dec_bank_plain,
    )
    from idsp_tpu_torch.filters.hbf import hbf_dec_cascade
    from idsp_tpu_torch.filters.lowpass_cuda import (
        lowpass_bank, lowpass_bank_plain,
    )
    from idsp_tpu_torch.filters.pll_cuda import pll_bank, pll_bank_plain
    from idsp_tpu_torch.filters.cic_cuda import cic_dec_bank, cic_int_bank
    from idsp_tpu_torch.filters.hbf_cuda import (
        hbf_dec_cascade_bank, hbf_int_cascade_bank,
    )
    from idsp_tpu_torch.ops import accu
    from idsp_tpu_torch.ops.fastlo import fastlo_mix
    from idsp_tpu_torch.ops.trig import atan2, cossin
    from idsp_tpu_torch.ops.unwrap import ClampWrapState
    from idsp_tpu_torch.pipelines.ddc_bank import DdcBank, make_tone_bank
    from idsp_tpu_torch.profiling import measure_rate

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"phase 1 card: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {kind} x{count}")

    t0 = time.perf_counter()
    _ext.library()
    log(f"phase 2 build: {time.perf_counter() - t0:.2f} s")
    for line in _ext.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.02).lowpass()), 29)
    rng = np.random.default_rng(0)

    def i32(shape, lo=-(2**31), hi=2**31):
        a = rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)
        return torch.from_numpy(a).to(dev)

    def i64(shape, lo=-(2**62), hi=2**62):
        return torch.from_numpy(
            rng.integers(lo, hi, size=shape, dtype=np.int64)).to(dev)

    lp_gains = lowpass.gains2(0.004)
    pll_ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    # the biquad bank's filter, benches/suite.py:1034-1042
    ba_bank = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.004).lowpass()), 29)

    # ---- phase 3: each kernel against its plain version ---------------
    c2 = 2 * C_MAIN
    taps_ms = (5, 10, 23)
    errs = {}

    st = biquad.Df1State(x=i32((c2, 2)), y=i32((c2, 2)))
    err = 0.0
    for _ in range(BLOCKS):
        xs = i32((T, c2))
        got = df1_bank_q(ba, st, xs, 29, out_dtype=torch.float32)
        want = df1_bank_q_plain(ba, st, xs, 29, out_dtype=torch.float32)
        torch.cuda.synchronize()
        err = max(err, compare("df1_bank_q", got, want))
        st = got[0]
    errs["df1_bank_q"] = err
    log(f"phase 3 K1 df1_bank_q == plain over {BLOCKS} blocks "
        f"(c2={c2}, t={T}): max |d| {err}")

    st = biquad.df1_init((c2,), device=dev)
    tails = tuple(hbf1_tail_init(c2, m, device=dev) for m in taps_ms)
    err = 0.0
    for _ in range(BLOCKS):
        xs = i32((T, c2), -(2**27), 2**27)
        got = df1_hbf_cascade_bank(ba, st, tails, xs, 29, time_chunk=TC)
        want = df1_hbf_cascade_bank_plain(ba, st, tails, xs, 29)
        torch.cuda.synchronize()
        err = max(err, compare("df1_hbf_cascade_bank", got, want))
        st, tails = got[0], got[1]
    errs["df1_hbf_cascade_bank"] = err
    log(f"phase 3 K2 df1_hbf_cascade_bank == plain over {BLOCKS} blocks: "
        f"max |d| {err}")

    st = biquad.df1_init((c2,), device=dev)
    tails = tuple(hbf1_tail_init(c2, m, device=dev) for m in taps_ms)
    ph = i32((C_MAIN,))
    steps = i32((C_MAIN,), 1 << 24, 1 << 30)
    err = 0.0
    for _ in range(BLOCKS):
        x = i32((T,), -(2**27), 2**27)
        got = fastlo_ddc_cascade_bank(ba, st, tails, ph, steps, x, 29,
                                      time_chunk=TC)
        want = fastlo_ddc_cascade_bank_plain(ba, st, tails, ph, steps, x, 29,
                                             time_chunk=TC)
        torch.cuda.synchronize()
        err = max(err, compare("fastlo_ddc_cascade_bank", got, want))
        st, tails, ph = got[0], got[1], got[2]
    errs["fastlo_ddc_cascade_bank"] = err
    log(f"phase 3 K3 fastlo_ddc_cascade_bank == plain over {BLOCKS} blocks: "
        f"max |d| {err}")

    # K4-K6 at the bank's width: c = 1024 channels, 2048 I|Q lanes
    cb2 = 2 * C_BANK
    st = lowpass.LowpassState(p=i64((cb2, 2), -(2**50), 2**50))
    err = 0.0
    for _ in range(BLOCKS):
        xs = i32((T, cb2))  # full range: the saturating subtraction too
        got = lowpass_bank(lp_gains, st, xs, dec=DEC)
        want = lowpass_bank_plain(lp_gains, st, xs, dec=DEC)
        torch.cuda.synchronize()
        err = max(err, compare("lowpass_bank", got, want))
        st = got[0]
    errs["lowpass_bank"] = err
    log(f"phase 3 K4 lowpass_bank == plain over {BLOCKS} blocks "
        f"(lanes={cb2}, t={T}, dec={DEC}): max |d| {err}")

    st = pll.PllState(
        clamp=ClampWrapState(
            x0=i32((C_BANK,)),
            clamp=i32((C_BANK,), -1, 2).to(torch.int8)),
        z0=i32((C_BANK,)), y0=i32((C_BANK,)), f0=i64((C_BANK,)),
        f=i64((C_BANK,)), y=i32((C_BANK,)))
    err = 0.0
    for _ in range(BLOCKS):
        ph = i32((T // DEC, C_BANK))
        got = pll_bank(pll_ba, st, ph)
        want = pll_bank_plain(pll_ba, st, ph)
        torch.cuda.synchronize()
        err = max(err, compare("pll_bank", got, want))
        st = got[0]
    errs["pll_bank"] = err
    log(f"phase 3 K5 pll_bank == plain over {BLOCKS} blocks "
        f"(c={C_BANK}, rows={T // DEC}): max |d| {err}")

    carry = (lowpass.init(2, (cb2,), device=dev),
             pll.init((C_BANK,), device=dev), i32((C_BANK,)))
    steps = i32((C_BANK,), 1 << 24, 1 << 30)
    err = 0.0
    for _ in range(BLOCKS):
        x = i32((T,), -(2**27), 2**27)
        got = fastlo_ddc_bank_block_lp(lp_gains, pll_ba, *carry, steps, x,
                                       d=DEC, time_chunk=TC)
        want = fastlo_ddc_bank_block_lp_plain(lp_gains, pll_ba, *carry,
                                              steps, x, d=DEC, time_chunk=TC)
        torch.cuda.synchronize()
        err = max(err, compare("fastlo_ddc_bank_block_lp", got, want))
        carry = got[:3]
    errs["fastlo_ddc_bank_block_lp"] = err
    log(f"phase 3 K6 fastlo_ddc_bank_block_lp == plain over {BLOCKS} "
        f"blocks (c={C_BANK}, t={T}, d={DEC}, time_chunk={TC}): "
        f"max |d| {err}")
    check_rate_kernels(dev, rng, errs)
    check_biquad_kernels(dev, i32, errs, ba, ba_bank, pll_ba)

    # ---- phase 4: the main path ---------------------------------------
    steps_np = rng.integers(1 << 24, 1 << 30, size=(C_WIDE,)).astype(np.int32)
    steps_np[0] = F0_STEP
    steps_all = torch.from_numpy(steps_np).to(dev)
    # a clean carrier at f0 + offset, amplitude 2^27, 3 blocks in a row
    ph_in = accu.ramp(torch.tensor(123, dtype=torch.int32, device=dev),
                      torch.tensor(F0_STEP + OFF_STEP, dtype=torch.int32,
                                   device=dev), BLOCKS * T)
    carrier = ((cossin(ph_in)[0].to(torch.int64) * (1 << 27)) >> 31).to(
        torch.int32)
    xblocks = [carrier[i * T:(i + 1) * T].contiguous() for i in range(BLOCKS)]

    modes = ("scan", "split", "fused", "fold3", "fastlo_fused")
    chains = {m: DdcChain(m, steps_all[:C_MAIN], ba, time_chunk=TC)
              for m in modes}
    wrappers = (df1_bank_q, df1_hbf_cascade_bank, fastlo_ddc_cascade_bank,
                lowpass_bank, pll_bank, fastlo_ddc_bank_block_lp,
                hbf_dec_cascade_bank, hbf_int_cascade_bank, cic_dec_bank,
                cic_int_bank, df1_bank_q_dec, fastlo_df1_dec_bank,
                fastlo_ddc_bank_block, ddc_mix_df1_bank)
    chain_kernels = ("df1_bank_q", "df1_hbf_cascade_bank",
                     "fastlo_ddc_cascade_bank", "ddc_mix_df1_bank")
    bank_kernels = ("lowpass_bank", "pll_bank", "fastlo_ddc_bank_block_lp")
    biquad_kernels = ("df1_bank_q_dec", "fastlo_df1_dec_bank",
                      "fastlo_ddc_bank_block")
    rate_kernels = ("hbf_dec_cascade_bank", "hbf_int_cascade_bank",
                    "cic_dec_bank", "cic_int_bank")
    for w in wrappers:
        w.launches = 0
    # every mode at c = C_MAIN; the exact-LO modes also at c = C_WIDE
    wide_modes = ("scan", "split", "fused")
    runs, wide_runs = {}, {}
    for c, ms, into in ((C_MAIN, modes, runs), (C_WIDE, wide_modes,
                                                 wide_runs)):
        for m in ms:
            chain = chains[m] if c == C_MAIN else DdcChain(
                m, steps_all[:c], ba, time_chunk=TC)
            state = chain.init_state()
            outs = []
            for xb in xblocks:
                state, (zi, zq) = chain(state, xb)
                outs.append((zi, zq, state[0].x.clone(), state[0].y.clone(),
                             state[3].clone()))
            into[m] = outs
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    launches = {k: counts[k] for k in chain_kernels}
    log(f"phase 4 main path: DdcChain {modes} x {BLOCKS} blocks at "
        f"c={C_MAIN} and {wide_modes} at c={C_WIDE}, t={T}; launches "
        f"{counts}")

    # fused: the output of split word for word, the integer state of scan
    for c, rs in ((C_MAIN, runs), (C_WIDE, wide_runs)):
        for b, (f_run, s_run, o_run) in enumerate(
                zip(rs["fused"], rs["split"], rs["scan"])):
            compare(f"DdcChain fused vs split at c={c}, block {b}",
                    f_run[:2], s_run[:2])
            compare(f"DdcChain fused vs scan state at c={c}, block {b}",
                    f_run[2:], o_run[2:])
        log(f"phase 4 fused at c={c}: (zi, zq) == split's and DF1 state and "
            f"phase == scan's, bit for bit over {BLOCKS} blocks")

    for m in ("split", "fold3"):
        worst = 0.0
        for (zi, zq, sx, sy, ph), (ri, rq, rx, ry, rph) in zip(runs[m],
                                                             runs["scan"]):
            for a, b in ((sx, rx), (sy, ry), (ph, rph)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{m}: integer state differs from "
                                         "the scan oracle")
            scale = float(torch.maximum(ri.abs().max(), rq.abs().max()))
            bound = 16 * float(np.spacing(np.float32(2 * scale)))
            for got, want in ((zi.T, ri), (zq.T, rq)):
                if got.shape != want.shape or not bool(
                        torch.isfinite(got).all()):
                    raise AssertionError(f"{m}: bad output")
                worst = max(worst, max_abs(got, want))
            if worst > bound:
                raise AssertionError(f"{m}: output off the oracle by {worst}"
                                     f" > {bound}")
        log(f"phase 4 {m}: DF1 state and phase bit-exact vs scan; "
            f"max |output - scan| {worst}")

    zi, zq = runs["fastlo_fused"][0][:2]
    if tuple(zi.shape) != (T // 8, C_MAIN) or not bool(
            torch.isfinite(zi).all() & torch.isfinite(zq).all()):
        raise AssertionError("fastlo_fused: bad output")
    z = (zi[:, 0].double().cpu().numpy()
         + 1j * zq[:, 0].double().cpu().numpy())[1024:1024 + 2048]
    snr, peak = snr_db(z)
    expect = int(round(OFF_STEP * 8 / 2**32 * 2048)) % 2048
    if min(abs(peak - expect), 2048 - abs(peak - expect)) > 2 or snr <= 80.0:
        raise AssertionError(f"fastlo_fused: SNR {snr:.2f} dB at bin {peak}"
                             f" (want > 80 dB at bin {expect})")
    log(f"phase 4 fastlo_fused: SNR {snr:.3f} dB at bin {peak} "
        f"(expected {expect}, gate > 80 dB)")

    # ---- phase 4 (bank): the BASELINE #5 main path --------------------
    bank_modes = ("scan", "exact", "fast", "one_kernel")
    bank_steps = i32((C_BANK,), 1 << 24, 1 << 30)
    banks = {m: DdcBank(m, bank_steps, lp_gains, pll_ba, decimate=DEC,
                        time_chunk=TC) for m in bank_modes}
    bank_x = [i32((T,), -(2**27), 2**27) for _ in range(BLOCKS)]
    for w in wrappers:
        w.launches = 0
    bank_runs = {}
    for m in bank_modes:
        state = banks[m].init_state()
        outs = []
        for xb in bank_x:
            state, out = banks[m](state, xb)
            outs.append((state, out))
        bank_runs[m] = outs
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    for k in bank_kernels:
        launches[k] = counts[k]
    log(f"phase 4 main path: DdcBank {bank_modes} x {BLOCKS} blocks at "
        f"c={C_BANK}, t={T}, d={DEC}; launches {counts}")
    for m, ref in (("exact", "scan"), ("one_kernel", "fast")):
        for b, (got, want) in enumerate(zip(bank_runs[m], bank_runs[ref])):
            compare(f"DdcBank {m} vs {ref}, block {b}", got, want)
        log(f"phase 4 DdcBank {m} == {ref} on every output and state word "
            f"over {BLOCKS} blocks")
    for m in bank_modes:
        yi, yq, y_pll, freq = bank_runs[m][-1][1]
        shapes = [tuple(v.shape) for v in (yi, yq, y_pll, freq)]
        if shapes != [(T // DEC, C_BANK)] * 3 + [(C_BANK,)]:
            raise AssertionError(f"DdcBank {m}: output shapes {shapes}")

    # PLL acquisition (tests/test_rate_ddc_bank.py:57-84) in the bank
    n_tones = 16
    acq_rng = np.random.default_rng(0)
    acq_steps_np = rng.integers(1 << 24, 1 << 30, size=(C_BANK,)).astype(
        np.int32)
    acq_steps_np[:n_tones] = ((np.arange(n_tones) + 8) * (1 << 26)).astype(
        np.int64).astype(np.int32)
    offsets = acq_rng.integers(-(1 << 16), 1 << 16, size=n_tones,
                               dtype=np.int64).astype(np.int32)
    acq_x = make_tone_bank(acq_steps_np[:n_tones], T, amplitude=1 << 26,
                           offsets=offsets, device=dev)
    want_f = -(offsets.astype(np.int64) * DEC)
    for m in ("exact", "one_kernel"):
        bank = DdcBank(m, torch.from_numpy(acq_steps_np).to(dev),
                       lowpass.gains2(0.001), pll_ba, decimate=DEC,
                       time_chunk=TC)
        _, (_, _, _, freq) = bank(bank.init_state(), acq_x)
        f = freq[:n_tones].cpu().numpy().astype(np.int64)
        acq_err = np.abs((f - want_f + 2**31) % 2**32 - 2**31)
        med, worst = float(np.median(acq_err)), int(acq_err.max())
        if not (med < 1 << 16 and worst < (1 << 31) * 1e-4):
            raise AssertionError(f"DdcBank {m}: PLL acquisition error median"
                                 f" {med}, max {worst}")
        log(f"phase 4 DdcBank {m} acquisition: {n_tones} tones locked, "
            f"|freq err| median {med} < {1 << 16}, max {worst} < "
            f"{(1 << 31) * 1e-4:.1f}")

    # ---- phase 4 (biquad bank): the BASELINE #5 biquad variant --------
    counts, bq_banks, bq_x = biquad_bank_main_path(dev, i32, rng, ba_bank,
                                                   pll_ba, wrappers)
    for k in biquad_kernels:
        launches[k] = counts[k]

    # ---- phase 4 (rate conversion): the BASELINE #4 main path ---------
    counts = rate_main_path(dev, rng, wrappers)
    for k in rate_kernels:
        launches[k] = counts[k]

    # ---- phase 5: the main paths went through every kernel ------------
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name}: no launch in the main path")
    log(f"phase 5 launch counters > 0: {launches}")

    # ---- phase 6: times ------------------------------------------------
    timings = {"card": card, "t": T, "kernels": {}, "layers": {},
               "chain_samples_per_s": {}, "busy_share": {}}
    for c in (C_MAIN, C_WIDE):
        c2 = 2 * c
        st = biquad.df1_init((c2,), device=dev)
        tails = tuple(hbf1_tail_init(c2, m, device=dev) for m in taps_ms)
        xs = i32((T, c2), -(2**27), 2**27)
        x = xblocks[0]
        ph0 = torch.zeros((c,), dtype=torch.int32, device=dev)
        stp = steps_all[:c]
        cases = {
            "df1_bank_q": (
                lambda s: df1_bank_q(ba, s, xs, 29, out_dtype=torch.float32),
                lambda s: df1_bank_q_plain(ba, s, xs, 29,
                                           out_dtype=torch.float32)),
            "df1_hbf_cascade_bank": (
                lambda s: df1_hbf_cascade_bank(ba, s, tails, xs, 29,
                                               time_chunk=TC),
                lambda s: df1_hbf_cascade_bank_plain(ba, s, tails, xs, 29)),
            "fastlo_ddc_cascade_bank": (
                lambda s: fastlo_ddc_cascade_bank(ba, s, tails, ph0, stp, x,
                                                  29, time_chunk=TC),
                lambda s: fastlo_ddc_cascade_bank_plain(
                    ba, s, tails, ph0, stp, x, 29, time_chunk=TC)),
            "ddc_mix_df1_bank": (
                lambda s: ddc_mix_df1_bank(ba, s, ph0, stp, x, 29,
                                           out_dtype=torch.float32),
                lambda s: ddc_mix_df1_bank_plain(ba, s, ph0, stp, x, 29,
                                                 out_dtype=torch.float32)),
        }
        for name, (kern, plain) in cases.items():
            k_s, _ = measure_rate(kern, st, iters=20, trials=3)
            p_s, _ = measure_rate(plain, st, iters=1, trials=2)
            timings["kernels"].setdefault(name, {})[c] = {
                "ms": k_s * 1e3, "plain_ms": p_s * 1e3}
            log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms, plain "
                f"{p_s * 1e3:.2f} ms  [{card}]")
        # the plain layers around the kernels in the split/fold3 modes
        split = DdcChain("split", stp, ba)
        yiq = torch.from_numpy(
            rng.normal(0, 2**27, (T, c2)).astype(np.float32)).to(dev)
        dec = split.init_state()[1]
        layers = {
            "exact_mix": lambda _: exact_mix(x, ph0, stp),
            "hbf_dec8_time_major": lambda _: hbf_dec_cascade(dec, yiq, axis=0),
        }
        for name, fn in layers.items():
            sec, _ = measure_rate(fn, None, iters=10, trials=3, stateful=False)
            timings["layers"].setdefault(name, {})[c] = sec * 1e3
            log(f"phase 6 c={c} layer {name} (plain): {sec * 1e3:.4f} ms  "
                f"[{card}]")
        for m in modes:
            chain = DdcChain(m, stp, ba, time_chunk=TC)
            iters, trials = (1, 1) if m == "scan" else (10, 3)
            sec, _ = measure_rate(chain, chain.init_state(), x, iters=iters,
                                  trials=trials)
            rate = c * T / sec
            timings["chain_samples_per_s"].setdefault(m, {})[c] = rate
            log(f"phase 6 c={c} chain {m}: {sec * 1e3:.3f} ms/block, "
                f"{rate:.6e} samples/s (c*t)  [{card}]")
            if m != "scan":
                log_busy(timings, m, c, sec, card, chain, chain.init_state(),
                         x)
    # the bank at its published width
    c = C_BANK
    x = bank_x[0]
    ph0 = torch.zeros((c,), dtype=torch.int32, device=dev)
    lp0 = lowpass.init(2, (2 * c,), device=dev)
    pll0 = pll.init((c,), device=dev)
    xs = i32((T, 2 * c), -(2**26), 2**26)
    phd = i32((T // DEC, c))

    def k6(fn):
        def step(s):
            r = fn(lp_gains, pll_ba, *s, ph0, bank_steps, x, d=DEC,
                   time_chunk=TC)
            return ((r[0], r[1]),) + r[2:]
        return step

    cases = {
        "lowpass_bank": (
            lambda s: lowpass_bank(lp_gains, s, xs, dec=DEC),
            lambda s: lowpass_bank_plain(lp_gains, s, xs, dec=DEC), lp0),
        "pll_bank": (lambda s: pll_bank(pll_ba, s, phd),
                     lambda s: pll_bank_plain(pll_ba, s, phd), pll0),
        "fastlo_ddc_bank_block_lp": (
            k6(fastlo_ddc_bank_block_lp),
            k6(fastlo_ddc_bank_block_lp_plain), (lp0, pll0)),
    }

    def k13(fn):
        def step(s):
            r = fn(ba_bank, pll_ba, *s, ph0, bank_steps, x, 29, d=DEC,
                   time_chunk=TC)
            return ((r[0], r[1]),) + r[2:]
        return step

    bq0 = biquad.df1_init((2 * c,), device=dev)
    cases.update({
        "df1_bank_q_dec": (
            lambda s: df1_bank_q_dec(ba_bank, s, xs, 29, d=DEC),
            lambda s: df1_bank_q_dec_plain(ba_bank, s, xs, 29, d=DEC), bq0),
        "fastlo_df1_dec_bank": (
            lambda s: fastlo_df1_dec_bank(ba_bank, s, ph0, bank_steps, x, 29,
                                          d=DEC, time_chunk=TC),
            lambda s: fastlo_df1_dec_bank_plain(ba_bank, s, ph0, bank_steps,
                                                x, 29, d=DEC, time_chunk=TC),
            bq0),
        "fastlo_ddc_bank_block": (
            k13(fastlo_ddc_bank_block), k13(fastlo_ddc_bank_block_plain),
            (bq0, pll0)),
    })
    for name, (kern, plain, st) in cases.items():
        k_s, _ = measure_rate(kern, st, iters=20, trials=3)
        p_s, _ = measure_rate(plain, st, iters=1, trials=1)
        timings["kernels"].setdefault(name, {})[c] = {
            "ms": k_s * 1e3, "plain_ms": p_s * 1e3}
        log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms, plain "
            f"{p_s * 1e3:.2f} ms  [{card}]")
    layers = {
        "fastlo_mix": lambda _: fastlo_mix(x, ph0, bank_steps, TC),
        "atan2_decimated": lambda _: atan2(phd, phd.flip(0)),
    }
    for name, fn in layers.items():
        sec, _ = measure_rate(fn, None, iters=10, trials=3, stateful=False)
        timings["layers"].setdefault(name, {})[c] = sec * 1e3
        log(f"phase 6 c={c} layer {name} (plain): {sec * 1e3:.4f} ms  "
            f"[{card}]")
    timings["bank_samples_per_s"] = {}
    for m in bank_modes:
        bank = banks[m]
        iters, trials = (1, 1) if m == "scan" else (10, 3)
        sec, _ = measure_rate(bank, bank.init_state(), x, iters=iters,
                              trials=trials)
        rate = c * T / sec
        timings["bank_samples_per_s"][m] = rate
        log(f"phase 6 c={c} bank {m}: {sec * 1e3:.3f} ms/block, "
            f"{rate:.6e} samples/s (c*t)  [{card}]")
        if m != "scan":
            log_busy(timings, f"bank_{m}", c, sec, card, bank,
                     bank.init_state(), x)
    timings["biquad_bank_samples_per_s"] = {}
    for m, bank in bq_banks.items():
        iters, trials = (1, 1) if m == "scan" else (10, 3)
        sec, _ = measure_rate(bank, bank.init_state(), bq_x[0], iters=iters,
                              trials=trials)
        rate = c * T / sec
        timings["biquad_bank_samples_per_s"][m] = rate
        log(f"phase 6 c={c} biquad bank {m}: {sec * 1e3:.3f} ms/block, "
            f"{rate:.6e} samples/s (c*t)  [{card}]")
        if m != "scan":
            log_busy(timings, f"biquad_bank_{m}", c, sec, card, bank,
                     bank.init_state(), bq_x[0])
    time_rate(dev, rng, card, timings)
    print(json.dumps({"timings": timings}), flush=True)

    sources = {
        "df1_bank_q": ("idsp_tpu_torch/csrc/df1_bank.cu",
                       "idsp_tpu/filters/biquad_pallas.py:225"),
        "df1_hbf_cascade_bank": ("idsp_tpu_torch/csrc/ddc_cascade.cu",
                                 "idsp_tpu/filters/ddc_pallas.py:789"),
        "fastlo_ddc_cascade_bank": ("idsp_tpu_torch/csrc/ddc_cascade.cu",
                                    "idsp_tpu/filters/ddc_pallas.py:1298"),
        "lowpass_bank": ("idsp_tpu_torch/csrc/lowpass_bank.cu",
                         "idsp_tpu/filters/lowpass_pallas.py:69"),
        "pll_bank": ("idsp_tpu_torch/csrc/pll_bank.cu",
                     "idsp_tpu/filters/pll_pallas.py:93"),
        "df1_bank_q_dec": ("idsp_tpu_torch/csrc/df1_bank.cu",
                           "idsp_tpu/filters/biquad_pallas.py:290"),
        "fastlo_df1_dec_bank": ("idsp_tpu_torch/csrc/ddc_bank.cu",
                                "idsp_tpu/filters/ddc_pallas.py:870"),
        "fastlo_ddc_bank_block": ("idsp_tpu_torch/csrc/ddc_bank.cu",
                                  "idsp_tpu/filters/ddc_pallas.py:1018"),
        "ddc_mix_df1_bank": ("idsp_tpu_torch/csrc/ddc_mix_df1.cu",
                             "idsp_tpu/filters/ddc_pallas.py:47"),
        "fastlo_ddc_bank_block_lp": ("idsp_tpu_torch/csrc/ddc_bank.cu",
                                     "idsp_tpu/filters/ddc_pallas.py:1066"),
        "hbf_dec_cascade_bank": ("idsp_tpu_torch/csrc/hbf_cascade.cu",
                                 "idsp_tpu/filters/hbf_pallas.py:52"),
        "hbf_int_cascade_bank": ("idsp_tpu_torch/csrc/hbf_cascade.cu",
                                 "idsp_tpu/filters/hbf_pallas.py:210"),
        "cic_dec_bank": ("idsp_tpu_torch/csrc/cic_bank.cu",
                         "idsp_tpu/filters/cic_pallas.py:83"),
        "cic_int_bank": ("idsp_tpu_torch/csrc/cic_bank.cu",
                         "idsp_tpu/filters/cic_pallas.py:131"),
    }
    sm_mhz = sm_clock_mhz()
    kernels = []
    for name, (src, rep) in sources.items():
        c = (C_MAIN if name in chain_kernels else
             C_BANK if name in bank_kernels + biquad_kernels else C_RATE)
        timed = timings["kernels"][name][c]
        bound_ms, bound_by, floor_ms = bounds(name, c, sm_mhz)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timed.get("library_ms"), "c": c})
        nbytes, f32_ops, i32_ops, steps, chain = work(name, c)
        log(f"bound {name} at c={c}: {bound_ms:.6f} ms ({bound_by}: "
            f"{nbytes / 1e6:.2f} MB, {f32_ops / 1e6:.1f} M f32 ops, "
            f"{i32_ops / 1e6:.1f} M int32 ops); estimated latency floor "
            f"{floor_ms} ms ({steps} steps x {chain} dependent ops x "
            f"{CYCLES_PER_DEPENDENT_OP} cycles at {sm_mhz:.0f} MHz, not "
            f"measured); kernel {timed['ms']:.4f} ms")
    log(f"wall time {time.perf_counter() - wall0:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
