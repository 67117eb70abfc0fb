#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`idsp_tpu_torch`) on one NVIDIA GPU.

Builds the CUDA kernels from ``idsp_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version, drives the two main paths -- the
headline DDC chain (`DdcChain`) and the BASELINE #5 DDC bank (`DdcBank`)
-- through their kernel modes, checks the results and times kernels,
chain and bank.  Phases, each reported on its own line:

1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
2. the kernel build (nvcc, sm_90a, one process per source) and its time;
3. each kernel against its plain version over 3 carried blocks, t=32768:
   K1 `df1_bank_q`, K2 `df1_hbf_cascade_bank`, K3
   `fastlo_ddc_cascade_bank` at c=512 channels (1024 I|Q lanes); K4
   `lowpass_bank` (dec 16), K5 `pll_bank` (t/16 rows) and K6
   `fastlo_ddc_bank_block_lp` at c=1024 (2048 lanes), d=16; state,
   tails and outputs bit for bit (tolerance 0);
4. the main paths, each with every launch counter reset just before it
   and read just after:
   * `DdcChain` in ``split`` (K1), ``fold3`` (K2) and ``fastlo_fused``
     (K3) over 3 blocks of a coherent carrier at c=512; ``split``/
     ``fold3`` integer state bit for bit against the ``scan`` oracle
     (outputs within 16 ULP of the output scale), ``fastlo_fused``
     > 80 dB SNR on the expected bin;
   * `DdcBank` in ``scan``, ``exact`` (K4, K5), ``fast`` (K4, K5) and
     ``one_kernel`` (K6) over 3 blocks at its published width (c=1024,
     t=32768, d=16, gains2(0.004), PLL bandwidth 2e-2, x uniform in
     +-2^27, steps uniform in [2^24, 2^30)); ``exact`` equals ``scan``
     and ``one_kernel`` (time chunk 128) equals ``fast`` (fine length
     128) on every output and state word; then PLL acquisition
     (tests/test_rate_ddc_bank.py:57-84: 16 tones with offsets, gains2
     (0.001), one block) inside the 1024-channel bank in ``exact`` and
     ``one_kernel``, gated by that test's bounds;
5. every kernel's launch counter > 0 from its main path's run;
6. CUDA-event times of each kernel and its plain version, of the plain
   layers around them (exact mix, time-major HBF, fast mix, atan2),
   chain rates at c=512 and c=1024 and bank rates at c=1024, in c*t
   full-rate samples/s, t=32768; for each kernel mode, the device's
   busy share (`torch.profiler` device time over the CUDA-event block
   time); the run's wall time.

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
        df1_bank_q, df1_bank_q_plain,
    )
    from idsp_tpu_torch.filters.ddc_cuda import (
        df1_hbf_cascade_bank, df1_hbf_cascade_bank_plain,
        fastlo_ddc_cascade_bank, fastlo_ddc_cascade_bank_plain,
        hbf1_tail_init,
    )
    from idsp_tpu_torch.filters import lowpass, pll
    from idsp_tpu_torch.filters.ddc_bank_cuda import (
        fastlo_ddc_bank_block_lp, fastlo_ddc_bank_block_lp_plain,
    )
    from idsp_tpu_torch.filters.hbf import hbf_dec_cascade
    from idsp_tpu_torch.filters.lowpass_cuda import (
        lowpass_bank, lowpass_bank_plain,
    )
    from idsp_tpu_torch.filters.pll_cuda import pll_bank, pll_bank_plain
    from idsp_tpu_torch.ops import accu
    from idsp_tpu_torch.ops.fastlo import fastlo_mix
    from idsp_tpu_torch.ops.trig import atan2, cossin
    from idsp_tpu_torch.ops.unwrap import ClampWrapState
    from idsp_tpu_torch.pipelines.ddc_bank import DdcBank, make_tone_bank
    from idsp_tpu_torch.profiling import busy_share, measure_rate

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

    modes = ("scan", "split", "fold3", "fastlo_fused")
    chains = {m: DdcChain(m, steps_all[:C_MAIN], ba, time_chunk=TC)
              for m in modes}
    wrappers = (df1_bank_q, df1_hbf_cascade_bank, fastlo_ddc_cascade_bank,
                lowpass_bank, pll_bank, fastlo_ddc_bank_block_lp)
    chain_kernels = ("df1_bank_q", "df1_hbf_cascade_bank",
                     "fastlo_ddc_cascade_bank")
    for w in wrappers:
        w.launches = 0
    runs = {}
    for m in modes:
        state = chains[m].init_state()
        outs = []
        for xb in xblocks:
            state, (zi, zq) = chains[m](state, xb)
            outs.append((zi, zq, state[0].x.clone(), state[0].y.clone(),
                         state[3].clone()))
        runs[m] = outs
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    launches = {k: counts[k] for k in chain_kernels}
    log(f"phase 4 main path: DdcChain {modes} x {BLOCKS} blocks at "
        f"c={C_MAIN}, t={T}; launches {counts}")

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
    for w in wrappers[len(chain_kernels):]:
        launches[w.__name__] = counts[w.__name__]
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
            if m == "scan":
                continue
            busy, window = busy_share(chain, chain.init_state(), x, iters=5)
            timings["busy_share"].setdefault(m, {})[c] = {
                "device_ms": busy * 1e3, "profiled_ms": window * 1e3,
                "ms": sec * 1e3}
            log(f"phase 6 c={c} chain {m} busy: device {busy * 1e3:.3f} ms "
                f"of {window * 1e3:.3f} ms/block under the profiler "
                f"(share {busy / window:.4f}; of the unprofiled block "
                f"{busy / sec:.4f})  [{card}]")
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
        if m == "scan":
            continue
        busy, window = busy_share(bank, bank.init_state(), x, iters=5)
        timings["busy_share"].setdefault(f"bank_{m}", {})[c] = {
            "device_ms": busy * 1e3, "profiled_ms": window * 1e3,
            "ms": sec * 1e3}
        log(f"phase 6 c={c} bank {m} busy: device {busy * 1e3:.3f} ms of "
            f"{window * 1e3:.3f} ms/block under the profiler (share "
            f"{busy / window:.4f}; of the unprofiled block "
            f"{busy / sec:.4f})  [{card}]")
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
        "fastlo_ddc_bank_block_lp": ("idsp_tpu_torch/csrc/ddc_bank.cu",
                                     "idsp_tpu/filters/ddc_pallas.py:1066"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        c = C_MAIN if name in chain_kernels else C_BANK
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": timings["kernels"][name][c]["ms"],
            "plain_ms": timings["kernels"][name][c]["plain_ms"]})
    log(f"wall time {time.perf_counter() - wall0:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
