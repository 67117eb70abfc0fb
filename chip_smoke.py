#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`idsp_tpu_torch`) on one NVIDIA GPU.

Builds the CUDA kernels from ``idsp_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version, drives the headline DDC chain
(`DdcChain`) through its kernel modes, checks the results and times
kernels and chain.  Phases, each reported on its own line:

1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
2. the kernel build (nvcc, sm_90a) and its time;
3. K1 `df1_bank_q`, K2 `df1_hbf_cascade_bank`, K3
   `fastlo_ddc_cascade_bank`, each against its plain version at c=512
   channels (1024 I|Q lanes), t=32768, over 3 carried blocks: state,
   tails and outputs bit for bit (tolerance 0);
4. the main path: `DdcChain` in ``split`` (K1), ``fold3`` (K2) and
   ``fastlo_fused`` (K3) over 3 blocks of a coherent carrier, launch
   counters reset just before; ``split``/``fold3`` integer state bit for
   bit against the ``scan`` oracle (outputs within 16 ULP of the output
   scale), ``fastlo_fused`` > 80 dB SNR on the expected bin;
5. every kernel's launch counter > 0 from that run;
6. CUDA-event times of each kernel and its plain version, of the plain
   layers around them (exact mix, time-major HBF), and chain rates in
   c*t full-rate samples/s, at c=512 and c=1024, t=32768; for each
   kernel mode, the device's busy share (`torch.profiler` device time
   over the CUDA-event block time).

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
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")

    from idsp_tpu_torch import _ext
    from idsp_tpu_torch.chain import DdcChain
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
    from idsp_tpu_torch.filters.hbf import hbf_dec_cascade
    from idsp_tpu_torch.ops import accu
    from idsp_tpu_torch.ops.trig import cossin
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
    wrappers = (df1_bank_q, df1_hbf_cascade_bank, fastlo_ddc_cascade_bank)
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
    launches = {w.__name__: w.launches for w in wrappers}
    log(f"phase 4 main path: DdcChain {modes} x {BLOCKS} blocks at "
        f"c={C_MAIN}, t={T}; launches {launches}")

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

    # ---- phase 5: the main path went through every kernel -------------
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
            "exact_mix": lambda _: split.exact_mix(x, ph0),
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
    print(json.dumps({"timings": timings}), flush=True)

    sources = {
        "df1_bank_q": ("idsp_tpu_torch/csrc/df1_bank.cu",
                       "idsp_tpu/filters/biquad_pallas.py:225"),
        "df1_hbf_cascade_bank": ("idsp_tpu_torch/csrc/ddc_cascade.cu",
                                 "idsp_tpu/filters/ddc_pallas.py:789"),
        "fastlo_ddc_cascade_bank": ("idsp_tpu_torch/csrc/ddc_cascade.cu",
                                    "idsp_tpu/filters/ddc_pallas.py:1298"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timings["kernels"][name][C_MAIN]["ms"],
         "plain_ms": timings["kernels"][name][C_MAIN]["plain_ms"]}
        for name, (src, rep) in sources.items()
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
