"""Time K1, K6, K7, K8 and K17 of two checkouts of the port in turns, in
one process.

Usage (on a CUDA machine, from the root of a checkout)::

    python3 -m idsp_tpu_torch.ab_time PARENT_ROOT CHANGE_ROOT

Each root is a checkout holding an ``idsp_tpu_torch/`` package; each is
loaded under a name of its own, so both live in this process, and each
builds its kernels into its own ``build/``.  One set of inputs, made from
a seed, goes to both: K1 `df1_bank_q` (f32 out) at c = 512 and 1024
channels (2c I|Q lanes, t = 32768, as `chip_smoke.py` phase 6 times it),
K6 `fastlo_ddc_bank_block_lp` at c = 1024 (d = 16, time chunk 128), and
K7 `hbf_dec_cascade_bank` on (32768, c) and K8 `hbf_int_cascade_bank` on
(2048, c) f32 at c = 512 and 1024 (depth 4, `HBF_TAPS`, zero state, each
tree's default chunk and launch shape), and K17 `channelize_fused` at
m = 1024, 8 taps, n = 1024 and 16384 frames, bf16 and f32 (zero history,
each tree's default plan).  The two trees must compute the same words,
K17 within 2e-5 of the scale (its sums run in another order).
One sample is the CUDA-event time of ITERS launches on the same inputs,
per launch.  Each of ROUNDS rounds r takes one sample of each tree in
the order parent, change, change, parent (r even) or change, parent,
parent, change (r odd), so a drift of the card's clock falls on both
alike.

Per kernel it prints each tree's median, min and max sample, and the
paired ratio change / parent of each round (the mean of the round's two
change samples over the mean of its two parent samples): median, and
the 10th and 90th percentile.  The last line is one JSON object with
all of it.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

T, DEC, TC, DEPTH = 32768, 16, 128, 4
M_CH, CH_TAPS, N_CH = 1024, 8, (1024, 16384)  # K17: branches, taps, frames
ROUNDS, ITERS = 30, 20


def load_tree(root: str, alias: str):
    """The ``idsp_tpu_torch`` package under ``root``, imported as
    ``alias`` (its modules import each other relatively)."""
    pkg = Path(root).resolve() / "idsp_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def cases(alias: str, dev, inputs):
    """name -> zero-argument launch of that kernel of the tree ``alias``,
    on ``inputs`` (shared by both trees)."""
    sub = {m: importlib.import_module(f"{alias}.{m}") for m in (
        "design", "filters.biquad", "filters.biquad_cuda", "filters.lowpass",
        "filters.pll", "filters.ddc_bank_cuda", "filters.hbf",
        "filters.hbf_cuda", "pipelines.channelizer",
        "pipelines.channelizer_cuda")}
    biquad, lowpass, pll = (sub["filters.biquad"], sub["filters.lowpass"],
                            sub["filters.pll"])
    ba = biquad.quantize_ba(biquad.from_cookbook(
        sub["design"].Filter().critical_frequency(0.02).lowpass()), 29)
    df1_bank_q = sub["filters.biquad_cuda"].df1_bank_q
    k6 = sub["filters.ddc_bank_cuda"].fastlo_ddc_bank_block_lp
    gains = lowpass.gains2(0.004)
    pll_ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    out = {}
    for c in (512, 1024):
        st = biquad.df1_init((2 * c,), device=dev)
        xs = inputs[f"xs{c}"]
        out[f"df1_bank_q c={c}"] = (
            lambda st=st, xs=xs: df1_bank_q(ba, st, xs, 29,
                                            out_dtype=torch.float32))
    lp0 = lowpass.init(2, (2048,), device=dev)
    pll0 = pll.init((1024,), device=dev)
    out["fastlo_ddc_bank_block_lp c=1024"] = lambda: k6(
        gains, pll_ba, lp0, pll0, inputs["ph0"], inputs["steps"],
        inputs["x"], d=DEC, time_chunk=TC)
    hbf, hbf_cuda = sub["filters.hbf"], sub["filters.hbf_cuda"]
    for c in (512, 1024):
        dec0 = hbf.hbf_dec_cascade_init(DEPTH, (c,), axis=0, device=dev)
        int0 = hbf.hbf_int_cascade_init(DEPTH, (c,), axis=0, device=dev)
        out[f"hbf_dec_cascade_bank c={c}"] = (
            lambda st=dec0, x=inputs[f"hbf{c}"]:
            hbf_cuda.hbf_dec_cascade_bank(st, x))
        out[f"hbf_int_cascade_bank c={c}"] = (
            lambda st=int0, x=inputs[f"low{c}"]:
            hbf_cuda.hbf_int_cascade_bank(st, x))
    chz = sub["pipelines.channelizer"]
    k17 = sub["pipelines.channelizer_cuda"].channelize_fused
    for n in N_CH:
        st = chz.init_planes(M_CH, CH_TAPS, device=dev)
        for tw in (torch.bfloat16, torch.float32):
            out[f"channelize_fused {str(tw)[6:]} n={n}"] = (
                lambda st=st, z=inputs[f"ch{n}"], tw=tw: k17(
                    st, *z, m=M_CH, taps=CH_TAPS, twiddle_dtype=tw))
    return out


def sample(fn, iters: int) -> float:
    """ms per launch of ``iters`` launches, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_time needs a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    trees = {"parent": load_tree(args.parent, "ab_parent"),
             "change": load_tree(args.change, "ab_change")}
    exts = [importlib.import_module(f"ab_{k}._ext") for k in trees]
    builds = [threading.Thread(target=e.library) for e in exts]
    for b in builds:
        b.start()
    for b in builds:
        b.join()
    for e in exts:
        e.library()  # raises here if a build failed

    rng = np.random.default_rng(0)

    def i32(shape, lo=-(2**31), hi=2**31):
        return torch.from_numpy(rng.integers(lo, hi, size=shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    inputs = {f"xs{c}": i32((T, 2 * c), -(2**27), 2**27) for c in (512, 1024)}
    for c in (512, 1024):
        inputs[f"hbf{c}"] = torch.from_numpy(
            rng.normal(size=(T, c)).astype(np.float32)).to(dev)
        inputs[f"low{c}"] = torch.from_numpy(
            rng.normal(size=(T >> DEPTH, c)).astype(np.float32)).to(dev)
    inputs.update(x=i32((T,), -(2**27), 2**27),
                  ph0=torch.zeros((1024,), dtype=torch.int32, device=dev),
                  steps=i32((1024,), 1 << 24, 1 << 30))
    for n in N_CH:
        inputs[f"ch{n}"] = tuple(torch.from_numpy(rng.normal(
            size=(n, M_CH)).astype(np.float32)).to(dev) for _ in range(2))
    fns = {k: cases(f"ab_{k}", dev, inputs) for k in trees}
    names = list(fns["parent"])
    for k in trees:  # warm up, and the two trees compute the same words
        for n in names:
            fns[k][n]()
    for n in names:
        a, b = fns["parent"][n](), fns["change"][n]()
        for u, v in zip(a[-1:], b[-1:]):
            same = (float((u - v).abs().max()) <= 2e-5 * float(u.abs().max())
                    if n.startswith("channelize") else torch.equal(u, v))
            if not same:
                raise AssertionError(f"{n}: parent and change differ")
    torch.cuda.synchronize()

    samples = {n: {"parent": [], "change": []} for n in names}
    ratios = {n: [] for n in names}
    for r in range(ROUNDS):
        order = (("parent", "change", "change", "parent") if r % 2 == 0 else
                 ("change", "parent", "parent", "change"))
        for n in names:
            got = {"parent": [], "change": []}
            for k in order:
                got[k].append(sample(fns[k][n], ITERS))
            for k in got:
                samples[n][k].extend(got[k])
            ratios[n].append(np.mean(got["change"]) / np.mean(got["parent"]))

    result = {"card": card, "rounds": ROUNDS, "iters": ITERS, "kernels": {}}
    for n in names:
        row = {k: {"median_ms": float(np.median(v)), "min_ms": float(min(v)),
                   "max_ms": float(max(v))} for k, v in samples[n].items()}
        q = np.percentile(ratios[n], [10, 50, 90])
        row["ratio_change_over_parent"] = {
            "p10": float(q[0]), "median": float(q[1]), "p90": float(q[2])}
        result["kernels"][n] = row
        print(f"{n}: parent median {row['parent']['median_ms']:.4f} ms "
              f"[{row['parent']['min_ms']:.4f}, {row['parent']['max_ms']:.4f}]"
              f", change median {row['change']['median_ms']:.4f} ms "
              f"[{row['change']['min_ms']:.4f}, {row['change']['max_ms']:.4f}]"
              f"; change/parent per round: median {q[1]:.4f} (p10 {q[0]:.4f},"
              f" p90 {q[2]:.4f}) over {ROUNDS} rounds  [{card}]",
              flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
