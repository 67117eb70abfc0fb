"""K23 "default" against the float64 truth over many seeds, on the CPU.

The port's plain `hbf_int_cascade_mxu_plain(precision="default")` and the
numpy one-pass emulation of tests/test_torch_hbf_mxu_precision.py
(`_reference`: both operands rounded to bf16, the exact products summed in
float64, one f32 rounding a stage) at `chip_smoke.py`'s phase-3 shape: c =
512 channels, depth 4, 2048 low-rate rows, x and the carried state ~ N(0,
1) from a seed, for `HBF_TAPS` and `HBF_TAPS_98`.  For each seed and tap
table: each one's error against the float64 truth (`_reference`'s "truth":
the band of float64 taps over float64 data), max |y - truth| / max
|truth|, `chip_smoke.py`'s MXU_TRUTH measure, and the two's difference
from each other on the same measure.  Prints one line per tap table with
the spread (min, median, 90th and 99th percentile, max) and the count of
seeds above `chip_smoke.py`'s MXU_TRUTH["default"] = 1e-2, then one JSON
object with every seed's numbers.

    python tests/torch_mxu_spread.py [--seeds 200] [--workers 3]
"""

import argparse
import json
import multiprocessing as mp

import numpy as np
import torch

C, DEPTH, ROWS = 512, 4, 2048
GATE = 1e-2  # chip_smoke.py MXU_TRUTH["default"]


def one(args):
    seed, name = args
    from test_torch_hbf_mxu_precision import TAPS, _rand_states, _reference

    from idsp_tpu_torch.filters.hbf_mxu import hbf_int_cascade_mxu_plain

    torch.set_num_threads(1)
    taps = TAPS[name][0]
    rng = np.random.default_rng(seed)
    st = _rand_states(rng, DEPTH, C, taps, "int")
    x = rng.normal(size=(ROWS, C)).astype(np.float32)
    np_st = [(s.x.numpy(),) for s in st]
    truth, _ = _reference(np_st, x, taps, DEPTH, "int", "truth")
    emu, _ = _reference(np_st, x, taps, DEPTH, "int", "default")
    _, y = hbf_int_cascade_mxu_plain(st, torch.from_numpy(x), taps=taps,
                                     precision="default")
    scale = float(np.abs(truth).max())

    def rel(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max()) / scale

    return {"seed": seed, "taps": name, "plain": rel(y.numpy(), truth),
            "emulation": rel(emu, truth),
            "plain_vs_emulation": rel(y.numpy(),
                                      np.asarray(emu, np.float64))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--workers", type=int, default=3)
    args = ap.parse_args()
    jobs = [(s, n) for n in ("140dB", "98dB") for s in range(args.seeds)]
    with mp.get_context("spawn").Pool(args.workers) as pool:
        rows = pool.map(one, jobs, chunksize=4)
    for name in ("140dB", "98dB"):
        mine = [r for r in rows if r["taps"] == name]
        for key in ("plain", "emulation", "plain_vs_emulation"):
            v = np.array([r[key] for r in mine])
            q = np.percentile(v, [0, 50, 90, 99, 100])
            print(f"{name} {key}: min {q[0]:.4e} median {q[1]:.4e} p90 "
                  f"{q[2]:.4e} p99 {q[3]:.4e} max {q[4]:.4e}; above "
                  f"{GATE}: {int((v > GATE).sum())} of {len(v)} seeds",
                  flush=True)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
