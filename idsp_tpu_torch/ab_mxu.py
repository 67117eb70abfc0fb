"""Time variants of K22/K23 (`csrc/hbf_mxu.cu`) in one process.

Usage (on a CUDA machine, from the root of a checkout)::

    python3 -m idsp_tpu_torch.ab_mxu

A variant is the kernel source with other values of ``kMxuWarps`` (warps
a block) and ``kIlp`` (rows a thread sums side by side); VARIANTS lists
them, the source's own values first.  Each is compiled with nvcc on its
own (the flags of `_ext`) into ``build/ab_mxu/``, all at once, and bound
in turn in place of the package's library, so the wrappers
`hbf_dec_cascade_mxu` / `hbf_int_cascade_mxu` launch it.  One set of
inputs, made from a seed, goes to every variant: K22 on (32768, c) and
K23 on (2048, c) f32, depth 4, HBF_TAPS, zero state, c = 512 and 1024,
at each (block, sub) of TILES.  Every result is held to the plain
version bit for bit; a time is the median of 3 trials of 20 chained
launches (`profiling.measure_rate`).  The last line is one JSON object
with every time.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from . import _ext
from .filters import hbf
from .filters.hbf_mxu import (
    hbf_dec_cascade_mxu, hbf_dec_cascade_mxu_plain, hbf_int_cascade_mxu,
    hbf_int_cascade_mxu_plain,
)
from .profiling import measure_rate

VARIANTS = ((32, 4), (8, 1), (8, 4), (16, 4), (32, 2), (16, 8))
TILES = {"dec": ((256, 32), (1024, 8)), "int": ((64, 32), (16, 4))}
OUT = _ext.BUILD_ROOT.parent / "ab_mxu"


def variant_source(warps: int, ilp: int) -> str:
    src = (_ext.CSRC / "hbf_mxu.cu").read_text()
    for name, value in (("kMxuWarps", warps), ("kIlp", ilp)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in hbf_mxu.cu")
    return src


def build() -> dict:
    """(warps, ilp) -> the bound library of that variant."""
    nvcc = _ext._nvcc()
    procs = {}
    for warps, ilp in VARIANTS:
        d = OUT / f"w{warps}_i{ilp}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "hbf_mxu.cu").write_text(variant_source(warps, ilp))
        procs[warps, ilp] = subprocess.Popen(
            [nvcc, *_ext.NVCC_FLAGS, "-I", str(_ext.CSRC), "-shared", "-o",
             str(d / "lib.so"), str(d / "hbf_mxu.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"w{key[0]}_i{key[1]}" / "lib.so"))
        for name in ("idsp_hbf_dec_mxu", "idsp_hbf_int_mxu"):
            getattr(lib, name).argtypes = _ext._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        libs[key] = lib
    return libs


def leaves(x):
    if isinstance(x, tuple):
        for v in x:
            yield from leaves(v)
    else:
        yield x


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_mxu times the CUDA device; none is available")
    libs = build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    times = {}
    try:
        for c in (512, 1024):
            x = torch.from_numpy(rng.normal(size=(32768, c)).astype(
                np.float32)).to(dev)
            low = torch.from_numpy(rng.normal(size=(2048, c)).astype(
                np.float32)).to(dev)
            cases = {
                "dec": (hbf_dec_cascade_mxu, hbf_dec_cascade_mxu_plain, x,
                        hbf.hbf_dec_cascade_init(4, (c,), axis=0,
                                                 device=dev)),
                "int": (hbf_int_cascade_mxu, hbf_int_cascade_mxu_plain, low,
                        hbf.hbf_int_cascade_init(4, (c,), axis=0,
                                                 device=dev)),
            }
            for kind, (kern, plain, xin, st) in cases.items():
                want = list(leaves(plain(st, xin)))
                for block, sub in TILES[kind]:
                    row = {}
                    for (warps, ilp), lib in libs.items():
                        _ext._lib = lib

                        def step(s, block=block, sub=sub):
                            return kern(s, xin, block=block, sub=sub)

                        got = list(leaves(step(st)))
                        torch.cuda.synchronize()
                        if not all(torch.equal(a, b)
                                   for a, b in zip(got, want, strict=True)):
                            raise AssertionError(
                                f"{kind} w{warps} i{ilp} differs from plain")
                        ms = measure_rate(step, st, iters=20,
                                          trials=3)[0] * 1e3
                        row[f"w{warps}_i{ilp}"] = ms
                    times[f"{kind} c={c} block={block} sub={sub}"] = row
                    print(f"{kind} c={c} block={block} sub={sub}: "
                          + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in row.items()), flush=True)
    finally:
        _ext._lib = None
    print(json.dumps({"card": card, "ms": times}), flush=True)


if __name__ == "__main__":
    main()
