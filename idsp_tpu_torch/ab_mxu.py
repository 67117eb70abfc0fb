"""Time variants of K22/K23's MMA kernels (`csrc/hbf_mxu.cu`) in one
process.

Usage (on a CUDA machine, from the root of a checkout)::

    python3 -m idsp_tpu_torch.ab_mxu

A variant is the kernel source with another value of ``kMmaWarps`` (warps
a block of the "split3" / "default" kernels); VARIANTS lists them, the
source's own value first.  Each is compiled with nvcc on its own (the
flags of `_ext`) into ``build/ab_mxu/``, all at once, and bound in turn in
place of the package's library, so the wrappers `hbf_dec_cascade_mxu` /
`hbf_int_cascade_mxu` launch it.  One set of inputs, made from a seed,
goes to every variant: K22 on (32768, c) and K23 on (2048, c) f32, depth
4, HBF_TAPS, zero state, c = 512 and 1024, at each precision of
PRECISIONS and each (block, sub) of TILES.  No value depends on the warps
or the tiles: every variant's result is held to the first variant's bit
for bit, and that to the plain version within its precision's
`hbf_mxu.KERNEL_TOL` of the scale.  A time is the median of 3 trials of
20 chained launches (`profiling.measure_rate`).  The last line is one
JSON object with every time.
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
    KERNEL_TOL, hbf_dec_cascade_mxu, hbf_dec_cascade_mxu_plain,
    hbf_int_cascade_mxu, hbf_int_cascade_mxu_plain,
)
from .profiling import measure_rate

VARIANTS = (8, 4, 16)
TILES = {"dec": ((256, 32), (512, 8)), "int": ((64, 32), (16, 4))}
PRECISIONS = ("split3", "default")
OUT = _ext.BUILD_ROOT.parent / "ab_mxu"


def variant_source(warps: int) -> str:
    src = (_ext.CSRC / "hbf_mxu.cu").read_text()
    src, n = re.subn(r"constexpr int kMmaWarps = \d+;",
                     f"constexpr int kMmaWarps = {warps};", src)
    if n != 1:
        raise RuntimeError("kMmaWarps not found once in hbf_mxu.cu")
    return src


def build() -> dict:
    """warps -> the bound library of that variant."""
    nvcc = _ext._nvcc()
    procs = {}
    for warps in VARIANTS:
        d = OUT / f"w{warps}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "hbf_mxu.cu").write_text(variant_source(warps))
        procs[warps] = subprocess.Popen(
            [nvcc, *_ext.NVCC_FLAGS, "-I", str(_ext.CSRC), "-shared", "-o",
             str(d / "lib.so"), str(d / "hbf_mxu.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for warps, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {warps} warps:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"w{warps}" / "lib.so"))
        for name in ("idsp_hbf_dec_mma", "idsp_hbf_int_mma"):
            getattr(lib, name).argtypes = _ext._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        libs[warps] = lib
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
                for prec in PRECISIONS:
                    want = list(leaves(plain(st, xin, precision=prec)))
                    scale = float(want[-1].abs().max())
                    for block, sub in TILES[kind]:
                        row, first = {}, None
                        for warps, lib in libs.items():
                            _ext._lib = lib

                            def step(s, block=block, sub=sub, prec=prec):
                                return kern(s, xin, block=block, sub=sub,
                                            precision=prec)

                            got = list(leaves(step(st)))
                            torch.cuda.synchronize()
                            if first is None:
                                first = got
                                err = max(float((a.double() - b.double())
                                                .abs().max())
                                          for a, b in zip(got, want,
                                                          strict=True))
                                if err > KERNEL_TOL[prec] * scale:
                                    raise AssertionError(
                                        f"{kind} {prec}: off plain by {err}")
                            elif not all(torch.equal(a, b) for a, b in
                                         zip(got, first, strict=True)):
                                raise AssertionError(
                                    f"{kind} {prec} w{warps} differs from "
                                    f"w{VARIANTS[0]}")
                            ms = measure_rate(step, st, iters=20,
                                              trials=3)[0] * 1e3
                            row[f"w{warps}"] = ms
                        key = f"{kind} {prec} c={c} block={block} sub={sub}"
                        times[key] = row
                        print(f"{key}: " + ", ".join(
                            f"{k} {v:.4f} ms" for k, v in row.items()),
                            flush=True)
    finally:
        _ext._lib = None
    print(json.dumps({"card": card, "ms": times}), flush=True)


if __name__ == "__main__":
    main()
