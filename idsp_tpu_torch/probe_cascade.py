"""Where K2, K3 and K19-K21 spend their time on the card
(`csrc/ddc_cascade.cu`).

Usage (on a CUDA machine, from the root of a checkout)::

    python3 -m idsp_tpu_torch.probe_cascade

One set of inputs, made from a seed: the chain's Q<29> lowpass at 0.02
and taps (5, 10, 23), t = 32768, xs uniform in +-2^27, x in +-2^30 with
a fine length of 128 for K3, a random DF1 state, zero tails.  Two parts:

* the plan sweep: the package's kernel at forced plans (`launch_plan`'s
  ``warps``, ``producers``, ``chunk`` and ``ring``): K2 and K3 at c = 512
  and 1024, K19, K20 and K21 at c = 512; every plan's words are held to
  the default plan's bit for bit (no plan changes a value);
* variants of the kernel source, each compiled with nvcc on its own (the
  flags of `_ext`) into ``build/probe_cascade/`` and bound in turn in
  place of the package's library, so the wrappers launch it: "output"
  (the DF1 sum in `df1.cuh` `output`'s order and form), "df1_copy" (the
  DF1 warp passes its input through: no recurrence), "no_fir" (the FIR
  warps skip the stages' sums), both of those, and "stamps" (clock64
  stamps of block 0: the DF1 warp's compute and its wait a chunk, the FIR
  warps' chunk, stage 0 and wait, the producer's issue of its first
  chunk, into a fresh slot).  K2,
  K20 and K3 at c = 512, each at its default plan; "output" and "stamps"
  are held to the package's kernel bit for bit.

A time is the median of 3 trials of 20 chained launches (CUDA events,
`profiling.measure_rate`); a stamp is SM clock cycles, the median over
the launch's chunks.  The last line is one JSON object with all of it.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from . import _ext, design
from .filters import biquad, ddc_cuda, hbf
from .ops.fastlo import fastlo_tables
from .profiling import measure_rate

T, TC = 32768, 128
CLAMP = (1 << 10, -(1 << 23), 1 << 23)
OUT = _ext.BUILD_ROOT.parent / "probe_cascade"
STAMPS = 1024  # chunks a stamp series holds


def _patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"not found once in ddc_cascade.cu: {old[:60]!r}")
    return src.replace(old, new)


def _no_fir(src):
    return _patch(src, "      if (d + 1 < D) {\n        const int so",
                  "      if (true) {\n      } else if (d + 1 < D) {\n"
                  "        const int so")


def _df1_copy(src):
    return _patch(src, "    int32_t y0 = s.output_y1_last(k, x0);",
                  "    int32_t y0 = x0;")


def _stamps(src):
    """clock64 stamps of block 0 into g_stamps[series][chunk]: 0/1 the DF1
    warp's compute start/end, 2 the producer's issue start, 3 the FIR
    warps' chunk start, 4 their stage 0 end, 5 their chunk end."""
    src = _patch(src, "namespace {\n\nusing idsp::sm90::bar_sync;",
                 f"__device__ long long g_stamps[6][{STAMPS}];\n"
                 "extern \"C\" int probe_stamps(void* dst) {\n"
                 "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                 "      dst, g_stamps, sizeof(g_stamps)));\n}\n"
                 "namespace {\n\nusing idsp::sm90::bar_sync;")
    at = f"blockIdx.x == 0 && threadIdx.x % 32 == 0 && q < {STAMPS}"
    src = _patch(src, "    mbar_wait(R.empty0(u.k), u.ph ^ 1);\n"
                      "    df1_rows<Clamp>",
                 "    mbar_wait(R.empty0(u.k), u.ph ^ 1);\n"
                 "    const int q = r0 / a.chunk;\n"
                 f"    if ({at}) g_stamps[0][q] = clock64();\n"
                 "    df1_rows<Clamp>")
    src = _patch(src, "    mbar_arrive(R.full0(u.k));\n"
                      "    mbar_arrive(R.empty_in(u.k));",
                 f"    if ({at}) g_stamps[1][q] = clock64();\n"
                 "    mbar_arrive(R.full0(u.k));\n"
                 "    mbar_arrive(R.empty_in(u.k));")
    src = _patch(src, "    mbar_wait(R.empty_in(u.k), u.ph ^ 1);\n"
                      "    const uint32_t slot",
                 "    mbar_wait(R.empty_in(u.k), u.ph ^ 1);\n"
                 "    const int q = r0 / a.chunk;\n"
                 f"    if ({at}) g_stamps[2][q] = clock64();\n"
                 "    const uint32_t slot")
    fir = "blockIdx.x == 0 && team.rank == 0 && threadIdx.x % 32 == 0"
    src = _patch(src, "    team.sync();  // the last chunk's moves (and the "
                      "carried rows) landed",
                 "    team.sync();  // the last chunk's moves (and the "
                 "carried rows) landed\n"
                 "    const int q = cs / K;\n"
                 f"    const bool stamp = {fir} && q < {STAMPS};\n"
                 "    if (stamp) g_stamps[3][q] = clock64();")
    src = _patch(src, "      team.sync();\n      if (d == 0) {",
                 "      team.sync();\n"
                 "      if (d == 0 && stamp) g_stamps[4][q] = clock64();\n"
                 "      if (d == 0) {")
    return _patch(src, "    k_last = u.k;\n    cs_last = cs;",
                  "    if (stamp) g_stamps[5][q] = clock64();\n"
                  "    k_last = u.k;\n    cs_last = cs;")


def variants() -> dict:
    src = (_ext.CSRC / "ddc_cascade.cu").read_text()
    return {
        "output": _patch(src, "s.output_y1_last(k, x0)", "s.output(k, x0)"),
        "df1_copy": _df1_copy(src),
        "no_fir": _no_fir(src),
        "df1_copy_no_fir": _no_fir(_df1_copy(src)),
        "stamps": _stamps(src),
    }


def build(sources: dict) -> dict:
    """name -> the bound library of that variant (built all at once)."""
    nvcc = _ext._nvcc()
    procs = {}
    for name, src in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "ddc_cascade.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_ext.NVCC_FLAGS, "-I", str(_ext.CSRC), "-shared", "-o",
             str(d / "lib.so"), str(d / "ddc_cascade.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.idsp_ddc_cascade.argtypes = _ext._SIGNATURES["idsp_ddc_cascade"]
        lib.idsp_ddc_cascade.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _ms(fn) -> float:
    sec, _ = measure_rate(lambda _: fn(), None, iters=20, trials=3,
                          stateful=False)
    return round(sec * 1e3, 4)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_same(u, v) for u, v in zip(a, b, strict=True))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_cascade times the CUDA device; none is "
                         "available")
    dev = torch.device("cuda", 0)
    _ext.library()
    package = _ext._lib
    libs = build(variants())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ba = biquad.quantize_ba(biquad.from_cookbook(
        design.Filter().critical_frequency(0.02).lowpass()), 29)
    taps = tuple(np.asarray(hbf.HBF_TAPS[2 - d], np.float32)
                 for d in range(3))
    rng = np.random.default_rng(0)

    def i32(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(
            np.int32)).to(dev)

    def inputs(c):
        c2 = 2 * c
        st = biquad.Df1State(x=i32((c2, 2), -(2**24), 2**24),
                             y=i32((c2, 2), -(2**24), 2**24))
        tails = tuple(torch.zeros((3 * len(v) - 2, c2), device=dev)
                      for v in taps)
        ph = i32((c,), -(2**31), 2**31)
        steps = i32((c,), 1 << 24, 1 << 30)
        return (st, tails, i32((T, c2), -(2**27), 2**27),
                i32((T,), -(2**30), 2**30), fastlo_tables(ph, steps, T, TC))

    def launch(ins, depth=3, plan=None, k3=False, clamp=None):
        st, tails, xs, x, tables = ins
        c2 = xs.shape[1]
        if k3:
            return ddc_cuda._launch_cascade(
                ba, st, tails, taps, 29, T, c2, TC, dev, x=x, tables=tables,
                clamp=clamp, plan=plan)
        return ddc_cuda._launch_cascade(
            ba, st, tails[:depth], taps[:depth], 29, T, c2, TC, dev, xs=xs,
            clamp=clamp, plan=plan)

    result = {"card": card, "sweep": {}, "variants": {}, "stamps": {}}
    plans = [dict(warps=w, chunk=ch, ring=r) for w in (8, 12, 16)
             for ch in (128, 256) for r in (2, 3, 4)]
    for c in (512, 1024):
        ins = inputs(c)
        cases = [("K2", {}, dict(depth=3), plans),
                 ("K3", {"fastlo": True}, dict(k3=True),
                  [dict(warps=w, producers=p, chunk=ch) for w in (12, 16)
                   for p in (2, 4) for ch in (128, 256)])]
        if c == 512:
            cases += [
                ("K19", {}, dict(depth=3, clamp=CLAMP),
                 [dict(chunk=ch) for ch in (128, 256)]),
                ("K20", {}, dict(depth=1), [dict(chunk=ch)
                                            for ch in (128, 256)]),
                ("K21", {}, dict(depth=2), [dict(chunk=ch)
                                            for ch in (128, 256)])]
        for name, plan_kw, kw, forced in cases:
            ms = [len(v) for v in taps[:kw.get("depth", 3)]]
            want = launch(ins, **kw)
            for p in forced:
                try:
                    plan = ddc_cuda.launch_plan(ms, 2 * c, **plan_kw, **p)
                except ValueError:
                    continue  # more shared memory than a block may have
                if not _same(launch(ins, plan=plan, **kw), want):
                    raise AssertionError(f"{name} {p}: another value")
                key = (f"{name} c={c} w{plan.warps} p{plan.producers} "
                       f"ch{plan.chunk} r{plan.ring}")
                result["sweep"][key] = _ms(lambda: launch(ins, plan=plan,
                                                          **kw))
                print(f"{key}: {result['sweep'][key]} ms  [{card}]",
                      flush=True)

    ins = inputs(512)
    _ext._lib = package
    want = launch(ins)
    for name, lib in libs.items():
        _ext._lib = lib
        if name in ("output", "stamps") and not _same(launch(ins), want):
            raise AssertionError(f"variant {name}: another value")
        row = {"K2": _ms(lambda: launch(ins)),
               "K20": _ms(lambda: launch(ins, depth=1)),
               "K3": _ms(lambda: launch(ins, k3=True))}
        result["variants"][name] = row
        print(f"variant {name}: {row} ms  [{card}]", flush=True)
    lib = libs["stamps"]
    for key, kw in (("K2", dict(depth=3)), ("K20", dict(depth=1)),
                    ("K3", dict(k3=True))):
        _ext._lib = lib
        launch(ins, **kw)
        torch.cuda.synchronize()
        buf = np.zeros((6, STAMPS), np.int64)
        if lib.probe_stamps(ctypes.c_void_p(buf.ctypes.data)) != 0:
            raise RuntimeError("probe_stamps failed")
        n = -(-T // ddc_cuda.launch_plan(
            [len(v) for v in taps[:kw.get("depth", 3)]], 1024,
            fastlo="k3" in kw).chunk)
        b = buf[:, :n].astype(np.float64)
        row = {"chunks": n,
               "df1_compute": float(np.median(b[1] - b[0])),
               "df1_wait": float(np.median(b[0, 1:] - b[1, :-1])),
               "fir_chunk": float(np.median(b[5] - b[3])),
               "fir_stage0": float(np.median(b[4] - b[3])),
               "fir_wait": float(np.median(b[3, 1:] - b[5, :-1]))}
        if key != "K3":  # K3's producers are the mix warps: no stamp
            row["producer_first_chunk"] = float(b[2, 1] - b[2, 0])
        result["stamps"][key] = row
        print(f"stamps {key} (cycles a chunk): {row}  [{card}]", flush=True)
    _ext._lib = package
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
