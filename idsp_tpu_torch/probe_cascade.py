"""Where K2, K3, K19-K21 (`csrc/ddc_cascade.cu`), K12/K13, K14 and K15
(`csrc/ddc_bank.cu`, `csrc/ddc_mix_df1.cu`, `csrc/fm_disc.cu`, all on
`csrc/df1_ring.cuh`'s DF1 warp), K16, K28-K31 and K37, K34-K36, K1, K11,
K18, K26, K25/K32, K4, K5 and K6 (`csrc/ddc_lockin.cu`,
`csrc/biquad_precision.cu`, `csrc/structures_bank.cu`, `csrc/df1_bank.cu`,
`csrc/biquad_bank.cu`, `csrc/lowpass_bank.cu`, `csrc/pll_bank.cu`,
`csrc/ddc_bank.cu`, on its depth-0 pipeline with serial warps of their
own), K24 (on a chain of such blocks over a cluster) and K8 and K23
"highest" (`csrc/hbf_cascade.cu`) spend their time on the card.

Usage (on a CUDA machine, from the root of a checkout)::

    python3 -m idsp_tpu_torch.probe_cascade [--only cascade|pipe|cic]
        [--cases K28,K30]

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
  are held to the package's kernel bit for bit;
* K8 `hbf_int_cascade_bank` and K23 `hbf_int_cascade_mxu` at precision
  "highest" (K8's walk in the band order) on (2048, c) f32 ~ N(0, 1), depth
  4, `HBF_TAPS`, zero state, at c = 512 and 1024: device ms a launch
  (profiler spans) at the chunks HBF_INT_CHUNKS x 1, 2, 4 and 8 blocks an
  SM (`HBF_BLOCKS_PER_SM`), every one's words held to the default's.

K14 and K15 (``pipe``), on the same kind of inputs (K14: x in
+-2^27, full-range steps, f32 out; K15: IQ full range, carrier 12345, the
deemphasis lowpass at 0.02):

* the plan sweep (`ddc_cuda.mix_plan` / `fm_cuda.disc_plan`: producers,
  CTAs a tile, chunk, ring): K14 at c = 512 and 1024, K15 exact and fast
  at c = 512, each plan's words held to the default plan's;
* variants of the two kernels, built as above: "stamps" (clock64 stamps
  of block 0 a chunk: the DF1 warp's compute, producer 0's chunk, the
  store warp's chunk, each start and end) and "df1_copy" (the DF1 warp
  passes its input through: the pace of the other roles alone);
* K29 (the Q64<61> lowpass at 0.1, x in +-2^55) and K37 (the RPLL row
  (8, 12, 11), full-range timestamps, 1 in 64 valid) at c = 1024 lanes:
  the plan sweep (`biquad_cuda.q64_plan`: producers, chunk, ring;
  `rpll_cuda.rpll_plan`: warps, chunk, ring), each plan's words held to
  the default plan's, and the "stamps" of their serial warp, producer 0
  and store warp;
* K31 (the Q29 lowpass at 0.1, x in +-2^24, unclamped) and K34 (the
  suite's SVF row (0.01, 0.7), x ~ N(0, 1), lp) at c = 1024 lanes: the
  same plan sweep (`biquad_cuda.dither_plan`, `svf_cuda.svf_plan`:
  producers, chunk, ring) and stamps;
* K13 (the suite's bank filter, the Q29 lowpass at 0.004, d = 16, time
  chunk 128, x in +-2^27, full-range steps) at c = 1024 channels and K16
  (LO frequencies 0.05-0.45, the lowpass at 0.002, x ~ N(0, 1), time
  chunk 512) at c = 512: the plan sweep (`ddc_bank_cuda.bank_plan`,
  `ddc_lockin_cuda.lockin_plan`: producers, chunk, ring; K12 and its
  ``clamp=`` at K13's default plan too) and the stamps: the serial warp,
  producer 0 and, in the store warp's place, K13's back end;
* K1 (the chain's lowpass, f32 out) and K18 (clamp (2^10, +-2^23)) at c =
  512 channels (1024 lanes), K11 (the bank filter, d = 16) at c = 1024
  (2048 lanes) on xs in +-2^27, K26 with per-lane Q29 lowpass planes on
  full-range x at 1024 lanes: K1's plan sweep (`biquad_cuda.df1_plan`:
  producers, chunk, ring) and the stamps of all four (the serial warp,
  producer 0, df1_bank.cu's own store warp, `keep_store`);
* K24 (4 stages of the Q29 lowpass at 0.1, x in +-2^24) at 1024 lanes:
  the plan sweep (`pipe_plan.sos_plan`: g = 1-4 stages a CTA, two
  one-stage ranks a CTA, producers, chunk, ring) and the stamps of every
  chain rank of tile 0 at g = 1, 2 and 4 and at two ranks a CTA (the
  serial warp, producer 0 -- rank 0's from xs, a later rank's from its x
  ring --, the store warp -- into the next rank's x ring, or the last
  rank's to device memory); K25 (that lowpass on full-range x,
  unclamped and clamped at (0, +-2^30)) and K32 (the per-lane planes):
  K25's plan sweep (`biquad_cuda.wide_plan`) and the stamps of all
  three;
* K4 (2048 lanes of x in +-2^27, d = 16) and K6 (c = 1024 channels, x in
  +-2^27, full-range steps, d = 16, time chunk 128), each with the #5
  bank's gains (`lowpass.gains2(0.004)`; N = 1: `gains1(0.01)`): their plan
  sweeps (`lowpass_cuda.lowpass_plan`: producers, chunk, ring;
  `ddc_bank_cuda.bank_plan`: producers, chunk, ring), their times at N = 1
  and 2, and the stamps (K4: the serial warp, producer 0, `keep_store`;
  K6: the serial warp, producer 0, the back end);
* K35 (the normal form's lowpass at 0.06 in Q29, and in Q33 for the
  shift's other regime, x in +-2^24) and K36 (that lowpass in f32, x ~
  N(0, 1)) at 1024 lanes: their plan sweeps (`normal_cuda.normal_plan`:
  producers, chunk, ring), their stamps (the serial warp, producer 0, the
  store warp), and K35's serial warp in other forms of its sums and K36's
  producers at 16-row batches, each built on its own and held to the
  package's words (`NORMAL_FORMS`);
* K28 (the suite's Q16<13> lowpass at 0.1, x in +-2^14; and the same
  words at f = 17, the shift's other regime) and K30 (that lowpass in
  f32, x ~ N(0, 1)) at 1024 lanes: their plan sweeps
  (`biquad_cuda.q16_plan`, `f32_plan`: producers, chunk, ring), their
  stamps (the serial warp, producer 0, the store warp) and K28's chain in
  other forms (`Q16_FORMS`), each built on its own and held to the
  package's words;
* K5 (the #5 bank's loop `pll.coefficients_from_bandwidth(2e-2, 4.0)`,
  2048 rows of full-range phases, zero state) at 1024 channels: its plan
  sweep (`pll_cuda.pll_plan`: producers, chunk, ring) with each plan's
  device ms (profiler spans: an event time takes in the wrapper's host
  work), its stamps (the serial warp, producer 0, the store warp; 8 chunks
  of 256 rows) and its serial warp in other forms (`PLL_FORMS`), each a
  stamps build of its own held to the package's words, with its device ms
  and the serial warp's cycles a row;
* ``--cases`` keeps the depth-0 cases, and of ``cascade`` the K2/K3/K19-K21
  cases and the K8/K23 sweep ("K23"), whose key holds one of its
  substrings (and builds only their variants);
* K9 and K10 (``cic``, `_cic`): the kernel alone at chip_smoke.py's
  phase-6 inputs, its device time at the default plan and at other
  (warps, CTAs a tile), and the clock64 stamps of each range's local
  pass, fold and second pass;
* the SASS of the built library (`cuobjdump -sass`): the largest loops of
  K24's, K25/K32's, K1's, K35's (both regimes and each form), K36's,
  K28's (each form), K30's, K16's, the Lowpass serial warp's kernels
  (K4 and K6 at N = 1 and 2) and K5's (each form) with their instruction
  counts (the serial warp's 8-row group among them).

A time is the median of 3 trials of 20 chained launches (CUDA events,
`profiling.measure_rate`); a stamp is SM clock cycles, the median over
the launch's chunks.  The last line is one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import types
from pathlib import Path

import numpy as np
import torch

from . import _ext, design, fxp
from .filters import biquad, biquad_cuda, ddc_bank_cuda, ddc_cuda, fm_cuda
from .filters import ddc_lockin_cuda, hbf, lowpass, lowpass_cuda, pll, rpll
from .filters import hbf_cuda, hbf_mxu, normal, normal_cuda, pll_cuda
from .filters import rpll_cuda, svf, svf_cuda
from .filters.pipe_plan import sos_plan
from .ops.fastlo import factor_pairs, fastlo_tables
from .pipelines import fm_disc
from .profiling import measure_rate

T, TC = 32768, 128
CLAMP = (1 << 10, -(1 << 23), 1 << 23)
OUT = _ext.BUILD_ROOT.parent / "probe_cascade"
STAMPS = 1024  # chunks a stamp series holds
# K8 and K23 "highest" in the cascade part: chunks (low-rate rows) and
# blocks an SM (the range count ceil(k * SMs / tiles))
HBF_INT_CHUNKS = (16, 32, 64)
HBF_BLOCKS_PER_SM = (1, 2, 4, 8)


def _patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"not found once: {old[:60]!r}")
    return src.replace(old, new)


def _patch_fn(src: str, head: str, old: str, new: str) -> str:
    """`_patch` inside the function whose text starts at ``head`` (up to
    the first line that closes a function after it)."""
    i = src.index(head)
    j = src.index("\n}\n", i)
    return src[:i] + _patch(src[i:j], old, new) + src[j:]


def _no_fir(src):
    return _patch(src, "      if (d + 1 < D) {\n        const int so",
                  "      if (true) {\n      } else if (d + 1 < D) {\n"
                  "        const int so")


def _df1_copy(src):
    """df1_ring.cuh with the DF1 warp passing its input through."""
    return _patch(src, "    int32_t y0 = s.output_y1_last(k, x0);",
                  "    int32_t y0 = x0;")


def _pipe_stamps(ring, kernel):
    """A depth-0 kernel's stamps of block 0 (df1_ring.cuh, the kernel's
    .cu): 0/1 the serial warp's compute start/end, 2/3 producer 0's chunk
    start (after its wait) and end, 4/5 the store warp's (`store_warp`, or
    `keep_store`: K1, K11, K18, K26, K27 and K4)."""
    g = "idsp::ring::g_stamps"
    at = f"blockIdx.x == 0 && lid == 0 && q < {STAMPS}"
    ring = _df1_stamps(ring)
    store = "void store_warp("
    ring = _patch_fn(ring, store,
                     "    sm90::mbar_wait(R.full_out(u.k), u.ph);\n",
                     "    sm90::mbar_wait(R.full_out(u.k), u.ph);\n"
                     "    const int q = r0 / chunk;\n"
                     f"    if ({at}) g_stamps[4][q] = clock64();\n")
    ring = _patch_fn(ring, store, "    sm90::mbar_arrive(R.empty_out(u.k));\n",
                     f"    if ({at}) g_stamps[5][q] = clock64();\n"
                     "    sm90::mbar_arrive(R.empty_out(u.k));\n")
    keep = "void keep_store("
    ring = _patch_fn(ring, keep,
                     "    sm90::mbar_wait(R.full_out(u.k), u.ph);\n",
                     "    sm90::mbar_wait(R.full_out(u.k), u.ph);\n"
                     "    const int q = r0 / chunk;\n"
                     f"    if ({at}) g_stamps[4][q] = clock64();\n")
    ring = _patch_fn(ring, keep, "    sm90::mbar_arrive(R.empty_out(u.k));\n",
                     f"    if ({at}) g_stamps[5][q] = clock64();\n"
                     "    sm90::mbar_arrive(R.empty_out(u.k));\n")
    loop = re.findall(r"for \(int r0 = 0;[^\n]*u\.next\(p\.d\.depth\)\) \{\n",
                      kernel)
    if "span_batches" in kernel or not loop:  # df1_ring.cuh's producer walk
        at = (f"blockIdx.x == 0 && threadIdx.x % 32 == 0 && pw == 0 && "
              f"r0 / chunk < {STAMPS}")
        walk = "void span_batches("
        ring = _patch_fn(ring, walk,
                         "    sm90::mbar_wait(R.empty_in(u.k), u.ph ^ 1);\n",
                         "    sm90::mbar_wait(R.empty_in(u.k), u.ph ^ 1);\n"
                         f"    if ({at}) g_stamps[2][r0 / chunk] = "
                         "clock64();\n")
        ring = _patch_fn(ring, walk, "    sm90::mbar_arrive(R.full_in(u.k));\n",
                         f"    if ({at}) g_stamps[3][r0 / chunk] = "
                         "clock64();\n"
                         "    sm90::mbar_arrive(R.full_in(u.k));\n")
        return ring, kernel + STAMPS_READER
    if len(loop) != 1:
        raise RuntimeError("the producer's chunk loop not found once")
    kernel = _patch(kernel, loop[0],
                    loop[0] + "    const int q = r0 / p.d.chunk;\n")
    kernel = _patch(kernel, "mbar_wait(R.empty_in(u.k), u.ph ^ 1);",
                    "mbar_wait(R.empty_in(u.k), u.ph ^ 1);\n"
                    f"      if (pw == 0 && {at}) {g}[2][q] = clock64();")
    kernel = _patch(kernel, "mbar_arrive(R.full_in(u.k));",
                    f"if (pw == 0 && {at}) {g}[3][q] = clock64();\n"
                    "      mbar_arrive(R.full_in(u.k));")
    return ring, kernel + STAMPS_READER


def _df1_stamps(ring):
    """df1_ring.cuh with g_stamps[6][STAMPS] (idsp::ring) and the serial
    warp's stamps of block 0 (`serial_chunks`, K29 and K37, and the DF1
    warp's loop): series 0/1 its compute start/end a chunk."""
    at = f"blockIdx.x == 0 && threadIdx.x == 0 && q < {STAMPS}"
    ring = _patch(ring, "constexpr int kMaxWarps = 16;\n",
                  "constexpr int kMaxWarps = 16;\n"
                  f"static __device__ long long g_stamps[6][{STAMPS}];\n")
    wait = "    sm90::mbar_wait(R.empty_out(u.k), u.ph ^ 1);\n"
    done = ("    sm90::mbar_arrive(R.full_out(u.k));\n"
            "    sm90::mbar_arrive(R.empty_in(u.k));\n")
    parts = ring.split(wait)
    if len(parts) != 3 or ring.count(done) != 2:
        raise RuntimeError("the two serial loops not found")
    # serial_chunks, then the DF1 warp (its chunk is a.chunk)
    ring = (parts[0] + wait + "    const int q = r0 / chunk;\n"
            f"    if ({at}) g_stamps[0][q] = clock64();\n" + parts[1] + wait
            + "    const int q = r0 / a.chunk;\n"
            f"    if ({at}) g_stamps[0][q] = clock64();\n" + parts[2])
    return ring.replace(done, f"    if ({at}) g_stamps[1][q] = clock64();\n"
                        + done)


def _back_stamps(ring, name):
    """The stamps of block 0 of a `run_roles` kernel whose store warp is
    its own (K6's and K12/K13's back end, ddc_bank.cu): the serial warp's
    and producer 0's
    (`_pipe_stamps`: their producers walk df1_ring.cuh's `span_batches`),
    4/5 the kernel's own store warp's."""
    bank = _read(name)
    ring, _ = _pipe_stamps(ring, "span_batches")
    at = f"blockIdx.x == 0 && threadIdx.x % 32 == 0 && q < {STAMPS}"
    g = "idsp::ring::g_stamps"
    bank = _patch(bank, "    idsp::sm90::mbar_wait(R.full_out(u.k), u.ph);\n",
                  "    idsp::sm90::mbar_wait(R.full_out(u.k), u.ph);\n"
                  "    const int q = r0 / chunk;\n"
                  f"    if ({at}) {g}[4][q] = clock64();\n")
    bank = _patch(bank, "    idsp::sm90::mbar_arrive(R.empty_out(u.k));\n",
                  f"    if ({at}) {g}[5][q] = clock64();\n"
                  "    idsp::sm90::mbar_arrive(R.empty_out(u.k));\n")
    return {"df1_ring.cuh": ring, name: bank + STAMPS_READER}


STAMPS_READER = (
    "\nextern \"C\" int probe_stamps(void* dst) {\n"
    "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
    "      dst, idsp::ring::g_stamps, sizeof(idsp::ring::g_stamps)));\n}\n")


def _stamps(src, ring):
    """K2's stamps of block 0 (ddc_cascade.cu, df1_ring.cuh): 0/1 the DF1
    warp's compute start/end, 2 the producer's issue start, 3 the FIR
    warps' chunk start, 4 their stage 0 end, 5 their chunk end."""
    g = "idsp::ring::g_stamps"
    at = f"blockIdx.x == 0 && threadIdx.x % 32 == 0 && q < {STAMPS}"
    src = _patch(src, "    mbar_wait(R.empty_in(u.k), u.ph ^ 1);\n"
                      "    const uint32_t slot",
                 "    mbar_wait(R.empty_in(u.k), u.ph ^ 1);\n"
                 "    const int q = r0 / a.chunk;\n"
                 f"    if ({at}) {g}[2][q] = clock64();\n"
                 "    const uint32_t slot")
    fir = "blockIdx.x == 0 && team.rank == 0 && threadIdx.x % 32 == 0"
    src = _patch(src, "    team.sync();  // the last chunk's moves (and the "
                      "carried rows) landed",
                 "    team.sync();  // the last chunk's moves (and the "
                 "carried rows) landed\n"
                 "    const int q = cs / K;\n"
                 f"    const bool stamp = {fir} && q < {STAMPS};\n"
                 f"    if (stamp) {g}[3][q] = clock64();")
    src = _patch(src, "      team.sync();\n      if (d == 0) {",
                 "      team.sync();\n"
                 f"      if (d == 0 && stamp) {g}[4][q] = clock64();\n"
                 "      if (d == 0) {")
    src = _patch(src, "    k_last = u.k;\n    cs_last = cs;",
                 f"    if (stamp) {g}[5][q] = clock64();\n"
                 "    k_last = u.k;\n    cs_last = cs;")
    return {"ddc_cascade.cu": src + STAMPS_READER,
            "df1_ring.cuh": _df1_stamps(ring)}


CHAIN_READER = (
    "\nextern \"C\" int probe_chain_stamps(void* dst) {\n"
    "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
    "      dst, idsp::ring::g_chain, sizeof(idsp::ring::g_chain)));\n}\n")


def _chain_stamps(ring, bank):
    """K24's stamps of tile 0, a series set for each chain rank (the CTAs of
    cluster 0, one or two ranks each), g_chain[rank][6][STAMPS]
    (df1_ring.cuh, biquad_bank.cu): 0/1 the serial warp's compute
    start/end a chunk (`serial_chunks`), 2/3 producer 0's chunk start
    (after its waits: rank 0's `span_batches`, a later rank's `x_feed`)
    and end, 4/5 the store warp's (the last rank's `store_warp`, the
    others' `peer_store`).  `run_chain` notes each warp's rank in shared
    memory (g_chain_rank) for the stamps to read."""
    g = "g_chain[g_chain_rank[threadIdx.x / 32]]"
    lane0 = f"probe_tile0() && threadIdx.x % 32 == 0 && q < {STAMPS}"
    ring = _patch(ring, "constexpr int kMaxWarps = 16;\n",
                  "constexpr int kMaxWarps = 16;\n"
                  f"static __device__ long long g_chain[8][6][{STAMPS}];\n"
                  "static __shared__ int g_chain_rank[32];\n"
                  "static __device__ __forceinline__ bool probe_tile0() {\n"
                  "  uint32_t n;\n"
                  "  asm(\"mov.u32 %0, %%cluster_nctarank;\" : \"=r\"(n));\n"
                  "  return blockIdx.x < n;\n}\n")
    ring = _patch_fn(ring, "void run_chain(", "  if (rank >= ranks) return;\n",
                     "  if (rank >= ranks) return;\n"
                     "  g_chain_rank[warp] = rank;\n")
    serial = "void serial_chunks("
    ring = _patch_fn(ring, serial,
                     "    sm90::mbar_wait(R.empty_out(u.k), u.ph ^ 1);\n",
                     "    sm90::mbar_wait(R.empty_out(u.k), u.ph ^ 1);\n"
                     "    const int q = r0 / chunk;\n"
                     f"    if ({lane0}) {g}[0][q] = clock64();\n")
    ring = _patch_fn(ring, serial, "    sm90::mbar_arrive(R.full_out(u.k));\n",
                     f"    if ({lane0}) {g}[1][q] = clock64();\n"
                     "    sm90::mbar_arrive(R.full_out(u.k));\n")
    for fn, wait in (("void span_batches(",
                      "    sm90::mbar_wait(R.empty_in(u.k), u.ph ^ 1);\n"),
                     ("void x_feed(",
                      "    sm90::mbar_wait_cluster(X.full(u.k), u.ph);\n")):
        at = f"pw == 0 && {lane0}"
        ring = _patch_fn(ring, fn, wait, wait +
                         "    const int q = r0 / chunk;\n"
                         f"    if ({at}) {g}[2][q] = clock64();\n")
        ring = _patch_fn(ring, fn, "    sm90::mbar_arrive(R.full_in(u.k));\n",
                         f"    if ({at}) {g}[3][q] = clock64();\n"
                         "    sm90::mbar_arrive(R.full_in(u.k));\n")
    for fn, wait in (("void store_warp(",
                      "    sm90::mbar_wait(R.full_out(u.k), u.ph);\n"),
                     ("void peer_store(",
                      "    sm90::mbar_wait_cluster(pos.x.empty(u.k), u.ph ^ 1);"
                      "\n")):
        ring = _patch_fn(ring, fn, wait, wait +
                         f"    const int q = r0 / chunk;\n"
                         f"    if ({lane0}) {g}[4][q] = clock64();\n")
        ring = _patch_fn(ring, fn,
                         "    sm90::mbar_arrive(R.empty_out(u.k));\n",
                         f"    if ({lane0}) {g}[5][q] = clock64();\n"
                         "    sm90::mbar_arrive(R.empty_out(u.k));\n")
    return {"df1_ring.cuh": ring, "biquad_bank.cu": bank + CHAIN_READER}


def sass_loops(lib_path: str, kernel: str) -> list:
    """The serial warps' group loops of each function whose name holds
    ``kernel`` in the library's SASS (`cuobjdump -sass`): the loops (a
    branch back to an earlier address, and the instructions from there to
    it) with one shared-memory store (STS) for each of the kGroup = 8 rows
    of a group and at least as many loads (LDS); per loop its function,
    instruction count and the count of 64-bit multiply-adds (IMAD.WIDE),
    LDS and STS, smallest first."""
    tool = str(Path(_ext._nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        ins = []  # (address, instruction)
        for line in part.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2)))
        loops = []
        for i, (addr, op) in enumerate(ins):
            m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) <= addr:
                body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
                loops.append({
                    "function": name[:90], "instructions": len(body),
                    "imad_wide": sum("IMAD.WIDE" in b for b in body),
                    "lds": sum(" LDS" in f" {b}" for b in body),
                    "sts": sum(" STS" in f" {b}" for b in body)})
        out += sorted((r for r in loops if r["sts"] == 8 and r["lds"] >= 8),
                      key=lambda r: r["instructions"])
    return out


def _read(name):
    return (_ext.CSRC / name).read_text()


def variants() -> dict:
    """K2's variants: name -> {file: source}; each builds ddc_cascade.cu
    (the DF1 warp's variants patch df1_ring.cuh beside it)."""
    src, ring = _read("ddc_cascade.cu"), _read("df1_ring.cuh")
    return {
        "output": {"ddc_cascade.cu": src, "df1_ring.cuh": _patch(
            ring, "s.output_y1_last(k, x0)", "s.output(k, x0)")},
        "df1_copy": {"ddc_cascade.cu": src, "df1_ring.cuh": _df1_copy(ring)},
        "no_fir": {"ddc_cascade.cu": _no_fir(src)},
        "df1_copy_no_fir": {"ddc_cascade.cu": _no_fir(src),
                            "df1_ring.cuh": _df1_copy(ring)},
        "stamps": _stamps(src, ring),
    }


DF1_PIPE_SOURCES = ("ddc_mix_df1.cu", "fm_disc.cu")  # K14, K15
PIPE_SOURCES = DF1_PIPE_SOURCES + ("biquad_precision.cu",  # K28-K31/K33
                                   "structures_bank.cu",  # K34-K37
                                   "ddc_lockin.cu",  # K16
                                   "biquad_bank.cu",  # K25/K32
                                   "df1_bank.cu",  # K1, K11, K18, K26, K27
                                   "lowpass_bank.cu",  # K4
                                   "pll_bank.cu")  # K5


# the stamps of each timed depth-0 case: (key, its stamps library)
STAMP_LIBS = (
    ("K14 c=512", "stamps_ddc_mix_df1"), ("K15 exact", "stamps_fm_disc"),
    ("K15 fast", "stamps_fm_disc"), ("K29 c=1024", "stamps_biquad_precision"),
    ("K37 c=1024", "stamps_structures_bank"),
    ("K31 c=1024", "stamps_biquad_precision"),
    ("K34 c=1024", "stamps_structures_bank"),
    ("K13 c=1024", "stamps_ddc_bank"), ("K16 c=512", "stamps_ddc_lockin"),
    ("K4 c=2048", "stamps_lowpass_bank"), ("K6 c=1024", "stamps_ddc_bank"),
    ("K1 c=512", "stamps_df1_bank"), ("K11 c=1024", "stamps_df1_bank"),
    ("K18 c=512", "stamps_df1_bank"), ("K26 c=1024", "stamps_df1_bank"),
    ("K25 c=1024", "stamps_biquad_bank"),
    ("K25 clamp c=1024", "stamps_biquad_bank"),
    ("K32 c=1024", "stamps_biquad_bank"),
    ("K35 c=1024", "stamps_structures_bank"),
    ("K36 c=1024", "stamps_structures_bank"),
    ("K28 c=1024", "stamps_biquad_precision"),
    ("K28 f=17 c=1024", "stamps_biquad_precision"),
    ("K30 c=1024", "stamps_biquad_precision"),
    ("K5 c=1024", "stamps_pll_bank"))


def _wanted(cases):
    """key -> whether a probe of the case ``key`` runs: every case, or
    those whose key holds one of the substrings ``cases``."""
    return lambda key: not cases or any(c in key for c in cases)


def pipe_variants(cases=()) -> dict:
    """K4's, K6's, K13's, K14's, K15's, K16's, K28's, K29's, K30's, K31's,
    K34's, K35's, K36's and K37's variants (those the cases ``cases`` read,
    `_wanted`): name -> {file: source}; each builds its .cu files."""
    want = _wanted(cases)
    ring = _read("df1_ring.cuh")
    out = {}
    if want("K14") or want("K15"):
        out["df1_copy"] = {"df1_ring.cuh": _df1_copy(ring),
                           **{f: _read(f) for f in DF1_PIPE_SOURCES}}
    libs = {lib for key, lib in STAMP_LIBS if want(key)}
    for f in PIPE_SOURCES:  # one library each: one g_stamps a library
        if f"stamps_{f[:-3]}" in libs:
            r, k = _pipe_stamps(ring, _read(f))
            out[f"stamps_{f[:-3]}"] = {"df1_ring.cuh": r, f: k}
    if "stamps_ddc_bank" in libs:  # K6, K12/K13
        out["stamps_ddc_bank"] = _back_stamps(ring, "ddc_bank.cu")
    if want("K24"):
        out["chain_stamps"] = _chain_stamps(ring, _read("biquad_bank.cu"))
    if want("K35") or want("K36"):
        out.update(_normal_forms(_read("structures_bank.cu"), ring))
    if want("K28"):
        out.update({k: {"biquad_precision.cu": v} for k, v in
                    _q16_forms(_read("biquad_precision.cu")).items()})
    if want(K5_KEY):  # each form a stamps build
        r, k = _pipe_stamps(ring, _read("pll_bank.cu"))
        out.update({name: {"df1_ring.cuh": r, "pll_bank.cu": k, "pll.cuh": v}
                    for name, v in _pll_forms(_read("pll.cuh")).items()})
    return out


# K35's serial warp as the package has it: acc1 = mad_wide(n_im, y0,
# mad_wide(p_re, y1, W)), acc0 = mad_wide(p_im, y1, mul_wide(p_re, y0))
_W = "static_cast<int64_t>(uint64_t{w.y} << 32 | w.x)"
_ACC1 = ("const int64_t acc1 = mad_wide(\n"
         "                    n_im, y0,\n"
         "                    mad_wide(p_re, y1,\n"
         f"                             {_W}));\n")
_ACC0 = "const int64_t acc0 = mad_wide(p_im, y1, mul_wide(p_re, y0));\n"
# other forms of K35's sums (they wrap mod 2^64: every form gives the same
# words) and K36 at 16-row producer batches, each built on its own
NORMAL_FORMS = ("normal_b", "normal_swap", "normal_acc0", "normal_b_acc0",
                "normal_iadd3", "normal_iadd3_both", "normal_f32_b16")


def _normal_forms(src, ring) -> dict:
    """structures_bank.cu with K35's serial warp's sums in other forms:
    "normal_b", -p_im y0's product beside p_re y1's multiply-add onto W,
    then one 64-bit add; "normal_swap", -p_im y0's multiply-add onto W
    first; "normal_acc0", acc0 as two products and an add; both b and
    acc0; "normal_iadd3", acc0 as two products and a three-input add with a
    zero ptxas cannot see (t >> 31; t >= 0), which keeps it from fusing a
    product into a multiply-add; both sums so; and "normal_f32_b16", K36's
    producers (df1_ring.cuh `f32_feed`) in batches of 16 rows (kWRows)
    instead of kF32Rows: name -> {file: source}."""
    u64 = "static_cast<uint64_t>"
    zero = f"{u64}(static_cast<int64_t>(p.d.t >> 31))"
    b = (f"const int64_t acc1 = static_cast<int64_t>({u64}(\n"
         f"    mul_wide(n_im, y0)) + {u64}(mad_wide(p_re, y1, {_W})));\n")
    swap = ("const int64_t acc1 = mad_wide(p_re, y1,\n"
            f"    mad_wide(n_im, y0, {_W}));\n")
    acc0 = (f"const int64_t acc0 = static_cast<int64_t>({u64}(\n"
            f"    mul_wide(p_im, y1)) + {u64}(mul_wide(p_re, y0)));\n")
    add3_0 = (f"const int64_t acc0 = static_cast<int64_t>(\n"
              f"    {u64}(mul_wide(p_im, y1)) + {u64}(mul_wide(p_re, y0)) +\n"
              f"    {zero});\n")
    add3_1 = (f"const int64_t acc1 = static_cast<int64_t>(\n"
              f"    {u64}(mul_wide(p_re, y1)) + {u64}(mul_wide(n_im, y0)) +\n"
              f"    {u64}({_W}) + {zero});\n")
    forms = {"normal_b": _patch(src, _ACC1, b),
             "normal_swap": _patch(src, _ACC1, swap),
             "normal_acc0": _patch(src, _ACC0, acc0),
             "normal_b_acc0": _patch(_patch(src, _ACC1, b), _ACC0, acc0),
             "normal_iadd3": _patch(src, _ACC0, add3_0),
             "normal_iadd3_both": _patch(_patch(src, _ACC0, add3_0), _ACC1,
                                         add3_1)}
    out = {k: {"structures_bank.cu": v} for k, v in forms.items()}
    out["normal_f32_b16"] = {
        "structures_bank.cu": src,
        "df1_ring.cuh": _patch(ring, "constexpr int kF32Rows = 32;",
                               "constexpr int kF32Rows = kWRows;")}
    return out


# K28's serial warp as the package has it: the coefficients scaled by 2^s
# (s = max(16 - f, 0)) and one arithmetic shift by sh = f + s on the chain
_Q16_SCALE = "  const int s = f < 16 ? 16 - f : 0;\n"
_Q16_Y0 = "  return static_cast<int32_t>(acc) >> sh;\n"
_Q16_STEP = ("                const uint32_t v =  // off the chain\n"
             "                    mad_lo(a2, static_cast<uint32_t>(y2), w);\n"
             "                const int32_t y0 =\n"
             "                    q16_y0(mad_lo(a1, static_cast<uint32_t>(y1), "
             "v), sh);\n")
# other forms of its chain, each built on its own: every form gives the
# same words
Q16_FORMS = ("q16_cxx", "q16_narrow", "q16_bfe", "q16_shl")


def _q16_forms(src) -> dict:
    """biquad_precision.cu with K28's chain in other forms: "q16_cxx", the
    step's two multiply-adds in C++ (V = W + a2 y2, then V + a1 y1), which
    the compiler regroups; with the coefficients unscaled, "q16_narrow",
    the plain step's int16 wrap of int32(acc) >> f (a shift and a sign
    extension); "q16_bfe", one `bfe.s32` of bits [f, f + 16) of acc
    (sign-filled past bit 31); "q16_shl", acc shifted left by max(16 - f,
    0) and right by f plus that on the chain."""
    cxx = ("                const uint32_t v = w + a2 * static_cast<uint32_t>"
           "(y2);\n"
           "                const int32_t y0 =\n"
           "                    q16_y0(v + a1 * static_cast<uint32_t>(y1), "
           "sh);\n")
    unscaled = _patch(src, _Q16_SCALE, "  const int s = 0;\n")
    narrow = "  return static_cast<int16_t>(static_cast<int32_t>(acc) >> sh);\n"
    bfe = ("  int32_t y;\n"
           "  asm(\"bfe.s32 %0, %1, %2, 16;\" : \"=r\"(y) : \"r\"(acc), "
           "\"r\"(sh));\n  return y;\n")
    shl = ("  const int l = sh < 16 ? 16 - sh : 0;\n"
           "  return static_cast<int32_t>(acc << l) >> (sh + l);\n")
    return {"q16_cxx": _patch(src, _Q16_STEP, cxx),
            "q16_narrow": _patch(unscaled, _Q16_Y0, narrow),
            "q16_bfe": _patch(unscaled, _Q16_Y0, bfe),
            "q16_shl": _patch(unscaled, _Q16_Y0, shl)}


# K5's serial step as the package has it (pll.cuh `step_grouped`), whose
# body the forms below replace
_STEP_HEAD = "  __device__ __forceinline__ int32_t step_grouped("
_STEP_END = "    return y;\n  }\n"
# the package's V, and "pll_v0"'s: f0 + b1 y0 and a1 hi(f0) as two
# multiply-adds, then the signed (a1 lo(f0)) >> 32 sign-extended
_V_PKG = """    const int64_t v = wadd64(
        wadd64(mad_wide(k.a1, static_cast<int32_t>(f0 >> 32), f0m), uh),
        mul_wide(k.b1, y0));
"""
_V_0 = """    const int64_t v = wadd64(
        mad_wide(k.a1, static_cast<int32_t>(f0 >> 32),
                 mad_wide(k.b1, y0, f0)),
        static_cast<int32_t>(uh - (k.a1 < 0 ? static_cast<uint32_t>(f0)
                                            : 0u)));
"""
# the words before the chain of the forms that replace the whole body
_OFF = """    const int32_t ca = wadd32(z0, INT32_MIN >> 1);
    const int32_t cb = wadd32(z0, INT32_MAX >> 1);
    const int64_t f0m = static_cast<int64_t>(
        static_cast<uint64_t>(f0) &
        ~static_cast<uint64_t>(k.a1 < 0 ? 0xFFFFFFFFu : 0u));
    const int64_t uh = static_cast<int64_t>(__umulhi(
        static_cast<uint32_t>(k.a1), static_cast<uint32_t>(f0)));
""" + _V_PKG + """    const int64_t w = wadd64(f, v);
    const int32_t h = static_cast<int32_t>(f >> 32);
    const int32_t xi = add3(x, y, h);
"""
_TAIL = """    f0 = mad_wide(k.b0, y0n, v);
    y = wadd32(y, h);
    x0 = xi;
    z0 = static_cast<int32_t>(static_cast<uint32_t>(y0n) -
                              static_cast<uint32_t>(z0));
    y0 = y0n;
"""
# s = cl + (delta >= 0) - (xi >= x0) as a sum, its sign picking y0
_SUM = """    const int32_t delta = static_cast<int32_t>(
        static_cast<uint32_t>(xi) - static_cast<uint32_t>(x0));
    const int32_t s = cl + int32_t{delta >= 0} - int32_t{xi >= x0};
    const int32_t cx = wadd32(xi >> 1, z0);
    const int32_t y0n = s < 0 ? ca : (s > 0 ? cb : cx);
    f = mad_wide(k.b0, y0n, w);
    cl = max(-1, min(1, s));
"""
# the package's one compare and picks in C++ (the compiler keeps the bools
# as 0/1 words and compares them again)
_FLAG_C = """    const int32_t t = x0 ^ INT32_MIN;
    const bool xneg = x0 < 0;
    const int32_t s1 = cl + (xneg ? -1 : 1);
    const int32_t k1 = s1 < 0 ? ca : cb, k0 = cl < 0 ? ca : cb;
    const bool m1 = s1 == 0, m0 = cl == 0;
    const bool flag = (xi < t) != xneg;
    const int32_t cx = wadd32(xi >> 1, z0);
    const int32_t y0n = (flag ? m1 : m0) ? cx : (flag ? k1 : k0);
    f = mad_wide(k.b0, y0n, w);
    cl = max(-1, min(1, flag ? s1 : cl));
"""
# the package's f = b0 y0' + W as a 32-bit multiply-add with carry out and
# its high word's with carry in
_F_LINE = "    f = mad_wide(k.b0, y0n, w);\n"
_F_MADCC = ("    {\n      uint32_t lo, hi;\n"
            "      asm(\"mad.lo.cc.u32 %0, %2, %3, %4;\\n\\t\"\n"
            "          \"madc.hi.s32 %1, %2, %3, %5;\"\n"
            "          : \"=r\"(lo), \"=r\"(hi)\n"
            "          : \"r\"(y0n), \"r\"(k.b0), \"r\"(static_cast<uint32_t>(w)),\n"
            "            \"r\"(static_cast<uint32_t>(static_cast<uint64_t>(w) >> 32)));\n"
            "      f = static_cast<int64_t>(uint64_t{hi} << 32 | lo);\n    }\n")
# with a1 < 0 (the loop filters' case, pole < 1): f0 + a1 hi(f0) + (a1
# lo(f0)) >> 32 = a1 hi(f0) + {umulhi(a1, lo(f0)) : hi(f0)}, one 64-bit
# multiply-add whose addend needs no add
_VW_NEG = """    const uint32_t uh = __umulhi(static_cast<uint32_t>(k.a1),
                                 static_cast<uint32_t>(f0));
    const int64_t pk = static_cast<int64_t>(
        (static_cast<uint64_t>(f0) & 0xFFFFFFFF00000000ull) | uh);
    const int64_t part = mad_wide(k.a1, static_cast<int32_t>(f0 >> 32), pk);
    const int64_t v = mad_wide(k.b1, y0, part);
"""


def _vw_block(src):
    """The package's V and W lines."""
    i = src.index("    const int64_t f0m = ")
    end = "    const int64_t w = wadd64(f, v);\n"
    return src[i:src.index(end, i) + len(end)]


# K5's case key ("K5" alone also names K35's cases for ``--cases``)
K5_KEY = "K5 c=1024"
# K5's forms timed against the package, each a stamps build of its own:
# every form gives the same words
PLL_FORMS = ("pll_plain", "pll_sum", "pll_flag_c", "pll_v0", "pll_madcc",
             "pll_neg")


def _pll_forms(src) -> dict:
    """pll.cuh with K5's serial step in other forms: "pll_plain", the plain
    order (`PllLane::step`, K6/K13's); "pll_sum", the wrap as (delta >= 0)
    - (xi >= x0) added to cl, s's sign picking y0; "pll_flag_c", the
    package's one compare with its picks written in C++; "pll_v0", the
    package with V grouped as `_V_0`; "pll_madcc", the package with f = b0
    y0' + W as `mad.lo.cc.u32` and `madc.hi.s32`; "pll_neg", V for a1 <
    0 as `_VW_NEG` (the probe's loop has a1 < 0)."""
    i = src.index(_STEP_HEAD)
    j = src.index(_STEP_END, i) + len(_STEP_END)
    head = src[i:src.index("{\n", i) + 2]

    def body(chain):
        return src[:i] + head + _OFF + chain + _TAIL + _STEP_END + src[j:]

    return {"pll_plain": _patch(src, "s.step_grouped(k, x)", "s.step(k, x)"),
            "pll_sum": body(_SUM), "pll_flag_c": body(_FLAG_C),
            "pll_v0": _patch(src, _V_PKG, _V_0),
            "pll_madcc": _patch(src, _F_LINE, _F_MADCC),
            "pll_neg": _patch(src, _vw_block(src), _VW_NEG
                              + "    const int64_t w = wadd64(f, v);\n")}


def build(sources: dict) -> dict:
    """name -> the bound entry points of that variant's .cu files, each
    built into a library of its own with nvcc (all at once) in a
    directory that holds every header of csrc/, the variant's in place of
    theirs (a header includes its neighbours)."""
    nvcc = _ext._nvcc()
    procs = {}
    for name, files in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _ext.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        for f, text in files.items():
            (d / f).write_text(text)
        for f in files:
            if f.endswith(".cu"):
                procs[(name, f)] = subprocess.Popen(
                    [nvcc, *_ext.NVCC_FLAGS, "-shared", "-o",
                     str(d / f"{f}.so"), str(d / f)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
    libs = {name: types.SimpleNamespace() for name in sources}
    for (name, f), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {f}:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / f"{f}.so"))
        for fn, argtypes in _ext._SIGNATURES.items():
            if hasattr(lib, fn):
                entry = getattr(lib, fn)
                entry.argtypes, entry.restype = argtypes, ctypes.c_int
                setattr(libs[name], fn, entry)
        for probe in ("probe_stamps", "probe_chain_stamps",
                      "probe_cic_stamps"):
            if hasattr(lib, probe):
                setattr(libs[name], probe, getattr(lib, probe))
    return libs


def _ms(fn) -> float:
    sec, _ = measure_rate(lambda _: fn(), None, iters=20, trials=3,
                          stateful=False)
    return round(sec * 1e3, 4)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_same(u, v) for u, v in zip(a, b, strict=True))


def _device_ms(step, st, symbol, iters=20):
    """Device ms a launch of the kernel whose name holds ``symbol``: the
    mean of its profiler spans over ``iters`` chained calls ``step(s) ->
    (s, ...)`` (`profiling.busy_share`), None if none was recorded."""
    from .profiling import busy_share

    _, _, by_name = busy_share(step, st, iters=iters)
    kept = [(n, sec) for k, (n, sec) in by_name.items() if symbol in k]
    spans = sum(n for n, _ in kept)
    return round(sum(sec for _, sec in kept) * iters / spans * 1e3, 4) \
        if spans else None


def _int_sweep(dev, card, result) -> None:
    """K8 and K23 "highest" on (2048, c) f32 ~ N(0, 1), depth 4, HBF_TAPS,
    zero state, at c = 512 and 1024: device ms a launch at each of
    HBF_INT_CHUNKS x HBF_BLOCKS_PER_SM blocks an SM (ranges ceil(k SMs /
    tiles)) and at the wrappers' defaults, every call's words held to the
    default's bit for bit."""
    rng = np.random.default_rng(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result["int_sweep"] = {}
    for c in (512, 1024):
        x = torch.from_numpy(rng.normal(size=(T >> 4, c)).astype(
            np.float32)).to(dev)
        st = hbf.hbf_int_cascade_init(4, (c,), axis=0, device=dev)
        tiles = -(-c // hbf_cuda.LANES)
        for key, symbol, run in (
                (f"K8 c={c}", "hbf_int_cascade_kernel",
                 lambda tc, r: hbf_cuda.hbf_int_cascade_bank(
                     st, x, **({} if tc is None else {"time_chunk": tc}),
                     ranges=r)),
                (f"K23 highest c={c}", "hbf_int_band_kernel",
                 lambda tc, r: hbf_mxu._int(st, x, None, tc, 32, "highest",
                                            r))):
            want = run(None, None)
            row = {"default": _device_ms(
                lambda s: (s, run(None, None)), st, symbol)}
            for tc in HBF_INT_CHUNKS:
                for k in HBF_BLOCKS_PER_SM:
                    r = -(-k * sms // tiles)
                    if not _same(run(tc, r), want):
                        raise AssertionError(f"{key} at chunk {tc}, {r} "
                                             "ranges: another value")
                    row[f"{tc},{r}"] = _device_ms(
                        lambda s, tc=tc, r=r: (s, run(tc, r)), st, symbol)
            result["int_sweep"][key] = row
            print(f"int sweep {key} (chunk,ranges: device ms a launch): "
                  f"{row}  [{card}]", flush=True)


def _cascade(dev, card, libs, package, result, cases=()) -> None:
    """K2, K3 and K19-K21: the plan sweep, the variants, the stamps; K8
    and K23 "highest": `_int_sweep` (those whose key holds one of
    ``cases``, `_wanted`)."""
    want = _wanted(cases)
    if want("K23"):
        _int_sweep(dev, card, result)
    if "stamps" not in libs:  # no K2/K3/K19-K21 case asked for
        return
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
                i32((T,), -(2**30), 2**30),
                factor_pairs(fastlo_tables(ph, steps, T, TC)))

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

    result.update(sweep={}, variants={}, stamps={})
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
            if not want(name):
                continue
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
        if name.startswith("pipe_"):
            continue
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


def _stamp_rows(lib, launch, chunk, series, rows=T) -> dict:
    """One launch of a stamps variant over ``rows`` rows; the medians over
    its chunks of each named span (start series, end series) and of the
    waits between."""
    _ext._lib = lib
    launch()
    torch.cuda.synchronize()
    buf = np.zeros((6, STAMPS), np.int64)
    if lib.probe_stamps(ctypes.c_void_p(buf.ctypes.data)) != 0:
        raise RuntimeError("probe_stamps failed")
    n = min(-(-rows // chunk), STAMPS)
    b = buf[:, :n].astype(np.float64)
    row = {"chunks": n, "period": float(np.median(np.diff(b[0])))}
    for name, (s0, s1) in series.items():
        row[name] = float(np.median(b[s1] - b[s0]))
        row[f"{name}_wait"] = float(np.median(b[s0, 1:] - b[s1, :-1]))
    return row


def _pipe(dev, card, libs, package, result, cases=()) -> None:
    """K1, K4, K5, K6, K11, K12/K13, K14, K15, K16, K18, K24-K26, K28-K31 and
    K34-K37 (those whose key holds one of ``cases``, `_wanted`): the plan
    sweep, the variants, the per-role stamps, the serial loops' SASS."""
    want = _wanted(cases)
    ba = biquad.quantize_ba(biquad.from_cookbook(
        design.Filter().critical_frequency(0.02).lowpass()), 29)
    bf = fm_disc.deemphasis_coefficients(0.02)
    rng = np.random.default_rng(1)

    def i32(shape, lo=-(2**31), hi=2**31):
        return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(
            np.int32)).to(dev)

    x = i32((T,), -(2**27), 2**27)
    k14_in = {c: (biquad.df1_init((2 * c,), device=dev),
                  torch.zeros((c,), dtype=torch.int32, device=dev),
                  i32((c,))) for c in (512, 1024)}
    iq = (i32((T, 512)), i32((T, 512)))
    st15 = fm_disc.init_state((512,), device=dev)

    def k14(c, plan=None):
        return ddc_cuda.ddc_mix_df1_bank(ba, *k14_in[c], x, 29,
                                         out_dtype=torch.float32, _plan=plan)

    def k15(angle, plan=None):
        return fm_cuda.fm_disc_bank(bf, st15, *iq, 12345, angle=angle,
                                    _plan=plan)

    x64 = torch.from_numpy(rng.integers(-(2**55), 2**55, size=(T, 1024),
                                        dtype=np.int64)).to(dev)
    ba64 = biquad.quantize_ba(biquad.from_cookbook(
        design.Filter().critical_frequency(0.1).lowpass()), 61,
        dtype=np.int64)
    xr = (i32((T, 1024)), torch.from_numpy(
        rng.integers(0, 64, size=(T, 1024)) == 0).to(dev))

    def k29(plan=None):
        return biquad_cuda.df1_bank_q64(
            ba64, biquad.df1_init((1024,), torch.int64, device=dev), x64, 61,
            _plan=plan)

    x29 = i32((T, 1024), -(2**24), 2**24)
    ba29 = biquad.quantize_ba(biquad.from_cookbook(
        design.Filter().critical_frequency(0.1).lowpass()), 29)
    xf = torch.from_numpy(rng.normal(size=(T, 1024)).astype(
        np.float32)).to(dev)
    f_svf, qi_svf = svf.coefficients(0.01, 0.7)

    def k31(plan=None):
        return biquad_cuda.df1_dither_bank(
            ba29, biquad.df1_dither_init((1024,), device=dev), x29, 29,
            _plan=plan)

    def k34(plan=None):
        return svf_cuda.svf_bank(f_svf, qi_svf, svf.init((1024,), device=dev),
                                 xf, _plan=plan)

    def k37(plan=None):
        return rpll_cuda.rpll_bank(rpll.RpllConfig(8, 12, 11),
                                   rpll.init((1024,), device=dev), *xr,
                                   _plan=plan)

    ba_bank = biquad.quantize_ba(biquad.from_cookbook(
        design.Filter().critical_frequency(0.004).lowpass()), 29)
    pll_ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    bank_in = (torch.zeros((1024,), dtype=torch.int32, device=dev),
               i32((1024,)))

    def k12(plan=None, clamp=None):
        return ddc_bank_cuda.fastlo_df1_dec_bank(
            ba_bank, biquad.df1_init((2048,), device=dev), *bank_in, x, 29,
            d=16, clamp=clamp, time_chunk=TC, _plan=plan)

    def k13(plan=None):
        return ddc_bank_cuda.fastlo_ddc_bank_block(
            ba_bank, pll_ba, biquad.df1_init((2048,), device=dev),
            pll.init((1024,), device=dev), *bank_in, x, 29, d=16,
            time_chunk=TC, _plan=plan)

    ba_lk = biquad.from_cookbook(design.Filter().critical_frequency(
        0.002).lowpass()).astype(np.float32)
    lo_lk = np.linspace(0.05, 0.45, 512)
    x_lk = torch.from_numpy(rng.normal(size=T).astype(np.float32)).to(dev)

    lp_gains = {1: lowpass.gains1(0.01), 2: lowpass.gains2(0.004)}
    xs_lp = i32((T, 2048), -(2**27), 2**27)

    def k4(plan=None, n=2):
        return lowpass_cuda.lowpass_bank(
            lp_gains[n], lowpass.init(n, (2048,), device=dev), xs_lp, dec=16,
            _plan=plan)

    def k6(plan=None, n=2):
        return ddc_bank_cuda.fastlo_ddc_bank_block_lp(
            lp_gains[n], pll_ba, lowpass.init(n, (2048,), device=dev),
            pll.init((1024,), device=dev), *bank_in, x, d=16, time_chunk=TC,
            _plan=plan)

    ph5 = i32((T // 16, 1024))  # K5: the #5 bank's kept rows

    def k5(plan=None):
        return pll_cuda.pll_bank(pll_ba, pll.init((1024,), device=dev), ph5,
                                 _plan=plan)

    def k16(plan=None):
        return ddc_lockin_cuda.ddc_lockin_bank(
            ba_lk, biquad.df1_init((1024,), torch.float32, device=dev), x_lk,
            lo_lk, 0, time_chunk=512, _plan=plan)

    xs1 = i32((T, 1024), -(2**27), 2**27)
    xs2 = i32((T, 2048), -(2**27), 2**27)
    x32 = i32((T, 1024))
    planes = torch.from_numpy(np.stack([biquad.quantize_ba(
        biquad.from_cookbook(design.Filter().critical_frequency(
            fc).lowpass()), 29) for fc in rng.uniform(0.01, 0.2, 1024)],
        axis=1)).to(dev)

    def k1(plan=None):
        return biquad_cuda.df1_bank_q(ba, biquad.df1_init((1024,), device=dev),
                                      xs1, 29, out_dtype=torch.float32,
                                      _plan=plan)

    def k11(plan=None):
        return biquad_cuda.df1_bank_q_dec(
            ba_bank, biquad.df1_init((2048,), device=dev), xs2, 29, d=16,
            _plan=plan)

    def k18(plan=None):
        return biquad_cuda.df1_clamp_bank_q(
            ba, biquad.df1_init((1024,), device=dev), xs1, 29, u=CLAMP[0],
            lo=CLAMP[1], hi=CLAMP[2], _plan=plan)

    def k26(plan=None):
        return biquad_cuda.df1_bank_q_coef(
            planes, biquad.df1_init((1024,), device=dev), x32, 29,
            _plan=plan)

    ba_sos = np.stack([ba29] * 4)

    def k24(plan=None):
        return biquad_cuda.sos_bank_q(
            ba_sos, [biquad.df1_init((1024,), device=dev)] * 4, x29, 29,
            _plan=plan)

    def k25(plan=None, clamp=None):
        return biquad_cuda.df1_wide_bank(
            ba29, biquad.df1_wide_init((1024,), device=dev), x32, 29,
            clamp=clamp, _plan=plan)

    def k32(plan=None):
        return biquad_cuda.df1_wide_bank_coef(
            planes, biquad.df1_wide_init((1024,), device=dev), x32, 29,
            _plan=plan)

    b_n, p_n = normal.from_cookbook(
        design.Filter().critical_frequency(0.06).lowpass())
    nq = {f: (fxp.from_float(b_n, f), fxp.from_float(p_n, f))
          for f in (29, 33)}
    x24 = i32((T, 1024), -(2**24), 2**24)

    def k35(plan=None, f=29):
        return normal_cuda.normal_bank_q(
            *nq[f], normal.init((1024,), torch.int32, device=dev), x24, f,
            _plan=plan)

    def k36(plan=None):
        return normal_cuda.normal_bank_f32(
            b_n, p_n, normal.init((1024,), device=dev), xf, _plan=plan)

    lp_01 = biquad.from_cookbook(
        design.Filter().critical_frequency(0.1).lowpass())
    b16 = biquad.quantize_ba(lp_01, 13, dtype=np.int16)
    x16 = torch.from_numpy(rng.integers(-(2**14), 2**14, size=(T, 1024))
                           .astype(np.int16)).to(dev)

    def k28(plan=None, f=13):  # f = 17: the same words, the other regime
        return biquad_cuda.df1_bank_q16(
            b16, biquad.df1_init((1024,), torch.int16, device=dev), x16, f,
            _plan=plan)

    def k30(plan=None):
        return biquad_cuda.df1_bank_f32(
            lp_01, biquad.df1_init((1024,), torch.float32, device=dev), xf,
            _plan=plan)

    _ext._lib = package
    result.update(pipe_sweep={}, pipe_variants={}, pipe_stamps={})
    cases = [(f"K14 c={c}", lambda p, c=c: k14(c, p),
              lambda c=c, **kw: ddc_cuda.mix_plan(2 * c, **kw),
              [dict(producers=p) for p in (5, 8, 11)]
              + [dict(producers=8, chunk=128, ring=4),
                 dict(producers=10, warps=16)])
             for c in (512, 1024)]
    cases += [(f"K15 {a} c=512", lambda p, a=a: k15(a, p),
               lambda a=a, **kw: fm_cuda.disc_plan(512, a, **kw),
               [dict(cluster=cl, producers=p) for cl in (1, 2)
                for p in (5, 8, 11)]
               + [dict(chunk=128, ring=4)])
              for a in ("exact", "fast")]
    cases += [("K29 c=1024", k29,
               lambda **kw: biquad_cuda.q64_plan(1024, **kw),
               [dict(producers=p) for p in (2, 3, 8, 11)]
               + [dict(chunk=64, ring=r) for r in (2, 3, 4)]
               + [dict(chunk=32, ring=8), dict(chunk=128, producers=8)]),
              ("K37 c=1024", k37, lambda **kw: rpll_cuda.rpll_plan(1024, **kw),
               [dict(chunk=128, ring=2), dict(chunk=64, ring=3),
                dict(chunk=64, ring=7), dict(chunk=32, ring=8),
                dict(warps=8)]),
              ("K31 c=1024", k31,
               lambda **kw: biquad_cuda.dither_plan(1024, **kw),
               [dict(producers=p) for p in (2, 3, 8, 11)]
               + [dict(chunk=128, ring=r) for r in (2, 3)]
               + [dict(chunk=64, ring=r) for r in (2, 4, 9)]
               + [dict(chunk=32, ring=8)]),
              ("K34 c=1024", k34, lambda **kw: svf_cuda.svf_plan(1024, **kw),
               [dict(producers=p) for p in (1, 2, 3, 8, 11)]
               + [dict(chunk=256, ring=2), dict(chunk=128, ring=2),
                  dict(chunk=128, ring=6), dict(chunk=64, ring=4),
                  dict(chunk=32, ring=8)]),
              ("K13 c=1024", k13,
               lambda **kw: ddc_bank_cuda.bank_plan(1024, **kw),
               [dict(producers=p) for p in (4, 5, 11)]
               + [dict(chunk=256, ring=2), dict(chunk=128, ring=6),
                  dict(chunk=64, ring=4), dict(chunk=32, ring=8)]),
              ("K4 c=2048", k4,
               lambda **kw: lowpass_cuda.lowpass_plan(2048, **kw),
               [dict(producers=p) for p in (3, 4, 6, 7, 8, 11)]
               + [dict(chunk=128, ring=r) for r in (2, 3, 6)]
               + [dict(chunk=256, ring=2), dict(chunk=64, ring=4),
                  dict(chunk=32, ring=8)]),
              ("K5 c=1024", k5, lambda **kw: pll_cuda.pll_plan(1024, **kw),
               [dict(producers=p) for p in (1, 2, 3, 8, 11)]
               + [dict(chunk=128, ring=r) for r in (2, 3, 6)]
               + [dict(chunk=256, ring=2), dict(chunk=64, ring=4),
                  dict(chunk=64, ring=8), dict(chunk=32, ring=8),
                  dict(chunk=128, producers=2), dict(chunk=64, producers=2)]),
              ("K6 c=1024", k6,
               lambda **kw: ddc_bank_cuda.bank_plan(1024, **kw),
               [dict(producers=p) for p in (4, 5, 6, 7, 9, 10, 11)]
               + [dict(chunk=256, ring=2), dict(chunk=128, ring=6),
                  dict(chunk=64, ring=4)]),
              ("K16 c=512", k16,
               lambda **kw: ddc_lockin_cuda.lockin_plan(512, **kw),
               [dict(producers=p) for p in (3, 5, 11)]
               + [dict(chunk=256, ring=2), dict(chunk=128, ring=6),
                  dict(chunk=64, ring=4), dict(chunk=32, ring=8)]),
              ("K1 c=512", k1, lambda **kw: biquad_cuda.df1_plan(1024, **kw),
               [dict(producers=p) for p in (3, 5, 11)]
               + [dict(chunk=128, ring=r) for r in (2, 3)]
               + [dict(chunk=64, ring=4), dict(chunk=32, ring=8)]),
              ("K24 c=1024", k24, lambda **kw: sos_plan(1024, 4, **kw),
               [dict(group=g) for g in (1, 2, 3, 4)]
               + [dict(group=1, halves=2, producers=p) for p in (2, 3)]
               + [dict(group=1, halves=2, chunk=ch, ring=r)
                  for ch, r in ((96, 2), (64, 2), (32, 6))]
               + [dict(group=2, producers=p) for p in (3, 5)]),
              ("K25 c=1024", k25, lambda **kw: biquad_cuda.wide_plan(1024,
                                                                     **kw),
               [dict(producers=p) for p in (3, 5, 11)]
               + [dict(chunk=128, ring=r) for r in (2, 3)]),
              ("K35 c=1024", k35,
               lambda **kw: normal_cuda.normal_plan(1024, **kw),
               [dict(producers=p) for p in (2, 3, 5, 8, 11)]
               + [dict(chunk=128, ring=r) for r in (2, 3)]
               + [dict(chunk=64, ring=4), dict(chunk=32, ring=8)]),
              ("K36 c=1024", k36,
               lambda **kw: normal_cuda.normal_plan(1024, f32=True, **kw),
               [dict(producers=p) for p in (1, 2, 3, 5, 8, 11)]
               + [dict(chunk=256, ring=2), dict(chunk=128, ring=6),
                  dict(chunk=64, ring=4), dict(chunk=32, ring=8)])]
    cases += [(f"K{k} c=1024", run, plan_of,
               [dict(producers=p) for p in (2, 3, 5, 8, 11)]
               + [dict(producers=11, warps=16)]
               + [dict(chunk=128, ring=r) for r in (2, 3, 6)]
               + [dict(chunk=256, ring=2), dict(chunk=64, ring=4),
                  dict(chunk=32, ring=8)])
              for k, run, plan_of in (
                  (28, k28, lambda **kw: biquad_cuda.q16_plan(1024, **kw)),
                  (30, k30, lambda **kw: biquad_cuda.f32_plan(1024, **kw)))]
    for name, run, plan_of, forced in cases:
        if not want(name):
            continue
        want_words = run(None)
        for kw in forced:
            try:
                plan = plan_of(**kw)
            except ValueError:
                continue  # a plan the kernel cannot run
            if not _same(run(plan), want_words):
                raise AssertionError(f"{name} {kw}: another value")
            key = (f"{name} w{plan.warps} p{plan.producers} "
                   f"cl{plan.cluster} ch{plan.chunk} r{plan.ring}"
                   + (f" g{plan.group} h{plan.halves}"
                      if hasattr(plan, "group") else ""))
            result["pipe_sweep"][key] = _ms(lambda: run(plan))
            if name == K5_KEY:  # events take in the wrapper's host work
                result["pipe_sweep"][f"{key} device"] = _device_ms(
                    lambda s: (s, run(plan)), None, "pll_pipe_kernel")
            print(f"{key}: {result['pipe_sweep'][key]} ms, device "
                  f"{result['pipe_sweep'].get(f'{key} device')} ms  "
                  f"[{card}]", flush=True)

    timed = {"K14 c=512": lambda: k14(512), "K15 exact": lambda: k15("exact"),
             "K15 fast": lambda: k15("fast")}
    timed = {k: fn for k, fn in timed.items() if want(k)}
    package_timed = {
        **timed, "K29 c=1024": k29, "K37 c=1024": k37, "K31 c=1024": k31,
        "K34 c=1024": k34, "K12 c=1024": k12,
        "K12 clamp c=1024": lambda: k12(clamp=(1 << 10, -(1 << 23),
                                               1 << 23)),
        "K13 c=1024": k13, "K16 c=512": k16, "K1 c=512": k1,
        "K11 c=1024": k11, "K18 c=512": k18, "K26 c=1024": k26,
        "K24 c=1024": k24, "K25 c=1024": k25,
        "K25 clamp c=1024": lambda: k25(clamp=(0, -(2**30), 2**30)),
        "K32 c=1024": k32, "K35 c=1024": k35,
        "K35 f=33 c=1024": lambda: k35(f=33), "K36 c=1024": k36,
        "K4 c=2048": k4, "K4 N=1 c=2048": lambda: k4(n=1), "K6 c=1024": k6,
        "K6 N=1 c=1024": lambda: k6(n=1), "K5 c=1024": k5,
        "K28 c=1024": k28,
        "K28 f=17 c=1024": lambda: k28(f=17), "K30 c=1024": k30}
    result["pipe_variants"]["package"] = {
        k: _ms(fn) for k, fn in package_timed.items() if want(k)}
    if timed:
        _ext._lib = libs["pipe_df1_copy"]
        result["pipe_variants"]["df1_copy"] = {k: _ms(fn)
                                               for k, fn in timed.items()}
    _ext._lib = package
    for names, fns in (
            (NORMAL_FORMS, {"K35 c=1024": k35,
                            "K35 f=33 c=1024": lambda: k35(f=33),
                            "K36 c=1024": k36}),
            (Q16_FORMS, {"K28 c=1024": k28,
                         "K28 f=17 c=1024": lambda: k28(f=17)}),
            (PLL_FORMS, {"K5 c=1024": k5})):
        fns = {k: fn for k, fn in fns.items() if want(k)}
        if not fns:
            continue
        words = {k: fn() for k, fn in fns.items()}
        for form in names:
            _ext._lib = libs[f"pipe_{form}"]
            for k, fn in fns.items():
                if not _same(fn(), words[k]):
                    raise AssertionError(f"{form} {k}: another value")
            result["pipe_variants"][form] = {k: _ms(fn)
                                             for k, fn in fns.items()}
        _ext._lib = package
    for name, row in result["pipe_variants"].items():
        print(f"variant {name}: {row} ms  [{card}]", flush=True)
    roles = {"serial": (0, 1), "producer": (2, 3), "store": (4, 5)}
    chunks = {"K14 c=512": ddc_cuda.mix_plan(1024).chunk,
              "K15 exact": fm_cuda.disc_plan(512, "exact").chunk,
              "K15 fast": fm_cuda.disc_plan(512, "fast").chunk,
              "K29 c=1024": biquad_cuda.q64_plan(1024).chunk,
              "K37 c=1024": rpll_cuda.rpll_plan(1024).chunk,
              "K31 c=1024": biquad_cuda.dither_plan(1024).chunk,
              "K34 c=1024": svf_cuda.svf_plan(1024).chunk,
              "K13 c=1024": ddc_bank_cuda.bank_plan(1024).chunk,
              "K16 c=512": ddc_lockin_cuda.lockin_plan(512).chunk,
              "K4 c=2048": lowpass_cuda.lowpass_plan(2048).chunk,
              "K6 c=1024": ddc_bank_cuda.bank_plan(1024).chunk,
              "K35 c=1024": normal_cuda.normal_plan(1024).chunk,
              "K36 c=1024": normal_cuda.normal_plan(1024, f32=True).chunk,
              "K28 c=1024": biquad_cuda.q16_plan(1024).chunk,
              "K28 f=17 c=1024": biquad_cuda.q16_plan(1024).chunk,
              "K30 c=1024": biquad_cuda.f32_plan(1024).chunk,
              "K5 c=1024": pll_cuda.pll_plan(1024).chunk}
    chunks.update({k: biquad_cuda.df1_plan(1024).chunk for k in (
        "K1 c=512", "K11 c=1024", "K18 c=512", "K26 c=1024")})
    chunks.update({k: biquad_cuda.wide_plan(1024).chunk for k in (
        "K25 c=1024", "K25 clamp c=1024", "K32 c=1024")})
    for key, lib in STAMP_LIBS:
        if not want(key):
            continue
        fn = package_timed[key]
        chunk = chunks[key]
        row = _stamp_rows(libs[f"pipe_{lib}"], fn, chunk, roles,
                          T // 16 if key.startswith("K5 ") else T)
        row["pace"] = max(roles, key=lambda r: row[r])
        result["pipe_stamps"][key] = row
        print(f"stamps {key} (cycles a chunk): {row}  [{card}]", flush=True)
    if want(K5_KEY):  # each form's stamps and device ms a launch
        chunk = pll_cuda.pll_plan(1024).chunk
        for form in ("stamps_pll_bank",) + PLL_FORMS:
            lib = libs[f"pipe_{form}"]
            row = _stamp_rows(lib, k5, chunk, roles, T // 16)
            row["device_ms"] = _device_ms(lambda s: (s, k5()), None,
                                          "pll_pipe_kernel")
            row["serial_cycles_a_row"] = row["serial"] / chunk
            result["pipe_stamps"][f"K5 {form}"] = row
            print(f"stamps K5 {form} (cycles a chunk): {row}  [{card}]",
                  flush=True)
    if want("K24"):
        _chain(libs["pipe_chain_stamps"], k24, card, result)
    _ext._lib = package
    so = next(_ext.BUILD_ROOT.glob("*/libidsp_tpu_torch.so"))
    lp_syms = (("K4 N=1", "lowpass_pipe_kernelILi1"),
               ("K4 N=2", "lowpass_pipe_kernelILi2"),
               ("K6 N=1", "BankLpSerialILi1"), ("K6 N=2", "BankLpSerialILi2"))
    result["sass_loops"] = {k: sass_loops(str(so), sym) for k, sym in (
        ("K24", "sos_chain_kernelILb0"), ("K25/K32", "df1_wide_pipe_kernel"),
        ("K1", "df1_pipe_kernelILb0ELb0ELb0ELb0"),
        ("K35 f<=32", "normal_q_kernelILb0"),
        ("K35 f>32", "normal_q_kernelILb1"),
        ("K36", "normal_f32_kernel"), ("K28", "df1_q16_kernel"),
        ("K30", "df1_f32_kernel"), ("K16", "ddc_lockin_kernel"),
        (K5_KEY, "pll_pipe_kernel")) + lp_syms
        if want(k)}
    for form in NORMAL_FORMS if want("K35") else ():
        lib = str(OUT / f"pipe_{form}" / "structures_bank.cu.so")
        result["sass_loops"][f"K35 {form}"] = sass_loops(
            lib, "normal_q_kernelILb0")
        result["sass_loops"][f"K36 {form}"] = sass_loops(
            lib, "normal_f32_kernel")
    for form in Q16_FORMS if want("K28") else ():
        lib = str(OUT / f"pipe_{form}" / "biquad_precision.cu.so")
        result["sass_loops"][f"K28 {form}"] = sass_loops(lib,
                                                         "df1_q16_kernel")
    for form in PLL_FORMS if want(K5_KEY) else ():
        lib = str(OUT / f"pipe_{form}" / "pll_bank.cu.so")
        result["sass_loops"][f"K5 {form}"] = sass_loops(lib,
                                                        "pll_pipe_kernel")
    for k, loops in result["sass_loops"].items():
        print(f"sass {k}: {loops}", flush=True)


def _chain(lib, k24, card, result) -> None:
    """K24's per-rank stamps (`_chain_stamps`) at 1024 lanes and 4
    stages, at g = 1, 2 and 4 stages a CTA and two one-stage ranks a CTA:
    a row per rank of tile 0."""
    _ext._lib = lib
    result["chain_stamps"] = {}
    roles = {"serial": (0, 1), "producer": (2, 3), "store": (4, 5)}
    for g, h in ((1, 1), (1, 2), (2, 1), (4, 1)):
        plan = sos_plan(1024, 4, group=g, halves=h)
        k24(plan)
        torch.cuda.synchronize()
        buf = np.zeros((8, 6, STAMPS), np.int64)
        if lib.probe_chain_stamps(ctypes.c_void_p(buf.ctypes.data)) != 0:
            raise RuntimeError("probe_chain_stamps failed")
        n = min(-(-T // plan.chunk), STAMPS)
        for rank in range(-(-4 // g)):
            b = buf[rank, :, :n].astype(np.float64)
            row = {"chunks": n, "period": float(np.median(np.diff(b[0])))}
            for name, (s0, s1) in roles.items():
                row[name] = float(np.median(b[s1] - b[s0]))
                row[f"{name}_wait"] = float(np.median(b[s0, 1:] - b[s1, :-1]))
            row["pace"] = max(roles, key=lambda r: row[r])
            key = f"K24 g={g} halves={h} rank {rank}"
            result["chain_stamps"][key] = row
            print(f"stamps {key} (cycles a {plan.chunk}-row chunk): {row}  "
                  f"[{card}]", flush=True)


# K9/K10's plan sweep: (warps, CTAs a tile) beside the default plan
CIC_SWEEP = ((8, 4), (8, 8), (16, 1), (16, 2), (16, 4), (16, 8), (32, 2),
             (32, 4), (32, 8))


def _cic(dev, card, libs, package, result) -> None:
    """K9 and K10 (cic_bank.cu): the kernel alone (`cic_cuda._launch`, no
    combs) at N = 3 on chip_smoke.py's phase-6 inputs -- K9 at R = 16 (x in
    +-2^16) and R = 4 (the composite's, x in +-2^20), K10 at R = 16 (2048
    slow rows in +-2^10) -- at c = 512 and 1024, zero state: device ms a
    launch (profiler spans) at the default plan and at CIC_SWEEP's (every
    plan's words held to the default's bit for bit), then the stamps of
    tile 0's ranges at the default plan: cycles of the local pass, the fold
    (its barriers' waits included) and the second pass, the median and the
    largest over the ranges that hold rows."""
    from .filters import cic
    from .filters.cic_cuda import _launch, cic_launch_plan, cic_plan

    rng = np.random.default_rng(2)

    def i32(shape, lim):
        return torch.from_numpy(rng.integers(-lim, lim, size=shape).astype(
            np.int32)).to(dev)

    def device_ms(step, st):
        return _device_ms(step, st, "cic_range_kernel")

    result.update(cic_sweep={}, cic_stamps={})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for c in (512, 1024):
        st = cic.init(3, 1, (c,), device=dev)
        for key, dec, r, x in (
                (f"K9 R=16 c={c}", True, 16, i32((T, c), 2**16)),
                (f"K9 R=4 c={c}", True, 4, i32((T, c), 2**20)),
                (f"K10 R=16 c={c}", False, 16, i32((T // 16, c), 2**10))):
            t = x.shape[0]
            name = "cic_dec_bank" if dec else "cic_int_bank"
            rows = t // r if dec else t * r
            default = cic_launch_plan(t, c, 3, r, dec, dev)

            def step(s, plan):
                return s, _launch(name, s, x, r, rows, dec, plan)

            _ext._lib = package
            want = step(st, default)
            row = {"default": {"plan": list(default),
                               "device_ms": device_ms(
                                   lambda s: step(s, default), st)}}
            for warps, cl in CIC_SWEEP:
                if -(-c // 32) * cl > 2 * sms:
                    continue
                plan = cic_plan(t, c, 3, r, dec=dec, warps=warps, cluster=cl)
                if not _same(step(st, plan), want):
                    raise AssertionError(f"{key} at {plan}: differs from the "
                                         "default plan")
                row[f"{warps},{cl}"] = {"plan": list(plan),
                                        "device_ms": device_ms(
                                            lambda s, p=plan: step(s, p), st)}
            result["cic_sweep"][key] = row
            print(f"cic sweep {key} (warps,cluster: plan, device ms a "
                  f"launch): {row}  [{card}]", flush=True)
            _ext._lib = libs["cic_stamps"]
            got = step(st, default)
            torch.cuda.synchronize()
            if not _same(got, want):
                raise AssertionError(f"{key}: the stamps build differs")
            buf = np.zeros((8 * 32, 4), np.int64)
            if libs["cic_stamps"].probe_cic_stamps(
                    ctypes.c_void_p(buf.ctypes.data)) != 0:
                raise RuntimeError("probe_cic_stamps failed")
            buf = buf[:default.ranges]
            parts = {"local": buf[:, 1] - buf[:, 0],
                     "fold": buf[:, 2] - buf[:, 1],
                     "second": buf[:, 3] - buf[:, 2]}
            stamps = {k: {"median": float(np.median(v)), "max": int(v.max())}
                      for k, v in parts.items()}
            result["cic_stamps"][key] = stamps
            print(f"cic stamps {key} (cycles a range, tile 0, {default}): "
                  f"{stamps}  [{card}]", flush=True)
    _ext._lib = package


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("cascade", "pipe", "cic"),
                    help="K2/K3/K19-K21 and K8/K23 \"highest\", the "
                         "depth-0 kernels (K1, K4, K5, K6, K11, K12/K13, "
                         "K14, K15, K16, K18, K24-K26, K28-K31, K34-K37), "
                         "or K9/K10 alone")
    ap.add_argument("--cases", default="",
                    help="comma-separated substrings of the depth-0 cases "
                         "and of the cascade part's to probe (e.g. "
                         "'K28,K30', 'K5 ,K23'); all by default")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_cascade times the CUDA device; none is "
                         "available")
    dev = torch.device("cuda", 0)
    _ext.library()
    package = _ext._lib
    parts = (("cascade", "pipe", "cic") if args.only is None else
             (args.only,))
    cases = tuple(c for c in args.cases.split(",") if c)
    sources = variants() if "cascade" in parts and _wanted(cases)("K2") \
        else {}
    if "pipe" in parts:
        sources.update({f"pipe_{k}": v
                        for k, v in pipe_variants(cases).items()})
    if "cic" in parts:  # K9/K10 with clock64 stamps (IDSP_CIC_STAMPS)
        sources["cic_stamps"] = {"cic_bank.cu": "#define IDSP_CIC_STAMPS\n"
                                 + _read("cic_bank.cu")}
    libs = build(sources)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card}
    if "cascade" in parts:
        _cascade(dev, card, libs, package, result, cases)
    if "pipe" in parts:
        _pipe(dev, card, libs, package, result, cases)
    if "cic" in parts:
        _cic(dev, card, libs, package, result)
    _ext._lib = package
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
