#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`idsp_tpu_torch`) on one NVIDIA GPU.

Builds the CUDA kernels from ``idsp_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version, drives the main paths -- the
headline DDC chain (`DdcChain`) and its anti-windup (clamped) front
ends, the BASELINE #5 DDC bank in its Lowpass
(`DdcBank`) and biquad (`DdcBankBiquad`) variants, the BASELINE #4
rate conversion (`RoundTrip` in its shift and banded-matrix forms, the
CIC + half-band composite decimator, CIC interpolation), and BASELINE
#1-#3 (`FmReceiver`, `DdcLockinBank`, `channelize_planes`), and the
Stabilizer IIR control path (`compat.sos`, `compat.sos_clamp_wide`, the
per-channel config bank `ConfigBank`), the biquad precision ladder
(Q16, Q64, f32, dither and the runtime-coefficient wide and dither
banks), the filter structures (SVF, normal form, RPLL, WDF allpass
chains and complementary pairs), and the scale-out layer on four
processes sharing the card -- through their kernel modes, checks
the results and times kernels, chain, banks, rate conversion, FM,
lock-in, channelizer, control path, ladder and structures.
Phases, each reported on its own line:

1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
2. the kernel build (nvcc, sm_90a, one process per source) and its time;
3. each kernel against its plain version over carried blocks of t=32768
   (HOLD_BLOCKS = 2, `hold`; BLOCKS = 3 for K7-K10 and K22/K23), the
   plain calls timed, for phase 6 too:
   K1 `df1_bank_q`, K2 `df1_hbf_cascade_bank`, K3
   `fastlo_ddc_cascade_bank` at c=512 channels (1024 I|Q lanes); K4
   `lowpass_bank` (dec 16), K5 `pll_bank` (t/16 rows) and K6
   `fastlo_ddc_bank_block_lp` at c=1024 (2048 lanes), d=16; K7
   `hbf_dec_cascade_bank` (depth 4, (32768, 512) f32), K8
   `hbf_int_cascade_bank` (depth 4, (2048, 512) f32), each also from a
   random carried state at HBF_RANGE_CASES (depths 1-4, c=512 and the
   ragged c=200, HBF_TAPS and HBF_TAPS_98, forced range counts from one
   to one row a range), K9 `cic_dec_bank`
   (N=3, R=16, (32768, 512) i32 in +-2^16) and K10 `cic_int_bank`
   ((2048, 512) i32 in +-2^10), each also at the edges of its time-range
   plan from a random carried state on full-range x over 2 blocks
   (CIC_EDGES: one range, one kept or slow row a range, a ragged last
   range, N = 1 and 8, R = 1 and 4, c = 200, t <= 8192); K11 `df1_bank_q_dec`, K12
   `fastlo_df1_dec_bank` and K13 `fastlo_ddc_bank_block` at c=1024,
   d=16, time chunk 128; K14 `ddc_mix_df1_bank` (int32 and f32 out, x
   and steps full range) at c=512 and 1024; K15 `fm_disc_bank` (exact and fast
   angle; c=512, IQ = cossin of random phases) and K16 `ddc_lockin_bank`
   (c=512, time chunk 512, x ~ N(0, 1), n0 carried); state, tails and
   outputs bit for bit (tolerance 0); K17 `channelize_fused` (f32 and
   bf16; m=1024 at n=1024 frames over 3 blocks and n=16384, m=384 and
   2048 at n=1024: clusters of 8, 3 and 8 CTAs, the last two sharing the
   FIR) within 2e-5 of the output scale, its history bit for bit, the 64-
   and 128-frame plans and one block against its halves (split at frames
   100, 1 and n/2) bit for bit; K18
   `df1_clamp_bank_q`, K19 `df1_clamp_hbf_cascade_bank` (depth 3), K20
   `df1_hbf1_bank` and K21 `df1_hbf12_bank` (time chunk 512) on the same
   3 blocks of the chain's exact mix (c=512, x uniform in +-2^27), K3's
   ``clamp=`` form at c=512 and K12's at c=1024 (d=16, time chunk 128),
   clamped with CLAMP, bit for bit, each plain call timed, with the share
   of DF1 outputs the clamp pinned (> 0); K19 once with the suite's clamp
   row CLAMP_SUITE; K2, K3 (and its ``clamp=``), K19, K20 and K21 at the
   shapes that stress their kernel's rings and tiles (t one kernel chunk,
   t not a multiple of ring depth x chunk, c2 = 200 and 50, fine lengths
   32 and 256 against the kernel's chunk, K19 with the clamp engaged,
   HBF_TAPS_98 at depth 4, forced plans) over 2 blocks, bit for bit; K14
   (int32 and f32 out) and K15 (exact and fast) at the edges of their
   depth-0 pipeline (PIPE_EDGES: forced plans of 1 and 11 producers, 2
   and 14 slots, 1-row chunks; c = 100 and 50; t one chunk and 7 chunks
   + 40 rows) over 2 blocks, bit for bit; K29 and K37 at the same
   edges of the same pipeline at their own 128-row chunk (forced plans of
   1 and 11 producers, 2 slots and the most that fit, 1-row chunks; c =
   100, 50 and 51; t one chunk and 7 chunks + 40; K29 with the Q64<61>
   lowpass and, on the 7-chunk row, full-range coefficients at f = 47 and
   int64's edge values at f = 33; K37 with 1 in 4 rows valid and 1.5
   chunks without one, at sf 12 and on the 7-chunk row also sf 32 and 40)
   over 2 blocks, bit for bit; K31, K33 and K34 at that pipeline's edges
   (t = 1, t under a chunk, t = 3 chunks + 17, a forced plan of 16-row
   chunks; c = 200, 50, 1 and 200; K31 at f 29 unclamped and clamped, f
   1 and f 32, K33 per-lane and shared, K34 each output, K35 at f 29, 1,
   32, 33 and 63 with full-range coefficients, x and state, whose 64-bit
   sums wrap, K36, K28 with the Q16<13> lowpass and at f 1 and 31 with
   full-range int16 words, whose int32 sums wrap, K30) over 2 blocks, and
   K31 at f 1 and 32 on a block whose 64-bit sums wrap, bit for bit;
   K12 (unclamped and with CLAMP) and K13 at that pipeline's edges
   (chunks other than the time chunk and not multiples of d, chunks
   under d, t not a multiple of the chunk, c = 17, 3, 1, d = 1, 5 and 3
   producers, spans across a time chunk of 12, the int64 sum wrapping) and K16 (t = the time chunk, t not
   a multiple of the chunk, time chunks under a span, 2-row spans, 11
   producers, t = 1, a time chunk of 16384 rows) at small t and c over 2
   blocks, bit for bit; K1 (int32 at f 29, 33 and 63, f32 at f 33), K11
   (d 3, 4 and 1: kept rows across chunk edges), K18 (CLAMP at f 29 and
   33), K26 (per-lane and shared planes at f 63) and K27 (per-lane, CLAMP,
   f 33) at the edges of the same pipeline (`df1_plan`: t = 1, t under a
   chunk, t = 3 chunks + 17, a forced plan of 16-row chunks; c = 200, 50,
   1 and 200) over 2 blocks, and K1, K18 at f 32 and 63 and K27 at f 63
   on a block whose 64-bit sums wrap, bit for bit; K5 at the edges of the
   same pipeline (`pll_plan`: t = 1, t under a chunk, t not a multiple of
   the chunk, c = 200, 50, 33, 40, 1 and the bank's 1024, 1-11 producers;
   the #5 bank's loop and coefficients at int32's ends, a1 = INT32_MIN;
   f and f0 within 2^40 of +-2^63, cl at -1, 0 and +1, x0 next to a wrap)
   over 2 blocks, bit for bit; K24 on its cluster
   chain (`sos_plan`: c = 1, 50 and 200 lanes, t not a multiple of the
   chunk, under a chunk and 1 row, N = 1, 3 and 8 stages at g = 1, 2 and
   N stages a rank and at two one-stage ranks a CTA, f 1, 32 and 33, and f
   1-63 where the sum wraps) and
   K25 (unclamped, CLAMP, lo > hi) and K32 (per-lane and shared planes)
   at their depth-0 pipeline's edges (`wide_plan`, f 1-32, full-range
   int64 y, the sum wrapping) over 2 blocks, bit for bit; the card's
   co-resident K24 clusters (cudaOccupancyMaxActiveClusters) of 1-8 CTAs
   of one rank and 1-4 of two, and the plans it picks;
   K22 `hbf_dec_cascade_mxu`
   ((32768, 512) f32) and K23
   `hbf_int_cascade_mxu` ((2048, 512) f32), depth 4, with HBF_TAPS and
   HBF_TAPS_98 from a random carried state, at two (block, sub) tilings
   and the forced range counts MXU_RANGES, bit for bit (K23 "highest" also
   at c=1024), and one block against its two halves, bit for bit; K24
   `sos_bank_q` (4 stages), K25 `df1_wide_bank` (clamped with the suite's
   row), K26 `df1_bank_q_coef` and K27 `df1_clamp_bank_q_coef` (per-lane
   planes of 1024 `BiquadConfig`s) at c=1024 lanes on one block of
   full-range x, bit for bit, each plain call timed; K25 unclamped and K26
   with a shared (5,) set on T_PREFIX rows; K28 `df1_bank_q16`, K29
   `df1_bank_q64`, K30 `df1_bank_f32`, K31 `df1_dither_bank`, K32
   `df1_wide_bank_coef` and K33 `df1_dither_bank_coef` (per-lane planes)
   at c=1024 lanes on one block of the suite's inputs from a random
   state, bit for bit, each plain call timed; K31-K33 clamped with CLAMP
   on one block, with the share of outputs the clamp pinned (> 0), and
   K32/K33 with a shared (5,) set on T_PREFIX rows; each of K28-K33
   over two half-blocks against one block, bit for bit; K34 `svf_bank`
   (the suite's row, x ~ N(0, 1)), K35 `normal_bank_q` (Q29, x in
   +-2^24), K36 `normal_bank_f32`, K37 `rpll_bank` (full-range
   timestamps, 1 in 64 valid), K38 `wdf_bank` (wdf-ca-7's first chain),
   K39 `wdf_chain_bank` (wdf-ca-19's branch 0) and K40 `wdf_pair_bank`
   (wdf-ca-7 and wdf-ca-19, x in +-2^24) at c=1024 lanes over 2 carried
   blocks from a random state, bit for bit (K39 and K40's first block of
   T_PREFIX rows, every other block of t=32768), each full-block plain
   call timed, the SVF's other three outputs on T_PREFIX rows each, and
   each of K34-K40 over two half-blocks against one block, bit for bit;
   then the WDF kernel off the suite's plans on T_PREFIX rows, bit for
   bit: one stage of every adapter type (the generic loop), wdf-ca-19
   with every stage on the generic loop and at a chunk of WDF_SMALL_CHUNK
   rows, each launch's plan (warps, stage kinds, chunk, ring depth,
   shared memory) on a line of its own;
4. the main paths, each with every launch counter reset just before it
   and read just after:
   * `DdcChain` in ``split`` (K1), ``fused`` (K14), ``fold`` (K20),
     ``fold2`` (K21), ``fold3`` (K2), ``fold3_fastlo`` (plain fast mix,
     K2) and ``fastlo_fused`` (K3) over 3 blocks of a coherent carrier at
     c=512, and ``scan``, ``split``, ``fused`` at c=1024;
     ``split``/``fold``/``fold2``/``fold3`` integer state bit for bit
     against the ``scan`` oracle (outputs within 16 ULP of the output
     scale), ``fused`` output equal to ``split``'s and its state to
     ``scan``'s at both widths, ``fastlo_fused`` and ``fold3_fastlo``
     > 80 dB SNR on the expected bin;
   * the clamped front ends over 3 blocks of the same carrier at c=512:
     the exact mix then K19 against the exact mix, K18 and the plain
     time-major HBF, and K3 ``clamp=`` against the plain fast mix, K18 and
     that HBF (integer state bit for bit, output within 16 ULP); at
     c=1024 on the bank's blocks K12 ``clamp=`` against the fast mix, K18
     and keep 1 in 16 (bit for bit);
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
     c=512, t=32768): `RoundTrip` (depth 4, x ~ N(0, 1)) in ``scan``,
     ``kernel`` (K7, K8) and ``mxu`` (K22, K23, once a block each),
     `cic_hbf_decimate_t` (CIC N=3 by 4, then half-band by 4; x in
     +-2^20) plain and with K9 + K7, and CIC interpolation (N=3, R=16, x
     in +-2^10) plain and with K10, over 3 blocks: ``kernel`` within 32
     ULP of ``scan``, ``mxu`` within 5e-5 of the scale of ``scan`` with
     the decimator's stage-0 carry bit for bit, the CIC state and the CIC
     interpolation bit for bit, the composite output within 16 ULP; then
     the quality gates of tests/test_rate_ddc_bank.py:11-54 in kernel and
     mxu modes, each lane with its own tone or level, and the HBF_TAPS_98
     gates (tests/test_hbf.py:64-78: passband within 0.001 dB, stopband
     below -98 dB) on the depth-4 round trip in all three modes;
   * BASELINE #1 (benches/suite.py:751-794): `FmReceiver` in ``scan``,
     ``composed`` (K26), ``kernel`` (K15) and ``kernel_fast`` at c=512,
     t=32768, carrier 12345, Q32<30> deemphasis at 0.02, over 3 blocks:
     ``kernel`` == ``composed`` == ``scan`` on every word,
     ``kernel_fast`` within 1024 LSB; `run_fm_disc` with K15 (both
     angles) against fm_disc.rs:151-157;
   * BASELINE #2 (suite.py:899-931): `DdcLockinBank` ``scan`` and
     ``kernel`` (K16) at c=512, t=32768, lowpass 0.002, over 3 blocks:
     within 2e-5; a tone at channel 40 against the gates of
     tests/test_structures_pallas.py:214-229;
   * the control path at c=1024 lanes, t=32768, over 3 blocks:
     `compat.sos` (K24, 4 stages of the suite's Q29 lowpass at 0.1, x in
     +-2^24), `compat.sos_clamp_wide` (K25, 2 stages clamped at (0,
     +-2^30), x full range), `ConfigBank` clamped (K27) and not (K26) over
     1024 configs (Filter lowpass/notch/bandpass, Pid I/PI; limits
     +-2^26; x in +-2^27), half the channels retuned after the first
     block: the first T_PREFIX rows of each compat output equal the plain
     versions on the CPU, K24/K25/K27 over two half-blocks equal one
     block, and after the retune every channel equals the plain K27/K26
     with the new planes on T_PREFIX rows while the channels not retuned
     equal a bank never retuned on every word;
   * the precision ladder (benches/suite.py:279-388) at c=1024 lanes,
     t=32768, over 3 blocks from zero state, the suite's lowpass at 0.1:
     K28 (Q16<13>, x in +-2^14), K29 (Q64<61>, x in +-2^55), K30 (f32,
     x ~ N(0, 1)), K31 (Q29, x in +-2^24) unclamped and with the suite's
     clamp row (0, +-2^30), K32 and K33 with per-lane planes; after the
     counts are read, K32/K33 with a shared (5,) set equal K25/K31 on one
     block; each rung within
     `rung_error`'s bound of the float64 DF1 of its coefficients on
     T_PREFIX rows;
   * the filter structures (benches/suite.py:442-569) at c=1024 lanes,
     t=32768, over 3 blocks from zero state: K34 with each of its four
     outputs, K35 and K36 (the suite's lowpass at 0.06), K37 on the
     suite's row and on the reference's default and wide-fast scenarios
     (tests/test_loops.py:262-280; one timestamp stream a lane, lane 0
     from the test's first timestamp, every other lane from its own, each
     with its own noise), K38, K39, K40 over
     wdf-ca-7 and over wdf-ca-19 with an impulse on lane 0; then the
     gates: the SVF's br == hp + lp bit for bit and, on one more block at
     f0 0.02, Q 1/sqrt(2), tests/test_structures.py:11-32's band gains;
     the normal form against the f32 DF1 of its cookbook filter
     (:35-59); each RPLL scenario within the reference's limits, lane 0
     after the test's settling rows and every lane after twice them (the
     readings of every lane after the test's rows logged); K38 and K39
     allpass; wdf-ca-7's complementary half-band (:80-114) on every lane
     and wdf-ca-19's response on lane 0 (:150-200: DC within 1e-5,
     ripple within 1e-5 dB, stopband below -75 dB);
   * the scale-out layer (`idsp_tpu_torch.parallel`) on P_PAR = 4
     processes sharing the card, spawned after the others (one gloo group
     through `distributed.initialize_from_env` and `make_mesh`; K41 moves
     every shift): K41 `halo_exchange_prev_rdma` against its plain version
     (the gloo ring on CPU copies) on (8192, 1024) int32 and f32 blocks at
     h = 1, 2, 90, 3 blocks back to back on the same slots, and the ring
     of one (all fill), bit for bit; then, K41's count from 0 in every
     rank, `sharded_hbf_dec` (rdma, HBF_TAPS[0], 1024 lanes of f32,
     time-last, 3 blocks) within 2e-6 of `hbf_dec_block` on the whole
     stream with the state bit for bit; `sharded_df1_q_relay` (Q29 at
     0.05, 1024 lanes, one block) equal to `df1_process_q` over the whole
     stream; `sharded_df1_float` (float64, 3 blocks) within 1e-9 + 1e-9
     |y| of `df1_block_float`; `pipelined_sos_cascade_sharded` (4 Q29
     stages at 0.05-0.14, 1024 lanes, 8 blocks of 4096) equal to the
     stage-major sweep; `channelize_tp` (m = 1024, 8 taps, n = 1024, f32,
     both ``out_mode``s, 3 blocks) within 2e-5 of `channelize`'s scale,
     history bit for bit; `DdcChain` ``fold3`` on each rank's quarter of
     c = 1024 channels equal to the whole bank's columns (3 blocks).  The
     parent computes the relay's and the pipeline's references with the
     plain scans while the ranks run;
   * BASELINE #3 (suite.py:960-1012): `channelize_planes` ``fused``
     (K17) and ``xla`` at m=1024, 8 taps, n=1024 (3 blocks) and 16384,
     bf16 and f32: fused within 2e-5 of the scale; a tone at channel 100
     through the fused path, p[100] > 1e4 x the rest at f32, > 10x at
     bf16;
5. every kernel's launch counter > 0 from its main path's run (the
   ``clamp=`` forms of K3 and K12 counted on their own; K41 summed over
   the ranks);
6. CUDA-event times of each kernel and its plain version (the plain
   calls timed in phase 3; one call, `ONCE`, of ``scan`` and of K1-K3's
   plain versions at c=1024), of the plain
   layers around
   them (exact mix, time-major HBF, fast mix, atan2),
   chain rates (every mode but ``scan`` with its busy share) at c=512
   and c=1024 and bank rates at c=1024, in c*t full-rate samples/s,
   t=32768 (K14, K18-K21 and K3's clamp form at c=512 and 1024, their
   plain versions' times from phase 3; K1, K2, K3, K14, K18-K21 and K3's
   clamp form also by their profiler spans, device ms a launch, and K2 beside
   "K1 then K7", the two-kernel composition it fuses; K11-K13 (each
   with its device ms), K12's clamp form and the
   biquad bank's five modes at c=1024); K7-K10 and K22-K23 (also at
   their second tiling; K7, K8, K22 and K23 also by their profiler
   spans, device ms a launch, and K7/K8 so at the chunks of HBF_CHUNKS
   and the range counts of HBF_BLOCKS_PER_SM blocks an SM) at c=512 and
   1024 beside their
   library yardsticks (grouped `F.conv1d` per half-band stage, TF32
   off; chained `torch.cumsum` and `torch.diff` for the CIC; K9/K10 also
   by their profiler spans, device ms a launch, with the plain combs'
   spans and the plan),
   round-trip and composite
   rates at c=512 and 1024; K15 (both angles; also by its profiler
   spans, device ms a launch) and K16 at c=512 with the FM and lock-in
   modes' block times; K17 (bf16 and f32) at n=1024 and
   16384 with its launch plan and its device ms a launch (profiler
   spans), and the forced 64-frame plan's time, beside its plain version and its library yardstick (the FIR in
   torch ops and `torch.matmul` of the four products, TF32 off), with
   the planes path's rates (n*m samples/s); K24-K27 at c=1024 lanes with
   their plain versions' times from phase 3 (K24-K27 also by their
   profiler spans, device ms a launch), and the control legs' block
   times; K28-K33 at c=1024 lanes with their plain versions' times from
   phase 3 (K31 clamped and K32/K33 with a shared set on the log only;
   K28-K33 also by their profiler spans, device ms a launch);
   K34-K40 at c=1024 lanes with their rates and their plain versions'
   times from phase 3 (K40 over wdf-ca-7 on the log only), K29, K31,
   K33 and K34-K40 also by their profiler spans, device ms a launch;
   K41 at h = 1, 2, 90 on (8192, 1024) f32 blocks, timed by the ranks
   at the end of phase 4 once the parent is done: the median of 20 calls
   with CUDA events (host gate included; 4 time-sliced processes on one
   card, not link latency), its plain version's (host clock) and the
   yardstick's, torch's own CUDA IPC (`peer_view.copy_` between two host
   barriers);
   for each kernel mode, the device's busy
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

import itertools
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
# K17's products: f32 FMAs at the data sheet's 67 Tflop/s (an FMA two
# flops), bf16 on the tensor cores at 989 Tflop/s dense.
F32_FMA_FLOPS_PER_S = 67e12
BF16_MMA_FLOPS_PER_S = 989e12
# An estimate, not a measurement, printed on the log line only: the
# latency floor of a serial recurrence, its dependent operations per step
# (read off the source; each 64-bit operation counted once) at an assumed
# 4 cycles each (the fixed-latency ALU pipes) at the SM's maximum clock.
CYCLES_PER_DEPENDENT_OP = 4
BUSY_ITERS = 5  # chained blocks under the profiler per busy-share reading
# A plain version or scan takes seconds a block and compiles nothing, and
# phases 3-4 have run it at the same shape: phase 6 times one call of it.
ONCE = {"iters": 1, "trials": 1, "warmup": False}
M_DEC3, M_DEC4, M_INT4 = (5, 10, 23), (4, 5, 10, 23), (23, 10, 5, 4)
# K22/K23's (block, sub) tilings in phase 3: the defaults first (for the
# MMA kernels block is the chunk a CUDA block takes at a time: 1024 rows
# at depth 4 would ask for 290 KB of shared memory)
MXU_DEC_TILES, MXU_INT_TILES = ((256, 32), (512, 8)), ((64, 32), (16, 4))
# K22/K23's precisions; "split3" (the round trip's) keeps the bare names
MXU_PRECISIONS = ("split3", "default", "highest")
# K22/K23's plain versions against the float64 truth (the band of float64
# taps in float64), of the scale max |y|: hi + lo is within 2^-17 of a
# stage input and of a weight (the kernels against their plain versions:
# hbf_mxu.KERNEL_TOL)
MXU_TRUTH = {"highest": 1e-6, "split3": 2.0 ** -15, "default": 1e-2}
# K22/K23 in phase 3 at forced range counts (the private wrappers' ranges)
MXU_RANGES = (1, 7)
# K7/K8 in phase 3 beside the default launch: (depth, c, forced ranges,
# taps); None is the default count, 10**6 one output row a range
HBF_RANGE_CASES = ((1, 200, 3, "HBF_TAPS_98"), (2, C_RATE, 1, "HBF_TAPS"),
                   (3, 200, None, "HBF_TAPS"), (4, C_RATE, 2, "HBF_TAPS"),
                   (4, 200, 64, "HBF_TAPS_98"), (4, C_RATE, 10**6, "HBF_TAPS"))
# K9/K10 in phase 3 at the edges of their time-range plan (`cic_plan`),
# each over HOLD_BLOCKS carried blocks from a random state: (kernel, N, R,
# c, t input rows, forced plan or None for the default); the lengths in
# input rows (K9: fast, K10: slow), t <= 8192 each
CIC_EDGES = (
    ("K9", 3, 16, C_RATE, 8192, dict(length=8192, warps=1, cluster=1)),
    ("K9", 1, 1, 200, 256, dict(length=1, warps=32, cluster=8)),
    ("K9", 8, 4, 200, 1024, dict(length=4, warps=32, cluster=8)),
    ("K9", 3, 4, 200, 8192, dict(length=108, warps=16, cluster=5)),
    ("K9", 8, 1, 200, 8192, None),
    ("K10", 1, 1, 200, 256, dict(length=1, warps=32, cluster=8)),
    ("K10", 8, 4, 200, 2048, dict(length=9, warps=32, cluster=8)),
    ("K10", 3, 16, C_RATE, 512, dict(length=512, warps=1, cluster=1)),
    ("K10", 3, 4, 200, 2048, None),
)
# K7/K8 in phase 6 at other chunks and range counts (blocks an SM)
HBF_CHUNKS = {"hbf_dec_cascade_bank": (128, 256, 512),
              "hbf_int_cascade_bank": (16, 32, 64)}
HBF_BLOCKS_PER_SM = (1, 2, 4, 8)
# the device symbols of the half-band cascade, CIC, channelizer, WDF,
# fused DDC-cascade, K14 and K15 kernels, for their device time
DEVICE_SYMBOLS = {"hbf_dec_cascade_bank": "hbf_dec_cascade_kernel",
                  "cic_dec_bank": "cic_range_kernel",
                  "cic_int_bank": "cic_range_kernel",
                  "hbf_int_cascade_bank": "hbf_int_cascade_kernel",
                  "hbf_dec_cascade_mxu": "hbf_dec_mma_kernel",
                  "hbf_int_cascade_mxu": "hbf_int_mma_kernel",
                  "hbf_dec_cascade_mxu_default": "hbf_dec_mma_kernel",
                  "hbf_int_cascade_mxu_default": "hbf_int_mma_kernel",
                  "hbf_dec_cascade_mxu_highest": "hbf_dec_band_kernel",
                  "hbf_int_cascade_mxu_highest": "hbf_int_band_kernel",
                  "channelize_fused": "channelize_kernel",
                  "channelize_fused_f32": "channelize_kernel",
                  "wdf_bank": "wdf_pipeline_kernel",
                  "wdf_chain_bank": "wdf_pipeline_kernel",
                  "wdf_pair_bank": "wdf_pipeline_kernel",
                  "wdf_pair_bank_ca7": "wdf_pipeline_kernel",
                  "df1_hbf_cascade_bank": "ddc_cascade_kernel",
                  "fastlo_ddc_cascade_bank": "ddc_cascade_kernel",
                  "df1_clamp_hbf_cascade_bank": "ddc_cascade_kernel",
                  "df1_hbf1_bank": "ddc_cascade_kernel",
                  "df1_hbf12_bank": "ddc_cascade_kernel",
                  "fastlo_ddc_cascade_bank_clamp": "ddc_cascade_kernel",
                  "ddc_mix_df1_bank": "ddc_mix_df1_kernel",
                  "df1_bank_q16": "df1_q16_kernel",
                  "df1_bank_q64": "df1_q64_kernel",
                  "df1_bank_f32": "df1_f32_kernel",
                  "df1_dither_bank": "df1_dither_kernel",
                  "df1_dither_bank_coef": "df1_dither_kernel",
                  "svf_bank": "svf_kernel",
                  "normal_bank_q": "normal_q_kernel",
                  "normal_bank_f32": "normal_f32_kernel",
                  "rpll_bank": "rpll_kernel",
                  "fm_disc_bank": "fm_disc_kernel",
                  "fm_disc_bank_fast": "fm_disc_kernel",
                  "fastlo_df1_dec_bank": "ddc_bank_kernel",
                  "fastlo_df1_dec_bank_clamp": "ddc_bank_kernel",
                  "fastlo_ddc_bank_block": "ddc_bank_kernel",
                  "fastlo_ddc_bank_block_lp": "ddc_bank_kernel",
                  "lowpass_bank": "lowpass_pipe_kernel",
                  "pll_bank": "pll_pipe_kernel",
                  "ddc_lockin_bank": "ddc_lockin_kernel",
                  "df1_bank_q": "df1_pipe_kernel",
                  "df1_bank_q_dec": "df1_pipe_kernel",
                  "df1_clamp_bank_q": "df1_pipe_kernel",
                  "df1_bank_q_coef": "df1_pipe_kernel",
                  "df1_clamp_bank_q_coef": "df1_pipe_kernel",
                  "sos_bank_q": "sos_chain_kernel",
                  "df1_wide_bank": "df1_wide_pipe_kernel",
                  "df1_wide_bank_coef": "df1_wide_pipe_kernel"}
# The anti-windup clamp (u, lo, hi) of the clamped kernels' checks.  On
# the chain's mixed stream the 0.02 lowpass output peaks near 2.6e7, under
# the 2^26 bound of tests/test_biquad_pallas.py:896, so that bound never
# engages there; 2^23 pins a few % of the DF1 outputs (the bank's 0.004
# lowpass: ~0.1 %).  CLAMP_SUITE is benches/suite.py:644-660's row.
CLAMP = (1 << 10, -(1 << 23), 1 << 23)
CLAMP_SUITE = (0, -(1 << 29), (1 << 29) - 1)
# BASELINE #1-#3 at the widths of benches/suite.py:751-1012
C_FM, FM_CARRIER = 512, 12345  # FM bank; carrier word of suite.py:760
C_LOCKIN, TC_LOCKIN = 512, 512  # lock-in channels, LO table chunk
M_CH, CH_TAPS = 1024, 8  # channelizer branches, prototype taps
N_CH = (1024, 16384)  # frames per block (suite.py:960, 1005)
# K17 in phase 3: (m, n, carried blocks); m = 384 and 2048 run clusters of
# 3 CTAs and of 8 with the FIR done twice
K17_CASES = ((M_CH, N_CH[0], BLOCKS), (M_CH, N_CH[1], 1), (384, N_CH[0], 1),
             (2048, N_CH[0], 1))
# The Stabilizer IIR control path at the port's bank width: compat.sos
# through the reference's "q32 cascade4" row (benches/suite.py:397-417),
# compat.sos_clamp_wide with the suite's clamp row (suite.py:323), the
# config bank's shared limits; the plain versions' prefix checks and the
# unclamped K25 / shared-set K26 holds run on T_PREFIX rows.
C_CTL, SOS_STAGES, WIDE_STAGES = 1024, 4, 2
WIDE_CLAMP = (0, -(2**30), 2**30)  # also the dither clamp row, suite.py:323
CONFIG_LIMITS = (-(2**26), 2**26)
T_PREFIX = 4096
# Phase 3's holds (`hold`) by default: HOLD_BLOCKS carried full blocks of
# T rows each (phase 4's main path runs BLOCKS).  The plain versions' host
# row loops set most of the run's wall time: 3 blocks a hold took the run
# to 1232 s of its 1200 on a slow host (PERF.md §7).
HOLD_BLOCKS = 2
# The biquad precision ladder (benches/suite.py:279-388) at the port's
# bank width; its plain versions' second forms run on T_PREFIX rows.
C_PREC = 1024
# The filter structures (benches/suite.py:442-569) at the same bank width:
# the SVF row (f0, Q), the normal form's cookbook lowpass, the RPLL row
# (dt2, shift_frequency, shift_phase), and the WDF complementary pairs
# (tests/embedded/src/bin/biquad.rs:120-173) as (nibble word, adapters, g)
# stages of branch 0 and branch 1.
C_STRUCT = 1024
SVF_ROW, SVF_GATE = (0.01, 0.7), (0.02, 1 / np.sqrt(2.0))
NORMAL_FC = 0.06
RPLL_ROW = (8, 12, 11)
WDF_CA7 = ([(0xAD, 2, [-0.9, 0.9]), (0xAD, 2, [-0.6, 0.7])],
           [(0xAD, 2, [-0.7, 0.6]), (0xA, 1, [0.8])])
WDF_CA19 = ([(0x1, 1, [0.0]), (0x1C, 2, [-0.226119, 0.0]),
             (0x1D, 2, [-0.602422, 0.0]), (0x1D, 2, [-0.83932, 0.0]),
             (0x1D, 2, [-0.950847, 0.0])],
            [(0x1C, 2, [-0.063978, 0.0]), (0x1C, 2, [-0.423068, 0.0]),
             (0x1D, 2, [-0.741327, 0.0]), (0x1D, 2, [-0.905567, 0.0]),
             (0x1D, 2, [-0.984721, 0.0])])
# The WDF kernel off the suite's plans in phase 3 (on T_PREFIX rows): one
# stage of every adapter type (outside the specialised set: the generic
# loop) with coefficients in range, and a forced small chunk
WDF_EVERY = ((0xA, 0.7), (0xB, 0.3), (0xE, 0.2), (0x1, 0.0), (0xC, -0.3),
             (0xF, -0.45), (0xD, -0.8), (0x0, 0.0))
WDF_SMALL_CHUNK = 5
# The reference's RPLL scenarios that settle within BLOCKS blocks
# (tests/test_loops.py:262-280): (dt2, sf, sp), period, the test's first
# timestamp, noise, the limits of (mean, standard error) of the frequency
# and of the phase error, and the rows measured.
RPLL_SCENARIOS = {
    "default": ((8, 9, 8), 333, 111, 0, (1e-11, 4e-8, 2e-8, 2e-8), 1 << 14),
    "wide-fast": ((8, 10, 9), 990, 351, 5, (2e-5, 3e-1, 2e-4, 2e-1),
                  1 << 16),
}
# The scale-out layer (`idsp_tpu_torch.parallel`) at P_PAR ranks, each a
# process on card 0 in one gloo group (its CUDA all-reduce carries the
# sums) with K41 for every shift; each rank holds a quarter of a t = T
# stream of C_PAR lanes.
P_PAR, C_PAR = 4, 1024
T_LOC = T // P_PAR
HALO_HS = (1, 2, 90)  # 90 = 4 * 23 - 2, the halo of HBF_TAPS[0]
HALO_H, HALO_FILL = 90, -7  # the kernels line's h; test_halo_rdma's fill
K41_ROUNDS = 20
PIPE_NB, PIPE_FCS = 8, (0.05, 0.08, 0.11, 0.14)  # S = 4 Q29 stages
PAR_SEED = 1234


def fir_dec_ops(t, ms):
    """f32 operations of a decimation cascade per lane: 3m per output
    (m pair adds, m products, m-1 sums, the center add)."""
    return sum((t >> (d + 1)) * 3 * m for d, m in enumerate(ms))


def fir_int_ops(t, ms):
    """f32 operations of an interpolation cascade per lane: 3m-1 per FIR
    output, one FIR output per stage input row (the center is a copy)."""
    return sum((t << d) * (3 * m - 1) for d, m in enumerate(ms))


def _w(nbytes, f32, i32, steps, chain, fma=0, mma=0):
    """One kernel call's work: bytes moved, f32 operations issued one by
    one, int32 operations, f32 flops of FMAs (2 each), bf16 tensor-core
    flops, serial steps and dependent operations per step."""
    return {"bytes": nbytes, "f32": f32, "i32": i32, "fma": fma, "mma": mma,
            "steps": steps, "chain": chain}


def work(name, c, t=T):
    """The `_w` work of one call of a kernel at the shapes phase 6 times
    it: c channels (2c I|Q lanes for K1-K6, K11-K14 and K18-K21, c lanes
    for K7-K10, c channels for K15 and K16, c frames of M_CH branches for
    K17), t full-rate rows.  A name ending in ``_clamp`` is the ``clamp=``
    form of K3 or K12.  Operation counts are read off the kernels'
    sources."""
    c2 = 2 * c
    tails3 = 2 * 4 * sum(3 * m - 2 for m in M_DEC3) * c2
    tables = 2 * 4 * (t // TC + TC) * c  # fast-LO factor tables
    # the anti-windup clamp: add, max, min per sample, on the serial chain
    base = name.removesuffix("_clamp")
    df1, chain = (14, 6) if "clamp" in name else (11, 3)
    if name == "df1_bank_q":  # 5 products, 4 adds, shift, convert
        return _w(8 * t * c2 + 32 * c2, 0, 11 * t * c2, t, 3)
    # K24-K27 at c lanes (not I|Q pairs): x in, y out, the state in and out
    if name == "sos_bank_q":  # SOS_STAGES chained DF1s a row
        return _w(8 * t * c + 32 * SOS_STAGES * c, 0,
                  11 * SOS_STAGES * t * c, t, 3 * SOS_STAGES)
    if name == "df1_wide_bank":  # clamped: 3 products, 2 split-word
        # products (mask, multiply, shift, high word, multiply, add: 6
        # each), 4 adds, the shift, the high word, the clamp 3, the splice
        # 3; on the chain: split product, add, shift, clamp, splice
        return _w(8 * t * c + 48 * c, 0, 27 * t * c, t, 9)
    if name in ("df1_bank_q_coef", "df1_clamp_bank_q_coef"):  # K1 / K18
        # with the lane's five coefficients read once
        return _w(8 * t * c + 52 * c, 0, df1 * t * c, t, chain)
    # K28-K33 at c lanes: x in, y out, the state in and out
    if name == "df1_bank_q16":  # K1's 11 ops on 2-byte words
        return _w(4 * t * c + 16 * c, 0, 11 * t * c, t, 3)
    if name == "df1_bank_q64":  # what the function needs, not what the
        # kernel issues: per signed 64 x 64 -> 128-bit product one full
        # product of 32-bit limbs (12), per 128-bit sum four carry-chained
        # 32-bit adds (4 x 4), the funnel shift's two output words (2): 78;
        # on the chain the high-word product of y1, its carry and the shift
        return _w(16 * t * c + 64 * c, 0, 78 * t * c, t, 10)
    if name == "df1_bank_f32":  # 5 products and 4 adds, one by one
        return _w(8 * t * c + 32 * c, 9 * t * c, 0, t, 3)
    if name in ("df1_dither_bank", "df1_dither_bank_coef"):  # K1's 11
        # and the error word's add, the shift left, its mask and shift
        # right; on the chain the product, the adds, the shift, the high
        # word; e in and out as int64; K33 reads its five planes once
        planes = 20 * c if name.endswith("coef") else 0
        return _w(8 * t * c + 48 * c + planes, 0, 15 * t * c, t, 4)
    if name == "df1_wide_bank_coef":  # K25 unclamped: 3 products, 2
        # split-word products (6 each), 4 adds, the shift, the high word;
        # on the chain the split product, the add, the shift
        return _w(8 * t * c + 68 * c, 0, 21 * t * c, t, 6)
    if name == "df1_clamp_bank_q":  # K1's DF1 + the clamp, int32 out
        return _w(8 * t * c2 + 32 * c2, 0, df1 * t * c2, t, chain)
    if name in ("df1_hbf_cascade_bank", "df1_clamp_hbf_cascade_bank",
                "df1_hbf1_bank", "df1_hbf12_bank"):
        ms = {"df1_hbf1_bank": M_DEC3[:1],
              "df1_hbf12_bank": M_DEC3[:2]}.get(name, M_DEC3)
        return _w(4 * t * c2 + 4 * (t >> len(ms)) * c2
                  + 2 * 4 * sum(3 * m - 2 for m in ms) * c2 + 32 * c2,
                  fir_dec_ops(t, ms) * c2, df1 * t * c2, t, chain)
    if base == "fastlo_ddc_cascade_bank":  # + 6 f32 ops of mix per sample
        return _w(4 * t + tables + 4 * (t // 8) * c2 + tails3 + 32 * c2,
                  (6 * t + fir_dec_ops(t, M_DEC3)) * c2, df1 * t * c2, t,
                  chain)
    if name == "lowpass_bank":  # Lowpass<2>: 9 int ops per sample
        return _w(4 * t * c2 + 4 * (t // DEC) * c2 + 32 * c2, 0,
                  9 * t * c2, t, 8)
    if name == "pll_bank":  # about 25 int ops per kept row
        rows = t // DEC
        return _w(8 * rows * c + 72 * c, 0, 25 * rows * c, rows, 12)
    if name == "fastlo_ddc_bank_block_lp":  # mix, 2 lowpasses, atan2+PLL
        return _w(4 * t + tables + 12 * (t // DEC) * c + 32 * c2 + 80 * c,
                  6 * t * c2, 9 * t * c2 + 55 * (t // DEC) * c, t, 8)
    if name == "df1_bank_q_dec":  # K1's DF1, t/d rows out
        return _w(4 * t * c2 + 4 * (t // DEC) * c2 + 32 * c2, 0,
                  11 * t * c2, t, 3)
    if base == "fastlo_df1_dec_bank":  # mix, 2 DF1s, t/d rows out
        return _w(4 * t + tables + 8 * (t // DEC) * c + 32 * c2, 6 * t * c2,
                  df1 * t * c2, t, chain)
    if name == "fastlo_ddc_bank_block":  # K12, then atan2 + PLL
        return _w(4 * t + tables + 8 * (t // DEC) * c + 32 * c2 + 72 * c,
                  6 * t * c2, 11 * t * c2 + 55 * (t // DEC) * c, t, 3)
    if name == "ddc_mix_df1_bank":  # per channel and row: the LO 38 (once,
        # though the kernel's I and Q lanes each make it), then per lane
        # the mix 2 and the DF1 11
        return _w(4 * t + 8 * c + 4 * t * c2 + 32 * c2, 0,
                  (38 + 2 * 2 + 2 * 11) * t * c, t, 3)
    # K22/K23 compute K7/K8's functions: the same work, whatever the form
    # or precision
    for mxu, shift in (("hbf_dec_cascade_mxu", "hbf_dec_cascade_bank"),
                       ("hbf_int_cascade_mxu", "hbf_int_cascade_bank")):
        if name.startswith(mxu):
            name = shift
    if name == "hbf_dec_cascade_bank":
        return _w(4 * t * c + 4 * (t >> DEPTH) * c
                  + 2 * 4 * sum(3 * m - 2 for m in M_DEC4) * c,
                  fir_dec_ops(t, M_DEC4) * c, 0, 0, 0)
    if name == "hbf_int_cascade_bank":  # t low-rate rows in
        low = t >> DEPTH
        return _w(4 * low * c + 4 * t * c
                  + 2 * 4 * sum(2 * m - 1 for m in M_INT4) * c,
                  fir_int_ops(low, M_INT4) * c, 0, 0, 0)
    # K9/K10 as phase 6 times them, through the wrapper: the kernel's N = 3
    # wrapping adds per fast row and the plain combs' 3 subtractions per
    # slow row; state read and written once (integrators and combs, (c, 3)
    # each) and the zoh row written
    slow, state = t // CIC_R, 52 * c
    if name == "cic_dec_bank":
        return _w(4 * t * c + 4 * slow * c + state, 0, 3 * (t + slow) * c,
                  t, 1)
    if name == "cic_int_bank":  # t // R slow rows in, t fast rows out
        return _w(4 * slow * c + 4 * t * c + state, 0, 3 * (t + slow) * c,
                  t, 1)
    if name == "fm_disc_bank":  # exact angle, per sample: the conjugate
        # product (4 wide products and 2 wide sums, 2 ops each, and the
        # negation) 13, atan2 ~50, the carrier 1, the DF1 11; IQ in, y
        # out, 7 state words in and out
        return _w(12 * t * c + 56 * c, 0, 75 * t * c, t, 3)
    if name == "fm_disc_bank_fast":  # f32 product 10 (4 casts), f32 angle
        # 23 (abs 2, min/max 3, divide 1, Horner 13, fold 3, scale, round,
        # clamp, cast 4); the carrier and the DF1 12 int
        return _w(12 * t * c + 56 * c, 37 * t * c, 12 * t * c, t, 3)
    if name == "ddc_lockin_bank":  # per channel and row: the LO 6, the mix
        # 2 and the negation, the two f32 DF1s 9 each; x in, tables, (t, 2c)
        # out, state (2c, 2) x2 in and out
        tabs = 2 * 4 * (t // TC_LOCKIN + TC_LOCKIN) * c
        return _w(4 * t + tabs + 4 * t * c2 + 32 * c2, 27 * t * c, 0, t, 3)
    if name in ("channelize_fused", "channelize_fused_f32"):  # c frames:
        # the FIR 2 planes x (taps products + taps-1 sums) per sample; the
        # DFT 8m flops per complex sample; planes in and out, twiddles,
        # coefficients and history
        n, m = c, M_CH
        tw = 2 if name == "channelize_fused" else 4
        nbytes = (16 * n * m + 2 * tw * m * m + 4 * CH_TAPS * m
                  + 4 * 4 * (CH_TAPS - 1) * m)
        fir = 2 * (2 * CH_TAPS - 1) * n * m
        dft = 8 * m * n * m
        if name == "channelize_fused":
            return _w(nbytes, fir, 0, 0, 0, mma=dft)
        return _w(nbytes, fir, 0, 0, 0, fma=dft)
    # K34-K40 at c lanes: read off csrc/structures_bank.cu and wdf_bank.cu
    if name == "svf_bank":  # lp: 4 products and 3 adds; 3 words in and out
        return _w(8 * t * c + 24 * c, 7 * t * c, 0, t, 6)
    if name == "normal_bank_q":  # 7 products, 5 adds, 2 shifts, 2 narrows;
        # on the chain (W from the producers) p_re y1's multiply-add onto W,
        # -p_im y0's onto that, the shift (acc0: two, then its shift)
        return _w(8 * t * c + 32 * c, 0, 16 * t * c, t, 3)
    if name == "normal_bank_f32":  # 7 products and 5 adds, one by one; on
        # the chain (s from the producers) p_re y1, + s, - p_im y0
        return _w(8 * t * c + 32 * c, 12 * t * c, 0, t, 3)
    if name == "rpll_bank":  # 4 B x, a mask byte in, phase and frequency
        # out; per sample the phase add, dx, the u32 x u32 -> u64 product,
        # the 64-bit bias add 2 and shift 2, ff2 2, dt 2, the y_ref shift and
        # product, dy's subtract and shift, f2, 3 selects: 19; on the chain
        # ff -> product, bias, shift, two adds, select (and f's 6)
        return _w(13 * t * c + 32 * c, 0, 19 * t * c, t, 7)
    if name in ("wdf_bank", "wdf_chain_bank", "wdf_pair_bank",
                "wdf_pair_bank_ca7"):
        # 4 ops an adapter but X and Z (subtract, high-word product, two
        # adds), the pair's butterfly 2; z in and out; on the chain the
        # adapters of one stage (a stage's input comes from the stage before
        # in the same sample, so stages pipeline across samples)
        spec = {"wdf_bank": ([WDF_CA7[0][0]],),
                "wdf_chain_bank": (WDF_CA19[0],),
                "wdf_pair_bank": WDF_CA19,
                "wdf_pair_bank_ca7": WDF_CA7}[name]
        stages = [(m, n) for br in spec for m, n, _ in br]
        arith = [sum((m >> (4 * j)) & 0xF in (0xA, 0xB, 0xE, 0xC, 0xF, 0xD)
                     for j in range(n)) for m, n in stages]
        pair = len(spec) == 2
        return _w(4 * t * c * (3 if pair else 2)
                  + 8 * c * sum(n for _, n in stages), 0,
                  (4 * sum(arith) + 2 * pair) * t * c, t, 4 * max(arith))
    if name == "halo_exchange_prev_rdma":  # K41 at c lanes of f32: the
        # sender's HALO_H rows read once and the receiver's written once
        # (the slot between is the kernel's own).  Latency, not bytes,
        # bounds it: the flag round trip between processes.
        return _w(2 * HALO_H * 4 * c, 0, 0, 0, 0)
    raise KeyError(name)


def bounds(name, c, sm_mhz):
    """(bound_ms, bound_by, estimated latency floor ms or None) of
    `work`: the larger of the bytes over the memory rate and each kind of
    operation over its peak."""
    w = work(name, c)
    t_bytes = w["bytes"] / HBM_BYTES_PER_S
    t_ops = max(w["f32"] / F32_OPS_PER_S, w["i32"] / I32_OPS_PER_S,
                w["fma"] / F32_FMA_FLOPS_PER_S, w["mma"] / BF16_MMA_FLOPS_PER_S)
    floor = (w["steps"] * w["chain"] * CYCLES_PER_DEPENDENT_OP
             / (sm_mhz * 1e6) * 1e3 if w["steps"] else None)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", floor)


def log(msg):
    print(msg, flush=True)


def log_bound(name, c, ms, sm_mhz):
    """The `bound` log line of one kernel: its roofline bound and terms,
    and the estimated latency floor of a recurrence (not measured)."""
    bound_ms, bound_by, floor_ms = bounds(name, c, sm_mhz)
    w = work(name, c)
    log(f"bound {name} at c={c}: {bound_ms:.6f} ms ({bound_by}: "
        f"{w['bytes'] / 1e6:.2f} MB, {w['f32'] / 1e6:.1f} M f32 ops, "
        f"{w['i32'] / 1e6:.1f} M int32 ops, {w['fma'] / 1e9:.2f} G f32 FMA "
        f"flops, {w['mma'] / 1e9:.2f} G bf16 tensor flops); estimated "
        f"latency floor {floor_ms} ms ({w['steps']} steps x {w['chain']} "
        f"dependent ops x {CYCLES_PER_DEPENDENT_OP} cycles at "
        f"{sm_mhz:.0f} MHz, not measured); kernel {ms:.4f} ms")


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
    if isinstance(x, (tuple, list)):
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
    if busy is None:
        timings["busy_share"].setdefault(key, {})[c] = {
            "device_ms": None, "profiled_ms": window * 1e3, "ms": sec * 1e3,
            "spans": {}}
        log(f"phase 6 c={c} {key} busy: not measured (the profiler recorded "
            f"no device event in {BUSY_ITERS} blocks of {window * 1e3:.3f} "
            f"ms)  [{card}]")
        return
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

    # K7/K8 at forced range counts, a ragged lane tile, both tap tables and
    # every depth, from a random carried state
    for tag, kern, plain in (
            ("K7", hbf_dec_cascade_bank, hbf_dec_cascade_bank_plain),
            ("K8", hbf_int_cascade_bank, hbf_int_cascade_bank_plain)):
        name, err = kern.__name__, 0.0
        for depth, cc, ranges, tname in HBF_RANGE_CASES:
            taps = getattr(hbf, tname)
            if tag == "K7":
                st0 = tuple(hbf.HbfDecState(normal(s.odd.shape),
                                            normal(s.even.shape))
                            for s in hbf.hbf_dec_cascade_init(
                                depth, (cc,), taps=taps, axis=0, device=dev))
                rows = T
            else:
                st0 = tuple(hbf.HbfIntState(normal(s.x.shape))
                            for s in hbf.hbf_int_cascade_init(
                                depth, (cc,), taps=taps, axis=0, device=dev))
                rows = T >> depth
            err = max(err, hold(
                name,
                lambda s, x: kern(s, x, taps=taps, ranges=ranges),
                lambda s, x: plain(s, x, taps=taps), (st0,),
                lambda: normal((rows, cc))))
        errs[name] = max(errs[name], err)
        log(f"phase 3 {tag} {name} == plain over {HOLD_BLOCKS} blocks from a "
            f"random state at (depth, c, ranges, taps) {HBF_RANGE_CASES}: "
            f"max |d| {err}")


def check_cic_edges(dev, errs):
    """Phase 3 for K9 and K10 at the edges of their time-range plan
    (CIC_EDGES: one range, one R-row or slow-row range each, a ragged last
    range, N = 1 and 8, R = 1, 4 and 16, c = 200 and C_RATE, the default
    plans), each over HOLD_BLOCKS carried blocks from a random state of
    full-range words on full-range x, so every sum wraps; tolerance 0 (into
    errs under the kernel's own name).  Its inputs come from a generator of
    its own, so the other phases' inputs stay as they were.  Logs each
    plan."""
    import torch
    from idsp_tpu_torch.filters import cic
    from idsp_tpu_torch.filters.cic_cuda import (
        cic_dec_bank, cic_dec_bank_plain, cic_int_bank, cic_int_bank_plain,
        cic_launch_plan, cic_plan,
    )

    rng = np.random.default_rng(25)

    def i32(shape):
        return torch.from_numpy(rng.integers(
            -(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)).to(
                dev)

    plans = []
    for tag, n, r, c, t, forced in CIC_EDGES:
        dec = tag == "K9"
        plan = (cic_launch_plan(t, c, n, r, dec, dev) if forced is None else
                cic_plan(t, c, n, r, dec=dec, **forced))
        kern, plain = ((cic_dec_bank, cic_dec_bank_plain) if dec else
                       (cic_int_bank, cic_int_bank_plain))
        st = cic.CicState(*(i32(tuple(v.shape))
                            for v in cic.init(n, 2, (c,), device=dev)))
        name = kern.__name__
        errs[name] = max(errs[name], hold(
            name, lambda s, x, k=kern, p=plan: k(s, x, r - 1, _plan=p),
            lambda s, x, f=plain: f(s, x, r - 1), (st,),
            lambda t=t, c=c: i32((t, c))))
        plans.append((tag, n, r, c, t, tuple(plan)))
    log(f"phase 3 K9/K10 == plain over {HOLD_BLOCKS} blocks from a random "
        f"state at their plans' edges, x full range; (kernel, N, R, c, t, "
        f"(tiles, cluster, warps, length, ranges, smem)): {plans}")


def ulp_bound(ref, k):
    """k * spacing(max |ref|) in f32 (tests/test_hbf_pallas.py:23-27)."""
    scale = np.float32(max(float(ref.abs().max()), 1.0))
    return k * float(np.spacing(scale))


def rate_main_path(dev, rng, wrappers):
    """Phase 4 for BASELINE #4: the round trip (scan, K7-K8 and K22-K23),
    the composite decimator and CIC interpolation, plain and through
    K7-K10, then the quality gates in kernel and mxu modes and the
    HBF_TAPS_98 gates in all three.  Returns the launch counts of the
    run."""
    import torch
    from idsp_tpu_torch.filters import cic, hbf
    from idsp_tpu_torch.filters.cic_cuda import cic_int_bank
    from idsp_tpu_torch.filters.hbf_mxu import (
        hbf_dec_cascade_mxu, hbf_int_cascade_mxu,
    )
    from idsp_tpu_torch.pipelines import rate_conversion as rc
    from idsp_tpu_torch.pipelines.rate_conversion import RoundTrip

    normal, ints = rate_inputs(dev, rng)
    c, rate = C_RATE, CIC_R - 1
    rt_x = [normal((T, c)) for _ in range(BLOCKS)]
    comp_x = [ints((T, c), 2**20) for _ in range(BLOCKS)]
    int_x = [ints((T // CIC_R, c), 2**10) for _ in range(BLOCKS)]

    reset(wrappers)
    rt = {}
    for m in ("scan", "kernel", "mxu"):
        mod = RoundTrip(m, DEPTH, c, device=dev)
        st, outs = mod.init_state(), []
        for xb in rt_x:
            st, y = mod(st, xb)
            outs.append((st, y))
        rt[m] = outs
    # K22 then K23 at the other precisions, through their entry points (the
    # round trip's composition, its 2^-depth gain)
    for p in MXU_PRECISIONS[1:]:
        sd = hbf.hbf_dec_cascade_init(DEPTH, (c,), axis=0, device=dev)
        si = hbf.hbf_int_cascade_init(DEPTH, (c,), axis=0, device=dev)
        outs = []
        for xb in rt_x:
            sd, low = hbf_dec_cascade_mxu(sd, xb, precision=p)
            si, y = hbf_int_cascade_mxu(si, low, precision=p)
            outs.append(y / (1 << DEPTH))
        rt[f"mxu_{p}"] = outs
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
    counts = launch_counts(wrappers)
    for name in ("hbf_dec_cascade_mxu", "hbf_int_cascade_mxu"):
        for form in ("", "_default", "_highest"):
            if counts[name + form] != BLOCKS:
                raise AssertionError(f"RoundTrip mxu: {name + form} launched "
                                     f"{counts[name + form]} times in "
                                     f"{BLOCKS} blocks")
    log(f"phase 4 main path: RoundTrip (scan, kernel, mxu; K22 then K23 at "
        f"{MXU_PRECISIONS[1:]}), "
        f"cic_hbf_decimate_t (plain, kernel), CIC interpolation (plain, "
        f"kernel) x {BLOCKS} blocks at c={c}, t={T}; launches {counts}")

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

    # mxu: outputs within 5e-5 of the scale of scan (tests/test_hbf_pallas.py
    # :244-256), the decimator's stage-0 carry (copies of the input) bit for
    # bit, every other tail within 5e-5 of its own scale (the stages' rows
    # carry their gains, up to 2^depth; bf16x3 keeps about 16 bits of each)
    worst = bound = tails = 0.0
    for b, ((st, y), (st_r, y_r)) in enumerate(zip(rt["mxu"], rt["scan"])):
        if tuple(y.shape) != (T, c) or not bool(torch.isfinite(y).all()):
            raise AssertionError("RoundTrip mxu: bad output")
        compare(f"RoundTrip mxu stage-0 carry, block {b}", st.dec[0],
                st_r.dec[0])
        bound = 5e-5 * float(y_r.abs().max())
        worst = max(worst, max_abs(y, y_r))
        if worst > bound:
            raise AssertionError(f"RoundTrip mxu off scan by {worst} > "
                                 f"{bound}")
        for a, r in zip(leaves(st), leaves(st_r), strict=True):
            d = max_abs(a, r) / max(float(r.abs().max()), 1e-30)
            tails = max(tails, d)
            if d > 5e-5:
                raise AssertionError(f"RoundTrip mxu tail off scan by {d} of "
                                     f"its scale")
    log(f"phase 4 RoundTrip mxu vs scan over {BLOCKS} blocks: stage-0 carry "
        f"bit for bit; max |d| of outputs {worst} (gate 5e-5 x scale = "
        f"{bound}); tails within {tails:.3e} of their own scales (gate "
        f"5e-5)")
    # the other precisions' outputs against scan's: "highest" within the
    # round trip's 5e-5 of the scale, "default" (eight stages, each input
    # and weight rounded to bf16, 2^-9 each) within 2^-5
    for p, gate in (("highest", 5e-5), ("default", 2.0 ** -5)):
        worst = 0.0
        for y, (_, y_r) in zip(rt[f"mxu_{p}"], rt["scan"]):
            if tuple(y.shape) != (T, c) or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"K22/K23 {p}: bad output")
            scale = float(y_r.abs().max())
            worst = max(worst, max_abs(y, y_r) / scale)
        if worst > gate:
            raise AssertionError(f"K22 then K23 ({p}) off scan by {worst} of "
                                 f"the scale > {gate}")
        log(f"phase 4 K22 then K23 ({p}) vs RoundTrip scan over {BLOCKS} "
            f"blocks: max |d| {worst:.3e} of the scale (gate {gate:.3e})")
    for mode in ("kernel", "mxu"):
        rate_gates(dev, mode)
    for mode in ("scan", "kernel", "mxu"):
        gates_98(dev, mode)
    return counts


def tone_power(dev, mod, f, n, skip, phased=False):
    """Per lane, the power of ``mod``'s output from row ``skip`` on, driven
    from its initial state by a cosine per lane at ``f`` cycles a sample
    (with ``phased``, lane k at phase 2 pi k / c); and the input's power
    likewise."""
    import torch

    c = len(f)
    phase = 2 * np.pi * np.arange(c) / c if phased else np.zeros(c)
    x = np.cos(2 * np.pi * f[None] * np.arange(n)[:, None]
               + phase[None]).astype(np.float32)
    _, y = mod(mod.init_state(), torch.from_numpy(x).to(dev))
    y = y.double().cpu().numpy()
    return (y[skip:] ** 2).mean(0), (x[skip:].astype(np.float64) ** 2).mean(0)


def passband_f(c):
    """A passband tone per lane, 0.1/16 to 0.3/16 cycles a sample, whole
    periods from row 4096 on."""
    return (77 + np.arange(c) * 153 // (c - 1)) / 12288


def rate_gates(dev, mode):
    """The quality gates of tests/test_rate_ddc_bank.py:11-54 through
    `RoundTrip(mode)` and `cic_hbf_decimate_t(use_kernel=...)` at c =
    C_RATE, one tone or level per lane."""
    import torch
    from idsp_tpu_torch.filters import cic, hbf
    from idsp_tpu_torch.pipelines import rate_conversion as rc
    from idsp_tpu_torch.pipelines.rate_conversion import RoundTrip

    c = C_RATE
    p_y, p_x = tone_power(dev, RoundTrip(mode, 4, c, device=dev),
                          passband_f(c), 1 << 14, 4096, phased=True)
    tone = float(np.abs(p_y / p_x - 1).max())
    p_y, _ = tone_power(dev, RoundTrip(mode, 2, c, device=dev),
                        np.linspace(0.15, 0.45, c), 1 << 13, 2048)
    stop = float(p_y.max())
    level = 1000 + np.arange(c)
    x = torch.from_numpy(np.broadcast_to(
        level[None], (20 * 64, c)).astype(np.int32).copy()).to(dev)
    (_, _), y = rc.cic_hbf_decimate_t(
        cic.init(3, 1, (c,), device=dev),
        hbf.hbf_dec_cascade_init(2, (c,), axis=0, device=dev), x, 4, 2,
        use_kernel=True if mode == "kernel" else mode)
    gain = cic.gain(4, 3, 1) * 4
    dc = float(np.abs(y[-1].double().cpu().numpy() / (level * gain) - 1).max())
    torch.cuda.synchronize()
    if not (tone < 1e-3 and stop < 0.5 * 10 ** (-98 / 10) and dc < 1e-3):
        raise AssertionError(f"rate-conversion gates ({mode}): tone {tone}, "
                             f"stopband {stop}, DC {dc}")
    log(f"phase 4 rate-conversion gates on {c} lanes ({mode} mode): round-"
        f"trip tone power |ratio - 1| max {tone:.3e} < 1e-3; depth-2 "
        f"stopband power max {stop:.3e} < {0.5 * 10 ** (-98 / 10):.3e}; "
        f"composite DC gain |err| max {dc:.3e} < 1e-3")


def gates_98(dev, mode):
    """The HBF_TAPS_98 gates of tests/test_hbf.py:64-78 (> 98 dB stopband,
    < 0.001 dB passband ripple) on the depth-4 round trip in ``mode`` at
    c = C_RATE: a passband tone per lane (0.1/16 to 0.3/16 cycles a
    sample) keeps its power within 0.001 dB, a stopband tone per lane
    (above 0.6/16) leaves less than -98 dB of its power."""
    from idsp_tpu_torch.filters.hbf import HBF_TAPS_98
    from idsp_tpu_torch.pipelines.rate_conversion import RoundTrip

    c, n = C_RATE, 1 << 14
    mod = RoundTrip(mode, 4, c, taps=HBF_TAPS_98, device=dev)
    p_y, p_x = tone_power(dev, mod, passband_f(c), n, 4096, phased=True)
    ripple = float(np.abs(10 * np.log10(p_y / p_x)).max())
    p_y, p_x = tone_power(dev, mod, np.linspace(0.6 / 16 + 1e-3, 0.5 - 1e-3,
                                                c), n, 4096)
    stop = float(10 * np.log10(p_y / p_x).max())
    if not (ripple < 1e-3 and stop < -98.0):
        raise AssertionError(f"HBF_TAPS_98 round trip ({mode}): ripple "
                             f"{ripple} dB, stopband {stop} dB")
    log(f"phase 4 HBF_TAPS_98 round trip on {c} lanes ({mode} mode): "
        f"passband |power ratio| max {ripple:.6f} dB < 0.001 dB; stopband "
        f"max {stop:.3f} dB < -98 dB")


def mxu_truth(states, x, taps, kind):
    """K22's (``kind`` "dec") or K23's output in float64: the band of the
    float64 taps over the float64 carried rows and input, stage by
    stage."""
    import torch

    depth, cur = len(states), x.double()
    order = range(depth - 1, -1, -1) if kind == "dec" else range(depth)
    for st, i in zip(states, order):
        tv = np.asarray(taps[i], np.float64)
        m = len(tv)
        if kind == "dec":
            win = torch.zeros((4 * m - 2, x.shape[1]), dtype=torch.float64,
                              device=x.device)
            win[1::2], win[2 * m::2] = st.odd.double(), st.even.double()
            ext, n = torch.cat([win, cur]), cur.shape[0] // 2
            band = np.zeros(4 * m - 1)
            band[0:2 * m:2], band[2 * m::2], band[2 * m - 1] = tv, tv[::-1], 1
            cur = sum(float(w) * ext[1 + v:1 + v + 2 * n:2]
                      for v, w in enumerate(band) if w)
        else:
            ext, n = torch.cat([st.x.double(), cur]), cur.shape[0]
            band = np.concatenate([tv, tv[::-1]])
            fir = sum(float(w) * ext[v:v + n] for v, w in enumerate(band))
            cur = torch.stack([fir, ext[m:m + n]], dim=1).flatten(0, 1)
    return cur


def hold_near(name, kern, plain, carry, xs, tol, plain_s=None):
    """Phase 3 for K22/K23: ``kern`` against ``plain`` (both ``fn(carry,
    x) -> (carry, y)``) over the blocks ``xs``, within ``tol`` of each
    block's scale max |y| (0: bit for bit), the stage-0 carry bit for bit.
    With a dict ``plain_s``, ``plain_s[name]`` gets the plain calls'
    median time (CUDA events).  Returns (max |d|, max |d| / scale,
    outputs that differ, outputs, the kernel's results)."""
    import statistics

    import torch

    err = rel = 0.0
    ndiff = nout = 0
    times, got_all = [], []
    for x in xs:
        got = kern(carry, x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(carry, x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
        compare(f"{name} stage-0 carry", got[0][0], want[0][0])
        scale = float(want[1].abs().max())
        for g, w in zip(leaves(got), leaves(want), strict=True):
            if not bool(torch.isfinite(g).all()) or g.shape != w.shape:
                raise AssertionError(f"{name}: bad output")
            err = max(err, max_abs(g, w))
        ndiff += int((got[1] != want[1]).sum())
        nout += got[1].numel()
        rel = max(rel, err / scale)
        if err > tol * scale:
            raise AssertionError(f"{name}: kernel off plain by {err} > "
                                 f"{tol} x {scale}")
        got_all.append(got)
        carry = got[0]
    if plain_s is not None:
        plain_s[name] = statistics.median(times)
    return err, rel, ndiff, nout, got_all


def check_mxu_kernels(dev, rng, errs, plain_s):
    """Phase 3 for K22/K23 at c = C_RATE, depth DEPTH, with HBF_TAPS and
    HBF_TAPS_98, at each precision: against the plain version over BLOCKS
    carried blocks from a random state at two tilings (block, sub), within
    `hbf_mxu.KERNEL_TOL` of the scale, the stage-0 carry bit for bit; the
    second tiling and MXU_RANGES range counts against the first bit for
    bit; one block against its two halves bit for bit; the plain version
    against the float64 truth within MXU_TRUTH.  ``plain_s`` gets the plain
    calls' median time (HBF_TAPS, the first tiling)."""
    import torch
    from idsp_tpu_torch.filters import hbf, hbf_mxu
    from idsp_tpu_torch.filters.hbf_mxu import (
        hbf_dec_cascade_mxu, hbf_dec_cascade_mxu_plain, hbf_int_cascade_mxu,
        hbf_int_cascade_mxu_plain,
    )

    normal, _ = rate_inputs(dev, rng)

    def dec_state(taps, c):
        return tuple(hbf.HbfDecState(normal(s.odd.shape), normal(s.even.shape))
                     for s in hbf.hbf_dec_cascade_init(
                         DEPTH, (c,), taps=taps, axis=0, device=dev))

    def int_state(taps, c):
        return tuple(hbf.HbfIntState(normal(s.x.shape))
                     for s in hbf.hbf_int_cascade_init(
                         DEPTH, (c,), taps=taps, axis=0, device=dev))

    for tag, kind, kern, plain, private, rows, state, tiles in (
            ("K22", "dec", hbf_dec_cascade_mxu, hbf_dec_cascade_mxu_plain,
             hbf_mxu._dec, T, dec_state, MXU_DEC_TILES),
            ("K23", "int", hbf_int_cascade_mxu, hbf_int_cascade_mxu_plain,
             hbf_mxu._int, T >> DEPTH, int_state, MXU_INT_TILES)):
        for prec in MXU_PRECISIONS:
            name = kern.__name__ + ("" if prec == "split3" else f"_{prec}")
            err = rel = truth = 0.0
            ndiff = nout = 0
            # K23 "highest" (K8's walk in the band order) also at C_WIDE
            widths = ((C_RATE, C_WIDE) if (kind, prec) == ("int", "highest")
                      else (C_RATE,))
            for tname, c in itertools.product(("HBF_TAPS", "HBF_TAPS_98"),
                                              widths):
                taps = getattr(hbf, tname)
                st0 = state(taps, c)
                xs = [normal((rows, c)) for _ in range(BLOCKS)]
                runs = []
                for i, (block, sub) in enumerate(tiles):
                    first = tname == "HBF_TAPS" and i == 0 and c == C_RATE
                    e, r, nd, no, got = hold_near(
                        name,
                        lambda s, x: kern(s, x, taps=taps, block=block,
                                          sub=sub, precision=prec),
                        lambda s, x: plain(s, x, taps=taps, precision=prec),
                        st0, xs, hbf_mxu.KERNEL_TOL[prec],
                        plain_s if first else None)
                    err, rel = max(err, e), max(rel, r)
                    ndiff, nout = ndiff + nd, nout + no
                    runs.append(got)
                compare(f"{name} ({tname}, c={c}): tilings {tiles}", runs[1],
                        runs[0])
                block, sub = tiles[0]
                for ranges in MXU_RANGES:
                    compare(f"{name} ({tname}, c={c}): {ranges} ranges",
                            private(st0, xs[0], taps, block, sub, prec,
                                    ranges), runs[0][0])
                whole = kern(st0, xs[0], taps=taps, precision=prec)
                st_a, y_a = kern(st0, xs[0][:rows // 2], taps=taps,
                                 precision=prec)
                st_b, y_b = kern(st_a, xs[0][rows // 2:], taps=taps,
                                 precision=prec)
                torch.cuda.synchronize()
                compare(f"{name} ({tname}, c={c}): two halves vs one block",
                        (st_b, torch.cat([y_a, y_b])), whole)
                want = mxu_truth(st0, xs[0], taps, kind)
                y = plain(st0, xs[0], taps=taps, precision=prec)[1]
                d = max_abs(y, want) / float(want.abs().max())
                truth = max(truth, d)
                if d > MXU_TRUTH[prec]:
                    raise AssertionError(f"{name} ({tname}) plain off the "
                                         f"float64 truth by {d} of the scale")
            errs[name] = err
            log(f"phase 3 {tag} {name} ({prec}) vs plain over {BLOCKS} "
                f"blocks (c={' and '.join(map(str, widths))}, x ({rows}, "
                f"c), depth {DEPTH}, HBF_TAPS "
                f"and HBF_TAPS_98, random carried state, (block, sub) "
                f"{tiles}): max |d| {err}, {rel:.3e} of the scale (gate "
                f"{hbf_mxu.KERNEL_TOL[prec]:.3e}); outputs differing "
                f"{ndiff} of {nout}; "
                f"tilings, ranges {MXU_RANGES} and two halves bit for bit; "
                f"plain vs float64 truth {truth:.3e} (gate "
                f"{MXU_TRUTH[prec]:.1e}); plain {plain_s[name] * 1e3:.3f} ms")


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
    """Phase 6 for BASELINE #4: K7-K10 and K22-K23 beside their plain
    versions and library yardsticks (K22/K23 also at their second phase-3
    tiling), round-trip and composite rates, busy shares."""
    import torch
    from idsp_tpu_torch.filters import cic, hbf
    from idsp_tpu_torch.filters.cic_cuda import (
        cic_dec_bank, cic_dec_bank_plain, cic_int_bank, cic_int_bank_plain,
        cic_launch_plan,
    )
    from idsp_tpu_torch.filters.hbf_cuda import (
        LANES, hbf_dec_cascade_bank, hbf_dec_cascade_bank_plain,
        hbf_int_cascade_bank, hbf_int_cascade_bank_plain,
    )
    from idsp_tpu_torch.filters.hbf_mxu import (
        hbf_dec_cascade_mxu, hbf_dec_cascade_mxu_plain, hbf_int_cascade_mxu,
        hbf_int_cascade_mxu_plain,
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
        for p in MXU_PRECISIONS:  # K22/K23, "split3" under the bare names
            tag = "" if p == "split3" else f"_{p}"
            cases["hbf_dec_cascade_mxu" + tag] = (
                lambda s, p=p: hbf_dec_cascade_mxu(s, x, precision=p),
                lambda s, p=p: hbf_dec_cascade_mxu_plain(s, x, precision=p),
                dec0)
            cases["hbf_int_cascade_mxu" + tag] = (
                lambda s, p=p: hbf_int_cascade_mxu(s, low, precision=p),
                lambda s, p=p: hbf_int_cascade_mxu_plain(s, low,
                                                         precision=p), int0)
            libs["hbf_dec_cascade_mxu" + tag] = libs["hbf_dec_cascade_bank"]
            libs["hbf_int_cascade_mxu" + tag] = libs["hbf_int_cascade_bank"]
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
            note = ""
            if name in DEVICE_SYMBOLS:
                dev_ms = launch_device_ms(name, kern, st)
                timings["kernels"][name][c]["device_ms"] = dev_ms
                note = f", device {dev_ms} ms a launch (profiler spans)"
            log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms{note}, "
                f"plain {p_s * 1e3:.4f} ms, library {l_s * 1e3:.4f} ms (max "
                f"|d| library vs kernel {lib_d:.3e}, scale "
                f"{float(ker_out.abs().max()):.3e})  [{card}]")
            if name.startswith("cic"):  # the kernel and the plain combs'
                # device spans, and the plan
                log_busy(timings, name, c, k_s, card, kern, st)
                dec = name == "cic_dec_bank"
                plan = cic_launch_plan(T if dec else T // CIC_R, c, 3, CIC_R,
                                       dec, dev)
                log(f"phase 6 c={c} {name} plan: {plan}")

        # K22/K23 at their second phase-3 tiling
        for name, kern, st, xb, (block, sub) in (
                ("hbf_dec_cascade_mxu", hbf_dec_cascade_mxu, dec0, x,
                 MXU_DEC_TILES[1]),
                ("hbf_int_cascade_mxu", hbf_int_cascade_mxu, int0, low,
                 MXU_INT_TILES[1])):
            k_s, _ = measure_rate(
                lambda s: kern(s, xb, block=block, sub=sub), st, iters=20,
                trials=3)
            timings["kernels"][name][c]["ms_tiles"] = {
                f"{block},{sub}": k_s * 1e3}
            log(f"phase 6 c={c} {name} (block={block}, sub={sub}): kernel "
                f"{k_s * 1e3:.4f} ms  [{card}]")

        # K7/K8 at other chunks and range counts, device time a launch
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tiles = -(-c // LANES)
        for name, kern, st, xb in (
                ("hbf_dec_cascade_bank", hbf_dec_cascade_bank, dec0, x),
                ("hbf_int_cascade_bank", hbf_int_cascade_bank, int0, low)):
            sweep = timings["kernels"][name][c]["device_ms_sweep"] = {}
            for tc in HBF_CHUNKS[name]:
                for k in HBF_BLOCKS_PER_SM:
                    r = -(-k * sms // tiles)
                    dev_ms = launch_device_ms(
                        name, lambda s, tc=tc, r=r: kern(
                            s, xb, time_chunk=tc, ranges=r), st)
                    sweep[f"{tc},{r}"] = dev_ms
                    log(f"phase 6 c={c} {name} (time_chunk={tc}, ranges={r}:"
                        f" {k} blocks an SM): device {dev_ms} ms a launch  "
                        f"[{card}]")

        def comp(s, xb, uk):
            return rc.cic_hbf_decimate_t(s[0], s[1], xb, 3, 2, use_kernel=uk)

        xc = ints((T, c), 2**20)
        comp0 = (cic0, hbf.hbf_dec_cascade_init(2, (c,), axis=0, device=dev))
        runs = {f"round_trip_{m}": (RoundTrip(m, DEPTH, c, device=dev), None)
                for m in ("scan", "kernel", "mxu")}
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
            if "kernel" in name or "mxu" in name:
                log_busy(timings, name, c, sec, card, step, st, xb)


def launch_device_ms(name, step, state, iters=20):
    """Device ms of one launch of ``name``'s kernel (DEVICE_SYMBOLS): the
    mean of the profiler's spans of it over ``iters`` chained calls
    (`profiling.busy_share`; each call launches it once, and the profiler
    may lose some spans); None if it recorded none.  For kernels of
    tenths of a millisecond, whose CUDA-event time takes in the wrapper's
    host work between launches."""
    from idsp_tpu_torch.profiling import busy_share

    _, _, by_name = busy_share(step, state, iters=iters)
    kept = [(n, s) for k, (n, s) in by_name.items()
            if DEVICE_SYMBOLS[name] in k]
    spans = sum(n for n, _ in kept)
    if not spans:
        return None
    return round(sum(s for _, s in kept) * iters / spans * 1e3, 4)


def hold(name, kern, plain, carry, make_x, plain_s=None,
         blocks=HOLD_BLOCKS):
    """Phase 3: ``kern`` against ``plain`` over ``blocks`` carried blocks,
    tolerance 0.  Both are called as ``fn(*carry, x)``; the first
    len(carry) results are the next carry.  ``make_x`` may make blocks of
    different lengths.  With a dict ``plain_s``, each plain call is timed
    with CUDA events and ``plain_s[name]`` gets the median over the
    longest blocks in seconds.  Returns the largest |d|."""
    import statistics

    import torch

    err, times = 0.0, []
    for _ in range(blocks):
        x = make_x()
        got = kern(*carry, x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*carry, x)
        end.record()
        torch.cuda.synchronize()
        times.append((next(leaves(x)).shape[0], start.elapsed_time(end) / 1e3))
        err = max(err, compare(name, got, want))
        carry = got[:len(carry)]
    if plain_s is not None:
        rows = max(n for n, _ in times)
        plain_s[name] = statistics.median(s for n, s in times if n == rows)
    return err


# the wrappers' other forms, counted apart: ``<form>_launches``
FORMS = ("clamp", "default", "highest")


def reset(wrappers):
    """Every launch counter of the wrappers to 0 (the other forms' too)."""
    for w in wrappers:
        w.launches = 0
        for form in FORMS:
            if hasattr(w, f"{form}_launches"):
                setattr(w, f"{form}_launches", 0)


def launch_counts(wrappers):
    """Each wrapper's launches; a wrapper with other forms (K3/K12's
    ``clamp=``, K22/K23's precisions) also reports each form's launches as
    ``<name>_<form>``."""
    counts = {w.__name__: w.launches for w in wrappers}
    counts.update({f"{w.__name__}_{form}": getattr(w, f"{form}_launches")
                   for w in wrappers for form in FORMS
                   if hasattr(w, f"{form}_launches")})
    return counts


def pinned(ys, clamp):
    """Share of the DF1 output words pinned at a clamp bound."""
    _, lo, hi = clamp
    return float(((ys == lo) | (ys == hi)).double().mean())


def check_clamp_kernels(dev, i32, errs, plain_s, ba, ba_bank):
    """Phase 3 for K18-K21 and the clamp forms of K3 and K12, each over
    HOLD_BLOCKS carried blocks against its plain version, tolerance 0, its
    plain calls timed: K18, K19 (depth 3), K20, K21 on the chain's exact
    mix of x uniform in +-2^27 at c = C_MAIN (the same blocks for all
    four), K3 ``clamp=`` at c = C_MAIN, K12 ``clamp=`` at c = C_BANK (d =
    DEC, time chunk TC), all clamped with CLAMP; then K19 once with the
    suite's clamp row.  Logs the share of DF1 outputs the clamp pinned (K18's
    output on K18/K19's input, on K3's fast mix of its first block; K12's
    kept rows)."""
    import torch
    from idsp_tpu_torch.chain import exact_mix
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.filters.biquad_cuda import (
        df1_clamp_bank_q, df1_clamp_bank_q_plain,
    )
    from idsp_tpu_torch.filters.ddc_bank_cuda import (
        fastlo_df1_dec_bank, fastlo_df1_dec_bank_plain,
    )
    from idsp_tpu_torch.filters.ddc_cuda import (
        df1_clamp_hbf_cascade_bank, df1_clamp_hbf_cascade_bank_plain,
        df1_hbf1_bank, df1_hbf1_bank_plain, df1_hbf12_bank,
        df1_hbf12_bank_plain, fastlo_ddc_cascade_bank,
        fastlo_ddc_cascade_bank_plain, hbf1_tail_init,
    )
    from idsp_tpu_torch.ops.fastlo import fastlo_mix

    u, lo, hi = CLAMP
    c, c2 = C_MAIN, 2 * C_MAIN
    steps = i32((c,), 1 << 24, 1 << 30)
    blocks = [exact_mix(i32((T,), -(2**27), 2**27), i32((c,)), steps)
              for _ in range(BLOCKS)]

    def df1_state(lanes):
        return biquad.df1_init((lanes,), device=dev)

    def tails(ms, lanes=c2):
        return tuple(hbf1_tail_init(lanes, m, device=dev) for m in ms)

    cases = (
        ("df1_clamp_bank_q",
         lambda s, xs: df1_clamp_bank_q(ba, s, xs, 29, u=u, lo=lo, hi=hi),
         lambda s, xs: df1_clamp_bank_q_plain(ba, s, xs, 29, u=u, lo=lo,
                                              hi=hi),
         (df1_state(c2),)),
        ("df1_clamp_hbf_cascade_bank",
         lambda s, tl, xs: df1_clamp_hbf_cascade_bank(
             ba, s, tl, xs, 29, u=u, lo=lo, hi=hi, time_chunk=TC),
         lambda s, tl, xs: df1_clamp_hbf_cascade_bank_plain(
             ba, s, tl, xs, 29, u=u, lo=lo, hi=hi),
         (df1_state(c2), tails(M_DEC3))),
        ("df1_hbf1_bank",
         lambda s, tl, xs: df1_hbf1_bank(ba, s, tl, xs, 29),
         lambda s, tl, xs: df1_hbf1_bank_plain(ba, s, tl, xs, 29),
         (df1_state(c2), tails(M_DEC3[:1])[0])),
        ("df1_hbf12_bank",
         lambda s, t1, t2, xs: df1_hbf12_bank(ba, s, t1, t2, xs, 29),
         lambda s, t1, t2, xs: df1_hbf12_bank_plain(ba, s, t1, t2, xs, 29),
         (df1_state(c2), *tails(M_DEC3[:2]))),
    )
    for name, kern, plain, carry in cases:
        errs[name] = hold(name, kern, plain, carry, iter(blocks).__next__,
                          plain_s)
    share = pinned(df1_clamp_bank_q(ba, df1_state(c2), blocks[0], 29, u=u,
                                    lo=lo, hi=hi)[1], CLAMP)
    if not share > 0:
        raise AssertionError("K18/K19: the clamp never engaged")
    log(f"phase 3 K18 df1_clamp_bank_q, K19 df1_clamp_hbf_cascade_bank "
        f"(depth 3), K20 df1_hbf1_bank (time_chunk 512), K21 df1_hbf12_bank "
        f"(512) == plain over {HOLD_BLOCKS} blocks of the exact mix (c={c}, "
        f"t={T}, x in +-2^27, clamp {CLAMP}): max |d| "
        f"{errs['df1_clamp_bank_q']}, "
        f"{errs['df1_clamp_hbf_cascade_bank']}, {errs['df1_hbf1_bank']}, "
        f"{errs['df1_hbf12_bank']}; DF1 outputs pinned by the clamp "
        f"{share:.4%} (first block)")

    ph = i32((c,))
    wide = [i32((T,), -(2**27), 2**27) for _ in range(BLOCKS)]
    name = "fastlo_ddc_cascade_bank_clamp"
    errs[name] = hold(
        name,
        lambda s, tl, p0, x: fastlo_ddc_cascade_bank(
            ba, s, tl, p0, steps, x, 29, clamp=CLAMP, time_chunk=TC),
        lambda s, tl, p0, x: fastlo_ddc_cascade_bank_plain(
            ba, s, tl, p0, steps, x, 29, clamp=CLAMP, time_chunk=TC),
        (df1_state(c2), tails(M_DEC3), ph), iter(wide).__next__, plain_s)
    share = pinned(df1_clamp_bank_q(
        ba, df1_state(c2), fastlo_mix(wide[0], ph, steps, TC), 29, u=u, lo=lo,
        hi=hi)[1], CLAMP)
    if not share > 0:
        raise AssertionError("K3 clamp=: the clamp never engaged")
    log(f"phase 3 K3 fastlo_ddc_cascade_bank clamp={CLAMP} == plain over "
        f"{HOLD_BLOCKS} blocks (c={c}, t={T}, time_chunk={TC}): max |d| "
        f"{errs[name]}; DF1 outputs pinned {share:.4%} (first block)")

    cb = C_BANK
    stp = i32((cb,), 1 << 24, 1 << 30)
    kept = []
    name = "fastlo_df1_dec_bank_clamp"
    kw = {"d": DEC, "clamp": CLAMP, "time_chunk": TC}

    def k12(s, p0, x):
        out = fastlo_df1_dec_bank(ba_bank, s, p0, stp, x, 29, **kw)
        kept.append(pinned(out[2], CLAMP))
        return out

    errs[name] = hold(
        name, k12,
        lambda s, p0, x: fastlo_df1_dec_bank_plain(ba_bank, s, p0, stp, x,
                                                   29, **kw),
        (df1_state(2 * cb), i32((cb,))),
        lambda: i32((T,), -(2**27), 2**27), plain_s)
    if not max(kept) > 0:
        raise AssertionError("K12 clamp=: the clamp never engaged")
    log(f"phase 3 K12 fastlo_df1_dec_bank clamp={CLAMP} == plain over "
        f"{HOLD_BLOCKS} blocks (c={cb}, t={T}, d={DEC}, time_chunk={TC}, the "
        f"bank's lowpass at 0.004): max |d| {errs[name]}; kept rows pinned "
        f"{max(kept):.4%}")

    # the suite's clamp row (benches/suite.py:644-660), one block
    su, slo, shi = CLAMP_SUITE
    got = df1_clamp_hbf_cascade_bank(ba, df1_state(c2), tails(M_DEC3),
                                     blocks[0], 29, u=su, lo=slo, hi=shi,
                                     time_chunk=TC)
    want = df1_clamp_hbf_cascade_bank_plain(ba, df1_state(c2), tails(M_DEC3),
                                            blocks[0], 29, u=su, lo=slo,
                                            hi=shi)
    torch.cuda.synchronize()
    err = compare("df1_clamp_hbf_cascade_bank (suite row)", got, want)
    errs["df1_clamp_hbf_cascade_bank"] = max(errs["df1_clamp_hbf_cascade_bank"],
                                             err)
    log(f"phase 3 K19 with the suite's clamp {CLAMP_SUITE} == plain on one "
        f"block (c={c}, t={T}): max |d| {err}")


def check_cascade_edges(dev, i32, errs, ba):
    """Phase 3 for K2, K3 (and its ``clamp=``), K19, K20 and K21 at the
    shapes that stress the kernel's rings and tiles (csrc/ddc_cascade.cu):
    t equal to one kernel chunk, t not a multiple of ring depth x chunk,
    c2 not a multiple of the lane tile (200; 50, whose rows the producer
    copies 4 bytes at a time), K3 with fine lengths other than the
    kernel's chunk, K19 with the clamp engaged, HBF_TAPS_98 at depth 4, and
    forced plans (small chunks, two slots, 8 and 16 warps);
    each over 2 carried blocks against its plain version, tolerance 0 (into
    errs under the kernel's own name)."""
    import torch
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.filters.ddc_cuda import (
        df1_clamp_hbf_cascade_bank, df1_clamp_hbf_cascade_bank_plain,
        df1_hbf1_bank, df1_hbf1_bank_plain, df1_hbf12_bank,
        df1_hbf12_bank_plain, df1_hbf_cascade_bank,
        df1_hbf_cascade_bank_plain, fastlo_ddc_cascade_bank,
        fastlo_ddc_cascade_bank_plain, launch_plan,
    )
    from idsp_tpu_torch.filters.hbf import HBF_TAPS, HBF_TAPS_98

    chain = (HBF_TAPS[2], HBF_TAPS[1], HBF_TAPS[0])
    t98 = tuple(HBF_TAPS_98[3 - d] for d in range(4))
    u, lo, hi = CLAMP

    def start(taps, c2):
        st = biquad.Df1State(x=i32((c2, 2), -(2**26), 2**26),
                             y=i32((c2, 2), -(2**26), 2**26))
        tails = tuple(torch.from_numpy(np.random.default_rng(c2).normal(
            0, 1e6, (3 * len(tv) - 2, c2)).astype(np.float32)).to(dev)
            for tv in taps)
        return st, tails

    def hold(label, name, taps, c2, t, kern, plain, blocks=2):
        st, tails = start(taps, c2)
        ps, pt = st, tails
        err = 0.0
        for _ in range(blocks):
            xs = i32((t, c2), -(2**27), 2**27)
            got, want = kern(st, tails, xs), plain(ps, pt, xs)
            torch.cuda.synchronize()
            err = max(err, compare(f"{name} ({label})", got, want))
            st, tails = got[0], got[1]
            ps, pt = want[0], want[1]
        errs[name] = max(errs.get(name, 0.0), err)
        return err

    def k2(taps, plan=None):
        tc = 1 << len(taps)  # checked, and no other use: the plan's chunk
        return (lambda s, tl, xs: df1_hbf_cascade_bank(
                    ba, s, tl, xs, 29, taps=taps, time_chunk=tc, _plan=plan),
                lambda s, tl, xs: df1_hbf_cascade_bank_plain(
                    ba, s, tl, xs, 29, taps=taps))

    def plan(c2, **kw):
        return launch_plan([5, 10, 23], c2, **kw)

    name = "df1_hbf_cascade_bank"
    for label, taps, c2, t, p in (
            ("t = one chunk", chain, 2 * C_MAIN, 128, None),
            ("t = 7 chunks + 40 rows", chain, 2 * C_MAIN, 7 * 128 + 40, None),
            ("c2 = 200", chain, 200, 1024, None),
            ("c2 = 50, 4-byte copies", chain, 50, 520, None),
            ("t = 8", chain, 64, 8, None),
            ("HBF_TAPS_98 depth 4", t98, 256, 2048, None),
            ("chunk 24, 2 slots", chain, 96, 24 * 9, plan(96, chunk=24,
                                                          ring=2)),
            ("8 warps", chain, 200, 1024, plan(200, warps=8)),
            ("16 warps, chunk 256, 2 slots", chain, 256, 2048,
             plan(256, warps=16, chunk=256, ring=2))):
        hold(label, name, taps, c2, t, *k2(taps, p))
    name = "df1_clamp_hbf_cascade_bank"
    c2, t = 200, 7 * 128 + 40
    st, _ = start(chain, c2)
    xs = i32((t, c2), -(2**27), 2**27)
    _, ys = biquad.df1_clamp_process_q(ba, 29, st, xs, u=u, lo=lo, hi=hi)
    share = pinned(ys, CLAMP)
    if share <= 0:
        raise AssertionError("K19 edge check: the clamp never engaged")
    hold("c2 = 200, t = 7 chunks + 40 rows", name, chain, c2, t,
         lambda s, tl, xs: df1_clamp_hbf_cascade_bank(
             ba, s, tl, xs, 29, u=u, lo=lo, hi=hi, time_chunk=8),
         lambda s, tl, xs: df1_clamp_hbf_cascade_bank_plain(
             ba, s, tl, xs, 29, u=u, lo=lo, hi=hi))
    hold("c2 = 200, t = 936", "df1_hbf1_bank", chain[:1], 200, 936,
         lambda s, tl, xs: (lambda r: (r[0], (r[1],), r[2]))(
             df1_hbf1_bank(ba, s, tl[0], xs, 29, time_chunk=8)),
         lambda s, tl, xs: (lambda r: (r[0], (r[1],), r[2]))(
             df1_hbf1_bank_plain(ba, s, tl[0], xs, 29)))
    hold("c2 = 200, t = 936", "df1_hbf12_bank", chain[:2], 200, 936,
         lambda s, tl, xs: (lambda r: (r[0], r[1:3], r[3]))(
             df1_hbf12_bank(ba, s, *tl, xs, 29, time_chunk=8)),
         lambda s, tl, xs: (lambda r: (r[0], r[1:3], r[3]))(
             df1_hbf12_bank_plain(ba, s, *tl, xs, 29)))
    # K3: the fine length (time_chunk) against the kernel's chunk of 128
    for tc, c2, t, clamp, p in ((32, 200, 960, None, None),
                                (256, 2 * C_MAIN, 1280, None, None),
                                (32, 200, 960, CLAMP, None),
                                (128, 96, 1024, None,
                                 plan(96, fastlo=True, chunk=64, ring=2))):
        nm = ("fastlo_ddc_cascade_bank" if clamp is None
              else "fastlo_ddc_cascade_bank_clamp")
        st, tails = start(chain, c2)
        ps, pt = st, tails
        ph = i32((c2 // 2,))
        steps = i32((c2 // 2,), 1 << 24, 1 << 30)
        pph = ph
        err = 0.0
        for _ in range(2):
            x = i32((t,), -(2**27), 2**27)
            got = fastlo_ddc_cascade_bank(ba, st, tails, ph, steps, x, 29,
                                          clamp=clamp, time_chunk=tc,
                                          _plan=p)
            want = fastlo_ddc_cascade_bank_plain(ba, ps, pt, pph, steps, x,
                                                 29, clamp=clamp,
                                                 time_chunk=tc)
            torch.cuda.synchronize()
            err = max(err, compare(f"{nm} (time_chunk {tc}, c2 = {c2})",
                                   got, want))
            st, tails, ph = got[0], got[1], got[2]
            ps, pt, pph = want[0], want[1], want[2]
        errs[nm] = max(errs.get(nm, 0.0), err)
    log(f"phase 3 K2, K3 (and clamp=), K19-K21 at the ring and tile edges "
        f"== plain over 2 blocks each (t = one chunk, t = 7 chunks + 40, "
        f"c2 = 200 and 50, fine lengths 32 and 256, HBF_TAPS_98 depth 4, "
        f"forced plans; K19's clamp pinned {share:.4%} of the DF1 outputs)")


def check_chain_bank_kernels(dev, i32, i64, errs, plain_s, ba, lp_gains,
                             pll_ba):
    """Phase 3 for K1-K3 at c = C_MAIN and K4-K6 at c = C_BANK (d = DEC,
    time chunk TC), each over HOLD_BLOCKS carried blocks (`hold`) against its
    plain version, tolerance 0, its plain calls timed into plain_s."""
    import torch
    from idsp_tpu_torch.filters import biquad, lowpass, pll
    from idsp_tpu_torch.filters.biquad_cuda import df1_bank_q, df1_bank_q_plain
    from idsp_tpu_torch.filters.ddc_bank_cuda import (
        fastlo_ddc_bank_block_lp, fastlo_ddc_bank_block_lp_plain,
    )
    from idsp_tpu_torch.filters.ddc_cuda import (
        df1_hbf_cascade_bank, df1_hbf_cascade_bank_plain,
        fastlo_ddc_cascade_bank, fastlo_ddc_cascade_bank_plain,
        hbf1_tail_init,
    )
    from idsp_tpu_torch.filters.lowpass_cuda import (
        lowpass_bank, lowpass_bank_plain,
    )
    from idsp_tpu_torch.filters.pll_cuda import pll_bank, pll_bank_plain
    from idsp_tpu_torch.ops.unwrap import ClampWrapState

    c2 = 2 * C_MAIN
    taps_ms = (5, 10, 23)
    errs["df1_bank_q"] = hold(
        "df1_bank_q",
        lambda s, xs: df1_bank_q(ba, s, xs, 29, out_dtype=torch.float32),
        lambda s, xs: df1_bank_q_plain(ba, s, xs, 29,
                                       out_dtype=torch.float32),
        (biquad.Df1State(x=i32((c2, 2)), y=i32((c2, 2))),),
        lambda: i32((T, c2)), plain_s)
    log(f"phase 3 K1 df1_bank_q == plain over {HOLD_BLOCKS} blocks "
        f"(c2={c2}, t={T}): max |d| {errs['df1_bank_q']}")

    errs["df1_hbf_cascade_bank"] = hold(
        "df1_hbf_cascade_bank",
        lambda s, tl, xs: df1_hbf_cascade_bank(ba, s, tl, xs, 29,
                                               time_chunk=TC),
        lambda s, tl, xs: df1_hbf_cascade_bank_plain(ba, s, tl, xs, 29),
        (biquad.df1_init((c2,), device=dev),
         tuple(hbf1_tail_init(c2, m, device=dev) for m in taps_ms)),
        lambda: i32((T, c2), -(2**27), 2**27), plain_s)
    log(f"phase 3 K2 df1_hbf_cascade_bank == plain over {HOLD_BLOCKS} blocks "
        f"(t={T}): max |d| {errs['df1_hbf_cascade_bank']}")

    steps = i32((C_MAIN,), 1 << 24, 1 << 30)
    errs["fastlo_ddc_cascade_bank"] = hold(
        "fastlo_ddc_cascade_bank",
        lambda s, tl, p0, x: fastlo_ddc_cascade_bank(
            ba, s, tl, p0, steps, x, 29, time_chunk=TC),
        lambda s, tl, p0, x: fastlo_ddc_cascade_bank_plain(
            ba, s, tl, p0, steps, x, 29, time_chunk=TC),
        (biquad.df1_init((c2,), device=dev),
         tuple(hbf1_tail_init(c2, m, device=dev) for m in taps_ms),
         i32((C_MAIN,))),
        lambda: i32((T,), -(2**27), 2**27), plain_s)
    log(f"phase 3 K3 fastlo_ddc_cascade_bank == plain over {HOLD_BLOCKS} "
        f"blocks (t={T}): max |d| {errs['fastlo_ddc_cascade_bank']}")

    # K4-K6 at the bank's width: c = 1024 channels, 2048 I|Q lanes
    cb2 = 2 * C_BANK
    errs["lowpass_bank"] = hold(
        "lowpass_bank",
        lambda s, xs: lowpass_bank(lp_gains, s, xs, dec=DEC),
        lambda s, xs: lowpass_bank_plain(lp_gains, s, xs, dec=DEC),
        (lowpass.LowpassState(p=i64((cb2, 2), -(2**50), 2**50)),),
        # full range: the saturating subtraction too
        lambda: i32((T, cb2)), plain_s)
    log(f"phase 3 K4 lowpass_bank == plain over {HOLD_BLOCKS} blocks "
        f"(lanes={cb2}, t={T}, dec={DEC}): max |d| "
        f"{errs['lowpass_bank']}")

    errs["pll_bank"] = hold(
        "pll_bank",
        lambda s, ph: pll_bank(pll_ba, s, ph),
        lambda s, ph: pll_bank_plain(pll_ba, s, ph),
        (pll.PllState(
            clamp=ClampWrapState(
                x0=i32((C_BANK,)),
                clamp=i32((C_BANK,), -1, 2).to(torch.int8)),
            z0=i32((C_BANK,)), y0=i32((C_BANK,)), f0=i64((C_BANK,)),
            f=i64((C_BANK,)), y=i32((C_BANK,))),),
        lambda: i32((T // DEC, C_BANK)), plain_s)
    log(f"phase 3 K5 pll_bank == plain over {HOLD_BLOCKS} blocks "
        f"(c={C_BANK}, rows={T // DEC}): max |d| "
        f"{errs['pll_bank']}")

    steps = i32((C_BANK,), 1 << 24, 1 << 30)
    errs["fastlo_ddc_bank_block_lp"] = hold(
        "fastlo_ddc_bank_block_lp",
        lambda lp, pl, p0, x: fastlo_ddc_bank_block_lp(
            lp_gains, pll_ba, lp, pl, p0, steps, x, d=DEC, time_chunk=TC),
        lambda lp, pl, p0, x: fastlo_ddc_bank_block_lp_plain(
            lp_gains, pll_ba, lp, pl, p0, steps, x, d=DEC, time_chunk=TC),
        (lowpass.init(2, (cb2,), device=dev),
         pll.init((C_BANK,), device=dev), i32((C_BANK,))),
        lambda: i32((T,), -(2**27), 2**27), plain_s)
    log(f"phase 3 K6 fastlo_ddc_bank_block_lp == plain over {HOLD_BLOCKS} "
        f"blocks (c={C_BANK}, t={T}, d={DEC}, "
        f"time_chunk={TC}): max |d| {errs['fastlo_ddc_bank_block_lp']}")


# K14 and K15 at the edges of their depth-0 pipeline (csrc/df1_ring.cuh),
# as tests/test_torch_kernels.py PIPE_EDGES: (c, t, plan keywords)
PIPE_EDGES = {
    "1 producer, 2 slots": (100, 7 * 64 + 40, dict(producers=1, chunk=64,
                                                   ring=2)),
    "most producers": (50, 7 * 64 + 40, dict(producers=11, warps=16,
                                             chunk=64)),
    "most slots": (100, 7 * 64 + 40, dict(chunk=64, ring=14)),
    "chunk 1": (50, 40, dict(chunk=1, ring=2)),
    "t = one chunk": (100, 256, {}),
    "t = 7 chunks + 40": (50, 7 * 256 + 40, {}),
}


def check_pipe_edges(dev, i32, errs, ba):
    """Phase 3 for K14 (int32 and f32 out) and K15 (exact and fast) at
    PIPE_EDGES: forced plans (1 and the most producers, 2 slots and the
    most, 1-row chunks), c = 100 and 50 (not multiples of
    the 32-lane tile; 4-byte stores for K15's 50 channels), t = one chunk
    and 7 chunks + 40 (K15 there also at the other CTAs a tile than its
    angle's default); each over 2 carried blocks against its plain
    version, tolerance 0 (into errs under the kernel's own name)."""
    import torch
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.filters.ddc_cuda import (
        ddc_mix_df1_bank, ddc_mix_df1_bank_plain, mix_plan,
    )
    from idsp_tpu_torch.filters.fm_cuda import (
        DISC_CLUSTER, disc_plan, fm_disc_bank, fm_disc_bank_plain,
    )
    from idsp_tpu_torch.pipelines import fm_disc

    ba_fm = fm_disc.deemphasis_coefficients(0.02)
    for label, (c, t, kw) in PIPE_EDGES.items():
        mplan = mix_plan(2 * c, **kw) if kw else None
        stp = i32((c,))
        for od in (None, torch.float32):
            st = biquad.Df1State(x=i32((2 * c, 2)),
                                 y=i32((2 * c, 2), -(2**28), 2**28))
            errs["ddc_mix_df1_bank"] = max(errs["ddc_mix_df1_bank"], hold(
                f"ddc_mix_df1_bank ({label})",
                lambda s, ph, x, od=od, p=mplan: ddc_mix_df1_bank(
                    ba, s, ph, stp, x, 29, out_dtype=od, _plan=p),
                lambda s, ph, x, od=od: ddc_mix_df1_bank_plain(
                    ba, s, ph, stp, x, 29, out_dtype=od),
                (st, i32((c,))), lambda t=t: i32((t,)), blocks=2))
        for angle in ("exact", "fast"):
            fplan = disc_plan(c, angle, **kw) if kw else None
            st = fm_disc.FmDiscState(
                prev_re=i32((c,)), prev_im=i32((c,)),
                prev_valid=torch.arange(c, device=dev) % 3 == 0,
                deemph=biquad.Df1State(x=i32((c, 2)),
                                       y=i32((c, 2), -(2**28), 2**28)))
            errs["fm_disc_bank"] = max(errs["fm_disc_bank"], hold(
                f"fm_disc_bank ({label})",
                lambda s, iq, a=angle, p=fplan: fm_disc_bank(
                    ba_fm, s, *iq, FM_CARRIER, angle=a, _plan=p),
                lambda s, iq, a=angle: fm_disc_bank_plain(
                    ba_fm, s, *iq, FM_CARRIER, angle=a),
                (st,), lambda t=t, c=c: (i32((t, c)), i32((t, c))),
                blocks=2))
        if label.startswith("t = 7"):  # K15 at the other CTAs a tile
            for angle in ("exact", "fast"):
                st = fm_disc.init_state((c,), device=dev)
                other = disc_plan(c, angle,
                                  cluster=3 - DISC_CLUSTER[angle])
                errs["fm_disc_bank"] = max(errs["fm_disc_bank"], hold(
                    f"fm_disc_bank ({label}, cluster {other.cluster})",
                    lambda s, iq, a=angle, p=other: fm_disc_bank(
                        ba_fm, s, *iq, FM_CARRIER, angle=a, _plan=p),
                    lambda s, iq, a=angle: fm_disc_bank_plain(
                        ba_fm, s, *iq, FM_CARRIER, angle=a),
                    (st,), lambda t=t, c=c: (i32((t, c)), i32((t, c))),
                    blocks=2))
    log(f"phase 3 K14 (int32 and f32 out) and K15 (exact and fast; its "
        f"exact angle a cluster of 2 CTAs a tile, and each angle once at "
        f"the other) at the depth-0 pipeline's edges == plain over 2 "
        f"blocks each ({', '.join(PIPE_EDGES)}; c = 100 and 50)")


def most_slots(plan, c, chunk):
    """The most slots of ``chunk`` rows that a depth-0 plan function
    (`q64_plan`, `rpll_plan`) fits in a block's shared memory."""
    ring = 2
    while True:
        try:
            plan(c, chunk=chunk, ring=ring + 1)
        except ValueError:
            return ring
        ring += 1


def check_serial_pipe_edges(dev, i32, errs):
    """Phase 3 for K29 and K37 at the edges of the depth-0 pipeline, as
    PIPE_EDGES at their own chunk (128 rows by default): forced plans (1
    and the most producers, 2 slots and the most that fit, 1-row chunks),
    c = 100 and 50 (not
    multiples of the 32-lane tile; K37's 50 lanes and K29's 51 in the
    1-row case take the stores of a lane each, the rest 16 bytes a
    thread), t = one chunk and 7 chunks + 40; each over 2 carried blocks
    against its plain version, tolerance 0 (into errs under the kernel's
    own name).  K29 with the suite's Q64<61> lowpass, x and
    state in +-2^55, and at "t = 7 chunks + 40" also with full-range
    coefficients, x and state at f = 47 and int64's edge values at f = 33
    (the 128-bit sum wraps); K37 on the suite's row (sf 12) with 1 in 4
    rows valid and a stretch of 1.5 chunks with no valid row, and at "t = 7
    chunks + 40" also at sf 32 and 40 (the other two shift instances)."""
    import torch
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad, rpll
    from idsp_tpu_torch.filters.biquad_cuda import (
        df1_bank_q64, df1_bank_q64_plain, q64_plan,
    )
    from idsp_tpu_torch.filters.rpll_cuda import (
        rpll_bank, rpll_bank_plain, rpll_plan,
    )

    rng = np.random.default_rng(18)
    edges64 = np.array([-(2**63), -(2**63) + 1, -(2**62), -1, 0, 1, 2**62,
                        2**63 - 1], np.int64)

    def words(shape, kind):
        if kind == "edges":
            return rng.choice(edges64, shape)
        lim = 2**63 if kind == "full" else 2**55
        return rng.integers(-lim, lim, shape, dtype=np.int64)

    def i64(shape, kind):
        return torch.from_numpy(words(shape, kind)).to(dev)

    lp = biquad.quantize_ba(biquad.from_cookbook(
        Filter().critical_frequency(0.1).lowpass()), 61, dtype=np.int64)
    labels = []
    for name, plan_of, chunk in (("df1_bank_q64", q64_plan, 128),
                                 ("rpll_bank", rpll_plan, 128)):
        most = most_slots(plan_of, 100, 64)
        k37 = name == "rpll_bank"
        edges = {
            "1 producer, 2 slots": (100, 7 * 64 + 40,
                                    dict(producers=1, chunk=64, ring=2)),
            "most producers": (50, 7 * 64 + 40, dict(producers=11,
                                                     warps=16, chunk=64)),
            f"most slots ({most})": (100, 7 * 64 + 40,
                                     dict(chunk=64, ring=most)),
            "chunk 1": (50 if k37 else 51, 40, dict(chunk=1, ring=2)),
            "t = one chunk": (100, chunk, {}),
            "t = 7 chunks + 40": (50, 7 * chunk + 40, {}),
        }
        for label, (c, t, kw) in edges.items():
            plan = plan_of(c, **kw) if kw else None
            if k37:
                for sf in ((12, 32, 40) if label.startswith("t = 7")
                           else (12,)):
                    cfg = rpll.RpllConfig(RPLL_ROW[0], sf, RPLL_ROW[2])

                    def make(t=t, c=c):
                        v = rng.integers(0, 4, size=(t, c)) == 0
                        v[t // 3: t // 3 + 3 * chunk // 2] = False
                        return (i32((t, c)), torch.from_numpy(v).to(dev))

                    st = rpll.RpllState(*(i32((c,)) for _ in range(4)))
                    errs[name] = max(errs[name], hold(
                        f"{name} ({label}, sf {sf})",
                        lambda s, xv, cfg=cfg, p=plan: rpll_bank(
                            cfg, s, *xv, _plan=p),
                        lambda s, xv, cfg=cfg: rpll_bank_plain(cfg, s, *xv),
                        (st,), make, blocks=2))
            else:
                for kind, f in ((("lowpass", 61), ("full", 47),
                                 ("edges", 33)) if label.startswith("t = 7")
                                else (("lowpass", 61),)):
                    ba = lp if kind == "lowpass" else words((5,), kind)
                    st = biquad.Df1State(x=i64((c, 2), kind),
                                         y=i64((c, 2), kind))
                    errs[name] = max(errs[name], hold(
                        f"{name} ({label}, {kind}, f {f})",
                        lambda s, x, ba=ba, f=f, p=plan: df1_bank_q64(
                            ba, s, x, f, _plan=p),
                        lambda s, x, ba=ba, f=f: df1_bank_q64_plain(
                            ba, s, x, f),
                        (st,), lambda t=t, c=c, kind=kind: i64((t, c), kind),
                        blocks=2))
        labels.append(f"{name}: {', '.join(edges)}")
    log("phase 3 K29 (the Q64<61> lowpass; full range at f 47 and int64's "
        "edges at f 33 on the 7-chunk row) and K37 (sf 12, 1 in 4 rows "
        "valid, 1.5 chunks without one; sf 32 and 40 on the 7-chunk row) at "
        "the depth-0 pipeline's edges == plain over 2 blocks each ("
        + "; ".join(labels) + "; c = 100 and 50): max |d| "
        f"{errs['df1_bank_q64']}, {errs['rpll_bank']}")


def check_depth0_edges(dev, i32, errs):
    """Phase 3 for K28, K30, K31, K33, K34, K35 and K36 at the edges of the
    depth-0 pipeline, each against its plain version over 2 carried blocks,
    tolerance 0 (into errs under the kernel's own name): t = 1 (c = 200),
    t under a chunk (c = 50), t = 3 chunks + 17 (c = 1: one live lane of a
    tile), and a forced plan of 16-row chunks, 3 slots and 2 producers (c =
    200: a tile's tail lanes).  K31 unclamped and clamped with CLAMP at f =
    29, at f = 1 and at f = 32 (coefficients in +-2^(f + 1), full-range x
    and state), K33 with per-lane and with shared planes at f = 29 (and
    CLAMP); then K31 at f = 1 and 32, clamped and not, on a block whose
    rows' five products and e pass 2^63 (coefficients, state and the first
    row at -2^31, e at 2^32 - 1; the rest at int32's edges: the sum
    wraps); K34 with each of its four outputs from a random state; K35 at f
    = 29, 1, 32, 33 and 63 with full-range coefficients (p_im never
    INT32_MIN), x and state, whose five-term sums wrap mod 2^64; K36 on x ~
    N(0, 1) from a random state, the structure row's float lowpass; K28 with
    the ladder's Q16<13> lowpass on x and state in +-2^14, and at f = 1 and
    31 with full-range int16 coefficients, x and state, whose int32 sums
    wrap (c = 200: 16-byte stores of 8 lanes' low halves; c = 50 and 1: a
    2-byte store a lane); K30 on x ~ N(0, 1) from a random state, the
    ladder's f32 lowpass."""
    import torch
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad, normal, svf
    from idsp_tpu_torch.filters.biquad_cuda import (
        df1_bank_f32, df1_bank_f32_plain, df1_bank_q16, df1_bank_q16_plain,
        df1_dither_bank, df1_dither_bank_coef, df1_dither_bank_coef_plain,
        df1_dither_bank_plain, dither_plan, f32_plan, q16_plan,
    )
    from idsp_tpu_torch.filters.normal_cuda import (
        normal_bank_f32, normal_bank_f32_plain, normal_bank_q,
        normal_bank_q_plain, normal_plan,
    )
    from idsp_tpu_torch.filters.svf_cuda import (
        OUTPUTS, svf_bank, svf_bank_plain, svf_plan,
    )

    rng = np.random.default_rng(19)

    def dither_state(c):
        return biquad.Df1DitherState(
            xy=biquad.Df1State(x=i32((c, 2)), y=i32((c, 2))),
            e=torch.from_numpy(rng.integers(0, 2**32, c)).to(dev))

    def chunk_of(plan_of):
        return plan_of(1).chunk

    edges = {
        "t = 1": (200, 1, {}),
        "t under a chunk": (50, 100, {}),
        "t = 3 chunks + 17": (1, None, {}),
        "16-row chunks": (200, 5 * 16 + 3, dict(chunk=16, ring=3,
                                                producers=2)),
    }
    b_f, p_f = normal.from_cookbook(
        Filter().critical_frequency(NORMAL_FC).lowpass())
    lp = biquad.from_cookbook(Filter().critical_frequency(0.1).lowpass())
    b16 = biquad.quantize_ba(lp, 13, dtype=np.int16)

    def i16(shape, lim):
        return torch.from_numpy(rng.integers(-lim, lim, size=shape).astype(
            np.int16)).to(dev)

    def f32(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev)

    for label, (c, t, kw) in edges.items():
        for name, plan_of in (("dither", dither_plan), ("svf", svf_plan),
                              ("normal_q", normal_plan),
                              ("normal_f32", lambda c, **kw: normal_plan(
                                  c, f32=True, **kw)),
                              ("q16", q16_plan), ("f32", f32_plan)):
            rows = 3 * chunk_of(plan_of) + 17 if t is None else t
            plan = plan_of(c, **kw) if kw else None
            if name == "q16":
                for f, lim in ((13, 2**14), (1, 2**15), (31, 2**15)):
                    ba = (b16 if f == 13 else rng.integers(
                        -(2**15), 2**15, 5).astype(np.int16))
                    errs["df1_bank_q16"] = max(errs["df1_bank_q16"], hold(
                        f"df1_bank_q16 ({label}, f {f})",
                        lambda s, x, ba=ba, f=f, pl=plan: df1_bank_q16(
                            ba, s, x, f, _plan=pl),
                        lambda s, x, ba=ba, f=f: df1_bank_q16_plain(
                            ba, s, x, f),
                        (biquad.Df1State(x=i16((c, 2), lim),
                                         y=i16((c, 2), lim)),),
                        lambda rows=rows, c=c, lim=lim: i16((rows, c), lim),
                        blocks=2))
                continue
            if name == "f32":
                errs["df1_bank_f32"] = max(errs["df1_bank_f32"], hold(
                    f"df1_bank_f32 ({label})",
                    lambda s, x, pl=plan: df1_bank_f32(lp, s, x, _plan=pl),
                    lambda s, x: df1_bank_f32_plain(lp, s, x),
                    (biquad.Df1State(x=f32((c, 2)), y=f32((c, 2))),),
                    lambda rows=rows, c=c: f32((rows, c)), blocks=2))
                continue
            if name == "normal_q":
                for f in (29, 1, 32, 33, 63):
                    bq = rng.integers(-(2**31) + 1, 2**31, 3).astype(np.int32)
                    pq = rng.integers(-(2**31) + 1, 2**31, 2).astype(np.int32)
                    errs["normal_bank_q"] = max(errs["normal_bank_q"], hold(
                        f"normal_bank_q ({label}, f {f})",
                        lambda s, x, b=bq, p=pq, f=f, pl=plan: normal_bank_q(
                            b, p, s, x, f, _plan=pl),
                        lambda s, x, b=bq, p=pq, f=f: normal_bank_q_plain(
                            b, p, s, x, f),
                        (biquad.Df1State(x=i32((c, 2)), y=i32((c, 2))),),
                        lambda rows=rows, c=c: i32((rows, c)), blocks=2))
                continue
            if name == "normal_f32":
                st = biquad.Df1State(*(torch.from_numpy(rng.normal(
                    size=(c, 2)).astype(np.float32)).to(dev)
                    for _ in range(2)))
                errs["normal_bank_f32"] = max(errs["normal_bank_f32"], hold(
                    f"normal_bank_f32 ({label})",
                    lambda s, x, pl=plan: normal_bank_f32(b_f, p_f, s, x,
                                                          _plan=pl),
                    lambda s, x: normal_bank_f32_plain(b_f, p_f, s, x), (st,),
                    lambda rows=rows, c=c: torch.from_numpy(rng.normal(
                        size=(rows, c)).astype(np.float32)).to(dev),
                    blocks=2))
                continue
            if name == "svf":
                f, qi = svf.coefficients(*SVF_ROW)
                for out in OUTPUTS:
                    st = svf.SvfState(*(torch.from_numpy(rng.normal(
                        size=c).astype(np.float32)).to(dev)
                        for _ in range(3)))
                    errs["svf_bank"] = max(errs["svf_bank"], hold(
                        f"svf_bank ({label}, {out})",
                        lambda s, x, o=out, p=plan: svf_bank(
                            f, qi, s, x, output=o, _plan=p),
                        lambda s, x, o=out: svf_bank_plain(
                            f, qi, s, x, output=o),
                        (st,), lambda rows=rows, c=c: torch.from_numpy(
                            rng.normal(size=(rows, c)).astype(np.float32))
                        .to(dev), blocks=2))
                continue
            for f, clamp in ((29, None), (29, CLAMP), (1, None), (32, None),
                             (32, CLAMP)):
                top = min(2**31 - 1, 2 << f)
                ba = rng.integers(-top, top + 1, size=5).astype(np.int32)
                errs["df1_dither_bank"] = max(errs["df1_dither_bank"], hold(
                    f"df1_dither_bank ({label}, f {f}, clamp {clamp})",
                    lambda s, x, ba=ba, f=f, cl=clamp, p=plan:
                    df1_dither_bank(ba, s, x, f, clamp=cl, _plan=p),
                    lambda s, x, ba=ba, f=f, cl=clamp: df1_dither_bank_plain(
                        ba, s, x, f, clamp=cl),
                    (dither_state(c),), lambda rows=rows, c=c: i32((rows, c)),
                    blocks=2))
            for shared, clamp in ((False, None), (True, None), (False, CLAMP)):
                planes = torch.from_numpy(rng.integers(
                    -(2**30), 2**30, size=(5,) if shared else (5, c)).astype(
                    np.int32)).to(dev)
                errs["df1_dither_bank_coef"] = max(
                    errs["df1_dither_bank_coef"], hold(
                        f"df1_dither_bank_coef ({label}, "
                        f"{'shared' if shared else 'per-lane'}, "
                        f"clamp {clamp})",
                        lambda s, x, pl=planes, cl=clamp, p=plan:
                        df1_dither_bank_coef(pl, s, x, 29, clamp=cl,
                                             _plan=p),
                        lambda s, x, pl=planes, cl=clamp:
                        df1_dither_bank_coef_plain(pl, s, x, 29, clamp=cl),
                        (dither_state(c),),
                        lambda rows=rows, c=c: i32((rows, c)), blocks=2))
    c, t = 50, 300
    edge = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 1], np.int32)
    xs = rng.choice(edge, (t, c))
    xs[0] = -(2**31)
    low = torch.full((c, 2), -(2**31), dtype=torch.int32, device=dev)
    st = biquad.Df1DitherState(
        xy=biquad.Df1State(x=low, y=low.clone()),
        e=torch.full((c,), 2**32 - 1, dtype=torch.int64, device=dev))
    ba = np.full(5, -(2**31), np.int32)
    for f in (1, 32):
        for clamp in (None, (2**31 - 9, -(2**31), 2**31 - 1)):
            errs["df1_dither_bank"] = max(errs["df1_dither_bank"], hold(
                f"df1_dither_bank (the sum wraps, f {f}, clamp {clamp})",
                lambda s, x, f=f, cl=clamp: df1_dither_bank(
                    ba, s, x, f, clamp=cl),
                lambda s, x, f=f, cl=clamp: df1_dither_bank_plain(
                    ba, s, x, f, clamp=cl),
                (st,), lambda: torch.from_numpy(xs).to(dev), blocks=1))
    log(f"phase 3 K31 (f 29 unclamped and clamped {CLAMP}, f 1, f 32 "
        f"unclamped and clamped), K33 (per-lane and shared planes, clamped "
        f"per-lane), K34 (lp, hp, bp, br), K35 (f 29, 1, 32, 33, 63, "
        f"full-range coefficients, x and state: the sums wrap), K36, K28 "
        f"(the Q16<13> lowpass; f 1 and 31 at full range: the int32 sums "
        f"wrap) and K30 at the depth-0 pipeline's edges == plain over 2 "
        f"blocks each ({', '.join(edges)}: c = 200, 50, 1 and 200); K31 at "
        f"f 1 and 32 where the 64-bit sum wraps, clamped and not: max |d| "
        f"{errs['df1_dither_bank']}, {errs['df1_dither_bank_coef']}, "
        f"{errs['svf_bank']}, {errs['normal_bank_q']}, "
        f"{errs['normal_bank_f32']}, {errs['df1_bank_q16']}, "
        f"{errs['df1_bank_f32']}")


def check_df1_pipe_edges(dev, i32, errs):
    """Phase 3 for K1, K11, K18, K26 and K27 at the edges of the depth-0
    pipeline (`df1_plan`), each against its plain version over 2 carried
    blocks, tolerance 0 (into errs under the kernel's own name): t = 1 (c
    = 200), t under a chunk (c = 50), t = 3 chunks + 17 (c = 1: one live
    lane of a tile) and a forced plan of 16-row chunks, 3 slots and 2
    producers (c = 200: a tile's tail lanes; t not a multiple of the
    chunk).  Full-range x and state, coefficients in +-2^(f + 1): K1 int32
    at f 29, 33 and 63 (the funnel shift and the high word's) and f32 at f
    33; K11 at d 3 (4 under a chunk; 1 at t = 1; kept rows across chunk
    edges where the chunk is not a multiple of d) at f 29 and 63; K18
    with CLAMP at f 29 and 33; K26 per-lane and shared at f 63, K27
    per-lane with CLAMP at f 33.  Then K1, K18 at f 32 and 63 and K27 at
    f 63 on a block whose five products pass 2^63 (coefficients, state
    and the first row at -2^31, the rest at int32's edges: the sum
    wraps)."""
    import torch
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.filters.biquad_cuda import (
        df1_bank_q, df1_bank_q_coef, df1_bank_q_coef_plain, df1_bank_q_dec,
        df1_bank_q_dec_plain, df1_bank_q_plain, df1_clamp_bank_q,
        df1_clamp_bank_q_coef, df1_clamp_bank_q_coef_plain,
        df1_clamp_bank_q_plain, df1_plan,
    )

    rng = np.random.default_rng(21)
    u, lo, hi = CLAMP

    def coefs(f, shape=(5,)):
        top = min(2**31 - 1, 2 << f)
        return torch.from_numpy(rng.integers(-top, top + 1, size=shape)
                                .astype(np.int32)).to(dev)

    def state(c):
        return (biquad.Df1State(x=i32((c, 2)), y=i32((c, 2))),)

    def run(name, label, kern, plain, c, t):
        errs[name] = max(errs.get(name, 0.0), hold(
            f"{name} ({label})", kern, plain, state(c),
            lambda: i32((t, c)), blocks=2))

    chunk = df1_plan(1).chunk
    edges = {
        "t = 1": (200, 1, {}, 1),
        "t under a chunk": (50, 100, {}, 4),
        "t = 3 chunks + 17": (1, 3 * chunk + 17, {}, 3),
        "16-row chunks": (200, 5 * 16 + 3, dict(chunk=16, ring=3,
                                                producers=2), 3),
    }
    for label, (c, t, kw, d) in edges.items():
        p = df1_plan(c, **kw) if kw else None
        for f, f32 in ((29, False), (33, False), (63, False), (33, True)):
            ba = coefs(f)
            dt = torch.float32 if f32 else None
            run("df1_bank_q", f"{label}, f {f}, {'f32' if f32 else 'i32'}",
                lambda s, x, ba=ba, f=f, dt=dt, p=p: df1_bank_q(
                    ba, s, x, f, out_dtype=dt, _plan=p),
                lambda s, x, ba=ba, f=f, dt=dt: df1_bank_q_plain(
                    ba, s, x, f, out_dtype=dt), c, t)
        td = -(-t // d) * d  # K11's rows: a multiple of d
        for f in (29, 63):
            ba = coefs(f)
            run("df1_bank_q_dec", f"{label}, d {d}, f {f}",
                lambda s, x, ba=ba, f=f, d=d, p=p: df1_bank_q_dec(
                    ba, s, x, f, d=d, _plan=p),
                lambda s, x, ba=ba, f=f, d=d: df1_bank_q_dec_plain(
                    ba, s, x, f, d=d), c, td)
        for f in (29, 33):
            ba = coefs(f)
            run("df1_clamp_bank_q", f"{label}, f {f}, clamp {CLAMP}",
                lambda s, x, ba=ba, f=f, p=p: df1_clamp_bank_q(
                    ba, s, x, f, u=u, lo=lo, hi=hi, _plan=p),
                lambda s, x, ba=ba, f=f: df1_clamp_bank_q_plain(
                    ba, s, x, f, u=u, lo=lo, hi=hi), c, t)
        for shape in ((5, c), (5,)):
            pl = coefs(63, shape)
            run("df1_bank_q_coef", f"{label}, f 63, planes {shape}",
                lambda s, x, pl=pl, p=p: df1_bank_q_coef(pl, s, x, 63,
                                                         _plan=p),
                lambda s, x, pl=pl: df1_bank_q_coef_plain(pl, s, x, 63),
                c, t)
        pl = coefs(33, (5, c))
        run("df1_clamp_bank_q_coef", f"{label}, f 33, clamp {CLAMP}",
            lambda s, x, pl=pl, p=p: df1_clamp_bank_q_coef(
                pl, s, x, 33, u=u, lo=lo, hi=hi, _plan=p),
            lambda s, x, pl=pl: df1_clamp_bank_q_coef_plain(
                pl, s, x, 33, u=u, lo=lo, hi=hi), c, t)
    c, t = 50, 300
    edge = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 1], np.int32)
    xs = rng.choice(edge, (t, c))
    xs[0] = -(2**31)
    low = torch.full((c, 2), -(2**31), dtype=torch.int32, device=dev)
    st = (biquad.Df1State(x=low, y=low.clone()),)
    ba = torch.full((5,), -(2**31), dtype=torch.int32, device=dev)
    pl = ba[:, None].expand(5, c).contiguous()
    wide = (2**31 - 9, -(2**31), 2**31 - 1)
    cases = [("df1_bank_q", f, lambda s, x, f=f: df1_bank_q(ba, s, x, f),
              lambda s, x, f=f: df1_bank_q_plain(ba, s, x, f))
             for f in (32, 63)]
    cases += [("df1_clamp_bank_q", f,
               lambda s, x, f=f: df1_clamp_bank_q(ba, s, x, f, u=wide[0],
                                                  lo=wide[1], hi=wide[2]),
               lambda s, x, f=f: df1_clamp_bank_q_plain(
                   ba, s, x, f, u=wide[0], lo=wide[1], hi=wide[2]))
              for f in (32, 63)]
    cases.append(("df1_clamp_bank_q_coef", 63,
                  lambda s, x: df1_clamp_bank_q_coef(
                      pl, s, x, 63, u=wide[0], lo=wide[1], hi=wide[2]),
                  lambda s, x: df1_clamp_bank_q_coef_plain(
                      pl, s, x, 63, u=wide[0], lo=wide[1], hi=wide[2])))
    for name, f, kern, plain in cases:
        errs[name] = max(errs.get(name, 0.0), hold(
            f"{name} (the sum wraps, f {f})", kern, plain, st,
            lambda: torch.from_numpy(xs).to(dev), blocks=1))
    log(f"phase 3 K1 (i32 at f 29, 33, 63; f32 at f 33), K11 (d 3, 4, 1; f "
        f"29 and 63), K18 (f 29, 33, clamp {CLAMP}), K26 (f 63, per-lane and "
        f"shared planes) and K27 (f 33, per-lane, clamped) at the depth-0 "
        f"pipeline's edges == plain over 2 blocks each ({', '.join(edges)}: "
        f"c = 200, 50, 1 and 200); K1, K18 at f 32 and 63 and K27 at f 63 "
        f"where the 64-bit sum wraps: max |d| "
        + ", ".join(str(errs[k]) for k in (
            "df1_bank_q", "df1_bank_q_dec", "df1_clamp_bank_q",
            "df1_bank_q_coef", "df1_clamp_bank_q_coef")))


# K24's plan edges: (c, t) pairs (t not a multiple of the 128-row chunk,
# under a chunk, one row), stage counts, and each count's stages a CTA
SOS_EDGE_SHAPES = ((1, 3 * 128 + 17), (50, 100), (200, 2 * 128 + 5))
SOS_EDGE_STAGES = {1: (1,), 3: (1, 2, 3), 8: (1, 2, 8)}
SOS_EDGE_F = (1, 32, 33)


def check_chain_edges(dev, i32, i64, errs):
    """Phase 3 for K24 on its cluster chain (`pipe_plan.sos_plan`) and K25
    / K32 on the depth-0 pipeline (`biquad_cuda.wide_plan`), each against
    its plain version over 2 carried blocks, tolerance 0 (into errs under
    the kernel's own name).  K24 at SOS_EDGE_SHAPES (c = 1, 50 and 200
    lanes; t = 3 chunks + 17, under a chunk, 2 chunks + 5) with N = 1, 3
    and 8 stages at g = 1, 2 and N stages a CTA (SOS_EDGE_STAGES:
    clusters of 1-8 CTAs), f cycling through 1, 32 and 33; N = 3 at t = 1
    (g 1 and 3); N = 8 in one CTA over 4-row chunks in 3 slots and 1-row
    chunks in 8; two one-stage ranks a CTA at SOS_EDGE_SHAPES for N = 2, 3
    (a CTA's second rank unused) and 8; then N = 3, g = 1 at f 1, 32, 33
    and 63 on a block whose
    products pass 2^63 (coefficients, state and the first row at -2^31:
    the sums wrap).  Coefficients in +-2^(f + 1), full-range x and state.
    K25 and K32 (per-lane and shared planes) at t = 1 (c = 200), t under a
    chunk (c = 50), t = 3 chunks + 17 (c = 1) and a forced plan of 16-row
    chunks, 3 slots and 2 producers (c = 200): K25 at f 1 and 32, clamped
    with CLAMP and not, and at f 29 with a clamp whose lo > hi (its hi);
    K32 per-lane at f 29 with CLAMP, shared at f 16; full-range int64 y
    state; then K25 at f 1 and 32 and K32 at f 32 where the sum wraps (y
    words at int64's edges, coefficients and x at -2^31).  Returns the
    plans' g and clusters it ran."""
    import torch
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.filters.biquad_cuda import (
        df1_wide_bank, df1_wide_bank_coef, df1_wide_bank_coef_plain,
        df1_wide_bank_plain, sos_bank_q, sos_bank_q_plain, wide_plan,
    )
    from idsp_tpu_torch.filters.pipe_plan import sos_plan

    rng = np.random.default_rng(22)

    def coefs(f, shape=(5,)):
        top = min(2**31 - 1, 2 << f)
        return rng.integers(-top, top + 1, size=shape).astype(np.int32)

    def run(name, label, kern, plain, carry, c, t):
        errs[name] = max(errs.get(name, 0.0), hold(
            f"{name} ({label})", kern, plain, carry, lambda: i32((t, c)),
            blocks=2))

    def stages(c, n):
        return [biquad.Df1State(x=i32((c, 2)), y=i32((c, 2)))
                for _ in range(n)]

    ran, i = set(), 0
    cases = [(c, t, n, g, {}) for c, t in SOS_EDGE_SHAPES
             for n, gs in SOS_EDGE_STAGES.items() for g in gs]
    cases += [(200, 1, 3, 1, {}), (200, 1, 3, 3, {}),
              (50, 45, 8, 8, dict(chunk=4, ring=3)),
              (33, 23, 8, 8, dict(chunk=1, ring=8))]
    cases += [(c, t, n, 1, dict(halves=2)) for c, t in SOS_EDGE_SHAPES
              for n in (2, 3, 8)]
    for c, t, n, g, kw in cases:
        f = SOS_EDGE_F[i % len(SOS_EDGE_F)]
        i += 1
        ba = coefs(f, (n, 5))
        plan = sos_plan(c, n, group=g, **kw)
        ran.add((n, g, plan.halves, plan.cluster))
        run("sos_bank_q", f"c {c}, t {t}, {n} stages, g {g}, {kw}, f {f}",
            lambda s, x, ba=ba, f=f, p=plan: sos_bank_q(ba, s, x, f,
                                                        _plan=p),
            lambda s, x, ba=ba, f=f: sos_bank_q_plain(ba, s, x, f),
            (stages(c, n),), c, t)
    c, t = 50, 300
    edge = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 1], np.int32)
    xs = rng.choice(edge, (t, c))
    xs[0] = -(2**31)
    ba = np.full((3, 5), -(2**31), np.int32)
    low = torch.full((c, 2), -(2**31), dtype=torch.int32, device=dev)
    st = [biquad.Df1State(x=low, y=low.clone()) for _ in range(3)]
    for f in (1, 32, 33, 63):
        errs["sos_bank_q"] = max(errs["sos_bank_q"], hold(
            f"sos_bank_q (the sum wraps, f {f})",
            lambda s, x, f=f: sos_bank_q(ba, s, x, f,
                                         _plan=sos_plan(c, 3, group=1)),
            lambda s, x, f=f: sos_bank_q_plain(ba, s, x, f), (st,),
            lambda: torch.from_numpy(xs).to(dev), blocks=1))

    def wide_state(c):
        return (biquad.Df1WideState(x=i32((c, 2)), y=i64((c, 2), -(2**63),
                                                         2**63 - 1)),)

    chunk = wide_plan(1).chunk
    edges = {
        "t = 1": (200, 1, {}),
        "t under a chunk": (50, 100, {}),
        "t = 3 chunks + 17": (1, 3 * chunk + 17, {}),
        "16-row chunks": (200, 5 * 16 + 3, dict(chunk=16, ring=3,
                                                producers=2)),
    }
    u, lo, hi = CLAMP
    for label, (c, t, kw) in edges.items():
        p = wide_plan(c, **kw) if kw else None
        for f, clamp in ((1, None), (1, CLAMP), (32, None), (32, CLAMP),
                         (29, (5, 2**20, -(2**20)))):
            ba = coefs(f)
            run("df1_wide_bank", f"{label}, f {f}, clamp {clamp}",
                lambda s, x, ba=ba, f=f, cl=clamp, p=p: df1_wide_bank(
                    ba, s, x, f, clamp=cl, _plan=p),
                lambda s, x, ba=ba, f=f, cl=clamp: df1_wide_bank_plain(
                    ba, s, x, f, clamp=cl), wide_state(c), c, t)
        for shape, f, clamp in (((5, c), 29, CLAMP), ((5,), 16, None)):
            pl = torch.from_numpy(coefs(f, shape)).to(dev)
            run("df1_wide_bank_coef", f"{label}, f {f}, planes {shape}, "
                f"clamp {clamp}",
                lambda s, x, pl=pl, f=f, cl=clamp, p=p: df1_wide_bank_coef(
                    pl, s, x, f, clamp=cl, _plan=p),
                lambda s, x, pl=pl, f=f, cl=clamp: df1_wide_bank_coef_plain(
                    pl, s, x, f, clamp=cl), wide_state(c), c, t)
    c, t = 50, 300
    ends = np.array([-(2**63), -(2**63) + 1, -1, 0, 2**63 - 1], np.int64)
    yw = torch.from_numpy(rng.choice(ends, (c, 2))).to(dev)
    wst = (biquad.Df1WideState(x=low, y=yw),)
    ba = np.full((5,), -(2**31), np.int32)
    pl = torch.full((5, c), -(2**31), dtype=torch.int32, device=dev)
    wraps = [("df1_wide_bank", f, lambda s, x, f=f: df1_wide_bank(ba, s, x, f),
              lambda s, x, f=f: df1_wide_bank_plain(ba, s, x, f))
             for f in (1, 32)]
    wraps.append(("df1_wide_bank_coef", 32,
                  lambda s, x: df1_wide_bank_coef(pl, s, x, 32, clamp=CLAMP),
                  lambda s, x: df1_wide_bank_coef_plain(pl, s, x, 32,
                                                        clamp=CLAMP)))
    for name, f, kern, plain in wraps:
        errs[name] = max(errs[name], hold(
            f"{name} (the sum wraps, f {f})", kern, plain, wst,
            lambda: torch.from_numpy(xs).to(dev), blocks=1))
    log(f"phase 3 K24 on its cluster chain at c, t = {SOS_EDGE_SHAPES} and "
        f"(200, 1), (stages, g, ranks a CTA, CTAs a tile) {sorted(ran)}, 8 "
        f"stages over "
        f"4- and 1-row chunks, f 1, 32, 33; f "
        f"1, 32, 33, 63 where the sum wraps; K25 (f 1, 32 with and without "
        f"clamp {CLAMP}, f 29 with lo > hi) and K32 (per-lane f 29 clamped, "
        f"shared f 16) at the depth-0 pipeline's edges ({', '.join(edges)}: "
        f"c = 200, 50, 1 and 200), full-range int64 y; K25 f 1, 32 and K32 "
        f"f 32 where the sum wraps: == plain over 2 blocks each, max |d| "
        + ", ".join(str(errs[k]) for k in (
            "sos_bank_q", "df1_wide_bank", "df1_wide_bank_coef")))
    return sorted(ran)


def log_sos_plans(dev):
    """Logs the K24 clusters of 1-8 CTAs of one rank and of 1-4 CTAs of two
    one-stage ranks the card holds at once (cudaOccupancyMaxActiveClusters
    of the kernel at its plan's shape) and
    the plans `sos_launch_plan` picks at C_CTL and 2 C_CTL lanes for
    SOS_STAGES and 8 stages; returns the plan at C_CTL lanes and
    SOS_STAGES stages as the kernels line names it."""
    from idsp_tpu_torch.filters.biquad_cuda import (
        _max_clusters, sos_launch_plan,
    )
    from idsp_tpu_torch.filters.pipe_plan import sos_plan

    fit = {}
    for h in (1, 2):
        for cl in range(1, 8 // h + 1):  # cl CTAs of h one-stage ranks
            p = sos_plan(C_CTL, cl * h, group=1, halves=h)
            fit[h, cl] = _max_clusters(dev, cl, h, p.warps, p.smem)
    plans = {(c, n): sos_launch_plan(c, n, dev)
             for c in (C_CTL, 2 * C_CTL) for n in (SOS_STAGES, 8)}
    log(f"phase 3 K24 co-resident clusters of 1-8 CTAs (one CTA an SM) of "
        f"one rank: {[fit[1, cl] for cl in range(1, 9)]}, of 1-4 CTAs of two "
        f"one-stage ranks: {[fit[2, cl] for cl in range(1, 5)]}; plans "
        f"(lanes, stages) "
        f"-> (g, ranks a CTA, CTAs a tile, CTAs): " + ", ".join(
            f"{k}: ({p.group}, {p.halves}, {p.cluster}, "
            f"{p.tiles * p.cluster})" for k, p in plans.items()))
    p = plans[(C_CTL, SOS_STAGES)]
    return {"stages": p.stages, "group": p.group, "halves": p.halves,
            "cluster": p.cluster, "chunk": p.chunk, "ring": p.ring,
            "co_resident_clusters": fit[p.halves, p.cluster]}


def check_bank_lockin_edges(dev, i32, errs):
    """Phase 3 for K12 (and its ``clamp=``), K13 and K16 at the edges of
    the depth-0 pipeline, at small t and c, each over 2 carried blocks
    against its plain version, tolerance 0 (into errs under the kernel's
    own name).  K12/K13 (x in +-2^27, full-range phases and steps, the
    chain's Q29 lowpass, CLAMP): chunks other than the time chunk and not
    multiples of d, chunks under d, t not a multiple of the chunk, c not a
    multiple of the 16-channel tile, d = 1, one channel, 5 and 3
    producers, spans across a time chunk of 12, and where the DF1's int64
    sum wraps (coefficients and state at int32's
    edges).  K16 (the lowpass at 0.2, x ~ N(0, 1), a random state, n0 >
    0): t = the time chunk, t not a multiple of the chunk, a time chunk
    under a span, 2-row spans, 11 producers, t = 1, and a time chunk of
    16384 rows (above the old kernel's 8192-row limit)."""
    import torch
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad, pll
    from idsp_tpu_torch.filters.ddc_bank_cuda import (
        bank_plan, fastlo_ddc_bank_block, fastlo_ddc_bank_block_plain,
        fastlo_df1_dec_bank, fastlo_df1_dec_bank_plain,
    )
    from idsp_tpu_torch.filters.ddc_lockin_cuda import (
        ddc_lockin_bank, ddc_lockin_bank_plain, lockin_plan,
    )

    rng = np.random.default_rng(20)
    lp = biquad.quantize_ba(biquad.from_cookbook(
        Filter().critical_frequency(0.02).lowpass()), 29)
    pll_ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    int_edges = np.array([-(2**31), 2**31 - 1], np.int32)
    bank = {  # (c, t, d, time chunk, plan keywords)
        "chunk 24, d 16": (16, 256, 16, 32, dict(chunk=24, ring=2)),
        "17 channels, t % chunk": (17, 192, 4, 64, dict(chunk=40, ring=3)),
        "chunks under d": (3, 96, 16, 48, dict(chunk=8, ring=4)),
        "d = 1": (20, 40, 1, 8, dict(chunk=16, ring=2)),
        "one channel": (1, 64, 4, 16, dict(chunk=12, ring=3, producers=1)),
        "5 producers": (9, 120, 8, 24, dict(chunk=24, producers=5)),
        "14-row spans, time chunk 12": (7, 180, 4, 12, dict(chunk=40,
                                                            producers=3)),
        "a batch's last row past the coarse block": (5, 170, 1, 17, dict(
            chunk=30, producers=3)),
        "the sum wraps": (18, 160, 8, 32, dict(chunk=20, ring=3)),
    }
    for label, (c, t, d, tc, kw) in bank.items():
        plan = bank_plan(c, **kw)
        wraps = label == "the sum wraps"
        ba = np.full(5, -(2**31), np.int32) if wraps else lp
        st = (biquad.Df1State(
            x=torch.from_numpy(rng.choice(int_edges, (2 * c, 2))).to(dev),
            y=torch.from_numpy(rng.choice(int_edges, (2 * c, 2))).to(dev))
            if wraps else biquad.Df1State(x=i32((2 * c, 2), -(2**27), 2**27),
                                          y=i32((2 * c, 2), -(2**26),
                                                2**26)))
        steps = i32((c,))
        pst = pll.block(pll_ba, pll.init((c,), device=dev), i32((7, c)))[0]

        def x_of(t=t):
            return i32((t,)) if wraps else i32((t,), -(2**27), 2**27)

        for clamp in (None,) if wraps else (None, CLAMP):
            key = "fastlo_df1_dec_bank" + ("_clamp" if clamp else "")
            errs[key] = max(errs[key], hold(
                f"fastlo_df1_dec_bank ({label}, clamp {clamp})",
                lambda s, ph, x, ba=ba, d=d, tc=tc, cl=clamp, p=plan:
                fastlo_df1_dec_bank(ba, s, ph, steps, x, 29, d=d, clamp=cl,
                                    time_chunk=tc, _plan=p),
                lambda s, ph, x, ba=ba, d=d, tc=tc, cl=clamp:
                fastlo_df1_dec_bank_plain(ba, s, ph, steps, x, 29, d=d,
                                          clamp=cl, time_chunk=tc),
                (st, i32((c,))), x_of, blocks=2))
        errs["fastlo_ddc_bank_block"] = max(errs["fastlo_ddc_bank_block"],
                                            hold(
            f"fastlo_ddc_bank_block ({label})",
            lambda s, ps, ph, x, ba=ba, d=d, tc=tc, p=plan:
            fastlo_ddc_bank_block(ba, pll_ba, s, ps, ph, steps, x, 29, d=d,
                                  time_chunk=tc, _plan=p),
            lambda s, ps, ph, x, ba=ba, d=d, tc=tc:
            fastlo_ddc_bank_block_plain(ba, pll_ba, s, ps, ph, steps, x, 29,
                                        d=d, time_chunk=tc),
            (st, pst, i32((c,))), x_of, blocks=2))
    bf = biquad.from_cookbook(
        Filter().critical_frequency(0.2).lowpass()).astype(np.float32)
    lockin = {  # (c, t, time chunk, n0, plan keywords)
        "t = time chunk": (16, 256, 256, 0, {}),
        "t % chunk, 3 producers": (20, 240, 48, 1000,
                                   dict(chunk=44, ring=2, producers=3)),
        "time chunk under a span": (3, 96, 8, 17, dict(chunk=24,
                                                       producers=5)),
        "2-row spans": (9, 60, 12, 5, dict(chunk=7, ring=4, producers=4)),
        "11 producers": (40, 130, 13, 0, dict(chunk=32, ring=4,
                                              producers=11, warps=16)),
        "t = 1": (4, 1, 1, 9, dict(chunk=8)),
        "time chunk 16384": (2, 16384, 16384, 77, {}),
    }
    for label, (c, t, tc, n0, kw) in lockin.items():
        plan = lockin_plan(c, **kw) if kw else None
        lo = rng.uniform(0.01, 0.49, c)
        st = biquad.Df1State(*(torch.from_numpy(rng.normal(size=(
            2 * c, 2)).astype(np.float32)).to(dev) for _ in range(2)))
        n = iter(range(2))
        errs["ddc_lockin_bank"] = max(errs["ddc_lockin_bank"], hold(
            f"ddc_lockin_bank ({label})",
            lambda s, xn, tc=tc, p=plan: ddc_lockin_bank(
                bf, s, *xn, time_chunk=tc, _plan=p),
            lambda s, xn, tc=tc: ddc_lockin_bank_plain(
                bf, s, *xn, time_chunk=tc),
            (st,), lambda t=t, lo=lo, n0=n0, n=n: (torch.from_numpy(
                rng.normal(size=t).astype(np.float32)).to(dev), lo,
                n0 + next(n) * t), blocks=2))
    log(f"phase 3 K12 (unclamped and clamped {CLAMP}), K13 and K16 at the "
        f"depth-0 pipeline's edges == plain over 2 blocks each (K12/K13: "
        f"{', '.join(bank)}; K16: {', '.join(lockin)}): max |d| "
        f"{errs['fastlo_df1_dec_bank']}, "
        f"{errs['fastlo_df1_dec_bank_clamp']}, "
        f"{errs['fastlo_ddc_bank_block']}, {errs['ddc_lockin_bank']}")


def check_lowpass_edges(dev, i32, errs):
    """Phase 3 for K4 and K6 at the edges of the depth-0 pipeline, at small
    t and c, each over 2 carried blocks against its plain version,
    tolerance 0 (into errs under the kernel's own name).  K4 (N = 1 and
    2): dec 1, 3 and 16 with chunks that are not multiples of dec, t = 1, t
    under a chunk, t not a multiple of the chunk, 3 and 11 producers; the
    #5 bank's gains, gains of 2^30 and opposite signs, and gains at int32's
    ends (e k0 = 2^62), states within 2^40 of int64's ends and x a third
    at int32's ends, so the subtract saturates both ways and the regrouped
    sums wrap.  K6 (N = 1 and 2; the
    three gains sets; states at int64's edges, so the subtract saturates on
    the mixed stream): d = 1 and 16, chunks under d, c not a
    multiple of the 16-channel tile, one channel, time chunks of 32, 128
    and 512 against pipeline chunks of 64-256, 3-11 producers.  Logs K4's
    and K6's default plans at the bank's width."""
    import torch
    from idsp_tpu_torch.filters import lowpass, pll
    from idsp_tpu_torch.filters.ddc_bank_cuda import (
        bank_plan, fastlo_ddc_bank_block_lp, fastlo_ddc_bank_block_lp_plain,
    )
    from idsp_tpu_torch.filters.lowpass_cuda import (
        lowpass_bank, lowpass_bank_plain, lowpass_plan,
    )

    rng = np.random.default_rng(23)
    gains = {  # the #5 bank's; 2^30 and opposite signs; int32's ends
        "bank": {1: lowpass.gains1(0.01), 2: lowpass.gains2(0.004)},
        "mixed": {1: np.array([-(2**30)], np.int32),
                  2: np.array([2**30 - 1, -(2**30)], np.int32)},
        "edge": {1: np.array([-(2**31)], np.int32),
                 2: np.array([-(2**31), 2**31 - 1], np.int32)}}
    pll_ba = pll.coefficients_from_bandwidth(2e-2, 4.0)

    def edge_state(rows, n):
        base = rng.choice(np.array([-(2**63), 0, 2**63 - 1], np.int64),
                          (rows, n))
        off = rng.integers(0, 2**40, (rows, n), dtype=np.int64)
        return lowpass.LowpassState(p=torch.from_numpy(
            np.where(base < 0, base + off, base - off)).to(dev))

    def edge_x(t, c):
        x = i32((t, c))
        x[::3] = 2**31 - 1
        x[1::5] = -(2**31)
        return x

    lp = {  # (N, gains, lanes, t, dec, plan keywords)
        "dec 3, chunk 40, t % chunk": (2, "edge", 64, 999, 3, dict(
            chunk=40)),
        "dec 16, chunk 24, 11 producers": (1, "mixed", 40, 7 * 64 + 48,
                                           16, dict(chunk=24, producers=11,
                                                    warps=16)),
        "dec 16, 3 producers": (2, "bank", 96, 512, 16, dict(producers=3)),
        "t = 1": (1, "bank", 33, 1, 1, {}),
        "t under a chunk": (2, "mixed", 50, 100, 1, {}),
        "dec 3, 2 slots": (1, "bank", 20, 300, 3, dict(chunk=64, ring=2)),
        "dec 16, chunk 40": (2, "bank", 64, 640, 16, dict(chunk=40)),
    }
    for label, (n, g, c, t, dec, kw) in lp.items():
        plan = lowpass_plan(c, **kw)
        k = gains[g][n]
        errs["lowpass_bank"] = max(errs["lowpass_bank"], hold(
            f"lowpass_bank ({label}, N={n})",
            lambda s, xs, k=k, dec=dec, p=plan: lowpass_bank(
                k, s, xs, dec=dec, _plan=p),
            lambda s, xs, k=k, dec=dec: lowpass_bank_plain(k, s, xs,
                                                           dec=dec),
            (edge_state(c, n),), lambda t=t, c=c: edge_x(t, c), blocks=2))
    k6 = {  # (N, gains, c, t, d, time chunk, plan keywords)
        "d = 1": (2, "bank", 20, 40, 1, 8, dict(chunk=16, ring=2)),
        "17 channels, chunk 96": (1, "edge", 17, 256, 4, 128, dict(
            chunk=96)),
        "chunks under d": (2, "mixed", 3, 96, 16, 48, dict(chunk=8,
                                                            ring=4)),
        "one channel": (1, "bank", 1, 64, 4, 16, dict(chunk=12,
                                                      producers=1)),
        "time chunk 512, 11 producers": (2, "bank", 9, 1024, 8, 512, dict(
            chunk=256, producers=11, warps=16)),
        "time chunk 32, chunk 64, 3 producers": (2, "edge", 40, 768, 16, 32,
                                                 dict(chunk=64, producers=3)),
        "d = 16, time chunk 128": (1, "bank", 48, 1024, 16, 128, dict(
            chunk=128, producers=5)),
    }
    for label, (n, g, c, t, d, tc, kw) in k6.items():
        plan = bank_plan(c, **kw)
        k = gains[g][n]
        steps = i32((c,))
        pst = pll.block(pll_ba, pll.init((c,), device=dev), i32((7, c)))[0]
        errs["fastlo_ddc_bank_block_lp"] = max(
            errs["fastlo_ddc_bank_block_lp"], hold(
                f"fastlo_ddc_bank_block_lp ({label}, N={n})",
                lambda s, ps, ph, x, k=k, d=d, tc=tc, p=plan, st=steps:
                fastlo_ddc_bank_block_lp(k, pll_ba, s, ps, ph, st, x, d=d,
                                         time_chunk=tc, _plan=p),
                lambda s, ps, ph, x, k=k, d=d, tc=tc, st=steps:
                fastlo_ddc_bank_block_lp_plain(k, pll_ba, s, ps, ph, st, x,
                                               d=d, time_chunk=tc),
                (edge_state(2 * c, n), pst, i32((c,))),
                lambda t=t: i32((t,), -(2**27), 2**27), blocks=2))
    log(f"phase 3 K4 and K6 at the depth-0 pipeline's edges == plain over 2 "
        f"blocks each (K4: {', '.join(lp)}; K6: {', '.join(k6)}): max |d| "
        f"{errs['lowpass_bank']}, {errs['fastlo_ddc_bank_block_lp']}; plans "
        f"K4 {dict(lowpass_plan(2 * C_BANK)._asdict())}, K6 "
        f"{dict(bank_plan(C_BANK)._asdict())}")


def check_pll_edges(dev, i32, errs):
    """Phase 3 for K5 at the edges of the depth-0 pipeline, each case over
    2 carried blocks of full-range phases against its plain version,
    tolerance 0 (into errs["pll_bank"]): t = 1, t under a chunk, t not a
    multiple of the chunk, c not a multiple of 4 (no 16-byte stores), one
    channel and the bank's width, 1-11 producers; the #5 bank's loop and
    coefficients at int32's ends (a1 = INT32_MIN); states at the int32 and
    int64 edges: f and f0 within 2^40 of +-2^63 or of 0 (a quarter of f0's
    low words 0xFFFFFFFF), cl at -1, 0 and +1, x0 within 2^8 of a wrap.
    Logs K5's default plan at the bank's width."""
    import torch
    from idsp_tpu_torch.filters import pll
    from idsp_tpu_torch.filters.pll_cuda import (
        pll_bank, pll_bank_plain, pll_plan,
    )
    from idsp_tpu_torch.ops.unwrap import ClampWrapState

    rng = np.random.default_rng(27)
    coefs = {"bank": pll.coefficients_from_bandwidth(2e-2, 4.0),
             "edge": np.array([-(2**31), 2**31 - 1, -(2**31)], np.int64)}

    def edge_state(c):
        def i64():
            base = rng.choice(np.array([-(2**63), 0, 2**63 - 1], np.int64),
                              c)
            off = rng.integers(0, 2**40, c, dtype=np.int64)
            return np.where(base < 0, base + off, base - off)

        def t(v):
            return torch.from_numpy(np.asarray(v)).to(dev)

        f0 = i64()
        f0 = np.where(rng.random(c) < 0.25, f0 | 0xFFFFFFFF, f0)
        end = rng.choice(np.array([-(2**31), 2**31 - 1], np.int64), c)
        x0 = (end - np.sign(end) * rng.integers(0, 256, c)).astype(np.int32)
        return pll.PllState(
            clamp=ClampWrapState(x0=t(x0), clamp=t(rng.integers(
                -1, 2, c).astype(np.int8))),
            z0=i32((c,)), y0=i32((c,)), f0=t(f0), f=t(i64()), y=i32((c,)))

    cases = {  # (c, t, coefficients, plan keywords)
        "t = 1": (200, 1, "bank", {}),
        "t under a chunk, 3 producers": (50, 100, "edge", dict(
            producers=3)),
        "33 channels, t % chunk": (33, 999, "edge", dict(chunk=40)),
        "chunk 24, 11 producers": (40, 7 * 64 + 48, "bank", dict(
            chunk=24, producers=11, warps=16)),
        "one channel, 1 producer": (1, 64, "edge", dict(chunk=12,
                                                        producers=1)),
        "2 slots of 64 rows": (96, 512, "bank", dict(chunk=64, ring=2)),
        "the bank's width": (C_BANK, T // DEC, "edge", {}),
    }
    for label, (c, t, k, kw) in cases.items():
        plan = pll_plan(c, **kw)
        ba = coefs[k]
        errs["pll_bank"] = max(errs["pll_bank"], hold(
            f"pll_bank ({label})",
            lambda s, xs, ba=ba, p=plan: pll_bank(ba, s, xs, _plan=p),
            lambda s, xs, ba=ba: pll_bank_plain(ba, s, xs),
            (edge_state(c),), lambda t=t, c=c: i32((t, c)), blocks=2))
    log(f"phase 3 K5 at the depth-0 pipeline's edges == plain over 2 blocks "
        f"each ({', '.join(cases)}): max |d| {errs['pll_bank']}; plan "
        f"{dict(pll_plan(C_BANK)._asdict())}")


def check_biquad_kernels(dev, i32, errs, plain_s, ba, ba_bank, pll_ba):
    """Phase 3 for K11-K14 at full width: K11-K13 at c = C_BANK (d = 16,
    time chunk TC), K14 at c = C_MAIN and C_WIDE with int32 and f32
    output, each over HOLD_BLOCKS carried blocks; plain calls timed into
    plain_s
    (K14's f32 under ``ddc_mix_df1_bank c=<c>``)."""
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
        (df1_state(cb2),), lambda: i32((T, cb2)), plain_s)
    errs["fastlo_df1_dec_bank"] = hold(
        "fastlo_df1_dec_bank",
        lambda s, ph, x: fastlo_df1_dec_bank(ba_bank, s, ph, steps, x, 29,
                                             **kw),
        lambda s, ph, x: fastlo_df1_dec_bank_plain(ba_bank, s, ph, steps, x,
                                                   29, **kw),
        (df1_state(cb2), i32((c,))), wide, plain_s)
    errs["fastlo_ddc_bank_block"] = hold(
        "fastlo_ddc_bank_block",
        lambda s, p, ph, x: fastlo_ddc_bank_block(ba_bank, pll_ba, s, p, ph,
                                                  steps, x, 29, **kw),
        lambda s, p, ph, x: fastlo_ddc_bank_block_plain(
            ba_bank, pll_ba, s, p, ph, steps, x, 29, **kw),
        (df1_state(cb2), pll.init((c,), device=dev), i32((c,))), wide,
        plain_s)
    log(f"phase 3 K11 df1_bank_q_dec, K12 fastlo_df1_dec_bank, K13 "
        f"fastlo_ddc_bank_block == plain over {HOLD_BLOCKS} blocks (c={c}, "
        f"t={T}, d={DEC}, time_chunk={TC}): max |d| "
        f"{errs['df1_bank_q_dec']}, {errs['fastlo_df1_dec_bank']}, "
        f"{errs['fastlo_ddc_bank_block']}")
    err = 0.0
    for c in (C_MAIN, C_WIDE):
        stp = i32((c,))  # full-range frequency words: every LO octant
        for od in (None, torch.float32):
            k14_s = {}
            err = max(err, hold(
                "ddc_mix_df1_bank",
                lambda s, ph, x, od=od: ddc_mix_df1_bank(
                    ba, s, ph, stp, x, 29, out_dtype=od),
                lambda s, ph, x, od=od: ddc_mix_df1_bank_plain(
                    ba, s, ph, stp, x, 29, out_dtype=od),
                (df1_state(2 * c), i32((c,))), lambda: i32((T,)), k14_s))
        plain_s[f"ddc_mix_df1_bank c={c}"] = k14_s["ddc_mix_df1_bank"]
    errs["ddc_mix_df1_bank"] = err
    log(f"phase 3 K14 ddc_mix_df1_bank (int32 and f32 out) == plain over "
        f"{HOLD_BLOCKS} blocks at c={C_MAIN} and {C_WIDE} (x full range): max "
        f"|d| {err}")


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
    reset(wrappers)
    runs = {}
    for m, bank in banks.items():
        state, outs = bank.init_state(), []
        for xb in xs:
            state, out = bank(state, xb)
            outs.append((state, out))
        runs[m] = outs
    torch.cuda.synchronize()
    counts = launch_counts(wrappers)
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


def clamp_main_path(dev, ba, ba_bank, xblocks, steps, bank_x, bank_steps,
                    wrappers):
    """Phase 4 for the anti-windup (clamped) front ends, every counter
    reset just before and read just after: over BLOCKS blocks of the
    coherent carrier at c = C_MAIN, the exact mix then K19 against the
    exact mix, K18 and the plain time-major HBF (integer state bit for
    bit, output within 16 ULP), and K3 ``clamp=`` against the plain fast
    mix, K18 and the same HBF (the same gates); over the bank's blocks at
    c = C_BANK, K12 ``clamp=`` against the fast mix, K18 and keep 1 in
    DEC (bit for bit).  All clamped with CLAMP.  Returns the launch
    counts of the run."""
    import torch
    from idsp_tpu_torch.chain import exact_mix
    from idsp_tpu_torch.filters import biquad, hbf
    from idsp_tpu_torch.filters.biquad_cuda import df1_clamp_bank_q
    from idsp_tpu_torch.filters.ddc_bank_cuda import fastlo_df1_dec_bank
    from idsp_tpu_torch.filters.ddc_cuda import (
        df1_clamp_hbf_cascade_bank, fastlo_ddc_cascade_bank, hbf1_tail_init,
    )
    from idsp_tpu_torch.ops import accu
    from idsp_tpu_torch.ops.fastlo import fastlo_mix

    u, lo, hi = CLAMP
    c, c2, cb = C_MAIN, 2 * C_MAIN, C_BANK

    def zero(lanes, cascade):
        tails = tuple(hbf1_tail_init(lanes, m, device=dev) for m in M_DEC3)
        dec = hbf.hbf_dec_cascade_init(3, (lanes,), axis=0, device=dev)
        return (biquad.df1_init((lanes,), device=dev),
                tails if cascade else dec,
                torch.zeros((lanes // 2,), dtype=torch.int32, device=dev))

    def composed(state, miq):
        """The unfused clamped front end: K18, then the time-major HBF."""
        bq, dec, _ = state
        bq, ys = df1_clamp_bank_q(ba, bq, miq, 29, u=u, lo=lo, hi=hi)
        dec, y = hbf.hbf_dec_cascade(dec, ys.to(torch.float32), axis=0)
        return (bq, dec), y, ys

    reset(wrappers)
    runs = {"exact": [], "fast": [], "bank": []}
    for name, mix in (("exact", None), ("fast", TC)):
        st_k, st_r = zero(c2, True), zero(c2, False)
        for x in xblocks:
            ph = st_r[2]
            if mix is None:
                miq = exact_mix(x, ph, steps)
                bq, tails, y = df1_clamp_hbf_cascade_bank(
                    ba, st_k[0], st_k[1], miq, 29, u=u, lo=lo, hi=hi,
                    time_chunk=TC)
                ph_k = accu.advance(st_k[2], steps, T)
            else:
                miq = fastlo_mix(x, ph, steps, mix)
                bq, tails, ph_k, y = fastlo_ddc_cascade_bank(
                    ba, st_k[0], st_k[1], st_k[2], steps, x, 29, clamp=CLAMP,
                    time_chunk=TC)
            (bq_r, dec), y_r, ys = composed(st_r, miq)
            st_k = (bq, tails, ph_k)
            st_r = (bq_r, dec, accu.advance(ph, steps, T))
            runs[name].append((bq, ph_k, y, bq_r, st_r[2], y_r,
                               pinned(ys, CLAMP)))
    st_k = st_r = (biquad.df1_init((2 * cb,), device=dev),
                   torch.zeros((cb,), dtype=torch.int32, device=dev))
    for x in bank_x:
        bq, ph_k, yk = fastlo_df1_dec_bank(ba_bank, *st_k, bank_steps, x, 29,
                                           d=DEC, clamp=CLAMP, time_chunk=TC)
        bq_r, ys = df1_clamp_bank_q(ba_bank, st_r[0],
                                    fastlo_mix(x, st_r[1], bank_steps, TC), 29,
                                    u=u, lo=lo, hi=hi)
        st_k, st_r = (bq, ph_k), (bq_r, accu.advance(st_r[1], bank_steps, T))
        runs["bank"].append((bq, ph_k, yk, bq_r, st_r[1], ys[::DEC],
                             pinned(yk, CLAMP)))
    torch.cuda.synchronize()
    counts = launch_counts(wrappers)
    log(f"phase 4 main path: clamped front ends x {BLOCKS} blocks, clamp "
        f"{CLAMP}: exact mix + K19 and exact mix + K18 + HBF, K3 clamp= and "
        f"fast mix + K18 + HBF at c={c} (the coherent carrier), K12 clamp= "
        f"and fast mix + K18 + keep 1 in {DEC} at c={cb}; launches {counts}")
    for name, outs in runs.items():
        worst, share = 0.0, 0.0
        for b, (bq, ph, y, bq_r, ph_r, y_r, pin) in enumerate(outs):
            compare(f"clamped {name}: DF1 state and phase, block {b}",
                    (bq.x, bq.y, ph), (bq_r.x, bq_r.y, ph_r))
            if y.shape != y_r.shape or not bool(torch.isfinite(
                    y.float()).all()):
                raise AssertionError(f"clamped {name}: bad output")
            worst = max(worst, max_abs(y, y_r))
            share = max(share, pin)
            bound = 0 if name == "bank" else ulp_bound(y_r, 16)
            if worst > bound:
                raise AssertionError(f"clamped {name}: output off the "
                                     f"unfused composition by {worst} > "
                                     f"{bound}")
        log(f"phase 4 clamped {name}: DF1 state and phase bit for bit vs the "
            f"unfused composition; max |output d| {worst} (gate "
            f"{'0' if name == 'bank' else '16 ULP'}); DF1 outputs pinned "
            f"{share:.4%}")
    return counts


def fm_inputs(dev, rng):
    """The FM bank's (T, C_FM) IQ planes: `cossin` of uniform random int32
    phases (benches/suite.py:751-756)."""
    import torch
    from idsp_tpu_torch.ops.trig import cossin

    ph = rng.integers(-(2**31), 2**31, size=(T, C_FM), dtype=np.int64)
    re, im = cossin(torch.from_numpy(ph.astype(np.int32)).to(dev))
    return re.contiguous(), im.contiguous()


def normal_f32(dev, rng, shape):
    import torch

    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)


def lockin_setup():
    """(lo_fs, ba) of the lock-in bank (benches/suite.py:899-931)."""
    from idsp_tpu_torch.pipelines.ddc_lockin import lowpass_ba

    return np.linspace(0.05, 0.45, C_LOCKIN), lowpass_ba(0.002)


def near(got, want, scale, rel=2e-5):
    """Largest |got - want| of two tensors; raises above rel * scale."""
    err = max_abs(got, want)
    if not (got.shape == want.shape and err <= rel * scale):
        raise AssertionError(f"off by {err} > {rel} * {scale}")
    return err


def check_slice5_kernels(dev, rng, errs, plain_s):
    """Phase 3 for K15-K17: K15 (both angles) and K16 bit for bit over
    HOLD_BLOCKS carried blocks at c = 512, t = T, plain calls
    timed into plain_s (K15 fast under ``fm_disc_bank_fast``); K17
    (`check_k17`)."""
    import torch
    from idsp_tpu_torch.filters.ddc_lockin_cuda import (
        ddc_lockin_bank, ddc_lockin_bank_plain,
    )
    from idsp_tpu_torch.filters.fm_cuda import fm_disc_bank, fm_disc_bank_plain
    from idsp_tpu_torch.pipelines import fm_disc

    ba_fm = fm_disc.deemphasis_coefficients(0.02)
    err = 0.0
    for angle, key in (("exact", "fm_disc_bank"),
                       ("fast", "fm_disc_bank_fast")):
        k15_s = {}
        e = hold(
            "fm_disc_bank",
            lambda s, iq: fm_disc_bank(ba_fm, s, *iq, FM_CARRIER,
                                       angle=angle),
            lambda s, iq: fm_disc_bank_plain(ba_fm, s, *iq, FM_CARRIER,
                                             angle=angle),
            (fm_disc.init_state((C_FM,), device=dev),),
            lambda: fm_inputs(dev, rng), k15_s)
        plain_s[key] = k15_s["fm_disc_bank"]
        err = max(err, e)
    errs["fm_disc_bank"] = err
    log(f"phase 3 K15 fm_disc_bank (exact and fast angle) == plain over "
        f"{HOLD_BLOCKS} blocks (c={C_FM}, t={T}, IQ = cossin of random "
        f"phases): max |d| {err}")

    lo_fs, ba_lk = lockin_setup()
    n0 = iter(range(0, BLOCKS * T, T))  # the sample index carried on

    errs["ddc_lockin_bank"] = hold(
        "ddc_lockin_bank",
        lambda s, xn: ddc_lockin_bank(ba_lk, s, *xn, time_chunk=TC_LOCKIN),
        lambda s, xn: ddc_lockin_bank_plain(ba_lk, s, *xn,
                                            time_chunk=TC_LOCKIN),
        (biquad_f32_state(dev, rng, 2 * C_LOCKIN),),
        lambda: (normal_f32(dev, rng, (T,)), lo_fs, next(n0)), plain_s)
    log(f"phase 3 K16 ddc_lockin_bank == plain over {HOLD_BLOCKS} blocks "
        f"(c={C_LOCKIN}, t={T}, time_chunk={TC_LOCKIN}, x ~ N(0, 1)): "
        f"max |d| {errs['ddc_lockin_bank']}")

    check_k17(dev, rng, errs)


def check_k17(dev, rng, errs):
    """Phase 3 for K17 (f32 and bf16) at K17_CASES within 2e-5 of the
    output scale, its history bit for bit; at m = M_CH, n = 1024 the 64-
    and 128-frame plans, and one block against its halves split at frames
    100, 1 and n/2, bit for bit."""
    import torch
    from idsp_tpu_torch.pipelines import channelizer as chz
    from idsp_tpu_torch.pipelines.channelizer_cuda import (
        channelize_fused, channelize_fused_plain, launch_plan,
    )

    errs["channelize_fused"] = 0.0
    for tw in (torch.float32, torch.bfloat16):
        for m, n, blocks in K17_CASES:
            st = chz.PlanesState(*(normal_f32(dev, rng, (CH_TAPS - 1, m))
                                   for _ in range(2)))
            err = rel = 0.0
            for _ in range(blocks):
                zr, zi = (normal_f32(dev, rng, (n, m)) for _ in range(2))
                got = channelize_fused(st, zr, zi, m=m, taps=CH_TAPS,
                                       twiddle_dtype=tw)
                want = channelize_fused_plain(st, zr, zi, m=m, taps=CH_TAPS,
                                              twiddle_dtype=tw)
                torch.cuda.synchronize()
                compare("channelize_fused history", got[0], want[0])
                scale = float(torch.maximum(want[1].abs().max(),
                                            want[2].abs().max()))
                for g, w in zip(got[1:], want[1:]):
                    d = near(g, w, scale)
                    err, rel = max(err, d), max(rel, d / scale)
                st = got[0]
            if tw == torch.bfloat16:
                errs["channelize_fused"] = max(errs["channelize_fused"], err)
            log(f"phase 3 K17 channelize_fused ({str(tw)[6:]}) vs plain over "
                f"{blocks} block(s) (m={m}, n={n}, "
                f"{launch_plan(n, m, CH_TAPS, tw)}): max |d| {err} = "
                f"{rel:.3e} of the scale (gate 2e-5), history bit for bit")
        # two plans and a block against its halves, bit for bit
        m, n = M_CH, N_CH[0]
        st = chz.PlanesState(*(normal_f32(dev, rng, (CH_TAPS - 1, m))
                               for _ in range(2)))
        zr, zi = (normal_f32(dev, rng, (n, m)) for _ in range(2))
        outs = [channelize_fused(st, zr, zi, m=m, taps=CH_TAPS,
                                 twiddle_dtype=tw,
                                 _plan=launch_plan(n, m, CH_TAPS, tw, frames=f))
                for f in (64, 128)]
        compare("channelize_fused 64- vs 128-frame plan", outs[0], outs[1])
        for cut in (100, 1, n // 2):
            a = channelize_fused(st, zr[:cut], zi[:cut], m=m, taps=CH_TAPS,
                                 twiddle_dtype=tw)
            b = channelize_fused(a[0], zr[cut:], zi[cut:], m=m, taps=CH_TAPS,
                                 twiddle_dtype=tw)
            torch.cuda.synchronize()
            compare(f"channelize_fused halves at {cut} vs one block", (
                b[0], torch.cat([a[1], b[1]]), torch.cat([a[2], b[2]])),
                outs[0])
        log(f"phase 3 K17 channelize_fused ({str(tw)[6:]}, m={m}, n={n}): "
            f"the 64- and 128-frame plans, and one block against its halves "
            f"split at frames 100, 1 and {n // 2}, bit for bit")


def biquad_f32_state(dev, rng, lanes):
    from idsp_tpu_torch.filters import biquad

    return biquad.Df1State(x=normal_f32(dev, rng, (lanes, 2)),
                           y=normal_f32(dev, rng, (lanes, 2)))


def fm_main_path(dev, rng, wrappers):
    """Phase 4 for BASELINE #1: `FmReceiver` in its four modes over BLOCKS
    blocks at c = C_FM, t = T; ``kernel`` == ``composed`` (K26 once a
    block) == ``scan`` on every word, ``kernel_fast`` within 1024 LSB of ``kernel``; then
    `run_fm_disc` through K15 (both angles) against the reference's gates.
    Returns the launch counts of the run."""
    import torch
    from idsp_tpu_torch.pipelines import fm_disc
    from idsp_tpu_torch.pipelines.fm_disc import FmReceiver

    ba = fm_disc.deemphasis_coefficients(0.02)
    blocks = [fm_inputs(dev, rng) for _ in range(BLOCKS)]
    reset(wrappers)
    runs = {}
    for m in fm_disc.MODES:
        rx = FmReceiver(m, ba, FM_CARRIER, C_FM, device=dev)
        st, outs = rx.init_state(), []
        for re, im in blocks:
            st, y = rx(st, re, im)
            outs.append((st, y))
        runs[m] = outs
    gates = {k: fm_disc.run_fm_disc(kernel=k, device=dev)
             for k in ("exact", "fast")}
    torch.cuda.synchronize()
    counts = launch_counts(wrappers)
    log(f"phase 4 main path: FmReceiver {fm_disc.MODES} x {BLOCKS} blocks at "
        f"c={C_FM}, t={T}, carrier {FM_CARRIER}, deemphasis Q32<30> at 0.02; "
        f"run_fm_disc (exact, fast); launches {counts}")
    for m in ("composed", "kernel"):
        for b, (got, want) in enumerate(zip(runs[m], runs["scan"])):
            compare(f"FmReceiver {m} vs scan, block {b}", got, want)
    if counts["df1_bank_q_coef"] != BLOCKS:  # composed: K26 once a block
        raise AssertionError(f"FmReceiver composed launched K26 "
                             f"{counts['df1_bank_q_coef']} times in {BLOCKS} "
                             "blocks")
    fast = max(max_abs(f[1], k[1])
               for f, k in zip(runs["kernel_fast"], runs["kernel"]))
    for m, outs in runs.items():
        y = outs[-1][1]
        if tuple(y.shape) != (T, C_FM) or y.dtype != torch.int32:
            raise AssertionError(f"FmReceiver {m}: output {y.dtype}"
                                 f"{tuple(y.shape)}")
    if fast > 1024:
        raise AssertionError(f"FmReceiver kernel_fast off kernel by {fast}")
    log(f"phase 4 FmReceiver kernel == composed (K26, {BLOCKS} launches) == "
        f"scan on every output and state word over {BLOCKS} blocks; "
        f"kernel_fast max |d| {fast} <= 1024 LSB")
    for k, r in gates.items():
        if not (r["corr"] > 0.999 and 0.95 < r["gain"] < 1.05
                and r["rms"] < 5e-4):
            raise AssertionError(f"run_fm_disc({k!r}) gates: {r}")
        log(f"phase 4 run_fm_disc kernel={k!r}: corr {r['corr']:.9f} > "
            f"0.999, gain {r['gain']:.7f} in (0.95, 1.05), rms "
            f"{r['rms']:.3e} < 5e-4")
    return counts


def lockin_f64(lo_fs, ba, xs):
    """The lock-in bank in float64 (LO from float64 phases, float64 DF1 with
    the same coefficients) over the blocks ``xs``: the yardstick of the
    f32 paths' rounding."""
    import torch
    from idsp_tpu_torch.filters import biquad

    f64 = torch.float64
    dev = xs[0].device
    w = torch.as_tensor(2 * np.pi * lo_fs, dtype=f64, device=dev)
    st = biquad.df1_init((2 * len(lo_fs),), f64, device=dev)
    outs = []
    for b, x in enumerate(xs):
        i = b * len(x) + torch.arange(len(x), dtype=f64, device=dev)
        ph = torch.remainder(i[:, None] * w[None], 2 * np.pi)
        xb = x.to(f64)[:, None]
        iq = torch.cat([xb * torch.cos(ph), -(xb * torch.sin(ph))], dim=1)
        st, y = biquad.df1_process(ba.astype(np.float64), st, iq)
        outs.append(y)
    return outs


def lockin_tone_gates(y, lo_fs, k_tone, phi):
    """The gates of tests/test_structures_pallas.py:214-229 on the output of
    a tone at channel ``k_tone``: (mean errors, rms, distant channels)."""
    c = len(lo_fs)
    tail = y[3 * y.shape[0] // 4:].double().cpu().numpy()
    exp_i, exp_q = 0.5 * np.cos(phi), 0.5 * np.sin(phi)
    di = abs(tail[:, k_tone].mean() - exp_i)
    dq = abs(tail[:, c + k_tone].mean() - exp_q)
    rms = float(np.sqrt(((tail[:, k_tone] - exp_i) ** 2
                         + (tail[:, c + k_tone] - exp_q) ** 2).mean()))
    # channels whose LO lies within the +-3-channel window of the c = 128
    # test (0.0094 in frequency) see the difference tone in the passband
    far = np.abs(lo_fs - lo_fs[k_tone]) > 3 * 0.4 / 127
    off = float(np.abs(tail[:, :c]).mean(axis=0)[far].max())
    if not (di < 3e-3 and dq < 3e-3 and rms < 6e-3 and off < 0.05):
        raise AssertionError(f"lock-in gates: mean off by ({di}, {dq}), rms "
                             f"{rms}, distant channels {off}")
    return f"|mean - 0.5 (cos, sin) phi| = ({di:.3e}, {dq:.3e}) < 3e-3, " \
        f"rms {rms:.3e} < 6e-3, distant channels mean |I| max {off:.3e} < 0.05"


def lockin_main_path(dev, rng, wrappers):
    """Phase 4 for BASELINE #2: `DdcLockinBank` ``scan`` and ``kernel``
    over BLOCKS blocks (n0 carried) at c = C_LOCKIN, t = T, x ~ N(0, 1),
    and a tone at channel 40 through ``kernel`` against the gates of
    tests/test_structures_pallas.py:214-229.  ``kernel`` against ``scan``:
    within 2e-5 on the JAX package's own inputs (:182-212: c = 128, t =
    4096, time chunk 256, two blocks, the tone); at this width the f32
    DF1's roundoff (the lowpass at 0.002 lifts it ~6000x at DC) exceeds
    that, so there ``kernel``'s error against a float64 evaluation must
    stay within twice ``scan``'s.  Returns the launch counts of the run."""
    import torch
    from idsp_tpu_torch.pipelines.ddc_lockin import MODES, DdcLockinBank

    lo_fs, ba = lockin_setup()
    xs = [normal_f32(dev, rng, (T,)) for _ in range(BLOCKS)]
    k_tone, phi = 40, 0.37

    def tone(freq, t):
        i = np.arange(t, dtype=np.float64)
        return torch.from_numpy(np.cos(2 * np.pi * freq * i + phi).astype(
            np.float32)).to(dev)

    lo_128 = np.linspace(0.05, 0.45, 128)
    x_128 = tone(lo_128[k_tone], 4096)
    reset(wrappers)
    runs, small = {}, {}
    for m in MODES:
        bank = DdcLockinBank(m, lo_fs, ba, time_chunk=TC_LOCKIN, device=dev)
        st, outs = bank.init_state(), []
        for b, xb in enumerate(xs):
            st, y = bank(st, xb, b * T)
            outs.append((st, y))
        runs[m] = outs
        bank = DdcLockinBank(m, lo_128, ba, time_chunk=256, device=dev)
        st, outs = bank.init_state(), []
        for n0 in (0, 2048):
            st, y = bank(st, x_128[n0:n0 + 2048], n0)
            outs.append(y)
        small[m] = torch.cat(outs)
    bank = DdcLockinBank("kernel", lo_fs, ba, time_chunk=TC_LOCKIN,
                         device=dev)
    _, y_tone = bank(bank.init_state(), tone(lo_fs[k_tone], T))
    torch.cuda.synchronize()
    counts = launch_counts(wrappers)
    log(f"phase 4 main path: DdcLockinBank {MODES} x {BLOCKS} blocks at "
        f"c={C_LOCKIN} ({2 * C_LOCKIN} I|Q lanes), t={T}, time_chunk="
        f"{TC_LOCKIN}, lowpass 0.002, and at c=128, t=4096 on a tone; a tone "
        f"at channel {k_tone}; launches {counts}")
    d128 = max_abs(small["kernel"], small["scan"])
    if d128 >= 2e-5:
        raise AssertionError(f"DdcLockinBank kernel off scan by {d128} at "
                             f"c=128")
    log(f"phase 4 DdcLockinBank kernel vs scan at c=128, t=4096 (the tone of "
        f"tests/test_structures_pallas.py:182-212): max |d| {d128} < 2e-5; "
        f"gates: {lockin_tone_gates(small['kernel'], lo_128, k_tone, phi)}")
    ref = lockin_f64(lo_fs, ba, xs)
    worst = e_scan = e_kernel = 0.0
    for (sk, yk), (ss, ys), yr in zip(runs["kernel"], runs["scan"], ref):
        if tuple(yk.shape) != (T, 2 * C_LOCKIN) or not bool(
                torch.isfinite(yk).all()):
            raise AssertionError("DdcLockinBank kernel: bad output")
        worst = max(worst, max_abs(yk, ys), max_abs(sk.y, ss.y))
        e_scan = max(e_scan, max_abs(ys, yr))
        e_kernel = max(e_kernel, max_abs(yk, yr))
    if e_kernel > 2 * e_scan:
        raise AssertionError(f"DdcLockinBank kernel off float64 by {e_kernel}"
                             f", scan by {e_scan}")
    log(f"phase 4 DdcLockinBank over {BLOCKS} blocks at c={C_LOCKIN}: max "
        f"|kernel - scan| {worst}; against float64: kernel {e_kernel}, scan "
        f"{e_scan} (gate: kernel <= 2 x scan)")
    log(f"phase 4 lock-in gates at c={C_LOCKIN} (kernel, channel {k_tone}): "
        f"{lockin_tone_gates(y_tone, lo_fs, k_tone, phi)}")
    return counts


def channelizer_main_path(dev, rng, wrappers):
    """Phase 4 for BASELINE #3: `channelize_planes` at m = M_CH, 8 taps,
    ``impl="fused"`` (K17) and the plain ``"xla"`` composition, bf16 and
    f32, over BLOCKS blocks of n = N_CH[0] frames and one of N_CH[1]:
    fused within 2e-5 of the scale of the plain planes path; then the
    tone at channel 100 through the fused path: p[100] > 1e4 x the rest
    at f32 (tests/test_pipelines.py:46-53), > 10x at bf16 (:205-209).
    Returns the launch counts of the run."""
    import torch
    from idsp_tpu_torch.pipelines import channelizer as chz

    blocks = {n: [tuple(normal_f32(dev, rng, (n, M_CH)) for _ in range(2))
                  for _ in range(BLOCKS if n == N_CH[0] else 1)]
              for n in N_CH}
    nfr = 160
    x = chz.tone(100 / M_CH, M_CH * nfr, device=dev)
    tone = chz.planes_from_stream(x[..., 0].contiguous(),
                                  x[..., 1].contiguous(), M_CH)
    reset(wrappers)
    runs, powers = {}, {}
    for tw in (torch.bfloat16, torch.float32):
        for impl in ("fused", "xla"):
            for n, zs in blocks.items():
                st = chz.init_planes(M_CH, CH_TAPS, device=dev)
                outs = []
                for zr, zi in zs:
                    st, yr, yi = chz.channelize_planes(
                        st, zr, zi, m=M_CH, taps=CH_TAPS, twiddle_dtype=tw,
                        impl=impl)
                    outs.append((st, yr, yi))
                runs[(tw, impl, n)] = outs
        _, yr, yi = chz.channelize_planes(
            chz.init_planes(M_CH, CH_TAPS, device=dev), *tone, m=M_CH,
            taps=CH_TAPS, twiddle_dtype=tw, impl="fused")
        powers[tw] = (yr.double() ** 2 + yi.double() ** 2)[128:].mean(
            0).cpu().numpy()
    torch.cuda.synchronize()
    counts = launch_counts(wrappers)
    log(f"phase 4 main path: channelize_planes (fused, xla) x (bf16, f32) at "
        f"m={M_CH}, taps={CH_TAPS}, n={N_CH[0]} x {BLOCKS} blocks and n="
        f"{N_CH[1]}; the tone at channel 100; launches {counts}")
    for (tw, impl, n), outs in runs.items():
        if impl != "fused":
            continue
        worst = 0.0
        for (st, yr, yi), (st_p, yr_p, yi_p) in zip(outs,
                                                     runs[(tw, "xla", n)]):
            compare("channelize_planes fused vs xla history", st, st_p)
            scale = float(torch.maximum(yr_p.abs().max(), yi_p.abs().max()))
            for g, w in ((yr, yr_p), (yi, yi_p)):
                worst = max(worst, near(g, w, scale))
        log(f"phase 4 channelize_planes fused vs xla ({str(tw)[6:]}, n={n}):"
            f" max |d| {worst} (gate 2e-5 x {scale:.3f}), history bit for bit")
    for tw, ratio in ((torch.float32, 1e4), (torch.bfloat16, 10.0)):
        p = powers[tw]
        got = float(p[100] / np.delete(p, 100).max())
        if int(np.argmax(p)) != 100 or not got > ratio:
            raise AssertionError(f"channelizer tone gate ({tw}): peak at "
                                 f"{int(np.argmax(p))}, ratio {got}")
        log(f"phase 4 channelizer tone at channel 100 ({str(tw)[6:]}, fused):"
            f" p[100] / max(others) = {got:.4e} > {ratio:g}")
    return counts


def channelizer_library(zr, zi, tw):
    """The yardstick of K17 (never used by the port): the polyphase FIR in
    torch ops and `torch.matmul` of the four products, in ``tw`` (bf16
    products with a bf16 result; f32 with TF32 off)."""
    import torch
    from idsp_tpu_torch.pipelines import channelizer as chz

    coeff = torch.from_numpy(chz.coefficients(None, M_CH, CH_TAPS)).to(
        zr.device)
    hist = torch.zeros((CH_TAPS - 1, M_CH), device=zr.device)
    wr, wi = chz.twiddles(M_CH, tw, zr.device)

    def run(_):
        ar = chz.polyphase_fir(hist, zr, coeff)[0].to(tw)
        ai = chz.polyphase_fir(hist, zi, coeff)[0].to(tw)
        return ar @ wr - ai @ wi, ar @ wi + ai @ wr

    return run


def time_slice5(dev, rng, card, timings, plain_s):
    """Phase 6 for BASELINE #1-#3: K15-K17 beside their plain versions
    (K15's and K16's timed in phase 3; K17 also beside its library
    yardstick), the modes' block times and rates, busy shares of the
    kernel modes."""
    import torch
    from idsp_tpu_torch.filters.ddc_lockin_cuda import (
        ddc_lockin_bank,
    )
    from idsp_tpu_torch.filters.fm_cuda import fm_disc_bank
    from idsp_tpu_torch.pipelines import channelizer as chz
    from idsp_tpu_torch.pipelines import fm_disc
    from idsp_tpu_torch.pipelines.channelizer_cuda import (
        channelize_fused, channelize_fused_plain, launch_plan,
    )
    from idsp_tpu_torch.pipelines.ddc_lockin import DdcLockinBank
    from idsp_tpu_torch.pipelines.fm_disc import FmReceiver
    from idsp_tpu_torch.profiling import measure_rate

    def record(name, key, k_s, p_s, l_s=None, note=""):
        entry = {"ms": k_s * 1e3, "plain_ms": p_s * 1e3}
        if l_s is not None:
            entry["library_ms"] = l_s * 1e3
        timings["kernels"].setdefault(name, {})[key] = entry
        lib = "" if l_s is None else f", library {l_s * 1e3:.4f} ms"
        log(f"phase 6 {name} {note}: kernel {k_s * 1e3:.4f} ms, plain "
            f"{p_s * 1e3:.2f} ms{lib}  [{card}]")

    # K15 and the FM receiver at c = C_FM
    ba = fm_disc.deemphasis_coefficients(0.02)
    re, im = fm_inputs(dev, rng)
    st0 = fm_disc.init_state((C_FM,), device=dev)
    for angle, name in (("exact", "fm_disc_bank"),
                        ("fast", "fm_disc_bank_fast")):
        def kern(s, angle=angle):
            return fm_disc_bank(ba, s, re, im, FM_CARRIER, angle=angle)

        k_s, _ = measure_rate(kern, st0, iters=20, trials=3)
        p_s = plain_s[name]
        dev_ms = launch_device_ms(name, kern, st0)
        record(name, C_FM, k_s, p_s, note=f"c={C_FM} ({angle} angle), "
               f"device {dev_ms} ms a launch (profiler spans)")
        timings["kernels"][name][C_FM]["device_ms"] = dev_ms
    timings["fm_samples_per_s"] = {}
    for m in fm_disc.MODES:
        rx = FmReceiver(m, ba, FM_CARRIER, C_FM, device=dev)
        how = ONCE if m == "scan" else {"iters": 10, "trials": 3}
        sec, _ = measure_rate(rx, rx.init_state(), re, im, **how)
        timings["fm_samples_per_s"][m] = C_FM * T / sec
        log(f"phase 6 c={C_FM} FmReceiver {m}: {sec * 1e3:.3f} ms/block, "
            f"{C_FM * T / sec:.6e} samples/s (c*t)  [{card}]")
        if m != "scan":
            log_busy(timings, f"fm_{m}", C_FM, sec, card, rx,
                     rx.init_state(), re, im)

    # K16 and the lock-in bank at c = C_LOCKIN
    lo_fs, ba_lk = lockin_setup()
    x = normal_f32(dev, rng, (T,))
    sl0 = biquad_f32_state(dev, rng, 2 * C_LOCKIN)
    def k16(s):
        return ddc_lockin_bank(ba_lk, s, x, lo_fs, 0, time_chunk=TC_LOCKIN)

    k_s, _ = measure_rate(k16, sl0, iters=20, trials=3)
    p_s = plain_s["ddc_lockin_bank"]
    dev_ms = launch_device_ms("ddc_lockin_bank", k16, sl0)
    record("ddc_lockin_bank", C_LOCKIN, k_s, p_s, note=f"c={C_LOCKIN}, "
           f"device {dev_ms} ms a launch (profiler spans)")
    timings["kernels"]["ddc_lockin_bank"][C_LOCKIN]["device_ms"] = dev_ms
    timings["lockin_samples_per_s"] = {}
    for m in ("scan", "kernel"):
        bank = DdcLockinBank(m, lo_fs, ba_lk, time_chunk=TC_LOCKIN,
                             device=dev)
        how = ONCE if m == "scan" else {"iters": 10, "trials": 3}
        sec, _ = measure_rate(bank, bank.init_state(), x, **how)
        timings["lockin_samples_per_s"][m] = C_LOCKIN * T / sec
        log(f"phase 6 c={C_LOCKIN} DdcLockinBank {m}: {sec * 1e3:.3f} "
            f"ms/block, {C_LOCKIN * T / sec:.6e} samples/s (c*t)  [{card}]")
        if m != "scan":
            log_busy(timings, f"lockin_{m}", C_LOCKIN, sec, card, bank,
                     bank.init_state(), x)

    # K17 at m = M_CH, n in N_CH: bf16 and f32, beside plain and library
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    timings["channelizer_samples_per_s"] = {}
    for n in N_CH:
        zr, zi = (normal_f32(dev, rng, (n, M_CH)) for _ in range(2))
        sc0 = chz.init_planes(M_CH, CH_TAPS, device=dev)
        for tw, name in ((torch.bfloat16, "channelize_fused"),
                         (torch.float32, "channelize_fused_f32")):
            def kern(s, tw=tw):
                return channelize_fused(s, zr, zi, m=M_CH, taps=CH_TAPS,
                                        twiddle_dtype=tw)

            def plain(s, tw=tw):
                return channelize_fused_plain(s, zr, zi, m=M_CH, taps=CH_TAPS,
                                              twiddle_dtype=tw)

            lib = channelizer_library(zr, zi, tw)
            k_s, _ = measure_rate(kern, sc0, iters=20, trials=3)
            p_s, _ = measure_rate(plain, sc0, iters=5, trials=3)
            l_s, _ = measure_rate(lib, None, iters=10, trials=3,
                                  stateful=False)
            dev_ms = launch_device_ms(name, kern, sc0)
            plan = launch_plan(n, M_CH, CH_TAPS, tw)
            # the 64-frame tiling the tests force, beside the default 128
            p64 = launch_plan(n, M_CH, CH_TAPS, tw, frames=64)
            k64_s, _ = measure_rate(
                lambda s, tw=tw, p=p64: channelize_fused(
                    s, zr, zi, m=M_CH, taps=CH_TAPS, twiddle_dtype=tw,
                    _plan=p), sc0, iters=20, trials=3)
            record(name, n, k_s, p_s, l_s,
                   note=f"n={n}, m={M_CH}, {plan}, device {dev_ms} ms a "
                        f"launch (profiler spans); the 64-frame plan "
                        f"{k64_s * 1e3:.4f} ms")
            timings["kernels"][name][n].update(
                device_ms=dev_ms, plan=plan._asdict(),
                ms_64_frames=k64_s * 1e3)
            for impl in ("fused", "xla"):
                def step(s, impl=impl, tw=tw):
                    return chz.channelize_planes(s, zr, zi, m=M_CH,
                                                 taps=CH_TAPS,
                                                 twiddle_dtype=tw, impl=impl)

                sec, _ = measure_rate(step, sc0, iters=10, trials=3)
                key = f"{impl}_{str(tw)[6:]}"
                timings["channelizer_samples_per_s"].setdefault(key, {})[n] = (
                    n * M_CH / sec)
                log(f"phase 6 n={n} channelize_planes {key}: "
                    f"{sec * 1e3:.4f} ms/block, {n * M_CH / sec:.6e} "
                    f"samples/s (n*m)  [{card}]")
                if impl == "fused":
                    log_busy(timings, f"channelizer_{key}", n, sec, card,
                             step, sc0)


# ---- the Stabilizer IIR control path (K24-K27) ------------------------------


def control_rows():
    """The compat legs' rows: the suite's Q29 lowpass at 0.1 four times
    ("q32 cascade4", benches/suite.py:221, 397-417) as (4, 6) cookbook
    rows, and two of them with the clamp WIDE_CLAMP as (2, 9) rows."""
    from idsp_tpu_torch.design import Filter

    ba = Filter().critical_frequency(0.1).lowpass()
    row = np.concatenate([ba[0], ba[1]])
    sos = np.stack([row] * SOS_STAGES)
    wide = np.stack([np.concatenate([row, WIDE_CLAMP])] * WIDE_STAGES)
    return sos, wide


def control_configs(c, seed):
    """c `BiquadConfig`s built with f = 29, one per channel, sharing the
    offset 0 and the limits CONFIG_LIMITS (K27 takes one triple): Filter
    lowpass, notch and bandpass at spread frequencies, Pid "I" and "PI"."""
    from idsp_tpu_torch.design.config import (
        BiquadConfig, FilterConfig, GainsConfig, PidConfig,
    )

    rng = np.random.default_rng(seed)
    lo, hi = CONFIG_LIMITS
    out = []
    for k in range(c):
        fc = float(rng.uniform(0.005, 0.2))
        if k % 5 < 3:
            cfg = BiquadConfig("Filter", FilterConfig(
                typ=("lowpass", "notch", "bandpass")[k % 5], frequency=fc,
                min=lo, max=hi))
        else:
            gain = (GainsConfig(i=fc * 1e-2) if k % 5 == 3
                    else GainsConfig(i=fc * 1e-2, p=0.5))
            cfg = BiquadConfig("Pid", PidConfig(order="I", gain=gain, min=lo,
                                                max=hi))
        out.append(cfg.build(f=29))
    return out


def check_control_kernels(dev, i32, i64, errs, plain_s):
    """Phase 3 for K24-K27 at c = C_CTL lanes, x full range: each kernel
    against its plain version on one carried block of T rows, tolerance 0,
    the plain call timed (K24 with SOS_STAGES stages and random state, K25
    clamped with WIDE_CLAMP and a random int64 state, K26 and K27 with
    per-lane planes of the config bank); then K25 unclamped and K26 with a
    shared (5,) set on T_PREFIX rows."""
    import torch
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.filters.biquad_cuda import (
        df1_bank_q_coef, df1_bank_q_coef_plain, df1_clamp_bank_q_coef,
        df1_clamp_bank_q_coef_plain, df1_wide_bank, df1_wide_bank_plain,
        sos_bank_q, sos_bank_q_plain,
    )
    from idsp_tpu_torch.pipelines.config_bank import stack_coeffs

    c = C_CTL
    sos_rows, _ = control_rows()
    ba_sos = biquad.quantize_ba(biquad.from_cookbook(
        sos_rows.reshape(-1, 2, 3)), 29)
    ba_wide = ba_sos[0]
    planes, (u, lo, hi) = stack_coeffs(control_configs(c, 1))
    planes = torch.from_numpy(planes).to(dev)

    def df1(lo=-(2**31), hi=2**31):
        return biquad.Df1State(x=i32((c, 2)), y=i32((c, 2), lo, hi))

    wide_st = biquad.Df1WideState(x=i32((c, 2)), y=i64((c, 2)))
    cases = (
        ("sos_bank_q",
         lambda s, x: sos_bank_q(ba_sos, s, x, 29),
         lambda s, x: sos_bank_q_plain(ba_sos, s, x, 29),
         ([df1(-(2**26), 2**26) for _ in range(SOS_STAGES)],)),
        ("df1_wide_bank",
         lambda s, x: df1_wide_bank(ba_wide, s, x, 29, clamp=WIDE_CLAMP),
         lambda s, x: df1_wide_bank_plain(ba_wide, s, x, 29,
                                          clamp=WIDE_CLAMP),
         (wide_st,)),
        ("df1_bank_q_coef",
         lambda s, x: df1_bank_q_coef(planes, s, x, 29),
         lambda s, x: df1_bank_q_coef_plain(planes, s, x, 29), (df1(),)),
        ("df1_clamp_bank_q_coef",
         lambda s, x: df1_clamp_bank_q_coef(planes, s, x, 29, u=u, lo=lo,
                                            hi=hi),
         lambda s, x: df1_clamp_bank_q_coef_plain(planes, s, x, 29, u=u,
                                                  lo=lo, hi=hi), (df1(),)),
    )
    for name, kern, plain, carry in cases:
        errs[name] = hold(name, kern, plain, carry, lambda: i32((T, c)),
                          plain_s, blocks=1)
    prefix = (
        ("df1_wide_bank (unclamped)",
         lambda s, x: df1_wide_bank(ba_wide, s, x, 29),
         lambda s, x: df1_wide_bank_plain(ba_wide, s, x, 29), (wide_st,)),
        ("df1_bank_q_coef (shared (5,))",
         lambda s, x: df1_bank_q_coef(ba_wide, s, x, 29),
         lambda s, x: df1_bank_q_coef_plain(ba_wide, s, x, 29), (df1(),)),
    )
    for name, kern, plain, carry in prefix:
        err = hold(name, kern, plain, carry, lambda: i32((T_PREFIX, c)),
                   blocks=1)
        errs[name.split()[0]] = max(errs[name.split()[0]], err)
    log(f"phase 3 K24 sos_bank_q ({SOS_STAGES} stages), K25 df1_wide_bank "
        f"(clamp {WIDE_CLAMP}), K26 df1_bank_q_coef and K27 "
        f"df1_clamp_bank_q_coef (per-lane planes of the config bank, clamp "
        f"{(u, lo, hi)}) == plain on one block (c={c}, t={T}, x full range; "
        f"plain {', '.join(f'{k} {plain_s[k]:.2f} s' for k, *_ in cases)}); "
        f"K25 unclamped and K26 with a shared (5,) set on {T_PREFIX} rows: "
        f"max |d| {[errs[k] for k, *_ in cases]}")


def halves(name, fn, carry, x):
    """``fn(*carry, x)`` over x whole and over its two halves in turn:
    raises unless state and output agree bit for bit.  ``x`` and the
    output may be tensors or tuples of tensors with time on axis 0."""
    import torch

    def cut(v, sl):
        return (tuple(u[sl].contiguous() for u in v) if isinstance(v, tuple)
                else v[sl].contiguous())

    def cat(a, b):
        return (tuple(torch.cat([u, w]) for u, w in zip(a, b))
                if isinstance(a, tuple) else torch.cat([a, b]))

    whole = fn(*carry, x)
    h = (x[0] if isinstance(x, tuple) else x).shape[0] // 2
    first = fn(*carry, cut(x, slice(None, h)))
    second = fn(*first[:len(carry)], cut(x, slice(h, None)))
    compare(f"{name}: two halves vs one block", (
        second[:len(carry)], cat(first[-1], second[-1])), (
        whole[:len(carry)], whole[-1]))


def control_main_path(dev, i32, wrappers):
    """Phase 4 for the Stabilizer IIR control path at c = C_CTL lanes,
    t = T, over BLOCKS blocks: `compat.sos` (K24, SOS_STAGES stages, x in
    +-2^24 as benches/suite.py:223), `compat.sos_clamp_wide` (K25,
    WIDE_STAGES clamped stages, x full range) and the config bank
    (`ConfigBank`: c `BiquadConfig`s, K27 clamped, K26 unclamped; x in
    +-2^27), half its channels retuned after the first block.  Checks: the first
    T_PREFIX rows of each compat output against the plain versions on
    those rows (the legs start from zero state each call); K24, K25 and
    K27 over two half-blocks == one block; after the retune, every channel
    against the plain K27 / K26 with the new planes on T_PREFIX rows, and
    the channels not retuned against a bank never retuned, on every row
    and state word.  Returns the launch counts of the run."""
    import torch
    from idsp_tpu_torch import compat
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.filters.biquad_cuda import (
        df1_bank_q_coef_plain, df1_clamp_bank_q_coef_plain, df1_wide_bank,
        sos_bank_q,
    )
    from idsp_tpu_torch.pipelines.config_bank import ConfigBank

    c = C_CTL
    sos_rows, wide_rows = control_rows()
    xa = [i32((T, c), -(2**24), 2**24) for _ in range(BLOCKS)]
    xb = [i32((T, c)) for _ in range(BLOCKS)]
    xc = [i32((T, c), -(2**27), 2**27) for _ in range(BLOCKS)]
    coeffs = control_configs(c, 1)
    retuned = torch.arange(0, c, 2, device=dev)
    new = control_configs(len(retuned), 2)
    banks = {clamp: ConfigBank(coeffs, clamp=clamp, device=dev)
             for clamp in (True, False)}

    reset(wrappers)
    ya = [compat.sos(sos_rows, x, device=dev) for x in xa]
    yb = [compat.sos_clamp_wide(wide_rows, x, device=dev) for x in xb]
    runs = {}
    for clamp, bank in banks.items():
        st, outs = bank.init_state(), []
        for b, x in enumerate(xc):
            if b == 1:
                bank.retune(retuned.cpu().numpy(), new)
            st, y = bank(st, x)
            outs.append((st, y))
        runs[clamp] = outs
    torch.cuda.synchronize()
    counts = launch_counts(wrappers)
    log(f"phase 4 main path: compat.sos ({SOS_STAGES} stages), "
        f"compat.sos_clamp_wide ({WIDE_STAGES} stages, clamp {WIDE_CLAMP}) "
        f"and ConfigBank (clamped and not; {len(retuned)} of {c} channels "
        f"retuned after block 0) x {BLOCKS} blocks at c={c}, t={T}; "
        f"launches {counts}")
    for name, ys in (("compat.sos", ya), ("compat.sos_clamp_wide", yb)):
        for y in ys:
            if tuple(y.shape) != (T, c) or y.dtype != torch.int32:
                raise AssertionError(f"{name}: output {y.dtype}"
                                     f"{tuple(y.shape)}")
    want_a = compat.sos(sos_rows, xa[0][:T_PREFIX].cpu(),
                        device=torch.device("cpu"))
    compare("compat.sos vs plain (prefix)", ya[0][:T_PREFIX].cpu(), want_a)
    want_b = compat.sos_clamp_wide(wide_rows, xb[0][:T_PREFIX].cpu(),
                                   device=torch.device("cpu"))
    compare("compat.sos_clamp_wide vs plain (prefix)",
            yb[0][:T_PREFIX].cpu(), want_b)
    pinned_b = pinned(yb[0], WIDE_CLAMP)
    log(f"phase 4 compat.sos and compat.sos_clamp_wide: (t, c) int32; the "
        f"first {T_PREFIX} rows == the plain versions (CPU) bit for bit; "
        f"the wide clamp pinned {pinned_b:.4f} of the outputs")

    ba_sos = biquad.quantize_ba(biquad.from_cookbook(
        sos_rows.reshape(-1, 2, 3)), 29)
    halves("sos_bank_q", lambda s, x: sos_bank_q(ba_sos, s, x, 29),
           ([biquad.df1_init((c,), device=dev)] * SOS_STAGES,), xa[1])
    halves("df1_wide_bank", lambda s, x: df1_wide_bank(
        ba_sos[0], s, x, 29, clamp=WIDE_CLAMP),
        (biquad.df1_wide_init((c,), device=dev),), xb[1])
    bank = ConfigBank(coeffs, device=dev)
    halves("ConfigBank (K27)", lambda s, x: bank(s, x), (bank.init_state(),),
           xc[0])
    log("phase 4 K24, K25 and K27: two half-blocks == one block, state and "
        "output bit for bit")

    keep = torch.arange(1, c, 2, device=dev)
    for clamp, outs in runs.items():
        ref = ConfigBank(coeffs, clamp=clamp, device=dev)
        st = ref.init_state()
        plain = (df1_clamp_bank_q_coef_plain if clamp
                 else df1_bank_q_coef_plain)
        kw = dict(zip(("u", "lo", "hi"), ref.bounds)) if clamp else {}
        for b, x in enumerate(xc):
            if b == 1:
                pre = plain(banks[clamp].planes, st_prev, x[:T_PREFIX], 29,
                            **kw)
                compare(f"ConfigBank clamp={clamp} after the retune vs plain "
                        "(prefix)", outs[1][1][:T_PREFIX], pre[1])
            st_prev = outs[b][0]
            st, y = ref(st, x)
            compare(f"ConfigBank clamp={clamp} channels not retuned, block "
                    f"{b}", (outs[b][0].x[keep], outs[b][0].y[keep],
                             outs[b][1][:, keep]),
                    (st.x[keep], st.y[keep], y[:, keep]))
            moved = float((outs[b][1][:, retuned] != y[:, retuned]).double()
                          .mean())
            if b >= 1 and moved < 0.1:
                raise AssertionError(f"ConfigBank clamp={clamp}: retuned "
                                     f"channels moved on only {moved:.3f} of "
                                     "the rows")
        pin = (f"; the clamp {ref.bounds} pinned "
               f"{pinned(outs[-1][1], ref.bounds):.4f} of the last block's "
               "outputs" if clamp else "")
        log(f"phase 4 ConfigBank clamp={clamp}: after the retune every channel"
            f" == plain {'K27' if clamp else 'K26'} with the new planes on "
            f"{T_PREFIX} rows; channels not retuned == a bank never retuned "
            f"on every row and state word over {BLOCKS} blocks; retuned "
            f"channels differ from the old filter on {moved:.4f} of the last "
            f"block's rows (> 0.1){pin}")
    return counts


def time_control(dev, i32, card, timings, plain_s):
    """Phase 6 for K24-K27 at c = C_CTL, t = T: each kernel (K25 in its
    clamped form) beside its plain version (timed in phase 3), and the
    three legs' block times."""
    import torch
    from idsp_tpu_torch import compat
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.filters.biquad_cuda import (
        df1_bank_q_coef, df1_clamp_bank_q_coef, df1_wide_bank, sos_bank_q,
    )
    from idsp_tpu_torch.pipelines.config_bank import ConfigBank
    from idsp_tpu_torch.profiling import measure_rate

    c = C_CTL
    sos_rows, wide_rows = control_rows()
    ba_sos = biquad.quantize_ba(biquad.from_cookbook(
        sos_rows.reshape(-1, 2, 3)), 29)
    bank = ConfigBank(control_configs(c, 1), device=dev)
    u, lo, hi = bank.bounds
    x = i32((T, c))
    df1 = biquad.df1_init((c,), device=dev)
    cases = {
        "sos_bank_q": (lambda s: sos_bank_q(ba_sos, s, x, 29),
                       [df1] * SOS_STAGES),
        "df1_wide_bank": (lambda s: df1_wide_bank(ba_sos[0], s, x, 29,
                                                  clamp=WIDE_CLAMP),
                          biquad.df1_wide_init((c,), device=dev)),
        "df1_bank_q_coef": (lambda s: df1_bank_q_coef(bank.planes, s, x, 29),
                            df1),
        "df1_clamp_bank_q_coef": (lambda s: df1_clamp_bank_q_coef(
            bank.planes, s, x, 29, u=u, lo=lo, hi=hi), df1),
    }
    for name, (kern, st) in cases.items():
        k_s, _ = measure_rate(kern, st, iters=20, trials=3)
        entry = {"ms": k_s * 1e3, "plain_ms": plain_s[name] * 1e3}
        note = ""
        if name in DEVICE_SYMBOLS:
            entry["device_ms"] = launch_device_ms(name, kern, st)
            note = f", device {entry['device_ms']} ms a launch"
        timings["kernels"][name] = {c: entry}
        log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms{note}, plain "
            f"{plain_s[name] * 1e3:.2f} ms (phase 3)  [{card}]")
    timings["control_samples_per_s"] = {}
    legs = {
        "compat.sos": lambda _: compat.sos(sos_rows, x, device=dev),
        "compat.sos_clamp_wide": lambda _: compat.sos_clamp_wide(
            wide_rows, x, device=dev),
        "ConfigBank": lambda _: bank(bank.init_state(), x),
    }
    for name, step in legs.items():
        sec, _ = measure_rate(step, None, iters=10, trials=3, stateful=False)
        timings["control_samples_per_s"][name] = c * T / sec
        log(f"phase 6 c={c} {name}: {sec * 1e3:.3f} ms/block, "
            f"{c * T / sec:.6e} samples/s (c*t)  [{card}]")


# ---- the biquad precision ladder (K28-K33) ----------------------------------


def precision_setup(rng, dev):
    """The ladder's filters and input makers at c = C_PREC lanes: the
    suite's lowpass at 0.1 (benches/suite.py:221) as Q16<13> (int16 x in
    +-2^14, suite.py:279-300), Q64<61> (int64 x in +-2^55, :302-315), f32
    (x ~ N(0, 1), :374-388) and Q32<29> (int32 x in +-2^24, the suite's
    ``xs_i``, for the dither rows :319-372); per-lane Q29 planes of lowpass
    filters at frequencies spread over [0.01, 0.2] for K32/K33.  Returns
    (coefficients by rung, input makers by rung, planes)."""
    import torch
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad

    lp = biquad.from_cookbook(Filter().critical_frequency(0.1).lowpass())
    ba = {"q16": biquad.quantize_ba(lp, 13, dtype=np.int16),
          "q64": biquad.quantize_ba(lp, 61, dtype=np.int64),
          "f32": lp.astype(np.float32), "q29": biquad.quantize_ba(lp, 29)}

    def ints(shape, lim, dtype):
        a = rng.integers(-lim, lim, size=shape, dtype=np.int64)
        return torch.from_numpy(a.astype(dtype)).to(dev)

    make = {
        "q16": lambda shape: ints(shape, 2**14, np.int16),
        "q64": lambda shape: ints(shape, 2**55, np.int64),
        "f32": lambda shape: torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev),
        "q29": lambda shape: ints(shape, 2**24, np.int32),
    }
    fcs = rng.uniform(0.01, 0.2, C_PREC)
    planes = torch.from_numpy(np.stack([biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(fc).lowpass()), 29)
        for fc in fcs], axis=1)).to(dev)
    return ba, make, planes


def precision_states(rng, dev, c):
    """Random carried states of each rung (phase 3 holds): x and y in the
    inputs' ranges, the dither error word in [0, 2^32), the wide words in
    +-2^55."""
    import torch
    from idsp_tpu_torch.filters import biquad

    def ints(lim, dtype, shape=(c, 2)):
        a = rng.integers(-lim, lim, size=shape, dtype=np.int64)
        return torch.from_numpy(a.astype(dtype)).to(dev)

    xy29 = biquad.Df1State(x=ints(2**24, np.int32), y=ints(2**24, np.int32))
    return {
        "q16": biquad.Df1State(x=ints(2**14, np.int16),
                               y=ints(2**14, np.int16)),
        "q64": biquad.Df1State(x=ints(2**55, np.int64),
                               y=ints(2**55, np.int64)),
        "f32": biquad.Df1State(
            x=torch.from_numpy(rng.normal(size=(c, 2)).astype(np.float32))
            .to(dev),
            y=torch.from_numpy(rng.normal(size=(c, 2)).astype(np.float32))
            .to(dev)),
        "dither": biquad.Df1DitherState(xy=xy29, e=torch.from_numpy(
            rng.integers(0, 2**32, c)).to(dev)),
        "wide": biquad.Df1WideState(x=ints(2**24, np.int32),
                                    y=ints(2**55, np.int64)),
    }


def precision_cases(ba, planes, clamp=None, shared=False):
    """name -> (kernel, plain, state key, input rung) of K28-K33; K31-K33
    with ``clamp``, K32/K33 with the shared (5,) set when ``shared``."""
    from idsp_tpu_torch.filters import biquad_cuda as bc

    p = ba["q29"] if shared else planes
    return {
        "df1_bank_q16": (lambda s, x: bc.df1_bank_q16(ba["q16"], s, x, 13),
                         lambda s, x: bc.df1_bank_q16_plain(ba["q16"], s, x,
                                                            13),
                         "q16", "q16"),
        "df1_bank_q64": (lambda s, x: bc.df1_bank_q64(ba["q64"], s, x, 61),
                         lambda s, x: bc.df1_bank_q64_plain(ba["q64"], s, x,
                                                            61),
                         "q64", "q64"),
        "df1_bank_f32": (lambda s, x: bc.df1_bank_f32(ba["f32"], s, x),
                         lambda s, x: bc.df1_bank_f32_plain(ba["f32"], s, x),
                         "f32", "f32"),
        "df1_dither_bank": (
            lambda s, x: bc.df1_dither_bank(ba["q29"], s, x, 29, clamp=clamp),
            lambda s, x: bc.df1_dither_bank_plain(ba["q29"], s, x, 29,
                                                  clamp=clamp),
            "dither", "q29"),
        "df1_wide_bank_coef": (
            lambda s, x: bc.df1_wide_bank_coef(p, s, x, 29, clamp=clamp),
            lambda s, x: bc.df1_wide_bank_coef_plain(p, s, x, 29,
                                                     clamp=clamp),
            "wide", "q29"),
        "df1_dither_bank_coef": (
            lambda s, x: bc.df1_dither_bank_coef(p, s, x, 29, clamp=clamp),
            lambda s, x: bc.df1_dither_bank_coef_plain(p, s, x, 29,
                                                       clamp=clamp),
            "dither", "q29"),
    }


def check_precision_kernels(dev, rng, errs, plain_s):
    """Phase 3 for K28-K33 at c = C_PREC lanes: each kernel against its
    plain version on one block of T rows from a random carried state,
    tolerance 0, the plain call timed (K31 unclamped, K32/K33 with per-lane
    planes); then K31-K33 clamped with CLAMP on one block, raising unless
    the clamp pinned some of their outputs, and K32/K33 with the shared
    (5,) set on T_PREFIX rows."""
    ba, make, planes = precision_setup(rng, dev)
    c = C_PREC
    for name, (kern, plain, key, rung) in precision_cases(ba,
                                                          planes).items():
        st = precision_states(rng, dev, c)[key]
        errs[name] = hold(name, kern, plain, (st,),
                          lambda: make[rung]((T, c)), plain_s, blocks=1)
    second = {**{f"{k} (clamp {CLAMP})": (v, T) for k, v in precision_cases(
        ba, planes, CLAMP).items() if "dither" in k or "coef" in k},
              **{f"{k} (shared (5,))": (v, T_PREFIX) for k, v in
                 precision_cases(ba, planes, shared=True).items()
                 if "coef" in k}}
    pins = {}
    for name, ((kern, plain, key, rung), rows) in second.items():
        st, outs = precision_states(rng, dev, c)[key], []

        def kept(s, x, kern=kern):
            out = kern(s, x)
            outs.append(out[1])
            return out

        err = hold(name, kept, plain, (st,),
                   lambda: make[rung]((rows, c)), blocks=1)
        errs[name.split()[0]] = max(errs[name.split()[0]], err)
        if "clamp" in name:
            pins[name.split()[0]] = pinned(outs[0], CLAMP)
            if not pins[name.split()[0]] > 0:
                raise AssertionError(f"{name}: the clamp pinned no output")
    for name, (kern, _, key, rung) in precision_cases(ba, planes).items():
        halves(name, kern, (precision_states(rng, dev, c)[key],),
               make[rung]((T, c)))
    names = list(precision_cases(ba, planes))
    log(f"phase 3 K28-K33 {', '.join(names)} == plain on one block (c={c}, "
        f"t={T}, the suite's inputs, random carried state; plain "
        f"{', '.join(f'{k} {plain_s[k]:.2f} s' for k in names)}); K31-K33 "
        f"clamped with {CLAMP} on one block (pinned "
        f"{', '.join(f'{k} {v:.4f}' for k, v in pins.items())}) and "
        f"K32/K33 with a shared (5,) set on {T_PREFIX} rows: max |d| "
        f"{[errs[k] for k in names]}; each over two half-blocks == one "
        "block, state and output bit for bit")


def df1_f64(ba5, xs):
    """The float64 DF1 of real coefficients ``ba5`` over ``xs`` (t, c),
    from zero state: the reference the ladder's rungs approximate."""
    import torch
    from idsp_tpu_torch.filters import biquad

    x = xs.to(torch.float64)
    st = biquad.df1_init((x.shape[1],), torch.float64, device=x.device)
    return biquad.df1_process(torch.tensor(ba5, dtype=torch.float64,
                                           device=x.device), st, x)[1]


def feedback_l1(a1, a2, n=T):
    """||h||_1 of the feedback 1 / (1 - a1 z^-1 - a2 z^-2): the most an
    error of 1 injected at every step can add up to in the output."""
    h = np.zeros(n)
    h[0] = 1.0
    for k in range(1, n):
        h[k] = a1 * h[k - 1] + (a2 * h[k - 2] if k >= 2 else 0.0)
    return float(np.abs(h).sum())


def rung_error(y, ref, ba5, lsb, u_dut, xs):
    """(max |y - ref| in output units, its bound): a truncating rung
    injects at most ``lsb`` a step, a rounding one ``u_dut`` of the step's
    terms, the float64 reference 2^-53 of them (its input, coefficients,
    five products and four sums: 12 roundings at most), each carried on by
    the feedback's ||h||_1."""
    err = float((y.double() - ref).abs().max())
    s = (float(np.abs(ba5[:3]).sum()) * float(xs.double().abs().max())
         + float(np.abs(ba5[3:]).sum()) * float(ref.abs().max()))
    bound = feedback_l1(ba5[3], ba5[4]) * (lsb + 12 * (2.0**-53 + u_dut) * s)
    return err, bound


def precision_main_path(dev, rng, wrappers):
    """Phase 4 for the precision ladder at c = C_PREC lanes, t = T, over
    BLOCKS blocks from zero state, through the port's entry points with
    the suite's inputs: K28 Q16<13>, K29 Q64<61>, K30 f32, K31 Q29 dither
    unclamped and clamped with the suite's row WIDE_CLAMP ("q32 dither",
    "q32 clamp+dither", suite.py:319-372), K32 and K33 with per-lane
    planes; the launch counts read, then K32/K33 once with the shared (5,)
    set (== K25 / K31, their static twins, on every word), a check whose
    launches are not counted.  Checks: outputs of the expected dtype and
    shape, f32 finite; each rung against the float64 DF1 of its own
    coefficients on the first T_PREFIX rows of block 0, within the bound of
    `rung_error`.  Returns the launch counts of the run."""
    import torch
    from idsp_tpu_torch.filters import biquad
    from idsp_tpu_torch.filters import biquad_cuda as bc

    c = C_PREC
    ba, make, planes = precision_setup(rng, dev)
    xb = {k: [m((T, c)) for _ in range(BLOCKS)] for k, m in make.items()}
    init = {
        "q16": lambda: biquad.df1_init((c,), torch.int16, device=dev),
        "q64": lambda: biquad.df1_init((c,), torch.int64, device=dev),
        "f32": lambda: biquad.df1_init((c,), torch.float32, device=dev),
        "dither": lambda: biquad.df1_dither_init((c,), device=dev),
        "wide": lambda: biquad.df1_wide_init((c,), device=dev),
    }
    legs = {**precision_cases(ba, planes),
            "df1_dither_bank (clamped)": precision_cases(
                ba, planes, WIDE_CLAMP)["df1_dither_bank"]}
    reset(wrappers)
    runs = {}
    for name, (kern, _, key, rung) in legs.items():
        st, outs = init[key](), []
        for x in xb[rung]:
            st, y = kern(st, x)
            outs.append(y)
        runs[name] = outs
    shared = precision_cases(ba, planes, shared=True)
    twins = {
        "df1_wide_bank_coef": lambda s, x: bc.df1_wide_bank(ba["q29"], s, x,
                                                            29),
        "df1_dither_bank_coef": lambda s, x: bc.df1_dither_bank(ba["q29"], s,
                                                                x, 29)}
    torch.cuda.synchronize()
    counts = launch_counts(wrappers)
    for name, twin in twins.items():
        kern, _, key, rung = shared[name]
        compare(f"{name} (shared (5,)) vs its static twin",
                kern(init[key](), xb[rung][0]), twin(init[key](), xb[rung][0]))
    log(f"phase 4 main path: the precision ladder (Q16<13>, Q64<61>, f32, "
        f"Q29 dither unclamped and clamped {WIDE_CLAMP}, K32/K33 per-lane) x "
        f"{BLOCKS} blocks at c={c}, t={T}; launches {counts}; then K32/K33 "
        "with a shared (5,) set == K25 / K31 on one block")
    want = {"df1_bank_q16": torch.int16, "df1_bank_q64": torch.int64,
            "df1_bank_f32": torch.float32}
    for name, outs in runs.items():
        dt = want.get(name.split()[0], torch.int32)
        for y in outs:
            if y.dtype != dt or tuple(y.shape) != (T, c):
                raise AssertionError(f"{name}: output {y.dtype}"
                                     f"{tuple(y.shape)}")
        if dt == torch.float32 and not bool(torch.isfinite(
                torch.stack(outs)).all()):
            raise AssertionError(f"{name}: non-finite output")
    # each rung against the float64 DF1 of its own coefficients
    scaled = {"df1_bank_q16": (ba["q16"].astype(np.float64) / 2.0**13, 1.0,
                               0.0, "q16"),
              "df1_bank_q64": (ba["q64"].astype(np.float64) / 2.0**61, 1.0,
                               0.0, "q64"),
              "df1_bank_f32": (ba["f32"].astype(np.float64), 0.0, 2.0**-24,
                               "f32"),
              "df1_dither_bank": (ba["q29"].astype(np.float64) / 2.0**29, 1.0,
                                  0.0, "q29")}
    ref_errs = {}
    for name, (ba5, lsb, u_dut, rung) in scaled.items():
        xs = xb[rung][0][:T_PREFIX]
        ref = df1_f64(ba5, xs)
        err, bound = rung_error(runs[name][0][:T_PREFIX], ref, ba5, lsb,
                                u_dut, xs)
        if not err <= bound:
            raise AssertionError(f"{name}: max |y - float64 DF1| {err} > "
                                 f"{bound}")
        ref_errs[name] = (err, bound)
    log("phase 4 precision ladder vs the float64 DF1 of each rung's "
        f"coefficients, first {T_PREFIX} rows of block 0 (max |d| in output "
        "units <= bound): " + ", ".join(
            f"{k} {e:.6g} <= {b:.6g}" for k, (e, b) in ref_errs.items())
        + f"; the suite's clamp {WIDE_CLAMP} pinned "
        f"{pinned(torch.stack(runs['df1_dither_bank (clamped)']), WIDE_CLAMP):.4f}"
        " of the clamped dither outputs")
    return counts


def time_precision(dev, rng, card, timings, plain_s):
    """Phase 6 for K28-K33 at c = C_PREC, t = T, the suite's inputs: each
    kernel (K31 unclamped, K32/K33 per-lane) beside its plain version
    (timed in phase 3), each also by its profiler spans
    (`launch_device_ms`);
    K31 clamped with the suite's row, and K32/K33 with the shared (5,)
    set, on the log only."""
    from idsp_tpu_torch.profiling import measure_rate

    c = C_PREC
    ba, make, planes = precision_setup(rng, dev)
    states = precision_states(rng, dev, c)
    x = {k: make[k]((T, c)) for k in make}
    for name, (kern, _, key, rung) in precision_cases(ba, planes).items():
        k_s, _ = measure_rate(kern, states[key], x[rung], iters=20, trials=3)
        timings["kernels"][name] = {c: {"ms": k_s * 1e3,
                                        "plain_ms": plain_s[name] * 1e3}}
        note = ""
        if name in DEVICE_SYMBOLS:
            dev_ms = launch_device_ms(name, lambda s, kern=kern, rung=rung:
                                      kern(s, x[rung]), states[key])
            timings["kernels"][name][c]["device_ms"] = dev_ms
            note = f", device {dev_ms} ms a launch (profiler spans)"
        log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms{note}, plain "
            f"{plain_s[name] * 1e3:.2f} ms (phase 3)  [{card}]")
    extra = {"df1_dither_bank (clamped)": precision_cases(
        ba, planes, WIDE_CLAMP)["df1_dither_bank"]}
    extra.update({f"{k} (shared (5,))": v for k, v in precision_cases(
        ba, planes, shared=True).items() if "coef" in k})
    for name, (kern, _, key, rung) in extra.items():
        k_s, _ = measure_rate(kern, states[key], x[rung], iters=20, trials=3)
        log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms  [{card}]")


# ---- the filter structures (K34-K40) ----------------------------------------


def structure_setup():
    """The structure rows' coefficients: the SVF's (f, qi), the normal
    form's Q29 and float (b, p), the RPLL's config, and the WDF pairs'
    branches as lists of (tpas, a) stages."""
    from idsp_tpu_torch import fxp
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import normal, rpll, svf, wdf

    def stages(spec):
        return [(wdf.nibbles(m, n), wdf.quantize(wdf.nibbles(m, n), g))
                for m, n, g in spec]

    b, p = normal.from_cookbook(
        Filter().critical_frequency(NORMAL_FC).lowpass())
    return {"svf": svf.coefficients(*SVF_ROW),
            "normal_q": (fxp.from_float(b, 29), fxp.from_float(p, 29)),
            "normal_f32": (b, p), "rpll": rpll.RpllConfig(*RPLL_ROW),
            "ca7": tuple(stages(br) for br in WDF_CA7),
            "ca19": tuple(stages(br) for br in WDF_CA19)}


def structure_inputs(rng, dev, c):
    """Input makers by kind, each of ``rows``: x ~ N(0, 1) f32, x uniform
    in +-2^24 int32, and the RPLL row's full-range int32 timestamps with
    a timestamp in 1 of 64 cycles (benches/suite.py:540-549)."""
    import torch

    def i32(rows, lim=2**31):
        return torch.from_numpy(rng.integers(-lim, lim, size=(rows, c))
                                .astype(np.int32)).to(dev)

    return {
        "f32": lambda rows: torch.from_numpy(
            rng.normal(size=(rows, c)).astype(np.float32)).to(dev),
        "i24": lambda rows: i32(rows, 2**24),
        "rpll": lambda rows: (i32(rows), torch.from_numpy(
            rng.integers(0, 64, size=(rows, c)) == 0).to(dev)),
    }


def structure_state(key, c, dev, rng=None):
    """A state of the structure ``key``: zero, or random in the inputs'
    ranges with ``rng`` (phase 3's carried states)."""
    import torch
    from idsp_tpu_torch.filters import biquad, rpll, svf, wdf

    def ints(shape, lim=2**24):
        if rng is None:
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        return torch.from_numpy(rng.integers(-lim, lim, size=shape)
                                .astype(np.int32)).to(dev)

    def floats(shape):
        if rng is None:
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    def chain(spec):
        return [wdf.WdfState(z=ints((c, n))) for _, n, _ in spec]

    if key == "svf":
        return svf.SvfState(*(floats((c,)) for _ in range(3)))
    if key == "normal_q":
        return biquad.Df1State(x=ints((c, 2)), y=ints((c, 2)))
    if key == "normal_f32":
        return biquad.Df1State(x=floats((c, 2)), y=floats((c, 2)))
    if key == "rpll":
        return rpll.RpllState(*(ints((c,), 2**31) for _ in range(4)))
    if key == "wdf_bank":
        return chain(WDF_CA7[0][:1])[0]
    if key == "ca19_0":
        return chain(WDF_CA19[0])
    spec = WDF_CA7 if key == "ca7" else WDF_CA19
    return tuple(chain(br) for br in spec)


def structure_cases(k, output="lp"):
    """name -> (kernel, plain, state key, input kind, rows of each carried
    block of the plain check) of K34-K40, each called as ``fn(state, x)``;
    K40 over wdf-ca-19 (``wdf_pair_bank``) and wdf-ca-7
    (``wdf_pair_bank_ca7``).  K39/K40's plain versions take tens of
    seconds a block (4 torch ops an adapter a row): their first block is
    T_PREFIX rows, their second a full one."""
    from idsp_tpu_torch.filters.normal_cuda import (
        normal_bank_f32, normal_bank_f32_plain, normal_bank_q,
        normal_bank_q_plain,
    )
    from idsp_tpu_torch.filters.rpll_cuda import rpll_bank, rpll_bank_plain
    from idsp_tpu_torch.filters.svf_cuda import svf_bank, svf_bank_plain
    from idsp_tpu_torch.filters.wdf_cuda import (
        wdf_bank, wdf_bank_plain, wdf_chain_bank, wdf_chain_bank_plain,
        wdf_pair_bank, wdf_pair_bank_plain,
    )

    f, qi = k["svf"]
    bq, pq = k["normal_q"]
    b, p = k["normal_f32"]
    cfg = k["rpll"]
    (tp, a), = k["ca7"][0][:1]
    return {
        "svf_bank": (
            lambda s, x: svf_bank(f, qi, s, x, output=output),
            lambda s, x: svf_bank_plain(f, qi, s, x, output=output),
            "svf", "f32", (T, T)),
        "normal_bank_q": (
            lambda s, x: normal_bank_q(bq, pq, s, x, 29),
            lambda s, x: normal_bank_q_plain(bq, pq, s, x, 29),
            "normal_q", "i24", (T, T)),
        "normal_bank_f32": (
            lambda s, x: normal_bank_f32(b, p, s, x),
            lambda s, x: normal_bank_f32_plain(b, p, s, x),
            "normal_f32", "f32", (T, T)),
        "rpll_bank": (
            lambda s, xv: rpll_bank(cfg, s, *xv),
            lambda s, xv: rpll_bank_plain(cfg, s, *xv), "rpll", "rpll", (T, T)),
        "wdf_bank": (
            lambda s, x: wdf_bank(tp, a, s, x),
            lambda s, x: wdf_bank_plain(tp, a, s, x), "wdf_bank", "i24", (T, T)),
        "wdf_chain_bank": (
            lambda s, x: wdf_chain_bank(k["ca19"][0], s, x),
            lambda s, x: wdf_chain_bank_plain(k["ca19"][0], s, x), "ca19_0",
            "i24", (T_PREFIX, T)),
        "wdf_pair_bank": (
            lambda s, x: wdf_pair_bank(*k["ca19"], s, x),
            lambda s, x: wdf_pair_bank_plain(*k["ca19"], s, x), "ca19",
            "i24", (T_PREFIX, T)),
        "wdf_pair_bank_ca7": (
            lambda s, x: wdf_pair_bank(*k["ca7"], s, x),
            lambda s, x: wdf_pair_bank_plain(*k["ca7"], s, x), "ca7", "i24",
            (T_PREFIX, T)),
    }


def check_structure_kernels(dev, rng, errs, plain_s):
    """Phase 3 for K34-K40 at c = C_STRUCT lanes: each kernel against its
    plain version over 2 carried blocks from a random state (K39/K40's
    first of T_PREFIX rows, the others of T), tolerance 0, each plain call
    over T rows timed; the SVF's hp, bp and br outputs on T_PREFIX rows
    each; then each kernel over two half-blocks against one block of T
    rows; then `check_wdf_plans`."""
    c = C_STRUCT
    k = structure_setup()
    make = structure_inputs(rng, dev, c)
    cases = structure_cases(k)
    for name, (kern, plain, key, kind, rows) in cases.items():
        sizes = iter(rows)
        errs[name] = hold(name, kern, plain,
                          (structure_state(key, c, dev, rng),),
                          lambda: make[kind](next(sizes)), plain_s,
                          blocks=len(rows))
    for out in ("hp", "bp", "br"):
        kern, plain, key, kind, _ = structure_cases(k, out)["svf_bank"]
        errs["svf_bank"] = max(errs["svf_bank"], hold(
            f"svf_bank ({out})", kern, plain,
            (structure_state(key, c, dev, rng),),
            lambda: make[kind](T_PREFIX), blocks=1))
    for name, (kern, _, key, kind, _) in cases.items():
        halves(name, kern, (structure_state(key, c, dev, rng),),
               make[kind](T))
    errs["wdf_pair_bank"] = max(errs["wdf_pair_bank"],
                                errs.pop("wdf_pair_bank_ca7"),
                                check_wdf_plans(dev, rng, k, make))
    log(f"phase 3 K34-K40 {', '.join(cases)} == plain over 2 carried blocks "
        f"(c={c}, random state; t={T}, K39/K40's first {T_PREFIX} rows; "
        f"plain over {T} rows "
        f"{', '.join(f'{n} {plain_s[n]:.2f} s' for n in cases)}); the SVF's "
        f"hp, bp, br on {T_PREFIX} rows: max |d| "
        f"{[errs[n] for n in cases if n in errs]}; each over two half-blocks "
        f"== one block of {T}, state and output bit for bit")


def check_wdf_plans(dev, rng, k, make):
    """Phase 3 for the WDF kernel off the suite's plans, at c = C_STRUCT
    lanes on T_PREFIX rows from a random state against the plain version,
    bit for bit: a chain of one stage of every adapter type (WDF_EVERY,
    the generic loop), wdf-ca-19 with every stage on the generic loop and
    at a chunk of WDF_SMALL_CHUNK rows.  Logs each launch's plan (the
    suite's K38-K40 too) on a line of its own.  Returns the largest
    |d|."""
    import torch
    from idsp_tpu_torch.filters import wdf, wdf_cuda

    c = C_STRUCT
    every = [wdf.Tpa(t) for t, _ in WDF_EVERY]
    runs = {
        "generic stage (every type)": (
            [[(every, wdf.quantize(every, [g for _, g in WDF_EVERY]))]], {}),
        "wdf-ca-19 generic loop": (list(k["ca19"]), {"generic": True}),
        f"wdf-ca-19 chunk {WDF_SMALL_CHUNK}": (
            list(k["ca19"]), {"chunk": WDF_SMALL_CHUNK}),
    }
    plans = {name: wdf_cuda.launch_plan([[tp for tp, _ in br]
                                         for br in branches])
             for name, branches in (("K38 wdf-ca-7's first chain",
                                     [k["ca7"][0][:1]]),
                                    ("K39 wdf-ca-19's branch 0",
                                     [k["ca19"][0]]),
                                    ("K40 wdf-ca-7", list(k["ca7"])),
                                    ("K40 wdf-ca-19", list(k["ca19"])))}
    err = 0.0
    for name, (branches, kw) in runs.items():
        plan = plans[name] = wdf_cuda.launch_plan(
            [[tp for tp, _ in br] for br in branches], **kw)
        sts = [[wdf.WdfState(z=torch.from_numpy(rng.integers(
            -(2**24), 2**24, size=(c, len(tp))).astype(np.int32)).to(dev))
                for tp, _ in br] for br in branches]
        x = make["i24"](T_PREFIX)
        new, ys = wdf_cuda._launch(name, branches, sts, x, plan=plan)
        if len(branches) == 2:
            got = ((new[0], new[1]), tuple(ys))
            want = wdf_cuda.wdf_pair_bank_plain(*branches, tuple(sts), x)
        else:
            got = (new[0], ys[0])
            want = wdf_cuda.wdf_chain_bank_plain(branches[0], sts[0], x)
        err = max(err, compare(name, got, want))
    log("phase 3 WDF plans (warps a block with the loader and store "
        "warps; stage kinds, 0 the generic loop; chunk rows x ring depth; "
        "shared memory): " + "; ".join(
            f"{n}: {p.warps} warps, kinds {p.kinds}, {p.chunk} x {p.depth}, "
            f"{p.smem} B" for n, p in plans.items()))
    log(f"phase 3 WDF off the suite's plans ({', '.join(runs)}) == plain on "
        f"{T_PREFIX} rows at c={c}, random state: max |d| {err}")
    return err


def rpll_scenario(dt2, period, first, noise, rows, c, rng):
    """The reference's timestamp harness (tests/test_loops.py:210-232,
    rpll.rs:105-173), one stream a lane, vectorized across lanes: lane 0's
    first timestamp the test's ``first``, every other lane's uniform in
    [0, period), each lane with its own noise draws.  Returns (xs (rows, c)
    int32, valids bool, the int32 phase t - nxt of each row)."""
    nxt = rng.integers(0, period, size=c).astype(np.int32)
    nxt[0] = first
    nxt_noisy = nxt.copy()
    xs = np.zeros((rows, c), np.int32)
    valids = np.zeros((rows, c), bool)
    dphase = np.zeros((rows, c), np.int32)
    step = np.int32(period)
    for i in range(rows):
        tt = np.array(i << dt2, np.int64).astype(np.int32)
        hit = (tt - nxt_noisy) >= 0
        nxt = np.where(hit, nxt + step, nxt)
        xs[i] = np.where(hit, nxt_noisy, 0)
        valids[i] = hit
        jitter = (rng.integers(-noise, noise + 1, size=c).astype(np.int32)
                  if noise else np.int32(0))
        nxt_noisy = np.where(hit, nxt + jitter, nxt_noisy)
        dphase[i] = tt - nxt
    return xs, valids, dphase


def rpll_ratios(phase, freq, dphase, dt2, period, limits, w0, n):
    """Per lane, the reference's four statistics (tests/test_loops.py:
    235-259) over rows w0..w0 + n, each as |value| / limit: (4, c)."""
    import torch

    ys = phase[w0:w0 + n].to(torch.int64)
    fs = freq[w0:w0 + n].to(torch.int64)
    y_ref = dphase[w0:w0 + n].double() * 2.0**32 / period
    y_err = (ys.double() - y_ref) / 2.0**32
    y_err -= torch.round(y_err)
    f_err = (((fs & 0xFFFFFFFF).double() * period - 2.0 ** (32 + dt2))
             / 2.0 ** (32 + dt2))
    stats = torch.stack([f_err.mean(0), f_err.std(0, unbiased=False) / n**0.5,
                         y_err.mean(0), y_err.std(0, unbiased=False) / n**0.5])
    return stats.abs() / torch.tensor(limits, dtype=torch.float64,
                                      device=stats.device)[:, None]


def rpll_gates(name, phase, freq, dphase, dt2, sf, sp, period, limits, n):
    """The reference's gates on each lane of a scenario.  Lane 0, which
    starts at the test's first timestamp, is measured as the test measures
    it: n rows after the t_settle = 2^(sf-dt2+4) + 2^(sp-dt2+4) rows of
    the formula.  Every lane is measured n rows after 2 t_settle: with its
    own first timestamp the loop, starting from f = 0, may take longer to
    acquire, and the readings of all lanes at t_settle are logged to show
    how many.  Raises unless both hold; returns the log text."""
    settle = (1 << (sf - dt2 + 4)) + (1 << (sp - dt2 + 4))
    at1, at2 = (rpll_ratios(phase, freq, dphase, dt2, period, limits,
                            k * settle, n) for k in (1, 2))
    if not (bool((at1[:, 0] <= 1).all()) and bool((at2 <= 1).all())):
        raise AssertionError(
            f"RPLL {name}: lane 0 at t_settle |stat| / limit "
            f"{at1[:, 0].tolist()}; lanes over the limits at 2 t_settle "
            f"{(at2 > 1).sum(dim=1).tolist()}")

    def worst(r):
        return [f"{v:.3f}" for v in r.max(dim=1).values.tolist()]

    return (f"lane 0 (first timestamp of the test) over rows {settle}.."
            f"{settle + n}: |stat| / limit {worst(at1[:, :1])}; every lane "
            f"over rows {2 * settle}..{2 * settle + n}: worst {worst(at2)}; "
            f"every lane at rows {settle}..{settle + n} (logged): worst "
            f"{worst(at1)}, lanes over {(at1 > 1).sum(dim=1).tolist()}")


def spectra(v, skip=0):
    """|rfft| along time of (t, c) rows from ``skip`` on, Hann-windowed,
    float64."""
    import torch

    x = v[skip:].double()
    w = torch.hann_window(x.shape[0], periodic=False, dtype=torch.float64,
                          device=x.device)[:, None]
    return torch.fft.rfft(x * w, dim=0).abs()


def structure_gates(dev, k, x, runs):
    """Phase 4's checks of the structures (after the counts are read; the
    extra SVF block launches K34 outside the counted window).  Returns the
    log text."""
    import torch
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad, svf
    from idsp_tpu_torch.filters.svf_cuda import svf_bank

    c = C_STRUCT
    notes = []
    # SVF: br == hp + lp bit for bit; the spectral gates at the test's
    # corner (tests/test_structures.py:11-32)
    for i in range(BLOCKS):
        compare("svf br == hp + lp", runs["svf br"][i],
                runs["svf hp"][i] + runs["svf lp"][i])
    f, qi = svf.coefficients(*SVF_GATE)
    xg = x["f32"][0]
    _, lp = svf_bank(f, qi, svf.init((c,), device=dev), xg)
    ratio = spectra(lp) / spectra(xg).clamp(min=1e-9)
    n = ratio.shape[0]
    hi = ratio[int(0.3 * n):].mean(0)
    lo = ratio[1:int(0.02 * n)].mean(0)
    if not (bool((hi < 0.1).all()) and bool(((lo > 0.5) & (lo < 1.5)).all())):
        raise AssertionError(f"SVF gates: high band max {float(hi.max())}, "
                             f"low band {float(lo.min())}..{float(lo.max())}")
    notes.append(f"SVF br == hp + lp on {BLOCKS} blocks; at f0 {SVF_GATE[0]}, "
                 f"Q 1/sqrt(2) high-band gain max {float(hi.max()):.4f} < 0.1, "
                 f"low-band {float(lo.min()):.3f}..{float(lo.max()):.3f} in "
                 "(0.5, 1.5)")
    # normal form: the spectral match against the f32 DF1 of the same
    # cookbook filter (tests/test_structures.py:35-59), per lane
    ba5 = torch.from_numpy(biquad.from_cookbook(Filter().critical_frequency(
        NORMAL_FC).lowpass()).astype(np.float32)).to(dev)
    for key, kind in (("normal q29", "i24"), ("normal f32", "f32")):
        xs = x[kind][0][:T_PREFIX].float()
        _, yd = biquad.df1_process(ba5, biquad.df1_init(
            (c,), torch.float32, device=dev), xs)
        ratio = ((spectra(runs[key][0][:T_PREFIX], 200) + 1e-9)
                 / (spectra(yd, 200) + 1e-9))
        med = ratio.median(dim=0).values
        dev_med = (ratio / med - 1.0).abs().median(dim=0).values
        if not bool((dev_med < 0.2).all()):
            raise AssertionError(f"{key}: spectral mismatch vs the f32 DF1 "
                                 f"{float(dev_med.max())}")
        notes.append(f"{key} vs the f32 DF1: median |ratio/median - 1| max "
                     f"{float(dev_med.max()):.4f} < 0.2")
    # RPLL: the reference's scenarios, one stream a lane
    for name, (cfg, period, _, _, limits, nrows) in RPLL_SCENARIOS.items():
        ph, fr, dph = runs[f"rpll {name}"]
        notes.append(f"RPLL {name} on {c} lanes: " + rpll_gates(
            name, ph, fr, dph, *cfg, period, limits, nrows))
    # WDF allpasses (tests/test_structures.py:62-77), per lane
    for key in ("wdf_bank", "wdf_chain_bank"):
        ratio = (spectra(runs[key][0], 512)[10:-10]
                 / spectra(x["i24"][0], 512)[10:-10].clamp(min=1.0))
        med = ratio.median(dim=0).values
        if not bool(((med - 1).abs() < 0.05).all()):
            raise AssertionError(f"{key}: not an allpass, median |H| "
                                 f"{float(med.min())}..{float(med.max())}")
        notes.append(f"{key} allpass: median |H| {float(med.min()):.4f}.."
                     f"{float(med.max()):.4f}")
    # wdf-ca-7: the complementary half-band (tests/test_structures.py:
    # 80-114), per lane
    lp, hp = runs["wdf-ca-7"][0]
    sl, sh = spectra(lp, 512) ** 2, spectra(hp, 512) ** 2
    sx = spectra(x["i24"][0], 512) ** 2
    m = sl.shape[0]
    low_ok = sl[:m // 4].sum(0) > 10 * sl[3 * m // 4:].sum(0)
    high_ok = sh[3 * m // 4:].sum(0) > 2 * sh[:m // 4].sum(0)
    total = ((sl + sh)[10:m - 10] / (4 * sx[10:m - 10]).clamp(min=1.0)
             ).median(dim=0).values
    if not (bool(low_ok.all()) and bool(high_ok.all())
            and bool(((total - 1).abs() < 0.1).all())):
        raise AssertionError("wdf-ca-7: half-band gates failed")
    notes.append(f"wdf-ca-7 half-band gates on {c} lanes, |L|^2 + |H|^2 over "
                 f"4|X|^2 median {float(total.min()):.4f}.."
                 f"{float(total.max()):.4f}")
    # wdf-ca-19: lane 0's impulse response (tests/test_structures.py:
    # 150-200)
    h = runs["wdf-ca-19"][0][0][:4096, 0].double() / (1 << 28)
    mag = torch.fft.rfft(h).abs()
    fq = torch.linspace(0, 0.5, mag.shape[0], dtype=torch.float64,
                        device=dev)
    pb, sb = mag[fq < 0.20], mag[fq > 0.30]
    gates = (abs(float(mag[0]) - 1.0), 20 * float(torch.log10(pb.max())),
             20 * float(torch.log10(pb.min())),
             20 * float(torch.log10(sb.max())))
    if not (gates[0] < 1e-5 and gates[1] < 1e-5 and gates[2] > -1e-5
            and gates[3] < -75.0):
        raise AssertionError(f"wdf-ca-19 response gates: {gates}")
    notes.append(f"wdf-ca-19 lane 0: |DC - 1| {gates[0]:.3g} < 1e-5, ripple "
                 f"{gates[2]:.3g}..{gates[1]:.3g} dB within 1e-5, stopband "
                 f"{gates[3]:.2f} dB < -75")
    return "; ".join(notes)


def structures_main_path(dev, rng, wrappers):
    """Phase 4 for the structures at c = C_STRUCT lanes, t = T, BLOCKS
    carried blocks from zero state through the port's entry points: the
    SVF row (x ~ N(0, 1)) with each of its four outputs, the normal form
    in Q29 (x in +-2^24) and f32 (N(0, 1)), the RPLL row (full-range
    timestamps, 1 in 64 valid) and the reference's default and wide-fast
    scenarios, K38 (wdf-ca-7's first chain), K39 (wdf-ca-19's branch 0),
    K40 over wdf-ca-7 and over wdf-ca-19 with an impulse on lane 0 (x in
    +-2^24 on the rest).  Checks (after the counts are read):
    `structure_gates`, and every output of the expected dtype and shape,
    the floats finite.  Returns the launch counts of the run."""
    import torch
    from idsp_tpu_torch.filters import biquad, rpll, svf, wdf
    from idsp_tpu_torch.filters.normal_cuda import (
        normal_bank_f32, normal_bank_q,
    )
    from idsp_tpu_torch.filters.rpll_cuda import rpll_bank
    from idsp_tpu_torch.filters.svf_cuda import OUTPUTS, svf_bank
    from idsp_tpu_torch.filters.wdf_cuda import (
        wdf_bank, wdf_chain_bank, wdf_pair_bank,
    )

    c = C_STRUCT
    k = structure_setup()
    make = structure_inputs(rng, dev, c)
    x = {kind: [m(T) for _ in range(BLOCKS)] for kind, m in make.items()}
    impulse = [v.clone() for v in x["i24"]]
    for v in impulse:
        v[:, 0] = 0
    impulse[0][0, 0] = 1 << 27
    scen = {}
    for name, ((dt2, _, _), period, first, noise, _, _) in \
            RPLL_SCENARIOS.items():
        xs, valids, dph = rpll_scenario(dt2, period, first, noise,
                                        BLOCKS * T, c, rng)
        scen[name] = (torch.from_numpy(xs).to(dev),
                      torch.from_numpy(valids).to(dev),
                      torch.from_numpy(dph).to(dev))
    f, qi = k["svf"]
    (tp, a), = k["ca7"][0][:1]
    legs = {f"svf {o}": (lambda s, v, o=o: svf_bank(f, qi, s, v, output=o),
                         lambda: svf.init((c,), device=dev), x["f32"])
            for o in OUTPUTS}
    legs.update({
        "normal q29": (lambda s, v: normal_bank_q(*k["normal_q"], s, v, 29),
                       lambda: biquad.df1_init((c,), device=dev), x["i24"]),
        "normal f32": (lambda s, v: normal_bank_f32(*k["normal_f32"], s, v),
                       lambda: biquad.df1_init((c,), torch.float32,
                                               device=dev), x["f32"]),
        "rpll row": (lambda s, v: rpll_bank(k["rpll"], s, *v),
                     lambda: rpll.init((c,), device=dev), x["rpll"]),
        "wdf_bank": (lambda s, v: wdf_bank(tp, a, s, v),
                     lambda: wdf.init(len(tp), (c,), device=dev), x["i24"]),
        "wdf_chain_bank": (
            lambda s, v: wdf_chain_bank(k["ca19"][0], s, v),
            lambda: [wdf.init(len(t_), (c,), device=dev)
                     for t_, _ in k["ca19"][0]], x["i24"]),
        "wdf-ca-7": (lambda s, v: wdf_pair_bank(*k["ca7"], s, v),
                     lambda: tuple([wdf.init(len(t_), (c,), device=dev)
                                    for t_, _ in br] for br in k["ca7"]),
                     x["i24"]),
        "wdf-ca-19": (lambda s, v: wdf_pair_bank(*k["ca19"], s, v),
                      lambda: tuple([wdf.init(len(t_), (c,), device=dev)
                                     for t_, _ in br] for br in k["ca19"]),
                      impulse),
    })
    for name, (cfg, *_) in RPLL_SCENARIOS.items():
        xs, valids, _ = scen[name]
        legs[f"rpll {name}"] = (
            lambda s, v, cfg=rpll.RpllConfig(*cfg): rpll_bank(cfg, s, *v),
            lambda: rpll.init((c,), device=dev),
            [(xs[i * T:(i + 1) * T], valids[i * T:(i + 1) * T])
             for i in range(BLOCKS)])
    reset(wrappers)
    runs = {}
    for name, (fn, init, blocks) in legs.items():
        st, runs[name] = init(), []
        for v in blocks:
            st, y = fn(st, v)
            runs[name].append(y)
    torch.cuda.synchronize()
    counts = launch_counts(wrappers)
    for name, outs in runs.items():
        for y in leaves(outs):
            want = torch.float32 if name.startswith(("svf", "normal f32")) \
                else torch.int32
            if y.dtype != want or tuple(y.shape) != (T, c):
                raise AssertionError(f"{name}: output {y.dtype}"
                                     f"{tuple(y.shape)}")
            if y.dtype == torch.float32 and not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{name}: non-finite output")
    for name in RPLL_SCENARIOS:
        ph, fr = (torch.cat(v) for v in zip(*runs[f"rpll {name}"]))
        runs[f"rpll {name}"] = (ph, fr, scen[name][2])
    log(f"phase 4 main path: the structures ({', '.join(legs)}) x {BLOCKS} "
        f"blocks at c={c}, t={T}; launches {counts}")
    log(f"phase 4 structure gates: {structure_gates(dev, k, x, runs)}")
    return counts


def time_structures(dev, rng, card, timings, plain_s):
    """Phase 6 for K34-K40 at c = C_STRUCT, t = T: each kernel beside its
    plain version (timed in phase 3) and its rate in c*t samples/s, each
    also by its profiler spans (`launch_device_ms`); K40 over wdf-ca-7 on
    the log only."""
    from idsp_tpu_torch.profiling import measure_rate

    c = C_STRUCT
    make = structure_inputs(rng, dev, c)
    for name, (kern, _, key, kind, _) in structure_cases(
            structure_setup()).items():
        st, x = structure_state(key, c, dev, rng), make[kind](T)
        k_s, _ = measure_rate(kern, st, x, iters=20, trials=3)
        timings["kernels"][name] = {c: {
            "ms": k_s * 1e3, "plain_ms": plain_s[name] * 1e3}}
        note = ""
        if name in DEVICE_SYMBOLS:
            dev_ms = launch_device_ms(name, lambda s: kern(s, x), st)
            timings["kernels"][name][c]["device_ms"] = dev_ms
            note = f", device {dev_ms} ms a launch (profiler spans)"
        log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms{note} "
            f"({c * T / k_s:.4g} samples/s), plain {plain_s[name] * 1e3:.2f} "
            f"ms (phase 3)  [{card}]")


def par_input(dev, seed, shape, dtype, lo=None, hi=None):
    """A seeded input on the card, the same in every process: int32 in
    [lo, hi), or a float ~ N(0, 1)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)
    return torch.randn(shape, generator=gen, device=dev, dtype=dtype)


def relay_inputs(dev):
    """(ba, state, xs) of the relay leg: tests/test_sp_relay.py:18-35 at
    C_PAR lanes and t = T."""
    import torch
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad

    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.05).lowpass()), 29)
    st = biquad.Df1State(
        x=par_input(dev, PAR_SEED + 21, (C_PAR, 2), torch.int32, -(2**20),
                    2**20),
        y=par_input(dev, PAR_SEED + 22, (C_PAR, 2), torch.int32, -(2**20),
                    2**20))
    xs = par_input(dev, PAR_SEED + 20, (T, C_PAR), torch.int32, -(2**24),
                   2**24)
    return ba, st, xs


def pipeline_inputs(dev):
    """(stage coefficients, blocks) of the pipeline leg:
    tests/test_pipeline_parallel.py:17-26 at C_PAR lanes, PIPE_NB blocks
    of T / PIPE_NB rows."""
    import torch
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad

    bas = np.stack([biquad.quantize_ba(biquad.from_cookbook(
        Filter().critical_frequency(fc).lowpass()), 29) for fc in PIPE_FCS])
    return bas, par_input(dev, PAR_SEED + 40, (PIPE_NB, T // PIPE_NB, C_PAR),
                          torch.int32, -(2**24), 2**24)


def scale_out_rank(rank, port, refs_ready, results):
    """A rank of phase 4 (scale-out); sends (rank, result) or (rank,
    traceback) to ``results``."""
    import traceback

    try:
        results.put((rank, _scale_out_rank(rank, port, refs_ready)))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def _event_ms(fn):
    """CUDA-event milliseconds of one call that ends synchronized."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _k41_holds(dev, g, g1, rank):
    """K41 against its plain version (the gloo ring on CPU copies of the
    same blocks), 3 blocks back to back on the same slots, at every h of
    HALO_HS in int32 and f32; on rank 0 also the ring of one.  Returns the
    largest |d|."""
    import torch
    from idsp_tpu_torch.parallel.halo_rdma import halo_exchange_prev_rdma

    rows = slice(rank * T_LOC, (rank + 1) * T_LOC)
    err = 0.0
    for dtype in (torch.int32, torch.float32):
        for h in HALO_HS:
            for b in range(BLOCKS):
                x = par_input(dev, PAR_SEED + b, (T, C_PAR), dtype, -(2**30),
                              2**30)[rows]
                got = halo_exchange_prev_rdma(x, g, h, fill=HALO_FILL)
                want = halo_exchange_prev_rdma(x.cpu(), g, h, fill=HALO_FILL)
                err = max(err, compare(f"K41 {dtype} h={h}", got.cpu(), want))
            if rank == 0:  # the ring of one: all fill
                got = halo_exchange_prev_rdma(x, g1, h, fill=HALO_FILL)
                want = halo_exchange_prev_rdma(x.cpu(), g1, h,
                                               fill=HALO_FILL)
                compare(f"K41 self ring h={h}", got.cpu(), want)
                if not bool((want == HALO_FILL).all()):
                    raise AssertionError("the ring of one is not all fill")
    return err


def _scale_out_legs(dev, mesh, g, rank, lines, out):
    """The main path's legs on this rank; the relay's and the pipeline's
    results go to ``out`` for the parent, the rest are held here."""
    import torch
    from idsp_tpu_torch.chain import DdcChain
    from idsp_tpu_torch.design import Filter
    from idsp_tpu_torch.filters import biquad, hbf
    from idsp_tpu_torch.parallel.pipeline import run_pipelined_sos
    from idsp_tpu_torch.parallel.stream import (
        channel_slice, sharded_df1_float, sharded_df1_q_relay,
        sharded_hbf_dec,
    )
    from idsp_tpu_torch.pipelines import channelizer as chz

    rows = slice(rank * T_LOC, (rank + 1) * T_LOC)
    taps = hbf.HBF_TAPS[0]
    st = st_ref = hbf.hbf_dec_init(len(taps), (C_PAR,), device=dev)
    worst = 0.0
    for b in range(BLOCKS):
        x = par_input(dev, PAR_SEED + 10 + b, (C_PAR, T), torch.float32)
        st, y = sharded_hbf_dec(taps, st, x[:, rows], g, use_rdma=True)
        st_ref, y_ref = hbf.hbf_dec_block(taps, st_ref, x)
        want = y_ref[:, rank * T_LOC // 2:(rank + 1) * T_LOC // 2]
        if not bool(torch.isfinite(y).all()):
            raise AssertionError("sharded_hbf_dec: non-finite output")
        worst = max(worst, near(y, want, 1.0, rel=2e-6))
        compare("sharded_hbf_dec state", tuple(st), tuple(st_ref))
    lines.append(f"rank {rank}: sharded_hbf_dec (rdma, m={len(taps)}, "
                 f"{C_PAR} lanes, t_loc={T_LOC}) x {BLOCKS} blocks: max |y - "
                 f"hbf_dec_block| {worst} (gate 2e-6), state bit for bit")

    ba_q, st_q, xq = relay_inputs(dev)
    st_q, ys_q = sharded_df1_q_relay(ba_q, st_q, xq[rows], 29, g)
    out["relay"] = (st_q.x.cpu().numpy(), st_q.y.cpu().numpy(),
                    ys_q.cpu().numpy())

    ba_f = torch.from_numpy(biquad.from_cookbook(
        Filter().critical_frequency(0.05).lowpass())).to(dev)
    st_f = st_fr = biquad.Df1State(
        x=par_input(dev, PAR_SEED + 30, (C_PAR, 2), torch.float64),
        y=par_input(dev, PAR_SEED + 31, (C_PAR, 2), torch.float64))
    worst = 0.0
    for b in range(BLOCKS):
        xf = par_input(dev, PAR_SEED + 32 + b, (T, C_PAR), torch.float64)
        st_f, ys_f = sharded_df1_float(ba_f, st_f, xf[rows], g)
        st_fr, ys_fr = biquad.df1_block_float(ba_f, st_fr, xf)
        for got, want in ((ys_f, ys_fr[rows]), (st_f.y, st_fr.y)):
            d = (got - want).abs()
            worst = max(worst, float(d.max()))
            if not bool((d <= 1e-9 + 1e-9 * want.abs()).all()):
                raise AssertionError(f"sharded_df1_float off by {worst}")
        compare("sharded_df1_float state.x", st_f.x, st_fr.x)
    lines.append(f"rank {rank}: sharded_df1_float (f64, {C_PAR} lanes) x "
                 f"{BLOCKS} blocks: max |d| vs df1_block_float {worst} (gate "
                 f"1e-9 + 1e-9 |y|), state.x bit for bit")

    bas, xp = pipeline_inputs(dev)
    out["pipeline"] = run_pipelined_sos(mesh, bas, xp, 29, "sp",
                                        shard_io=True).cpu().numpy()

    m_loc = M_CH // P_PAR
    ch = slice(rank * m_loc, (rank + 1) * m_loc)
    for mode in ("replicated", "scatter"):
        st_tp = chz.BankState(hist=torch.zeros((CH_TAPS - 1, m_loc, 2),
                                               device=dev))
        st_cr = chz.init(M_CH, CH_TAPS, device=dev)
        worst = 0.0
        for b in range(BLOCKS):
            xc = par_input(dev, PAR_SEED + 50 + b, (N_CH[0], M_CH, 2),
                           torch.float32)
            st_tp, y = chz.channelize_tp(st_tp, xc[:, ch], g, m=M_CH,
                                         taps=CH_TAPS, out_mode=mode)
            st_cr, y_ref = chz.channelize(st_cr, xc, m=M_CH, taps=CH_TAPS)
            want = y_ref if mode == "replicated" else y_ref[:, ch]
            worst = max(worst, near(y, want, float(y_ref.abs().max())))
            compare("channelize_tp history", st_tp.hist,
                    st_cr.hist[:, ch].contiguous())
        lines.append(f"rank {rank}: channelize_tp {mode} (m={M_CH}, n="
                     f"{N_CH[0]}) x {BLOCKS} blocks: max |d| vs channelize "
                     f"{worst} (gate 2e-5 of the scale), history bit for bit")

    ba = biquad.quantize_ba(
        biquad.from_cookbook(Filter().critical_frequency(0.02).lowpass()), 29)
    steps = par_input(dev, PAR_SEED + 60, (C_PAR,), torch.int32, 1 << 24,
                      1 << 30)
    part = DdcChain("fold3", channel_slice(steps, g), ba, time_chunk=TC)
    whole = DdcChain("fold3", steps, ba, time_chunk=TC)
    s_part, s_whole = part.init_state(), whole.init_state()
    cols = slice(rank * C_PAR // P_PAR, (rank + 1) * C_PAR // P_PAR)
    for b in range(BLOCKS):
        x = par_input(dev, PAR_SEED + 61 + b, (T,), torch.int32, -(2**27),
                      2**27)
        s_part, zp = part(s_part, x)
        s_whole, zw = whole(s_whole, x)
        compare("DdcChain fold3 on a channel slice", zp,
                tuple(z[:, cols] for z in zw))
    lines.append(f"rank {rank}: DdcChain fold3 on channels {cols.start}:"
                 f"{cols.stop} of {C_PAR} x {BLOCKS} blocks == the whole "
                 f"bank's columns bit for bit")


def _k41_times(dev, g, rank):
    """{h: {ms, plain_ms, library_ms}}: medians of K41_ROUNDS calls of K41
    (CUDA events, its host gate included), of its plain version (host
    clock) and of the yardstick, torch's own CUDA IPC."""
    import statistics

    import torch
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor
    from idsp_tpu_torch.parallel import halo_rdma
    from idsp_tpu_torch.parallel.halo_rdma import halo_exchange_prev_rdma

    rows = slice(rank * T_LOC, (rank + 1) * T_LOC)
    x = par_input(dev, PAR_SEED, (T, C_PAR), torch.float32)[rows]
    xc = x.cpu()
    times = {}
    for h in HALO_HS:
        k41 = [_event_ms(lambda: halo_exchange_prev_rdma(x, g, h,
                                                          fill=HALO_FILL))
               for _ in range(K41_ROUNDS)]
        plain = []
        for _ in range(K41_ROUNDS):
            t1 = time.perf_counter()
            halo_exchange_prev_rdma(xc, g, h, fill=HALO_FILL)
            plain.append((time.perf_counter() - t1) * 1e3)
        # the yardstick: torch's own CUDA IPC (a tensor shared as
        # torch.multiprocessing shares it), peer_view.copy_ under the host
        # barrier, a second barrier to tell the receiver
        recv = torch.empty((h, C_PAR), dtype=torch.float32, device=dev)
        rebuild, args = reduce_tensor(recv)
        shared = [None] * P_PAR
        dist.all_gather_object(shared, args, group=g)
        peer_view = rebuild(*shared[(rank + 1) % P_PAR])

        def ipc_copy():
            torch.cuda.current_stream().synchronize()
            dist.barrier(group=g)
            peer_view.copy_(x[-h:])
            torch.cuda.current_stream().synchronize()
            dist.barrier(group=g)

        ipc = [_event_ms(ipc_copy) for _ in range(K41_ROUNDS)]
        compare(f"IPC copy_ yardstick h={h} vs K41", recv,
                halo_rdma.ring_put(x[-h:], g))
        times[h] = {"ms": statistics.median(k41),
                    "plain_ms": statistics.median(plain),
                    "library_ms": statistics.median(ipc)}
        del peer_view
        dist.barrier(group=g)
    return times


def _scale_out_rank(rank, port, refs_ready):
    """One rank: K41 against its plain version, the main path's legs (K41
    launches counted), then the timings.  Returns numpy and numbers."""
    import torch
    import torch.distributed as dist
    from idsp_tpu_torch.parallel import distributed, halo_rdma, make_mesh
    from idsp_tpu_torch.parallel.halo_rdma import halo_exchange_prev_rdma

    t_start = time.perf_counter()
    distributed.initialize_from_env(f"tcp://localhost:{port}", P_PAR, rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh({"sp": P_PAR})
    g = mesh.get_group("sp")
    g1 = dist.new_group([0])  # the ring of one, on rank 0
    lines, out = [], {}
    lines.append(f"rank {rank}: up in {time.perf_counter() - t_start:.1f} s,"
                 f" {dist.get_backend()} group of {dist.get_world_size(g)} on"
                 f" {dev}")
    out["err"] = _k41_holds(dev, g, g1, rank)

    # the main path; K41's count from 0
    halo_exchange_prev_rdma.launches = 0
    t0 = time.perf_counter()
    _scale_out_legs(dev, mesh, g, rank, lines, out)
    torch.cuda.synchronize()
    out["launches"] = halo_exchange_prev_rdma.launches
    out["main_s"] = time.perf_counter() - t0
    lines.append(f"rank {rank}: main path {out['main_s']:.1f} s, K41 "
                 f"launches {out['launches']}")

    # times, once the parent no longer uses the card for its references
    if not refs_ready.wait(timeout=600):
        raise RuntimeError("the parent's references never came")
    out["times"] = _k41_times(dev, g, rank)
    halo_rdma.close(g)
    if rank == 0:
        halo_rdma.close(g1)
    dist.destroy_process_group()
    out["lines"] = lines
    return out


def scale_out_main_path(dev):
    """Phase 4 (scale-out): spawns P_PAR ranks on the card, computes the
    relay's and the pipeline's references with the plain scans while they
    run, holds their results, and returns (K41 launches summed over the
    ranks, K41's max |d| against its plain version, rank 0's times per
    h)."""
    import socket

    import torch
    import torch.multiprocessing as tmp
    from idsp_tpu_torch.filters import biquad

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the earlier phases' blocks, for the ranks
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = tmp.get_context("spawn")
    results, refs_ready = ctx.Queue(), ctx.Event()
    procs = [ctx.Process(target=scale_out_rank,
                         args=(r, port, refs_ready, results))
             for r in range(P_PAR)]
    for q in procs:
        q.start()
    got = {}
    try:
        ba_q, st_q, xq = relay_inputs(dev)
        st_ref, ys_ref = biquad.df1_process_q(ba_q, 29, st_q, xq)
        bas, xp = pipeline_inputs(dev)
        y = xp.reshape(T, C_PAR)
        for ba in bas:  # the stage-major sweep
            _, y = biquad.df1_process_q(ba, 29, biquad.df1_init(
                (C_PAR,), device=dev), y)
        sweep = y.reshape(xp.shape).cpu().numpy()
        ys_ref, st_ref = ys_ref.cpu().numpy(), tuple(
            v.cpu().numpy() for v in st_ref)
        t_refs = time.perf_counter() - t0
        refs_ready.set()
        for _ in range(P_PAR):
            rank, out = results.get(timeout=900)
            if isinstance(out, str):
                raise RuntimeError(f"scale-out rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        refs_ready.set()
        for q in procs:
            q.join(timeout=60)
            if q.is_alive():
                q.kill()
                q.join()
    if any(q.exitcode != 0 for q in procs):
        raise RuntimeError(f"scale-out ranks exited with "
                           f"{[q.exitcode for q in procs]}")
    wall = time.perf_counter() - t0
    for r in range(P_PAR):
        for line in got[r]["lines"]:
            log(f"phase 4 scale-out {line}")
    ys = np.concatenate([got[r]["relay"][2] for r in range(P_PAR)])
    if not np.array_equal(ys, ys_ref) or not all(
            np.array_equal(got[r]["relay"][i], st_ref[i])
            for r in range(P_PAR) for i in (0, 1)):
        raise AssertionError("sharded_df1_q_relay differs from df1_process_q")
    log(f"phase 4 scale-out sharded_df1_q_relay (Q29 at 0.05, {C_PAR} lanes,"
        f" t={T} over {P_PAR} ranks): outputs and the replicated state == "
        f"df1_process_q over the whole stream, bit for bit")
    for b in range(PIPE_NB):
        if not np.array_equal(got[b % P_PAR]["pipeline"][b // P_PAR],
                              sweep[b]):
            raise AssertionError(f"pipelined_sos_cascade_sharded block {b} "
                                 "differs from the stage-major sweep")
    log(f"phase 4 scale-out pipelined_sos_cascade_sharded (S={P_PAR} Q29 "
        f"stages {PIPE_FCS}, {C_PAR} lanes, {PIPE_NB} blocks of "
        f"{T // PIPE_NB}) == the stage-major sweep, bit for bit")
    launches = sum(got[r]["launches"] for r in range(P_PAR))
    err = max(got[r]["err"] for r in range(P_PAR))
    for h in HALO_HS:
        per = ", ".join(
            f"rank {r} {got[r]['times'][h]['ms']:.4f}/"
            f"{got[r]['times'][h]['plain_ms']:.4f}/"
            f"{got[r]['times'][h]['library_ms']:.4f}" for r in range(P_PAR))
        log(f"phase 4 scale-out K41 h={h} ({h} x {C_PAR} f32), median of "
            f"{K41_ROUNDS} calls, ms kernel/plain/IPC copy_: {per} "
            f"({P_PAR} time-sliced processes on one card, host gate "
            f"included: not link latency)")
    log(f"phase 4 scale-out: {P_PAR} ranks, K41 launches {launches} "
        f"(per rank {[got[r]['launches'] for r in range(P_PAR)]}), max |d| "
        f"vs plain {err}; references {t_refs:.1f} s; phase wall {wall:.1f} s")
    return launches, err, got[0]["times"], wall


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
        df1_bank_f32, df1_bank_q, df1_bank_q16, df1_bank_q64,
        df1_bank_q_coef, df1_bank_q_dec, df1_bank_q_plain, df1_clamp_bank_q,
        df1_clamp_bank_q_coef, df1_dither_bank,
        df1_dither_bank_coef, df1_wide_bank, df1_wide_bank_coef, sos_bank_q,
    )
    from idsp_tpu_torch.filters.ddc_cuda import (
        ddc_mix_df1_bank, df1_clamp_hbf_cascade_bank, df1_hbf1_bank,
        df1_hbf12_bank, df1_hbf_cascade_bank, df1_hbf_cascade_bank_plain,
        fastlo_ddc_cascade_bank, fastlo_ddc_cascade_bank_plain,
        hbf1_tail_init,
    )
    from idsp_tpu_torch.filters import lowpass, pll
    from idsp_tpu_torch.filters.ddc_bank_cuda import (
        fastlo_ddc_bank_block, fastlo_ddc_bank_block_lp,
        fastlo_df1_dec_bank,
    )
    from idsp_tpu_torch.filters.hbf import (
        HBF_TAPS, hbf_dec_cascade, hbf_dec_cascade_init,
    )
    from idsp_tpu_torch.filters.lowpass_cuda import lowpass_bank
    from idsp_tpu_torch.filters.pll_cuda import pll_bank
    from idsp_tpu_torch.filters.cic_cuda import cic_dec_bank, cic_int_bank
    from idsp_tpu_torch.filters.hbf_cuda import (
        hbf_dec_cascade_bank, hbf_int_cascade_bank,
    )
    from idsp_tpu_torch.filters.hbf_mxu import (
        hbf_dec_cascade_mxu, hbf_int_cascade_mxu,
    )
    from idsp_tpu_torch.filters.ddc_lockin_cuda import ddc_lockin_bank
    from idsp_tpu_torch.filters.fm_cuda import fm_disc_bank
    from idsp_tpu_torch.filters.normal_cuda import (
        normal_bank_f32, normal_bank_q,
    )
    from idsp_tpu_torch.filters.rpll_cuda import rpll_bank
    from idsp_tpu_torch.filters.svf_cuda import svf_bank
    from idsp_tpu_torch.filters.wdf_cuda import (
        wdf_bank, wdf_chain_bank, wdf_pair_bank,
    )
    from idsp_tpu_torch.pipelines.channelizer_cuda import channelize_fused
    from idsp_tpu_torch.ops import accu
    from idsp_tpu_torch.ops.fastlo import fastlo_mix
    from idsp_tpu_torch.ops.trig import atan2, cossin
    from idsp_tpu_torch.pipelines.ddc_bank import DdcBank, make_tone_bank
    from idsp_tpu_torch.profiling import measure_rate

    dev = torch.device("cuda", 0)
    # the plain versions' and the planes path's f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
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

    plain_s = {}  # phase 3's plain calls' times, read again in phase 6
    check_chain_bank_kernels(dev, i32, i64, errs, plain_s, ba, lp_gains,
                             pll_ba)
    check_rate_kernels(dev, rng, errs)
    check_cic_edges(dev, errs)
    check_mxu_kernels(dev, rng, errs, plain_s)
    check_biquad_kernels(dev, i32, errs, plain_s, ba, ba_bank, pll_ba)
    check_slice5_kernels(dev, rng, errs, plain_s)
    check_clamp_kernels(dev, i32, errs, plain_s, ba, ba_bank)
    check_cascade_edges(dev, i32, errs, ba)
    check_pipe_edges(dev, i32, errs, ba)
    check_control_kernels(dev, i32, i64, errs, plain_s)
    check_precision_kernels(dev, rng, errs, plain_s)
    check_structure_kernels(dev, rng, errs, plain_s)
    check_serial_pipe_edges(dev, i32, errs)
    check_depth0_edges(dev, i32, errs)
    check_df1_pipe_edges(dev, i32, errs)
    check_chain_edges(dev, i32, i64, errs)
    sos_plans = log_sos_plans(dev)
    check_bank_lockin_edges(dev, i32, errs)
    check_lowpass_edges(dev, i32, errs)
    check_pll_edges(dev, i32, errs)
    log(f"phase 3 done at {time.perf_counter() - wall0:.1f} s")

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

    modes = ("scan", "split", "fused", "fold", "fold2", "fold3",
             "fold3_fastlo", "fastlo_fused")
    chains = {m: DdcChain(m, steps_all[:C_MAIN], ba, time_chunk=TC)
              for m in modes}
    wrappers = (df1_bank_q, df1_hbf_cascade_bank, fastlo_ddc_cascade_bank,
                lowpass_bank, pll_bank, fastlo_ddc_bank_block_lp,
                hbf_dec_cascade_bank, hbf_int_cascade_bank, cic_dec_bank,
                cic_int_bank, df1_bank_q_dec, fastlo_df1_dec_bank,
                fastlo_ddc_bank_block, ddc_mix_df1_bank, fm_disc_bank,
                ddc_lockin_bank, channelize_fused, df1_clamp_bank_q,
                df1_clamp_hbf_cascade_bank, df1_hbf1_bank, df1_hbf12_bank,
                hbf_dec_cascade_mxu, hbf_int_cascade_mxu, sos_bank_q,
                df1_wide_bank, df1_bank_q_coef, df1_clamp_bank_q_coef,
                df1_bank_q16, df1_bank_q64, df1_bank_f32, df1_dither_bank,
                df1_wide_bank_coef, df1_dither_bank_coef, svf_bank,
                normal_bank_q, normal_bank_f32, rpll_bank, wdf_bank,
                wdf_chain_bank, wdf_pair_bank)
    chain_kernels = ("df1_bank_q", "df1_hbf_cascade_bank",
                     "fastlo_ddc_cascade_bank", "ddc_mix_df1_bank",
                     "df1_hbf1_bank", "df1_hbf12_bank")
    # the clamped front ends (K12's clamp form at the bank's width)
    clamp_kernels = ("df1_clamp_bank_q", "df1_clamp_hbf_cascade_bank",
                     "fastlo_ddc_cascade_bank_clamp",
                     "fastlo_df1_dec_bank_clamp")
    bank_kernels = ("lowpass_bank", "pll_bank", "fastlo_ddc_bank_block_lp")
    biquad_kernels = ("df1_bank_q_dec", "fastlo_df1_dec_bank",
                      "fastlo_ddc_bank_block")
    rate_kernels = ("hbf_dec_cascade_bank", "hbf_int_cascade_bank",
                    "cic_dec_bank", "cic_int_bank", "hbf_dec_cascade_mxu",
                    "hbf_int_cascade_mxu", "hbf_dec_cascade_mxu_default",
                    "hbf_int_cascade_mxu_default",
                    "hbf_dec_cascade_mxu_highest",
                    "hbf_int_cascade_mxu_highest")
    control_kernels = ("sos_bank_q", "df1_wide_bank", "df1_bank_q_coef",
                       "df1_clamp_bank_q_coef")
    precision_kernels = ("df1_bank_q16", "df1_bank_q64", "df1_bank_f32",
                         "df1_dither_bank", "df1_wide_bank_coef",
                         "df1_dither_bank_coef")
    structure_kernels = ("svf_bank", "normal_bank_q", "normal_bank_f32",
                         "rpll_bank", "wdf_bank", "wdf_chain_bank",
                         "wdf_pair_bank")
    # BASELINE #1-#3: each kernel's width in the kernels line (K17: frames)
    slice5_c = {"fm_disc_bank": C_FM, "ddc_lockin_bank": C_LOCKIN,
                "channelize_fused": N_CH[-1]}
    reset(wrappers)
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
    counts = launch_counts(wrappers)
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

    for m in ("split", "fold", "fold2", "fold3"):
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

    for m in ("fastlo_fused", "fold3_fastlo"):
        zi, zq = runs[m][0][:2]
        if tuple(zi.shape) != (T // 8, C_MAIN) or not bool(
                torch.isfinite(zi).all() & torch.isfinite(zq).all()):
            raise AssertionError(f"{m}: bad output")
        z = (zi[:, 0].double().cpu().numpy()
             + 1j * zq[:, 0].double().cpu().numpy())[1024:1024 + 2048]
        snr, peak = snr_db(z)
        expect = int(round(OFF_STEP * 8 / 2**32 * 2048)) % 2048
        if min(abs(peak - expect),
               2048 - abs(peak - expect)) > 2 or snr <= 80.0:
            raise AssertionError(f"{m}: SNR {snr:.2f} dB at bin {peak} "
                                 f"(want > 80 dB at bin {expect})")
        log(f"phase 4 {m}: SNR {snr:.3f} dB at bin {peak} "
            f"(expected {expect}, gate > 80 dB)")

    # ---- phase 4 (bank): the BASELINE #5 main path --------------------
    bank_modes = ("scan", "exact", "fast", "one_kernel")
    bank_steps = i32((C_BANK,), 1 << 24, 1 << 30)
    banks = {m: DdcBank(m, bank_steps, lp_gains, pll_ba, decimate=DEC,
                        time_chunk=TC) for m in bank_modes}
    bank_x = [i32((T,), -(2**27), 2**27) for _ in range(BLOCKS)]
    reset(wrappers)
    bank_runs = {}
    for m in bank_modes:
        state = banks[m].init_state()
        outs = []
        for xb in bank_x:
            state, out = banks[m](state, xb)
            outs.append((state, out))
        bank_runs[m] = outs
    torch.cuda.synchronize()
    counts = launch_counts(wrappers)
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

    # ---- phase 4 (clamp): the anti-windup front ends ------------------
    counts = clamp_main_path(dev, ba, ba_bank, xblocks, steps_all[:C_MAIN],
                             bank_x, bank_steps, wrappers)
    for k in clamp_kernels:
        launches[k] = counts[k]

    # ---- phase 4 (rate conversion): the BASELINE #4 main path ---------
    counts = rate_main_path(dev, rng, wrappers)
    for k in rate_kernels:
        launches[k] = counts[k]

    # ---- phase 4 (BASELINE #1-#3): FM, lock-in, channelizer -----------
    for path, name in ((fm_main_path, "fm_disc_bank"),
                       (lockin_main_path, "ddc_lockin_bank"),
                       (channelizer_main_path, "channelize_fused")):
        launches[name] = path(dev, rng, wrappers)[name]

    # ---- phase 4 (control): compat.sos, sos_clamp_wide, config bank ---
    counts = control_main_path(dev, i32, wrappers)
    for k in control_kernels:
        launches[k] = counts[k]

    # ---- phase 4 (precision ladder): Q16, Q64, f32, dither, _coef -----
    counts = precision_main_path(dev, rng, wrappers)
    for k in precision_kernels:
        launches[k] = counts[k]

    # ---- phase 4 (structures): SVF, normal form, RPLL, WDF -------------
    counts = structures_main_path(dev, rng, wrappers)
    for k in structure_kernels:
        launches[k] = counts[k]

    # ---- phase 4 (scale-out): the parallel layer on P_PAR ranks --------
    (launches["halo_exchange_prev_rdma"], errs["halo_exchange_prev_rdma"],
     k41_times, _) = scale_out_main_path(dev)
    log(f"phase 4 done at {time.perf_counter() - wall0:.1f} s")

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
                                           out_dtype=torch.float32), None),
        }
        for name, (kern, plain) in cases.items():
            k_s, _ = measure_rate(kern, st, iters=20, trials=3)
            # the plain calls timed in phase 3 on the same shapes (K1-K3's
            # there at c = C_MAIN only, K14's at both widths)
            key = f"{name} c={c}" if name == "ddc_mix_df1_bank" else name
            if c == C_MAIN or plain is None:
                p_s, where = plain_s[key], " (phase 3)"
            else:
                (p_s, _), where = measure_rate(plain, st, **ONCE), ""
            entry = timings["kernels"].setdefault(name, {})[c] = {
                "ms": k_s * 1e3, "plain_ms": p_s * 1e3}
            note = ""
            if name in DEVICE_SYMBOLS:
                entry["device_ms"] = launch_device_ms(name, kern, st)
                note = f", device {entry['device_ms']} ms a launch"
            log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms{note}, "
                f"plain {p_s * 1e3:.2f} ms{where}  [{card}]")
        # the two-kernel composition K2 fuses: K1 (f32 out), then K7 on the
        # chain's three stages, on K2's input
        dec3 = hbf_dec_cascade_init(3, (c2,), axis=0, device=dev)

        def k1_then_k7(s):
            s1, y = df1_bank_q(ba, s, xs, 29, out_dtype=torch.float32)
            return s1, hbf_dec_cascade_bank(dec3, y, taps=HBF_TAPS[:3])

        k_s, _ = measure_rate(k1_then_k7, st, iters=20, trials=3)
        k2_t = timings["kernels"]["df1_hbf_cascade_bank"][c]
        k2_t["k1_then_k7_ms"] = k_s * 1e3
        log(f"phase 6 c={c} K1 then K7 (the composition K2 fuses): "
            f"{k_s * 1e3:.4f} ms; K2 {k2_t['ms']:.4f} ms  [{card}]")
        # K18-K21 and K3's clamp form; their plain versions were timed in
        # phase 3 (c = C_MAIN)
        u, lo, hi = CLAMP
        clamped = {
            "df1_clamp_bank_q": lambda s: df1_clamp_bank_q(
                ba, s, xs, 29, u=u, lo=lo, hi=hi),
            "df1_clamp_hbf_cascade_bank": lambda s: df1_clamp_hbf_cascade_bank(
                ba, s, tails, xs, 29, u=u, lo=lo, hi=hi, time_chunk=TC),
            "df1_hbf1_bank": lambda s: df1_hbf1_bank(ba, s, tails[0], xs, 29),
            "df1_hbf12_bank": lambda s: df1_hbf12_bank(ba, s, *tails[:2], xs,
                                                       29),
            "fastlo_ddc_cascade_bank_clamp": lambda s: fastlo_ddc_cascade_bank(
                ba, s, tails, ph0, stp, x, 29, clamp=CLAMP, time_chunk=TC),
        }
        for name, kern in clamped.items():
            k_s, _ = measure_rate(kern, st, iters=20, trials=3)
            entry = {"ms": k_s * 1e3}
            if c == C_MAIN:
                entry["plain_ms"] = plain_s[name] * 1e3
            if name in DEVICE_SYMBOLS:
                entry["device_ms"] = launch_device_ms(name, kern, st)
            timings["kernels"].setdefault(name, {})[c] = entry
            log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms"
                + (f", device {entry['device_ms']} ms a launch"
                   if "device_ms" in entry else "")
                + (f", plain {entry['plain_ms']:.2f} ms (phase 3)"
                   if c == C_MAIN else "") + f"  [{card}]")
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
            how = ONCE if m == "scan" else {"iters": 10, "trials": 3}
            sec, _ = measure_rate(chain, chain.init_state(), x, **how)
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
            lambda s: lowpass_bank(lp_gains, s, xs, dec=DEC), lp0),
        "pll_bank": (lambda s: pll_bank(pll_ba, s, phd), pll0),
        "fastlo_ddc_bank_block_lp": (k6(fastlo_ddc_bank_block_lp),
                                     (lp0, pll0)),
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
            lambda s: df1_bank_q_dec(ba_bank, s, xs, 29, d=DEC), bq0),
        "fastlo_df1_dec_bank": (
            lambda s: fastlo_df1_dec_bank(ba_bank, s, ph0, bank_steps, x, 29,
                                          d=DEC, time_chunk=TC), bq0),
        "fastlo_ddc_bank_block": (k13(fastlo_ddc_bank_block), (bq0, pll0)),
    })
    cases["fastlo_df1_dec_bank_clamp"] = (
        lambda s: fastlo_df1_dec_bank(ba_bank, s, ph0, bank_steps, x, 29,
                                      d=DEC, clamp=CLAMP, time_chunk=TC),
        bq0)
    for name, (kern, st) in cases.items():
        k_s, _ = measure_rate(kern, st, iters=20, trials=3)
        p_s = plain_s[name]  # timed in phase 3 on the same shapes
        entry = timings["kernels"].setdefault(name, {})[c] = {
            "ms": k_s * 1e3, "plain_ms": p_s * 1e3}
        note = ""
        if name in DEVICE_SYMBOLS:
            entry["device_ms"] = launch_device_ms(name, kern, st)
            note = f", device {entry['device_ms']} ms a launch"
        log(f"phase 6 c={c} {name}: kernel {k_s * 1e3:.4f} ms{note}, plain "
            f"{p_s * 1e3:.2f} ms (phase 3)  [{card}]")
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
        how = ONCE if m == "scan" else {"iters": 10, "trials": 3}
        sec, _ = measure_rate(bank, bank.init_state(), x, **how)
        rate = c * T / sec
        timings["bank_samples_per_s"][m] = rate
        log(f"phase 6 c={c} bank {m}: {sec * 1e3:.3f} ms/block, "
            f"{rate:.6e} samples/s (c*t)  [{card}]")
        if m != "scan":
            log_busy(timings, f"bank_{m}", c, sec, card, bank,
                     bank.init_state(), x)
    timings["biquad_bank_samples_per_s"] = {}
    for m, bank in bq_banks.items():
        how = ONCE if m == "scan" else {"iters": 10, "trials": 3}
        sec, _ = measure_rate(bank, bank.init_state(), bq_x[0], **how)
        rate = c * T / sec
        timings["biquad_bank_samples_per_s"][m] = rate
        log(f"phase 6 c={c} biquad bank {m}: {sec * 1e3:.3f} ms/block, "
            f"{rate:.6e} samples/s (c*t)  [{card}]")
        if m != "scan":
            log_busy(timings, f"biquad_bank_{m}", c, sec, card, bank,
                     bank.init_state(), bq_x[0])
    time_rate(dev, rng, card, timings)
    time_slice5(dev, rng, card, timings, plain_s)
    time_control(dev, i32, card, timings, plain_s)
    time_precision(dev, rng, card, timings, plain_s)
    time_structures(dev, rng, card, timings, plain_s)
    # K41, timed in phase 4 by the ranks (rank 0's medians)
    timings["kernels"]["halo_exchange_prev_rdma"] = {C_PAR: k41_times[HALO_H]}
    timings["halo_exchange_prev_rdma_by_h"] = k41_times
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
        "hbf_dec_cascade_mxu": ("idsp_tpu_torch/csrc/hbf_mxu.cu",
                                "idsp_tpu/filters/hbf_pallas.py:409"),
        "hbf_int_cascade_mxu": ("idsp_tpu_torch/csrc/hbf_mxu.cu",
                                "idsp_tpu/filters/hbf_pallas.py:612"),
        "hbf_dec_cascade_mxu_default": ("idsp_tpu_torch/csrc/hbf_mxu.cu",
                                        "idsp_tpu/filters/hbf_pallas.py:409"),
        "hbf_int_cascade_mxu_default": ("idsp_tpu_torch/csrc/hbf_mxu.cu",
                                        "idsp_tpu/filters/hbf_pallas.py:612"),
        "hbf_dec_cascade_mxu_highest": ("idsp_tpu_torch/csrc/hbf_cascade.cu",
                                        "idsp_tpu/filters/hbf_pallas.py:409"),
        "hbf_int_cascade_mxu_highest": ("idsp_tpu_torch/csrc/hbf_cascade.cu",
                                        "idsp_tpu/filters/hbf_pallas.py:612"),
        "cic_dec_bank": ("idsp_tpu_torch/csrc/cic_bank.cu",
                         "idsp_tpu/filters/cic_pallas.py:83"),
        "cic_int_bank": ("idsp_tpu_torch/csrc/cic_bank.cu",
                         "idsp_tpu/filters/cic_pallas.py:131"),
        "fm_disc_bank": ("idsp_tpu_torch/csrc/fm_disc.cu",
                         "idsp_tpu/filters/fm_pallas.py:93"),
        "ddc_lockin_bank": ("idsp_tpu_torch/csrc/ddc_lockin.cu",
                            "idsp_tpu/filters/ddc_pallas.py:1359"),
        "channelize_fused": ("idsp_tpu_torch/csrc/channelize.cu",
                             "idsp_tpu/pipelines/channelizer_pallas.py:54"),
        "df1_clamp_bank_q": ("idsp_tpu_torch/csrc/df1_bank.cu",
                             "idsp_tpu/filters/biquad_pallas.py:696"),
        "df1_clamp_hbf_cascade_bank": ("idsp_tpu_torch/csrc/ddc_cascade.cu",
                                       "idsp_tpu/filters/ddc_pallas.py:834"),
        "df1_hbf1_bank": ("idsp_tpu_torch/csrc/ddc_cascade.cu",
                          "idsp_tpu/filters/ddc_pallas.py:743"),
        "df1_hbf12_bank": ("idsp_tpu_torch/csrc/ddc_cascade.cu",
                           "idsp_tpu/filters/ddc_pallas.py:767"),
        "fastlo_ddc_cascade_bank_clamp": (
            "idsp_tpu_torch/csrc/ddc_cascade.cu",
            "idsp_tpu/filters/ddc_pallas.py:1298"),
        "fastlo_df1_dec_bank_clamp": ("idsp_tpu_torch/csrc/ddc_bank.cu",
                                      "idsp_tpu/filters/ddc_pallas.py:870"),
        "sos_bank_q": ("idsp_tpu_torch/csrc/biquad_bank.cu",
                       "idsp_tpu/filters/biquad_pallas.py:147"),
        "df1_wide_bank": ("idsp_tpu_torch/csrc/biquad_bank.cu",
                          "idsp_tpu/filters/biquad_pallas.py:796"),
        "df1_bank_q_coef": ("idsp_tpu_torch/csrc/df1_bank.cu",
                            "idsp_tpu/filters/biquad_pallas.py:932"),
        "df1_clamp_bank_q_coef": ("idsp_tpu_torch/csrc/df1_bank.cu",
                                  "idsp_tpu/filters/biquad_pallas.py:999"),
        # K28, K30: depth-0 `run_pipe` (`tap_feed` over int16 rows and
        # `Q16Serial`, int16 rows out; `f32_feed` and `Df1F32Serial`)
        "df1_bank_q16": ("idsp_tpu_torch/csrc/biquad_precision.cu",
                         "idsp_tpu/filters/biquad_pallas.py:1352"),
        "df1_bank_q64": ("idsp_tpu_torch/csrc/biquad_precision.cu",
                         "idsp_tpu/filters/biquad_pallas.py:1250"),
        "df1_bank_f32": ("idsp_tpu_torch/csrc/biquad_precision.cu",
                         "idsp_tpu/filters/biquad_pallas.py:98"),
        "df1_dither_bank": ("idsp_tpu_torch/csrc/biquad_precision.cu",
                            "idsp_tpu/filters/biquad_pallas.py:872"),
        "df1_wide_bank_coef": ("idsp_tpu_torch/csrc/biquad_bank.cu",
                               "idsp_tpu/filters/biquad_pallas.py:1053"),
        "df1_dither_bank_coef": ("idsp_tpu_torch/csrc/biquad_precision.cu",
                                 "idsp_tpu/filters/biquad_pallas.py:1104"),
        "svf_bank": ("idsp_tpu_torch/csrc/structures_bank.cu",
                     "idsp_tpu/filters/svf_pallas.py:28"),
        "normal_bank_q": ("idsp_tpu_torch/csrc/structures_bank.cu",
                          "idsp_tpu/filters/normal_pallas.py:35"),
        "normal_bank_f32": ("idsp_tpu_torch/csrc/structures_bank.cu",
                            "idsp_tpu/filters/normal_pallas.py:105"),
        "rpll_bank": ("idsp_tpu_torch/csrc/structures_bank.cu",
                      "idsp_tpu/filters/rpll_pallas.py:35"),
        "wdf_bank": ("idsp_tpu_torch/csrc/wdf_bank.cu",
                     "idsp_tpu/filters/wdf_pallas.py:109"),
        "wdf_chain_bank": ("idsp_tpu_torch/csrc/wdf_bank.cu",
                           "idsp_tpu/filters/wdf_pallas.py:220"),
        "wdf_pair_bank": ("idsp_tpu_torch/csrc/wdf_bank.cu",
                          "idsp_tpu/filters/wdf_pallas.py:280"),
        "halo_exchange_prev_rdma": ("idsp_tpu_torch/csrc/halo.cu",
                                    "idsp_tpu/parallel/halo_rdma.py:30"),
    }
    sm_mhz = sm_clock_mhz()
    kernels = []
    for name, (src, rep) in sources.items():
        c = (C_MAIN if name in chain_kernels + clamp_kernels[:3] else
             C_BANK if name in bank_kernels + biquad_kernels
             + clamp_kernels[3:] else C_CTL if name in control_kernels
             else C_PREC if name in precision_kernels
             else C_STRUCT if name in structure_kernels
             else C_PAR if name == "halo_exchange_prev_rdma"
             else slice5_c.get(name, C_RATE))
        timed = timings["kernels"][name][c]
        bound_ms, bound_by, _ = bounds(name, c, sm_mhz)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timed.get("library_ms"), "c": c,
            **({"plan": sos_plans} if name == "sos_bank_q" else {})})
        log_bound(name, c, timed["ms"], sm_mhz)
    # the other instantiations of K15 and K17, on their log lines only
    for name, c in (("fm_disc_bank_fast", C_FM),
                    ("channelize_fused", N_CH[0]),
                    ("channelize_fused_f32", N_CH[0]),
                    ("channelize_fused_f32", N_CH[-1]),
                    ("wdf_pair_bank_ca7", C_STRUCT)):
        log_bound(name, c, timings["kernels"][name][c]["ms"], sm_mhz)
    log(f"wall time {time.perf_counter() - wall0:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
