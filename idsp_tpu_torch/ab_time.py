"""Time K1-K19, K22 and K23 "highest", K24-K37 and K38-K40 (K12 also with
its ``clamp=``) of two checkouts of the port in turns, in one process.

Usage (on a CUDA machine, from the root of a checkout)::

    python3 -m idsp_tpu_torch.ab_time PARENT_ROOT CHANGE_ROOT [--only A,B]

``--only`` keeps the kernels whose name contains one of the given substrings
(e.g. ``--only highest,wdf``; K2, K3, K19: ``--only
df1_hbf,fastlo_ddc_cascade,df1_clamp``; K14, K15: ``--only mix_df1,fm_disc``;
K29, K37: ``--only q64,rpll``; K28, K30: ``--only q16,df1_bank_f32``;
K31, K33, K34: ``--only dither,svf``; K35, K36: ``--only normal``; K12, its
``clamp=``, K13, K6 and K16: ``--only
fastlo_df1_dec,fastlo_ddc_bank,ddc_lockin``; K4: ``--only lowpass``; K1, K11,
K18, K26, K27: ``--only df1_bank_q,df1_clamp_bank_q``; K24, K25, K32: ``--only
sos,wide``; K9, K10: ``--only cic``; K5: ``--only pll_bank``; K23 "highest":
``--only int_cascade_mxu``; K7, K8, K22 and K23 "highest": ``--only hbf_``).

Each root is a checkout holding an ``idsp_tpu_torch/`` package; each is
loaded under a name of its own, so both live in this process, and each
builds its kernels into its own ``build/``.  One set of inputs, made from
a seed, goes to both: K1 `df1_bank_q` (f32 out) at c = 512 and 1024
channels (2c I|Q lanes, t = 32768, as `chip_smoke.py` phase 6 times it),
K18 `df1_clamp_bank_q` (clamp (2^10, +-2^23)) on the same xs at c = 512
and 1024, K11 `df1_bank_q_dec` (the suite's bank filter, the Q29 lowpass
at 0.004, d = 16) on the c = 1024 xs, K26 `df1_bank_q_coef` and K27
`df1_clamp_bank_q_coef` (clamp (0, +-2^26), the config bank's) with the
per-lane Q29 lowpass planes below on full-range x at c = 1024 lanes,
K2 `df1_hbf_cascade_bank` on the same xs and K3
`fastlo_ddc_cascade_bank` (x, a zero phase, the K6 steps) at c = 512 and
1024 and K19 `df1_clamp_hbf_cascade_bank` (clamp (2^10, +-2^23)) at
c = 512 (the chain's taps (5, 10, 23), zero state, time chunk 128), K6
`fastlo_ddc_bank_block_lp` at c = 1024 (d = 16, time chunk 128), K4
`lowpass_bank` on the c = 1024 xs (2048 lanes, d = 16, zero state), both
with the #5 bank's `lowpass.gains2(0.004)`, and
K7 `hbf_dec_cascade_bank` on (32768, c) and K8 `hbf_int_cascade_bank` on
(2048, c) f32 at c = 512 and 1024 (depth 4, `HBF_TAPS`, zero state, each
tree's default chunk and launch shape), K9 `cic_dec_bank` (N = 3, R = 16,
x in +-2^16; and R = 4, x in +-2^20, the composite decimator's) and K10
`cic_int_bank` (N = 3, R = 16, 2048 slow rows in +-2^10) through their
wrappers (the plain combs included) at c = 512 and 1024, zero state, as
`chip_smoke.py` phase 6 times them, and K17 `channelize_fused` at
m = 1024, 8 taps, n = 1024 and 16384 frames, bf16 and f32 (zero history,
each tree's default plan), K22 `hbf_dec_cascade_mxu` at precision
"highest" on K7's inputs and K23 `hbf_int_cascade_mxu` at precision
"highest" on K8's, at c = 512 and 1024, K5 `pll_bank` at c = 1024 on
2048 rows of full-range phases (the #5 bank's kept rows;
`pll.coefficients_from_bandwidth(2e-2, 4.0)`, zero state), and K38
`wdf_bank` (wdf-ca-7's first chain),
K39 `wdf_chain_bank` (wdf-ca-19's branch 0) and K40 `wdf_pair_bank`
(wdf-ca-7 and wdf-ca-19) at c = 1024 lanes of x in +-2^24, t = 32768
(zero state, `chip_smoke.py`'s chains), K14 `ddc_mix_df1_bank` (f32
out; x, a zero phase, the K6 steps) at c = 512 and 1024, and K15
`fm_disc_bank` (exact and fast angle; IQ full range, carrier 12345, the
deemphasis lowpass at 0.02, zero state) at c = 512, K29 `df1_bank_q64`
(the Q64<61> lowpass at 0.1, x in +-2^55, zero state) and K37
`rpll_bank` (the RPLL row (8, 12, 11), full-range timestamps, 1 in 64
valid, zero state), K28 `df1_bank_q16` (the suite's Q16<13> lowpass at
0.1, x in +-2^14, zero state) and K30 `df1_bank_f32` (that lowpass in
f32, x ~ N(0, 1), zero state) at c = 1024 lanes, t = 32768, as
`chip_smoke.py`'s ladder and structures; K31 `df1_dither_bank` (the Q29 lowpass at 0.1, x
in +-2^24, zero state; unclamped and clamped with the suite's row (0,
+-2^30), which pins nothing), K33 `df1_dither_bank_coef` (per-lane Q29
lowpass planes at 1024 frequencies in [0.01, 0.2], and the shared set)
and K34 `svf_bank` (the suite's row (0.01, 0.7), x ~ N(0, 1), zero
state; each of its four outputs), K35 `normal_bank_q` (the normal form's
lowpass at 0.06 in Q29, x in +-2^24, zero state) and K36 `normal_bank_f32`
(that lowpass in f32, x ~ N(0, 1), zero state) at the same width; K12
`fastlo_df1_dec_bank` (unclamped and with ``clamp=`` (2^10, +-2^23)) and
K13 `fastlo_ddc_bank_block` at c = 1024 (the suite's bank filter, the
Q29 lowpass at 0.004; d = 16, time chunk 128; x, a zero phase, the K6
steps; zero state) and K16 `ddc_lockin_bank` at c = 512 (LO frequencies
0.05-0.45, the lowpass at 0.002, x ~ N(0, 1), time chunk 512, zero
state), as `chip_smoke.py` runs them; K24 `sos_bank_q` (4 stages of the
Q29 lowpass at 0.1, `compat.sos`'s rows, x in +-2^24, zero state), K25
`df1_wide_bank` (that lowpass, clamped with `chip_smoke.py`'s WIDE_CLAMP
(0, +-2^30) and unclamped) and K32 `df1_wide_bank_coef` (the per-lane
planes above, and the shared set as a device tensor) on full-range x at
c = 1024 lanes, zero state.  The two trees must
compute the same words, K17 within 2e-5 of the scale (its sums run in
another order).
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
C_WDF = 1024  # K38-K40's lanes
C_FM, FM_CARRIER = 512, 12345  # K15's channels and carrier word
C_SERIAL = 1024  # K24's, K25's and K28-K37's lanes
C_BANK, C_LOCKIN, TC_LOCKIN = 1024, 512, 512  # K12/K13's, K16's widths
BANK_CLAMP = (1 << 10, -(1 << 23), 1 << 23)  # K12's clamp= in chip_smoke
DITHER_CLAMP = (0, -(2**30), 2**30)  # the suite's clamped-dither row
WIDE_CLAMP = DITHER_CLAMP  # K25's clamp in chip_smoke (its WIDE_CLAMP)
SOS_STAGES = 4  # `compat.sos`'s "q32 cascade4" stages
CIC_R, COMP_R = 16, 4  # K9/K10's rate change, and the composite's K9
SVF_ROW = (0.01, 0.7)  # the suite's SVF row (f0, Q)
NORMAL_FC = 0.06  # the normal form's cookbook lowpass (chip_smoke.py's)
# wdf-ca-7 and wdf-ca-19 (benches/suite.py:442-500): per branch, stages of
# (type nibbles, adapters, pole coefficients)
WDF_CA7 = ([(0xAD, 2, [-0.9, 0.9]), (0xAD, 2, [-0.6, 0.7])],
           [(0xAD, 2, [-0.7, 0.6]), (0xA, 1, [0.8])])
WDF_CA19 = ([(0x1, 1, [0.0]), (0x1C, 2, [-0.226119, 0.0]),
             (0x1D, 2, [-0.602422, 0.0]), (0x1D, 2, [-0.83932, 0.0]),
             (0x1D, 2, [-0.950847, 0.0])],
            [(0x1C, 2, [-0.063978, 0.0]), (0x1C, 2, [-0.423068, 0.0]),
             (0x1D, 2, [-0.741327, 0.0]), (0x1D, 2, [-0.905567, 0.0]),
             (0x1D, 2, [-0.984721, 0.0])])


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
        "filters.hbf_cuda", "filters.hbf_mxu", "filters.wdf",
        "filters.ddc_cuda", "filters.fm_cuda", "pipelines.fm_disc",
        "filters.wdf_cuda", "pipelines.channelizer",
        "pipelines.channelizer_cuda", "filters.rpll", "filters.rpll_cuda",
        "filters.svf", "filters.svf_cuda", "filters.ddc_lockin_cuda",
        "filters.lowpass_cuda", "filters.normal", "filters.normal_cuda",
        "filters.cic", "filters.cic_cuda", "filters.pll_cuda", "fxp")}
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
        out[f"df1_clamp_bank_q c={c}"] = (
            lambda st=st, xs=xs: sub["filters.biquad_cuda"].df1_clamp_bank_q(
                ba, st, xs, 29, u=BANK_CLAMP[0], lo=BANK_CLAMP[1],
                hi=BANK_CLAMP[2]))
    ddc = sub["filters.ddc_cuda"]
    for c in (512, 1024):
        st = biquad.df1_init((2 * c,), device=dev)
        tails = tuple(ddc.hbf1_tail_init(2 * c, m, device=dev)
                      for m in (5, 10, 23))
        xs = inputs[f"xs{c}"]
        out[f"df1_hbf_cascade_bank c={c}"] = (
            lambda st=st, tails=tails, xs=xs: ddc.df1_hbf_cascade_bank(
                ba, st, tails, xs, 29, time_chunk=TC))
        out[f"fastlo_ddc_cascade_bank c={c}"] = (
            lambda st=st, tails=tails, c=c: ddc.fastlo_ddc_cascade_bank(
                ba, st, tails, inputs["ph0"][:c], inputs["steps"][:c],
                inputs["x"], 29, time_chunk=TC))
        if c == 512:
            out[f"df1_clamp_hbf_cascade_bank c={c}"] = (
                lambda st=st, tails=tails, xs=xs:
                ddc.df1_clamp_hbf_cascade_bank(
                    ba, st, tails, xs, 29, u=1 << 10, lo=-(1 << 23),
                    hi=1 << 23, time_chunk=TC))
        out[f"ddc_mix_df1_bank c={c}"] = (
            lambda st=st, c=c: ddc.ddc_mix_df1_bank(
                ba, st, inputs["ph0"][:c], inputs["steps"][:c], inputs["x"],
                29, out_dtype=torch.float32))
    fm, fm_cuda = sub["pipelines.fm_disc"], sub["filters.fm_cuda"]
    ba_fm = fm.deemphasis_coefficients(0.02)
    for angle in ("exact", "fast"):
        out[f"fm_disc_bank {angle} c={C_FM}"] = (
            lambda st=fm.init_state((C_FM,), device=dev), angle=angle:
            fm_cuda.fm_disc_bank(ba_fm, st, *inputs["iq"], FM_CARRIER,
                                 angle=angle))
    ba64 = biquad.quantize_ba(biquad.from_cookbook(
        sub["design"].Filter().critical_frequency(0.1).lowpass()), 61,
        dtype=np.int64)
    out[f"df1_bank_q64 c={C_SERIAL}"] = (
        lambda st=biquad.df1_init((C_SERIAL,), torch.int64, device=dev):
        sub["filters.biquad_cuda"].df1_bank_q64(ba64, st, inputs["x64"], 61))
    bc = sub["filters.biquad_cuda"]
    lp_01 = biquad.from_cookbook(
        sub["design"].Filter().critical_frequency(0.1).lowpass())
    b16 = biquad.quantize_ba(lp_01, 13, dtype=np.int16)
    out[f"df1_bank_q16 c={C_SERIAL}"] = (
        lambda st=biquad.df1_init((C_SERIAL,), torch.int16, device=dev):
        bc.df1_bank_q16(b16, st, inputs["x16"], 13))
    out[f"df1_bank_f32 c={C_SERIAL}"] = (
        lambda st=biquad.df1_init((C_SERIAL,), torch.float32, device=dev):
        bc.df1_bank_f32(lp_01, st, inputs["xf"]))
    ba29 = biquad.quantize_ba(biquad.from_cookbook(
        sub["design"].Filter().critical_frequency(0.1).lowpass()), 29)
    for label, clamp in (("", None), (" clamped", DITHER_CLAMP)):
        out[f"df1_dither_bank{label} c={C_SERIAL}"] = (
            lambda st=biquad.df1_dither_init((C_SERIAL,), device=dev),
            clamp=clamp: bc.df1_dither_bank(ba29, st, inputs["x29"], 29,
                                            clamp=clamp))
    for label, planes in (("per-lane", inputs["planes29"]),
                          ("shared", torch.from_numpy(ba29).to(dev))):
        out[f"df1_dither_bank_coef {label} c={C_SERIAL}"] = (
            lambda st=biquad.df1_dither_init((C_SERIAL,), device=dev),
            planes=planes: bc.df1_dither_bank_coef(planes, st,
                                                   inputs["x29"], 29))
    svf, svf_cuda = sub["filters.svf"], sub["filters.svf_cuda"]
    f, qi = svf.coefficients(*SVF_ROW)
    for o in svf_cuda.OUTPUTS:
        out[f"svf_bank {o} c={C_SERIAL}"] = (
            lambda st=svf.init((C_SERIAL,), device=dev), o=o:
            svf_cuda.svf_bank(f, qi, st, inputs["xf"], output=o))
    normal, normal_cuda = sub["filters.normal"], sub["filters.normal_cuda"]
    b_n, p_n = normal.from_cookbook(
        sub["design"].Filter().critical_frequency(NORMAL_FC).lowpass())
    bq, pq = (sub["fxp"].from_float(v, 29) for v in (b_n, p_n))
    out[f"normal_bank_q c={C_SERIAL}"] = (
        lambda st=normal.init((C_SERIAL,), torch.int32, device=dev):
        normal_cuda.normal_bank_q(bq, pq, st, inputs["x29"], 29))
    out[f"normal_bank_f32 c={C_SERIAL}"] = (
        lambda st=normal.init((C_SERIAL,), device=dev):
        normal_cuda.normal_bank_f32(b_n, p_n, st, inputs["xf"]))
    rpll = sub["filters.rpll"]
    out[f"rpll_bank c={C_SERIAL}"] = (
        lambda st=rpll.init((C_SERIAL,), device=dev):
        sub["filters.rpll_cuda"].rpll_bank(rpll.RpllConfig(8, 12, 11), st,
                                           *inputs["rpll"]))
    bank = sub["filters.ddc_bank_cuda"]
    ba_bank = biquad.quantize_ba(biquad.from_cookbook(
        sub["design"].Filter().critical_frequency(0.004).lowpass()), 29)
    out[f"df1_bank_q_dec c={C_BANK}"] = (
        lambda st=biquad.df1_init((2 * C_BANK,), device=dev):
        bc.df1_bank_q_dec(ba_bank, st, inputs["xs1024"], 29, d=DEC))
    out[f"df1_bank_q_coef c={C_SERIAL}"] = (
        lambda st=biquad.df1_init((C_SERIAL,), device=dev):
        bc.df1_bank_q_coef(inputs["planes29"], st, inputs["x32"], 29))
    out[f"sos_bank_q c={C_SERIAL}"] = (
        lambda st=[biquad.df1_init((C_SERIAL,), device=dev)] * SOS_STAGES:
        bc.sos_bank_q(np.stack([ba29] * SOS_STAGES), st, inputs["x29"], 29))
    for label, clamp in (("", None), (" clamped", WIDE_CLAMP)):
        out[f"df1_wide_bank{label} c={C_SERIAL}"] = (
            lambda st=biquad.df1_wide_init((C_SERIAL,), device=dev),
            clamp=clamp: bc.df1_wide_bank(ba29, st, inputs["x32"], 29,
                                          clamp=clamp))
    for label, planes in (("per-lane", inputs["planes29"]),
                          ("shared", torch.from_numpy(ba29).to(dev))):
        out[f"df1_wide_bank_coef {label} c={C_SERIAL}"] = (
            lambda st=biquad.df1_wide_init((C_SERIAL,), device=dev),
            planes=planes: bc.df1_wide_bank_coef(planes, st, inputs["x32"],
                                                 29))
    out[f"df1_clamp_bank_q_coef c={C_SERIAL}"] = (
        lambda st=biquad.df1_init((C_SERIAL,), device=dev):
        bc.df1_clamp_bank_q_coef(inputs["planes29"], st, inputs["x32"], 29,
                                 u=0, lo=-(2**26), hi=2**26))
    for label, clamp in (("", None), (" clamp", BANK_CLAMP)):
        out[f"fastlo_df1_dec_bank{label} c={C_BANK}"] = (
            lambda st=biquad.df1_init((2 * C_BANK,), device=dev), cl=clamp:
            bank.fastlo_df1_dec_bank(ba_bank, st, inputs["ph0"],
                                     inputs["steps"], inputs["x"], 29,
                                     d=DEC, clamp=cl, time_chunk=TC))
    out[f"fastlo_ddc_bank_block c={C_BANK}"] = (
        lambda st=biquad.df1_init((2 * C_BANK,), device=dev),
        pst=pll.init((C_BANK,), device=dev): bank.fastlo_ddc_bank_block(
            ba_bank, pll_ba, st, pst, inputs["ph0"], inputs["steps"],
            inputs["x"], 29, d=DEC, time_chunk=TC))
    ba_lk = biquad.from_cookbook(sub["design"].Filter().critical_frequency(
        0.002).lowpass()).astype(np.float32)
    lo_fs = np.linspace(0.05, 0.45, C_LOCKIN)
    out[f"ddc_lockin_bank c={C_LOCKIN}"] = (
        lambda st=biquad.df1_init((2 * C_LOCKIN,), torch.float32,
                                  device=dev):
        sub["filters.ddc_lockin_cuda"].ddc_lockin_bank(
            ba_lk, st, inputs["xlk"], lo_fs, 0, time_chunk=TC_LOCKIN))
    lp0 = lowpass.init(2, (2048,), device=dev)
    pll0 = pll.init((1024,), device=dev)
    out["fastlo_ddc_bank_block_lp c=1024"] = lambda: k6(
        gains, pll_ba, lp0, pll0, inputs["ph0"], inputs["steps"],
        inputs["x"], d=DEC, time_chunk=TC)
    out[f"pll_bank c={C_BANK}"] = (
        lambda st=pll.init((C_BANK,), device=dev):
        sub["filters.pll_cuda"].pll_bank(pll_ba, st, inputs["ph"]))
    out[f"lowpass_bank c={2 * C_BANK}"] = (
        lambda st=lowpass.init(2, (2 * C_BANK,), device=dev):
        sub["filters.lowpass_cuda"].lowpass_bank(gains, st, inputs["xs1024"],
                                                 dec=DEC))
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
        out[f"hbf_dec_cascade_mxu highest c={c}"] = (
            lambda st=dec0, x=inputs[f"hbf{c}"]:
            sub["filters.hbf_mxu"].hbf_dec_cascade_mxu(
                st, x, precision="highest"))
        out[f"hbf_int_cascade_mxu highest c={c}"] = (
            lambda st=int0, x=inputs[f"low{c}"]:
            sub["filters.hbf_mxu"].hbf_int_cascade_mxu(
                st, x, precision="highest"))
    cic, cic_cuda = sub["filters.cic"], sub["filters.cic_cuda"]
    for c in (512, 1024):
        cic0 = cic.init(3, 1, (c,), device=dev)
        out[f"cic_dec_bank R={CIC_R} c={c}"] = (
            lambda st=cic0, x=inputs[f"cic{c}"]:
            cic_cuda.cic_dec_bank(st, x, CIC_R - 1))
        out[f"cic_int_bank R={CIC_R} c={c}"] = (
            lambda st=cic0, x=inputs[f"cicl{c}"]:
            cic_cuda.cic_int_bank(st, x, CIC_R - 1))
        out[f"cic_dec_bank R={COMP_R} c={c}"] = (
            lambda st=cic0, x=inputs[f"comp{c}"]:
            cic_cuda.cic_dec_bank(st, x, COMP_R - 1))
    wdf, wdf_cuda = sub["filters.wdf"], sub["filters.wdf_cuda"]

    def stages(spec):
        return [(wdf.nibbles(m, n), wdf.quantize(wdf.nibbles(m, n), g))
                for m, n, g in spec]

    def zero(branch):
        return [wdf.init(len(tp), (C_WDF,), device=dev) for tp, _ in branch]

    ca7 = [stages(br) for br in WDF_CA7]
    ca19 = [stages(br) for br in WDF_CA19]
    (tp, a), = ca7[0][:1]
    xw = inputs["wdf"]
    out[f"wdf_bank c={C_WDF}"] = (
        lambda st=zero([(tp, a)])[0]: wdf_cuda.wdf_bank(tp, a, st, xw))
    out[f"wdf_chain_bank c={C_WDF}"] = (
        lambda st=zero(ca19[0]): wdf_cuda.wdf_chain_bank(ca19[0], st, xw))
    for name, pair in (("ca7", ca7), ("ca19", ca19)):
        out[f"wdf_pair_bank {name} c={C_WDF}"] = (
            lambda pair=pair, st=tuple(zero(br) for br in pair):
            wdf_cuda.wdf_pair_bank(*pair, st, xw))
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
    ap.add_argument("--only", default="",
                    help="comma-separated substrings of the kernels to time")
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
    # the parent tree's design code makes the shared inputs' planes
    trees_biquad = importlib.import_module("ab_parent.filters.biquad")
    trees_design = importlib.import_module("ab_parent.design")

    def i32(shape, lo=-(2**31), hi=2**31):
        return torch.from_numpy(rng.integers(lo, hi, size=shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    inputs = {f"xs{c}": i32((T, 2 * c), -(2**27), 2**27) for c in (512, 1024)}
    for c in (512, 1024):
        inputs[f"hbf{c}"] = torch.from_numpy(
            rng.normal(size=(T, c)).astype(np.float32)).to(dev)
        inputs[f"low{c}"] = torch.from_numpy(
            rng.normal(size=(T >> DEPTH, c)).astype(np.float32)).to(dev)
    for c in (512, 1024):  # the CIC's, as chip_smoke.py's phase 6
        inputs[f"cic{c}"] = i32((T, c), -(2**16), 2**16)
        inputs[f"cicl{c}"] = i32((T // CIC_R, c), -(2**10), 2**10)
        inputs[f"comp{c}"] = i32((T, c), -(2**20), 2**20)
    inputs["wdf"] = i32((T, C_WDF), -(2**24), 2**24)
    inputs["iq"] = (i32((T, C_FM)), i32((T, C_FM)))
    inputs["x64"] = torch.from_numpy(rng.integers(
        -(2**55), 2**55, size=(T, C_SERIAL), dtype=np.int64)).to(dev)
    inputs["rpll"] = (i32((T, C_SERIAL)), torch.from_numpy(
        rng.integers(0, 64, size=(T, C_SERIAL)) == 0).to(dev))
    inputs.update(x=i32((T,), -(2**27), 2**27),
                  ph0=torch.zeros((1024,), dtype=torch.int32, device=dev),
                  steps=i32((1024,), 1 << 24, 1 << 30))
    for n in N_CH:
        inputs[f"ch{n}"] = tuple(torch.from_numpy(rng.normal(
            size=(n, M_CH)).astype(np.float32)).to(dev) for _ in range(2))
    inputs["x29"] = i32((T, C_SERIAL), -(2**24), 2**24)
    inputs["x32"] = i32((T, C_SERIAL))
    inputs["xf"] = torch.from_numpy(
        rng.normal(size=(T, C_SERIAL)).astype(np.float32)).to(dev)
    inputs["xlk"] = torch.from_numpy(
        rng.normal(size=T).astype(np.float32)).to(dev)
    inputs["planes29"] = torch.from_numpy(np.stack([
        trees_biquad.quantize_ba(trees_biquad.from_cookbook(
            trees_design.Filter().critical_frequency(fc).lowpass()), 29)
        for fc in rng.uniform(0.01, 0.2, C_SERIAL)], axis=1)).to(dev)
    inputs["x16"] = i32((T, C_SERIAL), -(2**14), 2**14).to(torch.int16)
    inputs["ph"] = i32((T // DEC, C_BANK))  # K5's phases
    fns = {k: cases(f"ab_{k}", dev, inputs) for k in trees}
    only = [o for o in args.only.split(",") if o]
    names = [n for n in fns["parent"] if not only or any(o in n for o in only)]
    for k in trees:  # warm up, and the two trees compute the same words
        for n in names:
            fns[k][n]()
    def outputs(res):  # the tensors of a call's outputs (its last item)
        out = res[-1]
        return list(out) if isinstance(out, (tuple, list)) else [out]

    for n in names:
        a, b = fns["parent"][n](), fns["change"][n]()
        for u, v in zip(outputs(a), outputs(b), strict=True):
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
