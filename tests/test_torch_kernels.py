"""The CUDA kernels K1-K41 against their plain PyTorch versions, on the card.

Marked ``requires_cuda``; each test skips (inside its fixture) where no
CUDA device is present.  No jax here, so the file also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels.py

On the card every K1-K16 and K18-K40 output (with the ``clamp=`` forms
of K3 and K12; K22/K23 at precision "highest") must equal its plain
version bit for bit: the integer paths are the same int64 arithmetic,
and the kernels' f32 operations are single-rounding intrinsics in the
plain versions' order, as eager PyTorch rounds each operation.  K17's
matrix products sum in another order than torch.matmul: its outputs are
held within 2e-5 of the output scale (the JAX package's own
fused-vs-planes gate), its history bit for bit, at clusters of 1, 3 and 8
CTAs; two plans (64- and 128-frame tiles) and a block against its two
halves bit for bit; a plan beyond the shared memory raises.  K22/K23 at
"split3" and "default" run bf16 ``mma.sync`` products whose k-step sums
are the tensor cores' own: they are held within MXU_TOL of the scale, and
bit for bit across tilings, range counts and two half blocks.  K41 (the
peer put of `halo_exchange_prev_rdma`) runs in 2 spawned processes on
one card (`torch_ranks.spawn`), against the gloo ring on CPU copies,
bit for bit.
"""

import numpy as np
import pytest
import torch

from idsp_tpu_torch import fxp
from idsp_tpu_torch.design import Filter
from idsp_tpu_torch.filters import biquad
from idsp_tpu_torch.filters.biquad_cuda import (
    df1_bank_f32,
    df1_bank_f32_plain,
    df1_bank_q16,
    df1_bank_q16_plain,
    df1_bank_q64,
    df1_bank_q64_plain,
    df1_dither_bank,
    df1_dither_bank_coef,
    df1_dither_bank_coef_plain,
    df1_dither_bank_plain,
    df1_wide_bank_coef,
    df1_wide_bank_coef_plain,
    df1_bank_q,
    df1_bank_q_dec,
    df1_bank_q_dec_plain,
    df1_bank_q_plain,
    df1_bank_q_coef,
    df1_bank_q_coef_plain,
    df1_clamp_bank_q,
    df1_clamp_bank_q_coef,
    df1_clamp_bank_q_coef_plain,
    df1_clamp_bank_q_plain,
    df1_wide_bank,
    df1_wide_bank_plain,
    sos_bank_q,
    sos_bank_q_plain,
)
from idsp_tpu_torch.filters.ddc_cuda import (
    ddc_mix_df1_bank,
    ddc_mix_df1_bank_plain,
    df1_clamp_hbf_cascade_bank,
    df1_clamp_hbf_cascade_bank_plain,
    df1_hbf1_bank,
    df1_hbf1_bank_plain,
    df1_hbf12_bank,
    df1_hbf12_bank_plain,
    df1_hbf_cascade_bank,
    df1_hbf_cascade_bank_plain,
    fastlo_ddc_cascade_bank,
    fastlo_ddc_cascade_bank_plain,
    hbf1_tail_init,
)
from idsp_tpu_torch.filters import cic, hbf, lowpass, pll
from idsp_tpu_torch.filters.cic_cuda import (
    cic_dec_bank,
    cic_dec_bank_plain,
    cic_int_bank,
    cic_int_bank_plain,
    cic_plan,
)
from idsp_tpu_torch.filters.ddc_bank_cuda import (
    bank_plan,
    fastlo_ddc_bank_block,
    fastlo_ddc_bank_block_lp,
    fastlo_ddc_bank_block_lp_plain,
    fastlo_ddc_bank_block_plain,
    fastlo_df1_dec_bank,
    fastlo_df1_dec_bank_plain,
)
from idsp_tpu_torch.filters.hbf import HBF_TAPS
from idsp_tpu_torch.filters.hbf_cuda import (
    hbf_dec_cascade_bank,
    hbf_dec_cascade_bank_plain,
    hbf_int_cascade_bank,
    hbf_int_cascade_bank_plain,
)
from idsp_tpu_torch.filters import hbf_mxu
from idsp_tpu_torch.filters.hbf_mxu import (
    hbf_dec_cascade_mxu,
    hbf_dec_cascade_mxu_plain,
    hbf_int_cascade_mxu,
    hbf_int_cascade_mxu_plain,
)
from idsp_tpu_torch.filters.ddc_lockin_cuda import (
    ddc_lockin_bank,
    ddc_lockin_bank_plain,
)
from idsp_tpu_torch.filters.fm_cuda import fm_disc_bank, fm_disc_bank_plain
from idsp_tpu_torch.filters.lowpass_cuda import (
    lowpass_bank,
    lowpass_bank_plain,
    lowpass_plan,
)
from idsp_tpu_torch.filters.pll_cuda import pll_bank, pll_bank_plain, pll_plan
from idsp_tpu_torch.ops.unwrap import ClampWrapState
from idsp_tpu_torch.filters import normal, rpll, svf, wdf
from idsp_tpu_torch.filters.normal_cuda import (
    normal_bank_f32,
    normal_bank_f32_plain,
    normal_bank_q,
    normal_bank_q_plain,
)
from idsp_tpu_torch.filters.rpll_cuda import rpll_bank, rpll_bank_plain
from idsp_tpu_torch.filters.svf_cuda import svf_bank, svf_bank_plain
from idsp_tpu_torch.filters import wdf_cuda
from idsp_tpu_torch.filters.wdf_cuda import (
    WDF_MAX,
    wdf_bank,
    wdf_bank_plain,
    wdf_chain_bank,
    wdf_chain_bank_plain,
    wdf_pair_bank,
    wdf_pair_bank_plain,
)
from idsp_tpu_torch.pipelines import channelizer, fm_disc
from idsp_tpu_torch.pipelines.channelizer_cuda import (
    channelize_fused,
    channelize_fused_plain,
    launch_plan,
)

BA_Q = biquad.quantize_ba(
    biquad.from_cookbook(Filter().critical_frequency(0.02).lowpass()), 29)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a CUDA kernel with its "
                    "plain PyTorch version")
    return torch.device("cuda")


def _i32(rng, shape, lo=-(2**31), hi=2**31, device=None):
    a = rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(a).to(device)


def _equal(a, b):
    for u, v in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if isinstance(u, tuple):
            _equal(u, v)
        else:
            assert u.dtype == v.dtype and u.shape == v.shape
            assert torch.equal(u, v), (u != v).sum().item()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_df1_bank_q_kernel_equals_plain(cuda, out_dtype):
    c, t = 256, 1000  # t not a multiple of the kernel's row group
    rng = np.random.default_rng(30)
    st = biquad.Df1State(x=_i32(rng, (c, 2), device=cuda),
                         y=_i32(rng, (c, 2), device=cuda))
    st_p = st
    for _ in range(3):
        xs = _i32(rng, (t, c), device=cuda)
        st, ys = df1_bank_q(BA_Q, st, xs, 29, out_dtype=out_dtype)
        st_p, ys_p = df1_bank_q_plain(BA_Q, st_p, xs, 29, out_dtype=out_dtype)
        torch.cuda.synchronize()
        _equal((st.x, st.y, ys), (st_p.x, st_p.y, ys_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("depth", [1, 3])
def test_df1_hbf_cascade_kernel_equals_plain(cuda, depth):
    c2, t = 256, 1024
    taps = tuple(HBF_TAPS[2 - d] for d in range(depth))
    rng = np.random.default_rng(31)
    st = biquad.df1_init((c2,), device=cuda)
    tails = tuple(hbf1_tail_init(c2, len(tv), device=cuda) for tv in taps)
    st_p, tails_p = st, tails
    for _ in range(3):
        xs = _i32(rng, (t, c2), -(2**27), 2**27, device=cuda)
        st, tails, y = df1_hbf_cascade_bank(BA_Q, st, tails, xs, 29,
                                            taps=taps, time_chunk=128)
        st_p, tails_p, y_p = df1_hbf_cascade_bank_plain(
            BA_Q, st_p, tails_p, xs, 29, taps=taps)
        torch.cuda.synchronize()
        _equal((st.x, st.y, tails, y), (st_p.x, st_p.y, tails_p, y_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tc", [16, 128])
def test_fastlo_cascade_kernel_equals_plain(cuda, tc):
    c, t = 128, 1024
    rng = np.random.default_rng(32)
    p0 = _i32(rng, (c,), device=cuda)
    steps = _i32(rng, (c,), 1 << 24, 1 << 30, device=cuda)
    st = biquad.df1_init((2 * c,), device=cuda)
    tails = tuple(hbf1_tail_init(2 * c, m, device=cuda) for m in (5, 10, 23))
    ph, st_p, tails_p, ph_p = p0, st, tails, p0
    for _ in range(3):
        x = _i32(rng, (t,), -(2**27), 2**27, device=cuda)
        st, tails, ph, y = fastlo_ddc_cascade_bank(
            BA_Q, st, tails, ph, steps, x, 29, time_chunk=tc)
        st_p, tails_p, ph_p, y_p = fastlo_ddc_cascade_bank_plain(
            BA_Q, st_p, tails_p, ph_p, steps, x, 29, time_chunk=tc)
        torch.cuda.synchronize()
        _equal((st.x, st.y, tails, ph, y), (st_p.x, st_p.y, tails_p, ph_p, y_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,dec,t", [(1, 1, 1000), (2, 8, 1000),
                                     (2, 16, 1024)])
def test_lowpass_bank_kernel_equals_plain(cuda, n, dec, t):
    # c not a multiple of the 32-lane block; t = 1000 leaves a tail of
    # rows after the last full prefetch group
    c = 200
    rng = np.random.default_rng(33)
    k = lowpass.gains1(0.01) if n == 1 else lowpass.gains2(0.2)
    st = lowpass.LowpassState(p=torch.from_numpy(
        rng.integers(-(2**55), 2**55, size=(c, n), dtype=np.int64)).to(cuda))
    st_p = st
    for _ in range(3):
        xs = _i32(rng, (t, c), device=cuda)
        xs[::5] = 2**31 - 1  # the saturating subtraction
        xs[1::7] = -(2**31)
        st, ys = lowpass_bank(k, st, xs, dec=dec)
        st_p, ys_p = lowpass_bank_plain(k, st_p, xs, dec=dec)
        torch.cuda.synchronize()
        _equal((st.p, ys), (st_p.p, ys_p))


@pytest.mark.requires_cuda
def test_pll_bank_kernel_equals_plain(cuda):
    c, t = 200, 512
    rng = np.random.default_rng(34)
    ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    st = pll.init((c,), device=cuda)
    st_p = st
    for _ in range(3):
        xs = _i32(rng, (t, c), device=cuda)
        st, ys = pll_bank(ba, st, xs)
        st_p, ys_p = pll_bank_plain(ba, st_p, xs)
        torch.cuda.synchronize()
        _equal((st, ys), (st_p, ys_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,tc", [(2, 128), (2, 32), (1, 64)])
def test_fastlo_ddc_bank_lp_kernel_equals_plain(cuda, n, tc):
    c, t, d = 100, 1024, 16
    rng = np.random.default_rng(35)
    k = lowpass.gains1(0.004) if n == 1 else lowpass.gains2(0.004)
    ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    steps = _i32(rng, (c,), 1 << 24, 1 << 30, device=cuda)
    carry = (lowpass.init(n, (2 * c,), device=cuda),
             pll.init((c,), device=cuda), _i32(rng, (c,), device=cuda))
    carry_p = carry
    for _ in range(3):
        x = _i32(rng, (t,), -(2**27), 2**27, device=cuda)
        out = fastlo_ddc_bank_block_lp(k, ba, *carry, steps, x, d=d,
                                       time_chunk=tc)
        out_p = fastlo_ddc_bank_block_lp_plain(k, ba, *carry_p, steps, x,
                                               d=d, time_chunk=tc)
        torch.cuda.synchronize()
        _equal(out, out_p)
        carry, carry_p = out[:3], out_p[:3]


def _lp_edge_state(rng, shape, device):
    """Lowpass state words within 2^40 of int64's ends, or of 0."""
    base = rng.choice(np.array([-(2**63), 0, 2**63 - 1], np.int64), shape)
    off = rng.integers(0, 2**40, shape, dtype=np.int64)
    return lowpass.LowpassState(p=torch.from_numpy(
        np.where(base < 0, base + off, base - off)).to(device))


# K4 at the depth-0 pipeline's edges: (N, lanes, t, dec, plan keywords);
# states at int64's edges, x a third at int32's ends: the subtract
# saturates and the regrouped sums wrap; `_lp_gains`
LP_PIPE_EDGES = [
    (2, 64, 999, 3, dict(chunk=40, ring=3)),       # chunk % dec, t % chunk
    (1, 33, 1, 1, {}),                             # t = 1
    (2, 50, 100, 1, dict(producers=3)),            # t under a chunk
    (1, 40, 7 * 64 + 48, 16, dict(chunk=24, producers=11, warps=16)),
    (2, 2048, 1024, 16, {}),                       # the bank's lanes
]


def _lp_gains(kind, n):
    """Lowpass gains: the #5 bank's, gains of 2^30 and opposite signs, or
    int32's ends (e k0 = 2^62)."""
    if kind == "bank":
        return lowpass.gains1(0.01) if n == 1 else lowpass.gains2(0.004)
    if kind == "mixed":
        return np.array([-(2**30), 2**30 - 1][:n], np.int32)
    return np.array([-(2**31), 2**31 - 1][:n], np.int32)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("gains", ["bank", "mixed", "edge"])
@pytest.mark.parametrize("n,c,t,dec,kw", LP_PIPE_EDGES)
def test_lowpass_bank_kernel_at_the_edges(cuda, n, c, t, dec, kw, gains):
    rng = np.random.default_rng(40 + c)
    k = _lp_gains(gains, n)
    st = _lp_edge_state(rng, (c, n), cuda)
    st_p, plan = st, lowpass_plan(c, **kw)
    for _ in range(2):
        xs = _i32(rng, (t, c), device=cuda)
        xs[::3] = 2**31 - 1
        xs[1::5] = -(2**31)
        st, ys = lowpass_bank(k, st, xs, dec=dec, _plan=plan)
        st_p, ys_p = lowpass_bank_plain(k, st_p, xs, dec=dec)
        torch.cuda.synchronize()
        _equal((st.p, ys), (st_p.p, ys_p))


# K6 at the edges of K12/K13's kernel: (N, c, t, d, time chunk, plan
# keywords); states at int64's edges, so the subtract saturates on the
# mixed stream
K6_PIPE_EDGES = [
    (2, 1024, 2048, 16, 128, {}),                       # the bank's width
    (2, 20, 40, 1, 8, dict(chunk=16, ring=2)),          # every row kept
    (1, 17, 256, 4, 128, dict(chunk=96)),               # 17 channels
    (2, 3, 96, 16, 48, dict(chunk=8, ring=4)),          # chunks under d
    (1, 1, 64, 4, 16, dict(chunk=12, producers=1)),     # one channel
    (2, 9, 1024, 8, 512, dict(chunk=256, producers=11, warps=16)),
    (2, 40, 768, 16, 32, dict(chunk=64, producers=3)),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("gains", ["bank", "mixed", "edge"])
@pytest.mark.parametrize("n,c,t,d,tc,kw", K6_PIPE_EDGES)
def test_fastlo_ddc_bank_lp_kernel_at_the_edges(cuda, n, c, t, d, tc, kw,
                                                gains):
    rng = np.random.default_rng(45 + c)
    k = _lp_gains(gains, n)
    ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    steps = _i32(rng, (c,), device=cuda)
    carry = (_lp_edge_state(rng, (2 * c, n), cuda),
             pll_bank_plain(ba, pll.init((c,), device=cuda),
                            _i32(rng, (7, c), device=cuda))[0],
             _i32(rng, (c,), device=cuda))
    carry_p, plan = carry, bank_plan(c, **kw)
    for _ in range(2):
        x = _i32(rng, (t,), -(2**27), 2**27, device=cuda)
        out = fastlo_ddc_bank_block_lp(k, ba, *carry, steps, x, d=d,
                                       time_chunk=tc, _plan=plan)
        out_p = fastlo_ddc_bank_block_lp_plain(k, ba, *carry_p, steps, x,
                                               d=d, time_chunk=tc)
        torch.cuda.synchronize()
        _equal(out, out_p)
        carry, carry_p = out[:3], out_p[:3]


def _pll_edge_state(rng, c, device):
    """A PLL state at the edges: f and f0 within 2^40 of int64's ends or of
    0 (a quarter of f0's low words 0xFFFFFFFF), cl -1, 0 or 1, x0 within
    2^8 of a wrap, z0, y0 and y full range."""
    def i64():
        base = rng.choice(np.array([-(2**63), 0, 2**63 - 1], np.int64), c)
        off = rng.integers(0, 2**40, c, dtype=np.int64)
        return np.where(base < 0, base + off, base - off)

    def t(v):
        return torch.from_numpy(np.asarray(v)).to(device)

    f0 = i64()
    f0 = np.where(rng.random(c) < 0.25, f0 | 0xFFFFFFFF, f0)
    end = rng.choice(np.array([-(2**31), 2**31 - 1], np.int64), c)
    x0 = (end - np.sign(end) * rng.integers(0, 256, c)).astype(np.int32)
    return pll.PllState(
        clamp=ClampWrapState(x0=t(x0), clamp=t(rng.integers(
            -1, 2, c).astype(np.int8))),
        z0=_i32(rng, (c,), device=device), y0=_i32(rng, (c,), device=device),
        f0=t(f0), f=t(i64()), y=_i32(rng, (c,), device=device))


# K5 at the depth-0 pipeline's edges: (c, t, plan keywords)
PLL_PIPE_EDGES = [
    (1024, 2048, {}),                                # the #5 bank's
    (200, 1, {}),                                    # t = 1
    (50, 100, dict(producers=3)),                    # t under a chunk
    (33, 999, dict(chunk=40)),                       # t % chunk, c % 4
    (40, 7 * 64 + 48, dict(chunk=24, producers=11, warps=16)),
    (1, 64, dict(chunk=12, producers=1)),            # one channel
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("coefs", ["bank", "edge"])
@pytest.mark.parametrize("c,t,kw", PLL_PIPE_EDGES)
def test_pll_bank_kernel_at_the_edges(cuda, c, t, kw, coefs):
    """K5 from edge states over 2 carried blocks of full-range phases, the
    #5 bank's loop or coefficients at int32's ends (a1 = INT32_MIN)."""
    rng = np.random.default_rng(50 + c + t)
    ba = (pll.coefficients_from_bandwidth(2e-2, 4.0) if coefs == "bank"
          else np.array([-(2**31), 2**31 - 1, -(2**31)], np.int64))
    st = st_p = _pll_edge_state(rng, c, cuda)
    plan = pll_plan(c, **kw)
    for _ in range(2):
        xs = _i32(rng, (t, c), device=cuda)
        st, ys = pll_bank(ba, st, xs, _plan=plan)
        st_p, ys_p = pll_bank_plain(ba, st_p, xs)
        torch.cuda.synchronize()
        _equal((st, ys), (st_p, ys_p))


@pytest.mark.requires_cuda
def test_pll_entry_refuses_a_plan_not_its_own(cuda):
    """K5's entry point refuses a plan whose shared memory is not the
    kernel's own sum, or roles that do not fit the warps (RuntimeError,
    nothing launched); the next launch runs as usual."""
    c, t = 64, 256
    rng = np.random.default_rng(5)
    ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    st = pll.init((c,), device=cuda)
    xs = _i32(rng, (t, c), device=cuda)
    plan = pll_plan(c)
    n0 = pll_bank.launches
    for bad in (plan._replace(smem=plan.smem - 32),
                plan._replace(producers=6)):  # 8 roles in 6 places
        with pytest.raises(RuntimeError):
            pll_bank(ba, st, xs, _plan=bad)
    assert pll_bank.launches == n0
    _equal(pll_bank(ba, st, xs), pll_bank_plain(ba, st, xs))


@pytest.mark.requires_cuda
def test_lowpass_entries_refuse_a_plan_not_their_own(cuda):
    """K4's and K6's entry points refuse a plan whose shared memory is not
    the kernel's own sum, or roles that do not fit the warps (RuntimeError,
    nothing launched); the next launch runs as usual."""
    c, t = 64, 256
    rng = np.random.default_rng(4)
    k = lowpass.gains2(0.004)
    ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    st = lowpass.init(2, (c,), device=cuda)
    xs = _i32(rng, (t, c), -(2**27), 2**27, device=cuda)
    plan = lowpass_plan(c)
    lp = lowpass.init(2, (2 * c,), device=cuda)
    pst = pll.init((c,), device=cuda)
    ph = _i32(rng, (c,), device=cuda)
    x = _i32(rng, (t,), -(2**27), 2**27, device=cuda)
    bplan = bank_plan(c)
    for bad, bbad in ((plan._replace(smem=plan.smem - 32),
                       bplan._replace(smem=bplan.smem + 32)),
                      (plan._replace(producers=6),  # 8 roles in 6 places
                       bplan._replace(producers=9))):  # 10 roles in 9
        with pytest.raises(RuntimeError):
            lowpass_bank(k, st, xs, dec=16, _plan=bad)
        with pytest.raises(RuntimeError):
            fastlo_ddc_bank_block_lp(k, ba, lp, pst, ph, ph, x, _plan=bbad)
    _equal(lowpass_bank(k, st, xs, dec=16),
           lowpass_bank_plain(k, st, xs, dec=16))
    _equal(fastlo_ddc_bank_block_lp(k, ba, lp, pst, ph, ph, x),
           fastlo_ddc_bank_block_lp_plain(k, ba, lp, pst, ph, ph, x))


@pytest.mark.requires_cuda
def test_wrappers_reject_bad_input(cuda):
    st = biquad.df1_init((128,), device=cuda)
    xs = torch.zeros((100, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        df1_bank_q(BA_Q, st, xs.to(torch.int64), 29)
    with pytest.raises(ValueError):
        df1_bank_q(BA_Q, st, torch.zeros((128, 100), dtype=torch.int32,
                                       device=cuda).T, 29)
    tails = tuple(hbf1_tail_init(128, m, device=cuda) for m in (5, 10, 23))
    with pytest.raises(ValueError):  # 100 % 128 != 0
        df1_hbf_cascade_bank(BA_Q, st, tails, xs, 29)
    lp = lowpass.init(2, (128,), device=cuda)
    with pytest.raises(ValueError):  # 100 % 16 != 0
        lowpass_bank(lowpass.gains2(0.01), lp, xs, dec=16)
    with pytest.raises(ValueError):  # int64 phases
        pll_bank(pll.coefficients_from_bandwidth(2e-2), pll.init(
            (128,), device=cuda), xs.to(torch.int64))


# forced range counts: one, two, ranges shorter than the halo (K7's is
# 912 full-rate rows, K8's 57 low-rate rows at depth 4), one row each
HBF_RANGES = [1, 2, 16, 10**6]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tname", ["HBF_TAPS", "HBF_TAPS_98"])
@pytest.mark.parametrize("ranges", [None, *HBF_RANGES])
@pytest.mark.parametrize("depth,tc", [(1, 64), (2, 512), (4, 512), (4, 64)])
def test_hbf_dec_cascade_kernel_equals_plain(cuda, depth, tc, ranges, tname):
    c, t = 200, 2048  # c not a multiple of the 32-lane tile
    taps = getattr(hbf, tname)
    rng = np.random.default_rng(36)
    st = tuple(hbf.HbfDecState(odd=torch.randn_like(s.odd),
                               even=torch.randn_like(s.even))
               for s in hbf.hbf_dec_cascade_init(depth, (c,), taps=taps,
                                                 axis=0, device=cuda))
    st_p = st
    for _ in range(3):
        x = torch.from_numpy(rng.normal(size=(t, c)).astype(np.float32)).to(
            cuda)
        st, y = hbf_dec_cascade_bank(st, x, taps=taps, time_chunk=tc,
                                     ranges=ranges)
        st_p, y_p = hbf_dec_cascade_bank_plain(st_p, x, taps=taps)
        torch.cuda.synchronize()
        _equal((st, y), (st_p, y_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tname", ["HBF_TAPS", "HBF_TAPS_98"])
@pytest.mark.parametrize("ranges", [None, *HBF_RANGES])
@pytest.mark.parametrize("depth,tc", [(1, 64), (3, 32), (4, 64), (4, 8)])
def test_hbf_int_cascade_kernel_equals_plain(cuda, depth, tc, ranges, tname):
    c, t = 200, 256
    taps = getattr(hbf, tname)
    rng = np.random.default_rng(37)
    st = tuple(hbf.HbfIntState(x=torch.randn_like(s.x))
               for s in hbf.hbf_int_cascade_init(depth, (c,), taps=taps,
                                                 axis=0, device=cuda))
    st_p = st
    for _ in range(3):
        x = torch.from_numpy(rng.normal(size=(t, c)).astype(np.float32)).to(
            cuda)
        st, y = hbf_int_cascade_bank(st, x, taps=taps, time_chunk=tc,
                                     ranges=ranges)
        st_p, y_p = hbf_int_cascade_bank_plain(st_p, x, taps=taps)
        torch.cuda.synchronize()
        _equal((st, y), (st_p, y_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,m,rate", [(3, 1, 15), (2, 2, 3), (4, 1, 4),
                                      (8, 1, 1)])
def test_cic_bank_kernels_equal_plain(cuda, n, m, rate):
    c, r = 200, rate + 1
    rng = np.random.default_rng(38)
    st = cic.CicState(*(_i32(rng, tuple(v.shape), device=cuda)
                        for v in cic.init(n, m, (c,), device=cuda)))
    st_p = st
    for _ in range(3):
        xs = _i32(rng, (64 * r + 16 * r, c), device=cuda)  # wraps by design
        st, ys = cic_dec_bank(st, xs, rate)
        st_p, ys_p = cic_dec_bank_plain(st_p, xs, rate)
        torch.cuda.synchronize()
        _equal((st, ys), (st_p, ys_p))
    st = st_p = cic.init(n, m, (c,), device=cuda)
    lim = 2**31 // cic.gain(rate, n, m) // 4
    for _ in range(3):
        xs = _i32(rng, (37, c), -lim, lim, device=cuda)
        st, ys = cic_int_bank(st, xs, rate)
        st_p, ys_p = cic_int_bank_plain(st_p, xs, rate)
        torch.cuda.synchronize()
        _equal((st, ys), (st_p, ys_p))


@pytest.mark.requires_cuda
def test_rate_conversion_wrappers_reject_bad_input(cuda):
    dec = hbf.hbf_dec_cascade_init(4, (128,), axis=0, device=cuda)
    with pytest.raises(ValueError):  # 100 % 16 != 0
        hbf_dec_cascade_bank(dec, torch.zeros((100, 128), device=cuda))
    with pytest.raises(ValueError):  # int32 input
        hbf_dec_cascade_bank(dec, torch.zeros((128, 128), dtype=torch.int32,
                                              device=cuda))
    itp = hbf.hbf_int_cascade_init(4, (128,), axis=0, device=cuda)
    with pytest.raises(RuntimeError):  # 256 KB of shared memory a block
        hbf_int_cascade_bank(itp, torch.zeros((128, 128), device=cuda),
                             time_chunk=128)
    st = cic.init(3, 1, (128,), device=cuda)
    with pytest.raises(ValueError):  # 100 % 16 != 0
        cic_dec_bank(st, torch.zeros((100, 128), dtype=torch.int32,
                                     device=cuda), 15)
    with pytest.raises(ValueError):  # 9 integrator stages
        cic_dec_bank(cic.init(9, 1, (128,), device=cuda),
                     torch.zeros((32, 128), dtype=torch.int32, device=cuda), 15)
    # plans the kernel cannot run: the C entry refuses them
    xs = torch.zeros((256, 128), dtype=torch.int32, device=cuda)
    plan = cic_plan(256, 128, 3, 16, warps=4, cluster=2)
    for bad in (plan._replace(smem=plan.smem + 4),  # not its own sum
                plan._replace(length=8),  # kept rows across ranges
                plan._replace(length=16, cluster=1)):  # 16 ranges, 4 warps
        with pytest.raises(RuntimeError):
            cic_dec_bank(st, xs, 15, _plan=bad)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d,out_dtype,t", [(16, None, 1024), (12, None, 996),
                                           (16, torch.float32, 1024)])
def test_df1_bank_q_dec_kernel_equals_plain(cuda, d, out_dtype, t):
    # c not a multiple of the 32-lane block; t = 996 leaves a tail of rows
    # after the last full prefetch group
    c = 200
    rng = np.random.default_rng(39)
    st = biquad.Df1State(x=_i32(rng, (c, 2), device=cuda),
                         y=_i32(rng, (c, 2), device=cuda))
    st_p = st
    for _ in range(3):
        xs = _i32(rng, (t, c), device=cuda)
        st, ys = df1_bank_q_dec(BA_Q, st, xs, 29, d=d, out_dtype=out_dtype)
        st_p, ys_p = df1_bank_q_dec_plain(BA_Q, st_p, xs, 29, d=d,
                                          out_dtype=out_dtype)
        torch.cuda.synchronize()
        _equal((st.x, st.y, ys), (st_p.x, st_p.y, ys_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_pll", [False, True])
@pytest.mark.parametrize("d,tc,t", [(16, 128, 1024), (16, 32, 1024),
                                    (12, 96, 768)])
def test_fastlo_df1_bank_kernels_equal_plain(cuda, with_pll, d, tc, t):
    """K12 (without the PLL) and K13 (with it)."""
    c = 100
    rng = np.random.default_rng(40)
    ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    steps = _i32(rng, (c,), 1 << 24, 1 << 30, device=cuda)
    st = biquad.Df1State(x=_i32(rng, (2 * c, 2), -(2**27), 2**27, device=cuda),
                         y=_i32(rng, (2 * c, 2), -(2**27), 2**27, device=cuda))
    carry = (st, pll.init((c,), device=cuda), _i32(rng, (c,), device=cuda))
    carry_p = carry
    for _ in range(3):
        x = _i32(rng, (t,), -(2**27), 2**27, device=cuda)
        if with_pll:
            out = fastlo_ddc_bank_block(BA_Q, ba, *carry, steps, x, 29, d=d,
                                        time_chunk=tc)
            out_p = fastlo_ddc_bank_block_plain(BA_Q, ba, *carry_p, steps, x,
                                                29, d=d, time_chunk=tc)
            carry, carry_p = out[:3], out_p[:3]
        else:
            out = fastlo_df1_dec_bank(BA_Q, carry[0], carry[2], steps, x, 29,
                                      d=d, time_chunk=tc)
            out_p = fastlo_df1_dec_bank_plain(BA_Q, carry_p[0], carry_p[2],
                                              steps, x, 29, d=d, time_chunk=tc)
            carry = (out[0], carry[1], out[1])
            carry_p = (out_p[0], carry_p[1], out_p[1])
        torch.cuda.synchronize()
        _equal(out, out_p)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_ddc_mix_df1_kernel_equals_plain(cuda, out_dtype):
    # 200 lanes: not a multiple of the 32-lane block; t = 1000 leaves a
    # tail of rows after the last full prefetch group; full-range x and
    # phases take the mix to its extremes and every octant of the LO
    c, t = 100, 1000
    rng = np.random.default_rng(41)
    steps = _i32(rng, (c,), device=cuda)
    st = biquad.Df1State(x=_i32(rng, (2 * c, 2), device=cuda),
                         y=_i32(rng, (2 * c, 2), -(2**28), 2**28, device=cuda))
    ph = _i32(rng, (c,), device=cuda)
    st_p, ph_p = st, ph
    for _ in range(3):
        x = _i32(rng, (t,), device=cuda)
        st, ph, y = ddc_mix_df1_bank(BA_Q, st, ph, steps, x, 29,
                                     out_dtype=out_dtype)
        st_p, ph_p, y_p = ddc_mix_df1_bank_plain(BA_Q, st_p, ph_p, steps, x,
                                                 29, out_dtype=out_dtype)
        torch.cuda.synchronize()
        _equal((st.x, st.y, ph, y), (st_p.x, st_p.y, ph_p, y_p))


@pytest.mark.requires_cuda
def test_biquad_bank_wrappers_reject_bad_input(cuda):
    st = biquad.df1_init((128,), device=cuda)
    xs = torch.zeros((100, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # 100 % 16 != 0
        df1_bank_q_dec(BA_Q, st, xs, 29, d=16)
    steps = torch.zeros((64,), dtype=torch.int32, device=cuda)
    x = torch.zeros((256,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # time_chunk % d != 0
        fastlo_df1_dec_bank(BA_Q, st, steps, steps, x, 29, d=16,
                            time_chunk=24)
    with pytest.raises(ValueError):  # the state is (2c, 2)
        fastlo_ddc_bank_block(BA_Q, pll.coefficients_from_bandwidth(2e-2),
                              biquad.df1_init((64,), device=cuda),
                              pll.init((64,), device=cuda), steps, steps, x)
    with pytest.raises(ValueError):  # int64 output
        ddc_mix_df1_bank(BA_Q, st, steps, steps, x, out_dtype=torch.int64)


@pytest.mark.requires_cuda
def test_refused_launch_leaves_no_pending_error(cuda):
    """A launch refused for its shared memory raises, and the next
    kernel of the library launches as usual."""
    itp = hbf.hbf_int_cascade_init(4, (128,), axis=0, device=cuda)
    with pytest.raises(RuntimeError):
        hbf_int_cascade_bank(itp, torch.zeros((128, 128), device=cuda),
                             time_chunk=128)
    st = biquad.df1_init((128,), device=cuda)
    xs = torch.ones((64, 128), dtype=torch.int32, device=cuda)
    _equal(df1_bank_q_dec(BA_Q, st, xs, 29, d=16),
           df1_bank_q_dec_plain(BA_Q, st, xs, 29, d=16))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("angle", ["exact", "fast"])
def test_fm_disc_kernel_equals_plain(cuda, angle):
    # 100 channels: not a multiple of the 32-lane block; t = 1000 leaves a
    # tail after the last prefetch group; rows of -2^31 take the conjugate
    # product's sums to 2^63; half the channels start valid
    c, t = 100, 1000
    rng = np.random.default_rng(50)
    ba = fm_disc.deemphasis_coefficients(0.02)
    st = fm_disc.FmDiscState(
        prev_re=_i32(rng, (c,), device=cuda),
        prev_im=_i32(rng, (c,), device=cuda),
        prev_valid=torch.from_numpy(np.arange(c) % 2 == 0).to(cuda),
        deemph=biquad.Df1State(x=_i32(rng, (c, 2), device=cuda),
                               y=_i32(rng, (c, 2), -(2**28), 2**28,
                                      device=cuda)))
    st_p = st
    for b in range(3):
        re, im = _i32(rng, (t, c), device=cuda), _i32(rng, (t, c), device=cuda)
        if b == 0:
            re[:3] = -(2**31)
            im[:3] = -(2**31)
        st, y = fm_disc_bank(ba, st, re, im, 0x1934_1234, angle=angle)
        st_p, y_p = fm_disc_bank_plain(ba, st_p, re, im, 0x1934_1234,
                                       angle=angle)
        torch.cuda.synchronize()
        _equal((st.prev_re, st.prev_im, st.prev_valid, st.deemph.x,
                st.deemph.y, y),
               (st_p.prev_re, st_p.prev_im, st_p.prev_valid, st_p.deemph.x,
                st_p.deemph.y, y_p))


# K14 and K15 at the depth-0 pipeline's edges (csrc/df1_ring.cuh): forced
# plans (1 and the most producers in 16 warps, 2 slots and the most that
# fit, the smallest chunk), c = 100 and 50 (not multiples
# of the 32-lane tile; K14's 200 and 100 lanes, K15's 50 channels take
# 4-byte stores), t = one chunk and 7 chunks + 40 rows
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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("case", sorted(PIPE_EDGES))
def test_ddc_mix_df1_kernel_at_pipe_edges(cuda, case, out_dtype):
    from idsp_tpu_torch.filters.ddc_cuda import mix_plan

    c, t, kw = PIPE_EDGES[case]
    plan = mix_plan(2 * c, **kw) if kw else None
    rng = np.random.default_rng(44)
    steps = _i32(rng, (c,), device=cuda)
    st = biquad.Df1State(x=_i32(rng, (2 * c, 2), device=cuda),
                         y=_i32(rng, (2 * c, 2), -(2**28), 2**28, device=cuda))
    ph = _i32(rng, (c,), device=cuda)
    st_p, ph_p = st, ph
    for _ in range(2):
        x = _i32(rng, (t,), device=cuda)
        st, ph, y = ddc_mix_df1_bank(BA_Q, st, ph, steps, x, 29,
                                     out_dtype=out_dtype, _plan=plan)
        st_p, ph_p, y_p = ddc_mix_df1_bank_plain(BA_Q, st_p, ph_p, steps, x,
                                                 29, out_dtype=out_dtype)
        torch.cuda.synchronize()
        _equal((st.x, st.y, ph, y), (st_p.x, st_p.y, ph_p, y_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("angle", ["exact", "fast"])
@pytest.mark.parametrize("case", sorted(PIPE_EDGES) + ["the other cluster"])
def test_fm_disc_kernel_at_pipe_edges(cuda, case, angle):
    """The edges at each angle's default CTAs a tile (exact: a cluster of
    2), and the 7-chunk case with the other (exact 1, fast 2)."""
    from idsp_tpu_torch.filters.fm_cuda import DISC_CLUSTER, disc_plan

    if case == "the other cluster":
        c, t, kw = 50, 7 * 64 + 40, dict(chunk=64,
                                         cluster=3 - DISC_CLUSTER[angle])
    else:
        c, t, kw = PIPE_EDGES[case]
    plan = disc_plan(c, angle, **kw) if kw else None
    rng = np.random.default_rng(54)
    ba = fm_disc.deemphasis_coefficients(0.02)
    st = fm_disc.FmDiscState(
        prev_re=_i32(rng, (c,), device=cuda),
        prev_im=_i32(rng, (c,), device=cuda),
        prev_valid=torch.from_numpy(np.arange(c) % 3 == 0).to(cuda),
        deemph=biquad.Df1State(x=_i32(rng, (c, 2), device=cuda),
                               y=_i32(rng, (c, 2), -(2**28), 2**28,
                                      device=cuda)))
    st_p = st
    for b in range(2):
        re, im = _i32(rng, (t, c), device=cuda), _i32(rng, (t, c), device=cuda)
        if b == 0:
            re[:3], im[:3] = -(2**31), -(2**31)
        st, y = fm_disc_bank(ba, st, re, im, 0x1934_1234, angle=angle,
                             _plan=plan)
        st_p, y_p = fm_disc_bank_plain(ba, st_p, re, im, 0x1934_1234,
                                       angle=angle)
        torch.cuda.synchronize()
        _equal((st.prev_re, st.prev_im, st.prev_valid, st.deemph.x,
                st.deemph.y, y),
               (st_p.prev_re, st_p.prev_im, st_p.prev_valid, st_p.deemph.x,
                st_p.deemph.y, y_p))


@pytest.mark.requires_cuda
def test_pipe_entries_refuse_a_plan_not_their_own(cuda):
    """K14's and K15's entry points refuse a plan whose shared memory is
    not the kernel's own sum, or more than a block may have (RuntimeError,
    nothing launched), and the next launch runs as usual."""
    from idsp_tpu_torch.filters.ddc_cuda import mix_plan
    from idsp_tpu_torch.filters.fm_cuda import disc_plan
    from idsp_tpu_torch.filters.pipe_plan import pipe_smem

    c, t = 64, 300
    st = biquad.df1_init((2 * c,), device=cuda)
    ph = torch.zeros((c,), dtype=torch.int32, device=cuda)
    x = torch.ones((t,), dtype=torch.int32, device=cuda)
    plan = mix_plan(2 * c)
    big = plan._replace(chunk=512, ring=2, smem=pipe_smem(512, 2))  # 256 KB
    for bad in (plan._replace(smem=plan.smem - 32), big):
        with pytest.raises(RuntimeError):
            ddc_mix_df1_bank(BA_Q, st, ph, ph, x, 29, _plan=bad)
    fst = fm_disc.init_state((c,), device=cuda)
    re = torch.ones((t, c), dtype=torch.int32, device=cuda)
    ba = fm_disc.deemphasis_coefficients(0.02)
    with pytest.raises(RuntimeError):
        fm_disc_bank(ba, fst, re, re, 5, _plan=disc_plan(c)._replace(
            producers=12))  # 13 roles in 12 warps
    _equal(ddc_mix_df1_bank(BA_Q, st, ph, ph, x, 29),
           ddc_mix_df1_bank_plain(BA_Q, st, ph, ph, x, 29))
    _equal(fm_disc_bank(ba, fst, re, re, 5)[1],
           fm_disc_bank_plain(ba, fst, re, re, 5)[1])


# K29 and K37 at the depth-0 pipeline's edges, at their own chunk (128
# rows); the most slots that fit a block at 64-row chunks are 4 (K29) and
# 7 (K37)
SERIAL_EDGES = {
    "1 producer, 2 slots": (100, 7 * 64 + 40, dict(producers=1, chunk=64,
                                                   ring=2)),
    "most producers": (50, 7 * 64 + 40, dict(producers=11, warps=16,
                                             chunk=64)),
    "most slots": (100, 7 * 64 + 40, dict(chunk=64, ring=0)),
    "chunk 1": (51, 40, dict(chunk=1, ring=2)),
    "t = one chunk": (100, 128, {}),
    "t = 7 chunks + 40": (50, 7 * 128 + 40, {}),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f,kind", [(61, "lowpass"), (47, "full")])
@pytest.mark.parametrize("case", sorted(SERIAL_EDGES))
def test_df1_bank_q64_kernel_at_pipe_edges(cuda, case, f, kind):
    from idsp_tpu_torch.filters.biquad_cuda import q64_plan

    c, t, kw = SERIAL_EDGES[case]
    if kw.get("ring") == 0:
        kw = {**kw, "ring": 4}  # the most slots of 64 rows
    plan = q64_plan(c, **kw) if kw else None
    rng = np.random.default_rng(29)
    top = 64 if kind == "full" else 56
    ba = (rng.integers(-(2**63), 2**63, 5, dtype=np.int64) if kind == "full"
          else biquad.quantize_ba(LOWPASS, 61, dtype=np.int64))

    def make(shape):
        return _ints(rng, shape, 64, -(2 ** (top - 1)), 2 ** (top - 1),
                     device=cuda)

    _carried(lambda s, x: df1_bank_q64(ba, s, x, f, _plan=plan),
             lambda s, x: df1_bank_q64_plain(ba, s, x, f),
             biquad.Df1State(x=make((c, 2)), y=make((c, 2))),
             lambda: make((t, c)), blocks=2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("sf", [12, 32, 40])
@pytest.mark.parametrize("case", sorted(SERIAL_EDGES))
def test_rpll_kernel_at_pipe_edges(cuda, case, sf):
    """Full-range timestamps, 1 in 4 valid, none over 1.5 chunks."""
    from idsp_tpu_torch.filters.rpll_cuda import rpll_plan

    c, t, kw = SERIAL_EDGES[case]
    if kw.get("ring") == 0:
        kw = {**kw, "ring": 7}  # the most slots of 64 rows
    plan = rpll_plan(c, **kw) if kw else None
    rng = np.random.default_rng(37)
    cfg = rpll.RpllConfig(dt2=8, shift_frequency=sf, shift_phase=11)

    def make(rows):
        v = rng.random((rows, c)) < 0.25
        v[rows // 3: rows // 3 + 192] = False
        return (_i32(rng, (rows, c), device=cuda),
                torch.from_numpy(v).to(cuda))

    st = rpll.RpllState(*(_i32(rng, (c,), device=cuda) for _ in range(4)))
    _structure_hold(lambda s, x, v: rpll_bank(cfg, s, x, v, _plan=plan),
                    lambda s, x, v: rpll_bank_plain(cfg, s, x, v), st, make,
                    t)


@pytest.mark.requires_cuda
def test_serial_pipe_entries_refuse_a_plan_not_their_own(cuda):
    """K29's and K37's entry points refuse a plan whose shared memory is
    not the kernel's own sum, or roles that do not fit the warps
    (RuntimeError, nothing launched); the next launch runs as usual."""
    from idsp_tpu_torch.filters.biquad_cuda import q64_plan
    from idsp_tpu_torch.filters.rpll_cuda import rpll_plan

    c, t = 64, 300
    st = biquad.df1_init((c,), torch.int64, device=cuda)
    x = torch.ones((t, c), dtype=torch.int64, device=cuda)
    b64 = biquad.quantize_ba(LOWPASS, 61, dtype=np.int64)
    plan = q64_plan(c)
    for bad in (plan._replace(smem=plan.smem - 32),
                plan._replace(producers=7)):  # 9 roles in 8 warps
        with pytest.raises(RuntimeError):
            df1_bank_q64(b64, st, x, 61, _plan=bad)
    rst = rpll.init((c,), device=cuda)
    xi = torch.ones((t, c), dtype=torch.int32, device=cuda)
    plan = rpll_plan(c)
    for bad in (plan._replace(smem=plan.smem + 32),
                plan._replace(producers=7)):  # 9 roles in 8 warps
        with pytest.raises(RuntimeError):
            rpll_bank(rpll.RpllConfig(8, 12, 11), rst, xi, xi.bool(),
                      _plan=bad)
    _equal(df1_bank_q64(b64, st, x, 61), df1_bank_q64_plain(b64, st, x, 61))
    _equal(rpll_bank(rpll.RpllConfig(8, 12, 11), rst, xi, xi.bool())[1],
           rpll_bank_plain(rpll.RpllConfig(8, 12, 11), rst, xi, xi.bool())[1])


# K31/K33 and K34 at the depth-0 pipeline's edges (their default chunk is
# 256 rows): t = 1, t under a chunk, t not a multiple of it, c = 200, 50
# and 1 (a tile's tail lanes), and a forced plan of short chunks
DEPTH0_EDGES = {
    "t = 1": (200, 1, {}),
    "t under a chunk": (50, 100, {}),
    "t = 3 chunks + 17": (1, 3 * 256 + 17, {}),
    "16-row chunks, 2 producers": (200, 5 * 16 + 3,
                                   dict(chunk=16, ring=3, producers=2)),
}
CLAMP_Q = (1 << 10, -(1 << 23), 1 << 23)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f,clamp", [(29, None), (29, CLAMP_Q), (1, None),
                                     (32, None), (32, CLAMP_Q)])
@pytest.mark.parametrize("case", sorted(DEPTH0_EDGES))
def test_df1_dither_kernels_at_pipe_edges(cuda, case, f, clamp):
    """K31, and K33 with per-lane and shared planes, over 2 carried blocks
    against their plain versions, coefficients in +-2^(f + 1)."""
    from idsp_tpu_torch.filters.biquad_cuda import dither_plan

    c, t, kw = DEPTH0_EDGES[case]
    plan = dither_plan(c, **kw) if kw else None
    rng = np.random.default_rng(310 + f)
    top = min(2**31 - 1, 2 << f)
    ba = rng.integers(-top, top + 1, size=5).astype(np.int32)
    planes = torch.from_numpy(rng.integers(-top, top + 1, size=(5, c))
                              .astype(np.int32)).to(cuda)
    _carried(lambda s, x: df1_dither_bank(ba, s, x, f, clamp=clamp,
                                          _plan=plan),
             lambda s, x: df1_dither_bank_plain(ba, s, x, f, clamp=clamp),
             _dither_state(rng, c, cuda),
             lambda: _i32(rng, (t, c), device=cuda), blocks=2)
    for p in (planes, ba):
        _carried(lambda s, x, p=p: df1_dither_bank_coef(
                     p, s, x, f, clamp=clamp, _plan=plan),
                 lambda s, x, p=p: df1_dither_bank_coef_plain(
                     p, s, x, f, clamp=clamp),
                 _dither_state(rng, c, cuda),
                 lambda: _i32(rng, (t, c), device=cuda), blocks=2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f", [1, 32])
@pytest.mark.parametrize("clamp", [None, (2**31 - 9, -(2**31), 2**31 - 1)])
def test_df1_dither_kernel_where_the_sum_wraps(cuda, f, clamp):
    """Coefficients, state and the first row at -2^31, e at 2^32 - 1: the
    five products and e pass 2^63 and wrap mod 2^64; the other rows at
    int32's edges."""
    c, t = 50, 300
    rng = np.random.default_rng(64 + f)
    ba = np.full(5, -(2**31), np.int32)
    edges = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 1], np.int32)
    xs = rng.choice(edges, (t, c))
    xs[0] = -(2**31)
    full = torch.full((c, 2), -(2**31), dtype=torch.int32, device=cuda)
    st = biquad.Df1DitherState(
        xy=biquad.Df1State(x=full, y=full.clone()),
        e=torch.full((c,), 2**32 - 1, dtype=torch.int64, device=cuda))
    x = torch.from_numpy(xs).to(cuda)
    _equal(df1_dither_bank(ba, st, x, f, clamp=clamp),
           df1_dither_bank_plain(ba, st, x, f, clamp=clamp))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("output", ["lp", "hp", "bp", "br"])
@pytest.mark.parametrize("case", sorted(DEPTH0_EDGES))
def test_svf_kernel_at_pipe_edges(cuda, case, output):
    """Two carried blocks from a random state, x ~ N(0, 1), then one block
    against its two halves (t >= 2)."""
    from idsp_tpu_torch.filters.svf_cuda import svf_plan

    c, t, kw = DEPTH0_EDGES[case]
    plan = svf_plan(c, **kw) if kw else None
    rng = np.random.default_rng(34)
    f, qi = svf.coefficients(0.04, 1.3)

    def make(rows):
        return (torch.from_numpy(rng.normal(size=(rows, c)).astype(
            np.float32)).to(cuda),)

    st = svf.SvfState(*(torch.from_numpy(rng.normal(size=c).astype(
        np.float32)).to(cuda) for _ in range(3)))
    def kern(s, x):
        return svf_bank(f, qi, s, x, output=output, _plan=plan)

    def plain(s, x):
        return svf_bank_plain(f, qi, s, x, output=output)

    if t >= 2:
        _structure_hold(kern, plain, st, make, t)
    else:
        for _ in range(2):
            x, = make(t)
            got = kern(st, x)
            _same(got, plain(st, x))
            st = got[0]


@pytest.mark.requires_cuda
def test_dither_and_svf_entries_refuse_a_plan_not_their_own(cuda):
    """K31's, K33's and K34's entry points refuse a plan whose shared
    memory is not the kernel's own sum, or roles that do not fit the
    warps (RuntimeError, nothing launched); the next launch runs as
    usual."""
    from idsp_tpu_torch.filters.biquad_cuda import dither_plan
    from idsp_tpu_torch.filters.svf_cuda import svf_plan

    c, t = 64, 300
    st = biquad.df1_dither_init((c,), device=cuda)
    x = torch.ones((t, c), dtype=torch.int32, device=cuda)
    plan = dither_plan(c)
    for bad in (plan._replace(smem=plan.smem - 32),
                plan._replace(producers=9),  # 10 roles in 9 places
                svf_plan(c)):  # another kernel's words a row
        with pytest.raises(RuntimeError):
            df1_dither_bank(BA_Q, st, x, 29, _plan=bad)
        with pytest.raises(RuntimeError):
            df1_dither_bank_coef(BA_Q, st, x, 29, _plan=bad)
    sst = svf.init((c,), device=cuda)
    xf = x.to(torch.float32)
    plan = svf_plan(c)
    for bad in (plan._replace(smem=plan.smem + 32),
                plan._replace(producers=7), dither_plan(c)):
        with pytest.raises(RuntimeError):
            svf_bank(0.1, 1.0, sst, xf, _plan=bad)
    _equal(df1_dither_bank(BA_Q, st, x, 29),
           df1_dither_bank_plain(BA_Q, st, x, 29))
    _equal(df1_dither_bank_coef(BA_Q, st, x, 29),
           df1_dither_bank_plain(BA_Q, st, x, 29))
    _same(svf_bank(0.1, 1.0, sst, xf), svf_bank_plain(0.1, 1.0, sst, xf))


# K1, K11, K18, K26 and K27 at the same edges (`df1_plan`: 256-row chunks)
DF1_KINDS = ("K1", "K1 f32", "K11", "K18", "K26", "K26 shared", "K27")


def _df1_call(kind, ba, f, plan, d):
    """(kernel, plain) of ``kind`` as ``fn(state, xs)``."""
    from idsp_tpu_torch.filters import biquad_cuda as bc

    u, lo, hi = CLAMP_Q
    if kind in ("K1", "K1 f32"):
        dt = torch.float32 if kind == "K1 f32" else None
        return (lambda s, x: bc.df1_bank_q(ba, s, x, f, out_dtype=dt,
                                           _plan=plan),
                lambda s, x: bc.df1_bank_q_plain(ba, s, x, f, out_dtype=dt))
    if kind == "K11":
        return (lambda s, x: bc.df1_bank_q_dec(ba, s, x, f, d=d, _plan=plan),
                lambda s, x: bc.df1_bank_q_dec_plain(ba, s, x, f, d=d))
    if kind == "K18":
        return (lambda s, x: bc.df1_clamp_bank_q(ba, s, x, f, u=u, lo=lo,
                                                 hi=hi, _plan=plan),
                lambda s, x: bc.df1_clamp_bank_q_plain(ba, s, x, f, u=u,
                                                       lo=lo, hi=hi))
    if kind.startswith("K26"):
        return (lambda s, x: bc.df1_bank_q_coef(ba, s, x, f, _plan=plan),
                lambda s, x: bc.df1_bank_q_coef_plain(ba, s, x, f))
    return (lambda s, x: bc.df1_clamp_bank_q_coef(ba, s, x, f, u=u, lo=lo,
                                                  hi=hi, _plan=plan),
            lambda s, x: bc.df1_clamp_bank_q_coef_plain(ba, s, x, f, u=u,
                                                        lo=lo, hi=hi))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f", [1, 29, 31, 32, 33, 62, 63])
@pytest.mark.parametrize("kind", DF1_KINDS)
@pytest.mark.parametrize("case", sorted(DEPTH0_EDGES))
def test_df1_kernels_at_pipe_edges(cuda, case, kind, f):
    """K1 (int32 and f32 out), K11 (d = 3, 4 under a chunk, 1 at t = 1:
    kept rows across chunk edges), K18, K26 (per-lane and shared planes)
    and K27 over 2 carried blocks against their plain versions: full-range
    x and state, coefficients in +-2^(f + 1), both shifts (f <= 32, > 32),
    the clamp engaged."""
    from idsp_tpu_torch.filters.biquad_cuda import df1_plan

    c, t, kw = DEPTH0_EDGES[case]
    plan = df1_plan(c, **kw) if kw else None
    d = 1 if t == 1 else 4 if t == 100 else 3
    t = -(-t // d) * d if kind == "K11" else t
    rng = np.random.default_rng(2100 + f)
    top = min(2**31 - 1, 2 << f)
    shape = (5, c) if kind in ("K26", "K27") else (5,)
    ba = torch.from_numpy(rng.integers(-top, top + 1, size=shape).astype(
        np.int32)).to(cuda)
    kern, plain = _df1_call(kind, ba, f, plan, d)
    st = biquad.Df1State(x=_i32(rng, (c, 2), device=cuda),
                         y=_i32(rng, (c, 2), device=cuda))
    _carried(kern, plain, st, lambda: _i32(rng, (t, c), device=cuda),
             blocks=2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f", [1, 32, 33, 63])
@pytest.mark.parametrize("kind", DF1_KINDS)
def test_df1_kernels_where_the_sum_wraps(cuda, kind, f):
    """Coefficients, state and the first row at -2^31: the five products
    pass 2^63 and wrap mod 2^64; the other rows at int32's edges; K18/K27
    clamped near int32's top."""
    c, t = 50, 300
    rng = np.random.default_rng(640 + f)
    edges = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 1], np.int32)
    xs = rng.choice(edges, (t, c))
    xs[0] = -(2**31)
    full = torch.full((c, 2), -(2**31), dtype=torch.int32, device=cuda)
    st = biquad.Df1State(x=full, y=full.clone())
    shape = (5, c) if kind in ("K26", "K27") else (5,)
    ba = torch.full(shape, -(2**31), dtype=torch.int32, device=cuda)
    kern, plain = _df1_call(kind, ba, f, None, 3)
    x = torch.from_numpy(xs).to(cuda)
    _equal(kern(st, x), plain(st, x))


@pytest.mark.requires_cuda
def test_df1_entries_refuse_a_plan_not_their_own(cuda):
    """K1's, K11's, K18's, K26's and K27's entry points refuse a plan whose
    shared memory is not the kernel's own sum, roles that do not fit the
    warps, or another kernel's words a row (RuntimeError, nothing
    launched); the next launch runs as usual."""
    from idsp_tpu_torch.filters.biquad_cuda import df1_plan
    from idsp_tpu_torch.filters.svf_cuda import svf_plan

    c, t = 64, 300
    st = biquad.df1_init((c,), device=cuda)
    x = torch.ones((t, c), dtype=torch.int32, device=cuda)
    plan = df1_plan(c)
    for bad in (plan._replace(smem=plan.smem - 32),
                plan._replace(producers=9),  # 10 roles in 9 places
                svf_plan(c)):  # another kernel's words a row
        for kind in DF1_KINDS:
            kern, _ = _df1_call(kind, BA_Q, 29, bad, 4)
            with pytest.raises(RuntimeError):
                kern(st, x)
    for kind in DF1_KINDS:
        kern, plain = _df1_call(kind, BA_Q, 29, None, 4)
        _equal(kern(st, x), plain(st, x))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tc", [64, 256])
def test_ddc_lockin_kernel_equals_plain(cuda, tc):
    c, t = 100, 1024  # 200 lanes: not a multiple of the 32-lane block
    rng = np.random.default_rng(51)
    lo = np.linspace(0.05, 0.45, c)
    ba = biquad.from_cookbook(
        Filter().critical_frequency(0.002).lowpass()).astype(np.float32)
    st = biquad.Df1State(
        x=torch.from_numpy(rng.normal(size=(2 * c, 2)).astype(np.float32)).to(
            cuda),
        y=torch.from_numpy(rng.normal(size=(2 * c, 2)).astype(np.float32)).to(
            cuda))
    st_p = st
    for b in range(3):
        x = torch.from_numpy(rng.normal(size=t).astype(np.float32)).to(cuda)
        st, y = ddc_lockin_bank(ba, st, x, lo, b * t, time_chunk=tc)
        st_p, y_p = ddc_lockin_bank_plain(ba, st_p, x, lo, b * t,
                                          time_chunk=tc)
        torch.cuda.synchronize()
        _equal((st.x, st.y, y), (st_p.x, st_p.y, y_p))


# K12/K13 at the depth-0 pipeline's edges: (c, t, d, time chunk, plan
# keywords); chunks other than the time chunk and not multiples of d,
# chunks under d, t not a multiple of the chunk, c not a multiple of the
# 16-channel tile, d = 1, t = 0, one live channel, spans crossing the
# time chunk's coarse blocks
BANK_EDGES = {
    "chunk 24, d 16": (16, 256, 16, 32, dict(chunk=24, ring=2)),
    "17 channels, t % chunk": (17, 192, 4, 64, dict(chunk=40, ring=3)),
    "chunks under d": (3, 96, 16, 48, dict(chunk=8, ring=4)),
    "d = 1": (20, 40, 1, 8, dict(chunk=16, ring=2)),
    "one channel, 1 producer": (1, 64, 4, 16,
                                dict(chunk=12, ring=3, producers=1)),
    "5 producers": (9, 120, 8, 24, dict(chunk=24, producers=5)),
    "14-row spans, time chunk 12": (7, 180, 4, 12,
                                    dict(chunk=40, producers=3)),
    "a batch's last row past the coarse block": (5, 170, 1, 17,
                                                 dict(chunk=30, producers=3)),
    "default plan, 3 chunks + 128": (40, 3 * 256 + 128, 16, 128, {}),
    "t = 0": (6, 0, 16, 128, {}),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["k12", "k12_clamp", "k13"])
@pytest.mark.parametrize("case", sorted(BANK_EDGES))
def test_fastlo_bank_kernels_at_pipe_edges(cuda, case, kind):
    """K12, its ``clamp=`` and K13 over 2 carried blocks against their
    plain versions, x in +-2^27, full-range phases and steps."""
    from idsp_tpu_torch.filters.ddc_bank_cuda import bank_plan

    c, t, d, tc, kw = BANK_EDGES[case]
    plan = bank_plan(c, **kw) if kw else None
    rng = np.random.default_rng(120 + c)
    ba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    clamp = CLAMP_Q if kind == "k12_clamp" else None
    steps = _i32(rng, (c,), device=cuda)
    st = biquad.Df1State(x=_i32(rng, (2 * c, 2), -(2**27), 2**27, device=cuda),
                         y=_i32(rng, (2 * c, 2), -(2**26), 2**26, device=cuda))
    pst = pll.block(ba, pll.init((c,), device=cuda),
                    _i32(rng, (7, c), device=cuda))[0]
    carry = carry_p = (st, pst, _i32(rng, (c,), device=cuda))
    for _ in range(2):
        x = _i32(rng, (t,), -(2**27), 2**27, device=cuda)
        if kind == "k13":
            out = fastlo_ddc_bank_block(BA_Q, ba, *carry, steps, x, 29, d=d,
                                        time_chunk=tc, _plan=plan)
            out_p = fastlo_ddc_bank_block_plain(BA_Q, ba, *carry_p, steps, x,
                                                29, d=d, time_chunk=tc)
            carry, carry_p = out[:3], out_p[:3]
        else:
            out = fastlo_df1_dec_bank(BA_Q, carry[0], carry[2], steps, x, 29,
                                      d=d, clamp=clamp, time_chunk=tc,
                                      _plan=plan)
            out_p = fastlo_df1_dec_bank_plain(BA_Q, carry_p[0], carry_p[2],
                                              steps, x, 29, d=d, clamp=clamp,
                                              time_chunk=tc)
            carry = (out[0], carry[1], out[1])
            carry_p = (out_p[0], carry_p[1], out_p[1])
        torch.cuda.synchronize()
        _equal(out, out_p)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f", [29, 45])
def test_fastlo_bank_kernels_where_the_sum_wraps(cuda, f):
    """Coefficients and state at int32's edges, full-range x: the DF1's
    five-term int64 sum wraps; K12 and K13 at a chunk other than the time
    chunk and not a multiple of d."""
    from idsp_tpu_torch.filters.ddc_bank_cuda import bank_plan

    c, t, d, tc = 18, 160, 8, 32
    rng = np.random.default_rng(77)
    edges = np.array([-(2**31), 2**31 - 1], np.int32)
    ba = np.full(5, -(2**31), np.int32)
    plan = bank_plan(c, chunk=20, ring=3)
    st = biquad.Df1State(
        x=torch.from_numpy(rng.choice(edges, (2 * c, 2))).to(cuda),
        y=torch.from_numpy(rng.choice(edges, (2 * c, 2))).to(cuda))
    pba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    pst = pll.init((c,), device=cuda)
    ph, steps = _i32(rng, (c,), device=cuda), _i32(rng, (c,), device=cuda)
    x = _i32(rng, (t,), device=cuda)
    _equal(fastlo_df1_dec_bank(ba, st, ph, steps, x, f, d=d, time_chunk=tc,
                               _plan=plan),
           fastlo_df1_dec_bank_plain(ba, st, ph, steps, x, f, d=d,
                                     time_chunk=tc))
    _equal(fastlo_ddc_bank_block(ba, pba, st, pst, ph, steps, x, f, d=d,
                                 time_chunk=tc, _plan=plan),
           fastlo_ddc_bank_block_plain(ba, pba, st, pst, ph, steps, x, f,
                                       d=d, time_chunk=tc))


# K16 at the depth-0 pipeline's edges: (c, t, time chunk, n0, plan
# keywords); span and chunk edges, t = time chunk, time chunks other than
# the pipeline's chunk (one above the old 8192-row limit), t = 1 and 0
LOCKIN_EDGES = {
    "t = time chunk": (16, 256, 256, 0, {}),
    "t % chunk, 3 producers": (20, 240, 48, 1000,
                               dict(chunk=44, ring=2, producers=3)),
    "time chunk under a span": (3, 96, 8, 17, dict(chunk=24, producers=5)),
    "2-row spans": (9, 60, 12, 5, dict(chunk=7, ring=4, producers=4)),
    "11 producers": (40, 130, 13, 0,
                     dict(chunk=32, ring=4, producers=11, warps=16)),
    "t = 1": (4, 1, 1, 9, dict(chunk=8)),
    "t = 0": (2, 0, 4, 0, {}),
    "time chunk 16384": (50, 16384, 16384, 77, {}),
    "default plan, c = 100": (100, 3 * 256 + 64, 64, 5, {}),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(LOCKIN_EDGES))
def test_ddc_lockin_kernel_at_pipe_edges(cuda, case):
    """K16 over 2 carried blocks (n0 carried) from a random state, the
    wideband lowpass at 0.2 and x ~ N(0, 1), against the plain version."""
    from idsp_tpu_torch.filters.ddc_lockin_cuda import lockin_plan

    c, t, tc, n0, kw = LOCKIN_EDGES[case]
    plan = lockin_plan(c, **kw) if kw else None
    rng = np.random.default_rng(160 + c)
    lo = rng.uniform(0.01, 0.49, c)
    ba = biquad.from_cookbook(
        Filter().critical_frequency(0.2).lowpass()).astype(np.float32)
    st = biquad.Df1State(
        x=torch.from_numpy(rng.normal(size=(2 * c, 2)).astype(np.float32)).to(
            cuda),
        y=torch.from_numpy(rng.normal(size=(2 * c, 2)).astype(np.float32)).to(
            cuda))
    st_p = st
    for b in range(2):
        x = torch.from_numpy(rng.normal(size=t).astype(np.float32)).to(cuda)
        st, y = ddc_lockin_bank(ba, st, x, lo, n0 + b * t, time_chunk=tc,
                                _plan=plan)
        st_p, y_p = ddc_lockin_bank_plain(ba, st_p, x, lo, n0 + b * t,
                                          time_chunk=tc)
        torch.cuda.synchronize()
        _equal((st.x, st.y, y), (st_p.x, st_p.y, y_p))


@pytest.mark.requires_cuda
def test_bank_and_lockin_entries_refuse_a_plan_not_their_own(cuda):
    """K12's, K13's and K16's entry points refuse a plan whose shared
    memory is not the kernel's own sum, or roles that do not fit the warps
    (RuntimeError, nothing launched); the next launch runs as usual."""
    from idsp_tpu_torch.filters.ddc_bank_cuda import bank_plan
    from idsp_tpu_torch.filters.ddc_lockin_cuda import lockin_plan

    c, t = 64, 256
    rng = np.random.default_rng(3)
    st = biquad.df1_init((2 * c,), device=cuda)
    pst = pll.init((c,), device=cuda)
    ph = _i32(rng, (c,), device=cuda)
    x = _i32(rng, (t,), -(2**27), 2**27, device=cuda)
    pba = pll.coefficients_from_bandwidth(2e-2, 4.0)
    plan = bank_plan(c)
    for bad in (plan._replace(smem=plan.smem - 32),
                plan._replace(producers=9)):  # 10 roles in 9 places
        with pytest.raises(RuntimeError):
            fastlo_df1_dec_bank(BA_Q, st, ph, ph, x, 29, _plan=bad)
        with pytest.raises(RuntimeError):
            fastlo_ddc_bank_block(BA_Q, pba, st, pst, ph, ph, x, 29,
                                  _plan=bad)
    lo = np.linspace(0.1, 0.2, c)
    bf = biquad.from_cookbook(
        Filter().critical_frequency(0.02).lowpass()).astype(np.float32)
    sl = biquad.df1_init((2 * c,), torch.float32, device=cuda)
    xf = torch.ones((t,), device=cuda)
    lplan = lockin_plan(c)
    for bad in (lplan._replace(smem=lplan.smem + 32),
                lplan._replace(producers=12)):  # 13 roles in 12 places
        with pytest.raises(RuntimeError):
            ddc_lockin_bank(bf, sl, xf, lo, _plan=bad)
    _equal(fastlo_ddc_bank_block(BA_Q, pba, st, pst, ph, ph, x, 29),
           fastlo_ddc_bank_block_plain(BA_Q, pba, st, pst, ph, ph, x, 29))
    _equal(ddc_lockin_bank(bf, sl, xf, lo),
           ddc_lockin_bank_plain(bf, sl, xf, lo))


# m = 128, 384, 1024, 2048: clusters of 1, 3 and 8 CTAs, and 8 with the
# FIR done by two clusters; n = 1 and 5 < taps - 1 (the new history reaches
# back into the old one), 100 (a ragged frame tile), 1024; 2 to 16 taps
K17_CASES = [(m, n, taps) for m in (128, 384, 1024, 2048)
             for n in (1, 5, 100, 1024) for taps in (2, 8, 16)] + [
                 (256, 5, 8), (128, 70, 16), (128, 64, 2)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tw", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,taps", K17_CASES)
def test_channelize_fused_kernel_matches_plain(cuda, tw, m, n, taps):
    rng = np.random.default_rng(52)

    def planes(rows):
        return (torch.from_numpy(rng.normal(size=(rows, m)).astype(
            np.float32)).to(cuda) for _ in range(2))

    st = channelizer.PlanesState(*planes(taps - 1))
    st_p = st
    for _ in range(3):
        zr, zi = planes(n)
        st, yr, yi = channelize_fused(st, zr, zi, m=m, taps=taps,
                                      twiddle_dtype=tw)
        st_p, yr_p, yi_p = channelize_fused_plain(st_p, zr, zi, m=m,
                                                  taps=taps, twiddle_dtype=tw)
        torch.cuda.synchronize()
        _equal((st.hist_r, st.hist_i), (st_p.hist_r, st_p.hist_i))
        scale = float(torch.maximum(yr_p.abs().max(), yi_p.abs().max()))
        for got, want in ((yr, yr_p), (yi, yi_p)):
            assert float((got - want).abs().max()) <= 2e-5 * scale


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tw", [torch.float32, torch.bfloat16])
def test_channelize_fused_streaming_equals_one_shot(cuda, tw):
    m, taps, n = 128, 8, 256
    rng = np.random.default_rng(53)
    zr, zi = (torch.from_numpy(rng.normal(size=(n, m)).astype(
        np.float32)).to(cuda) for _ in range(2))
    st0 = channelizer.init_planes(m, taps, device=cuda)
    _, yr, yi = channelize_fused(st0, zr, zi, m=m, taps=taps,
                                 twiddle_dtype=tw)
    st, ar, ai = channelize_fused(st0, zr[:128], zi[:128], m=m, taps=taps,
                                  twiddle_dtype=tw)
    _, br, bi = channelize_fused(st, zr[128:], zi[128:], m=m, taps=taps,
                                 twiddle_dtype=tw)
    _equal((torch.cat([ar, br]), torch.cat([ai, bi])), (yr, yi))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tw", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,taps", [(1024, 8), (384, 16), (128, 2)])
def test_channelize_fused_plans_and_halves_bit_for_bit(cuda, tw, m, taps):
    # every output sums the same k16 steps whatever the plan or the block
    n = 300
    rng = np.random.default_rng(54)
    zr, zi = (torch.from_numpy(rng.normal(size=(n, m)).astype(
        np.float32)).to(cuda) for _ in range(2))
    st = channelizer.PlanesState(*(torch.from_numpy(rng.normal(
        size=(taps - 1, m)).astype(np.float32)).to(cuda) for _ in range(2)))
    outs = [channelize_fused(st, zr, zi, m=m, taps=taps, twiddle_dtype=tw,
                             _plan=launch_plan(n, m, taps, tw, frames=f))
            for f in (64, 128)]
    _equal(outs[0], outs[1])
    for cut in (100, 1):
        a = channelize_fused(st, zr[:cut], zi[:cut], m=m, taps=taps,
                             twiddle_dtype=tw)
        b = channelize_fused(a[0], zr[cut:], zi[cut:], m=m, taps=taps,
                             twiddle_dtype=tw)
        _equal((b[0].hist_r, b[0].hist_i, torch.cat([a[1], b[1]]),
                torch.cat([a[2], b[2]])),
               (outs[0][0].hist_r, outs[0][0].hist_i, outs[0][1],
                outs[0][2]))


@pytest.mark.requires_cuda
def test_channelize_fused_refuses_plan_beyond_shared_memory(cuda):
    m, taps, n = 1024, 16, 256
    big = launch_plan(n, m, taps, torch.bfloat16, frames=128, stages=8)
    sp = channelizer.init_planes(m, taps, device=cuda)
    z = torch.zeros((n, m), device=cuda)
    with pytest.raises(RuntimeError):
        channelize_fused(sp, z, z, m=m, taps=taps, _plan=big)
    # a plan whose shared memory is not the kernel's own sum is refused too
    p = launch_plan(n, m, taps, torch.bfloat16)
    with pytest.raises(RuntimeError):
        channelize_fused(sp, z, z, m=m, taps=taps,
                         _plan=p._replace(smem=p.smem + 128))
    got = channelize_fused(sp, z + 1, z, m=m, taps=taps)
    want = channelize_fused_plain(sp, z + 1, z, m=m, taps=taps)
    torch.cuda.synchronize()
    scale = float(want[1].abs().max())
    assert float((got[1] - want[1]).abs().max()) <= 2e-5 * scale


@pytest.mark.requires_cuda
def test_baseline_1_3_wrappers_reject_bad_input(cuda):
    c = 64
    st = fm_disc.init_state((c,), device=cuda)
    re = torch.zeros((16, c), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fm_disc_bank(BA_Q, st, re, re, 0, angle="approx")
    with pytest.raises(ValueError):  # the IQ planes are int32
        fm_disc_bank(BA_Q, st, re.float(), re.float(), 0)
    lo = np.linspace(0.1, 0.2, c)
    sl = biquad.df1_init((2 * c,), torch.float32, device=cuda)
    x = torch.zeros((1000,), device=cuda)
    with pytest.raises(ValueError):  # 1000 % 256 != 0
        ddc_lockin_bank(np.ones(5, np.float32), sl, x, lo)
    with pytest.raises(ValueError):  # the lock-in state is (2c, 2) f32
        ddc_lockin_bank(np.ones(5, np.float32),
                        biquad.df1_init((c,), torch.float32, device=cuda),
                        x[:512], lo)
    sp = channelizer.init_planes(96, 8, device=cuda)
    z = torch.zeros((64, 96), device=cuda)
    with pytest.raises(ValueError):  # m % 128 != 0
        channelize_fused(sp, z, z, m=96)
    sp = channelizer.init_planes(128, 8, device=cuda)
    z = torch.zeros((64, 128), device=cuda)
    with pytest.raises(ValueError):
        channelize_fused(sp, z, z, m=128, twiddle_dtype=torch.float16)


# (u, lo, hi): the JAX test's peaks (engages on raw +-2^27 inputs), an
# offset that wraps int32 with bounds at its extremes, and lo > hi (every
# output hi)
CLAMPS = [(1 << 10, -(1 << 26), 1 << 26), (2**31 - 8, -(2**31), 2**31 - 1),
          (0, 1 << 20, -(1 << 20))]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("clamp", CLAMPS)
def test_df1_clamp_bank_q_kernel_equals_plain(cuda, clamp):
    u, lo, hi = clamp
    c, t = 200, 1000  # c not a multiple of the 32-lane block, a row tail
    rng = np.random.default_rng(60)
    st = biquad.Df1State(x=_i32(rng, (c, 2), device=cuda),
                         y=_i32(rng, (c, 2), device=cuda))
    st_p = st
    for _ in range(3):
        xs = _i32(rng, (t, c), -(2**27), 2**27, device=cuda)
        st, ys = df1_clamp_bank_q(BA_Q, st, xs, 29, u=u, lo=lo, hi=hi)
        st_p, ys_p = df1_clamp_bank_q_plain(BA_Q, st_p, xs, 29, u=u, lo=lo,
                                            hi=hi)
        torch.cuda.synchronize()
        _equal((st.x, st.y, ys), (st_p.x, st_p.y, ys_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("depth,clamp", [(1, CLAMPS[0]), (3, CLAMPS[0]),
                                         (3, CLAMPS[1]), (2, CLAMPS[2])])
def test_df1_clamp_hbf_cascade_kernel_equals_plain(cuda, depth, clamp):
    u, lo, hi = clamp
    c2, t = 256, 1024
    taps = tuple(HBF_TAPS[2 - d] for d in range(depth))
    rng = np.random.default_rng(61)
    st = biquad.df1_init((c2,), device=cuda)
    tails = tuple(hbf1_tail_init(c2, len(tv), device=cuda) for tv in taps)
    st_p, tails_p = st, tails
    for _ in range(3):
        xs = _i32(rng, (t, c2), -(2**27), 2**27, device=cuda)
        st, tails, y = df1_clamp_hbf_cascade_bank(
            BA_Q, st, tails, xs, 29, u=u, lo=lo, hi=hi, taps=taps,
            time_chunk=128)
        st_p, tails_p, y_p = df1_clamp_hbf_cascade_bank_plain(
            BA_Q, st_p, tails_p, xs, 29, u=u, lo=lo, hi=hi, taps=taps)
        torch.cuda.synchronize()
        _equal((st.x, st.y, tails, y), (st_p.x, st_p.y, tails_p, y_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tc", [64, 512])
def test_df1_hbf1_and_hbf12_kernels_equal_plain(cuda, tc):
    """K20 and K21 (K2 at depth 1 and 2, their JAX default chunk 512)."""
    c2, t = 200, 1024  # c2 not a multiple of the 32-lane block
    rng = np.random.default_rng(62)
    st = biquad.df1_init((c2,), device=cuda)
    t1, t2 = (hbf1_tail_init(c2, m, device=cuda) for m in (5, 10))
    a = a_p = (st, t1)
    b = b_p = (st, t1, t2)
    for _ in range(3):
        xs = _i32(rng, (t, c2), -(2**27), 2**27, device=cuda)
        out = df1_hbf1_bank(BA_Q, *a, xs, 29, time_chunk=tc)
        out_p = df1_hbf1_bank_plain(BA_Q, *a_p, xs, 29)
        out12 = df1_hbf12_bank(BA_Q, *b, xs, 29, time_chunk=tc)
        out12_p = df1_hbf12_bank_plain(BA_Q, *b_p, xs, 29)
        torch.cuda.synchronize()
        _equal(out, out_p)
        _equal(out12, out12_p)
        assert tuple(out[2].shape) == (t // 2, c2)
        assert tuple(out12[3].shape) == (t // 4, c2)
        a, a_p, b, b_p = out[:2], out_p[:2], out12[:3], out12_p[:3]


# K2, K19-K21 at the shapes that stress csrc/ddc_cascade.cu's rings and
# tiles: (taps: "chain" depth 3, "chain1"/"chain2" depth 1/2 through K20 /
# K21's entry points, "98" HBF_TAPS_98 at depth 4; c2, t, forced plan,
# clamp)
CASCADE_EDGES = {
    "t-one-chunk": ("chain", 1024, 128, {}, None),
    "t-not-ring-x-chunk": ("chain", 256, 7 * 128 + 40, {}, None),
    "c2-200": ("chain", 200, 1024, {}, None),
    "c2-50-4-byte-copies": ("chain", 50, 520, {}, None),
    "t-8": ("chain", 64, 8, {}, None),
    "t-0": ("chain", 64, 0, {}, None),
    "chunk-24-two-slots": ("chain", 96, 24 * 9, dict(chunk=24, ring=2),
                           None),
    "8-warps": ("chain", 200, 1024, dict(warps=8), None),
    "16-warps-chunk-256": ("chain", 256, 2048,
                           dict(warps=16, chunk=256, ring=2), None),
    "hbf98-depth4": ("98", 256, 2048, {}, None),
    "k19-clamp-engaged": ("chain", 200, 936, {}, CLAMPS[0]),
    "k19-lo-gt-hi": ("chain", 200, 936, {}, CLAMPS[2]),
    "k20": ("chain1", 200, 936, {}, None),
    "k21": ("chain2", 200, 936, {}, None),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(CASCADE_EDGES))
def test_df1_hbf_cascade_kernel_edges_equal_plain(cuda, case):
    from idsp_tpu_torch.filters.ddc_cuda import launch_plan
    from idsp_tpu_torch.filters.hbf import HBF_TAPS_98

    name, c2, t, kw, clamp = CASCADE_EDGES[case]
    depth = {"chain1": 1, "chain2": 2}.get(name, 3)
    taps = (tuple(HBF_TAPS_98[3 - d] for d in range(4)) if name == "98"
            else tuple(HBF_TAPS[2 - d] for d in range(depth)))
    plan = launch_plan([len(tv) for tv in taps], c2, **kw) if kw else None
    rng = np.random.default_rng(68)
    st = biquad.Df1State(x=_i32(rng, (c2, 2), -(2**26), 2**26, device=cuda),
                         y=_i32(rng, (c2, 2), -(2**26), 2**26, device=cuda))
    tails = tuple(torch.from_numpy(rng.normal(
        0, 1e6, (3 * len(tv) - 2, c2)).astype(np.float32)).to(cuda)
        for tv in taps)
    st_p, tails_p = st, tails
    for _ in range(3):
        xs = _i32(rng, (t, c2), -(2**27), 2**27, device=cuda)
        if name == "chain1":
            st, tl, y = df1_hbf1_bank(BA_Q, st, tails[0], xs, 29,
                                      time_chunk=8)
            st_p, tl_p, y_p = df1_hbf1_bank_plain(BA_Q, st_p, tails_p[0], xs,
                                                  29)
            tails, tails_p = (tl,), (tl_p,)
        elif name == "chain2":
            st, t1, t2, y = df1_hbf12_bank(BA_Q, st, *tails, xs, 29,
                                           time_chunk=8)
            st_p, p1, p2, y_p = df1_hbf12_bank_plain(BA_Q, st_p, *tails_p,
                                                     xs, 29)
            tails, tails_p = (t1, t2), (p1, p2)
        elif clamp is None:
            st, tails, y = df1_hbf_cascade_bank(
                BA_Q, st, tails, xs, 29, taps=taps,
                time_chunk=1 << len(taps), _plan=plan)
            st_p, tails_p, y_p = df1_hbf_cascade_bank_plain(
                BA_Q, st_p, tails_p, xs, 29, taps=taps)
        else:
            u, lo, hi = clamp
            st, tails, y = df1_clamp_hbf_cascade_bank(
                BA_Q, st, tails, xs, 29, u=u, lo=lo, hi=hi, taps=taps,
                time_chunk=8, _plan=plan)
            st_p, tails_p, y_p = df1_clamp_hbf_cascade_bank_plain(
                BA_Q, st_p, tails_p, xs, 29, u=u, lo=lo, hi=hi, taps=taps)
        torch.cuda.synchronize()
        _equal((st.x, st.y, tails, y), (st_p.x, st_p.y, tails_p, y_p))
        assert tuple(y.shape) == (t >> len(taps), c2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,t,tc,kw,clamp", [
    (100, 960, 32, {}, None),        # fine length 32; a tile straddles I|Q
    (512, 1280, 256, {}, None),      # fine length 256 against chunks of 128
    (64, 1024, 512, {}, None),       # 512 rows: the fine table not staged
    (48, 1024, 128, dict(chunk=64, ring=2), None),
    (100, 960, 32, {}, CLAMPS[0]),
])
def test_fastlo_cascade_kernel_edges_equal_plain(cuda, c, t, tc, kw, clamp):
    """K3 (and its ``clamp=``) with fine lengths other than the kernel's
    chunk, a forced plan, and a fine table too long to stage."""
    from idsp_tpu_torch.filters.ddc_cuda import launch_plan

    plan = (launch_plan([5, 10, 23], 2 * c, fastlo=True, time_chunk=tc, **kw)
            if kw else None)
    rng = np.random.default_rng(69)
    p0 = _i32(rng, (c,), device=cuda)
    steps = _i32(rng, (c,), 1 << 24, 1 << 30, device=cuda)
    st = biquad.df1_init((2 * c,), device=cuda)
    tails = tuple(hbf1_tail_init(2 * c, m, device=cuda) for m in (5, 10, 23))
    ph, st_p, tails_p, ph_p = p0, st, tails, p0
    for _ in range(3):
        x = _i32(rng, (t,), -(2**27), 2**27, device=cuda)
        st, tails, ph, y = fastlo_ddc_cascade_bank(
            BA_Q, st, tails, ph, steps, x, 29, clamp=clamp, time_chunk=tc,
            _plan=plan)
        st_p, tails_p, ph_p, y_p = fastlo_ddc_cascade_bank_plain(
            BA_Q, st_p, tails_p, ph_p, steps, x, 29, clamp=clamp,
            time_chunk=tc)
        torch.cuda.synchronize()
        _equal((st.x, st.y, tails, ph, y), (st_p.x, st_p.y, tails_p, ph_p, y_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("clamp", CLAMPS[:2])
def test_fastlo_cascade_clamp_kernel_equals_plain(cuda, clamp):
    c, t, tc = 128, 1024, 128
    rng = np.random.default_rng(63)
    p0 = _i32(rng, (c,), device=cuda)
    steps = _i32(rng, (c,), 1 << 24, 1 << 30, device=cuda)
    st = biquad.df1_init((2 * c,), device=cuda)
    tails = tuple(hbf1_tail_init(2 * c, m, device=cuda) for m in (5, 10, 23))
    ph, st_p, tails_p, ph_p = p0, st, tails, p0
    for _ in range(3):
        x = _i32(rng, (t,), -(2**27), 2**27, device=cuda)
        st, tails, ph, y = fastlo_ddc_cascade_bank(
            BA_Q, st, tails, ph, steps, x, 29, clamp=clamp, time_chunk=tc)
        st_p, tails_p, ph_p, y_p = fastlo_ddc_cascade_bank_plain(
            BA_Q, st_p, tails_p, ph_p, steps, x, 29, clamp=clamp,
            time_chunk=tc)
        torch.cuda.synchronize()
        _equal((st.x, st.y, tails, ph, y), (st_p.x, st_p.y, tails_p, ph_p, y_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("clamp", CLAMPS[:2])
def test_fastlo_df1_dec_bank_clamp_kernel_equals_plain(cuda, clamp):
    c, t, d, tc = 100, 1024, 16, 128
    rng = np.random.default_rng(64)
    steps = _i32(rng, (c,), 1 << 24, 1 << 30, device=cuda)
    carry = (biquad.df1_init((2 * c,), device=cuda),
             _i32(rng, (c,), device=cuda))
    carry_p = carry
    for _ in range(3):
        x = _i32(rng, (t,), -(2**27), 2**27, device=cuda)
        out = fastlo_df1_dec_bank(BA_Q, carry[0], carry[1], steps, x, 29, d=d,
                                  clamp=clamp, time_chunk=tc)
        out_p = fastlo_df1_dec_bank_plain(BA_Q, carry_p[0], carry_p[1], steps,
                                          x, 29, d=d, clamp=clamp,
                                          time_chunk=tc)
        torch.cuda.synchronize()
        _equal(out, out_p)
        carry, carry_p = out[:2], out_p[:2]


@pytest.mark.requires_cuda
def test_clamped_cascade_refused_launch_leaves_no_pending_error(cuda):
    """A cascade plan of 1024-row chunks in 4 slots asks for 590 KB of
    shared memory a block, and one whose bytes are not the kernel's own
    sum is refused too: each launch is refused and raises (no smaller plan
    is taken), and the next kernel of the library launches as usual."""
    from idsp_tpu_torch.filters.ddc_cuda import cascade_smem, launch_plan

    st = biquad.df1_init((128,), device=cuda)
    xs = torch.ones((4096, 128), dtype=torch.int32, device=cuda)
    tails = tuple(hbf1_tail_init(128, m, device=cuda) for m in (5, 10, 23))
    plan = launch_plan([5, 10, 23], 128)
    for bad in (plan._replace(chunk=1024, ring=4,
                              smem=cascade_smem([5, 10, 23], 1024, 4)),
                plan._replace(smem=plan.smem + 16)):
        with pytest.raises(RuntimeError):
            df1_hbf_cascade_bank(BA_Q, st, tails, xs, 29, _plan=bad)
    _equal(df1_clamp_bank_q(BA_Q, st, xs, 29, lo=-5, hi=5),
           df1_clamp_bank_q_plain(BA_Q, st, xs, 29, lo=-5, hi=5))


@pytest.mark.requires_cuda
def test_channelizer_f32_products_ignore_global_tf32(cuda):
    """The planes path and K17's plain version compute their f32 products
    in full f32 even when the caller turned TF32 on."""
    m, n = 256, 64
    rng = np.random.default_rng(65)
    zr, zi = (torch.from_numpy(rng.normal(size=(n, m)).astype(
        np.float32)).to(cuda) for _ in range(2))
    st = channelizer.init_planes(m, 8, device=cuda)
    mm = torch.backends.cuda.matmul

    def run():
        return (channelizer.channelize_planes(
                    st, zr, zi, m=m, taps=8, twiddle_dtype=torch.float32),
                channelize_fused_plain(st, zr, zi, m=m, taps=8,
                                       twiddle_dtype=torch.float32))

    old = mm.fp32_precision
    try:
        mm.fp32_precision = "ieee"
        want = run()
        mm.fp32_precision = "tf32"
        got = run()
        assert mm.fp32_precision == "tf32"  # the caller's setting stays
    finally:
        mm.fp32_precision = old
    torch.cuda.synchronize()
    _equal(got, want)


# K22/K23 against their plain versions, of the scale max |y|: "highest"
# bit for bit; "split3" and "default" sum each k-step on the tensor cores,
# so at depth 1 only the sums' order differs (1e-6); deeper, a last-bit
# difference in a stage output can move the next stage's bf16 lo part by
# one of its ulps, about 2^-16 of the value ("split3"), or its hi part by
# one, up to 2^-7 ("default"): two such moves under the largest weights
# 2^-15 / 2^-6
MXU_TOL = {"highest": 0.0, "split3": 2.0 ** -15, "default": 2.0 ** -6}


def _mxu_states(kind, depth, c, taps, dev, rng):
    def rand(v):
        return torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(
            np.float32)).to(dev)

    if kind == "dec":
        return tuple(hbf.HbfDecState(rand(s.odd), rand(s.even))
                     for s in hbf.hbf_dec_cascade_init(depth, (c,), taps=taps,
                                                       axis=0, device=dev))
    return tuple(hbf.HbfIntState(rand(s.x))
                 for s in hbf.hbf_int_cascade_init(depth, (c,), taps=taps,
                                                   axis=0, device=dev))


def _near(got, want, tol):
    """got within tol of want's scale max |y| (tol 0: bit for bit); the
    stage-0 carry bit for bit."""
    (st, y), (st_p, y_p) = got, want
    _equal(st[0], st_p[0])
    if tol == 0.0:
        _equal(got, want)
        return
    scale = float(y_p.abs().max())
    flat = [(a, b) for u, v in zip(st, st_p) for a, b in zip(u, v)]
    for a, b in flat + [(y, y_p)]:
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert float((a.double() - b.double()).abs().max()) <= tol * scale


@pytest.mark.requires_cuda
@pytest.mark.parametrize("precision", ["split3", "default", "highest"])
@pytest.mark.parametrize("kind,c,t,block,sub,taps", [
    ("dec", 200, 2048, 256, 32, hbf.HBF_TAPS),  # c not a multiple of 32
    ("dec", 37, 96, 256, 5, hbf.HBF_TAPS_98),  # one segment
    ("dec", 64, 1024, 64, 3, hbf.HBF_TAPS),  # segments inside the halo
    ("int", 200, 256, 64, 32, hbf.HBF_TAPS),
    ("int", 37, 20, 64, 7, hbf.HBF_TAPS_98),  # one segment
    ("int", 64, 100, 3, 1, hbf.HBF_TAPS),  # ragged last segment
])
def test_hbf_mxu_kernels_equal_plain(cuda, kind, c, t, block, sub, taps,
                                     precision):
    """K22/K23 against their plain versions over 3 carried blocks from a
    random state, within MXU_TOL of the scale (bit for bit for
    "highest")."""
    rng = np.random.default_rng(39)
    kern, plain = ((hbf_dec_cascade_mxu, hbf_dec_cascade_mxu_plain)
                   if kind == "dec" else
                   (hbf_int_cascade_mxu, hbf_int_cascade_mxu_plain))
    st = st_p = _mxu_states(kind, 4, c, taps, cuda, rng)
    for _ in range(3):
        x = torch.from_numpy(rng.normal(size=(t, c)).astype(np.float32)).to(
            cuda)
        st, y = kern(st, x, taps=taps, block=block, sub=sub,
                     precision=precision)
        st_p, y_p = plain(st_p, x, taps=taps, precision=precision)
        torch.cuda.synchronize()
        _near((st, y), (st_p, y_p), MXU_TOL[precision])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("precision", ["split3", "default"])
@pytest.mark.parametrize("kind", ["dec", "int"])
@pytest.mark.parametrize("tv", [[0.0] * 4, [0.0, 1.0, 0.0, 0.0],
                                [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.5]])
def test_hbf_mma_layout_unit_taps(cuda, kind, tv, precision):
    """Depth 1 with a band of unit taps (the center alone, or one more
    tap of 1 or 0.5): each output is one or two exact products, so the
    MMA kernels equal their plain versions bit for bit; an error in a
    fragment layout shows as a permuted copy."""
    rng = np.random.default_rng(41)
    taps = (np.asarray(tv, np.float64),)
    kern, plain = ((hbf_dec_cascade_mxu, hbf_dec_cascade_mxu_plain)
                   if kind == "dec" else
                   (hbf_int_cascade_mxu, hbf_int_cascade_mxu_plain))
    st = _mxu_states(kind, 1, 64, taps, cuda, rng)
    x = torch.from_numpy(rng.normal(size=(512, 64)).astype(np.float32)).to(
        cuda)
    got = kern(st, x, taps=taps, precision=precision)
    want = plain(st, x, taps=taps, precision=precision)
    torch.cuda.synchronize()
    _equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("precision", ["split3", "default"])
@pytest.mark.parametrize("taps", [hbf.HBF_TAPS, hbf.HBF_TAPS_98])
@pytest.mark.parametrize("kind", ["dec", "int"])
def test_hbf_mma_tilings_ranges_and_halves_exact(cuda, kind, taps,
                                                 precision):
    """The MMA kernels at t = 32768 (K22; K23 2048), depth 4, c = 100:
    every (block, sub) and range count gives the same bits, and two half
    blocks equal one block (every stage's tiles start at multiples of 16
    rows of the call)."""
    rng = np.random.default_rng(43)
    c = 100
    st = _mxu_states(kind, 4, c, taps, cuda, rng)
    if kind == "dec":
        t, fn = 32768, hbf_mxu._dec
        tiles = ((256, 32, None), (512, 8, None), (256, 64, 1), (768, 16, 5),
                 (256, 1, 300))
        kern = hbf_dec_cascade_mxu
    else:
        t, fn = 2048, hbf_mxu._int
        tiles = ((64, 32, None), (16, 4, None), (32, 64, 1), (48, 16, 5),
                 (64, 1, 300))
        kern = hbf_int_cascade_mxu
    x = torch.from_numpy(rng.normal(size=(t, c)).astype(np.float32)).to(cuda)
    ref = fn(st, x, taps, *tiles[0][:2], precision, tiles[0][2])
    for block, sub, ranges in tiles[1:]:
        _equal(fn(st, x, taps, block, sub, precision, ranges), ref)
    sa, ya = kern(st, x[:t // 2], taps=taps, precision=precision)
    sb, yb = kern(sa, x[t // 2:], taps=taps, precision=precision)
    torch.cuda.synchronize()
    _equal((sb, torch.cat([ya, yb])), ref)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("precision", ["split3", "default", "highest"])
def test_hbf_mxu_refused_launch_leaves_no_pending_error(cuda, precision):
    """K22 taking 4096 rows at a time at depth 4 (a chunk for the MMA
    kernels, a segment for "highest") asks for more shared memory than a
    block has: the launch is refused and raises, and the next kernel of
    the library launches as usual; the same for K23 at 512 rows."""
    dec = hbf.hbf_dec_cascade_init(4, (64,), axis=0, device=cuda)
    with pytest.raises(RuntimeError):
        hbf_dec_cascade_mxu(dec, torch.zeros((8192, 64), device=cuda),
                            block=4096, precision=precision)
    itp = hbf.hbf_int_cascade_init(4, (64,), axis=0, device=cuda)
    with pytest.raises(RuntimeError):
        hbf_int_cascade_mxu(itp, torch.zeros((1024, 64), device=cuda),
                            block=512, precision=precision)
    x = torch.ones((64, 64), device=cuda)
    _equal(hbf_dec_cascade_mxu(dec, x, precision="highest"),
           hbf_dec_cascade_mxu_plain(dec, x, precision="highest"))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tname", ["HBF_TAPS", "HBF_TAPS_98"])
@pytest.mark.parametrize("c", [200, 512, 1024])
def test_hbf_dec_highest_walk_equals_plain(cuda, c, tname):
    """K22 "highest" on K7's walk, depth 4, t = 8192 from a random state:
    the default launch over 2 carried blocks, forced range counts (1, 7,
    one output row a range) and chunks (64, 512, 256), and two half
    blocks against one block, bit for bit with the plain version."""
    taps = getattr(hbf, tname)
    rng = np.random.default_rng(c + len(tname))
    t = 8192
    st = st_p = _mxu_states("dec", 4, c, taps, cuda, rng)

    def rows():
        return torch.from_numpy(rng.normal(size=(t, c)).astype(
            np.float32)).to(cuda)

    for _ in range(2):
        x = rows()
        got = hbf_dec_cascade_mxu(st, x, taps=taps, precision="highest")
        want = hbf_dec_cascade_mxu_plain(st_p, x, taps=taps,
                                         precision="highest")
        torch.cuda.synchronize()
        _equal(got, want)
        for block, ranges in ((64, 1), (512, 7), (256, t >> 4)):
            _equal(hbf_mxu._dec(st, x, taps, block, 32, "highest", ranges),
                   want)
        st, st_p = got[0], want[0]
    x = rows()
    whole = hbf_dec_cascade_mxu(st, x, taps=taps, precision="highest")
    sa, ya = hbf_dec_cascade_mxu(st, x[:t // 2], taps=taps,
                                 precision="highest")
    sb, yb = hbf_dec_cascade_mxu(sa, x[t // 2:], taps=taps,
                                 precision="highest")
    torch.cuda.synchronize()
    _equal((sb, torch.cat([ya, yb])), whole)


# --- K24-K27: the Stabilizer IIR control path --------------------------------


def _stages(n, f=29):
    fcs = np.linspace(0.02, 0.3, n)
    return np.stack([biquad.quantize_ba(biquad.from_cookbook(
        Filter().critical_frequency(fc).lowpass()), f) for fc in fcs])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 4, 8, 11])
def test_sos_bank_q_kernel_equals_plain(cuda, n):
    # 100 lanes: not a multiple of the 32-lane block; t = 1000 leaves a
    # tail after the last prefetch group; 11 stages take two launches
    c, t = 100, 1000
    rng = np.random.default_rng(80)
    ba = _stages(n)
    sts = [biquad.Df1State(x=_i32(rng, (c, 2), device=cuda),
                           y=_i32(rng, (c, 2), -(2**26), 2**26, device=cuda))
           for _ in range(n)]
    sts_p = sts
    launches = sos_bank_q.launches
    for _ in range(3):
        xs = _i32(rng, (t, c), -(2**26), 2**26, device=cuda)
        sts, ys = sos_bank_q(ba, sts, xs, 29)
        sts_p, ys_p = sos_bank_q_plain(ba, sts_p, xs, 29)
        torch.cuda.synchronize()
        _equal((tuple(sts), ys), (tuple(sts_p), ys_p))
    assert sos_bank_q.launches - launches == 3 * -(-n // 8)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f", [29, 32, 16])
@pytest.mark.parametrize("clamp", [None, (-777, -(2**27), 2**27),
                                   (2**31 - 9, -(2**31), 2**31 - 1)])
def test_df1_wide_bank_kernel_equals_plain(cuda, f, clamp):
    c, t = 100, 1000
    rng = np.random.default_rng(81)
    top = min(2**31 - 1, 2 << f)
    ba = rng.integers(-top, top + 1, size=5).astype(np.int32)
    st = biquad.Df1WideState(
        x=_i32(rng, (c, 2), device=cuda),
        y=torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, size=(c, 2),
                                        dtype=np.int64)).to(cuda))
    st_p = st
    for _ in range(3):
        xs = _i32(rng, (t, c), device=cuda)
        st, ys = df1_wide_bank(ba, st, xs, f, clamp=clamp)
        st_p, ys_p = df1_wide_bank_plain(ba, st_p, xs, f, clamp=clamp)
        torch.cuda.synchronize()
        _equal((st.x, st.y, ys), (st_p.x, st_p.y, ys_p))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("clamp", [None, (321, -(2**28), 2**28)])
def test_coef_bank_kernels_equal_plain(cuda, shared, clamp):
    """Shared (5,) and per-lane (5, c) coefficients, retuned between
    blocks: the state carries across each retune."""
    c, t = 100, 1000
    rng = np.random.default_rng(82)
    st = biquad.Df1State(x=_i32(rng, (c, 2), device=cuda),
                         y=_i32(rng, (c, 2), device=cuda))
    st_p = st
    for b in range(3):
        ba = (_stages(1)[0] if shared else
              np.roll(_stages(c).T, 17 * b, axis=1).copy())
        planes = torch.from_numpy(ba).to(cuda)
        xs = _i32(rng, (t, c), device=cuda)
        if clamp is None:
            st, ys = df1_bank_q_coef(planes, st, xs, 29)
            st_p, ys_p = df1_bank_q_coef_plain(planes, st_p, xs, 29)
        else:
            u, lo, hi = clamp
            st, ys = df1_clamp_bank_q_coef(planes, st, xs, 29, u=u, lo=lo,
                                           hi=hi)
            st_p, ys_p = df1_clamp_bank_q_coef_plain(planes, st_p, xs, 29,
                                                     u=u, lo=lo, hi=hi)
        torch.cuda.synchronize()
        _equal((st.x, st.y, ys), (st_p.x, st_p.y, ys_p))
    if shared and clamp is None:  # a shared set is K1's filter
        st0 = biquad.df1_init((c,), device=cuda)
        _equal(df1_bank_q_coef(_stages(1)[0], st0, xs, 29),
               df1_bank_q(_stages(1)[0], st0, xs, 29))


@pytest.mark.requires_cuda
def test_control_path_wrappers_reject_bad_input(cuda):
    st = biquad.df1_init((64,), device=cuda)
    xs = torch.zeros((32, 64), dtype=torch.int32, device=cuda)
    wide = biquad.df1_wide_init((64,), device=cuda)
    with pytest.raises(ValueError):  # the shift 32 - f needs f <= 32
        df1_wide_bank(BA_Q, wide, xs, 33)
    with pytest.raises(ValueError):  # y is int64
        df1_wide_bank(BA_Q, biquad.Df1WideState(x=wide.x, y=st.y), xs, 29)
    with pytest.raises(ValueError):  # planes (5, c)
        df1_bank_q_coef(torch.zeros((5, 63), dtype=torch.int32,
                                    device=cuda), st, xs, 29)
    with pytest.raises(ValueError):
        df1_clamp_bank_q_coef(BA_Q, st, xs, 64, lo=-1, hi=1)
    with pytest.raises(ValueError):  # one state per stage
        sos_bank_q(_stages(2), [st], xs, 29)


@pytest.mark.requires_cuda
def test_control_path_launch_after_refused_launch(cuda):
    """After a launch refused for its shared memory, K24-K27 launch as
    usual and match their plain versions: no CUDA error is left pending."""
    itp = hbf.hbf_int_cascade_init(4, (128,), axis=0, device=cuda)
    with pytest.raises(RuntimeError):
        hbf_int_cascade_bank(itp, torch.zeros((128, 128), device=cuda),
                             time_chunk=128)
    st = biquad.df1_init((128,), device=cuda)
    xs = torch.ones((64, 128), dtype=torch.int32, device=cuda)
    sts, ys = sos_bank_q(_stages(2), [st, st], xs, 29)
    sts_p, ys_p = sos_bank_q_plain(_stages(2), [st, st], xs, 29)
    _equal((tuple(sts), ys), (tuple(sts_p), ys_p))
    wide = biquad.df1_wide_init((128,), device=cuda)
    _equal(df1_wide_bank(BA_Q, wide, xs, 29, clamp=(0, -5, 5)),
           df1_wide_bank_plain(BA_Q, wide, xs, 29, clamp=(0, -5, 5)))
    _equal(df1_bank_q_coef(BA_Q, st, xs, 29),
           df1_bank_q_coef_plain(BA_Q, st, xs, 29))
    _equal(df1_clamp_bank_q_coef(BA_Q, st, xs, 29, lo=-5, hi=5),
           df1_clamp_bank_q_coef_plain(BA_Q, st, xs, 29, lo=-5, hi=5))


SOS_EDGES = [
    # (c, t, stages, stages a CTA, plan keywords): K24's clusters of 1-8
    # CTAs at t not a multiple of the 128-row chunk, under a chunk and one
    # row; 8 and 6 stages over chunks of 1-4 rows
    (1, 3 * 128 + 17, 8, 1, {}), (1, 3 * 128 + 17, 3, 2, {}),
    (50, 100, 3, 1, {}), (50, 100, 8, 2, {}), (50, 100, 8, 8, {}),
    (200, 2 * 128 + 5, 1, 1, {}), (200, 2 * 128 + 5, 4, 1, {}),
    (200, 2 * 128 + 5, 4, 4, {}), (200, 1, 3, 1, {}), (200, 1, 3, 3, {}),
    (50, 45, 8, 8, dict(chunk=4, ring=3)), (33, 23, 8, 8, dict(chunk=1,
                                                                ring=8)),
    (40, 37, 6, 3, dict(chunk=2, ring=2, producers=2)),
    # two one-stage ranks a CTA (a CTA's second rank unused at N = 3)
    (200, 2 * 64 + 5, 4, 1, dict(halves=2)), (1, 3 * 64 + 17, 3, 1,
                                              dict(halves=2)),
    (50, 100, 8, 1, dict(halves=2)), (50, 45, 2, 1, dict(halves=2,
                                                         chunk=4)),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f", [1, 29, 32, 33, 63])
@pytest.mark.parametrize("case", SOS_EDGES)
def test_sos_bank_q_kernel_at_plan_edges(cuda, case, f):
    """K24 at forced stage groups (`sos_plan`'s g: clusters of
    ceil(N / g) CTAs, a short last group where g does not divide N; two
    one-stage ranks a CTA; forced chunks down to 1 row) over 2
    carried blocks against the plain version: full-range x and state,
    coefficients in +-2^(f + 1), both shifts."""
    from idsp_tpu_torch.filters.pipe_plan import sos_plan

    c, t, n, g, kw = case
    rng = np.random.default_rng(2200 + f + n)
    top = min(2**31 - 1, 2 << f)
    ba = rng.integers(-top, top + 1, size=(n, 5)).astype(np.int32)
    plan = sos_plan(c, n, group=g, **kw)
    sts = [biquad.Df1State(x=_i32(rng, (c, 2), device=cuda),
                           y=_i32(rng, (c, 2), device=cuda))
           for _ in range(n)]
    _carried(lambda s, x: sos_bank_q(ba, s, x, f, _plan=plan),
             lambda s, x: sos_bank_q_plain(ba, s, x, f), sts,
             lambda: _i32(rng, (t, c), device=cuda), blocks=2)


WIDE_KINDS = ("K25", "K25 clamped", "K25 lo > hi", "K32", "K32 shared")


def _wide_call(kind, ba, f, plan):
    clamp = (CLAMP_Q if kind.endswith("clamped") else
             (5, 1 << 20, -(1 << 20)) if kind.endswith("hi") else None)
    if kind.startswith("K32"):
        return (lambda s, x: df1_wide_bank_coef(ba, s, x, f, clamp=clamp,
                                                _plan=plan),
                lambda s, x: df1_wide_bank_coef_plain(ba, s, x, f,
                                                      clamp=clamp))
    return (lambda s, x: df1_wide_bank(ba, s, x, f, clamp=clamp, _plan=plan),
            lambda s, x: df1_wide_bank_plain(ba, s, x, f, clamp=clamp))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f", [1, 16, 29, 32])
@pytest.mark.parametrize("kind", WIDE_KINDS)
@pytest.mark.parametrize("case", sorted(DEPTH0_EDGES))
def test_wide_kernels_at_pipe_edges(cuda, case, kind, f):
    """K25 (unclamped, clamped, lo > hi) and K32 (per-lane and shared
    planes) at the depth-0 pipeline's edges (`wide_plan`) over 2 carried
    blocks against their plain versions: full-range x and int64 y,
    coefficients in +-2^(f + 1)."""
    from idsp_tpu_torch.filters.biquad_cuda import wide_plan

    c, t, kw = DEPTH0_EDGES[case]
    plan = wide_plan(c, **kw) if kw else None
    rng = np.random.default_rng(2500 + f)
    top = min(2**31 - 1, 2 << f)
    shape = (5, c) if kind == "K32" else (5,)
    ba = torch.from_numpy(rng.integers(-top, top + 1, size=shape).astype(
        np.int32)).to(cuda)
    kern, plain = _wide_call(kind, ba, f, plan)
    st = biquad.Df1WideState(
        x=_i32(rng, (c, 2), device=cuda),
        y=torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, size=(c, 2),
                                        dtype=np.int64)).to(cuda))
    _carried(kern, plain, st, lambda: _i32(rng, (t, c), device=cuda),
             blocks=2)


@pytest.mark.requires_cuda
def test_sos_and_wide_entries_refuse_a_plan_not_their_own(cuda):
    """K24 refuses a plan whose shared memory is not its own sum (the x
    ring left out of a cluster's) or more warps than a chain block takes
    (its wrapper, ValueError, before the entry); K25's and K32's entries a
    plan of another kernel's words a row or shared memory (RuntimeError,
    nothing launched); the next launches run as usual."""
    from idsp_tpu_torch.filters.biquad_cuda import wide_plan
    from idsp_tpu_torch.filters.pipe_plan import sos_plan
    from idsp_tpu_torch.filters.svf_cuda import svf_plan

    c, t = 64, 300
    st = biquad.df1_init((c,), device=cuda)
    x = torch.ones((t, c), dtype=torch.int32, device=cuda)
    ba = _stages(3)
    plan = sos_plan(c, 3, group=1)
    two = sos_plan(c, 3, group=1, halves=2)
    for bad in (plan._replace(smem=plan.smem - 16 * plan.ring - 1),
                plan._replace(warps=16, producers=11),
                two._replace(producers=8), two._replace(halves=1)):
        with pytest.raises((RuntimeError, ValueError)):
            sos_bank_q(ba, [st] * 3, x, 29, _plan=bad)
    wst = biquad.df1_wide_init((c,), device=cuda)
    wp = wide_plan(c)
    for bad in (wp._replace(smem=wp.smem - 32), svf_plan(c)):
        for kind in ("K25", "K32 shared"):
            kern, _ = _wide_call(kind, BA_Q, 29, bad)
            with pytest.raises(RuntimeError):
                kern(wst, x)
    sts, ys = sos_bank_q(ba, [st] * 3, x, 29)
    sts_p, ys_p = sos_bank_q_plain(ba, [st] * 3, x, 29)
    _equal((tuple(sts), ys), (tuple(sts_p), ys_p))
    for kind in ("K25", "K32 shared"):
        kern, plain = _wide_call(kind, BA_Q, 29, None)
        _equal(kern(wst, x), plain(wst, x))


# --- K28-K33: the rest of the precision ladder -------------------------------


def _ints(rng, shape, bits, lo=None, hi=None, device=None):
    lo = -(2 ** (bits - 1)) if lo is None else lo
    hi = 2 ** (bits - 1) if hi is None else hi
    a = rng.integers(lo, hi, size=shape, dtype=np.int64)
    return torch.from_numpy(a.astype(f"int{bits}")).to(device)


def _dither_state(rng, c, device):
    return biquad.Df1DitherState(
        xy=biquad.Df1State(x=_i32(rng, (c, 2), device=device),
                           y=_i32(rng, (c, 2), device=device)),
        e=torch.from_numpy(rng.integers(0, 2**32, c)).to(device))


def _carried(kern, plain, st, make_x, blocks=3):
    """``kern`` == ``plain`` over carried blocks, every word."""
    st_p = st
    for _ in range(blocks):
        xs = make_x()
        st, ys = kern(st, xs)
        st_p, ys_p = plain(st_p, xs)
        torch.cuda.synchronize()
        _equal((tuple(st), ys), (tuple(st_p), ys_p))


LOWPASS = biquad.from_cookbook(Filter().critical_frequency(0.1).lowpass())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rung", ["q16", "q64", "q64_full_range", "f32"])
def test_precision_banks_kernel_equal_plain(cuda, rung):
    # 100 lanes and t = 1000: a ragged block of lanes and a tail of rows
    c, t = 100, 1000
    rng = np.random.default_rng(90)
    if rung == "q16":
        ba, f = biquad.quantize_ba(LOWPASS, 13, dtype=np.int16), 13
        kern, plain = df1_bank_q16, df1_bank_q16_plain
        args = (f,)

        def make(shape):
            return _ints(rng, shape, 16, device=cuda)
    elif rung == "f32":
        ba, kern, plain, args = LOWPASS, df1_bank_f32, df1_bank_f32_plain, ()

        def make(shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(cuda)
    else:
        full = rung == "q64_full_range"
        ba = (rng.integers(-(2**63), 2**63, 5, dtype=np.int64) if full
              else biquad.quantize_ba(LOWPASS, 61, dtype=np.int64))
        kern, plain, args = df1_bank_q64, df1_bank_q64_plain, (47 if full
                                                              else 61,)
        top = 64 if full else 56

        def make(shape):
            return _ints(rng, shape, 64, -(2 ** (top - 1)), 2 ** (top - 1),
                         device=cuda)
    launches = kern.launches
    _carried(lambda s, x: kern(ba, s, x, *args),
             lambda s, x: plain(ba, s, x, *args),
             biquad.Df1State(x=make((c, 2)), y=make((c, 2))),
             lambda: make((t, c)))
    assert kern.launches - launches == 3


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f", [29, 32, 16])
@pytest.mark.parametrize("clamp", [None, (1 << 10, -(1 << 23), 1 << 23),
                                   (2**31 - 9, -(2**31), 2**31 - 1)])
def test_df1_dither_bank_kernel_equals_plain(cuda, f, clamp):
    c, t = 100, 1000
    rng = np.random.default_rng(91)
    top = min(2**31 - 1, 2 << f)
    ba = rng.integers(-top, top + 1, size=5).astype(np.int32)
    _carried(lambda s, x: df1_dither_bank(ba, s, x, f, clamp=clamp),
             lambda s, x: df1_dither_bank_plain(ba, s, x, f, clamp=clamp),
             _dither_state(rng, c, cuda),
             lambda: _i32(rng, (t, c), device=cuda))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["wide", "dither"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("clamp", [None, (321, -(2**28), 2**28)])
def test_runtime_coef_wide_dither_kernels_equal_plain(cuda, kind, shared,
                                                      clamp):
    """Shared (5,) and per-lane (5, c) coefficients, retuned between
    blocks; a shared set equals the static twin (K25, K31)."""
    c, t = 100, 1000
    rng = np.random.default_rng(92)
    if kind == "wide":
        kern, plain, twin = (df1_wide_bank_coef, df1_wide_bank_coef_plain,
                             df1_wide_bank)
        st = biquad.Df1WideState(
            x=_i32(rng, (c, 2), device=cuda),
            y=torch.from_numpy(rng.integers(-(2**62), 2**62, (c, 2))).to(cuda))
    else:
        kern, plain, twin = (df1_dither_bank_coef, df1_dither_bank_coef_plain,
                             df1_dither_bank)
        st = _dither_state(rng, c, cuda)
    st_p = st
    for b in range(3):
        ba = (_stages(1)[0] if shared else
              np.roll(_stages(c).T, 17 * b, axis=1).copy())
        planes = torch.from_numpy(ba).to(cuda)
        xs = _i32(rng, (t, c), device=cuda)
        st, ys = kern(planes, st, xs, 29, clamp=clamp)
        st_p, ys_p = plain(planes, st_p, xs, 29, clamp=clamp)
        torch.cuda.synchronize()
        _equal((tuple(st), ys), (tuple(st_p), ys_p))
        if shared:
            _equal(kern(planes, st, xs, 29, clamp=clamp),
                   twin(ba, st, xs, 29, clamp=clamp))


@pytest.mark.requires_cuda
def test_precision_wrappers_reject_bad_input(cuda):
    c = 64
    q16 = biquad.df1_init((c,), torch.int16, device=cuda)
    q64 = biquad.df1_init((c,), torch.int64, device=cuda)
    f32 = biquad.df1_init((c,), torch.float32, device=cuda)
    dither = biquad.df1_dither_init((c,), device=cuda)
    x32 = torch.zeros((32, c), dtype=torch.int32, device=cuda)
    b16 = biquad.quantize_ba(LOWPASS, 13, dtype=np.int16)
    b64 = biquad.quantize_ba(LOWPASS, 61, dtype=np.int64)
    with pytest.raises(ValueError):  # int16 rows
        df1_bank_q16(b16, q16, x32, 13)
    with pytest.raises(ValueError):  # int64 state
        df1_bank_q64(b64, q16, x32.to(torch.int64), 61)
    with pytest.raises(ValueError):  # 32 < f < 64
        df1_bank_q64(b64, q64, x32.to(torch.int64), 32)
    with pytest.raises(ValueError):  # float32 rows
        df1_bank_f32(LOWPASS, f32, x32)
    with pytest.raises(ValueError):  # e is (c,) int64
        df1_dither_bank(BA_Q, dither._replace(e=dither.e.to(torch.int32)),
                        x32, 29)
    with pytest.raises(ValueError):  # 0 < f <= 32
        df1_dither_bank_coef(BA_Q, dither, x32, 0)
    with pytest.raises(ValueError):  # planes (5, c)
        df1_wide_bank_coef(torch.zeros((5, c + 1), dtype=torch.int32,
                                       device=cuda),
                           biquad.df1_wide_init((c,), device=cuda), x32, 29)


@pytest.mark.requires_cuda
def test_precision_banks_launch_after_refused_launch(cuda):
    """After a launch refused for its shared memory, K28-K33 launch as
    usual and match their plain versions: no CUDA error is left pending."""
    itp = hbf.hbf_int_cascade_init(4, (128,), axis=0, device=cuda)
    with pytest.raises(RuntimeError):
        hbf_int_cascade_bank(itp, torch.zeros((128, 128), device=cuda),
                             time_chunk=128)
    c = 128
    xs = torch.ones((64, c), dtype=torch.int32, device=cuda)
    b16 = biquad.quantize_ba(LOWPASS, 13, dtype=np.int16)
    b64 = biquad.quantize_ba(LOWPASS, 61, dtype=np.int64)
    for kern, plain, ba, st, x in (
            (df1_bank_q16, df1_bank_q16_plain, b16,
             biquad.df1_init((c,), torch.int16, device=cuda),
             xs.to(torch.int16)),
            (df1_bank_q64, df1_bank_q64_plain, b64,
             biquad.df1_init((c,), torch.int64, device=cuda),
             xs.to(torch.int64) << 40),
            (df1_bank_f32, df1_bank_f32_plain, LOWPASS,
             biquad.df1_init((c,), torch.float32, device=cuda),
             xs.to(torch.float32))):
        _equal(kern(ba, st, x), plain(ba, st, x))
    dither = biquad.df1_dither_init((c,), device=cuda)
    wide = biquad.df1_wide_init((c,), device=cuda)
    for kern, plain, st in ((df1_dither_bank, df1_dither_bank_plain, dither),
                            (df1_dither_bank_coef, df1_dither_bank_coef_plain,
                             dither),
                            (df1_wide_bank_coef, df1_wide_bank_coef_plain,
                             wide)):
        got = kern(BA_Q, st, xs, 29, clamp=(0, -5, 5))
        want = plain(BA_Q, st, xs, 29, clamp=(0, -5, 5))
        _equal((tuple(got[0]), got[1]), (tuple(want[0]), want[1]))


# K28 and K30 at the depth-0 pipeline's edges (`q16_plan`, `f32_plan`:
# 256-row chunks): DEPTH0_EDGES, t = 2 at c = 37, and c = 36 and 44 (K28's
# rows in 2-byte stores where c % 8 != 0, K30's 16-byte stores at c % 4 ==
# 0)
PRECISION_EDGES = {**DEPTH0_EDGES,
                   "t = 2": (37, 2, {}),
                   "c = 36, 2 chunks + 5": (36, 2 * 256 + 5, {}),
                   "c = 44, 1 producer": (44, 3 * 64 + 9,
                                          dict(producers=1, chunk=64,
                                               ring=2))}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f", [1, 13, 16, 17, 31])
@pytest.mark.parametrize("case", sorted(PRECISION_EDGES))
def test_df1_bank_q16_kernel_at_pipe_edges(cuda, case, f):
    """K28 over 2 carried blocks against its plain version: at f = 13 the
    Q16<13> lowpass on x and state in +-2^14, at the other f full-range
    int16 coefficients, x and state (the int32 sums wrap)."""
    from idsp_tpu_torch.filters.biquad_cuda import q16_plan

    c, t, kw = PRECISION_EDGES[case]
    plan = q16_plan(c, **kw) if kw else None
    rng = np.random.default_rng(280 + f)
    lim = 2**14 if f == 13 else 2**15
    ba = (biquad.quantize_ba(LOWPASS, 13, dtype=np.int16) if f == 13 else
          rng.integers(-(2**15), 2**15, 5).astype(np.int16))

    def make(shape):
        return _ints(rng, shape, 16, -lim, lim, device=cuda)

    _carried(lambda s, x: df1_bank_q16(ba, s, x, f, _plan=plan),
             lambda s, x: df1_bank_q16_plain(ba, s, x, f),
             biquad.Df1State(x=make((c, 2)), y=make((c, 2))),
             lambda: make((t, c)), blocks=2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(PRECISION_EDGES))
def test_df1_bank_f32_kernel_at_pipe_edges(cuda, case):
    """K30 over 2 carried blocks from a random state, x ~ N(0, 1), against
    its plain version, every word."""
    from idsp_tpu_torch.filters.biquad_cuda import f32_plan

    c, t, kw = PRECISION_EDGES[case]
    plan = f32_plan(c, **kw) if kw else None
    rng = np.random.default_rng(300)

    def make(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda)

    _carried(lambda s, x: df1_bank_f32(LOWPASS, s, x, _plan=plan),
             lambda s, x: df1_bank_f32_plain(LOWPASS, s, x),
             biquad.Df1State(x=make((c, 2)), y=make((c, 2))),
             lambda: make((t, c)), blocks=2)


@pytest.mark.requires_cuda
def test_q16_and_f32_entries_refuse_a_plan_not_their_own(cuda):
    """K28's and K30's entry points refuse a plan whose shared memory is
    not the kernel's own sum, roles that do not fit the warps, or another
    kernel's words a row (RuntimeError, nothing launched); the next launch
    runs as usual."""
    from idsp_tpu_torch.filters.biquad_cuda import f32_plan, q16_plan, q64_plan

    c, t = 64, 300
    b16 = biquad.quantize_ba(LOWPASS, 13, dtype=np.int16)
    for kern, plain, ba, dt, plan in (
            (df1_bank_q16, df1_bank_q16_plain, b16, torch.int16,
             q16_plan(c)),
            (df1_bank_f32, df1_bank_f32_plain, LOWPASS, torch.float32,
             f32_plan(c))):
        st = biquad.df1_init((c,), dt, device=cuda)
        x = torch.ones((t, c), dtype=dt, device=cuda)
        n0 = kern.launches
        for bad in (plan._replace(smem=plan.smem - 32),
                    plan._replace(producers=9),  # 10 roles in 9 places
                    q64_plan(c)):  # another kernel's words a row
            with pytest.raises(RuntimeError):
                kern(ba, st, x, _plan=bad)
        assert kern.launches == n0
        _equal(kern(ba, st, x), plain(ba, st, x))


# --- K34-K40: the filter structures -------------------------------------------


def _same(a, b):
    """Every tensor of two nested results (tuples, lists, NamedTuples)
    equal, dtype and shape too."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), (a != b).sum().item()


def _structure_hold(kern, plain, carry, make, t):
    """``kern`` == ``plain`` over 2 carried blocks of ``make(t)`` inputs,
    then one block == its two halves; each called as ``fn(carry, *x)``."""
    for _ in range(2):
        x = make(t)
        got = kern(carry, *x)
        torch.cuda.synchronize()
        _same(got, plain(carry, *x))
        carry = got[0]
    x = make(t)
    whole = kern(carry, *x)
    h = t // 2
    first = kern(carry, *(v[:h].contiguous() for v in x))
    second = kern(first[0], *(v[h:].contiguous() for v in x))
    _same(second[0], whole[0])
    outs = [first[1], second[1]]
    if isinstance(whole[1], tuple):
        _same(tuple(torch.cat(p) for p in zip(*outs)), whole[1])
    else:
        _same(torch.cat(outs), whole[1])


CA7 = ([(0xAD, 2, [-0.9, 0.9]), (0xAD, 2, [-0.6, 0.7])],
       [(0xAD, 2, [-0.7, 0.6]), (0xA, 1, [0.8])])
CA19 = ([(0x1, 1, [0.0]), (0x1C, 2, [-0.226119, 0.0]),
         (0x1D, 2, [-0.602422, 0.0]), (0x1D, 2, [-0.83932, 0.0]),
         (0x1D, 2, [-0.950847, 0.0])],
        [(0x1C, 2, [-0.063978, 0.0]), (0x1C, 2, [-0.423068, 0.0]),
         (0x1D, 2, [-0.741327, 0.0]), (0x1D, 2, [-0.905567, 0.0]),
         (0x1D, 2, [-0.984721, 0.0])])


def _wdf_stages(spec):
    return [(wdf.nibbles(m, n), wdf.quantize(wdf.nibbles(m, n), g))
            for m, n, g in spec]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("output", ["lp", "hp", "bp", "br"])
def test_svf_bank_kernel_equals_plain(cuda, output):
    # 100 lanes and t = 1000: a ragged block of lanes and a tail of rows
    c, t = 100, 1000
    rng = np.random.default_rng(100)
    f, qi = svf.coefficients(0.01, 0.7)

    def make(rows):
        return (torch.from_numpy(rng.normal(size=(rows, c)).astype(
            np.float32)).to(cuda),)

    st = svf.SvfState(*(torch.from_numpy(rng.normal(size=c).astype(
        np.float32)).to(cuda) for _ in range(3)))
    launches = svf_bank.launches
    _structure_hold(lambda s, x: svf_bank(f, qi, s, x, output=output),
                    lambda s, x: svf_bank_plain(f, qi, s, x, output=output),
                    st, make, t)
    assert svf_bank.launches - launches == 5


@pytest.mark.requires_cuda
@pytest.mark.parametrize("form", ["q29", "q29_full_range", "f32"])
def test_normal_bank_kernels_equal_plain(cuda, form):
    c, t = 100, 1000
    rng = np.random.default_rng(101)
    b, p = normal.from_cookbook(Filter().critical_frequency(0.06).lowpass())
    if form == "f32":
        kern, plain, args = normal_bank_f32, normal_bank_f32_plain, (b, p)

        def make(shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(cuda)
    else:
        bq, pq = fxp.from_float(b, 29), fxp.from_float(p, 29)
        kern, plain, args = normal_bank_q, normal_bank_q_plain, (bq, pq)
        lim = 2**31 if form == "q29_full_range" else 2**24

        def make(shape):
            return _i32(rng, shape, -lim, lim, device=cuda)

    _structure_hold(lambda s, x: kern(*args, s, x),
                    lambda s, x: plain(*args, s, x),
                    biquad.Df1State(x=make((c, 2)), y=make((c, 2))),
                    lambda rows: (make((rows, c)),), t)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("sf", [9, 12, 32, 36, 40])
def test_rpll_bank_kernel_equals_plain(cuda, sf):
    """Full-range timestamps and state, at shifts below, at and above 32."""
    c, t = 100, 1000
    rng = np.random.default_rng(sf)
    cfg = rpll.RpllConfig(dt2=8, shift_frequency=sf, shift_phase=11)

    def make(rows):
        return (_i32(rng, (rows, c), device=cuda),
                torch.from_numpy(rng.random((rows, c)) < 0.3).to(cuda))

    st = rpll.RpllState(*(_i32(rng, (c,), device=cuda) for _ in range(4)))
    _structure_hold(lambda s, x, v: rpll_bank(cfg, s, x, v),
                    lambda s, x, v: rpll_bank_plain(cfg, s, x, v), st, make,
                    t)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["every-type", "bank", "chain-ca19",
                                  "pair-ca7", "pair-ca19"])
def test_wdf_kernels_equal_plain(cuda, kind):
    c, t = 100, 300
    rng = np.random.default_rng(len(kind))

    def z(n):
        return wdf.WdfState(z=_i32(rng, (c, n), device=cuda))

    def make(rows):
        return (_i32(rng, (rows, c), device=cuda),)

    if kind == "every-type":
        tp = [wdf.Tpa(v) for v in (0xA, 0xB, 0xE, 0x1, 0xC, 0xF, 0xD, 0x0)]
        a = wdf.quantize(tp, [0.7, 0.3, 0.2, 0.0, -0.3, -0.45, -0.8, 0.0])
        kern, plain = wdf_bank, wdf_bank_plain
        args, st = (tp, a), z(8)
    elif kind == "bank":
        (tp, a), = _wdf_stages(CA7[0][:1])
        kern, plain, args, st = wdf_bank, wdf_bank_plain, (tp, a), z(2)
    elif kind == "chain-ca19":
        kern, plain = wdf_chain_bank, wdf_chain_bank_plain
        args = (_wdf_stages(CA19[0]),)
        st = [z(n) for _, n, _ in CA19[0]]
    else:
        spec = CA7 if kind == "pair-ca7" else CA19
        kern, plain = wdf_pair_bank, wdf_pair_bank_plain
        args = tuple(_wdf_stages(br) for br in spec)
        st = tuple([z(n) for _, n, _ in br] for br in spec)
    launches = kern.launches
    _structure_hold(lambda s, x: kern(*args, s, x),
                    lambda s, x: plain(*args, s, x), st, make, t)
    assert kern.launches - launches == 5


# K38-K40 at forced and default plans (`wdf_cuda.launch_plan`): (branches
# as CA7 / CA19-style specs or "random", c, t, plan arguments)
WDF_PLAN_CASES = {
    "spec-X": ([[(0x1, 1, [0.0])]], 100, 300, {}),
    "spec-A": ([[(0xA, 1, [0.8])]], 100, 300, {}),
    "spec-DA": ([[(0xAD, 2, [-0.9, 0.9])]], 100, 300, {}),
    "spec-CX": ([[(0x1C, 2, [-0.226119, 0.0])]], 100, 300, {}),
    "spec-DX": ([[(0x1D, 2, [-0.602422, 0.0])]], 100, 300, {}),
    "generic-ca7": (list(CA7), 100, 300, {"generic": True}),
    "generic-ca19": (list(CA19), 100, 300, {"generic": True}),
    "generic-24-stages": ([[(0xD, 1, [-0.8])] * 12] * 2, 64, 200, {}),
    "generic-chain-D": ([[(0xD, 1, [-0.8]), (0xDA, 2, [0.9, -0.9])]], 64,
                        200, {}),
    "chunk5-ca19": (list(CA19), 100, 300, {"chunk": 5}),
    "chunk1-depth1-ca7": (list(CA7), 100, 70, {"chunk": 1, "depth": 1}),
    "chunk-edges-ca19": (list(CA19), 64, 193, {}),
    "t1-ca19": (list(CA19), 100, 1, {}),
    "t5-ca7": (list(CA7), 100, 5, {}),
    "c37-ca19": (list(CA19), 37, 300, {}),
    "c36-ca7": (list(CA7), 36, 300, {"chunk": 8}),
    "unaligned-ca19": (list(CA19), 64, 300, {"unaligned": True}),
    "random-0": ("random", 100, 300, {}),
    "random-1": ("random", 100, 300, {"chunk": 7}),
    "random-2": ("random", 64, 129, {}),
}


def _random_branches(rng):
    """Two branches of 1-3 and 1-5 stages of 1-3 random adapters."""
    g_of = {0xA: 0.7, 0xB: 0.3, 0xE: 0.2, 0xC: -0.3, 0xF: -0.45, 0xD: -0.8}
    out = []
    for most in (3, 5):
        br = []
        for _ in range(int(rng.integers(1, most + 1))):
            tp = [wdf.Tpa(int(v)) for v in rng.choice(
                [0xA, 0xB, 0xE, 0x1, 0xC, 0xF, 0xD, 0x0],
                size=int(rng.integers(1, 4)))]
            br.append((tp, wdf.quantize(tp, [g_of.get(int(v), 0.0)
                                             for v in tp])))
        out.append(br)
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(WDF_PLAN_CASES))
def test_wdf_plans_equal_plain(cuda, case):
    """The stage-warp kernel (K38-K40's) at each specialised (N, M), the
    generic loop (forced, or for stages outside the set), chunk edges, t
    below a chunk, ragged and unaligned lanes (the 4-byte paths) and
    random unequal pairs: 2 carried blocks from a random state against
    the plain version, then one block against its halves, bit for bit."""
    spec, c, t, kw = WDF_PLAN_CASES[case]
    kw = dict(kw)
    unaligned = kw.pop("unaligned", False)
    rng = np.random.default_rng(sum(map(ord, case)))
    branches = (_random_branches(rng) if spec == "random"
                else [_wdf_stages(br) for br in spec])
    plan = wdf_cuda.launch_plan([[tp for tp, _ in br] for br in branches],
                                **kw)
    if case.startswith("spec-"):
        assert plan.kinds[0] > 0
    if case.startswith("generic-"):
        assert plan.kinds == (0,) * len(plan.kinds)

    def rows(n):
        x = _i32(rng, (n, c), device=cuda)
        if not unaligned:
            return x
        buf = torch.zeros(n * c + 1, dtype=torch.int32, device=cuda)
        buf[1:].view(n, c).copy_(x)
        return buf[1:].view(n, c)

    pair = len(branches) == 2
    name = "wdf_pair_bank" if pair else "wdf_chain_bank"

    def kern(sts, x, plan=plan):
        new, ys = wdf_cuda._launch(name, branches, sts, x, plan=plan)
        return (new, tuple(ys)) if pair else (new[0], ys[0])

    def plain(sts, x):
        if pair:
            (s0, s1), ys = wdf_pair_bank_plain(branches[0], branches[1],
                                               tuple(sts), x)
            return [s0, s1], ys
        return wdf_chain_bank_plain(branches[0], sts[0], x)

    sts = [[wdf.WdfState(z=_i32(rng, (c, len(tp)), device=cuda))
            for tp, _ in br] for br in branches]
    for _ in range(2):
        x = rows(t)
        got, want = kern(sts, x), plain(sts, x)
        torch.cuda.synchronize()
        _same(got, want)
        sts = got[0] if pair else [got[0]]
    x = rows(t)
    whole = kern(sts, x)
    h = t // 2
    first = kern(sts, x[:h].contiguous())
    second = kern(first[0] if pair else [first[0]], x[h:].contiguous())
    _same(second[0], whole[0])
    if pair:
        _same(tuple(torch.cat(p) for p in zip(first[1], second[1])),
              whole[1])
    else:
        _same(torch.cat([first[1], second[1]]), whole[1])


@pytest.mark.requires_cuda
def test_wdf_refuses_bad_plans_and_leaves_no_pending_error(cuda):
    """A plan the kernel cannot run -- shared memory not its own sum,
    beyond a block's, or a stage claiming another stage's specialised
    loop -- raises before any launch, and the next launch runs."""
    c = 64
    branches = [_wdf_stages(br) for br in CA7]
    types = [[tp for tp, _ in br] for br in branches]
    sts = [[wdf.init(len(tp), (c,), device=cuda) for tp, _ in br]
           for br in branches]
    x = torch.ones((64, c), dtype=torch.int32, device=cuda) << 20
    good = wdf_cuda.launch_plan(types)
    bad = [good._replace(smem=good.smem + 16),
           wdf_cuda.launch_plan(types, chunk=256, depth=8),
           good._replace(kinds=(3, 3, 3, 3))]  # [A] is not (2, 0xAD)
    assert bad[1].smem > wdf_cuda.MAX_SMEM
    for plan in bad:
        with pytest.raises(RuntimeError):
            wdf_cuda._launch("wdf_pair_bank", branches, sts, x, plan=plan)
    (s0, s1), ys = wdf_pair_bank(*branches, tuple(sts), x)
    _same(((s0, s1), ys), wdf_pair_bank_plain(*branches, tuple(sts), x))


@pytest.mark.requires_cuda
def test_structures_wrappers_reject_bad_input(cuda):
    c = 64
    xf = torch.zeros((32, c), device=cuda)
    xi = torch.zeros((32, c), dtype=torch.int32, device=cuda)
    b, p = normal.from_cookbook(Filter().critical_frequency(0.06).lowpass())
    bq, pq = fxp.from_float(b, 29), fxp.from_float(p, 29)
    with pytest.raises(ValueError):  # float32 rows
        svf_bank(0.1, 1.0, svf.init((c,), device=cuda), xi)
    with pytest.raises(ValueError):  # no such output
        svf_bank(0.1, 1.0, svf.init((c,), device=cuda), xf, output="x")
    with pytest.raises(ValueError):  # int32 state
        normal_bank_q(bq, pq, normal.init((c,), device=cuda), xi)
    with pytest.raises(ValueError):  # p_im == INT32_MIN
        normal_bank_q(bq, np.array([pq[0], -(2**31)], np.int32),
                      normal.init((c,), torch.int32, device=cuda), xi)
    with pytest.raises(ValueError):  # float32 rows
        normal_bank_f32(b, p, normal.init((c,), device=cuda), xi)
    with pytest.raises(ValueError):  # bool valids
        rpll_bank(rpll.RpllConfig(8, 12, 11), rpll.init((c,), device=cuda),
                  xi, xi)
    with pytest.raises(ValueError):  # sf > 32 + dt2
        rpll_bank(rpll.RpllConfig(8, 41, 11), rpll.init((c,), device=cuda),
                  xi, xi.bool())
    tp = wdf.nibbles(0xAD, 2)
    with pytest.raises(ValueError):  # z is (c, 2)
        wdf_bank(tp, wdf.quantize(tp, [-0.9, 0.9]),
                 wdf.init(3, (c,), device=cuda), xi)
    with pytest.raises(ValueError):  # one coefficient set per stage
        wdf_bank(tp, np.zeros((c, 2), np.int32),
                 wdf.init(2, (c,), device=cuda), xi)


@pytest.mark.requires_cuda
def test_wdf_chain_over_max_raises_and_leaves_no_pending_error(cuda):
    """A chain of more than WDF_MAX adapters is refused before any launch,
    never truncated, and the next launch runs as usual."""
    c = 64
    stages = _wdf_stages(CA19[0] + CA19[1] + CA7[0] + CA7[1])
    assert sum(len(tp) for tp, _ in stages) > WDF_MAX
    xi = torch.ones((64, c), dtype=torch.int32, device=cuda) << 20
    states = [wdf.init(len(tp), (c,), device=cuda) for tp, _ in stages]
    launches = wdf_chain_bank.launches
    with pytest.raises(ValueError):
        wdf_chain_bank(stages, states, xi)
    assert wdf_chain_bank.launches == launches
    ca19 = _wdf_stages(CA19[0])
    st = [wdf.init(len(tp), (c,), device=cuda) for tp, _ in ca19]
    _same(wdf_chain_bank(ca19, st, xi), wdf_chain_bank_plain(ca19, st, xi))


# K41 cases: (dtype, lanes, h) -- 16-byte words (f32 and f64 rows, several
# blocks at h = 90), 4-byte (int32 rows of 12 bytes) and 1-byte (int8)
K41_CASES = {"i32x8_h3": (np.int32, 8, 3),
             "f32x1024_h90": (np.float32, 1024, 90),
             "i32x3_h3": (np.int32, 3, 3), "i8x3_h3": (np.int8, 3, 3),
             "f64x1024_h2": (np.float64, 1024, 2)}


@pytest.fixture(scope="module")
def k41_runs():
    """Every K41 case in one spawn of 2 ranks on card 0 (the library built
    here first, so the ranks find it and run no nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a CUDA kernel with its "
                    "plain PyTorch version")
    import torch_ranks
    from idsp_tpu_torch import _ext

    _ext.library()
    rng = np.random.default_rng(41)
    blocks = {k: [rng.integers(-100, 100, size=(2 * 96, c)).astype(dt)
                  for _ in range(3)] for k, (dt, c, _) in K41_CASES.items()}
    cases = {k: ("halo_rdma_vs_plain", 2, dict(xs=blocks[k], h=h, fill=-7))
             for k, (_, _, h) in K41_CASES.items()}
    return blocks, torch_ranks.spawn(2, cases, device="cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(K41_CASES))
def test_halo_exchange_prev_rdma_kernel_equals_plain(k41_runs, case):
    """Three puts back to back on the same slots (epochs 1-3): each rank's
    halo equals the plain version's and the left block's last h rows."""
    blocks, runs = k41_runs
    h = K41_CASES[case][2]
    for r, out in enumerate(runs):
        same, launches, got = out[case]
        assert same and launches == 3
        for x, g in zip(blocks[case], got):
            want = (np.full_like(x[:h], -7) if r == 0
                    else np.split(x, 2)[r - 1][-h:])
            np.testing.assert_array_equal(g, want)
    assert not any(out["jax_imported"] for out in runs)
