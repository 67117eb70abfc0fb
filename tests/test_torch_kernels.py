"""The CUDA kernels K1-K6 against their plain PyTorch versions, on the card.

Marked ``requires_cuda``; each test skips (inside its fixture) where no
CUDA device is present.  No jax here, so the file also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels.py

On the card every K1-K6 output must equal its plain version bit for bit:
the integer paths are the same int64 arithmetic, and the kernels' f32
operations are single-rounding intrinsics in the plain versions' order,
as eager PyTorch rounds each operation.
"""

import numpy as np
import pytest
import torch

from idsp_tpu_torch.design import Filter
from idsp_tpu_torch.filters import biquad
from idsp_tpu_torch.filters.biquad_cuda import df1_bank_q, df1_bank_q_plain
from idsp_tpu_torch.filters.ddc_cuda import (
    df1_hbf_cascade_bank,
    df1_hbf_cascade_bank_plain,
    fastlo_ddc_cascade_bank,
    fastlo_ddc_cascade_bank_plain,
    hbf1_tail_init,
)
from idsp_tpu_torch.filters import lowpass, pll
from idsp_tpu_torch.filters.ddc_bank_cuda import (
    fastlo_ddc_bank_block_lp,
    fastlo_ddc_bank_block_lp_plain,
)
from idsp_tpu_torch.filters.hbf import HBF_TAPS
from idsp_tpu_torch.filters.lowpass_cuda import lowpass_bank, lowpass_bank_plain
from idsp_tpu_torch.filters.pll_cuda import pll_bank, pll_bank_plain

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
