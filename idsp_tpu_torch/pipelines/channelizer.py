"""Maximally decimated polyphase analysis channel bank (port of
`idsp_tpu.pipelines.channelizer`, reference
examples/polyphase_channelizer.rs generalized to any power-of-two M;
BASELINE config #3 at M = 1024).

The polyphase FIR is M parallel decimated FIRs (one per branch) over the
frame axis, tap 0 the newest frame; the DFT across branches is a matrix
product against the M x M DFT matrix, or an FFT.  Sign convention of the
reference's DFT4 (polyphase_channelizer.rs:77-101): ``y[m] = sum_k x_k
exp(-2 pi j k m / M)``, unnormalized.

`channelize_planes` takes I/Q planes ``(..., n, m)``; ``impl="xla"`` is
the plain composition (the JAX package's name for it: there XLA runs
it), ``impl="fused"`` the one-kernel K17 `channelize_fused`.
`channelize_tp` is the tensor-parallel form over a `torch.distributed`
group (the branch axis split over the ranks).
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch


def prototype(m: int = 4, taps: int = 8) -> np.ndarray:
    """Hamming-windowed sinc prototype, DC-normalized
    (polyphase_channelizer.rs:29-44); (m*taps,) f32."""
    n = m * taps
    fc = 0.5 / m * 0.9
    mid = (n - 1) / 2.0
    i = np.arange(n, dtype=np.float64)
    x = 2.0 * np.pi * fc * (i - mid)
    sinc = np.where(x == 0.0, 1.0, np.sin(x) / np.where(x == 0.0, 1.0, x))
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))
    h = 2.0 * fc * sinc * w
    return (h / h.sum()).astype(np.float32)


class BankState(NamedTuple):
    """Polyphase FIR history: (taps-1) carried frames, each (M, 2) IQ."""

    hist: torch.Tensor  # (..., taps-1, m, 2)


def init(m: int = 4, taps: int = 8, shape=(), dtype=torch.float32, *,
         device) -> BankState:
    return BankState(hist=torch.zeros(tuple(shape) + (taps - 1, m, 2),
                                      dtype=dtype, device=device))


@lru_cache(maxsize=None)
def _dft_matrix(m: int) -> np.ndarray:
    """(m, m) forward (negative-exponent) DFT matrix, complex64 (numpy, as
    in the JAX package, so both hold the same twiddles)."""
    k = np.arange(m)
    w = np.exp(-2j * np.pi * np.outer(k, k) / m)
    return w.astype(np.complex64)


@lru_cache(maxsize=8)
def twiddles(m: int, dtype: torch.dtype, device: torch.device):
    """(wr, wi) (m, m) planes of `_dft_matrix` in ``dtype`` on ``device``,
    made once per (m, dtype, device)."""
    w = _dft_matrix(m)
    return tuple(torch.from_numpy(np.ascontiguousarray(
        part(w).astype(np.float32))).to(device=device, dtype=dtype)
        for part in (np.real, np.imag))


@lru_cache(maxsize=8)
def _dft_block(m: int, dtype: torch.dtype, device: torch.device):
    """``[[wr, wi], [-wi, wr]]`` (2m, 2m) of the ``dtype`` twiddles, held
    in f32 (negation is exact in either dtype)."""
    wr, wi = (w.float() for w in twiddles(m, dtype, device))
    return torch.cat([torch.cat([wr, wi], 1), torch.cat([-wi, wr], 1)])


class PlanesState(NamedTuple):
    """Polyphase FIR history as separate I/Q planes, (..., taps-1, m)
    each."""

    hist_r: torch.Tensor
    hist_i: torch.Tensor


def init_planes(m: int = 4, taps: int = 8, shape=(), dtype=torch.float32, *,
                device) -> PlanesState:
    shp = tuple(shape) + (taps - 1, m)
    return PlanesState(hist_r=torch.zeros(shp, dtype=dtype, device=device),
                       hist_i=torch.zeros(shp, dtype=dtype, device=device))


@contextlib.contextmanager
def full_f32_matmul():
    """Run the enclosed ``torch.matmul`` of f32 operands in full f32,
    whatever the caller set: TF32 keeps 10 mantissa bits, and the f32 DFT
    is gated at 2e-5 of the scale.  The card's setting is restored on
    exit; the CPU never rounds to TF32."""
    mm = torch.backends.cuda.matmul
    old = mm.fp32_precision
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = old


def coefficients(proto, m: int, taps: int) -> np.ndarray:
    """The prototype as per-tap branch rows (taps, m) f32 (``prototype(m,
    taps)`` for None)."""
    if proto is None:
        proto = prototype(m, taps)
    return np.asarray(proto, np.float32).reshape(taps, m)


def polyphase_fir(hist, z, coeff):
    """``y[t] = sum_tap coeff[tap] * frame[t - tap]`` over the frame axis
    -2, tap 0 the newest frame, summed in tap order; frames before the
    block come from ``hist`` (..., taps-1, m).  Returns (acc, new_hist):
    new_hist the last taps-1 frames of hist then z."""
    taps = coeff.shape[0]
    n = z.shape[-2]
    ext = torch.cat([hist, z], dim=-2)
    acc = None
    for tap in range(taps):
        term = ext[..., taps - 1 - tap:taps - 1 - tap + n, :] * coeff[tap]
        acc = term if acc is None else acc + term
    return acc, ext[..., n:, :].clone()


def channelize_planes(state: PlanesState, zr, zi, proto=None, *, m: int = 4,
                      taps: int = 8, dft: str = "matmul",
                      twiddle_dtype=torch.float32, impl: str = "xla"):
    """Plane-layout analysis bank.

    Args:
      zr, zi: (..., n, m) f32 I/Q planes of the frame stream (m polyphase
        branches on the last axis).
      dft: "matmul" (one real (n, 2m) x (2m, 2m) block product) or "fft".
      twiddle_dtype: matmul precision: float32 keeps both operands f32;
        bfloat16 rounds the DFT matrix and the FIR output to bf16 (their
        products are exact in f32, the sums f32).
      impl: "xla" (this composition) or "fused": K17 `channelize_fused`
        (FIR + cast + the DFT as four products in one kernel; needs
        dft="matmul", 2-D planes and m % 128 == 0).  The two agree up to
        f32 summation order, never bit for bit.

    Returns (state, yr, yi), planes shaped like the inputs.
    """
    if impl == "fused":
        if dft != "matmul":
            raise ValueError("impl='fused' supports dft='matmul' only")
        from .channelizer_cuda import channelize_fused

        return channelize_fused(state, zr, zi, proto, m=m, taps=taps,
                                twiddle_dtype=twiddle_dtype)
    if impl != "xla":
        raise ValueError(f"unknown impl {impl!r}")
    coeff = torch.from_numpy(coefficients(proto, m, taps)).to(zr.device)
    accr, hist_r = polyphase_fir(state.hist_r, zr, coeff)
    acci, hist_i = polyphase_fir(state.hist_i, zi, coeff)
    new_state = PlanesState(hist_r=hist_r, hist_i=hist_i)

    if dft == "fft":
        zf = torch.fft.fft(torch.complex(accr, acci), dim=-1)
        return new_state, zf.real.contiguous(), zf.imag.contiguous()
    if dft != "matmul":
        raise ValueError(f"unknown dft {dft!r}")
    # [yr yi] = [ar ai] @ [[wr, wi], [-wi, wr]], f32 accumulation
    ab = torch.cat([accr, acci], dim=-1)
    with full_f32_matmul():
        y = torch.matmul(ab.to(twiddle_dtype).float(),
                         _dft_block(m, twiddle_dtype, zr.device))
    return new_state, y[..., :m].contiguous(), y[..., m:].contiguous()


def channelize(state: BankState, x, proto=None, *, m: int = 4, taps: int = 8,
               dft: str = "matmul"):
    """Process (..., n_frames, m, 2) input frames (polyphase FIR + DFT),
    the reference's `View::from_frames` layout
    (polyphase_channelizer.rs:103-119), through `channelize_planes`.
    Returns (state, y) with y shaped like x."""
    pst = PlanesState(hist_r=state.hist[..., 0], hist_i=state.hist[..., 1])
    pst, yr, yi = channelize_planes(pst, x[..., 0], x[..., 1], proto, m=m,
                                    taps=taps, dft=dft)
    return (BankState(hist=torch.stack([pst.hist_r, pst.hist_i], dim=-1)),
            torch.stack([yr, yi], dim=-1))


def channelize_tp(state: BankState, x_local, group=None, *, m: int,
                  taps: int = 8, proto=None, out_mode: str = "replicated"):
    """Tensor-parallel channelizer: the DFT *contraction* axis (the
    polyphase branches k) split over the ranks of ``group``.

    Each rank runs the polyphase FIR on its ``m/P`` branch slice and
    contributes a partial DFT for ALL output channels; one sum over the
    ranks combines the partials -- the tensor-parallel matmul pattern
    (split the contraction axis, all-reduce the output) applied to the
    channelizer's DFT (polyphase_channelizer.rs:77-101).  The per-rank
    body of a `torch.distributed` program (JAX: a `shard_map` body).

    Args:
      state: this rank's BankState, hist (..., taps-1, m_loc, 2).
      x_local: (..., n, m_loc, 2), this rank's branch slice of the (..., n,
        m, 2) frame stream (rank r holds branches [r m_loc, (r+1) m_loc)).

    Returns (state, y).  ``out_mode="replicated"`` sums the partials on
    every rank, y the full (..., n, m, 2); ``"scatter"`` reduce-scatters
    over the output-channel axis, y this rank's (..., n, m/P, 2) slice --
    1/P of the collective's output bytes, for a consumer that is itself
    channel-sharded.  Matches `channelize` up to f32 summation order (the
    sum over ranks reassociates the k-sum).
    """
    from ..parallel import _comm

    p, idx = _comm.size(group), _comm.rank(group)
    if m % p:
        raise ValueError(f"m={m} branches do not split over {p} ranks")
    m_loc = x_local.shape[-2]
    if m_loc * p != m:
        raise ValueError(f"x_local holds {m_loc} branches, not m/P = {m // p}")
    if out_mode not in ("replicated", "scatter"):
        raise ValueError(f"unknown out_mode {out_mode!r}")
    rows = slice(idx * m_loc, (idx + 1) * m_loc)
    dev = x_local.device
    coeff = torch.from_numpy(np.ascontiguousarray(
        coefficients(proto, m, taps)[:, rows])).to(dev)  # (taps, m_loc)

    n = x_local.shape[-3]
    ext = torch.cat([state.hist, x_local], dim=-3)
    acc = None
    for tap in range(taps):
        term = ext[..., taps - 1 - tap:taps - 1 - tap + n, :, :] * coeff[
            tap][:, None]
        acc = term if acc is None else acc + term
    new_hist = ext[..., n:, :, :].clone()

    # partial DFT from this rank's k rows, real/imag planes
    w = _dft_matrix(m)[rows]
    wr, wi = (torch.from_numpy(np.ascontiguousarray(
        part(w).astype(np.float32))).to(dev) for part in (np.real, np.imag))
    zr, zi = acc[..., 0], acc[..., 1]  # (..., n, m_loc)
    with full_f32_matmul():
        yr = zr @ wr - zi @ wi
        yi = zr @ wi + zi @ wr
    stacked = torch.stack([yr, yi], dim=-1)
    if out_mode == "scatter":
        y = _comm.psum_scatter(stacked, group, dim=-2)
    else:
        y = _comm.psum(stacked, group)
    return BankState(hist=new_hist), y


def frames_from_stream(x_iq, m: int):
    """(..., n*m, 2) interleaved IQ stream -> (..., n, m, 2) frames."""
    t = x_iq.shape[-2]
    if t % m:
        raise ValueError(f"stream length {t} is not a multiple of m={m}")
    return x_iq.reshape(*x_iq.shape[:-2], t // m, m, 2)


def planes_from_stream(x_re, x_im, m: int):
    """(..., n*m) I/Q plane streams -> ((..., n, m), (..., n, m)) frames,
    the `channelize_planes` input layout (reshapes only)."""
    t = x_re.shape[-1]
    if t % m:
        raise ValueError(f"stream length {t} is not a multiple of m={m}")
    shp = tuple(x_re.shape[:-1]) + (t // m, m)
    return x_re.reshape(shp), x_im.reshape(shp)


def tone(freq: float, n: int, *, device):
    """Unit complex tone (polyphase_channelizer.rs:124-128): (n, 2) f32."""
    ph = 2.0 * np.pi * freq * np.arange(n, dtype=np.float64)
    return torch.from_numpy(
        np.stack([np.cos(ph), np.sin(ph)], axis=-1).astype(np.float32)
    ).to(device)


def channel_powers(freq: float, m: int = 4, taps: int = 8, n: int = 4096, *,
                   device="cuda"):
    """Mean power per channel of a tone (polyphase_channelizer.rs:133-146),
    the first 128 frames skipped; runs on ``device`` (the card unless the
    caller asks for another).  Returns (m,) float64 numpy."""
    x = frames_from_stream(tone(freq, n, device=device), m)
    _, y = channelize(init(m, taps, device=device), x, m=m, taps=taps)
    y = y.cpu().numpy().astype(np.float64)[128:]
    return (y ** 2).sum(axis=-1).mean(axis=0)
