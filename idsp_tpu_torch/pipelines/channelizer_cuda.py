"""K17: the one-kernel polyphase channelizer, FIR + cast + DFT (port of
`idsp_tpu.pipelines.channelizer_pallas.channelize_fused`).

`channelize_fused` runs the CUDA kernel of ``csrc/channelize.cu`` for
CUDA tensors and its plain PyTorch version, `channelize_fused_plain`,
for CPU tensors; any other device raises.  The plain version is the
kernel's function: the polyphase FIR in the kernel's tap order (tap 0
newest, each product and sum rounded on its own), the cast to the
twiddle dtype, then four ``(n, m) x (m, m)`` products with f32
accumulation combined as ``yr = ar wr - ai wi``, ``yi = ar wi + ai wr``
(channelizer_pallas.py:136-158).  Kernel and plain version hold the same
FIR output and twiddles bit for bit and differ only in the order of the
products' sums; the carried history is a copy of input rows.

The kernel's launch plan -- frames a CTA, the thread-block cluster that
shares the FIR, the ring stages and the shared memory they take -- is
`launch_plan`'s, and the twiddles reach it pre-tiled (`tiled_twiddles`):
one contiguous tile a (column tile, chunk of branches), in the layout
the kernel's shared memory holds.  Both, and the default prototype's
coefficients on the card, are made once per shape and device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from .. import _ext
from .channelizer import (
    PlanesState,
    coefficients,
    full_f32_matmul,
    polyphase_fir,
    twiddles,
)

TWIDDLE_DTYPES = (torch.float32, torch.bfloat16)
MAX_TAPS = 16  # csrc/channelize.cu kMaxTaps
# csrc/channelize.cu: columns a CTA, branches a chunk (the pre-tiled
# twiddles' chunk), the largest portable cluster, the barriers' bytes, a
# chunk's twiddle tile, the dynamic shared memory a CTA may take (227 KB)
COLUMNS = 128
CHUNK = {torch.bfloat16: 32, torch.float32: 16}
MAX_CLUSTER = 8
BARRIER_BYTES = 256
TWIDDLE_TILE_BYTES = 16384
SMEM_MAX = 232448
STAGES = 4  # every ring's stages, fewer where they do not fit


class Plan(NamedTuple):
    """A launch of K17: ``frames`` a CTA (64 per consumer warpgroup), the
    ``cluster`` of CTAs (column tiles of one frame tile) that share the
    FIR, the ``stages`` of each ring (A, B and input rows), the dynamic
    shared memory ``smem`` in bytes, and the ``grid`` (column tiles,
    frame tiles)."""

    frames: int
    cluster: int
    stages: int
    smem: int
    grid: tuple


def cluster_size(m: int) -> int:
    """The largest divisor of the m / 128 column tiles up to 8."""
    tiles = m // COLUMNS
    return max(c for c in range(1, MAX_CLUSTER + 1) if tiles % c == 0)


def _round128(b: int) -> int:
    return -(-b // 128) * 128


def smem_bytes(frames: int, cluster: int, stages: int, taps: int,
               twiddle_dtype) -> int:
    """Dynamic shared memory of a plan (csrc/channelize.cu `smem_bytes`):
    the barriers, then a stage: the A tile (both planes of ``frames`` x a
    chunk, bf16 or f32: 128 bytes a frame either way), the twiddle tile,
    and the input rows (each plane's box of a CTA's largest FIR share and
    the taps-1 rows before it, the chunk's coefficients, each plane's
    taps-1 history rows; f32 rows of a chunk, each region 128-byte
    aligned)."""
    row = CHUNK[twiddle_dtype] * 4
    share = 8 * -(-(frames // 8) // cluster)
    in_stage = (2 * _round128((share + taps - 1) * row)
                + _round128(taps * row) + 2 * _round128((taps - 1) * row))
    return BARRIER_BYTES + stages * (128 * frames + TWIDDLE_TILE_BYTES
                                     + in_stage)


@lru_cache(maxsize=64)
def launch_plan(n: int, m: int, taps: int, twiddle_dtype, *,
                frames: int = 128, stages=None) -> Plan:
    """K17's plan for n frames of m branches: ``frames`` a CTA (128, two
    consumer warpgroups; 64, one, is forced only by the tests' second
    tiling), the cluster `cluster_size(m)`, and STAGES stages a ring, or
    the most below it that fit in SMEM_MAX.  ``stages`` forces a depth,
    even one the card refuses; the result does not depend on the plan."""
    _check(m, taps, twiddle_dtype)
    if frames not in (64, 128):
        raise ValueError(f"frames must be 64 or 128, got {frames}")
    cluster = cluster_size(m)
    if stages is None:
        stages = next((s for s in range(STAGES, 2, -1)
                       if smem_bytes(frames, cluster, s, taps, twiddle_dtype)
                       <= SMEM_MAX), 2)
    return Plan(frames, cluster, stages,
                smem_bytes(frames, cluster, stages, taps, twiddle_dtype),
                (m // COLUMNS, -(-n // frames)))


@lru_cache(maxsize=8)
def tiled_twiddles(m: int, twiddle_dtype, device: torch.device):
    """`twiddles` (wr, wi) in the kernel's tile order, one contiguous
    16 KB tile a (column tile ct, chunk kc), both planes: bf16 (chunk 32)
    as the unswizzled K-major core matrices of ``wgmma``'s B operand,
    ``[ct][kc][plane][j // 8][k // 8][j % 8][k % 8]``; f32 (chunk 16)
    ``[ct][kc][plane][k][j]`` rows of the 128 columns.  ``k`` the branch
    within the chunk, ``j`` the column within the tile.  Made once per
    (m, dtype, device); (m // 128, m // chunk, 8192 or 4096) flat."""
    ck = CHUNK[twiddle_dtype]
    planes = []
    for w in twiddles(m, twiddle_dtype, device):  # w[k, j]
        if twiddle_dtype == torch.bfloat16:
            t = w.reshape(m // ck, ck // 8, 8, m // COLUMNS, COLUMNS // 8, 8)
            t = t.permute(3, 0, 4, 1, 5, 2)  # ct, kc, jg, kg, jr, ke
        else:
            t = w.reshape(m // ck, ck, m // COLUMNS, COLUMNS)
            t = t.permute(2, 0, 1, 3)  # ct, kc, k, j
        planes.append(t.reshape(m // COLUMNS, m // ck, -1))
    return torch.stack(planes, dim=2).reshape(
        m // COLUMNS, m // ck, -1).contiguous()


@lru_cache(maxsize=8)
def default_coefficients(m: int, taps: int, device: torch.device):
    """``coefficients(None, m, taps)`` as a (taps, m) f32 tensor on
    ``device``, made once per (m, taps, device)."""
    return torch.from_numpy(coefficients(None, m, taps)).to(device)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data is not 16-byte aligned (the
    kernel's bulk copies read 16-byte aligned rows)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(m: int, taps: int, twiddle_dtype) -> None:
    if twiddle_dtype not in TWIDDLE_DTYPES:
        raise ValueError(f"twiddle_dtype must be one of {TWIDDLE_DTYPES}, "
                         f"got {twiddle_dtype}")
    if not 2 <= taps <= MAX_TAPS:
        raise ValueError(f"need 2 <= taps <= {MAX_TAPS}, got {taps}")
    if m < 128 or m % 128:
        raise ValueError(f"m must be a multiple of 128, got {m}")


def channelize_fused_plain(state: PlanesState, zr, zi, proto=None, *, m: int,
                           taps: int = 8, twiddle_dtype=torch.bfloat16):
    """Plain PyTorch version of `channelize_fused`."""
    _check(m, taps, twiddle_dtype)
    coeff = torch.from_numpy(coefficients(proto, m, taps)).to(zr.device)
    accr, hist_r = polyphase_fir(state.hist_r, zr, coeff)
    acci, hist_i = polyphase_fir(state.hist_i, zi, coeff)
    wr, wi = (w.float() for w in twiddles(m, twiddle_dtype, zr.device))
    # bf16 x bf16 products are exact in f32: the f32 products of the
    # rounded operands, summed in f32
    ar = accr.to(twiddle_dtype).float()
    ai = acci.to(twiddle_dtype).float()
    with full_f32_matmul():
        yr = ar @ wr - ai @ wi
        yi = ar @ wi + ai @ wr
    return PlanesState(hist_r=hist_r, hist_i=hist_i), yr, yi


def channelize_fused(state: PlanesState, zr, zi, proto=None, *, m: int,
                     taps: int = 8, twiddle_dtype=torch.bfloat16,
                     _plan: Plan | None = None):
    """Fused planes-layout analysis bank in one kernel.

    Args:
      state: `PlanesState` with hist planes (taps-1, m) f32.
      zr, zi: (n, m) f32 I/Q frame planes, n >= 1, m % 128 == 0.
      proto: (m*taps,) prototype (`channelizer.prototype` for None).
      taps: 2 <= taps <= 16.
      twiddle_dtype: torch.bfloat16 (tensor cores; the FIR output and the
        DFT matrix rounded to bf16) or torch.float32 (CUDA-core f32
        products).

    Returns (state, yr, yi) with yr, yi (n, m) f32.  ``_plan`` forces a
    `launch_plan` (tests); the result does not depend on it.
    """
    if zr.device.type == "cpu":
        return channelize_fused_plain(state, zr, zi, proto, m=m, taps=taps,
                                      twiddle_dtype=twiddle_dtype)
    _check(m, taps, twiddle_dtype)
    n = zr.shape[0]
    h = taps - 1
    dev = zr.device
    if n < 1:
        raise ValueError("need at least one frame")
    _ext.require("zr", zr, dev, torch.float32, (n, m))
    _ext.require("zi", zi, dev, torch.float32, (n, m))
    _ext.require("state.hist_r", state.hist_r, dev, torch.float32, (h, m))
    _ext.require("state.hist_i", state.hist_i, dev, torch.float32, (h, m))
    if proto is None:
        coeff = default_coefficients(m, taps, dev)
    else:
        coeff = torch.from_numpy(coefficients(proto, m, taps)).to(dev)
    tiles = tiled_twiddles(m, twiddle_dtype, dev)
    plan = _plan or launch_plan(n, m, taps, twiddle_dtype)
    zr, zi, hr, hi = (_aligned(t) for t in (zr, zi, state.hist_r,
                                            state.hist_i))
    yr = torch.empty((n, m), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    hist_r = torch.empty_like(state.hist_r)
    hist_i = torch.empty_like(state.hist_i)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.idsp_channelize(
            zr.data_ptr(), zi.data_ptr(), hr.data_ptr(), hi.data_ptr(),
            coeff.data_ptr(), tiles.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            hist_r.data_ptr(), hist_i.data_ptr(), n, m, taps,
            int(twiddle_dtype == torch.bfloat16), plan.frames, plan.cluster,
            plan.stages, plan.smem, _ext.stream_ptr(dev),
        )
    _ext.check(err, "channelize_fused")
    channelize_fused.launches += 1
    return PlanesState(hist_r=hist_r, hist_i=hist_i), yr, yi


channelize_fused.launches = 0  # kernel launches since the last reset

