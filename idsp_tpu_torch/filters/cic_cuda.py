"""K9 and K10: the CIC integrator cascade as one kernel each (port of
`idsp_tpu.filters.cic_pallas.cic_dec_bank` and `cic_int_bank`).

Both run ``csrc/cic_bank.cu`` for CUDA tensors and their plain PyTorch
versions (``*_plain``, the `cic` block paths at ``axis=0``) for CPU
tensors; any other device raises.  The N integrators are the kernel;
the combs run in plain PyTorch at the slow rate, as in the JAX package
(cic_pallas.py:72, :113).  Pure wrapping int32 arithmetic: outputs and
state equal the plain versions bit for bit, for any plan.

The kernel splits time into ranges that run at once (lane tiles x time
ranges, `cic_plan`): each range runs from zero, the carries are folded
across ranges by the cascade's linear map mod 2^32 (`carry_map`), and a
second pass adds each range's carry (K9) or runs the range again from it
(K10).  `cic_ranges_plain` is that algorithm in plain PyTorch.

State is `cic.CicState` with channel-shaped leaves (`cic.init(n, m,
(c,))`): combs (c, N, M), integrators (c, N), zoh (c,), all int32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import _ext
from .cic import (
    CicState,
    _check_block,
    _comb_chain,
    _integrator_chain,
    decimate_block,
    interpolate_block,
)
from ..fxp import wrap_i32

MAX_ORDER = 8  # integrator stages the kernels are built for (kMaxOrder)
LANES = 32  # lanes of a tile (cic_bank.cu kLanes)
MAX_WARPS = 32  # warps of a CTA, one range each (kMaxWarps)
MAX_CLUSTER = 8  # CTAs of a tile, a portable cluster (kMaxCluster)
CIC_WARPS = 16  # warps of a CTA at most by default
# the warps an SM is given by default: at 16 the local pass's loads keep
# the card's memory busy, and more (or fewer CTAs a tile for as many)
# measured slower (PERF.md §6, K9/K10)
WARPS_PER_SM = 16
MAX_SMEM = 232448  # the shared memory a CTA may have, 227 KB
MAP_WORDS = MAX_ORDER * (MAX_ORDER + 1) // 2  # kMapWords
_MASK = (1 << 32) - 1


class CicPlan(NamedTuple):
    """How K9 / K10 run a launch: ``tiles`` lane tiles of LANES lanes, each
    a cluster of ``cluster`` CTAs of ``warps`` warps; warp w of rank q
    takes range q * warps + w of ``length`` input rows (K9: fast rows, a
    multiple of R; K10: slow rows); ``ranges`` of them hold rows; ``smem``
    bytes a CTA (each warp's aggregate and the CTA's)."""

    tiles: int
    cluster: int
    warps: int
    length: int
    ranges: int
    smem: int


def cic_smem(n: int, warps: int) -> int:
    """Shared memory of a CTA (cic_bank.cu `plan_ok`): N words a lane of
    each warp's aggregate and of the CTA's."""
    return 4 * LANES * n * (warps + 1)


def cic_plan(t: int, c: int, n: int, r: int, *, dec: bool = True,
             sms: int | None = None, warps: int | None = None,
             cluster: int | None = None, length: int | None = None
             ) -> CicPlan:
    """K9's (``dec``) or K10's plan over ``t`` input rows (K9: fast rows,
    t % r == 0; K10: slow rows) of ``c`` lanes, ``n`` integrators and
    rate change ``r``.  Unless given: warps a CTA the largest power of two
    up to CIC_WARPS that gives ``sms`` SMs at most WARPS_PER_SM warps each
    with MAX_CLUSTER CTAs a tile (or the given ``cluster``), at least one;
    the most CTAs a tile, up to MAX_CLUSTER, that have rows to take; ranges
    as even as whole kept rows (K9) or slow rows (K10) allow, the last the
    shortest.  A given ``length`` (K9: a multiple of r) is the ranges'
    length.  Raises ValueError for a plan the kernel cannot run."""
    if t < 1 or c < 1:
        raise ValueError(f"need rows and lanes >= 1, got t={t}, c={c}")
    if not 1 <= n <= MAX_ORDER:
        raise ValueError(f"need 1..{MAX_ORDER} integrator stages, got {n}")
    if r < 1:
        raise ValueError(f"need a rate change r >= 1, got {r}")
    if dec and t % r:
        raise ValueError(f"block length {t} must be a multiple of r = {r}")
    if not dec and t * r > 0x7FFFFFFF:
        raise ValueError(f"{t} x {r} fast rows exceed int32")
    tiles = -(-c // LANES)
    if (warps is None or cluster is None) and (sms is None or sms < 1):
        raise ValueError(f"need the card's SMs (sms >= 1), got {sms}")
    if warps is None:
        room = WARPS_PER_SM * sms // (tiles * (cluster or MAX_CLUSTER))
        warps = min(CIC_WARPS, 1 << max(room, 1).bit_length() - 1)
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"warps must be 1 to {MAX_WARPS}, got {warps}")
    unit = r if dec else 1  # input rows of a kept or slow row
    units = t // unit
    if length is not None and (length < 1 or length % unit):
        raise ValueError(f"a range's length must be a positive multiple of "
                         f"{unit} rows, got {length}")
    if cluster is None:
        ranges = units if length is None else -(-t // length)
        cluster = max(1, min(MAX_CLUSTER, -(-ranges // warps)))
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster must be 1 to {MAX_CLUSTER} CTAs, "
                         f"got {cluster}")
    if length is None:
        length = -(-units // (cluster * warps)) * unit
    ranges = -(-t // length)
    if ranges > cluster * warps:
        raise ValueError(f"{ranges} ranges of {length} rows exceed "
                         f"{cluster} CTAs x {warps} warps")
    smem = cic_smem(n, warps)
    if smem > MAX_SMEM:
        raise ValueError(f"{smem} bytes of shared memory exceed {MAX_SMEM}")
    return CicPlan(tiles=tiles, cluster=cluster, warps=warps, length=length,
                   ranges=ranges, smem=smem)


@functools.lru_cache(maxsize=256)
def carry_map(n: int, steps: int) -> tuple[int, ...]:
    """T^steps of the N-integrator cascade mod 2^32, lower triangular, rows
    packed (entry (i, j), j <= i, at i (i + 1) / 2 + j): T^L[i][j] =
    C(L-1+i-j, i-j) mod 2^32, exact in Python ints; T^0 = I.  A range of L
    rows started from integrators s ends with T^L s + (its end from 0)."""
    if steps == 0:
        return tuple(int(i == j) for i in range(n) for j in range(i + 1))
    return tuple(math.comb(steps - 1 + i - j, i - j) & _MASK
                 for i in range(n) for j in range(i + 1))


def plan_maps(plan: CicPlan, n: int, r: int, dec: bool) -> tuple[int, ...]:
    """The kernel's 2 x MAP_WORDS map words: T^L, then T^(L warps), L the
    plan's range length in fast rows, each zero-padded to MAP_WORDS."""
    fast = plan.length * (1 if dec else r)
    pad = (0,) * (MAP_WORDS - n * (n + 1) // 2)
    return (carry_map(n, fast) + pad
            + carry_map(n, fast * plan.warps) + pad)


@functools.lru_cache(maxsize=64)
def _map_array(plan: CicPlan, n: int, r: int, dec: bool):
    """`plan_maps` as the host array the C entry reads (never written)."""
    return (ctypes.c_uint32 * (2 * MAP_WORDS))(*plan_maps(plan, n, r, dec))


@functools.lru_cache(maxsize=64)
def _launch_plan(t: int, c: int, n: int, r: int, dec: bool,
                 index: int) -> CicPlan:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return cic_plan(t, c, n, r, dec=dec, sms=sms)


def cic_launch_plan(t: int, c: int, n: int, r: int, dec: bool,
                    device: torch.device) -> CicPlan:
    """K9's / K10's default plan on ``device`` (`cic_plan` at its SMs)."""
    return _launch_plan(t, c, n, r, dec, device.index or 0)


def _launch(name, state: CicState, xs, r: int, y_rows: int, dec: bool,
            plan: CicPlan | None):
    """Validate and launch ``idsp_cic_{dec,int}_bank`` on xs (t, c) at
    ``plan`` (default: `cic_launch_plan`); returns (new integrators, y)."""
    t, c = xs.shape
    n = state.integrators.shape[-1]
    if not 1 <= n <= MAX_ORDER:
        raise ValueError(f"need 1..{MAX_ORDER} integrator stages, got {n}")
    dev = xs.device
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    _ext.require("state.integrators", state.integrators, dev, torch.int32,
                 (c, n))
    y = torch.empty((y_rows, c), dtype=torch.int32, device=dev)
    if plan is None:
        plan = cic_launch_plan(t, c, n, r, dec, dev)
    elif plan.tiles != -(-c // LANES):
        raise ValueError(f"the plan's {plan.tiles} tiles are not c = {c}'s")
    maps = _map_array(plan, n, r, dec)
    new_int = torch.empty_like(state.integrators)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = getattr(lib, f"idsp_{name}")(
            xs.data_ptr(), y.data_ptr(), state.integrators.data_ptr(),
            new_int.data_ptr(), ctypes.addressof(maps), t, c, n, r,
            plan.cluster, plan.warps, plan.length, plan.smem,
            _ext.stream_ptr(dev))
    _ext.check(err, name)
    return new_int, y


def cic_dec_bank_plain(state: CicState, xs, rate: int):
    """Plain PyTorch version of `cic_dec_bank`:
    `cic.decimate_block(state, xs, rate, axis=0)`."""
    return decimate_block(state, xs, rate, axis=0)


def cic_dec_bank(state: CicState, xs, rate: int, *,
                 _plan: CicPlan | None = None):
    """Decimate a time-major (t, c) int32 block by R = rate+1.

    The integrator cascade and the keep-1-in-R (rows 0, R, 2R, ...) run
    as one kernel; the combs follow at the slow rate.  t % R == 0.
    Returns (new_state, y) with y (t // R, c) int32; t = 0 returns the
    state unchanged.
    """
    if xs.shape[0] == 0:
        return state, xs[:0]
    if xs.device.type == "cpu":
        return cic_dec_bank_plain(state, xs, rate)
    t = xs.shape[0]
    _check_block(t, rate + 1)
    new_int, sampled = _launch("cic_dec_bank", state, xs, rate + 1,
                               t // (rate + 1), True, _plan)
    cic_dec_bank.launches += 1
    new_combs, y = _comb_chain(state.combs, sampled, axis=0)
    return CicState(combs=new_combs, integrators=new_int, zoh=y[-1]), y


cic_dec_bank.launches = 0  # kernel launches since the last reset


def cic_int_bank_plain(state: CicState, xs, rate: int):
    """Plain PyTorch version of `cic_int_bank`:
    `cic.interpolate_block(state, xs, rate, axis=0)`."""
    return interpolate_block(state, xs, rate, axis=0)


def cic_int_bank(state: CicState, xs, rate: int, *,
                 _plan: CicPlan | None = None):
    """Interpolate a time-major (t, c) int32 block by R = rate+1.

    The combs run at the slow rate; the kernel holds each comb output
    row R times and runs the integrator cascade over the t*R fast rows.
    Returns (new_state, y) with y (t * R, c) int32; t = 0 returns the
    state unchanged.
    """
    if xs.shape[0] == 0:
        return state, xs[:0]
    if xs.device.type == "cpu":
        return cic_int_bank_plain(state, xs, rate)
    if xs.dtype != torch.int32:
        raise ValueError(f"xs must be int32, got {xs.dtype}")
    new_combs, cmb = _comb_chain(state.combs, xs, axis=0)
    new_int, y = _launch("cic_int_bank", state, cmb, rate + 1,
                         xs.shape[0] * (rate + 1), False, _plan)
    cic_int_bank.launches += 1
    return CicState(combs=new_combs, integrators=new_int, zoh=cmb[-1]), y


cic_int_bank.launches = 0  # kernel launches since the last reset


# --- the kernels' algorithm in plain PyTorch ---------------------------------


def _mulmod(a, b):
    """a * b mod 2^32 of int64 tensors (or ints) in [0, 2^32), with every
    product under 2^49."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _MASK


def _fold(words, v, a):
    """M v + a mod 2^32: M the packed words of `carry_map`, v and a (c, N)
    int64 in [0, 2^32)."""
    n = v.shape[-1]
    m = torch.zeros((n, n), dtype=torch.int64, device=v.device)
    rows, cols = torch.tril_indices(n, n)
    m[rows, cols] = torch.tensor(words, dtype=torch.int64, device=v.device)
    return (_mulmod(m, v[:, None, :]).sum(-1) + a) & _MASK


def _u32(x):
    return x.to(torch.int64) & _MASK


def _integ_ranges(integrators, xs, r: int, plan: CicPlan, dec: bool):
    """The kernel's integrator pass in plain PyTorch: ``xs`` (t, c) int32
    (K10: the comb output), split into the plan's ranges; each range's
    local pass from zero (K9 keeps its rows 0, r, ...); the carries folded
    as `cic_bank.cu` folds them -- a CTA's warps' ends with T^L into its
    aggregate, the earlier CTAs' aggregates with T^(L warps) onto the
    carried state, the CTA's earlier warps' ends with T^L --; then the
    second pass (K9: the carry's zero-input response added to the kept
    rows; K10: the range again from its carry).  Returns (new
    integrators, y)."""
    t, c = xs.shape
    n = integrators.shape[-1]
    fast = plan.length * (1 if dec else r)
    m_range, m_cta = carry_map(n, fast), carry_map(n, fast * plan.warps)
    slots = plan.cluster * plan.warps
    zero = torch.zeros((c, n), dtype=torch.int32, device=xs.device)
    spans, ends, locals_ = [], [], []
    for g in range(slots):
        lo, hi = min(g * plan.length, t), min((g + 1) * plan.length, t)
        x = xs[lo:hi]
        if not dec:
            x = torch.repeat_interleave(x, r, dim=0)
        end, y = _integrator_chain(zero, x, axis=0) if hi > lo else (zero, x)
        spans.append((lo, hi, x))
        ends.append(_u32(end))
        locals_.append(y[::r] if dec else None)
    # the kernel's warps each fold from their CTA's carry-in: in order, so
    # one running fold gives every warp's
    starts, cta_in = [], _u32(integrators)
    for q in range(plan.cluster):
        agg = torch.zeros_like(cta_in)
        s = cta_in
        for w in range(plan.warps):
            starts.append(s)
            agg = _fold(m_range, agg, ends[q * plan.warps + w])
            s = _fold(m_range, s, ends[q * plan.warps + w])
        cta_in = _fold(m_cta, cta_in, agg)
    outs, new_int = [], integrators
    for g, (lo, hi, x) in enumerate(spans):
        s = starts[g]
        if hi == lo:
            continue
        s32 = wrap_i32(s)
        if dec:
            zend, zy = _integrator_chain(s32, torch.zeros_like(x), axis=0)
            outs.append(wrap_i32(locals_[g].to(torch.int64)
                                 + zy[::r].to(torch.int64)))
            end = wrap_i32(zend.to(torch.int64) + ends[g])
        else:
            end, y = _integrator_chain(s32, x, axis=0)
            outs.append(y)
        if hi == t:
            new_int = end
    return new_int, torch.cat(outs) if outs else xs[:0]


def cic_ranges_plain(state: CicState, xs, rate: int, plan: CicPlan, *,
                     dec: bool = True):
    """`cic_dec_bank` (``dec``) or `cic_int_bank` with the kernel's
    algorithm at ``plan`` in plain PyTorch in the kernel's place
    (`_integ_ranges`), the combs as the wrappers run them; equal to the
    plain versions bit for bit."""
    r = rate + 1
    if xs.shape[0] == 0:
        return state, xs[:0]
    if dec:
        _check_block(xs.shape[0], r)
        new_int, sampled = _integ_ranges(state.integrators, xs, r, plan, True)
        new_combs, y = _comb_chain(state.combs, sampled, axis=0)
        return CicState(combs=new_combs, integrators=new_int, zoh=y[-1]), y
    new_combs, cmb = _comb_chain(state.combs, xs, axis=0)
    new_int, y = _integ_ranges(state.integrators, cmb, r, plan, False)
    return CicState(combs=new_combs, integrators=new_int, zoh=cmb[-1]), y
