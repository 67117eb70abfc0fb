"""K38-K40: the wave-digital allpass banks (port of
`idsp_tpu.filters.wdf_pallas`: `wdf_bank`, `wdf_chain_bank`,
`wdf_pair_bank`).

Each runs the CUDA kernel of ``csrc/wdf_bank.cu`` for a CUDA tensor and
its plain PyTorch version (``*_plain``) for a CPU tensor; any other
device raises.  K38 is bit-identical to `wdf.block`, K39 to
`wdf.chain_block`, K40 to `wdf.pair_block`.  One kernel serves all
three: a CUDA block is a tile of 32 lanes with one warp per serial
stage (both branches of a pair), a loader warp and a store warp, the
stages passing chunks of rows through rings in shared memory
(`launch_plan`); K40 runs both branches and the butterfly in one
launch.  A chain of more than
WDF_MAX adapters in all, or a stage with fewer coefficients than
adapters, is refused (ValueError) before any launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _ext
from .wdf import Tpa, WdfState, block, chain_block, pair_block

WDF_MAX = 24  # adapters of one launch, both branches (csrc/wdf_bank.cu)
LANES = 32  # lanes of a CUDA block's tile
# The stages (N adapters, type nibbles M: adapter j in nibble j, as
# `wdf.nibbles` decodes them) with a loop of their own in the kernel
# (kSpecs of csrc/wdf_bank.cu), kind i + 1 for entry i; kind 0 is the
# generic loop.  The suite's chains (benches/suite.py:442-500): wdf-ca-7's
# [D, A] and [A], wdf-ca-19's [X], [C, X] and [D, X].
SPECIALISED = ((1, 0x1), (1, 0xA), (2, 0xAD), (2, 0x1C), (2, 0x1D))
# rows a ring slot, slots a ring (the most): a chunk costs each warp a few
# hundred cycles of barrier work, so 64 rows beat 32 by 12-17 % at any
# depth from 2 to 4 (PERF.md, PR 15)
CHUNK, DEPTH = 64, 4
SMEM_BUDGET = 216 * 1024  # bytes of rings a plan takes at most
MAX_SMEM = 232448  # bytes of shared memory a block may have


def stage_key(tpas) -> tuple[int, int]:
    """(N, M) of a stage: its adapter count and its type nibbles, adapter
    j in nibble j (the reference's `Wdf<N, M>`)."""
    return len(tpas), sum(int(Tpa(t)) << (4 * j) for j, t in enumerate(tpas))


def stage_kind(tpas) -> int:
    """The kernel loop of a stage: 1 + its index in SPECIALISED, or 0 (the
    generic loop)."""
    key = stage_key(tpas)
    return SPECIALISED.index(key) + 1 if key in SPECIALISED else 0


def ring_bytes(stages: int, chunk: int, depth: int) -> int:
    """Shared memory of a launch of ``stages`` stages: stages + 1 rings
    (the input's, one before every stage but each branch's first, one
    after each branch's last), each of ``depth`` slots of ``chunk`` rows
    x LANES int32 words and two 8-byte mbarriers (csrc/wdf_bank.cu
    `ring_count`, `smem_bytes`)."""
    return (stages + 1) * depth * (16 + chunk * LANES * 4)


class WdfPlan(NamedTuple):
    """How the kernel runs a launch: a CUDA block of LANES lanes has one
    warp per stage, branch 0's then branch 1's, a loader warp and a store
    warp (``warps`` in all); stage s runs loop ``kinds[s]``
    (`stage_kind`) for its ``keys[s]`` (`stage_key`); chunks of ``chunk``
    rows pass between the warps through rings of ``depth`` slots,
    ``smem`` bytes in all."""

    stages: tuple[int, int]  # (branch 0's, branch 1's); (n, 0): one chain
    keys: tuple[tuple[int, int], ...]
    kinds: tuple[int, ...]
    chunk: int
    depth: int
    smem: int

    @property
    def warps(self) -> int:
        """Warps of a CUDA block: the stages', the loader and the store
        warp."""
        return sum(self.stages) + 2


def launch_plan(branches, *, chunk: int | None = None,
                depth: int | None = None, generic: bool = False) -> WdfPlan:
    """The plan of a launch over one branch (K38, K39) or two (K40), each
    a list of stages, each stage a list of adapter types (`Tpa`).

    The chunk is CHUNK rows and the depth the most of DEPTH .. 2 whose
    rings fit SMEM_BUDGET (wdf-ca-7: 4, wdf-ca-19: 2), unless given; a
    chunk too large for depth 2 is halved (24 stages: 32 rows, depth 2).  ``generic`` runs every stage on the
    generic loop (for the tests).  Raises ValueError for no stages, an
    empty stage, more than two branches or more than WDF_MAX adapters."""
    if not 1 <= len(branches) <= 2 or not branches[0] or (
            len(branches) == 2 and not branches[1]):
        raise ValueError("a WDF launch takes one or two branches of stages")
    flat = [list(tp) for br in branches for tp in br]
    if any(len(tp) < 1 for tp in flat):
        raise ValueError("a WDF stage needs at least one adapter")
    n = sum(len(tp) for tp in flat)
    if n > WDF_MAX:
        raise ValueError(f"{n} adapters, more than the kernel's {WDF_MAX}")
    stages = len(flat)
    ch = CHUNK if chunk is None else chunk
    if depth is None:
        fits = [d for d in range(DEPTH, 1, -1)
                if ring_bytes(stages, ch, d) <= SMEM_BUDGET]
        while not fits and chunk is None and ch > 1:
            ch //= 2
            fits = [d for d in range(DEPTH, 1, -1)
                    if ring_bytes(stages, ch, d) <= SMEM_BUDGET]
        dp = fits[0] if fits else 2
    else:
        dp = depth
    if ch < 1 or dp < 1:
        raise ValueError(f"chunk and depth must be >= 1, got {ch}, {dp}")
    return WdfPlan(
        stages=(len(branches[0]), len(branches[1]) if len(branches) > 1
                else 0),
        keys=tuple(stage_key(tp) for tp in flat),
        kinds=tuple(0 if generic else stage_kind(tp) for tp in flat),
        chunk=ch, depth=dp, smem=ring_bytes(stages, ch, dp))


def _coefs(tpas, a):
    """One stage's shared (N,) coefficients as Python ints: the first N of
    ``a``; fewer than N raise ValueError (the plain version and the JAX
    package raise for them too), before anything is launched."""
    arr = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    if arr.ndim > 1:
        raise ValueError("the kernels take one shared (N,) coefficient "
                         f"set per stage, got shape {arr.shape}")
    flat = arr.reshape(-1)
    if flat.size < len(tpas):
        raise ValueError(f"a stage of {len(tpas)} adapters needs "
                         f"{len(tpas)} coefficients, got {flat.size}")
    return [int(v) for v in flat[:len(tpas)]]


def _launch(name, branches, states, xs, plan: WdfPlan | None = None):
    """Validate and launch the kernel over one branch (K38, K39) or two
    (K40) of serial stages, each (tpas, a); ``states`` the matching lists
    of WdfState; ``plan`` `launch_plan`'s by default.  Returns (per-branch
    state lists, outputs).  A plan the kernel refuses raises
    RuntimeError, having launched nothing."""
    t, c = xs.shape
    dev = xs.device
    if plan is None:
        plan = launch_plan([[tp for tp, _ in br] for br in branches])
    types, coefs, lens = [], [], []
    for br, sts in zip(branches, states):
        if len(sts) != len(br):
            raise ValueError(f"{name}: {len(br)} stages, {len(sts)} states")
        for tpas, a in br:
            types += [int(Tpa(v)) for v in tpas]
            coefs += _coefs(tpas, a)
            lens.append(len(tpas))
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    zs = [st.z for sts in states for st in sts]
    for z, n in zip(zs, lens):
        _ext.require("state.z", z, dev, torch.int32, (c, n))
    z_in = torch.cat(zs, dim=1).t().contiguous()  # (n, c) planes
    z_out = torch.empty_like(z_in)
    ys = [torch.empty_like(xs) for _ in branches]

    def ints(v):
        return (ctypes.c_int * WDF_MAX)(*v)

    with torch.cuda.device(dev):
        err = _ext.library().idsp_wdf_bank(
            xs.data_ptr(), ys[0].data_ptr(),
            ys[1].data_ptr() if len(ys) > 1 else None, z_in.data_ptr(),
            z_out.data_ptr(), ints(types), ints(coefs), ints(lens),
            ints(plan.kinds), t, c, plan.stages[0], plan.stages[1],
            plan.chunk, plan.depth, plan.smem, _ext.stream_ptr(dev))
    _ext.check(err, name)
    cols = iter(torch.split(z_out.t(), lens, dim=1))
    new = [[WdfState(z=next(cols).contiguous()) for _ in br]
           for br in branches]
    return new, ys


def wdf_bank_plain(tpas, a, state: WdfState, xs):
    """Plain PyTorch version of `wdf_bank`: `wdf.block`."""
    return block(tpas, a, state, xs)


def wdf_bank(tpas, a, state: WdfState, xs):
    """One adapter chain over a bank of lanes.

    Args:
      tpas: list of Tpa.
      a: (N,) int32 Q32<32> coefficients (`wdf.quantize`), shared.
      state: WdfState with z of shape (c, N) int32.
      xs: (t, c) int32.

    Returns (state, ys (t, c) int32), bit-identical to `wdf.block`.
    """
    if xs.device.type == "cpu":
        return wdf_bank_plain(tpas, a, state, xs)
    (new,), (ys,) = _launch("wdf_bank", [[(tpas, a)]], [[state]], xs)
    wdf_bank.launches += 1
    return new[0], ys


wdf_bank.launches = 0  # kernel launches since the last reset


def wdf_chain_bank_plain(stages, states, xs):
    """Plain PyTorch version of `wdf_chain_bank`: `wdf.chain_block`."""
    return chain_block(stages, states, xs)


def wdf_chain_bank(stages, states, xs):
    """Serial adapter chains over a bank of lanes, in one launch.

    Args:
      stages: list of (tpas, a) with shared (N_i,) coefficients.
      states: list of WdfState, z of shape (c, N_i) int32.
      xs: (t, c) int32.

    Returns (new_states, ys (t, c) int32), bit-identical to
    `wdf.chain_block`.
    """
    if xs.device.type == "cpu":
        return wdf_chain_bank_plain(stages, states, xs)
    (new,), (ys,) = _launch("wdf_chain_bank", [stages], [states], xs)
    wdf_chain_bank.launches += 1
    return new, ys


wdf_chain_bank.launches = 0  # kernel launches since the last reset


def wdf_pair_bank_plain(branch0, branch1, states, xs):
    """Plain PyTorch version of `wdf_pair_bank`: `wdf.pair_block`."""
    return pair_block(branch0, branch1, states, xs)


def wdf_pair_bank(branch0, branch1, states, xs):
    """Complementary allpass pair over a bank of lanes: both branches and
    the butterfly ``(y0 + y1, y0 - y1)`` (wrapping int32) in one launch.

    Args:
      branch0, branch1: lists of (tpas, a) serial stages.
      states: (s0, s1), lists of WdfState of the two branches.
      xs: (t, c) int32.

    Returns ((s0, s1), (sum, diff)), bit-identical to `wdf.pair_block`.
    """
    if xs.device.type == "cpu":
        return wdf_pair_bank_plain(branch0, branch1, states, xs)
    (s0, s1), ys = _launch("wdf_pair_bank", [branch0, branch1],
                           list(states), xs)
    wdf_pair_bank.launches += 1
    return (s0, s1), tuple(ys)


wdf_pair_bank.launches = 0  # kernel launches since the last reset
