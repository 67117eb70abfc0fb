"""K38-K40: the wave-digital allpass banks (port of
`idsp_tpu.filters.wdf_pallas`: `wdf_bank`, `wdf_chain_bank`,
`wdf_pair_bank`).

Each runs the CUDA kernel of ``csrc/wdf_bank.cu`` for a CUDA tensor and
its plain PyTorch version (``*_plain``) for a CPU tensor; any other
device raises.  K38 is bit-identical to `wdf.block`, K39 to
`wdf.chain_block`, K40 to `wdf.pair_block`.  One kernel serves all
three: the adapter types, Q32<32> coefficients and stage boundaries of
up to WDF_MAX adapters in all (both branches of a pair together) go to
it by value; K40 runs both branches and the butterfly in one launch.  A
longer chain is refused (ValueError) before any launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _ext
from .wdf import Tpa, WdfState, block, chain_block, pair_block

WDF_MAX = 24  # adapters of one launch, both branches (csrc/wdf_bank.cu)
_FIRST, _LAST = 1, 2  # flags of an adapter that opens / closes its stage


def _flatten(stages):
    """(types, coefficients, flags, stage lengths) of serial stages of
    (tpas, a), each a list of Python ints."""
    types, coefs, flags, lens = [], [], [], []
    for tpas, a in stages:
        n = len(tpas)
        if n < 1:
            raise ValueError("a WDF stage needs at least one adapter")
        arr = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        if arr.ndim > 1:
            raise ValueError("the kernels take one shared (N,) coefficient "
                             f"set per stage, got shape {arr.shape}")
        types += [int(Tpa(t)) for t in tpas]
        coefs += [int(v) for v in arr.reshape(-1)[:n]]
        flags += [(_FIRST if j == 0 else 0) | (_LAST if j == n - 1 else 0)
                  for j in range(n)]
        lens.append(n)
    return types, coefs, flags, lens


def _launch(name, branches, states, xs):
    """Validate and launch the kernel over one branch (K38, K39) or two
    (K40) of serial stages; ``states`` the matching lists of WdfState.
    Returns (per-branch state lists, outputs)."""
    t, c = xs.shape
    dev = xs.device
    flat = [_flatten(b) for b in branches]
    n_br = [sum(f[3]) for f in flat]
    if sum(n_br) > WDF_MAX:
        raise ValueError(f"{name}: {sum(n_br)} adapters, more than the "
                         f"kernel's {WDF_MAX}")
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    zs = []
    for (_, _, _, lens), sts in zip(flat, states):
        if len(sts) != len(lens):
            raise ValueError(f"{name}: {len(lens)} stages, {len(sts)} states")
        for n, st in zip(lens, sts):
            _ext.require("state.z", st.z, dev, torch.int32, (c, n))
            zs.append(st.z)
    z_in = torch.cat(zs, dim=1).t().contiguous()  # (n, c) planes
    z_out = torch.empty_like(z_in)
    ys = [torch.empty_like(xs) for _ in branches]
    arrays = [(ctypes.c_int * WDF_MAX)(*sum((f[k] for f in flat), []))
              for k in range(3)]
    with torch.cuda.device(dev):
        err = _ext.library().idsp_wdf_bank(
            xs.data_ptr(), ys[0].data_ptr(),
            ys[1].data_ptr() if len(ys) > 1 else None, z_in.data_ptr(),
            z_out.data_ptr(), *arrays, t, c, n_br[0],
            n_br[1] if len(n_br) > 1 else 0, _ext.stream_ptr(dev))
    _ext.check(err, name)
    cols = iter(torch.split(z_out.t(), [n for f in flat for n in f[3]], dim=1))
    new = [[WdfState(z=next(cols).contiguous()) for _ in f[3]] for f in flat]
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
