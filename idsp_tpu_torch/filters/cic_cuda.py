"""K9 and K10: the CIC integrator cascade as one kernel each (port of
`idsp_tpu.filters.cic_pallas.cic_dec_bank` and `cic_int_bank`).

Both run ``csrc/cic_bank.cu`` for CUDA tensors and their plain PyTorch
versions (``*_plain``, the `cic` block paths at ``axis=0``) for CPU
tensors; any other device raises.  The N integrators are the kernel;
the combs run in plain PyTorch at the slow rate, as in the JAX package
(cic_pallas.py:72, :113).  Pure wrapping int32 arithmetic: outputs and
state equal the plain versions bit for bit.

State is `cic.CicState` with channel-shaped leaves (`cic.init(n, m,
(c,))`): combs (c, N, M), integrators (c, N), zoh (c,), all int32.
"""

from __future__ import annotations

import torch

from .. import _ext
from .cic import (
    CicState,
    _check_block,
    _comb_chain,
    decimate_block,
    interpolate_block,
)

MAX_ORDER = 8  # integrator stages the kernels are built for


def _launch(name, state: CicState, xs, rate: int, y_rows: int):
    """Validate and launch ``idsp_cic_{dec,int}_bank`` on xs (t, c);
    returns (new integrators, y)."""
    t, c = xs.shape
    n = state.integrators.shape[-1]
    if not 1 <= n <= MAX_ORDER:
        raise ValueError(f"need 1..{MAX_ORDER} integrator stages, got {n}")
    dev = xs.device
    _ext.require("xs", xs, dev, torch.int32, (t, c))
    _ext.require("state.integrators", state.integrators, dev, torch.int32,
                 (c, n))
    new_int = torch.empty_like(state.integrators)
    y = torch.empty((y_rows, c), dtype=torch.int32, device=dev)
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = getattr(lib, f"idsp_{name}")(
            xs.data_ptr(), y.data_ptr(), state.integrators.data_ptr(),
            new_int.data_ptr(), t, c, n, rate + 1, _ext.stream_ptr(dev))
    _ext.check(err, name)
    return new_int, y


def cic_dec_bank_plain(state: CicState, xs, rate: int):
    """Plain PyTorch version of `cic_dec_bank`:
    `cic.decimate_block(state, xs, rate, axis=0)`."""
    return decimate_block(state, xs, rate, axis=0)


def cic_dec_bank(state: CicState, xs, rate: int):
    """Decimate a time-major (t, c) int32 block by R = rate+1.

    The integrator cascade and the keep-1-in-R (rows 0, R, 2R, ...) run
    as one kernel; the combs follow at the slow rate.  t % R == 0.
    Returns (new_state, y) with y (t // R, c) int32.
    """
    if xs.device.type == "cpu":
        return cic_dec_bank_plain(state, xs, rate)
    t = xs.shape[0]
    _check_block(t, rate + 1)
    new_int, sampled = _launch("cic_dec_bank", state, xs, rate,
                               t // (rate + 1))
    cic_dec_bank.launches += 1
    new_combs, y = _comb_chain(state.combs, sampled, axis=0)
    return CicState(combs=new_combs, integrators=new_int, zoh=y[-1]), y


cic_dec_bank.launches = 0  # kernel launches since the last reset


def cic_int_bank_plain(state: CicState, xs, rate: int):
    """Plain PyTorch version of `cic_int_bank`:
    `cic.interpolate_block(state, xs, rate, axis=0)`."""
    return interpolate_block(state, xs, rate, axis=0)


def cic_int_bank(state: CicState, xs, rate: int):
    """Interpolate a time-major (t, c) int32 block by R = rate+1.

    The combs run at the slow rate; the kernel holds each comb output
    row R times and runs the integrator cascade over the t*R fast rows.
    Returns (new_state, y) with y (t * R, c) int32.
    """
    if xs.device.type == "cpu":
        return cic_int_bank_plain(state, xs, rate)
    if xs.dtype != torch.int32:
        raise ValueError(f"xs must be int32, got {xs.dtype}")
    new_combs, cmb = _comb_chain(state.combs, xs, axis=0)
    new_int, y = _launch("cic_int_bank", state, cmb, rate,
                         xs.shape[0] * (rate + 1))
    cic_int_bank.launches += 1
    return CicState(combs=new_combs, integrators=new_int, zoh=cmb[-1]), y


cic_int_bank.launches = 0  # kernel launches since the last reset
