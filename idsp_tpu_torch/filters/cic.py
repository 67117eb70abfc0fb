"""Cascaded integrator-comb (CIC) interpolators and decimators (port of
`idsp_tpu.filters.cic`, reference src/cic.rs).

Order N, comb delay M, rate change R = rate + 1 fast samples per slow
sample.  The block path uses linearity: the integrators are N chained
wrapping cumulative sums, the combs shifted differences at the slow
rate, the rate change a strided slice (keep rows 0, R, 2R, ...) or a
repeat.  The step mirrors follow the per-sample reference and equal the
block paths bit for bit.

All arithmetic wraps in int32, as the JAX package's does: each sum is
formed in int64 and wrapped back (`fxp.wrap_i32`), so no int32 overflow
is left to the backend.  Block lengths must be multiples of R.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fxp import wrap_i32


class CicState(NamedTuple):
    """Combs (..., N, M) at the slow rate, integrators (..., N) at the
    fast rate, plus the ZOH (...,) (cic.rs:13-27)."""

    combs: torch.Tensor
    integrators: torch.Tensor
    zoh: torch.Tensor


def init(n: int, m: int = 1, shape=(), dtype=torch.int32, *,
         device) -> CicState:
    if m <= 0:
        raise ValueError("comb delay must be non-zero")
    shape = tuple(shape)
    return CicState(
        combs=torch.zeros(shape + (n, m), dtype=dtype, device=device),
        integrators=torch.zeros(shape + (n,), dtype=dtype, device=device),
        zoh=torch.zeros(shape, dtype=dtype, device=device),
    )


def gain(rate: int, n: int, m: int = 1) -> int:
    """(M*(rate+1))**N (cic.rs:104-106)."""
    return (m * (rate + 1)) ** n


def gain_log2(rate: int, n: int, m: int = 1) -> int:
    """Upper bound on log2(gain) (cic.rs:112-114)."""
    v = m * rate + (m - 1)
    return (32 - _clz32(v)) * n


def _clz32(v: int) -> int:
    return 32 - v.bit_length() if v > 0 else 32


def response_length(rate: int, n: int) -> int:
    """rate * N (cic.rs:117-119)."""
    return rate * n


def settle_interpolate(rate: int, n: int, m: int, x, shape=(),
                       dtype=torch.int32, *, device) -> CicState:
    """Settled interpolator state for constant input x (cic.rs:121-133)."""
    st = init(n, m, shape, dtype, device=device)
    x = torch.as_tensor(x, dtype=dtype, device=device)
    if n == 0:
        return st._replace(zoh=x)
    combs = st.combs.clone()
    combs[..., 0, :] = x[..., None]
    integ = st.integrators.clone()
    integ[..., -1] = wrap_i32(x.to(torch.int64) * gain(rate, n, m))
    return CicState(combs=combs, integrators=integ, zoh=st.zoh)


def settle_decimate(rate: int, n: int, m: int, x, shape=(),
                    dtype=torch.int32):
    """Settled decimator state (cic.rs:135-142): not implemented in the
    reference either (`unimplemented!()`); kept for API parity."""
    raise NotImplementedError(
        "settle_decimate is unimplemented (as in the reference)")


def _time_dim(x, axis: int) -> int:
    return 0 if axis == 0 else x.dim() - 1


def _comb_chain(combs, x, axis: int = -1):
    """The comb cascade on a slow-rate block.  combs: (..., N, M)
    carried delay lines, row[..., 0] oldest; x: (..., t) for axis=-1 or
    (t, ...) for axis=0.  Returns (new_combs, y)."""
    n = combs.shape[-2]
    dim = _time_dim(x, axis)
    cur = x
    new_rows = []
    for i in range(n):
        row = combs[..., i, :]
        if axis == 0:
            row = row.movedim(-1, 0)  # (M, ...)
        t = cur.shape[dim]
        ext = torch.cat([row, cur], dim=dim)
        delayed = ext.narrow(dim, 0, t)
        y = wrap_i32(cur.to(torch.int64) - delayed.to(torch.int64))
        tail = ext.narrow(dim, t, ext.shape[dim] - t)
        new_rows.append(tail.movedim(0, -1) if axis == 0 else tail)
        cur = y
    new_combs = torch.stack(new_rows, dim=-2) if new_rows else combs
    return new_combs, cur


def _integrator_chain(integrators, x, axis: int = -1):
    """N chained wrapping cumulative sums on a fast-rate block.
    integrators: (..., N) carried values; x: (..., t) or (t, ...) for
    axis=0.  Returns (new_integrators, y)."""
    n = integrators.shape[-1]
    dim = _time_dim(x, axis)
    cur = x
    finals = []
    for i in range(n):
        c0 = integrators[..., i].unsqueeze(dim).to(torch.int64)
        cur = wrap_i32(c0 + torch.cumsum(cur, dim=dim, dtype=torch.int64))
        finals.append(cur.select(dim, -1))
    new_int = torch.stack(finals, dim=-1) if finals else integrators
    return new_int, cur


def _check_block(t: int, r: int) -> None:
    if t % r:
        raise ValueError(f"block length {t} must be a multiple of "
                         f"rate+1 = {r}")


def decimate_block(state: CicState, x, rate: int, *, axis: int = -1):
    """Decimate a fast-rate block by R = rate+1 (cic.rs:175-199).

    x: (..., t) int32, or (t, ...) with ``axis=0``; t a multiple of R.
    Outputs are taken at fast positions 0, R, 2R, ... of the stream
    continuation (with a fresh state the reference emits on the first
    fast sample).  Returns (state, y) with t // R slow-rate samples.
    """
    if x.dtype != torch.int32:
        raise ValueError(f"x must be int32, got {x.dtype}")
    r = rate + 1
    _check_block(x.shape[axis], r)
    new_int, integ = _integrator_chain(state.integrators, x, axis)
    dim = _time_dim(x, axis)
    sampled = integ[::r] if axis == 0 else integ[..., ::r]
    new_combs, y = _comb_chain(state.combs, sampled, axis)
    return CicState(combs=new_combs, integrators=new_int,
                    zoh=y.select(dim, -1)), y


def interpolate_block(state: CicState, x, rate: int, *, axis: int = -1):
    """Interpolate a slow-rate block by R = rate+1 (cic.rs:149-172):
    combs at the slow rate, ZOH upsampling, then N integrators at the
    fast rate.  Output has t*R samples on the time axis."""
    if x.dtype != torch.int32:
        raise ValueError(f"x must be int32, got {x.dtype}")
    r = rate + 1
    dim = _time_dim(x, axis)
    new_combs, c = _comb_chain(state.combs, x, axis)
    zoh = torch.repeat_interleave(c, r, dim=dim)
    new_int, y = _integrator_chain(state.integrators, zoh, axis)
    return CicState(combs=new_combs, integrators=new_int,
                    zoh=c.select(dim, -1)), y


# --- per-sample mirrors of the reference (cic.rs:149-199), used to hold
# the block paths equal to it --------------------------------------------


def decimate_step(state: CicState, x, index, rate: int):
    """One fast-rate sample (cic.rs:175-199).  Returns
    (state, index, (emitted, y))."""
    index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
    new_int, y = _integrator_chain(state.integrators, x[..., None])
    emit = index == 0
    new_combs, yc = _comb_chain(state.combs, y)
    yc = yc[..., 0]
    combs = torch.where(emit, new_combs, state.combs)
    zoh = torch.where(emit, yc, state.zoh)
    index2 = torch.where(emit, rate, index - 1).to(torch.int32)
    return (CicState(combs=combs, integrators=new_int, zoh=zoh), index2,
            (emit, yc))


def interpolate_step(state: CicState, x_opt, index, rate: int):
    """One fast-rate tick with an optional slow-rate input
    ``x_opt = (x, valid)`` (cic.rs:149-172).  Returns (state, index, y)."""
    x, valid = x_opt
    index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
    valid = torch.as_tensor(valid, device=x.device)
    new_combs, yc = _comb_chain(state.combs, x[..., None])
    yc = yc[..., 0]
    zoh = torch.where(valid, yc, state.zoh)
    index2 = torch.where(valid, rate, index - 1).to(torch.int32)
    new_int, y = _integrator_chain(state.integrators, zoh[..., None])
    combs = torch.where(valid, new_combs, state.combs)
    return (CicState(combs=combs, integrators=new_int, zoh=zoh), index2,
            y[..., 0])
