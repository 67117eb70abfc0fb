"""Masked event-stream adapters: the (valid, value) Option calculus (port
of `idsp_tpu.masked`).

The reference lifts processors over `Option<X>` streams and enforces an
exactly-one-tick contract on chunked decimation
(dsp-process/src/adapters.rs:26-35 `Interpolator`, :70-83 `Downsample`,
:107-118 `Hold`, :157-222 `Decimator`/`TryDecimator` with
`DecimatorError::{NoTick, ExtraTick}`, :240-257 `Map`).  An `Option<X>`
stream is a pair of dense tensors ``(valid: bool, value)`` (`Masked`);
contract violations are per-frame error codes the caller checks, and
`decimate` sums them into counters for streaming loops.

`mask_lift` turns any step function into a masked step (the state
advances only on valid samples), the structure of the RPLL's timestamp
input (`filters/rpll.py`).  `hold` takes the index of the last valid
slot (`torch.cummax`) and gathers; `try_decimate` the first valid slot
of each frame (`argmax`) and gathers: both only select values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: tick-contract codes (adapters.rs:171-178)
OK = 0
NO_TICK = 1
EXTRA_TICK = 2


class Masked(NamedTuple):
    """An Option stream: ``value[i]`` is meaningful iff ``valid[i]``."""

    valid: torch.Tensor  # bool
    value: torch.Tensor


def _tree_map(fn, a, b):
    """``fn`` over the leaves of two trees of the same structure (tuples,
    NamedTuples, lists, dicts), as ``jax.tree.map`` does for two trees."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_tree_map(fn, u, v) for u, v in zip(a, b, strict=True)))
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_map(fn, u, v) for u, v in zip(a, b, strict=True))
    if isinstance(a, dict):
        return {k: _tree_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def masked_update(valid, new_tree, old_tree):
    """Keep ``new`` where valid else ``old``: the masked state-advance
    primitive shared by `mask_lift` and the RPLL timestamp branch."""
    return _tree_map(lambda n, o: torch.where(valid, n, o), new_tree,
                     old_tree)


def mask_lift(step):
    """Lift ``step(config, state, x) -> (state, y)`` over Option input
    (adapters.rs `Map`/`Interpolator` inner contract): the state advances
    only on valid samples; the output is a `Masked` whose value is
    undefined where invalid (mirroring `None`)."""

    def lifted(config, state, mx: Masked):
        new_state, y = step(config, state, mx.value)
        return (
            masked_update(mx.valid, new_state, state),
            Masked(valid=mx.valid, value=y),
        )

    return lifted


def hold(carry, m: Masked, *, axis: int = -1):
    """Zero-order hold over an Option stream (adapters.rs:107-118): each
    output is the most recent valid value, starting from ``carry``.

    The index of the last valid slot up to each position is the running
    maximum of ``where(valid, index, -1)``; the output gathers it (or
    takes ``carry`` before the first valid slot).  Returns (new_carry, y)
    with y dense, the shape of ``m.value``.
    """
    valid, value = torch.broadcast_tensors(m.valid, m.value)
    valid = valid.movedim(axis, -1)
    x = value.movedim(axis, -1)
    t = x.shape[-1]
    idx = torch.arange(t, device=x.device).expand(x.shape)
    last, _ = torch.cummax(torch.where(valid, idx, -1), dim=-1)
    h = torch.gather(x, -1, last.clamp(min=0))
    carry = torch.as_tensor(carry, dtype=x.dtype, device=x.device)
    y = torch.where(last >= 0, h, carry.unsqueeze(-1))
    return y[..., -1], y.movedim(-1, axis)


def downsample(x, r: int, phase: int = 0, *, axis: int = -1) -> Masked:
    """Dense -> Option at rate 1/r (adapters.rs:70-83 `Downsample`): valid
    on the ``phase``-th slot of every r-frame."""
    t = x.shape[axis]
    valid = (torch.arange(t, device=x.device) % r) == phase
    shape = [1] * x.dim()
    shape[axis] = t
    return Masked(valid=valid.reshape(shape).expand(x.shape), value=x)


def interpolate(x, r: int, phase: int = 0, *, fill=0,
                axis: int = -1) -> Masked:
    """Low-rate dense -> high-rate Option (adapters.rs:26-35
    `Interpolator` input contract): each input appears at ``phase``
    within its r-slot output frame, the other slots are invalid."""
    x = x.movedim(axis, -1)
    t = x.shape[-1]
    vals = torch.full(x.shape + (r,), fill, dtype=x.dtype, device=x.device)
    vals[..., phase] = x
    vals = vals.reshape(*x.shape[:-1], t * r)
    valid = torch.zeros((t, r), dtype=torch.bool, device=x.device)
    valid[:, phase] = True
    valid = valid.reshape(t * r).expand(vals.shape)
    return Masked(valid=valid.movedim(-1, axis), value=vals.movedim(-1, axis))


def try_decimate(m: Masked, r: int, *, axis: int = -1):
    """Chunk an Option stream into r-frames and enforce the
    exactly-one-tick contract (adapters.rs:157-222 `TryDecimator`).

    Returns ``(y, err)``: per frame, ``y`` is the first valid value (the
    reference's `y.replace(..)` keeps the first and then errors), or the
    frame's last value where no slot is valid, and ``err`` is OK /
    NO_TICK / EXTRA_TICK (int32).  The caller checks the codes:
    `Decimator`'s panic is ``(err == OK).all()`` asserted by the caller.
    """
    valid = m.valid.movedim(axis, -1)
    value = m.value.movedim(axis, -1)
    t = valid.shape[-1]
    assert t % r == 0 and r > 0
    vf = valid.reshape(*valid.shape[:-1], t // r, r)
    xf = value.reshape(*value.shape[:-1], t // r, r)
    n = vf.sum(dim=-1)
    # argmax gives the first of equal maxima: the first valid slot
    first = torch.where(n > 0, vf.to(torch.int8).argmax(dim=-1), r - 1)
    y = torch.gather(xf, -1, first.unsqueeze(-1)).squeeze(-1)
    err = torch.where(n == 0, NO_TICK,
                      torch.where(n > 1, EXTRA_TICK, OK)).to(torch.int32)
    return y.movedim(-1, axis), err.movedim(-1, axis)


def decimate(m: Masked, r: int, *, counters=None, axis: int = -1):
    """`Decimator` with streaming error counters instead of a panic:
    returns (y, counters') where counters is an int64 [no_tick,
    extra_tick] running total (zeros if None), the long-running-loop form
    of the tick contract."""
    y, err = try_decimate(m, r, axis=axis)
    if counters is None:
        counters = torch.zeros((2,), dtype=torch.int64, device=err.device)
    counters = counters + torch.stack(
        [(err == NO_TICK).sum(), (err == EXTRA_TICK).sum()]).to(torch.int64)
    return y, counters


def map_masked(fn, m: Masked) -> Masked:
    """Lift a pure elementwise fn over the Option stream (adapters.rs:
    240-257 `Map`): runs on every slot, the validity framing kept."""
    return Masked(valid=m.valid, value=fn(m.value))
