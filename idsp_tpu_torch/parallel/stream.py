"""Time-block (sequence) parallel streaming primitives (port of
`idsp_tpu.parallel.stream`).

The reference carries filter state across block boundaries inside one
core (ring-buffer `copy_within`, src/hbf.rs:93-101; scan carries).  When
the time axis is split over the ranks of a group, those carries become
collectives (`_comm`):

* `halo_exchange_prev`: the last ``h`` samples of each rank's block go
  to the right neighbour -- the overlap-save halo of FIR windows and the
  one-sample history of a discriminator.
* `sharded_df1_float`: a float DF1 biquad exact up to FP reassociation --
  each rank runs its block from zero feedback state, an exclusive prefix
  of the blocks' affine state maps fixes up the initial conditions.
* `sharded_df1_q_relay`: the fixed-point DF1 bit for bit, its carry
  relayed rank to rank.
* `sharded_hbf_dec`: a half-band decimator with overlap-save halos.

Each function is the per-rank body of a `torch.distributed` program, the
counterpart of a `shard_map` body: ``group`` is the mesh axis (None: the
default group), and rank 0 holds the first block.  Every rank calls each
function with tensors of the same shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..filters import biquad, hbf
from . import _comm
from .halo_rdma import halo_exchange_prev_rdma


def halo_exchange_prev(x, group=None, h: int = 1, *, fill=0):
    """Return the ``h`` samples preceding this rank's block.

    Block layout: x has time on axis 0 (this rank's shard).  Rank 0
    receives ``fill``.  One `_comm.ppermute` to the right neighbour (K41
    for a CUDA tensor, gloo send/recv for a CPU one).
    """
    prev = _comm.ppermute(x[x.shape[0] - h:], group)
    return torch.full_like(prev, fill) if _comm.rank(group) == 0 else prev


def time_sharded_prev(x, group, state_prev, state_valid):
    """One-sample history for a time-sharded stream.

    Rank 0 uses the carried (state_prev, state_valid) from the previous
    block; the others take the neighbour's last sample.  Returns (prev
    aligned with x, valid mask).
    """
    prev_tail = halo_exchange_prev(x, group, 1)
    state_prev = torch.as_tensor(state_prev, dtype=x.dtype, device=x.device)
    state_valid = torch.as_tensor(state_valid, dtype=torch.bool,
                                  device=x.device)
    first = _comm.rank(group) == 0
    first_prev = state_prev if first else prev_tail[0]
    first_valid = state_valid if first else torch.ones_like(state_valid)
    prev = torch.cat([first_prev.reshape((1,) + tuple(x.shape[1:])), x[:-1]])
    valid = torch.ones((x.shape[0],) + tuple(first_valid.shape),
                       dtype=torch.bool, device=x.device)
    valid[0] = first_valid
    return prev, valid


def replicate_from(x, group, src: int):
    """Rank ``src``'s value on every rank (the sum of a single-source
    contribution, as JAX's ``psum`` form; value-exact)."""
    return _comm.psum(x if _comm.rank(group) == src else torch.zeros_like(x),
                      group)


def _compose(m_k, v_k, m_acc, v_acc):
    """(M_k M_acc, M_k v_acc + v_k): the affine map k after the maps so far."""
    return (m_k @ m_acc, (m_k @ v_acc[..., None])[..., 0] + v_k)


def sharded_df1_float(ba, state: biquad.Df1State, xs, group=None):
    """Distributed float DF1 biquad over a time-sharded stream.

    ``xs`` is this rank's (n_local, ...) block, ``state`` the global carry
    entering rank 0, ``ba`` (5,) or (..., 5) a tensor of xs's dtype.

    Algorithm:
      1. x-halo: fetch the 2 input samples before this block, so the FIR
         part is local.
      2. Each rank runs its block (`biquad.df1_block_float`) with zero
         initial y-state: outputs ``y0_loc`` and the block's affine action
         (A^n, v) on the incoming y-state.
      3. The exclusive prefix of the affine maps across ranks from an
         all-gather of (A^n, v).
      4. Fix up: add the homogeneous response to the incoming state (the
         same block function with zero input).

    Returns (new_state_global, ys_local).
    """
    p, idx = _comm.size(group), _comm.rank(group)
    n = xs.shape[0]

    # 1. input halo for the FIR taps
    prev2 = halo_exchange_prev(xs, group, 2)  # (2, ...)
    x_state = state.x if idx == 0 else torch.stack([prev2[-1], prev2[-2]],
                                                   dim=-1)

    # 2. block-local pass with zero initial feedback state
    zero_y = torch.zeros_like(state.y)
    _, ys_loc = biquad.df1_block_float(ba, biquad.Df1State(x=x_state,
                                                           y=zero_y), xs)
    # s_out = A^n s_in + v, v the state reached from zero initial conditions
    v = torch.stack([ys_loc[-1], ys_loc[-2] if n >= 2 else zero_y[..., 0]],
                    dim=-1)
    a1 = torch.broadcast_to(ba[..., 3], v.shape[:-1])
    a2 = torch.broadcast_to(ba[..., 4], v.shape[:-1])
    a_mat = torch.stack([torch.stack([a1, a2], dim=-1),
                         torch.stack([torch.ones_like(a1),
                                      torch.zeros_like(a1)], dim=-1)], dim=-2)
    a_pow = torch.linalg.matrix_power(a_mat, n)

    # 3. the incoming state of this rank: the maps of ranks k < idx
    mats = _comm.all_gather(a_pow, group)  # (P, ..., 2, 2)
    vs = _comm.all_gather(v, group)  # (P, ..., 2)
    m_acc = torch.broadcast_to(torch.eye(2, dtype=v.dtype, device=v.device),
                               a_pow.shape)
    v_acc = torch.zeros_like(v)
    for k in range(idx):
        m_acc, v_acc = _compose(mats[k], vs[k], m_acc, v_acc)
    s_in = (m_acc @ state.y[..., None])[..., 0] + v_acc

    # 4. the homogeneous response C A^(k+1) s_in: the block scan of zero
    # input from state s_in
    _, hom = biquad.df1_block_float(
        ba, biquad.Df1State(x=torch.zeros_like(state.x), y=s_in),
        torch.zeros_like(xs))
    ys = ys_loc + hom

    # the carry leaving the last rank is the global new state
    s_out_last = (a_pow @ s_in[..., None])[..., 0] + v
    x_out_last = torch.stack([xs[-1], xs[-2] if n >= 2 else x_state[..., 0]],
                             dim=-1)
    return biquad.Df1State(x=replicate_from(x_out_last, group, p - 1),
                           y=replicate_from(s_out_last, group, p - 1)), ys


def _pack(st: biquad.Df1State):
    return torch.cat([st.x, st.y], dim=-1)


def _unpack(packed) -> biquad.Df1State:
    return biquad.Df1State(x=packed[..., :2].contiguous(),
                           y=packed[..., 2:].contiguous())


def sharded_df1_q_relay(ba, state: biquad.Df1State, xs, f: int, group=None):
    """Bit-exact time-sharded fixed-point DF1 by a sequential carry relay.

    The truncating fixed-point recurrence has no associative form
    (SURVEY.md §7 hard part 3), so rank k can only start once it has rank
    k-1's carry.  P rounds: in round k rank k alone scans its block
    (`biquad.df1_process_q`, from the carry it holds), then every rank's
    out-state moves one hop right (one `_comm.ppermute` of the packed
    (x, y) words) and rank k+1 adopts it.  Each rank scans its block once
    and the bits equal the sequential scan; latency stays serial in the
    rank count (time-sharding an integer IIR buys memory, not speed).

    ``xs`` is this rank's (n_local, ...) block.  Returns (new_state_global,
    ys_local).
    """
    p, idx = _comm.size(group), _comm.rank(group)
    st_in = st_out = state
    ys = torch.zeros_like(xs)
    for k in range(p):
        if idx == k:
            st_out, ys = biquad.df1_process_q(ba, f, st_in, xs)
        nxt = _comm.ppermute(_pack(st_out), group)
        if idx == k + 1:
            st_in = _unpack(nxt)
    out = _pack(st_out)
    return _unpack(replicate_from(out, group, p - 1)), ys


def sharded_hbf_dec(taps, state: hbf.HbfDecState, x_local, group=None, *,
                    use_rdma: bool = False):
    """Time-sharded half-band decimate-by-2 with overlap-save halos.

    Each rank fetches the ``4m-2`` full-rate samples preceding its block
    (one hop), rebuilds the odd/even tails and runs the block FIR
    (`hbf.hbf_dec_block`) locally; rank 0 uses the carried global state.
    Matches `hbf.hbf_dec_block` over the concatenated stream (same windows
    and add order).

    Args:
      x_local: (..., t_loc) this rank's time shard, t_loc even and at
        least 4m-2.
      use_rdma: move the halo with `halo_exchange_prev_rdma` (K41 on CUDA,
        whatever this flag says about `halo_exchange_prev`, which also
        takes K41 there; the flag mirrors the JAX signature).

    Returns (new_state_global, y_local (..., t_loc // 2)).
    """
    taps = np.asarray(taps)
    m = taps.shape[0]
    h = 4 * m - 2
    p, idx = _comm.size(group), _comm.rank(group)
    t_loc = x_local.shape[-1]
    if t_loc % 2 or t_loc < h:
        raise ValueError(f"t_loc must be even and >= {h}, got {t_loc}")
    xt = x_local.movedim(-1, 0)
    exchange = halo_exchange_prev_rdma if use_rdma else halo_exchange_prev
    halo = exchange(xt, group, h).movedim(0, -1)  # (..., h) preceding

    # Blocks start at even global indices (t_loc even), so halo[0] is an
    # even-parity sample: odds at 1::2 (2m-1 of them), evens at 0::2 (the
    # tail keeps the last m-1 of 2m-1).
    if idx == 0:
        st_loc = state
    else:
        st_loc = hbf.HbfDecState(odd=halo[..., 1::2],
                                 even=halo[..., 0::2][..., m:])
    new_st, y = hbf.hbf_dec_block(taps, st_loc, x_local)
    return hbf.HbfDecState(*(replicate_from(a.contiguous(), group, p - 1)
                             for a in new_st)), y


def channel_slice(x, group=None, dim: int = 0):
    """This rank's share of the channel axis ``dim`` of ``x`` (P equal
    pieces, rank r the r-th): the per-rank view of a channel-sharded
    array.  Channels are independent, so a bank run on the slice gives the
    slice of the bank's result."""
    p, r = _comm.size(group), _comm.rank(group)
    if x.shape[dim] % p:
        raise ValueError(f"{x.shape[dim]} channels do not split into {p}")
    piece = x.shape[dim] // p
    return x.narrow(dim, r * piece, piece)


def channel_sharding(mesh, axis: str = "dp"):
    """DTensor placements for (channel, time) arrays sharded on channels
    over mesh dimension ``axis`` (JAX's ``NamedSharding(mesh, P(axis,
    None))``): ``Shard(0)`` on that dimension, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]
