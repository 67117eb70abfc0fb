"""Pipeline parallelism: cascade stages across ranks (port of
`idsp_tpu.parallel.pipeline`).

The reference nests cascade stages in one core (`Major` scratch
pipelines, hbf.rs:385-421; stage-major SOS sweeps, py.rs:51-74).  Over
a group of S ranks, each rank owns one stage and blocks stream through
the chain: rank s processes block k-s at step k and hands its output to
rank s+1 -- a software systolic pipeline with S-1 fill bubbles.

Implemented for a homogeneous fixed-point biquad (SOS) cascade, each
stage a `biquad.df1_process_q` (plain torch, as `lax.scan` is in JAX).
The functions are per-rank bodies of a `torch.distributed` program;
``group`` is the pipe axis.  A rank with no block at a step does no scan
(JAX computes and discards it): the bits are the same.
"""

from __future__ import annotations

import torch

from ..filters import biquad
from . import _comm
from .stream import _pack, _unpack, replicate_from


def _group(mesh, axis_name: str):
    """The group of mesh dimension ``axis_name`` (a `DeviceMesh`), or
    ``mesh`` itself (a `ProcessGroup` or None)."""
    return mesh.get_group(axis_name) if hasattr(mesh, "get_group") else mesh


def pipelined_sos_cascade(ba_stages, xs_blocks, f: int, group=None):
    """Run an S-stage fixed-point SOS cascade pipelined over S ranks.

    Args:
      ba_stages: (S, 5) int32 coefficients, the same on every rank.
      xs_blocks: (nb, tb, ...) int32 input blocks, the same on every rank.
      f: fractional bits.

    Returns (nb, tb, ...): the outputs of the full cascade on every rank,
    equal to the sequential stage-major sweep.
    """
    s_count, stage = _comm.size(group), _comm.rank(group)
    nb = xs_blocks.shape[0]
    my_ba = ba_stages[stage]
    state = biquad.df1_init(tuple(xs_blocks.shape[2:]),
                            device=xs_blocks.device)
    prev_out = torch.zeros_like(xs_blocks[0])
    outs = []
    for k in range(nb + s_count - 1):
        # the upstream rank's last output
        inbox = _comm.ppermute(prev_out, group)
        b = k - stage
        if 0 <= b < nb:
            x_in = xs_blocks[b] if stage == 0 else inbox
            state, prev_out = biquad.df1_process_q(my_ba, f, state, x_in)
        else:  # no block here: hold the state, emit zeros
            prev_out = torch.zeros_like(prev_out)
        outs.append(replicate_from(prev_out, group, s_count - 1))
    # block j of the output leaves the last rank at step j + S - 1
    return torch.stack(outs[s_count - 1:])


def pipelined_sos_cascade_sharded(ba_stages, xs_local, nb: int, f: int,
                                  group=None):
    """S-stage pipelined SOS with sharded block storage and rotating
    states.

    Blocks are sharded cyclically (block b lives on rank b mod S) and
    never move.  Rank d at step k applies stage s = (k - d) mod S to its
    own block b = k - s, so each rank runs all S stages on one resident
    block over S consecutive steps, while the per-stage filter states
    rotate along the ring: one `_comm.ppermute` (ring) of one packed
    `Df1State` (4 words a channel) per step, whatever the block length.
    Stage s's state visits the blocks in stream order b = 0, 1, 2, ...,
    which is the ring walk d = 0, 1, 2, ... (mod S).

    ``xs_local`` is this rank's (nb_loc, tb, ...) cyclic shard (global
    blocks d, d+S, d+2S, ...), nb = S * nb_loc.  Returns this rank's
    cyclic shard of the cascade output, bit-exact vs the sequential
    stage-major sweep.
    """
    s_count, d = _comm.size(group), _comm.rank(group)
    nb_loc = xs_local.shape[0]
    if nb != nb_loc * s_count:
        raise ValueError(f"nb={nb} is not {s_count} x {nb_loc} local blocks")
    state = biquad.df1_init(tuple(xs_local.shape[2:]), device=xs_local.device)
    prev_y = torch.zeros_like(xs_local[0])
    outs = torch.zeros_like(xs_local)
    for k in range(nb + s_count - 1):
        # the state of the stage this rank runs at step k, as its previous
        # block left it (the only collective of the loop)
        state = _unpack(_comm.ppermute(_pack(state), group, ring=True))
        s_idx = (k - d) % s_count
        b = k - s_idx  # resident block (b mod S = d)
        if not 0 <= b < nb:
            prev_y = torch.zeros_like(prev_y)
            continue
        mc = (k - d) // s_count  # its local index
        # stage 0 reads the resident input block; later stages the previous
        # step's output of the same rank (same block)
        x_in = xs_local[mc] if s_idx == 0 else prev_y
        state, prev_y = biquad.df1_process_q(ba_stages[s_idx], f, state, x_in)
        if s_idx == s_count - 1:  # the last stage's output stays here
            outs[mc] = prev_y
    return outs


def run_pipelined_sos(mesh, ba_stages, xs_blocks, f: int,
                      axis_name: str = "pp", *, shard_io: bool = False):
    """The pipelined cascade on this rank (JAX's jit + shard_map wrapper).

    ``mesh``: a `DeviceMesh` (its dimension ``axis_name`` is the pipe) or
    a `ProcessGroup`.  ``xs_blocks`` (nb, tb, ...) is the whole input on
    every rank.

    shard_io=False: replicated in and out; returns the whole output.
    shard_io=True: this rank keeps only its cyclic shard of blocks
    (memory O(nb/S); nb must divide by the stage count) and returns its
    shard of the output, blocks rank, rank + S, ...
    """
    group = _group(mesh, axis_name)
    if not shard_io:
        return pipelined_sos_cascade(ba_stages, xs_blocks, f, group)
    nb, s_count = xs_blocks.shape[0], _comm.size(group)
    if nb % s_count:
        raise ValueError(f"nb={nb} blocks do not split over {s_count} ranks")
    return pipelined_sos_cascade_sharded(
        ba_stages, xs_blocks[_comm.rank(group)::s_count].contiguous(), nb, f,
        group)
