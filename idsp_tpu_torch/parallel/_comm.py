"""The four collectives of the scale-out layer, over `torch.distributed`.

The JAX package writes each parallel function as the body of `shard_map`
over a named mesh axis and uses four XLA collectives.  Here a function
is the per-rank body of a `torch.distributed` program, the axis is a
``group`` (a `ProcessGroup`, or None for the default group; a
`DeviceMesh` hands out one per dimension with ``mesh.get_group(name)``),
and the collectives are:

* `ppermute` (the right shift, or the ring): gloo send/recv for CPU
  tensors; K41 (`halo_rdma.ring_put`, a CUDA IPC peer put) for CUDA
  tensors, since gloo has no CUDA send/recv and NCCL refuses two ranks on
  one card.
* `psum`: `dist.all_reduce`.
* `all_gather`: an all-reduce of rank-masked slots (exact: the other
  slots add zeros), because gloo has no CUDA all-gather.
* `psum_scatter`: `reduce_scatter_tensor` on NCCL; elsewhere (gloo, for
  CPU and CUDA tensors alike) an all-reduce and this rank's slice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def rank(group=None) -> int:
    """This process's index on the axis (JAX `axis_index`)."""
    return dist.get_rank(group)


def size(group=None) -> int:
    """The axis size (JAX `axis_size`)."""
    return dist.get_world_size(group)


def _global(group, r: int) -> int:
    return dist.get_global_rank(group or dist.group.WORLD, r)


def ppermute(x, group=None, *, ring: bool = False):
    """JAX's ``ppermute`` one step right: rank r's ``x`` goes to rank r + 1
    and, with ``ring``, rank P-1's to rank 0; a rank that nothing is sent
    to gets zeros.  Every rank passes a tensor of the same shape and
    dtype."""
    p, r = size(group), rank(group)
    if x.device.type == "cuda":
        from . import halo_rdma

        got = halo_rdma.ring_put(x, group)
        return got if ring or r > 0 else torch.zeros_like(got)
    if x.device.type != "cpu":
        raise ValueError(f"ppermute takes CPU or CUDA tensors, got {x.device}")
    x = x.contiguous()
    out = torch.zeros_like(x)
    if p == 1:
        return x.clone() if ring else out
    reqs = []
    if ring or r < p - 1:
        reqs.append(dist.isend(x, _global(group, (r + 1) % p), group=group))
    if ring or r > 0:
        reqs.append(dist.irecv(out, _global(group, (r - 1) % p), group=group))
    for q in reqs:
        q.wait()
    return out


def psum(x, group=None):
    """The sum over the axis, on every rank (a new tensor)."""
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def all_gather(x, group=None):
    """(P, ...) stack of every rank's ``x``, on every rank: slot r holds
    rank r's value, the all-reduce adds zeros to it."""
    slots = torch.zeros((size(group),) + tuple(x.shape), dtype=x.dtype,
                        device=x.device)
    slots[rank(group)] = x
    dist.all_reduce(slots, group=group)
    return slots


def psum_scatter(x, group=None, *, dim: int):
    """JAX's tiled ``psum_scatter``: the sum over the axis, cut into P
    equal pieces along ``dim``; rank r keeps piece r."""
    p, r = size(group), rank(group)
    dim %= x.dim()
    if x.shape[dim] % p:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"into {p} pieces")
    piece = x.shape[dim] // p
    if x.device.type == "cuda" and dist.get_backend(group) == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((piece,) + tuple(src.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)
    # gloo: no reduce-scatter of CUDA tensors, so all-reduce and slice
    return psum(x, group).narrow(dim, r * piece, piece).contiguous()
