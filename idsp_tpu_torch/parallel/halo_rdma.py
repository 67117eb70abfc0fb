"""K41: the halo exchange by a peer put (port of
`idsp_tpu.parallel.halo_rdma`).

`halo_exchange_prev_rdma` returns the ``h`` rows that precede this
rank's block: rank r - 1's last ``h`` rows, ``fill`` on rank 0.  On CUDA
tensors the rows travel by K41 (``csrc/halo.cu``): each rank stores its
tail straight into its right neighbour's receive slot through a CUDA
IPC mapping, raises the neighbour's arrival flag with a system-scope
release, and waits for its own flag -- the Hopper counterpart of the
Pallas kernel's `make_async_remote_copy` plus neighbour barrier.  The
ring is symmetric (rank P-1 wraps to rank 0, whose entry is then masked
to ``fill``), as in JAX.  On CPU tensors the plain version runs: the
gloo send/recv ring of `stream.halo_exchange_prev`.

The slots.  Each rank allocates one slot per (group, byte size, device)
with cudaMalloc at the first call of that size, exchanges the IPC
handles with `dist.all_gather_object` and maps its right neighbour's
(a ring of one puts into its own slot); `close` frees them.  The same
code serves several processes on one card and one process per card over
NVLink peer mappings.

The host gate.  Before each launch a rank waits for its own stream and
meets the group at a host barrier, so every rank enters the kernel with
its earlier work done.  The device spin then lasts no longer than the
neighbours' launches, whatever the host-side skew between ranks (the
relay of `stream.sharded_df1_q_relay` keeps one rank busy for a whole
block scan while the others wait).  That matters most when processes
share a card: they take turns on it (time slicing), and a kernel that
spins while a neighbour still has work queued holds the card from that
work.  The kernel's wait is bounded by time (`TIMEOUT_S`); on timeout it
writes an error word, and the wrapper raises.  There is no fallback to
gloo or to the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from .. import _ext
from . import _comm

#: bound of the device-side wait for a neighbour, seconds
TIMEOUT_S = 5.0
#: bytes a block moves, up to the slot's flag count of blocks
CHUNK_BYTES = 16384
_HANDLE_BYTES = 64  # cudaIpcMemHandle_t
_ERRORS = {1: "the right neighbour never freed its receive slot",
           2: "the left neighbour's rows never arrived"}


class _Slot:
    """This rank's receive slot for one (group, byte size, device) and the
    mapping of its right neighbour's."""

    def __init__(self, group, nbytes: int, device: torch.device):
        lib = _ext.library()
        self.group, self.device = group, device
        p, r = _comm.size(group), _comm.rank(group)
        self.blocks = min(lib.idsp_halo_max_blocks(),
                          max(1, -(-nbytes // CHUNK_BYTES)))
        base = ctypes.c_void_p()
        handle = (ctypes.c_char * _HANDLE_BYTES)()
        with torch.cuda.device(device):
            err = lib.idsp_halo_slot_alloc(nbytes, ctypes.byref(base), handle)
        _ext.check(err, "idsp_halo_slot_alloc")
        self.base = base.value
        self.peer, self.mapped = self.base, False
        peers = [None] * p
        dist.all_gather_object(peers, (bytes(handle), nbytes), group=group)
        sizes = {nb for _, nb in peers}
        if sizes != {nbytes}:
            raise ValueError(f"halo_exchange_prev_rdma: the ranks' tails "
                             f"differ in size ({sorted(sizes)} bytes)")
        if p > 1:  # a ring of one puts into its own slot
            peer = ctypes.c_void_p()
            right = (ctypes.c_char * _HANDLE_BYTES).from_buffer_copy(
                peers[(r + 1) % p][0])
            with torch.cuda.device(device):
                _ext.check(lib.idsp_halo_slot_open(right, ctypes.byref(peer)),
                           "idsp_halo_slot_open")
            self.peer, self.mapped = peer.value, True
        self.epoch = 0  # puts made; the flags count the same
        self.err = torch.zeros(1, dtype=torch.int32, device=device)
        self.broken = None

    def free(self) -> None:
        lib = _ext.library()
        with torch.cuda.device(self.device):
            if self.mapped:
                _ext.check(lib.idsp_halo_slot_close(self.peer),
                           "idsp_halo_slot_close")
            dist.barrier(group=self.group)  # no peer maps this slot now
            _ext.check(lib.idsp_halo_slot_free(self.base),
                       "idsp_halo_slot_free")


_SLOTS: dict = {}  # (group name, nbytes, device) -> _Slot


def _name(group) -> str:
    """The group's name: one key for the handles that name one group."""
    return (group or dist.group.WORLD).group_name


def _slot(group, nbytes: int, device: torch.device) -> _Slot:
    key = (_name(group), nbytes, device)
    if key not in _SLOTS:
        _SLOTS[key] = _Slot(group, nbytes, device)
    return _SLOTS[key]


def close(group=None) -> None:
    """Free this rank's slots of ``group`` and unmap its neighbours'.
    Collective: every rank of the group calls it, before the group is
    destroyed."""
    torch.cuda.synchronize()
    dist.barrier(group=group)  # every rank is past its last put
    for key in [k for k in _SLOTS if k[0] == _name(group)]:
        _SLOTS.pop(key).free()


def ring_put(x, group=None):
    """K41 on a whole tensor: every rank of ``group`` passes a CUDA tensor
    of one shape and dtype and gets its left neighbour's (rank 0 gets rank
    P-1's).  The ring form of `_comm.ppermute`."""
    if x.device.type != "cuda":
        raise ValueError(f"ring_put moves CUDA tensors, got {x.device}")
    x = x.contiguous()
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        raise ValueError("ring_put: empty tensor")
    slot = _slot(group, nbytes, x.device)
    if slot.broken:
        raise RuntimeError(slot.broken)
    out = torch.empty_like(x)
    torch.cuda.current_stream(x.device).synchronize()  # the host gate
    dist.barrier(group=group)
    slot.epoch += 1
    with torch.cuda.device(x.device):
        err = _ext.library().idsp_halo_put(
            x.data_ptr(), out.data_ptr(), slot.base, slot.peer, nbytes,
            slot.blocks, slot.epoch, int(TIMEOUT_S * 1e9),
            slot.err.data_ptr(), _ext.stream_ptr(x.device))
    _ext.check(err, "halo_exchange_prev_rdma")
    halo_exchange_prev_rdma.launches += 1
    code = int(slot.err.item())  # waits for the kernel
    if code:
        slot.broken = (f"halo_exchange_prev_rdma: {_ERRORS[code]} within "
                       f"{TIMEOUT_S} s (put {slot.epoch} of {nbytes} bytes, "
                       f"rank {_comm.rank(group)} of {_comm.size(group)})")
        raise RuntimeError(slot.broken)
    return out


def halo_exchange_prev_rdma(x, group=None, h: int = 1, *, fill=0):
    """The ``h`` rows preceding this rank's block, moved by K41.

    Drop-in equivalent of `stream.halo_exchange_prev` (rank 0 gets
    ``fill``), with the hop a peer put instead of a send/recv.

    Args:
      x: this rank's (n, ...) time-major block, any dtype; every rank of
        ``group`` passes the same shape.
      group: the axis (None: the default group).

    Returns (h, ...) like ``x``.  A CPU tensor takes the plain version,
    the gloo ring of `stream.halo_exchange_prev`.
    """
    n = x.shape[0]
    if not 1 <= h <= n:
        raise ValueError(f"need 1 <= h <= n, got h={h}, n={n}")
    if x.device.type == "cpu":
        from .stream import halo_exchange_prev

        return halo_exchange_prev(x, group, h, fill=fill)
    prev = ring_put(x[n - h:], group)
    return torch.full_like(prev, fill) if _comm.rank(group) == 0 else prev


halo_exchange_prev_rdma.launches = 0  # K41 launches since the last reset
