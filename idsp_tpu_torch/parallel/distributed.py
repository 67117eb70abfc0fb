"""Multi-process initialization helpers (port of
`idsp_tpu.parallel.distributed`).

`initialize_from_env` starts the default `torch.distributed` process
group when the environment describes a multi-process launch (torchrun's
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK``,
or the JAX launcher names), and stays inert in a single process.  Then:

    from idsp_tpu_torch.parallel import distributed
    distributed.initialize_from_env()          # no-op in one process
    mesh = distributed.global_mesh({"dp": 2, "sp": 4})

The backend: NCCL when each rank of a host owns a card, gloo when
several ranks share one (NCCL refuses two ranks on one device; the
parallel layer's shifts then go through K41 and its sums through gloo's
CUDA all-reduce), gloo for ``device_type="cpu"``.  A CUDA launch on a
machine without a card raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import make_mesh


def _env(*names):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return None


def _int(v):
    return None if v is None else int(v)


def initialize_from_env(init_method: str | None = None,
                        world_size: int | None = None,
                        rank: int | None = None, *,
                        device_type: str = "cuda") -> bool:
    """Initialize the default process group if a multi-process launch is
    detected.

    Detection order: the explicit arguments, then torchrun's variables
    (``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), then
    JAX's (``JAX_COORDINATOR_ADDRESS``/``COORDINATOR_ADDRESS`` as
    ``host:port``, ``JAX_NUM_PROCESSES``/``NUM_PROCESSES``,
    ``JAX_PROCESS_ID``/``PROCESS_ID``).  The card of a rank is
    ``LOCAL_RANK`` (else the rank) modulo the cards present.

    Returns True once the group is up (here or before: repeated calls
    return True), False in a single process (no address and no world
    size) -- then nothing is touched.  Raises on a partial description or
    a CUDA launch without a card.
    """
    if dist.is_initialized():
        return True
    if init_method is None:
        addr, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
        coord = _env("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
        if addr is not None and port is not None:
            init_method = f"tcp://{addr}:{port}"
        elif coord is not None:
            init_method = f"tcp://{coord}"
    if world_size is None:
        world_size = _int(_env("WORLD_SIZE", "JAX_NUM_PROCESSES",
                               "NUM_PROCESSES"))
    if rank is None:
        rank = _int(_env("RANK", "JAX_PROCESS_ID", "PROCESS_ID"))
    if init_method is None and world_size is None:
        return False  # single process: stay inert
    if init_method is None or world_size is None or rank is None:
        raise ValueError(f"incomplete launch description: init_method="
                         f"{init_method}, world_size={world_size}, "
                         f"rank={rank}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    local_rank = _int(_env("LOCAL_RANK"))
    local_rank = rank if local_rank is None else local_rank
    local_world = _int(_env("LOCAL_WORLD_SIZE")) or world_size
    backend = _backend(device_type, local_world)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def _backend(device_type: str, local_world: int) -> str:
    """NCCL when every rank of the host has a card of its own, gloo when
    ranks share cards or run on the CPU."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA launch needs a card and none is present; "
                           "pass device_type='cpu' to run on the CPU")
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def global_mesh(axis_sizes: dict[str, int], *, device_type: str = "cuda"):
    """A mesh over every rank of the default group (same contract as
    `make_mesh`: the sizes multiply to the world size)."""
    return make_mesh(axis_sizes, device_type=device_type)


def process_info(device_type: str = "cuda") -> dict:
    """Topology summary for logs and metrics: this process's rank and the
    process count, the devices this process sees (the cards, or 1 for the
    CPU) and the devices of the group (one per rank)."""
    up = dist.is_initialized()
    count = dist.get_world_size() if up else 1
    local = (torch.cuda.device_count() if device_type == "cuda" else 1)
    return {"process_index": dist.get_rank() if up else 0,
            "process_count": count, "local_devices": local,
            "global_devices": count}
