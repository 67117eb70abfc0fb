"""Device-mesh construction helpers (port of `idsp_tpu.parallel.mesh`).

A mesh here is a `torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, which must be initialized (see
`distributed.initialize_from_env`); `mesh.get_group(name)` is the group
of one named axis, the ``group`` argument of the parallel functions.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axis_sizes: dict[str, int], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh with named axes from a {name: size} mapping.

    The sizes must multiply to the world size.  Axis order follows the
    dict order, rank-major: put the axis with the most traffic (the
    carry relay / halo ``sp`` axis) last, so that it joins neighbouring
    ranks.  ``device_type`` is "cuda" (the card) or "cpu".
    """
    names = tuple(axis_sizes)
    shape = tuple(int(axis_sizes[n]) for n in names)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"mesh {axis_sizes} needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def local_mesh(*names_and_sizes: tuple[str, int],
               device_type: str = "cuda") -> DeviceMesh:
    """Convenience: ``local_mesh(("sp", 4), ("dp", 2))``."""
    return make_mesh(dict(names_and_sizes), device_type=device_type)
