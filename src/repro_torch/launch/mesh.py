"""Mesh definitions over the initialised process group (port of
``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group.  A mesh is a :class:`torch.distributed.device_mesh.
DeviceMesh` with named dims, one rank a device, numbered row-major.  The
process group must exist (``torch.distributed.run`` or
``init_process_group``) and hold exactly the mesh's ranks: the reference
clips its mesh to the devices jax sees, but a rank outside the mesh would
have no work here, so a mismatch raises.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.fractal_sort import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh"]


def _mesh(shape: tuple, names: tuple, device):
    if not dist.is_initialized():
        raise ValueError(f"a {shape} mesh needs an initialised process "
                         f"group")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 ranks per pod; multi_pod prepends a 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """The (data, model) mesh over the process group's ranks (tests,
    examples, the train driver).  ``device=None`` means ``"cuda"``."""
    return _mesh((data, model), ("data", "model"), device)
