"""The dry run's meshes (port of ``repro.launch.mesh``).

The reference forces 512 XLA host devices and lays a mesh over them. The
port has no such devices: it starts a ``torch.distributed`` process group
of the FAKE backend (PyTorch's test backend, which moves nothing) with
the production world size and plays its rank 0. Collectives then run and
are counted, but carry no data. The group is started only if none
exists, and these functions refuse to run beside a real one:
``repro_torch.dist.sharding.make_mesh`` keeps taking only NCCL and gloo,
so nothing on a real path accepts the fake backend.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

__all__ = ["make_production_mesh", "make_test_mesh", "fake_group"]


def fake_group(world_size: int) -> None:
    """Start a fake process group of ``world_size`` ranks, as rank 0, or
    check the running one is such a group of that size."""
    if dist.is_initialized():
        backend = str(dist.get_backend())
        if backend != "fake":
            raise RuntimeError(f"a real process group ({backend}) is running: the dry run's "
                               "meshes need a fake group of their own process")
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"the fake group has {dist.get_world_size()} ranks, the mesh "
                               f"needs {world_size}: start another process")
        return
    # PyTorch's fake backend registers itself on this import.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_test_mesh(shape: Sequence[int] = (2, 2), axes: Sequence[str] = ("data", "model")):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake group of
    prod(shape) ranks, seen from rank 0."""
    fake_group(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16 x 16 = 256 ranks ("data", "model"). Multi-pod:
    2 x 16 x 16 = 512 ranks ("pod", "data", "model")."""
    if multi_pod:
        return make_test_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_test_mesh((16, 16), ("data", "model"))
