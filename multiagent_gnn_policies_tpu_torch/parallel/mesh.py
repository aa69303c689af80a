"""Device meshes over the ranks of the process group.

The counterpart of the JAX package's ``parallel/mesh.py``. Axes:

* ``env``: data parallelism over environments and the replay batch;
* ``agents``: the swarm's agent axis (the model is ~1.7k parameters; the
  graph is the big tensor, so scale-out shards N, not the weights).

One process per device: a mesh of D ranks needs a process group of D
ranks (:mod:`parallel.distributed`), each on its own device.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from multiagent_gnn_policies_tpu_torch.parallel.distributed import AxisGroup

AXES = ("env", "agents")


def make_mesh(n_env: Optional[int] = None, n_agent_shards: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """An ``("env", "agents")`` mesh over the process group's ranks.

    Args:
      n_env: size of the env (data-parallel) axis; defaults to the world
        size over ``n_agent_shards``.
      n_agent_shards: size of the agent-sharding axis.
      device_type: "cuda" (NCCL, one card per rank) or "cpu" (gloo).

    Raises ValueError for a world size that ``n_agent_shards`` does not
    divide, a mesh larger than the world, or one smaller (each rank is one
    device, and every rank takes part), and RuntimeError without a process
    group (asking for a mesh never quietly runs on one device)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize_distributed "
                           "(or run under torchrun with "
                           "MAGNN_AUTO_DISTRIBUTED=1)")
    world = dist.get_world_size()
    if n_env is None:
        if world % n_agent_shards:
            raise ValueError(f"{world} devices not divisible by "
                             f"{n_agent_shards} agent shards")
        n_env = world // n_agent_shards
    need = n_env * n_agent_shards
    if need > world:
        raise ValueError(f"mesh needs {need} devices, have {world}")
    if need < world:
        raise ValueError(f"mesh of {need} devices on {world} ranks: one "
                         f"process drives one device, so the mesh must "
                         f"cover every rank")
    return init_device_mesh(device_type, (n_env, n_agent_shards),
                            mesh_dim_names=AXES)


def axis_group(mesh: DeviceMesh, axis: str = "agents",
               force_n_dev: Optional[int] = None) -> AxisGroup:
    """The collectives of ``mesh``'s ``axis`` for this rank. With
    ``force_n_dev`` (a timing mode) the axis is emulated at that size on
    this rank's device when it differs from the mesh's
    (:class:`AxisGroup`)."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    index = mesh.get_local_rank(axis)
    if force_n_dev is None or force_n_dev == size:
        return AxisGroup(mesh.get_group(axis), size, index)
    return AxisGroup(None, force_n_dev, index, emulated=True)
