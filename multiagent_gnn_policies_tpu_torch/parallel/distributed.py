"""Multi-process bootstrap on ``torch.distributed``, and the collectives of
one mesh axis.

The counterpart of the JAX package's ``parallel/distributed.py``. The JAX
package runs one process with many devices under ``shard_map``; the port
runs one process per device (SPMD, PyTorch's idiom): rank r drives
``cuda:{LOCAL_RANK}`` over NCCL, or the CPU over gloo.

Environment contract (the JAX package's; all three must be set, else
:func:`maybe_initialize_distributed` does nothing, so every CLI can call it
unconditionally):

  MAGNN_COORDINATOR   host:port of rank 0 (a ``tcp://`` rendezvous)
  MAGNN_NUM_PROCESSES world size
  MAGNN_PROCESS_ID    this process's rank in [0, world size)

``MAGNN_AUTO_DISTRIBUTED=1`` takes the rendezvous from the variables that
``torchrun`` sets (``env://``: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
LOCAL_RANK). ``MAGNN_PLATFORM=cpu`` (or ``platform="cpu"``) selects gloo on
the CPU; anything else NCCL on the card of the local rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)
# the tiled all_gather: newer torch names it all_gather_single and warns on
# the older name, which is all that older torch has
_ALL_GATHER = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)


def _backend(platform: Optional[str]) -> str:
    if platform is None:
        platform = os.environ.get("MAGNN_PLATFORM")
    return "gloo" if platform == "cpu" else "nccl"


def local_device(platform: Optional[str] = None) -> torch.device:
    """This rank's device: the CPU under gloo, else ``cuda:{LOCAL_RANK}``
    (the rank modulo the visible cards when LOCAL_RANK is unset)."""
    if _backend(platform) == "gloo":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(local))


def initialize_distributed(coordinator: Optional[str], num_processes: int,
                           process_id: int,
                           platform: Optional[str] = None) -> None:
    """Join the process group: ``coordinator`` ``host:port`` of rank 0
    (``tcp://``; None reads the ``env://`` variables), the world size and
    this rank. ``platform`` "cpu" selects gloo, anything else NCCL (whose
    rank first binds its card, :func:`local_device`)."""
    backend = _backend(platform)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device; pass platform='cpu' "
                               "(MAGNN_PLATFORM=cpu) for gloo on the CPU")
        os.environ.setdefault("LOCAL_RANK", str(
            process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local_device(platform))
    init = "env://" if coordinator is None else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def maybe_initialize_distributed(platform: Optional[str] = None) -> bool:
    """Initialise the process group from the environment (see the module
    docstring); True if a group is up afterwards. A no-op without the
    variables, and when a group already exists."""
    if dist.is_available() and dist.is_initialized():
        return True
    if os.environ.get("MAGNN_AUTO_DISTRIBUTED") == "1":
        initialize_distributed(None, int(os.environ["WORLD_SIZE"]),
                               int(os.environ["RANK"]), platform)
        return True
    coord = os.environ.get("MAGNN_COORDINATOR")
    nproc = os.environ.get("MAGNN_NUM_PROCESSES")
    pid = os.environ.get("MAGNN_PROCESS_ID")
    if not (coord and nproc and pid):
        return False
    initialize_distributed(coord, int(nproc), int(pid), platform)
    return True


def process_info() -> Tuple[int, int]:
    """``(rank, world size)`` of this process; ``(0, 1)`` without a
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The collectives of one mesh axis: its process group, its size
    ``n_dev`` and this rank's ``index`` on it (the JAX package's
    ``axis_name`` with ``axis_index``).

    ``emulated``: one device runs rank ``index``'s program of an
    ``n_dev``-wide axis (``rollout_large(force_n_dev=)``, the per-device
    timing mode): each collective is replaced by a local operation with the
    output's shape (a reduction is the identity, a gather tiles the local
    part), so the device does a real rank's compute and no communication,
    and the results are not valid."""

    group: Optional[dist.ProcessGroup]
    n_dev: int
    index: int
    emulated: bool = False

    def live(self) -> bool:
        """Whether the axis's process group still exists (an emulated axis
        has none and is always live): a CUDA graph that captured its
        collectives must not replay once it is destroyed."""
        if self.group is None:
            return True
        try:
            dist.get_process_group_ranks(self.group)
        except (KeyError, RuntimeError, ValueError):
            return False
        return True

    def all_reduce(self, t: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the axis in place (``psum``, ``pmin``,
        ``pmax``); returns it."""
        if not self.emulated:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The axis's ``t`` concatenated along dim 0 in rank order (a tiled
        ``all_gather``)."""
        t = t.contiguous()
        if self.emulated:
            return t.repeat(self.n_dev, *([1] * (t.dim() - 1)))
        out = t.new_empty((self.n_dev * t.shape[0], *t.shape[1:]))
        _ALL_GATHER(out, t, group=self.group)
        return out
