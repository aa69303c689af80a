"""Agent-axis-sharded inference on a mesh.

The counterpart of the JAX package's ``parallel/sharded.py``:

* :func:`sharded_policy_forward`, the dense large-N inference path: the
  ``(K, N, N) x (K, N, F)`` aggregation partitions by output-agent blocks,
  so each rank holds the GSO columns of its own agents, contracts the
  whole (replicated, small) feature stack with them and runs the policy on
  its agents. Memory per rank is O(K·N²/D).

The JAX package's ``ShardedImitationLearner`` (data-parallel training over
the mesh's ``env`` axis) is not ported yet: it is the next slice (ROADMAP.md
queue 1 item 2).
"""

from __future__ import annotations

from typing import Optional

import torch

from multiagent_gnn_policies_tpu_torch.ops.graph import aggregate
from multiagent_gnn_policies_tpu_torch.parallel.distributed import AxisGroup


def sharded_policy_forward(actor: torch.nn.Module, delay_state: torch.Tensor,
                           gso_cols: torch.Tensor,
                           axis: Optional[AxisGroup] = None,
                           gather: bool = False) -> torch.Tensor:
    """The policy's actions for this rank's agents.

    Args:
      actor: an ``ind_agg = 0`` actor (it reads the aggregated stack).
      delay_state: ``(K, N, F)``, replicated.
      gso_cols: ``(K, N, N/D)``, the columns of the delayed GSO that belong
        to this rank's agents (the JAX package shards the full GSO on its
        last axis).
      axis / gather: with ``gather`` the ranks' actions are gathered over
        ``axis`` in rank order into ``(N, n_a)``.

    Returns ``(N/D, n_a)`` actions (``(N, n_a)`` with ``gather``). The
    contraction is ``torch.matmul``, as the JAX package leaves it to XLA."""
    out = actor(aggregate(gso_cols, delay_state))
    if gather:
        if axis is None:
            raise ValueError("gather=True needs the mesh axis to gather over")
        out = axis.all_gather(out)
    return out
