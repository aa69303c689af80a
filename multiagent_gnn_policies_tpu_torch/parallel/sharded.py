"""Data-parallel training and agent-axis-sharded inference on a mesh.

The counterpart of the JAX package's ``parallel/sharded.py``:

* :class:`ShardedImitationLearner`, data parallelism for the dense
  learner: the round's ``n_rollout_envs`` episodes are split over the
  mesh's ``env`` axis, and each Adam update's replay batch is split over
  the same axis, its gradient summed by one ``all_reduce`` (the gradient
  ``psum`` that XLA inserts against the JAX learner's replicated params).
* :func:`sharded_policy_forward`, the dense large-N inference path: the
  ``(K, N, N) x (K, N, F)`` aggregation partitions by output-agent blocks,
  so each rank holds the GSO columns of its own agents, contracts the
  whole (replicated, small) feature stack with them and runs the policy on
  its agents. Memory per rank is O(K·N²/D).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from multiagent_gnn_policies_tpu_torch.algos.imitation import (
    ImitationConfig,
    ImitationLearner,
    rollout_episode,
)
from multiagent_gnn_policies_tpu_torch.ops.graph import aggregate
from multiagent_gnn_policies_tpu_torch.parallel.distributed import AxisGroup
from multiagent_gnn_policies_tpu_torch.parallel.mesh import axis_group
from multiagent_gnn_policies_tpu_torch.utils.metrics import MetricsLogger


class ShardedImitationLearner(ImitationLearner):
    """The dense imitation learner with its round data-parallel over the
    ``env`` axis of ``mesh`` (``parallel.mesh.make_mesh``; every rank of
    the mesh constructs one, each on its own device).

    Every rank holds the same actor, Adam state, buffer and generator, and
    makes every random draw of the round, as one process does:

    * collection: env group g runs episodes ``[g·E/n_env, (g+1)·E/n_env)``
      of the round's E = ``n_rollout_envs`` (the whole batch's reset, coins
      and noise drawn, its slice kept: ``FlockingEnv.env_range``);
      the records are gathered over ``env`` in episode order, so every
      rank's buffer is the one-process buffer;
    * updates: every rank samples the same batch of B records; env group g
      takes the MSE of rows ``[g·c, min((g+1)·c, B))``, c = ceil(B /
      n_env) (XLA's split of an uneven batch, which the JAX learner takes
      too), as that slice's share of the batch mean (its mean times its
      rows / B), and one ``all_reduce(SUM)`` over ``env`` sums the
      gradients and the loss; then the same Adam step on every rank.

    Ranks of one env group (the ``agents`` axis) do the same work, as the
    JAX learner replicates over that axis. ``graph`` as the dense
    learner's: by default the rank's slice of the collection runs as its
    ``DenseEpisodeProgram`` (the slice part of the setup) and each update
    as the learner's ``UpdateProgram`` over :meth:`_update`, its rows of
    the batch and its ``all_reduce`` captured with it (the counterpart of
    the JAX package's ``_round_impl`` re-jitted over the mesh); the
    records' gather over ``env`` runs eagerly after the episode. Raises
    ValueError when the ``env`` axis does not divide ``n_rollout_envs``."""

    def __init__(self, cfg: ImitationConfig, mesh,
                 logger: Optional[MetricsLogger] = None, device="cuda",
                 graph=None):
        env_axis = axis_group(mesh, "env")
        if cfg.n_rollout_envs % env_axis.n_dev:
            raise ValueError(
                f"n_rollout_envs={cfg.n_rollout_envs} not divisible by mesh "
                f"env axis {env_axis.n_dev} (the episodes must divide "
                f"evenly over it)")
        self.mesh, self._env_axis = mesh, env_axis
        super().__init__(cfg, logger, device, graph)

    def _collect(self):
        cfg, total = self.cfg, self.cfg.n_rollout_envs
        e = total // self._env_axis.n_dev
        mine = slice(self._env_axis.index * e, (self._env_axis.index + 1) * e)
        x0 = self.env.reset(self.gen, (total,))[0].x[mine]
        coins = None
        if cfg.mode == "dagger":
            coins = torch.rand((self.env.params.episode_steps, total),
                               generator=self.gen,
                               device=self.device)[:, mine] < self._beta
        return rollout_episode(
            self.actor, self.gen, self._beta,
            dataclasses.replace(self.env, env_range=(mine.start, total)),
            cfg.actor, mode=cfg.mode, x0=x0, coins=coins, graph=self._graph)

    def _batch_rows(self, b: int):
        """This env group's rows ``[lo, hi)`` of a batch of ``b``."""
        ax = self._env_axis
        c = -(-b // ax.n_dev)
        return min(ax.index * c, b), min((ax.index + 1) * c, b)

    def _update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The rank's rows of ``batch`` (none on a rank past its end: a
        zero gradient, a choice fixed per rank, so a captured update takes
        the same branch at every replay), their share of the MSE's
        gradient and loss summed over ``env`` by one ``all_reduce``, then
        Adam."""
        b = batch["act"].shape[0]
        lo, hi = self._batch_rows(b)
        params = list(self.actor.parameters())
        self.opt.zero_grad(set_to_none=True)
        if hi > lo:
            loss = F.mse_loss(self.actor(batch["agg"][lo:hi]),
                              batch["act"][lo:hi]) * ((hi - lo) / b)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), device=self.device)
            for p in params:
                p.grad = torch.zeros_like(p)
        flat = self._env_axis.all_reduce(torch.cat(
            [p.grad.reshape(-1) for p in params] + [loss.reshape(1)]))
        at = 0
        for p in params:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p))
            at += p.numel()
        self.opt.step()
        return flat[-1]


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
