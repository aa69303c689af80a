"""DDPG past the dense record's size: the positions record (N = 4,096).

The counterpart of the JAX package's ``algos/ddpg_large.py``. The dense
learner stores (K, N, N) GSO tensors per transition; at N = 4,096 and
K = 2 a record would take ~268 MB. Here a record holds what the graphs
are a function of:

* the raw feature history ``hist`` (K, N, S), the positions that source
  the current and delayed graphs ``pos`` (max(K-1, 1), N, 2), newest
  first, and the next step's features and positions, the action, the
  reward and ``notdone`` (always 1, as the JAX class stores it): O(K·N)
  floats, ~393 KB at N = 4,096;
* a gradient step rebuilds each sampled record's row-normalised
  adjacencies from positions (:func:`dense_adj_from_pos`: exact, nothing
  to overflow) and applies the graphs as chains of ``A^T @ h`` products
  (:func:`actor_forward_adj`, :func:`critic_forward_adj`), so neither the
  delayed GSO nor the GSO powers are ever built.

An episode's frames (features, degrees, min r²) come from the O(N²)
row-blocked ``ops/blocked.py:blocked_frame``, as in the JAX class: no cell
grid, so no capacity and no overflow. Resets below the lattice regime take
the first of up to ``1 + max_resets`` candidates with min separation and
min degree met (the last one otherwise). The eval runs
``n_test_episodes`` episodes one after another and clips the policy's
output to ±1. Losses, the gradient step, the OU process, the training
episode's programs, resume and export are the dense learner's
(``algos/ddpg.py``). On one card an eval episode's steps run as one
captured graph (:meth:`DDPGLarge._eval_program`), replayed after each
episode's eager reset (whose candidate loop waits on the host).

The products are float32 ``torch.matmul`` calls (cuBLAS on the card, TF32
off); the JAX package computes them with XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.algos.ddpg import (
    DDPG,
    DDPGConfig,
    Batch,
)
from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams,
    _init_candidate,
    _lattice_regime,
    _r2_adj,
    dynamics,
    reward,
)
from multiagent_gnn_policies_tpu_torch.models.actor import Actor
from multiagent_gnn_policies_tpu_torch.models.critic import Critic
from multiagent_gnn_policies_tpu_torch.ops.blocked import (
    FrameQuantities,
    blocked_frame,
    pick_block,
)
from multiagent_gnn_policies_tpu_torch.ops.graph import normalized_adjacency
from multiagent_gnn_policies_tpu_torch.utils import graphs
from multiagent_gnn_policies_tpu_torch.utils.config import ExperimentConfig
from multiagent_gnn_policies_tpu_torch.utils.graphs import WARMUP_STEPS

# Rows per block of the episode's O(N²) frames: the largest divisor of N up
# to this (a block's ~25 (rows, N) temporaries take ~400 MB at N = 4,096).
FRAME_BLOCK = 1024


def frame_block(n: int) -> int:
    """Largest divisor of ``n`` that is <= ``FRAME_BLOCK``."""
    return pick_block(n, FRAME_BLOCK)


def dense_adj_from_pos(pos: torch.Tensor, comm_radius: float) -> torch.Tensor:
    """The row-normalised radius-graph adjacency (..., N, N) of positions
    (..., N, 2): the env's ``observe`` network, rebuilt from an O(N)
    record. Squared distances come from elementwise differences, so every
    pair is on the side of the radius the env puts it on."""
    dx = pos[..., :, None, 0] - pos[..., None, :, 0]
    dy = pos[..., :, None, 1] - pos[..., None, :, 1]
    _, adj = _r2_adj(dx, dy, comm_radius)
    return normalized_adjacency(adj)


def actor_forward_adj(actor: Actor, hist: torch.Tensor,
                      adjs: torch.Tensor) -> torch.Tensor:
    """The actor with its delayed aggregation as chained transpose-applies:
    ``G_k^T h = A_{t-k+1}^T (... (A_t^T h))``.

    Args:
      hist: (..., K, N, S) raw feature history ``[x_t .. x_{t-K+1}]``.
      adjs: (..., K-1, N, N) normalised adjacencies, newest first
        (``adjs[..., 0, :, :] = A_t``).
    """
    def delayed(x):
        outs, v = [x[..., 0, :, :]], x[..., 1:, :, :]   # slots 1..K-1
        for s in range(x.shape[-3] - 1):
            # A_{t-s}^T to every slot not finished yet
            v = adjs[..., s, None, :, :].transpose(-1, -2) @ v
            outs.append(v[..., 0, :, :])
            v = v[..., 1:, :, :]
        return torch.stack(outs, -3)

    return actor.run(hist, delayed)


def critic_forward_adj(critic: Critic, states: torch.Tensor,
                       actions: torch.Tensor, adj: torch.Tensor
                       ) -> torch.Tensor:
    """The critic with the GSO powers ``[I, A, ..., A^{K-1}]`` applied as a
    chain of ``A^T`` products on the current adjacency ``adj`` (..., N,
    N)."""
    adj_t = adj.transpose(-1, -2)

    def powers(x):
        zs = [x]
        for _ in range(critic.cfg.k - 1):
            zs.append(adj_t @ zs[-1])
        return torch.stack(zs, -3)

    return critic.run(states, actions, powers)


def _shift_in(new: torch.Tensor, hist: torch.Tensor, k: int) -> torch.Tensor:
    """``[new, hist[0], ..., hist[k-2]]`` on the leading axis."""
    return torch.cat([new[None], hist[:k - 1]]) if k > 1 else new[None]


class DDPGLarge(DDPG):
    """DDPG on the positions record and graph-from-positions gradient
    steps (:mod:`algos.ddpg_large`)."""

    def _init_env(self) -> None:
        cfg = self.cfg
        self.env = None                    # the dense env is never built
        # the env as the config gives it, the id's variant not applied: the
        # JAX DDPGLarge steps, resets and evaluates cfg.env itself
        self.params: FlockingParams = cfg.env
        self.block = frame_block(cfg.env.n_agents)
        self._eval_prog: Optional[graphs.Program] = None

    def _example_record(self) -> Batch:
        cfg = self.cfg
        n, k, ns, na = (cfg.env.n_agents, cfg.actor.k, cfg.actor.n_s,
                        cfg.actor.n_a)
        z = lambda *shape: torch.zeros(shape, device=self.device)
        return {"hist": z(k, n, ns), "pos": z(max(k - 1, 1), n, 2),
                "next_values": z(n, ns), "next_pos": z(n, 2),
                "action": z(n, na), "reward": z(), "notdone": z()}

    # --- the gradient step on the positions record ---

    def _pi(self, actor, hist, adjs):
        return actor_forward_adj(actor, hist, adjs)

    def _q(self, critic, states, actions, adj):
        return critic_forward_adj(critic, states, actions, adj)

    def _graphs(self, batch: Batch):
        k, r = self.cfg.actor.k, self.cfg.env.comm_radius
        adjs = dense_adj_from_pos(batch["pos"], r)          # (B, K-1|1, N, N)
        a_next = dense_adj_from_pos(batch["next_pos"], r)   # (B, N, N)
        # s' holds [A_{t+1}, A_t, ..]; a K = 1 actor reads no graph
        n_adjs = (a_next[:, None] if k <= 2
                  else torch.cat([a_next[:, None], adjs[:, :k - 2]], 1))
        n_hist = torch.cat([batch["next_values"][:, None],
                            batch["hist"][:, :k - 1]], 1)
        return (batch["hist"], adjs, adjs[:, 0]), (n_hist, n_adjs, a_next)

    # --- episodes on the O(N) state ---

    def _frame(self, x: torch.Tensor) -> FrameQuantities:
        return blocked_frame(x, self.params, True, self.block)

    def reset(self, gen: torch.Generator):
        """An initial state (N, 4) and its frame: the lattice candidate, or
        below the lattice regime the first candidate with min separation
        and min degree met (the last of ``1 + max_resets`` otherwise)."""
        p = self.params
        x = _init_candidate(gen, p, self.device)
        fq = self._frame(x)
        if _lattice_regime(p):
            return x, fq
        for _ in range(p.max_resets):
            if bool((fq.min_r2 >= p.min_separation ** 2)
                    & (fq.degree.min() >= p.min_degree)):
                break
            x = _init_candidate(gen, p, self.device)
            fq = self._frame(x)
        return x, fq

    def _start(self, x0: Optional[torch.Tensor] = None):
        """State, feature history and graph positions at an episode's
        start (the reset's, or ``x0``'s): the delayed slots are zeros, so
        seeding their graph sources with the current positions changes
        nothing."""
        cfg = self.cfg
        with torch.no_grad():
            if x0 is None:
                x, fq = self.reset(self.gen)
            else:
                x = x0.to(self.device)
                fq = self._frame(x)
            k, n = cfg.actor.k, cfg.env.n_agents
            hist = _shift_in(fq.values, torch.zeros(
                (k, n, cfg.actor.n_s), device=self.device), k)
            pos = x[None, :, :2].expand(max(k - 1, 1), n, 2).clone()
        return x, hist, pos

    def _advance(self, x2, fq2, hist, pos):
        """The history and graph positions after a step to ``x2``."""
        k = self.cfg.actor.k
        if k > 1:
            pos = _shift_in(x2[:, :2], pos, k - 1)
        return _shift_in(fq2.values, hist, k), pos

    def _carry(self, start):
        return tuple(start)

    def _transition(self, carry, ou: torch.Tensor, gen):
        """One step of the O(N) state under ``clip(mu + ou_scale · ou,
        ±1)``: the next carry, the positions record and the reward."""
        cfg, p = self.cfg, self.params
        x, hist, pos = carry
        adjs = dense_adj_from_pos(pos, p.comm_radius)
        mu = actor_forward_adj(self.actor, hist, adjs)
        action = torch.clamp(mu + cfg.ou_scale * ou, -1.0, 1.0)
        x2 = dynamics(x, action, p, gen)
        fq2 = self._frame(x2)
        r = reward(x2)
        record = {"hist": hist, "pos": pos, "next_values": fq2.values,
                  "next_pos": x2[:, :2], "action": action, "reward": r,
                  "notdone": torch.ones((), device=self.device)}
        return (x2, *self._advance(x2, fq2, hist, pos)), record, r

    def _greedy_steps(self, start, gen, total: torch.Tensor,
                      steps: int) -> None:
        """``steps`` greedy steps from :meth:`_start`'s tensors, the policy
        clipped to ±1, each reward added into ``total`` in place."""
        p = self.params
        x, hist, pos = start
        with torch.no_grad():
            for _ in range(steps):
                adjs = dense_adj_from_pos(pos, p.comm_radius)
                act = torch.clamp(actor_forward_adj(self.actor, hist, adjs),
                                  -1.0, 1.0)
                x = dynamics(x, act, p, gen)
                fq = self._frame(x)
                hist, pos = self._advance(x, fq, hist, pos)
                total += reward(x)

    def _eval_program(self) -> graphs.Program:
        """The eval episode's steps as one program (its summed reward the
        static output), reading the learner's actor by address; made at
        its first use."""
        if self._eval_prog is None:
            self._eval_prog = graphs.Program(
                self.device, self.params.dynamics_noise > 0,
                [torch.zeros((), device=self.device)])
        return self._eval_prog

    def eval_rewards(self) -> np.ndarray:
        """Summed rewards of ``n_test_episodes`` greedy episodes run one
        after another (a batch would multiply the O(N²) peak), the
        policy's output clipped to ±1: each reset eager, its steps through
        :meth:`_eval_program` (the eager loop with ``graph=False``)."""
        T = self.params.episode_steps
        prog = None if self._graph is False else self._eval_program()

        def body(gen, steps):
            prog.outputs[0].zero_()
            self._greedy_steps(prog.inputs, gen, prog.outputs[0], steps)

        out = []
        for _ in range(self.cfg.n_test_episodes):
            start = self._start()
            if prog is None:
                total = torch.zeros((), device=self.device)
                self._greedy_steps(start, self.gen, total, T)
            else:
                prog.run(start, self.gen, lambda gen: body(gen, T),
                         lambda gen: body(gen, min(WARMUP_STEPS, T)))
                total = prog.outputs[0].clone()
            out.append(total)
        return torch.stack(out).cpu().numpy()


def train_ddpg_large(cfg: ExperimentConfig, logger=None, save_path=None,
                     state_path=None, checkpoint_every=0,
                     device="cuda") -> dict:
    learner = DDPGLarge(DDPGConfig.from_experiment(cfg), logger, device)
    return learner.train(save_path, state_path, checkpoint_every)
