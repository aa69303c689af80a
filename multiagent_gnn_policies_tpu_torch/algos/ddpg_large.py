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
output to ±1. Losses, the gradient step, the OU process, resume and
export are the dense learner's (``algos/ddpg.py``).

The products are float32 ``torch.matmul`` calls (cuBLAS on the card, TF32
off); the JAX package computes them with XLA outside any Pallas kernel.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.algos.ddpg import (
    DDPG,
    DDPGConfig,
    Batch,
    _sync,
    ou_reset,
    ou_step,
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
from multiagent_gnn_policies_tpu_torch.utils.config import ExperimentConfig

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
        if x0 is None:
            x, fq = self.reset(self.gen)
        else:
            x = x0.to(self.device)
            fq = self._frame(x)
        k, n = cfg.actor.k, cfg.env.n_agents
        hist = _shift_in(fq.values, torch.zeros((k, n, cfg.actor.n_s),
                                                device=self.device), k)
        pos = x[None, :, :2].expand(max(k - 1, 1), n, 2).clone()
        return x, hist, pos

    def _advance(self, x2, fq2, hist, pos):
        """The history and graph positions after a step to ``x2``."""
        k = self.cfg.actor.k
        if k > 1:
            pos = _shift_in(x2[:, :2], pos, k - 1)
        return _shift_in(fq2.values, hist, k), pos

    def episode(self, x0: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                indices: Optional[torch.Tensor] = None):
        """One training episode (see ``DDPG.episode``; ``x0``, ``noise``
        and ``indices`` replace the reset, the OU draws and the replay
        samples in tests)."""
        cfg = self.cfg
        p, dev = self.params, self.device
        t0 = time.perf_counter()
        with torch.no_grad():
            x, hist, pos = self._start(x0)
        ou = ou_reset(cfg.env.n_agents, cfg.actor.n_a, dev)
        one = torch.ones((), device=dev)
        zero = torch.zeros((), device=dev)
        total, c_total, a_total = zero, zero, zero
        for t in range(p.episode_steps):
            with torch.no_grad():
                adjs = dense_adj_from_pos(pos, p.comm_radius)
                ou = ou_step(ou, self.gen, cfg.ou_theta, cfg.ou_sigma,
                             None if noise is None else noise[t])
                mu = actor_forward_adj(self.actor, hist, adjs)
                action = torch.clamp(mu + cfg.ou_scale * ou, -1.0, 1.0)
                x2 = dynamics(x, action, p, self.gen)
                fq2 = self._frame(x2)
                r = reward(x2)
                record = {"hist": hist, "pos": pos,
                          "next_values": fq2.values, "next_pos": x2[:, :2],
                          "action": action, "reward": r, "notdone": one}
                self.buffer.insert({k: v[None] for k, v in record.items()})
                hist, pos = self._advance(x2, fq2, hist, pos)
                x = x2
            losses = self._updates(None if indices is None else indices[t])
            total = total + r
            if losses is not None:
                c_total, a_total = c_total + losses[0], a_total + losses[1]
        _sync(dev)
        self.timing["s"] += time.perf_counter() - t0
        self.timing["steps"] += p.episode_steps
        return total, c_total, a_total

    def eval_rewards(self) -> np.ndarray:
        """Summed rewards of ``n_test_episodes`` greedy episodes run one
        after another (a batch would multiply the O(N²) peak), the
        policy's output clipped to ±1."""
        p = self.params
        out = []
        with torch.no_grad():
            for _ in range(self.cfg.n_test_episodes):
                x, hist, pos = self._start()
                total = torch.zeros((), device=self.device)
                for _ in range(p.episode_steps):
                    adjs = dense_adj_from_pos(pos, p.comm_radius)
                    act = torch.clamp(
                        actor_forward_adj(self.actor, hist, adjs), -1.0, 1.0)
                    x = dynamics(x, act, p, self.gen)
                    fq = self._frame(x)
                    hist, pos = self._advance(x, fq, hist, pos)
                    total = total + reward(x)
                out.append(total)
        return torch.stack(out).cpu().numpy()


def train_ddpg_large(cfg: ExperimentConfig, logger=None, save_path=None,
                     state_path=None, checkpoint_every=0,
                     device="cuda") -> dict:
    learner = DDPGLarge(DDPGConfig.from_experiment(cfg), logger, device)
    return learner.train(save_path, state_path, checkpoint_every)
