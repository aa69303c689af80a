"""Cloning and DAGGER at large N (N = 32,768 and up), on one device or a
mesh.

The counterpart of the JAX package's ``algos/imitation_large.py``. The
dense learner's (K, N, N) graph state cannot hold a swarm of this size, so
a round here collects through the O(N) cell sweeps of
``parallel/large_n.py`` and stores an agent subsample:

* **Collection** runs :func:`collect_step` T times: as one
  ``EpisodeProgram`` of ``parallel/large_n.py`` on every path, on one
  device or banded over a mesh (CUDA graphs on the card, the JAX
  package's ``lax.scan``, under ``shard_map`` on a mesh; the mesh's
  collectives captured with it), else as a Python loop
  (``graph=False``). Each step
  takes the delayed stack ``y`` (K3 in ``ystack_pre``), the frame's
  expert (K1's gradient channels and the float64 consensus), the action
  (the expert when cloning; the expert where the episode's per-step coin
  ``rand < beta`` falls, else the policy, when DAGGER), the record ``{agg: y[:, idx], act: expert[idx]}``
  of ``store_agents`` agents drawn uniformly with replacement, the env
  step, and the new frame with the next step's s = 0 apply (K1 and K2).
  A K = 3 episode of T steps launches K1 T+1 times and K2 and K3 T times
  each, as an evaluation episode does. Collection always uses the
  centralized expert, whatever the config says, as the JAX package does.
* **Agent-subsampled replay**: a record is (K, S, F) features and (S, 2)
  labels. With ``ind_agg == 0`` the policy is per-agent in its own
  pre-aggregated rows, so the MSE over a uniform subsample is unbiased,
  and the canonical buffer (10,000 records of S = 4,096) takes 3.28 GB
  against 26.2 GB for whole-swarm records.
* **Updates, resume, schedule and export** are the dense learner's
  (``algos/imitation.py``): ``updates_per_episode · n_rollout_envs`` Adam
  updates a round once the buffer holds more than one batch, as the
  update program's replays (a CUDA graph on the card, at this learner's
  (K, S, F) record), on one device and on a mesh alike.
* **Exactness gate**: a round whose collection dropped a radius neighbour
  (grid overflow > 0) raises before anything is stored, and an eval
  episode with overflow or a non-finite reward raises. On a mesh the
  round's overflow (and an eval episode's fault) is reduced with MAX over
  every rank first, so that every rank raises together rather than one
  alone while the others wait in their next collective.
* **Mesh modes** (``mesh``, a ``parallel.mesh.make_mesh`` of every rank,
  each on its own device): the sweeps of every episode are banded over
  the ``agents`` axis (``parallel/large_n.py``; a mesh of n_env = 1 is the
  JAX package's ``('agents',)`` mesh), and the round's E =
  ``n_rollout_envs`` episodes are split over the ``env`` axis: env group g
  collects episodes ``[g·E/n_env, (g+1)·E/n_env)`` (n_agents = 1 is the
  JAX ``('env',)`` mesh, both axes its ``('env', 'agents')``). The records
  are gathered over ``env`` in episode order; the buffer insert and the
  Adam updates run replicated on every rank, with no gradient collective.
  Evaluation is ``rollout_large(mesh=)``. The collection and eval
  episodes run as their episode programs on the mesh too, and the
  overflow gate's MAX over the mesh waits on the host once per round,
  after the episodes, as the JAX gate does. Every rank's parameters equal
  the one-process learner's (bit for bit on the same grid:
  ``make_pcell_spec(n_dev=)`` rounds the grid's rows to the agents axis).

The port's default is the "pcells" path at every N: ``graph_path`` "auto"
and "pcells" run it, "blocked" runs the O(N²) row-blocked sweeps of
``ops/blocked.py``, "cells" the dense cell grid of ``ops/cells.py`` (cap
``cell_cap`` or 12) and "binned" the spatial-hash neighbour list of
``ops/binned.py`` (cap 32, as the JAX learner's); none of the last three
launches a cell kernel.

Random draws: the learner's one device generator draws the actor's init,
the replay samples, the eval resets and, at the start of each round,
``n_rollout_envs`` seeds in one call; episode e of the round runs on its
own generator seeded with seed e (the JAX package's ``jax.random.split``
of the round's key), drawing its reset, then all its coins, then its (T,
S) indices, one call each, and the stochastic variant's noise. So a rank
can run any episode of the round, and a resumed run continues the same
stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multiagent_gnn_policies_tpu_torch.algos.imitation import (
    ImitationConfig,
    ImitationLearner,
)
from multiagent_gnn_policies_tpu_torch.envs.flocking import ENV_REGISTRY
from multiagent_gnn_policies_tpu_torch.models.actor import ActorConfig
from multiagent_gnn_policies_tpu_torch.parallel import large_n as ln
from multiagent_gnn_policies_tpu_torch.parallel.mesh import axis_group
from multiagent_gnn_policies_tpu_torch.utils.config import ExperimentConfig

@dataclasses.dataclass(frozen=True)
class LargeNImitationConfig(ImitationConfig):
    """:class:`ImitationConfig` and the large-N collection settings.

    Attributes:
      store_agents: agents per stored replay record (a uniform subsample
        with replacement; 0 = all agents, only sensible at small N).
      graph_path: "auto" or "pcells" (the cell sweeps), "blocked" (the
        O(N²) row-blocked sweeps), "cells" (the dense cell grid) or
        "binned" (the spatial-hash neighbour list).
      cell_margin / cell_cap / cell_edge_mult: the cell grid
        (``make_pcell_spec``; ``cell_cap`` 0 = 16; on the cells path
        ``make_cell_spec``, 0 = 12, no edge multiple; the binned path
        takes 32 slots per cell run whatever they say).
    """

    store_agents: int = 4096
    graph_path: str = "auto"
    cell_margin: float = 1.3
    cell_cap: int = 0
    cell_edge_mult: float = 1.0

    @classmethod
    def from_experiment(cls, x: ExperimentConfig, mode: Optional[str] = None
                        ) -> "LargeNImitationConfig":
        """Build from an INI-backed :class:`ExperimentConfig`;
        ``store_agents`` 0 becomes ``min(N, 4096)``, and it is capped at N."""
        base = ImitationConfig.from_experiment(x, mode=mode)
        s = x.store_agents or min(x.n_agents, 4096)
        return cls(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(base)},
            store_agents=min(s, x.n_agents),
            graph_path=x.graph_path,
            cell_cap=x.cell_cap,
            cell_margin=x.cell_margin,
            cell_edge_mult=x.cell_edge_mult,
        )


def collect_step(cfg: ln.LargeNConfig, actor: Optional[torch.nn.Module],
                 state: ln.EpisodeState, gen: Optional[torch.Generator],
                 sel: torch.Tensor, coin: Optional[torch.Tensor] = None):
    """One collecting env step: the expert's action, or with a DAGGER
    ``coin`` () bool the expert's where it falls and else the policy's on
    the delayed stack ``y`` (K, N, F). Returns ``(state', reward, y[:,
    sel] (K, S, F), the expert's actions at sel (S, 2))``: the subsample
    ``sel`` (S,) recorded before the step. The eager loop of
    :func:`collect_episode` and its episode program both run it."""
    y = ln._ystack(cfg, state)
    expert = state.fq.expert
    act = expert if coin is None else torch.where(coin, expert, actor(y))
    agg, label = y[:, sel], expert[sel]
    state2, r = ln._advance(cfg, state, act, gen)
    return state2, r, agg, label


def collection_program(cfg: ln.LargeNConfig, acfg: ActorConfig, mode: str,
                       s_store: int, device) -> ln.EpisodeProgram:
    """The cached ``EpisodeProgram`` of :func:`collect_episode`'s steps:
    :func:`collect_step` with the subsample (S,) and, for DAGGER, the coin
    () as per-step inputs, and the (K, S, F) and (S, 2) records."""
    s = s_store
    return ln.episode_program(
        cfg, acfg, cfg.params.episode_steps, device, step=collect_step,
        inputs=((((s,), torch.int64),) if mode == "cloning" else
                (((s,), torch.int64), ((), torch.bool))),
        records=((acfg.k, s, acfg.n_s), (s, acfg.n_a)))


def collect_episode(cfg: ln.LargeNConfig, actor: torch.nn.Module,
                    acfg: ActorConfig, mode: str, s_store: int,
                    gen: Optional[torch.Generator], beta: float, device,
                    x0: Optional[torch.Tensor] = None,
                    coins: Optional[torch.Tensor] = None,
                    idx: Optional[torch.Tensor] = None, graph=None):
    """One collecting episode of ``cfg.params.episode_steps`` steps of
    :func:`collect_step`.

    ``mode`` is "cloning" (expert actions) or "dagger" (per step, the
    expert's action where the coin falls, else the policy's). ``cfg``
    must compute the expert (``need_expert``). Returns ``(samples, reward,
    overflow)``: ``samples`` holds per step the subsampled features
    ``"agg"`` (T, K, S, F) and expert actions ``"act"`` (T, S, 2),
    ``reward`` is the episode's summed reward and ``overflow`` its max
    grid overflow, both () on the device. ``x0`` (N, 4), ``coins`` (T,)
    bool and ``idx`` (T, S) replace the reset's, the coins' and the
    subsample's draws, for tests. ``graph`` as ``rollout_large``'s: by
    default the steps run as the setup's ``EpisodeProgram`` on every
    path, on one device or banded over ``cfg``'s mesh (CUDA graphs on the
    card with the mesh's collectives in them; the coins and indices drawn
    before them as here and copied in per chunk of steps, the records
    written in static buffers per chunk, copied out after the episode),
    else the eager loop below.
    """
    p = cfg.params
    T = p.episode_steps
    device = torch.device(device)
    program = ln.use_program(device, graph)
    with torch.no_grad():
        state = ln._episode_init(cfg, acfg, gen, device, x0)
        if mode == "dagger" and coins is None:
            coins = torch.rand(T, generator=gen, device=device) < beta
        if idx is None:
            idx = torch.randint(0, p.n_agents, (T, s_store), generator=gen,
                                device=device)
        inputs = (idx,) if mode == "cloning" else (idx, coins)
        if program:
            prog = collection_program(cfg, acfg, mode, idx.shape[1], device)
            state = prog.run(state, actor, gen, inputs=inputs)
            agg, act = (r.clone() for r in prog.records)
            return ({"agg": agg, "act": act}, prog.rewards.sum(),
                    state.overflow.clone())
        aggs, acts, rewards = [], [], []
        for t in range(T):
            state, r, agg, act = collect_step(cfg, actor, state, gen,
                                              *(x[t] for x in inputs))
            aggs.append(agg)
            acts.append(act)
            rewards.append(r)
    samples = {"agg": torch.stack(aggs), "act": torch.stack(acts)}
    return samples, torch.stack(rewards).sum(), state.overflow


class LargeNImitationLearner(ImitationLearner):
    """Cloning/DAGGER trainer at large N: cell-sweep collection and an
    agent-subsampled buffer, everything else the dense learner's. With
    ``mesh``, the mesh modes of the module docstring: ``axis`` names the
    mesh axis the sweeps are banded over. ``graph`` as the dense
    learner's: by default its Adam updates run as the update program and
    its collection and eval episodes as their episode programs, on every
    path, on one device or a mesh (CUDA graphs on the card);
    ``graph=False`` runs every loop eagerly; ``graph=True`` raises
    ValueError on the CPU."""

    def __init__(self, cfg: LargeNImitationConfig, logger=None,
                 device="cuda", mesh=None, axis: str = "agents", graph=None):
        if cfg.graph_path != "auto" and cfg.graph_path not in ln.PATHS:
            raise ValueError(f"unknown graph_path {cfg.graph_path!r}")
        if cfg.actor.ind_agg != 0 or cfg.actor.k < 2:
            raise ValueError("the large-N learner needs ind_agg == 0, "
                             "k >= 2")
        if mesh is not None:
            self._env_axis = axis_group(mesh, "env")
            if cfg.n_rollout_envs % self._env_axis.n_dev:
                raise ValueError(
                    f"n_rollout_envs={cfg.n_rollout_envs} must divide evenly "
                    f"over the mesh env axis ({self._env_axis.n_dev})")
        self.mesh, self.axis = mesh, axis
        path = "pcells" if cfg.graph_path == "auto" else cfg.graph_path
        # the JAX learner's binned table has 32 slots whatever cell_cap is
        self._cap = None if path == "binned" else cfg.cell_cap or None
        # collection acts on the centralized expert, as the JAX learner's
        self._lcfg = ln.make_config(
            ENV_REGISTRY[cfg.env_name](cfg.env), path=path,
            cap=self._cap, cell_margin=cfg.cell_margin,
            cell_edge_mult=cfg.cell_edge_mult, centralized=True,
            need_expert=True, mesh=mesh, axis=axis)
        super().__init__(cfg, logger, device, graph)

    @property
    def store_agents(self) -> int:
        return self.cfg.store_agents or self.cfg.env.n_agents

    def _example_record(self) -> Dict[str, torch.Tensor]:
        a, s = self.cfg.actor, self.store_agents
        return {"agg": torch.zeros((a.k, s, a.n_s), device=self.device),
                "act": torch.zeros((s, a.n_a), device=self.device)}

    def _mesh_max(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` reduced in place with MAX over every rank of the mesh (the
        default group: ``make_mesh`` covers every rank); ``t`` itself
        without a mesh."""
        if self.mesh is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def _episode_generators(self):
        """The round's episode generators, this rank's slice of them: all
        ``n_rollout_envs`` seeds are drawn from the learner's generator in
        one call, on every rank."""
        e = self.cfg.n_rollout_envs
        seeds = torch.randint(0, 2**62, (e,), generator=self.gen,
                              device=self.device).tolist()
        if self._env_axis is not None:
            local = e // self._env_axis.n_dev
            start = self._env_axis.index * local
            seeds = seeds[start:start + local]
        return [torch.Generator(device=self.device).manual_seed(s)
                for s in seeds]

    def _collect(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """This rank's episodes of the round, one after another; raises on
        every rank if any step of any rank's episodes overflowed (the host
        waits here, as the JAX learner's gate does)."""
        cfg = self.cfg
        runs = [collect_episode(self._lcfg, self.actor, cfg.actor, cfg.mode,
                                self.store_agents, gen, self._beta,
                                self.device, graph=self._graph)
                for gen in self._episode_generators()]
        ovf = int(self._mesh_max(
            torch.stack([o for _, _, o in runs]).max().reshape(1)))
        if ovf:
            raise RuntimeError(
                f"neighbor-structure overflow={ovf} during collection: the "
                f"episode dropped radius neighbors (a cell over capacity or "
                f"an agent outside the grid); raise cell_margin or cell_cap. "
                f"Training on a truncated graph is invalid.")
        samples = {k: torch.cat([s[k] for s, _, _ in runs])
                   for k in runs[0][0]}
        return samples, torch.stack([r for _, r, _ in runs])

    def evaluate(self) -> Tuple[float, float]:
        """Mean and population std of ``n_test_episodes`` greedy episodes
        through ``rollout_large`` (on the mesh, when there is one), one
        after another; raises on an episode with grid overflow or a
        non-finite reward."""
        cfg = self.cfg
        rewards = []
        for _ in range(cfg.n_test_episodes):
            r, _, ovf = ln.rollout_large(
                self.actor, cfg.actor, self.gen, self._lcfg.params,
                cap=self._cap, cell_margin=cfg.cell_margin,
                cell_edge_mult=cfg.cell_edge_mult, return_overflow=True,
                device=self.device, path=self._lcfg.path, mesh=self.mesh,
                axis=self.axis, graph=self._graph)
            tot = r.sum()
            bad = self._mesh_max(torch.stack([
                ovf.to(tot.dtype), (~torch.isfinite(tot)).to(tot.dtype)]))
            tot, ovf = float(tot), int(ovf)
            if bool(bad.any()):
                raise RuntimeError(f"eval episode overflow={ovf} reward="
                                   f"{tot}: invalid rollout, refusing to "
                                   f"score it")
            rewards.append(tot)
        return float(np.mean(rewards)), float(np.std(rewards))


def train_dagger_large(cfg: ExperimentConfig, logger=None, save_path=None,
                       state_path=None, checkpoint_every=0,
                       device="cuda") -> dict:
    learner = LargeNImitationLearner(
        LargeNImitationConfig.from_experiment(cfg, mode="dagger"), logger,
        device)
    return learner.train(save_path, state_path, checkpoint_every)


def train_cloning_large(cfg: ExperimentConfig, logger=None, save_path=None,
                        state_path=None, checkpoint_every=0,
                        device="cuda") -> dict:
    learner = LargeNImitationLearner(
        LargeNImitationConfig.from_experiment(cfg, mode="cloning"), logger,
        device)
    return learner.train(save_path, state_path, checkpoint_every)
