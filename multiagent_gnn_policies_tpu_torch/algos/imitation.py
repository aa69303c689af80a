"""Behaviour cloning and DAGGER on the dense N = 100 path.

The counterpart of the JAX package's ``algos/imitation.py``. One training
round collects ``n_rollout_envs`` episodes as one batch of envs (env step,
expert, delayed graph state, policy, DAGGER coin), writes them into the
replay buffer on the device, and then runs ``updates_per_step`` Adam
updates per episode. The host waits on the device only where the JAX
learner fetches a value: once per reset block, at the round's timing
points, and where an eval is read.

What the JAX learner compiles into one program runs as CUDA graphs on
the card: the T steps behind an episode's reset
(:class:`DenseEpisodeProgram`, one per static setup, cached; the reset
and the DAGGER coins stay eager; a data-parallel rank's slice of the
envs too) and one Adam update with its replay sample
(:class:`UpdateProgram`, one per learner, replayed once per update; a
mesh learner's update with its gradient ``all_reduce`` in it), and the
trajectory dump's steps (:class:`TrajectoryProgram`).
Each equals its eager loop (``graph=False``) bit for bit; on the CPU
each runs its body eagerly.

Semantics kept:
  * DAGGER: a per-step expert coin per episode with probability ``beta``;
    the expert's action is stored as the label whatever the coin says;
    ``beta <- max(beta * beta_coeff, 0.5)`` per episode, the 0.5 floor
    included;
  * cloning: expert-only rollouts; evals every ``test_interval`` episodes;
    cloning returns the best eval's stats, DAGGER the final eval's;
  * updates start once the buffer holds more than one batch; MSE over all
    elements; Adam with ``actor_lr`` (``torch.optim.Adam``'s defaults are
    ``optax.adam``'s: betas 0.9 / 0.999, eps 1e-8 outside the square root);
  * the buffer stores the delayed features pre-aggregated,
    ``delay_gso^T · delay_state`` (the actor aggregates before its first
    layer, ``ind_agg = 0``).

The metric events are the JAX learner's (``eval``, ``final_eval``,
``resume``, with its fields), plus one ``timing`` event after
``final_eval``: rollout ms per env step, ms per Adam update and env steps
per second.

Random draws come from one ``torch.Generator`` on the device, seeded from
``seed``: the actor's init, every reset, coin and replay sample, and the
stochastic variant's noise. Its state is part of the training state, so a
resumed run continues the same stream.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiagent_gnn_policies_tpu_torch.algos.replay import ReplayBuffer
from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    EnvState,
    FlockingEnv,
    FlockingParams,
    Obs,
    make_env,
    strict_fp32,
)
from multiagent_gnn_policies_tpu_torch.models.actor import (
    Actor,
    ActorConfig,
    init_actor_,
)
from multiagent_gnn_policies_tpu_torch.models.torch_import import (
    actor_numpy_from_params,
)
from multiagent_gnn_policies_tpu_torch.ops.graph import (
    aggregate,
    initial_graph_state,
    update_graph_state,
)
from multiagent_gnn_policies_tpu_torch.parallel.distributed import (
    process_info,
)
from multiagent_gnn_policies_tpu_torch.utils import checkpoint, graphs
from multiagent_gnn_policies_tpu_torch.utils.config import ExperimentConfig
from multiagent_gnn_policies_tpu_torch.utils.debug import check_finite
from multiagent_gnn_policies_tpu_torch.utils.graphs import (
    PROGRAMS_KEPT,
    WARMUP_STEPS,
)
from multiagent_gnn_policies_tpu_torch.utils.metrics import MetricsLogger


@dataclasses.dataclass(frozen=True)
class ImitationConfig:
    """Static configuration of an imitation run."""

    mode: str                    # 'dagger' | 'cloning'
    actor: ActorConfig
    env_name: str
    env: FlockingParams
    batch_size: int = 20
    buffer_size: int = 10000
    updates_per_episode: int = 200
    actor_lr: float = 5e-5
    n_train_episodes: int = 400
    beta_coeff: float = 0.993
    beta_floor: float = 0.5
    test_interval: int = 40
    n_test_episodes: int = 20
    n_rollout_envs: int = 1
    seed: int = 11
    # include the replay buffer in training-state checkpoints: True
    # resumes bit for bit; False writes a small file and a resumed run
    # starts with an empty buffer, which the next round refills
    checkpoint_buffer: bool = True

    @classmethod
    def from_experiment(cls, x: ExperimentConfig, mode: Optional[str] = None,
                        k: Optional[int] = None) -> "ImitationConfig":
        """Build from an INI-backed :class:`ExperimentConfig`; ``k``
        overrides its filter length (transfer evaluation across K)."""
        actor = ActorConfig(n_s=x.n_states, n_a=x.n_actions, hidden=x.hidden,
                            k=k or x.k, ind_agg=0)
        env = FlockingParams(n_agents=x.n_agents, comm_radius=x.comm_radius,
                             dt=x.dt, v_max=x.v_max,
                             episode_steps=x.episode_steps)
        return cls(
            mode=(mode or x.alg), actor=actor, env_name=x.env, env=env,
            batch_size=x.batch_size, buffer_size=x.buffer_size,
            updates_per_episode=x.updates_per_step, actor_lr=x.actor_lr,
            n_train_episodes=x.n_train_episodes, beta_coeff=x.beta_coeff,
            test_interval=x.test_interval, n_test_episodes=x.n_test_episodes,
            n_rollout_envs=x.n_rollout_envs, seed=x.seed,
            checkpoint_buffer=x.checkpoint_buffer,
        )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


MODES = ("eval", "cloning", "dagger", "expert")


def _episode_steps(env: FlockingEnv, actor, acfg: Optional[ActorConfig],
                   mode: str, state: EnvState, obs, coins, gen,
                   total: torch.Tensor, collect: bool, centralized: bool,
                   steps: int):
    """``steps`` env steps of :func:`rollout_episode` from ``state`` and
    its observation ``obs``, each step's reward added into ``total`` in
    place. Returns the per-step pre-aggregated features and expert actions
    (empty lists without ``collect``). The eager loop and the episode
    program both run it."""
    gs = (None if mode == "expert"
          else initial_graph_state(obs.values, obs.network, acfg.k))
    # an actor that aggregates past its first layer (DDPG's, ind_agg > 0)
    # reads the delayed pair itself
    inner = acfg is not None and acfg.ind_agg > 0
    aggs, acts = [], []
    for t in range(steps):
        agg = (None if gs is None or inner
               else aggregate(gs.delay_gso, gs.delay_state))
        if mode == "eval":
            act = (actor(gs.delay_state, gs.delay_gso) if inner
                   else actor(agg))
            expert = None
        else:
            expert = env.controller(state, centralized)
            act = (torch.where(coins[t][:, None, None], expert, actor(agg))
                   if mode == "dagger" else expert)
        state, obs, r, _ = env.step(state, act, gen)
        if gs is not None:
            gs = update_graph_state(gs, obs.values, obs.network)
        total += r
        if collect:
            aggs.append(agg)
            acts.append(expert)
    return aggs, acts


class DenseEpisodeProgram(graphs.Program):
    """The ``T`` steps behind a dense episode's reset, for one static setup
    (env, actor widths, mode, ``n_envs``, ``collect``, ``centralized``), as
    one CUDA graph: the counterpart of the JAX package's ``lax.scan`` of
    ``rollout_episode`` (vmapped inside ``_round_impl``, and
    ``_eval_impl``) and of the baseline's jitted episode.

    The graph reads static inputs, copied in before each replay: the
    initial states (E, N, 4), their observation, DAGGER's coins (T, E),
    and its own copy of the actor's parameters. It writes static outputs:
    the summed rewards (E,) and, with ``collect``, the records
    ``agg`` (E, T, K, N, F) and ``act`` (E, T, N, n_a), valid until the
    next run. On the CPU the same body runs eagerly over the static
    buffers with the caller's generator and actor. On the card the first
    run warms the body up for ``WARMUP_STEPS`` steps (it overwrites only
    the outputs, which every run rewrites), then captures; the stochastic
    variant's noise comes from the program's own generator, handed over
    as ``utils/graphs.py`` says. ``DenseEpisodeProgram.captures`` counts
    the captures of the process (``graphs.Program.captures`` counts them
    with every other program's)."""

    captures = 0

    def __init__(self, env: FlockingEnv, acfg: Optional[ActorConfig],
                 mode: str, n_envs: int, collect: bool, centralized: bool,
                 device):
        super().__init__(device, env.params.dynamics_noise > 0)
        self.env, self.acfg, self.mode = env, acfg, mode
        self.collect, self.centralized = collect, centralized
        dev, p = self.device, env.params
        self.rewards = torch.zeros(n_envs, device=dev)
        self.agg = self.act = None
        if collect:
            self.agg = torch.zeros((n_envs, p.episode_steps, acfg.k,
                                    p.n_agents, acfg.n_s), device=dev)
            self.act = torch.zeros((n_envs, p.episode_steps, p.n_agents,
                                    acfg.n_a), device=dev)
        self._actor = None

    def _body(self, actor, gen, steps: int) -> None:
        x, *rest = self.inputs
        obs = None if self.mode == "expert" else Obs(*rest[:2])
        coins = rest[-1] if self.mode == "dagger" else None
        self.rewards.zero_()
        aggs, acts = _episode_steps(
            self.env, actor, self.acfg, self.mode, EnvState(x, 0), obs,
            coins, gen, self.rewards, self.collect, self.centralized, steps)
        if self.collect:
            torch.stack(aggs, 1, out=self.agg[:, :steps])
            torch.stack(acts, 1, out=self.act[:, :steps])

    def run(self, x: torch.Tensor, obs: Optional[Obs],
            coins: Optional[torch.Tensor], actor: Optional[torch.nn.Module],
            gen: Optional[torch.Generator]) -> None:
        """One episode from the states ``x`` (E, N, 4) and their
        observation ``obs`` (None for the expert), with DAGGER's ``coins``
        (T, E): its outputs in ``rewards``, ``agg`` and ``act``."""
        if actor is None and self.mode in ("eval", "dagger"):
            raise ValueError(f"a {self.mode} episode needs an actor")
        steps = self.env.params.episode_steps
        inputs = [x, *(obs or ()), *(() if coins is None else (coins,))]
        with torch.no_grad():
            if self.device.type == "cuda":
                if self.mode in ("eval", "dagger"):
                    self._actor = graphs.actor_copy(self._actor, actor)
                actor = self._actor
            captures = graphs.Program.captures
            super().run(
                inputs, gen, lambda g: self._body(actor, g, steps),
                lambda g: self._body(actor, g, min(WARMUP_STEPS, steps)))
            DenseEpisodeProgram.captures += graphs.Program.captures - captures


@functools.lru_cache(maxsize=PROGRAMS_KEPT)
def dense_program(env: FlockingEnv, acfg: Optional[ActorConfig], mode: str,
                  n_envs: int, collect: bool, centralized: bool,
                  device: torch.device) -> DenseEpisodeProgram:
    """The :class:`DenseEpisodeProgram` of this static setup, made at its
    first use and kept (``device`` with its index)."""
    return DenseEpisodeProgram(env, acfg, mode, n_envs, collect, centralized,
                               device)


def rollout_episode(actor: Optional[Actor], gen: Optional[torch.Generator],
                    beta, env: FlockingEnv, acfg: Optional[ActorConfig], *,
                    mode: str, collect: bool = True, n_envs: int = 1,
                    x0: Optional[torch.Tensor] = None,
                    coins: Optional[torch.Tensor] = None,
                    centralized: bool = True, graph=None):
    """``n_envs`` episodes of ``episode_steps`` steps, run as one batch.

    ``mode`` is "eval" (greedy policy; an actor with ``ind_agg > 0``,
    DDPG's, reads the delayed pair), "cloning" (expert actions),
    "dagger" (per step and episode, the expert's action where the coin
    ``rand < beta`` falls, else the policy's) or "expert" (the analytic
    expert, ``centralized`` or not, with no graph state and no records:
    the baseline's episode; ``actor`` and ``acfg`` may be None). Returns
    ``(samples, rewards)``, where ``samples`` holds per step the
    pre-aggregated delayed features ``"agg"`` ``(n_envs·T, K, N, F)`` and
    the expert action ``"act"`` ``(n_envs·T, N, n_a)``, episode-major, and
    ``rewards`` is each episode's summed reward ``(n_envs,)``; with
    ``collect=False`` only the rewards. ``x0`` ``(n_envs, N, 4)`` replaces
    the reset's draw (and sets ``n_envs``) and ``coins`` ``(T, n_envs)``
    the coin draws, for tests.

    The reset (whose rejection loop waits on the host once per candidate
    block) and the coins run eagerly; the steps run as the setup's cached
    :class:`DenseEpisodeProgram` (``graph`` None: a CUDA graph on the
    card, its body eagerly on the CPU; a data-parallel rank's slice of the
    envs, ``env.env_range``, is part of the setup), or as the eager loop
    with ``graph=False`` (the program's oracle); ``graph=True`` asks for
    the CUDA graph and raises ValueError on the CPU.
    """
    if mode not in MODES:
        raise ValueError(f"unknown episode mode {mode!r}; known: {MODES}")
    if collect and mode in ("eval", "expert"):
        raise ValueError(f"a {mode} episode collects no records")
    T = env.params.episode_steps
    with torch.no_grad():
        if x0 is None:
            state, obs = env.reset(gen, (n_envs,))
        else:
            state = EnvState(x0, 0)
            obs = env.observe(state)
            n_envs = x0.shape[0]
        device = state.x.device
        if mode == "dagger" and coins is None:
            coins = torch.rand((T, n_envs), generator=gen,
                               device=device) < beta
        if mode != "dagger":
            coins = None
        if mode == "expert":
            acfg = actor = obs = None
        program = graphs.use_program(device, graph, None, "the episode",
                                     "the card")
        if program:
            prog = dense_program(env, acfg, mode, n_envs, collect,
                                 centralized, graphs.device_of(device))
            prog.run(state.x, obs, coins,
                     None if mode == "cloning" else actor, gen)
            total = prog.rewards.clone()
            if collect:
                samples = {"agg": prog.agg.flatten(0, 1).clone(),
                           "act": prog.act.flatten(0, 1).clone()}
        else:
            total = torch.zeros(n_envs, device=device)
            aggs, acts = _episode_steps(
                env, actor, acfg, mode, state, obs, coins, gen, total,
                collect, centralized, T)
            if collect:
                samples = {"agg": torch.stack(aggs, 1).flatten(0, 1),
                           "act": torch.stack(acts, 1).flatten(0, 1)}
    if not collect:
        return total
    return samples, total


def _trajectory_steps(env: FlockingEnv, actor, acfg: ActorConfig,
                      state: EnvState, obs: Obs, gen, steps: int):
    """``steps`` greedy env steps of :func:`rollout_trajectory` from
    ``state`` and its observation: the lists of the states (N, 4) and
    rewards () after each step. The eager loop and the trajectory program
    both run it."""
    gs = initial_graph_state(obs.values, obs.network, acfg.k)
    xs, rewards = [], []
    for _ in range(steps):
        act = actor(aggregate(gs.delay_gso, gs.delay_state))
        state, obs, r, _ = env.step(state, act, gen)
        gs = update_graph_state(gs, obs.values, obs.network)
        xs.append(state.x)
        rewards.append(r)
    return xs, rewards


class TrajectoryProgram(graphs.Program):
    """The ``T`` greedy steps of :func:`rollout_trajectory` behind its
    eager reset, for one static setup (env, actor widths), as one CUDA
    graph: the counterpart of the JAX CLI's jitted trajectory scan. It
    reads the static initial state (N, 4), its observation and its own
    copy of the actor's parameters, and writes the static states ``xs``
    (T, N, 4) and ``rewards`` (T,), valid until the next run. On the CPU
    the same body runs eagerly with the caller's generator and actor; on
    the card the first run warms the body up for ``WARMUP_STEPS`` steps
    (it overwrites only the outputs), then captures; the stochastic
    variant's noise comes from the program's own generator, handed over
    as ``utils/graphs.py`` says."""

    captures = 0

    def __init__(self, env: FlockingEnv, acfg: ActorConfig, device):
        super().__init__(device, env.params.dynamics_noise > 0)
        self.env, self.acfg = env, acfg
        p = env.params
        self.xs = torch.zeros((p.episode_steps, p.n_agents, 4),
                              device=self.device)
        self.rewards = torch.zeros(p.episode_steps, device=self.device)
        self._actor = None

    def _body(self, actor, gen, steps: int) -> None:
        x, values, network = self.inputs
        xs, rewards = _trajectory_steps(self.env, actor, self.acfg,
                                        EnvState(x, 0), Obs(values, network),
                                        gen, steps)
        torch.stack(xs, out=self.xs[:steps])
        torch.stack(rewards, out=self.rewards[:steps])

    def run(self, x: torch.Tensor, obs: Obs, actor: torch.nn.Module,
            gen: Optional[torch.Generator]) -> None:
        """One episode from the state ``x`` (N, 4) and its observation:
        its states and rewards in ``xs`` and ``rewards``."""
        steps = self.env.params.episode_steps
        with torch.no_grad():
            if self.device.type == "cuda":
                actor = self._actor = graphs.actor_copy(self._actor, actor)
            captures = graphs.Program.captures
            super().run(
                [x, *obs], gen, lambda g: self._body(actor, g, steps),
                lambda g: self._body(actor, g, min(WARMUP_STEPS, steps)))
            TrajectoryProgram.captures += graphs.Program.captures - captures


@functools.lru_cache(maxsize=PROGRAMS_KEPT)
def trajectory_program(env: FlockingEnv, acfg: ActorConfig,
                       device: torch.device) -> TrajectoryProgram:
    """The :class:`TrajectoryProgram` of this static setup, made at its
    first use and kept (``device`` with its index)."""
    return TrajectoryProgram(env, acfg, device)


def rollout_trajectory(actor: Actor, gen: Optional[torch.Generator],
                       env: FlockingEnv, acfg: ActorConfig,
                       x0: Optional[torch.Tensor] = None, graph=None):
    """One greedy episode of one env that records its states: ``(xs (T, N,
    4), rewards (T,))``, the state and reward after each step (the
    visualisation dump of ``evaluate --save-trajectory``). ``x0`` (N, 4)
    replaces the reset's draw, for tests. The reset runs eagerly; the
    steps run as the setup's cached :class:`TrajectoryProgram` (``graph``
    None: a CUDA graph on the card, its body eagerly on the CPU), or as
    the eager loop with ``graph=False`` (the program's oracle);
    ``graph=True`` asks for the CUDA graph and raises ValueError on the
    CPU."""
    with torch.no_grad():
        if x0 is None:
            state, obs = env.reset(gen)
        else:
            state = EnvState(x0, 0)
            obs = env.observe(state)
        device = state.x.device
        if graphs.use_program(device, graph, None, "the trajectory",
                              "the card"):
            prog = trajectory_program(env, acfg, graphs.device_of(device))
            prog.run(state.x, obs, actor, gen)
            return prog.xs.clone(), prog.rewards.clone()
        xs, rewards = _trajectory_steps(env, actor, acfg, state, obs, gen,
                                        env.params.episode_steps)
    return torch.stack(xs), torch.stack(rewards)


def adam_update(actor: Actor, opt: torch.optim.Optimizer,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One Adam step on the MSE between the policy's action on
    ``batch["agg"]`` and ``batch["act"]``; returns the (detached) loss."""
    loss = F.mse_loss(actor(batch["agg"]), batch["act"])
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


class UpdateProgram:
    """A learner's Adam update, ``replay sample -> update -> loss_sum +=
    loss`` (``update``, the learner's own, on ``buffer.sample``:
    :func:`adam_update`'s forward, MSE, backward and Adam by default, or a
    mesh learner's with its rows of the batch and its gradient
    ``all_reduce``), as one CUDA
    graph replayed once per update: the counterpart of the JAX learners'
    ``lax.scan`` of updates (``_round_impl``, re-jitted over the mesh by
    ``parallel/sharded.py``).

    The graph reads the actor's parameters, Adam's state (``opt`` must be
    built with ``capturable=True``) and the buffer by address; all are
    updated or loaded in place, so a replay costs no copy. The sample
    masks with the buffer's device size, so the buffer may grow between
    rounds. Each update adds its loss into the static ``loss_sum``. On
    the CPU the same body runs eagerly with the caller's generator. On
    the card the first run warms the body up for ``WARMUP_STEPS`` updates
    (Adam allocates its state lazily, cuBLAS its workspace), restores the
    parameters and Adam's state in place (zeros at step 0 where Adam had
    none yet), drops every gradient so that the captured backward
    allocates its own, then captures (a mesh learner's collectives are
    issued by the warm-up's updates first, ``utils/graphs.capture``).
    The samples come from the program's own generator, handed over around
    a run's replays as ``utils/graphs.py`` says. ``UpdateProgram.captures``
    counts the captures of the process."""

    captures = 0

    def __init__(self, actor: Actor, opt: torch.optim.Optimizer,
                 buffer: ReplayBuffer, batch: int, device, update=None):
        self.update = update or functools.partial(adam_update, actor, opt)
        self.actor, self.opt = actor, opt
        self.buffer, self.batch = buffer, batch
        self.device = graphs.device_of(device)
        self.loss_sum = torch.zeros((), device=self.device)
        self._gen = graphs.program_generator(self.device, True)
        self._graph = None
        self.capture_s = self.instantiate_s = self.pool_mb = None
        self.nodes = None

    def _body(self, gen: torch.Generator) -> None:
        self.loss_sum += self.update(self.buffer.sample(gen, self.batch))

    def run(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """``n`` updates drawing their samples from ``gen``; returns their
        summed loss."""
        if self.device.type == "cuda" and self._graph is None:
            self._capture()
        self.loss_sum.zero_()
        if self.device.type != "cuda":
            for _ in range(n):
                self._body(gen)
        else:
            with graphs.generator_handover(self._gen, gen, self.device):
                for _ in range(n):
                    self._graph.replay()
        return self.loss_sum.clone()

    def _capture(self) -> None:
        def warmup():
            saved = graphs.Snapshot(list(self.actor.parameters()), [self.opt])
            for _ in range(WARMUP_STEPS):
                self._body(self._gen)
            saved.restore()

        (self._graph, self.capture_s, self.instantiate_s, self.pool_mb,
         self.nodes) = graphs.capture(
            self.device, warmup, lambda: self._body(self._gen), self._gen)
        UpdateProgram.captures += 1


class ImitationLearner:
    """Cloning/DAGGER trainer: owns the actor, Adam, the buffer and the
    generator, all on ``device``.

    ``graph``: None (default) runs the round's loops as programs, on one
    device or a mesh: the collection and eval episodes as their
    :class:`DenseEpisodeProgram` and the Adam updates as the learner's
    :class:`UpdateProgram` over its own :meth:`_update` (CUDA graphs on
    the card, a mesh's collectives captured in them, their bodies eagerly
    on the CPU); False the eager loops (the programs' oracle); True the
    programs, raising ValueError on the CPU.

    On a mesh (a subclass sets ``mesh`` and ``_env_axis`` before this
    class's ``__init__``) every rank holds the same actor, Adam state,
    buffer and generator: it collects its slice of the round's episodes
    (:meth:`_collect`), the records are gathered over the ``env`` axis in
    episode order (:meth:`_gather_envs`, eager, after the episode), and
    each update is :meth:`_update`. Only rank 0 writes files and metrics;
    every rank
    reads a state file on resume, and a barrier follows each write."""

    mesh = None                 # the DeviceMesh of a mesh learner
    _env_axis = None            # the mesh's "env" AxisGroup

    def __init__(self, cfg: ImitationConfig,
                 logger: Optional[MetricsLogger] = None, device="cuda",
                 graph=None):
        if cfg.mode not in ("dagger", "cloning"):
            raise ValueError(f"unknown imitation mode {cfg.mode!r}")
        strict_fp32()
        self.cfg = cfg
        self.device = torch.device(device)
        self.env = make_env(cfg.env_name, cfg.env)
        self.logger = (logger if logger and self._writes_files()
                       else MetricsLogger())
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(cfg.seed)
        self.actor = init_actor_(Actor(cfg.actor).to(self.device), self.gen)
        # capturable: Adam's step count and bias correction on the device,
        # so that an update can be captured (PyTorch allows it on the card
        # only); the eager loop on the card steps the same optimizer
        self.opt = torch.optim.Adam(self.actor.parameters(), lr=cfg.actor_lr,
                                    capturable=self.device.type == "cuda")
        self.buffer = ReplayBuffer(cfg.buffer_size, self._example_record())
        programs = graphs.use_program(self.device, graph, None, "the round",
                                      "the card")
        # what the round's episodes are given: None runs their programs
        self._graph = None if programs else False
        # over the learner's own update (a mesh learner's collective in it)
        self._updates = (UpdateProgram(
            self.actor, self.opt, self.buffer, cfg.batch_size, self.device,
            self._update) if programs else None)
        # training-loop state (checkpointed, see training_state())
        self._rnd = 0
        self._beta = 1.0
        self._best = {"mean": -np.inf, "std": 0.0, "params": None}
        self.last_loss_sum: Optional[torch.Tensor] = None
        # cumulative wall seconds of the rounds' two halves
        self.timing = {"rollout_s": 0.0, "rollout_steps": 0,
                       "update_s": 0.0, "updates": 0}

    def _example_record(self) -> Dict[str, torch.Tensor]:
        """One replay record, shaped as the buffer stores it: the (K, N, F)
        pre-aggregated features and the (N, n_a) expert action."""
        n, a = self.cfg.env.n_agents, self.cfg.actor
        return {"agg": torch.zeros((a.k, n, a.n_s), device=self.device),
                "act": torch.zeros((n, a.n_a), device=self.device)}

    # --- the round's hooks (the mesh learners override them) ---

    def _collect(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """This rank's episodes of the round (all ``n_rollout_envs`` of them
        without a mesh): their records, episode by episode, and each
        episode's summed reward, on the device."""
        cfg = self.cfg
        return rollout_episode(
            self.actor, self.gen, self._beta, self.env, cfg.actor,
            mode=cfg.mode, n_envs=cfg.n_rollout_envs, graph=self._graph)

    def _gather_envs(self, samples: Dict[str, torch.Tensor],
                     rewards: torch.Tensor):
        """The whole round's records and rewards from this rank's: gathered
        over the ``env`` axis in rank order, which is episode order (the
        identity without an ``env`` axis)."""
        ax = self._env_axis
        if ax is None:
            return samples, rewards
        return ({k: ax.all_gather(v) for k, v in samples.items()},
                ax.all_gather(rewards))

    def _update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One Adam update on a replay batch; returns its loss."""
        return adam_update(self.actor, self.opt, batch)

    def _round(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One training round: collect, insert, update. Returns the mean
        episode reward and the round's loss sum, on the device."""
        cfg = self.cfg
        n_envs = cfg.n_rollout_envs
        t0 = time.perf_counter()
        samples, rewards = self._gather_envs(*self._collect())
        self.buffer.insert(samples)
        ep_reward = rewards.mean()
        _sync(self.device)
        t1 = time.perf_counter()
        loss_sum = torch.zeros((), device=self.device)
        n_up = 0
        if self.buffer.size > cfg.batch_size:
            n_up = cfg.updates_per_episode * n_envs
            if self._updates is not None:
                loss_sum = self._updates.run(n_up, self.gen)
            else:
                for _ in range(n_up):
                    loss_sum += self._update(
                        self.buffer.sample(self.gen, cfg.batch_size))
        _sync(self.device)
        t2 = time.perf_counter()
        self.timing["rollout_s"] += t1 - t0
        self.timing["rollout_steps"] += cfg.env.episode_steps * n_envs
        self.timing["update_s"] += t2 - t1
        self.timing["updates"] += n_up
        self.last_loss_sum = loss_sum
        return ep_reward, loss_sum

    def eval_rewards(self) -> np.ndarray:
        """The summed rewards of ``n_test_episodes`` greedy episodes, run
        as one batch."""
        rewards = rollout_episode(
            self.actor, self.gen, 0.0, self.env, self.cfg.actor, mode="eval",
            collect=False, n_envs=self.cfg.n_test_episodes, graph=self._graph)
        return rewards.cpu().numpy()

    def evaluate(self) -> Tuple[float, float]:
        """Mean and population std of :meth:`eval_rewards`."""
        r = self.eval_rewards()
        return float(r.mean()), float(r.std())

    def timing_summary(self) -> Dict[str, float]:
        """Rollout ms per env step, ms per Adam update and env steps per
        second of the rounds run so far."""
        t = self.timing
        return {
            "rollout_ms_per_step":
                1e3 * t["rollout_s"] / max(t["rollout_steps"], 1),
            "update_ms_per_update": 1e3 * t["update_s"] / max(t["updates"], 1),
            "env_steps_per_s": t["rollout_steps"] / max(
                t["rollout_s"] + t["update_s"], 1e-9),
        }

    # --- full training state: checkpoint and resume ---

    def _opt_tree(self) -> dict:
        return checkpoint.adam_state_tree(self.actor.parameters(), self.opt)

    def training_state(self) -> dict:
        """Everything a resume needs: params, Adam, the replay buffer
        (unless ``checkpoint_buffer`` is off), the generator, the loop
        counters and the best eval."""
        best = self._best["params"]
        params = dict(self.actor.state_dict())
        buf = {}
        if self.cfg.checkpoint_buffer:
            buf = {"buffer": {**self.buffer.data,
                              "size": np.int64(self.buffer.size),
                              "cursor": np.int64(self.buffer.cursor)}}
        return {
            **buf,
            "params": params,
            "opt_state": self._opt_tree(),
            "generator": self.gen.get_state(),
            "round": np.int64(self._rnd),
            "beta": np.float64(self._beta),
            "best_mean": np.float64(self._best["mean"]),
            "best_std": np.float64(self._best["std"]),
            "has_best": np.bool_(best is not None),
            "best_params": best if best is not None else params,
        }

    # --- files: rank 0 writes, a barrier follows ---

    def _writes_files(self) -> bool:
        return self.mesh is None or process_info()[0] == 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            torch.distributed.barrier()

    def save_training_state(self, path: str) -> None:
        # a checkpoint holding NaN would resume into a poisoned run
        check_finite(dict(self.actor.state_dict()), "params")
        check_finite(self._opt_tree(), "opt_state")
        if self._writes_files():
            checkpoint.save_tree(path, self.training_state())
        self._barrier()

    def load_training_state(self, path: str) -> None:
        st = checkpoint.load_tree(path, self.training_state())
        as_t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
        self.actor.load_state_dict(as_t(st["params"]))
        checkpoint.load_adam_state_tree(self.opt, st["opt_state"])
        if self.cfg.checkpoint_buffer:
            b = st["buffer"]
            for k, d in self.buffer.data.items():
                d.copy_(torch.from_numpy(b[k]))
            self.buffer.size, self.buffer.cursor = int(b["size"]), int(
                b["cursor"])
        # else: resume with the empty buffer; the next round refills it
        self.gen.set_state(torch.from_numpy(st["generator"]))
        self._rnd = int(st["round"])
        self._beta = float(st["beta"])
        self._best = {
            "mean": float(st["best_mean"]),
            "std": float(st["best_std"]),
            "params": ({k: v.to(self.device)
                        for k, v in as_t(st["best_params"]).items()}
                       if bool(st["has_best"]) else None),
        }

    def export_actor(self, save_path: str,
                     params: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Write the actor (or ``params``) as ``save_path + ".npz"``, which
        both packages read, and as a reference-layout torch state_dict at
        ``save_path``."""
        if self._writes_files():
            layers = actor_numpy_from_params(
                params if params is not None else self.actor.state_dict(),
                self.cfg.actor)
            checkpoint.save_actor_npz(save_path + ".npz", layers)
            checkpoint.save_actor_torch_format(save_path, layers)
        self._barrier()

    def train(self, save_path: Optional[str] = None,
              state_path: Optional[str] = None, checkpoint_every: int = 0,
              stop_after: Optional[int] = None) -> dict:
        """Run (or resume) the training loop.

        Args:
          save_path: final (DAGGER) or best (cloning) actor export.
          state_path: training-state file; loaded at entry when it exists
            (resume), written every ``checkpoint_every`` rounds and at exit.
          checkpoint_every: rounds between state saves (0 = at exit only).
          stop_after: return after this many rounds in all, with the state
            saved (when ``state_path``) and ``interrupted=True``; a later
            call resumes bit for bit.
        """
        cfg = self.cfg
        if state_path and os.path.exists(state_path):
            self.load_training_state(state_path)
            self.logger.log("resume", round=self._rnd, beta=self._beta)
        episodes_per_round = cfg.n_rollout_envs
        n_rounds = max(1, cfg.n_train_episodes // episodes_per_round)
        steps_per_round = cfg.env.episode_steps * episodes_per_round

        while self._rnd < n_rounds:
            if stop_after is not None and self._rnd >= stop_after:
                if state_path:
                    self.save_training_state(state_path)
                return {"mean": self._best["mean"], "std": self._best["std"],
                        "interrupted": True}
            rnd = self._rnd
            episode = rnd * episodes_per_round
            if cfg.mode == "dagger":
                # anneal per episode: a round of n_rollout_envs episodes
                # advances the schedule by that many episodes
                self._beta = max(
                    self._beta * cfg.beta_coeff ** episodes_per_round,
                    cfg.beta_floor)
            t0 = time.perf_counter()
            ep_reward, loss_sum = self._round()
            self._rnd = rnd + 1

            if episode % cfg.test_interval < episodes_per_round:
                dt_round = time.perf_counter() - t0
                mean, std = self.evaluate()
                self.logger.log(
                    "eval", episode=episode, steps=self._rnd * steps_per_round,
                    reward_mean=mean, reward_std=std, beta=self._beta,
                    policy_loss_sum=float(loss_sum),
                    rollout_reward=float(ep_reward),
                    round_s=dt_round,
                    env_steps_per_s=steps_per_round / dt_round,
                )
                if mean > self._best["mean"]:
                    self._best = {"mean": mean, "std": std, "params": {
                        k: v.detach().clone()
                        for k, v in self.actor.state_dict().items()}}
            if (state_path and checkpoint_every
                    and self._rnd % checkpoint_every == 0):
                self.save_training_state(state_path)

        final_mean, final_std = self.evaluate()
        self.logger.log("final_eval", reward_mean=final_mean,
                        reward_std=final_std)
        self.logger.log("timing", **self.timing_summary())
        if state_path:
            self.save_training_state(state_path)

        if cfg.mode == "cloning" and self._best["params"] is not None:
            # cloning reports (and keeps) the best eval
            stats = {"mean": self._best["mean"], "std": self._best["std"]}
            save_params = self._best["params"]
        else:
            # DAGGER reports the final eval
            stats = {"mean": final_mean, "std": final_std}
            save_params = None
        if save_path:
            self.export_actor(save_path, save_params)
        return stats


def train_dagger(cfg: ExperimentConfig, logger=None, save_path=None,
                 state_path=None, checkpoint_every=0, device="cuda") -> dict:
    learner = ImitationLearner(
        ImitationConfig.from_experiment(cfg, mode="dagger"), logger, device)
    return learner.train(save_path, state_path, checkpoint_every)


def train_cloning(cfg: ExperimentConfig, logger=None, save_path=None,
                  state_path=None, checkpoint_every=0, device="cuda") -> dict:
    learner = ImitationLearner(
        ImitationConfig.from_experiment(cfg, mode="cloning"), logger, device)
    return learner.train(save_path, state_path, checkpoint_every)
