"""DDPG with a delayed-aggregation actor and a centralized GNN critic, on
the dense path (N up to a few hundred agents).

The counterpart of the JAX package's ``algos/ddpg.py``:

* Ornstein–Uhlenbeck exploration noise per agent and action dimension
  (:func:`ou_step`); the executed action is ``clip(mu + ou_scale · ou,
  -1, 1)``;
* the actor aggregates halfway (``ind_agg = len(hidden) // 2``) over the
  delayed GSO; the critic applies the current GSO powers at every layer;
* target networks with a Polyak update after every gradient step
  (:func:`soft_update_`); Adam on both networks;
* ``updates_per_step`` gradient steps inside every env step, once the
  buffer holds more than one batch (``size`` is a host int, so the gate
  never waits on the device: an episode's gate opens at a step the host
  knows before the episode, :meth:`DDPG._gate_opens`);
* a gradient step (:meth:`DDPG.gradient_step`): the critic's Adam step on
  the MSE to ``y = reward_scale · r + gamma · notdone · Q'(s', pi'(s'))``,
  then the actor's Adam step on ``-mean Q(s, pi(s))`` against the critic
  just updated (its gradient reaches the actor only), then Polyak on both
  targets;
* the replay record is compact: ``delay_state``, ``delay_gso``,
  ``network``, ``next_network``, ``next_values``, ``action``, ``reward``
  and ``notdone``; a gradient step rebuilds both states' GSO powers and
  the next delayed pair from it (``ops/graph.py``).

An eval (:func:`eval_episodes`) runs ``n_test_episodes`` greedy episodes
as one batch and passes the policy's output to the env as it is (the env
clips it to ``max_accel``).

What the JAX learner compiles into one program runs as CUDA graphs on one
card: a training episode's T steps behind its reset, the gradient steps
included, as one graph per step at which the update gate opens
(:meth:`DDPG._run_program`, at most three per run), and an eval's steps
behind its batched reset as the dense episode program of
``algos/imitation.py``. The resets stay eager (their rejection loop waits
on the host). Each equals its eager loop (``graph=False``) bit for bit;
on the CPU each runs its body eagerly.

Random draws come from one ``torch.Generator`` on the device, seeded from
``seed``: the actor's and the critic's init, every reset, the OU noise,
the replay samples and the evals. Its state is part of the training state,
so a resumed run continues the same stream and equals the uninterrupted
one bit for bit.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.algos.imitation import rollout_episode
from multiagent_gnn_policies_tpu_torch.algos.replay import ReplayBuffer
from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    EnvState,
    FlockingEnv,
    FlockingParams,
    make_env,
    strict_fp32,
)
from multiagent_gnn_policies_tpu_torch.models.actor import (
    Actor,
    ActorConfig,
    init_actor_,
)
from multiagent_gnn_policies_tpu_torch.models.critic import (
    Critic,
    CriticConfig,
    init_critic_,
)
from multiagent_gnn_policies_tpu_torch.models.torch_import import (
    actor_numpy_from_params,
    critic_numpy_from_params,
)
from multiagent_gnn_policies_tpu_torch.ops.graph import (
    delayed_gso_update,
    gso_powers,
    history_shift,
    initial_graph_state,
    update_graph_state,
)
from multiagent_gnn_policies_tpu_torch.utils import checkpoint, graphs
from multiagent_gnn_policies_tpu_torch.utils.config import ExperimentConfig
from multiagent_gnn_policies_tpu_torch.utils.debug import check_finite
from multiagent_gnn_policies_tpu_torch.utils.graphs import (
    PROGRAMS_KEPT,
    WARMUP_STEPS,
)
from multiagent_gnn_policies_tpu_torch.utils.metrics import MetricsLogger

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """Static configuration of a DDPG run (the JAX package's)."""

    actor: ActorConfig
    critic: CriticConfig
    env_name: str
    env: FlockingParams
    batch_size: int = 100
    buffer_size: int = 10000
    updates_per_step: int = 1
    actor_lr: float = 1e-5
    critic_lr: float = 1e-4
    gamma: float = 0.99
    tau: float = 0.5
    n_train_episodes: int = 200
    test_interval: int = 10
    n_test_episodes: int = 10
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    ou_scale: float = 1.0
    reward_scale: float = 1.0       # scales the reward in the TD target only
    seed: int = 8

    @classmethod
    def from_experiment(cls, x: ExperimentConfig) -> "DDPGConfig":
        """From an INI-backed :class:`ExperimentConfig`. The env takes five
        fields of it (n_agents, comm_radius, dt, v_max, episode_steps);
        every other ``FlockingParams`` field keeps its default. The
        section's ``test_interval`` is not read: DDPG evaluates every 10
        episodes, as the JAX package's and the reference's DDPG do."""
        hidden = x.hidden
        actor = ActorConfig(n_s=x.n_states, n_a=x.n_actions, hidden=hidden,
                            k=x.k, ind_agg=len(hidden) // 2,
                            bound=x.policy_bound)
        critic = CriticConfig(n_s=x.n_states, n_a=x.n_actions, hidden=hidden,
                              k=x.k, use_groupnorm=x.critic_gn,
                              input_transform=x.critic_input)
        env = FlockingParams(n_agents=x.n_agents, comm_radius=x.comm_radius,
                             dt=x.dt, v_max=x.v_max,
                             episode_steps=x.episode_steps)
        return cls(
            actor=actor, critic=critic, env_name=x.env, env=env,
            batch_size=x.batch_size, buffer_size=x.buffer_size,
            updates_per_step=x.updates_per_step, gamma=x.gamma, tau=x.tau,
            actor_lr=x.ddpg_actor_lr or cls.actor_lr,
            critic_lr=x.ddpg_critic_lr or cls.critic_lr,
            reward_scale=x.reward_scale,
            n_train_episodes=x.n_train_episodes,
            n_test_episodes=x.n_test_episodes, seed=x.seed,
        )


def ou_reset(n_agents: int, n_a: int, device=None) -> torch.Tensor:
    """The OU process's start, zeros (N, n_a)."""
    return torch.zeros((n_agents, n_a), device=device)


def ou_step(x: torch.Tensor, gen: Optional[torch.Generator], theta: float,
            sigma: float, noise: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """``x + theta · (0 - x) + sigma · n`` with ``n`` standard normal, drawn
    from ``gen`` unless ``noise`` gives it (tests)."""
    if noise is None:
        noise = torch.randn(x.shape, generator=gen, device=x.device)
    return x + (theta * (0.0 - x) + sigma * noise)


def soft_update_(target: torch.nn.Module, source: torch.nn.Module,
                 tau: float) -> None:
    """Polyak, in place: ``target <- (1 - tau) · target + tau · source``."""
    with torch.no_grad():
        t = list(target.parameters())
        torch._foreach_mul_(t, 1.0 - tau)
        torch._foreach_add_(t, list(source.parameters()), alpha=tau)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eval_episodes(actor: Actor, env: FlockingEnv, acfg: ActorConfig,
                  gen: torch.Generator, n_episodes: int,
                  graph=None) -> torch.Tensor:
    """The summed rewards (n_episodes,) of greedy episodes run as one
    batch; the policy's output goes to the env unclipped. The batched
    reset runs eagerly, the steps as ``rollout_episode``'s eval: the
    setup's dense episode program (``graph`` None: a CUDA graph on the
    card, its body on the CPU), the eager loop with ``graph=False``;
    ``graph=True`` raises ValueError on the CPU."""
    return rollout_episode(actor, gen, 0.0, env, acfg, mode="eval",
                           collect=False, n_envs=n_episodes, graph=graph)


class DDPG:
    """The dense DDPG learner: actor, critic, their targets and Adam
    states, the replay buffer and the generator, all on ``device``.

    ``graph``: None (default) runs each training episode's steps through
    its training-episode program (:meth:`_run_program`) and each eval's
    through its episode program (CUDA graphs on the card, their bodies
    eagerly on the CPU); False the eager loops (the programs' oracle);
    True the programs, raising ValueError on the CPU."""

    def __init__(self, cfg: DDPGConfig, logger: Optional[MetricsLogger] = None,
                 device="cuda", graph=None):
        strict_fp32()
        self.cfg = cfg
        self.device = torch.device(device)
        self.logger = logger or MetricsLogger()
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(cfg.seed)
        self.actor = init_actor_(Actor(cfg.actor).to(self.device), self.gen)
        self.critic = init_critic_(Critic(cfg.critic).to(self.device),
                                   self.gen)
        # hard copies at init; the targets never take a gradient
        self.actor_target = copy.deepcopy(self.actor).requires_grad_(False)
        self.critic_target = copy.deepcopy(self.critic).requires_grad_(False)
        # capturable: Adam's step count and bias correction on the device,
        # so that a gradient step can be captured (PyTorch allows it on the
        # card only); the eager loop on the card steps the same optimizers
        capturable = self.device.type == "cuda"
        self.actor_opt = torch.optim.Adam(self.actor.parameters(),
                                          lr=cfg.actor_lr,
                                          capturable=capturable)
        self.critic_opt = torch.optim.Adam(self.critic.parameters(),
                                           lr=cfg.critic_lr,
                                           capturable=capturable)
        self._init_env()
        self.buffer = ReplayBuffer(cfg.buffer_size, self._example_record())
        programs = graphs.use_program(self.device, graph, None,
                                      "the DDPG episode", "one device")
        # what the episodes are given: None runs their programs
        self._graph = None if programs else False
        # the training episode's programs by (gate step, injected noise,
        # injected indices), the least recently used first
        self._programs: Dict[tuple, graphs.Program] = (
            collections.OrderedDict())
        self._ep = 0
        # the last training episode's summed reward and losses (device)
        self.last_episode: Optional[Dict[str, torch.Tensor]] = None
        # cumulative wall seconds of the training episodes, each env step
        # with its gradient steps
        self.timing = {"s": 0.0, "steps": 0, "updates": 0}

    def _init_env(self) -> None:
        self.env = make_env(self.cfg.env_name, self.cfg.env)

    def _example_record(self) -> Batch:
        cfg = self.cfg
        n, k, ns, na = (cfg.env.n_agents, cfg.actor.k, cfg.actor.n_s,
                        cfg.actor.n_a)
        z = lambda *shape: torch.zeros(shape, device=self.device)
        return {"delay_state": z(k, n, ns), "delay_gso": z(k, n, n),
                "network": z(n, n), "next_network": z(n, n),
                "next_values": z(n, ns), "action": z(n, na),
                "reward": z(), "notdone": z()}

    # --- the gradient step ---

    def _pi(self, actor, hist, graph):
        return actor(hist, graph)

    def _q(self, critic, states, actions, graph):
        return critic(states, actions, graph)

    def _graphs(self, batch: Batch):
        """``(hist, actor graph, critic graph)`` of s and of s' from the
        compact record: the delayed GSOs and the current GSO powers."""
        k = self.cfg.actor.k
        now = (batch["delay_state"], batch["delay_gso"],
               gso_powers(batch["network"], k))
        nxt = (history_shift(batch["delay_state"], batch["next_values"]),
               delayed_gso_update(batch["next_network"], batch["delay_gso"]),
               gso_powers(batch["next_network"], k))
        return now, nxt

    def gradient_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One critic step, one actor step against the updated critic and
        Polyak on both targets. Returns the critic's and the actor's loss
        (detached, on the device)."""
        cfg = self.cfg
        (hist, g_actor, g_critic), (n_hist, n_actor, n_critic) = (
            self._graphs(batch))
        values = hist[:, 0]                    # x_t is delay slot 0
        with torch.no_grad():
            q_next = self._q(self.critic_target, batch["next_values"],
                             self._pi(self.actor_target, n_hist, n_actor),
                             n_critic)
            y = (cfg.reward_scale * batch["reward"][:, None]
                 + cfg.gamma * batch["notdone"][:, None] * q_next)

        q = self._q(self.critic, values, batch["action"], g_critic)
        c_loss = torch.mean((q - y) ** 2)
        self.critic_opt.zero_grad(set_to_none=True)
        c_loss.backward()
        self.critic_opt.step()

        pi = self._pi(self.actor, hist, g_actor)
        a_loss = -torch.mean(self._q(self.critic, values, pi, g_critic))
        params = list(self.actor.parameters())
        # the actor's gradient only: the critic's grads stay as its step
        # left them
        for p, g in zip(params, torch.autograd.grad(a_loss, params)):
            p.grad = g
        self.actor_opt.step()

        soft_update_(self.actor_target, self.actor, cfg.tau)
        soft_update_(self.critic_target, self.critic, cfg.tau)
        return c_loss.detach(), a_loss.detach()

    def _batch(self, gen, indices: Optional[torch.Tensor], t: int,
               u: int) -> Batch:
        """Step ``t``'s ``u``-th replay batch: drawn from ``gen``, or the
        records ``indices[t, u]`` names (tests)."""
        if indices is None:
            return self.buffer.sample(gen, self.cfg.batch_size)
        return self.buffer.gather(indices[t, u])

    # --- episodes ---

    def _start(self, x0: Optional[torch.Tensor] = None):
        """The tensors an episode starts from, the reset's (drawn from the
        learner's generator) or ``x0``'s: the state (N, 4) and its
        observation's values and network."""
        with torch.no_grad():
            if x0 is None:
                state, obs = self.env.reset(self.gen)
            else:
                state = EnvState(x0.to(self.device), 0)
                obs = self.env.observe(state)
        return state.x, obs.values, obs.network

    def _carry(self, start):
        """The step loop's carry at the episode's start."""
        x, values, network = start
        return EnvState(x, 0), initial_graph_state(values, network,
                                                   self.cfg.actor.k)

    def _transition(self, carry, ou: torch.Tensor, gen):
        """One env step under ``clip(mu + ou_scale · ou, ±1)``: the next
        carry, the step's replay record and its reward."""
        cfg = self.cfg
        state, gs = carry
        mu = self.actor(gs.delay_state, gs.delay_gso)
        action = torch.clamp(mu + cfg.ou_scale * ou, -1.0, 1.0)
        state, obs, r, done = self.env.step(state, action, gen)
        # done depends on the step index alone (a host int), so a capture
        # of the whole episode records each step's notdone as it is
        record = {"delay_state": gs.delay_state, "delay_gso": gs.delay_gso,
                  "network": gs.network, "next_network": obs.network,
                  "next_values": obs.values, "action": action, "reward": r,
                  "notdone": torch.full((), 0.0 if done else 1.0,
                                        device=self.device)}
        return (state, update_graph_state(gs, obs.values, obs.network)), \
            record, r

    def _steps(self, start, gen, gate, insert, sums: torch.Tensor,
               noise: Optional[torch.Tensor] = None,
               indices: Optional[torch.Tensor] = None,
               steps: Optional[int] = None) -> int:
        """A training episode's ``steps`` (all T by default) from
        :meth:`_start`'s tensors: per step the OU step, the transition, its
        record stored by ``insert`` and, where ``gate(t)`` holds once it
        is stored, the step's ``updates_per_step`` gradient steps, drawing
        from ``gen``; the reward and both losses are added into ``sums``
        (3,) in place. ``noise`` (T, N, n_a) and ``indices`` (T,
        updates_per_step, B) replace the OU draws and the replay samples
        (tests). Returns the number of steps that updated. The eager loop
        and the training-episode program both run it."""
        cfg = self.cfg
        with torch.no_grad():
            carry = self._carry(start)
            ou = ou_reset(cfg.env.n_agents, cfg.actor.n_a, self.device)
        opened = 0
        for t in range(cfg.env.episode_steps if steps is None else steps):
            with torch.no_grad():
                ou = ou_step(ou, gen, cfg.ou_theta, cfg.ou_sigma,
                             None if noise is None else noise[t])
                carry, record, r = self._transition(carry, ou, gen)
                insert({k: v[None] for k, v in record.items()})
                sums[0] += r
            if gate(t):
                losses = [torch.stack(self.gradient_step(
                    self._batch(gen, indices, t, u)))
                    for u in range(cfg.updates_per_step)]
                sums[1:] += torch.stack(losses).sum(0)
                opened += 1
        return opened

    def _gate_opens(self) -> int:
        """The first step of the next episode that runs gradient steps:
        the gate ``size > batch_size`` opens once ``batch_size - size + 1``
        more records are stored (T: not in this episode; never while the
        capacity is at most one batch)."""
        cfg, b = self.cfg, self.buffer
        T = cfg.env.episode_steps
        if b.capacity <= cfg.batch_size:
            return T
        return min(max(cfg.batch_size - b.size, 0), T)

    def _run_program(self, start, noise, indices, t_open: int
                     ) -> torch.Tensor:
        """The episode's steps from ``start`` through the training-episode
        program of its gate step ``t_open`` (and of injected draws): the
        counterpart of the JAX ``_episode_impl``'s scan, its
        ``lax.cond`` on the buffer's size resolved on the host. Each key's
        program is made at its first use and kept (PROGRAMS_KEPT, least
        recently used out). Returns the summed reward and losses (3,).

        The graph reads the reset's tensors (and the injected draws) as
        static inputs and writes the sums as its static output; the four
        networks, both Adam states and the buffer (its rows, device size
        and cursor) it reads by address, so they are updated and loaded in
        place. The record goes in by ``ReplayBuffer.insert_device`` and
        the host ints advance by T after the run. On the card the first
        run warms the body up for ``min(WARMUP_STEPS, T)`` steps with the
        capture's gate pattern (the steps before the gate, then those
        after it), restores what the warm-up wrote, then captures; the
        draws come from the program's own generator, handed over as
        ``utils/graphs.py`` says."""
        T = self.cfg.env.episode_steps
        key = (t_open, noise is not None, indices is not None)
        prog = self._programs.pop(key, None) or graphs.Program(
            self.device, True, [torch.zeros(3, device=self.device)])
        self._programs[key] = prog
        if len(self._programs) > PROGRAMS_KEPT:
            self._programs.popitem(last=False)
        n = len(start)

        def body(gen, steps, opens):
            start_, draws = prog.inputs[:n], iter(prog.inputs[n:])
            sums = prog.outputs[0]
            sums.zero_()
            self._steps(start_, gen, lambda t: t >= opens,
                        self.buffer.insert_device, sums,
                        next(draws) if key[1] else None,
                        next(draws) if key[2] else None, steps)

        def warmup(gen):
            b, w = self.buffer, min(WARMUP_STEPS, T)
            saved = graphs.Snapshot(
                [p for m in self._modules().values() for p in m.parameters()]
                + [b._size_dev, b._cursor_dev],
                [self.actor_opt, self.critic_opt])
            idx = (torch.arange(w, device=self.device) + b.cursor) % (
                b.capacity)
            rows = {k: d.index_select(0, idx) for k, d in b.data.items()}
            body(gen, w, min(t_open, w - 1) if t_open < T else w)
            saved.restore()
            for k, d in b.data.items():
                d.index_copy_(0, idx, rows[k])

        prog.run([*start, *(d for d in (noise, indices) if d is not None)],
                 self.gen, lambda gen: body(gen, T, t_open), warmup)
        self.buffer.advance(T)
        return prog.outputs[0].clone()

    def episode(self, x0: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                indices: Optional[torch.Tensor] = None):
        """One training episode: per step the OU step, the action, the env
        step, one record stored, then the step's gradient steps. Returns
        the summed reward and the summed critic and actor losses (on the
        device). ``x0`` (N, 4), ``noise`` (T, N, n_a) and ``indices`` (T,
        updates_per_step, B) replace the reset, the OU draws and the
        replay samples (tests). The steps run through
        :meth:`_run_program`, or with ``graph=False`` as the eager loop,
        whose gate reads the buffer's host size after each insert."""
        cfg = self.cfg
        T = cfg.env.episode_steps
        t0 = time.perf_counter()
        start = self._start(x0)
        if self._graph is None:
            t_open = self._gate_opens()
            sums = self._run_program(start, noise, indices, t_open)
            opened = T - t_open
        else:
            sums = torch.zeros(3, device=self.device)
            opened = self._steps(
                start, self.gen, lambda t: self.buffer.size > cfg.batch_size,
                self.buffer.insert, sums, noise, indices)
        self.timing["updates"] += opened * cfg.updates_per_step
        _sync(self.device)
        self.timing["s"] += time.perf_counter() - t0
        self.timing["steps"] += T
        return tuple(sums)

    def eval_rewards(self) -> np.ndarray:
        """Summed rewards of ``n_test_episodes`` greedy episodes."""
        return eval_episodes(self.actor, self.env, self.cfg.actor, self.gen,
                             self.cfg.n_test_episodes,
                             self._graph).cpu().numpy()

    def evaluate(self) -> Tuple[float, float]:
        """Mean and population std of :meth:`eval_rewards`."""
        r = self.eval_rewards()
        return float(r.mean()), float(r.std())

    def timing_summary(self) -> Dict[str, float]:
        """Wall ms per env step with its gradient steps, and env steps per
        second, of the training episodes run so far."""
        t = self.timing
        return {"ms_per_step": 1e3 * t["s"] / max(t["steps"], 1),
                "env_steps_per_s": t["steps"] / max(t["s"], 1e-9),
                "updates": t["updates"]}

    # --- full training state: checkpoint and resume ---

    def _modules(self):
        return {"actor": self.actor, "actor_target": self.actor_target,
                "critic": self.critic, "critic_target": self.critic_target}

    def _opt_trees(self) -> dict:
        return {
            "actor_opt": checkpoint.adam_state_tree(self.actor.parameters(),
                                                    self.actor_opt),
            "critic_opt": checkpoint.adam_state_tree(
                self.critic.parameters(), self.critic_opt)}

    def training_state(self) -> dict:
        """Everything a resume needs: the four networks, both Adam states,
        the replay buffer, the generator and the episode counter."""
        return {
            **{k: dict(m.state_dict()) for k, m in self._modules().items()},
            **self._opt_trees(),
            "buffer": {**self.buffer.data,
                       "size": np.int64(self.buffer.size),
                       "cursor": np.int64(self.buffer.cursor)},
            "generator": self.gen.get_state(),
            "episode": np.int64(self._ep),
        }

    def save_training_state(self, path: str) -> None:
        # a checkpoint holding NaN would resume into a poisoned run
        check_finite(dict(self.actor.state_dict()), "actor")
        check_finite(dict(self.critic.state_dict()), "critic")
        checkpoint.save_tree(path, self.training_state())

    def load_training_state(self, path: str) -> None:
        st = checkpoint.load_tree(path, self.training_state())
        for k, m in self._modules().items():
            m.load_state_dict({n: torch.from_numpy(v)
                               for n, v in st[k].items()})
        checkpoint.load_adam_state_tree(self.actor_opt, st["actor_opt"])
        checkpoint.load_adam_state_tree(self.critic_opt, st["critic_opt"])
        b = st["buffer"]
        for k, d in self.buffer.data.items():
            d.copy_(torch.from_numpy(b[k]))
        self.buffer.size, self.buffer.cursor = int(b["size"]), int(
            b["cursor"])
        self.gen.set_state(torch.from_numpy(st["generator"]))
        self._ep = int(st["episode"])

    def export(self, save_path: str) -> None:
        """Write the actor as ``save_path + ".npz"`` and the critic as
        ``save_path + "_critic.npz"`` (both packages read them), and the
        actor as a reference-layout torch state_dict at ``save_path``."""
        layers = actor_numpy_from_params(self.actor.state_dict(),
                                         self.cfg.actor)
        checkpoint.save_layers_npz(save_path + ".npz", layers)
        checkpoint.save_layers_npz(
            save_path + "_critic.npz",
            critic_numpy_from_params(self.critic.state_dict(),
                                     self.cfg.critic))
        checkpoint.save_actor_torch_format(save_path, layers)

    def train(self, save_path: Optional[str] = None,
              state_path: Optional[str] = None, checkpoint_every: int = 0,
              stop_after: Optional[int] = None) -> dict:
        """Run (or resume) the training loop.

        Args:
          save_path: the final networks' export (:meth:`export`).
          state_path: training-state file; loaded at entry when it exists
            (resume), written every ``checkpoint_every`` episodes and at
            exit.
          checkpoint_every: episodes between state saves (0 = at exit).
          stop_after: return after this many episodes in all, with the
            state saved (when ``state_path``) and ``interrupted=True``; a
            later call resumes bit for bit.
        """
        cfg = self.cfg
        if state_path and os.path.exists(state_path):
            self.load_training_state(state_path)
            self.logger.log("resume", episode=self._ep)
        while self._ep < cfg.n_train_episodes:
            if stop_after is not None and self._ep >= stop_after:
                if state_path:
                    self.save_training_state(state_path)
                return {"mean": np.nan, "std": np.nan, "interrupted": True}
            ep = self._ep
            ep_reward, c_loss, a_loss = self.episode()
            self.last_episode = {"reward": ep_reward, "critic_loss": c_loss,
                                 "actor_loss": a_loss}
            self._ep = ep + 1
            if ep % cfg.test_interval == 0:
                mean, std = self.evaluate()
                self.logger.log(
                    "eval", episode=ep, reward_mean=mean, reward_std=std,
                    rollout_reward=float(ep_reward),
                    critic_loss=float(c_loss), actor_loss=float(a_loss))
            if (state_path and checkpoint_every
                    and self._ep % checkpoint_every == 0):
                self.save_training_state(state_path)
        mean, std = self.evaluate()
        self.logger.log("final_eval", reward_mean=mean, reward_std=std)
        self.logger.log("timing", **self.timing_summary())
        if state_path:
            self.save_training_state(state_path)
        if save_path:
            self.export(save_path)
        return {"mean": mean, "std": std}


def train_ddpg(cfg: ExperimentConfig, logger=None, save_path=None,
               state_path=None, checkpoint_every=0, device="cuda") -> dict:
    learner = DDPG(DDPGConfig.from_experiment(cfg), logger, device)
    return learner.train(save_path, state_path, checkpoint_every)
