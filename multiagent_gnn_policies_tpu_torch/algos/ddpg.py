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
  never waits on the device);
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

Random draws come from one ``torch.Generator`` on the device, seeded from
``seed``: the actor's and the critic's init, every reset, the OU noise,
the replay samples and the evals. Its state is part of the training state,
so a resumed run continues the same stream and equals the uninterrupted
one bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
from multiagent_gnn_policies_tpu_torch.utils import checkpoint
from multiagent_gnn_policies_tpu_torch.utils.config import ExperimentConfig
from multiagent_gnn_policies_tpu_torch.utils.debug import check_finite
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
                  gen: torch.Generator, n_episodes: int) -> torch.Tensor:
    """The summed rewards (n_episodes,) of greedy episodes run as one
    batch; the policy's output goes to the env unclipped."""
    with torch.no_grad():
        state, obs = env.reset(gen, (n_episodes,))
        gs = initial_graph_state(obs.values, obs.network, acfg.k)
        total = torch.zeros(n_episodes, device=state.x.device)
        for _ in range(env.params.episode_steps):
            mu = actor(gs.delay_state, gs.delay_gso)
            state, obs, r, _ = env.step(state, mu, gen)
            gs = update_graph_state(gs, obs.values, obs.network)
            total += r
    return total


class DDPG:
    """The dense DDPG learner: actor, critic, their targets and Adam
    states, the replay buffer and the generator, all on ``device``."""

    def __init__(self, cfg: DDPGConfig, logger: Optional[MetricsLogger] = None,
                 device="cuda"):
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
        self.actor_opt = torch.optim.Adam(self.actor.parameters(),
                                          lr=cfg.actor_lr)
        self.critic_opt = torch.optim.Adam(self.critic.parameters(),
                                           lr=cfg.critic_lr)
        self._init_env()
        self.buffer = ReplayBuffer(cfg.buffer_size, self._example_record())
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

    def _updates(self, indices: Optional[torch.Tensor]):
        """The step's ``updates_per_step`` gradient steps, once the buffer
        holds more than one batch; ``indices`` (updates_per_step, B) names
        the records (tests). Returns the summed losses or None."""
        cfg = self.cfg
        if self.buffer.size <= cfg.batch_size:
            return None
        c_sum = a_sum = 0.0
        for u in range(cfg.updates_per_step):
            batch = (self.buffer.sample(self.gen, cfg.batch_size)
                     if indices is None else self.buffer.gather(indices[u]))
            c, a = self.gradient_step(batch)
            c_sum, a_sum = c_sum + c, a_sum + a
        self.timing["updates"] += cfg.updates_per_step
        return c_sum, a_sum

    # --- episodes ---

    def episode(self, x0: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                indices: Optional[torch.Tensor] = None):
        """One training episode: per step the OU step, the action, the env
        step, one record stored, then the step's gradient steps. Returns
        the summed reward and the summed critic and actor losses (on the
        device). ``x0`` (N, 4), ``noise`` (T, N, n_a) and ``indices`` (T,
        updates_per_step, B) replace the reset, the OU draws and the
        replay samples (tests)."""
        cfg = self.cfg
        T = cfg.env.episode_steps
        dev = self.device
        t0 = time.perf_counter()
        with torch.no_grad():
            if x0 is None:
                state, obs = self.env.reset(self.gen)
            else:
                state = EnvState(x0.to(dev), 0)
                obs = self.env.observe(state)
            gs = initial_graph_state(obs.values, obs.network, cfg.actor.k)
        ou = ou_reset(cfg.env.n_agents, cfg.actor.n_a, dev)
        zero = torch.zeros((), device=dev)
        total, c_total, a_total = zero, zero, zero
        for t in range(T):
            with torch.no_grad():
                ou = ou_step(ou, self.gen, cfg.ou_theta, cfg.ou_sigma,
                             None if noise is None else noise[t])
                mu = self.actor(gs.delay_state, gs.delay_gso)
                action = torch.clamp(mu + cfg.ou_scale * ou, -1.0, 1.0)
                state, obs, r, done = self.env.step(state, action, self.gen)
                record = {"delay_state": gs.delay_state,
                          "delay_gso": gs.delay_gso,
                          "network": gs.network,
                          "next_network": obs.network,
                          "next_values": obs.values,
                          "action": action, "reward": r,
                          "notdone": torch.full((), 0.0 if done else 1.0,
                                                device=dev)}
                self.buffer.insert({k: v[None] for k, v in record.items()})
                gs = update_graph_state(gs, obs.values, obs.network)
            losses = self._updates(None if indices is None else indices[t])
            total = total + r
            if losses is not None:
                c_total, a_total = c_total + losses[0], a_total + losses[1]
        _sync(dev)
        self.timing["s"] += time.perf_counter() - t0
        self.timing["steps"] += T
        return total, c_total, a_total

    def eval_rewards(self) -> np.ndarray:
        """Summed rewards of ``n_test_episodes`` greedy episodes."""
        return eval_episodes(self.actor, self.env, self.cfg.actor, self.gen,
                             self.cfg.n_test_episodes).cpu().numpy()

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
