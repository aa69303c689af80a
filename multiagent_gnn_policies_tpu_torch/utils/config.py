"""Experiment configuration: the reference's INI files, read unchanged.

A copy of the JAX package's ``utils/config.py``. One INI section is one
experiment; ``[DEFAULT]`` supplies shared keys. Key names, types and
defaults are the JAX package's, so every section parses to equal values in
both packages. The port reads the learning, architecture, env and large-N
grid fields; the DDPG fields are parsed for that equality and wait for the
DDPG trainer.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Optional, Tuple


def load_ini(path: str) -> configparser.ConfigParser:
    # strict=False: some generated cfg files repeat a key (e.g.
    # cfg/default_baseline.cfg repeats `dt`); last value wins.
    cp = configparser.ConfigParser(strict=False)
    with open(path) as f:
        cp.read_file(f)
    return cp


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Typed view of one INI section."""

    # experiment
    alg: str = "dagger"
    env: str = "FlockingRelative-v0"
    seed: int = 11
    debug: bool = False          # echo every metric event to stderr
    header: Optional[str] = None
    fname: Optional[str] = None
    # learning
    batch_size: int = 20
    buffer_size: int = 10000
    updates_per_step: int = 200  # Adam updates per training episode
    actor_lr: float = 5e-5
    # DDPG-only learning rates; None = the reference's 1e-5 / 1e-4
    ddpg_actor_lr: Optional[float] = None
    ddpg_critic_lr: Optional[float] = None
    n_train_episodes: int = 400
    beta_coeff: float = 0.993
    test_interval: int = 40
    n_test_episodes: int = 20
    # architecture
    k: int = 3
    hidden_size: int = 32
    n_layers: int = 2            # an absent or zero key means 2
    gamma: float = 0.99
    tau: float = 0.5
    # env
    v_max: float = 3.0
    comm_radius: float = 1.0
    n_agents: int = 100
    n_actions: int = 2
    n_states: int = 6
    dt: float = 0.01
    centralized: bool = True
    # DDPG: TD-target reward scale, critic GroupNorm and input transform,
    # and the policy class ("tanh" bounded, or "none")
    reward_scale: float = 1.0
    critic_gn: bool = True
    critic_input: str = "identity"
    policy_bound: str = "tanh"
    # episodes collected per training round (one batch of envs)
    n_rollout_envs: int = 1
    episode_steps: int = 200
    # the JAX package's matmul precision; the port keeps float32 products
    # in full float32 always (envs/flocking.py:strict_fp32)
    matmul_precision: str = "default"
    # large-N trainer: agents per stored replay record (0 = auto) and
    # graph backend
    store_agents: int = 0
    graph_path: str = "auto"
    # cell grid of the large-N path: per-cell slot capacity (0 = the
    # path default, 16), grid-extent margin and cell-edge multiple
    cell_cap: int = 0
    cell_margin: float = 1.3
    cell_edge_mult: float = 1.0
    # include the replay buffer in training-state checkpoints (True =
    # resume bit for bit; False = small checkpoints, the buffer refills)
    checkpoint_buffer: bool = True
    # trainer dispatch: "auto" routes dagger/cloning sections with
    # n_agents > 1024 to the large-N trainer; "large" always does
    trainer: str = "auto"

    @classmethod
    def from_section(cls, sec) -> "ExperimentConfig":
        """Build from a configparser section proxy."""

        def get(getter, key, default):
            v = getter(key, fallback=None)
            return default if v is None else v

        d = cls()
        i, f, b, s = sec.getint, sec.getfloat, sec.getboolean, sec.get
        return cls(
            alg=get(s, "alg", d.alg).lower(),
            env=get(s, "env", d.env),
            seed=get(i, "seed", d.seed),
            debug=get(b, "debug", d.debug),
            header=get(s, "header", d.header),
            fname=get(s, "fname", d.fname),
            batch_size=get(i, "batch_size", d.batch_size),
            buffer_size=get(i, "buffer_size", d.buffer_size),
            updates_per_step=get(i, "updates_per_step", d.updates_per_step),
            actor_lr=get(f, "actor_lr", d.actor_lr),
            ddpg_actor_lr=get(f, "ddpg_actor_lr", d.ddpg_actor_lr),
            ddpg_critic_lr=get(f, "ddpg_critic_lr", d.ddpg_critic_lr),
            n_train_episodes=get(i, "n_train_episodes", d.n_train_episodes),
            beta_coeff=get(f, "beta_coeff", d.beta_coeff),
            test_interval=get(i, "test_interval", d.test_interval),
            n_test_episodes=get(i, "n_test_episodes", d.n_test_episodes),
            k=get(i, "k", d.k),
            hidden_size=get(i, "hidden_size", d.hidden_size),
            n_layers=sec.getint("n_layers", fallback=0) or d.n_layers,
            gamma=get(f, "gamma", d.gamma),
            tau=get(f, "tau", d.tau),
            v_max=get(f, "v_max", d.v_max),
            comm_radius=get(f, "comm_radius", d.comm_radius),
            n_agents=get(i, "n_agents", d.n_agents),
            n_actions=get(i, "n_actions", d.n_actions),
            n_states=get(i, "n_states", d.n_states),
            dt=get(f, "dt", d.dt),
            centralized=get(b, "centralized", d.centralized),
            reward_scale=get(f, "reward_scale", d.reward_scale),
            critic_gn=get(b, "critic_gn", d.critic_gn),
            critic_input=get(s, "critic_input", d.critic_input),
            policy_bound=get(s, "policy_bound", d.policy_bound).lower(),
            n_rollout_envs=get(i, "n_rollout_envs", d.n_rollout_envs),
            episode_steps=get(i, "episode_steps", d.episode_steps),
            matmul_precision=get(s, "matmul_precision", d.matmul_precision),
            store_agents=get(i, "store_agents", d.store_agents),
            graph_path=get(s, "graph_path", d.graph_path).lower(),
            cell_cap=get(i, "cell_cap", d.cell_cap),
            cell_margin=get(f, "cell_margin", d.cell_margin),
            cell_edge_mult=get(f, "cell_edge_mult", d.cell_edge_mult),
            checkpoint_buffer=get(b, "checkpoint_buffer",
                                  d.checkpoint_buffer),
            trainer=get(s, "trainer", d.trainer).lower(),
        )

    @property
    def hidden(self) -> Tuple[int, ...]:
        return tuple([self.hidden_size] * self.n_layers)
