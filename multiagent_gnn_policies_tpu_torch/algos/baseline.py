"""The expert-controller baseline: no learning.

The counterpart of the JAX package's ``algos/baseline.py``: the analytic
expert (centralized or not, per the ``centralized`` key) drives
``n_test_episodes`` episodes, run as one batch of envs, and the mean and
population std of their summed rewards are reported. The episode is
``rollout_episode``'s "expert" mode: its steps run as the setup's dense
episode program (a CUDA graph on the card, ``centralized`` part of the
setup), the reset eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.algos.imitation import (
    rollout_episode,
)
from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams,
    make_env,
    strict_fp32,
)
from multiagent_gnn_policies_tpu_torch.utils.config import ExperimentConfig


def train_baseline(cfg: ExperimentConfig, logger=None, save_path=None,
                   device="cuda") -> dict:
    strict_fp32()
    env = make_env(cfg.env, FlockingParams(
        n_agents=cfg.n_agents, comm_radius=cfg.comm_radius, dt=cfg.dt,
        v_max=cfg.v_max, episode_steps=cfg.episode_steps))
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(cfg.seed)
    rewards = rollout_episode(
        None, gen, 0.0, env, None, mode="expert", collect=False,
        n_envs=cfg.n_test_episodes, centralized=cfg.centralized).cpu().numpy()
    stats = {"mean": float(rewards.mean()), "std": float(rewards.std())}
    if logger is not None:
        logger.log("baseline_eval", centralized=cfg.centralized, **stats)
    return stats
