"""The expert-controller baseline: no learning.

The counterpart of the JAX package's ``algos/baseline.py``: the analytic
expert (centralized or not, per the ``centralized`` key) drives
``n_test_episodes`` episodes, run as one batch of envs, and the mean and
population std of their summed rewards are reported.
"""

from __future__ import annotations

import numpy as np
import torch

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
    with torch.no_grad():
        state, _ = env.reset(gen, (cfg.n_test_episodes,))
        total = torch.zeros(cfg.n_test_episodes, device=state.x.device)
        for _ in range(cfg.episode_steps):
            u = env.controller(state, centralized=cfg.centralized)
            state, _, r, _ = env.step(state, u, gen)
            total += r
    rewards = total.cpu().numpy()
    stats = {"mean": float(rewards.mean()), "std": float(rewards.std())}
    if logger is not None:
        logger.log("baseline_eval", centralized=cfg.centralized, **stats)
    return stats
