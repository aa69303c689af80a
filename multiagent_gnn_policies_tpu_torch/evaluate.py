"""Large-N checkpoint evaluation on the GPU: the PyTorch counterpart of
``evaluate.py``'s large-N path (its ``evaluate_blocked``).

    python -m multiagent_gnn_policies_tpu_torch.evaluate cfg/dagger_n32k.cfg \\
        (--actor-path models/actor_FlockingRelative-v0_dagger_n32k.npz \\
         | --expert) [--n-agents 32768] [--episodes E] [--cell-margin M] \\
        [--cell-cap C] [--cell-edge-mult E] [--device cuda|cpu]

Each section of the INI file is evaluated with greedy episodes of the
checkpoint, or with ``--expert`` of the analytic controller (centralized
or not as the section's ``centralized`` says), through the O(N) cell
sweeps and printed as the JAX CLI prints it: the header line, then
``section, mean, std``. A run whose cell grid overflowed in any step
(neighbours dropped, so the rewards are not the exact-graph dynamics) exits
with status 3 and prints no result.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    ENV_REGISTRY,
    FlockingParams,
)
from multiagent_gnn_policies_tpu_torch.models.actor import Actor, ActorConfig
from multiagent_gnn_policies_tpu_torch.models.torch_import import (
    actor_params_from_numpy,
)
from multiagent_gnn_policies_tpu_torch.parallel.large_n import rollout_large
from multiagent_gnn_policies_tpu_torch.utils.checkpoint import load_actor_npz
from multiagent_gnn_policies_tpu_torch.utils.config import (
    ExperimentConfig,
    load_ini,
)


def load_actor(path: str, acfg: ActorConfig, device) -> Actor:
    """The port's ``Actor`` with the weights of a JAX ``.npz`` checkpoint."""
    actor = Actor(acfg)
    actor.load_state_dict(actor_params_from_numpy(load_actor_npz(path, acfg)))
    return actor.to(device).eval()


def episode_generator(seed: int, episode: int, device) -> torch.Generator:
    """The generator of one evaluation episode (the JAX CLI folds the
    episode index into ``key(seed)``; torch streams differ from jax.random,
    so only the distribution of episodes is shared)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + episode)
    return gen


def evaluate_blocked(section, actor_path: Optional[str], n_agents=None,
                     n_episodes=None, per_episode=False, cell_margin=None,
                     expert=False, cell_cap=None, cell_edge_mult=None,
                     device="cuda"):
    """Large-N evaluation under ``section``'s env: greedy episodes of the
    checkpoint at ``actor_path``, or of the analytic expert with
    ``expert`` (``actor_path`` unused). ``cell_margin``, ``cell_cap`` and
    ``cell_edge_mult`` override the section's grid.

    Returns ``{"mean", "std", "rewards", "overflow"}``; exits with status 3
    when any step's cell grid overflowed."""
    cfg = ExperimentConfig.from_section(section)
    p = FlockingParams(n_agents=n_agents or cfg.n_agents,
                       comm_radius=cfg.comm_radius, dt=cfg.dt,
                       v_max=cfg.v_max, episode_steps=cfg.episode_steps)
    p = ENV_REGISTRY[cfg.env](p)
    device = torch.device(device)
    actor = acfg = None
    if not expert:
        acfg = ActorConfig(n_s=cfg.n_states, n_a=cfg.n_actions,
                           hidden=cfg.hidden, k=cfg.k, ind_agg=0)
        actor = load_actor(actor_path, acfg, device)
    rewards, max_overflow = [], 0
    for ep in range(n_episodes or cfg.n_test_episodes):
        r, _, ovf = rollout_large(
            actor, acfg, episode_generator(cfg.seed, ep, device), p,
            centralized_expert=cfg.centralized, return_overflow=True,
            cell_margin=cell_margin or cfg.cell_margin,
            cap=cell_cap or cfg.cell_cap or None,
            cell_edge_mult=cell_edge_mult or cfg.cell_edge_mult,
            device=device, expert_mode=expert)
        total, ovf = float(r.sum()), int(ovf)
        max_overflow = max(max_overflow, ovf)
        if per_episode:
            print(total if ovf == 0 else f"{total}  # OVERFLOW={ovf}")
        rewards.append(total)
    if max_overflow:
        print(f"ERROR: neighbor-structure overflow={max_overflow} (max over "
              f"episodes/steps) — results are invalid; raise --cell-margin "
              f"or --cell-cap", file=sys.stderr)
        raise SystemExit(3)
    return {"mean": float(np.mean(rewards)), "std": float(np.std(rewards)),
            "rewards": rewards, "overflow": max_overflow}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("config", help="INI experiment file")
    ap.add_argument("--actor-path", default=None,
                    help="actor checkpoint (.npz of the JAX package)")
    ap.add_argument("--expert", action="store_true",
                    help="evaluate the analytic expert instead of a "
                         "checkpoint")
    ap.add_argument("--n-agents", type=int, default=None,
                    help="swarm-size override")
    ap.add_argument("--episodes", type=int, default=None,
                    help="override n_test_episodes")
    ap.add_argument("--per-episode", action="store_true",
                    help="print every episode reward")
    ap.add_argument("--cell-margin", type=float, default=None,
                    help="cell-grid extent margin override")
    ap.add_argument("--cell-cap", type=int, default=None,
                    help="cell slot-capacity override (overlapping flocks "
                         "need 32)")
    ap.add_argument("--cell-edge-mult", type=float, default=None,
                    help="cell-edge multiple override (the sweep stays "
                         "exact for any value >= 1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu; nothing falls back")
    args = ap.parse_args(argv)
    if not args.expert and not args.actor_path:
        ap.error("--actor-path is required (or pass --expert)")

    config = load_ini(args.config)
    sections = config.sections() or [config.default_section]
    print(config[sections[0]].get("header"))
    for name in sections:
        stats = evaluate_blocked(
            config[name], args.actor_path, n_agents=args.n_agents,
            n_episodes=args.episodes, per_episode=args.per_episode,
            cell_margin=args.cell_margin, expert=args.expert,
            cell_cap=args.cell_cap, cell_edge_mult=args.cell_edge_mult,
            device=args.device)
        print(f"{name}, {stats['mean']}, {stats['std']}")


if __name__ == "__main__":
    main()
