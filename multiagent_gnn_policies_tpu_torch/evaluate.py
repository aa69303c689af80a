"""Checkpoint evaluation on the GPU: the PyTorch counterpart of
``evaluate.py``, routed as it routes.

Plain evaluation (one checkpoint under every section's env):

    python -m multiagent_gnn_policies_tpu_torch.evaluate cfg/dagger.cfg \\
        --actor-path models/actor_FlockingRelative-v0_dagger_k3.npz

Transfer evaluation (a per-section ``k`` picks checkpoint ``<base><k>``,
the extensionless state_dict first, else ``<base><k>.npz``, and builds the
actor and the delayed state with that ``k``):

    python -m multiagent_gnn_policies_tpu_torch.evaluate \\
        cfg/transfer_stoch.cfg \\
        --actor-base models/actor_FlockingStochastic-v0_transfer2_stoch \\
        [--n-agents 32768]

Without ``--n-agents`` or ``--expert`` a section is evaluated on the dense
path at its own N (the imitation learner's greedy eval, ``n_test_episodes``
episodes as one batch). With ``--n-agents`` (or ``--expert``, which rolls
the analytic controller, centralized or not as the section's
``centralized`` says) it goes through the O(N) cell sweeps: ``--episodes``,
``--cell-margin``, ``--cell-cap`` and ``--cell-edge-mult`` apply there. A
large-N run whose cell grid overflowed in any step (neighbours dropped, so
the rewards are not the exact-graph dynamics) exits with status 3 and
prints no result.

Checkpoints are ``.npz`` files of either package or reference-layout
torch ``state_dict`` files (any other name). ``--k`` overrides the
section's K. Output: the header line, then ``section, mean, std``;
``--per-episode`` prints each episode's reward, and ``--save-trajectory
out.npz`` writes one greedy episode's states: on the dense path ``x (T, N,
4)`` and ``reward (T,)``; on the large-N path episode 0's ``x (T, M, 4)``
for M = min(2000, N) evenly spaced agents, ``reward``, ``final_x (N, 4)``
and ``subset_indices (M,)``.

On one card the large-N route runs each episode's steps as CUDA graphs
per static setup, on every graph path, captured at its first episode
(``parallel/large_n.py``'s episode program), and the dense route its
batch's steps (``algos/imitation.py``'s dense episode program) and the
``--save-trajectory`` episode's (its trajectory program); the resets
stay eager.

``--mesh D`` shares the large-N route's sweeps over the ``agents`` axis of
D processes, one per device (``parallel/large_n.py``), and implies that
route, as in the JAX CLI. Launch one process per card:

    MAGNN_AUTO_DISTRIBUTED=1 torchrun --nproc-per-node D \
        -m multiagent_gnn_policies_tpu_torch.evaluate cfg/dagger_n32k.cfg \
        --actor-path models/actor_FlockingRelative-v0_dagger_n32k.npz \
        --n-agents 32768 --mesh D

(or set MAGNN_COORDINATOR, MAGNN_NUM_PROCESSES and MAGNN_PROCESS_ID per
process; ``--device cpu`` takes gloo on the CPU). Every rank rolls the same
episodes and rank 0 prints. A world size other than D exits non-zero.

``alg = ddpg`` sections on the dense route score the DDPG policy class
(aggregation halfway, the section's ``policy_bound``) through the dense
DDPG learner's eval, ``n_test_episodes`` episodes as one batch drawn from
a generator seeded with the section's seed; ``--k`` and
``--save-trajectory`` are refused there, as the JAX CLI refuses them.
"""

from __future__ import annotations

import argparse
import os
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
    actor_params_from_state_dict,
)
from multiagent_gnn_policies_tpu_torch.parallel import distributed
from multiagent_gnn_policies_tpu_torch.parallel.large_n import (
    rollout_large,
    traj_subset_indices,
)
from multiagent_gnn_policies_tpu_torch.utils.checkpoint import load_actor_npz
from multiagent_gnn_policies_tpu_torch.utils.config import (
    ExperimentConfig,
    load_ini,
)

TRAJ_AGENTS = 2000      # agents a large-N trajectory records at most


def load_actor_layers(path: str, acfg: ActorConfig):
    """JAX-layout actor layers from a ``.npz`` checkpoint or a reference
    torch ``state_dict`` file, each layer's shape checked against the
    actor ``acfg`` implies; exits naming the layer and both shapes."""
    if path.endswith(".npz"):
        try:
            return load_actor_npz(path, acfg)
        except ValueError as e:
            raise SystemExit(str(e)) from e
    layers = actor_params_from_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))
    if len(layers) != acfg.n_layers:
        raise SystemExit(f"{path}: {len(layers)} layers != cfg-implied "
                         f"{acfg.n_layers}")
    widths = acfg.widths
    for i, layer in enumerate(layers):
        want = (widths[i + 1], widths[i], acfg.taps(i))
        if layer["w"].shape != want or layer["b"].shape != want[:1]:
            raise SystemExit(
                f"{path}: layer {i} weight shape {layer['w'].shape} != "
                f"cfg-implied {want}")
    return layers


def load_actor(path: str, acfg: ActorConfig, device) -> Actor:
    """The port's ``Actor`` with the weights of ``path`` (see
    :func:`load_actor_layers`)."""
    actor = Actor(acfg)
    actor.load_state_dict(actor_params_from_numpy(
        load_actor_layers(path, acfg)))
    return actor.to(device).eval()


def episode_generator(seed: int, episode: int, device) -> torch.Generator:
    """The generator of one evaluation episode (the JAX CLI folds the
    episode index into ``key(seed)``; torch streams differ from jax.random,
    so only the distribution of episodes is shared)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + episode)
    return gen


def evaluate_blocked(section, actor_path: Optional[str], k=None,
                     n_agents=None, n_episodes=None, per_episode=False,
                     cell_margin=None, expert=False, cell_cap=None,
                     cell_edge_mult=None, traj_path=None, device="cuda",
                     mesh=None):
    """Large-N evaluation under ``section``'s env: greedy episodes of the
    checkpoint at ``actor_path`` with filter length ``k`` (the section's
    when None), or of the analytic expert with ``expert`` (``actor_path``
    unused). ``cell_margin``, ``cell_cap`` and ``cell_edge_mult`` override
    the section's grid; ``traj_path`` receives episode 0's trajectory.
    ``mesh``: a ``DeviceMesh`` whose ``agents`` axis shares the sweeps;
    every rank calls this alike and only rank 0 prints and writes.

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
                           hidden=cfg.hidden, k=k or cfg.k, ind_agg=0)
        actor = load_actor(actor_path, acfg, device)
    traj_agents = min(TRAJ_AGENTS, p.n_agents) if traj_path else 0
    lead = distributed.process_info()[0] == 0
    rewards, max_overflow = [], 0
    for ep in range(n_episodes or cfg.n_test_episodes):
        out = rollout_large(
            actor, acfg, episode_generator(cfg.seed, ep, device), p,
            centralized_expert=cfg.centralized, return_overflow=True,
            cell_margin=cell_margin or cfg.cell_margin,
            cap=cell_cap or cfg.cell_cap or None,
            cell_edge_mult=cell_edge_mult or cfg.cell_edge_mult,
            device=device, expert_mode=expert,
            traj_agents=traj_agents if ep == 0 else 0, mesh=mesh)
        r, final_x, ovf = out[:3]
        if ep == 0 and traj_path and lead:
            np.savez(traj_path, x=out[3].cpu().numpy(), reward=r.cpu().numpy(),
                     final_x=final_x.cpu().numpy(),
                     subset_indices=traj_subset_indices(
                         p.n_agents, traj_agents).to(torch.int32).numpy())
            print(f"# trajectory ({out[3].shape[0]} steps, "
                  f"{traj_agents}/{p.n_agents} agents) -> {traj_path}")
        total, ovf = float(r.sum()), int(ovf)
        max_overflow = max(max_overflow, ovf)
        if per_episode and lead:
            print(total if ovf == 0 else f"{total}  # OVERFLOW={ovf}")
        rewards.append(total)
    if max_overflow:
        if not lead:
            raise SystemExit(3)
        print(f"ERROR: neighbor-structure overflow={max_overflow} (max over "
              f"episodes/steps) — results are invalid; raise --cell-margin "
              f"or --cell-cap", file=sys.stderr)
        raise SystemExit(3)
    return {"mean": float(np.mean(rewards)), "std": float(np.std(rewards)),
            "rewards": rewards, "overflow": max_overflow}


def evaluate_section(section, actor_path: str, k=None, per_episode=False,
                     traj_path=None, device="cuda"):
    """Dense evaluation at the section's N: the imitation learner's greedy
    eval (``n_test_episodes`` episodes as one batch) of the checkpoint at
    ``actor_path`` with filter length ``k`` (the section's when None);
    ``traj_path`` receives one more greedy episode's trajectory. Returns
    ``{"mean", "std", "rewards"}``."""
    from multiagent_gnn_policies_tpu_torch.algos.imitation import (
        ImitationConfig,
        ImitationLearner,
        rollout_trajectory,
    )

    cfg = ExperimentConfig.from_section(section)
    if cfg.alg == "ddpg":
        return evaluate_ddpg(cfg, actor_path, k, per_episode, traj_path,
                             device)
    icfg = ImitationConfig.from_experiment(cfg, mode="dagger", k=k)
    learner = ImitationLearner(icfg, device=device)
    learner.actor.load_state_dict(actor_params_from_numpy(
        load_actor_layers(actor_path, icfg.actor)))
    learner.actor.eval()
    rewards = learner.eval_rewards()
    if per_episode:
        for r in rewards:
            print(float(r))
    if traj_path:
        gen = torch.Generator(device=learner.device)
        gen.manual_seed(cfg.seed)
        xs, rs = rollout_trajectory(learner.actor, gen, learner.env,
                                    icfg.actor)
        np.savez(traj_path, x=xs.cpu().numpy(), reward=rs.cpu().numpy())
        print(f"# trajectory ({xs.shape[0]} steps, N={xs.shape[1]}) -> "
              f"{traj_path}")
    return {"mean": float(rewards.mean()), "std": float(rewards.std()),
            "rewards": [float(r) for r in rewards]}


def evaluate_ddpg(cfg: ExperimentConfig, actor_path: str, k=None,
                  per_episode=False, traj_path=None, device="cuda"):
    """A DDPG section's dense eval: the checkpoint at ``actor_path`` as the
    DDPG policy class, ``n_test_episodes`` greedy episodes as one batch
    from a generator seeded with the section's seed. The filter length is
    the section's and no trajectory is written."""
    from multiagent_gnn_policies_tpu_torch.algos.ddpg import (
        DDPGConfig,
        eval_episodes,
    )
    from multiagent_gnn_policies_tpu_torch.envs.flocking import (
        make_env,
        strict_fp32,
    )

    if traj_path:
        raise SystemExit(
            "--save-trajectory is not supported for alg=ddpg sections")
    if k is not None:
        raise SystemExit("--k is not supported for alg=ddpg sections "
                         "(the checkpoint's k is fixed by the cfg)")
    strict_fp32()
    dcfg = DDPGConfig.from_experiment(cfg)
    actor = load_actor(actor_path, dcfg.actor, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    rewards = eval_episodes(actor, make_env(dcfg.env_name, dcfg.env),
                            dcfg.actor, gen,
                            dcfg.n_test_episodes).cpu().numpy()
    if per_episode:
        for r in rewards:
            print(float(r))
    return {"mean": float(rewards.mean()), "std": float(rewards.std()),
            "rewards": [float(r) for r in rewards]}


def section_checkpoint(section, actor_path, actor_base, k):
    """``(k, path)`` of a section: with ``actor_base`` the section's K and
    ``<base><K>`` (``+ ".npz"`` only when the extensionless file is
    missing), else ``k`` and ``actor_path``."""
    if not actor_base:
        return k, actor_path
    k = section.getint("k")
    path = f"{actor_base}{k}"
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"
    return k, path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("config", help="INI experiment file")
    ap.add_argument("--actor-path", default=None,
                    help="checkpoint evaluated for every section (.npz, or "
                         "a reference torch state_dict)")
    ap.add_argument("--actor-base", default=None,
                    help="transfer mode: per-section k selects <base><k>")
    ap.add_argument("--k", type=int, default=None,
                    help="filter-length override (transfer across K)")
    ap.add_argument("--expert", action="store_true",
                    help="evaluate the analytic expert instead of a "
                         "checkpoint (large-N path)")
    ap.add_argument("--n-agents", type=int, default=None,
                    help="swarm-size override (takes the large-N path)")
    ap.add_argument("--episodes", type=int, default=None,
                    help="override n_test_episodes (large-N path)")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="share the large-N path's sweeps over D processes "
                         "(the agents axis; one process per device, e.g. "
                         "under torchrun); implies the large-N path")
    ap.add_argument("--per-episode", action="store_true",
                    help="print every episode reward")
    ap.add_argument("--save-trajectory", default=None,
                    help="dump one greedy episode's agent states to this "
                         ".npz")
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
    if not args.expert and bool(args.actor_path) == bool(args.actor_base):
        ap.error("exactly one of --actor-path / --actor-base is required "
                 "(or pass --expert)")

    mesh, device = None, args.device
    if args.mesh:
        mesh, device = mesh_from_environment(args.mesh, args.device)
    lead = distributed.process_info()[0] == 0
    config = load_ini(args.config)
    sections = config.sections() or [config.default_section]
    if lead:
        print(config[sections[0]].get("header"))
    for name in sections:
        section = config[name]
        k, path = section_checkpoint(section, args.actor_path,
                                     args.actor_base, args.k)
        if args.n_agents or args.expert or mesh is not None:
            stats = evaluate_blocked(
                section, path, k=k, n_agents=args.n_agents,
                n_episodes=args.episodes, per_episode=args.per_episode,
                cell_margin=args.cell_margin, expert=args.expert,
                cell_cap=args.cell_cap, cell_edge_mult=args.cell_edge_mult,
                traj_path=args.save_trajectory, device=device, mesh=mesh)
        else:
            stats = evaluate_section(section, path, k=k,
                                     per_episode=args.per_episode,
                                     traj_path=args.save_trajectory,
                                     device=args.device)
        if lead:
            print(f"{name}, {stats['mean']}, {stats['std']}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


def mesh_from_environment(n_dev: int, device: str):
    """``(mesh, this rank's device)`` for ``--mesh n_dev``: the process
    group from the environment (``parallel.distributed``; gloo for
    ``device`` "cpu") must hold exactly ``n_dev`` ranks, else this exits
    non-zero naming what it needs."""
    platform = "cpu" if device == "cpu" else None
    if not distributed.maybe_initialize_distributed(platform):
        raise SystemExit(
            f"--mesh {n_dev} needs {n_dev} processes, one per device: run "
            f"under `torchrun --nproc-per-node {n_dev}` with "
            f"MAGNN_AUTO_DISTRIBUTED=1, or set MAGNN_COORDINATOR, "
            f"MAGNN_NUM_PROCESSES={n_dev} and MAGNN_PROCESS_ID in each; this "
            f"is one process with no process group")
    world = distributed.process_info()[1]
    if world != n_dev:
        raise SystemExit(f"--mesh {n_dev} needs a world of {n_dev} "
                         f"processes, one per device; this one has {world}")
    from multiagent_gnn_policies_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, n_dev, device_type=device)
    return mesh, distributed.local_device(platform)


if __name__ == "__main__":
    main()
