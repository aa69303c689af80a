"""Multi-device dry run: the counterpart of the JAX package's
``__graft_entry__.py:dryrun_multichip``. One process per device:

    python -m multiagent_gnn_policies_tpu_torch.scripts.dryrun_multichip \\
        [--devices D] [--device cuda|cpu]

With no process group in the environment the script starts D copies of
itself on a free localhost port; under
``MAGNN_AUTO_DISTRIBUTED=1 torchrun --nproc-per-node D -m ...`` (or the
``MAGNN_*`` variables) it is one rank of the group. ``--device cuda``, the
default, runs NCCL ranks, one card each, and exits non-zero without a
card; ``--device cpu`` runs gloo ranks on the CPU. Every rank runs, at the
JAX function's tiny shapes:

1. one ``ShardedImitationLearner`` DAGGER round (beta 0.9) on an
   ``("env", "agents")`` mesh of D/2 x 2 ranks when D >= 4 is even, else D
   x 1, against the same round of the one-process learner (parameters
   within rtol 1e-6);
2. the agent-sharded policy forward (``sharded_policy_forward``) over a
   1 x D mesh against the dense forward (1e-5);
3. the grid-row-banded pcells rollout over that mesh against the
   one-process rollout (overflow 0, rewards within 1e-5);
4. a ``LargeNImitationLearner`` mesh training round on 2 x D/2 (D >= 4
   even, else 1 x D) against the one-process learner's parameters (rtol
   1e-6).

Rank 0 prints one ``dryrun_multichip OK ...`` line; any failure exits
non-zero (in the spawning process too).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.parallel import distributed
from multiagent_gnn_policies_tpu_torch.scripts._common import (
    add_device_arg,
    device_of,
)

ENV_VARS = ("MAGNN_COORDINATOR", "MAGNN_NUM_PROCESSES", "MAGNN_PROCESS_ID")


def _close(what, got, want, rtol=1e-6, atol=1e-7):
    got, want = np.asarray(got), np.asarray(want)
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise SystemExit(f"dryrun_multichip: {what} differs by "
                         f"{np.abs(got - want).max()}")


def _same_params(what, a, b):
    for k, v in a.actor.state_dict().items():
        _close(f"{what} {k}", v.cpu(), b.actor.state_dict()[k].cpu())


def run_rank(platform, device: torch.device) -> str:
    """Every check on this rank; returns the OK line."""
    from multiagent_gnn_policies_tpu_torch.algos import imitation as im
    from multiagent_gnn_policies_tpu_torch.algos import imitation_large as il
    from multiagent_gnn_policies_tpu_torch.envs.flocking import (
        FlockingParams)
    from multiagent_gnn_policies_tpu_torch.models.actor import (
        Actor, ActorConfig, init_actor_)
    from multiagent_gnn_policies_tpu_torch.ops.graph import aggregate
    from multiagent_gnn_policies_tpu_torch.parallel.large_n import (
        rollout_large)
    from multiagent_gnn_policies_tpu_torch.parallel.mesh import (
        axis_group, make_mesh)
    from multiagent_gnn_policies_tpu_torch.parallel.sharded import (
        ShardedImitationLearner, sharded_policy_forward)

    _, d = distributed.process_info()
    kind = device.type
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)

    # 1. one data-parallel DAGGER round
    shards = 2 if d % 2 == 0 and d >= 4 else 1
    n_env = d // shards
    cfg = im.ImitationConfig(
        mode="dagger",
        actor=ActorConfig(n_s=6, n_a=2, hidden=(8, 8), k=2),
        env_name="FlockingRelative-v0",
        env=FlockingParams(n_agents=8, episode_steps=8),
        batch_size=8, buffer_size=128, updates_per_episode=2,
        n_train_episodes=n_env, n_rollout_envs=n_env, n_test_episodes=2,
        seed=0)
    learners = (ShardedImitationLearner(cfg, make_mesh(n_env, shards, kind),
                                        device=device),
                im.ImitationLearner(cfg, device=device))
    for lrn in learners:
        lrn._beta = 0.9
        ep_r, loss = (float(v) for v in lrn._round())
        if not (np.isfinite(ep_r) and np.isfinite(loss)):
            raise SystemExit(f"dryrun_multichip: round reward {ep_r}, "
                             f"loss {loss}")
    _same_params("the sharded round's", *learners)

    # 2. the agent-sharded forward over a 1 x D mesh
    mesh_agents = make_mesh(1, d, kind)
    axis = axis_group(mesh_agents, "agents")
    acfg = ActorConfig(n_s=6, n_a=2, hidden=(16,), k=2)
    actor = init_actor_(Actor(acfg).to(device), gen(1))
    n = 16 * d
    ds = torch.randn((acfg.k, n, acfg.n_s), generator=gen(2), device=device)
    gso = 0.1 * torch.rand((acfg.k, n, n), generator=gen(3), device=device)
    own = slice(axis.index * n // d, (axis.index + 1) * n // d)
    with torch.no_grad():
        out = sharded_policy_forward(actor, ds, gso[:, :, own], axis,
                                     gather=True)
        _close("the sharded forward", out.cpu(),
               actor(aggregate(gso, ds)).cpu(), rtol=1e-5, atol=1e-5)

    # 3. the banded pcells rollout against one process's
    acfg3 = ActorConfig(n_s=6, n_a=2, hidden=(8,), k=3)
    actor3 = init_actor_(Actor(acfg3).to(device), gen(4))
    p = FlockingParams(n_agents=16 * d, episode_steps=4, max_resets=4)
    r1, _ = rollout_large(actor3, acfg3, gen(5), p, device=device)
    r2, _, ovf = rollout_large(actor3, acfg3, gen(5), p, device=device,
                               mesh=mesh_agents, return_overflow=True)
    if int(ovf):
        raise SystemExit(f"dryrun_multichip: banded rollout overflow="
                         f"{int(ovf)}")
    _close("the banded rollout's rewards", r2.cpu(), r1.cpu(), rtol=0,
           atol=1e-5)

    # 4. a large-N mesh training round against one process's
    if d % 2 == 0 and d >= 4:
        t_env, t_agents = 2, d // 2
    else:
        t_env, t_agents = 1, d
    lcfg = il.LargeNImitationConfig(
        mode="dagger",
        actor=ActorConfig(n_s=6, n_a=2, hidden=(8,), k=3),
        env_name="FlockingRelative-v0",
        env=FlockingParams(n_agents=64, episode_steps=6, max_resets=4),
        batch_size=4, buffer_size=64, updates_per_episode=2,
        n_train_episodes=t_env, n_rollout_envs=t_env, n_test_episodes=2,
        seed=7, store_agents=16, graph_path="pcells")
    large = (il.LargeNImitationLearner(
                 lcfg, device=device, mesh=make_mesh(t_env, t_agents, kind)),
             il.LargeNImitationLearner(lcfg, device=device))
    for lrn in large:
        lrn.train()
    _same_params("the large-N mesh round's", *large)

    return (f"dryrun_multichip OK: {d} ranks ({platform or 'nccl'}), mesh "
            f"env={n_env} x agents={shards}, round reward={ep_r:.3f}, "
            f"loss={loss:.6f}, agent-sharded fwd over {d} ranks, banded "
            f"pcells rollout over {d} ranks (reward "
            f"{float(r2.sum()):.3f} == single-process), large-N mesh "
            f"TRAINING round over {t_env}x{t_agents} (env,agents) == "
            f"single-process params")


def _spawn(d: int, device: str) -> int:
    """Start ``d`` ranks of this script on a free localhost port; returns
    the first non-zero exit code (0 if every rank passed)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ENV_VARS + ("MAGNN_AUTO_DISTRIBUTED",)}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env.update(MAGNN_COORDINATOR=f"127.0.0.1:{port}",
               MAGNN_NUM_PROCESSES=str(d),
               PYTHONPATH=os.pathsep.join(
                   [root] + [v for v in [env.get("PYTHONPATH")] if v]))
    if device == "cpu":
        env.update(MAGNN_PLATFORM="cpu", OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", __spec__.name, "--devices", str(d),
            "--device", device]
    procs = [subprocess.Popen(argv, env=dict(env, MAGNN_PROCESS_ID=str(r)))
             for r in range(d)]
    try:
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return next((c for c in codes if c), 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Multi-device dry run of the port's data-parallel and "
                    "agent-sharded paths, one process per device.")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks to start when no process group is set up "
                         "(default 8)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device_of(args.device)
    platform = "cpu" if args.device == "cpu" else None
    if not distributed.maybe_initialize_distributed(platform):
        return _spawn(args.devices, args.device)
    if args.device == "cpu":
        torch.set_num_threads(1)
    try:
        line = run_rank(platform, distributed.local_device(platform))
        if distributed.process_info()[0] == 0:
            print(line, flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
