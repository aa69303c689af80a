"""Multi-process mesh check: the counterpart of the JAX package's
``scripts/multihost_demo.py``. Run one copy per process (one per device):

    python -m multiagent_gnn_policies_tpu_torch.scripts.multihost_demo \\
        --coordinator localhost:8476 --num-processes 2 --process-id 0 \\
        --device cpu &
    python -m multiagent_gnn_policies_tpu_torch.scripts.multihost_demo \\
        --coordinator localhost:8476 --num-processes 2 --process-id 1 \\
        --device cpu

or under ``MAGNN_AUTO_DISTRIBUTED=1 torchrun --nproc-per-node D -m ...``
(``--device cuda``, the default: NCCL, one card per process; gloo on the
CPU with ``--device cpu``). The processes form one mesh, then:

1. an ``all_reduce`` sanity check: rank r adds r + 1, so the sum is
   D(D + 1)/2;
2. an agent-sharded large-N expert rollout (``parallel/large_n.py``) over
   a 1 x D ``("env", "agents")`` mesh, against the same rollout with no
   process group on this rank's device: rewards, final state and overflow
   must be equal bit for bit (the JAX demo allows 1e-3);
3. one data-parallel DAGGER round (``ShardedImitationLearner``, beta 0.9)
   over the global ``env`` axis of a D x 1 mesh, at the JAX demo's config
   (N = 8, T = 8, K = 2, hidden 8x8, batch 8, buffer 128, D episodes):
   its mean episode reward and loss sum must be finite.

Prints one ``MULTIHOST_OK`` line with the checked numbers, the same on
every rank; exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from multiagent_gnn_policies_tpu_torch.algos.imitation import ImitationConfig
from multiagent_gnn_policies_tpu_torch.envs.flocking import FlockingParams
from multiagent_gnn_policies_tpu_torch.models.actor import ActorConfig
from multiagent_gnn_policies_tpu_torch.parallel import distributed
from multiagent_gnn_policies_tpu_torch.parallel.large_n import rollout_large
from multiagent_gnn_policies_tpu_torch.parallel.mesh import make_mesh
from multiagent_gnn_policies_tpu_torch.parallel.sharded import (
    ShardedImitationLearner,
)
from multiagent_gnn_policies_tpu_torch.scripts._common import (
    add_device_arg,
    device_of,
)

SEED = 7


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Multi-process mesh check: all_reduce, the "
                    "agent-sharded expert rollout against one process's, "
                    "and one data-parallel DAGGER round.")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (else the MAGNN_* or torchrun "
                         "variables)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--n-agents", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device_of(args.device)
    platform = "cpu" if args.device == "cpu" else None
    if args.device == "cpu":
        torch.set_num_threads(1)
    if args.coordinator:
        distributed.initialize_distributed(
            args.coordinator, args.num_processes, args.process_id, platform)
    elif not distributed.maybe_initialize_distributed(platform):
        raise SystemExit("no process group: pass --coordinator, "
                         "--num-processes and --process-id, or run under "
                         "torchrun with MAGNN_AUTO_DISTRIBUTED=1")
    rank, world = distributed.process_info()
    device = distributed.local_device(platform)
    mesh = make_mesh(1, world, device_type=args.device)
    group = mesh.get_group("agents")

    # 1. all_reduce over the mesh
    t = torch.full((1,), float(rank + 1), device=device)
    torch.distributed.all_reduce(t, group=group)
    psum = float(t[0])
    if psum != world * (world + 1) / 2:
        raise SystemExit(f"all_reduce gave {psum}, expected "
                         f"{world * (world + 1) / 2}")

    # 2. the agent-sharded expert rollout against this process's own
    p = FlockingParams(n_agents=args.n_agents, episode_steps=args.steps,
                       max_resets=2)

    def rollout(m):
        gen = torch.Generator(device=device).manual_seed(SEED)
        return rollout_large(None, None, gen, p, return_overflow=True,
                             device=device, expert_mode=True, mesh=m)

    r_mesh, x_mesh, o_mesh = rollout(mesh)
    r_local, x_local, o_local = rollout(None)
    if not (torch.equal(r_mesh, r_local) and torch.equal(x_mesh, x_local)
            and int(o_mesh) == int(o_local)):
        raise SystemExit(
            f"the sharded rollout differs from this process's: rewards "
            f"{float(r_mesh.sum())} vs {float(r_local.sum())}, overflow "
            f"{int(o_mesh)} vs {int(o_local)}")

    # 3. one data-parallel DAGGER round over the global env axis
    cfg = ImitationConfig(
        mode="dagger",
        actor=ActorConfig(n_s=6, n_a=2, hidden=(8, 8), k=2),
        env_name="FlockingRelative-v0",
        env=FlockingParams(n_agents=8, episode_steps=8),
        batch_size=8, buffer_size=128, updates_per_episode=2,
        n_train_episodes=world, n_rollout_envs=world, n_test_episodes=2,
        seed=0)
    learner = ShardedImitationLearner(
        cfg, make_mesh(world, 1, device_type=args.device), device=device)
    learner._beta = 0.9
    ep_r, loss = (float(v) for v in learner._round())
    if not (math.isfinite(ep_r) and math.isfinite(loss)):
        raise SystemExit(f"the data-parallel round gave reward {ep_r}, "
                         f"loss {loss}")
    print(f"MULTIHOST_OK rank={rank}/{world} devices={world} psum={psum:.1f} "
          f"rollout={float(r_mesh.sum()):.6f} "
          f"local={float(r_local.sum()):.6f} overflow={int(o_mesh)} "
          f"round_reward={ep_r:.4f} loss={loss:.6f}",
          flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
