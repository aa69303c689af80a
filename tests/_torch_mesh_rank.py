"""One rank of a gloo process group on the CPU that rolls the port's
large-N episodes on an ``agents`` mesh (run by tests/test_torch_multihost.py,
one subprocess per rank):

    python tests/_torch_mesh_rank.py RANK WORLD PORT CASES.json OUT_DIR

Each case of the JSON list names an env, a path, a policy (an actor
``state_dict`` file, or the expert), an optional initial state (.npy) or a
generator seed, the episode length and optionally the agents whose states
it records (``traj``), the chunks it runs in (``chunks``) and ``graph``
(``rollout_large``'s: by default the pcells path runs its episode
program's body, ``false`` the eager loop); the rank writes its rewards, final state, overflow
(and trajectory) to ``OUT_DIR/<case>_<rank>.npz``, or, for a case with
``may_raise``, the ValueError's message (``error``) if the rollout raises
one. A case with ``grid``
(positions .npy and a ``PCellSpec``'s fields) writes the sharded grid
build's tables instead. Imports no JAX.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multiagent_gnn_policies_tpu_torch.envs.flocking import (  # noqa: E402
    ENV_REGISTRY, FlockingParams)
from multiagent_gnn_policies_tpu_torch.models.actor import (  # noqa: E402
    Actor, ActorConfig)
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as cc  # noqa
from multiagent_gnn_policies_tpu_torch.parallel import distributed  # noqa
from multiagent_gnn_policies_tpu_torch.parallel.large_n import (  # noqa
    rollout_large)
from multiagent_gnn_policies_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh)


def run_case(case, mesh):
    """The case's episode on ``mesh`` (None: one process)."""
    p = ENV_REGISTRY[case["env"]](FlockingParams(
        n_agents=case["n"], episode_steps=case["steps"]))
    actor = acfg = None
    if case.get("actor"):
        acfg = ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=case["k"])
        actor = Actor(acfg)
        actor.load_state_dict(torch.load(case["actor"], weights_only=True))
        actor.eval()
    x0 = (torch.from_numpy(np.load(case["x0"])) if case.get("x0")
          else None)
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    return rollout_large(actor, acfg, gen, p, return_overflow=True, x0=x0,
                         device="cpu", expert_mode=actor is None,
                         path=case["path"], mesh=mesh,
                         n_episodes=case.get("episodes", 1),
                         traj_agents=case.get("traj", 0),
                         scan_chunks=case.get("chunks", 1),
                         graph=case.get("graph"))


def main(argv):
    rank, world, port = (int(a) for a in argv[:3])
    cases, out = json.load(open(argv[3])), argv[4]
    torch.set_num_threads(1)
    distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       platform="cpu")
    mesh = make_mesh(1, world, device_type="cpu")
    for case in cases:
        if case.get("grid"):
            axis = distributed.AxisGroup(mesh.get_group("agents"), world, rank)
            g = cc.build_pcell_grid_sharded(
                torch.from_numpy(np.load(case["grid"])),
                cc.PCellSpec(*case["spec"]), axis)
            np.savez(os.path.join(out, f"{case['name']}_{rank}.npz"),
                     **{k: v.numpy() for k, v in g._asdict().items()})
            continue
        try:
            r, x, ovf, *traj = run_case(case, mesh)
        except ValueError as e:
            if not case.get("may_raise"):
                raise
            np.savez(os.path.join(out, f"{case['name']}_{rank}.npz"),
                     error=str(e))
            continue
        np.savez(os.path.join(out, f"{case['name']}_{rank}.npz"),
                 rewards=r.numpy(), x=x.numpy(), overflow=int(ovf),
                 **({"traj": traj[0].numpy()} if traj else {}))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
