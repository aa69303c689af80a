"""Expert-rollout smoke test for every environment on the card: the
counterpart of the JAX package's ``scripts/smoke_env.py``.

Each episode rolls the dense env under the analytic expert (centralized,
or the local-information expert with ``--decentralized``) and prints its
reward and the velocity disagreement at its first and last step; an
episode that is not finite, or whose disagreement neither falls nor ends
below 0.1, is SUSPECT and makes the script exit 1. ``--save out.npz``
writes the last env's last episode as ``x (T, N, 4)`` and ``reward
(T,)``, the schema ``scripts/render_trajectory.py`` reads.

    python -m multiagent_gnn_policies_tpu_torch.scripts.smoke_env
    python -m multiagent_gnn_policies_tpu_torch.scripts.smoke_env \\
        --env FlockingLeader-v0 --episodes 5 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    ENV_REGISTRY,
    FlockingParams,
    make_env,
    strict_fp32,
)
from multiagent_gnn_policies_tpu_torch.scripts._common import (
    add_device_arg,
    device_line,
    device_of,
)


def rollout_expert(env, gen: torch.Generator, centralized: bool):
    """One expert episode: the states after each step ``(T, N, 4)`` and
    the rewards ``(T,)``, on the host."""
    xs, rs = [], []
    with torch.no_grad():
        state, _ = env.reset(gen)
        for _ in range(env.params.episode_steps):
            a = env.controller(state, centralized=centralized)
            state, _, r, _ = env.step(state, a, gen)
            xs.append(state.x)
            rs.append(r)
    return torch.stack(xs).cpu().numpy(), torch.stack(rs).cpu().numpy()


def velocity_disagreement(x: np.ndarray) -> float:
    """Mean squared deviation of each agent's velocity from the swarm
    mean: the flocking cost whose negative is the reward."""
    v = x[:, 2:4]
    return float(np.mean(np.sum((v - v.mean(axis=0)) ** 2, axis=-1)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="An expert episode per env: reward and velocity "
                    "disagreement, SUSPECT episodes exit 1.")
    ap.add_argument("--env", default=None, choices=sorted(ENV_REGISTRY),
                    help="single env id (default: every registered env)")
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--n-agents", type=int, default=100)
    ap.add_argument("--comm-radius", type=float, default=1.0)
    ap.add_argument("--v-max", type=float, default=3.0)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decentralized", action="store_true",
                    help="use the local-information expert")
    ap.add_argument("--save", default=None,
                    help="write the last episode's trajectory to this .npz "
                         "(keys: x (T,N,4), reward (T,))")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    strict_fp32()
    print(device_line(device), flush=True)

    params = FlockingParams(n_agents=args.n_agents,
                            comm_radius=args.comm_radius, v_max=args.v_max,
                            dt=args.dt)
    names = [args.env] if args.env else sorted(ENV_REGISTRY)
    centralized = not args.decentralized
    gen = torch.Generator(device=device).manual_seed(args.seed)
    failures = 0
    for name in names:
        env = make_env(name, params)
        for ep in range(args.episodes):
            t0 = time.perf_counter()
            xs, rs = rollout_expert(env, gen, centralized)
            elapsed = time.perf_counter() - t0
            total = float(rs.sum())
            vd0 = velocity_disagreement(xs[0])
            vd1 = velocity_disagreement(xs[-1])
            ok = np.isfinite(xs).all() and np.isfinite(rs).all()
            # a sane expert reduces the velocity disagreement over the
            # episode (the stochastic env may keep a small noise floor)
            improved = vd1 < vd0 or vd1 < 0.1
            status = "ok" if (ok and improved) else "SUSPECT"
            failures += status != "ok"
            print(f"{name} ep{ep}: reward={total:9.2f}  "
                  f"vel-disagreement {vd0:7.3f} -> {vd1:7.3f}  "
                  f"[{len(rs)} steps, {elapsed:.2f}s]  {status}",
                  flush=True)
        if args.save and name == names[-1]:
            np.savez(args.save, x=xs, reward=rs)
            print(f"# trajectory ({xs.shape[0]} steps, N={xs.shape[1]}) "
                  f"-> {args.save}", flush=True)
    if failures:
        print(f"{failures} suspect episode(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
