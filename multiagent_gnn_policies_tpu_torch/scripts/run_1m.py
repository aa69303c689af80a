"""The 1,000,000-agent full-horizon policy rollout on one card: the
counterpart of the JAX package's ``scripts/run_1m.py``.

A greedy K = 3 policy (hidden 32x2, seeded random weights) on
FlockingRelative-v0 at N = 1,000,000 for T = 200 steps (the reference
horizon) through the pcells path, with cells of twice the minimum edge and
32 slots (``--edge-mult 2 --cap 32``, the JAX defaults): a first episode,
then a steady one. Each prints its reward sum, grid overflow, ms per step
(the host clock, synchronised once per episode) and the wrappers' calls
(the counters zeroed just before it; a CUDA graph's replay calls none).
On the card the steady episode runs once more under torch.profiler, and
the kernels' launches are read from its trace. ``--traj out.npz`` writes
the steady episode's ``x (T, M, 4)`` for M = 2,000 evenly spaced agents,
``reward (T,)``, ``final_x (N, 4)`` and ``subset_indices (M,)``, the JAX
file's schema.

Exit 1 unless both episodes have overflow 0 and finite rewards, and, on
the card, the traced episode launched K1 T+1 times and K2 and K3 T times
each on the device.

    python -m multiagent_gnn_policies_tpu_torch.scripts.run_1m \\
        [--n 1000000] [--steps 200] [--chunks 4] [--traj out.npz] \\
        [--device cpu]

``--chunks`` (the JAX script's, default 4) runs each episode as that many
chunks of steps (``rollout_large(scan_chunks=)``): on the card one CUDA
graph of T/4 steps replayed 4 times, captured in the first episode.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams,
    strict_fp32,
)
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as cc
from multiagent_gnn_policies_tpu_torch.parallel import large_n as ln
from multiagent_gnn_policies_tpu_torch.scripts._common import (
    add_device_arg,
    device_line,
    device_of,
    seeded_actor,
    timed,
)

TRAJ_AGENTS = 2000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The N = 1,000,000 T = 200 pcells policy rollout.")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--edge-mult", type=float, default=2.0,
                    help="pcells cell-edge multiple (make_pcell_spec)")
    ap.add_argument("--cap", type=int, default=32,
                    help="cell slot capacity")
    ap.add_argument("--chunks", type=int, default=4,
                    help="chunks of steps per episode (scan_chunks)")
    ap.add_argument("--traj", default=None,
                    help="write a 2000-agent subset trajectory .npz here")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    strict_fp32()
    print(device_line(device), flush=True)
    acfg, actor = seeded_actor(3, 0, device)
    p = FlockingParams(n_agents=args.n, episode_steps=args.steps)
    traj_agents = min(TRAJ_AGENTS, args.n) if args.traj else 0
    t = args.steps
    want = {"frame_sweep": t + 1, "apply_deg_sweep": t, "apply_sweep": t}
    mode = ("CUDA graph" if device.type == "cuda"
            else "program body on the CPU")

    def episode(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        cc.reset_launch_counts()
        out, s = timed(lambda: ln.rollout_large(
            actor, acfg, gen, p, return_overflow=True,
            cell_edge_mult=args.edge_mult, cap=args.cap, device=device,
            traj_agents=traj_agents, scan_chunks=args.chunks), device)
        launches = cc.launch_counts()
        r, final_x, ovf = out[:3]
        tot = float(r.sum())
        ok = int(ovf) == 0 and math.isfinite(tot)
        return out, tot, int(ovf), s, launches, ok

    with torch.no_grad():
        _, tot, ovf, s, launches, ok1 = episode(11)
        print(f"N={args.n} pcells POLICY k=3 T={t} edge_mult="
              f"{args.edge_mult} cap={args.cap} chunks={args.chunks} "
              f"{mode}: first episode "
              f"reward_sum={tot:.4f} overflow={ovf} ({s:.2f} s, "
              f"{1e3 * s / t:.4f} ms/step, build and reset included) "
              f"launches {launches}", flush=True)
        out, tot2, ovf2, s, launches, ok2 = episode(12)
        print(f"steady: {1e3 * s / t:.4f} ms/step reward={tot2:.4f} "
              f"overflow={ovf2} launches {launches} ({s:.3f} s, reset "
              f"included)", flush=True)
        if device.type == "cuda":
            (_, tot3, _, _, _, ok3), by_cols = cc.device_launches(
                lambda: episode(12))
            on_device = {w: sum(by.values()) for w, by in by_cols.items()}
            print(f"traced: reward={tot3:.4f}, launches on the device "
                  f"{on_device}", flush=True)
            ok2 = ok2 and ok3 and tot3 == tot2 and on_device == want
    if args.traj:
        r, final_x, _, traj = out
        np.savez(args.traj, x=traj.cpu().numpy(), reward=r.cpu().numpy(),
                 final_x=final_x.cpu().numpy(),
                 subset_indices=ln.traj_subset_indices(
                     args.n, traj_agents).to(torch.int32).numpy())
        print(f"trajectory -> {args.traj}", flush=True)
    ok = ok1 and ok2
    if device.type == "cuda":
        print(f"launches wanted on the device per episode {want}",
              flush=True)
    print(f"rc={0 if ok else 1}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
