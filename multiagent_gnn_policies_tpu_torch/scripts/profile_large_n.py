"""A ``torch.profiler`` trace of one steady large-N episode on the card and
its per-operation breakdown: the counterpart of the JAX package's
``scripts/profile_large_n.py``.

A greedy K = 3 policy (hidden 32x2, seeded random weights) runs a warm
episode (the kernels' build is in it), a timed episode (ms per step by the
host clock, synchronised once), then one episode under
``utils/profiling.trace`` into ``--out/trace.json``. Printed from the
trace through ``utils/profiling.summarize_trace``: device busy ms and idle
share per step, device operations per step; then every device operation
by self time: ms over the episode, share of the device time, and count.
K1, K2 and K3 appear under their kernel names (``frame_kernel``,
``apply_deg_kernel<...>``, ``apply_kernel<...>``) on the pcells path;
``--path`` profiles another graph backend (``rollout_large``'s paths).
These episodes run the eager loop of steps (``graph=False``). On the card
on the pcells path the same three episodes then run through the episode
program's CUDA graph (its capture in the first), the third traced into
``--out/graph/trace.json``: ms per step, device busy ms and idle share,
device operations per step; its reward must equal the eager one's.

    python -m multiagent_gnn_policies_tpu_torch.scripts.profile_large_n \\
        [--n 100000] [--path pcells] [--steps 25] [--edge-mult 2 --cap 32] \\
        [--device cpu]

The JAX script's ``--force-n-dev`` is left out: the port profiles one
device's program (``scripts/bench_scaling.py`` times the emulated bands).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams,
    strict_fp32,
)
from multiagent_gnn_policies_tpu_torch.parallel import large_n as ln
from multiagent_gnn_policies_tpu_torch.scripts._common import (
    add_device_arg,
    device_line,
    device_of,
    seeded_actor,
    timed,
)
from multiagent_gnn_policies_tpu_torch.utils.profiling import (
    summarize_trace,
    trace,
    trace_events,
)

TOP = 25             # rows of the per-operation table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Profile one steady large-N episode; per-operation "
                    "device time table.")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--path", default="pcells", choices=ln.PATHS)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--edge-mult", type=float, default=1.0,
                    help="pcells cell-edge multiple (make_pcell_spec)")
    ap.add_argument("--cap", type=int, default=None,
                    help="cell slot capacity (default 16 pcells, 12 "
                         "cells, 32 binned)")
    ap.add_argument("--out", default=os.path.join("runs", "torch",
                                                  "profile_large_n"),
                    help="directory of the Chrome trace (trace.json)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    strict_fp32()
    print(device_line(device), flush=True)
    acfg, actor = seeded_actor(3, 0, device)
    p = FlockingParams(n_agents=args.n, episode_steps=args.steps,
                       max_resets=2)

    def run(seed, graph=False):
        gen = torch.Generator(device=device).manual_seed(seed)
        r, _, ovf = ln.rollout_large(actor, acfg, gen, p,
                                     return_overflow=True,
                                     cell_edge_mult=args.edge_mult,
                                     cap=args.cap, device=device,
                                     path=args.path, graph=graph)
        return float(r.sum()), int(ovf)

    with torch.no_grad():
        (tot, ovf), s = timed(lambda: run(3), device)
        print(f"warm episode: {s:.2f} s reward={tot:.4f} overflow={ovf}",
              flush=True)
        (tot, ovf), s = timed(lambda: run(4), device)
        wall_ms = 1e3 * s / args.steps
        print(f"timed episode: {s:.4f} s = {wall_ms:.4f} ms/step "
              f"(overflow={ovf})", flush=True)
        with trace(args.out) as prof:
            (tot, ovf), s = timed(lambda: run(5), device)
    prof_ms = 1e3 * s / args.steps
    print(f"traced episode: {s:.4f} s = {prof_ms:.4f} ms/step "
          f"(overflow={ovf}) -> {os.path.join(args.out, 'trace.json')}",
          flush=True)
    summary = summarize_trace(trace_events(prof), args.steps, wall_ms, prof_ms,
                              top=0)
    if summary:
        by_name = summary["by_name"]
        grand = sum(us for us, _ in by_name.values())
        print(f"total device-op time: {grand / 1e3:.4f} ms over "
              f"{args.steps} steps", flush=True)
        print(f"{'op':64s} {'ms':>9s} {'%':>6s} {'count':>6s}", flush=True)
        for name, (us, cnt) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][0])[:TOP]:
            print(f"{name[:64]:64s} {us / 1e3:9.4f} "
                  f"{100 * us / max(grand, 1e-9):6.2f} {cnt:6d}", flush=True)
    if device.type == "cuda" and args.path == "pcells":
        with torch.no_grad():
            (gtot, govf), s = timed(lambda: run(3, True), device)
            print(f"graph: first episode {s:.2f} s (capture included)",
                  flush=True)
            (gtot, govf), s = timed(lambda: run(4, True), device)
            g_ms = 1e3 * s / args.steps
            with trace(os.path.join(args.out, "graph")) as gprof:
                (gtot, govf), s = timed(lambda: run(5, True), device)
        g = summarize_trace(trace_events(gprof), args.steps, g_ms,
                            1e3 * s / args.steps, top=0)
        print(f"graph episode: {g_ms:.4f} ms/step (overflow={govf}, reward "
              f"{'equal to' if gtot == tot else 'UNLIKE'} the eager "
              f"episode's); traced: "
              + (f"device busy {g['busy_ms']:.4f} ms/step, idle "
                 f"{g['idle']:.4f}, {g['ops_per_step']:.2f} device ops/step"
                 if g else "not measured"), flush=True)
        ovf, tot = max(ovf, govf), tot if gtot == tot else math.nan
    return 0 if ovf == 0 and math.isfinite(tot) else 1


if __name__ == "__main__":
    sys.exit(main())
