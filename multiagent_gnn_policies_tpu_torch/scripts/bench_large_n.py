"""Large-N steps per second on the card, per N and graph path: the
counterpart of the JAX package's ``scripts/bench_large_n.py``.

For each N and path (``pcells``, the O(N) cell sweeps; ``cells``, the
dense cell grid, and ``binned``, the spatial-hash neighbour list, both
run only up to N = 100,000: at 1,000,000 a cells sweep holds 1.3·10^9
slot pairs and a binned gather (N, 288, C) blocks of ~4.6 GB; ``blocked``,
the O(N²) row-blocked sweeps, run only up to N = 32,768: at 100,000 its
frame is ~10^10 pairs per step) a greedy K = 3 policy (hidden 32x2,
seeded random weights) runs:

* a first episode, timed alone (the kernels' build, at the first pcells
  run of the process, is in it);
* ``--repeats`` chains of ``--episodes`` episodes each
  (``rollout_large(n_episodes=...)``), each chain synchronised once at its
  end: ms per step and steps per second by the host clock, their median
  and spread (min..max) over the chains; edges per second (K times the
  final frame's directed radius edges per step); the max overflow and the
  non-finite episodes (a chain with either withholds its rate);
* one episode under ``torch.profiler``: device-busy ms per step, the idle
  share against the median's wall ms per step, device operations per step.

On every path each of ``--graphs`` is a row: ``eager`` (the eager loop
of steps, ``graph=False``) and ``graph`` (the episode program's CUDA
graphs, on the card only), their chains timed in turn; the eager row
adds its first episode's peak allocation (MB over what was allocated
before it), the graph row its steps per graph, a graph's nodes, its
capture and instantiate seconds and its memory pool's growth (MB) over
the captures, each (N, path)'s programs captured into a new pool.

    python -m multiagent_gnn_policies_tpu_torch.scripts.bench_large_n
    python -m multiagent_gnn_policies_tpu_torch.scripts.bench_large_n \\
        --n 10000 --paths blocked cells binned pcells --steps 25 \\
        [--graphs eager graph] [--device cpu]

Default sizes 10,000, 32,768, 100,000 and 1,000,000, paths blocked, cells
and pcells (the JAX script's), edge_mult 1, cap the path's default (16
pcells, 12 cells, 32 binned).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

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
    sync,
    timed,
)
from multiagent_gnn_policies_tpu_torch.utils.profiling import (
    summarize_trace,
    trace_events,
)

SIZES = (10_000, 32_768, 100_000, 1_000_000)
PATHS = ("blocked", "cells", "pcells")
# the largest N run on a path (pcells runs every N)
MAX_N = {"blocked": 32_768, "cells": 100_000, "binned": 100_000}
TOP = 5              # device operations listed per profiled episode


def bench_one(n, path, args, actor, acfg, device):
    """The (N, path) rows, one per mode of ``args.graphs``: a list of each
    row's numbers (rates None when withheld)."""
    p = FlockingParams(n_agents=n, episode_steps=args.steps, max_resets=2)
    kw = dict(return_overflow=True, cap=args.cap,
              cell_edge_mult=args.edge_mult, device=device, path=path)
    cfg = ln.make_config(p, path=path, cap=args.cap,
                         cell_edge_mult=args.edge_mult)
    modes = []
    for mode in args.graphs:
        if mode != "eager" and device.type != "cuda":
            print(f"N={n:>8} {path:>8} {mode:>8}: skipped (a CUDA graph "
                  f"needs the card)", flush=True)
        else:
            modes.append(mode)

    def chain(mode, seed, episodes):
        gen = torch.Generator(device=device).manual_seed(seed)
        return ln.rollout_large(actor, acfg, gen, p, n_episodes=episodes,
                                graph=mode == "graph",
                                **kw)

    rows = {}
    ln.clear_programs()       # each N's programs capture into a new pool
    for mode in modes:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        (r, x, ovf), first_s = timed(lambda: chain(mode, 3, 1), device)
        row = rows[mode] = {
            "n": n, "path": path, "mode": mode, "first_s": first_s, "ms": [],
            "overflow": int(ovf), "busy_ms": None, "idle": None, "ops": None,
            "nonfinite": int(not bool(torch.isfinite(r.sum()))),
            "capture_s": None, "instantiate_s": None, "pool_mb": None,
            "steps_per_graph": None, "nodes": None,
            # the first episode's peak allocation over its start
            "peak_mb": ((torch.cuda.max_memory_allocated(device) - base)
                        / 2**20 if device.type == "cuda" else None)}
        if mode != "eager":
            prog = ln.episode_program(cfg, acfg, args.steps, device)
            row.update(capture_s=prog.capture_s,
                       instantiate_s=prog.instantiate_s,
                       pool_mb=prog.pool_mb,
                       steps_per_graph=prog.steps_per_graph,
                       nodes=prog.nodes)
    for rep in range(args.repeats):       # the modes' chains in turn
        for mode in modes:
            row = rows[mode]
            (r, x, ovf), s = timed(lambda: chain(mode, 4 + rep,
                                                 args.episodes), device)
            row["ms"].append(1e3 * s / (args.episodes * args.steps))
            row["overflow"] = max(row["overflow"], int(ovf))
            row["nonfinite"] += int(
                (~torch.isfinite(r.reshape(args.episodes, -1).sum(1))).sum())
    # the final frame's directed radius edges, which each of the K hops
    # aggregates once per step
    edges = args.k * float(ln._frame(cfg, x)[0].degree.sum())
    fmt = lambda v, f: "not measured" if v is None else format(v, f)
    for mode in modes:
        row = rows[mode]
        ms, max_ovf, bad = row["ms"], row["overflow"], row["nonfinite"]
        med = statistics.median(ms)
        row["median_ms"] = med
        valid = max_ovf == 0 and bad == 0
        graph = (f" | peak {fmt(row['peak_mb'], '.1f')} MB"
                 if mode == "eager" else
                 f" | {row['steps_per_graph']} steps per graph, "
                 f"{row['nodes']} nodes a graph, capture "
                 f"{row['capture_s']:.3f} s, "
                 f"instantiate {row['instantiate_s']:.3f} s, pool "
                 f"{row['pool_mb']:.1f} MB")
        print(f"N={n:>8} {path:>8} {mode:>8}: first episode {row['first_s']:8.2f}"
              f" s | "
              + (f"{1e3 / med:9.1f} steps/s | {1e3 / med * edges:.3e} "
                 f"edges/s | {med:9.4f} ms/step (median of {args.repeats}, "
                 f"{min(ms):.4f}..{max(ms):.4f}) | " if valid else
                 "INVALID: rates withheld | ")
              + f"overflow={max_ovf} nonfinite_eps={bad}" + graph,
              flush=True)
        if valid:
            from torch.profiler import ProfilerActivity, profile

            # the device's activity alone on the card: host operations
            # would add events that no number here reads
            acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
                    else [ProfilerActivity.CPU])
            with profile(activities=acts) as prof:
                _, s = timed(lambda: chain(mode, 99, 1), device)
            summary = summarize_trace(trace_events(prof), args.steps, med,
                                      1e3 * s / args.steps, top=TOP)
            if summary:
                row.update(busy_ms=summary["busy_ms"], idle=summary["idle"],
                           ops=summary["ops_per_step"])
        row.update(steps_per_s=1e3 / med if valid else None,
                   edges_per_s=1e3 / med * edges if valid else None)
    return list(rows.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Large-N steps per second per N and path, repeated, "
                    "with one profiled episode each.")
    ap.add_argument("--n", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--paths", nargs="+", default=list(PATHS),
                    choices=ln.PATHS)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--episodes", type=int, default=2,
                    help="episodes per timed chain (one sync per chain)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed chains per configuration")
    ap.add_argument("--edge-mult", type=float, default=1.0,
                    help="pcells cell-edge multiple (make_pcell_spec)")
    ap.add_argument("--cap", type=int, default=None,
                    help="cell slot capacity (default 16 pcells, 12 cells, "
                         "32 binned)")
    ap.add_argument("--k", type=int, default=3, help="the policy's K")
    ap.add_argument("--graphs", nargs="+", default=["eager", "graph"],
                    choices=("eager", "graph"),
                    help="modes, timed in turn: the eager loop of steps, "
                         "and the episode program's CUDA graphs (on the "
                         "card only)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    strict_fp32()
    print(device_line(device), flush=True)
    acfg, actor = seeded_actor(args.k, 0, device)
    rows = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for n in args.n:
            for path in args.paths:
                if n > MAX_N.get(path, n):
                    print(f"N={n:>8} {path:>8}: skipped (above N = "
                          f"{MAX_N[path]} on this path)", flush=True)
                    continue
                rows += bench_one(n, path, args, actor, acfg, device)
    sync(device)
    print(f"# summary ({time.perf_counter() - t0:.1f} s): N, path, mode, "
          f"median ms/step, spread, steps/s, busy ms/step, idle share, "
          f"device ops/step, steps per graph, nodes a graph, capture s, "
          f"instantiate s, pool MB", flush=True)
    fmt = lambda v, f: "not measured" if v is None else format(v, f)
    for r in rows:
        print(f"#   {r['n']:>8} {r['path']:>8} {r['mode']:>8} "
              f"{r['median_ms']:.4f} {min(r['ms']):.4f}..{max(r['ms']):.4f} "
              f"{fmt(r['steps_per_s'], '.1f')} {fmt(r['busy_ms'], '.4f')} "
              f"{fmt(r['idle'], '.4f')} {fmt(r['ops'], '.2f')}"
              + ("" if r["mode"] == "eager" else
                 f" {r['steps_per_graph']} {r['nodes']} "
                 f"{r['capture_s']:.4f} {r['instantiate_s']:.4f} "
                 f"{r['pool_mb']:.1f}"), flush=True)
    bad = [r for r in rows if r["overflow"] or r["nonfinite"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
