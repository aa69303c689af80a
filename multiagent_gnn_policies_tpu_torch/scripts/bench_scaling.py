"""Multi-device scaling of the agent-sharded large-N rollout: the
counterpart of the JAX package's ``scripts/bench_scaling.py``.

Two modes, labelled as such in the output:

* ``--mode band`` (one process, one device): for each simulated axis size
  D, the rollout with ``force_n_dev = D`` on a one-rank mesh (a process
  group of one, NCCL on the card, gloo on the CPU): every step runs rank
  0's program of a D-rank mesh (its 1/D share of the grid build's sort,
  its band of cx/D grid rows through K1-K3, the actor and dynamics on N/D
  agents) with each collective replaced by a local operation of the same
  shape (``parallel.distributed.AxisGroup``). D = 1 is the real one-rank
  mesh. The time is one rank's compute in a D-rank mesh; the
  interconnect is excluded and reported from the shapes instead (MB per
  step of the collectives' tensors). Rewards of an emulated run are not
  valid. The same rollout with no mesh (one process, no process group)
  is timed first, as row D = 0. Per D: ms per step (median of
  ``--repeats`` chains of ``--episodes`` episodes, each synchronised
  once, with the spread), the
  busy ms and idle share of one profiled episode, K1, K2 and K3's device
  ms per step in it (the band's kernels), and the efficiency proxy
  eff(D) = t(1) / (D · t(D)) by the wall ms and by the busy ms. On the
  card, before the rollouts, each kernel's band launches on a real grid
  (a lattice draw at N): for each D, the slowest of the D bands of K1 (as
  ``frame_apply`` launches it: the band with its halo rows), K2 on 12
  columns and K3 on 6, by CUDA events, beside the bound of the band's
  own bytes and operations (``scripts/verify_cells.py``'s model on the
  band's agents; the neighbour structure pro rata), and each collective
  of a one-rank mesh's step on its own, at the step's shapes: the host
  µs a call takes to issue (100 calls, no synchronisation between them)
  and its device ms (CUDA events).

Each of ``--graphs`` is a row per D, in both modes, on every path:
``eager`` (the eager loop of steps, ``graph=False``) and ``graph`` (the
episode program's CUDA graphs, on the card only: on a mesh the band's
NCCL collectives are captured in them; emulated, they hold none), with
the busy ms, idle share and device operations per step of one profiled
episode each, and the graph row's steps per graph and nodes.
* ``--mode mesh``: real ranks, one subprocess per rank (gloo on the CPU
  with ``--device cpu``; NCCL on the card, only for D up to the cards the
  machine has): the same rollout over a D-rank mesh, rank 0's ms per
  step. On the CPU the times are no scaling signal; the mode shows the
  sharded program runs.

    python -m multiagent_gnn_policies_tpu_torch.scripts.bench_scaling \\
        --n 100000 [--devs 1 2 4 8] [--steps 25] [--device cpu]
    python -m multiagent_gnn_policies_tpu_torch.scripts.bench_scaling \\
        --mode mesh --n 4096 --devs 1 2 4 --path cells --device cpu
    [--graphs eager graph]

The policy: K = 3, hidden 32x2, seeded random weights, FlockingRelative,
on ``--path`` (the JAX script's choices: pcells, the default, with edge_mult
1 and cap 16; cells, cap 12; blocked; and the port's binned, cap 32) in
both modes. The band kernels and the collectives are timed on the pcells
path only: the other paths launch no cell kernel, and their collectives
are the frame's and the applies' tables (``collective_mb``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import time

import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams,
    strict_fp32,
)
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as cc
from multiagent_gnn_policies_tpu_torch.parallel import distributed
from multiagent_gnn_policies_tpu_torch.parallel import large_n as ln
from multiagent_gnn_policies_tpu_torch.parallel.mesh import make_mesh
from multiagent_gnn_policies_tpu_torch.scripts._common import (
    add_device_arg,
    device_line,
    device_of,
    seeded_actor,
    timed,
)
from multiagent_gnn_policies_tpu_torch.utils.profiling import (
    bound_ms,
    device_ms,
    summarize_trace,
    trace_events,
)

K, F = 3, 6
PATHS = ("pcells", "cells", "blocked", "binned")
MODULE = "multiagent_gnn_policies_tpu_torch.scripts.bench_scaling"
# the directory that holds the package, for the ranks' interpreters
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KERNELS = {"K1": r"\bframe_kernel", "K2": r"\bapply_deg_kernel",
           "K3": r"\bapply_kernel"}


def collective_mb(n: int, spec: cc.PCellSpec, d: int, k: int = K,
                  path: str = "pcells") -> float:
    """MB per step in the collectives' tensors of a D-rank step (K >= 2
    policy). pcells: the (N, 10 + (K-1)F) frame_apply table and the K-2
    historical applies' (N, (K-1-s)F) tables reduced, the (N, 4) state and
    the grid build's (N, 2) slots and positions and (D, cx·cy) counts
    gathered, the origin reduced. cells, blocked and binned: the (N, 9)
    frame table (reduced or gathered) and min r², the K-1 applies' (N,
    (K-1-s)F) tables reduced or gathered, the (N, 4) state gathered."""
    if path != "pcells":
        floats = 9 * n + 1 + sum(n * (k - 1 - s) * F for s in range(k - 1))
        return 4 * (floats + 4 * n) / 1e6
    floats = n * (10 + (k - 1) * F)
    floats += sum(n * (k - 1 - s) * F for s in range(1, k - 1))
    floats += 4 * n + 2 * n + d * spec.cx * spec.cy + 2
    return 4 * floats / 1e6


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _chain(actor, acfg, p, args, device, mesh, force, seed, episodes,
           mode="eager"):
    gen = torch.Generator(device=device).manual_seed(seed)
    return ln.rollout_large(actor, acfg, gen, p, return_overflow=True,
                            cap=args.cap, cell_edge_mult=args.edge_mult,
                            device=device, n_episodes=episodes, mesh=mesh,
                            force_n_dev=force, path=args.path,
                            graph=mode == "graph")


def modes_of(args, device):
    """The ``--graphs`` modes this run times: a graph needs the card."""
    modes = []
    for mode in args.graphs:
        if mode == "graph" and device.type != "cuda":
            print(f"{mode}: skipped (a CUDA graph needs the card)",
                  flush=True)
        else:
            modes.append(mode)
    return modes


def time_chains(run, args, device):
    """A first episode, then ``--repeats`` timed chains: ms per step of
    each chain."""
    run(3, 1)
    ms = []
    for rep in range(args.repeats):
        _, s = timed(lambda: run(4 + rep, args.episodes), device)
        ms.append(1e3 * s / (args.episodes * args.steps))
    return ms


def band_kernels(args, device, spec):
    """``{D: {kernel: (ms, bound ms, bound by)}}``: the slowest band of
    each kernel's D band launches on a lattice draw at N (D = 1: the full
    launch)."""
    from multiagent_gnn_policies_tpu_torch.envs.flocking import (
        _init_candidate)
    from multiagent_gnn_policies_tpu_torch.scripts.verify_cells import (
        apply_work, frame_work, neighbour_bytes)

    p = FlockingParams(n_agents=args.n)
    gen = torch.Generator(device=device).manual_seed(1)
    x = _init_candidate(gen, p, device)
    pos = x[:, :2].contiguous()
    grid = cc.build_pcell_grid(pos, spec)
    deg = cc.frame_sweep(x, grid, spec, 1.0, True)[:, 6].contiguous()
    cols = torch.randn((args.n, 12), generator=gen, device=device)
    nb = neighbour_bytes(grid, spec)
    row = (grid.slot.clamp_min(0) // (spec.cap * spec.cy))
    out = {}
    for d in args.devs:
        if spec.cx % d:
            continue
        worst = {}
        for r in range(d):
            band = cc.row_band(spec, d, r)
            halo = cc.halo_band(spec, band)
            own = cc.band_agents(grid, spec, band)
            n_in = int(((grid.slot >= 0) & (row >= halo[0])
                        & (row < halo[0] + halo[1])).sum())
            n_own = int(own.sum())
            cand, nbr = _band_pairs(pos, grid, spec, own)
            nb_in = nb * n_in // args.n
            work = {
                "K1": frame_work(n_own, cand, nbr, nb_in),
                "K2": apply_work(n_own, 12, cand, nbr, nb_in, False),
                "K3": apply_work(n_own, 6, cand, nbr, nb_in, True)}
            # the halo agents' inputs too: K1's state, K2's and K3's
            # position, degree and 12 or 6 columns
            halo_bytes = [(n_in - n_own) * b for b in (16, 60, 36)]
            runs = {
                "K1": lambda: cc.frame_sweep(x, grid, spec, 1.0, True,
                                             band=halo),
                "K2": lambda: cc.apply_deg_sweep(x, cols, deg, grid, spec,
                                                 1.0, band=band),
                "K3": lambda: cc.apply_sweep(pos, cols[:, 6:], deg, grid,
                                             spec, 1.0, band=band)}
            for q, name in enumerate(("K1", "K2", "K3")):
                ms = device_ms(runs[name])
                b_ms, b_by = bound_ms(work[name][0] + halo_bytes[q],
                                      work[name][1])
                if ms > worst.get(name, (0.0,))[0]:
                    worst[name] = (ms, b_ms, b_by)
        out[d] = worst
        print(f"D={d} band kernels (slowest of {d} bands): "
              + ", ".join(f"{k} {v[0]:.4f} ms (bound {v[1]:.5f}, {v[2]})"
                          for k, v in worst.items()), flush=True)
    return out


def _band_pairs(pos, grid, spec, own, chunk=1 << 17):
    """(candidate pairs, radius-neighbour pairs) of the agents ``own``."""
    n = pos.shape[0]
    cand = nbr = 0
    for r0 in range(0, n, chunk):
        rows = slice(r0, min(r0 + chunk, n))
        valid, _, _, _, r2 = cc._pair_geometry(
            pos, cc._candidates(grid, spec, rows), rows)
        valid &= own[rows, None]
        cand += int(valid.sum())
        nbr += int((valid & (r2 < 1.0)).sum())
    return cand, nbr


def band_row(d, actor, acfg, p, args, device, mesh, mode):
    """One D of band mode (D = 0: no mesh) in one of ``--graphs``' modes:
    its numbers, returned."""
    force = None if d <= 1 else d
    run = lambda seed, eps: _chain(actor, acfg, p, args, device,
                                   mesh if d else None, force, seed, eps,
                                   mode)
    ms = time_chains(run, args, device)
    med = statistics.median(ms)
    row = {"D": d, "mode": mode, "ms": med, "spread": [min(ms), max(ms)],
           "busy_ms": None, "idle": None, "ops": None, "kernel_ms": None,
           "steps_per_graph": None, "nodes": None}
    if mode == "graph":
        prog = ln.episode_program(ln.make_config(
            p, path=args.path, cap=args.cap, cell_edge_mult=args.edge_mult,
            mesh=mesh if d else None, force_n_dev=force), acfg, args.steps,
            device)
        row.update(steps_per_graph=prog.steps_per_graph, nodes=prog.nodes)
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
            else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        _, s = timed(lambda: run(99, 1), device)
    summary = summarize_trace(trace_events(prof), args.steps, med,
                              1e3 * s / args.steps, top=3)
    if summary and device.type == "cuda":
        kms = {}
        for name, pattern in KERNELS.items():
            us = sum(v[0] for op, v in summary["by_name"].items()
                     if re.search(pattern, op))
            kms[name] = us / 1e3 / args.steps
        row.update(busy_ms=summary["busy_ms"], idle=summary["idle"],
                   ops=summary["ops_per_step"], kernel_ms=kms)
    return row


def collectives(args, device, spec, axis, reps=100):
    """``{collective: (host us per call, device ms per call)}`` of the six
    collectives of a one-rank mesh's K = 3 pcells step, at its shapes."""
    n, ncell = args.n, spec.cx * spec.cy
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    calls = {
        "origin all_reduce MIN (2,)": lambda t=torch.zeros(2, **f32):
            axis.all_reduce(t, torch.distributed.ReduceOp.MIN),
        "counts all_gather (1, cx*cy)": lambda t=torch.zeros(
            (1, ncell), **i32): axis.all_gather(t),
        "slots all_gather (N, 2)": lambda t=torch.zeros((n, 2), **i32):
            axis.all_gather(t),
        "frame_apply all_reduce (N, 22)": lambda t=torch.zeros(
            (n, 10 + 2 * F), **f32): axis.all_reduce(t),
        "K3 all_reduce (N, 6)": lambda t=torch.zeros((n, F), **f32):
            axis.all_reduce(t),
        "state all_gather (N, 4)": lambda t=torch.zeros((n, 4), **f32):
            axis.all_gather(t),
    }
    out = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            call()
        host_us = 1e6 * (time.perf_counter() - t) / reps
        out[name] = (host_us, device_ms(call, reps))
        print(f"one-rank {name}: {host_us:.1f} us to issue, "
              f"{out[name][1]:.4f} ms on the device", flush=True)
    return out


def band_mode(args, device):
    platform = "cpu" if device.type == "cpu" else None
    distributed.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                       platform)
    mesh = make_mesh(1, 1, device_type=device.type)
    if device.type == "cuda" and args.path == "pcells":
        from multiagent_gnn_policies_tpu_torch.parallel.mesh import (
            axis_group)

        collectives(args, device, cc.make_pcell_spec(
            FlockingParams(n_agents=args.n), cap=args.cap or 16,
            edge_mult=args.edge_mult), axis_group(mesh))
    acfg, actor = seeded_actor(K, 0, device)
    p = FlockingParams(n_agents=args.n, episode_steps=args.steps,
                       max_resets=2)
    rows = []
    with torch.no_grad():
        for d in [0, *args.devs]:
            for mode in args.modes:
                rows.append(band_row(d, actor, acfg, p, args, device, mesh,
                                     mode))
    ln.clear_programs()              # their graphs name this group
    torch.distributed.destroy_process_group()
    return rows


def mesh_rank(args) -> int:
    """One rank of ``--mode mesh`` (a subprocess of :func:`mesh_mode`):
    prints rank 0's JSON line, a list of one row per mode."""
    rank, world, port = args.rank_of
    platform = "cpu" if args.device == "cpu" else None
    if args.device == "cpu":
        torch.set_num_threads(1)
    distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       platform)
    device = distributed.local_device(platform)
    mesh = make_mesh(1, world, device_type=args.device)
    acfg, actor = seeded_actor(K, 0, device)
    p = FlockingParams(n_agents=args.n, episode_steps=args.steps,
                       max_resets=2)
    rows = []
    with torch.no_grad():
        for mode in modes_of(args, device):
            run = lambda seed, eps: _chain(actor, acfg, p, args, device,
                                           mesh, None, seed, eps, mode)
            ms = time_chains(run, args, device)
            r, _, ovf = run(3, 1)
            rows.append({"D": world, "mode": mode, "ms": statistics.median(ms),
                         "spread": [min(ms), max(ms)],
                         "reward": float(r.sum()), "overflow": int(ovf)})
    if rank == 0:
        print(json.dumps(rows), flush=True)
    ln.clear_programs()
    torch.distributed.destroy_process_group()
    return 0


def mesh_mode(args, argv):
    rows = []
    for d in args.devs:
        if args.device == "cuda" and d > torch.cuda.device_count():
            print(f"D={d}: skipped (NCCL needs {d} cards, this machine has "
                  f"{torch.cuda.device_count()})", flush=True)
            continue
        port = free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, os.environ.get("PYTHONPATH", "")]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", MODULE, *argv,
             "--rank-of", str(r), str(d), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(env, LOCAL_RANK=str(r)))
            for r in range(d)]
        outs = [p.communicate(timeout=args.timeout) for p in procs]
        for p, (_, err) in zip(procs, outs):
            if p.returncode:
                raise SystemExit(f"a rank of D={d} failed:\n{err[-3000:]}")
        rows += json.loads(outs[0][0].strip().splitlines()[-1])
    return rows


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        description="Per-rank band timing (force_n_dev) or real ranks of "
                    "the agent-sharded large-N rollout.")
    ap.add_argument("--mode", default="band", choices=("band", "mesh"))
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--path", default="pcells", choices=PATHS)
    ap.add_argument("--devs", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--episodes", type=int, default=1,
                    help="episodes per timed chain (one sync per chain)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed chains per D")
    ap.add_argument("--edge-mult", type=float, default=1.0)
    ap.add_argument("--cap", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a rank of --mode mesh may take")
    ap.add_argument("--graphs", nargs="+", default=["eager", "graph"],
                    choices=("eager", "graph"),
                    help="modes per D, timed one after the other: the "
                         "eager loop of steps, and the episode program's "
                         "CUDA graphs (on the card only)")
    ap.add_argument("--rank-of", type=int, nargs=3, default=None,
                    metavar=("RANK", "WORLD", "PORT"), help=argparse.SUPPRESS)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.rank_of:
        return mesh_rank(args)
    device = device_of(args.device)
    strict_fp32()
    print(device_line(device), flush=True)
    args.modes = modes_of(args, device)
    p = FlockingParams(n_agents=args.n)
    spec = cc.make_pcell_spec(p, cap=args.cap or 16,
                              edge_mult=args.edge_mult,
                              n_dev=max(args.devs))
    t0 = time.perf_counter()
    kernels = {}
    if (args.mode == "band" and device.type == "cuda"
            and args.path == "pcells"):
        with torch.no_grad():
            kernels = band_kernels(args, device, spec)
    rows = (band_mode(args, device) if args.mode == "band"
            else mesh_mode(args, argv))
    label = ("one rank's program, collectives emulated (results not valid "
             "for D > 1)" if args.mode == "band" else "real ranks")
    print(f"# {args.mode} mode, {label}: N = {args.n}, path {args.path}, "
          f"{args.steps} steps "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    fmt = lambda v, f: "not measured" if v is None else format(v, f)
    for r in rows:
        d = r["D"]
        t1 = next((q for q in rows if q["D"] == 1
                   and q["mode"] == r["mode"]), None)
        eff = t1["ms"] / (d * r["ms"]) if t1 and d else None
        eff_busy = (t1["busy_ms"] / (d * r["busy_ms"])
                    if d and t1 and r.get("busy_ms") and t1.get("busy_ms")
                    else None)
        r.update(eff=eff, eff_busy=eff_busy,
                 collective_mb=(collective_mb(args.n, spec, d, path=args.path)
                                if d else 0.0),
                 band_kernels=kernels.get(d))
        kms = r.get("kernel_ms")
        print(f"D={d}{' (no mesh)' if not d else ''} {r['mode']}: "
              f"{r['ms']:.4f} ms/step ({r['spread'][0]:.4f}.."
              f"{r['spread'][1]:.4f}), busy {fmt(r.get('busy_ms'), '.4f')} "
              f"ms, idle {fmt(r.get('idle'), '.4f')}, "
              f"{fmt(r.get('ops'), '.2f')} device ops/step, K1/K2/K3 "
              + ("/".join(f"{kms[k]:.4f}" for k in KERNELS) if kms
                 else "not measured")
              + f" ms, eff {fmt(eff, '.3f')} (busy {fmt(eff_busy, '.3f')}), "
              f"collectives {r['collective_mb']:.2f} MB/step"
              + (f", {r['steps_per_graph']} steps per graph, {r['nodes']} "
                 f"nodes a graph" if r.get("nodes") else ""), flush=True)
    print(json.dumps({"mode": args.mode, "path": args.path, "n": args.n,
                      "steps": args.steps,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
