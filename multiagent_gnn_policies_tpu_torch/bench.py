"""Headline benchmark on the card: dense DAGGER collection throughput
against the reference's host loop. The counterpart of the top-level
``bench.py``.

    python -m multiagent_gnn_policies_tpu_torch.bench [--device cuda]

Prints ONE JSON line on stdout:

    {"metric": "rollout_steps_per_s", "value": ..., "unit": "env steps/s",
     "vs_baseline": ...}

The measured quantity is DAGGER collection on the canonical config
(FlockingRelative-v0, N = 100 agents, K = 3 delayed-aggregation GNN of
hidden 32x2 with seeded random weights, T = 200-step episodes, beta 0.7,
``cfg/dagger.cfg``): per env step, the double-integrator step, radius
graph, 6-feature observation, expert, delayed-GSO recursion, policy
forward and the DAGGER coin, through the port's
``algos/imitation.py:rollout_episode`` (which keeps the collected
samples; its steps replay the setup's dense episode program, a CUDA
graph captured at the first call of each batch size). It is timed for a single env, for a batch of ``--n-envs``
(128) envs per synchronised call (``--reps`` calls each), and
"sustained": 8 consecutive batches with one synchronisation at the end
(``--chains`` such chains), the headline ``value``. ``--n-envs`` and
``--steps`` shrink the run for the CPU.

``vs_baseline`` divides it by a re-implementation of the reference's hot
loop (a Python per-step loop with a NumPy env on the host, a torch Conv2d
actor, and the dense (K, N, N) delayed-GSO recursion in torch on the
CPU), measured live in a fresh subprocess with one thread: the pinned
protocol of the top-level ``bench.py``.

Detail goes to stderr: each measurement, the baseline with all threads,
and (unless ``--no-large-n``) large-N rollouts of the same policy shape
on the blocked path at N = 10,000 and the pcells path at N = 100,000; a
rollout with grid overflow or a non-finite reward withholds its rate.
``--device cpu`` runs the same loop through the plain versions on the CPU
(no number of it is a device metric); without a card and without it the
script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_AGENTS = 100
K = 3
HIDDEN = (32, 32)
T = 200                  # episode length (cfg/dagger.cfg horizon)
BATCH_ENVS = 128         # envs per batched call
SUSTAIN_REPS = 8         # consecutive batches per sustained chain
BASELINE_STEPS = 60      # steps of the reference-equivalent host loop
BETA = 0.7
COMM_RADIUS = 1.0
EDGES_PER_AGENT = 6.7    # mean radius degree at the canonical density


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Reference-equivalent baseline: host NumPy env + torch actor, per-step loop.
# The top-level bench.py's, kept here so the port needs nothing outside it.
# ---------------------------------------------------------------------------

def bench_reference_baseline(n_steps: int = 60, threads: int = 1) -> float:
    # Pinned measurement protocol: single-threaded torch, fixed n_steps,
    # no warm-up discard; ``threads`` != 1 is measured for comparison.
    torch.set_num_threads(threads)
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    n, k, dt = N_AGENTS, K, 0.01

    # torch actor in the reference's Conv2d parameterization
    widths = [6, *HIDDEN, 2]
    layers = torch.nn.ModuleList()
    for i in range(len(widths) - 1):
        step = k if i == 0 else 1   # ind_agg = 0
        layers.append(torch.nn.Conv2d(widths[i], widths[i + 1],
                                      (step, 1), stride=(step, 1)))

    def np_env_step(x, u):
        """Host NumPy double integrator + radius graph + 6 features."""
        u = np.clip(u, -1.0, 1.0)
        pos = x[:, 0:2] + x[:, 2:4] * dt + 0.5 * u * dt * dt
        vel = x[:, 2:4] + u * dt
        x = np.concatenate([pos, vel], axis=-1)
        diff = x[:, None, :] - x[None, :, :]
        r2 = diff[..., 0] ** 2 + diff[..., 1] ** 2
        np.fill_diagonal(r2, np.inf)
        adj = (r2 < COMM_RADIUS**2).astype(np.float64)
        r2s = np.where(np.isinf(r2), 1.0, r2)
        feats = np.stack([diff[..., 2], diff[..., 0] / r2s**2,
                          diff[..., 0] / r2s, diff[..., 3],
                          diff[..., 1] / r2s**2, diff[..., 1] / r2s], -1)
        values = np.sum(feats * adj[..., None], axis=1)
        deg = np.maximum(adj.sum(1, keepdims=True), 1.0)
        return x, values, adj / deg

    def np_expert(x):
        """Analytic flocking controller on the host (the reference's hot
        loop calls it every step)."""
        diff = x[:, None, :] - x[None, :, :]
        r2 = diff[..., 0] ** 2 + diff[..., 1] ** 2
        np.fill_diagonal(r2, np.inf)
        r2s = np.where(np.isinf(r2), 1.0, r2)
        in_range = r2 <= 1.0
        gx = (-2 * diff[..., 0] / r2s**2 + 2 * diff[..., 0] / r2s) * in_range
        gy = (-2 * diff[..., 1] / r2s**2 + 2 * diff[..., 1] / r2s) * in_range
        ux = -np.sum(diff[..., 2] + gx, axis=1)
        uy = -np.sum(diff[..., 3] + gy, axis=1)
        return np.clip(np.stack([ux, uy], -1), -10, 10)

    x = rng.uniform(-4, 4, (n, 4))
    x, values, net = np_env_step(x, np.zeros((n, 2)))

    # delayed state object, rebuilt per step (state_with_delay semantics)
    gso = torch.zeros(1, k, n, n)
    gso[0, 0] = torch.eye(n)
    hist = torch.zeros(1, k, 6, n)
    hist[0, 0] = torch.from_numpy(values.T).float()

    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(n_steps):
            _ = np_expert(x)                                  # expert label
            # actor forward on the delayed state (B,F,K,N conv layout)
            a = torch.matmul(hist, gso).permute(0, 2, 1, 3)   # aggregation
            a = layers[0](a)
            for conv in layers[1:-1]:
                a = conv(torch.tanh(a))
            act = layers[-1](torch.tanh(a))
            u = act[0, :, 0, :].T.numpy()                     # device->host
            x, values, net = np_env_step(x, u)                # host env
            # next delayed state: dense GSO recursion in torch
            a_t = torch.from_numpy(net).float().unsqueeze(0)
            new_gso = torch.zeros_like(gso)
            new_gso[0, 0] = torch.eye(n)
            new_gso[:, 1:] = torch.matmul(a_t.unsqueeze(1), gso[:, : k - 1])
            gso = new_gso
            new_hist = torch.zeros_like(hist)
            new_hist[0, 0] = torch.from_numpy(values.T).float()
            new_hist[:, 1:] = hist[:, : k - 1]
            hist = new_hist
    return n_steps / (time.perf_counter() - t0)


def pinned_baseline_subprocess(n_steps: int) -> float:
    """The pinned one-thread baseline in a fresh interpreter, so the
    ratio's denominator inherits no thread pool or warm state from this
    process. A failure of the subprocess raises."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "from multiagent_gnn_policies_tpu_torch.bench import "
            "bench_reference_baseline; "
            "print(bench_reference_baseline({n}))").format(root=root,
                                                           n=n_steps)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600, check=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
             "PYTHONDONTWRITEBYTECODE": "1"})
    return float(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# The port: batched dense DAGGER collection on the card.
# ---------------------------------------------------------------------------

def bench_dense(device: torch.device, n_envs: int, steps: int, reps: int,
                chains: int):
    """``(single, batched, sustained)`` env steps per second of DAGGER
    collection episodes; each figure after one warm call of its shape."""
    from multiagent_gnn_policies_tpu_torch.algos.imitation import (
        rollout_episode)
    from multiagent_gnn_policies_tpu_torch.envs.flocking import (
        FlockingParams, make_env, strict_fp32)
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor, sync, timed)

    strict_fp32()
    acfg, actor = seeded_actor(K, 0, device, HIDDEN)
    env = make_env("FlockingRelative-v0",
                   FlockingParams(n_agents=N_AGENTS, episode_steps=steps))
    gen = torch.Generator(device=device).manual_seed(1)

    def episodes(n):
        _, rewards = rollout_episode(actor, gen, BETA, env, acfg,
                                     mode="dagger", n_envs=n)
        return rewards

    def rate(n, calls, per_call):
        _, s = timed(lambda: episodes(n), device)
        log(f"  {n}-env first call: {s:.3f} s")
        sync(device)
        t = time.perf_counter()
        for _ in range(calls):
            for _ in range(per_call):
                r = episodes(n)
            if not bool(torch.isfinite(r).all()):   # waits for the device
                raise FloatingPointError(f"non-finite reward ({n} envs)")
        return calls * per_call * steps * n / (time.perf_counter() - t)

    single = rate(1, reps, 1)
    batched = rate(n_envs, reps, 1)
    sustained = rate(n_envs, chains, SUSTAIN_REPS)
    return single, batched, sustained


def bench_large_n(device: torch.device) -> None:
    """Large-N rollouts (stderr detail): the blocked O(B·N)-memory path at
    N = 10,000 (200 steps, 3 episodes) and the pcells path at N = 100,000
    (25 steps, 1 episode), seeded random weights of the same shape."""
    from multiagent_gnn_policies_tpu_torch.envs.flocking import (
        FlockingParams)
    from multiagent_gnn_policies_tpu_torch.parallel.large_n import (
        rollout_large)
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor, timed)

    acfg, actor = seeded_actor(K, 0, device, HIDDEN)
    for n, t_steps, episodes, path in ((10_000, 200, 3, "blocked"),
                                       (100_000, 25, 1, "pcells")):
        p = FlockingParams(n_agents=n, episode_steps=t_steps, max_resets=2)

        def run(seed):
            gen = torch.Generator(device=device).manual_seed(seed)
            r, _, ovf = rollout_large(actor, acfg, gen, p, path=path,
                                      return_overflow=True, device=device)
            return float(r.sum()), int(ovf)

        _, s = timed(lambda: run(3), device)
        log(f"large-N first episode (N={n}, {path}): {s:.1f}s")
        t0 = time.perf_counter()
        max_ovf = 0
        for e in range(episodes):
            tot, ovf = run(4 + e)
            max_ovf = max(max_ovf, ovf)
            if not np.isfinite(tot):
                max_ovf = max(max_ovf, 1)     # a NaN rollout is never valid
                log(f"large-N N={n} episode {e}: non-finite reward sum")
        dt = (time.perf_counter() - t0) / episodes
        if max_ovf:
            log(f"large-N rollout N={n} ({path}): INVALID "
                f"(overflow={max_ovf}; steps/s withheld)")
        else:
            log(f"large-N rollout N={n} ({path}): {t_steps / dt:.0f} "
                f"steps/s (~{t_steps / dt * n * EDGES_PER_AGENT * K:.2e} "
                f"aggregated edges/s, overflow=0)")


def main(argv=None) -> int:
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        add_device_arg, device_line, device_of)

    ap = argparse.ArgumentParser(
        description="Dense DAGGER collection throughput on the card against "
                    "the reference's host loop; one JSON line on stdout.")
    add_device_arg(ap)
    ap.add_argument("--n-envs", type=int, default=BATCH_ENVS,
                    help="envs per batched call (default 128)")
    ap.add_argument("--steps", type=int, default=T,
                    help="episode length (default 200)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls of the single-env and batched figures")
    ap.add_argument("--chains", type=int, default=2,
                    help="timed sustained chains (default 2)")
    ap.add_argument("--no-large-n", action="store_true",
                    help="skip the large-N stderr detail")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    log(device_line(device))

    # the pinned protocol first, in a fresh subprocess (the ratio's
    # denominator); then this process's all-thread run for comparison
    mt = os.cpu_count() or 1
    ref_sps = pinned_baseline_subprocess(BASELINE_STEPS)
    threads = torch.get_num_threads()
    ref_mt_sps = bench_reference_baseline(BASELINE_STEPS, threads=mt)
    torch.set_num_threads(threads)
    log(f"reference-equivalent baseline (torch/numpy host loop): pinned 1 "
        f"thread {ref_sps:.1f} steps/s ({1e3 / ref_sps:.2f} ms/step), the "
        f"vs_baseline denominator; {mt} threads {ref_mt_sps:.1f} steps/s "
        f"for comparison")

    single, batched, sustained = bench_dense(device, args.n_envs,
                                             args.steps, args.reps,
                                             args.chains)
    log(f"port rollout ({device.type}): single-env {single:.0f} steps/s, "
        f"{args.n_envs}-env per call {batched:.0f} steps/s, sustained "
        f"(x{SUSTAIN_REPS} per synchronisation) {sustained:.0f} steps/s "
        f"({sustained / ref_sps:.1f}x baseline)")
    log(f"approx aggregated edges/s (sustained): "
        f"{sustained * N_AGENTS * EDGES_PER_AGENT * K:.3e}")
    if not args.no_large_n:
        bench_large_n(device)

    print(json.dumps({
        "metric": "rollout_steps_per_s",
        "value": round(sustained, 1),
        "unit": "env steps/s",
        "vs_baseline": round(sustained / ref_sps, 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
