"""The cell-sweep gate on the card: K1, K2 and K3 at production sizes,
against their plain versions and the O(N²) blocked oracle, and short
rollouts through both large-N paths. The counterpart of the JAX package's
``scripts/verify_cells_tpu.py``; run it after any change to
``ops/cells_cuda.py``, ``csrc/cells.cu`` or ``envs/``:

    python -m multiagent_gnn_policies_tpu_torch.scripts.verify_cells
    python -m multiagent_gnn_policies_tpu_torch.scripts.verify_cells --quick

Checks, one ``[PASS]``/``[FAIL]`` line each; exit 1 on any failure:

* frame and applies at each ``--sizes`` N (2,048, 12,288 and 100,000;
  ``--quick`` skips 100,000), on a lattice draw (``_init_candidate``):
  the grid's overflow is 0; K1 (``frame_sweep``), K2 (``apply_deg_sweep``
  on 12 columns) and K3 (``apply_sweep`` on 6) through the port's wrappers
  against their plain versions within 1e-5 of each channel's largest
  magnitude (degree and min r² exact), and against the blocked oracle
  (``blocked_frame``, ``blocked_apply_adjT``) within 1e-4; on the card
  each kernel's time (CUDA events) beside its bound;
* the 1M geometry (``--big-n`` agents, edge_mult 2, cap 32): overflow 0,
  the slot ids inside int32, K1-K3 against their plain versions on row
  chunks of ``--chunk`` agents (the plain candidate gather of all N at
  once would take tens of GB), each kernel timed beside its bound. No
  O(N²) oracle runs at this size;
* rollouts (K = 3, hidden 32x2, seeded weights): the blocked and pcells
  paths on the same x0 and weights at the first size, 20 steps, rewards
  within 1e-4 of the largest; pcells episodes with overflow 0 and finite
  rewards at the other sizes (20 steps, 10 at N >= 100,000).

``--device cpu`` runs the same checks through the plain versions (the
wrappers take them for CPU tensors), at small ``--sizes``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams,
    _init_candidate,
    strict_fp32,
)
from multiagent_gnn_policies_tpu_torch.ops import blocked as bl
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as cc
from multiagent_gnn_policies_tpu_torch.parallel import large_n as ln
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
)

REL_PLAIN = 1e-5
REL_ORACLE = 1e-4
REL_ROLLOUT = 1e-4
SIZES = (2048, 12288, 100_000)
BIG_N, BIG_EDGE, BIG_CAP = 1_000_000, 2.0, 32
CHUNK = 131_072
SEED = 0


class Gate:
    """Collects ``[PASS]``/``[FAIL]`` lines."""

    def __init__(self):
        self.failed = []

    def check(self, name: str, ok: bool, detail: str = "") -> bool:
        print(f"[{'PASS' if ok else 'FAIL'}] {name} {detail}".rstrip(),
              flush=True)
        if not ok:
            self.failed.append(name)
        return ok

    def close(self, name, got, want, rel, exact=()):
        """Per-channel max error against ``rel`` of the channel's largest
        magnitude; the ``exact`` channels must be equal."""
        got = got.reshape(got.shape[0], -1).double()
        want = want.reshape(want.shape[0], -1).double()
        bad = int((~torch.isfinite(got)).sum())
        if bad:
            return self.check(name, False, f"{bad} non-finite entries")
        err = (got - want).abs().amax(0)
        scale = want.abs().amax(0).clamp_min(1e-30)
        worst = float((err / scale).max())
        ok = worst <= rel and all(float(err[q]) == 0.0 for q in exact)
        exact_note = f", exact {list(exact)}" if exact else ""
        return self.check(name, ok, f"max rel err {worst:.3g} (tolerance "
                          f"{rel}{exact_note})")


def chunked(fn, n: int, chunk: int) -> torch.Tensor:
    """``fn(rows)`` over row slices of ``chunk`` agents, concatenated."""
    return torch.cat([fn(slice(r, min(r + chunk, n)))
                      for r in range(0, n, chunk)])


def pair_counts(pos, grid, spec, r2cut=1.0, chunk=None):
    """(candidate pairs, radius-neighbour pairs) that this input's sweep
    visits: what the data needs, not the cap's worst case."""
    n = pos.shape[0]
    cand = nbr = 0
    for r in range(0, n, chunk or n):
        rows = slice(r, min(r + (chunk or n), n))
        valid, _, _, _, r2 = cc._pair_geometry(
            pos, cc._candidates(grid, spec, rows), rows)
        cand += int(valid.sum())
        nbr += int((valid & (r2 < r2cut)).sum())
    return cand, nbr


def neighbour_bytes(grid, spec):
    """Bytes of the least neighbour structure a sweep over ``grid`` needs:
    the cell-sorted agent order (int32 per agent) and an int32 start and
    count for each cell the sweep touches (the 3x3 cells around every
    occupied cell, inside the grid), not the cap-wide padded table."""
    s = grid.slot[grid.slot >= 0].long()
    occ = torch.zeros((1, 1, spec.cx, spec.cy), device=s.device)
    occ[0, 0, s // (spec.cap * spec.cy), s % spec.cy] = 1.0
    touched = torch.nn.functional.max_pool2d(occ, 3, stride=1, padding=1)
    return 4 * grid.slot.shape[0] + 8 * int(touched.sum())


def frame_work(n, cand, nbr, nb):
    """(bytes moved, operations) that one K1 sweep needs on this input: the
    (N, 4) state in, the neighbour structure, the (N, 10) frame out; 11
    operations per candidate pair, 25 per radius-neighbour pair."""
    return n * 16 + nb + n * 40, 11 * cand + 25 * nbr


def apply_work(n, c, cand, nbr, nb, historical):
    """(bytes moved, operations) that one K2 (``historical`` False) or K3
    sweep over ``c`` columns needs on this input: positions (K2 reads
    them from the (N, 4) state), degrees and raw columns read once, the
    neighbour structure, the output written once; 6 operations per
    candidate pair's r^2 test and, per radius-neighbour pair, K2's
    weight product and sum (2 + 2C), K3's sums (C) after a clamp and C
    divisions per agent."""
    n_bytes = n * 8 + n * 4 + n * 4 * c + nb + n * 4 * c
    if historical:
        return n_bytes, (1 + c) * n + 6 * cand + c * nbr
    return n_bytes, 6 * cand + (2 + 2 * c) * nbr


def _work(n, pos, grid, spec, r2cut, chunk):
    """K1, K2 on 12 columns and K3 on 6, all over ``grid``."""
    cand, nbr = pair_counts(pos, grid, spec, r2cut, chunk)
    nb = neighbour_bytes(grid, spec)
    return {"K1": frame_work(n, cand, nbr, nb),
            "K2": apply_work(n, 12, cand, nbr, nb, False),
            "K3": apply_work(n, 6, cand, nbr, nb, True)}


def _draw(n, device, spec_kw=None):
    p = FlockingParams(n_agents=n)
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = _init_candidate(gen, p, device)
    spec = cc.make_pcell_spec(p, **(spec_kw or {}))
    cols = torch.randn((n, 12), generator=gen, device=device)
    return p, x, spec, cols


def _time_kernels(n, device, kernels, work):
    """Prints each kernel's device ms beside its bound (the card only)."""
    if device.type != "cuda":
        print(f"#   N={n}: kernel times not measured (CPU run)", flush=True)
        return
    for name, fn in kernels.items():
        ms = device_ms(fn)
        b_ms, b_by = bound_ms(*work[name])
        print(f"#   N={n} {name}: {ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}),"
              f" {work[name][0]} B, {work[name][1]} ops", flush=True)


def frame_apply_checks(gate: Gate, n: int, device, chunk: int):
    """K1-K3 at N = ``n`` against their plain versions and the oracle."""
    p, x, spec, cols = _draw(n, device)
    r2cut = float(p.comm_radius) ** 2
    grid = cc.build_pcell_grid(x[:, :2], spec)
    gate.check(f"grid N={n}", int(grid.overflow) == 0,
               f"overflow={int(grid.overflow)} ({spec.cx}x{spec.cy} cells, "
               f"cap {spec.cap})")
    pos = x[:, :2].contiguous()
    per = cc.frame_sweep(x, grid, spec, r2cut, True)
    deg = per[:, 6].contiguous()
    c6 = cols[:, :6].contiguous()
    k2 = cc.apply_deg_sweep(x, cols, deg, grid, spec, r2cut)
    k3 = cc.apply_sweep(pos, c6, deg, grid, spec, r2cut)
    gate.close(f"K1 vs plain N={n}", per, chunked(
        lambda r: cc.frame_sweep_plain(x, grid, spec, r2cut, True, r),
        n, chunk), REL_PLAIN, exact=(6, 9))
    gate.close(f"K2 vs plain N={n}", k2, chunked(
        lambda r: cc.apply_deg_sweep_plain(x, cols, deg, grid, spec, r2cut,
                                           r), n, chunk), REL_PLAIN)
    gate.close(f"K3 vs plain N={n}", k3, chunked(
        lambda r: cc.apply_sweep_plain(pos, c6, deg, grid, spec, r2cut, r),
        n, chunk), REL_PLAIN)
    block = ln.block_rows(n)
    ref = bl.blocked_frame(x, p, True, block)
    fq = cc.frame(x, grid, spec, p, True, need_expert=True)
    gate.close(f"K1 frame vs blocked oracle N={n}", fq.values, ref.values,
               REL_ORACLE)
    gate.close(f"K1 degree vs blocked oracle N={n}", fq.degree[:, None],
               ref.degree[:, None], 0.0, exact=(0,))
    gate.close(f"K1 expert vs blocked oracle N={n}", fq.expert, ref.expert,
               REL_ORACLE)
    gate.check(f"K1 min r2 vs blocked oracle N={n}",
               float(fq.min_r2) == float(ref.min_r2),
               f"{float(fq.min_r2)} vs {float(ref.min_r2)}")
    gate.close(f"K2 vs blocked oracle N={n}", k2,
               bl.blocked_apply_adjT(pos, cols, p, block, deg=deg),
               REL_ORACLE)
    gate.close(f"K3 vs blocked oracle N={n}", k3,
               bl.blocked_apply_adjT(pos, c6, p, block, deg=deg), REL_ORACLE)
    _time_kernels(n, device, {
        "K1": lambda: cc.frame_sweep(x, grid, spec, r2cut, True),
        "K2": lambda: cc.apply_deg_sweep(x, cols, deg, grid, spec, r2cut),
        "K3": lambda: cc.apply_sweep(pos, c6, deg, grid, spec, r2cut),
    }, _work(n, pos, grid, spec, r2cut, chunk))


def big_geometry_checks(gate: Gate, n: int, device, chunk: int):
    """K1-K3 at the 1M geometry (edge_mult 2, cap 32) against their plain
    versions on row chunks; no O(N²) oracle at this size."""
    p, x, spec, cols = _draw(n, device, dict(cap=BIG_CAP,
                                             edge_mult=BIG_EDGE))
    r2cut = float(p.comm_radius) ** 2
    grid = cc.build_pcell_grid(x[:, :2], spec)
    gate.check(f"grid N={n} edge {BIG_EDGE} cap {BIG_CAP}",
               int(grid.overflow) == 0,
               f"overflow={int(grid.overflow)} ({spec.cx}x{spec.cy} cells, "
               f"tile {cc.tile_cells(spec, n)} columns)")
    top = (spec.cx * spec.cap) * spec.cy      # one past the largest slot id
    gate.check(f"slot ids N={n} inside int32", top < 2 ** 31 and
               int(grid.slot.max()) < top,
               f"largest {int(grid.slot.max())} < {top} < 2^31; plain table "
               f"{spec.cx * spec.cy * spec.cap} slots")
    pos = x[:, :2].contiguous()
    per = cc.frame_sweep(x, grid, spec, r2cut, True)
    deg = per[:, 6].contiguous()
    c6 = cols[:, :6].contiguous()
    gate.close(f"K1 vs plain N={n}", per, chunked(
        lambda r: cc.frame_sweep_plain(x, grid, spec, r2cut, True, r),
        n, chunk), REL_PLAIN, exact=(6, 9))
    gate.close(f"K2 vs plain N={n}",
               cc.apply_deg_sweep(x, cols, deg, grid, spec, r2cut), chunked(
                   lambda r: cc.apply_deg_sweep_plain(x, cols, deg, grid,
                                                      spec, r2cut, r),
                   n, chunk), REL_PLAIN)
    gate.close(f"K3 vs plain N={n}",
               cc.apply_sweep(pos, c6, deg, grid, spec, r2cut), chunked(
                   lambda r: cc.apply_sweep_plain(pos, c6, deg, grid, spec,
                                                  r2cut, r), n, chunk),
               REL_PLAIN)
    _time_kernels(n, device, {
        "K1": lambda: cc.frame_sweep(x, grid, spec, r2cut, True),
        "K2": lambda: cc.apply_deg_sweep(x, cols, deg, grid, spec, r2cut),
        "K3": lambda: cc.apply_sweep(pos, c6, deg, grid, spec, r2cut),
    }, _work(n, pos, grid, spec, r2cut, chunk))


def rollout_checks(gate: Gate, n: int, steps: int, device, paths):
    """Episodes of each path from one x0 and one policy: overflow 0 and
    finite rewards; with two paths, their rewards within REL_ROLLOUT."""
    p = FlockingParams(n_agents=n, episode_steps=steps)
    acfg, actor = seeded_actor(3, SEED, device)
    x0 = _init_candidate(torch.Generator(device=device).manual_seed(7), p,
                         device)
    rewards = {}
    for path in paths:
        (r, _, ovf), s = timed(lambda: ln.rollout_large(
            actor, acfg, None, p, return_overflow=True, x0=x0,
            device=device, path=path), device)
        rewards[path] = r
        gate.check(f"{path} rollout N={n}",
                   bool(torch.isfinite(r).all()) and int(ovf) == 0,
                   f"reward_sum={float(r.sum()):.4f} overflow={int(ovf)} "
                   f"({s:.2f} s, {steps} steps)")
    if len(paths) == 2:
        a, b = rewards[paths[0]], rewards[paths[1]]
        gate.close(f"{paths[0]} vs {paths[1]} rollout rewards N={n}",
                   a[:, None], b[:, None], REL_ROLLOUT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The cell-sweep gate: K1-K3 against their plain "
                    "versions and the blocked oracle, and rollouts; exits 1 "
                    "on any [FAIL].")
    ap.add_argument("--quick", action="store_true",
                    help="skip the sizes of 100,000 agents and more")
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES),
                    help="N of the frame/apply checks and the rollouts")
    ap.add_argument("--big-n", type=int, default=BIG_N,
                    help="agents of the edge-2 cap-32 geometry check "
                         "(0 skips it)")
    ap.add_argument("--chunk", type=int, default=CHUNK,
                    help="agent rows per plain-version call")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    strict_fp32()
    print(device_line(device), flush=True)
    sizes = [n for n in args.sizes if not (args.quick and n >= 100_000)]
    gate = Gate()
    with torch.no_grad():
        for n in sizes:
            t = time.perf_counter()
            frame_apply_checks(gate, n, device, args.chunk)
            print(f"#   (N={n} frame/apply checks: "
                  f"{time.perf_counter() - t:.1f} s)", flush=True)
        if args.big_n:
            t = time.perf_counter()
            big_geometry_checks(gate, args.big_n, device, args.chunk)
            print(f"#   (N={args.big_n} geometry checks: "
                  f"{time.perf_counter() - t:.1f} s)", flush=True)
        for i, n in enumerate(sizes):
            rollout_checks(gate, n, 20 if n < 100_000 else 10, device,
                           ("blocked", "pcells") if i == 0 else ("pcells",))
    print("ALL PASSED" if not gate.failed else f"FAILURES: {gate.failed}",
          flush=True)
    return 1 if gate.failed else 0


if __name__ == "__main__":
    sys.exit(main())
