"""Where a tile block of K1, K2 or K3 spends its time, from clock64 stamps.

    python -m multiagent_gnn_policies_tpu_torch.ops.tile_timeline \
        [--n 32768] [--radius 1.0] [--cols 6 12 18]

Builds ``csrc/cells.cu`` once more with ``-DCELLS_TIMELINE`` (a library of
its own in ``_build/``; the main path's library has no stamps), runs K1,
and K2 and K3 at each width of ``--cols``, once each on a lattice swarm at
the main path's shapes (``--radius 1.5``: the cross-K transfer policies'
graph, whose cells hold about twice the candidates), and prints, over the
blocks whose tile holds agents, the SM cycles of each phase of the tile
sweep: the cell-start loads, the (first) staging pass, the walk and the
output stores up to the block's last barrier, and the output writes; then
how evenly the tile agents fell on the SMs, a digest of each kernel's
output (so that two builds, a parent's checkout and a change, can be held
bit for bit on the same input), and its ms by CUDA events through the
main path's library, which has no stamps. K2 at C reads contiguous
(N, C) columns; K3 at C the row-strided view the delayed stack passes at
K = C/6 + 2, columns 6 .. C + 5 of an (N, C + 6) array (row stride 12 at
C = 6, 18 at C = 12). Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams,
    _init_candidate,
)
from multiagent_gnn_policies_tpu_torch.ops import _build
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as cc
from multiagent_gnn_policies_tpu_torch.utils.profiling import device_ms

STAMP_BLOCKS = 1 << 16            # cells.cu kStampBlocks
PHASES = (("cell starts", 1, 2), ("staging", 2, 3), ("walk + store", 3, 4),
          ("write-out", 4, 5), ("whole block", 1, 5))


def build_library() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "libcells-timeline.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = _build.nvcc_command(out)
    subprocess.run(cmd[:1] + ["-DCELLS_TIMELINE"] + cmd[1:], check=True,
                   capture_output=True, timeout=_build.NVCC_TIMEOUT_S)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _build.SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.cells_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cells_read_stamps.restype = ctypes.c_int
    return lib


def report(name: str, stamps: np.ndarray, n_blocks: int, n_sms: int,
           out: torch.Tensor, ms: float) -> None:
    d = stamps[:n_blocks]
    full = d[:, 6] > 0
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"{name}: {ms:.4f} ms; {n_blocks} blocks, {int(full.sum())} with "
          f"agents; output sha256 {digest}")
    for label, a, b in PHASES:
        cyc = d[full, b] - d[full, a]
        print(f"  {label:<13} cycles p50 {np.percentile(cyc, 50):.0f} "
              f"p90 {np.percentile(cyc, 90):.0f} max {cyc.max()}")
    sm = d[:, 0].astype(np.int64)
    agents = np.bincount(sm[full], weights=d[full, 6], minlength=n_sms)
    print(f"  tile agents per block p50 {np.percentile(d[full, 6], 50):.0f}"
          f" max {d[full, 6].max()}; per SM mean {agents.mean():.0f} max "
          f"{agents.max():.0f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--radius", type=float,
                    default=FlockingParams.comm_radius,
                    help="the communication radius (cell edge and cut)")
    ap.add_argument("--cols", type=int, nargs="+", choices=cc.APPLY_COLS,
                    default=list(cc.APPLY_COLS),
                    help="the K2 and K3 column widths to stamp")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    stamped = build_library()
    p = FlockingParams(n_agents=args.n, comm_radius=args.radius)
    r2cut = args.radius ** 2
    spec = cc.make_pcell_spec(p)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = _init_candidate(gen, p, dev)
    grid = cc.build_pcell_grid(x[:, :2], spec)
    deg = cc.frame_sweep_plain(x, grid, spec, r2cut, True)[:, 6].contiguous()
    tile = cc.tile_cells(spec, args.n)
    n_blocks = (-(-spec.cx // cc.TILE_ROWS)) * (-(-spec.cy // tile))
    pos = x[:, :2].contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{torch.cuda.get_device_name(0)}; N = {args.n}, radius "
          f"{args.radius}, {spec.cx} x {spec.cy} cells, tiles of "
          f"{cc.TILE_ROWS} x {tile} cells")
    out1 = torch.empty((args.n, 10), device=dev)
    inputs = []
    for c in args.cols:
        cols = torch.randn((args.n, c + cc.SLOT_COLS), generator=gen,
                           device=dev)
        inputs.append((c, cols[:, :c].contiguous(),     # K2's
                       cols[:, cc.SLOT_COLS:],          # K3's, a view
                       torch.empty((args.n, c), device=dev),
                       torch.empty((args.n, c), device=dev)))

    def launches(lib):
        """``{name: (output, launch)}`` of every kernel through ``lib``."""
        out = {"K1 frame_kernel": (out1, lambda: lib.cells_frame(
            x.data_ptr(), grid.kept.data_ptr(), grid.cell_start.data_ptr(),
            out1.data_ptr(), args.n, spec.cx, spec.cy, 0, spec.cx, tile,
            r2cut, 1, stream))}
        for c, k2_cols, k3_cols, out2, out3 in inputs:
            out[f"K2 apply_deg_kernel C={c}"] = (out2, (
                lambda c=c, cols=k2_cols, o=out2: lib.cells_apply_deg(
                    x.data_ptr(), cols.data_ptr(), deg.data_ptr(),
                    grid.kept.data_ptr(), grid.cell_start.data_ptr(),
                    o.data_ptr(), args.n, c, c, spec.cx, spec.cy, 0,
                    spec.cx, tile, r2cut, stream)))
            out[f"K3 apply_kernel C={c}, row stride {k3_cols.stride(0)}"] = (
                out3, (lambda c=c, cols=k3_cols, o=out3: lib.cells_apply(
                    pos.data_ptr(), cols.data_ptr(), deg.data_ptr(),
                    grid.kept.data_ptr(), grid.cell_start.data_ptr(),
                    o.data_ptr(), args.n, c, cols.stride(0), spec.cx,
                    spec.cy, 0, spec.cx, tile, r2cut, stream)))
        return out

    stamps = np.zeros((STAMP_BLOCKS, 8), np.int64)
    timed = launches(_build.library())
    for name, (out, launch) in launches(stamped).items():
        for _ in range(3):                  # warm: the last run is read
            if launch():
                raise RuntimeError(f"{name} launch failed")
        torch.cuda.synchronize()
        if stamped.cells_read_stamps(stamps.ctypes.data, stamps.nbytes):
            raise RuntimeError("reading the stamps failed")
        ms = device_ms(timed[name][1])
        report(name, stamps, n_blocks, sms, out, ms)


if __name__ == "__main__":
    main()
