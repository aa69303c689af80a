"""Where a tile block of K1, K2 or K3 spends its time, from clock64 stamps.

    python -m multiagent_gnn_policies_tpu_torch.ops.tile_timeline [--n 32768]

Builds ``csrc/cells.cu`` once more with ``-DCELLS_TIMELINE`` (a library of
its own in ``_build/``; the main path's library has no stamps), runs K1,
K2 and K3 (K3 on a row-strided view of the columns, as the delayed stack
passes them) once on a lattice swarm at the main path's shapes, and
prints, over the blocks whose tile holds agents, the SM cycles of each
phase of the tile sweep: the cell-start loads, the (first) staging pass,
the walk and the output stores up to the block's last barrier, and the
output writes; then how evenly the tile agents fell on the SMs. Needs a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams,
    _init_candidate,
)
from multiagent_gnn_policies_tpu_torch.ops import _build
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as cc

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


def report(name: str, stamps: np.ndarray, n_blocks: int, n_sms: int) -> None:
    d = stamps[:n_blocks]
    full = d[:, 6] > 0
    print(f"{name}: {n_blocks} blocks, {int(full.sum())} with agents")
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
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    lib = build_library()
    p = FlockingParams(n_agents=args.n)
    spec = cc.make_pcell_spec(p)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = _init_candidate(gen, p, dev)
    grid = cc.build_pcell_grid(x[:, :2], spec)
    cols = torch.randn((args.n, 12), generator=gen, device=dev)
    deg = cc.frame_sweep_plain(x, grid, spec, 1.0, True)[:, 6].contiguous()
    tile = cc.tile_cells(spec, args.n)
    n_blocks = (-(-spec.cx // cc.TILE_ROWS)) * (-(-spec.cy // tile))
    out1 = torch.empty((args.n, 10), device=dev)
    out2 = torch.empty((args.n, 12), device=dev)
    out3 = torch.empty((args.n, 6), device=dev)
    pos = x[:, :2].contiguous()
    cols3 = cols[:, 6:]                     # row stride 12, 24 bytes in
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{torch.cuda.get_device_name(0)}; N = {args.n}, {spec.cx} x "
          f"{spec.cy} cells, tiles of {cc.TILE_ROWS} x {tile} cells")
    launches = {
        "K1 frame_kernel": lambda: lib.cells_frame(
            x.data_ptr(), grid.kept.data_ptr(), grid.cell_start.data_ptr(),
            out1.data_ptr(), args.n, spec.cx, spec.cy, 0, spec.cx, tile,
            1.0, 1, stream),
        "K2 apply_deg_kernel<12>": lambda: lib.cells_apply_deg(
            x.data_ptr(), cols.data_ptr(), deg.data_ptr(),
            grid.kept.data_ptr(), grid.cell_start.data_ptr(),
            out2.data_ptr(), args.n, 12, 12, spec.cx, spec.cy, 0, spec.cx,
            tile, 1.0, stream),
        "K3 apply_kernel<6>": lambda: lib.cells_apply(
            pos.data_ptr(), cols3.data_ptr(), deg.data_ptr(),
            grid.kept.data_ptr(), grid.cell_start.data_ptr(),
            out3.data_ptr(), args.n, 6, cols3.stride(0), spec.cx, spec.cy,
            0, spec.cx, tile, 1.0, stream),
    }
    stamps = np.zeros((STAMP_BLOCKS, 8), np.int64)
    for name, launch in launches.items():
        for _ in range(3):                  # warm: the last run is read
            if launch():
                raise RuntimeError(f"{name} launch failed")
        torch.cuda.synchronize()
        if lib.cells_read_stamps(stamps.ctypes.data, stamps.nbytes):
            raise RuntimeError("reading the stamps failed")
        report(name, stamps, n_blocks, sms)


if __name__ == "__main__":
    main()
