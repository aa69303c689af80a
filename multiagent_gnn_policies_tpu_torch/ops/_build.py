"""Build the CUDA kernels of ``csrc/`` with one ``nvcc`` call and bind them.

The sources compile into a shared library with a plain C interface
(``extern "C"`` launchers that return ``cudaGetLastError()``), loaded with
``ctypes``: no PyTorch headers, so the build takes seconds. The library
goes to ``_build/`` beside this package (listed in ``.gitignore``), named by
a hash of the sources and the command, and is built on first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_TIMEOUT_S = 240

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the launchers in csrc/cells.cu; (row0, rows) is the band
# of grid rows a launch sweeps, (0, cx) for the whole grid
SIGNATURES = {
    # x, kept, cell_start, out, n, cx, cy, row0, rows, tile, r2cut,
    # centralized, stream
    "cells_frame": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # x, cols, deg, kept, cell_start, out, n, c, ld, cx, cy, row0, rows,
    # tile, r2cut, stream
    "cells_apply_deg": [_P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # pos, cols, deg, kept, cell_start, out, n, c, ld, cx, cy, row0, rows,
    # tile, r2cut, stream
    "cells_apply": [_P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
}


class BuildResult(NamedTuple):
    path: Path
    seconds: float          # 0.0 when the library was already built
    ptxas: List[str]        # nvcc's -Xptxas -v lines (registers, smem,
                            # stack and spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")
    return path


NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_command(out: Path) -> List[str]:
    sources = sorted(str(p) for p in CSRC.glob("*.cu"))
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), *sources]


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def build() -> BuildResult:
    """Compile ``csrc/*.cu`` into ``_build/libcells-<hash>.so`` unless it
    exists. Raises ``RuntimeError`` with nvcc's output if the build fails."""
    out = BUILD_DIR / f"libcells-{_source_hash()}.so"
    if out.exists():
        return BuildResult(out, 0.0, [])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    ptxas = [ln for ln in (proc.stdout + proc.stderr).splitlines()
             if "ptxas info" in ln or "bytes stack frame" in ln]
    return BuildResult(out, seconds, ptxas)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built library with every launcher's argument types declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
