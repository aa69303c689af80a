"""The K = 4 widths, K2 at 18 columns and K3 at 12, which ``csrc/cells.cu``
sweeps with ops of their own (``RowApplyDegOp``, ``RowApplyOp``).

Each column's sum in the kernels is independent of the other columns, so
C columns equal any split of them into slices, concatenated, bit for
bit. On the card that is held by ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` (K = 4's widths against their 6-column slices launched
alone). Here the plain versions, the kernels' oracle, are held to the
same contract on the inputs of the JAX parity tests in
``tests/test_torch_cells.py``, and to giving a band of rows what the
whole gives there (the benchmark and ``scripts/verify_cells.py`` take
them in row chunks); and, on the source text, every ``__global__`` of
``csrc/cells.cu`` (K = 4's widths are explicit specialisations of the
kernel templates) keeps a name that the trace readers of
``ops/cells_cuda.py`` and the coverage map of
``tests/test_torch_port_coverage.py`` know.
"""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams as TParams,
)
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELLS_CU = ROOT / "multiagent_gnn_policies_tpu_torch" / "csrc" / "cells.cu"
COVERAGE_TEST = ROOT / "tests" / "test_torch_port_coverage.py"
F = tcc.SLOT_COLS

# tests/test_torch_cells.py's parity inputs: (seed, n, spread, cap) of a
# sparse swarm and of a dense one whose cells overflow cap = 8, with the
# column and degree seeds its apply_adjT and frame_apply tests draw from
CASES = {"sparse": ((0, 48, 3.0, 16), 3, 4), "dense": ((5, 128, 1.2, 8), 0, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _swarm(seed, n, spread):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 2))
    vel = rng.normal(size=(n, 2))
    return np.concatenate([pos, vel], 1).astype(np.float32)


def _inputs(case):
    (seed, n, spread, cap), x_off, col_seed = CASES[case]
    x = torch.from_numpy(_swarm(seed + x_off, n, spread))
    spec = tcc.make_pcell_spec(TParams(n_agents=n), cap=cap)
    grid = tcc.build_pcell_grid(x[:, :2], spec)
    rng = np.random.default_rng(col_seed)
    s0 = torch.from_numpy(rng.normal(size=(n, 3 * F)).astype(np.float32))
    deg = torch.from_numpy(rng.integers(0, 6, n).astype(np.float32))
    return x, spec, grid, s0, deg


def _bands(spec):
    return {"whole": None, "band": (1, spec.cx // 2)}


@pytest.mark.parametrize("band", ["whole", "band"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_historical_apply_is_column_separable(case, band):
    """K3's plain version at 12 columns on the row-strided view the delayed
    stack passes at K = 4 (columns 6-17 of the (N, 18) pre-applied output)
    equals its two 6-column slices, each read as a view, concatenated."""
    x, spec, grid, s0, deg = _inputs(case)
    view = s0[:, F:]
    assert view.stride() == (3 * F, 1) and not view.is_contiguous()
    b = _bands(spec)[band]
    got = tcc.apply_sweep_plain(x[:, :2], view, deg, grid, spec, 1.0,
                                band=b)
    slices = [tcc.apply_sweep_plain(x[:, :2], view[:, s:s + F], deg, grid,
                                    spec, 1.0, band=b)
              for s in range(0, 2 * F, F)]
    assert got.shape == (x.shape[0], 2 * F) and got.abs().sum() > 0
    assert torch.equal(got, torch.cat(slices, 1))


@pytest.mark.parametrize("band", ["whole", "band"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fused_apply_is_column_separable(case, band):
    """K2's plain version at 18 columns (K = 4's s = 0 block) equals its
    three 6-column slices concatenated."""
    x, spec, grid, s0, deg = _inputs(case)
    b = _bands(spec)[band]
    got = tcc.apply_deg_sweep_plain(x, s0, deg, grid, spec, 1.0, band=b)
    slices = [tcc.apply_deg_sweep_plain(x, s0[:, s:s + F], deg, grid, spec,
                                        1.0, band=b)
              for s in range(0, 3 * F, F)]
    assert got.shape == (x.shape[0], 3 * F) and got.abs().sum() > 0
    assert torch.equal(got, torch.cat(slices, 1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_applies_give_a_row_chunk_what_the_whole_gives(case):
    """K2's plain version at 18 columns and K3's at 12 on the row-strided
    view, taken for a chunk of rows, equal those rows of the whole, bit
    for bit."""
    x, spec, grid, s0, deg = _inputs(case)
    n = x.shape[0]
    rows = slice(n // 3, n - 5)
    whole = (tcc.apply_deg_sweep_plain(x, s0, deg, grid, spec, 1.0),
             tcc.apply_sweep_plain(x[:, :2], s0[:, F:], deg, grid, spec,
                                   1.0))
    chunk = (tcc.apply_deg_sweep_plain(x, s0, deg, grid, spec, 1.0, rows),
             tcc.apply_sweep_plain(x[:, :2], s0[:, F:], deg, grid, spec,
                                   1.0, rows))
    for w, c in zip(whole, chunk):
        assert c.abs().sum() > 0
        assert torch.equal(w[rows], c)


def _source():
    return CELLS_CU.read_text()


def _globals(src):
    """``(name, template arguments or None)`` of each ``__global__``: a
    primary template or plain kernel, or an explicit specialisation."""
    pattern = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)"
        r"\s*(?:<([^<>]*)>)?\s*\(")
    return [(m.group(1), m.group(2)) for m in pattern.finditer(src)]


def _built_cols(src):
    m = re.search(r"#define CELLS_FOR_COLS\(M\)((?:\s*M\(\d+\))+)", src)
    return tuple(int(c) for c in re.findall(r"M\((\d+)\)", m.group(1)))


def _instantiations(src):
    """The kernel instantiations the launchers build, as a profiler trace
    names them: ``{trace name: (wrapper, output columns)}``. K2 loads a
    row in 16-byte pieces where C is a multiple of 4 (V = 4), else and
    also for unaligned columns in 8-byte pieces (V = 2)."""
    out = {"void (anonymous namespace)::frame_kernel((anonymous namespace)"
           "::FrameOp, (anonymous namespace)::Ranges, int)":
           ("frame_sweep", tcc.FRAME_CHANNELS)}
    for c in _built_cols(src):
        for v in ((2, 4) if c % 4 == 0 else (2,)):
            out[f"void (anonymous namespace)::apply_deg_kernel<{c}, {v}>("
                f"(anonymous namespace)::ApplyDegOp<{c}, {v}>, (anonymous "
                f"namespace)::Ranges, int)"] = ("apply_deg_sweep", c)
        out[f"void (anonymous namespace)::apply_kernel<{c}>((anonymous "
            f"namespace)::ApplyOp<{c}>, (anonymous namespace)::Ranges, "
            f"int)"] = ("apply_sweep", c)
    return out


def _coverage_kernels():
    """``tests/test_torch_port_coverage.py``'s KERNELS map, read as text."""
    for node in ast.parse(COVERAGE_TEST.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "KERNELS"):
            return ast.literal_eval(node.value)
    raise AssertionError("test_torch_port_coverage.py sets no KERNELS")


def test_built_widths_are_the_wrappers():
    assert _built_cols(_source()) == tcc.APPLY_COLS


def test_every_instantiation_is_read_from_a_trace():
    """Each kernel the launchers build, named as a profiler trace names
    it, is counted by ``launches_in_trace`` for its wrapper and width."""
    for name, (wrapper, cols) in _instantiations(_source()).items():
        counts = tcc.launches_in_trace([name])
        assert counts[wrapper] == {cols: 1}, (name, counts)
        assert sum(len(by) for by in counts.values()) == 1, name


def test_every_global_keeps_a_name_the_readers_know():
    """Every ``__global__`` of cells.cu is a kernel of the coverage map,
    and each explicit specialisation (K = 4's widths) is one of the
    built instantiations, so a trace names it as the readers expect."""
    src = _source()
    found = _globals(src)
    mapped = {v.split(":")[1] for v in _coverage_kernels().values()
              if v.startswith("csrc/cells.cu:")}
    assert {name for name, _ in found} == mapped
    names = _instantiations(src)
    specialised = [(name, args) for name, args in found if args]
    assert sorted(specialised) == [("apply_deg_kernel", "18, 2"),
                                   ("apply_kernel", "12")]
    for name, args in specialised:
        op = "ApplyDegOp" if name == "apply_deg_kernel" else "ApplyOp"
        trace = (f"void (anonymous namespace)::{name}<{args}>((anonymous "
                 f"namespace)::{op}<{args}>, (anonymous namespace)::Ranges, "
                 f"int)")
        assert trace in names, trace
        wrapper, cols = names[trace]
        assert tcc.launches_in_trace([trace])[wrapper] == {cols: 1}
