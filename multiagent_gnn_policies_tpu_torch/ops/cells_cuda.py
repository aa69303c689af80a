"""The O(N) cell-grid neighbour sweeps on Hopper: grid build, the three
kernels' wrappers and plain versions, and the functions built on them.

The counterpart of the JAX package's ``ops/pallas_cells.py``. It copies
each kernel's contract, not its TPU layout: with ``overflow == 0`` (no cell
over ``cap``, no agent outside the grid) every radius neighbour is counted
exactly once. The cell edge is ``max(comm_radius, 1) · edge_mult``, so the
3x3 cells around an agent hold its radius neighbours and the expert's
unit-range potential. The grid lists the kept agents in cell order with a
start per cell, so an agent's candidates are three contiguous ranges (one
per neighbour row); ``csrc/cells.cu`` sweeps all three kernels in
cell-row tiles staged in shared memory.

Three kernels, each with a wrapper that launches it for CUDA tensors (and
counts each launch in ``.launches``, and by column count in
``.launches_by_cols``) and takes the plain PyTorch version below it for CPU
tensors; for a CUDA tensor a wrapper launches its kernel or raises, never
falls back:

* :func:`frame_sweep` (K1): (N, 4) state -> (N, 10) frame channels;
* :func:`apply_deg_sweep` (K2): state, (N, C) raw columns and the new
  graph's (N,) degrees -> (N, C) degree-normalised neighbour sums;
* :func:`apply_sweep` (K3): (N, 2) positions, (N, C) raw columns and an
  earlier graph's (N,) degrees -> (N, C) degree-normalised neighbour sums
  over that graph.

K2 and K3 read row-strided column views in place. Each column's sum is
independent of the others, so on the card a column block wider than the
built widths (``APPLY_COLS``) is launched in chunks (:func:`apply_chunks`),
one launch each, as the JAX package's ``max_cols`` chunks its columns.

Each kernel and plain version takes a ``band`` ``(row0, rows)`` of grid
rows (the whole grid by default): it writes the outputs of the kept agents
in those rows, and, in the band that starts at row 0, of the dropped
agents, and 0 for every other agent (:func:`band_agents`), so that the
bands of a partition of the rows sum to the whole grid's outputs exactly.
That is how a mesh's ``agents`` axis shares the sweeps: rank d sweeps its
band of ``cx / D`` rows and one ``all_reduce(SUM)`` completes the (N, C)
tables (``frame``, ``frame_apply``, ``apply_adjT`` and ``ystack_pre`` with
``band`` and ``axis``; the JAX package's ``row_range`` and ``axis_name``);
:func:`build_pcell_grid_sharded` shares the grid build's sort.

The plain versions gather each agent's 9·cap candidates: O(N · 9 · cap)
memory, fine on the card at N = 32,768, never an (N, N) array; at larger
N they take a slice of rows at a time (``rows``).
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    COLLISION_R2_EPS,
    FlockingParams,
)
from multiagent_gnn_policies_tpu_torch.ops.blocked import (
    DelayCarry,
    FrameQuantities,
)
from multiagent_gnn_policies_tpu_torch.ops.precision import (
    centralized_consensus,
)
from multiagent_gnn_policies_tpu_torch.parallel.distributed import AxisGroup

# column counts the apply kernels are built for (cells.cu): K2's (K-1)·F
# and K3's (K-1-s)·F up to K = 4, F = 6; the delayed stack's column blocks
# are whole slots of F columns
APPLY_COLS = (6, 12, 18)
SLOT_COLS = 6
FRAME_CHANNELS = 10   # v0..v5 | degree | gx | gy | min_r2
MIN_R2_FILL = 1e12
# csrc/cells.cu's kThreads, kMaxTile, kRows and the ops' kChunk: threads
# per block, most columns and the grid rows of a tile, halo agents K1, K2
# and K3 stage per pass
BLOCK_THREADS = 128
MAX_TILE = 128
TILE_ROWS = 2
FRAME_CHUNK = 512
APPLY_DEG_CHUNK = 256
APPLY_CHUNK = 128
# agents a tile holds at the grid's mean density (tile_cells). The
# lattice disc covers about half of its square grid, so an occupied tile
# holds about twice as many: ~50 at N = 32,768, which timed fastest on the
# H100 among widths of 8-32 columns (PERF.md)
TILE_AGENTS = 23


class PCellSpec(NamedTuple):
    """Static cell-grid geometry."""

    cx: int        # grid rows (cells along x)
    cy: int        # grid cols (cells along y)
    cap: int       # agent slots per cell
    cell: float    # cell edge length (>= comm_radius and >= 1.0)


def make_pcell_spec(p: FlockingParams, cap: int = 16, margin: float = 1.3,
                    edge_mult: float = 1.0, n_dev: int = 1) -> PCellSpec:
    """A square grid for ``p``'s initial swarm extent times ``margin``, with
    cells of ``edge_mult`` times the minimum legal edge (the sweep is exact
    for any ``edge_mult >= 1``; the per-step overflow certifies capacity).
    ``n_dev > 1`` rounds ``cx`` up to a multiple of it, so that each of
    ``n_dev`` ranks sweeps an equal band of grid rows (:func:`row_band`)."""
    cell = max(p.comm_radius, 1.0) * edge_mult
    extent = 2.0 * math.sqrt(p.arena_r2_per_agent * p.n_agents) * margin
    need = max(3, math.ceil(extent / cell) + 2)
    d = max(1, n_dev)
    return PCellSpec(cx=-(-need // d) * d, cy=need, cap=cap, cell=cell)


def row_band(spec: PCellSpec, n_dev: int, index: int) -> Tuple[int, int]:
    """``(row0, rows)``: the band of grid rows of rank ``index`` of
    ``n_dev`` (``spec.cx`` a multiple of ``n_dev``; the JAX package's
    ``_cell_row_range``)."""
    if spec.cx % n_dev:
        raise ValueError(f"{spec.cx} grid rows do not split into {n_dev} "
                         f"equal bands (make_pcell_spec(n_dev={n_dev}))")
    rows = spec.cx // n_dev
    return index * rows, rows


def _band(spec: PCellSpec, band: Optional[Tuple[int, int]]
          ) -> Tuple[int, int]:
    """``band`` checked against the grid: at least one row, inside it;
    ``(0, cx)`` for None."""
    if band is None:
        return 0, spec.cx
    row0, rows = (int(v) for v in band)
    if row0 < 0 or rows < 1 or row0 + rows > spec.cx:
        raise ValueError(f"band of grid rows ({row0}, {rows}) is not inside "
                         f"the grid's {spec.cx} rows")
    return row0, rows


def band_agents(grid: "PCellGrid", spec: PCellSpec,
                band: Tuple[int, int]) -> torch.Tensor:
    """(N,) bool: the agents whose outputs a sweep over ``band`` writes:
    the kept agents of its grid rows and, when it starts at row 0, the
    dropped ones (each dropped agent is filled by exactly one band)."""
    row0, rows = band
    i = grid.slot // (spec.cap * spec.cy)
    own = (grid.slot >= 0) & (i >= row0) & (i < row0 + rows)
    return own | (grid.slot < 0) if row0 == 0 else own


def _banded(out: torch.Tensor, grid: "PCellGrid", spec: PCellSpec,
            band: Tuple[int, int], rows: slice) -> torch.Tensor:
    """The plain versions' band: ``out`` (of the agents ``rows``) with
    every agent outside ``band`` set to 0."""
    if band == (0, spec.cx):
        return out
    own = band_agents(grid, spec, band)[rows]
    return torch.where(own[:, None], out, 0.0)


class PCellGrid(NamedTuple):
    """One frame's agent -> (cell, rank) assignment, all int32.

    Attributes:
      slot: (N,) ``(i·cap + rank)·cy + j`` for an agent in cell (i, j), the
        JAX package's slot id; -1 = dropped (cell over ``cap`` or outside
        the grid).
      order: (N,) agent indices sorted by cell id (stable).
      kept: (N,) a permutation of the agents: the kept ones in cell order
        (rank order within a cell), then the dropped ones.
      cell_start: (cx·cy + 1,) exclusive prefix of kept agents per cell
        id ``i·cy + j``: cell (i, j) holds ``kept[cell_start[i·cy + j] :
        cell_start[i·cy + j + 1]]``, and ``cell_start[cx·cy]`` = N − overflow.
      overflow: () dropped-agent count; 0 means the sweeps are exact.
    """

    slot: torch.Tensor
    order: torch.Tensor
    kept: torch.Tensor
    cell_start: torch.Tensor
    overflow: torch.Tensor


def build_pcell_grid(pos: torch.Tensor, spec: PCellSpec) -> PCellGrid:
    """Sort agents by cell id and assign ranks: cell ids from the swarm's
    min corner, a stable argsort, the rank within each run of equal ids,
    and the drops of ranks >= ``cap`` and of agents outside the grid (the
    JAX package's ``build_pcell_grid``, slot for slot). ``kept`` and
    ``cell_start`` come from a second stable sort, on the one-bit key
    ``ok``, that moves the dropped agents (clamped into edge cells, so not
    always a run's tail) behind the kept ones. No operation waits for the
    device."""
    n = pos.shape[0]
    dev = pos.device
    origin = pos.min(0).values
    ij = torch.floor((pos - origin) / spec.cell).to(torch.int32)   # >= 0
    in_grid = (ij[:, 0] < spec.cx) & (ij[:, 1] < spec.cy)
    cid = (torch.clamp_max(ij[:, 0], spec.cx - 1) * spec.cy
           + torch.clamp_max(ij[:, 1], spec.cy - 1))
    order = torch.argsort(cid, stable=True)
    sc = cid[order]
    rank = (torch.arange(n, dtype=torch.int32, device=dev)
            - torch.searchsorted(sc, sc, out_int32=True))
    ok = (rank < spec.cap) & in_grid[order]
    slot_sorted = torch.where(
        ok, (sc // spec.cy * spec.cap + rank) * spec.cy + sc % spec.cy, -1)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    order = order.to(torch.int32)
    ncell = spec.cx * spec.cy
    perm = torch.argsort(ok, descending=True, stable=True)   # 1-bit key
    cell_start = torch.searchsorted(
        torch.where(ok, sc, ncell)[perm],
        torch.arange(ncell + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    return PCellGrid(slot=slot, order=order, kept=order[perm],
                     cell_start=cell_start, overflow=n - cell_start[ncell])


def _grid_from_slots(slot: torch.Tensor, opos: torch.Tensor,
                     spec: PCellSpec) -> PCellGrid:
    """The grid of the whole swarm from its (N,) slots and each agent's
    position ``opos`` in the stable cell-id order, with no sort: ``order``
    inverts ``opos``, ``kept`` moves the dropped agents behind the kept ones
    in that order (a prefix count), and ``cell_start`` is the exclusive
    prefix of the kept agents per cell (:func:`build_pcell_grid`'s tables,
    equal to them)."""
    n = slot.shape[0]
    dev = slot.device
    ncell = spec.cx * spec.cy
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    order = torch.empty_like(idx).scatter_(0, opos.long(), idx)
    ok = slot[order.long()] >= 0
    n_kept = torch.cumsum(ok, 0, dtype=torch.int32)
    n_ok = n_kept[-1]
    kpos = torch.where(ok, n_kept - 1, n_ok + idx - n_kept)
    kept = torch.empty_like(idx).scatter_(0, kpos.long(), order)
    s = slot.clamp_min(0)
    cell = torch.where(slot >= 0, s // (spec.cap * spec.cy) * spec.cy
                       + s % spec.cy, ncell)
    count = torch.zeros(ncell + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, cell.long(), torch.ones_like(idx))
    cell_start = torch.cat([count.new_zeros(1),
                            torch.cumsum(count[:ncell], 0, dtype=torch.int32)])
    return PCellGrid(slot=slot, order=order, kept=kept,
                     cell_start=cell_start, overflow=n - cell_start[ncell])


def build_pcell_grid_sharded(pos: torch.Tensor, spec: PCellSpec,
                             axis: AxisGroup) -> PCellGrid:
    """:func:`build_pcell_grid` with its sort shared over the ranks of
    ``axis`` (the JAX package's ``build_pcell_grid_sharded``): each rank
    sorts its own contiguous 1/D slice of the agents by cell id and ranks
    them within their runs; the per-cell counts of all ranks
    (``all_gather``) give each rank's offset in every cell's run (the
    exclusive prefix over the ranks before it), so local rank plus offset
    is the rank of the global stable sort (slices are contiguous and
    ascending, so ties break by agent index either way). One more
    ``all_gather`` brings every agent's slot and position in the cell-id
    order, from which every rank builds ``kept`` and ``cell_start``
    locally (:func:`_grid_from_slots`). Equal to the replicated build
    field for field. The origin is the ``MIN`` over the ranks' slices.

    Collective bytes per build: 4·D·cx·cy of counts and 8·N of slots and
    positions gathered, 8 of the origin reduced.

    Under ``axis.emulated`` (the force_n_dev timing mode on one device) the
    collectives are replaced by local operations of the same shapes and
    the grid is not this swarm's: the slice is strided (a thinned copy of
    the whole swarm rather than a ring of the radially ordered lattice),
    and its D copies, each offset in rank by one more slice's counts, stand
    in for the other ranks' slots. So the cells hold about the real
    density, every index is in range, and the result is a valid grid of
    other agents; the rewards of such a run mean nothing. Raises when N is
    not a multiple of D (the caller then uses the replicated build)."""
    n = pos.shape[0]
    d_n, d = axis.n_dev, axis.index
    if n % d_n:
        raise ValueError(f"the sharded grid build needs N divisible by the "
                         f"{d_n} ranks ({n} % {d_n} = {n % d_n})")
    local = n // d_n
    dev = pos.device
    ps = pos[d::d_n] if axis.emulated else pos[d * local:(d + 1) * local]
    origin = axis.all_reduce(ps.min(0).values.contiguous(), dist.ReduceOp.MIN)
    ij = torch.floor((ps - origin) / spec.cell).to(torch.int32)
    in_grid = (ij[:, 0] < spec.cx) & (ij[:, 1] < spec.cy)
    cid = (torch.clamp_max(ij[:, 0], spec.cx - 1) * spec.cy
           + torch.clamp_max(ij[:, 1], spec.cy - 1))
    o_loc = torch.argsort(cid, stable=True)
    sc = cid[o_loc]
    rank_loc = (torch.arange(local, dtype=torch.int32, device=dev)
                - torch.searchsorted(sc, sc, out_int32=True))
    ncell = spec.cx * spec.cy
    counts = torch.zeros(ncell, dtype=torch.int32, device=dev).scatter_add_(
        0, sc.long(), torch.ones_like(sc))
    ig = in_grid[o_loc]

    def slots_and_positions(base, prefix):
        """(..., local, 2): each local agent's slot and position in the
        cell-id order, in agent order, for offsets ``base`` (..., local)
        in the runs of its sorted cell ids."""
        rank = rank_loc + base
        ok = (rank < spec.cap) & ig
        slot_s = torch.where(
            ok, (sc // spec.cy * spec.cap + rank) * spec.cy + sc % spec.cy, -1)
        both = torch.stack([slot_s, prefix[sc] + rank], -1)
        return torch.empty_like(both).index_copy_(-2, o_loc, both)

    if axis.emulated:
        # copy r of the slice sits behind r slices in every cell's run; the
        # D copies in one batch, as many operations as a real rank's
        prefix = (torch.cumsum(counts, 0, dtype=torch.int32) - counts) * d_n
        r = torch.arange(d_n, dtype=torch.int32, device=dev)[:, None]
        both = slots_and_positions(r * counts[sc], prefix)   # (D, local, 2)
        both = both.transpose(0, 1).reshape(n, 2)
    else:
        counts_all = axis.all_gather(counts[None])             # (D, ncell)
        base = torch.cumsum(counts_all, 0, dtype=torch.int32) - counts_all
        total = counts_all.sum(0, dtype=torch.int32)
        prefix = torch.cumsum(total, 0, dtype=torch.int32) - total
        both = axis.all_gather(slots_and_positions(base[d][sc], prefix))
    return _grid_from_slots(both[:, 0].contiguous(), both[:, 1], spec)


def tile_cells(spec: PCellSpec, n: int) -> int:
    """Columns per tile (of ``TILE_ROWS`` grid rows): those that hold
    ``TILE_AGENTS`` agents at the grid's mean density. Static: from the
    spec and N only."""
    per_cell = max(n, 1) / (spec.cx * spec.cy)
    t = round(TILE_AGENTS / (per_cell * TILE_ROWS))
    return int(min(max(t, 1), MAX_TILE, spec.cy))


# --- plain versions -------------------------------------------------------

_OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


def _candidates(grid: PCellGrid, spec: PCellSpec,
                rows: slice = slice(None)) -> torch.Tensor:
    """(R, 9·cap) candidate agents of the agents ``rows`` (all N by
    default) in the kernels' order; -1 for an empty rank, a cell outside
    the grid, the agent itself, and every candidate of a dropped agent.
    Built from the slots alone (a cap-wide cell table scattered here),
    independent of the ranges the kernels walk."""
    n = grid.slot.shape[0]
    dev = grid.slot.device
    slot = grid.slot.to(torch.int64)
    s = slot.clamp_min(0)
    ci, cj = s // (spec.cap * spec.cy), s % spec.cy
    nslot = spec.cx * spec.cy * spec.cap
    table = torch.full((nslot + 1,), -1, dtype=torch.int64, device=dev)
    table.scatter_(0, torch.where(
        slot >= 0, (ci * spec.cy + cj) * spec.cap + s // spec.cy % spec.cap,
        nslot), torch.arange(n, device=dev))
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)
    ni = ci[rows, None] + offs[:, 0]                              # (R, 9)
    nj = cj[rows, None] + offs[:, 1]
    cell_ok = ((ni >= 0) & (ni < spec.cx) & (nj >= 0) & (nj < spec.cy)
               & (slot[rows] >= 0)[:, None])
    cell = ni.clamp(0, spec.cx - 1) * spec.cy + nj.clamp(0, spec.cy - 1)
    cand = table[:-1].view(-1, spec.cap)[cell]                   # (R,9,cap)
    cand = torch.where(cell_ok[..., None], cand, -1).reshape(ni.shape[0], -1)
    me = torch.arange(n, device=dev)[rows, None]
    return torch.where(cand == me, -1, cand)


def _pair_geometry(pos: torch.Tensor, cand: torch.Tensor,
                   rows: slice = slice(None)):
    """Differences and squared distances from the agents ``rows`` to each
    of their candidates, rounded per operation exactly as the kernels
    round them."""
    valid = cand >= 0
    pj = pos[cand.clamp_min(0)]                                   # (R, M, ·)
    dx = pos[rows, None, 0] - pj[..., 0]
    dy = pos[rows, None, 1] - pj[..., 1]
    return valid, pj, dx, dy, dx * dx + dy * dy


def _neighbour_sum(cols: torch.Tensor, jj: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """sum_m w[r, m]·cols[jj[r, m]] -> (R, C). The terms are laid out
    (C, R, M), so each column is summed over the candidates along a
    contiguous innermost axis: on the CPU a column's sum then depends on
    its own terms alone, as each column's sum does in the kernels, and C
    columns give any split of them, concatenated, bit for bit."""
    g = cols.t().contiguous().index_select(1, jj.reshape(-1))
    return (g.view(cols.shape[1], *jj.shape) * w).sum(-1).t().contiguous()


def frame_sweep_plain(x: torch.Tensor, grid: PCellGrid, spec: PCellSpec,
                      r2cut: float, centralized: bool,
                      rows: slice = slice(None),
                      band: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """K1's function in plain PyTorch: (N, 4) -> (N, 10), or the rows
    ``rows`` of it (a slice: the candidate gather is (rows, 9·cap)), over
    the grid rows ``band`` (all by default; 0 for the agents outside)."""
    valid, xj, dx, dy, r2 = _pair_geometry(
        x, _candidates(grid, spec, rows), rows)
    dvx = x[rows, None, 2] - xj[..., 2]
    dvy = x[rows, None, 3] - xj[..., 3]
    r2s = torch.clamp_min(torch.where(valid, r2, 1.0), COLLISION_R2_EPS)
    inv2 = 1.0 / r2s
    inv4 = inv2 * inv2
    m = (valid & (r2 < r2cut)).to(x.dtype)
    gmask = (valid & (r2 <= 1.0)).to(x.dtype) if centralized else m
    parts = (dvx * m, dx * inv4 * m, dx * inv2 * m,
             dvy * m, dy * inv4 * m, dy * inv2 * m, m,
             (-2.0 * dx * inv4 + 2.0 * dx * inv2) * gmask,
             (-2.0 * dy * inv4 + 2.0 * dy * inv2) * gmask)
    out = [t.sum(1) for t in parts]
    out.append(torch.where(valid, r2, MIN_R2_FILL).amin(1))
    return _banded(torch.stack(out, -1), grid, spec, _band(spec, band), rows)


def apply_deg_sweep_plain(x: torch.Tensor, cols: torch.Tensor,
                          deg: torch.Tensor, grid: PCellGrid, spec: PCellSpec,
                          r2cut: float, rows: slice = slice(None),
                          band: Optional[Tuple[int, int]] = None
                          ) -> torch.Tensor:
    """K2's function in plain PyTorch: out_i = sum_j m·cols_j/max(deg_j, 1)
    (for the agents ``rows``, over the grid rows ``band``)."""
    cand = _candidates(grid, spec, rows)
    valid, _, _, _, r2 = _pair_geometry(x[:, :2], cand, rows)
    jj = cand.clamp_min(0)
    w = (valid & (r2 < r2cut)).to(cols.dtype) / deg[jj].clamp_min(1.0)
    return _banded(_neighbour_sum(cols, jj, w), grid, spec,
                   _band(spec, band), rows)


def apply_sweep_plain(pos: torch.Tensor, cols: torch.Tensor,
                      deg: torch.Tensor, grid: PCellGrid, spec: PCellSpec,
                      r2cut: float, rows: slice = slice(None),
                      band: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """K3's function in plain PyTorch: out_i = sum_j m·cols_j/max(deg_j, 1),
    the columns divided first (for the agents ``rows``, over the grid rows
    ``band``)."""
    cand = _candidates(grid, spec, rows)
    valid, _, _, _, r2 = _pair_geometry(pos, cand, rows)
    m = (valid & (r2 < r2cut)).to(cols.dtype)
    wcols = cols / torch.clamp_min(deg, 1.0)[:, None]
    return _banded(_neighbour_sum(wcols, cand.clamp_min(0), m), grid, spec,
                   _band(spec, band), rows)


# --- kernel wrappers ------------------------------------------------------

def _check_meta(name: str, t: torch.Tensor, shape: Sequence[int], dtype,
                device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _check(name: str, t: torch.Tensor, shape: Sequence[int], dtype,
           device: torch.device, align: int = 4) -> None:
    _check_meta(name, t, shape, dtype, device)
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _check_grid(grid: PCellGrid, spec: PCellSpec, n: int,
                device: torch.device) -> None:
    _check("grid.slot", grid.slot, (n,), torch.int32, device)
    _check("grid.kept", grid.kept, (n,), torch.int32, device)
    _check("grid.cell_start", grid.cell_start, (spec.cx * spec.cy + 1,),
           torch.int32, device)


def _tile(spec: PCellSpec, n: int, tile: Optional[int]) -> int:
    tile = tile_cells(spec, n) if tile is None else int(tile)
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}], got {tile}")
    return tile


def _launch(fn_name: str, *args) -> None:
    from multiagent_gnn_policies_tpu_torch.ops import _build

    rc = getattr(_build.library(), fn_name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")


def _output(spec: PCellSpec, band: Tuple[int, int], shape, dtype, device):
    """A kernel's output: a partial band leaves the other agents' rows
    unwritten, so they start at 0."""
    new = torch.empty if band == (0, spec.cx) else torch.zeros
    return new(shape, dtype=dtype, device=device)


def frame_sweep(x: torch.Tensor, grid: PCellGrid, spec: PCellSpec,
                r2cut: float, centralized: bool,
                tile: Optional[int] = None,
                band: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K1: the (N, 10) frame channels of ``x`` (N, 4) over ``grid``.
    ``tile``: cells per block (default :func:`tile_cells`); ``band``:
    ``(row0, rows)`` of grid rows swept (all by default; 0 for the agents
    outside it, :func:`band_agents`)."""
    if not x.is_cuda:
        return frame_sweep_plain(x, grid, spec, r2cut, centralized,
                                 band=band)
    n = x.shape[0]
    band = _band(spec, band)
    _check("x", x, (n, 4), torch.float32, x.device, align=16)
    _check_grid(grid, spec, n, x.device)
    out = _output(spec, band, (n, FRAME_CHANNELS), x.dtype, x.device)
    _launch("cells_frame", x.data_ptr(), grid.kept.data_ptr(),
            grid.cell_start.data_ptr(), out.data_ptr(), n, spec.cx, spec.cy,
            *band, _tile(spec, n, tile), r2cut, int(centralized))
    _count(frame_sweep, FRAME_CHANNELS)
    return out


def apply_chunks(c: int):
    """``(first column, width)`` of each launch that covers ``c`` columns
    on the card: chunks of the widest built width, then the rest, each a
    width of ``APPLY_COLS``. Raises for ``c`` that is not a whole number of
    ``SLOT_COLS``-column slots."""
    if c <= 0 or c % SLOT_COLS:
        raise ValueError(f"the apply kernels take whole slots of {SLOT_COLS} "
                         f"columns on the card (launched in chunks of "
                         f"{APPLY_COLS}), got {c} columns")
    w = max(APPLY_COLS)
    return [(c0, min(w, c - c0)) for c0 in range(0, c, w)]


def _row_stride(name: str, t: torch.Tensor, shape: Sequence[int], dtype,
                device: torch.device) -> int:
    """The row stride of a 2-D ``t`` whose rows are contiguous and 8-byte
    aligned (a row-strided view passes); raises otherwise."""
    _check_meta(name, t, shape, dtype, device)
    n, c = shape
    if t.stride(1) != 1:
        raise ValueError(f"{name} must have last stride 1, got {t.stride()}")
    ld = t.stride(0) if n > 1 else c
    if ld < c:
        raise ValueError(f"{name} rows overlap (row stride {ld} < {c})")
    if t.data_ptr() % 8 or (ld * t.element_size()) % 8:
        raise ValueError(f"{name} rows must be 8-byte aligned (row stride "
                         f"{ld}, address {t.data_ptr()})")
    return ld


def _count(wrapper, c: int) -> None:
    wrapper.launches += 1
    wrapper.launches_by_cols[c] = wrapper.launches_by_cols.get(c, 0) + 1


def _apply_chunked(wrapper, fn_name: str, first: int, cols: torch.Tensor,
                   ptrs: Sequence[int], spec: PCellSpec,
                   band: Tuple[int, int], tail: Sequence,
                   device) -> torch.Tensor:
    """Launch ``fn_name`` over the columns ``cols`` (N, C) in the chunks of
    :func:`apply_chunks`, each read in place and each over the whole
    ``band``; its arguments are ``first`` (the state or positions), the
    chunk's columns, ``ptrs`` (degrees, kept, cell starts), the chunk's
    output, N, the chunk's width, the row stride, the grid and the band,
    then ``tail``. Each launch is counted."""
    n, c = cols.shape
    chunks = apply_chunks(c)
    ld = _row_stride("cols", cols, (n, c), torch.float32, device)
    outs = []
    for c0, w in chunks:
        out = _output(spec, band, (n, w), cols.dtype, device)
        _launch(fn_name, first, cols.data_ptr() + cols.element_size() * c0,
                *ptrs, out.data_ptr(), n, w, ld, spec.cx, spec.cy, *band,
                *tail)
        _count(wrapper, w)
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def apply_deg_sweep(x: torch.Tensor, cols: torch.Tensor, deg: torch.Tensor,
                    grid: PCellGrid, spec: PCellSpec, r2cut: float,
                    tile: Optional[int] = None,
                    band: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K2: ``out_i = sum_j m·cols_j / max(deg_j, 1)`` over ``grid``.
    ``cols`` may be a row-strided view (last stride 1, 8-byte aligned
    rows); it is read in place. ``tile``: cells per block (default
    :func:`tile_cells`); ``band`` as :func:`frame_sweep`'s (``deg`` must
    hold the degrees of the band's agents and of its two halo rows)."""
    if not x.is_cuda:
        return apply_deg_sweep_plain(x, cols, deg, grid, spec, r2cut,
                                     band=band)
    n = cols.shape[0]
    band = _band(spec, band)
    _check("x", x, (n, 4), torch.float32, x.device, align=16)
    _check("deg", deg, (n,), torch.float32, x.device)
    _check_grid(grid, spec, n, x.device)
    return _apply_chunked(
        apply_deg_sweep, "cells_apply_deg", x.data_ptr(), cols,
        (deg.data_ptr(), grid.kept.data_ptr(), grid.cell_start.data_ptr()),
        spec, band, (_tile(spec, n, tile), r2cut), x.device)


def apply_sweep(pos: torch.Tensor, cols: torch.Tensor, deg: torch.Tensor,
                grid: PCellGrid, spec: PCellSpec, r2cut: float,
                tile: Optional[int] = None,
                band: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K3: ``out_i = sum_j m·cols_j / max(deg_j, 1)`` over ``grid``, the
    graph of ``pos`` whose degrees ``deg`` are. ``cols`` may be a
    row-strided view (last stride 1, 8-byte aligned rows); it is read in
    place. ``tile``: cells per block (default :func:`tile_cells`); ``band``
    as :func:`frame_sweep`'s."""
    if not pos.is_cuda:
        return apply_sweep_plain(pos, cols, deg, grid, spec, r2cut,
                                 band=band)
    n = cols.shape[0]
    band = _band(spec, band)
    _check("pos", pos, (n, 2), torch.float32, pos.device, align=8)
    _check("deg", deg, (n,), torch.float32, pos.device)
    _check_grid(grid, spec, n, pos.device)
    return _apply_chunked(
        apply_sweep, "cells_apply", pos.data_ptr(), cols,
        (deg.data_ptr(), grid.kept.data_ptr(), grid.cell_start.data_ptr()),
        spec, band, (_tile(spec, n, tile), r2cut), pos.device)


KERNEL_WRAPPERS = (frame_sweep, apply_deg_sweep, apply_sweep)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        fn.launches_by_cols = {}


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


@contextlib.contextmanager
def uncounted():
    """The wrappers' calls in here leave the counters as they were: for a
    graph captured only to count its nodes, which never launches."""
    saved = [(fn.launches, dict(fn.launches_by_cols))
             for fn in KERNEL_WRAPPERS]
    try:
        yield
    finally:
        for fn, (n, by) in zip(KERNEL_WRAPPERS, saved):
            fn.launches, fn.launches_by_cols = n, by


def launch_counts_by_cols() -> dict:
    """``{wrapper name: {output columns: launches}}`` (K1's are its 10
    frame channels)."""
    return {fn.__name__: dict(sorted(fn.launches_by_cols.items()))
            for fn in KERNEL_WRAPPERS}


# the kernels' names in a profiler trace, by wrapper: K1 launches 10
# frame channels, K2 and K3 the template's column count
_KERNEL_NAMES = re.compile(
    r"\b(?:(frame_kernel)\(|apply_deg_kernel<(\d+),|apply_kernel<(\d+)>)")


def launches_in_trace(names) -> dict:
    """The kernels' launches on the device, read from the names of a
    profiler trace's device events (``utils.profiling.trace_events``):
    ``{wrapper name: {output columns: launches}}`` as
    :func:`launch_counts_by_cols` gives them. The counters count the
    wrappers' calls on the host, which a CUDA graph's replay makes none
    of; the trace counts what the device ran."""
    out = {fn.__name__: {} for fn in KERNEL_WRAPPERS}
    for name in names:
        m = _KERNEL_NAMES.search(name)
        if m is None:
            continue
        frame, deg_c, c = m.groups()
        wrapper, cols = (("frame_sweep", 10) if frame else
                         ("apply_deg_sweep", int(deg_c)) if deg_c else
                         ("apply_sweep", int(c)))
        out[wrapper][cols] = out[wrapper].get(cols, 0) + 1
    return {w: dict(sorted(by.items())) for w, by in out.items()}


SETTLE_S = 0.5     # host wait around a traced window's sentinels
SENTINELS = 32     # spin kernels on each side of a traced window


def device_launches(fn):
    """``fn()`` under torch.profiler (device activity): ``(its result, the
    kernels' launches the device ran, by wrapper and width)``
    (:func:`launches_in_trace`). On an H100 the profiler at times loses
    the first records of a window, and the last ones of a window that
    closes as soon as the device finishes (seen around CUDA graph replays
    and eager episodes alike). So the window opens with throwaway kernels
    and a wait, then SENTINELS spin kernels, runs ``fn``, waits, launches
    SENTINELS more spin kernels and waits again before it closes; it
    raises RuntimeError unless the trace holds every sentinel, the work
    between them included."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from multiagent_gnn_policies_tpu_torch.utils.profiling import (
        trace_events)

    def sentinels():
        for _ in range(SENTINELS):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()

    primer = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            primer.zero_()
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        sentinels()
        out = fn()
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        sentinels()
        time.sleep(SETTLE_S)
    names = [e.name for e in trace_events(prof)]
    seen = sum("spin_kernel" in name for name in names)
    if seen != 2 * SENTINELS:
        raise RuntimeError(f"the profiler lost part of the trace: {seen} of "
                           f"{2 * SENTINELS} sentinel kernels in it")
    return out, launches_in_trace(names)


reset_launch_counts()


# --- the JAX package's wrappers, on one device or a band of a mesh -------

def _expert_from(per: torch.Tensor, x: torch.Tensor,
                 centralized: bool) -> torch.Tensor:
    """The analytic expert from K1's channels: ``-(consensus + gradient)``,
    clipped to ±10. Centralized, the consensus is ``sum_{j != i}(v_i -
    v_j)`` over the whole swarm (float64, :mod:`ops.precision`) and the
    gradient channels 7-8 are masked by ``r² <= 1``; decentralized, both
    are neighbour sums over the radius graph (channels 0 and 3, and 7-8
    masked by the radius)."""
    if centralized:
        cons = centralized_consensus(x[:, 2:4])
    else:
        cons = per[:, 0:4:3]
    return torch.clamp(-(cons + per[:, 7:9]), -10.0, 10.0)


def _frame_quantities(per: torch.Tensor, x: torch.Tensor, centralized: bool,
                      need_expert: bool) -> FrameQuantities:
    expert = _expert_from(per, x, centralized) if need_expert else None
    return FrameQuantities(values=per[:, :6], degree=per[:, 6], expert=expert,
                           min_r2=per[:, 9].min())


def _complete(t: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    """A band's (N, C) table summed over the ranks of ``axis`` (each agent
    is written by one band, so the sum is exact); as it is without one."""
    return t if axis is None else axis.all_reduce(t)


def frame(x: torch.Tensor, grid: PCellGrid, spec: PCellSpec,
          p: FlockingParams, centralized: bool = True,
          need_expert: bool = False,
          band: Optional[Tuple[int, int]] = None,
          axis: Optional[AxisGroup] = None) -> FrameQuantities:
    """Frame quantities of ``x`` (N, 4) through K1 (``blocked_frame``
    semantics; ``min_r2`` over each agent's 3x3-cell candidates). The
    expert only with ``need_expert`` (``expert`` is None otherwise: the
    greedy policy path never reads it).

    ``band`` / ``axis``: each rank sweeps its band of grid rows and one
    ``all_reduce(SUM)`` over ``axis`` completes the (N, 10) table (the JAX
    package's ``row_range`` / ``axis_name``)."""
    per = frame_sweep(x, grid, spec, float(p.comm_radius) ** 2, centralized,
                      band=band)
    return _frame_quantities(_complete(per, axis), x, centralized,
                             need_expert)


def halo_band(spec: PCellSpec, band: Tuple[int, int]) -> Tuple[int, int]:
    """``band`` with its halo rows above and below, inside the grid: the
    rows whose degrees K2 reads for the agents of ``band``."""
    row0, rows = band
    lo, hi = max(row0 - 1, 0), min(row0 + rows + 1, spec.cx)
    return lo, hi - lo


def frame_apply(x: torch.Tensor, cols: torch.Tensor, grid: PCellGrid,
                spec: PCellSpec, p: FlockingParams, centralized: bool = True,
                need_expert: bool = False,
                band: Optional[Tuple[int, int]] = None,
                axis: Optional[AxisGroup] = None):
    """:func:`frame`'s quantities and ``out_i = sum_{j in nbr(i)} cols_j /
    deg_j`` over the same new graph: K1, then K2 reading K1's degrees.
    Returns ``(FrameQuantities, (N, C) applied columns)``.

    ``band`` / ``axis`` as :func:`frame`'s; one ``all_reduce(SUM)`` of the
    (N, 10 + C) table completes both. K2 on a band reads the degrees of
    its two halo rows, which belong to the neighbouring ranks' bands: the
    JAX package fetches them with a one-row ``ppermute`` each way; here K1
    sweeps the band with its halo rows (:func:`halo_band`, two rows more
    of the same launch, no exchange and no host-side sizes) and the halo
    agents' channels are zeroed before the sum."""
    r2cut = float(p.comm_radius) ** 2
    own = _band(spec, band)
    per = frame_sweep(x, grid, spec, r2cut, centralized,
                      band=halo_band(spec, own))
    applied = apply_deg_sweep(x, cols.contiguous(), per[:, 6].contiguous(),
                              grid, spec, r2cut, band=own)
    if own != (0, spec.cx):
        per = torch.where(band_agents(grid, spec, own)[:, None], per, 0.0)
    if axis is not None:
        table = axis.all_reduce(torch.cat([per, applied], 1))
        per, applied = table[:, :FRAME_CHANNELS], table[:, FRAME_CHANNELS:]
    return _frame_quantities(per, x, centralized, need_expert), applied


def apply_adjT(pos_src: torch.Tensor, deg_src: torch.Tensor,
               cols: torch.Tensor, spec: PCellSpec, p: FlockingParams,
               grid: Optional[PCellGrid] = None,
               band: Optional[Tuple[int, int]] = None,
               axis: Optional[AxisGroup] = None) -> torch.Tensor:
    """``out_i = sum_{j in nbr(i)} cols_j / deg_j`` over the radius graph of
    ``pos_src`` through K3 (the graph is symmetric, so the transpose-apply
    is a neighbour sum of divided columns; K3 divides as it stages).
    ``band`` / ``axis`` as :func:`frame`'s."""
    pos_src = pos_src.contiguous()
    if grid is None:
        grid = build_pcell_grid(pos_src, spec)
    return _complete(apply_sweep(pos_src, cols, deg_src, grid, spec,
                                 float(p.comm_radius) ** 2, band=band), axis)


def ystack_pre(carry: DelayCarry, s0_out: torch.Tensor, spec: PCellSpec,
               p: FlockingParams,
               grid_hist: Optional[Sequence[PCellGrid]] = None,
               band: Optional[Tuple[int, int]] = None,
               axis: Optional[AxisGroup] = None) -> torch.Tensor:
    """The aggregated delayed stack ``y_k = G_k(t)^T x_{t-k}`` (K, N, F)
    with the s = 0 (current-graph) apply already done: ``s0_out`` is
    :func:`frame_apply`'s output of the previous step. Only the historical
    graphs' applies (s >= 1) remain, newest graph first. Each apply takes
    the slots not yet final as a row-strided view of the last output, and
    its first slot is final: at K = 3 the step issues K3 and one stack.
    ``band`` / ``axis`` as :func:`frame`'s: one ``all_reduce`` per
    historical apply."""
    k = carry.history.shape[0]
    n, f = carry.history.shape[1:]
    y = [carry.history[0]]
    if k == 1:
        return torch.stack(y)
    v = s0_out.reshape(n, k - 1, f).transpose(0, 1)          # (K-1, N, F)
    y.append(v[0])
    for s in range(1, k - 1):
        pos_s, deg_s = carry.pos_hist[s - 1], carry.deg_hist[s - 1]
        grid_s = grid_hist[s - 1] if grid_hist else None
        cols = v[1:].transpose(0, 1).reshape(n, (k - 1 - s) * f)
        out = apply_adjT(pos_s, deg_s, cols, spec, p, grid=grid_s,
                         band=band, axis=axis)
        v = out.reshape(n, k - 1 - s, f).transpose(0, 1)      # slots s..K-2
        y.append(v[0])
    return torch.stack(y)
