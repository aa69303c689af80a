"""The regular-layout cell grid: the O(N) radius graph as dense per-cell
blocks.

The counterpart of the JAX package's ``ops/cells.py``. It computes the
frame quantities and adjacency transpose-applies of ``ops/blocked.py``
with no per-candidate gather:

1. **Pack** (:func:`build_cell_grid`, :func:`cell_pack`): the agents are
   sorted by cell id (one stable sort) and placed in a dense
   ``(cx·cy·cap, F)`` slot table.
2. **Neighbourhood by slices**: the 3x3 cells around every cell are 9
   constant-offset slices of the zero-padded grid.
3. **Dense sweep**: each cell's ``cap`` slots meet its ``9·cap``
   neighbourhood slots as a dense (cap, 9·cap) block, and the
   transpose-apply is a batched (cap, 9·cap) @ (9·cap, C) product per cell
   (``torch.matmul``, float32: ``envs/flocking.py:strict_fp32`` keeps TF32
   off on the card).
4. **Unpack**: per-agent results come back with one N-row gather.

The JAX module sweeps one strip of ``CellSpec.strip`` grid rows per
``lax.scan`` iteration. Here a sweep takes groups of whole strips, as many
as keep a group's (rows, cy, cap, 9·cap) pair block within
``SWEEP_PAIRS`` (so each float32 temporary of a group stays near 134 MB):
about 40 device operations a group instead of a strip, 2 groups a frame at
N = 32,768. Every per-slot sum runs over one slot's 9·cap candidates and
min r² is a min, so the grouping does not change a result.

**Exactness**: with ``overflow == 0`` (no cell over ``cap``, no agent
outside the grid) every radius neighbour is seen exactly once. The cell
edge is ``max(comm_radius, 1)``, so the 3x3 cells also hold the expert's
unit-range potential. The grid's origin follows the swarm's min corner
each frame; only its extent is static (``margin`` times the initial
swarm's diameter).

On a mesh every rank packs the whole grid, sweeps its band of grid rows
(``row_range``, :func:`make_cell_spec` ``n_dev`` makes the bands whole
strips) and unpacks its band to per-agent rows (:func:`cell_unpack_band`,
0 elsewhere); one ``all_reduce(SUM)`` completes the (N, C) tables (every
agent lives in one band) and a MIN the min r². The JAX module reaches no
Pallas kernel; neither does this one.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

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

RowRange = Optional[Tuple[int, int]]

# (slot, candidate) pairs a sweep group holds at most (whole strips, at
# least one): each float32 temporary of a group is ~4 · SWEEP_PAIRS bytes
SWEEP_PAIRS = 1 << 25
# 3x3 neighbourhood offsets into the padded grid, (dx, dy) in {0, 1, 2}
OFFSETS = tuple((dx, dy) for dx in range(3) for dy in range(3))


class CellSpec(NamedTuple):
    """Static cell-grid geometry."""

    cx: int        # grid cells along x (grid rows)
    cy: int        # grid cells along y
    cap: int       # agent slots per cell
    cell: float    # cell edge (>= comm_radius and >= 1.0)
    strip: int     # grid rows per strip (bands are whole strips)


def make_cell_spec(p: FlockingParams, cap: int = 12, margin: float = 1.3,
                   strip_rows: int = 8, n_dev: int = 1) -> CellSpec:
    """A square grid for ``p``'s initial swarm extent times ``margin``.

    A sweep pays cells · cap · 9·cap pairs whether the slots are filled or
    not, so ``cap`` and ``margin`` are its padding knobs. Occupancy is
    Poisson with mean ``cell² / arena_r2_per_agent / π`` ≈ 2.1, so cap 12
    overflows with negligible probability; the per-step ``overflow``
    certifies it. ``n_dev > 1`` rounds the grid so that each of ``n_dev``
    ranks sweeps an equal whole number of strips."""
    cell = max(p.comm_radius, 1.0)
    extent = 2.0 * math.sqrt(p.arena_r2_per_agent * p.n_agents) * margin
    need = max(3, math.ceil(extent / cell) + 2)
    unit = strip_rows * max(1, n_dev)
    cx = ((need + unit - 1) // unit) * unit
    return CellSpec(cx=cx, cy=cx, cap=cap, cell=cell,
                    strip=min(strip_rows, cx))


class CellGrid(NamedTuple):
    """One frame's agent -> slot assignment, all int32.

    Attributes:
      slot_of_agent: (N,) packed slot ``cell_id·cap + rank`` per agent;
        a dropped agent (its cell over ``cap``, or outside the grid)
        points at the dump slot ``cx·cy·cap``.
      agent_of_slot: (cx·cy·cap,) agent per slot, -1 for an empty one.
      overflow: () dropped agents; 0 means the grid is exact.
    """

    slot_of_agent: torch.Tensor
    agent_of_slot: torch.Tensor
    overflow: torch.Tensor


def build_cell_grid(pos: torch.Tensor, spec: CellSpec) -> CellGrid:
    """Sort the agents of ``pos`` (N, 2) by cell and give each a slot:
    cell ids from the swarm's min corner, a stable argsort, the rank in
    each run of equal ids (the index less the run's first index, a
    running max of the run starts), and the drops of ranks >= ``cap`` and
    of agents outside the grid (clamped into an edge cell for the sort)."""
    n = pos.shape[0]
    dev = pos.device
    nslots = spec.cx * spec.cy * spec.cap
    origin = pos.min(0).values
    ij = torch.floor((pos - origin) / spec.cell).to(torch.int32)   # >= 0
    in_grid = (ij[:, 0] < spec.cx) & (ij[:, 1] < spec.cy)
    cid = (torch.clamp_max(ij[:, 0], spec.cx - 1).long() * spec.cy
           + torch.clamp_max(ij[:, 1], spec.cy - 1).long())
    order = torch.argsort(cid, stable=True)
    sc = cid[order]
    i = torch.arange(n, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sc[1:] != sc[:-1]
    rank = i - torch.cummax(torch.where(is_start, i, 0), 0).values
    ok = (rank < spec.cap) & in_grid[order]
    slot = torch.where(ok, sc * spec.cap + rank, nslots)
    # dropped agents all write the dump slot, which is cut off
    agent_of_slot = torch.full((nslots + 1,), -1, dtype=torch.int64,
                               device=dev).scatter_(0, slot, order)[:-1]
    slot_of_agent = torch.empty_like(slot).scatter_(0, order, slot)
    return CellGrid(slot_of_agent=slot_of_agent.to(torch.int32),
                    agent_of_slot=agent_of_slot.to(torch.int32),
                    overflow=(n - ok.sum()).to(torch.int32))


def cell_pack(grid: CellGrid, arr: torch.Tensor,
              fill: float = 0.0) -> torch.Tensor:
    """(N, ...) agent-major -> (cx·cy·cap, ...) slot-major; empty slots
    read ``fill``."""
    n = arr.shape[0]
    pad = torch.full((1,) + arr.shape[1:], fill, dtype=arr.dtype,
                     device=arr.device)
    a = grid.agent_of_slot.long()
    return torch.cat([arr, pad])[torch.where(a >= 0, a, n)]


def cell_unpack(grid: CellGrid, packed: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """(cx·cy·cap, ...) slot-major -> (N, ...) agent-major (one N-row
    gather); dropped agents get ``fill``."""
    pad = torch.full((1,) + packed.shape[1:], fill, dtype=packed.dtype,
                     device=packed.device)
    return torch.cat([packed, pad])[grid.slot_of_agent.long()]


def cell_unpack_band(grid: CellGrid, packed: torch.Tensor, start_slot: int,
                     fill: float = 0.0) -> torch.Tensor:
    """The band unpack of the sharded sweep: ``packed`` holds slots
    ``[start_slot, start_slot + len(packed))`` only; agents outside the
    band, and dropped agents (the dump slot is in no band), get ``fill``.
    The bands' results summed over a mesh are the whole per-agent table."""
    idx = grid.slot_of_agent.long() - start_slot
    ok = (idx >= 0) & (idx < packed.shape[0])
    vals = packed[torch.where(ok, idx, 0)]
    shape = (ok.shape[0],) + (1,) * (packed.dim() - 1)
    return torch.where(ok.reshape(shape), vals, fill)


def _pad_grid(spec: CellSpec, packed: torch.Tensor, ids: torch.Tensor):
    """A slot table (cx·cy·cap, F) and its agent ids as the zero-padded
    (cx+2, cy+2, cap, F) grid and (cx+2, cy+2, cap) ids (-1 padding)."""
    f = packed.shape[-1]
    g = packed.reshape(spec.cx, spec.cy, spec.cap, f)
    gi = ids.reshape(spec.cx, spec.cy, spec.cap)
    return (F.pad(g, (0, 0, 0, 0, 1, 1, 1, 1)),
            F.pad(gi, (0, 0, 1, 1, 1, 1), value=-1))


def _pad_grid_band(spec: CellSpec, grid: CellGrid, vals: torch.Tensor,
                   row_range: RowRange = None):
    """The padded grid of grid rows ``[start - 1, start + local + 1)`` only
    (a band's rows with their halo; rows outside the grid come out empty),
    gathered from ``vals`` (N, F); ``None``: the whole grid, equal to
    :func:`_pad_grid` of the packed table. Returns ``(gx (local+2, cy+2,
    cap, F), gi (local+2, cy+2, cap))``; band row r is padded row r + 1."""
    n, f = vals.shape
    cx, cy, cap = spec.cx, spec.cy, spec.cap
    start, local = (0, cx) if row_range is None else row_range
    agent3 = grid.agent_of_slot.long().reshape(cx, cy, cap)
    rows = start - 1 + torch.arange(local + 2, device=vals.device)
    in_g = (rows >= 0) & (rows < cx)
    a = agent3[rows.clamp(0, cx - 1)]
    a = torch.where(in_g[:, None, None], a, -1)          # (local+2, cy, cap)
    vals1 = torch.cat([vals, vals.new_zeros((1, f))])
    gx = torch.where((a >= 0)[..., None], vals1[torch.where(a >= 0, a, n)],
                     0.0)
    return (F.pad(gx, (0, 0, 0, 0, 1, 1)),
            F.pad(a, (0, 0, 1, 1), value=-1))


def _strip_views(spec: CellSpec, gx: torch.Tensor, gi: torch.Tensor, s0: int,
                 S: int):
    """Slot data and 3x3-neighbourhood data of the ``S`` grid rows (whole
    strips) from padded row ``s0``.

    Returns ``xi (S, cy, cap, F)``, ``ii (S, cy, cap)``, ``xj (S, cy,
    9·cap, F)`` and ``ij (S, cy, 9·cap)``."""
    cy = spec.cy
    g = gx[s0:s0 + S + 2]
    gid = gi[s0:s0 + S + 2]
    xi, ii = g[1:1 + S, 1:1 + cy], gid[1:1 + S, 1:1 + cy]
    xj = torch.stack([g[dx:dx + S, dy:dy + cy] for dx, dy in OFFSETS], 2)
    ij = torch.stack([gid[dx:dx + S, dy:dy + cy] for dx, dy in OFFSETS], 2)
    return (xi, ii, xj.reshape(S, cy, 9 * spec.cap, gx.shape[-1]),
            ij.reshape(S, cy, 9 * spec.cap))


def _groups(spec: CellSpec, local_rows: int):
    """``(first row, rows)`` of each sweep group of a band of
    ``local_rows`` grid rows: whole strips, as many as ``SWEEP_PAIRS``
    allows (at least one)."""
    per_strip = spec.strip * spec.cy * spec.cap * 9 * spec.cap
    rows = spec.strip * max(1, SWEEP_PAIRS // per_strip)
    nstrips_rows = local_rows // spec.strip * spec.strip
    return [(r0, min(rows, nstrips_rows - r0))
            for r0 in range(0, nstrips_rows, rows)]


def cells_frame(x: torch.Tensor, grid: CellGrid, spec: CellSpec,
                p: FlockingParams, centralized: bool = True,
                row_range: RowRange = None, axis=None) -> FrameQuantities:
    """Frame quantities of ``x`` (N, 4) through the dense cell sweep:
    ``blocked_frame``'s observation row-sums, degrees, expert (always
    computed) and min r² (over the 3x3 neighbourhoods: the global min
    whenever it is below the cell edge, as the reset's threshold is).

    Args:
      row_range: ``(start_row, local_rows)``: sweep those grid rows only;
        the band is unpacked to per-agent rows, 0 for the agents of other
        bands and the dropped ones, and min r² is the band's.
      axis: with ``row_range``, the mesh axis (a ``parallel.distributed.
        AxisGroup``): one ``all_reduce(SUM)`` of the (N, 9) table and a
        MIN of min r² complete the frame.
    """
    start, local_rows = (0, spec.cx) if row_range is None else row_range
    if centralized:
        # the O(N) consensus in float64 (ops/precision.py), packed beside
        # the state so that the sweep reads it per slot
        xin = torch.cat([x, centralized_consensus(x[:, 2:4])], -1)
    else:
        xin = x
    gx, gi = _pad_grid_band(spec, grid, xin, row_range)
    r2cut = p.comm_radius * p.comm_radius
    min_r2 = torch.full((), torch.inf, dtype=x.dtype, device=x.device)
    tables = []
    for r0, rows in _groups(spec, local_rows):
        xi, ii, xj, ij = _strip_views(spec, gx, gi, r0, rows)
        pair_ok = ((ii[..., :, None] >= 0) & (ij[..., None, :] >= 0)
                   & (ii[..., :, None] != ij[..., None, :]))
        dx = xi[..., :, None, 0] - xj[..., None, :, 0]
        dy = xi[..., :, None, 1] - xj[..., None, :, 1]
        dvx = xi[..., :, None, 2] - xj[..., None, :, 2]
        dvy = xi[..., :, None, 3] - xj[..., None, :, 3]
        r2 = dx * dx + dy * dy
        r2s = torch.clamp_min(torch.where(pair_ok, r2, 1.0),
                              COLLISION_R2_EPS)
        inv_r2 = 1.0 / r2s
        inv_r4 = inv_r2 * inv_r2
        m = (pair_ok & (r2 < r2cut)).to(x.dtype)
        in_range = pair_ok.to(x.dtype) * (r2 <= 1.0).to(x.dtype)
        gxp = (-2.0 * dx * inv_r4 + 2.0 * dx * inv_r2) * in_range
        gyp = (-2.0 * dy * inv_r4 + 2.0 * dy * inv_r2) * in_range
        if centralized:
            ux = -(xi[..., 4] + gxp.sum(-1))
            uy = -(xi[..., 5] + gyp.sum(-1))
        else:
            ux = -((dvx * m).sum(-1) + (gxp * m).sum(-1))
            uy = -((dvy * m).sum(-1) + (gyp * m).sum(-1))
        tables.append(torch.stack([
            (dvx * m).sum(-1),
            (dx * inv_r4 * m).sum(-1),
            (dx * inv_r2 * m).sum(-1),
            (dvy * m).sum(-1),
            (dy * inv_r4 * m).sum(-1),
            (dy * inv_r2 * m).sum(-1),
            m.sum(-1),
            torch.clamp(ux, -10.0, 10.0),
            torch.clamp(uy, -10.0, 10.0),
        ], -1).reshape(-1, 9))
        min_r2 = torch.minimum(
            min_r2, torch.where(pair_ok, r2, torch.inf).amin())
    table = torch.cat(tables)                            # (slots, 9)
    if row_range is None:
        per = cell_unpack(grid, table)
    else:
        per = cell_unpack_band(grid, table, start * spec.cy * spec.cap)
    if axis is not None:
        axis.all_reduce(per)
        min_r2 = axis.all_reduce(min_r2.reshape(1), dist.ReduceOp.MIN)[0]
    return FrameQuantities(values=per[:, :6], degree=per[:, 6],
                           expert=per[:, 7:9], min_r2=min_r2)


def cells_apply_adjT(pos_src: torch.Tensor, deg_src: torch.Tensor,
                     cols: torch.Tensor, spec: CellSpec, p: FlockingParams,
                     grid: Optional[CellGrid] = None,
                     row_range: RowRange = None, axis=None) -> torch.Tensor:
    """``out[i] = sum_{j in nbr(i)} cols[j] / max(deg_j, 1)`` over the
    radius graph of ``pos_src``: the columns are divided first and each
    cell's (cap, 9·cap) mask multiplies its neighbourhood's (9·cap, C)
    columns.

    Args:
      pos_src: (N, 2) positions of the (historical) graph.
      deg_src: (N,) that graph's degrees (the rollout carries them);
        episode-start placeholder graphs have degree 1 and zero columns.
      cols: (N, C) columns of the matching time step.
      grid: ``pos_src``'s grid if the caller has it; built otherwise.
      row_range / axis: as :func:`cells_frame`'s (one ``all_reduce(SUM)``
        of the (N, C) table).
    """
    if grid is None:
        grid = build_cell_grid(pos_src, spec)
    start, local_rows = (0, spec.cx) if row_range is None else row_range
    wcols = cols / torch.clamp_min(deg_src, 1.0)[:, None]
    gx, gi = _pad_grid_band(spec, grid, torch.cat([pos_src, wcols], -1),
                            row_range)
    r2cut = p.comm_radius * p.comm_radius
    outs = []
    for r0, rows in _groups(spec, local_rows):
        xi, ii, xj, ij = _strip_views(spec, gx, gi, r0, rows)
        dx = xi[..., :, None, 0] - xj[..., None, :, 0]
        dy = xi[..., :, None, 1] - xj[..., None, :, 1]
        m = ((ii[..., :, None] >= 0) & (ij[..., None, :] >= 0)
             & (ii[..., :, None] != ij[..., None, :])
             & (dx * dx + dy * dy < r2cut)).to(xi.dtype)
        outs.append(torch.matmul(m, xj[..., 2:]).reshape(-1, cols.shape[1]))
    out = torch.cat(outs)
    if row_range is None:
        return cell_unpack(grid, out)
    out = cell_unpack_band(grid, out, start * spec.cy * spec.cap)
    return out if axis is None else axis.all_reduce(out)


def cells_ystack(carry: DelayCarry, grid_now: CellGrid, x_now: torch.Tensor,
                 deg_now: torch.Tensor, spec: CellSpec, p: FlockingParams,
                 row_range: RowRange = None, axis=None) -> torch.Tensor:
    """The aggregated delayed stack ``y_k = G_k(t)^T x_{t-k}`` (K, N, F):
    ``delayed_ystack`` with every transpose-apply on the cell grid, newest
    graph first. The historical grids are rebuilt from the carry's
    positions (their overflow was counted when their frames were current);
    the current one is ``grid_now``. ``row_range`` / ``axis`` as
    :func:`cells_frame`'s."""
    k = carry.history.shape[0]
    n, f = carry.history.shape[1:]
    y = [carry.history[0]]
    if k == 1:
        return torch.stack(y)
    v = carry.history[1:].clone()                        # slots 1..K-1
    for s in range(k - 1):
        if s == 0:
            pos_s, deg_s, grid_s = x_now[:, :2], deg_now, grid_now
        else:
            pos_s, deg_s, grid_s = (carry.pos_hist[s - 1],
                                    carry.deg_hist[s - 1], None)
        cols = v[s:].transpose(0, 1).reshape(n, (k - 1 - s) * f)
        out = cells_apply_adjT(pos_s, deg_s, cols, spec, p, grid=grid_s,
                               row_range=row_range, axis=axis)
        v[s:] = out.reshape(n, k - 1 - s, f).transpose(0, 1)
        y.append(v[s])
    return torch.stack(y)
