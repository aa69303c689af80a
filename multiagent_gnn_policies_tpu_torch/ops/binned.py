"""The spatial-hash neighbour list: the exact O(N · cap) radius graph.

The counterpart of the JAX package's ``ops/binned.py``. Flocking swarms
hold a constant density (the arena's area grows with N), so the radius
graph has O(1) mean degree. This module computes the frame quantities and
the adjacency transpose-applies of ``ops/blocked.py`` in O(N · cap):

1. **Bin**: an agent's cell is ``(floor(px / r), floor(py / r))`` with the
   cell edge ``r = comm_radius`` (so every radius neighbour lies in the 3x3
   cells around it), hashed into 2^20 keys: no arena bounds, no grid.
2. **Sort**: the agents are sorted by key (stable); each cell is a run.
3. **Scan**: per agent, the runs of its 9 neighbouring cells are located
   with ``searchsorted`` and up to ``cap`` agents taken from each: a fixed
   (N, 9·cap) candidate table. A bucket that two of the 9 offsets hash to
   is read once (no double count); candidates beyond the radius are masked
   by the exact distance.

**Exactness**: with ``NeighborList.overflow == 0`` (no run longer than
``cap``) the table lists every radius neighbour exactly once, so its frame
quantities and applies are exact. ``overflow`` counts the agents a full
run hides; the rollout surfaces it and never drops it silently.

The keys equal the JAX package's bit for bit: it multiplies int32 cell
coordinates by int32 primes with wrap-around; here the products are taken
in int64 (no overflow) and masked to 20 bits, whose low bits are the same.

Every function is plain PyTorch (gathers, elementwise work and sums over
the candidate axis); the JAX module reaches no Pallas kernel either. On a
mesh the table is built on every rank and each rank gathers its own
destination rows (``row_range``); a tiled ``all_gather`` completes them.
Memory: the frame gathers a (4, N, 9·cap) block (151 MB at N = 32,768,
cap 32), the applies a (C, N, 9·cap) one. The gathers are channel-major
(one float per index): gathered as rows of 16 or 48 bytes, torch's
16-byte vectorised row gather took 72% of the binned step's device time
on the H100 at N = 100,000 (PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

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

HASH_BITS = 20
HASH_SIZE = 1 << HASH_BITS
# the classic 2-D spatial-hash primes (Teschner et al.)
P1 = 73856093
P2 = 19349663
# the 3x3 cell neighbourhood, (dx, dy) with dx slowest
OFFSETS = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))


class NeighborList(NamedTuple):
    """Fixed-capacity radius-neighbour table (the sparse edge list).

    Attributes:
      idx: (N, 9·cap) int32 candidate agents (arbitrary where masked).
      mask: (N, 9·cap) float 1 for true radius neighbours (r² <
        comm_radius², self excluded), 0 elsewhere; each neighbour appears
        once when ``overflow == 0``.
      r2: (N, 9·cap) squared distances, inf where not a valid candidate.
      deg: (N,) radius degrees (``mask.sum(-1)``).
      overflow: () int32 agents hidden by a run longer than ``cap``; 0
        means the table is exact.
    """

    idx: torch.Tensor
    mask: torch.Tensor
    r2: torch.Tensor
    deg: torch.Tensor
    overflow: torch.Tensor


def _hash_ij(ij: torch.Tensor) -> torch.Tensor:
    """(..., 2) integer cell coordinates -> (...) int32 keys in
    [0, HASH_SIZE): ``(i·P1) ^ (j·P2)`` masked to ``HASH_BITS`` bits."""
    ij = ij.to(torch.int64)
    h = (ij[..., 0] * P1) ^ (ij[..., 1] * P2)
    return (h & (HASH_SIZE - 1)).to(torch.int32)


def _cell_keys(pos: torch.Tensor, cell: float):
    """Hashed cell key per agent, and the int32 cell coordinates."""
    ij = torch.floor(pos / cell).to(torch.int32)                  # (N, 2)
    return _hash_ij(ij), ij


def build_neighbor_list(pos: torch.Tensor, comm_radius: float,
                        cap: int = 32) -> NeighborList:
    """The radius-neighbour table of ``pos`` (N, 2) in O(N log N), exact
    when its ``overflow`` is 0. ``comm_radius`` is also the cell edge, so
    the 3x3 cells hold every radius neighbour; ``cap`` agents are taken
    from each cell's run."""
    n = pos.shape[0]
    dev = pos.device
    keys, ij = _cell_keys(pos, comm_radius)
    order = torch.argsort(keys, stable=True)
    sorted_keys = keys[order]

    # the 9 neighbouring cells' keys, (dx, dy) with dx slowest as OFFSETS
    # lists them (the offsets by device arithmetic: a host table would be
    # a copy from the host inside the step); a key that an earlier offset
    # already has is a hash-collided bucket, read once
    d = torch.arange(-1, 2, device=dev)
    i = ij[:, 0, None, None].to(torch.int64) + d[:, None]          # (N,3,1)
    j = ij[:, 1, None, None].to(torch.int64) + d                   # (N,1,3)
    nbr_h = (((i * P1) ^ (j * P2)) & (HASH_SIZE - 1)).to(
        torch.int32).reshape(n, 9)                                 # (N, 9)
    earlier = torch.ones(9, 9, dtype=torch.bool, device=dev).tril(-1)
    keep = ~((nbr_h[:, :, None] == nbr_h[:, None, :]) & earlier).any(-1)

    start = torch.searchsorted(sorted_keys, nbr_h)
    end = torch.searchsorted(sorted_keys, nbr_h, right=True)
    slot = torch.arange(cap, device=dev)
    valid = ((slot < (end - start)[:, :, None])
             & keep[:, :, None]).reshape(n, 9 * cap)
    cand = order[(start[:, :, None] + slot).clamp(0, n - 1)].reshape(
        n, 9 * cap)
    d = pos[:, None, :] - pos[cand]                                # (N,9c,2)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    self_or_invalid = ~valid | (cand == torch.arange(n, device=dev)[:, None])
    r2 = torch.where(self_or_invalid, torch.inf, r2)
    mask = (r2 < comm_radius * comm_radius).to(pos.dtype)

    # agents ranked >= cap in their own cell's run are gathered by no one
    own_start = torch.searchsorted(sorted_keys, keys)
    rank = torch.arange(n, device=dev) - own_start[order]
    overflow = (rank >= cap).sum().to(torch.int32)
    return NeighborList(idx=cand.to(torch.int32), mask=mask, r2=r2,
                        deg=mask.sum(-1), overflow=overflow)


def _slice_rows(a: torch.Tensor, row_range: RowRange) -> torch.Tensor:
    """Rows ``[start, start + length)`` of ``a`` (all of them for None)."""
    if row_range is None:
        return a
    start, length = row_range
    return a[start:start + length]


def binned_frame(x: torch.Tensor, nl: NeighborList, p: FlockingParams,
                 centralized: bool = True,
                 row_range: RowRange = None) -> FrameQuantities:
    """Frame quantities of ``x`` (N, 4) from its neighbour table:
    ``blocked_frame``'s outputs (observation row-sums, degrees, the expert,
    min r²) in O(N · cap). The expert is always computed.

    The centralized expert's consensus term sums over all agents: the
    O(N) closed form of ``ops/precision.py``. Its potential term truncates
    at unit range, which the table covers when ``comm_radius >= 1``
    (``rollout_large`` refuses less). ``row_range``: only those
    destination rows (``x`` and ``nl`` stay whole; the rows of the ranks
    of a mesh compose with an ``all_gather``); min r² over them."""
    idx = _slice_rows(nl.idx, row_range).long()                  # (R, 9c)
    m = _slice_rows(nl.mask, row_range)
    r2 = _slice_rows(nl.r2, row_range)
    xi = _slice_rows(x, row_range)                                # (R, 4)
    xj = x.t().contiguous()[:, idx]                               # (4,R,9c)
    dx = xi[:, None, 0] - xj[0]
    dy = xi[:, None, 1] - xj[1]
    dvx = xi[:, None, 2] - xj[2]
    dvy = xi[:, None, 3] - xj[3]
    r2s = torch.clamp_min(torch.where(torch.isinf(r2), 1.0, r2),
                          COLLISION_R2_EPS)
    inv_r2 = 1.0 / r2s
    inv_r4 = inv_r2 * inv_r2
    values = torch.stack([
        (dvx * m).sum(1),
        (dx * inv_r4 * m).sum(1),
        (dx * inv_r2 * m).sum(1),
        (dvy * m).sum(1),
        (dy * inv_r4 * m).sum(1),
        (dy * inv_r2 * m).sum(1),
    ], -1)
    in_range = (r2 <= 1.0).to(x.dtype)
    gx = (-2.0 * dx * inv_r4 + 2.0 * dx * inv_r2) * in_range
    gy = (-2.0 * dy * inv_r4 + 2.0 * dy * inv_r2) * in_range
    if centralized:
        cons = _slice_rows(centralized_consensus(x[:, 2:4]), row_range)
        ux = -(cons[:, 0] + gx.sum(1))
        uy = -(cons[:, 1] + gy.sum(1))
    else:
        ux = -((dvx * m).sum(1) + (gx * m).sum(1))
        uy = -((dvy * m).sum(1) + (gy * m).sum(1))
    expert = torch.clamp(torch.stack([ux, uy], -1), -10.0, 10.0)
    # the table's min is the global min pairwise r² whenever that is below
    # comm_radius² (the reset's min_separation always is)
    return FrameQuantities(values=values, degree=m.sum(-1), expert=expert,
                           min_r2=r2.min())


def apply_adjT(idx: torch.Tensor, mask: torch.Tensor, deg: torch.Tensor,
               cols: torch.Tensor, row_range: RowRange = None
               ) -> torch.Tensor:
    """``out[i] = sum_{j in nbr(i)} cols[j] / max(deg_j, 1)``: the
    degree-normalised adjacency transpose-apply (the radius graph is
    symmetric, so destination-major gathers replace the product). The mask
    is divided by the source degrees (the JAX module's order).

    Args:
      idx / mask / deg: a neighbour table; ``deg`` covers all N sources
        even under ``row_range``.
      cols: (N, C) columns of the matching time step.
      row_range: only those destination rows, (R, C); an ``all_gather``
        completes them.
    """
    idx = _slice_rows(idx, row_range).long()
    w = _slice_rows(mask, row_range) / torch.clamp_min(deg, 1.0)[idx]
    return (w * cols.t().contiguous()[:, idx]).sum(-1).t().contiguous()


def binned_apply_adjT(nl: NeighborList, cols: torch.Tensor,
                      deg: Optional[torch.Tensor] = None,
                      row_range: RowRange = None) -> torch.Tensor:
    """:func:`apply_adjT` addressed by a :class:`NeighborList` (its own
    degrees unless ``deg`` is given)."""
    return apply_adjT(nl.idx, nl.mask, nl.deg if deg is None else deg, cols,
                      row_range)


def binned_ystack(carry: DelayCarry, nl_now: NeighborList, p: FlockingParams,
                  cap: int = 32, row_range: RowRange = None,
                  axis=None) -> torch.Tensor:
    """The aggregated delayed stack ``y_k = G_k(t)^T x_{t-k}`` (K, N, F):
    ``delayed_ystack`` with every transpose-apply through a neighbour
    table. ``A_t^T`` goes to every delayed slot, then ``A_{t-1}^T`` to
    slots >= 2, ... (newest first). The historical tables are rebuilt from
    the carry's positions (``pos_hist``; ``deg_hist`` is not read: a
    rebuilt table has the same degrees). Their overflow was counted when
    their frames were current; the episode-start zero positions only ever
    multiply zero slots.

    Args:
      nl_now: the current frame's table (the graph ``A_t``).
      row_range / axis: each rank gathers its destination rows and a tiled
        ``all_gather`` over ``axis`` (a ``parallel.distributed.AxisGroup``)
        restores the (N, C) columns after every apply.
    """
    k = carry.history.shape[0]
    n, f = carry.history.shape[1:]
    y = [carry.history[0]]
    if k == 1:
        return torch.stack(y)
    v = carry.history[1:].clone()                        # slots 1..K-1
    for s in range(k - 1):
        nl_s = nl_now if s == 0 else build_neighbor_list(
            carry.pos_hist[s - 1], p.comm_radius, cap)
        cols = v[s:].transpose(0, 1).reshape(n, (k - 1 - s) * f)
        out = binned_apply_adjT(nl_s, cols, row_range=row_range)
        if axis is not None:
            out = axis.all_gather(out)
        v[s:] = out.reshape(n, k - 1 - s, f).transpose(0, 1)
        y.append(v[s])
    return torch.stack(y)
