"""The O(N²) row-blocked oracle and the delayed-stack carry.

The counterpart of the JAX package's ``ops/blocked.py``:

* :func:`blocked_frame` and :func:`blocked_apply_adjT` compute the frame
  quantities and the degree-normalised adjacency transpose-apply over the
  radius graph with peak memory O(block · N): never an (N, N) array. They
  are the oracle of the cell sweeps (``ops/cells_cuda.py``) in the tests
  and in ``chip_smoke.py``, and the large-N rollout's "blocked" path;
  :func:`pick_block` chooses a block that divides N.
* :class:`DelayCarry`, :func:`delay_carry_init` and
  :func:`delay_carry_update` hold the feature history and the historical
  graphs' positions and degrees that the delayed y-stack reads;
  :func:`delayed_ystack` is the stack's O(N²) oracle at any K.

``row_range = (start, length)`` sweeps only those agent rows, the share of
one rank of a mesh's ``agents`` axis (the JAX package's ``row_range``):
``blocked_frame`` returns the rows' quantities (the caller gathers them)
and ``blocked_apply_adjT`` the rows' outputs with zeros elsewhere, which
one ``all_reduce(SUM)`` completes (``delayed_ystack`` with ``axis``). The
transpose-apply is taken per output row, ``out_j = sum_i adj[j, i] /
deg_i · cols_i`` (the radius graph is symmetric bit for bit:
``x_j - x_i = -(x_i - x_j)`` in IEEE arithmetic), where the JAX package
sums partial columns ``adj[i, :]`` over the source rows: so each output
row is one product over all N sources on every rank count, and the
completed stack does not depend on how the rows are split.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    COLLISION_R2_EPS,
    FlockingParams,
)

RowRange = Optional[Tuple[int, int]]


class FrameQuantities(NamedTuple):
    """Per-agent quantities of the current frame.

    Attributes:
      values: (N, 6) observation feature row-sums.
      degree: (N,) radius-graph degree (excluding self).
      expert: (N, 2) analytic flocking-controller accelerations, or None
        from the cell sweeps unless asked for (``need_expert``: the greedy
        policy path never reads it).
      min_r2: () minimum squared pairwise distance.
    """

    values: torch.Tensor
    degree: torch.Tensor
    expert: Optional[torch.Tensor]
    min_r2: torch.Tensor


def pick_block(rows: int, preferred: int = 128) -> int:
    """Largest divisor of ``rows`` that is <= ``preferred`` (the JAX
    package's ``parallel/large_n.py:pick_block``)."""
    return next(b for b in range(min(preferred, rows), 0, -1)
                if rows % b == 0)


def _pair_blocks(xi, x, p: FlockingParams, rows):
    """Geometry of a (B, 4) row block against the full (N, 4) state."""
    n = x.shape[0]
    dx = xi[:, None, 0] - x[None, :, 0]
    dy = xi[:, None, 1] - x[None, :, 1]
    r2 = dx * dx + dy * dy
    self_mask = rows[:, None] == torch.arange(n, device=x.device)[None, :]
    r2 = torch.where(self_mask, torch.inf, r2)
    adj = (r2 < p.comm_radius * p.comm_radius).to(x.dtype)
    return dx, dy, r2, adj, self_mask


def _rows(n: int, block: int, row_range: RowRange) -> range:
    """The first row of each block of ``row_range`` (all N rows by
    default)."""
    start, length = (0, n) if row_range is None else row_range
    if length % block:
        raise ValueError(f"row count {length} not divisible by block {block}")
    return range(start, start + length, block)


def blocked_frame(x: torch.Tensor, p: FlockingParams, centralized: bool = True,
                  block: int = 128,
                  row_range: RowRange = None) -> FrameQuantities:
    """Observation features, degrees, expert and min r² of ``x`` (N, 4);
    with ``row_range`` those of its rows only (min r² over them)."""
    values, degree, expert = [], [], []
    min_r2 = torch.full((), torch.inf, dtype=x.dtype, device=x.device)
    for off in _rows(x.shape[0], block, row_range):
        xi = x[off:off + block]
        rows = torch.arange(off, off + block, device=x.device)
        dx, dy, r2, adj, self_mask = _pair_blocks(xi, x, p, rows)
        dvx = xi[:, None, 2] - x[None, :, 2]
        dvy = xi[:, None, 3] - x[None, :, 3]
        r2s = torch.clamp_min(torch.where(torch.isinf(r2), 1.0, r2),
                              COLLISION_R2_EPS)
        inv_r2 = 1.0 / r2s
        inv_r4 = inv_r2 * inv_r2
        values.append(torch.stack([
            (dvx * adj).sum(1),
            (dx * inv_r4 * adj).sum(1),
            (dx * inv_r2 * adj).sum(1),
            (dvy * adj).sum(1),
            (dy * inv_r4 * adj).sum(1),
            (dy * inv_r2 * adj).sum(1),
        ], -1))
        degree.append(adj.sum(1))
        # truncated potential gradient + velocity consensus
        in_range = (r2 <= 1.0).to(x.dtype)
        gx = (-2.0 * dx * inv_r4 + 2.0 * dx * inv_r2) * in_range
        gy = (-2.0 * dy * inv_r4 + 2.0 * dy * inv_r2) * in_range
        if centralized:
            nonself = 1.0 - self_mask.to(x.dtype)
            ux = -((dvx * nonself).sum(1) + gx.sum(1))
            uy = -((dvy * nonself).sum(1) + gy.sum(1))
        else:
            ux = -((dvx * adj).sum(1) + (gx * adj).sum(1))
            uy = -((dvy * adj).sum(1) + (gy * adj).sum(1))
        expert.append(torch.clamp(torch.stack([ux, uy], -1), -10.0, 10.0))
        min_r2 = torch.minimum(min_r2, r2.min())
    return FrameQuantities(values=torch.cat(values), degree=torch.cat(degree),
                           expert=torch.cat(expert), min_r2=min_r2)


def _adj_rows(x: torch.Tensor, p: FlockingParams, off: int, block: int):
    rows = torch.arange(off, off + block, device=x.device)
    return _pair_blocks(x[off:off + block], x, p, rows)[3]


def blocked_apply_adjT(pos: torch.Tensor, cols: torch.Tensor,
                       p: FlockingParams, block: int = 128,
                       deg: Optional[torch.Tensor] = None,
                       row_range: RowRange = None) -> torch.Tensor:
    """``out[j] = sum_i adj[i, j] / deg_i · cols[i]`` without storing adj,
    one block of output rows at a time (``adj`` is symmetric).

    ``deg``: the (N,) radius degrees of ``pos``'s graph, recomputed when
    ``None``. ``row_range``: only those output rows, zeros elsewhere."""
    n = pos.shape[0]
    x = torch.cat([pos, torch.zeros_like(pos)], -1)
    if deg is None:
        deg = torch.cat([_adj_rows(x, p, off, block).sum(1)
                         for off in _rows(n, block, None)])
    inv = 1.0 / torch.clamp_min(deg, 1.0)[None, :]
    out = torch.zeros((n, cols.shape[1]), dtype=cols.dtype, device=cols.device)
    for off in _rows(n, block, row_range):
        out[off:off + block] = (_adj_rows(x, p, off, block) * inv) @ cols
    return out


class DelayCarry(NamedTuple):
    """Rollout carry for the feature-space delayed stack.

    Attributes:
      history: (K, N, F) raw feature history ``[x_t, ..., x_{t-K+1}]``
        (zeros before episode step k).
      pos_hist: (max(K-2, 0), N, 2) positions at ``[t-1, ..., t-K+2]``.
      deg_hist: (max(K-2, 0), N) radius degrees of those graphs.
    """

    history: torch.Tensor
    pos_hist: torch.Tensor
    deg_hist: torch.Tensor


def delay_carry_init(values: torch.Tensor, n: int, k: int) -> DelayCarry:
    """Episode-start carry: history ``[x_0, 0, ..., 0]``; positions zeroed
    and degrees one (never read before they are filled)."""
    f = values.shape[-1]
    kw = dict(dtype=values.dtype, device=values.device)
    history = torch.cat([values[None], torch.zeros((k - 1, n, f), **kw)])
    return DelayCarry(history=history,
                      pos_hist=torch.zeros((max(k - 2, 0), n, 2), **kw),
                      deg_hist=torch.ones((max(k - 2, 0), n), **kw))


def delayed_ystack(carry: DelayCarry, pos_now: torch.Tensor,
                   p: FlockingParams, block: int = 128,
                   deg_now: Optional[torch.Tensor] = None,
                   row_range: RowRange = None, axis=None) -> torch.Tensor:
    """The aggregated delayed stack ``y_k = G_k(t)^T x_{t-k}`` (K, N, F) by
    K-1 blocked transpose-applies over the historical graphs: ``A_t^T`` to
    every delayed slot, then ``A_{t-1}^T`` to slots >= 2, ... (newest
    first). The oracle of the cell path's ``ystack_pre``, never on the main
    path.

    Args:
      carry: the delay carry before this step's history shift
        (``history[0]`` is x_t, ``pos_hist[0]`` the positions at t-1, ...).
      pos_now: (N, 2) current positions (the graph ``A_t``).
      deg_now: (N,) degrees of ``A_t``, recomputed when None.
      row_range / axis: each rank sweeps its output rows and an
        ``all_reduce(SUM)`` over ``axis`` (a ``parallel.distributed.
        AxisGroup``) completes every apply.
    """
    k = carry.history.shape[0]
    n, f = carry.history.shape[1:]
    y = [carry.history[0]]
    if k == 1:
        return torch.stack(y)
    v = carry.history[1:].clone()                       # slots 1..K-1
    for s in range(k - 1):
        pos_s = pos_now if s == 0 else carry.pos_hist[s - 1]
        deg_s = deg_now if s == 0 else carry.deg_hist[s - 1]
        cols = v[s:].transpose(0, 1).reshape(n, (k - 1 - s) * f)
        out = blocked_apply_adjT(pos_s, cols, p, block, deg=deg_s,
                                 row_range=row_range)
        if axis is not None:
            axis.all_reduce(out)
        v[s:] = out.reshape(n, k - 1 - s, f).transpose(0, 1)
        y.append(v[s])
    return torch.stack(y)


def delay_carry_update(carry: DelayCarry, new_values: torch.Tensor,
                       pos_prev: torch.Tensor,
                       deg_prev: Optional[torch.Tensor] = None) -> DelayCarry:
    """Shift and insert after an env step: ``x_{t+1}`` enters the feature
    history; the pre-step positions and degrees enter the graph history."""
    k = carry.history.shape[0]
    history = torch.cat([new_values[None], carry.history[:k - 1]])
    if not carry.pos_hist.shape[0]:
        return DelayCarry(history, carry.pos_hist, carry.deg_hist)
    if deg_prev is None:
        raise ValueError(
            "delay_carry_update needs deg_prev (the pre-step frame's degrees) "
            "when K > 2: ones would silently mis-normalise")
    return DelayCarry(
        history=history,
        pos_hist=torch.cat([pos_prev[None], carry.pos_hist[:-1]]),
        deg_hist=torch.cat([deg_prev[None], carry.deg_hist[:-1]]),
    )
