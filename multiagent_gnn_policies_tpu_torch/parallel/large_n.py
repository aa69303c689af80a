"""Large-N rollouts on one device or agent-sharded over a mesh, through the
cell sweeps or one of three other graph backends.

The counterpart of the JAX package's ``parallel/large_n.py``, with its
four paths ("pcells", "blocked", "cells", "binned"): reset, then T env
steps (the JAX package's ``lax.scan`` body, ``_scan_steps``). On every
path, on one device or banded over a mesh, the steps run as an
:class:`EpisodeProgram`, CUDA graphs per static setup, captured at its
first use, cached and replayed per episode (the JAX package's jitted scan,
``lru_cache``'d, under ``shard_map`` on a mesh); a mesh's graphs hold the
step's NCCL collectives. A graph covers the whole episode, or chunks of it
replayed back to back where a whole episode would make too large a graph
(the blocked path's row blocks). The reset stays eager. ``graph=False``
selects the eager loop of steps, the graphs' oracle. On the pcells path
each step of a K >= 2 policy runs

1. ``ystack_pre``: the historical graphs' applies of the delayed stack,
   s = 1 .. K-2, through K3 on (K-1-s)·F columns (the s = 0 apply was done
   the step before);
2. the actor on the stack and the double-integrator step;
3. the new frame: a grid build, K1, and K2 pre-applying the NEXT step's
   s = 0 columns, (K-1)·F of them, over the new graph (``frame_apply``,
   the fused path);
4. the delay-carry update; the grids of the K-2 historical graphs are
   carried, not rebuilt.

A K = 1 policy reads the current features alone: its step is the actor,
the double-integrator step and the new frame (a grid build and K1), as
the JAX package's unfused path runs it (``_use_fused`` is False below
K = 2). An expert-mode step rolls the analytic controller instead of a
policy: the double-integrator step on the frame's expert, then the new
frame alone. Neither runs K2 or K3.

An episode of T steps launches K1 T+1 times (reset + T), K2 T times for
K >= 2 and K3 (K-2)·T times for K >= 3 (one launch per historical graph
and step while its columns fit one kernel width); an expert-mode or
K = 1 episode launches K1 alone, through a graph as eagerly. The launch
counters of ``ops/cells_cuda.py`` count the wrappers' calls: a capture
counts the launches it records, and a replay, which calls no wrapper,
counts nothing (a profiler trace counts the kernels a replay runs). The
per-episode max grid overflow is returned: 0 means every step's sweep
was exact.

The "blocked" path (``path="blocked"``, the JAX package's default below
N = 32,768) computes the same step with the O(N²) row-blocked sweeps of
``ops/blocked.py`` instead: ``blocked_frame`` for every frame and
``delayed_ystack`` for the whole delayed stack, unfused. It launches no
cell kernel and has no grid, so its overflow is always 0. Its peak memory
is O(B·N) for blocks of B rows (:func:`block_rows`).

The "cells" path (``ops/cells.py``, the dense cell grid swept in
(cap, 9·cap) blocks per cell, a batched product for each apply) and the
"binned" path (``ops/binned.py``, the spatial-hash neighbour list, the
exact oracle at any extent; ``sparse=True`` selects it) run the same step
unfused as the blocked path does: their frame (with the expert, always),
then the whole delayed stack (``cells_ystack``, ``binned_ystack``: the
historical graphs rebuilt from the carried positions). Both are plain
PyTorch and launch no cell kernel; their overflow is the grid's or the
neighbour list's.

On a mesh (``rollout_large(mesh=...)``, one process per device, the
``agents`` axis of D ranks) every rank holds the whole O(N) state and
shares the sweeps: on the pcells path rank d builds the grid with a 1/D
share of the sort (``build_pcell_grid_sharded``), sweeps its band of
``cx / D`` grid rows through K1-K3 and completes each (N, C) table with one
``all_reduce(SUM)`` (exact: every agent is written by one band); on the
cells path every rank builds the grid, sweeps its ``cx / D`` grid rows and
completes the frame's (N, 9) and each apply's (N, C) table the same way,
with a MIN for min r², so any N shards; on the blocked and binned paths
it sweeps its N/D agent rows, gathers the frame (min r² by MIN) and, after
each binned apply, its rows (a tiled ``all_gather``). The
actor and the double-integrator step run on the rank's N/D agents and an
``all_gather`` rebuilds the (N, 4) state (:func:`_shard_actor_dynamics`).
So every rank returns the same rewards, and they equal the single-process
rollout's on the same grid (``make_pcell_spec(n_dev=D)``) bit for bit.
Collective bytes per K = 3 pcells step: 4·N·(10 + 12) of the frame_apply
table and 4·N·6 of the historical apply reduced, 16·N of the state and
8·N + 4·D·cx·cy of the grid build gathered.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams,
    _init_candidate,
    _lattice_regime,
    dynamics as _dynamics,
    reward as _reward,
    strict_fp32,
)
from multiagent_gnn_policies_tpu_torch.models.actor import ActorConfig
from multiagent_gnn_policies_tpu_torch.ops.blocked import (
    DelayCarry,
    blocked_frame,
    delay_carry_init,
    delay_carry_update,
    delayed_ystack,
    pick_block,
)
from multiagent_gnn_policies_tpu_torch.ops import binned as bn
from multiagent_gnn_policies_tpu_torch.ops import cells as cl
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as cc
from multiagent_gnn_policies_tpu_torch.parallel.distributed import AxisGroup
from multiagent_gnn_policies_tpu_torch.parallel.mesh import (
    axis_group as mesh_axis_group,
)
from multiagent_gnn_policies_tpu_torch.utils import graphs
from multiagent_gnn_policies_tpu_torch.utils.graphs import (
    PROGRAMS_KEPT,
    WARMUP_STEPS,
)


PATHS = ("pcells", "blocked", "cells", "binned")
# rows per block of the blocked path's O(N²) sweeps: about 2^25 (row,
# agent) pairs per block, so that each of a block's ~25 (B, N) float32
# temporaries stays near 128 MB (~3.4 GB in all at N = 32,768), and
# between 128 rows (the JAX package's block) and 1,024
BLOCK_PAIRS = 1 << 25


class LargeNConfig(NamedTuple):
    """Static setup of a single-device rollout.

    ``centralized`` selects every frame's expert (and K1's gradient mask);
    ``need_expert`` computes it (``fq.expert``), which only expert-mode
    rollouts and the imitation learner's collection read (the JAX
    package's ``LargeNConfig.need_expert``; the blocked frame always
    computes it, and so do the cells and binned frames). ``path`` is
    "pcells" (the cell sweeps over ``cell_spec``, a ``PCellSpec``),
    "blocked" (row blocks of ``block`` rows), "cells" (the dense cell grid
    of ``ops/cells.py`` over ``cell_spec``, a ``CellSpec``) or "binned"
    (the spatial-hash neighbour list of ``ops/binned.py``, ``cap`` agents
    per cell run).

    On a mesh: ``axis`` holds the ``agents`` axis's collectives, ``n_dev``
    its size, ``rows`` the agents per rank (N / n_dev) and ``emulated``
    the force_n_dev timing mode (collectives replaced by local operations
    of the same shapes; results not valid). ``axis`` None: one device."""

    params: FlockingParams
    cell_spec: Optional[Union[cc.PCellSpec, cl.CellSpec]]
    centralized: bool = True
    need_expert: bool = False
    path: str = "pcells"
    block: int = 0
    axis: Optional[AxisGroup] = None
    n_dev: int = 1
    rows: int = 0
    emulated: bool = False
    cap: int = 32


class EpisodeState(NamedTuple):
    """What one step carries to the next (the JAX scan carry). Expert mode
    carries no delayed stack: ``carry`` and ``s0`` are None, ``grid_hist``
    is empty. A K = 1 policy carries its history but no ``s0`` and no
    historical grid."""

    x: torch.Tensor                  # (N, 4) state
    carry: Optional[DelayCarry]
    fq: cc.FrameQuantities           # frame of x
    # the neighbour structure of x: a PCellGrid (pcells), a CellGrid
    # (cells), a NeighborList (binned) or None (blocked)
    grid: Optional[NamedTuple]
    grid_hist: Tuple[cc.PCellGrid, ...]  # pcells: grids of pos_hist, newest
                                         # first
    s0: Optional[torch.Tensor]       # (N, (K-1)·F) pre-applied s=0 columns
    overflow: torch.Tensor           # () max overflow so far


def block_rows(n: int, rows: Optional[int] = None) -> int:
    """Rows per block of the blocked path at ``n`` agents, ``rows`` of them
    swept on this rank (all by default): the largest divisor of ``rows``
    up to ``BLOCK_PAIRS / n`` rows, held in [128, 1024]."""
    return pick_block(n if rows is None else rows,
                      min(max(BLOCK_PAIRS // max(n, 1), 128), 1024))


def _use_sharded_actor(cfg: LargeNConfig) -> bool:
    """The actor and dynamics on this rank's agents (the JAX package's rule
    less its ``n_dev > 1``: a one-rank mesh takes the sharded step too, so
    that it runs the collectives of a real mesh)."""
    return cfg.axis is not None and cfg.params.n_agents % cfg.n_dev == 0


def _row_range(cfg: LargeNConfig):
    """This rank's agent rows ``(start, rows)`` (blocked path), or None."""
    if cfg.axis is None:
        return None
    return cfg.axis.index * cfg.rows, cfg.rows


def _cell_row_range(cfg: LargeNConfig):
    """This rank's band of grid rows (pcells and cells paths), or None: the
    sweep is per grid row, so the mesh partitions grid rows, not agent
    rows."""
    if cfg.axis is None:
        return None
    return cc.row_band(cfg.cell_spec, cfg.n_dev, cfg.axis.index)


def _gather_frame(cfg: LargeNConfig, fq: cc.FrameQuantities):
    """A frame of this rank's agent rows completed over the mesh: one
    ``all_gather`` of the (N/D, 9) table and min r² reduced by MIN."""
    table = cfg.axis.all_gather(torch.cat(
        [fq.values, fq.degree[:, None], fq.expert], 1))
    min_r2 = cfg.axis.all_reduce(fq.min_r2.reshape(1), dist.ReduceOp.MIN)
    return cc.FrameQuantities(values=table[:, :6], degree=table[:, 6],
                              expert=table[:, 7:9], min_r2=min_r2[0])


def _grid(cfg: LargeNConfig, pos: torch.Tensor) -> cc.PCellGrid:
    """The grid of ``pos``: its sort shared over the mesh when N divides
    into the ranks, else replicated."""
    if cfg.axis is not None and pos.shape[0] % cfg.n_dev == 0:
        return cc.build_pcell_grid_sharded(pos, cfg.cell_spec, cfg.axis)
    return cc.build_pcell_grid(pos, cfg.cell_spec)


def _frame(cfg: LargeNConfig, x: torch.Tensor, apply_cols=None):
    """Grid and frame of ``x``; with ``apply_cols`` (pcells only) also the
    fused K2 apply of those columns over the same graph. Returns ``(fq,
    grid[, applied])``. The expert as ``cfg`` says (``centralized``,
    ``need_expert``; the blocked, cells and binned frames always compute
    it). The blocked path returns ``(blocked_frame, None)``, the cells path
    its ``CellGrid``, the binned path its ``NeighborList``. On a mesh every
    sweep is this rank's band (grid rows on the cell paths, agent rows on
    the blocked and binned paths), completed over the mesh."""
    if cfg.path == "blocked":
        fq = blocked_frame(x, cfg.params, cfg.centralized, cfg.block,
                           row_range=_row_range(cfg))
        return (fq if cfg.axis is None else _gather_frame(cfg, fq)), None
    if cfg.path == "binned":
        # the table is built on every rank; each gathers its agent rows
        nl = bn.build_neighbor_list(x[:, :2], cfg.params.comm_radius,
                                    cfg.cap)
        fq = bn.binned_frame(x, nl, cfg.params, cfg.centralized,
                             row_range=_row_range(cfg))
        return (fq if cfg.axis is None else _gather_frame(cfg, fq)), nl
    if cfg.path == "cells":
        grid = cl.build_cell_grid(x[:, :2], cfg.cell_spec)
        return cl.cells_frame(x, grid, cfg.cell_spec, cfg.params,
                              cfg.centralized, row_range=_cell_row_range(cfg),
                              axis=cfg.axis), grid
    grid = _grid(cfg, x[:, :2])
    band = _cell_row_range(cfg)
    if apply_cols is not None:
        fq, applied = cc.frame_apply(x, apply_cols, grid, cfg.cell_spec,
                                     cfg.params, cfg.centralized,
                                     cfg.need_expert, band=band,
                                     axis=cfg.axis)
        return fq, grid, applied
    fq = cc.frame(x, grid, cfg.cell_spec, cfg.params, cfg.centralized,
                  cfg.need_expert, band=band, axis=cfg.axis)
    return fq, grid


def _reset(cfg: LargeNConfig, gen: torch.Generator, device):
    """Initial state with its frame and grid. In the lattice regime the
    candidate is valid by construction; below it, candidates are redrawn
    (at most ``max_resets`` times) until min separation and min degree
    hold. The frame's expert is ``cfg``'s, which step 0 acts on."""
    p = cfg.params
    x = _init_candidate(gen, p, device)
    fq, grid = _frame(cfg, x)
    if _lattice_regime(p):
        return x, fq, grid
    for _ in range(p.max_resets):
        ok = ((fq.min_r2 >= p.min_separation ** 2)
              & (fq.degree.min() >= p.min_degree))
        if bool(ok):
            break
        x = _init_candidate(gen, p, device)
        fq, grid = _frame(cfg, x)
    return x, fq, grid


def _s0_cols(carry: DelayCarry) -> torch.Tensor:
    """The next step's s = 0 apply columns: delayed feature slots
    ``[x_t, ..., x_{t-K+2}]`` flattened per agent, slot-major."""
    k_1 = carry.history.shape[0] - 1
    n, f = carry.history.shape[1:]
    return carry.history[:k_1].transpose(0, 1).reshape(n, k_1 * f)


def _overflow(grid: Optional[NamedTuple], x: torch.Tensor):
    """The grid's (or neighbour list's) dropped-agent count; 0 on the
    blocked path (no grid)."""
    if grid is None:
        return torch.zeros((), dtype=torch.int32, device=x.device)
    return grid.overflow


def _episode_init(cfg: LargeNConfig, acfg: Optional[ActorConfig],
                  gen: Optional[torch.Generator], device,
                  x0: Optional[torch.Tensor] = None) -> EpisodeState:
    """Reset (or the injected ``x0``) and the initial episode state; with
    ``acfg`` None (expert mode) no delayed stack, at K = 1 or off the
    pcells path no pre-applied columns and no historical grids."""
    p = cfg.params
    if x0 is None:
        x, fq, grid = _reset(cfg, gen, device)
    else:
        x = x0.to(device=device, dtype=torch.float32).contiguous()
        fq, grid = _frame(cfg, x)
    if acfg is None:
        return EpisodeState(x, None, fq, grid, (), None, _overflow(grid, x))
    k = acfg.k
    carry = delay_carry_init(fq.values, p.n_agents, k)
    if cfg.path != "pcells":
        return EpisodeState(x, carry, fq, grid, (), None, _overflow(grid, x))
    # the K-2 historical graphs start as the reset frame's grid: their
    # history slots are zero until step >= k, so this is exact
    grid_hist = tuple(grid for _ in range(max(k - 2, 0)))
    s0 = None
    if k >= 2:
        s0 = torch.zeros((p.n_agents, (k - 1) * carry.history.shape[-1]),
                         dtype=x.dtype, device=x.device)
    return EpisodeState(x, carry, fq, grid, grid_hist, s0, grid.overflow)


def _ystack(cfg: LargeNConfig, state: EpisodeState) -> torch.Tensor:
    """The policy's (K, N, F) input: the delayed stack of ``state``."""
    if cfg.path == "blocked":
        return delayed_ystack(state.carry, state.x[:, :2], cfg.params,
                              cfg.block, deg_now=state.fq.degree,
                              row_range=_row_range(cfg), axis=cfg.axis)
    if cfg.path == "cells":
        return cl.cells_ystack(state.carry, state.grid, state.x,
                               state.fq.degree, cfg.cell_spec, cfg.params,
                               row_range=_cell_row_range(cfg), axis=cfg.axis)
    if cfg.path == "binned":
        return bn.binned_ystack(state.carry, state.grid, cfg.params, cfg.cap,
                                row_range=_row_range(cfg), axis=cfg.axis)
    return cc.ystack_pre(state.carry, state.s0, cfg.cell_spec, cfg.params,
                         grid_hist=state.grid_hist,
                         band=_cell_row_range(cfg), axis=cfg.axis)


def _shard_actor_dynamics(cfg: LargeNConfig, actor: torch.nn.Module,
                          y: torch.Tensor, x: torch.Tensor,
                          gen: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """The policy and the double-integrator step on this rank's N/D agents
    (its rows of the (K, N, F) stack ``y`` and of ``x``), and an
    ``all_gather`` that rebuilds the (N, 4) state (16·N bytes). The leader
    mask and the noise are global (``dynamics(global_start=)``), so the
    step equals the single-process step bit for bit. Emulated, the slice
    is written into a copy of ``x`` in place of the gather (the JAX
    package tiles it: D coincident copies of one slice would leave the
    next grids D times as dense as a real rank's)."""
    d, local = cfg.axis.index, cfg.rows
    sl = slice(d * local, (d + 1) * local)
    x2_d = _dynamics(x[sl], actor(y[:, sl]), cfg.params, gen,
                     global_start=d * local)
    if cfg.emulated:
        x2 = x.clone()
        x2[sl] = x2_d
        return x2
    return cfg.axis.all_gather(x2_d)


def _advance(cfg: LargeNConfig, state: EpisodeState,
             act: Optional[torch.Tensor],
             gen: Optional[torch.Generator] = None,
             x2: Optional[torch.Tensor] = None):
    """The env step under ``act`` (N, 2) (or, with ``x2``, its result,
    computed by the sharded step), the new frame and, unless in expert
    mode, the delayed stack's update; returns ``(state', reward)``. The
    new frame pre-applies the next step's s = 0 columns (K2) only when the
    state carries them (K >= 2)."""
    x, carry, fq, grid, grid_hist, s0, ovf = state
    if x2 is None:
        x2 = _dynamics(x, act, cfg.params, gen)
    if carry is None:
        fq2, grid2 = _frame(cfg, x2)
        state2 = state._replace(
            x=x2, fq=fq2, grid=grid2,
            overflow=torch.maximum(ovf, _overflow(grid2, x2)))
        return state2, _reward(x2)
    if s0 is None:
        (fq2, grid2), s02 = _frame(cfg, x2), None
    else:
        fq2, grid2, s02 = _frame(cfg, x2, apply_cols=_s0_cols(carry))
    carry2 = delay_carry_update(
        carry, fq2.values, x[:, :2],
        deg_prev=fq.degree if carry.deg_hist.shape[0] else None)
    grid_hist2 = ((grid,) + grid_hist[:-1]) if grid_hist else grid_hist
    state2 = EpisodeState(x2, carry2, fq2, grid2, grid_hist2, s02,
                          torch.maximum(ovf, _overflow(grid2, x2)))
    return state2, _reward(x2)


def _step(cfg: LargeNConfig, actor: Optional[torch.nn.Module],
          state: EpisodeState, gen: Optional[torch.Generator] = None):
    """One env step of the fused policy path, or of the expert with
    ``actor`` None; returns ``(state', reward)``. On a mesh the policy
    steps this rank's agents (the expert's step is replicated)."""
    if actor is None:
        return _advance(cfg, state, state.fq.expert, gen)
    y = _ystack(cfg, state)
    if _use_sharded_actor(cfg):
        return _advance(cfg, state, None, gen,
                        x2=_shard_actor_dynamics(cfg, actor, y, state.x, gen))
    return _advance(cfg, state, actor(y), gen)


def traj_subset_indices(n_agents: int, traj_agents: int,
                        device=None) -> torch.Tensor:
    """``traj_agents`` evenly spaced agent indices spanning [0, n_agents):
    a rounded linspace (the lattice reset orders agents radially, so the
    subset covers the whole disc), taken in float64."""
    return torch.linspace(0, n_agents - 1, traj_agents, dtype=torch.float64,
                          device=device).round().to(torch.int64)


def _scan_steps(cfg: LargeNConfig, actor: Optional[torch.nn.Module],
                state: EpisodeState, n_steps: int,
                gen: Optional[torch.Generator] = None,
                traj_agents: int = 0):
    """``n_steps`` env steps from ``state`` (of the expert with ``actor``
    None): ``(state', rewards (T,))``, and with ``traj_agents`` = M > 0 the
    states of :func:`traj_subset_indices`' M agents after each step,
    ``(state', rewards, traj (T, M, 4))``."""
    rewards, traj = [], []
    idx = (traj_subset_indices(cfg.params.n_agents, traj_agents,
                               state.x.device) if traj_agents else None)
    for _ in range(n_steps):
        state, r = _step(cfg, actor, state, gen)
        rewards.append(r)
        if traj_agents:
            traj.append(state.x[idx])
    if traj_agents:
        return state, torch.stack(rewards), torch.stack(traj)
    return state, torch.stack(rewards)


# --- the episode program: the JAX package's compiled scan as a CUDA graph --

def _tensors(t) -> list:
    """The tensors of a nested tuple (NamedTuples too), in order; None
    leaves are skipped."""
    if t is None:
        return []
    if isinstance(t, torch.Tensor):
        return [t]
    return [leaf for f in t for leaf in _tensors(f)]


def _clone(t):
    """A nested tuple with a contiguous copy of each tensor."""
    if t is None or isinstance(t, torch.Tensor):
        return None if t is None else t.clone(
            memory_format=torch.contiguous_format)
    fields = [_clone(f) for f in t]
    return type(t)(*fields) if hasattr(t, "_fields") else tuple(fields)


def _copy(dst, src) -> None:
    for d, s in zip(_tensors(dst), _tensors(src), strict=True):
        d.copy_(s)


def copy_state(dst: EpisodeState, src: EpisodeState) -> None:
    """Copy ``src`` into the tensors of ``dst``, in place. The historical
    grids go first, oldest first: a step rotates them by reference
    (``grid_hist' = (grid,) + grid_hist[:-1]``), so each table is read
    before it is overwritten."""
    for d, s in zip(dst.grid_hist[::-1], src.grid_hist[::-1], strict=True):
        _copy(d, s)
    _copy(dst._replace(grid_hist=()), src._replace(grid_hist=()))


class _Buffers(NamedTuple):
    """An episode program's per-step inputs and outputs, indexed by step."""

    rewards: torch.Tensor                # (T,)
    traj: Optional[torch.Tensor]         # (T, M, 4), or None
    records: Tuple[torch.Tensor, ...]    # (T, *shape) per record
    inputs: Tuple[torch.Tensor, ...]     # (T, ...) per input

    def outputs(self) -> list:
        return [self.rewards, *_tensors(self.traj), *self.records]


class EpisodeProgram:
    """``steps`` env steps of one static setup as CUDA graphs: the
    counterpart of the JAX package's jitted ``lax.scan`` of an episode
    (``_jitted_rollout``, ``_jitted_chunked``'s chunk, the chain of
    ``_jitted_chain``, the collection scan of ``algos/imitation_large.py``,
    each under ``shard_map`` on a mesh), on every path (pcells, blocked,
    cells, binned), on one device or over a mesh (``cfg.axis``): there the
    graphs hold the step's collectives (the sharded grid build's gathers,
    the sweeps' ``all_reduce`` completions, the frames' gathers, the
    sharded actor's state gather), captured in CUDA's thread-local mode
    (``utils/graphs.capture``); every rank captures and replays at the same
    calls, and a program whose process group was destroyed raises rather
    than replay. The emulated timing mode (``force_n_dev``) holds no
    collective.

    ``step(cfg, actor, state, gen, *inputs_t)`` returns ``(state', reward,
    *records_t)``: :func:`_step` (a policy, or the expert with ``actor``
    None) by default, with no inputs or records; the large learner's
    collection step takes the step's subsample (and DAGGER's coin) and
    returns its records. ``inputs`` gives each input's (per-step shape,
    dtype), ``records`` each float32 record's per-step shape. The graphs
    read and write static buffers: every tensor of an
    :class:`EpisodeState` (allocated from the first state it is given:
    its grid is a ``PCellGrid``, a ``CellGrid``, a ``NeighborList`` or
    None, as the path's), the per-step inputs and outputs (``rewards``,
    ``traj``, ``records``), and its own copy of the actor's parameters,
    which :meth:`run` refreshes from the caller's actor before each run
    (a graph reads parameters by address: an in-place update of the
    caller's and another actor of the same widths both reach it). The
    state passes from step to step by reference, as the eager loop passes
    it, and is copied into the static buffers at the end of each graph.

    A graph unrolls its steps, where the JAX scan compiles its body once.
    So a graph covers ``steps_per_graph`` steps, replayed back to back
    with no host synchronisation until the episode is done (each replay
    carries the state in the static buffers to the next; a shorter graph
    runs the last steps when the chunks do not divide the episode), each
    chunk's inputs copied in and outputs copied out on the device. By
    default, on the card, a probe graph of one step (captured after the
    warm-up, never replayed, its launches not counted) counts the step's
    nodes, and the episode is split into the fewest even chunks whose
    graphs hold at most ``graphs.GRAPH_NODES`` nodes; on the CPU the
    default is one chunk. ``steps_per_graph`` fixes the chunk (on the CPU
    too: the same chunked loop, each chunk's body run eagerly).

    On the CPU the body runs eagerly over the static buffers: no graph, no
    copy of the actor, the caller's generator. On the card the first run
    warms the body up for ``WARMUP_STEPS`` steps on scratch copies (on the
    capture stream: cuBLAS's workspace, the kernels' first loads, NCCL's
    communicators; a capture without them is invalidated), then captures;
    the warm-up leaves the episode and the caller's generator as they
    were, and its launches count as the launches they are
    (``EpisodeProgram.captures`` counts the programs captured in the
    process). The stochastic variant's noise comes from the program's own
    generator, registered with its graphs: each run sets its state to the
    caller's (the default generator's with ``gen`` None), replays, and
    hands the advanced state back, so an episode draws the eager loop's
    noise and leaves the generator where the loop would. A failure to
    capture or to replay raises; nothing falls back to the eager loop.
    The capture stream, the memory pool every program of a device shares
    and the generator's hand-over are ``utils/graphs.py``'s.
    ``steps_per_graph``, ``nodes`` (those of a graph of
    ``steps_per_graph`` steps), ``capture_s``, ``instantiate_s`` and
    ``pool_mb`` (the reserved memory's growth over the captures; summed
    over the graphs, the probe's capture included) record the capture."""

    captures = 0          # programs captured in this process

    def __init__(self, cfg: LargeNConfig, acfg: Optional[ActorConfig],
                 steps: int, device, traj_agents: int = 0, step=None,
                 inputs: tuple = (), records: tuple = (),
                 steps_per_graph: Optional[int] = None):
        if steps < 1 or (steps_per_graph is not None and steps_per_graph < 1):
            raise ValueError(f"an episode program needs steps >= 1 and "
                             f"steps_per_graph >= 1, got {steps} and "
                             f"{steps_per_graph}")
        self.cfg, self.acfg, self.steps = cfg, acfg, steps
        self.step, self.device = step or _step, graphs.device_of(device)
        self.steps_per_graph = steps_per_graph
        self._shapes = (traj_agents, tuple(inputs), tuple(records))
        self.capture_s = self.instantiate_s = self.pool_mb = None
        self.nodes = None
        self._graphs: dict = {}          # chunk steps -> its graph
        self._static = self._actor = None
        self._buf = self._buffers(steps)
        self._bufs = {steps: self._buf}  # chunk steps -> its buffers
        self._traj_idx = (traj_subset_indices(cfg.params.n_agents,
                                              traj_agents, self.device)
                          if traj_agents else None)
        self._gen = graphs.program_generator(self.device,
                                             cfg.params.dynamics_noise > 0)

    rewards = property(lambda self: self._buf.rewards)
    traj = property(lambda self: self._buf.traj)
    records = property(lambda self: self._buf.records)
    captured = property(lambda self: bool(self._graphs))

    def _buffers(self, n: int) -> _Buffers:
        traj_agents, inputs, records = self._shapes
        dev = self.device
        return _Buffers(
            rewards=torch.zeros(n, device=dev),
            traj=(torch.zeros(n, traj_agents, 4, device=dev)
                  if traj_agents else None),
            records=tuple(torch.zeros((n, *shape), device=dev)
                          for shape in records),
            inputs=tuple(torch.zeros((n, *shape), dtype=dtype, device=dev)
                         for shape, dtype in inputs))

    def _chunks(self, per_graph: Optional[int] = None) -> list:
        """``(first step, steps)`` of each chunk of the episode, of
        ``per_graph`` steps (the program's ``steps_per_graph``)."""
        c = per_graph or self.steps_per_graph or self.steps
        return [(c0, min(c, self.steps - c0))
                for c0 in range(0, self.steps, c)]

    def _steps(self, state: EpisodeState, buf: _Buffers, actor, gen,
               n: int) -> EpisodeState:
        """``n`` steps from ``state``, each one's outputs written into
        ``buf`` at its index; returns the last state."""
        for t in range(n):
            state, r, *rec = self.step(self.cfg, actor, state, gen,
                                       *(x[t] for x in buf.inputs))
            buf.rewards[t] = r
            if buf.traj is not None:
                buf.traj[t] = state.x[self._traj_idx]
            for out, v in zip(buf.records, rec, strict=True):
                out[t] = v
        return state

    def _body(self, state: EpisodeState, dst: EpisodeState, buf: _Buffers,
              actor, gen, n: int) -> None:
        """``n`` steps from ``state``, the final state copied into ``dst``
        (a graph's body)."""
        copy_state(dst, self._steps(state, buf, actor, gen, n))

    def run(self, state: EpisodeState, actor: Optional[torch.nn.Module] = None,
            gen: Optional[torch.Generator] = None,
            inputs: tuple = ()) -> EpisodeState:
        """``steps`` env steps from ``state``, with the step's ``inputs``
        (each (T, ...), row t passed to step t). Returns the final state,
        which is the program's static buffers: valid until its next run,
        as are ``rewards``, ``traj`` and ``records``."""
        if actor is None and self.acfg is not None:
            raise ValueError("a policy's episode needs an actor")
        if not _live(self.cfg):
            raise RuntimeError("the episode program's process group was "
                               "destroyed: its collectives name a "
                               "communicator that no longer exists")
        if self._static is not None and (
                [t.shape for t in _tensors(state)]
                != [t.shape for t in _tensors(self._static)]):
            raise ValueError("the state is not of this program's setup (its "
                             "tensors' shapes differ from the first one's)")
        with torch.no_grad():
            if self._static is None:
                self._static = _clone(state)
            else:
                copy_state(self._static, state)
            _copy(self._buf.inputs, inputs)
            card = self.device.type == "cuda"
            if card:
                actor = self._actor = graphs.actor_copy(self._actor, actor)
                if not self._graphs:
                    self._capture()
            with graphs.generator_handover(self._gen if card else None, gen,
                                           self.device):
                self._run_chunks(actor, self._gen if card else gen)
        return self._static

    def _run_chunks(self, actor, gen) -> None:
        """Each chunk in turn: its inputs' rows copied into its buffers, its
        graph replayed (on the CPU its body run), its outputs copied out."""
        for c0, n in self._chunks():
            if n not in self._bufs:
                self._bufs[n] = self._buffers(n)
            buf = self._bufs[n]
            whole = buf is self._buf
            if not whole:
                for d, s in zip(buf.inputs, self._buf.inputs, strict=True):
                    d.copy_(s[c0:c0 + n])
            if self._graphs:
                self._graphs[n].replay()
            else:
                self._body(self._static, self._static, buf, actor, gen, n)
            if not whole:
                for d, s in zip(self._buf.outputs(), buf.outputs(),
                                strict=True):
                    d[c0:c0 + n].copy_(s)

    def _capture(self) -> None:
        def warmup():
            scratch, sbuf = _clone(self._static), _clone(self._buf)
            self._body(scratch, scratch, sbuf, self._actor, self._gen,
                       min(WARMUP_STEPS, self.steps))

        per_graph = self.steps_per_graph
        totals = [0.0, 0.0, 0.0]         # capture s, instantiate s, MB
        if per_graph is None:
            # the probe: one step's nodes, never instantiated or replayed,
            # the launches it records not counted (the warm-up's are; its
            # capture s and pool are)
            def one_step():
                with cc.uncounted():
                    self._steps(self._static, self._buf, self._actor,
                                self._gen, 1)

            probe = graphs.capture(self.device, warmup, one_step, self._gen,
                                   instantiate=False)
            nodes = probe.nodes
            totals[0], totals[2] = probe.capture_s, probe.pool_mb
            del probe
            if self.cfg.axis is not None:     # every rank splits alike
                nodes = int(self.cfg.axis.all_reduce(torch.tensor(
                    [nodes], device=self.device), dist.ReduceOp.MAX)[0])
            per_graph = graphs.steps_per_graph(nodes, self.steps)
            warmup = lambda: None
        lengths = sorted({n for _, n in self._chunks(per_graph)},
                         reverse=True)
        done, nodes = {}, {}
        for n in lengths:
            if n not in self._bufs:
                self._bufs[n] = self._buffers(n)
            buf = self._bufs[n]
            cap = graphs.capture(self.device, warmup, lambda: self._body(
                self._static, self._static, buf, self._actor, self._gen, n),
                self._gen)
            warmup = lambda: None
            done[n] = cap.graph
            nodes[n] = cap.nodes
            for i, v in enumerate((cap.capture_s, cap.instantiate_s,
                                   cap.pool_mb)):
                totals[i] += v
        self.steps_per_graph, self._graphs = per_graph, done
        self.capture_s, self.instantiate_s, self.pool_mb = totals
        self.nodes = nodes[lengths[0]]
        EpisodeProgram.captures += 1


def _live(cfg: LargeNConfig) -> bool:
    """Whether ``cfg``'s mesh axis (if any) still has its process group."""
    return cfg.axis is None or cfg.axis.live()


# the cached programs, least recently used first (the JAX package's
# lru_cache of jitted episodes); a mesh's key holds its process group, so
# a new group never meets an old group's program
_PROGRAMS: "collections.OrderedDict[tuple, EpisodeProgram]" = (
    collections.OrderedDict())


def episode_program(cfg: LargeNConfig, acfg: Optional[ActorConfig],
                    steps: int, device, traj_agents: int = 0, step=None,
                    inputs: tuple = (), records: tuple = ()
                    ) -> EpisodeProgram:
    """The :class:`EpisodeProgram` of this static setup, made at its first
    use and kept, ``PROGRAMS_KEPT`` of them, least recently used out (the
    JAX package's ``lru_cache`` of jitted episodes). The programs of a
    destroyed process group are dropped first: their graphs' collectives
    name a communicator that no longer exists. Every rank of a mesh makes
    the same calls, so the cache hits and misses alike on every rank."""
    for key in [k for k, prog in _PROGRAMS.items() if not _live(prog.cfg)]:
        del _PROGRAMS[key]
    device = graphs.device_of(device)
    key = (cfg, acfg, steps, device, traj_agents, step or _step,
           tuple(inputs), tuple(records))
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = EpisodeProgram(
            cfg, acfg, steps, device, traj_agents, step, tuple(inputs),
            tuple(records))
        while len(_PROGRAMS) > PROGRAMS_KEPT:
            _PROGRAMS.popitem(last=False)
    _PROGRAMS.move_to_end(key)
    return prog


def clear_programs() -> None:
    """Drop every cached episode program, its graph and the shared pool
    (the next capture starts a new one)."""
    _PROGRAMS.clear()
    graphs.clear_pools()


def use_program(device, graph=None) -> bool:
    """Whether an episode on ``device`` (on any path, on one device or
    banded over a mesh) runs its steps as an :class:`EpisodeProgram` (else
    the eager loop): ``utils/graphs.use_program``'s answer."""
    return graphs.use_program(device, graph, None, "the episode",
                              "on the card")


def make_config(p: FlockingParams, *, path: str = "pcells",
                cap: Optional[int] = None, cell_margin: float = 1.3,
                cell_edge_mult: float = 1.0, centralized: bool = True,
                need_expert: bool = False, mesh=None, axis: str = "agents",
                force_n_dev: Optional[int] = None,
                block: Optional[int] = None) -> LargeNConfig:
    """The :class:`LargeNConfig` of ``p`` on ``path``, on one device or
    banded over ``mesh``'s ``axis`` (``rollout_large``'s arguments of the
    same names; a mesh without that axis runs the single-device program).
    ``cap`` defaults to 16 (pcells), 12 (cells) or 32 (binned); ``block``
    (the blocked path's rows per block) to :func:`block_rows`'.
    Raises ValueError for an unknown path, for ``force_n_dev`` without a
    mesh, on the blocked and binned paths (which split agent rows) for an
    axis that does not divide N, and on the binned path with the
    centralized expert for ``comm_radius < 1`` (its 3x3 cells of edge
    comm_radius would miss part of the expert's unit-range potential)."""
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; known: {PATHS}")
    if path == "binned" and centralized and p.comm_radius < 1.0:
        raise ValueError(
            "binned path needs comm_radius >= 1.0 for the centralized "
            "expert's unit-range potential (use the cells or blocked path)")
    if mesh is not None and axis not in (mesh.mesh_dim_names or ()):
        mesh = None    # no agents axis to band over: one device's program
    if force_n_dev is not None and mesh is None:
        raise ValueError("force_n_dev needs a mesh (a one-rank mesh is "
                         "fine)")
    group = None if mesh is None else mesh_axis_group(mesh, axis,
                                                      force_n_dev)
    n, n_dev = p.n_agents, 1 if group is None else group.n_dev
    if path in ("blocked", "binned") and n % n_dev:
        raise ValueError(f"n_agents={n} not divisible by mesh axis {n_dev} "
                         f"(the {path} path splits agent rows)")
    spec = None
    if path == "pcells":
        spec = cc.make_pcell_spec(p, cap=cap or 16, margin=cell_margin,
                                  edge_mult=cell_edge_mult, n_dev=n_dev)
    elif path == "cells":
        spec = cl.make_cell_spec(p, cap=cap or 12, margin=cell_margin,
                                 n_dev=n_dev)
    return LargeNConfig(
        params=p,
        cell_spec=spec,
        centralized=centralized,
        need_expert=need_expert,
        path=path,
        block=(block or block_rows(n, n // n_dev)) if path == "blocked"
        else 0,
        axis=group, n_dev=n_dev, rows=n // n_dev,
        emulated=group is not None and group.emulated,
        cap=cap or 32,
    )


def rollout_large(actor: Optional[torch.nn.Module],
                  acfg: Optional[ActorConfig],
                  gen: Optional[torch.Generator], p: FlockingParams,
                  centralized_expert: bool = True, cap: Optional[int] = None,
                  cell_margin: float = 1.3, cell_edge_mult: float = 1.0,
                  return_overflow: bool = False,
                  x0: Optional[torch.Tensor] = None, device="cuda",
                  expert_mode: bool = False, traj_agents: int = 0,
                  path: Optional[str] = None, sparse: bool = False,
                  n_episodes: int = 1, mesh=None, axis: str = "agents",
                  force_n_dev: Optional[int] = None, scan_chunks: int = 1,
                  block: Optional[int] = None, graph=None):
    """One episode of ``p.episode_steps`` steps through the cell sweeps (the
    JAX package's "pcells" path), the row-blocked O(N²) sweeps
    (``path="blocked"``), the dense cell grid (``"cells"``) or the
    spatial-hash neighbour list (``"binned"``): greedy, or the analytic
    expert with ``expert_mode``. Returns ``(rewards (T,), final_x)``, plus
    the max per-step grid overflow with ``return_overflow`` (0 means every
    step was exact; always 0 on the blocked path), plus with
    ``traj_agents`` = M > 0 the (T, M, 4) states of
    :func:`traj_subset_indices`' agents after each step: ``(rewards,
    final_x[, overflow][, traj])``.

    Args:
      actor / acfg: the policy (``ind_agg`` must be 0; any K >= 1);
        ignored (may be None) with ``expert_mode``.
      gen: the generator of the reset (and of the stochastic variant's
        noise); may be None when ``x0`` is given and the env is noiseless.
      centralized_expert: the expert's kind (expert mode reads it; K1's
        gradient mask follows it either way).
      cap / cell_margin / cell_edge_mult: the cell grid (``make_pcell_spec``;
        ``make_cell_spec`` on the cells path, which has no edge multiple;
        ``cap`` alone on the binned path: 16, 12 and 32 by default).
      x0: an (N, 4) initial state to use instead of the reset's draw (of
        every episode, with ``n_episodes``).
      device: "cuda" (default) or "cpu"; nothing falls back to the CPU.
      expert_mode: roll the analytic controller instead of the policy (the
        large-N expert baseline): a grid build and K1 per step.
      traj_agents: record this many agents' states per step (0: none).
      path: "pcells" (the default at every N: the port's switch-over point
        is not set), "blocked", "cells" or "binned" (the exact oracle; with
        the centralized expert it needs ``comm_radius >= 1``).
      sparse: with ``path`` None, True selects "binned" (the JAX package's
        alias).
      n_episodes: run this many episodes one after another from ``gen``
        with no host synchronisation between them (the JAX package's
        episode chain): the (E·T,) rewards, the last episode's final state
        and the max overflow over all of them. Not with ``traj_agents``
        or ``scan_chunks``.
      mesh / axis: a ``DeviceMesh`` (``parallel.mesh.make_mesh``) whose
        ``axis`` dimension of D ranks shares the sweeps (module docstring);
        run by every rank of it, each on its own device with a generator
        seeded alike, and each returns the same outputs. The grid is
        ``make_pcell_spec(n_dev=D)``'s (``cx`` a multiple of D; on the cells
        path ``make_cell_spec(n_dev=D)``'s, D bands of whole strips). A
        mesh without an ``axis`` dimension runs the single-device program.
        The blocked and binned paths need D to divide N. The overflow is
        the maximum over the ranks.
      force_n_dev: a timing mode: run this rank's program of a
        ``force_n_dev``-rank axis on the given mesh (one rank is fine),
        every collective replaced by a local operation of the same shape
        (``parallel.distributed.AxisGroup``). Its rewards, states and
        overflow are not valid unless it equals the mesh's size.
      scan_chunks: run the episode as this many chunks of ceil(T / C)
        steps (the last one shorter), the state carried from one to the
        next (the JAX package's chunked scans, which bound a TPU program's
        memory); the result equals one chunk's bit for bit.
      block: the blocked path's rows per block (default
        :func:`block_rows`'; the JAX package's ``block or pick_block``).
      graph: None (default) runs each chunk through its cached
        :class:`EpisodeProgram`, on every path, on one device or a mesh
        (its collectives captured with it; ``force_n_dev`` too): CUDA
        graphs on the card and the same body eagerly on the CPU; False the
        eager loop of steps (``_scan_steps``, the graphs' oracle); True
        the graphs, raising ValueError on the CPU. The overflow's MAX over
        the mesh runs after the episodes, outside the graphs.
    """
    if path is None:
        path = "binned" if sparse else "pcells"
    if n_episodes < 1:
        raise ValueError(f"n_episodes must be >= 1, got {n_episodes}")
    if scan_chunks < 1:
        raise ValueError(f"scan_chunks must be >= 1, got {scan_chunks}")
    if n_episodes > 1 and (traj_agents or scan_chunks > 1):
        raise ValueError("n_episodes > 1 is timing-oriented; trajectory "
                         "dumps and chunked episodes need per-episode calls")
    program = use_program(device, graph)
    if expert_mode:
        actor = acfg = None
    elif acfg is None or acfg.ind_agg != 0:
        raise ValueError("the large-N path requires ind_agg == 0 actors")
    cfg = make_config(p, path=path, cap=cap, cell_margin=cell_margin,
                      cell_edge_mult=cell_edge_mult,
                      centralized=centralized_expert,
                      need_expert=expert_mode, mesh=mesh, axis=axis,
                      force_n_dev=force_n_dev, block=block)
    group = cfg.axis
    strict_fp32()
    device = torch.device(device)
    T = p.episode_steps
    clen = -(-T // scan_chunks)
    rewards, traj, overflow = [], [], None
    with torch.no_grad():
        for _ in range(n_episodes):
            state = _episode_init(cfg, acfg, gen, device, x0)
            for c0 in range(0, T, clen):
                n = min(clen, T - c0)
                if not program:
                    state, r, *tr = _scan_steps(cfg, actor, state, n, gen,
                                                traj_agents)
                else:
                    prog = episode_program(cfg, acfg, n, device, traj_agents)
                    state = prog.run(state, actor, gen)
                    r = prog.rewards.clone()
                    tr = [prog.traj.clone()] if traj_agents else []
                rewards.append(r)
                traj += tr
            overflow = (state.overflow.clone() if overflow is None
                        else torch.maximum(overflow, state.overflow))
        if group is not None:
            overflow = group.all_reduce(overflow.reshape(1),
                                        dist.ReduceOp.MAX)[0]
    cat = lambda ts: ts[0] if len(ts) == 1 else torch.cat(ts)
    out = (cat(rewards), state.x.clone())
    out += (overflow,) if return_overflow else ()
    return out + ((cat(traj),) if traj_agents else ())
