"""Large-N rollouts on one device, through the cell sweeps.

The counterpart of the JAX package's ``parallel/large_n.py`` for the
"pcells" path on one device: reset, then a Python loop of env steps
(the JAX package's ``lax.scan`` body, ``_scan_steps``). Each step of a K >= 2
policy runs

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
K = 1 episode launches K1 alone. The per-episode max grid overflow is
returned: 0 means every step's sweep was exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

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
    delay_carry_init,
    delay_carry_update,
)
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as cc


class LargeNConfig(NamedTuple):
    """Static setup of a single-device pcells rollout.

    ``centralized`` selects every frame's expert (and K1's gradient mask);
    ``need_expert`` computes it (``fq.expert``), which only expert-mode
    rollouts and the imitation learner's collection read (the JAX
    package's ``LargeNConfig.need_expert``)."""

    params: FlockingParams
    cell_spec: cc.PCellSpec
    centralized: bool = True
    need_expert: bool = False


class EpisodeState(NamedTuple):
    """What one step carries to the next (the JAX scan carry). Expert mode
    carries no delayed stack: ``carry`` and ``s0`` are None, ``grid_hist``
    is empty. A K = 1 policy carries its history but no ``s0`` and no
    historical grid."""

    x: torch.Tensor                  # (N, 4) state
    carry: Optional[DelayCarry]
    fq: cc.FrameQuantities           # frame of x
    grid: cc.PCellGrid               # grid of x
    grid_hist: Tuple[cc.PCellGrid, ...]  # grids of pos_hist, newest first
    s0: Optional[torch.Tensor]       # (N, (K-1)·F) pre-applied s=0 columns
    overflow: torch.Tensor           # () max overflow so far


def _frame(cfg: LargeNConfig, x: torch.Tensor, apply_cols=None):
    """Grid and frame of ``x``; with ``apply_cols`` also the fused K2 apply
    of those columns over the same graph. Returns ``(fq, grid[, applied])``.
    The expert as ``cfg`` says (``centralized``, ``need_expert``)."""
    grid = cc.build_pcell_grid(x[:, :2], cfg.cell_spec)
    if apply_cols is not None:
        fq, applied = cc.frame_apply(x, apply_cols, grid, cfg.cell_spec,
                                     cfg.params, cfg.centralized,
                                     cfg.need_expert)
        return fq, grid, applied
    fq = cc.frame(x, grid, cfg.cell_spec, cfg.params, cfg.centralized,
                  cfg.need_expert)
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


def _episode_init(cfg: LargeNConfig, acfg: Optional[ActorConfig],
                  gen: Optional[torch.Generator], device,
                  x0: Optional[torch.Tensor] = None) -> EpisodeState:
    """Reset (or the injected ``x0``) and the initial episode state; with
    ``acfg`` None (expert mode) no delayed stack, at K = 1 no pre-applied
    columns."""
    p = cfg.params
    if x0 is None:
        x, fq, grid = _reset(cfg, gen, device)
    else:
        x = x0.to(device=device, dtype=torch.float32).contiguous()
        fq, grid = _frame(cfg, x)
    if acfg is None:
        return EpisodeState(x, None, fq, grid, (), None, grid.overflow)
    k = acfg.k
    carry = delay_carry_init(fq.values, p.n_agents, k)
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
    return cc.ystack_pre(state.carry, state.s0, cfg.cell_spec, cfg.params,
                         grid_hist=state.grid_hist)


def _advance(cfg: LargeNConfig, state: EpisodeState, act: torch.Tensor,
             gen: Optional[torch.Generator] = None):
    """The env step under ``act`` (N, 2), the new frame and, unless in
    expert mode, the delayed stack's update; returns ``(state', reward)``.
    The new frame pre-applies the next step's s = 0 columns (K2) only
    when the state carries them (K >= 2)."""
    x, carry, fq, grid, grid_hist, s0, ovf = state
    x2 = _dynamics(x, act, cfg.params, gen)
    if carry is None:
        fq2, grid2 = _frame(cfg, x2)
        state2 = state._replace(x=x2, fq=fq2, grid=grid2,
                                overflow=torch.maximum(ovf, grid2.overflow))
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
                          torch.maximum(ovf, grid2.overflow))
    return state2, _reward(x2)


def _step(cfg: LargeNConfig, actor: Optional[torch.nn.Module],
          state: EpisodeState, gen: Optional[torch.Generator] = None):
    """One env step of the fused policy path, or of the expert with
    ``actor`` None; returns ``(state', reward)``."""
    act = state.fq.expert if actor is None else actor(_ystack(cfg, state))
    return _advance(cfg, state, act, gen)


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


def rollout_large(actor: Optional[torch.nn.Module],
                  acfg: Optional[ActorConfig],
                  gen: Optional[torch.Generator], p: FlockingParams,
                  centralized_expert: bool = True, cap: Optional[int] = None,
                  cell_margin: float = 1.3, cell_edge_mult: float = 1.0,
                  return_overflow: bool = False,
                  x0: Optional[torch.Tensor] = None, device="cuda",
                  expert_mode: bool = False, traj_agents: int = 0):
    """One episode of ``p.episode_steps`` steps through the cell sweeps (the
    JAX package's "pcells" path): greedy, or the analytic expert with
    ``expert_mode``. Returns ``(rewards (T,), final_x)``, plus the max
    per-step grid overflow with ``return_overflow`` (0 means every step was
    exact), plus with ``traj_agents`` = M > 0 the (T, M, 4) states of
    :func:`traj_subset_indices`' agents after each step:
    ``(rewards, final_x[, overflow][, traj])``.

    Args:
      actor / acfg: the policy (``ind_agg`` must be 0; any K >= 1);
        ignored (may be None) with ``expert_mode``.
      gen: the generator of the reset (and of the stochastic variant's
        noise); may be None when ``x0`` is given and the env is noiseless.
      centralized_expert: the expert's kind (expert mode reads it; K1's
        gradient mask follows it either way).
      cap / cell_margin / cell_edge_mult: the cell grid (``make_pcell_spec``).
      x0: an (N, 4) initial state to use instead of the reset's draw.
      device: "cuda" (default) or "cpu"; nothing falls back to the CPU.
      expert_mode: roll the analytic controller instead of the policy (the
        large-N expert baseline): a grid build and K1 per step.
      traj_agents: record this many agents' states per step (0: none).
    """
    if expert_mode:
        actor = acfg = None
    elif acfg is None or acfg.ind_agg != 0:
        raise ValueError("the large-N path requires ind_agg == 0 actors")
    strict_fp32()
    device = torch.device(device)
    cfg = LargeNConfig(
        params=p,
        cell_spec=cc.make_pcell_spec(p, cap=cap or 16, margin=cell_margin,
                                     edge_mult=cell_edge_mult),
        centralized=centralized_expert,
        need_expert=expert_mode,
    )
    with torch.no_grad():
        state = _episode_init(cfg, acfg, gen, device, x0)
        state, rewards, *traj = _scan_steps(cfg, actor, state,
                                            p.episode_steps, gen, traj_agents)
    out = (rewards, state.x) + ((state.overflow,) if return_overflow else ())
    return out + tuple(traj)
