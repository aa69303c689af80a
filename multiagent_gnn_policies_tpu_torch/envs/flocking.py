"""Flocking environments in PyTorch: parameters, initial swarm, dense step.

The counterpart of the JAX package's ``envs/flocking.py``: the static
parameters, the five env ids, the candidate initial state (a jittered
lattice from ``LATTICE_INIT_N`` agents up, a uniform disc below), and the
dense O(N²) functions of the N = 100 path: the 6-feature observation with
the row-normalised adjacency, the analytic expert, the reward, the reset's
rejection loop and the double-integrator step. The large-N path computes
the same quantities with the cell sweeps (``ops/cells_cuda.py``) and steps
the swarm in ``parallel/large_n.py`` through :func:`dynamics` and
:func:`reward`.

Every dense function takes an optional leading batch of envs: ``x`` is
``(..., N, 4)``. Random draws take an explicit ``torch.Generator``. It does
not give jax.random's numbers, so tests hand both packages the same state
instead, or compare distributions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from multiagent_gnn_policies_tpu_torch.ops.graph import normalized_adjacency


@dataclasses.dataclass(frozen=True)
class FlockingParams:
    """Static environment parameters (the JAX package's, field for field)."""

    n_agents: int = 100
    comm_radius: float = 1.0
    dt: float = 0.01
    v_max: float = 3.0          # initial per-agent velocity spread
    v_bias: Optional[float] = None  # shared velocity bias; default = v_max
    max_accel: float = 1.0      # action clip
    gain: float = 1.0           # action gain applied after the clip
    arena_r2_per_agent: float = 0.15  # squared arena radius per agent
    min_separation: float = 0.1  # no initial pair closer than this
    min_degree: int = 2          # every agent starts with this many neighbours
    max_resets: int = 256        # bound for the rejection-sampling loop
    episode_steps: int = 200     # fixed horizon
    # variant knobs
    n_leaders: int = 0           # FlockingLeader: first n agents ignore control
    two_flocks: bool = False     # FlockingTwoFlocks: two opposing groups
    dynamics_noise: float = 0.0  # FlockingStochastic: velocity noise std
    drag: float = 0.0            # FlockingAirsimAccel: linear velocity drag

    @property
    def bias(self) -> float:
        return self.v_max if self.v_bias is None else self.v_bias

    @classmethod
    def from_cfg(cls, args, **overrides) -> "FlockingParams":
        """From a configparser section, as the reference's
        ``params_from_cfg``: ``n_agents``, ``comm_radius``, ``dt`` and
        ``v_max``, then ``overrides``."""
        kw = dict(
            n_agents=args.getint("n_agents"),
            comm_radius=args.getfloat("comm_radius"),
            dt=args.getfloat("dt"),
            v_max=args.getfloat("v_max"),
        )
        kw.update(overrides)
        return cls(**kw)


# Exact f32 co-location must give a huge but finite repulsion, not inf ->
# NaN: every observation and expert path clamps r^2 from below by this.
COLLISION_R2_EPS = 1e-12

# From this swarm size up the init is the jittered lattice and reset skips
# the rejection loop (whole-swarm acceptance ~ exp(-0.033 N) vanishes).
LATTICE_INIT_N = 512


def strict_fp32() -> None:
    """Keep float32 matrix products and convolutions in full float32.

    TF32 keeps about three decimal digits: coordinates of a 32k swarm
    reach +-70, where that is a resolution near 0.03 and co-locates agents
    (the JAX package met the same trap as bf16 on the TPU's matrix unit,
    its ``envs/flocking.py:220-226``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _lattice_regime(p: FlockingParams) -> bool:
    pitch = math.sqrt(math.pi * p.arena_r2_per_agent)
    return p.n_agents >= LATTICE_INIT_N and pitch > 1.05 * p.min_separation


def _uniform(gen, shape, lo, hi, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


def _lattice_positions(gen: torch.Generator, p: FlockingParams,
                       device) -> torch.Tensor:
    """A randomly rotated and offset square lattice with per-agent jitter:
    the uniform disc's density (pitch² = disc area / N) with
    ``min_separation`` guaranteed by construction (per-axis jitter
    amplitude (pitch - min_separation) / 2)."""
    n = p.n_agents
    pitch = math.sqrt(math.pi * p.arena_r2_per_agent)
    jit_amp = 0.5 * (pitch - p.min_separation)
    r_max = math.sqrt(p.arena_r2_per_agent * n)
    m = int(math.ceil(2.0 * (r_max + pitch) / pitch)) + 1
    ii = (torch.arange(m, device=device, dtype=torch.float32)
          - (m - 1) / 2.0) * pitch
    gx, gy = torch.meshgrid(ii, ii, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    pts = pts + _uniform(gen, (2,), -pitch / 2, pitch / 2, device)
    # the N sites closest to the origin: a disc of the uniform init's radius
    idx = torch.topk(-(pts * pts).sum(-1), n).indices
    pts = pts[idx] + _uniform(gen, (n, 2), -jit_amp, jit_amp, device)
    ang = _uniform(gen, (), 0.0, 2 * math.pi, device)
    c, s = torch.cos(ang), torch.sin(ang)
    # rotate elementwise, never as a matrix product (see strict_fp32)
    x0, y0 = pts[:, 0], pts[:, 1]
    return torch.stack([c * x0 - s * y0, s * x0 + c * y0], -1)


def _sample_positions(gen, p: FlockingParams, device,
                      batch: Tuple[int, ...] = ()) -> torch.Tensor:
    if _lattice_regime(p):
        if not batch:
            return _lattice_positions(gen, p, device)
        pts = [_lattice_positions(gen, p, device)
               for _ in range(math.prod(batch))]
        return torch.stack(pts).reshape(*batch, p.n_agents, 2)
    r2_max = p.arena_r2_per_agent * p.n_agents
    shape = (*batch, p.n_agents)
    length = torch.sqrt(_uniform(gen, shape, 0.0, r2_max, device))
    angle = _uniform(gen, shape, 0.0, 2 * math.pi, device)
    return torch.stack([length * torch.cos(angle),
                        length * torch.sin(angle)], -1)


def _init_candidate(gen: torch.Generator, p: FlockingParams, device,
                    batch: Tuple[int, ...] = ()) -> torch.Tensor:
    """Candidate initial states ``(*batch, N, 4) = [px, py, vx, vy]``."""
    n = p.n_agents
    pos = _sample_positions(gen, p, device, batch)
    bias = _uniform(gen, (*batch, 2), -p.bias, p.bias, device)[..., None, :]
    vel = _uniform(gen, (*batch, n, 2), -p.v_max, p.v_max, device) + bias
    if p.two_flocks:
        # two spatially separated groups with opposing velocity biases
        offset = math.sqrt(p.arena_r2_per_agent * n)
        side = torch.where(torch.arange(n, device=device) < n // 2,
                           -1.0, 1.0)[:, None]
        pos = pos * 0.5 + side * torch.tensor([[offset, 0.0]], device=device)
        vel = vel - bias + (-side) * bias * 0.5
    if p.n_leaders > 0:
        # leaders move with exactly the shared bias velocity
        is_leader = (torch.arange(n, device=device) < p.n_leaders)[:, None]
        vel = torch.where(is_leader, bias, vel)
    return torch.cat([pos, vel], -1)


class EnvState(NamedTuple):
    """Dynamic env state: ``x = [px, py, vx, vy]`` per agent, ``(..., N, 4)``,
    and the step count ``t``, shared by every env of a batch and kept on
    the host (the JAX package's ``EnvState`` also carries a PRNG key; here
    the caller passes the generator)."""

    x: torch.Tensor
    t: int


class Obs(NamedTuple):
    values: torch.Tensor     # (..., N, 6)
    network: torch.Tensor    # (..., N, N) row-normalised adjacency


def _r2_adj(dx: torch.Tensor, dy: torch.Tensor, comm_radius: float):
    """Squared distances ``(..., N, N)`` from pairwise differences, inf on
    the diagonal, and the radius adjacency (zero diagonal)."""
    r2 = dx * dx + dy * dy
    eye = torch.eye(r2.shape[-1], dtype=torch.bool, device=r2.device)
    r2 = r2.masked_fill(eye, float("inf"))
    return r2, (r2 < comm_radius * comm_radius).to(r2.dtype)


def _pairwise(x: torch.Tensor, comm_radius: float):
    """Shared N² geometry: differences ``(..., N, N, 4)``, squared
    distances (inf diagonal) and the adjacency."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    r2, adj = _r2_adj(diff[..., 0], diff[..., 1], comm_radius)
    return diff, r2, adj


def _r2_clamped(r2: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isinf(r2), 1.0, r2).clamp_min(COLLISION_R2_EPS)


def observe(x: torch.Tensor, p: FlockingParams) -> Obs:
    """The 6-feature relative observation (sums over radius neighbours of
    ``[dvx, dx/r⁴, dx/r², dvy, dy/r⁴, dy/r²]``) and the normalised
    adjacency."""
    diff, r2, adj = _pairwise(x, p.comm_radius)
    r2s = _r2_clamped(r2)
    feats = torch.stack([
        diff[..., 2],
        diff[..., 0] / (r2s * r2s),
        diff[..., 0] / r2s,
        diff[..., 3],
        diff[..., 1] / (r2s * r2s),
        diff[..., 1] / r2s,
    ], -1)
    values = (feats * adj[..., None]).sum(-2)
    return Obs(values=values, network=normalized_adjacency(adj))


def expert_action(x: torch.Tensor, p: FlockingParams,
                  centralized: bool = True) -> torch.Tensor:
    """The analytic flocking controller: velocity consensus plus the
    gradient of ``U(r²) = 1/r² + log r²``, truncated beyond unit range;
    decentralized mode sums over radius neighbours only. Clipped to
    ``±10``."""
    diff, r2, adj = _pairwise(x, p.comm_radius)
    r2s = _r2_clamped(r2)
    in_range = (r2 <= 1.0).to(x.dtype)
    grad_x = (-2.0 * diff[..., 0] / (r2s * r2s)
              + 2.0 * diff[..., 0] / r2s) * in_range
    grad_y = (-2.0 * diff[..., 1] / (r2s * r2s)
              + 2.0 * diff[..., 1] / r2s) * in_range
    if centralized:
        n = x.shape[-2]
        vmask = 1.0 - torch.eye(n, dtype=x.dtype, device=x.device)
    else:
        vmask = adj
        grad_x = grad_x * adj
        grad_y = grad_y * adj
    ux = -(diff[..., 2] * vmask + grad_x).sum(-1)
    uy = -(diff[..., 3] * vmask + grad_y).sum(-1)
    return torch.stack([ux, uy], -1).clamp(-10.0, 10.0)


def reward(x: torch.Tensor) -> torch.Tensor:
    """Negative total velocity variance (population variance, ddof 0)."""
    return -torch.var(x[..., 2:4], dim=-2, correction=0).sum(-1)


def _init_ok(x: torch.Tensor, p: FlockingParams) -> torch.Tensor:
    """The reset's acceptance test: no pair closer than ``min_separation``
    and every agent with at least ``min_degree`` neighbours."""
    pos = x[..., :2]
    d = pos[..., :, None, :] - pos[..., None, :, :]
    r2, adj = _r2_adj(d[..., 0], d[..., 1], p.comm_radius)
    min_d2 = r2.amin((-2, -1))
    degree = adj.sum(-1).amin(-1)
    return (min_d2 >= p.min_separation ** 2) & (degree >= p.min_degree)


# Elements of (batch, block, N, N) pairwise arrays one block of reset
# candidates may take; sets how many candidates each env draws per block.
RESET_BLOCK_ELEMS = 1 << 23


def reset_block(p: FlockingParams, n_envs: int) -> int:
    """Candidates drawn per env and block of the reset's rejection loop."""
    per = n_envs * p.n_agents * p.n_agents
    return max(1, min(RESET_BLOCK_ELEMS // per, p.max_resets + 1))


def reset(gen: torch.Generator, p: FlockingParams,
          batch: Tuple[int, ...] = ()) -> Tuple[EnvState, Obs]:
    """Initial states for ``batch`` envs on the generator's device.

    In the lattice regime the candidate is valid by construction. Below it
    each env takes the first of up to ``1 + max_resets`` candidates that
    passes :func:`_init_ok`, and the last one if none does (the JAX
    package's bounded ``while_loop``). Candidates are drawn and tested in
    blocks of :func:`reset_block` per env, so the host waits on the device
    once per block, not once per candidate."""
    device = gen.device
    if _lattice_regime(p):
        x = _init_candidate(gen, p, device, batch)
        return EnvState(x, 0), observe(x, p)
    n_envs = math.prod(batch)
    total, block = p.max_resets + 1, reset_block(p, n_envs)
    rows = torch.arange(n_envs, device=device)
    x = found = None
    drawn = 0
    while drawn < total:
        m = min(block, total - drawn)
        cand = _init_candidate(gen, p, device, (n_envs, m))
        ok = _init_ok(cand, p)
        drawn += m
        if drawn == total:
            ok[:, -1] = True             # accept the last candidate
        pick = cand[rows, ok.float().argmax(1)]    # first accepted, if any
        has = ok.any(1)
        if x is None:
            x, found = pick, has
        else:
            x = torch.where((has & ~found)[:, None, None], pick, x)
            found = found | has
        if bool(found.all()):
            break
    x = x.reshape(*batch, p.n_agents, 4)
    return EnvState(x, 0), observe(x, p)


def dynamics(x: torch.Tensor, action: torch.Tensor, p: FlockingParams,
             gen: Optional[torch.Generator] = None,
             global_start: Optional[int] = None,
             env_range: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Double-integrator step of ``(..., N, 4)`` states: clip, gain,
    leaders, drag, velocity noise (drawn from ``gen``).

    ``global_start``: ``x`` is the slice of the swarm's agents from this
    global index on (an agent-sharded step; None: ``x`` is the whole
    swarm). The leader mask then tests global indices, and the noise is
    drawn for the whole ``(p.n_agents, 2)`` swarm and sliced, so that every
    rank consumes the single-process stream (the JAX package's
    ``parallel/large_n.py:_dynamics``).

    ``env_range`` ``(start, total)``: ``x`` ``(E, N, 4)`` holds envs
    ``[start, start + E)`` of a batch of ``total`` (a data-parallel rank's
    slice). Either way the noise is drawn for the whole batch and swarm and
    this part of it kept."""
    u = torch.clamp(action, -p.max_accel, p.max_accel) * p.gain
    first, local = global_start or 0, x.shape[-2]
    if p.n_leaders > 0:
        is_leader = (torch.arange(first, first + local, device=x.device)
                     < p.n_leaders)[:, None]
        u = torch.where(is_leader, 0.0, u)
    pos = x[..., 0:2] + x[..., 2:4] * p.dt + 0.5 * u * p.dt * p.dt
    vel = x[..., 2:4] + u * p.dt
    if p.drag > 0.0:
        vel = vel * (1.0 - p.drag * p.dt)
    if p.dynamics_noise > 0.0:
        whole, part = list(vel.shape), [slice(None)] * vel.dim()
        if global_start is not None:
            whole[-2], part[-2] = p.n_agents, slice(first, first + local)
        if env_range is not None:
            start = env_range[0]
            whole[0], part[0] = env_range[1], slice(start, start + x.shape[0])
        noise = torch.randn(whole, generator=gen, device=x.device,
                            dtype=vel.dtype)[tuple(part)]
        vel = vel + p.dynamics_noise * noise
    return torch.cat([pos, vel], -1)


def step(state: EnvState, action: torch.Tensor, p: FlockingParams,
         gen: Optional[torch.Generator] = None,
         env_range: Optional[Tuple[int, int]] = None):
    """One env step: ``(state', obs', reward (...,), done)``; ``done`` is a
    Python bool, true once ``episode_steps`` steps are taken.
    ``env_range``: as :func:`dynamics`'s."""
    x = dynamics(state.x, action, p, gen, env_range=env_range)
    t = state.t + 1
    return EnvState(x, t), observe(x, p), reward(x), t >= p.episode_steps


def _relative(params: FlockingParams) -> FlockingParams:
    return params


def _leader(params: FlockingParams) -> FlockingParams:
    return dataclasses.replace(params, n_leaders=max(params.n_leaders, 2))


def _two_flocks(params: FlockingParams) -> FlockingParams:
    return dataclasses.replace(params, two_flocks=True)


def _stochastic(params: FlockingParams) -> FlockingParams:
    return dataclasses.replace(
        params, dynamics_noise=params.dynamics_noise or 0.05)


def _airsim_accel(params: FlockingParams) -> FlockingParams:
    return dataclasses.replace(params, drag=params.drag or 0.1)


ENV_REGISTRY: Dict[str, Callable[[FlockingParams], FlockingParams]] = {
    "FlockingRelative-v0": _relative,
    "FlockingLeader-v0": _leader,
    "FlockingTwoFlocks-v0": _two_flocks,
    "FlockingStochastic-v0": _stochastic,
    "FlockingAirsimAccel-v0": _airsim_accel,
}


@dataclasses.dataclass(frozen=True)
class FlockingEnv:
    """The dense functions bound to their params, gym_flock-style names.
    ``env_range`` ``(start, total)``: the states it steps are envs ``[start,
    start + E)`` of a batch of ``total`` (:func:`dynamics`)."""

    params: FlockingParams
    env_range: Optional[Tuple[int, int]] = None

    def reset(self, gen: torch.Generator, batch: Tuple[int, ...] = ()):
        return reset(gen, self.params, batch)

    def step(self, state: EnvState, action: torch.Tensor,
             gen: Optional[torch.Generator] = None):
        return step(state, action, self.params, gen, self.env_range)

    def controller(self, state: EnvState,
                   centralized: bool = True) -> torch.Tensor:
        return expert_action(state.x, self.params, centralized=centralized)

    def observe(self, state: EnvState) -> Obs:
        return observe(state.x, self.params)

    @property
    def n_agents(self) -> int:
        return self.params.n_agents


def make_env(name: str,
             params: FlockingParams = FlockingParams()) -> FlockingEnv:
    """The ``gym.make`` analogue: env ids are the reference's."""
    if name not in ENV_REGISTRY:
        raise KeyError(f"unknown env '{name}'; known: {sorted(ENV_REGISTRY)}")
    return FlockingEnv(params=ENV_REGISTRY[name](params))
