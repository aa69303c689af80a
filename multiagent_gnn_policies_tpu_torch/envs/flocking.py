"""Flocking environment parameters and the initial swarm, in PyTorch.

The counterpart of the JAX package's ``envs/flocking.py`` for the large-N
path: the static parameters, the five env ids and the candidate initial
state (a jittered lattice from ``LATTICE_INIT_N`` agents up, a uniform disc
below). The dense O(N²) observe/step of the N = 100 path are not ported
here; the large-N path computes the same quantities with the cell sweeps
(``ops/cells_cuda.py``) and steps the swarm in ``parallel/large_n.py``.

Random draws take an explicit ``torch.Generator``. It does not give
jax.random's numbers, so tests hand both packages the same state instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch


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


def _sample_positions(gen, p: FlockingParams, device) -> torch.Tensor:
    if _lattice_regime(p):
        return _lattice_positions(gen, p, device)
    r2_max = p.arena_r2_per_agent * p.n_agents
    length = torch.sqrt(_uniform(gen, (p.n_agents,), 0.0, r2_max, device))
    angle = _uniform(gen, (p.n_agents,), 0.0, 2 * math.pi, device)
    return torch.stack([length * torch.cos(angle),
                        length * torch.sin(angle)], -1)


def _init_candidate(gen: torch.Generator, p: FlockingParams,
                    device) -> torch.Tensor:
    """One candidate initial state ``(N, 4) = [px, py, vx, vy]``."""
    n = p.n_agents
    pos = _sample_positions(gen, p, device)
    bias = _uniform(gen, (2,), -p.bias, p.bias, device)
    vel = _uniform(gen, (n, 2), -p.v_max, p.v_max, device) + bias
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
        vel = torch.where(is_leader, bias[None, :], vel)
    return torch.cat([pos, vel], -1)


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
