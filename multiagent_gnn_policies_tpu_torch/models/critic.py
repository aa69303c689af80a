"""The centralized GNN critic of DDPG as an ``nn.Module``.

The counterpart of the JAX package's ``models/critic.py``. Unlike the
actor, the critic applies the current graph at every layer; per layer
``i`` of input width ``W_i``:

1. every GSO power ``[I, A, ..., A^{K-1}]`` applied to the features,
   ``gso^T x``: (..., N, W_i) -> (..., K, N, W_i) (at layer 0 only when
   ``gso_first``, else one channel);
2. one linear map over the (K, W_i) channels per agent. The JAX weight is
   (W_out, K, W_in) and the flattened input is k-major, so the weight
   reshapes to (W_out, K·W_in) as it is (``models/torch_import.py``);
3. on hidden layers, GroupNorm with one group per channel, a per-feature
   normalisation over the agent axis with the population variance,
   ``(x - mean) · rsqrt(var + 1e-5)``, its per-feature affine when
   ``use_groupnorm``, then ReLU.

``input_transform = "asinh"`` compresses the states (not the actions)
first. The output is the per-agent Q, (..., N). The graph products are
float32 ``torch.matmul`` calls (cuBLAS on the card, TF32 off); the JAX
package computes them with XLA outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

GROUPNORM_EPS = 1e-5            # torch.nn.GroupNorm's default


@dataclasses.dataclass(frozen=True)
class CriticConfig:
    """Static architecture (the JAX package's ``CriticConfig``)."""

    n_s: int
    n_a: int
    hidden: Tuple[int, ...]
    k: int
    gso_first: bool = True
    use_groupnorm: bool = True
    input_transform: str = "identity"     # or "asinh" (states only)

    def __post_init__(self):
        if self.input_transform not in ("identity", "asinh"):
            raise ValueError(
                f"unknown critic input_transform {self.input_transform!r}")

    @property
    def widths(self) -> Tuple[int, ...]:
        return (self.n_s + self.n_a, *self.hidden, 1)

    @property
    def n_layers(self) -> int:
        return len(self.widths) - 1

    def in_channels(self, i: int) -> int:
        return self.k if (i > 0 or self.gso_first) else 1


class Critic(nn.Module):
    """``critic_forward(params, cfg, states, actions, gso)``.

    Parameters: ``layers.{i}`` (``nn.Linear`` over the c-major flattened
    channels) and, with ``use_groupnorm``, ``gn_scale.{i}`` and
    ``gn_bias.{i}`` for each hidden layer."""

    def __init__(self, cfg: CriticConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.widths
        self.layers = nn.ModuleList(
            [nn.Linear(cfg.in_channels(i) * w[i], w[i + 1])
             for i in range(cfg.n_layers)])
        hidden = w[1:-1] if cfg.use_groupnorm else ()
        self.gn_scale = nn.ParameterList(
            [nn.Parameter(torch.ones(c)) for c in hidden])
        self.gn_bias = nn.ParameterList(
            [nn.Parameter(torch.zeros(c)) for c in hidden])

    def forward(self, states: torch.Tensor, actions: torch.Tensor,
                gso: torch.Tensor) -> torch.Tensor:
        """``states`` (..., N, n_s), ``actions`` (..., N, n_a) and the
        current GSO powers ``gso`` (..., K, N, N) -> Q (..., N)."""
        gso_t = gso.transpose(-1, -2)
        return self.run(states, actions, lambda x: gso_t @ x.unsqueeze(-3))

    def run(self, states: torch.Tensor, actions: torch.Tensor,
            shift: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """The layers, with ``shift`` (..., N, W) -> (..., K, N, W) the
        graph application of every layer (of layer 0 only when
        ``gso_first``)."""
        cfg = self.cfg
        if cfg.input_transform == "asinh":
            states = torch.asinh(states)
        x = torch.cat([states, actions], -1)             # (..., N, W0)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = shift(x) if (i > 0 or cfg.gso_first) else x.unsqueeze(-3)
            x = layer(h.movedim(-3, -2).flatten(-2))     # (..., N, W_out)
            if i < last:
                if cfg.use_groupnorm:
                    mean = x.mean(-2, keepdim=True)
                    var = x.var(-2, keepdim=True, correction=0)
                    x = (x - mean) * torch.rsqrt(var + GROUPNORM_EPS)
                    x = x * self.gn_scale[i] + self.gn_bias[i]
                x = torch.relu(x)
        return x[..., 0]


def init_critic_(critic: Critic,
                 gen: Optional[torch.Generator] = None) -> Critic:
    """Draw every weight and bias uniformly in ``±1/sqrt(c_in · w_in)``
    from ``gen`` (the JAX package's ``init_critic``; ``in_features`` is
    ``c_in · w_in``); GroupNorm scales stay one and biases zero."""
    with torch.no_grad():
        for layer in critic.layers:
            bound = 1.0 / math.sqrt(layer.in_features)
            layer.weight.uniform_(-bound, bound, generator=gen)
            layer.bias.uniform_(-bound, bound, generator=gen)
    return critic
