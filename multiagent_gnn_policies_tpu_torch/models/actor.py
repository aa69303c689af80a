"""The delayed-aggregation GNN policy as an ``nn.Module``.

The counterpart of the JAX package's ``models/actor.py``. Layers before
``ind_agg`` are per-tap linear maps of the (..., K, N, F) feature history;
at ``ind_agg`` the history is aggregated, ``delay_gso^T x`` per tap, and
one linear map contracts the K taps and the features per agent; the later
layers are per-agent linear maps, with ``tanh`` between layers and, for
``bound="tanh"``, on the output. The imitation learners and every large-N
rollout use ``ind_agg = 0`` on the pre-aggregated input (``delay_gso``
None); DDPG aggregates halfway (``ind_agg = len(hidden) // 2``) and passes
the delayed GSO. These are plain matrix products (the JAX package leaves
them to XLA, outside any kernel), so they go to ``nn.Linear`` and
``torch.matmul``.

Weights: JAX layer ``i`` holds ``w`` (F_out, F_in, taps) and ``b``
(F_out,); ``models/torch_import.py`` maps them onto this module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from multiagent_gnn_policies_tpu_torch.ops.graph import aggregate


@dataclasses.dataclass(frozen=True)
class ActorConfig:
    """Static architecture (the JAX package's ``ActorConfig``).

    Attributes:
      n_s / n_a: per-agent feature and action widths.
      hidden: hidden layer widths.
      k: number of delay taps.
      ind_agg: layer before which aggregation happens (0 in the imitation
        learners, ``len(hidden) // 2`` in DDPG).
      bound: "none" (raw linear output) or "tanh".
    """

    n_s: int
    n_a: int
    hidden: Tuple[int, ...]
    k: int
    ind_agg: int = 0
    bound: str = "none"

    def __post_init__(self):
        if self.bound not in ("none", "tanh"):
            raise ValueError(f"unknown actor bound {self.bound!r}")

    @property
    def widths(self) -> Tuple[int, ...]:
        return (self.n_s, *self.hidden, self.n_a)

    @property
    def n_layers(self) -> int:
        return len(self.widths) - 1

    def taps(self, i: int) -> int:
        return self.k if i == self.ind_agg else 1


class Actor(nn.Module):
    """``actor_forward(params, cfg, delay_state, delay_gso)``."""

    def __init__(self, cfg: ActorConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.widths
        self.layers = nn.ModuleList(
            [nn.Linear(w[i] * cfg.taps(i), w[i + 1])
             for i in range(cfg.n_layers)])

    def forward(self, x: torch.Tensor,
                delay_gso: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x``: (..., K, N, F) feature history and ``delay_gso`` (..., K,
        N, N), or with ``delay_gso`` None and ``ind_agg = 0`` the
        pre-aggregated history ``delay_gso^T x``. Returns (..., N, n_a)."""
        if delay_gso is None:
            if self.cfg.ind_agg != 0:
                raise ValueError("pre-aggregated input requires ind_agg == 0")
            return self.run(x, None)
        return self.run(x, lambda h: aggregate(delay_gso, h))

    def run(self, x: torch.Tensor,
            agg: Optional[Callable[[torch.Tensor], torch.Tensor]]
            ) -> torch.Tensor:
        """The layers on the (..., K, N, F) history ``x``, with ``agg``
        (..., K, N, F) -> (..., K, N, F) the aggregation at ``ind_agg``
        (None: ``x`` is pre-aggregated)."""
        h = x
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            if i == self.cfg.ind_agg:
                if agg is not None:
                    h = agg(h)
                h = h.movedim(-3, -2).flatten(-2)      # (..., N, K·F), k-major
            h = layer(h)
            if i < last or self.cfg.bound == "tanh":
                h = torch.tanh(h)
        return h


def init_actor_(actor: Actor, gen: Optional[torch.Generator] = None) -> Actor:
    """Draw every weight and bias uniformly in ``±1/sqrt(fan_in · taps)``
    from ``gen``, the JAX package's ``init_actor`` distribution (the
    reference's ``nn.Conv2d`` default): here ``in_features`` is
    ``fan_in · taps``."""
    with torch.no_grad():
        for layer in actor.layers:
            bound = 1.0 / math.sqrt(layer.in_features)
            layer.weight.uniform_(-bound, bound, generator=gen)
            layer.bias.uniform_(-bound, bound, generator=gen)
    return actor


def actor_param_count(layers: List[dict]) -> int:
    """The number of weights and biases in JAX-layout ``layers`` (numpy
    arrays or tensors)."""
    return sum(math.prod(v.shape) for layer in layers for v in layer.values())


def hidden_layers(hidden_size: int, n_layers: int) -> Sequence[int]:
    """The reference's convention: ``n_layers`` copies of ``hidden_size``."""
    return tuple([hidden_size] * n_layers)
