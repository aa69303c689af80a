"""The delayed K-hop graph state of the dense N = 100 path.

The counterpart of the JAX package's ``ops/graph.py``. Every function takes
optional leading batch dims: features are ``(..., N, F)``, graph shift
operators ``(..., N, N)`` and their stacks ``(..., K, N, N)``. ``S[i, j]``
is the weight with which agent ``j`` receives from agent ``i``, so
aggregation is ``y[j] = sum_i S[i, j] x[i]`` (:func:`aggregate`).

  * ``delay_gso[k] = A_t · A_{t-1} · … · A_{t-k+1}``  (delayed operator)
  * ``delay_state[k] = x_{t-k}``                      (feature history)

At an episode start the delayed slots ``k >= 1`` are zero and
``delay_gso[0] = I`` (:func:`initial_graph_state`).

The products are dense float32 ``torch.matmul`` calls (cuBLAS on the card,
with TF32 off: ``envs/flocking.py:strict_fp32``); the JAX package computes
them outside any Pallas kernel too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GraphState(NamedTuple):
    """Delayed graph state of one env or a batch of envs.

    Attributes:
      values:      ``(..., N, F)``    current features ``x_t``.
      network:     ``(..., N, N)``    current graph shift operator ``A_t``.
      delay_gso:   ``(..., K, N, N)`` delayed GSO stack.
      delay_state: ``(..., K, N, F)`` feature history.
    """

    values: torch.Tensor
    network: torch.Tensor
    delay_gso: torch.Tensor
    delay_state: torch.Tensor


def _eye_like(network: torch.Tensor) -> torch.Tensor:
    n = network.shape[-1]
    eye = torch.eye(n, dtype=network.dtype, device=network.device)
    return eye.expand(network.shape)


def gso_powers(network: torch.Tensor, k: int) -> torch.Tensor:
    """``[I, A, A², …, A^{k-1}]`` stacked on axis -3: the powers of the
    current graph, for a caller that needs them (the graph state does not
    hold them)."""
    out = [_eye_like(network)]
    for _ in range(k - 1):
        out.append(network @ out[-1])
    return torch.stack(out, -3)


def delayed_gso_update(network: torch.Tensor,
                       prev_delay_gso: torch.Tensor) -> torch.Tensor:
    """One step of the delayed-GSO recursion: ``new[0] = I``,
    ``new[k] = A_t @ prev[k-1]`` for ``k >= 1``."""
    k = prev_delay_gso.shape[-3]
    eye = _eye_like(network).unsqueeze(-3)
    if k == 1:
        return eye.contiguous()
    shifted = network.unsqueeze(-3) @ prev_delay_gso[..., :k - 1, :, :]
    return torch.cat([eye, shifted], -3)


def history_shift(prev_history: torch.Tensor,
                  new_slot: torch.Tensor) -> torch.Tensor:
    """Shift-and-insert on the tap axis: ``new[0] = new_slot``,
    ``new[k] = prev[k-1]``."""
    k = prev_history.shape[-3]
    new = new_slot.unsqueeze(-3)
    if k == 1:
        return new.contiguous()
    return torch.cat([new, prev_history[..., :k - 1, :, :]], -3)


def initial_graph_state(values: torch.Tensor, network: torch.Tensor,
                        k: int) -> GraphState:
    """Episode-start state: ``delay_gso = [I, 0, …]``,
    ``delay_state = [x_t, 0, …]``."""
    gso0 = _eye_like(network).unsqueeze(-3)
    x0 = values.unsqueeze(-3)
    delay_gso = torch.cat(
        [gso0, gso0.new_zeros((*network.shape[:-2], k - 1,
                               *network.shape[-2:]))], -3)
    delay_state = torch.cat(
        [x0, x0.new_zeros((*values.shape[:-2], k - 1, *values.shape[-2:]))],
        -3)
    return GraphState(values, network, delay_gso, delay_state)


def update_graph_state(prev: GraphState, values: torch.Tensor,
                       network: torch.Tensor) -> GraphState:
    """Advance the delayed graph state by one env step."""
    return GraphState(values, network,
                      delayed_gso_update(network, prev.delay_gso),
                      history_shift(prev.delay_state, values))


def aggregate(gso: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y[..., k, j, f] = sum_i gso[..., k, i, j] x[..., k, i, f]``:
    ``(..., K, N, N)`` and ``(..., K, N, F)`` -> ``(..., K, N, F)``."""
    return gso.transpose(-1, -2) @ x


def normalized_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """Row-normalise a zero-diagonal adjacency by out-degree, the degree
    clamped to at least 1 (mean pooling)."""
    return adj / adj.sum(-1, keepdim=True).clamp_min(1.0)
