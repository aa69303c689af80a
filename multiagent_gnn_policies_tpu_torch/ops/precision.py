"""The N-amplified global term of the centralized expert, in float64.

The counterpart of the JAX package's ``ops/precision.py``. The centralized
expert's velocity consensus ``sum_{j != i}(v_i - v_j) = N·v_i - Σ_j v_j`` is
O(N) as a closed form, but the closed form multiplies any error in the
global sum by N: a float32 ``v.sum(0)`` of 1e5 velocities is off by ~2e-2
relative after the ×N (the JAX package's measurement of its naive forms).
The TPU has no float64, so the JAX package folds a two-float sum. The H100
has native float64: the sum and the closed form are taken there and the
result is rounded once to float32, which is as close as a float32 result
can be to the exact one (relative 2^-24) for 5 device operations.
"""

from __future__ import annotations

import torch


def centralized_consensus(v: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_{j != i}(v[i] - v[j])`` for all i, in O(N).

    Args:
      v: (N, C) per-agent values (C components handled independently).

    Returns:
      (N, C) consensus sums in ``v``'s dtype.
    """
    v64 = v.double()
    return (v.shape[0] * v64 - v64.sum(0)).to(v.dtype)
