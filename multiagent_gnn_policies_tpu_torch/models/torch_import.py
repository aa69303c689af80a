"""Carry the JAX package's actor weights onto the port's ``Actor``.

JAX layer ``i`` is ``{'w': (F_out, F_in, taps), 'b': (F_out,)}``. The
port's first layer is an ``nn.Linear`` over the flattened (K, F) taps,
k-major, so its weight is ``w`` with the tap axis moved before the feature
axis; later layers take ``w[:, :, 0]``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def actor_params_from_numpy(layers: List[dict]) -> Dict[str, torch.Tensor]:
    """JAX actor layers as numpy ``w``/``b`` -> a ``state_dict`` for
    ``models.actor.Actor`` (float32, on the CPU; ``load_state_dict`` copies
    it to the module's device)."""
    sd = {}
    for i, layer in enumerate(layers):
        w = np.asarray(layer["w"], dtype=np.float32)
        if w.ndim != 3:
            raise ValueError(f"layer {i}: w must be (F_out, F_in, taps), "
                             f"got {w.shape}")
        f_out = w.shape[0]
        sd[f"layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(0, 2, 1).reshape(f_out, -1)))
        sd[f"layers.{i}.bias"] = torch.from_numpy(
            np.asarray(layer["b"], dtype=np.float32).copy())
    return sd
