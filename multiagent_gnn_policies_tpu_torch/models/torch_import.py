"""Convert actor and critic weights between the JAX layout, the port's
``Actor`` and ``Critic`` and the reference's torch ``state_dict``.

JAX layer ``i`` is ``{'w': (F_out, F_in, taps), 'b': (F_out,)}``. The
port's first layer is an ``nn.Linear`` over the flattened (K, F) taps,
k-major, so its weight is ``w`` with the tap axis moved before the feature
axis; later layers take ``w[:, :, 0]``. The reference's state_dict holds
``conv_layers.{i}.weight`` ``(F_out, F_in, taps, 1)`` and
``conv_layers.{i}.bias`` (the layout of the in-repo
``models/actor_FlockingRelative-v0_dagger_k3``).

JAX critic layer ``i`` is ``{'w': (W_out, C, W_in), 'b': (W_out,)}`` plus,
on hidden layers with GroupNorm, ``gn_scale`` and ``gn_bias`` (W_out,).
The port's ``nn.Linear`` reads the (C, W) channels flattened c-major, so
its weight is ``w`` reshaped to (W_out, C·W_in), with no transpose. The
reference critic's state_dict holds ``conv_layers.{i}.weight`` ``(W_out,
C, W_in, 1)``, ``conv_layers.{i}.bias`` and, where it normalises,
``layer_norms.{i}.{weight,bias}``; :func:`critic_params_from_state_dict`
reads it into JAX-layout layers, which :func:`critic_params_from_numpy`
loads into ``Critic``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch


def _to_numpy(v) -> np.ndarray:
    """A float32 copy, never a view of a live parameter."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, dtype=np.float32)


def actor_params_from_numpy(layers: List[dict]) -> Dict[str, torch.Tensor]:
    """JAX actor layers as numpy ``w``/``b`` -> a ``state_dict`` for
    ``models.actor.Actor`` (float32, on the CPU; ``load_state_dict`` copies
    it to the module's device)."""
    sd = {}
    for i, layer in enumerate(layers):
        w = _to_numpy(layer["w"])
        if w.ndim != 3:
            raise ValueError(f"layer {i}: w must be (F_out, F_in, taps), "
                             f"got {w.shape}")
        f_out = w.shape[0]
        sd[f"layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(0, 2, 1).reshape(f_out, -1)))
        sd[f"layers.{i}.bias"] = torch.from_numpy(_to_numpy(layer["b"]))
    return sd


def actor_numpy_from_params(sd: Mapping[str, torch.Tensor],
                            acfg) -> List[dict]:
    """The inverse of :func:`actor_params_from_numpy`: an ``Actor``
    state_dict -> JAX-layout layers of float32 numpy arrays, for the
    architecture ``acfg`` (``models.actor.ActorConfig``)."""
    layers = []
    for i in range(acfg.n_layers):
        w = _to_numpy(sd[f"layers.{i}.weight"])
        f_out, taps = w.shape[0], acfg.taps(i)
        w = w.reshape(f_out, taps, -1).transpose(0, 2, 1)
        layers.append({"w": np.ascontiguousarray(w),
                       "b": _to_numpy(sd[f"layers.{i}.bias"])})
    return layers


def actor_params_from_state_dict(sd: Mapping[str, object]) -> List[dict]:
    """Reference Actor state_dict -> JAX-layout layers (numpy):
    ``conv_layers.{i}.weight (F_out, F_in, taps, 1)`` -> ``w (F_out, F_in,
    taps)``."""
    layers = []
    i = 0
    while f"conv_layers.{i}.weight" in sd:
        w = _to_numpy(sd[f"conv_layers.{i}.weight"])
        if w.ndim != 4 or w.shape[-1] != 1:
            raise ValueError(f"conv_layers.{i}.weight: want (F_out, F_in, "
                             f"taps, 1), got {w.shape}")
        layers.append({"w": np.ascontiguousarray(w[:, :, :, 0]),
                       "b": _to_numpy(sd[f"conv_layers.{i}.bias"])})
        i += 1
    if not layers:
        raise ValueError("no conv_layers.* keys found in state_dict")
    return layers


def actor_state_dict_from_params(layers: List[dict]) -> Dict[str, np.ndarray]:
    """JAX-layout layers -> the reference's state_dict layout (numpy)."""
    sd: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(layers):
        sd[f"conv_layers.{i}.weight"] = _to_numpy(layer["w"])[:, :, :, None]
        sd[f"conv_layers.{i}.bias"] = _to_numpy(layer["b"])
    return sd


def critic_params_from_state_dict(sd: Mapping[str, object]) -> List[dict]:
    """Reference Critic state_dict -> JAX-layout layers (numpy):
    ``conv_layers.{i}.weight (W_out, C, W_in, 1)`` -> ``w (W_out, C,
    W_in)``; ``layer_norms.{i}.{weight,bias}`` -> ``gn_scale``/``gn_bias``."""
    layers = []
    i = 0
    while f"conv_layers.{i}.weight" in sd:
        w = _to_numpy(sd[f"conv_layers.{i}.weight"])
        if w.ndim != 4 or w.shape[-1] != 1:
            raise ValueError(f"conv_layers.{i}.weight: want (W_out, C, "
                             f"W_in, 1), got {w.shape}")
        layer = {"w": np.ascontiguousarray(w[:, :, :, 0]),
                 "b": _to_numpy(sd[f"conv_layers.{i}.bias"])}
        if f"layer_norms.{i}.weight" in sd:
            layer["gn_scale"] = _to_numpy(sd[f"layer_norms.{i}.weight"])
            layer["gn_bias"] = _to_numpy(sd[f"layer_norms.{i}.bias"])
        layers.append(layer)
        i += 1
    if not layers:
        raise ValueError("no conv_layers.* keys found in state_dict")
    return layers


def critic_params_from_numpy(layers: List[dict]) -> Dict[str, torch.Tensor]:
    """JAX critic layers as numpy arrays -> a ``state_dict`` for
    ``models.critic.Critic`` (float32, on the CPU)."""
    sd = {}
    for i, layer in enumerate(layers):
        w = _to_numpy(layer["w"])
        if w.ndim != 3:
            raise ValueError(f"layer {i}: w must be (W_out, C, W_in), "
                             f"got {w.shape}")
        sd[f"layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.reshape(w.shape[0], -1)))
        sd[f"layers.{i}.bias"] = torch.from_numpy(_to_numpy(layer["b"]))
        if "gn_scale" in layer:
            sd[f"gn_scale.{i}"] = torch.from_numpy(_to_numpy(layer["gn_scale"]))
            sd[f"gn_bias.{i}"] = torch.from_numpy(_to_numpy(layer["gn_bias"]))
    return sd


def critic_numpy_from_params(sd: Mapping[str, torch.Tensor],
                             ccfg) -> List[dict]:
    """The inverse of :func:`critic_params_from_numpy` for the architecture
    ``ccfg`` (``models.critic.CriticConfig``)."""
    layers = []
    for i in range(ccfg.n_layers):
        w = _to_numpy(sd[f"layers.{i}.weight"])
        layer = {"w": w.reshape(w.shape[0], ccfg.in_channels(i), -1),
                 "b": _to_numpy(sd[f"layers.{i}.bias"])}
        if f"gn_scale.{i}" in sd:
            layer["gn_scale"] = _to_numpy(sd[f"gn_scale.{i}"])
            layer["gn_bias"] = _to_numpy(sd[f"gn_bias.{i}"])
        layers.append(layer)
    return layers
