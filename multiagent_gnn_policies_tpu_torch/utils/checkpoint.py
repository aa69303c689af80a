"""Checkpoints: ``.npz`` archives of leaves plus a structure manifest.

The JAX package saves a pytree as ``leaf_0 .. leaf_{L-1}`` (the leaves in
``jax.tree_util`` flatten order) plus ``__treedef__``, the JSON-encoded
string of the tree's structure (its ``utils/checkpoint.py:save``). An actor
is a list of ``{'b', 'w'}`` layer dicts, and dict keys flatten sorted, so
layer ``i`` holds ``leaf_{2i}`` (bias) and ``leaf_{2i+1}`` (weight). A
critic's hidden layers with GroupNorm flatten ``b, gn_bias, gn_scale, w``.
The port reads and writes actor and critic files in exactly that form, so
either package loads the other's. A training state is a nested dict; the port writes it
with its own structure string (:func:`tree_structure`), which only the port
reads, and checks it at load.

Writes are atomic: a temp file in the same directory, then ``os.replace``,
so a run stopped mid-save leaves the previous checkpoint intact.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from multiagent_gnn_policies_tpu_torch.models.torch_import import (
    actor_state_dict_from_params,
)


def save(path: str, leaves: List[np.ndarray], treedef: str) -> None:
    """Write ``leaves`` and the structure string ``treedef`` to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(json.dumps(treedef).encode(),
                                          dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_leaves(path: str) -> Tuple[List[np.ndarray], str]:
    """All leaves of a checkpoint, in order, and its stored treedef string."""
    with np.load(path) as z:
        treedef = json.loads(bytes(z["__treedef__"]).decode())
        n = sum(1 for name in z.files if name.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    return leaves, treedef


def layers_treedef(layers: List[dict]) -> str:
    """The treedef string the JAX package stores for a list of layer dicts
    (an actor's or a critic's): each dict's keys, sorted."""
    return "PyTreeDef([" + ", ".join(
        "{" + ", ".join(f"'{k}': *" for k in sorted(layer)) + "}"
        for layer in layers) + "])"


def actor_treedef(n_layers: int) -> str:
    """The treedef string the JAX package stores for an ``n_layers`` actor."""
    return layers_treedef([{"b": None, "w": None}] * n_layers)


def save_layers_npz(path: str, layers: List[dict]) -> None:
    """Export JAX-layout layers (an actor's or a critic's,
    ``models.torch_import``) as the JAX package writes them, so its
    ``checkpoint.load`` reads the file."""
    leaves = [layer[k] for layer in layers for k in sorted(layer)]
    save(path, leaves, layers_treedef(layers))


def _load_layers(path: str, want: List[Dict[str, tuple]]) -> List[dict]:
    """Float32 layers of the checkpoint at ``path``, checked against
    ``want`` (per layer, each key's shape): another structure or shape
    raises ``ValueError`` instead of loading mis-shaped weights."""
    leaves, treedef = load_leaves(path)
    if treedef != layers_treedef(want):
        raise ValueError(
            f"{path}: checkpoint structure mismatch:\n saved: {treedef}\n"
            f" want: {layers_treedef(want)}")
    layers, it = [], iter(leaves)
    for i, shapes in enumerate(want):
        layer = {k: next(it).astype(np.float32) for k in sorted(shapes)}
        got = {k: v.shape for k, v in layer.items()}
        if got != shapes:
            raise ValueError(f"{path}: layer {i} has shapes {got}; the config "
                             f"implies {shapes}")
        layers.append(layer)
    return layers


def save_actor_npz(path: str, layers: List[dict]) -> None:
    """Export JAX-layout actor layers; see :func:`save_layers_npz`."""
    save_layers_npz(path, layers)


def load_actor_npz(path: str, acfg) -> List[dict]:
    """Actor layers ``[{'w': (F_out, F_in, taps), 'b': (F_out,)}, ...]`` as
    float32 numpy arrays, checked against the architecture ``acfg``
    (``models.actor.ActorConfig``): a checkpoint of another depth, width or
    K raises ``ValueError`` instead of loading mis-shaped weights."""
    w = acfg.widths
    return _load_layers(path, [
        {"b": (w[i + 1],), "w": (w[i + 1], w[i], acfg.taps(i))}
        for i in range(acfg.n_layers)])


def load_critic_npz(path: str, ccfg) -> List[dict]:
    """Critic layers (``w`` (W_out, C, W_in), ``b``, and ``gn_scale`` and
    ``gn_bias`` on hidden layers with GroupNorm) as float32 numpy arrays,
    checked against the architecture ``ccfg``
    (``models.critic.CriticConfig``)."""
    w, want = ccfg.widths, []
    for i in range(ccfg.n_layers):
        shapes = {"b": (w[i + 1],),
                  "w": (w[i + 1], ccfg.in_channels(i), w[i])}
        if ccfg.use_groupnorm and i < ccfg.n_layers - 1:
            shapes.update(gn_bias=(w[i + 1],), gn_scale=(w[i + 1],))
        want.append(shapes)
    return _load_layers(path, want)


def save_actor_torch_format(path: str, layers: List[dict]) -> None:
    """Export JAX-layout actor layers as a torch state_dict in the
    reference's ``models/actor_{env}_{fname}`` layout."""
    sd = {k: torch.from_numpy(v)
          for k, v in actor_state_dict_from_params(layers).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)


def adam_state_tree(params, opt: torch.optim.Optimizer) -> dict:
    """``opt``'s per-parameter Adam state for the parameters ``params``, in
    their order, zeros before the first step (the state Adam starts from),
    so the tree's structure never changes (the step count is a float32
    scalar on the host, or on the device for a ``capturable`` Adam)."""
    out = {}
    for i, p in enumerate(params):
        st = opt.state.get(p, {})
        out[str(i)] = {
            "step": st.get("step", torch.zeros((), dtype=torch.float32)),
            "exp_avg": st.get("exp_avg", torch.zeros_like(p)),
            "exp_avg_sq": st.get("exp_avg_sq", torch.zeros_like(p)),
        }
    return out


def load_adam_state_tree(opt: torch.optim.Optimizer, tree: dict) -> None:
    """Load a tree of :func:`adam_state_tree` (as numpy arrays) into
    ``opt``, whose one parameter group holds the same parameters. State
    that Adam already holds is written in place (a CUDA graph that steps
    ``opt`` reads it by address); an optimizer that has not stepped yet
    takes it through ``load_state_dict``."""
    params = opt.param_groups[0]["params"]
    if all(opt.state.get(p) for p in params):
        with torch.no_grad():
            for i, p in enumerate(params):
                for k, v in tree[str(i)].items():
                    opt.state[p][k].copy_(torch.as_tensor(v))
        return
    sd = opt.state_dict()
    sd["state"] = {
        int(i): {"step": torch.tensor(float(s["step"])),
                 "exp_avg": torch.from_numpy(s["exp_avg"]),
                 "exp_avg_sq": torch.from_numpy(s["exp_avg_sq"])}
        for i, s in tree.items()}
    opt.load_state_dict(sd)


def _flatten(tree: Any, prefix: str = ""):
    """``(key path, leaf)`` pairs of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.shape(leaf)


def tree_structure(tree: Dict[str, Any]) -> str:
    """The port's structure string of a nested dict of leaves: its sorted
    key paths."""
    return "port-tree:" + json.dumps([p for p, _ in _flatten(tree)])


def save_tree(path: str, tree: Dict[str, Any]) -> None:
    """Write a nested dict of tensors, arrays and scalars."""
    flat = list(_flatten(tree))
    save(path, [_as_numpy(v) for _, v in flat], tree_structure(tree))


def load_tree(path: str, like: Dict[str, Any]) -> Dict[str, Any]:
    """A tree written by :func:`save_tree`, as nested dicts of numpy arrays
    structured like ``like``; raises ``ValueError`` on another structure or
    a leaf of another shape."""
    leaves, stored = load_leaves(path)
    want = tree_structure(like)
    if stored != want:
        raise ValueError(f"{path}: checkpoint structure mismatch:\n saved: "
                         f"{stored}\n want: {want}")
    out: Dict[str, Any] = {}
    for (key, ref), leaf in zip(_flatten(like), leaves):
        if leaf.shape != _shape(ref):
            raise ValueError(f"{path}: {key} has shape {leaf.shape}, want "
                             f"{_shape(ref)}")
        *parents, name = key.strip("/").split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out

