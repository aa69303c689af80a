"""Checkpoints: ``.npz`` archives of leaves plus a structure manifest.

The JAX package saves a pytree as ``leaf_0 .. leaf_{L-1}`` (the leaves in
``jax.tree_util`` flatten order) plus ``__treedef__``, the JSON-encoded
string of the tree's structure (its ``utils/checkpoint.py:save``). An actor
is a list of ``{'b', 'w'}`` layer dicts, and dict keys flatten sorted, so
layer ``i`` holds ``leaf_{2i}`` (bias) and ``leaf_{2i+1}`` (weight). The
port reads and writes actor files in exactly that form, so either package
loads the other's. A training state is a nested dict; the port writes it
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


def actor_treedef(n_layers: int) -> str:
    """The treedef string the JAX package stores for an ``n_layers`` actor."""
    return "PyTreeDef([" + ", ".join(["{'b': *, 'w': *}"] * n_layers) + "])"


def save_actor_npz(path: str, layers: List[dict]) -> None:
    """Export JAX-layout actor layers (``models.torch_import``) as the JAX
    package writes them, so its ``checkpoint.load`` reads the file."""
    leaves = [a for layer in layers for a in (layer["b"], layer["w"])]
    save(path, leaves, actor_treedef(len(layers)))


def load_actor_npz(path: str, acfg) -> List[dict]:
    """Actor layers ``[{'w': (F_out, F_in, taps), 'b': (F_out,)}, ...]`` as
    float32 numpy arrays, checked against the architecture ``acfg``
    (``models.actor.ActorConfig``): a checkpoint of another depth, width or
    K raises ``ValueError`` instead of loading mis-shaped weights."""
    leaves, treedef = load_leaves(path)
    want = actor_treedef(acfg.n_layers)
    if treedef != want:
        raise ValueError(
            f"{path}: checkpoint structure mismatch:\n saved: {treedef}\n"
            f" want: {want}")
    widths = acfg.widths
    layers = []
    for i in range(acfg.n_layers):
        b, w = leaves[2 * i], leaves[2 * i + 1]
        w_shape = (widths[i + 1], widths[i], acfg.taps(i))
        if w.shape != w_shape or b.shape != (widths[i + 1],):
            raise ValueError(
                f"{path}: layer {i} has w {w.shape}, b {b.shape}; the config "
                f"implies w {w_shape}, b {(widths[i + 1],)}")
        layers.append({"w": w.astype(np.float32), "b": b.astype(np.float32)})
    return layers


def save_actor_torch_format(path: str, layers: List[dict]) -> None:
    """Export JAX-layout actor layers as a torch state_dict in the
    reference's ``models/actor_{env}_{fname}`` layout."""
    sd = {k: torch.from_numpy(v)
          for k, v in actor_state_dict_from_params(layers).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)


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

