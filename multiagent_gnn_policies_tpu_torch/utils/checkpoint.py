"""Read the JAX package's ``.npz`` checkpoints with numpy alone.

The JAX package saves a pytree as ``leaf_0 .. leaf_{L-1}`` (the leaves in
``jax.tree_util`` flatten order) plus ``__treedef__``, the JSON-encoded
string of the tree's structure (its ``utils/checkpoint.py:save``). An actor
is a list of ``{'b', 'w'}`` layer dicts, and dict keys flatten sorted, so
layer ``i`` holds ``leaf_{2i}`` (bias) and ``leaf_{2i+1}`` (weight).
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np


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
