"""Host-side finiteness check for state about to be written to disk.

The counterpart of the JAX package's ``utils/debug.py:check_finite``: a
checkpoint holding NaN or inf would resume into a poisoned run, so the
trainers check params and optimizer state at every state save.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def check_finite(tree: Any, name: str = "value") -> None:
    """Raise ``FloatingPointError`` naming the first leaf of ``tree`` (nested
    dicts of tensors, arrays or scalars) that holds a NaN or an inf."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.inexact) and not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite values in {name}{path} "
                f"(nan={int(np.isnan(arr).sum())}, "
                f"inf={int(np.isinf(arr).sum())})")
