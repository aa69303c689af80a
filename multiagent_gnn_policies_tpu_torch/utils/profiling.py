"""Tracing: a ``torch.profiler`` trace of a block, as a Chrome trace.

The counterpart of the JAX package's ``utils/profiling.py:trace``, which
the train CLI's ``--profile DIR`` wraps around a whole run. The trace
records host operations, and device kernels when a card is present; open
``DIR/trace.json`` in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed block into ``log_dir/trace.json`` (no-op when
    ``log_dir`` is ``None`` or empty)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
