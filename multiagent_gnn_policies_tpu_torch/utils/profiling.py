"""Tracing and measurement: a ``torch.profiler`` trace of a block, a
throughput meter, a finiteness check, and the card's timing helpers.

The counterpart of the JAX package's ``utils/profiling.py``:

* :func:`trace` profiles a block into a Chrome trace (the train CLI's
  ``--profile DIR`` wraps a whole run in it); open ``DIR/trace.json`` in
  Perfetto or ``chrome://tracing``;
* :class:`Throughput` counts env steps (and graph edges) against the host
  clock;
* :func:`assert_finite` raises on a non-finite value in nested dicts,
  lists or tuples of tensors.

And what ``chip_smoke.py`` and the measurement scripts share on the card:

* :func:`device_ms`: a function's device time by CUDA events, the host's
  queueing kept out of the window;
* :func:`bound_ms`: the least time the card could take for given bytes
  and float32 operations (``HBM_BYTES_PER_S``, ``FP32_FLOPS``);
* :func:`summarize_trace`: device busy time, idle share, device operations
  per step, the top device operations and per-layer times of a
  ``torch.profiler`` event list, read by :func:`trace_events`.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import time
from types import SimpleNamespace
from typing import Iterator, List, Optional

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
REPS = 50                      # calls per device_ms window


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[object]]:
    """Profile the enclosed block into ``log_dir/trace.json`` (no-op when
    ``log_dir`` is ``None`` or empty). Yields the ``torch.profiler``
    profile (None when not profiling), whose ``events()`` can be read
    after the block."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """Counts env steps (and optionally edges) against wall-clock time."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self.steps = 0
        self.edges = 0.0

    def add(self, steps: int, edges: float = 0.0) -> None:
        self.steps += steps
        self.edges += edges

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def rates(self) -> dict:
        dt = max(self.elapsed, 1e-9)
        out = {"steps_per_s": self.steps / dt, "elapsed_s": dt}
        if self.edges:
            out["edges_per_s"] = self.edges / dt
        return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree, where: str = "") -> None:
    """Host-side check that every tensor leaf of ``tree`` (nested dicts,
    lists and tuples) is finite; raises ``FloatingPointError`` naming the
    leaf's path. Reading the result waits for the device."""
    for name, leaf in _leaves(tree):
        if not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            raise FloatingPointError(
                f"non-finite values at {name}"
                + (f" ({where})" if where else ""))


def device_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after a warm-up. The card first waits in a sleep kernel while
    the host queues all calls, so host overhead stays out of the window."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops):
    """``(ms, "bytes" or "operations")``: the larger of moving ``n_bytes``
    at the card's memory rate and doing ``n_ops`` float32 operations at its
    peak rate, and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def trace_events(prof) -> List[SimpleNamespace]:
    """The events of a finished ``torch.profiler`` profile that
    :func:`summarize_trace` reads (every device event, and the host
    ranges named ``"layer: <name>"``), straight from its raw kineto
    results: ``prof.events()`` first builds the whole host event tree,
    the larger part of reading a trace with host activity, of which
    this reads nothing but the layer ranges. Each has
    ``name``, ``device_type``, ``is_user_annotation`` and ``time_range``
    (microseconds from the profile's first event), as ``prof.events()``'s
    have."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval

    raw = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in raw), default=0)
    out = []
    for e in raw:
        name, dev = e.name(), e.device_type()
        if dev != DeviceType.CUDA and not name.startswith("layer: "):
            continue
        t0 = (e.start_ns() - base) / 1e3
        out.append(SimpleNamespace(
            name=name, device_type=dev,
            is_user_annotation=bool(e.is_user_annotation()),
            time_range=Interval(t0, t0 + e.duration_ns() / 1e3)))
    return out


def summarize_trace(events, steps, wall_ms, prof_wall_ms, top: int = 10):
    """Prints device busy and idle share per step, device ops per step, the
    top ``top`` device ops and each annotated layer's host and device time,
    from a torch.profiler event list (``prof.events()`` or
    :func:`trace_events`; kernels, memcpys and memsets are its
    device events; the layer ranges, named ``"layer: <name>"``, appear on
    both sides). Returns ``{"busy_ms", "idle", "ops_per_step", "by_name":
    {op name: (device us, count)}}`` per the whole window, or None when the
    profiler recorded no device activity."""
    from torch.autograd import DeviceType

    host = {}                       # layer -> host us (CPU-side ranges)
    spans, kernels = [], []         # device-side layer ranges; device ops
    shadows = 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # a record_function range (a layer's, Optimizer.step's) has a
            # device-side copy, a user annotation: not device work
            if e.is_user_annotation:
                if e.name.startswith("layer: "):
                    spans.append(e)
                else:
                    shadows += 1
            else:
                kernels.append(e)
        elif e.name.startswith("layer: "):
            host[e.name[7:]] = host.get(e.name[7:], 0.0) + (
                e.time_range.elapsed_us())
    print(f"#   trace: {steps} steps, wall {wall_ms:.4f} ms/step "
          f"({prof_wall_ms:.4f} under the profiler); {len(spans)} layer and "
          f"{shadows} other annotation ranges on the device side set aside",
          flush=True)
    if not kernels:
        print("#   trace: device time not measured (the profiler recorded no "
              "device activity)", flush=True)
        return None
    kernels.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in kernels]
    busy_us, end = 0.0, float("-inf")
    for e in kernels:
        s0, s1 = e.time_range.start, e.time_range.end   # union of intervals
        if s1 > end:
            busy_us += s1 - max(s0, end)
            end = s1
    busy_ms = busy_us / 1e3 / steps
    print(f"#   trace: device busy {busy_ms:.4f} ms/step, idle share "
          f"{1 - busy_ms / wall_ms:.4f} of the unprofiled wall "
          f"({1 - busy_ms / prof_wall_ms:.4f} under the profiler), "
          f"{len(kernels) / steps:.2f} device ops per step", flush=True)
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:top]:
        print(f"#   trace top: {tot / 1e3 / steps:.4f} ms/step, "
              f"{cnt / steps:.2f}/step  {name[:100]}", flush=True)
    # a device op belongs to the layer whose device-side range holds it
    layer_dev = {}
    for sp in spans:
        inside = kernels[bisect.bisect_left(starts, sp.time_range.start):
                         bisect.bisect_left(starts, sp.time_range.end)]
        us, n = layer_dev.get(sp.name[7:], (0.0, 0))
        layer_dev[sp.name[7:]] = (
            us + sum(e.time_range.elapsed_us() for e in inside),
            n + len(inside))
    in_layers = sum(n for _, n in layer_dev.values())
    for name in sorted(host, key=lambda k: -layer_dev.get(k, (0, 0))[0]):
        us, n = layer_dev.get(name, (0.0, 0))
        print(f"#   trace layer: {name:<22} host {host[name] / 1e3 / steps:.4f}"
              f" ms/step (profiled), device {us / 1e3 / steps:.4f} ms/step, "
              f"{n / steps:.2f} device ops/step", flush=True)
    if host:
        print(f"#   trace layer: {'(outside the layers)':<22} "
              f"{(len(kernels) - in_layers) / steps:.2f} device ops/step",
              flush=True)
    return {"busy_ms": busy_ms, "idle": 1 - busy_ms / wall_ms,
            "ops_per_step": len(kernels) / steps, "by_name": by_name}
