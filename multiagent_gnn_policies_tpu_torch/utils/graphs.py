"""CUDA graph capture shared by the port's programs.

The port compiles what the JAX package compiles into one program (a
jitted ``lax.scan``, under ``shard_map`` on a mesh) as CUDA graphs: the
large-N episode (``parallel/large_n.py:EpisodeProgram``), the dense
episode and the learners' Adam update (``algos/imitation.py``), each on
one card or as one rank of a mesh with its NCCL collectives captured in
it, and DDPG's training episode and eval (``algos/ddpg.py``,
``algos/ddpg_large.py``). Each
program captures its body once and replays it; this module holds what
they share:

* one capture stream and one memory pool per device. A graph keeps no
  value in the pool from one replay to the next (its outputs are static
  buffers allocated outside it), and replays run one at a time on the
  caller's stream, so every program of a device may share the pool;
* :func:`capture`: a warm-up on the capture stream (cuBLAS's workspace,
  the kernels' first loads, Adam's lazy state, NCCL's communicators; a
  capture without it is invalidated), then the capture in CUDA's
  thread-local mode, timed, the graph's nodes counted
  (:func:`graph_nodes`; :func:`steps_per_graph` splits an episode whose
  graph would be too large);
* :func:`generator_handover`: a program draws from a generator of its
  own, registered with its graph; the caller's state is copied in before
  the replays and the advanced state handed back after, so the draws are
  the eager loop's and the caller's generator ends where the loop leaves
  it;
* :func:`actor_copy`: a program that reads a policy keeps its own copy of
  the parameters (a graph reads them by address), refreshed from the
  caller's actor before each replay;
* :class:`Snapshot`: what a warm-up writes of a learner's state
  (parameters, Adam's state, ...), restored in place after it;
* :class:`Program`: a body over static inputs and outputs, captured at
  its first run on the card and replayed, run eagerly on the CPU.

A failure to capture or to replay raises; nothing falls back to the eager
loop.
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import strict_fp32

PROGRAMS_KEPT = 16    # programs cached per setup kind, least recently used out
WARMUP_STEPS = 2      # steps (updates) of a body run before its capture
# nodes an episode program's graph holds at most: graphs of 18k-31k nodes
# captured in 0.36-1.28 s on the H100 (PERF.md section 5)
GRAPH_NODES = 32_768
_STREAMS: dict = {}   # per device: the stream every program captures on
_POOLS: dict = {}     # per device: the programs' shared memory pool


def device_of(device) -> torch.device:
    """``device`` with its index (the current card's when it has none)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def use_program(device, graph=None, refusal: Optional[str] = None,
                what: str = "a program", where: str = "on one card") -> bool:
    """Whether a loop runs as its program (else the eager loop).
    ``refusal`` says why no program applies here ("on the blocked path",
    ...), or is None. ``graph``: None runs the program where it applies
    (captured on the card, its body eagerly on the CPU) and the eager loop
    elsewhere; False the eager loop; True a CUDA graph, which raises
    ValueError where a program does not apply and on the CPU."""
    if graph is False:
        return False
    if graph is not None and graph is not True:
        raise ValueError(f"graph must be None, False or True, got {graph!r}")
    if graph is None:
        return refusal is None
    refusal = refusal or ("on the CPU" if torch.device(device).type != "cuda"
                          else None)
    if refusal:
        raise ValueError(f"a CUDA graph of {what} was asked for {refusal}: "
                         f"it runs {where} (graph=False runs the eager "
                         f"loop)")
    return True


def program_generator(device, draws: bool) -> Optional[torch.Generator]:
    """A program's own generator, for a program that ``draws`` on the
    card (None otherwise: on the CPU the body draws from the caller's)."""
    device = torch.device(device)
    return (torch.Generator(device=device)
            if draws and device.type == "cuda" else None)


class Captured(NamedTuple):
    """A captured graph, with the capture's and the instantiation's
    seconds, the pool's growth over them (the reserved memory's) and the
    graph's nodes (its kernels, copies and memsets)."""

    graph: torch.cuda.CUDAGraph
    capture_s: float
    instantiate_s: float
    pool_mb: float
    nodes: int


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a graph captured with ``keep_graph=True``, by
    ``libcuda``'s ``cuGraphGetNodes``."""
    import ctypes

    count = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return count.value


def steps_per_graph(nodes_per_step: int, steps: int) -> int:
    """Steps per graph of an episode of ``steps`` steps of
    ``nodes_per_step`` nodes each: the fewest even chunks whose graphs
    hold at most ``GRAPH_NODES`` nodes (at least one step a graph)."""
    most = max(1, GRAPH_NODES // max(nodes_per_step, 1))
    chunks = -(-steps // most)
    return -(-steps // chunks)


def capture(device, warmup: Callable[[], None], body: Callable[[], None],
            gen: Optional[torch.Generator] = None,
            instantiate: bool = True) -> Captured:
    """Run ``warmup()`` on the capture stream, then capture ``body()``
    into a graph on the device's shared pool, ``gen`` registered with it.
    ``warmup`` must leave the program's state as it found it; what it
    allocates is freed when it returns.

    A mesh's body issues NCCL collectives. NCCL builds a communicator at
    its first collective, which a capture may not do, so the warm-up must
    issue every collective the body holds (it runs the same steps). Every
    rank captures at the same call, as the ranks run the same program
    calls in the same order; a capture launches nothing, so no rank waits
    for another here. The capture runs in CUDA's ``thread_local`` mode:
    only this thread's calls can invalidate it, not another thread's
    (ProcessGroupNCCL's watchdog queries the events of earlier
    collectives while a capture may be open). The device is synchronised
    first, so no collective issued before it is still in flight.

    The graph is kept (``keep_graph=True``) so that its nodes can be
    counted, then instantiated (not with ``instantiate`` False: a graph
    captured only to be counted); ``instantiate_s`` times the
    instantiation, ``capture_s`` the capture up to the body's end.

    A failed capture raises, after it has stopped routing allocations to
    the pool and dropped the pool: the process may capture again."""
    strict_fp32()
    device = device_of(device)
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    stream = _STREAMS[device]
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        warmup()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    if gen is not None:
        graph.register_generator_state(gen)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    if device not in _POOLS:
        _POOLS[device] = torch.cuda.graph_pool_handle()
    t0 = time.perf_counter()
    try:
        # the outer context restores the caller's stream should the
        # capture fail (torch.cuda.graph then leaves its stream current)
        with torch.cuda.stream(torch.cuda.current_stream(device)), \
                torch.cuda.graph(graph, pool=_POOLS[device], stream=stream,
                                 capture_error_mode="thread_local"):
            body()
            t1 = time.perf_counter()
    except BaseException:
        _abandon_pool(device)
        raise
    nodes = graph_nodes(graph)
    t2 = time.perf_counter()
    if instantiate:
        graph.instantiate()
    return Captured(graph, t1 - t0, time.perf_counter() - t2,
                    (torch.cuda.memory_reserved(device) - reserved) / 2**20,
                    nodes)


def _abandon_pool(device: torch.device) -> None:
    """After a failed capture: stop routing the device's allocations to the
    shared pool (a failed ``torch.cuda.graph`` leaves its pool recording,
    and the next capture into it would raise) and forget it, so that the
    next capture starts a new one."""
    pool = _POOLS.pop(device, None)
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if pool is not None and end is not None:
        try:
            end(device.index, pool)
        except RuntimeError:      # the capture had stopped recording
            pass


def clear_pools() -> None:
    """Forget the shared pools: the next capture starts a new one (a graph
    keeps its own pool alive)."""
    _POOLS.clear()


@contextlib.contextmanager
def generator_handover(own: Optional[torch.Generator],
                       gen: Optional[torch.Generator], device):
    """Around replays that draw from ``own``: its state set to ``gen``'s
    (the device's default generator's when ``gen`` is None) before, and
    handed back to it after. Nothing when ``own`` is None."""
    if own is None:
        yield
        return
    src = gen or torch.cuda.default_generators[device_of(device).index]
    own.set_state(src.get_state())
    yield
    src.set_state(own.get_state())


def actor_copy(own: Optional[torch.nn.Module],
               actor: Optional[torch.nn.Module]
               ) -> Optional[torch.nn.Module]:
    """``own`` (made from ``actor`` when None) with ``actor``'s parameters
    copied in; raises ValueError for an actor of other widths."""
    if actor is None:
        return own
    if own is None:
        own = copy.deepcopy(actor).requires_grad_(False)
    for d, s in zip(own.parameters(), actor.parameters(), strict=True):
        if d.shape != s.shape:
            raise ValueError(f"the actor's widths differ from the "
                             f"program's: {tuple(s.shape)} against "
                             f"{tuple(d.shape)}")
        d.copy_(s)
    return own


def _opt_params(opt: torch.optim.Optimizer) -> list:
    return [p for g in opt.param_groups for p in g["params"]]


class Snapshot:
    """Copies of what a warm-up writes, restored in place after it: the
    ``tensors`` (parameters, a buffer's device size, ...) and the Adam
    states of ``optimizers``, zeros where Adam had no state yet (the state
    it starts from). The restore also drops every gradient of the
    optimizers' parameters, so that a captured backward allocates its
    own."""

    def __init__(self, tensors: Sequence[torch.Tensor],
                 optimizers: Sequence[torch.optim.Optimizer] = ()):
        # opt.state is a defaultdict: read it with get, which inserts no
        # empty state
        self._tensors = [(t, t.detach().clone()) for t in tensors]
        self._opts = [(opt, {p: {k: v.clone() for k, v in st.items()}
                             for p in _opt_params(opt)
                             if (st := opt.state.get(p))})
                      for opt in optimizers]

    def restore(self) -> None:
        with torch.no_grad():
            for t, v in self._tensors:
                t.copy_(v)
            for opt, saved in self._opts:
                for p in _opt_params(opt):
                    for k, st in opt.state.get(p, {}).items():
                        if p in saved:
                            st.copy_(saved[p][k])
                        else:
                            st.zero_()
        for opt, _ in self._opts:
            opt.zero_grad(set_to_none=True)


class Program:
    """A body that reads the static ``inputs`` and writes the static
    ``outputs``: the inputs are copied in before each run; everything else
    it reads or writes (parameters, Adam's state, a buffer) it reads by
    address, so the caller updates or loads those in place. On the CPU
    :meth:`run` runs the body eagerly with the caller's generator. On the
    card the first run captures it (:func:`capture`, after its warm-up)
    and every run replays it, drawing from the program's own generator
    when it ``draws`` (:func:`generator_handover`). ``Program.captures``
    counts the captures of the process."""

    captures = 0

    def __init__(self, device, draws: bool,
                 outputs: Sequence[torch.Tensor] = ()):
        self.device = device_of(device)
        self.inputs: Optional[list] = None
        self.outputs = list(outputs)
        self._gen = program_generator(self.device, draws)
        self._graph = None
        self.capture_s = self.instantiate_s = self.pool_mb = None
        self.nodes = None

    def run(self, inputs: Sequence[torch.Tensor],
            gen: Optional[torch.Generator],
            body: Callable[[Optional[torch.Generator]], None],
            warmup: Callable[[Optional[torch.Generator]], None]) -> None:
        """``body(gen)`` on ``inputs``; ``warmup(gen)`` runs before the
        capture and must leave the state as it found it."""
        with torch.no_grad():
            if self.inputs is None:
                self.inputs = [t.to(self.device, copy=True) for t in inputs]
            else:
                for d, t in zip(self.inputs, inputs, strict=True):
                    d.copy_(t)
        if self.device.type != "cuda":
            body(gen)
            return
        if self._graph is None:
            (self._graph, self.capture_s, self.instantiate_s,
             self.pool_mb, self.nodes) = capture(
                self.device, lambda: warmup(self._gen),
                lambda: body(self._gen), self._gen)
            Program.captures += 1
        with generator_handover(self._gen, gen, self.device):
            self._graph.replay()
