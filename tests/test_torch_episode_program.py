"""The port's episode program (``parallel/large_n.py``: ``EpisodeProgram``,
``rollout_large(scan_chunks=, block=, graph=)``) on the CPU, where the
program runs the body it captures on the card eagerly over its static
buffers:

* ``scan_chunks = C`` equals one chunk bit for bit, and the JAX package's
  ``rollout_large(..., scan_chunks=C)`` (Pallas kernels in interpret mode)
  within 1e-4 on the same reset, with and without a trajectory;
* the program's body equals the eager loop of ``_step`` bit for bit
  over 20 steps, in one chunk and in three, for K = 1-4, the expert and
  the collection episode;
* ``block=`` sets the blocked path's rows per block as the JAX package's
  argument does;
* the refusals: ``n_episodes > 1`` with ``scan_chunks > 1``, a graph asked
  for on the CPU, on every path (with a mesh too: a mesh's episode runs
  its program), a program run on a state of another setup;
* the kernels' launches read from a profiler trace's kernel names.

jax.random and torch generators give different numbers, so the port is
handed the JAX reset's initial state (``x0``). Tolerance against JAX: 1e-4
of the largest magnitude (the episode tolerance of
``tests/test_torch_rollout.py``); within the port, exact.
"""

import jax
import pytest
import torch

from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc
from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln

from test_torch_rollout import ACFG, _close, _jax_reset, _port_actor

N_BODY, T_BODY = 600, 20


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the suite runs several test
    processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _actor(k, seed=0):
    tcfg = tac.ActorConfig(**dict(ACFG, k=k))
    return tcfg, tac.init_actor_(tac.Actor(tcfg),
                                 torch.Generator().manual_seed(seed)).eval()


@pytest.mark.parametrize("chunks,traj", [(3, 0), (4, 16), (3, 16), (4, 0)])
def test_scan_chunks_equal_one_chunk_and_jax(chunks, traj):
    """``scan_chunks = C`` runs C chunks of ceil(T/C) steps (T = 10: 4, 4,
    2 or 3, 3, 3, 1), the state carried between them: bit for bit the
    single chunk's rewards, final state, overflow and trajectory of the
    port's pcells program, and within 1e-4 of the JAX package's chunked
    episode from the same reset (N = 600, the lattice regime), on its
    blocked path: the exact O(N²) oracle, which the JAX package's own
    chunked test runs (its pcells path compiles the interpret-mode
    kernels of each chunk length in ~20 s on the CPU)."""
    n, steps = N_BODY, 10
    jp = jfl.FlockingParams(n_agents=n, episode_steps=steps)
    tp = tfl.FlockingParams(n_agents=n, episode_steps=steps)
    jcfg, tcfg = jac.ActorConfig(**ACFG), tac.ActorConfig(**ACFG)
    params = jac.init_actor(jax.random.key(1), jcfg)
    key = jax.random.key(4)
    kw = dict(return_overflow=True, traj_agents=traj)
    want = jln.rollout_large(params, jcfg, key, jp, scan_chunks=chunks,
                             path="blocked", **kw)
    actor = _port_actor(params, tcfg)
    x0 = torch.from_numpy(_jax_reset(jp, key))
    one = tln.rollout_large(actor, tcfg, None, tp, x0=x0, device="cpu", **kw)
    got = tln.rollout_large(actor, tcfg, None, tp, x0=x0, device="cpu",
                            scan_chunks=chunks, **kw)
    assert len(got) == len(one) == len(want) == (4 if traj else 3)
    for a, b in zip(got, one):
        assert torch.equal(a, b)
    assert int(got[2]) == int(want[2]) == 0
    assert got[0].shape == (steps,)
    for i in (0, 1) + ((3,) if traj else ()):
        _close(got[i], want[i])
    if traj:
        assert got[3].shape == (steps, traj, 4)


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 0], ids=lambda k: f"k{k}" if k
                         else "expert")
def test_program_body_equals_the_eager_loop(chunks, k):
    """The program's body, run eagerly on the CPU over its static buffers
    (the stochastic variant, its noise from the caller's generator),
    against the eager loop of ``_step`` (``graph=False``) over 20 steps:
    rewards, final state, overflow and trajectory bit for bit, the
    generator left in the same state. Three chunks (7, 7, 6 steps) carry
    the state from one program's buffers to the next (K = 4 rotates two
    historical grids by reference inside each)."""
    p = tfl.ENV_REGISTRY["FlockingStochastic-v0"](
        tfl.FlockingParams(n_agents=N_BODY, episode_steps=T_BODY))
    tcfg, actor = _actor(max(k, 1))
    kw = dict(return_overflow=True, device="cpu", traj_agents=16,
              expert_mode=k == 0)
    out = {}
    for graph in (False, None):
        gen = torch.Generator().manual_seed(7)
        out[graph] = (tln.rollout_large(actor, tcfg, gen, p, graph=graph,
                                        scan_chunks=1 if graph is False
                                        else chunks, **kw),
                      gen.get_state())
    (want, want_gen), (got, got_gen) = out[False], out[None]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got_gen, want_gen)
    assert int(want[2]) == 0


@pytest.mark.parametrize("k,n_tensors", [(3, 19), (4, 24)])
def test_program_state_equals_the_eager_state(k, n_tensors):
    """The final ``EpisodeState`` of a K = 3 or 4 program run, every
    tensor of it (the carry, the frame, the grid and the K - 2 historical
    grids, the pre-applied columns), equals the eager loop's bit for
    bit."""
    p = tfl.FlockingParams(n_agents=N_BODY, episode_steps=T_BODY)
    tcfg, actor = _actor(k)
    cfg = tln.make_config(p)
    x0 = tfl._init_candidate(torch.Generator().manual_seed(2), p, "cpu")
    with torch.no_grad():
        want, rewards = tln._scan_steps(
            cfg, actor, tln._episode_init(cfg, tcfg, None, "cpu", x0),
            T_BODY)
        prog = tln.EpisodeProgram(cfg, tcfg, T_BODY, "cpu")
        got = prog.run(tln._episode_init(cfg, tcfg, None, "cpu", x0), actor)
    assert torch.equal(prog.rewards, rewards)
    assert len(got.grid_hist) == k - 2
    got_t, want_t = tln._tensors(got), tln._tensors(want)
    assert len(got_t) == len(want_t) == n_tensors
    assert all(torch.equal(a, b) for a, b in zip(got_t, want_t))


@pytest.mark.parametrize("env", ["FlockingRelative-v0",
                                 "FlockingStochastic-v0"])
@pytest.mark.parametrize("mode", ["cloning", "dagger"])
def test_collection_program_equals_the_eager_loop(mode, env):
    """The large learner's collection episode (``collect_step``) through
    the program's body against its eager loop (``graph=False``), 20 steps
    from one generator (the reset, the coins, the subsample and, in the
    stochastic variant, the noise drawn from it): records, summed reward
    and overflow bit for bit, the generator left in the same state."""
    p = tfl.ENV_REGISTRY[env](
        tfl.FlockingParams(n_agents=N_BODY, episode_steps=T_BODY))
    cfg = tln.make_config(p, need_expert=True)
    tcfg, actor = _actor(3)
    out = {}
    for graph in (False, None):
        gen = torch.Generator().manual_seed(3)
        out[graph] = til.collect_episode(cfg, actor, tcfg, mode, 32, gen,
                                         0.5, "cpu", graph=graph) + (
                                             gen.get_state(),)
    (sa, ra, oa, ga), (sb, rb, ob, gb) = out[False], out[None]
    assert sa.keys() == sb.keys() == {"agg", "act"}
    assert all(torch.equal(sa[key], sb[key]) for key in sa)
    assert sa["agg"].shape == (T_BODY, 3, 32, 6)
    assert torch.equal(ra, rb) and int(oa) == int(ob) == 0
    assert torch.equal(ga, gb)


def test_block_sets_the_blocked_paths_rows_per_block():
    """``block=150`` on the blocked path (neither package's default at N =
    600) against the JAX package's ``rollout_large(path="blocked",
    block=150)`` from the same reset: rewards and final state within
    1e-4, overflow 0; the port's config carries the block."""
    n, steps, block = 600, 8, 150
    jp = jfl.FlockingParams(n_agents=n, episode_steps=steps)
    tp = tfl.FlockingParams(n_agents=n, episode_steps=steps)
    jcfg, tcfg = jac.ActorConfig(**ACFG), tac.ActorConfig(**ACFG)
    params = jac.init_actor(jax.random.key(2), jcfg)
    key = jax.random.key(6)
    jr, jx, jovf = jln.rollout_large(params, jcfg, key, jp, path="blocked",
                                     block=block, return_overflow=True)
    tr, tx, tovf = tln.rollout_large(
        _port_actor(params, tcfg), tcfg, None, tp, return_overflow=True,
        x0=torch.from_numpy(_jax_reset(jp, key)), device="cpu",
        path="blocked", block=block)
    assert int(tovf) == int(jovf) == 0
    _close(tr, jr)
    _close(tx, jx)
    assert tln.make_config(tp, path="blocked", block=block).block == block
    assert tln.make_config(tp, path="blocked").block == tln.block_rows(n)


@pytest.mark.parametrize("kw,match", [
    (dict(n_episodes=2, scan_chunks=2), "n_episodes > 1"),
    (dict(scan_chunks=0), "scan_chunks must be >= 1"),
    (dict(graph=True), "on the CPU"),
    (dict(graph="step"), "graph must be None, False or True"),
    (dict(graph=True, mesh=object()), "on the CPU"),
    (dict(graph=True, mesh=object(), path="binned"), "on the CPU"),
    (dict(graph=True, path="blocked"), "on the CPU"),
    (dict(graph=True, path="cells"), "on the CPU"),
    (dict(graph="nonsense"), "graph must be None, False or True"),
], ids=["episodes_and_chunks", "no_chunks", "cpu", "cpu_step", "mesh",
        "mesh_binned", "blocked", "cells", "unknown"])
def test_refusals(kw, match):
    """What the episode program does not run raises ValueError before any
    work; nothing falls back to the eager loop. A graph runs on every path
    on the card, so off pcells too the CPU is what refuses it."""
    p = tfl.FlockingParams(n_agents=48, episode_steps=2)
    tcfg, actor = _actor(3)
    with pytest.raises(ValueError, match=match):
        tln.rollout_large(actor, tcfg, None, p, device="cpu", **kw)


def test_program_refuses_what_it_cannot_capture():
    """An ``EpisodeProgram`` runs every path but refuses a state of another
    path's setup (a blocked state, with no grid, in a pcells program), no
    steps and no steps per graph, and a policy's program an episode
    without an actor; the cache returns one program per setup."""
    p = tfl.FlockingParams(n_agents=48, episode_steps=2)
    tcfg, actor = _actor(3)
    bcfg = tln.make_config(p, path="blocked")
    x0 = tfl._init_candidate(torch.Generator().manual_seed(1), p, "cpu")
    blocked = tln._episode_init(bcfg, tcfg, None, "cpu", x0)
    prog = tln.EpisodeProgram(tln.make_config(p), tcfg, 2, "cpu")
    prog.run(tln._episode_init(tln.make_config(p), tcfg, None, "cpu", x0),
             actor)
    with pytest.raises(ValueError, match="not of this program's setup"):
        prog.run(blocked, actor)
    for steps, per_graph in ((0, None), (2, 0)):
        with pytest.raises(ValueError, match="steps >= 1"):
            tln.EpisodeProgram(bcfg, tcfg, steps, "cpu",
                               steps_per_graph=per_graph)
    cfg = tln.make_config(p)
    a = tln.episode_program(cfg, tcfg, 2, "cpu")
    assert tln.episode_program(cfg, tcfg, 2, torch.device("cpu")) is a
    assert tln.episode_program(cfg, tcfg, 3, "cpu") is not a
    assert tln.episode_program(cfg, tcfg, 2, "cpu",
                               step=til.collect_step) is not a
    with pytest.raises(ValueError, match="needs an actor"):
        a.run(tln._episode_init(cfg, tcfg, None, "cpu", x0))


def test_launches_in_trace_reads_the_kernels_names():
    """``launches_in_trace`` counts K1, K2 and K3 by wrapper and width from
    the device events' names as the profiler records them on the card
    (the kernels' demangled names), and nothing else."""
    k1 = ("(anonymous namespace)::frame_kernel((anonymous namespace)::"
          "FrameOp, (anonymous namespace)::Ranges, int)")
    k2 = ("void (anonymous namespace)::apply_deg_kernel<12, 4>((anonymous "
          "namespace)::ApplyDegOp<12, 4>, (anonymous namespace)::Ranges, "
          "int)")
    k3 = ("void (anonymous namespace)::apply_kernel<{}>((anonymous "
          "namespace)::ApplyOp<{}>, (anonymous namespace)::Ranges, int)")
    names = ([k1] * 3 + [k2] * 2 + [k3.format(6, 6)] * 2
             + [k3.format(12, 12), "void at::native::vectorized_elementwise"
                "_kernel<4, at::native::FillFunctor<float>>(int)",
                "Memset (Device)"])
    assert tcc.launches_in_trace(names) == {
        "frame_sweep": {10: 3}, "apply_deg_sweep": {12: 2},
        "apply_sweep": {6: 2, 12: 1}}
    assert tcc.launches_in_trace([]) == {
        "frame_sweep": {}, "apply_deg_sweep": {}, "apply_sweep": {}}
