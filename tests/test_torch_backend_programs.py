"""The episode program (``parallel/large_n.py:EpisodeProgram``) on the
blocked, cells and binned paths, and the trajectory dump's program
(``algos/imitation.py:TrajectoryProgram``), on the CPU, where a program
runs the body it captures on the card eagerly over its static buffers:

* on each path, the program's body against the eager loop
  (``graph=False``), bit for bit (rewards, final state, overflow,
  trajectory, the generator's state): K = 1 and 3, the expert, the
  stochastic variant, ``traj_agents``, ``n_episodes`` > 1, and a program
  split into chunks of steps (``steps_per_graph``, the chunk loop the card
  replays graph by graph, its inputs and records copied per chunk);
* each path's program within 1e-4 of the JAX package's
  ``rollout_large(path=...)`` from the same initial state;
* each path on a 2-rank gloo mesh (one subprocess per rank,
  tests/_torch_mesh_rank.py) through its program's body, equal to one
  process and to the ranks' eager loop bit for bit;
* the large learner's collection episode on the cells and blocked paths
  through the program's body (whole and in chunks) against
  ``graph=False``;
* ``rollout_trajectory``'s program against its eager loop bit for bit and
  against the JAX package's ``rollout_trajectory`` within 1e-4;
* the cells grid at cap 12 on a dense N = 32,768 swarm that overflows:
  slots, the dump slot and the overflow count equal to the JAX package's.

jax.random and torch generators give different numbers, so the port is
handed the JAX reset's initial state (``x0``). Tolerance against JAX: 1e-4
of the largest magnitude (the episode tolerance of
``tests/test_torch_rollout.py``); within the port, exact.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from multiagent_gnn_policies_tpu.algos import imitation as jim
from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.ops import cells as jcl
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu_torch.algos import imitation as tim
from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.ops import cells as tcl
from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln

import _torch_mesh_rank as worker     # tests/, beside this file
from test_torch_rollout import ACFG, _close, _port_actor

PATHS = ("blocked", "cells", "binned")
N, T = 512, 4         # the lattice regime's least N: no reset redraws
N_MESH = 640          # tests/test_torch_multihost.py's lattice N
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_rank.py")


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


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", ["k1", "k3", "expert", "k3_chain"])
def test_program_body_equals_the_eager_loop(path, case):
    """The stochastic variant on ``path`` from one generator (its reset
    and noise): rollout_large through the program's body against the
    eager loop, bit for bit, with a trajectory (or, ``k3_chain``, two
    episodes chained), the generator left in the same state."""
    p = tfl.ENV_REGISTRY["FlockingStochastic-v0"](
        tfl.FlockingParams(n_agents=N, episode_steps=T))
    tcfg, actor = _actor(1 if case == "k1" else 3)
    kw = dict(return_overflow=True, device="cpu", path=path,
              expert_mode=case == "expert")
    kw.update(n_episodes=2) if case == "k3_chain" else kw.update(
        traj_agents=16)
    out = {}
    for graph in (False, None):
        gen = torch.Generator().manual_seed(7)
        out[graph] = (tln.rollout_large(actor, tcfg, gen, p, graph=graph,
                                        **kw), gen.get_state())
    (want, want_gen), (got, got_gen) = out[False], out[None]
    _equal(got, want)
    assert torch.equal(got_gen, want_gen)
    assert int(want[2]) == 0
    assert want[0].shape == (T * (2 if case == "k3_chain" else 1),)


@pytest.mark.parametrize("path", PATHS)
def test_program_in_chunks_equals_the_eager_loop(path):
    """A program of 7 steps in graphs of 3 (3, 3, 1), the state
    carried in its static buffers from chunk to chunk and the trajectory
    copied out per chunk, against ``_scan_steps``: rewards, trajectory and
    every tensor of the final state bit for bit; its chunks are (0, 3),
    (3, 3), (6, 1)."""
    steps = 7
    p = tfl.FlockingParams(n_agents=N, episode_steps=steps)
    tcfg, actor = _actor(3)
    cfg = tln.make_config(p, path=path)
    x0 = tfl._init_candidate(torch.Generator().manual_seed(2), p, "cpu")
    with torch.no_grad():
        want, rewards, traj = tln._scan_steps(
            cfg, actor, tln._episode_init(cfg, tcfg, None, "cpu", x0), steps,
            traj_agents=16)
        prog = tln.EpisodeProgram(cfg, tcfg, steps, "cpu", traj_agents=16,
                                  steps_per_graph=3)
        got = prog.run(tln._episode_init(cfg, tcfg, None, "cpu", x0), actor)
    assert prog._chunks() == [(0, 3), (3, 3), (6, 1)]
    assert torch.equal(prog.rewards, rewards)
    assert torch.equal(prog.traj, traj)
    _equal(tln._tensors(got), tln._tensors(want))


def _lattice_x0(jp, key):
    """The initial state ``jln.rollout_large`` draws for ``key`` in the
    lattice regime, where its reset takes the first candidate (the
    reset's draw as ``_jax_reset`` takes it, jitted)."""
    assert jfl._lattice_regime(jp)
    sub = jax.random.split(jax.random.split(key)[0])[1]
    return np.array(jax.jit(lambda k: jfl._init_candidate(k, jp))(sub))


@pytest.fixture(scope="module")
def jax_episodes():
    """The JAX package's K = 3 episode on each path from one key, with
    its reset and weights."""
    jp = jfl.FlockingParams(n_agents=N, episode_steps=T)
    jcfg = jac.ActorConfig(**ACFG)
    params = jac.init_actor(jax.random.key(1), jcfg)
    key = jax.random.key(4)
    runs = {path: jln.rollout_large(params, jcfg, key, jp, path=path,
                                    return_overflow=True)
            for path in PATHS}
    return params, _lattice_x0(jp, key), runs


@pytest.mark.parametrize("path", PATHS)
def test_program_matches_jax(jax_episodes, path):
    """The port's program on ``path`` (its body, on the CPU) against the
    JAX package's ``rollout_large(path=...)`` from the same reset:
    rewards and final state within 1e-4, overflow 0 on both."""
    params, x0, runs = jax_episodes
    tcfg = tac.ActorConfig(**ACFG)
    tp = tfl.FlockingParams(n_agents=N, episode_steps=T)
    jr, jx, jovf = runs[path]
    tr, tx, tovf = tln.rollout_large(
        _port_actor(params, tcfg), tcfg, None, tp, return_overflow=True,
        x0=torch.from_numpy(x0), device="cpu", path=path)
    assert int(tovf) == int(jovf) == 0
    _close(tr, jr)
    _close(tx, jx)


# the stochastic variant in two chunks with a trajectory, per path
MESH_CASES = {f"{path}_stoch_k3": dict(path=path, env="FlockingStochastic-v0",
                                       seed=5, chunks=2, traj=40)
              for path in PATHS}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Each of MESH_CASES on a 2-rank gloo mesh, through the program's
    body and (``<case>_eager``) the eager loop: the ranks' outputs."""
    tmp = tmp_path_factory.mktemp("mesh")
    torch.save(_actor(3)[1].state_dict(), tmp / "actor.pt")
    base = dict(n=N_MESH, steps=T, k=3, env="FlockingRelative-v0",
                actor=str(tmp / "actor.pt"))
    cases = {}
    for name, kw in MESH_CASES.items():
        cases[name] = dict(base, name=name, **kw)
        cases[f"{name}_eager"] = dict(cases[name], name=f"{name}_eager",
                                      graph=False)
    (tmp / "cases.json").write_text(json.dumps(list(cases.values())))
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(port),
         str(tmp / "cases.json"), str(tmp)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
        for r in range(2)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    return tmp, cases


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_program_equals_one_process_and_the_eager_loop(mesh_runs,
                                                            case):
    """Every rank of the 2-rank mesh, through its program's body (the
    frames' gathers, the applies' collectives and the state gather in it),
    returns the one-process rollout's rewards, final state, overflow and
    trajectory, and the ranks' eager loop's, bit for bit."""
    tmp, cases = mesh_runs
    r1, x1, o1, *traj = worker.run_case(cases[case], None)
    want = {"rewards": r1, "x": x1, "overflow": o1}
    if traj:
        want["traj"] = traj[0]
    for r in range(2):
        for name in (case, f"{case}_eager"):
            out = np.load(tmp / f"{name}_{r}.npz")
            assert set(out.files) == set(want)
            for key, v in want.items():
                np.testing.assert_array_equal(out[key], v.numpy(),
                                              err_msg=f"{name} {key}")
    assert int(o1) == 0


@pytest.mark.parametrize("path", ["cells", "blocked"])
@pytest.mark.parametrize("per_graph", [None, 3])
def test_collection_program_equals_the_eager_loop(path, per_graph):
    """The large learner's DAGGER collection episode (``collect_step``) on
    ``path`` through the program's body, whole or in graphs of 3 steps
    (3, 2: the subsample and the coin copied in per chunk, the records
    copied out), against its eager loop: records, summed reward and
    overflow bit for bit, the generator left in the same state."""
    steps = 5
    p = tfl.ENV_REGISTRY["FlockingStochastic-v0"](
        tfl.FlockingParams(n_agents=N, episode_steps=steps))
    cfg = tln.make_config(p, path=path, need_expert=True)
    tcfg, actor = _actor(3)
    tln.clear_programs()
    prog = til.collection_program(cfg, tcfg, "dagger", 32, "cpu")
    prog.steps_per_graph = per_graph
    out = {}
    for graph in (False, None):
        gen = torch.Generator().manual_seed(3)
        out[graph] = til.collect_episode(cfg, actor, tcfg, "dagger", 32, gen,
                                         0.5, "cpu", graph=graph) + (
                                             gen.get_state(),)
    assert til.collection_program(cfg, tcfg, "dagger", 32, "cpu") is prog
    assert prog._chunks() == ([(0, 3), (3, 2)] if per_graph else [(0, 5)])
    tln.clear_programs()
    (sa, ra, oa, ga), (sb, rb, ob, gb) = out[False], out[None]
    assert sa.keys() == sb.keys() == {"agg", "act"}
    assert all(torch.equal(sa[key], sb[key]) for key in sa)
    assert sa["agg"].shape == (steps, 3, 32, 6)
    assert torch.equal(ra, rb) and int(oa) == int(ob) == 0
    assert torch.equal(ga, gb)


def test_trajectory_program_equals_the_eager_loop_and_jax():
    """``rollout_trajectory`` through its program's body against its eager
    loop (``graph=False``) bit for bit, from the JAX reset, and both
    within 1e-4 of the JAX package's ``rollout_trajectory``; the
    stochastic variant's program against its eager loop from one
    generator, bit for bit; ``graph=True`` refused on the CPU."""
    n, steps, k = 20, 12, 3
    jp = jfl.FlockingParams(n_agents=n, episode_steps=steps)
    jenv = jfl.make_env("FlockingRelative-v0", jp)
    jcfg = jac.ActorConfig(**dict(ACFG, k=k))
    params = jac.init_actor(jax.random.key(2), jcfg)
    key = jax.random.key(4)
    jxs, jrs = jim.rollout_trajectory(params, key, jenv, jcfg)
    x0 = torch.from_numpy(np.array(jenv.reset(jax.random.split(key)[0])[0].x))
    tcfg = tac.ActorConfig(**dict(ACFG, k=k))
    actor = _port_actor(params, tcfg)
    tp = tfl.FlockingParams(n_agents=n, episode_steps=steps)
    tenv = tfl.make_env("FlockingRelative-v0", tp)
    runs = {g: tim.rollout_trajectory(actor, None, tenv, tcfg, x0=x0,
                                      graph=g) for g in (None, False)}
    _equal(runs[None], runs[False])
    assert runs[None][0].shape == (steps, n, 4)
    for got, want in zip(runs[None], (jxs, jrs)):
        _close(got, want)
    senv = tfl.make_env("FlockingStochastic-v0", tp)
    out = {}
    for g in (None, False):
        gen = torch.Generator().manual_seed(9)
        out[g] = tim.rollout_trajectory(actor, gen, senv, tcfg,
                                        graph=g) + (gen.get_state(),)
    _equal(out[None], out[False])
    with pytest.raises(ValueError, match="on the CPU"):
        tim.rollout_trajectory(actor, None, tenv, tcfg, x0=x0, graph=True)


def test_cells_grid_overflow_at_n32k_equals_jax():
    """The cells grid at its default cap 12 on a dense N = 32,768 swarm:
    the lattice reset contracted toward its centre by 0.35, so that many
    cells hold more than 12 agents. Both packages' ``make_cell_spec`` and
    ``build_cell_grid`` on the same positions: the spec, every slot, the
    dump slot of each dropped agent and the overflow count equal."""
    n = 32_768
    jp = jfl.FlockingParams(n_agents=n)
    tp = tfl.FlockingParams(n_agents=n)
    pos = tfl._init_candidate(torch.Generator().manual_seed(0), tp,
                              "cpu")[:, :2].numpy()
    pos = (pos * 0.35).astype(np.float32)
    jspec = jcl.make_cell_spec(jp, cap=12)
    tspec = tcl.make_cell_spec(tp, cap=12)
    assert tuple(tspec) == tuple(jspec)
    want = jax.jit(lambda q: jcl.build_cell_grid(q, jspec))(
        jax.numpy.asarray(pos))
    got = tcl.build_cell_grid(torch.from_numpy(pos), tspec)
    for f in ("slot_of_agent", "agent_of_slot", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    dump = tspec.cx * tspec.cy * tspec.cap
    dropped = int((got.slot_of_agent == dump).sum())
    assert dropped == int(got.overflow) > 0
