"""The port's mesh programs on the CPU, in a one-rank gloo process group:
``rollout_large(mesh=)`` through its episode program (``parallel/large_n.py:
EpisodeProgram`` banded over the mesh), the large learner's mesh round
(its collection program) and the data-parallel learner's round (its
rank's slice of the envs through the dense episode program, its update
with the gradient ``all_reduce`` through the update program). Gloo's
collectives cannot be captured, so on the CPU each program runs the body
it captures on the card eagerly, with the mesh's collectives in it:

* the mesh episode's program body equals the eager loop (``graph=False``)
  and the episode with no mesh bit for bit, greedy, expert, in two
  chunks, as a chain of two episodes, with a trajectory, and in the
  emulated timing mode (``force_n_dev``);
* the same banded episode against the JAX package's ``rollout_large
  (mesh=)`` on a one-device virtual CPU mesh (``shard_map``, Pallas in
  interpret mode) from the same reset, within 1e-4 of each channel's
  largest magnitude, the episode tolerance of ``tests/test_torch_rollout.py``;
* the large learner's and the data-parallel learner's round through
  their programs equal the eager rounds bit for bit;
* a program whose process group is destroyed is dropped from the cache
  and refuses to run; a new group captures anew.

D = 2 and 4 ranks run in the spawns of ``tests/test_torch_multihost.py``
and ``tests/test_torch_dp_training.py``, each program case beside its
``graph=False`` twin.
"""

import dataclasses
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.parallel import distributed as tdist
from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
from multiagent_gnn_policies_tpu_torch.parallel import mesh as tmesh
from multiagent_gnn_policies_tpu_torch.parallel.sharded import (
    ShardedImitationLearner,
)

from multiagent_gnn_policies_tpu.ops import pallas_cells as jpc

from test_torch_rollout import ACFG, _close, _port_actor
from test_torch_round_program import _dense_cfg, _large_cfg, _same

# the lattice regime (the reset draws once) and cx = 28 grid rows
N, T = 640, 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _join():
    """Join a one-rank gloo group on a free port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.initialize_distributed(f"127.0.0.1:{port}", 1, 0, platform="cpu")


@pytest.fixture
def one():
    """A one-rank gloo group and its ("env", "agents") mesh, the group
    destroyed after the test."""
    _join()
    try:
        yield tmesh.make_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _actor(seed=0):
    tcfg = tac.ActorConfig(**ACFG)
    return tcfg, tac.init_actor_(tac.Actor(tcfg),
                                 torch.Generator().manual_seed(seed)).eval()


def _jax_reset(p, key):
    """The initial state ``jln.rollout_large`` draws for ``key``, its reset
    jitted (``tests/test_torch_rollout.py``'s runs it op by op)."""
    cfg = jln.LargeNConfig(params=p, block=p.n_agents, rows=p.n_agents,
                           axis=None, path="pcells",
                           cell_spec=jpc.make_pcell_spec(p),
                           need_expert=False)
    reset_key, _ = jax.random.split(key)
    return np.array(jax.jit(lambda k: jln._reset(cfg, k, centralized=True)[0])(
        reset_key))


def _mesh_programs():
    return [k for k in tln._PROGRAMS if k[0].axis is not None]


@pytest.mark.parametrize("kw", [
    {}, dict(expert_mode=True), dict(scan_chunks=2), dict(n_episodes=2),
    dict(traj_agents=50, scan_chunks=3), dict(force_n_dev=4)],
    ids=["greedy", "expert", "chunks", "chain", "traj", "force_n_dev"])
def test_mesh_program_body_equals_the_eager_loop(one, kw):
    """The banded episode through its program body against the eager loop
    on the same mesh, and (a real axis) against no mesh: every output bit
    for bit, the program's config banded over the mesh."""
    p = tfl.ENV_REGISTRY["FlockingStochastic-v0"](
        tfl.FlockingParams(n_agents=N, episode_steps=T))
    tcfg, actor = _actor()

    def run(mesh, graph):
        gen = torch.Generator().manual_seed(4)
        out = tln.rollout_large(actor, tcfg, gen, p, return_overflow=True,
                                device="cpu", mesh=mesh, graph=graph, **kw)
        return out + (gen.get_state(),)

    tln.clear_programs()
    body = run(one, None)
    assert _mesh_programs(), "the mesh episode ran no program"
    assert all(k[0].axis.emulated == ("force_n_dev" in kw)
               for k in _mesh_programs())
    refs = [run(one, False)]
    if "force_n_dev" not in kw:     # emulated: no valid result to hold to
        refs.append(run(None, False))
        assert int(body[2]) == 0
    for ref in refs:
        for a, b in zip(body, ref, strict=True):
            assert torch.equal(a, b)


def test_mesh_program_matches_jax_mesh(one):
    """The port's banded episode program against the JAX ``shard_map``
    rollout on a one-device ``agents`` mesh from the same key (its reset
    is the port's x0): rewards and final state within 1e-4."""
    jcfg = jac.ActorConfig(**ACFG)
    params = jac.init_actor(jax.random.key(2), jcfg)
    jp = jfl.FlockingParams(n_agents=N, episode_steps=T)
    key = jax.random.key(7)
    jmesh = Mesh(np.asarray(jax.devices()[:1]), axis_names=("agents",))
    jr, jx, jovf = jln.rollout_large(params, jcfg, key, jp, mesh=jmesh,
                                     return_overflow=True)
    tcfg = tac.ActorConfig(**ACFG)
    tr, tx, tovf = tln.rollout_large(
        _port_actor(params, tcfg), tcfg, None,
        tfl.FlockingParams(n_agents=N, episode_steps=T),
        return_overflow=True, x0=torch.from_numpy(_jax_reset(jp, key)),
        device="cpu", mesh=one)
    assert _mesh_programs()
    assert int(tovf) == int(jovf) == 0
    _close(tr, jr)
    _close(tx, jx)


@pytest.mark.parametrize("kind", ["large", "dense"])
def test_mesh_rounds_through_programs_equal_eager_rounds(one, kind):
    """One round (with its eval) of the large learner on the ("env",
    "agents") mesh and of ``ShardedImitationLearner``, through their
    programs and eagerly: the whole training state, the loss sum and the
    stats bit for bit."""
    if kind == "large":
        make = lambda g: til.LargeNImitationLearner(
            _large_cfg(), device="cpu", mesh=one, graph=g)
    else:
        make = lambda g: ShardedImitationLearner(_dense_cfg(), one,
                                                 device="cpu", graph=g)
    tln.clear_programs()
    prog, eager = make(None), make(False)
    assert prog._updates.update == prog._update
    assert eager._updates is None
    stats = prog.train(stop_after=1)
    assert eager.train(stop_after=1) == stats
    if kind == "large":
        assert _mesh_programs(), "the mesh collection ran no program"
    assert torch.equal(prog.last_loss_sum, eager.last_loss_sum)
    assert float(prog.last_loss_sum) > 0
    _same(prog, eager)


def test_a_destroyed_groups_programs_are_dropped():
    """A mesh program's key holds its process group: after the group is
    destroyed, the program refuses to run, and the next lookup drops it;
    a new group's mesh makes (captures) a program of its own."""
    p = tfl.FlockingParams(n_agents=N, episode_steps=2)
    tcfg, actor = _actor()
    tln.clear_programs()
    progs = []
    for _ in range(2):
        _join()
        try:
            mesh = tmesh.make_mesh(1, 1, device_type="cpu")
            r = tln.rollout_large(actor, tcfg, torch.Generator().manual_seed(
                1), p, device="cpu", mesh=mesh)[0]
            (key,) = _mesh_programs()
            progs.append((tln._PROGRAMS[key], r))
            state = tln._episode_init(key[0], tcfg, None, "cpu",
                                      tfl._init_candidate(
                                          torch.Generator().manual_seed(2),
                                          p, "cpu"))
        finally:
            dist.destroy_process_group()
        assert not key[0].axis.live()
        with pytest.raises(RuntimeError, match="process group was destroyed"):
            progs[-1][0].run(state, actor)
    assert progs[0][0] is not progs[1][0]
    assert torch.equal(progs[0][1], progs[1][1])
    tln.episode_program(tln.make_config(p), tcfg, 2, "cpu")
    assert not _mesh_programs()


def test_graph_true_on_a_mesh_raises_only_on_the_cpu_or_off_pcells(one):
    """``graph=True`` on a mesh raises on the CPU, on the pcells path and
    off it alike: a mesh's episode runs its program on every path on the
    card."""
    p = tfl.FlockingParams(n_agents=48, episode_steps=2)
    tcfg, actor = _actor()
    with pytest.raises(ValueError, match="on the CPU"):
        tln.rollout_large(actor, tcfg, None, p, device="cpu", mesh=one,
                          graph=True)
    with pytest.raises(ValueError, match="on the CPU"):
        tln.rollout_large(actor, tcfg, None, p, device="cpu", mesh=one,
                          path="binned", graph=True)
    with pytest.raises(ValueError, match="on the CPU"):
        til.LargeNImitationLearner(
            dataclasses.replace(_large_cfg(), graph_path="cells"),
            device="cpu", mesh=one, graph=True)
