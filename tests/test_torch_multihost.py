"""The port's agent-sharded large-N path over real ranks: gloo process
groups on the CPU, one subprocess per rank, each on a free port and under a
timeout (tests/test_multihost.py's pattern; no state of
``torch.distributed`` is left in the test process):

* the port's ``multihost_demo`` at 2 ranks (its three steps, the
  data-parallel DAGGER round's reward and loss equal on both ranks);
* D-rank rollouts (D = 2 and 4; the expert and a K = 3 policy on the
  pcells, blocked, cells and binned paths, the leader and stochastic
  variants, an episode chain, a recorded trajectory, a chunked episode
  with one, the cells path at N = 66, which D = 4 does not divide) equal
  the single-process port rollout bit for bit, on every rank, with equal
  overflow; on the pcells path each runs its episode program's body,
  the mesh's collectives in it, and equals its ``graph=False`` twin (the
  eager loop) bit for bit; and they agree
  within 1e-4 with the JAX package's mesh rollout from the same initial
  state
  (``rollout_large(mesh=...)`` on tests/conftest.py's virtual CPU devices,
  Pallas in interpret mode), as tests/test_torch_rollout.py holds the
  unsharded one; the binned path at N = 66 raises at D = 4 (it splits
  agent rows) and runs at D = 2;
* ``build_pcell_grid_sharded`` equals the replicated build field for
  field, on a grid with dropped agents;
* ``evaluate --mesh 2`` under 2 ranks prints the single-process CSV, and
  refuses a world of another size; ``maybe_initialize_distributed`` is a
  no-op without its variables.

The ranks run tests/_torch_mesh_rank.py or the port's entry points.
"""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.ops import pallas_cells as jpc
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu_torch import evaluate as tev
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import torch_import as tim
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc
from multiagent_gnn_policies_tpu_torch.parallel import distributed as tdist

import _torch_mesh_rank as worker     # tests/, beside this file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_rank.py")
N32K = os.path.join(REPO, "models", "actor_FlockingRelative-v0_dagger_n32k.npz")
# the lattice reset's regime (no redraws), and cx = 28 grid rows: whole
# bands at D = 2 and 4
N, STEPS, K = 640, 8, 3
N_ODD = 66           # the JAX cells mesh test's N: D = 4 does not divide it
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    """The ranks' environment: the repository importable, one thread each."""
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


def _start_ranks(argv_of, d, env_of=None):
    return [subprocess.Popen(argv_of(r), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=REPO,
                             env=env_of(r) if env_of else _env())
            for r in range(d)]


def _run_ranks(argv_of, d, env_of=None, procs=None):
    """Start ``d`` rank processes (``argv_of(rank)``; or take the started
    ``procs``), wait for all; returns their stdouts, failing with a rank's
    stderr."""
    procs = procs or _start_ranks(argv_of, d, env_of)
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_reset(p, key):
    """The initial state ``jln.rollout_large`` draws for ``key``."""
    cfg = jln.LargeNConfig(params=p, block=p.n_agents, rows=p.n_agents,
                           axis=None, path="pcells",
                           cell_spec=jpc.make_pcell_spec(p),
                           need_expert=False)
    reset_key, _ = jax.random.split(key)
    # jitted: op by op, the Pallas kernels' interpret mode takes ~10 s
    return np.array(jax.jit(lambda k: jln._reset(cfg, k, centralized=True)[0])(
        reset_key))


CASES = ("pcells_k3", "pcells_expert", "blocked_k3", "blocked_expert",
         "leader_k3", "stoch_k3", "chain_k3", "traj_k3", "cells_k3",
         "cells_expert", "binned_k3", "binned_expert", "cells_n66",
         "chunks_traj_k3")
# the pcells cases run through their episode program's body; each has a
# twin, "<case>_eager", run with graph=False
PROGRAM_CASES = ("pcells_k3", "pcells_expert", "stoch_k3", "chain_k3",
                 "chunks_traj_k3")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every case at D = 2 and 4 ranks, once for the module: the rank
    outputs, and what the cases share (the JAX actor's weights, the JAX
    reset's initial state)."""
    tmp = tmp_path_factory.mktemp("mesh")
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=K)
    params = jac.init_actor(jax.random.key(0), jcfg)
    actor = tac.Actor(tac.ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=K))
    actor.load_state_dict(tim.actor_params_from_numpy(
        [{name: np.array(v) for name, v in layer.items()}
         for layer in params]))
    torch.save(actor.state_dict(), tmp / "actor.pt")
    for n, name in ((N, "x0.npy"), (N_ODD, "x0_66.npy")):
        jp = jfl.FlockingParams(n_agents=n, episode_steps=STEPS)
        np.save(tmp / name, _jax_reset(jp, jax.random.key(3)))
    base = dict(n=N, steps=STEPS, k=K, env="FlockingRelative-v0",
                actor=str(tmp / "actor.pt"), x0=str(tmp / "x0.npy"),
                path="pcells")
    cases = {
        "pcells_k3": {},
        "pcells_expert": dict(actor=None),
        "blocked_k3": dict(path="blocked"),
        "blocked_expert": dict(path="blocked", actor=None),
        "leader_k3": dict(env="FlockingLeader-v0"),
        "stoch_k3": dict(env="FlockingStochastic-v0", x0=None, seed=5),
        "chain_k3": dict(x0=None, seed=6, episodes=2, steps=4),
        "traj_k3": dict(path="blocked", traj=50),
        "cells_k3": dict(path="cells"),
        "cells_expert": dict(path="cells", actor=None),
        "binned_k3": dict(path="binned"),
        "binned_expert": dict(path="binned", actor=None),
        "cells_n66": dict(path="cells", n=N_ODD, x0=str(tmp / "x0_66.npy")),
        "binned_n66": dict(path="binned", n=N_ODD, may_raise=True,
                           x0=str(tmp / "x0_66.npy")),
        "chunks_traj_k3": dict(traj=50, chunks=3),
    }
    cases.update({f"{name}_eager": dict(cases[name], graph=False)
                  for name in PROGRAM_CASES})
    cases = [dict(base, name=name, **kw) for name, kw in cases.items()]
    rng = np.random.default_rng(4)
    pos = rng.uniform(-4.0, 4.0, (160, 2)).astype(np.float32)
    pos[:24] = rng.uniform(-0.3, 0.3, (24, 2))           # over cap
    np.save(tmp / "grid.npy", pos)
    spec = tcc.make_pcell_spec(tfl.FlockingParams(n_agents=160), cap=8,
                               n_dev=4)
    cases.append(dict(name="grid", grid=str(tmp / "grid.npy"),
                      spec=list(spec)))
    (tmp / "cases.json").write_text(json.dumps(cases))
    started = {}
    for d in (2, 4):               # both meshes at once, each on its port
        port = _free_port()
        (tmp / str(d)).mkdir()
        started[d] = _start_ranks(
            lambda r: [sys.executable, WORKER, str(r), str(d), str(port),
                       str(tmp / "cases.json"), str(tmp / str(d))], d)
    for d, procs in started.items():
        _run_ranks(None, d, procs=procs)
    return {"dir": tmp, "cases": {c["name"]: c for c in cases},
            "params": params, "jcfg": jcfg, "spec": spec, "pos": pos}


def _rank_outputs(runs, d, name):
    return [np.load(runs["dir"] / str(d) / f"{name}_{r}.npz")
            for r in range(d)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d", [2, 4])
def test_rank_rollout_equals_single_process(mesh_runs, d, case):
    """Every rank returns the single-process rollout's rewards, final
    state and overflow, bit for bit."""
    c = mesh_runs["cases"][case]
    r1, x1, o1, *traj = worker.run_case(c, None)
    assert int(o1) == 0
    assert r1.shape == (c["steps"] * c.get("episodes", 1),)
    for out in _rank_outputs(mesh_runs, d, case):
        np.testing.assert_array_equal(out["rewards"], r1.numpy())
        np.testing.assert_array_equal(out["x"], x1.numpy())
        assert int(out["overflow"]) == int(o1)
        if traj:
            assert traj[0].shape == (c["steps"], c["traj"], 4)
            np.testing.assert_array_equal(out["traj"], traj[0].numpy())


@pytest.mark.parametrize("case", PROGRAM_CASES)
@pytest.mark.parametrize("d", [2, 4])
def test_rank_program_equals_the_eager_loop(mesh_runs, d, case):
    """On every rank, the episode through its program's body (the band's
    collectives in it) equals the ``graph=False`` twin's eager loop bit
    for bit."""
    for prog, eager in zip(_rank_outputs(mesh_runs, d, case),
                           _rank_outputs(mesh_runs, d, f"{case}_eager"),
                           strict=True):
        assert prog.files == eager.files
        for key in prog.files:
            np.testing.assert_array_equal(prog[key], eager[key], err_msg=key)


@pytest.mark.parametrize("d,case", [(2, "pcells_k3"), (4, "pcells_expert"),
                                    (2, "blocked_k3"), (4, "blocked_expert"),
                                    (2, "cells_k3"), (4, "cells_expert"),
                                    (4, "binned_k3"), (2, "binned_expert"),
                                    (4, "cells_n66")])
def test_rank_rollout_matches_jax_mesh(mesh_runs, d, case):
    """The D-rank rollout against the JAX package's rollout over a D-device
    ``agents`` mesh from the same key (its reset is the ranks' x0):
    rewards and final state within 1e-4 of their largest magnitude."""
    c = mesh_runs["cases"][case]
    jp = jfl.FlockingParams(n_agents=c["n"], episode_steps=STEPS)
    mesh = Mesh(np.asarray(jax.devices()[:d]), axis_names=("agents",))
    expert = c["actor"] is None
    jr, jx, jovf = jln.rollout_large(
        None if expert else mesh_runs["params"],
        None if expert else mesh_runs["jcfg"], jax.random.key(3), jp,
        mesh=mesh, path=c["path"], expert_mode=expert, return_overflow=True)
    out = _rank_outputs(mesh_runs, d, case)[0]
    assert int(out["overflow"]) == int(jovf) == 0
    for got, want in ((out["rewards"], jr), (out["x"], jx)):
        want = np.asarray(want, np.float64)
        err = np.abs(got - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (err, np.abs(want).max())


def test_binned_needs_the_axis_to_divide_n(mesh_runs):
    """The binned path splits agent rows: at N = 66 a 4-rank axis raises on
    every rank, and a 2-rank one equals the single process bit for bit."""
    for out in _rank_outputs(mesh_runs, 4, "binned_n66"):
        assert "n_agents=66 not divisible by mesh axis 4" in str(out["error"])
    c = mesh_runs["cases"]["binned_n66"]
    r1, x1, o1 = worker.run_case(c, None)
    assert int(o1) == 0
    for out in _rank_outputs(mesh_runs, 2, "binned_n66"):
        assert "error" not in out
        np.testing.assert_array_equal(out["rewards"], r1.numpy())
        np.testing.assert_array_equal(out["x"], x1.numpy())


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_grid_build_equals_replicated(mesh_runs, d):
    want = tcc.build_pcell_grid(torch.from_numpy(mesh_runs["pos"]),
                                mesh_runs["spec"])
    assert int(want.overflow) > 0
    for out in _rank_outputs(mesh_runs, d, "grid"):
        for field in ("slot", "order", "kept", "cell_start", "overflow"):
            np.testing.assert_array_equal(
                out[field], getattr(want, field).numpy(), err_msg=field)


def test_multihost_demo_two_ranks():
    port = _free_port()
    outs = _run_ranks(lambda r: [
        sys.executable, "-m",
        "multiagent_gnn_policies_tpu_torch.scripts.multihost_demo",
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
        "--process-id", str(r), "--n-agents", "256", "--device", "cpu"], 2)
    oks = [re.search(r"MULTIHOST_OK (.*)", o) for o in outs]
    assert all(oks), outs
    fields = [dict(kv.split("=") for kv in m.group(1).split()) for m in oks]
    assert fields[0]["devices"] == fields[1]["devices"] == "2"
    assert fields[0]["psum"] == fields[1]["psum"] == "3.0"
    assert fields[0]["rollout"] == fields[1]["rollout"] == fields[0]["local"]
    assert fields[0]["overflow"] == "0"
    for f in fields:      # step 3: the data-parallel DAGGER round
        assert np.isfinite(float(f["round_reward"]))
        assert np.isfinite(float(f["loss"])) and float(f["loss"]) > 0
    assert fields[0]["round_reward"] == fields[1]["round_reward"]
    assert fields[0]["loss"] == fields[1]["loss"]


def test_maybe_initialize_is_a_noop_without_the_environment(monkeypatch):
    for var in ("MAGNN_COORDINATOR", "MAGNN_NUM_PROCESSES",
                "MAGNN_PROCESS_ID", "MAGNN_AUTO_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.maybe_initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert tdist.process_info() == (0, 1)


EVAL_CFG = """
[DEFAULT]
alg = dagger
env = FlockingRelative-v0
seed = 5
header = reward
n_agents = 640
k = 3
hidden_size = 32
n_test_episodes = 2
episode_steps = 6
v_max = 3.0
comm_radius = 1.0
n_actions = 2
n_states = 6
dt = 0.01

[small]
"""


def test_evaluate_mesh_prints_the_single_process_csv(tmp_path, capsys):
    """``evaluate --mesh 2`` under 2 gloo ranks (the MAGNN_* variables):
    rank 0 prints the CSV of the same command without ``--mesh``, rank 1
    prints nothing."""
    cfg = tmp_path / "eval.cfg"
    cfg.write_text(EVAL_CFG)
    argv = [str(cfg), "--actor-path", N32K, "--device", "cpu",
            "--per-episode", "--n-agents", "640"]
    tev.main(argv)
    want = capsys.readouterr().out
    port = _free_port()
    outs = _run_ranks(
        lambda r: [sys.executable, "-m",
                   "multiagent_gnn_policies_tpu_torch.evaluate", *argv,
                   "--mesh", "2"], 2,
        env_of=lambda r: _env(MAGNN_COORDINATOR=f"127.0.0.1:{port}",
                              MAGNN_NUM_PROCESSES="2",
                              MAGNN_PROCESS_ID=str(r)))
    assert outs[0] == want and outs[1] == ""
    assert want.splitlines()[-1].startswith("small, ")


def test_evaluate_mesh_refuses_a_world_of_another_size(tmp_path):
    cfg = tmp_path / "eval.cfg"
    cfg.write_text(EVAL_CFG)
    argv = [sys.executable, "-m", "multiagent_gnn_policies_tpu_torch.evaluate",
            str(cfg), "--expert", "--device", "cpu", "--mesh", "2"]
    env = {k: v for k, v in _env().items() if not k.startswith("MAGNN_")}
    alone = subprocess.run(argv, capture_output=True, text=True, cwd=REPO,
                           env=env, timeout=TIMEOUT)
    assert alone.returncode != 0
    assert "--mesh 2 needs 2 processes" in alone.stderr
    one = subprocess.run(argv, capture_output=True, text=True, cwd=REPO,
                         timeout=TIMEOUT, env=dict(
                             env, MAGNN_COORDINATOR=f"127.0.0.1:{_free_port()}",
                             MAGNN_NUM_PROCESSES="1", MAGNN_PROCESS_ID="0"))
    assert one.returncode != 0
    assert "needs a world of 2 processes" in one.stderr
