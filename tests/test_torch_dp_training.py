"""The port's data-parallel imitation training over real ranks: gloo process
groups on the CPU, one subprocess per rank (tests/_torch_train_rank.py),
each group on a free port and under a timeout; no state of
``torch.distributed`` is left in the test process.

* ``ShardedImitationLearner`` on 2 and 4 ``env`` ranks and on a 2 x 2
  ``("env", "agents")`` mesh, cloning and DAGGER (and the stochastic
  variant), at tests/test_sharding.py's config for 2 rounds: every rank's
  parameters equal the one-process learner's within rtol 1e-6 / atol 1e-7
  (the gradient is summed over the ranks in another order), the ranks
  equal each other and their buffers the one-process buffer bit for bit;
* one sharded Adam update of a numpy-drawn batch that the ranks split
  unevenly (7 rows over 2, 6 over 4: one rank empty) against the JAX
  ``_loss_fn`` and ``optax.adam`` on the same parameters, within 1e-6; and
  the JAX ``ShardedImitationLearner`` itself on such a batch, which runs
  (XLA splits it unevenly) rather than raising;
* ``LargeNImitationLearner(mesh=)`` on ``("agents",)`` meshes of 2 and 4
  ranks (n_env = 1; and the blocked and cells paths on 2, the binned path
  on 4), an ``("env",)`` mesh of 2 and a 2 x 2 mesh (pcells and cells), at tests/test_imitation_large.py's sizes (N = 64,
  store 16, T = 10, 2 episodes a round): parameters and eval means equal
  the one-process learner's within rtol 1e-6 (bit for bit here); a D-rank
  ``collect_episode`` from injected draws equals the one-process episode
  on the same grid bit for bit and the JAX ``_collect_episode`` within
  1e-4 of each channel's largest magnitude (the tolerance of
  tests/test_torch_imitation_large.py);
* the learners' loops run through their programs' bodies by default (on
  the card: the rank's slice of the dense collection and the banded
  large collection and eval as CUDA graphs, each Adam update with its
  gradient ``all_reduce``): a dense and a large round on 2 ranks and on a
  2 x 2 mesh, and the collection episode on 2 and 4 ranks, each equal to
  its ``graph=False`` twin (the eager loops) bit for bit on every rank;
* the guards: both learners refuse an ``n_rollout_envs`` that the ``env``
  axis does not divide; a forced overflow on one rank makes every rank
  exit non-zero with the gate's message within 60 s;
* a 2-rank run stopped after round 1 and resumed equals the uninterrupted
  2-rank run bit for bit (dense and large), its events logged by rank 0
  alone;
* ``scripts.dryrun_multichip`` at 4 ranks exits 0;
* the large learner's blocked path against the JAX learner's blocked
  collection at N = 64;
* the train CLI joins a process group from the ``MAGNN_*`` variables and
  stays one process without them.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from multiagent_gnn_policies_tpu.algos import imitation as jim
from multiagent_gnn_policies_tpu.algos import imitation_large as jil
from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.ops import pallas_cells as jpc
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import torch_import as tim
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc
from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln

import _torch_train_rank as worker     # tests/, beside this file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_train_rank.py")
TIMEOUT = 300
OVERFLOW_S = 60
REL = 1e-4

# tests/test_sharding.py:23-39 (2 rounds of 4 episodes)
DENSE = dict(mode="cloning", hidden=[8, 8], k=2, n_agents=10,
             episode_steps=16, batch_size=8, buffer_size=256,
             updates_per_episode=4, n_train_episodes=8, test_interval=4,
             n_test_episodes=2, n_rollout_envs=4, seed=0)
# tests/test_imitation_large.py's sizes (2 rounds of 2 episodes)
LARGE = dict(mode="dagger", hidden=[8], k=3, n_agents=64, episode_steps=10,
             batch_size=4, buffer_size=64, updates_per_episode=3,
             n_train_episodes=4, test_interval=2, n_test_episodes=2, seed=5,
             store_agents=16, graph_path="pcells", n_rollout_envs=2)
# name: (ranks, env axis, config changes)
DENSE_CASES = {
    "d2-env-cloning": (2, 2, {}),
    "d2-env-dagger": (2, 2, {"mode": "dagger"}),
    "d2-env-stoch": (2, 2, {"mode": "dagger",
                            "env_name": "FlockingStochastic-v0"}),
    "d4-env-cloning": (4, 4, {}),
    "d4-env-dagger": (4, 4, {"mode": "dagger"}),
    "d4-2x2-cloning": (4, 2, {}),
    "d4-2x2-dagger": (4, 2, {"mode": "dagger"}),
}
LARGE_CASES = {
    "d2-agents": (2, 1, {}),
    "d4-agents": (4, 1, {}),
    "d2-agents-blocked": (2, 1, {"graph_path": "blocked"}),
    "d2-agents-cells": (2, 1, {"graph_path": "cells"}),
    "d4-agents-binned": (4, 1, {"graph_path": "binned"}),
    "d2-env": (2, 2, {}),
    "d4-2x2": (4, 2, {}),
    "d4-2x2-cells": (4, 2, {"graph_path": "cells"}),
}
# ranks: (batch rows, the JAX reference's name)
UPDATES = {2: 7, 4: 6}
# cases run through the programs' bodies (the default) that also run with
# graph=False, as "<case>-eager": the eager loops, their oracle
EAGER_TWINS = ("d2-env-dagger", "d4-2x2-dagger", "d2-agents", "d4-2x2",
               "collect-d2", "collect-d4")
# the collection episode held against JAX: N, T, S, hidden
CN, CT, CS, CHIDDEN = 64, 10, 16, (8,)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


def _start(d, cases_path, out_dir):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(d), str(port), str(cases_path),
         str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env=_env()) for r in range(d)]


def _wait(procs, timeout=TIMEOUT):
    """Every process's ``(returncode, stdout, stderr)``; kills the rest on
    a timeout."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


def _ok(results):
    for rc, _, err in results:
        assert rc == 0, err[-3000:]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(jp, path):
    return jln.LargeNConfig(
        params=jp, block=jln.pick_block(jp.n_agents), rows=jp.n_agents,
        axis=None, path=path,
        cell_spec=jpc.make_pcell_spec(jp) if path == "pcells" else None)


def _jax_collect(path, params, jcfg, key, beta=0.5, mode="dagger"):
    """The JAX ``_collect_episode`` at N = CN and the reset, coins and
    subsample indices of its key schedule (``imitation_large.py:151,
    206-207``)."""
    jp = jfl.FlockingParams(n_agents=CN, episode_steps=CT)
    cfg = _jax_cfg(jp, path)
    beta = jnp.float32(beta)
    samples, reward, ovf = jax.jit(
        lambda pp, kk, bb: jil._collect_episode(cfg, jcfg, mode, CS, CT, pp,
                                                kk, bb))(params, key, beta)
    reset_key, scan_key = jax.random.split(key)
    x0 = jax.jit(lambda k: jln._reset(cfg, k, centralized=True)[0])(
        reset_key)
    _, coin_keys, idx_keys = (jax.random.split(k, CT)
                              for k in jax.random.split(scan_key, 3))
    coins = jax.vmap(lambda k: jax.random.bernoulli(k, beta))(coin_keys)
    idx = jax.vmap(lambda k: jax.random.randint(k, (CS,), 0, CN))(idx_keys)
    draws = {"x0": np.array(x0), "coins": np.array(coins),
             "idx": np.array(idx).astype(np.int64)}
    return draws, samples, float(reward), int(ovf)


def _close(got, want, what="", rel=REL):
    """|got - want| <= rel * max|want| per channel (last axis)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    w2 = want.reshape(-1, want.shape[-1])
    scale = np.maximum(np.abs(w2).max(0), 1e-30)
    err = np.abs(got.reshape(w2.shape) - w2).max(0)
    assert (err <= rel * scale).all(), (what, err / scale)


def _torch_actor_file(params, path):
    layers = [{k: np.array(v) for k, v in layer.items()} for layer in params]
    torch.save(tim.actor_params_from_numpy(layers), path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at 2 and 4 ranks, the forced overflow at 2 and
    ``dryrun_multichip`` at 4, all started at once; while they run, the
    references of this process: the JAX collection episode, whose draws
    the ranks' last cases wait for, and the one-process learners."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield from _runs(tmp_path_factory.mktemp("dp"))
    finally:
        torch.set_num_threads(threads)


def _runs(tmp):
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=CHIDDEN, k=3)
    cparams = jac.init_actor(jax.random.key(0), jcfg)
    _torch_actor_file(cparams, tmp / "collect_actor.pt")
    ucfg = jac.ActorConfig(n_s=6, n_a=2, hidden=(8, 8), k=2)
    uparams = jac.init_actor(jax.random.key(1), ucfg)
    _torch_actor_file(uparams, tmp / "update_actor.pt")
    rng = np.random.default_rng(3)
    batches = {}
    for d, b in UPDATES.items():
        batches[d] = {
            "agg": rng.standard_normal((b, 2, 10, 6)).astype(np.float32),
            "act": rng.standard_normal((b, 10, 2)).astype(np.float32)}
        np.savez(tmp / f"batch{d}.npz", **batches[d])

    cases = {2: [], 4: []}
    for name, (d, n_env, kw) in DENSE_CASES.items():
        cases[d].append(dict(name=name, op="train", kind="dense",
                             n_env=n_env, cfg=dict(DENSE, **kw)))
    for name, (d, n_env, kw) in LARGE_CASES.items():
        cases[d].append(dict(name=name, op="train", kind="large",
                             n_env=n_env, cfg=dict(LARGE, **kw)))
    collect = dict(op="collect", env="FlockingRelative-v0", n=CN, steps=CT,
                   hidden=list(CHIDDEN), actor=str(tmp / "collect_actor.pt"),
                   draws=str(tmp / "draws.npz"), path="pcells",
                   mode="dagger")
    for d, b in UPDATES.items():
        cases[d].append(dict(name=f"update-d{d}", op="update", kind="dense",
                             n_env=d, cfg=dict(DENSE, batch_size=b,
                                               actor_lr=1e-3),
                             actor=str(tmp / "update_actor.pt"),
                             batch=str(tmp / f"batch{d}.npz")))
    cases[2] += [
        dict(name="guards", op="guards", n_env=2,
             dense=dict(DENSE, n_rollout_envs=3),
             large=dict(LARGE, n_rollout_envs=3)),
        dict(name="resume-dense", op="resume", kind="dense", n_env=2,
             cfg=dict(DENSE, mode="dagger")),
        dict(name="resume-large", op="resume", kind="large", n_env=2,
             cfg=LARGE),
    ]
    for d in UPDATES:      # last: they wait for the JAX draws
        cases[d].append(dict(name=f"collect-d{d}", n_env=1, n_dev=d,
                             **collect))
    for d in cases:
        cases[d] += [dict(c, name=f"{c['name']}-eager", graph=False)
                     for c in cases[d] if c["name"] in EAGER_TWINS]
    started = {}
    for d in (2, 4):
        (tmp / str(d)).mkdir()
        (tmp / f"cases{d}.json").write_text(json.dumps(cases[d]))
        started[d] = _start(d, tmp / f"cases{d}.json", tmp / str(d))
    (tmp / "ovf").mkdir()
    (tmp / "ovf.json").write_text(json.dumps([dict(
        name="overflow", op="overflow", kind="large", n_env=2, bad_rank=1,
        cfg=LARGE)]))
    ovf = {}

    def wait_ovf(procs, t0=time.perf_counter()):
        ovf["results"] = _wait(procs)
        ovf["seconds"] = time.perf_counter() - t0

    ovf_thread = threading.Thread(
        target=wait_ovf, args=(_start(2, tmp / "ovf.json", tmp / "ovf"),))
    ovf_thread.start()
    dryrun = subprocess.Popen(
        [sys.executable, "-m",
         "multiagent_gnn_policies_tpu_torch.scripts.dryrun_multichip",
         "--devices", "4", "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env=_env())

    # the references of this process, while the ranks run
    draws, jsamples, jreward, jovf = _jax_collect(
        "pcells", cparams, jcfg, jax.random.key(11))
    np.savez(tmp / "draws.tmp.npz", **draws)
    os.replace(tmp / "draws.tmp.npz", tmp / "draws.npz")
    refs = {}
    for name, (_, _, kw) in DENSE_CASES.items():
        lrn = worker.make_learner(
            "dense", worker.make_config("dense", dict(DENSE, **kw)), None)
        refs[name] = worker.learner_arrays(lrn, lrn.train())
    for name, (_, _, kw) in LARGE_CASES.items():
        cfg = dict(LARGE, **kw)
        same = next((n for n, (_, _, k) in LARGE_CASES.items()
                     if n in refs and k == kw), None)
        if same:
            refs[name] = refs[same]
            continue
        lrn = worker.make_learner(
            "large", worker.make_config("large", cfg), None)
        refs[name] = worker.learner_arrays(lrn, lrn.train())
    for d in UPDATES:
        refs[f"collect-d{d}"] = worker.collect(
            dict(collect, n_dev=d), None)

    ovf_thread.join()
    for d in (2, 4):
        _ok(_wait(started[d]))
    dry_out, dry_err = dryrun.communicate(timeout=TIMEOUT)
    yield {"dir": tmp, "refs": refs, "ovf": ovf["results"],
           "ovf_s": ovf["seconds"],
            "dryrun": (dryrun.returncode, dry_out, dry_err),
            "jax_collect": (jsamples, jreward, jovf),
            "update": (uparams, ucfg, batches)}


def _ranks(runs, d, name):
    return [np.load(runs["dir"] / str(d) / f"{name}_{r}.npz")
            for r in range(d)]


def _params(arrays):
    return {k: arrays[k] for k in arrays.keys() if k.startswith("param/")}


def _assert_ranks_equal(outs):
    for out in outs[1:]:
        assert out.keys() == outs[0].keys()
        for k in outs[0].keys():
            np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_dense_ranks_match_one_process(runs, name):
    d = DENSE_CASES[name][0]
    ref = runs["refs"][name]
    outs = _ranks(runs, d, name)
    _assert_ranks_equal(outs)
    got = outs[0]
    assert int(got["rounds"]) == 2
    for k, v in _params(ref).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    for k in ("buffer/agg", "buffer/act"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["buffer/agg"].shape[0] == 2 * 4 * 16
    np.testing.assert_allclose(got["mean"], ref["mean"], rtol=1e-6)
    np.testing.assert_allclose(got["loss_sum"], ref["loss_sum"], rtol=1e-6)


@pytest.mark.parametrize("name", list(LARGE_CASES))
def test_large_ranks_match_one_process(runs, name):
    d = LARGE_CASES[name][0]
    ref = runs["refs"][name]
    outs = _ranks(runs, d, name)
    _assert_ranks_equal(outs)
    got = outs[0]
    assert int(got["rounds"]) == 2
    assert got["buffer/agg"].shape == (2 * 2 * 10, 3, 16, 6)
    for k, v in _params(ref).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    for k in ("mean", "std", "loss_sum"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("d", sorted(UPDATES))
def test_sharded_update_matches_jax_adam(runs, d):
    """One Adam update (lr 1e-3) of a batch split unevenly over the ranks,
    against the JAX loss and ``optax.adam`` on the same parameters. A first
    Adam step moves each parameter by about lr * sign(g), so the summed
    gradient itself is also held against the JAX gradient."""
    params, jcfg, batches = runs["update"]
    batch = {k: jnp.asarray(v) for k, v in batches[d].items()}
    loss, grads = jax.value_and_grad(jim._loss_fn)(params, jcfg, batch)
    tx = optax.adam(1e-3)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = tim.actor_params_from_numpy(
        [{k: np.array(v) for k, v in layer.items()}
         for layer in optax.apply_updates(params, updates)])
    want_grad = tim.actor_params_from_numpy(
        [{k: np.array(v) for k, v in layer.items()} for layer in grads])
    outs = _ranks(runs, d, f"update-d{d}")
    _assert_ranks_equal(outs)
    for k, v in want_grad.items():
        np.testing.assert_allclose(outs[0][f"grad/{k}"], v.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for k, v in want.items():
        np.testing.assert_allclose(outs[0][f"param/{k}"], v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(outs[0]["loss"]), float(loss),
                               rtol=1e-6)


def test_jax_sharded_learner_takes_an_uneven_batch():
    """What the port's uneven split copies: the JAX learner on the virtual
    CPU mesh with a batch of 6 over an env axis of 4 runs, and matches the
    single-device learner."""
    from multiagent_gnn_policies_tpu.parallel.mesh import make_mesh
    from multiagent_gnn_policies_tpu.parallel.sharded import (
        ShardedImitationLearner)

    def cfg():
        return jim.ImitationConfig(
            mode="cloning",
            actor=jac.ActorConfig(n_s=6, n_a=2, hidden=(8, 8), k=2),
            env_name="FlockingRelative-v0",
            env=jfl.FlockingParams(n_agents=10, episode_steps=16),
            batch_size=6, buffer_size=256, updates_per_episode=4,
            n_train_episodes=4, test_interval=4, n_test_episodes=2,
            n_rollout_envs=4, seed=0)

    a = ShardedImitationLearner(cfg(), make_mesh(n_env=4, n_agent_shards=2))
    b = jim.ImitationLearner(cfg())
    a.train()
    b.train()
    for la, lb in zip(a.params, b.params):
        np.testing.assert_allclose(np.asarray(la["w"]), np.asarray(lb["w"]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", sorted(UPDATES))
def test_rank_collection_equals_one_process_and_jax(runs, d):
    """A D-rank ``collect_episode`` from injected draws: bit for bit the
    one-process episode on the same grid (``make_pcell_spec(n_dev=D)``),
    and within 1e-4 of the JAX ``_collect_episode`` from the same key."""
    ref = runs["refs"][f"collect-d{d}"]
    outs = _ranks(runs, d, f"collect-d{d}")
    _assert_ranks_equal(outs)
    for k, v in ref.items():
        np.testing.assert_array_equal(outs[0][k], v, err_msg=k)
    jsamples, jreward, jovf = runs["jax_collect"]
    assert int(outs[0]["overflow"]) == jovf == 0
    _close(outs[0]["agg"], jsamples["agg"], "agg")
    _close(outs[0]["act"], jsamples["act"], "act")
    _close([float(outs[0]["reward"])], [jreward], "reward")


@pytest.mark.parametrize("name", EAGER_TWINS)
def test_rank_programs_equal_their_eager_twins(runs, name):
    """Every rank's round (collection, insert, updates with their gradient
    ``all_reduce``, eval) or collection episode through the programs'
    bodies equals the ``graph=False`` twin's eager loops bit for bit."""
    d = int(name[1]) if name[0] == "d" else int(name[-1])
    for prog, eager in zip(_ranks(runs, d, name),
                           _ranks(runs, d, f"{name}-eager"), strict=True):
        assert prog.files == eager.files
        for k in prog.files:
            np.testing.assert_array_equal(prog[k], eager[k], err_msg=k)


def test_both_learners_refuse_an_env_axis_that_does_not_divide(runs):
    for out in _ranks(runs, 2, "guards"):
        assert "divide evenly" in str(out["dense"])
        assert "n_rollout_envs=3 not divisible by mesh env axis 2" in str(
            out["dense"])
        assert "must divide evenly over the mesh env axis (2)" in str(
            out["large"])


def test_overflow_on_one_rank_stops_every_rank(runs):
    """Rank 1's collection reports an overflow: after the MAX over the
    mesh every rank raises the gate's error, long before the collective
    timeout."""
    assert runs["ovf_s"] < OVERFLOW_S, runs["ovf_s"]
    for rc, _, err in runs["ovf"]:
        assert rc != 0
        assert "neighbor-structure overflow=1 during collection" in err, (
            err[-2000:])


@pytest.mark.parametrize("name,train", [("resume-dense", "d2-env-dagger"),
                                        ("resume-large", "d2-env")])
def test_two_rank_resume_equals_uninterrupted(runs, name, train):
    outs = _ranks(runs, 2, name)
    _assert_ranks_equal(outs)
    want = _ranks(runs, 2, train)[0]
    assert outs[0].keys() == want.keys()
    for k in want.keys():
        np.testing.assert_array_equal(outs[0][k], want[k], err_msg=k)
    # rank 0 alone logs the resumed run's events
    logs = [(runs["dir"] / "2" / f"{name}_metrics_{r}.jsonl").read_text()
            for r in range(2)]
    events = [json.loads(line)["event"] for line in logs[0].splitlines()]
    assert events[0] == "resume" and events[-2:] == ["final_eval", "timing"]
    assert logs[1] == ""


def test_dryrun_multichip_four_ranks(runs):
    rc, out, err = runs["dryrun"]
    assert rc == 0, err[-3000:]
    assert re.search(r"dryrun_multichip OK: 4 ranks \(cpu\), mesh env=2 x "
                     r"agents=2, .* over 2x2 \(env,agents\) == "
                     r"single-process params", out), out


@pytest.mark.parametrize("mode", ["dagger", "cloning"])
def test_blocked_collection_matches_jax(mode):
    """``graph_path = "blocked"``: a collecting episode through the O(N²)
    row-blocked sweeps against the JAX learner's blocked
    ``_collect_episode`` at N = 64 from the same draws; it launches no
    cell sweep."""
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=CHIDDEN, k=3)
    params = jac.init_actor(jax.random.key(2), jcfg)
    draws, samples, reward, ovf = _jax_collect(
        "blocked", params, jcfg, jax.random.key(13), mode=mode)
    tcfg = tac.ActorConfig(n_s=6, n_a=2, hidden=CHIDDEN, k=3)
    actor = tac.Actor(tcfg)
    actor.load_state_dict(tim.actor_params_from_numpy(
        [{k: np.array(v) for k, v in layer.items()} for layer in params]))
    cfg = tln.make_config(tfl.FlockingParams(n_agents=CN, episode_steps=CT),
                          path="blocked", centralized=True, need_expert=True)
    tcc.reset_launch_counts()
    got, got_reward, got_ovf = til.collect_episode(
        cfg, actor, tcfg, mode, CS, None, 0.5, "cpu",
        x0=torch.from_numpy(draws["x0"]),
        coins=torch.from_numpy(draws["coins"]) if mode == "dagger" else None,
        idx=torch.from_numpy(draws["idx"]))
    assert int(got_ovf) == ovf == 0
    assert not any(tcc.launch_counts().values())
    _close(got["agg"], samples["agg"], "agg")
    _close(got["act"], samples["act"], "act")
    _close([float(got_reward)], [reward], "reward")


CLI_CFG = """
[DEFAULT]
alg = dagger
env = FlockingRelative-v0
seed = 3
header = reward
batch_size = 8
buffer_size = 200
updates_per_step = 4
n_train_episodes = 1
test_interval = 1
n_test_episodes = 2
k = 2
hidden_size = 8
n_agents = 10
episode_steps = 10

[run]
"""

CLI_PROBE = """
import sys
import torch.distributed as dist
from multiagent_gnn_policies_tpu_torch import train
train.main(sys.argv[1:])
print("GROUP", dist.is_initialized(),
      dist.get_world_size() if dist.is_initialized() else 0)
"""


def test_train_cli_joins_a_group_only_when_asked(tmp_path):
    """Without the ``MAGNN_*`` variables the CLI stays one process; with a
    world of one (gloo, ``--device cpu``) it initialises the group first
    and prints the same CSV."""
    cfg = tmp_path / "exp.cfg"
    cfg.write_text(CLI_CFG)
    env = {k: v for k, v in _env().items() if not k.startswith("MAGNN_")}
    argv = [sys.executable, "-c", CLI_PROBE, str(cfg), "--device", "cpu"]
    alone = subprocess.run(argv, capture_output=True, text=True,
                           cwd=tmp_path, env=env, timeout=TIMEOUT)
    assert alone.returncode == 0, alone.stderr[-3000:]
    assert alone.stdout.splitlines()[-1] == "GROUP False 0"
    one = subprocess.run(argv, capture_output=True, text=True, cwd=tmp_path,
                         timeout=TIMEOUT, env=dict(
                             env, MAGNN_COORDINATOR=f"127.0.0.1:"
                             f"{_free_port()}", MAGNN_NUM_PROCESSES="1",
                             MAGNN_PROCESS_ID="0"))
    assert one.returncode == 0, one.stderr[-3000:]
    assert one.stdout.splitlines()[-1] == "GROUP True 1"
    assert one.stdout.splitlines()[:-1] == alone.stdout.splitlines()[:-1]
    assert alone.stdout.splitlines()[1].startswith("run, ")
