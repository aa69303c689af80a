"""The port's compiled imitation round on the CPU, where each program runs
the body it captures on the card eagerly:

* the replay buffer's sample, which masks with a device copy of ``size``,
  draws the slots the host-int mask draws, bit for bit, from an empty,
  partly filled, full and wrapped buffer, and the JAX package's
  ``replay_sample`` draws on the same uniforms;
* the update program (``algos/imitation.py:UpdateProgram``) equals the
  loop of ``adam_update`` on ``buffer.sample`` bit for bit (parameters,
  Adam's state, the loss sum, the generator), at a dense and a
  subsampled record shape, and meets ``optax.adam`` on the same batches
  within the tolerance of ``test_adam_updates_match_optax``;
* the dense episode program equals the eager loop of ``rollout_episode``
  (``graph=False``) bit for bit in the dagger, cloning and eval modes,
  the baseline's expert episode and the stochastic variant, the
  generator's state after the episode included;
* the learners' rounds through their programs equal the eager rounds,
  a learner that has stepped resumes a state file into the uninterrupted
  run's state, and ``graph=True`` raises on the CPU (on a mesh too, where
  the learners build their programs) and, for the large learner, off the
  pcells path.

Tolerance against optax: 1e-6 of each tensor's largest magnitude;
everything else exactly.
"""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from multiagent_gnn_policies_tpu.algos import imitation as jim
from multiagent_gnn_policies_tpu.algos import replay as jrp
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu_torch.algos import imitation as tim
from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
from multiagent_gnn_policies_tpu_torch.algos.replay import ReplayBuffer
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import torch_import as tti
from multiagent_gnn_policies_tpu_torch.parallel import distributed as tdist
from multiagent_gnn_policies_tpu_torch.parallel import mesh as tmesh
from multiagent_gnn_policies_tpu_torch.parallel.sharded import (
    ShardedImitationLearner,
)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the replay sample ------------------------------------------------------

def _copy(gen):
    g = torch.Generator()
    g.set_state(gen.get_state())
    return g


def _host_int_sample(buf, gen, batch):
    """The sample as the buffer took it with the host int alone."""
    u = torch.rand(buf.capacity, generator=gen)
    u[buf.size:] = float("-inf")
    return torch.topk(u, batch).indices


@pytest.mark.parametrize("fill", [0, 5, 16, 23],
                         ids=["empty", "partly", "full", "wrapped"])
def test_device_size_sample_draws_the_host_int_slots(fill, monkeypatch):
    cap, batch = 16, 4
    buf = ReplayBuffer(cap, {"i": torch.zeros((), dtype=torch.int64)})
    for start in range(0, fill, 9):
        t = min(9, fill - start)
        buf.insert({"i": torch.arange(start, start + t)})
    assert buf.size == min(fill, cap) and int(buf._size_dev) == buf.size
    gen = torch.Generator().manual_seed(fill)
    for _ in range(5):
        want_gen, u_gen = _copy(gen), _copy(gen)
        u = torch.rand(cap, generator=u_gen)
        want = _host_int_sample(buf, want_gen, batch)
        got = buf.sample(gen, batch)["i"]
        np.testing.assert_array_equal(got.numpy(),
                                      buf.data["i"][want].numpy())
        assert torch.equal(gen.get_state(), want_gen.get_state())
        jbuf = jrp.ReplayBuffer(data={"i": jnp.asarray(buf.data["i"])},
                                size=jnp.asarray(buf.size),
                                cursor=jnp.asarray(buf.cursor))
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape: jnp.asarray(u.numpy()))
        jgot = jrp.replay_sample(jbuf, jax.random.key(0), batch)["i"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    buf.size = 2                     # the setter moves the device copy too
    assert int(buf._size_dev) == 2
    assert set(buf.sample(gen, 2)["i"].tolist()) == set(
        buf.data["i"][:2].tolist())


# --- the update program -----------------------------------------------------

def _learner_parts(record, seed=0):
    """A JAX-initialised actor, its Adam and a buffer of numpy-drawn
    records of shape ``record`` (K, M, F)."""
    k, m, f = record
    jcfg = jac.ActorConfig(n_s=f, n_a=2, hidden=(16, 16), k=k)
    tcfg = tac.ActorConfig(n_s=f, n_a=2, hidden=(16, 16), k=k)
    params = jac.init_actor(jax.random.key(seed), jcfg)
    actor = tac.Actor(tcfg)
    actor.load_state_dict(tti.actor_params_from_numpy(
        [{key: np.asarray(v) for key, v in layer.items()}
         for layer in params]))
    opt = torch.optim.Adam(actor.parameters(), lr=1e-3)
    rng = np.random.default_rng(seed + 1)
    buf = ReplayBuffer(24, {"agg": torch.zeros(record),
                            "act": torch.zeros((m, 2))})
    buf.insert({"agg": torch.from_numpy(
        rng.normal(size=(18, *record)).astype(np.float32)),
        "act": torch.from_numpy(rng.normal(size=(18, m, 2)).astype(
            np.float32))})
    return jcfg, params, actor, opt, buf


def _adam_tree(actor, opt):
    return [{k: v.clone() for k, v in opt.state[p].items()}
            for p in actor.parameters()]


@pytest.mark.parametrize("record", [(3, 10, 6), (3, 16, 6)],
                         ids=["dense", "subsampled"])
def test_update_program_equals_the_adam_update_loop(record):
    n, batch = 6, 5
    _, _, actor, opt, buf = _learner_parts(record)
    _, _, actor2, opt2, buf2 = _learner_parts(record)
    gen, gen2 = (torch.Generator().manual_seed(3) for _ in range(2))
    prog = tim.UpdateProgram(actor, opt, buf, batch, "cpu")
    got = prog.run(n, gen)
    want = torch.zeros(())
    for _ in range(n):
        want += tim.adam_update(actor2, opt2, buf2.sample(gen2, batch))
    assert torch.equal(got, want)
    for a, b in zip(actor.parameters(), actor2.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(_adam_tree(actor, opt), _adam_tree(actor2, opt2)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
    assert torch.equal(gen.get_state(), gen2.get_state())
    # a second run starts its loss sum anew
    again = prog.run(1, gen)
    assert torch.equal(again, tim.adam_update(actor2, opt2,
                                              buf2.sample(gen2, batch)))


def test_update_program_meets_optax_on_the_same_batches():
    n, batch = 5, 6
    jcfg, params, actor, opt, buf = _learner_parts((3, 10, 6), seed=4)
    gen = torch.Generator().manual_seed(9)
    draws = _copy(gen)
    batches = [buf.sample(draws, batch) for _ in range(n)]
    tim.UpdateProgram(actor, opt, buf, batch, "cpu").run(n, gen)
    tx = optax.adam(1e-3)
    jopt = tx.init(params)
    for b in batches:
        grads = jax.grad(jim._loss_fn)(
            params, jcfg, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        upd, jopt = tx.update(grads, jopt)
        params = optax.apply_updates(params, upd)
    got = tti.actor_numpy_from_params(actor.state_dict(), actor.cfg)
    for g, w in zip(got, params):
        for name in ("w", "b"):
            want = np.asarray(w[name])
            err = np.abs(g[name] - want).max() / np.abs(want).max()
            assert err <= 1e-6, (name, err)


# --- the dense episode program ----------------------------------------------

N, T = 10, 8


def _env(name="FlockingRelative-v0"):
    return tfl.make_env(name, tfl.FlockingParams(n_agents=N, episode_steps=T))


@pytest.mark.parametrize("mode,env,centralized", [
    ("dagger", "FlockingRelative-v0", True),
    ("cloning", "FlockingRelative-v0", True),
    ("eval", "FlockingRelative-v0", True),
    ("expert", "FlockingRelative-v0", True),
    ("expert", "FlockingRelative-v0", False),
    ("dagger", "FlockingStochastic-v0", True),
    ("eval", "FlockingStochastic-v0", True),
], ids=["dagger", "cloning", "eval", "baseline", "baseline_decentralized",
        "stochastic_dagger", "stochastic_eval"])
def test_dense_program_equals_the_eager_loop(mode, env, centralized):
    acfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(8,), k=3)
    actor = tac.init_actor_(tac.Actor(acfg), torch.Generator().manual_seed(1))
    collect = mode in ("dagger", "cloning")
    out = {}
    for graph in (False, None, None):    # eager, the program twice
        gen = torch.Generator().manual_seed(7)
        res = tim.rollout_episode(
            actor, gen, 0.5, _env(env), acfg, mode=mode, collect=collect,
            n_envs=3, centralized=centralized, graph=graph)
        res = res if collect else ({}, res)
        out.setdefault(graph, []).append((res, gen.get_state()))
    (want, want_gen), = out[False]
    assert want[1].shape == (3,)
    for (got, got_gen) in out[None]:
        assert got[0].keys() == want[0].keys()
        for k in want[0]:
            assert torch.equal(got[0][k], want[0][k]), k
        assert torch.equal(got[1], want[1])
        assert torch.equal(got_gen, want_gen)
    if collect:
        assert want[0]["agg"].shape == (3 * T, 3, N, 6)


def test_baseline_runs_the_expert_mode():
    from multiagent_gnn_policies_tpu_torch.algos import baseline as tbs
    from multiagent_gnn_policies_tpu_torch.utils.config import (
        ExperimentConfig)

    cfg = ExperimentConfig(alg="baseline", n_agents=N, episode_steps=T,
                           n_test_episodes=3, seed=2, centralized=False)
    stats = tbs.train_baseline(cfg, device="cpu")
    r = tim.rollout_episode(None, torch.Generator().manual_seed(2), 0.0,
                            _env(), None, mode="expert", collect=False,
                            n_envs=3, centralized=False, graph=False).numpy()
    assert stats == {"mean": float(r.mean()), "std": float(r.std())}


def test_dense_program_refusals():
    acfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(8,), k=3)
    actor = tac.Actor(acfg)
    gen = torch.Generator().manual_seed(0)
    for kw, match in ((dict(mode="eval", graph=True), "on the CPU"),
                      (dict(mode="walk"), "unknown episode mode"),
                      (dict(mode="eval", collect=True), "collects no"),
                      (dict(mode="dagger", graph="yes"), "must be None")):
        with pytest.raises(ValueError, match=match):
            tim.rollout_episode(actor, gen, 0.5, _env(), acfg,
                                **{"collect": False, **kw})
    # a data-parallel rank's slice of the envs runs its program too: on
    # the CPU a graph of it raises as any other
    sliced = tfl.FlockingEnv(_env().params, env_range=(0, 2))
    with pytest.raises(ValueError, match="on the CPU"):
        tim.rollout_episode(actor, gen, 0.5, sliced, acfg, mode="eval",
                            collect=False, graph=True)
    with pytest.raises(ValueError, match="needs an actor"):
        tim.rollout_episode(None, gen, 0.5, _env(), acfg, mode="eval",
                            collect=False)


# --- the learners' rounds ---------------------------------------------------

def _dense_cfg(**kw):
    d = dict(mode="dagger", actor=tac.ActorConfig(n_s=6, n_a=2, hidden=(8,),
                                                  k=2),
             env_name="FlockingStochastic-v0",
             env=tfl.FlockingParams(n_agents=N, episode_steps=T),
             batch_size=4, buffer_size=40, updates_per_episode=3,
             actor_lr=1e-3, n_train_episodes=6, test_interval=2,
             n_test_episodes=2, n_rollout_envs=2, seed=3)
    d.update(kw)
    return tim.ImitationConfig(**d)


def _large_cfg():
    return til.LargeNImitationConfig(
        mode="dagger", actor=tac.ActorConfig(n_s=6, n_a=2, hidden=(8,), k=3),
        env_name="FlockingRelative-v0",
        env=tfl.FlockingParams(n_agents=40, episode_steps=6), batch_size=4,
        buffer_size=40, updates_per_episode=3, actor_lr=1e-3,
        n_train_episodes=3, test_interval=2, n_test_episodes=1, seed=5,
        store_agents=12)


def _state(lrn):
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}")
            else:
                out[f"{path}/{k}"] = np.asarray(
                    v.detach().numpy() if isinstance(v, torch.Tensor) else v)
    walk(lrn.training_state(), "")
    return out


def _same(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("large", [False, True], ids=["dense", "large"])
def test_program_rounds_equal_eager_rounds(large):
    make = ((lambda g: til.LargeNImitationLearner(_large_cfg(), device="cpu",
                                                  graph=g)) if large else
            (lambda g: tim.ImitationLearner(_dense_cfg(), device="cpu",
                                            graph=g)))
    prog, eager = make(None), make(False)
    assert prog._updates is not None and eager._updates is None
    stats = prog.train()
    assert eager.train() == stats
    assert torch.equal(prog.last_loss_sum, eager.last_loss_sum)
    _same(prog, eager)


def test_a_learner_that_stepped_resumes_in_place(tmp_path):
    """Loading a state file into a learner whose Adam already holds state
    writes it in place (a captured update reads it by address); the
    resumed run equals the uninterrupted one."""
    state = str(tmp_path / "state.npz")
    full = tim.ImitationLearner(_dense_cfg(), device="cpu")
    full.train()
    part = tim.ImitationLearner(_dense_cfg(), device="cpu")
    part.train(state_path=state, stop_after=2)
    rest = tim.ImitationLearner(_dense_cfg(seed=8), device="cpu")
    rest.train(stop_after=1)
    held = lambda: [t.data_ptr() for p in rest.actor.parameters()
                    for t in rest.opt.state[p].values()]
    moments = held()
    rest.load_training_state(state)
    assert held() == moments
    assert rest._rnd == 2 and int(rest.buffer._size_dev) == rest.buffer.size
    rest.train(state_path=state)
    _same(full, rest)


def test_graph_true_raises_on_the_cpu_and_on_a_mesh():
    """``graph=True`` raises on the CPU, with a mesh or without, on the
    pcells path and off it (a program runs on every path on the card); on
    a mesh ``graph=None`` builds the programs, the update program over the
    learner's own update with its collective."""
    with pytest.raises(ValueError, match="on the CPU"):
        tim.ImitationLearner(_dense_cfg(), device="cpu", graph=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.initialize_distributed(f"127.0.0.1:{port}", 1, 0, platform="cpu")
    try:
        mesh = tmesh.make_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="on the CPU"):
            ShardedImitationLearner(_dense_cfg(), mesh, device="cpu",
                                    graph=True)
        with pytest.raises(ValueError, match="on the CPU"):
            til.LargeNImitationLearner(
                dataclasses.replace(_large_cfg(), graph_path="blocked"),
                device="cpu", mesh=mesh, graph=True)
        lrn = ShardedImitationLearner(_dense_cfg(), mesh, device="cpu")
        assert lrn._graph is None
        assert lrn._updates.update == lrn._update
    finally:
        dist.destroy_process_group()
