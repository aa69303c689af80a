"""The port's large-N imitation path against the JAX package's: an
expert-mode ``rollout_large`` episode (centralized and decentralized) and
a collection episode (cloning and DAGGER) of ``algos/imitation_large.py``,
both on the "pcells" path with the Pallas kernels in interpret mode, and
the collection episode on the "cells" and "binned" paths; then the port's
``LargeNImitationLearner`` on its own (buffer shapes, the update gate,
several envs a round, rounds on the cells and binned paths, the overflow
gate, the eval refusal, resume bit for bit with and without the buffer,
the export read by both packages), the sweeps each episode runs, and the
config rules.

jax.random and torch generators give different numbers, so the port is
handed what the JAX side drew: the reset's state (``x0``) and, for
collection, the coins and subsample indices of the JAX key schedule.
Tolerance: 1e-4 of each channel's largest magnitude for whole episodes
(float32 on both sides, summed in different orders, carried through the
closed loop), 1e-5 for the exported actor's actions; overflow counts,
resumes and shapes exactly.
"""

import dataclasses
import functools
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiagent_gnn_policies_tpu.algos import imitation_large as jil
from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.ops import cells as jcl
from multiagent_gnn_policies_tpu.ops import pallas_cells as jpc
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu.utils import checkpoint as jck
from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import torch_import as tti
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc
from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
from multiagent_gnn_policies_tpu_torch.utils import checkpoint as tck
from multiagent_gnn_policies_tpu_torch.utils.config import ExperimentConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The torch side on one thread: under the suite's xdist workers its
    intra-op threads oversubscribe the cores (the port's small ops ran
    ~20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REL = 1e-4
N, T, S = 48, 12, 16


def _close(got, want, what="", rel=REL):
    """|got - want| <= rel * max|want| per channel (last axis)."""
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    w2 = want.reshape(-1, want.shape[-1]) if want.ndim > 1 else want[:, None]
    scale = np.maximum(np.abs(w2).max(0), 1e-30)
    err = np.abs(got.reshape(w2.shape) - w2).max(0)
    assert (err <= rel * scale).all(), (what, err / scale)


def _jax_cfg(p, path="pcells"):
    spec = {"pcells": lambda: jpc.make_pcell_spec(p),
            "cells": lambda: jcl.make_cell_spec(p, cap=12),
            "binned": lambda: None}[path]()
    return jln.LargeNConfig(params=p, block=p.n_agents, rows=p.n_agents,
                            axis=None, path=path, cell_spec=spec)


def _port_cfg(p):
    return tln.LargeNConfig(params=p, cell_spec=tcc.make_pcell_spec(p),
                            centralized=True, need_expert=True)


@pytest.mark.parametrize("centralized", [True, False],
                         ids=["centralized", "decentralized"])
def test_expert_episode_matches_jax(centralized):
    """``rollout_large(expert_mode=True)``: the analytic controller rolled
    through a grid build and K1 per step, from the JAX reset."""
    jp = jfl.FlockingParams(n_agents=N, episode_steps=T)
    tp = tfl.FlockingParams(n_agents=N, episode_steps=T)
    key = jax.random.key(7)
    jr, jx, jovf = jln.rollout_large(None, None, key, jp, expert_mode=True,
                                     centralized_expert=centralized,
                                     path="pcells", return_overflow=True)
    reset_key, _ = jax.random.split(key)
    x0 = jax.jit(lambda k: jln._reset(_jax_cfg(jp), k,
                                      centralized=centralized)[0])(reset_key)
    tr, tx, tovf = tln.rollout_large(
        None, None, None, tp, centralized_expert=centralized,
        return_overflow=True, x0=torch.from_numpy(np.array(x0)),
        device="cpu", expert_mode=True)
    assert int(tovf) == int(jovf) == 0
    assert tr.shape == (T,)
    _close(tr, jr, "rewards")
    _close(tx, jx, "final state")


def _jax_draws(path="pcells"):
    """The reset, coins and subsample indices that the JAX
    ``_collect_episode`` draws for the collection tests' key 11 and beta
    0.5 (its key schedule, ``imitation_large.py:151, 206-207``) on
    ``path``; each path's drawn once per module (both modes draw alike),
    each caller given its own copies."""
    return tuple(torch.from_numpy(a.copy()) for a in _jax_draws_np(path))


@functools.lru_cache(maxsize=None)
def _jax_draws_np(path):
    jp = jfl.FlockingParams(n_agents=N, episode_steps=T)
    key, beta = jax.random.key(11), jnp.float32(0.5)
    reset_key, scan_key = jax.random.split(key)
    x0 = jax.jit(lambda k: jln._reset(_jax_cfg(jp, path), k,
                                      centralized=True)[0])(reset_key)
    _, coin_keys, idx_keys = (jax.random.split(k, T)
                              for k in jax.random.split(scan_key, 3))
    coins = jax.vmap(lambda k: jax.random.bernoulli(k, beta))(coin_keys)
    idx = jax.vmap(lambda k: jax.random.randint(k, (S,), 0, N))(idx_keys)
    return np.array(x0), np.array(coins), np.array(idx).astype(np.int64)


@pytest.mark.parametrize("mode", ["dagger", "cloning"])
def test_collection_episode_matches_jax(mode):
    """One collecting episode of an actor drawn by the JAX ``init_actor``:
    the subsampled features and labels, the summed reward and the
    overflow, against the JAX ``_collect_episode`` at ``graph_path =
    "pcells"`` with the same reset, coins and indices."""
    jp = jfl.FlockingParams(n_agents=N, episode_steps=T)
    tp = tfl.FlockingParams(n_agents=N, episode_steps=T)
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=(16, 16), k=3)
    tcfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(16, 16), k=3)
    params = jac.init_actor(jax.random.key(0), jcfg)
    key, beta = jax.random.key(11), jnp.float32(0.5)
    samples, reward, ovf = jax.jit(
        lambda pp, kk, bb: jil._collect_episode(_jax_cfg(jp), jcfg, mode, S,
                                                T, pp, kk, bb)
    )(params, key, beta)
    x0, coins, idx = _jax_draws()
    if mode == "dagger":
        assert 0 < int(coins.sum()) < T        # both branches taken
    actor = tac.Actor(tcfg)
    actor.load_state_dict(tti.actor_params_from_numpy(
        [{k: np.array(v) for k, v in layer.items()} for layer in params]))
    got, got_reward, got_ovf = til.collect_episode(
        _port_cfg(tp), actor, tcfg, mode, S, None, 0.5, "cpu", x0=x0,
        coins=coins if mode == "dagger" else None, idx=idx)
    assert int(got_ovf) == int(ovf) == 0
    assert got["agg"].shape == (T, 3, S, 6) and got["act"].shape == (T, S, 2)
    _close(got["agg"], samples["agg"], "agg")
    _close(got["act"], samples["act"], "act")
    _close(got_reward.reshape(1), np.asarray(reward).reshape(1), "reward")


@pytest.mark.parametrize("mode", ["dagger", "cloning"])
@pytest.mark.parametrize("path", ["cells", "binned"])
def test_cells_and_binned_collection_matches_jax(path, mode):
    """One collecting episode on the cells or binned path against the JAX
    ``_collect_episode`` of the same path (the JAX learner's cap: 12 cells,
    32 binned), from the same reset, coins, indices and weights as the
    pcells case above: the subsampled features and labels, the summed
    reward and the overflow."""
    jp = jfl.FlockingParams(n_agents=N, episode_steps=T)
    tp = tfl.FlockingParams(n_agents=N, episode_steps=T)
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=(16, 16), k=3)
    tcfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(16, 16), k=3)
    params = jac.init_actor(jax.random.key(0), jcfg)
    key, beta = jax.random.key(11), jnp.float32(0.5)
    samples, reward, ovf = jax.jit(
        lambda pp, kk, bb: jil._collect_episode(
            _jax_cfg(jp, path), jcfg, mode, S, T, pp, kk, bb)
    )(params, key, beta)
    x0, coins, idx = _jax_draws(path)
    actor = tac.Actor(tcfg)
    actor.load_state_dict(tti.actor_params_from_numpy(
        [{k: np.array(v) for k, v in layer.items()} for layer in params]))
    got, got_reward, got_ovf = til.collect_episode(
        tln.make_config(tp, path=path, centralized=True, need_expert=True),
        actor, tcfg, mode, S, None, 0.5, "cpu", x0=x0,
        coins=coins if mode == "dagger" else None, idx=idx)
    assert int(got_ovf) == int(ovf) == 0
    assert got["agg"].shape == (T, 3, S, 6) and got["act"].shape == (T, S, 2)
    _close(got["agg"], samples["agg"], "agg")
    _close(got["act"], samples["act"], "act")
    _close(got_reward.reshape(1), np.asarray(reward).reshape(1), "reward")


def test_episodes_run_each_sweep_as_the_main_path_counts_it(monkeypatch):
    """A collecting episode of T steps calls K1 T+1 times and K2 and K3 T
    times each, as an eval episode does; an expert-mode episode calls K1
    T+1 times and never K2 or K3. On the CPU the wrappers route to the
    plain versions, counted here."""
    calls = {"frame": 0, "apply_deg": 0, "apply": 0}
    for name in calls:
        plain = getattr(tcc, f"{name}_sweep_plain")

        def counted(*a, _name=name, _plain=plain, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(tcc, f"{name}_sweep_plain", counted)
    steps = 5
    tp = tfl.FlockingParams(n_agents=600, episode_steps=steps)
    tcfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(8,), k=3)
    actor = tac.init_actor_(tac.Actor(tcfg), torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    samples, r, ovf = til.collect_episode(_port_cfg(tp), actor, tcfg,
                                          "dagger", 32, gen, 0.5, "cpu")
    assert int(ovf) == 0 and torch.isfinite(r)
    assert samples["agg"].shape == (steps, 3, 32, 6)
    assert calls == {"frame": steps + 1, "apply_deg": steps, "apply": steps}
    calls.update(frame=0, apply_deg=0, apply=0)
    r, _, ovf = tln.rollout_large(None, None, gen, tp, return_overflow=True,
                                  device="cpu", expert_mode=True)
    assert int(ovf) == 0 and torch.isfinite(r).all()
    assert calls == {"frame": steps + 1, "apply_deg": 0, "apply": 0}


# --- the learner ------------------------------------------------------------

def _cfg(mode="dagger", **kw):
    d = dict(mode=mode, actor=tac.ActorConfig(n_s=6, n_a=2, hidden=(8,), k=3),
             env_name="FlockingRelative-v0",
             env=tfl.FlockingParams(n_agents=40, episode_steps=6),
             batch_size=4, buffer_size=40, updates_per_episode=3,
             actor_lr=1e-3, n_train_episodes=4, test_interval=2,
             n_test_episodes=1, seed=5, store_agents=12)
    d.update(kw)
    return til.LargeNImitationConfig(**d)


def test_from_experiment_store_agents_rule():
    x = ExperimentConfig(n_agents=5000, alg="dagger")
    c = til.LargeNImitationConfig.from_experiment(x)
    assert c.store_agents == 4096 and c.graph_path == "auto"
    assert c.mode == "dagger" and c.env.n_agents == 5000 and c.actor.k == x.k
    small = dataclasses.replace(x, n_agents=300)
    assert til.LargeNImitationConfig.from_experiment(small).store_agents == 300
    capped = dataclasses.replace(x, n_agents=300, store_agents=512,
                                 graph_path="pcells", cell_cap=32)
    c2 = til.LargeNImitationConfig.from_experiment(capped, mode="cloning")
    assert (c2.store_agents, c2.graph_path, c2.cell_cap, c2.mode) == (
        300, "pcells", 32, "cloning")


@pytest.mark.parametrize("path", ["cells", "binned"])
def test_cells_and_binned_learner_rounds(monkeypatch, path):
    """Two rounds on the cells or binned path: the buffer and update gate
    as on the pcells path, a finite loss and eval, the JAX learner's cap
    (cells ``cell_cap`` or 12; binned 32, whatever ``cell_cap`` says), and
    no cell sweep called (the plain versions, counted on the CPU)."""
    calls = []
    for name in ("frame", "apply_deg", "apply"):
        monkeypatch.setattr(tcc, f"{name}_sweep_plain",
                            lambda *a, _n=name, **k: calls.append(_n))
    lrn = til.LargeNImitationLearner(
        _cfg(graph_path=path, batch_size=6, cell_cap=8), device="cpu")
    assert lrn._lcfg.path == path
    if path == "cells":
        assert lrn._lcfg.cell_spec.cap == 8
    else:
        assert lrn._lcfg.cap == 32 and lrn._lcfg.cell_spec is None
    stats = lrn.train(stop_after=2)
    assert lrn.buffer.size == 12 and lrn.timing["updates"] == 3
    assert float(lrn.last_loss_sum) > 0.0 and np.isfinite(stats["mean"])
    assert calls == []
    with pytest.raises(ValueError, match="unknown graph_path"):
        til.LargeNImitationLearner(_cfg(graph_path="sparse"), device="cpu")


def test_buffer_holds_subsampled_records_and_updates_wait_for_a_batch():
    """Records are (K, S, F) and (S, 2); no update while the buffer holds
    at most one batch (round 1: 6 records, batch 6), then
    ``updates_per_episode`` a round."""
    lrn = til.LargeNImitationLearner(_cfg(batch_size=6), device="cpu")
    assert lrn.buffer.data["agg"].shape == (40, 3, 12, 6)
    assert lrn.buffer.data["act"].shape == (40, 12, 2)
    before = {k: v.clone() for k, v in lrn.actor.state_dict().items()}
    lrn.train(stop_after=1)
    assert lrn.buffer.size == 6 and lrn.timing["updates"] == 0
    assert float(lrn.last_loss_sum) == 0.0
    for k, v in lrn.actor.state_dict().items():
        assert torch.equal(v, before[k])
    lrn.train(stop_after=2)
    assert lrn.buffer.size == 12 and lrn.timing["updates"] == 3
    assert float(lrn.last_loss_sum) > 0.0
    assert lrn.timing["rollout_steps"] == 12


def test_several_envs_a_round():
    lrn = til.LargeNImitationLearner(
        _cfg("cloning", n_rollout_envs=2, n_train_episodes=4), device="cpu")
    stats = lrn.train()
    assert np.isfinite(stats["mean"]) and lrn._rnd == 2
    assert lrn.buffer.size == 2 * 2 * 6
    assert lrn.timing["updates"] == 2 * 2 * 3
    assert lrn.timing["rollout_steps"] == 2 * 2 * 6


def test_overflow_gate_refuses_to_store():
    """A grid of one slot per cell drops agents: the round raises before
    anything is stored or updated."""
    lrn = til.LargeNImitationLearner(_cfg(cell_cap=1), device="cpu")
    with pytest.raises(RuntimeError, match="overflow="):
        lrn.train()
    assert lrn.buffer.size == 0 and lrn._rnd == 0


@pytest.mark.parametrize("fault", ["overflow", "nan"])
def test_eval_refuses_an_invalid_episode(fault):
    lrn = til.LargeNImitationLearner(
        _cfg(cell_cap=1 if fault == "overflow" else 0), device="cpu")
    if fault == "nan":
        with torch.no_grad():
            lrn.actor.layers[0].bias.fill_(float("nan"))
    with pytest.raises(RuntimeError, match="refusing to score"):
        lrn.evaluate()


def _flat_state(lrn):
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}")
            else:
                out[f"{path}/{k}"] = (v.detach().cpu().numpy()
                                      if isinstance(v, torch.Tensor)
                                      else np.asarray(v))
    walk(lrn.training_state(), "")
    return out


def _assert_same_state(a, b):
    sa, sb = _flat_state(a), _flat_state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("with_buffer", [True, False])
def test_resume_matches_uninterrupted(tmp_path, with_buffer):
    """A run stopped after 2 of 4 rounds and resumed from its state file
    equals the uninterrupted run bit for bit (with the buffer in the file);
    without it, the uninterrupted run with its buffer emptied at the
    stop."""
    cfg = _cfg(checkpoint_buffer=with_buffer)
    state = str(tmp_path / "state.npz")
    part = til.LargeNImitationLearner(cfg, device="cpu")
    assert part.train(state_path=state, stop_after=2)["interrupted"]
    rest = til.LargeNImitationLearner(cfg, device="cpu")
    stats_rest = rest.train(state_path=state)
    ref = til.LargeNImitationLearner(cfg, device="cpu")
    ref.train(stop_after=2)
    if not with_buffer:
        ref.buffer.size = ref.buffer.cursor = 0
    stats_ref = ref.train()
    assert rest._rnd == ref._rnd == 4
    assert stats_rest == stats_ref
    _assert_same_state(ref, rest)


def test_export_is_read_by_both_packages(tmp_path):
    cfg = _cfg(n_train_episodes=2)
    lrn = til.LargeNImitationLearner(cfg, device="cpu")
    save = str(tmp_path / "actor_large")
    lrn.train(save_path=save)
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=(8,), k=3)
    jparams = jck.load(save + ".npz", jac.init_actor(jax.random.key(0), jcfg))
    layers = tck.load_actor_npz(save + ".npz", cfg.actor)
    y = lrn.buffer.data["agg"][:lrn.buffer.size]
    with torch.no_grad():
        got = lrn.actor(y).numpy()
        back = tac.Actor(cfg.actor)
        back.load_state_dict(tti.actor_params_from_numpy(layers))
        np.testing.assert_array_equal(back(y).numpy(), got)
    _close(got.reshape(-1, 2), np.asarray(jac.actor_forward(
        jparams, jcfg, jnp.asarray(y.numpy()), None)).reshape(-1, 2),
        "actions", rel=1e-5)
    assert pathlib.Path(save).is_file()
