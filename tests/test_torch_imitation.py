"""The port's imitation trainers against the JAX package: Adam updates
against ``optax.adam`` from the same JAX-initialised params on the same
batches; cloning and DAGGER episodes from the same initial state with the
same coins against a loop over the JAX package's public functions (also
with the in-repo ``dagger_k3`` weights); the learner's loop (finite stats,
determinism, the β floor, batched rollouts, learning, resume bit for bit);
the actor export read by both packages; the state-dict converters; the
expert baseline.

Tolerances: 1e-5 of each tensor's largest magnitude for single functions,
1e-6 for the parameters after Adam updates, 1e-4 of each channel's largest
magnitude for whole episodes; resumes and integer quantities exactly.
"""

import dataclasses
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from multiagent_gnn_policies_tpu.algos import imitation as jim
from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.models import torch_import as jti
from multiagent_gnn_policies_tpu.ops import graph as jgr
from multiagent_gnn_policies_tpu.utils import checkpoint as jck
from multiagent_gnn_policies_tpu_torch.algos import baseline as tbs
from multiagent_gnn_policies_tpu_torch.algos import imitation as tim
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import torch_import as tti
from multiagent_gnn_policies_tpu_torch.utils import checkpoint as tck
from multiagent_gnn_policies_tpu_torch.utils.config import ExperimentConfig
from multiagent_gnn_policies_tpu_torch.utils.metrics import MetricsLogger


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The torch side on one thread: under the suite's xdist workers its
    intra-op threads oversubscribe the cores (the port's small ops ran
    ~20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parent.parent
DAGGER_K3 = ROOT / "models" / "actor_FlockingRelative-v0_dagger_k3"


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    w2 = want.reshape(-1, want.shape[-1]) if want.ndim > 1 else want[:, None]
    scale = np.maximum(np.abs(w2).max(0), 1e-30)
    err = np.abs(got.reshape(w2.shape) - w2).max(0)
    assert (err <= rel * scale).all(), (what, err / scale)


def _port_actor(layers, acfg):
    actor = tac.Actor(acfg)
    actor.load_state_dict(tti.actor_params_from_numpy(
        [{k: np.asarray(v) for k, v in l.items()} for l in layers]))
    return actor


def _acfgs(k=3, hidden=(16, 16)):
    return (jac.ActorConfig(n_s=6, n_a=2, hidden=hidden, k=k),
            tac.ActorConfig(n_s=6, n_a=2, hidden=hidden, k=k))


@pytest.mark.parametrize("n_updates", [1, 5])
def test_adam_updates_match_optax(n_updates):
    jcfg, tcfg = _acfgs()
    params = jac.init_actor(jax.random.key(0), jcfg)
    actor = _port_actor(params, tcfg)
    lr = 1e-3                         # large enough to move every weight
    opt = torch.optim.Adam(actor.parameters(), lr=lr)
    tx = optax.adam(lr)
    jopt = tx.init(params)
    rng = np.random.default_rng(1)
    before = tti.actor_numpy_from_params(actor.state_dict(), tcfg)
    for _ in range(n_updates):
        batch = {"agg": rng.normal(size=(8, 3, 10, 6)).astype(np.float32),
                 "act": rng.normal(size=(8, 10, 2)).astype(np.float32)}
        loss = tim.adam_update(actor, opt, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        jloss, grads = jax.value_and_grad(jim._loss_fn)(
            params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
        upd, jopt = tx.update(grads, jopt)
        params = optax.apply_updates(params, upd)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    got = tti.actor_numpy_from_params(actor.state_dict(), tcfg)
    worst = max(float(np.abs(g[k] - np.asarray(w[k])).max()
                      / np.abs(np.asarray(w[k])).max())
                for g, w in zip(got, params) for k in ("w", "b"))
    print(f"{n_updates} Adam update(s): params within {worst:.3g} of each "
          f"tensor's largest magnitude of optax.adam's")
    for i, (g, w, b) in enumerate(zip(got, params, before)):
        for name in ("w", "b"):
            want = np.asarray(w[name])
            _close(g[name].reshape(-1), want.reshape(-1), 1e-6,
                   f"layer {i} {name}")
            # the update itself, to 1e-4 of its own size (the parameters'
            # float32 rounding is ~1e-5 of an update of lr = 1e-3)
            _close((g[name] - b[name]).reshape(-1),
                   (want - b[name]).reshape(-1), 1e-4,
                   f"layer {i} {name} update")


def _jax_episode(params, jcfg, env, x0, coins, mode):
    """The reference episode: a loop over the JAX package's public
    functions (env.step, env.controller, update_graph_state, aggregate,
    actor_forward) from the state ``x0``, with the coins given."""
    state = jfl.EnvState(x=jnp.asarray(x0), t=jnp.zeros((), jnp.int32),
                         key=jax.random.key(0))
    obs = env.observe(state)
    gs = jgr.initial_graph_state(obs.values, obs.network, jcfg.k)
    aggs, acts, total = [], [], 0.0
    for t in range(env.params.episode_steps):
        agg = jgr.aggregate(gs.delay_gso, gs.delay_state)
        expert = env.controller(state)
        if mode == "cloning":
            act = expert
        else:
            act = jnp.where(coins[t], expert,
                            jac.actor_forward(params, jcfg, agg, None))
        state, obs, r, _ = env.step(state, act)
        gs = jgr.update_graph_state(gs, obs.values, obs.network)
        aggs.append(np.asarray(agg))
        acts.append(np.asarray(expert))
        total += float(r)
    return np.stack(aggs), np.stack(acts), total


@pytest.mark.parametrize("mode,weights", [("cloning", "init"),
                                          ("dagger", "init"),
                                          ("dagger", "dagger_k3")])
def test_episode_matches_jax(mode, weights):
    n, steps = 40, 30
    jcfg, tcfg = _acfgs(hidden=(32, 32))
    if weights == "init":
        params = jac.init_actor(jax.random.key(2), jcfg)
    else:
        params = tck.load_actor_npz(str(DAGGER_K3) + ".npz", tcfg)
    jp = jfl.FlockingParams(n_agents=n, episode_steps=steps)
    jenv = jfl.make_env("FlockingRelative-v0", jp)
    x0 = np.array(jenv.reset(jax.random.key(3))[0].x)
    coins = np.random.default_rng(4).random(steps) < 0.5
    want_agg, want_act, want_r = _jax_episode(params, jcfg, jenv, x0, coins,
                                              mode)
    tenv = tfl.make_env("FlockingRelative-v0", tfl.FlockingParams(
        n_agents=n, episode_steps=steps))
    samples, rewards = tim.rollout_episode(
        _port_actor(params, tcfg), None, 0.5, tenv, tcfg, mode=mode,
        x0=torch.from_numpy(x0)[None], coins=torch.from_numpy(coins)[:, None])
    assert samples["agg"].shape == (steps, 3, n, 6)
    assert samples["act"].shape == (steps, n, 2)
    _close(samples["agg"].reshape(steps * 3 * n, 6),
           want_agg.reshape(-1, 6), 1e-4, "agg")
    _close(samples["act"].reshape(-1, 2), want_act.reshape(-1, 2), 1e-4,
           "act")
    np.testing.assert_allclose(float(rewards[0]), want_r, rtol=1e-4)


def _top_level_ops(fn):
    """ATen ops ``fn`` dispatches from Python (not those they call)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    return sum(1 for e in ops if not (e.cpu_parent is not None and
                                      e.cpu_parent.name.startswith("aten::")))


def test_dense_round_dispatch_counts():
    """On the card a dense round is host-bound (PERF.md section 5): its
    cost is the ops the host dispatches. Counts them at cfg/dagger.cfg's
    width (N = 100, K = 3, hidden 32x2, batch 20) for an env step of a
    DAGGER rollout and for an Adam update with its replay sample, on the
    CPU (where Adam runs per parameter, not foreach), prints them and
    keeps them from growing."""
    acfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=3)
    cfg = _tiny("dagger", actor=acfg, batch_size=20, buffer_size=400,
                env=tfl.FlockingParams(n_agents=100, episode_steps=20))
    lrn = tim.ImitationLearner(cfg, device="cpu")
    lrn.train(stop_after=1)
    x0 = tfl.reset(torch.Generator().manual_seed(0), cfg.env, (1,))[0].x
    steps = cfg.env.episode_steps
    per_step = _top_level_ops(lambda: tim.rollout_episode(
        lrn.actor, lrn.gen, 0.5, lrn.env, acfg, mode="dagger",
        x0=x0)) / steps
    per_update = _top_level_ops(lambda: tim.adam_update(
        lrn.actor, lrn.opt, lrn.buffer.sample(lrn.gen, cfg.batch_size)))
    print(f"dispatched ATen ops: {per_step:.1f} per DAGGER env step "
          f"(episode start included), {per_update} per Adam update with "
          f"its sample")
    assert per_step <= 140 and per_update <= 155


def _tiny(mode, **kw):
    d = dict(mode=mode, actor=tac.ActorConfig(n_s=6, n_a=2, hidden=(16, 16),
                                              k=2),
             env_name="FlockingRelative-v0",
             env=tfl.FlockingParams(n_agents=12, episode_steps=30),
             batch_size=8, buffer_size=300, updates_per_episode=20,
             actor_lr=3e-4, n_train_episodes=6, test_interval=3,
             n_test_episodes=3, seed=0)
    d.update(kw)
    return tim.ImitationConfig(**d)


class _Events(MetricsLogger):
    def __init__(self):
        super().__init__()
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


@pytest.mark.parametrize("mode", ["cloning", "dagger"])
def test_learner_trains_logs_and_is_deterministic(mode):
    log = _Events()
    lrn = tim.ImitationLearner(_tiny(mode), log, device="cpu")
    stats = lrn.train()
    assert set(stats) == {"mean", "std"}
    assert np.isfinite(stats["mean"]) and np.isfinite(stats["std"])
    evals = [f for e, f in log.events if e == "eval"]
    assert [f["episode"] for f in evals] == [0, 3]
    for f in evals:
        assert set(f) == {"episode", "steps", "reward_mean", "reward_std",
                          "beta", "policy_loss_sum", "rollout_reward",
                          "round_s", "env_steps_per_s"}
        assert np.isfinite(f["policy_loss_sum"]) and f["policy_loss_sum"] > 0
    final = [f for e, f in log.events if e == "final_eval"]
    assert len(final) == 1                   # the JAX learner's fields
    assert set(final[0]) == {"reward_mean", "reward_std"}
    timing = [f for e, f in log.events if e == "timing"]
    assert len(timing) == 1 and timing[0]["update_ms_per_update"] > 0
    assert lrn.timing["updates"] == 6 * 20 and lrn.timing[
        "rollout_steps"] == 6 * 30
    if mode == "dagger":
        assert lrn._beta == pytest.approx(0.993 ** 6)
    again = tim.ImitationLearner(_tiny(mode), device="cpu").train()
    assert again == stats


def test_dagger_beta_anneals_to_the_floor():
    cfg = _tiny("dagger", n_train_episodes=120, updates_per_episode=1,
                test_interval=1000, beta_coeff=0.99,
                env=tfl.FlockingParams(n_agents=6, episode_steps=2))
    lrn = tim.ImitationLearner(cfg, device="cpu")
    lrn.train()
    # 0.99 ** 69 < 0.5: the floor holds from episode 69 on
    assert lrn._beta == 0.5


def test_batched_rollout_envs_fill_the_buffer():
    cfg = _tiny("cloning", n_rollout_envs=3, n_train_episodes=6)
    lrn = tim.ImitationLearner(cfg, device="cpu")
    stats = lrn.train()
    assert np.isfinite(stats["mean"])
    assert lrn.buffer.size == min(300, 6 // 3 * 3 * 30)
    assert lrn.timing["updates"] == 2 * 3 * 20


def test_cloning_improves_over_untrained():
    cfg = _tiny("cloning", n_train_episodes=20, updates_per_episode=60,
                n_test_episodes=5)
    lrn = tim.ImitationLearner(cfg, device="cpu")
    before, _ = lrn.evaluate()
    assert lrn.train()["mean"] > before


def _resume_cfg(mode, **kw):
    return _tiny(mode, actor=tac.ActorConfig(n_s=6, n_a=2, hidden=(8,), k=2),
                 env=tfl.FlockingParams(n_agents=12, episode_steps=8),
                 batch_size=4, buffer_size=64, updates_per_episode=3,
                 test_interval=2, n_test_episodes=2, seed=3, **kw)


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


def _assert_same_state(a, b, skip=()):
    sa, sb = _flat_state(a), _flat_state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        if not k.startswith(skip):
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("mode", ["dagger", "cloning"])
def test_resume_matches_uninterrupted(tmp_path, mode):
    state = str(tmp_path / "state.npz")
    full = tim.ImitationLearner(_resume_cfg(mode, n_train_episodes=6),
                                device="cpu")
    stats_full = full.train()
    part = tim.ImitationLearner(_resume_cfg(mode, n_train_episodes=6),
                                device="cpu")
    assert part.train(state_path=state, stop_after=3)["interrupted"]
    log = _Events()
    rest = tim.ImitationLearner(_resume_cfg(mode, n_train_episodes=6), log,
                                device="cpu")
    stats_rest = rest.train(state_path=state)
    assert log.events[0] == ("resume", {"round": 3, "beta": part._beta})
    assert rest._rnd == 6 and stats_rest == stats_full
    _assert_same_state(full, rest)


def test_resume_without_the_buffer(tmp_path):
    """checkpoint_buffer = False: params, Adam, generator and schedule
    restore exactly and the buffer starts empty, so the resumed run equals,
    bit for bit, the uninterrupted run with its buffer emptied at the same
    round; the state file is smaller."""
    cfg = _resume_cfg("dagger", n_train_episodes=6, checkpoint_buffer=False)
    state = str(tmp_path / "state_nobuf.npz")
    part = tim.ImitationLearner(cfg, device="cpu")
    assert part.train(state_path=state, stop_after=3)["interrupted"]
    rest = tim.ImitationLearner(cfg, device="cpu")
    rest.load_training_state(state)
    assert rest.buffer.size == 0 and rest.buffer.cursor == 0
    _assert_same_state(part, rest)
    rest.train(state_path=state)
    ref = tim.ImitationLearner(cfg, device="cpu")
    ref.train(stop_after=3)
    ref.buffer.size = ref.buffer.cursor = 0
    ref.train()
    assert rest._rnd == ref._rnd == 6
    _assert_same_state(ref, rest)
    full_state = str(tmp_path / "state_full.npz")
    with_buf = tim.ImitationLearner(dataclasses.replace(
        cfg, checkpoint_buffer=True), device="cpu")
    with_buf.train(state_path=full_state, stop_after=3)
    assert (pathlib.Path(state).stat().st_size
            < pathlib.Path(full_state).stat().st_size)


def test_state_file_refuses_another_structure(tmp_path):
    lrn = tim.ImitationLearner(_resume_cfg("dagger", n_train_episodes=2),
                               device="cpu")
    lrn.train(stop_after=1)
    path = str(tmp_path / "s.npz")
    lrn.save_training_state(path)
    other = tim.ImitationLearner(_resume_cfg(
        "dagger", n_train_episodes=2, checkpoint_buffer=False), device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        other.load_training_state(path)
    with torch.no_grad():
        lrn.actor.layers[0].weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="params"):
        lrn.save_training_state(path)


def test_export_is_read_by_both_packages(tmp_path):
    cfg = _tiny("dagger", n_train_episodes=2)
    lrn = tim.ImitationLearner(cfg, device="cpu")
    save = str(tmp_path / "models" / "actor_test")
    lrn.train(save_path=save)
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=(16, 16), k=2)
    like = jac.init_actor(jax.random.key(0), jcfg)
    jparams = jck.load(save + ".npz", like)
    layers = tck.load_actor_npz(save + ".npz", cfg.actor)
    y = np.random.default_rng(5).normal(size=(3, 2, 12, 6)).astype(
        np.float32)
    with torch.no_grad():
        got = lrn.actor(torch.from_numpy(y)).numpy()
        again = _port_actor(layers, cfg.actor)(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, again)
    _close(got.reshape(-1, 2), np.asarray(jac.actor_forward(
        jparams, jcfg, jnp.asarray(y), None)).reshape(-1, 2), 1e-5)
    # the reference-layout torch state_dict beside it holds the same weights
    sd = torch.load(save, map_location="cpu")
    for a, b in zip(jti.actor_params_from_state_dict(sd), layers):
        np.testing.assert_array_equal(np.asarray(a["w"]), b["w"])
        np.testing.assert_array_equal(np.asarray(a["b"]), b["b"])


def test_state_dict_converters_round_trip_and_match_jax():
    sd = torch.load(str(DAGGER_K3), map_location="cpu")
    layers = tti.actor_params_from_state_dict(sd)
    want = jti.actor_params_from_state_dict(sd)
    npz = tck.load_actor_npz(str(DAGGER_K3) + ".npz",
                             tac.ActorConfig(n_s=6, n_a=2, hidden=(32, 32),
                                             k=3))
    for got, w, z in zip(layers, want, npz):
        for name in ("w", "b"):
            np.testing.assert_array_equal(got[name], np.asarray(w[name]))
            np.testing.assert_array_equal(got[name], z[name])
    back = tti.actor_state_dict_from_params(layers)
    jback = jti.actor_state_dict_from_params(want)
    assert back.keys() == sd.keys() == jback.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k].numpy())
        np.testing.assert_array_equal(back[k], jback[k])
    acfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=3)
    module_sd = tti.actor_params_from_numpy(layers)
    for got, w in zip(tti.actor_numpy_from_params(module_sd, acfg), layers):
        np.testing.assert_array_equal(got["w"], w["w"])
        np.testing.assert_array_equal(got["b"], w["b"])
    with pytest.raises(ValueError, match="conv_layers"):
        tti.actor_params_from_state_dict({"layers.0.weight": np.zeros(1)})


def test_baseline_runs_the_expert_batched():
    base = dict(alg="baseline", n_agents=30, episode_steps=60,
                n_test_episodes=4, seed=1)
    log = _Events()
    cen = tbs.train_baseline(ExperimentConfig(centralized=True, **base), log,
                             device="cpu")
    dec = tbs.train_baseline(ExperimentConfig(centralized=False, **base),
                             device="cpu")
    assert log.events == [("baseline_eval", {"centralized": True, **cen})]
    assert np.isfinite([cen["mean"], cen["std"], dec["mean"],
                        dec["std"]]).all()
    assert cen == tbs.train_baseline(ExperimentConfig(centralized=True,
                                                      **base), device="cpu")
    # the expert's episode is the cloning rollout's: same resets (same
    # generator stream), same actions
    env = tfl.make_env("FlockingRelative-v0", tfl.FlockingParams(
        n_agents=30, episode_steps=60))
    gen = torch.Generator().manual_seed(1)
    r = tim.rollout_episode(None, gen, 0.0, env, tac.ActorConfig(
        n_s=6, n_a=2, hidden=(4,), k=2), mode="cloning", collect=False,
        n_envs=4).numpy()
    assert cen == {"mean": float(r.mean()), "std": float(r.std())}
    assert cen["mean"] > dec["mean"]
