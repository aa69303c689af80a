"""The port's dense DDPG (``algos/ddpg.py``) against the JAX package: the
OU process by its statistics; Polyak; the config; gradient steps against
``DDPG._gradient_step`` from the same parameters on the same batches
(losses, networks, targets and both Adam states, which also holds
``torch.optim.Adam`` against ``optax.adam``); a training episode from an
injected reset, OU draws and replay indices against a loop of the JAX
package's public functions; the learner's loop (clipped actions, targets
that track, resume bit for bit); exports read by both packages; and the
port's evaluator on the in-repo toy checkpoint against the JAX mean.

Tolerances: 1e-5 of each tensor's largest magnitude per function, 1e-4
per episode; resumes exactly.
"""

import dataclasses
import pathlib
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiagent_gnn_policies_tpu.algos import ddpg as jdd
from multiagent_gnn_policies_tpu.algos import replay as jrp
from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.models import critic as jcr
from multiagent_gnn_policies_tpu.models import torch_import as jti
from multiagent_gnn_policies_tpu.ops import graph as jgr
from multiagent_gnn_policies_tpu.utils import checkpoint as jck
from multiagent_gnn_policies_tpu.utils import config as jconf
from multiagent_gnn_policies_tpu_torch import evaluate as tev
from multiagent_gnn_policies_tpu_torch.algos import ddpg as tdd
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import critic as tcr
from multiagent_gnn_policies_tpu_torch.models import torch_import as tti
from multiagent_gnn_policies_tpu_torch.utils import checkpoint as tck
from multiagent_gnn_policies_tpu_torch.utils.config import (
    ExperimentConfig,
    load_ini,
)


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
TOY = ROOT / "models" / "actor_FlockingRelative-v0_ddpg_toy_k2"
REL = 1e-5
REL_EPISODE = 1e-4
N = 8
# Adam's largest step, in units of lr: |m_hat| / sqrt(v_hat) is at most
# (1 - beta1) / sqrt(1 - beta2) with the default betas of both packages
ADAM_STEP_MAX = (1 - 0.9) / np.sqrt(1 - 0.999)


def _close(got, want, rel, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    scale = float(np.abs(want).max(initial=0.0))
    assert err <= rel * max(scale, 1e-30), (what, err, scale)


def _cfgs(gn=False, bound="tanh", transform="asinh", k=2, **kw):
    """The same tiny DDPG configuration in both packages."""
    d = dict(env_name="FlockingRelative-v0", batch_size=4, buffer_size=50,
             updates_per_step=1, actor_lr=1e-3, critic_lr=1e-3, gamma=0.9,
             tau=0.1, n_train_episodes=3, test_interval=2,
             n_test_episodes=2, seed=0, reward_scale=0.5)
    d.update(kw)
    hidden = (8, 8)
    out = []
    for ac, cr, fl, dd in ((jac, jcr, jfl, jdd), (tac, tcr, tfl, tdd)):
        out.append(dd.DDPGConfig(
            actor=ac.ActorConfig(n_s=6, n_a=2, hidden=hidden, k=k,
                                 ind_agg=1, bound=bound),
            critic=cr.CriticConfig(n_s=6, n_a=2, hidden=hidden, k=k,
                                   use_groupnorm=gn,
                                   input_transform=transform),
            env=fl.FlockingParams(n_agents=N, episode_steps=12), **d))
    return out


def _np_layers(layers):
    return [{k: np.array(v) for k, v in l.items()} for l in layers]


def _load_jax_state(learner, ts):
    """Put the JAX train state's networks into the port's learner."""
    for name, conv in (("actor", tti.actor_params_from_numpy),
                       ("actor_target", tti.actor_params_from_numpy),
                       ("critic", tti.critic_params_from_numpy),
                       ("critic_target", tti.critic_params_from_numpy)):
        getattr(learner, name).load_state_dict(
            conv(_np_layers(getattr(ts, name))))


def _port_layers(learner, module, tensors=None):
    """``module``'s parameters (or per-parameter ``tensors``) in the JAX
    layout."""
    m = getattr(learner, module)
    sd = m.state_dict() if tensors is None else {
        name: tensors[p] for name, p in m.named_parameters()}
    if module.startswith("actor"):
        return tti.actor_numpy_from_params(sd, learner.cfg.actor)
    return tti.critic_numpy_from_params(sd, learner.cfg.critic)


def _assert_same_train_state(learner, ts, rel, what="", steps=1):
    """Networks, targets and both Adam moments of the port's learner
    against the JAX train state.

    With GroupNorm, a hidden critic layer's bias ``b`` shifts every agent
    alike and the normalisation subtracts it again: its gradient is zero
    up to rounding in both packages, and Adam scales that rounding noise
    to steps of up to ``ADAM_STEP_MAX · lr``. Such a bias is held only to
    twice that per step, and its moments not at all; the critic's outputs
    do not depend on it."""
    cfg = learner.cfg
    free = ({(i, "b") for i in range(cfg.critic.n_layers - 1)}
            if cfg.critic.use_groupnorm else set())
    pairs = [(m, _port_layers(learner, m), getattr(ts, m))
             for m in ("actor", "actor_target", "critic", "critic_target")]
    for net, opt in (("actor", ts.actor_opt), ("critic", ts.critic_opt)):
        adam = opt[0]
        st = getattr(learner, f"{net}_opt").state
        for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            got = _port_layers(learner, net, {p: s[key]
                                              for p, s in st.items()})
            pairs.append((f"{net} {key}", got, moment))
    for name, got, want in pairs:
        for i, (g, w) in enumerate(zip(got, want)):
            assert sorted(g) == sorted(w)
            for k in w:
                if name.startswith("critic") and (i, k) in free:
                    if " " not in name:            # a network, not a moment
                        assert np.abs(g[k] - np.asarray(w[k])).max() <= (
                            2 * ADAM_STEP_MAX * cfg.critic_lr * steps), (
                                what, name, i, k)
                else:
                    _close(g[k], w[k], rel, f"{what} {name} {i} {k}")


def _assert_actor_loss(learner, batch, got, want, what=""):
    """The actor loss is a mean of Q values of both signs, so it is held to
    1e-5 of the largest Q it averages (after the step's updates)."""
    (hist, ga, gc), _ = learner._graphs(batch)
    with torch.no_grad():
        q_max = float(learner._q(learner.critic, hist[:, 0],
                                 learner._pi(learner.actor, hist, ga),
                                 gc).abs().max())
    assert abs(float(got) - float(want)) <= REL * q_max, (what, q_max)


def _random_gso_batch(rng, b, k, n=N):
    """A replay batch of valid graphs: normalised adjacencies of random
    positions and delayed GSOs built from them."""
    def adj():
        pos = rng.uniform(-1.2, 1.2, size=(b, n, 2))
        d = pos[:, :, None] - pos[:, None]
        a = ((d ** 2).sum(-1) < 1.0) & ~np.eye(n, dtype=bool)
        return (a / np.maximum(a.sum(-1, keepdims=True), 1)).astype(
            np.float32)

    gs = [np.broadcast_to(np.eye(n, dtype=np.float32), (b, n, n))]
    for _ in range(k - 1):
        gs.append(adj() @ gs[-1])
    return {
        "delay_state": rng.normal(size=(b, k, n, 6)).astype(np.float32),
        "delay_gso": np.stack(gs, 1).astype(np.float32),
        "network": adj(), "next_network": adj(),
        "next_values": rng.normal(size=(b, n, 6)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(b, n, 2)).astype(np.float32),
        "reward": rng.normal(-5, 1, size=(b,)).astype(np.float32),
        "notdone": (rng.random(b) < 0.7).astype(np.float32),
    }


def test_ou_noise_statistics():
    """As the JAX package's test: the stationary std sigma/sqrt(2 theta)
    ≈ 0.365, mean near 0, successive steps strongly correlated."""
    gen = torch.Generator().manual_seed(0)
    x = tdd.ou_reset(4, 2)
    xs = []
    for _ in range(500):
        x = tdd.ou_step(x, gen, theta=0.15, sigma=0.2)
        xs.append(x.numpy())
    xs = np.stack(xs)
    assert 0.25 < xs[200:].std() < 0.5
    assert abs(xs[200:].mean()) < 0.1
    assert np.abs(xs[1:] - xs[:-1]).mean() < xs[200:].std()
    # the same update as the JAX ou_step on the same normal draw
    key = jax.random.key(3)
    prev = jnp.asarray(xs[-1])
    want = jdd.ou_step(jdd.OUState(x=prev), key, 0.15, 0.2).x
    noise = np.array(jax.random.normal(key, prev.shape))
    got = tdd.ou_step(torch.from_numpy(xs[-1]), None, 0.15, 0.2,
                      noise=torch.from_numpy(noise))
    _close(got, want, REL)


def test_soft_update_polyak():
    t, s = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in t.parameters():
            p.zero_()
        for p in s.parameters():
            p.fill_(1.0)
    tdd.soft_update_(t, s, tau=0.25)
    for p in t.parameters():
        torch.testing.assert_close(p.detach(), torch.full_like(p, 0.25))
    jt = jdd._soft_update([{"w": jnp.full((2,), 0.3)}],
                          [{"w": jnp.full((2,), -1.7)}], 0.1)
    with torch.no_grad():
        for p in t.parameters():
            p.fill_(0.3)
        for p in s.parameters():
            p.fill_(-1.7)
    tdd.soft_update_(t, s, 0.1)
    _close(t.bias, jt[0]["w"], REL)


@pytest.mark.parametrize("path,section", [
    ("cfg/ddpg.cfg", "test"), ("cfg/ddpg.cfg", "test_unbounded"),
    ("cfg/ddpg_toy.cfg", "test"), ("cfg/ddpg_n4k.cfg", "n4k"),
    ("tmp", "test_interval = 40"), ("tmp", "no test_interval")])
def test_config_from_experiment_matches_jax(path, section, tmp_path):
    """Every field, the env built from its five fields only. The "tmp"
    cases are ``cfg/ddpg_toy.cfg [test]`` written with another
    ``test_interval`` and without the key: the JAX DDPG reads neither
    (it evaluates every 10 episodes), so the port must not either."""
    if path == "tmp":
        text = (ROOT / "cfg" / "ddpg_toy.cfg").read_text()
        assert "test_interval = 10" in text
        text = text.replace("test_interval = 10", (
            section if section.startswith("test_interval") else ""))
        path, section = tmp_path / "ddpg.cfg", "test"
        path.write_text(text)
    want = jdd.DDPGConfig.from_experiment(jconf.ExperimentConfig.from_section(
        jconf.load_ini(str(ROOT / path))[section]))
    got = tdd.DDPGConfig.from_experiment(ExperimentConfig.from_section(
        load_ini(str(ROOT / path))[section]))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("gn,bound", [(True, "tanh"), (True, "none"),
                                      (False, "tanh"), (False, "none")])
def test_gradient_steps_match_jax(gn, bound):
    """Five gradient steps, each on its own batch, from JAX-initialised
    networks with targets that differ from them: the losses of every step
    and, after the first and the fifth, every network, target and Adam
    moment within 1e-5 of the tensor's largest magnitude."""
    jcfg, tcfg = _cfgs(gn=gn, bound=bound,
                       transform="identity" if gn else "asinh")
    jl = jdd.DDPG(jcfg)
    ts = jl.state._replace(
        actor_target=jac.init_actor(jax.random.key(7), jcfg.actor),
        critic_target=jcr.init_critic(jax.random.key(8), jcfg.critic))
    tl = tdd.DDPG(tcfg, device="cpu")
    _load_jax_state(tl, ts)
    step = jax.jit(partial(jdd.DDPG._gradient_step, jl))
    rng = np.random.default_rng(1)
    # the loss functions themselves, before any step
    batch = _random_gso_batch(rng, 4, 2)
    c_fn, a_fn = jdd.DDPG._losses(jl, ts, jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (hist, ga, gc), _ = tl._graphs(tb)
    with torch.no_grad():
        pi = tl._pi(tl.actor, hist, ga)
        _close(-tl._q(tl.critic, hist[:, 0], pi, gc).mean(),
               a_fn(ts.actor), REL, "actor loss")
    for i in range(5):
        if i:
            batch = _random_gso_batch(rng, 4, 2)
        ts, c_loss, a_loss = step(ts, jax.tree.map(jnp.asarray, batch))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tc, ta = tl.gradient_step(tb)
        _close(tc, c_loss, REL, f"critic loss {i}")
        _assert_actor_loss(tl, tb, ta, a_loss, f"actor loss {i}")
        if i in (0, 4):
            _assert_same_train_state(tl, ts, REL, f"step {i}", steps=i + 1)
    # the critic's grads are its own step's: the actor step left them
    assert all(p.grad is not None for p in tl.critic.parameters())
    # the updated critics compute the same Q
    b = _random_gso_batch(rng, 4, 2)
    powers = jax.vmap(lambda a: jgr.gso_powers(a, 2))(b["network"])
    with torch.no_grad():
        _close(tl.critic(torch.from_numpy(b["next_values"]),
                         torch.from_numpy(b["action"]),
                         torch.from_numpy(np.array(powers))),
               jcr.critic_forward(ts.critic, jcfg.critic, b["next_values"],
                                  b["action"], powers), REL, "Q")


def _jax_episode(jl, ts, x0, noise, indices):
    """The reference episode: a loop of the JAX package's public functions
    (env.observe/step, ou_step on the given normal draws, actor_forward,
    the graph-state update, replay_insert_batch, a gather at the given
    indices and DDPG._gradient_step)."""
    cfg = jl.cfg
    env = jfl.make_env(cfg.env_name, cfg.env)
    state = jfl.EnvState(x=jnp.asarray(x0), t=jnp.zeros((), jnp.int32),
                         key=jax.random.key(0))
    obs = env.observe(state)
    gs = jgr.initial_graph_state(obs.values, obs.network, cfg.actor.k)
    ou = jnp.zeros((cfg.env.n_agents, cfg.actor.n_a))
    buf = jl.buffer
    step = jax.jit(partial(jdd.DDPG._gradient_step, jl))
    total = c_total = a_total = 0.0
    for t in range(cfg.env.episode_steps):
        ou = ou + (cfg.ou_theta * (0.0 - ou) + cfg.ou_sigma * noise[t])
        mu = jac.actor_forward(ts.actor, cfg.actor, gs.delay_state,
                               gs.delay_gso)
        action = jnp.clip(mu + cfg.ou_scale * ou, -1.0, 1.0)
        state, nobs, r, done = env.step(state, action)
        sample = {"delay_state": gs.delay_state, "delay_gso": gs.delay_gso,
                  "network": gs.network, "next_network": nobs.network,
                  "next_values": nobs.values, "action": action, "reward": r,
                  "notdone": 1.0 - done.astype(jnp.float32)}
        buf = jrp.replay_insert_batch(buf, jax.tree.map(lambda v: v[None],
                                                        sample))
        gs = jgr.update_graph_state(gs, nobs.values, nobs.network)
        if int(buf.size) > cfg.batch_size:
            batch = jax.tree.map(lambda d: d[jnp.asarray(indices[t, 0])],
                                 buf.data)
            ts, c, a = step(ts, batch)
            c_total, a_total = c_total + float(c), a_total + float(a)
        total += float(r)
    return ts, buf, total, c_total, a_total


def _episode_draws(jcfg, seed):
    """x0 from the JAX reset, OU normals and distinct replay indices of
    the filled prefix for every step."""
    env = jfl.make_env(jcfg.env_name, jcfg.env)
    x0 = np.array(env.reset(jax.random.key(seed))[0].x)
    T, n = jcfg.env.episode_steps, jcfg.env.n_agents
    noise = np.array(jax.random.normal(jax.random.key(seed + 1),
                                       (T, n, jcfg.actor.n_a)))
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(max(t + 1, jcfg.batch_size))
                    [:jcfg.batch_size] for t in range(T)])[:, None]
    return x0, noise, idx


@pytest.mark.parametrize("gn", [True, False], ids=["gn", "no-gn"])
def test_episode_matches_jax(gn):
    """One training episode (12 steps, updates from the fifth) from the
    same reset, OU draws and replay indices: the summed reward and losses,
    the stored records, and the networks, targets and Adam moments at its
    end, within 1e-4."""
    jcfg, tcfg = _cfgs(gn=gn)
    jl = jdd.DDPG(jcfg)
    tl = tdd.DDPG(tcfg, device="cpu")
    _load_jax_state(tl, jl.state)
    x0, noise, idx = _episode_draws(jcfg, seed=5)
    ts, buf, r, c, a = _jax_episode(jl, jl.state, x0, noise, idx)
    tr, tc, ta = tl.episode(torch.from_numpy(x0), torch.from_numpy(noise),
                            torch.from_numpy(idx).long())
    assert tl.buffer.size == int(buf.size) == 12
    assert tl.timing["updates"] == 12 - jcfg.batch_size
    for k, d in tl.buffer.data.items():
        _close(d, buf.data[k], REL_EPISODE, k)
    for got, want in ((tr, r), (tc, c), (ta, a)):
        np.testing.assert_allclose(float(got), want, rtol=REL_EPISODE)
    _assert_same_train_state(tl, ts, REL_EPISODE, "end",
                             steps=tl.timing["updates"])


def test_actions_clipped_and_stored_per_step():
    _, tcfg = _cfgs(ou_scale=5.0)
    tl = tdd.DDPG(tcfg, device="cpu")
    tl.episode()
    acts = tl.buffer.data["action"][:tl.buffer.size]
    assert tl.buffer.size == 12
    assert float(acts.abs().max()) == 1.0          # clipped, and reached
    notdone = tl.buffer.data["notdone"][:12]
    assert notdone[:-1].eq(1).all() and float(notdone[-1]) == 0.0


def test_targets_track():
    _, tcfg = _cfgs(tau=0.5, n_train_episodes=2)
    tl = tdd.DDPG(tcfg, device="cpu")
    before = tl.actor_target.layers[0].weight.clone()
    tl.train()
    after = tl.actor_target.layers[0].weight
    assert not torch.allclose(before, after)
    # with tau = 0.5 the targets stay close to the online nets
    assert float((after - tl.actor.layers[0].weight).detach().abs().max()) < 1e-2


def _flat_state(lrn):
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = (v.detach().cpu().numpy()
                                   if isinstance(v, torch.Tensor)
                                   else np.asarray(v))

    walk(lrn.training_state(), "")
    return out


def test_resume_matches_uninterrupted(tmp_path):
    """Stopped after 2 of 4 episodes, saved, resumed by a fresh learner:
    networks, targets, Adam states, buffer, generator and counters equal
    the uninterrupted run's bit for bit."""
    _, tcfg = _cfgs(n_train_episodes=4)
    state = str(tmp_path / "state.npz")
    full = tdd.DDPG(tcfg, device="cpu")
    full.train()
    part = tdd.DDPG(tcfg, device="cpu")
    assert part.train(state_path=state, stop_after=2)["interrupted"]
    rest = tdd.DDPG(tcfg, device="cpu")
    rest.train(state_path=state)
    assert rest._ep == 4
    a, b = _flat_state(full), _flat_state(rest)
    assert sorted(a) == sorted(b)
    assert any(k.startswith("critic_opt/") for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_exports_read_by_both_packages(tmp_path):
    """The port's actor and critic files load in the JAX package (and its
    torch-format actor through the JAX importer), the JAX package's in the
    port, each acting as it did."""
    jcfg, tcfg = _cfgs(gn=True)
    tl = tdd.DDPG(tcfg, device="cpu")
    tl.episode()
    path = str(tmp_path / "actor_x")
    tl.export(path)
    jl = jdd.DDPG(jcfg)
    actor = jck.load(path + ".npz", jl.state.actor)
    critic = jck.load(path + "_critic.npz", jl.state.critic)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    from_sd = jti.actor_params_from_state_dict(sd)
    rng = np.random.default_rng(0)
    b = _random_gso_batch(rng, 2, 2)
    want_pi = jac.actor_forward(actor, jcfg.actor, b["delay_state"],
                                b["delay_gso"])
    np.testing.assert_array_equal(
        np.asarray(jac.actor_forward(from_sd, jcfg.actor, b["delay_state"],
                                     b["delay_gso"])), np.asarray(want_pi))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        _close(tl.actor(tb["delay_state"], tb["delay_gso"]), want_pi, REL,
               "actor")
        powers = jgr.gso_powers(jnp.asarray(b["network"][0]), 2)
        _close(tl.critic(tb["next_values"][0], tb["action"][0],
                         torch.from_numpy(np.array(powers))),
               jcr.critic_forward(critic, jcfg.critic, b["next_values"][0],
                                  b["action"][0], powers), REL, "critic")
    # and the JAX package's files in the port
    jck.save(str(tmp_path / "j.npz"), jl.state.actor)
    jck.save(str(tmp_path / "j_critic.npz"), jl.state.critic)
    for got, want in ((tck.load_actor_npz(str(tmp_path / "j.npz"),
                                          tcfg.actor), jl.state.actor),
                      (tck.load_critic_npz(str(tmp_path / "j_critic.npz"),
                                           tcfg.critic), jl.state.critic)):
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))


def test_evaluator_on_the_toy_checkpoint():
    """The in-repo toy actor under ``cfg/ddpg_toy.cfg [test]``, 200 greedy
    episodes through the evaluate CLI's DDPG route: within the JAX mean
    -23.45 +- 3 * 21.31 / sqrt(200) (the JAX package's 200-episode eval
    of this file, std 21.31)."""
    section = load_ini(str(ROOT / "cfg" / "ddpg_toy.cfg"))["test"]
    section["n_test_episodes"] = "200"
    stats = tev.evaluate_section(section, str(TOY) + ".npz", device="cpu")
    assert len(stats["rewards"]) == 200
    assert abs(stats["mean"] - -23.45) < 3 * 21.31 / np.sqrt(200), stats["mean"]
