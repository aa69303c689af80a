"""The port's positions-record DDPG (``algos/ddpg_large.py``) against the
JAX package: the adjacency rebuilt from positions (against the JAX
function and the dense env's network), the chained actor and critic
applies (against the JAX ones and the port's dense forwards), a gradient
step against ``DDPGLarge._gradient_step``, a training episode from an
injected reset, OU draws and replay indices against a loop of the JAX
package's public functions, the O(N) record, and resume bit for bit.

Tolerances: 1e-5 of each tensor's largest magnitude per function, 1e-4
per episode; adjacencies and resumes exactly.
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
from multiagent_gnn_policies_tpu.algos import ddpg_large as jdl
from multiagent_gnn_policies_tpu.algos import replay as jrp
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.models import critic as jcr
from multiagent_gnn_policies_tpu.ops import blocked as jbl
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu.utils import config as jconf
from multiagent_gnn_policies_tpu_torch.algos import ddpg as tdd
from multiagent_gnn_policies_tpu_torch.algos import ddpg_large as tdl
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import critic as tcr
from multiagent_gnn_policies_tpu_torch.models import torch_import as tti
from multiagent_gnn_policies_tpu_torch.ops import graph as tgr
from multiagent_gnn_policies_tpu_torch.utils import config as tconf

from test_torch_ddpg import (
    REL,
    REL_EPISODE,
    _assert_actor_loss,
    _assert_same_train_state,
    _cfgs,
    _close,
    _flat_state,
    _load_jax_state,
    _np_layers,
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


N = 48
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _large_cfgs(gn=False, k=2, **kw):
    kw = {"batch_size": 4, "buffer_size": 64, "n_test_episodes": 2,
          "test_interval": 1, "n_train_episodes": 2, **kw}
    jcfg, tcfg = _cfgs(gn=gn, k=k, transform="identity" if gn else "asinh",
                       **kw)
    out = []
    for cfg in (jcfg, tcfg):
        out.append(type(cfg)(**{**cfg.__dict__, "env": type(cfg.env)(
            n_agents=N, episode_steps=8, max_resets=4)}))
    return out


def _positions(rng, steps, n=N):
    return rng.uniform(-2.0, 2.0, size=(steps, n, 2)).astype(np.float32)


def test_dense_adj_matches_jax_and_the_env_network():
    """Bit for bit: the JAX function on the same positions, and the
    port's dense env's network of the same state (pairs near the radius
    included)."""
    rng = np.random.default_rng(0)
    pos = _positions(rng, 3)
    pos[0, 1] = pos[0, 0] + np.float32([0.6, 0.8])        # r² ≈ 1
    got = tdl.dense_adj_from_pos(torch.from_numpy(pos), 1.0)
    want = jax.vmap(lambda p: jdl.dense_adj_from_pos(p, 1.0))(pos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.concatenate([pos, rng.normal(size=(3, N, 2))], -1).astype(
        np.float32)
    net = tfl.observe(torch.from_numpy(x), tfl.FlockingParams(n_agents=N))
    np.testing.assert_array_equal(got.numpy(), net.network.numpy())


def _delayed_gso(adjs, k):
    """``[I, A_t, A_t A_{t-1}, ..]`` from newest-first adjacencies."""
    gs = [torch.eye(adjs.shape[-1]).expand(adjs.shape[:-3] + adjs.shape[-2:])]
    for s in range(k - 1):
        gs.append(gs[-1] @ adjs[..., s, :, :])
    return torch.stack(gs, -3)


@pytest.mark.parametrize("gn", [True, False], ids=["gn", "no-gn"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_chained_forwards_match_jax_and_the_dense_forwards(k, gn):
    rng = np.random.default_rng(k)
    jcfg, tcfg = _large_cfgs(gn=gn, k=k)
    params = jac.init_actor(jax.random.key(k), jcfg.actor)
    cparams = jcr.init_critic(jax.random.key(k + 1), jcfg.critic)
    actor = tac.Actor(tcfg.actor)
    actor.load_state_dict(tti.actor_params_from_numpy(_np_layers(params)))
    critic = tcr.Critic(tcfg.critic)
    critic.load_state_dict(tti.critic_params_from_numpy(_np_layers(cparams)))
    for batch in ((), (2,)):
        hist = rng.normal(size=(*batch, k, N, 6)).astype(np.float32)
        pos = _positions(rng, int(np.prod(batch)) * max(k - 1, 1)).reshape(
            *batch, max(k - 1, 1), N, 2)
        acts = rng.uniform(-1, 1, size=(*batch, N, 2)).astype(np.float32)
        adjs = tdl.dense_adj_from_pos(torch.from_numpy(pos), 1.0)
        with torch.no_grad():
            got_a = tdl.actor_forward_adj(actor, torch.from_numpy(hist),
                                          adjs)
            got_q = tdl.critic_forward_adj(
                critic, torch.from_numpy(hist[..., 0, :, :]),
                torch.from_numpy(acts), adjs[..., 0, :, :])
            dense_a = actor(torch.from_numpy(hist), _delayed_gso(adjs, k))
            dense_q = critic(torch.from_numpy(hist[..., 0, :, :]),
                             torch.from_numpy(acts),
                             tgr.gso_powers(adjs[..., 0, :, :], k))
        ja = jnp.asarray(adjs.numpy())
        want_a = jdl.actor_forward_adj(params, jcfg.actor, hist, ja)
        want_q = jdl.critic_forward_adj(cparams, jcfg.critic,
                                        hist[..., 0, :, :], acts,
                                        ja[..., 0, :, :])
        _close(got_a, want_a, REL, f"actor {batch}")
        _close(dense_a, want_a, REL, f"dense actor {batch}")
        _close(got_q, want_q, REL, f"critic {batch}")
        _close(dense_q, want_q, REL, f"dense critic {batch}")


def _random_pos_batch(rng, b, k, n=N):
    return {
        "hist": rng.normal(size=(b, k, n, 6)).astype(np.float32),
        "pos": rng.uniform(-2, 2, size=(b, max(k - 1, 1), n, 2)).astype(
            np.float32),
        "next_values": rng.normal(size=(b, n, 6)).astype(np.float32),
        "next_pos": rng.uniform(-2, 2, size=(b, n, 2)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(b, n, 2)).astype(np.float32),
        "reward": rng.normal(-5, 1, size=(b,)).astype(np.float32),
        "notdone": np.ones(b, np.float32),
    }


@pytest.mark.parametrize("k,gn", [(2, False), (3, True)])
def test_gradient_step_matches_jax(k, gn):
    jcfg, tcfg = _large_cfgs(gn=gn, k=k)
    jl = jdl.DDPGLarge(jcfg)
    ts = jl.state._replace(
        actor_target=jac.init_actor(jax.random.key(7), jcfg.actor),
        critic_target=jcr.init_critic(jax.random.key(8), jcfg.critic))
    tl = tdl.DDPGLarge(tcfg, device="cpu")
    _load_jax_state(tl, ts)
    batch = _random_pos_batch(np.random.default_rng(k), 4, k)
    ts, c_loss, a_loss = jax.jit(partial(jdd.DDPG._gradient_step, jl))(
        ts, jax.tree.map(jnp.asarray, batch))
    tb = {k_: torch.from_numpy(v) for k_, v in batch.items()}
    tc, ta = tl.gradient_step(tb)
    _close(tc, c_loss, REL, "critic loss")
    _assert_actor_loss(tl, tb, ta, a_loss, "actor loss")
    _assert_same_train_state(tl, ts, REL, "step")


def _jax_episode(jl, ts, x0, noise, indices):
    """The reference episode: a loop of the JAX package's public functions
    (dense_adj_from_pos, the OU update on the given normal draws,
    actor_forward_adj, the large-N dynamics and reward, blocked_frame,
    replay_insert_batch, a gather at the given indices and the class's
    gradient step)."""
    cfg = jl.cfg
    p, k, n = cfg.env, cfg.actor.k, cfg.env.n_agents
    r = p.comm_radius
    x = jnp.asarray(x0)
    fq = jbl.blocked_frame(x, p, True, jl._block)
    hist = jnp.concatenate([fq.values[None], jnp.zeros((k - 1, n, 6))])
    pos = jnp.broadcast_to(x[None, :, :2], (max(k - 1, 1), n, 2))
    ou = jnp.zeros((n, cfg.actor.n_a))
    buf = jl.buffer
    step = jax.jit(partial(jdd.DDPG._gradient_step, jl))
    total = c_total = a_total = 0.0
    for t in range(p.episode_steps):
        adjs = jdl.dense_adj_from_pos(pos, r)
        ou = ou + (cfg.ou_theta * (0.0 - ou) + cfg.ou_sigma * noise[t])
        mu = jdl.actor_forward_adj(ts.actor, cfg.actor, hist, adjs)
        action = jnp.clip(mu + cfg.ou_scale * ou, -1.0, 1.0)
        x2 = jln._dynamics(x, action, p, jax.random.key(0))
        fq2 = jbl.blocked_frame(x2, p, True, jl._block)
        rew = jln._reward(x2)
        sample = {"hist": hist, "pos": pos, "next_values": fq2.values,
                  "next_pos": x2[:, :2], "action": action, "reward": rew,
                  "notdone": jnp.ones(())}
        buf = jrp.replay_insert_batch(buf, jax.tree.map(lambda v: v[None],
                                                        sample))
        hist = jnp.concatenate([fq2.values[None], hist[:k - 1]])
        pos = x2[None, :, :2]                      # K = 2
        if int(buf.size) > cfg.batch_size:
            batch = jax.tree.map(lambda d: d[jnp.asarray(indices[t, 0])],
                                 buf.data)
            ts, c, a = step(ts, batch)
            c_total, a_total = c_total + float(c), a_total + float(a)
        total += float(rew)
        x = x2
    return ts, buf, total, c_total, a_total


def test_episode_matches_jax():
    """One K = 2 training episode (8 steps, updates from the fifth) from
    the JAX reset's x0, the same OU draws and replay indices: rewards,
    losses, the stored records and the train state at its end, within
    1e-4."""
    jcfg, tcfg = _large_cfgs()
    jl = jdl.DDPGLarge(jcfg)
    tl = tdl.DDPGLarge(tcfg, device="cpu")
    _load_jax_state(tl, jl.state)
    x0 = np.array(jdl._ddpg_reset(jl, jax.random.key(4)))
    T = jcfg.env.episode_steps
    noise = np.array(jax.random.normal(jax.random.key(5), (T, N, 2)))
    rng = np.random.default_rng(6)
    idx = np.stack([rng.permutation(max(t + 1, 4))[:4]
                    for t in range(T)])[:, None]
    ts, buf, r, c, a = _jax_episode(jl, jl.state, x0, noise, idx)
    tr, tc, ta = tl.episode(torch.from_numpy(x0), torch.from_numpy(noise),
                            torch.from_numpy(idx).long())
    assert tl.buffer.size == int(buf.size) == T
    for key, d in tl.buffer.data.items():
        _close(d, buf.data[key], REL_EPISODE, key)
    for got, want in ((tr, r), (tc, c), (ta, a)):
        np.testing.assert_allclose(float(got), want, rtol=REL_EPISODE)
    _assert_same_train_state(tl, ts, REL_EPISODE, "end",
                             steps=tl.timing["updates"])


def test_record_is_o_of_n_and_training_runs():
    """Episodes store the positions record, no (N, N) leaf; losses and
    evals are finite; every transition is stored."""
    _, tcfg = _large_cfgs(gn=True)
    tl = tdl.DDPGLarge(tcfg, device="cpu")
    stats = tl.train()
    assert np.isfinite([stats["mean"], stats["std"]]).all()
    assert tl.buffer.size == 2 * 8 and tl.env is None
    shapes = {k: tuple(v.shape[1:]) for k, v in tl.buffer.data.items()}
    assert shapes == {"hist": (2, N, 6), "pos": (1, N, 2),
                      "next_values": (N, 6), "next_pos": (N, 2),
                      "action": (N, 2), "reward": (), "notdone": ()}
    for v in tl.buffer.data.values():
        assert v.ndim < 3 or v.shape[-1] != v.shape[-2]


def test_reset_meets_the_contract_below_the_lattice():
    """Below the lattice regime the reset redraws until min separation and
    min degree hold (N = 48 passes ~3% of candidates, so 257 suffice), and
    takes the last candidate when none passes (no redraw allowed)."""
    _, tcfg = _large_cfgs()
    tl = tdl.DDPGLarge(tcfg, device="cpu")
    for max_resets, ok in ((256, True), (0, False)):
        tl.params = dataclasses.replace(tl.params, max_resets=max_resets)
        gen = torch.Generator().manual_seed(0)
        x, fq = tl.reset(gen)
        first = tfl._init_candidate(torch.Generator().manual_seed(0),
                                    tl.params, "cpu")
        assert x.shape == (N, 4)
        assert torch.equal(x, first) != ok
        assert ((float(fq.min_r2) >= tl.params.min_separation ** 2)
                & (float(fq.degree.min()) >= tl.params.min_degree)) == ok


def test_resume_matches_uninterrupted(tmp_path):
    _, tcfg = _large_cfgs(n_train_episodes=3)
    state = str(tmp_path / "s.npz")
    full = tdl.DDPGLarge(tcfg, device="cpu")
    full.train()
    part = tdl.DDPGLarge(tcfg, device="cpu")
    assert part.train(state_path=state, stop_after=1)["interrupted"]
    rest = tdl.DDPGLarge(tcfg, device="cpu")
    rest.train(state_path=state)
    a, b = _flat_state(full), _flat_state(rest)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("env", ["FlockingLeader-v0", "FlockingStochastic-v0"])
def test_env_params_are_the_jax_learners(tmp_path, env):
    """The JAX ``DDPGLarge`` steps, resets and evaluates ``cfg.env`` as it
    is (``algos/ddpg_large.py:203, 278, 352, 402``): the env id's variant
    (two leaders, velocity noise) is not applied. A ``cfg/ddpg_n4k.cfg``
    section under either id (N cut to 48) gives the port's learner the
    JAX config's ``FlockingParams``, field for field."""
    text = (ROOT / "cfg" / "ddpg_n4k.cfg").read_text()
    assert "env = FlockingRelative-v0" in text and "n_agents = 4096" in text
    path = tmp_path / "ddpg.cfg"
    path.write_text(text.replace("env = FlockingRelative-v0", f"env = {env}")
                    .replace("n_agents = 4096", f"n_agents = {N}"))
    jcfg = jdd.DDPGConfig.from_experiment(jconf.ExperimentConfig.from_section(
        jconf.load_ini(str(path))["n4k"]))
    tcfg = tdd.DDPGConfig.from_experiment(tconf.ExperimentConfig.from_section(
        tconf.load_ini(str(path))["n4k"]))
    assert tcfg.env_name == jcfg.env_name == env
    tl = tdl.DDPGLarge(tcfg, device="cpu")
    assert dataclasses.asdict(tl.params) == dataclasses.asdict(jcfg.env)
    assert tl.params.n_leaders == 0 and tl.params.dynamics_noise == 0.0
