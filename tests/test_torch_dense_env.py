"""The port's dense N = 100 env, delayed graph ops and replay buffer
against the JAX package, on the same numpy inputs: observe, the expert,
the step of every variant, the reward and the reset's acceptance test,
batched and unbatched; the reset's contract; the stochastic variant's
noise by its distribution; every ``ops/graph.py`` function with the
episode-start seeds and K = 1; the ring buffer's inserts and sampling.

Tolerances: float32 on both sides with sums in different orders; values
agree to 1e-5 of each channel's largest magnitude, integers, booleans and
counts exactly.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiagent_gnn_policies_tpu.algos import replay as jrp
from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.ops import graph as jgr
from multiagent_gnn_policies_tpu_torch.algos.replay import ReplayBuffer
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.ops import graph as tgr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The torch side on one thread: under the suite's xdist workers its
    intra-op threads oversubscribe the cores (the port's small ops ran
    ~20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    w2 = want.reshape(-1, want.shape[-1]) if want.ndim > 1 else want[:, None]
    scale = np.maximum(np.abs(w2).max(0), 1e-30)
    err = np.abs(got.reshape(w2.shape) - w2).max(0)
    assert (err <= rel * scale).all(), (what, err, scale)


def _swarm(seed, n, batch=(), spread=2.0):
    """Positions in a square of side 2·spread (mean degree ~2-3 at n = 24)
    with a few close pairs, and unit-normal velocities."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (*batch, n, 2))
    pos[..., 1, :] = pos[..., 0, :] + 0.05          # a pair inside 0.1
    vel = rng.normal(size=(*batch, n, 2))
    return np.concatenate([pos, vel], -1).astype(np.float32)


def _params(variant, n):
    kw = {"relative": {}, "leader": {"n_leaders": 2}, "drag": {"drag": 0.1},
          "two_flocks": {"two_flocks": True}}[variant]
    return jfl.FlockingParams(n_agents=n, **kw), tfl.FlockingParams(
        n_agents=n, **kw)


def _vmap(fn, x, batched):
    return jax.vmap(fn)(jnp.asarray(x)) if batched else fn(jnp.asarray(x))


@pytest.mark.parametrize("batched", [False, True])
def test_observe_expert_reward_and_init_ok_match_jax(batched):
    n, batch = 24, ((3,) if batched else ())
    x = _swarm(1, n, batch)
    jp, tp = jfl.FlockingParams(n_agents=n), tfl.FlockingParams(n_agents=n)
    want = _vmap(lambda v: jfl.observe(v, jp), x, batched)
    got = tfl.observe(torch.from_numpy(x), tp)
    _close(got.values, want.values, what="values")
    np.testing.assert_array_equal(got.network.numpy(),
                                  np.asarray(want.network))
    for centralized in (True, False):
        want_u = _vmap(lambda v: jfl.expert_action(v, jp, centralized), x,
                       batched)
        got_u = tfl.expert_action(torch.from_numpy(x), tp, centralized)
        _close(got_u, want_u, what=f"expert centralized={centralized}")
    _close(tfl.reward(torch.from_numpy(x)).reshape(-1),
           np.asarray(_vmap(jfl.reward, x, batched)).reshape(-1),
           what="reward")
    # the acceptance test on states that pass and states that fail
    for p_kw in ({}, {"min_separation": 0.01, "min_degree": 0},
                 {"min_separation": 0.0, "min_degree": 1}):
        jp2 = dataclasses.replace(jp, **p_kw)
        tp2 = dataclasses.replace(tp, **p_kw)
        np.testing.assert_array_equal(
            tfl._init_ok(torch.from_numpy(x), tp2).numpy(),
            np.asarray(_vmap(lambda v: jfl._init_ok(v, jp2), x, batched)))


def test_expert_clips_and_truncates():
    """Two agents at r = 0.5 (inside the unit range) and one far away: the
    potential's gradient acts inside r² <= 1 only, and a co-located pair
    saturates the clip at ±10 with a finite value."""
    x = np.array([[0.0, 0.0, 0.0, 0.0], [0.5, 0.0, 0.0, 0.0],
                  [5.0, 0.0, 0.0, 0.0], [5.0, 0.0, 0.0, 0.0]], np.float32)
    jp, tp = jfl.FlockingParams(n_agents=4), tfl.FlockingParams(n_agents=4)
    for centralized in (True, False):
        got = tfl.expert_action(torch.from_numpy(x), tp, centralized)
        _close(got, jfl.expert_action(jnp.asarray(x), jp, centralized))
        assert torch.isfinite(got).all()
        assert float(got.abs().max()) == 10.0
        # r = 0.5: grad = 2d(1/r² - 1/r⁴) = 2·(-0.5)·(4 - 16) = 12 -> -12
        # on agent 0, clipped to -10
        assert float(got[0, 0]) == -10.0


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("variant", ["relative", "leader", "drag",
                                     "two_flocks"])
def test_step_matches_jax(variant, batched):
    n, batch = 24, ((2,) if batched else ())
    jp, tp = _params(variant, n)
    x = _swarm(2, n, batch)
    act = np.random.default_rng(3).normal(
        scale=2.0, size=(*batch, n, 2)).astype(np.float32)

    def jstep(xx, aa):
        st = jfl.EnvState(x=xx, t=jnp.asarray(jp.episode_steps - 1,
                                              jnp.int32),
                          key=jax.random.key(0))
        s2, obs, r, done = jfl.step(st, aa, jp)
        return s2.x, obs.values, obs.network, r, done

    want = (jax.vmap(jstep) if batched else jstep)(jnp.asarray(x),
                                                   jnp.asarray(act))
    state = tfl.EnvState(torch.from_numpy(x), tp.episode_steps - 1)
    s2, obs, r, done = tfl.step(state, torch.from_numpy(act), tp)
    _close(s2.x, want[0], what="x")
    _close(obs.values, want[1], what="values")
    np.testing.assert_array_equal(obs.network.numpy(), np.asarray(want[2]))
    _close(r.reshape(-1), np.asarray(want[3]).reshape(-1), what="reward")
    assert s2.t == tp.episode_steps and done is True
    assert bool(np.all(np.asarray(want[4])))
    if tp.n_leaders:
        lead = s2.x[..., :tp.n_leaders, 2:]
        torch.testing.assert_close(lead, state.x[..., :tp.n_leaders, 2:],
                                   rtol=0, atol=0)


def test_stochastic_noise_matches_jax_by_distribution():
    """FlockingStochastic's velocity noise: mean 0 and std
    ``dynamics_noise`` in both packages (within 3% on 40,000 draws), the
    positions untouched by it, and the port's draw fixed by its
    generator."""
    n, b = 200, 100
    jp = jfl.ENV_REGISTRY["FlockingStochastic-v0"](jfl.FlockingParams(
        n_agents=n))
    tp = tfl.ENV_REGISTRY["FlockingStochastic-v0"](tfl.FlockingParams(
        n_agents=n))
    assert tp.dynamics_noise == jp.dynamics_noise == 0.05
    x = _swarm(4, n, (b,), spread=20.0)
    zero = np.zeros((b, n, 2), np.float32)
    clean = tfl.dynamics(torch.from_numpy(x), torch.from_numpy(zero),
                         tfl.FlockingParams(n_agents=n))
    st = tfl.EnvState(torch.from_numpy(x), 0)
    g = torch.Generator().manual_seed(5)
    noisy = tfl.step(st, torch.from_numpy(zero), tp, g)[0].x
    again = tfl.step(st, torch.from_numpy(zero), tp,
                     torch.Generator().manual_seed(5))[0].x
    assert torch.equal(noisy, again)
    assert torch.equal(noisy[..., :2], clean[..., :2])
    t_noise = ((noisy - clean)[..., 2:] / tp.dynamics_noise).numpy()

    def jstep(xx, key):
        return jfl.step(jfl.EnvState(x=xx, t=jnp.zeros((), jnp.int32),
                                     key=key), jnp.zeros((n, 2)), jp)[0].x

    jx = np.asarray(jax.vmap(jstep)(jnp.asarray(x),
                                    jax.random.split(jax.random.key(5), b)))
    j_noise = (jx - clean.numpy())[..., 2:] / jp.dynamics_noise
    for noise in (t_noise, j_noise):
        assert abs(float(noise.mean())) < 0.03
        assert abs(float(noise.std()) - 1.0) < 0.03
    assert abs(float(t_noise.std()) - float(j_noise.std())) < 0.03


@pytest.mark.parametrize("batch", [(), (6,)])
def test_reset_contract(batch):
    """Every env starts with no pair closer than ``min_separation`` and
    every agent with ``min_degree`` neighbours (N = 30, where ~9% of
    candidates pass, so a miss over 257 candidates is ~1e-11), as the JAX
    acceptance test judges it; t = 0; the observation is the state's."""
    n = 30
    tp = tfl.FlockingParams(n_agents=n)
    jp = jfl.FlockingParams(n_agents=n)
    state, obs = tfl.reset(torch.Generator().manual_seed(0), tp, batch)
    assert state.x.shape == (*batch, n, 4) and state.t == 0
    x = state.x.numpy().reshape(-1, n, 4)
    assert np.asarray(jax.vmap(lambda v: jfl._init_ok(v, jp))(
        jnp.asarray(x))).all()
    d2 = ((x[:, :, None, :2] - x[:, None, :, :2]) ** 2).sum(-1)
    d2[:, np.arange(n), np.arange(n)] = np.inf
    assert d2.min() >= tp.min_separation ** 2
    assert ((d2 < 1.0).sum(-1).min(-1) >= tp.min_degree).all()
    _close(obs.values, tfl.observe(state.x, tp).values)


@pytest.mark.parametrize("n,m", [(30, 2000), (50, 4000), (100, 8000)])
def test_reset_acceptance_rate_matches_jax(n, m):
    """The candidates have the JAX package's distribution: the shares of
    ``m`` candidates that pass the acceptance test agree within 4 standard
    errors. Both shares are printed. At N = 100 they are a few in a
    thousand, so most resets of either package run all 1 + max_resets
    candidates and take the last one, which fails the test."""
    tp, jp = tfl.FlockingParams(n_agents=n), jfl.FlockingParams(n_agents=n)
    chunk = 500
    g = torch.Generator().manual_seed(n)
    t_ok = torch.cat([tfl._init_ok(tfl._init_candidate(g, tp, "cpu",
                                                      (chunk,)), tp)
                      for _ in range(m // chunk)]).numpy()
    ok = jax.jit(jax.vmap(lambda k: jfl._init_ok(jfl._init_candidate(k, jp),
                                                 jp)))
    j_ok = np.concatenate([np.asarray(ok(jax.random.split(k, chunk)))
                           for k in jax.random.split(jax.random.key(n),
                                                     m // chunk)])
    p_t, p_j = float(t_ok.mean()), float(j_ok.mean())
    pooled = 0.5 * (p_t + p_j)
    se = np.sqrt(pooled * (1 - pooled) * 2 / m)
    print(f"N = {n}: {m} candidates each, accepted: port {p_t:.5f}, "
          f"JAX {p_j:.5f}; a reset takes its last candidate with "
          f"probability {(1 - pooled) ** (tp.max_resets + 1):.3f}")
    assert abs(p_t - p_j) <= 4 * se + 1.0 / m


def test_reset_takes_the_first_accepted_candidate_and_else_the_last():
    n, b = 20, 4
    dev = "cpu"
    # nothing can pass (min degree N): each env takes the last of the
    # 1 + max_resets candidates, and exactly that many are drawn
    tp = tfl.FlockingParams(n_agents=n, min_degree=n, max_resets=5)
    block = tfl.reset_block(tp, b)
    assert block == 6
    g, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    state, _ = tfl.reset(g, tp, (b,))
    cand = tfl._init_candidate(g2, tp, dev, (b, block))
    assert torch.equal(state.x, cand[:, -1])
    assert not tfl._init_ok(state.x, tp).any()
    assert torch.equal(g.get_state(), g2.get_state())
    # everything passes: each env takes its first candidate, one block
    tp = tfl.FlockingParams(n_agents=n, min_degree=0, min_separation=0.0)
    g, g2 = torch.Generator().manual_seed(2), torch.Generator().manual_seed(2)
    state, _ = tfl.reset(g, tp, (b,))
    cand = tfl._init_candidate(g2, tp, dev, (b, tfl.reset_block(tp, b)))
    assert torch.equal(state.x, cand[:, 0])
    assert torch.equal(g.get_state(), g2.get_state())
    # a mix, over several blocks: each env's pick is the first candidate,
    # in draw order, that the acceptance test passes
    tp = tfl.FlockingParams(n_agents=n, max_resets=40)
    old = tfl.RESET_BLOCK_ELEMS
    try:
        tfl.RESET_BLOCK_ELEMS = 3 * b * n * n            # blocks of 3
        g, g2 = (torch.Generator().manual_seed(3),
                 torch.Generator().manual_seed(3))
        state, _ = tfl.reset(g, tp, (b,))
        blocks = [tfl._init_candidate(g2, tp, dev, (b, 3))
                  for _ in range(-(-41 // 3))]
    finally:
        tfl.RESET_BLOCK_ELEMS = old
    cand = torch.cat(blocks, 1)[:, :41]
    ok = tfl._init_ok(cand, tp)
    assert ok.any(1).all() and not ok.all()
    first = ok.float().argmax(1)
    assert torch.equal(state.x, cand[torch.arange(b), first])


def test_lattice_regime_reset_is_the_candidate():
    n = 600
    tp = tfl.FlockingParams(n_agents=n)
    g, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    state, _ = tfl.reset(g, tp, (2,))
    assert torch.equal(state.x, tfl._init_candidate(g2, tp, "cpu", (2,)))
    d2 = torch.cdist(state.x[0, :, :2], state.x[0, :, :2]).fill_diagonal_(9)
    assert float(d2.min()) >= tp.min_separation


def test_make_env_and_registry():
    env = tfl.make_env("FlockingLeader-v0", tfl.FlockingParams(n_agents=10))
    assert env.params.n_leaders == 2 and env.params.n_agents == 10
    with pytest.raises(KeyError, match="unknown env"):
        tfl.make_env("Nope-v0")
    x = torch.from_numpy(_swarm(5, 10))
    st = tfl.EnvState(x, 0)
    torch.testing.assert_close(env.controller(st, centralized=False),
                               tfl.expert_action(x, env.params, False))
    torch.testing.assert_close(env.controller(st),        # centralized
                               tfl.expert_action(x, env.params, True))
    torch.testing.assert_close(env.observe(st).values,
                               tfl.observe(x, env.params).values)


# --- ops/graph.py ---


def _graph_inputs(seed, n, f, t, batch=()):
    rng = np.random.default_rng(seed)
    nets, vals = [], []
    for _ in range(t):
        pos = rng.uniform(-1.5, 1.5, (*batch, n, 2))
        d2 = ((pos[..., :, None, :] - pos[..., None, :, :]) ** 2).sum(-1)
        adj = (d2 < 1.0) & ~np.eye(n, dtype=bool)
        adj[..., 0, :] = False                  # an isolated agent
        adj[..., :, 0] = False
        nets.append(adj.astype(np.float32))
        vals.append(rng.normal(size=(*batch, n, f)).astype(np.float32))
    return nets, vals


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("batched", [False, True])
def test_graph_ops_match_jax(k, batched):
    n, f, steps = 10, 6, 4
    batch = (2,) if batched else ()
    adjs, vals = _graph_inputs(k, n, f, steps, batch)
    vm = (lambda fn: jax.vmap(fn)) if batched else (lambda fn: fn)
    nets = [tgr.normalized_adjacency(torch.from_numpy(a)) for a in adjs]
    jnets = [vm(jgr.normalized_adjacency)(jnp.asarray(a)) for a in adjs]
    for a, b in zip(nets, jnets):
        _close(a, b, what="normalized_adjacency")
    assert float(nets[0][..., 0, :].abs().sum()) == 0.0   # isolated: zeros

    tgs = tgr.initial_graph_state(torch.from_numpy(vals[0]), nets[0], k)
    jgs = vm(lambda v, a: jgr.initial_graph_state(v, a, k, True))(
        jnp.asarray(vals[0]), jnets[0])
    # the episode-start seeds: delay_gso = [I, 0, ...], state = [x_0, 0, ...]
    eye = np.broadcast_to(np.eye(n, dtype=np.float32), (*batch, n, n))
    np.testing.assert_array_equal(tgs.delay_gso[..., 0, :, :].numpy(), eye)
    assert float(tgs.delay_gso[..., 1:, :, :].abs().sum()) == 0.0
    np.testing.assert_array_equal(tgs.delay_state[..., 0, :, :].numpy(),
                                  vals[0])
    assert float(tgs.delay_state[..., 1:, :, :].abs().sum()) == 0.0
    for t in range(steps):
        if t:
            tgs = tgr.update_graph_state(tgs, torch.from_numpy(vals[t]),
                                         nets[t])
            jgs = vm(lambda g, v, a: jgr.update_graph_state(g, v, a, True))(
                jgs, jnp.asarray(vals[t]), jnets[t])
        for name in ("values", "network", "delay_gso", "delay_state"):
            got, want = getattr(tgs, name), np.asarray(getattr(jgs, name))
            assert got.shape == want.shape, name
            _close(got, want, what=f"{name} t={t}")
        # the port's state holds no powers; gso_powers gives JAX's curr_gso
        _close(tgr.gso_powers(tgs.network, k), jgs.curr_gso,
               what=f"gso_powers t={t}")
        _close(tgr.aggregate(tgs.delay_gso, tgs.delay_state),
               vm(jgr.aggregate)(jgs.delay_gso, jgs.delay_state),
               what="aggregate")
    assert tgr.GraphState._fields == ("values", "network", "delay_gso",
                                      "delay_state")
    _close(tgr.gso_powers(nets[1], k), vm(lambda a: jgr.gso_powers(a, k))(
        jnets[1]), what="gso_powers")
    _close(tgr.delayed_gso_update(nets[2], tgs.delay_gso),
           vm(jgr.delayed_gso_update)(jnets[2], jgs.delay_gso),
           what="delayed_gso_update")
    _close(tgr.history_shift(tgs.delay_state, torch.from_numpy(vals[1])),
           vm(jgr.history_shift)(jgs.delay_state, jnp.asarray(vals[1])),
           what="history_shift")


# --- algos/replay.py ---


def _records(t, start=0):
    return {"a": np.arange(start, start + t, dtype=np.float32)[:, None]
            * np.ones((1, 3), np.float32),
            "b": np.arange(start, start + t, dtype=np.int32)}


def test_replay_inserts_wrap_like_jax():
    cap = 10
    ex = {"a": torch.zeros(3), "b": torch.zeros((), dtype=torch.int32)}
    buf = ReplayBuffer(cap, ex)
    jbuf = jrp.replay_init(cap, {"a": jnp.zeros(3),
                                 "b": jnp.zeros((), jnp.int32)})
    for t, start in ((6, 0), (6, 6), (3, 12), (10, 15)):
        rec = _records(t, start)
        buf.insert({k: torch.from_numpy(v) for k, v in rec.items()})
        jbuf = jrp.replay_insert_batch(jbuf, {k: jnp.asarray(v)
                                              for k, v in rec.items()})
        assert (buf.size, buf.cursor) == (int(jbuf.size), int(jbuf.cursor))
        for k in ex:
            np.testing.assert_array_equal(buf.data[k].numpy(),
                                          np.asarray(jbuf.data[k]))
    assert buf.size == cap and buf.capacity == cap
    with pytest.raises(ValueError, match="exceeds buffer capacity"):
        buf.insert({k: torch.from_numpy(v)
                    for k, v in _records(cap + 1).items()})


def test_replay_samples_distinct_filled_slots_uniformly():
    cap, filled, batch, draws = 16, 6, 3, 6000
    buf = ReplayBuffer(cap, {"a": torch.zeros(3),
                             "b": torch.zeros((), dtype=torch.int32)})
    buf.insert({k: torch.from_numpy(v)
                for k, v in _records(filled).items()})
    g = torch.Generator().manual_seed(7)
    counts = np.zeros(cap, np.int64)
    for _ in range(draws):
        s = buf.sample(g, batch)
        idx = s["b"].numpy()
        assert len(set(idx.tolist())) == batch
        assert ((idx >= 0) & (idx < filled)).all()
        np.testing.assert_array_equal(s["a"].numpy()[:, 0], idx)
        counts[idx] += 1
    # uniform: each filled slot is drawn draws·batch/filled = 3000 times;
    # 4 standard deviations of a binomial(6000, 1/2) is ~155
    assert counts[filled:].sum() == 0
    assert np.abs(counts[:filled] - draws * batch / filled).max() < 155
