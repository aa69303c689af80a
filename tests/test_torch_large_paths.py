"""``rollout_large``'s blocked, cells and binned paths and episode chains,
on the CPU: the blocked path (``blocked_frame`` frames, the
``delayed_ystack`` stack), the cells path (``ops/cells.py``) and the binned
path (``ops/binned.py``, also as ``sparse=True``) against the JAX
package's ``rollout_large`` of the same path and against the port's
pcells path, the block size, ``n_episodes`` against a loop of single
episodes, and an unknown path's refusal.

jax.random and torch generators give different numbers, so the port is
handed the JAX reset's initial state (``x0``). Tolerance: 1e-4 of the
largest magnitude of the per-step rewards and of the final state (the
episode tolerance: both sides run float32 with sums in other orders, and
the closed loop carries those last-digit differences forward).
"""

import jax
import pytest
import torch

from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.ops import blocked as tbl
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc
from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln

from test_torch_rollout import ACFG, _close, _jax_reset, _port_actor

N_BLOCKED, T_BLOCKED = 600, 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the suite runs several test
    processes side by side, and many small parallel operations on an
    oversubscribed CPU are far slower than on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_blocked_episode_matches_jax(k):
    """The blocked path (``blocked_frame`` frames, the ``delayed_ystack``
    stack) against the JAX package's ``rollout_large(path="blocked")`` on
    the JAX reset's x0 (N = 600, the lattice regime) and JAX-initialised
    weights: rewards and final state within 1e-4, overflow 0 on both."""
    jp = jfl.FlockingParams(n_agents=N_BLOCKED, episode_steps=T_BLOCKED)
    tp = tfl.FlockingParams(n_agents=N_BLOCKED, episode_steps=T_BLOCKED)
    acfg = dict(ACFG, k=k)
    jcfg, tcfg = jac.ActorConfig(**acfg), tac.ActorConfig(**acfg)
    params = jac.init_actor(jax.random.key(k), jcfg)
    key = jax.random.key(5)
    jr, jx, jovf = jln.rollout_large(params, jcfg, key, jp, path="blocked",
                                     return_overflow=True)
    tr, tx, tovf = tln.rollout_large(
        _port_actor(params, tcfg), tcfg, None, tp, return_overflow=True,
        x0=torch.from_numpy(_jax_reset(jp, key)), device="cpu",
        path="blocked")
    assert int(tovf) == int(jovf) == 0
    assert tr.shape == (T_BLOCKED,)
    _close(tr, jr)
    _close(tx, jx)


@pytest.mark.parametrize("mode", ["policy", "expert"])
def test_blocked_path_matches_pcells_and_sweeps_no_cell(monkeypatch, mode):
    """The port's two paths on the same x0 and policy (or the expert):
    rewards and final state within 1e-4. The blocked path calls no cell
    sweep (on the CPU the wrappers' plain versions, counted here; on the
    card its kernel counters read 0) and reports overflow 0."""
    n, steps = N_BLOCKED, T_BLOCKED
    p = tfl.FlockingParams(n_agents=n, episode_steps=steps)
    tcfg = tac.ActorConfig(**ACFG)
    actor = tac.init_actor_(tac.Actor(tcfg),
                            torch.Generator().manual_seed(0)).eval()
    x0 = tfl._init_candidate(torch.Generator().manual_seed(1), p, "cpu")
    kw = dict(return_overflow=True, x0=x0, device="cpu",
              expert_mode=mode == "expert")
    pr, px, povf = tln.rollout_large(actor, tcfg, None, p, **kw)
    calls = []
    for name in ("frame", "apply_deg", "apply"):
        monkeypatch.setattr(tcc, f"{name}_sweep_plain",
                            lambda *a, _n=name, **k: calls.append(_n))
    br, bx, bovf = tln.rollout_large(actor, tcfg, None, p, path="blocked",
                                     **kw)
    assert calls == [] and int(bovf) == int(povf) == 0
    _close(br, pr)
    _close(bx, px)


def test_block_rows_divide_n_and_bound_memory():
    """Blocks divide N, hold about 2^25 (row, agent) pairs, and stay in
    [128, 1024] rows where N has such a divisor."""
    for n in (600, 2048, 10_000, 12_288, 32_768):
        b = tln.block_rows(n)
        assert n % b == 0 and b * n <= max(tln.BLOCK_PAIRS, 128 * n)
    assert tln.block_rows(32_768) == 1024 and tln.block_rows(10_000) == 1000
    assert tbl.pick_block(600) == jln.pick_block(600) == 120
    assert tbl.pick_block(97, 50) == jln.pick_block(97, 50) == 1


@pytest.mark.parametrize("path", ["pcells", "blocked", "cells", "binned"])
def test_n_episodes_is_a_loop_of_single_episodes(path):
    """``n_episodes = 3`` equals three consecutive single episodes from
    the same generator, bit for bit: the concatenated rewards, the last
    final state, the max overflow. Below the lattice regime (N = 48) each
    reset draws candidates from the generator, so the stream is shared."""
    p = tfl.FlockingParams(n_agents=48, episode_steps=6)
    tcfg = tac.ActorConfig(**ACFG)
    actor = tac.init_actor_(tac.Actor(tcfg),
                            torch.Generator().manual_seed(0)).eval()
    kw = dict(return_overflow=True, device="cpu", path=path)
    gen = torch.Generator().manual_seed(9)
    singles = [tln.rollout_large(actor, tcfg, gen, p, **kw)
               for _ in range(3)]
    gen = torch.Generator().manual_seed(9)
    r, x, ovf = tln.rollout_large(actor, tcfg, gen, p, n_episodes=3, **kw)
    assert torch.equal(r, torch.cat([s[0] for s in singles]))
    assert torch.equal(x, singles[-1][1])
    assert int(ovf) == max(int(s[2]) for s in singles)
    assert r.shape == (18,)
    with pytest.raises(ValueError, match="n_episodes > 1 is timing-oriented"):
        tln.rollout_large(actor, tcfg, gen, p, n_episodes=2, traj_agents=4,
                          device="cpu")


@pytest.mark.parametrize("kw", [dict(path="nonsense")], ids=["unknown"])
def test_unported_backends_raise(kw):
    """A path that is none of ``PATHS`` raises before any work (every path
    of the JAX package is ported)."""
    p = tfl.FlockingParams(n_agents=48, episode_steps=2)
    tcfg = tac.ActorConfig(**ACFG)
    assert set(tln.PATHS) == {"pcells", "blocked", "cells", "binned"}
    with pytest.raises(ValueError, match="unknown path"):
        tln.rollout_large(tac.Actor(tcfg), tcfg, None, p, device="cpu", **kw)


@pytest.mark.parametrize("kw,k", [
    (dict(path=path), k) for path in ("cells", "binned") for k in range(4)
] + [(dict(sparse=True), 0), (dict(sparse=True), 3)], ids=[
    f"{path}-{k and f'k{k}' or 'expert'}" for path in ("cells", "binned")
    for k in range(4)] + ["sparse-expert", "sparse-k3"])
def test_cells_and_binned_episodes_match_jax(kw, k):
    """The cells and binned paths (and ``sparse=True``, the alias for
    "binned") against the JAX package's ``rollout_large`` of the same path
    from the JAX reset's x0 (N = 600, the lattice regime), for the expert
    (k = 0) and JAX-initialised K = 1, 2, 3 policies: rewards and final
    state within 1e-4, overflow 0 on both. No cell kernel runs."""
    jp = jfl.FlockingParams(n_agents=N_BLOCKED, episode_steps=T_BLOCKED)
    tp = tfl.FlockingParams(n_agents=N_BLOCKED, episode_steps=T_BLOCKED)
    key = jax.random.key(5)
    x0 = torch.from_numpy(_jax_reset(jp, key))
    if k:
        acfg = dict(ACFG, k=k)
        jcfg, tcfg = jac.ActorConfig(**acfg), tac.ActorConfig(**acfg)
        params = jac.init_actor(jax.random.key(k), jcfg)
        actor = _port_actor(params, tcfg)
    else:
        jcfg = tcfg = params = actor = None
    jr, jx, jovf = jln.rollout_large(params, jcfg, key, jp, expert_mode=not k,
                                     return_overflow=True, **kw)
    tcc.reset_launch_counts()
    tr, tx, tovf = tln.rollout_large(actor, tcfg, None, tp, x0=x0,
                                     expert_mode=not k, return_overflow=True,
                                     device="cpu", **kw)
    assert not any(tcc.launch_counts().values())
    assert int(tovf) == int(jovf) == 0
    assert tr.shape == (T_BLOCKED,)
    _close(tr, jr)
    _close(tx, jx)


@pytest.mark.parametrize("mode", ["policy", "expert"])
@pytest.mark.parametrize("path", ["cells", "binned"])
def test_cells_and_binned_match_pcells(monkeypatch, path, mode):
    """The cells and binned paths against the port's pcells path on the
    same x0 and policy (or the expert): rewards and final state within
    1e-4, overflow 0; they call no cell sweep (on the CPU the wrappers'
    plain versions, counted here)."""
    p = tfl.FlockingParams(n_agents=N_BLOCKED, episode_steps=T_BLOCKED)
    tcfg = tac.ActorConfig(**ACFG)
    actor = tac.init_actor_(tac.Actor(tcfg),
                            torch.Generator().manual_seed(0)).eval()
    x0 = tfl._init_candidate(torch.Generator().manual_seed(1), p, "cpu")
    kw = dict(return_overflow=True, x0=x0, device="cpu",
              expert_mode=mode == "expert")
    pr, px, povf = tln.rollout_large(actor, tcfg, None, p, **kw)
    calls = []
    for name in ("frame", "apply_deg", "apply"):
        monkeypatch.setattr(tcc, f"{name}_sweep_plain",
                            lambda *a, _n=name, **k: calls.append(_n))
    r, x, ovf = tln.rollout_large(actor, tcfg, None, p, path=path, **kw)
    assert calls == [] and int(ovf) == int(povf) == 0
    _close(r, pr)
    _close(x, px)
