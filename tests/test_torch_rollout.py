"""Whole greedy pcells episodes of the port
(multiagent_gnn_policies_tpu_torch/parallel/large_n.py) against the JAX
package's ``rollout_large(..., path="pcells")`` (Pallas kernels in interpret
mode): K = 1 to 4 on FlockingRelative, K = 3 on the leader, drag and
two-flock variants; and the port's evaluate CLI on the CPU (checkpoints,
the expert, the grid overrides) on its large-N route (``--n-agents``).

jax.random and torch generators give different numbers, so the port is
handed the JAX reset's initial state (``x0``). Tolerance: 1e-4 of the
largest magnitude of the per-step rewards and of the final state. Both
sides run float32 with sums in different orders, and 12 steps of the
closed loop (features -> actor -> dynamics) carry those last-digit
differences forward.
"""

import configparser
import pathlib

import numpy as np
import jax
import pytest
import torch

from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.ops import pallas_cells as jpc
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu.utils import checkpoint as jck
from multiagent_gnn_policies_tpu_torch import evaluate as tev
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import torch_import as tim
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc
from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln


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
N32K = str(ROOT / "models" / "actor_FlockingRelative-v0_dagger_n32k.npz")
ACFG = dict(n_s=6, n_a=2, hidden=(32, 32), k=3)


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


_RESETS = {}


def _jax_reset(p, key):
    """The initial state ``jln.rollout_large`` draws for ``key``, its
    reset jitted as the rollout runs it; drawn once per process for each
    env and key (the K cases of an env share it), each caller given its
    own copy."""
    tag = (p, jax.random.key_data(key).tobytes())
    if tag not in _RESETS:
        cfg = jln.LargeNConfig(params=p, block=p.n_agents, rows=p.n_agents,
                               axis=None, path="pcells",
                               cell_spec=jpc.make_pcell_spec(p),
                               need_expert=False)
        reset_key, _ = jax.random.split(key)
        _RESETS[tag] = np.array(jax.jit(
            lambda k: jln._reset(cfg, k, centralized=True)[0])(reset_key))
    return _RESETS[tag].copy()


def _port_actor(params, tcfg):
    """The port's actor carrying the JAX actor's weights."""
    actor = tac.Actor(tcfg)
    actor.load_state_dict(tim.actor_params_from_numpy(
        [{name: np.array(v) for name, v in layer.items()}
         for layer in params]))
    return actor.eval()


@pytest.mark.parametrize("env,k,weights", [
    ("FlockingRelative-v0", 3, "n32k"),
    ("FlockingRelative-v0", 2, "init"),
    ("FlockingRelative-v0", 4, "init"),
    ("FlockingRelative-v0", 1, "init"),
    ("FlockingLeader-v0", 3, "init"),
    ("FlockingAirsimAccel-v0", 3, "init"),
    ("FlockingTwoFlocks-v0", 3, "init"),
])
def test_pcells_episode_matches_jax(env, k, weights):
    """The n32k checkpoint on FlockingRelative at K = 3; and an actor drawn
    by the JAX package's ``init_actor`` from a fixed key at K = 2 (no
    historical apply: K3 never runs), K = 4 (K2 on 18 columns, K3 on 12
    and 6), K = 1 (no delayed stack: K1 alone, the JAX package's unfused
    path) and on the leader, drag and two-flock variants at K = 3.
    FlockingStochastic draws its noise from each package's own generator,
    so it cannot be compared step by step."""
    n, steps = 48, 12
    jp = jfl.ENV_REGISTRY[env](jfl.FlockingParams(n_agents=n,
                                                  episode_steps=steps))
    tp = tfl.ENV_REGISTRY[env](tfl.FlockingParams(n_agents=n,
                                                  episode_steps=steps))
    acfg = dict(ACFG, k=k)
    jcfg, tcfg = jac.ActorConfig(**acfg), tac.ActorConfig(**acfg)
    params = jac.init_actor(jax.random.key(0), jcfg)
    if weights == "n32k":
        params = jck.load(N32K, params)
    key = jax.random.key(3)
    jr, jx, jovf = jln.rollout_large(params, jcfg, key, jp, path="pcells",
                                     return_overflow=True)
    x0 = _jax_reset(jp, key)
    actor = (tev.load_actor(N32K, tcfg, "cpu") if weights == "n32k"
             else _port_actor(params, tcfg))
    tr, tx, tovf = tln.rollout_large(actor, tcfg, None, tp,
                                     return_overflow=True,
                                     x0=torch.from_numpy(x0), device="cpu")
    assert int(tovf) == int(jovf) == 0
    assert tr.shape == (steps,)
    _close(tr, jr)
    _close(tx, jx)


@pytest.mark.parametrize("k", [3, 4, 2, 1])
def test_episode_runs_each_sweep_as_the_main_path_counts_it(monkeypatch, k):
    """An episode of T steps calls K1 T+1 times (reset + T), K2 T times
    for K >= 2 and K3 (K-2)·T times for K >= 3 (one per historical graph
    and step): at K = 3 T and T, at K = 4 T and 2T, at K = 1 neither. On
    the CPU the wrappers route to the plain versions, counted here (the
    kernel counters count CUDA launches only)."""
    calls = {"frame": 0, "apply_deg": 0, "apply": 0}
    for name in calls:
        plain = getattr(tcc, f"{name}_sweep_plain")

        def counted(*a, _name=name, _plain=plain, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(tcc, f"{name}_sweep_plain", counted)
    tcc.reset_launch_counts()
    steps = 5
    tp = tfl.FlockingParams(n_agents=600, episode_steps=steps)
    tcfg = tac.ActorConfig(**dict(ACFG, k=k))
    actor = (tev.load_actor(N32K, tcfg, "cpu") if k == 3
             else tac.Actor(tcfg).eval())
    r, x, ovf = tln.rollout_large(
        actor, tcfg, torch.Generator().manual_seed(0), tp,
        return_overflow=True, device="cpu")
    assert int(ovf) == 0 and torch.isfinite(r).all() and x.shape == (600, 4)
    assert calls == {"frame": steps + 1, "apply_deg": steps * (k >= 2),
                     "apply": steps * max(k - 2, 0)}
    assert set(tcc.launch_counts().values()) == {0}


EVAL_CFG = """
[DEFAULT]
alg = dagger
env = FlockingRelative-v0
seed = 5
header = reward
n_agents = 600
k = 3
hidden_size = 32
n_test_episodes = 2
episode_steps = 4
v_max = 3.0
comm_radius = 1.0
n_actions = 2
n_states = 6
dt = 0.01

[small]
fname = small
"""


def _cfg(tmp_path):
    path = tmp_path / "eval.cfg"
    path.write_text(EVAL_CFG)
    return str(path)


def test_evaluate_cli_on_cpu(tmp_path, capsys):
    tev.main([_cfg(tmp_path), "--actor-path", N32K, "--device", "cpu",
              "--per-episode", "--n-agents", "600"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "reward"
    name, mean, std = lines[-1].split(", ")
    per_ep = [float(v) for v in lines[1:-1]]
    assert name == "small" and len(per_ep) == 2
    assert float(mean) == pytest.approx(np.mean(per_ep))
    assert float(std) == pytest.approx(np.std(per_ep))
    assert np.isfinite(per_ep).all() and max(per_ep) < 0


@pytest.mark.parametrize("centralized", [True, False],
                         ids=["centralized", "decentralized"])
def test_evaluate_cli_expert_on_cpu(tmp_path, capsys, centralized):
    """``--expert`` needs no checkpoint and rolls the analytic controller
    the section names; its episode is ``rollout_large``'s expert mode under
    the CLI's episode generator."""
    cfg = tmp_path / "expert.cfg"
    cfg.write_text(EVAL_CFG + f"centralized = {centralized}\n")
    tev.main([str(cfg), "--expert", "--device", "cpu", "--per-episode"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "reward" and lines[-1].startswith("small, ")
    per_ep = [float(v) for v in lines[1:-1]]
    assert len(per_ep) == 2 and np.isfinite(per_ep).all()
    tp = tfl.FlockingParams(n_agents=600, episode_steps=4)
    r, _ = tln.rollout_large(None, None, tev.episode_generator(5, 1, "cpu"),
                             tp, centralized_expert=centralized,
                             device="cpu", expert_mode=True)
    assert per_ep[1] == float(r.sum())


def test_evaluate_cli_cell_overrides(tmp_path, capsys):
    """``--cell-edge-mult 2`` sweeps the same graph from larger cells (the
    same rewards to float32 summation order, 1e-5 relative); ``--cell-cap
    1`` overflows and exits 3."""
    args = [_cfg(tmp_path), "--actor-path", N32K, "--device", "cpu",
            "--episodes", "1", "--n-agents", "600"]
    tev.main(args)
    tev.main(args + ["--cell-edge-mult", "2.0", "--cell-cap", "64"])
    rows = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("small, ")]
    base, wide = (float(r.split(", ")[1]) for r in rows)
    assert wide == pytest.approx(base, rel=1e-5)
    with pytest.raises(SystemExit) as e:
        tev.main(args + ["--cell-cap", "1"])
    assert e.value.code == 3
    assert "overflow=" in capsys.readouterr().err


def test_evaluate_cli_needs_a_checkpoint_or_the_expert(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        tev.main([_cfg(tmp_path), "--device", "cpu"])
    assert e.value.code == 2
    assert ("exactly one of --actor-path / --actor-base is required (or "
            "pass --expert)") in capsys.readouterr().err


def test_evaluate_cli_exits_3_on_overflow(tmp_path, capsys):
    """A grid too small for the swarm drops agents: no result, status 3."""
    with pytest.raises(SystemExit) as e:
        tev.main([_cfg(tmp_path), "--actor-path", N32K, "--device", "cpu",
                  "--cell-margin", "0.3", "--episodes", "1",
                  "--n-agents", "600"])
    assert e.value.code == 3
    out = capsys.readouterr()
    assert "overflow=" in out.err
    assert "small," not in out.out


def test_evaluate_defaults_to_the_card_without_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    cp = configparser.ConfigParser()
    cp.read(_cfg(tmp_path))
    with pytest.raises((RuntimeError, AssertionError)):
        tev.evaluate_blocked(cp["small"], N32K, n_episodes=1)
