"""Cross-K transfer evaluation in the port: reference-format checkpoints,
the evaluate CLI's routes and options against the JAX package's
``evaluate.py``, and the dense trajectory episode against the JAX
``rollout_trajectory``. All on the CPU at small N.

Tolerances: checkpoints load bit for bit; the trajectory episode agrees
within 1e-4 of the largest magnitude of its states and of its rewards (both
sides float32, sums in other orders, 20 steps of the closed loop).
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from multiagent_gnn_policies_tpu.algos import imitation as jim
from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu_torch import evaluate as tev
from multiagent_gnn_policies_tpu_torch.algos import imitation as tim
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import torch_import as tti
from multiagent_gnn_policies_tpu_torch.utils import checkpoint as tck


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
BASE = str(ROOT / "models" / "actor_FlockingStochastic-v0_transfer2_stoch")


def _jax_cli():
    """The JAX package's evaluate.py, loaded from the repository root."""
    spec = importlib.util.spec_from_file_location("jax_evaluate_cli",
                                                  ROOT / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _acfg(mod, k):
    return mod.ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=k, ind_agg=0)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_transfer_checkpoints_load_bit_for_bit(k):
    """Each extensionless ``transfer2_stoch{k}`` state_dict loads through
    the port to its ``.npz`` twin's arrays and to the JAX loader's, bit for
    bit; leaf_1 (layer 0's weight) is (32, 6, K)."""
    acfg = _acfg(tac, k)
    got = tev.load_actor_layers(f"{BASE}{k}", acfg)
    twin = tev.load_actor_layers(f"{BASE}{k}.npz", acfg)
    want = _jax_cli().load_actor_params(
        f"{BASE}{k}", jac.init_actor(jax.random.key(0), _acfg(jac, k)))
    assert got[0]["w"].shape == (32, 6, k)
    for g, t, w in zip(got, twin, want, strict=True):
        for name in ("w", "b"):
            assert g[name].dtype == np.float32
            np.testing.assert_array_equal(g[name], t[name])
            np.testing.assert_array_equal(g[name], np.asarray(w[name]))


@pytest.mark.parametrize("suffix", ["", ".npz"])
def test_wrong_k_checkpoint_exits_with_layer_and_shapes(suffix):
    """A K = 4 checkpoint under a K = 3 config exits naming layer 0 and
    both weight shapes, from a state_dict file and from an .npz file."""
    with pytest.raises(SystemExit) as e:
        tev.load_actor(f"{BASE}4{suffix}", _acfg(tac, 3), "cpu")
    msg = str(e.value)
    assert "layer 0" in msg and "(32, 6, 4)" in msg and "(32, 6, 3)" in msg


def test_rollout_trajectory_matches_jax():
    """The dense greedy trajectory episode from the JAX reset: states and
    rewards after each step, against ``rollout_trajectory``."""
    n, steps, k = 20, 20, 3
    jp = jfl.FlockingParams(n_agents=n, episode_steps=steps)
    env = jfl.make_env("FlockingRelative-v0", jp)
    acfg = _acfg(jac, k)
    params = jac.init_actor(jax.random.key(2), acfg)
    key = jax.random.key(4)
    jxs, jrs = jim.rollout_trajectory(params, key, env, acfg)
    reset_key, _ = jax.random.split(key)
    x0, _ = env.reset(reset_key)
    actor = tac.Actor(_acfg(tac, k))
    actor.load_state_dict(tti.actor_params_from_numpy(
        [{name: np.array(v) for name, v in layer.items()}
         for layer in params]))
    tenv = tfl.make_env("FlockingRelative-v0",
                        tfl.FlockingParams(n_agents=n, episode_steps=steps))
    xs, rs = tim.rollout_trajectory(actor.eval(), None, tenv, _acfg(tac, k),
                                    x0=torch.from_numpy(np.array(x0.x)))
    assert xs.shape == (steps, n, 4) and rs.shape == (steps,)
    for got, want in ((xs, jxs), (rs, jrs)):
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), err


CFG = """
[DEFAULT]
alg = dagger
env = FlockingRelative-v0
seed = 7
header = k, reward
dt = 0.01
n_test_episodes = 2
hidden_size = 32
v_max = 3.0
comm_radius = 1.0
n_agents = 20
n_actions = 2
n_states = 6
episode_steps = 8

[4]
k = 4

[1]
k = 1
"""


def _cfg(tmp_path, text=CFG):
    path = tmp_path / "transfer.cfg"
    path.write_text(text)
    return str(path)


def _record(monkeypatch, mod, calls):
    """Replace ``mod``'s two evaluators by recorders of (route, path, k)."""
    def blocked(section, path, k=None, **kw):
        calls.append(("large-N", path, k))
        return {"mean": 0.0, "std": 0.0}

    def dense(section, path, k=None, **kw):
        calls.append(("dense", path, k))
        return {"mean": 0.0, "std": 0.0}

    monkeypatch.setattr(mod, "evaluate_blocked", blocked)
    monkeypatch.setattr(mod, "evaluate_section", dense)


@pytest.mark.parametrize("args,route", [
    (["--actor-path", "ckpt"], "dense"),
    (["--actor-path", "ckpt", "--k", "2"], "dense"),
    (["--actor-path", "ckpt", "--n-agents", "64"], "large-N"),
    (["--expert"], "large-N"),
    (["--actor-base", "base"], "dense"),
    (["--actor-base", "base", "--n-agents", "64", "--episodes", "1"],
     "large-N"),
])
def test_cli_routes_as_the_jax_cli(tmp_path, monkeypatch, capsys, args,
                                   route):
    """The same command takes the same route, checkpoint and K in both
    CLIs: the dense path without ``--n-agents`` or ``--expert``, the
    large-N path with either; ``--actor-base`` sets each section's K and
    ``<base><K>``, ``--k`` overrides the K of ``--actor-path``."""
    cfg = _cfg(tmp_path)
    jev = _jax_cli()
    got, want = [], []
    _record(monkeypatch, tev, got)
    _record(monkeypatch, jev, want)
    tev.main([cfg, *args, "--device", "cpu"])
    jev.main([cfg, *args])
    assert got == want and {r for r, _, _ in got} == {route}
    if "--actor-base" in args:
        assert [(p, k) for _, p, k in got] == [("base4", 4), ("base1", 1)]
    out = capsys.readouterr().out.splitlines()
    assert out.count("k, reward") == 2 and out.count("4, 0.0, 0.0") == 2


def _save_state_dict(path, layers):
    torch.save({k: torch.from_numpy(v) for k, v in
                tti.actor_state_dict_from_params(layers).items()}, path)


def test_actor_base_resolves_extensionless_first(tmp_path, capsys):
    """``<base><K>`` is read when it exists, ``<base><K>.npz`` only when it
    does not: two different actors under the two names score differently,
    and each route scores the one the JAX CLI would pick."""
    base = str(tmp_path / "actor_k")
    rng = np.random.default_rng(0)
    layers = {}
    for k in (1, 4):
        acfg = _acfg(tac, k)
        for ext in ("", ".npz"):
            layers[k, ext] = [
                {"w": rng.normal(0, 0.3, (acfg.widths[i + 1], acfg.widths[i],
                                          acfg.taps(i))).astype(np.float32),
                 "b": np.zeros(acfg.widths[i + 1], np.float32)}
                for i in range(acfg.n_layers)]
        tck.save_actor_npz(f"{base}{k}.npz", layers[k, ".npz"])
    _save_state_dict(f"{base}4", layers[4, ""])
    # K = 4 has both files, K = 1 the .npz alone
    cfg = _cfg(tmp_path)
    assert tev.section_checkpoint(tev.load_ini(cfg)["4"], None, base, None) \
        == (4, f"{base}4")
    assert tev.section_checkpoint(tev.load_ini(cfg)["1"], None, base, None) \
        == (1, f"{base}1.npz")
    rows = {}
    for args in (["--actor-base", base],
                 ["--actor-path", f"{base}4", "--k", "4"],
                 ["--actor-path", f"{base}4.npz", "--k", "4"],
                 ["--actor-path", f"{base}1.npz", "--k", "1"]):
        tev.main([cfg, *args, "--device", "cpu"])
        lines = capsys.readouterr().out.splitlines()
        rows[args[1]] = [l for l in lines if l[:3] in ("4, ", "1, ")]
    assert rows[base][0] == rows[f"{base}4"][0] != rows[f"{base}4.npz"][0]
    assert rows[base][1].split(", ")[1:] == rows[f"{base}1.npz"][1].split(
        ", ")[1:]


@pytest.mark.parametrize("route", ["dense", "large-N"])
def test_k_overrides_the_section(tmp_path, capsys, route):
    """``--k 4`` evaluates a K = 4 checkpoint under K = 1 and K = 4
    sections alike (the section's K is ignored); without it the K = 1
    section exits with the shape mismatch."""
    cfg = _cfg(tmp_path)
    extra = ["--n-agents", "64", "--episodes", "1"] if route == "large-N" \
        else []
    args = [cfg, "--actor-path", f"{BASE}4", "--device", "cpu", *extra]
    tev.main(args + ["--k", "4", "--per-episode"])
    lines = capsys.readouterr().out.splitlines()
    rows = [l.split(", ") for l in lines if l[:3] in ("4, ", "1, ")]
    assert [r[0] for r in rows] == ["4", "1"]
    assert rows[0][1:] == rows[1][1:] and np.isfinite(float(rows[0][1]))
    with pytest.raises(SystemExit) as e:
        tev.main(args)
    assert "layer 0" in str(e.value)


@pytest.mark.parametrize("route", ["dense", "large-N"])
def test_save_trajectory_matches_the_jax_schema(tmp_path, monkeypatch,
                                                capsys, route):
    """``--save-trajectory`` writes the keys, shapes and dtypes the JAX
    CLI writes for the same command, and the same ``# trajectory`` line:
    dense ``x (T, N, 4)``, ``reward (T,)``; large-N also ``final_x (N, 4)``
    and ``subset_indices (M,)``, M = min(2000, N)."""
    monkeypatch.setenv("MAGNN_TPU_CACHE", "")   # no compilation cache
    cfg = _cfg(tmp_path, CFG.replace("[1]\nk = 1\n", ""))
    extra = ["--n-agents", "64", "--episodes", "1"] if route == "large-N" \
        else []
    files = {}
    for name, run in (("port", lambda a: tev.main(a + ["--device", "cpu"])),
                      ("jax", lambda a: _jax_cli().main(a))):
        files[name] = tmp_path / f"{name}.npz"
        run([cfg, "--actor-base", BASE, *extra, "--save-trajectory",
             str(files[name])])
    out = capsys.readouterr().out.splitlines()
    traj = [l.replace(str(files["port"]), "F").replace(str(files["jax"]),
                                                       "F")
            for l in out if l.startswith("# trajectory")]
    assert len(traj) == 2 and traj[0] == traj[1]
    with np.load(files["port"]) as got, np.load(files["jax"]) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].shape == want[key].shape, key
            assert got[key].dtype == want[key].dtype, key
            assert np.isfinite(got[key]).all(), key
        if route == "large-N":
            assert got["x"].shape == (8, 64, 4)
            np.testing.assert_array_equal(got["subset_indices"],
                                          want["subset_indices"])
            np.testing.assert_array_equal(got["x"][-1],
                                          got["final_x"][got[
                                              "subset_indices"]])
        else:
            assert got["x"].shape == (8, 20, 4)


def test_large_n_subset_spans_the_swarm_as_jax():
    """The recorded subset is the JAX package's rounded linspace, e.g. at
    N = 3,000 with 2,000 agents (a floor stride would record only the
    innermost 2,000): distinct, sorted, from 0 to N - 1. The port rounds
    the float64 linspace; the JAX package rounds its float32 one, so the
    two differ by one only where the exact value lies within float32
    error of a half."""
    from multiagent_gnn_policies_tpu.parallel import large_n as jln
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln

    for n, m in ((3000, 2000), (4096, 2000), (64, 64), (32768, 2000)):
        got = tln.traj_subset_indices(n, m).numpy()
        want = np.asarray(jln.traj_subset_indices(n, m))
        assert got[0] == 0 and got[-1] == n - 1 and (np.diff(got) > 0).all()
        exact = np.arange(m) * (n - 1) / (m - 1)
        off = got != want
        assert (np.abs(got - want) <= 1).all()
        assert (np.abs(exact[off] % 1 - 0.5) < 1e-3 * n / m).all()


DDPG_TOY = str(ROOT / "models" / "actor_FlockingRelative-v0_ddpg_toy_k2.npz")


def test_ddpg_section_evaluates(tmp_path, capsys):
    """A DDPG section on the dense route scores the DDPG policy class (the
    toy checkpoint under ``cfg/ddpg_toy.cfg``, here with 8 episodes): the
    header, one finite row and one reward per episode; no cell kernel is
    needed."""
    text = (ROOT / "cfg" / "ddpg_toy.cfg").read_text().replace(
        "n_test_episodes = 10", "n_test_episodes = 8")
    cfg = _cfg(tmp_path, text)
    tev.main([cfg, "--actor-path", DDPG_TOY, "--per-episode", "--device",
              "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "reward" and len(out) == 1 + 8 + 1
    name, mean, std = [v.strip() for v in out[-1].split(",")]
    assert name == "test" and np.isfinite([float(mean), float(std)]).all()
    assert float(mean) == pytest.approx(np.mean([float(v) for v in out[1:9]]),
                                        rel=1e-6)


@pytest.mark.parametrize("args,message", [
    (["--k", "2"], "--k is not supported for alg=ddpg sections"),
    (["--save-trajectory", "t.npz"],
     "--save-trajectory is not supported for alg=ddpg sections"),
], ids=["k", "save-trajectory"])
def test_ddpg_section_refuses_as_the_jax_cli(tmp_path, args, message):
    """``--k`` and ``--save-trajectory`` on a DDPG section exit non-zero in
    both CLIs with the same message, and write no file."""
    cfg = _cfg(tmp_path, (ROOT / "cfg" / "ddpg_toy.cfg").read_text())
    args = [a if a != "t.npz" else str(tmp_path / a) for a in args]
    for main, extra in ((tev.main, ["--device", "cpu"]),
                        (_jax_cli().main, [])):
        with pytest.raises(SystemExit) as e:
            main([cfg, "--actor-path", DDPG_TOY, *args, *extra])
        assert str(e.value).startswith(message), str(e.value)
    assert not (tmp_path / "t.npz").exists()
