"""The port's config, environment and O(N²) graph oracle against the JAX
package, on the same numpy inputs: INI parsing (the experiment config
and ``FlockingParams.from_cfg``), the env registry, the
lattice reset's contract, the double-integrator step and reward, the
blocked frame and transpose-apply, and the delay carry. Also the rule that
the port and chip_smoke.py import neither JAX nor the JAX package.

Tolerances: float32 on both sides with sums in different orders; values
agree to 1e-5 of each channel's largest magnitude (the stated bound is
1e-4), integer quantities exactly.
"""

import ast
import dataclasses
import glob
import os
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.ops import blocked as jbl
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu.utils import config as jcfg
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.ops import blocked as tbl
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc
from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
from multiagent_gnn_policies_tpu_torch.utils import config as tcfg


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
REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    w2 = want.reshape(-1, want.shape[-1]) if want.ndim > 1 else want[:, None]
    scale = np.maximum(np.abs(w2).max(0), 1e-30)
    err = np.abs(got.reshape(w2.shape) - w2).max(0)
    assert (err <= rel * scale).all(), (what, err, scale)


def _swarm(seed, n, spread=3.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                           rng.normal(size=(n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize(
    "path", sorted(glob.glob(str(ROOT / "cfg" / "*.cfg"))),
    ids=lambda p: os.path.basename(p))
def test_config_sections_parse_equal(path):
    """Every field of the full ``ExperimentConfig``, in both packages,
    parses to the same value in every section of every cfg file."""
    assert ([f.name for f in dataclasses.fields(tcfg.ExperimentConfig)]
            == [f.name for f in dataclasses.fields(jcfg.ExperimentConfig)])
    jcp, tcp = jcfg.load_ini(path), tcfg.load_ini(path)
    assert jcp.sections() == tcp.sections()
    for name in tcp.sections() or [tcp.default_section]:
        want = jcfg.ExperimentConfig.from_section(jcp[name])
        got = tcfg.ExperimentConfig.from_section(tcp[name])
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), (name,
                                                                   f.name)
        assert got.hidden == want.hidden


def test_env_registry_matches():
    assert sorted(tfl.ENV_REGISTRY) == sorted(jfl.ENV_REGISTRY)
    for name in tfl.ENV_REGISTRY:
        want = jfl.ENV_REGISTRY[name](jfl.FlockingParams(n_agents=64))
        got = tfl.ENV_REGISTRY[name](tfl.FlockingParams(n_agents=64))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert tfl.COLLISION_R2_EPS == jfl.COLLISION_R2_EPS
    assert tfl.LATTICE_INIT_N == jfl.LATTICE_INIT_N


@pytest.mark.parametrize("n,seed", [(512, 0), (2048, 1), (4096, 2)])
def test_lattice_reset_contract(n, seed):
    """The lattice init holds min separation by construction, its density
    and radius are the uniform disc's, and every agent away from the disc's
    jagged edge starts with >= min_degree neighbours. (At the edge the JAX
    package's lattice has agents of degree 0 and 1 as well: its reset skips
    the degree test in this regime.)"""
    p = tfl.FlockingParams(n_agents=n)
    assert tfl._lattice_regime(p) == jfl._lattice_regime(
        jfl.FlockingParams(n_agents=n))
    gen = torch.Generator().manual_seed(seed)
    x = tfl._init_candidate(gen, p, "cpu")
    assert x.shape == (n, 4) and x.dtype == torch.float32
    spec = tcc.make_pcell_spec(p)
    grid = tcc.build_pcell_grid(x[:, :2], spec)
    assert int(grid.overflow) == 0
    fq = tcc.frame(x, grid, spec, p)
    assert float(fq.min_r2) >= p.min_separation ** 2
    r_max = np.sqrt(p.arena_r2_per_agent * n)
    inner = x[:, :2].norm(dim=1) < r_max - 2.0
    assert float(fq.degree[inner].min()) >= p.min_degree
    assert 5.0 < float(fq.degree.mean()) < 8.5
    assert abs(float(x[:, :2].norm(dim=1).max()) - r_max) < 2.0
    assert float(x[:, 2:].abs().max()) <= 2 * p.v_max + 1e-5


def test_small_n_reset_rejects_until_the_contract_holds():
    """Below the lattice regime the reset redraws uniform-disc candidates
    until min separation and min degree hold (the JAX package's loop)."""
    p = tfl.FlockingParams(n_agents=64)
    assert not tfl._lattice_regime(p)
    cfg = tln.LargeNConfig(params=p, cell_spec=tcc.make_pcell_spec(p))
    x, fq, grid = tln._reset(cfg, torch.Generator().manual_seed(0), "cpu")
    assert int(grid.overflow) == 0
    d2 = ((x[:, None, :2] - x[None, :, :2]) ** 2).sum(-1)
    d2.fill_diagonal_(float("inf"))
    assert float(d2.min()) >= p.min_separation ** 2
    assert int((d2 < p.comm_radius ** 2).sum(1).min()) >= p.min_degree
    np.testing.assert_array_equal(fq.degree.numpy(),
                                  (d2 < 1.0).sum(1).float().numpy())


@pytest.mark.parametrize("env", ["FlockingLeader-v0", "FlockingTwoFlocks-v0"])
def test_initial_state_variants(env):
    n = 600
    p = tfl.ENV_REGISTRY[env](tfl.FlockingParams(n_agents=n))
    x = tfl._init_candidate(torch.Generator().manual_seed(1), p, "cpu")
    if p.n_leaders:
        # leaders move with exactly the shared bias velocity
        lead = x[:p.n_leaders, 2:]
        assert torch.equal(lead, lead[:1].expand_as(lead))
        assert float(lead.abs().max()) <= p.v_max
    else:
        # two groups, left and right of the origin, with opposite biases
        left, right = x[: n // 2], x[n // 2:]
        assert float(left[:, 0].mean()) < 0 < float(right[:, 0].mean())
        bias = 0.5 * (left[:, 2:].mean(0) - right[:, 2:].mean(0))
        torch.testing.assert_close(left[:, 2:].mean(0), bias, atol=0.3,
                                   rtol=0)


def test_dynamics_noise_draws_from_the_generator():
    n = 2000
    p = tfl.FlockingParams(n_agents=n, dynamics_noise=0.05)
    x = torch.from_numpy(_swarm(2, n))
    act = torch.zeros((n, 2))
    a = tln._dynamics(x, act, p, torch.Generator().manual_seed(3))
    b = tln._dynamics(x, act, p, torch.Generator().manual_seed(3))
    clean = tln._dynamics(x, act, tfl.FlockingParams(n_agents=n))
    assert torch.equal(a, b)
    assert torch.equal(a[:, :2], clean[:, :2])
    noise = (a[:, 2:] - clean[:, 2:]) / p.dynamics_noise
    assert abs(float(noise.mean())) < 0.1 and 0.9 < float(noise.std()) < 1.1


@pytest.mark.parametrize("variant", ["relative", "leader", "drag"])
def test_dynamics_and_reward_match_jax(variant):
    n = 64
    kw = {"relative": {}, "leader": {"n_leaders": 3},
          "drag": {"drag": 0.1}}[variant]
    jp = jfl.FlockingParams(n_agents=n, **kw)
    tp = tfl.FlockingParams(n_agents=n, **kw)
    x = _swarm(3, n)
    act = np.random.default_rng(4).normal(scale=2.0,
                                          size=(n, 2)).astype(np.float32)
    want = jln._dynamics(jnp.asarray(x), jnp.asarray(act), jp,
                         jax.random.key(0))
    got = tln._dynamics(torch.from_numpy(x), torch.from_numpy(act), tp)
    _close(got, want)
    _close(tln._reward(got).reshape(1), np.asarray(jln._reward(want))[None])


@pytest.mark.parametrize("centralized", [True, False])
def test_blocked_frame_matches_jax(centralized):
    n = 96
    x = _swarm(5, n)
    want = jbl.blocked_frame(jnp.asarray(x), jfl.FlockingParams(n_agents=n),
                             centralized, block=32)
    got = tbl.blocked_frame(torch.from_numpy(x),
                            tfl.FlockingParams(n_agents=n), centralized,
                            block=32)
    _close(got.values, want.values, what="values")
    np.testing.assert_array_equal(got.degree.numpy(), np.asarray(want.degree))
    _close(got.expert, want.expert, what="expert")
    assert float(got.min_r2) == float(want.min_r2)


@pytest.mark.parametrize("given_deg", [True, False])
def test_blocked_apply_adjT_matches_jax(given_deg):
    n, c = 96, 6
    x = _swarm(6, n)
    rng = np.random.default_rng(7)
    cols = rng.normal(size=(n, c)).astype(np.float32)
    deg = rng.integers(0, 8, n).astype(np.float32) if given_deg else None
    want = jbl.blocked_apply_adjT(
        jnp.asarray(x[:, :2]), jnp.asarray(cols),
        jfl.FlockingParams(n_agents=n), 32,
        deg=None if deg is None else jnp.asarray(deg))
    got = tbl.blocked_apply_adjT(
        torch.from_numpy(x[:, :2]), torch.from_numpy(cols),
        tfl.FlockingParams(n_agents=n), 32,
        deg=None if deg is None else torch.from_numpy(deg))
    _close(got, want)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_delay_carry_matches_jax(k):
    n = 16
    rng = np.random.default_rng(k)
    vals = [rng.normal(size=(n, 6)).astype(np.float32) for _ in range(4)]
    pos = [rng.normal(size=(n, 2)).astype(np.float32) for _ in range(4)]
    deg = [rng.integers(0, 5, n).astype(np.float32) for _ in range(4)]
    jc = jbl.delay_carry_init(jnp.asarray(vals[0]), n, k)
    tc = tbl.delay_carry_init(torch.from_numpy(vals[0]), n, k)
    for t in range(1, 4):
        use_deg = k > 2
        jc = jbl.delay_carry_update(jc, jnp.asarray(vals[t]),
                                    jnp.asarray(pos[t]),
                                    jnp.asarray(deg[t]) if use_deg else None)
        tc = tbl.delay_carry_update(tc, torch.from_numpy(vals[t]),
                                    torch.from_numpy(pos[t]),
                                    torch.from_numpy(deg[t]) if use_deg
                                    else None)
    for f in ("history", "pos_hist", "deg_hist"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    if k > 2:
        with pytest.raises(ValueError, match="deg_prev"):
            tbl.delay_carry_update(tc, torch.from_numpy(vals[0]),
                                   torch.from_numpy(pos[0]))


def _port_sources():
    pkg = ROOT / "multiagent_gnn_policies_tpu_torch"
    return sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """The port runs where there is no JAX: no file of it, nor
    chip_smoke.py, imports jax or any module of the JAX package (matched
    by name, since the port's own package shares the prefix)."""
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top != "jax" and top != "multiagent_gnn_policies_tpu", (
            f"{path.name} imports {mod}")


@pytest.mark.parametrize(
    "path", sorted(glob.glob(str(ROOT / "cfg" / "*.cfg"))),
    ids=lambda p: os.path.basename(p))
def test_params_from_cfg_match_jax(path):
    """``FlockingParams.from_cfg`` reads the same four keys of every
    section of every cfg file as the JAX package, overrides included, and
    ``FlockingEnv.n_agents`` reads them back."""
    jcp, tcp = jcfg.load_ini(path), tcfg.load_ini(path)
    for name in tcp.sections() or [tcp.default_section]:
        for over in ({}, {"episode_steps": 7, "n_leaders": 2}):
            want = jfl.FlockingParams.from_cfg(jcp[name], **over)
            got = tfl.FlockingParams.from_cfg(tcp[name], **over)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (
                name, over)
            env = tfl.make_env("FlockingRelative-v0", got)
            assert env.n_agents == jfl.make_env(
                "FlockingRelative-v0", want).n_agents == got.n_agents
