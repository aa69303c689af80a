"""The port's agent-sharded pieces on one CPU process, against the JAX
package's (multiagent_gnn_policies_tpu_torch/ops/cells_cuda.py bands,
parallel/{mesh,sharded,distributed}.py, envs/flocking.py:dynamics):

* the plain versions of K1, K2 (6, 12, 18 columns) and K3 (6, 12) over the
  bands of D = 2, 3, 4 ranks sum to the whole grid's outputs bit for bit,
  on a grid with dropped agents (over cap and outside the grid) and
  agents in every band, the edge bands included;
* the port's banded ``frame``, ``frame_apply`` and ``apply_adjT``, summed
  over the bands, against the JAX functions with ``row_range`` and
  ``axis_name`` inside ``jax.shard_map`` over D = 2 and 4 of the virtual
  CPU devices of tests/conftest.py (Pallas kernels in interpret mode);
* ``make_pcell_spec(n_dev=)``, ``make_mesh`` shapes and refusals, the
  sharded grid build's emulated (timing) grid, ``dynamics(global_start=)``
  and ``sharded_policy_forward``.

Tolerance against the JAX package: 1e-5 of each channel's largest
magnitude (both sides float32, sums in other orders); slots, degrees,
overflow and min r² equal. Multi-rank runs are in
tests/test_torch_multihost.py.
"""

import json
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as SP

from multiagent_gnn_policies_tpu.envs.flocking import FlockingParams as JParams
from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.ops import pallas_cells as jpc
from multiagent_gnn_policies_tpu.ops.graph import aggregate as jaggregate
from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import torch_import as tim
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc
from multiagent_gnn_policies_tpu_torch.parallel import distributed as tdist
from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
from multiagent_gnn_policies_tpu_torch.parallel import mesh as tmesh
from multiagent_gnn_policies_tpu_torch.parallel.sharded import (
    sharded_policy_forward,
)

REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    w2 = want.reshape(want.shape[0], -1) if want.ndim > 1 else want[:, None]
    g2 = got.reshape(w2.shape)
    scale = np.maximum(np.abs(w2).max(0), 1e-30)
    err = np.abs(g2 - w2).max(0)
    assert (err <= rel * scale).all(), (what, err, scale)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a 24 x 26 grid of unit cells (24 rows: 2, 3 and 4 bands of whole rows):
# 700 agents spread over it, 60 in one cell (over the cap of 8) and 5 past
# its last row (outside the grid): dropped agents of both kinds
SPEC = tcc.PCellSpec(cx=24, cy=26, cap=8, cell=1.0)


def _grid_swarm():
    rng = np.random.default_rng(11)
    spread = rng.uniform((0.0, 0.0), (24.0, 26.0), (700, 2))
    clump = rng.uniform((10.1, 7.1), (10.9, 7.9), (60, 2))
    outside = rng.uniform((24.5, 0.0), (30.0, 26.0), (5, 2))
    pos = np.concatenate([spread, clump, outside]).astype(np.float32)
    vel = rng.normal(size=pos.shape).astype(np.float32)
    x = torch.from_numpy(np.concatenate([pos, vel], 1))
    grid = tcc.build_pcell_grid(x[:, :2], SPEC)
    return x, grid


def _sweep(kernel, c, x, grid, band):
    cols = torch.from_numpy(np.random.default_rng(c).normal(
        size=(x.shape[0], max(c, 1))).astype(np.float32))
    deg = tcc.frame_sweep_plain(x, grid, SPEC, 1.0, True)[:, 6]
    if kernel == "K1":
        return tcc.frame_sweep(x, grid, SPEC, 1.0, True, band=band)
    if kernel == "K2":
        return tcc.apply_deg_sweep(x, cols, deg, grid, SPEC, 1.0, band=band)
    return tcc.apply_sweep(x[:, :2].contiguous(), cols, deg.roll(3), grid,
                           SPEC, 1.0, band=band)


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("kernel,c", [("K1", 10), ("K2", 6), ("K2", 12),
                                      ("K2", 18), ("K3", 6), ("K3", 12)])
def test_plain_bands_sum_to_the_whole_grid(kernel, c, d):
    x, grid = _grid_swarm()
    assert int(grid.overflow) > 5        # over cap and outside the grid
    whole = _sweep(kernel, c, x, grid, None)
    total = torch.zeros_like(whole)
    written = torch.zeros(x.shape[0], dtype=torch.int32)
    for r in range(d):
        band = tcc.row_band(SPEC, d, r)
        out = _sweep(kernel, c, x, grid, band)
        own = tcc.band_agents(grid, SPEC, band)
        assert not out[~own].any()           # 0 outside the band
        assert own.any()                     # every band holds agents
        written += own.int()
        total += out
    assert (written == 1).all()              # each agent in one band
    assert torch.equal(total, whole)


def test_bands_are_checked():
    x, grid = _grid_swarm()
    for band in [(-1, 4), (20, 5), (3, 0)]:
        with pytest.raises(ValueError, match="band of grid rows"):
            tcc.frame_sweep(x, grid, SPEC, 1.0, True, band=band)
    with pytest.raises(ValueError, match="equal bands"):
        tcc.row_band(SPEC, 5, 0)
    assert tcc.halo_band(SPEC, (0, 6)) == (0, 7)
    assert tcc.halo_band(SPEC, (6, 6)) == (5, 8)
    assert tcc.halo_band(SPEC, (18, 6)) == (17, 7)


@pytest.mark.parametrize("n", [288, 4096, 32768, 100_000])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_pcell_spec_rounds_rows_as_jax(n, n_dev):
    js = jpc.make_pcell_spec(JParams(n_agents=n), n_dev=n_dev)
    ts = tcc.make_pcell_spec(tfl.FlockingParams(n_agents=n), n_dev=n_dev)
    assert (ts.cx, ts.cy, ts.cap, ts.cell) == (js.cx, js.cy, js.cap,
                                               js.cell)
    assert ts.cx % n_dev == 0


def _jax_banded(fn, d, jx, *args):
    """``fn(band, *args)`` in jax.shard_map over D virtual devices, each
    with its ``row_range`` and the ``agents`` axis."""
    mesh = Mesh(np.asarray(jax.devices()[:d]), axis_names=("agents",))
    return jax.jit(jax.shard_map(
        lambda *a: fn(jax.lax.axis_index("agents"), *a), mesh=mesh,
        in_specs=(SP(),) * (1 + len(args)), out_specs=SP(),
        check_vma=False))(jx, *args)


def _spec_pair(n, d, cap=8):
    jp, tp = JParams(n_agents=n), tfl.FlockingParams(n_agents=n)
    return (jp, tp, jpc.make_pcell_spec(jp, cap=cap, n_dev=d),
            tcc.make_pcell_spec(tp, cap=cap, n_dev=d))


def _swarm(n=160, spread=4.0, seed=5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 2))
    pos[:24] = rng.uniform(-0.3, 0.3, (24, 2))      # a clump over cap
    vel = rng.normal(size=(n, 2))
    return np.concatenate([pos, vel], 1).astype(np.float32)


@pytest.mark.parametrize("d", [2, 4])
def test_banded_frame_apply_matches_jax_shard_map(d):
    x = _swarm()
    n = x.shape[0]
    cols = np.random.default_rng(2).normal(size=(n, 12)).astype(np.float32)
    jp, tp, js, ts = _spec_pair(n, d)
    local = js.cx // d
    jg = jpc.build_pcell_grid(jnp.asarray(x[:, :2]), js)
    tx = torch.from_numpy(x)
    tg = tcc.build_pcell_grid(tx[:, :2], ts)
    assert int(tg.overflow) == int(jg.overflow) > 0
    np.testing.assert_array_equal(tg.slot.numpy(), np.asarray(jg.slot))

    def jfn(i, xx, cc):
        return jpc.frame_apply(xx, cc, jg, js, jp, False,
                               row_range=(i * local, local),
                               axis_name="agents", halo_devices=d)

    jfq, ja = _jax_banded(jfn, d, jnp.asarray(x), jnp.asarray(cols))
    parts = [tcc.frame_apply(tx, torch.from_numpy(cols), tg, ts, tp, False,
                             band=tcc.row_band(ts, d, r)) for r in range(d)]
    values = sum(fq.values for fq, _ in parts)
    degree = sum(fq.degree for fq, _ in parts)
    applied = sum(a for _, a in parts)
    _close(values, jfq.values, what="values")
    np.testing.assert_array_equal(degree.numpy(), np.asarray(jfq.degree))
    _close(applied, ja, what="applied")
    # the unbanded function is the sum of the bands, bit for bit
    fq1, a1 = tcc.frame_apply(tx, torch.from_numpy(cols), tg, ts, tp, False)
    assert torch.equal(values, fq1.values) and torch.equal(applied, a1)
    assert float(fq1.min_r2) == float(jfq.min_r2)


@pytest.mark.parametrize("d", [2, 4])
def test_banded_frame_matches_jax_shard_map(d):
    x = _swarm(seed=6)
    n = x.shape[0]
    jp, tp, js, ts = _spec_pair(n, d)
    local = js.cx // d
    jg = jpc.build_pcell_grid(jnp.asarray(x[:, :2]), js)
    tx = torch.from_numpy(x)
    tg = tcc.build_pcell_grid(tx[:, :2], ts)

    def jfn(i, xx):
        return jpc.frame(xx, jg, js, jp, True, row_range=(i * local, local),
                         axis_name="agents")

    jfq = _jax_banded(jfn, d, jnp.asarray(x))
    parts = [tcc.frame(tx, tg, ts, tp, True, band=tcc.row_band(ts, d, r))
             for r in range(d)]
    _close(sum(fq.values for fq in parts), jfq.values, what="values")
    np.testing.assert_array_equal(sum(fq.degree for fq in parts).numpy(),
                                  np.asarray(jfq.degree))
    assert torch.equal(sum(fq.values for fq in parts),
                       tcc.frame(tx, tg, ts, tp, True).values)


@pytest.mark.parametrize("d", [2, 4])
def test_banded_apply_adjT_matches_jax_shard_map(d):
    x = _swarm(seed=7)
    n = x.shape[0]
    rng = np.random.default_rng(8)
    cols = rng.normal(size=(n, 6)).astype(np.float32)
    deg = rng.integers(0, 6, n).astype(np.float32)
    jp, tp, js, ts = _spec_pair(n, d)
    local = js.cx // d
    jg = jpc.build_pcell_grid(jnp.asarray(x[:, :2]), js)
    tg = tcc.build_pcell_grid(torch.from_numpy(x[:, :2]), ts)

    def jfn(i, pos, dd, cc):
        return jpc.apply_adjT(pos, dd, cc, js, jp, grid=jg,
                              row_range=(i * local, local),
                              axis_name="agents")

    want = _jax_banded(jfn, d, jnp.asarray(x[:, :2]), jnp.asarray(deg),
                       jnp.asarray(cols))
    got = sum(tcc.apply_adjT(torch.from_numpy(x[:, :2]),
                             torch.from_numpy(deg), torch.from_numpy(cols),
                             ts, tp, grid=tg, band=tcc.row_band(ts, d, r))
              for r in range(d))
    _close(got, want, what="apply_adjT")


def _valid_grid(grid, spec, n):
    kept = grid.kept.long()
    assert sorted(kept.tolist()) == list(range(n))
    assert sorted(grid.order.tolist()) == list(range(n))
    cs = grid.cell_start
    assert cs[0] == 0 and (cs[1:] >= cs[:-1]).all() and cs[-1] <= n
    assert int(grid.overflow) == n - int(cs[-1])


@pytest.mark.parametrize("d", [2, 4, 8])
def test_emulated_sharded_build_gives_a_valid_grid(d):
    """The force_n_dev timing mode's grid is not the swarm's, but it is a
    grid: ``kept`` a permutation, ``cell_start`` a monotone prefix within
    N, so the kernels read only valid indices."""
    tp = tfl.FlockingParams(n_agents=4096)
    spec = tcc.make_pcell_spec(tp, n_dev=d)
    x = tfl._init_candidate(torch.Generator().manual_seed(0), tp, "cpu")
    axis = tdist.AxisGroup(None, d, 0, emulated=True)
    grid = tcc.build_pcell_grid_sharded(x[:, :2], spec, axis)
    _valid_grid(grid, spec, 4096)
    real = tcc.build_pcell_grid(x[:, :2], spec)
    assert abs(int(grid.cell_start[-1]) - int(real.cell_start[-1])) < 4096
    with pytest.raises(ValueError, match="divisible"):
        tcc.build_pcell_grid_sharded(x[:4095, :2], spec, axis)


def test_axis_group_emulation_keeps_shapes():
    axis = tdist.AxisGroup(None, 4, 1, emulated=True)
    t = torch.arange(6.0).reshape(3, 2)
    assert axis.all_gather(t).shape == (12, 2)
    assert torch.equal(axis.all_gather(t)[3:6], t)
    assert axis.all_reduce(t) is t


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank, destroyed after the test."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.initialize_distributed(f"127.0.0.1:{port}", 1, 0, platform="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(1, 1, device_type="cpu")
    assert tdist.process_info() == (0, 1)


def test_make_mesh_shapes_and_refusals(world_of_one):
    m = tmesh.make_mesh(device_type="cpu")
    assert tuple(m.mesh.shape) == (1, 1)
    assert m.mesh_dim_names == ("env", "agents")
    with pytest.raises(ValueError, match="not divisible by 2 agent shards"):
        tmesh.make_mesh(n_agent_shards=2, device_type="cpu")
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        tmesh.make_mesh(n_env=2, device_type="cpu")
    assert tdist.process_info() == (0, 1)
    assert tdist.maybe_initialize_distributed("cpu") is True
    axis = tmesh.axis_group(m)
    assert (axis.n_dev, axis.index, axis.emulated) == (1, 0, False)
    emu = tmesh.axis_group(m, force_n_dev=4)
    assert (emu.n_dev, emu.index, emu.emulated) == (4, 0, True)


def test_rollout_mesh_rules(world_of_one):
    """The JAX rules: a mesh without the axis runs the single-device
    program; force_n_dev needs a mesh; the blocked path needs D | N; a
    one-rank mesh equals no mesh bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh

    p = tfl.FlockingParams(n_agents=512, episode_steps=3)
    acfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=3)
    actor = tac.init_actor_(tac.Actor(acfg),
                            torch.Generator().manual_seed(0)).eval()

    def run(**kw):
        return tln.rollout_large(actor, acfg, torch.Generator().manual_seed(1),
                                 p, return_overflow=True, device="cpu", **kw)

    single = run()
    env_only = init_device_mesh("cpu", (1,), mesh_dim_names=("env",))
    for a, b in zip(run(mesh=env_only), single):
        assert torch.equal(a, b)
    one = tmesh.make_mesh(1, 1, device_type="cpu")
    for a, b in zip(run(mesh=one), single):
        assert torch.equal(a, b)
    for a, b in zip(run(mesh=one, path="blocked"), run(path="blocked")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="force_n_dev needs a mesh"):
        run(force_n_dev=2)
    with pytest.raises(ValueError, match="not divisible by mesh axis 3"):
        run(mesh=one, force_n_dev=3, path="blocked")
    r, x, _ = run(mesh=one, force_n_dev=4)        # emulated: runs, finite
    assert r.shape == (3,) and torch.isfinite(x).all()


@pytest.mark.parametrize("env", ["FlockingLeader-v0", "FlockingStochastic-v0"])
def test_dynamics_of_a_slice(env):
    """``global_start``: the leader mask tests global indices (as the JAX
    ``_dynamics``), and the noise is the whole swarm's draw sliced, so the
    slices of D ranks make the single-process step bit for bit."""
    n, d = 96, 4
    tp = tfl.ENV_REGISTRY[env](tfl.FlockingParams(n_agents=n))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    act = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
    whole = tfl.dynamics(x, act, tp, torch.Generator().manual_seed(9))
    local = n // d
    parts = [tfl.dynamics(x[r * local:(r + 1) * local],
                          act[r * local:(r + 1) * local], tp,
                          torch.Generator().manual_seed(9),
                          global_start=r * local) for r in range(d)]
    assert torch.equal(torch.cat(parts), whole)
    if env == "FlockingLeader-v0":
        jp = jln.FlockingParams(n_agents=n, n_leaders=tp.n_leaders)
        for r in range(d):
            sl = slice(r * local, (r + 1) * local)
            want = jln._dynamics(jnp.asarray(x[sl].numpy()),
                                 jnp.asarray(act[sl].numpy()), jp,
                                 jax.random.key(0), global_start=r * local)
            _close(parts[r], want, rel=1e-6, what=f"slice {r}")
        assert torch.equal(parts[0][:2, 2:], x[:2, 2:])   # leaders coast


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_policy_forward_matches_dense_jax(d):
    """Each rank's slice of the output-agent columns of the GSO gives its
    agents' actions of the dense JAX forward (tests/test_sharding.py's
    case)."""
    n, k = 64, 3
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=(16,), k=k, ind_agg=0)
    params = jac.init_actor(jax.random.key(0), jcfg)
    rng = np.random.default_rng(0)
    ds = rng.standard_normal((k, n, 6)).astype(np.float32)
    gso = rng.uniform(0, 0.3, (k, n, n)).astype(np.float32)
    want = np.asarray(jac.actor_forward(
        params, jcfg, jaggregate(jnp.asarray(gso), jnp.asarray(ds)), None))
    actor = tac.Actor(tac.ActorConfig(n_s=6, n_a=2, hidden=(16,), k=k))
    actor.load_state_dict(tim.actor_params_from_numpy(
        [{name: np.array(v) for name, v in layer.items()}
         for layer in params]))
    local = n // d
    got = [sharded_policy_forward(
        actor.eval(), torch.from_numpy(ds),
        torch.from_numpy(gso[:, :, r * local:(r + 1) * local]))
        for r in range(d)]
    assert all(g.shape == (local, 2) for g in got)
    _close(torch.cat(got).detach(), want, rel=1e-4)
    with pytest.raises(ValueError, match="gather"):
        sharded_policy_forward(actor, torch.from_numpy(ds),
                               torch.from_numpy(gso), gather=True)


def test_bench_scaling_band_mode_on_cpu(capsys):
    """Band mode at a tiny N on the CPU (a one-rank gloo group, destroyed
    after): a row per D, eff(1) = 1, the collectives' MB from the shapes,
    the emulation labelled, no device number (the kernels' band timing
    runs on the card only)."""
    from multiagent_gnn_policies_tpu_torch.scripts import bench_scaling

    assert bench_scaling.main(["--n", "1024", "--devs", "1", "2", "4",
                               "--steps", "3", "--repeats", "1",
                               "--device", "cpu"]) == 0
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert "collectives emulated (results not valid for D > 1)" in out
    assert "no number of this run is a device metric" in out
    rows = json.loads(out.strip().splitlines()[-1])["rows"]
    assert [r["D"] for r in rows] == [0, 1, 2, 4]     # 0: no mesh
    assert rows[0]["eff"] is None and rows[0]["collective_mb"] == 0.0
    assert rows[1]["eff"] == 1.0 and rows[1]["busy_ms"] is None
    spec = tcc.make_pcell_spec(tfl.FlockingParams(n_agents=1024), n_dev=4)
    want = 4 * (1024 * 22 + 1024 * 6 + 6 * 1024 + 2 * spec.cx * spec.cy
                + 2) / 1e6
    assert rows[2]["collective_mb"] == pytest.approx(want)


def test_bench_scaling_mesh_mode_on_cpu(capsys):
    """Mesh mode: real gloo ranks in subprocesses; the rollout's reward is
    the same at D = 1 and 2 (the sharded step is exact)."""
    from multiagent_gnn_policies_tpu_torch.scripts import bench_scaling

    assert bench_scaling.main(["--mode", "mesh", "--n", "640", "--devs",
                               "1", "2", "--steps", "3", "--repeats", "1",
                               "--device", "cpu"]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "rows"]
    assert [r["D"] for r in rows] == [1, 2]
    assert rows[0]["reward"] == rows[1]["reward"]
    assert rows[0]["overflow"] == rows[1]["overflow"] == 0


@pytest.mark.parametrize("path", ["cells", "blocked"])
def test_bench_scaling_takes_the_other_paths(capsys, path):
    """``--path cells`` and ``--path blocked`` (the JAX script's choices
    beside pcells): band mode labels the path, runs no kernel band timing
    and gives the collectives' MB of that path's step (the (N, 9) frame
    table and min r², the K-1 applies' tables, the (N, 4) state); mesh
    mode's reward is the same at D = 1 and 2 on the cells path."""
    from multiagent_gnn_policies_tpu_torch.scripts import bench_scaling

    assert bench_scaling.main(["--n", "1024", "--devs", "1", "2",
                               "--steps", "3", "--repeats", "1", "--path",
                               path, "--device", "cpu"]) == 0
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert f"N = 1024, path {path}," in out
    line = json.loads(out.strip().splitlines()[-1])
    assert line["path"] == path
    rows = line["rows"]
    assert [r["D"] for r in rows] == [0, 1, 2] and rows[1]["eff"] == 1.0
    want = 4 * (1024 * 9 + 1 + 1024 * 12 + 1024 * 6 + 1024 * 4) / 1e6
    assert rows[2]["collective_mb"] == pytest.approx(want)
    if path == "cells":
        assert bench_scaling.main(["--mode", "mesh", "--n", "640", "--devs",
                                   "1", "2", "--steps", "3", "--repeats",
                                   "1", "--path", "cells", "--device",
                                   "cpu"]) == 0
        rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
            "rows"]
        assert rows[0]["reward"] == rows[1]["reward"]
        assert rows[0]["overflow"] == rows[1]["overflow"] == 0


@pytest.mark.parametrize("tool", ["bench_scaling", "multihost_demo"])
def test_new_entry_points_refuse_without_a_card(tool):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")
    main = importlib.import_module(
        f"multiagent_gnn_policies_tpu_torch.scripts.{tool}").main
    with pytest.raises(SystemExit) as e:
        main([])
    assert "no CUDA device" in str(e.value.code)
    assert not dist.is_initialized()
