"""The port's cell sweeps (multiagent_gnn_policies_tpu_torch/ops/cells_cuda.py)
against the JAX package's (ops/pallas_cells.py, Pallas kernels in interpret
mode on the CPU): the grid build and its overflow count, frame, frame_apply,
apply_adjT, ystack_pre and the O(N²) delayed_ystack, on the same numpy
inputs; and the route frame_apply + ystack_pre against JAX ystack. On
the CPU every port wrapper takes its kernel's plain PyTorch version; the
kernels themselves are held against those plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: both sides compute in float32 over the same candidates but sum
in different orders, so a channel agrees to a few float32 ulps of its
largest magnitude. They are asserted at 1e-5 of that magnitude (the
repository's stated bound is 1e-4); integer quantities (slots, overflow,
degrees) must be equal.
"""

import functools
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiagent_gnn_policies_tpu.envs.flocking import FlockingParams as JParams
from multiagent_gnn_policies_tpu.ops import blocked as jbl
from multiagent_gnn_policies_tpu.ops import pallas_cells as jpc
from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams as TParams,
    _init_candidate,
)
from multiagent_gnn_policies_tpu_torch.ops import blocked as tbl
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc


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
    """|got - want| <= rel * max|want| per channel (last axis)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    w2 = want.reshape(-1, want.shape[-1]) if want.ndim > 1 else want[:, None]
    g2 = got.reshape(w2.shape)
    scale = np.maximum(np.abs(w2).max(0), 1e-30)
    err = np.abs(g2 - w2).max(0)
    assert (err <= rel * scale).all(), (what, err, scale)


def _swarm(seed, n, spread):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 2))
    vel = rng.normal(size=(n, 2))
    return np.concatenate([pos, vel], 1).astype(np.float32)


def _specs(n, cap=16):
    jp, tp = JParams(n_agents=n), TParams(n_agents=n)
    return jp, tp, jpc.make_pcell_spec(jp, cap=cap), tcc.make_pcell_spec(
        tp, cap=cap)


def _expert(x, per, centralized):
    """The JAX package's expert from the port's K1 channels (the port ships
    no expert: its greedy policy path never reads one). The centralized
    velocity consensus sum_{j != i}(v_i - v_j) = N·v_i - sum_j v_j is taken
    in float64 here; the JAX package compensates it in float32."""
    x, per = np.asarray(x, np.float64), np.asarray(per, np.float64)
    if centralized:
        cons = x.shape[0] * x[:, 2:4] - x[:, 2:4].sum(0)
    else:
        cons = per[:, [0, 3]]
    return np.clip(-(cons + per[:, 7:9]), -10.0, 10.0)


def _grids(x, js, ts):
    return (jpc.build_pcell_grid(jnp.asarray(x[:, :2]), js),
            tcc.build_pcell_grid(torch.from_numpy(x[:, :2]), ts))


# (seed, n, spread, cap): a sparse swarm, and a dense one whose cells
# overflow cap = 8
SPARSE = (0, 48, 3.0, 16)
DENSE = (5, 128, 1.2, 8)


@pytest.mark.parametrize("case", ["sparse", "dense", "coincident",
                                  "out_of_grid"])
def test_grid_matches_jax(case):
    if case in ("sparse", "dense"):
        seed, n, spread, cap = SPARSE if case == "sparse" else DENSE
        pos = _swarm(seed, n, spread)[:, :2]
        _, _, js, ts = _specs(n, cap)
    elif case == "coincident":
        # 20 agents in one cell of capacity 8: 12 must be counted dropped
        pos = (np.arange(20, dtype=np.float32)[:, None] * 1e-3).repeat(2, 1)
        js = jpc.PCellSpec(cx=4, cy=4, cap=8, cell=1.0)
        ts = tcc.PCellSpec(cx=4, cy=4, cap=8, cell=1.0)
    else:
        pos = np.array([[0.0, 0.0], [0.5, 0.5], [100.0, 100.0]], np.float32)
        js = jpc.PCellSpec(cx=4, cy=4, cap=8, cell=1.0)
        ts = tcc.PCellSpec(cx=4, cy=4, cap=8, cell=1.0)
    jg = jpc.build_pcell_grid(jnp.asarray(pos), js)
    tg = tcc.build_pcell_grid(torch.from_numpy(pos), ts)
    np.testing.assert_array_equal(tg.slot.numpy(), np.asarray(jg.slot))
    assert int(tg.overflow) == int(jg.overflow)
    if case in ("dense", "coincident", "out_of_grid"):
        assert int(tg.overflow) > 0
    # the port's cell ranges of kept agents are the inverse of the slots:
    # each kept agent lies in its slot's cell range, in slot-rank order
    slot = tg.slot.numpy()
    cap, cy = ts.cap, ts.cy
    kept, start = tg.kept.numpy(), tg.cell_start.numpy()
    for a in np.flatnonzero(slot >= 0):
        s = slot[a]
        cell = (s // (cap * cy)) * cy + s % cy
        assert a in kept[start[cell]:start[cell + 1]]
    ranks = (slot[kept[:start[-1]]] // cy) % cap
    cells = slot[kept[:start[-1]]] // (cap * cy) * cy + slot[kept[:start[-1]]] % cy
    assert (np.diff(cells * cap + ranks) > 0).all()
    assert start[-1] == (slot >= 0).sum()
    assert sorted(tg.order.numpy()) == list(range(pos.shape[0]))


@pytest.mark.parametrize("centralized", [True, False])
def test_frame_matches_jax(centralized):
    seed, n, spread, cap = SPARSE
    x = _swarm(seed, n, spread)
    jp, tp, js, ts = _specs(n, cap)
    jg, tg = _grids(x, js, ts)
    want = jpc.frame(jnp.asarray(x), jg, js, jp, centralized)
    got = tcc.frame(torch.from_numpy(x), tg, ts, tp, centralized)
    _close(got.values, want.values, what="values")
    np.testing.assert_array_equal(got.degree.numpy(), np.asarray(want.degree))
    assert got.expert is None
    per = tcc.frame_sweep(torch.from_numpy(x), tg, ts, 1.0, centralized)
    _close(_expert(x, per, centralized), want.expert, what="expert")
    assert float(got.min_r2) == float(want.min_r2)


@pytest.mark.parametrize("c", [12, 18])
def test_frame_apply_matches_jax_on_overflowing_swarm(c):
    """Dropped agents (over cap) are nobody's neighbour and get zeros, on
    both sides; the fused apply normalises by the new graph's degrees. 12
    columns are K = 3's s = 0 block, 18 K = 4's."""
    seed, n, spread, cap = DENSE
    x = _swarm(seed, n, spread)
    cols = np.random.default_rng(1).normal(size=(n, c)).astype(np.float32)
    jp, tp, js, ts = _specs(n, cap)
    jg, tg = _grids(x, js, ts)
    assert int(tg.overflow) == int(jg.overflow) > 0
    jfq, ja = jpc.frame_apply(jnp.asarray(x), jnp.asarray(cols), jg, js, jp,
                              False)
    tfq, ta = tcc.frame_apply(torch.from_numpy(x), torch.from_numpy(cols),
                              tg, ts, tp, False)
    _close(tfq.values, jfq.values, what="values")
    np.testing.assert_array_equal(tfq.degree.numpy(), np.asarray(jfq.degree))
    per = tcc.frame_sweep(torch.from_numpy(x), tg, ts, 1.0, False)
    _close(_expert(x, per, False), jfq.expert, what="expert")
    assert float(tfq.min_r2) == float(jfq.min_r2)
    _close(ta, ja, what="applied")


@pytest.mark.parametrize("c", [1, 6, 18, 24])
def test_apply_adjT_matches_jax(c):
    """Any column count: 18 is K = 4's widest block; 24 (K = 5) is wider
    than any kernel width and goes in chunks on the card."""
    seed, n, spread, cap = SPARSE
    x = _swarm(seed + 3, n, spread)
    rng = np.random.default_rng(4)
    cols = rng.normal(size=(n, c)).astype(np.float32)
    deg = rng.integers(0, 6, n).astype(np.float32)
    jp, tp, js, ts = _specs(n, cap)
    jg, tg = _grids(x, js, ts)
    want = jpc.apply_adjT(jnp.asarray(x[:, :2]), jnp.asarray(deg),
                          jnp.asarray(cols), js, jp, grid=jg)
    got = tcc.apply_adjT(torch.from_numpy(x[:, :2]), torch.from_numpy(deg),
                         torch.from_numpy(cols), ts, tp, grid=tg)
    _close(got, want, what="apply_adjT")
    # the grid is rebuilt from the positions when not given
    _close(tcc.apply_adjT(torch.from_numpy(x[:, :2]), torch.from_numpy(deg),
                          torch.from_numpy(cols), ts, tp), want)


def test_ystack_pre_matches_jax():
    """K = 3: slot 0 is the raw history, slot 1 the pre-applied s0 output,
    slot 2 one more apply over the carried historical graph."""
    k, n = 3, 48
    rng = np.random.default_rng(7)
    jp, tp, js, ts = _specs(n)
    hist = rng.normal(size=(k, n, 6)).astype(np.float32)
    pos_hist = _swarm(8, n, 3.0)[None, :, :2]
    deg_hist = rng.integers(1, 5, (1, n)).astype(np.float32)
    s0 = rng.normal(size=(n, (k - 1) * 6)).astype(np.float32)
    jcarry = jbl.DelayCarry(jnp.asarray(hist), jnp.asarray(pos_hist),
                            jnp.asarray(deg_hist))
    tcarry = tbl.DelayCarry(torch.from_numpy(hist), torch.from_numpy(pos_hist),
                            torch.from_numpy(deg_hist))
    jg = jpc.build_pcell_grid(jnp.asarray(pos_hist[0]), js)
    tg = tcc.build_pcell_grid(torch.from_numpy(pos_hist[0]), ts)
    want = jpc.ystack_pre(jcarry, jnp.asarray(s0), js, jp, grid_hist=(jg,))
    got = tcc.ystack_pre(tcarry, torch.from_numpy(s0), ts, tp,
                         grid_hist=(tg,))
    assert got.shape == (k, n, 6)
    _close(got.reshape(-1, 6), np.asarray(want).reshape(-1, 6))


@pytest.mark.parametrize("k", [1, 4])
def test_delayed_ystack_matches_jax(k):
    """The O(N²) oracle of the delayed stack at K = 1 (the history slot
    alone) and K = 4 (three applies over the current and two historical
    graphs); at K = 4 the cell path's ystack_pre, given the s = 0 apply
    over the current graph, builds the same stack."""
    n, f = 48, 6
    rng = np.random.default_rng(10 + k)
    jp, tp, _, ts = _specs(n)
    hist = rng.normal(size=(k, n, f)).astype(np.float32)
    x_now = _swarm(20, n, 3.0)
    pos_hist = np.zeros((max(k - 2, 0), n, 2), np.float32)
    deg_hist = torch.zeros((max(k - 2, 0), n))
    for s in range(k - 2):
        x_s = _swarm(21 + s, n, 3.0)
        pos_hist[s] = x_s[:, :2]
        deg_hist[s] = tbl.blocked_frame(torch.from_numpy(x_s), tp,
                                        block=n).degree
    t_pos_hist = torch.from_numpy(pos_hist)
    deg_now = tbl.blocked_frame(torch.from_numpy(x_now), tp, block=n).degree
    jcarry = jbl.DelayCarry(jnp.asarray(hist), jnp.asarray(pos_hist),
                            jnp.asarray(deg_hist.numpy()))
    tcarry = tbl.DelayCarry(torch.from_numpy(hist), t_pos_hist, deg_hist)
    want = jbl.delayed_ystack(jcarry, jnp.asarray(x_now[:, :2]), jp, n,
                              deg_now=jnp.asarray(deg_now.numpy()))
    got = tbl.delayed_ystack(tcarry, torch.from_numpy(x_now[:, :2]), tp, n,
                             deg_now=deg_now)
    assert got.shape == (k, n, f)
    _close(got.reshape(-1, f), np.asarray(want).reshape(-1, f))
    if k == 1:
        return
    x_t = torch.from_numpy(x_now)
    grid = tcc.build_pcell_grid(x_t[:, :2], ts)
    s0_cols = tcarry.history[1:].transpose(0, 1).reshape(n, (k - 1) * f)
    _, s0 = tcc.frame_apply(x_t, s0_cols, grid, ts, tp)
    grid_hist = tuple(tcc.build_pcell_grid(ph, ts) for ph in t_pos_hist)
    pre = tcc.ystack_pre(tcarry, s0, ts, tp, grid_hist=grid_hist)
    _close(pre.reshape(-1, f), got.reshape(-1, f), rel=1e-4)


@pytest.mark.parametrize("k,max_cols", [(3, None), (4, 6)],
                         ids=["k3-one-sweep", "k4-chunked"])
def test_ystack_route_matches_jax_ystack(k, max_cols):
    """JAX ``ystack`` does every delayed apply in one call; the port
    splits it: :func:`frame_apply` does the s = 0 apply over the current
    graph in the step's fused pass (K2), ``ystack_pre`` the historical
    ones (K3). With the grids carried as the rollout carries them, the
    port's route gives the JAX stack, also against JAX's column chunks
    (``max_cols = 6``, the 1M rollout's setting)."""
    n, f = 48, 6
    rng = np.random.default_rng(30 + k)
    jp, tp, js, ts = _specs(n)
    hist = rng.normal(size=(k, n, f)).astype(np.float32)
    x_now = _swarm(40 + k, n, 3.0)
    x_hist = [_swarm(50 + k + s, n, 3.0) for s in range(k - 2)]
    pos_hist = np.stack([x[:, :2] for x in x_hist])
    deg_hist = np.stack([tbl.blocked_frame(torch.from_numpy(x), tp, block=n)
                         .degree.numpy() for x in x_hist])
    deg_now = tbl.blocked_frame(torch.from_numpy(x_now), tp, block=n).degree
    jcarry = jbl.DelayCarry(jnp.asarray(hist), jnp.asarray(pos_hist),
                            jnp.asarray(deg_hist))
    tcarry = tbl.DelayCarry(torch.from_numpy(hist), torch.from_numpy(pos_hist),
                            torch.from_numpy(deg_hist))
    jg, tg = _grids(x_now, js, ts)
    jgh = tuple(jpc.build_pcell_grid(jnp.asarray(ph), js) for ph in pos_hist)
    tgh = tuple(tcc.build_pcell_grid(torch.from_numpy(ph), ts)
                for ph in pos_hist)
    want = jpc.ystack(jcarry, jg, jnp.asarray(x_now),
                      jnp.asarray(deg_now.numpy()), js, jp, grid_hist=jgh,
                      max_cols=max_cols)
    s0_cols = tcarry.history[1:].transpose(0, 1).reshape(n, (k - 1) * f)
    fq, s0 = tcc.frame_apply(torch.from_numpy(x_now), s0_cols, tg, ts, tp)
    assert torch.equal(fq.degree, deg_now)
    got = tcc.ystack_pre(tcarry, s0, ts, tp, grid_hist=tgh)
    assert got.shape == (k, n, f)
    _close(got.reshape(-1, f), np.asarray(want).reshape(-1, f))


@pytest.mark.parametrize("centralized", [True, False])
def test_plain_sweeps_match_blocked_oracle(centralized):
    """Port-only: the plain versions against the port's O(N²) oracle on a
    wider swarm (no JAX call, so it can afford N = 512)."""
    n = 512
    x = torch.from_numpy(_swarm(11, n, 6.0))
    tp = TParams(n_agents=n)
    ts = tcc.make_pcell_spec(tp)
    grid = tcc.build_pcell_grid(x[:, :2], ts)
    assert int(grid.overflow) == 0
    fq = tcc.frame(x, grid, ts, tp, centralized)
    ref = tbl.blocked_frame(x, tp, centralized, block=128)
    _close(fq.values, ref.values, what="values")
    assert torch.equal(fq.degree, ref.degree)
    per = tcc.frame_sweep(x, grid, ts, 1.0, centralized)
    _close(_expert(x, per, centralized), ref.expert, what="expert")
    assert float(fq.min_r2) == float(ref.min_r2)
    cols = torch.from_numpy(
        np.random.default_rng(2).normal(size=(n, 12)).astype(np.float32))
    _, applied = tcc.frame_apply(x, cols, grid, ts, tp, centralized)
    _close(applied, tbl.blocked_apply_adjT(x[:, :2], cols, tp, 128,
                                           deg=fq.degree), what="applied")


# --- the range layout the kernels walk (pure torch, no JAX) ---------------

def _tile_walk(grid, spec, tile, chunk, threads, rows):
    """Each agent's candidates as csrc/cells.cu's tile sweep visits
    them: blocks of ``rows`` grid rows by ``tile`` columns, the ``rows + 2``
    halo ranges of ``kept`` concatenated and staged ``chunk`` agents at a
    time, ``threads`` tile agents at a time, each walking its three
    sub-ranges in order. Returns {agent: [candidate agents]} for the kept
    agents."""
    kept, cs = grid.kept.numpy(), grid.cell_start.numpy()
    cx, cy, w, nh = spec.cx, spec.cy, tile + 3, rows + 2
    out = {}
    for i0 in range(0, cx, rows):
        for j0 in range(0, cy, tile):
            start = np.array([
                cs[(i0 - 1 + q // w) * cy + min(max(j0 - 1 + q % w, 0), cy)]
                if 0 <= i0 - 1 + q // w < cx else 0 for q in range(nh * w)])
            off = [0]
            for r in range(nh):
                off.append(off[-1] + start[r * w + w - 1] - start[r * w])
            pre = [0]
            for t in range(rows):
                pre.append(pre[-1] + start[(t + 1) * w + tile + 1]
                           - start[(t + 1) * w + 1])
            halo = np.concatenate([kept[start[r * w]:start[r * w + w - 1]]
                                   for r in range(nh)])
            for g0 in range(0, pre[-1], threads):
                for q in range(g0, min(g0 + threads, pre[-1])):
                    h = 1 + sum(q >= pre[t] for t in range(1, rows))
                    p = start[h * w + 1] + q - pre[h - 1]
                    v = max(u for u in range(tile)
                            if start[h * w + 1 + u] <= p)
                    ranges = [(off[r] - start[r * w] + start[r * w + v],
                               off[r] - start[r * w] + start[r * w + v + 3])
                              for r in (h - 1, h, h + 1)]
                    own = off[h] - start[h * w] + p
                    seen = []
                    for c0 in range(0, off[-1], chunk):
                        c1 = min(c0 + chunk, off[-1])
                        for lo, hi in ranges:
                            seen += [halo[k] for k in range(max(lo, c0),
                                                            min(hi, c1))
                                     if k != own]
                    out[int(kept[p])] = [int(a) for a in seen]
    return out


def _range_swarm(case, cap, edge):
    """(positions, spec) of one test swarm at (cap, edge_mult)."""
    if case in ("sparse", "dense"):
        seed, n, spread = (0, 48, 3.0) if case == "sparse" else (5, 512, 1.2)
        pos = _swarm(seed, n, spread)[:, :2]
        return pos, tcc.make_pcell_spec(TParams(n_agents=n), cap=cap,
                                        edge_mult=edge)
    spec = tcc.PCellSpec(cx=4, cy=4, cap=cap, cell=edge)
    if case == "coincident":
        # 40 agents in one cell: over cap 16 and cap 32
        pos = (np.arange(40, dtype=np.float32)[:, None] * 1e-3).repeat(2, 1)
        return pos, spec
    if case == "out_of_grid":
        # agent 1 lies outside the grid and is clamped into the corner cell
        # ahead of the in-grid agents 3 and 4: kept agents are not a prefix
        # of the corner cell's sorted run
        pos = edge * np.array([[0.0, 0.0], [0.5, 0.5], [100.0, 100.0],
                               [3.5, 3.5], [3.2, 3.7]], np.float32)
        return pos, spec
    n = 4096
    p = TParams(n_agents=n)
    gen = torch.Generator().manual_seed(3)
    pos = _init_candidate(gen, p, "cpu")[:, :2].numpy()
    return pos, tcc.make_pcell_spec(p, cap=cap, edge_mult=edge)


@pytest.mark.parametrize("cap,edge", [(16, 1.0), (32, 2.0)])
@pytest.mark.parametrize("case", ["sparse", "dense", "coincident",
                                  "out_of_grid", "lattice"])
def test_ranges_enumerate_the_candidates_in_order(case, cap, edge):
    """The candidates the kernels walk from kept/cell_start are the plain
    versions' candidates (from the slots alone), in the same order, for the
    default tile and for tiny tiles, chunks and blocks (one and three grid
    rows per tile) that force many chunks and several agent passes."""
    pos, spec = _range_swarm(case, cap, edge)
    n = pos.shape[0]
    grid = tcc.build_pcell_grid(torch.from_numpy(pos), spec)
    kept, cs = grid.kept.numpy(), grid.cell_start.numpy()
    assert sorted(kept.tolist()) == list(range(n))
    assert cs.shape == (spec.cx * spec.cy + 1,) and cs[0] == 0
    assert (np.diff(cs) >= 0).all()
    assert cs[-1] == n - int(grid.overflow)
    assert (int(grid.overflow) > 0) == (case in ("dense", "coincident",
                                                 "out_of_grid"))
    assert set(kept[cs[-1]:].tolist()) == set(
        np.flatnonzero(grid.slot.numpy() < 0).tolist())
    cand = tcc._candidates(grid, spec).numpy()
    want = {a: [int(j) for j in cand[a] if j >= 0] for a in kept[:cs[-1]]}
    tile, rows = tcc.tile_cells(spec, n), tcc.TILE_ROWS
    for tile, chunk, threads, rows in (
            (tile, tcc.FRAME_CHUNK, tcc.BLOCK_THREADS, rows),
            (tile, tcc.APPLY_DEG_CHUNK, tcc.BLOCK_THREADS, rows),
            (tile, tcc.APPLY_CHUNK, tcc.BLOCK_THREADS, rows),
            (3, 7, 5, 1), (2, 11, 6, 3)):
        assert _tile_walk(grid, spec, tile, chunk, threads, rows) == want
    assert (cand[kept[cs[-1]:]] < 0).all()


def _table_build(pos, spec):
    """The grid build of the previous layout (a cap-wide cell table beside
    the slots), kept as the yardstick of the op count below."""
    n = pos.shape[0]
    origin = pos.min(0).values
    ij = torch.floor((pos - origin) / spec.cell).to(torch.int64)
    in_grid = (ij[:, 0] < spec.cx) & (ij[:, 1] < spec.cy)
    cid = (torch.clamp_max(ij[:, 0], spec.cx - 1) * spec.cy
           + torch.clamp_max(ij[:, 1], spec.cy - 1))
    order = torch.argsort(cid, stable=True)
    sc = cid[order]
    rank = torch.arange(n) - torch.searchsorted(sc, sc)
    ok = (rank < spec.cap) & in_grid[order]
    slot_sorted = torch.where(
        ok, (sc // spec.cy * spec.cap + rank) * spec.cy + sc % spec.cy, -1)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    nslot = spec.cx * spec.cy * spec.cap
    table = torch.full((nslot + 1,), -1, dtype=torch.int64)
    table.scatter_(0, torch.where(ok, sc * spec.cap + rank, nslot), order)
    return (slot.to(torch.int32), table[:-1].to(torch.int32),
            order.to(torch.int32), (n - ok.sum()).to(torch.int32))


def _dispatched_ops(fn):
    """The ATen operations ``fn`` dispatches, views included."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.ops


def test_grid_build_issues_no_more_ops_than_the_table_build(capsys):
    """The ranges replace the cap-wide table and add no tensor operation
    (the step is host-bound); slots, order and overflow are unchanged."""
    pos = torch.from_numpy(_swarm(5, 512, 1.2)[:, :2])
    spec = tcc.make_pcell_spec(TParams(n_agents=512), cap=8)
    new = _dispatched_ops(lambda: tcc.build_pcell_grid(pos, spec))
    old = _dispatched_ops(lambda: _table_build(pos, spec))
    with capsys.disabled():
        print(f"\ngrid build: {len(new)} ATen ops (table build: {len(old)})")
    assert len(new) <= len(old) == 47
    grid, (slot, _, order, overflow) = (tcc.build_pcell_grid(pos, spec),
                                        _table_build(pos, spec))
    assert torch.equal(grid.slot, slot) and torch.equal(grid.order, order)
    assert int(grid.overflow) == int(overflow) > 0


def _ystack_pre_before(carry, s0_out, spec, p, grid_hist, ones):
    """ystack_pre as it was before K3 took the division in: the division
    and its clamp ahead of K3 (here K3 with unit degrees ``ones``), and a
    cat after it. Kept as the yardstick of the op count below."""
    k = carry.history.shape[0]
    n, f = carry.history.shape[1:]
    y = [carry.history[0]]
    v = s0_out.reshape(n, k - 1, f).transpose(0, 1)
    y.append(v[0])
    for s in range(1, k - 1):
        cols = v[s:].transpose(0, 1).reshape(n, (k - 1 - s) * f)
        wcols = cols / torch.clamp_min(carry.deg_hist[s - 1], 1.0)[:, None]
        out = tcc.apply_sweep(carry.pos_hist[s - 1], wcols, ones,
                              grid_hist[s - 1], spec, 1.0)
        v = torch.cat([v[:s], out.reshape(n, k - 1 - s, f).transpose(0, 1)])
        y.append(v[s])
    return torch.stack(y)


def test_ystack_pre_issues_k3_and_one_stack(monkeypatch, capsys):
    """At K = 3 the delayed stack issues two device operations per step,
    K3 and the stack, where the division ahead of K3 (a clamp and a
    division) and a cat after it made five. K3 stands in as one counted
    call here (on the CPU its plain version is many operations); views
    launch nothing and are not counted. Both versions give the same
    stack."""
    from torch.utils._python_dispatch import TorchDispatchMode

    k, n = 3, 48
    rng = np.random.default_rng(7)
    _, tp, _, ts = _specs(n)
    carry = tbl.DelayCarry(
        torch.from_numpy(rng.normal(size=(k, n, 6)).astype(np.float32)),
        torch.from_numpy(_swarm(8, n, 3.0)[None, :, :2].copy()),
        torch.from_numpy(rng.integers(0, 5, (1, n)).astype(np.float32)))
    grid_hist = (tcc.build_pcell_grid(carry.pos_hist[0], ts),)
    s0 = torch.from_numpy(rng.normal(size=(n, 12)).astype(np.float32))
    plain, seen = tcc.apply_sweep, []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                seen.append(str(func))
            return func(*args, **(kwargs or {}))

    def k3(*args, **kwargs):                  # one device operation
        seen.append("K3")
        with torch.utils._python_dispatch._disable_current_modes():
            return plain(*args, **kwargs)

    monkeypatch.setattr(tcc, "apply_sweep", k3)
    counts, outs = [], []
    before = functools.partial(_ystack_pre_before, ones=torch.ones(n))
    for fn in (before, tcc.ystack_pre):
        seen.clear()
        with Count():
            outs.append(fn(carry, s0, ts, tp, grid_hist=grid_hist))
        counts.append(list(seen))
    with capsys.disabled():
        print(f"\nystack_pre at K = 3: {len(counts[1])} device ops "
              f"{counts[1]} (before: {len(counts[0])} {counts[0]})")
    assert len(counts[0]) == 5
    assert counts[1] == ["K3", "aten.stack.default"]
    assert torch.equal(outs[0], outs[1])


def test_plain_historical_apply_reads_a_strided_view_as_a_copy():
    """apply_sweep_plain on the row-strided view ystack_pre passes equals
    it on a contiguous copy, bit for bit (the kernel reads the view in
    place; the plain version is its oracle)."""
    n = 48
    x = torch.from_numpy(_swarm(9, n, 3.0))
    ts = tcc.make_pcell_spec(TParams(n_agents=n))
    grid = tcc.build_pcell_grid(x[:, :2], ts)
    s0 = torch.from_numpy(
        np.random.default_rng(3).normal(size=(n, 12)).astype(np.float32))
    cols = s0.reshape(n, 2, 6).transpose(0, 1)[1:].transpose(0, 1).reshape(
        n, 6)
    assert cols.stride() == (12, 1) and not cols.is_contiguous()
    deg = torch.from_numpy(
        np.random.default_rng(4).integers(0, 6, n).astype(np.float32))
    got = tcc.apply_sweep_plain(x[:, :2], cols, deg, grid, ts, 1.0)
    want = tcc.apply_sweep_plain(x[:, :2], cols.contiguous(), deg, grid, ts,
                                 1.0)
    assert torch.equal(got, want) and got.abs().sum() > 0


def test_tile_cells_at_the_main_paths_density():
    p = TParams(n_agents=32768)
    spec = tcc.make_pcell_spec(p)
    assert (spec.cx, spec.cy) == (185, 185)
    assert tcc.tile_cells(spec, 32768) == 12
    # a dense grid takes narrow tiles, a sparse one wide tiles, any grid a
    # legal width
    assert tcc.tile_cells(tcc.PCellSpec(8, 8, 32, 2.0), 2048) == 1
    assert tcc.tile_cells(tcc.PCellSpec(3, 3, 16, 1.0), 1) == 3
    for n in (1, 100, 10 ** 6):
        assert 1 <= tcc.tile_cells(spec, n) <= tcc.MAX_TILE


def test_apply_chunks_cover_whole_slots():
    """On the card a column block is launched in chunks of the built
    widths: one launch up to 18 columns (K <= 4), then chunks of 18 and
    the rest; a count that is not whole 6-column slots raises."""
    assert tcc.APPLY_COLS == (6, 12, 18)
    assert tcc.apply_chunks(18) == [(0, 18)]
    assert tcc.apply_chunks(24) == [(0, 18), (18, 6)]
    assert tcc.apply_chunks(30) == [(0, 18), (18, 12)]
    for c in range(6, 121, 6):
        chunks = tcc.apply_chunks(c)
        assert all(w in tcc.APPLY_COLS for _, w in chunks)
        assert [c0 for c0, _ in chunks] == list(range(0, c, 18))
        assert sum(w for _, w in chunks) == c
    for c in (0, 1, 7, 20):
        with pytest.raises(ValueError, match="columns"):
            tcc.apply_chunks(c)


def test_cpu_wrappers_take_plain_versions_uncounted():
    """A CPU tensor goes to the plain version, which takes any column count
    (the CUDA launchers take APPLY_COLS), and launches nothing."""
    n = 48
    x = torch.from_numpy(_swarm(0, n, 3.0))
    tp = TParams(n_agents=n)
    ts = tcc.make_pcell_spec(tp)
    grid = tcc.build_pcell_grid(x[:, :2], ts)
    cols = torch.ones((n, 7))
    assert cols.shape[1] not in tcc.APPLY_COLS
    out = tcc.apply_sweep(x[:, :2].contiguous(), cols, torch.ones(n), grid,
                          ts, 1.0)
    assert out.shape == cols.shape
    assert tcc.launch_counts() == {"frame_sweep": 0, "apply_deg_sweep": 0,
                                   "apply_sweep": 0}


def test_nvcc_build_is_one_plain_c_abi_call():
    """The kernels build with nvcc for sm_90a into a C-ABI shared library
    (no PyTorch headers, no torch.utils.cpp_extension)."""
    from multiagent_gnn_policies_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "-gencode arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-Xptxas -v" in flags
    src = (_build.CSRC / "cells.cu").read_text()
    assert "torch" not in src.replace("multiagent_gnn_policies_tpu_torch", "")
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in src
    # the Python mirrors of the kernels' block geometry
    for const, value in (("kThreads", tcc.BLOCK_THREADS),
                         ("kMaxTile", tcc.MAX_TILE),
                         ("kRows", tcc.TILE_ROWS)):
        assert f"constexpr int {const} = {value};" in src
    chunks = [int(c) for c in re.findall(
        r"static constexpr int kChunk = (\d+);", src)]
    assert chunks == [tcc.FRAME_CHUNK, tcc.APPLY_DEG_CHUNK, tcc.APPLY_CHUNK]
