"""The port's regular-layout cell grid
(multiagent_gnn_policies_tpu_torch/ops/cells.py) against the JAX
package's ``ops/cells.py`` on the same inputs, drawn from a seed with
numpy: the grid geometry, the grid build (with cap and out-of-grid
drops), pack, unpack and band unpack, the frame (both expert settings and
``comm_radius`` 0.5) with the D bands summing to the whole sweep, the
transpose-apply, the delayed stack over a trajectory, and the port's
strip grouping, which must not change a bit.

Tolerance: 1e-5 of each channel's largest magnitude for frames, applies
and stacks (float32 on both sides, summed in other orders); specs, slots,
degrees and overflow exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.ops import blocked as jbl
from multiagent_gnn_policies_tpu.ops import cells as jcl
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.ops import blocked as tbl
from multiagent_gnn_policies_tpu_torch.ops import cells as tcl

from test_torch_binned import _both, _close, _state


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


def _params(n=N, **kw):
    return jfl.FlockingParams(n_agents=n, **kw), tfl.FlockingParams(
        n_agents=n, **kw)


def _specs(n=N, cap=16, n_dev=1, **kw):
    jp, tp = _params(n, **kw)
    return (jp, tp, jcl.make_cell_spec(jp, cap=cap, n_dev=n_dev),
            tcl.make_cell_spec(tp, cap=cap, n_dev=n_dev))


def _grid_equal(got, want):
    for f in ("slot_of_agent", "agent_of_slot", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("n,cap,margin,n_dev", [
    (48, 12, 1.3, 1), (48, 16, 1.3, 4), (600, 12, 1.6, 2),
    (4, 8, 1.3, 1), (32_768, 12, 1.3, 1), (100_000, 12, 1.3, 8)])
def test_make_cell_spec_equals_jax(n, cap, margin, n_dev):
    jp, tp = _params(n)
    want = jcl.make_cell_spec(jp, cap=cap, margin=margin, n_dev=n_dev)
    got = tcl.make_cell_spec(tp, cap=cap, margin=margin, n_dev=n_dev)
    assert tuple(got) == tuple(want)
    assert got.cx % (got.strip * n_dev) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_cell_grid_equals_jax(seed):
    _, _, jspec, tspec = _specs()
    jx, tx = _both(_state(seed))
    got = tcl.build_cell_grid(tx[:, :2], tspec)
    _grid_equal(got, jcl.build_cell_grid(jx[:, :2], jspec))
    assert int(got.overflow) == 0
    assert got.slot_of_agent.dtype == got.agent_of_slot.dtype == torch.int32


def test_build_cell_grid_drops_equal_jax():
    """20 agents in one cell at cap 4 (16 dropped), and one agent outside
    the grid: slots, the dump slot and the overflow as the JAX build's."""
    pos = (np.zeros((20, 2)) + np.arange(20)[:, None] * 0.001).astype(
        np.float32)
    _, _, jspec, tspec = _specs(20, cap=4)
    jpos, tpos = _both(pos)
    got = tcl.build_cell_grid(tpos, tspec)
    _grid_equal(got, jcl.build_cell_grid(jpos, jspec))
    assert int(got.overflow) == 16
    _, _, jspec, tspec = _specs(4, cap=8)
    far = np.array([[0.0, 0.0], [1.0, 1.0],
                    [tspec.cx * tspec.cell + 5.0, 0.0], [2.0, 2.0]],
                   np.float32)
    jpos, tpos = _both(far)
    got = tcl.build_cell_grid(tpos, tspec)
    _grid_equal(got, jcl.build_cell_grid(jpos, jspec))
    assert int(got.overflow) == 1
    assert int(got.slot_of_agent[2]) == tspec.cx * tspec.cy * tspec.cap


def test_pack_unpack_and_band_unpack_equal_jax():
    """Pack, unpack with a fill (dropped agents get it), the band unpack of
    two halves of the slots, which sum to the whole unpack, and the padded
    grid gathered for the whole band, equal to the padded pack."""
    pos = _state(3)
    pos[:12, :2] = np.arange(12)[:, None] * 0.001          # over cap
    _, _, jspec, tspec = _specs(cap=4)
    jx, tx = _both(pos)
    jg = jcl.build_cell_grid(jx[:, :2], jspec)
    tg = tcl.build_cell_grid(tx[:, :2], tspec)
    assert int(tg.overflow) > 0
    packed = tcl.cell_pack(tg, tx, fill=-1.0)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jcl.cell_pack(jg, jx, -1.0)))
    np.testing.assert_array_equal(
        tcl.cell_unpack(tg, packed, fill=-7.0).numpy(),
        np.asarray(jcl.cell_unpack(jg, jcl.cell_pack(jg, jx, -1.0), -7.0)))
    half = packed.shape[0] // 2
    bands = [tcl.cell_unpack_band(tg, packed[:half], 0),
             tcl.cell_unpack_band(tg, packed[half:], half)]
    for band, (lo, hi) in zip(bands, ((0, half), (half, None))):
        np.testing.assert_array_equal(band.numpy(), np.asarray(
            jcl.cell_unpack_band(jg, jcl.cell_pack(jg, jx, -1.0)[lo:hi],
                                 lo)))
    assert torch.equal(bands[0] + bands[1], tcl.cell_unpack(tg, packed))
    # the whole-grid band gather is the padded pack (JAX: the same pair)
    gx, gi = tcl._pad_grid(tspec, tcl.cell_pack(tg, tx), tg.agent_of_slot)
    bx, bi = tcl._pad_grid_band(tspec, tg, tx)
    assert torch.equal(gx, bx) and torch.equal(gi.long(), bi)
    jgx, jgi = jcl._pad_grid_band(jspec, jg, jx)
    np.testing.assert_array_equal(bx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(jgi))


@pytest.mark.parametrize("centralized,radius", [
    (True, 1.0), (False, 1.0), (True, 0.5)],
    ids=["centralized", "decentralized", "centralized-r0.5"])
def test_cells_frame_equals_jax(centralized, radius):
    jp, tp, jspec, tspec = _specs(comm_radius=radius)
    jx, tx = _both(_state(4, spread=2.0 if radius < 1 else 3.0))
    want = jcl.cells_frame(jx, jcl.build_cell_grid(jx[:, :2], jspec), jspec,
                           jp, centralized)
    got = tcl.cells_frame(tx, tcl.build_cell_grid(tx[:, :2], tspec), tspec,
                          tp, centralized)
    _close(got.values, want.values, "values")
    _close(got.expert, want.expert, "expert")
    np.testing.assert_array_equal(got.degree.numpy(), np.asarray(want.degree))
    _close(got.min_r2.reshape(1), np.asarray(want.min_r2).reshape(1),
           "min_r2")


@pytest.mark.parametrize("d", [2, 4])
def test_cells_bands_sum_to_the_whole_sweep(d):
    """On the grid of ``make_cell_spec(n_dev=D)`` the D bands' frames and
    applies sum to the whole sweep's bit for bit (min r² as a min), on a
    grid that drops agents."""
    pos = _state(5, n=300, spread=6.0)
    pos[:20, :2] = np.arange(20)[:, None] * 0.001          # over cap
    _, tp, _, spec = _specs(300, cap=12, n_dev=d)
    x = torch.from_numpy(pos)
    grid = tcl.build_cell_grid(x[:, :2], spec)
    assert int(grid.overflow) > 0
    cols = torch.from_numpy(
        np.random.default_rng(5).standard_normal((300, 6)).astype(
            np.float32))
    deg = torch.arange(300, dtype=torch.float32) % 5
    full = tcl.cells_frame(x, grid, spec, tp)
    full_apply = tcl.cells_apply_adjT(x[:, :2], deg, cols, spec, tp,
                                      grid=grid)
    local = spec.cx // d
    bands = [tcl.cells_frame(x, grid, spec, tp, row_range=(r * local, local))
             for r in range(d)]
    for f in ("values", "degree", "expert"):
        assert torch.equal(sum(getattr(b, f) for b in bands),
                           getattr(full, f)), f
    assert float(min(b.min_r2 for b in bands)) == float(full.min_r2)
    assert torch.equal(sum(tcl.cells_apply_adjT(
        x[:, :2], deg, cols, spec, tp, grid=grid,
        row_range=(r * local, local)) for r in range(d)), full_apply)


def test_cells_apply_adjT_equals_jax():
    """With the caller's grid and built inside, at 5 and 12 columns."""
    rng = np.random.default_rng(6)
    jp, tp, jspec, tspec = _specs()
    jx, tx = _both(_state(6))
    jd, td = _both(rng.integers(0, 6, N).astype(np.float32))
    for c in (5, 12):
        jc, tc = _both(rng.standard_normal((N, c)).astype(np.float32))
        want = jcl.cells_apply_adjT(jx[:, :2], jd, jc, jspec, jp)
        _close(tcl.cells_apply_adjT(tx[:, :2], td, tc, tspec, tp), want)
        grid = tcl.build_cell_grid(tx[:, :2], tspec)
        _close(tcl.cells_apply_adjT(tx[:, :2], td, tc, tspec, tp, grid=grid),
               want)


@pytest.mark.parametrize("k", [3, 4])
def test_cells_ystack_equals_jax_over_trajectory(k):
    """A random walk of 6 steps with random features: both packages'
    carries updated alike, the stack compared at every step (episode-start
    zero slots included)."""
    rng = np.random.default_rng(7 + k)
    jp, tp, jspec, tspec = _specs()
    x = _state(7)
    v0 = rng.standard_normal((N, 6)).astype(np.float32)
    jcarry = jbl.delay_carry_init(jnp.asarray(v0), N, k)
    tcarry = tbl.delay_carry_init(torch.from_numpy(v0), N, k)
    for _ in range(6):
        jx, tx = _both(x)
        jg = jcl.build_cell_grid(jx[:, :2], jspec)
        tg = tcl.build_cell_grid(tx[:, :2], tspec)
        deg = tcl.cells_frame(tx, tg, tspec, tp).degree
        _close(tcl.cells_ystack(tcarry, tg, tx, deg, tspec, tp),
               jcl.cells_ystack(jcarry, jg, jx, jnp.asarray(deg.numpy()),
                                jspec, jp), "ystack")
        v = rng.standard_normal((N, 6)).astype(np.float32)
        jcarry = jbl.delay_carry_update(jcarry, jnp.asarray(v), jx[:, :2],
                                        jnp.asarray(deg.numpy()))
        tcarry = tbl.delay_carry_update(tcarry, torch.from_numpy(v),
                                        tx[:, :2], deg)
        x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)


def test_strip_grouping_does_not_change_a_bit(monkeypatch):
    """One strip per sweep group against all strips in one group: the
    frame (both expert settings), the apply and the stack bit for bit."""
    _, tp, _, spec = _specs(600, cap=12)
    assert spec.cx // spec.strip >= 4
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_state(8, n=600, spread=12.0))
    cols = torch.from_numpy(rng.standard_normal((600, 12)).astype(
        np.float32))
    grid = tcl.build_cell_grid(x[:, :2], spec)
    carry = tbl.DelayCarry(history=cols.reshape(600, 2, 6).transpose(0, 1)
                           .repeat(2, 1, 1)[:3].contiguous(),
                           pos_hist=x[None, :, :2] + 0.05,
                           deg_hist=torch.ones((1, 600)))

    def run():
        frames = [tcl.cells_frame(x, grid, spec, tp, c) for c in (True,
                                                                   False)]
        deg = frames[0].degree
        return (frames, tcl.cells_apply_adjT(x[:, :2], deg, cols, spec, tp,
                                             grid=grid),
                tcl.cells_ystack(carry, grid, x, deg, spec, tp))

    outs = {}
    for pairs in (1, 1 << 40):
        monkeypatch.setattr(tcl, "SWEEP_PAIRS", pairs)
        assert len(tcl._groups(spec, spec.cx)) == (
            spec.cx // spec.strip if pairs == 1 else 1)
        outs[pairs] = run()
    (f1, a1, y1), (f2, a2, y2) = outs.values()
    for g1, g2 in zip(f1, f2):
        for fld in g1._fields:
            assert torch.equal(getattr(g1, fld), getattr(g2, fld)), fld
    assert torch.equal(a1, a2) and torch.equal(y1, y2)
