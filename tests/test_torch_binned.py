"""The port's spatial-hash neighbour list
(multiagent_gnn_policies_tpu_torch/ops/binned.py) against the JAX
package's ``ops/binned.py`` on the same inputs, drawn from a seed with
numpy: the cell hash (negative coordinates, products past the int32
wrap), the neighbour table (cap 4, overflowing, and 32), the frame (both
expert settings, row slices), the transpose-apply, the delayed stack over
a trajectory, and the refusal of ``comm_radius < 1`` under the centralized
expert.

Tolerance: 1e-5 of each channel's largest magnitude for frames, applies
and stacks (float32 on both sides, summed in other orders); hashes, masks,
degrees, overflow and the masked candidates exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiagent_gnn_policies_tpu.envs import flocking as jfl
from multiagent_gnn_policies_tpu.ops import binned as jbn
from multiagent_gnn_policies_tpu.ops import blocked as jbl
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.ops import binned as tbn
from multiagent_gnn_policies_tpu_torch.ops import blocked as tbl
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


REL = 1e-5
N = 48


def _close(got, want, what="", rel=REL):
    """|got - want| <= rel * max|want| per channel (last axis)."""
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    w2 = want.reshape(-1, want.shape[-1]) if want.ndim > 1 else want[:, None]
    scale = np.maximum(np.abs(w2).max(0), 1e-30)
    err = np.abs(got.reshape(w2.shape) - w2).max(0)
    assert (err <= rel * scale).all(), (what, err / scale)


def _state(seed, n=N, spread=3.0):
    """(N, 4) positions uniform in [-spread, spread]², normal velocities."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                           rng.standard_normal((n, 2))], 1).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def test_hash_equals_jax_bit_for_bit():
    """Negative coordinates, and ones whose products with the primes wrap
    int32 (the JAX side wraps, the port masks an int64 product)."""
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, -1, 7, -7, 29, 100_000, -100_000, 46_341,
                     2**31 - 1, -2**31, 2**31 - 2], np.int64)
    ij = np.stack(np.meshgrid(edge, edge), -1).reshape(-1, 2)
    ij = np.concatenate([ij, rng.integers(-2**31, 2**31, (4096, 2))])
    ij = ij.astype(np.int32)
    want = np.asarray(jbn._hash_ij(jnp.asarray(ij)))
    got = tbn._hash_ij(torch.from_numpy(ij))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() >= 0 and want.max() < tbn.HASH_SIZE
    assert (tbn.HASH_BITS, tbn.P1, tbn.P2) == (
        jbn.HASH_BITS, int(jbn._P1), int(jbn._P2))


@pytest.mark.parametrize("cap", [4, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_neighbor_list_equals_jax(seed, cap):
    """mask, degrees and overflow exactly, the candidates where masked,
    r² within 1e-5; cap 4 at this density overflows, 32 does not."""
    jx, tx = _both(_state(seed, spread=2.0))
    want = jbn.build_neighbor_list(jx[:, :2], 1.0, cap)
    got = tbn.build_neighbor_list(tx[:, :2], 1.0, cap)
    assert int(got.overflow) == int(want.overflow)
    assert (int(want.overflow) > 0) == (cap == 4)
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.deg.numpy(), np.asarray(want.deg))
    np.testing.assert_array_equal(np.where(mask > 0, got.idx.numpy(), -1),
                                  np.where(mask > 0, np.asarray(want.idx), -1))
    finite = np.isfinite(np.asarray(want.r2))
    np.testing.assert_array_equal(np.isfinite(got.r2.numpy()), finite)
    _close(got.r2.numpy()[finite][:, None],
           np.asarray(want.r2)[finite][:, None], "r2")


@pytest.mark.parametrize("centralized", [True, False])
def test_binned_frame_equals_jax(centralized):
    jx, tx = _both(_state(3))
    jp, tp = jfl.FlockingParams(n_agents=N), tfl.FlockingParams(n_agents=N)
    want = jbn.binned_frame(jx, jbn.build_neighbor_list(jx[:, :2], 1.0), jp,
                            centralized)
    got = tbn.binned_frame(tx, tbn.build_neighbor_list(tx[:, :2], 1.0), tp,
                           centralized)
    _close(got.values, want.values, "values")
    _close(got.expert, want.expert, "expert")
    np.testing.assert_array_equal(got.degree.numpy(), np.asarray(want.degree))
    _close(got.min_r2.reshape(1), np.asarray(want.min_r2).reshape(1),
           "min_r2")


def test_binned_frame_row_range_slices():
    """A row slice is those rows of the whole frame, and equals the JAX
    slice; min r² over the slice."""
    jx, tx = _both(_state(4))
    jp, tp = jfl.FlockingParams(n_agents=N), tfl.FlockingParams(n_agents=N)
    nl = tbn.build_neighbor_list(tx[:, :2], 1.0)
    full = tbn.binned_frame(tx, nl, tp)
    part = tbn.binned_frame(tx, nl, tp, row_range=(16, 16))
    want = jbn.binned_frame(jx, jbn.build_neighbor_list(jx[:, :2], 1.0), jp,
                            row_range=(jnp.asarray(16, jnp.int32), 16))
    for f in ("values", "degree", "expert"):
        assert torch.equal(getattr(part, f), getattr(full, f)[16:32]), f
    _close(part.values, want.values, "values")
    _close(part.expert, want.expert, "expert")
    np.testing.assert_array_equal(part.degree.numpy(),
                                  np.asarray(want.degree))
    assert float(part.min_r2) == float(nl.r2[16:32].min())


def test_apply_adjT_equals_jax():
    """The whole apply, a destination-row slice of it, and an injected
    source-degree vector."""
    rng = np.random.default_rng(5)
    jx, tx = _both(_state(5))
    jc, tc = _both(rng.standard_normal((N, 12)).astype(np.float32))
    jd, td = _both(rng.integers(0, 6, N).astype(np.float32))
    jnl = jbn.build_neighbor_list(jx[:, :2], 1.0)
    tnl = tbn.build_neighbor_list(tx[:, :2], 1.0)
    _close(tbn.binned_apply_adjT(tnl, tc), jbn.binned_apply_adjT(jnl, jc))
    _close(tbn.binned_apply_adjT(tnl, tc, deg=td),
           jbn.binned_apply_adjT(jnl, jc, deg=jd))
    part = tbn.binned_apply_adjT(tnl, tc, row_range=(8, 24))
    assert torch.equal(part, tbn.binned_apply_adjT(tnl, tc)[8:32])
    _close(part, jbn.binned_apply_adjT(jnl, jc,
                                       row_range=(jnp.asarray(8), 24)))


@pytest.mark.parametrize("k", [3, 4])
def test_binned_ystack_equals_jax_over_trajectory(k):
    """A random walk of 6 steps with random features: both packages'
    carries updated alike, the stack compared at every step (episode-start
    zero slots included)."""
    rng = np.random.default_rng(6 + k)
    x = _state(7)
    jp, tp = jfl.FlockingParams(n_agents=N), tfl.FlockingParams(n_agents=N)
    v0 = rng.standard_normal((N, 6)).astype(np.float32)
    jcarry = jbl.delay_carry_init(jnp.asarray(v0), N, k)
    tcarry = tbl.delay_carry_init(torch.from_numpy(v0), N, k)
    for _ in range(6):
        jx, tx = _both(x)
        jnl = jbn.build_neighbor_list(jx[:, :2], 1.0)
        tnl = tbn.build_neighbor_list(tx[:, :2], 1.0)
        _close(tbn.binned_ystack(tcarry, tnl, tp),
               jbn.binned_ystack(jcarry, jnl, jp), "ystack")
        x2 = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        v = rng.standard_normal((N, 6)).astype(np.float32)
        jcarry = jbl.delay_carry_update(jcarry, jnp.asarray(v), jx[:, :2],
                                        jnl.deg)
        tcarry = tbl.delay_carry_update(tcarry, torch.from_numpy(v),
                                        tx[:, :2], tnl.deg)
        x = x2


def test_centralized_expert_needs_a_unit_comm_radius():
    """Binned with the centralized expert and comm_radius < 1 raises (in
    ``rollout_large``, ``sparse=True`` too, and in ``make_config``, which
    the learner uses); the decentralized expert runs."""
    p = tfl.FlockingParams(n_agents=64, comm_radius=0.5, episode_steps=2)
    for kw in (dict(path="binned"), dict(sparse=True)):
        with pytest.raises(ValueError, match="comm_radius >= 1.0"):
            tln.rollout_large(None, None, None, p, expert_mode=True,
                              device="cpu", **kw)
    with pytest.raises(ValueError, match="comm_radius >= 1.0"):
        tln.make_config(p, path="binned", centralized=True)
    acfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(8,), k=2)
    with pytest.raises(ValueError, match="comm_radius >= 1.0"):
        tln.rollout_large(tac.Actor(acfg), acfg, None, p, path="binned",
                          device="cpu")
    x0 = torch.from_numpy(_state(8, n=64))
    r, _, ovf = tln.rollout_large(None, None, None, p, path="binned",
                                  centralized_expert=False, expert_mode=True,
                                  x0=x0, device="cpu", return_overflow=True)
    assert r.shape == (2,) and bool(torch.isfinite(r).all())
