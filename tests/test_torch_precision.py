"""The port's centralized expert at large N: the velocity consensus
(multiagent_gnn_policies_tpu_torch/ops/precision.py, float64) against the
JAX package's two-float fold (ops/precision.py), the float64 closed form
and the direct pairwise sum; and the expert of the port's ``frame`` and
``frame_apply`` with ``need_expert`` against the JAX ``pallas_cells``
functions (Pallas kernels in interpret mode on the CPU) and the blocked
oracle.

Tolerances: the consensus to 1e-5 relative to ``max(|exact|, 1)``
(``tests/test_precision.py``'s contract) against the float64 closed form
and the JAX function, and to 1e-4 absolute and 1e-6 relative against the
direct pairwise sum (that test's bound for the dense path); the expert
to 1e-5 of each channel's largest magnitude (both sides sum the same
candidates in float32, in different orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiagent_gnn_policies_tpu.envs.flocking import FlockingParams as JParams
from multiagent_gnn_policies_tpu.ops import pallas_cells as jpc
from multiagent_gnn_policies_tpu.ops import precision as jpr
from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams as TParams,
)
from multiagent_gnn_policies_tpu_torch.ops import blocked as tbl
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc
from multiagent_gnn_policies_tpu_torch.ops import precision as tpr


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


def _velocities(n, seed=0):
    """``tests/test_precision.py``'s inputs: uniform in ±3 (the v_max = 3
    resets) plus a mean offset, so the sum does not cancel by luck."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-3.0, 3.0, (n, 2)) + 0.013).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))


@pytest.mark.parametrize("n", [997, 4096, 100_000])
def test_consensus_matches_f64_and_jax(n):
    v = _velocities(n, seed=n)
    got = tpr.centralized_consensus(torch.from_numpy(v))
    assert got.dtype == torch.float32
    v64 = v.astype(np.float64)
    exact = n * v64 - v64.sum(0)
    assert _rel(got, exact) < REL
    want = np.asarray(jax.jit(jpr.centralized_consensus)(jnp.asarray(v)))
    assert _rel(got, want) < REL
    if n <= 4096:   # the direct pairwise sum the dense expert takes
        pairwise = (v64[:, None, :] - v64[None, :, :]).sum(1)
        np.testing.assert_allclose(got.numpy(), pairwise, atol=1e-4,
                                   rtol=1e-6)
    # printed beside the float32 closed form N·v - Σv, for the record
    naive = torch.from_numpy(v)
    naive = n * naive - naive.sum(0)
    print(f"N={n}: float64 route rel {_rel(got, exact):.3g}, float32 "
          f"N·v - Σv rel {_rel(naive, exact):.3g}")


def _close(got, want, what=""):
    """|got - want| <= REL * max|want| per channel (last axis)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.maximum(np.abs(want).max(0), 1e-30)
    err = np.abs(got - want).max(0)
    assert (err <= REL * scale).all(), (what, err / scale)


def _swarm(seed, n, spread):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 2))
    vel = rng.normal(size=(n, 2))
    return np.concatenate([pos, vel], 1).astype(np.float32)


def _setup(n, seed=0, spread=6.0, cap=16):
    x = _swarm(seed, n, spread)
    jp, tp = JParams(n_agents=n), TParams(n_agents=n)
    js, ts = jpc.make_pcell_spec(jp, cap=cap), tcc.make_pcell_spec(tp, cap=cap)
    jg = jpc.build_pcell_grid(jnp.asarray(x[:, :2]), js)
    tg = tcc.build_pcell_grid(torch.from_numpy(x[:, :2]), ts)
    return x, jp, tp, js, ts, jg, tg


@pytest.mark.parametrize("centralized", [True, False],
                         ids=["centralized", "decentralized"])
def test_frame_expert_matches_jax(centralized):
    """The expert of ``frame(..., need_expert=True)`` against the JAX
    ``pallas_cells.frame`` (interpret mode) and the O(N²) blocked oracle
    on a sparse swarm (no overflow), with some agents clipped at ±10."""
    n = 256
    x, jp, tp, js, ts, jg, tg = _setup(n)
    assert int(tg.overflow) == 0
    want = jpc.frame(jnp.asarray(x), jg, js, jp, centralized)
    got = tcc.frame(torch.from_numpy(x), tg, ts, tp, centralized,
                    need_expert=True)
    assert got.expert.shape == (n, 2) and got.expert.dtype == torch.float32
    _close(got.expert, want.expert, "expert vs JAX")
    ref = tbl.blocked_frame(torch.from_numpy(x), tp, centralized, block=64)
    _close(got.expert, ref.expert, "expert vs blocked oracle")
    assert (got.expert.abs() <= 10.0).all()
    if centralized:
        assert (got.expert.abs() == 10.0).any()   # the clip is exercised


@pytest.mark.parametrize("centralized", [True, False],
                         ids=["centralized", "decentralized"])
def test_frame_apply_expert_matches_jax(centralized):
    """The fused frame's expert (the one collection reads) equals the JAX
    ``frame_apply``'s, and ``need_expert=False`` leaves it None."""
    n = 192
    x, jp, tp, js, ts, jg, tg = _setup(n, seed=3, spread=5.0)
    cols = np.random.default_rng(4).normal(size=(n, 12)).astype(np.float32)
    jfq, _ = jpc.frame_apply(jnp.asarray(x), jnp.asarray(cols), jg, js, jp,
                             centralized)
    tfq, _ = tcc.frame_apply(torch.from_numpy(x), torch.from_numpy(cols), tg,
                             ts, tp, centralized, need_expert=True)
    _close(tfq.expert, jfq.expert, "expert")
    plain, _ = tcc.frame_apply(torch.from_numpy(x), torch.from_numpy(cols),
                               tg, ts, tp, centralized)
    assert plain.expert is None
    torch.testing.assert_close(plain.values, tfq.values, rtol=0, atol=0)
