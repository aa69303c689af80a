"""The port's actor (multiagent_gnn_policies_tpu_torch/models/actor.py) and
its weight import against the JAX package: the same numpy weights give the
same actions, and the numpy-only ``.npz`` reader returns exactly the leaves
the JAX package's checkpoint loader returns for the in-repo N = 32,768
checkpoint; the parameter count and the hidden widths' helper give the
JAX values.

Tolerance: float32 matrix products in different summation orders; actions
agree to 1e-5 of their largest magnitude (the stated bound is 1e-4).
"""

import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.utils import checkpoint as jck
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models.torch_import import (
    actor_params_from_numpy,
)
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
N32K = ROOT / "models" / "actor_FlockingRelative-v0_dagger_n32k.npz"


def _numpy_layers(cfg, seed):
    rng = np.random.default_rng(seed)
    w = cfg.widths
    return [{"w": rng.normal(scale=0.5, size=(w[i + 1], w[i], cfg.taps(i)))
             .astype(np.float32),
             "b": rng.normal(scale=0.1, size=(w[i + 1],)).astype(np.float32)}
            for i in range(cfg.n_layers)]


def _torch_actor(cfg, layers):
    actor = tac.Actor(tac.ActorConfig(cfg.n_s, cfg.n_a, cfg.hidden, cfg.k,
                                      bound=cfg.bound))
    actor.load_state_dict(actor_params_from_numpy(layers))
    return actor


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("bound", ["none", "tanh"])
def test_actor_forward_matches_jax(k, bound):
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=k, bound=bound)
    layers = _numpy_layers(jcfg, seed=k)
    y = np.random.default_rng(10 + k).normal(size=(k, 40, 6)).astype(
        np.float32)
    params = [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])}
              for l in layers]
    want = np.asarray(jac.actor_forward(params, jcfg, jnp.asarray(y), None))
    with torch.no_grad():
        got = _torch_actor(jcfg, layers)(torch.from_numpy(y)).numpy()
    assert got.shape == (40, 2)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_actor_forward_batched_matches_unbatched():
    cfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(8,), k=3)
    actor = _torch_actor(cfg, _numpy_layers(cfg, seed=0))
    y = torch.randn(5, 3, 7, 6, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        batched = actor(y)
        single = torch.stack([actor(y[b]) for b in range(5)])
    assert batched.shape == (5, 7, 2)
    torch.testing.assert_close(batched, single)


def test_actor_rejects_ind_agg_and_bad_bound():
    """Pre-aggregated input (no ``delay_gso``) needs ``ind_agg == 0``, as
    the JAX ``actor_forward`` says; an ``ind_agg = 1`` actor takes the
    delayed GSO (tests/test_torch_critic.py)."""
    actor = tac.Actor(tac.ActorConfig(6, 2, (8,), 3, ind_agg=1))
    with pytest.raises(ValueError, match="ind_agg"):
        actor(torch.zeros(3, 5, 6))
    with pytest.raises(ValueError, match="bound"):
        tac.ActorConfig(6, 2, (8,), 3, bound="relu")


def test_npz_reader_matches_jax_loader_on_n32k_checkpoint():
    cfg = tac.ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=3)
    got = tck.load_actor_npz(str(N32K), cfg)
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=3)
    want = jck.load(str(N32K), jac.init_actor(jax.random.key(0), jcfg))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for name in ("w", "b"):
            np.testing.assert_array_equal(g[name], np.asarray(w[name]))
    # and the imported actor acts as the JAX actor with those weights
    y = np.random.default_rng(0).normal(size=(3, 64, 6)).astype(np.float32)
    ref = np.asarray(jac.actor_forward(want, jcfg, jnp.asarray(y), None))
    with torch.no_grad():
        out = _torch_actor(cfg, got)(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("k,hidden", [(2, (32, 32)), (3, (16, 16)),
                                      (3, (32,))])
def test_npz_reader_refuses_other_architectures(k, hidden):
    with pytest.raises(ValueError, match="mismatch|layer"):
        tck.load_actor_npz(str(N32K), tac.ActorConfig(6, 2, hidden, k))


def test_treedef_string_matches_jax():
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=(32, 32), k=3)
    treedef = jax.tree_util.tree_structure(
        jac.init_actor(jax.random.key(0), jcfg))
    assert tck.actor_treedef(3) == str(treedef)


@pytest.mark.parametrize("k,hidden",
                         [(1, (8,)), (3, (32, 32)), (4, (16, 24, 8))])
def test_param_count_and_hidden_layers_match_jax(k, hidden):
    """``actor_param_count`` over JAX-layout layers (numpy, tensors, or the
    JAX package's own arrays) and ``hidden_layers`` give the JAX values."""
    jcfg = jac.ActorConfig(n_s=6, n_a=2, hidden=hidden, k=k)
    params = jac.init_actor(jax.random.key(k), jcfg)
    layers = _numpy_layers(jcfg, seed=k)
    want = jac.actor_param_count(params)
    assert tac.actor_param_count(layers) == want
    tensors = [{n: torch.from_numpy(v) for n, v in l.items()}
               for l in layers]
    assert tac.actor_param_count(tensors) == want
    assert tac.actor_param_count(params) == want
    actor = _torch_actor(jcfg, layers)
    assert want == sum(p.numel() for p in actor.parameters())
    for size, n in ((32, 2), (hidden[0], len(hidden)), (7, 0)):
        assert tac.hidden_layers(size, n) == jac.hidden_layers(size, n)
