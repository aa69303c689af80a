"""The port's GNN critic (``models/critic.py``) and DDPG actor
(``models/actor.py`` with ``ind_agg = 1`` and a delayed GSO) against the
JAX package: the same numpy weights and inputs give the same Q values and
actions; the weight converters round-trip; the init draws inside the JAX
bounds; the in-repo DDPG actor and critic files load in the port and act
as the JAX package's; each package reads the other's critic files; and
the reference critic's state_dict reads into the same layers in both.

Tolerance: float32 products in different summation orders; outputs agree
within 1e-5 of their largest magnitude.
"""

import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiagent_gnn_policies_tpu.models import actor as jac
from multiagent_gnn_policies_tpu.models import critic as jcr
from multiagent_gnn_policies_tpu.models import torch_import as jti
from multiagent_gnn_policies_tpu.ops import graph as jgr
from multiagent_gnn_policies_tpu.utils import checkpoint as jck
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import critic as tcr
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
MODELS = ROOT / "models"
REL = 1e-5
N = 24


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= REL * float(np.abs(want).max()), (what, err)


def _gso(rng, batch=(), n=N, k=2):
    """Normalised radius adjacencies of random positions and their powers
    ``[I, A, .., A^{k-1}]`` from the JAX package."""
    pos = rng.uniform(-2.0, 2.0, size=(*batch, n, 2))
    d = pos[..., :, None, :] - pos[..., None, :, :]
    adj = ((d ** 2).sum(-1) < 1.0) & ~np.eye(n, dtype=bool)
    a = jgr.normalized_adjacency(jnp.asarray(adj, jnp.float32))
    powers = jgr.gso_powers(a.reshape(-1, n, n)[0], k) if not batch else (
        jnp.stack([jgr.gso_powers(m, k) for m in a.reshape(-1, n, n)])
        .reshape(*batch, k, n, n))
    return np.array(a), np.array(powers)


def _critic_layers(jcfg, seed):
    """JAX-layout critic layers with GroupNorm affines away from 1 and 0."""
    params = jcr.init_critic(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    out = []
    for layer in params:
        layer = {k: np.array(v) for k, v in layer.items()}
        if "gn_scale" in layer:
            layer["gn_scale"] = rng.uniform(0.5, 1.5, layer["gn_scale"].shape
                                            ).astype(np.float32)
            layer["gn_bias"] = rng.normal(0, 0.2, layer["gn_bias"].shape
                                          ).astype(np.float32)
        out.append(layer)
    return out


def _port_critic(layers, tcfg):
    critic = tcr.Critic(tcfg)
    critic.load_state_dict(tti.critic_params_from_numpy(layers))
    return critic


def _cfgs(k, gn=True, transform="identity", hidden=(16, 16)):
    kw = dict(n_s=6, n_a=2, hidden=hidden, k=k, use_groupnorm=gn,
              input_transform=transform)
    return jcr.CriticConfig(**kw), tcr.CriticConfig(**kw)


def _jax_q(layers, jcfg, s, a, gso):
    params = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    return np.asarray(jcr.critic_forward(params, jcfg, jnp.asarray(s),
                                         jnp.asarray(a), jnp.asarray(gso)))


@pytest.mark.parametrize("transform", ["identity", "asinh"])
@pytest.mark.parametrize("gn", [True, False], ids=["gn", "no-gn"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_critic_forward_matches_jax(k, gn, transform):
    jcfg, tcfg = _cfgs(k, gn, transform)
    layers = _critic_layers(jcfg, seed=k)
    critic = _port_critic(layers, tcfg)
    rng = np.random.default_rng(10 * k + gn)
    for batch in ((), (3,)):
        # observation-like states: 1/r^4 features spike far past the others
        s = (rng.normal(size=(*batch, N, 6))
             * np.array([1, 50, 5, 1, 50, 5])).astype(np.float32)
        a = rng.uniform(-1, 1, size=(*batch, N, 2)).astype(np.float32)
        _, gso = _gso(rng, batch, k=k)
        want = _jax_q(layers, jcfg, s, a, gso)
        with torch.no_grad():
            got = critic(torch.from_numpy(s), torch.from_numpy(a),
                         torch.from_numpy(gso))
        assert got.shape == (*batch, N)
        _close(got, want, f"batch {batch}")


def _actor_cfgs(k, bound):
    kw = dict(n_s=6, n_a=2, hidden=(16, 16), k=k, ind_agg=1, bound=bound)
    return jac.ActorConfig(**kw), tac.ActorConfig(**kw)


def _delay_gso(rng, batch, k):
    """A delayed GSO stack ``[I, A_t, A_t A_{t-1}, ..]`` of random graphs."""
    adjs = [_gso(rng, batch, k=1)[0] for _ in range(max(k - 1, 1))]
    eye = np.broadcast_to(np.eye(N, dtype=np.float32), (*batch, N, N))
    gs = [eye]
    for s in range(k - 1):
        gs.append(gs[-1] @ adjs[s])
    return np.stack(gs, -3).astype(np.float32)


@pytest.mark.parametrize("bound", ["tanh", "none"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_ddpg_actor_matches_jax(k, bound):
    """``ind_agg = 1``: a per-tap first layer, the aggregation over the
    delayed GSO, then the tap-contracting layer; the JAX weights go
    through the same converter as the imitation actor's (k-major taps)."""
    jcfg, tcfg = _actor_cfgs(k, bound)
    params = jac.init_actor(jax.random.key(k), jcfg)
    params[-1]["w"] = params[-1]["w"] * 20.0      # leave [-1, 1] when raw
    actor = tac.Actor(tcfg)
    actor.load_state_dict(tti.actor_params_from_numpy(
        [{n: np.array(v) for n, v in l.items()} for l in params]))
    rng = np.random.default_rng(k)
    for batch in ((), (2,)):
        ds = rng.normal(size=(*batch, k, N, 6)).astype(np.float32)
        gso = _delay_gso(rng, batch, k)
        want = np.asarray(jac.actor_forward(params, jcfg, jnp.asarray(ds),
                                            jnp.asarray(gso)))
        with torch.no_grad():
            got = actor(torch.from_numpy(ds), torch.from_numpy(gso))
        _close(got, want, f"batch {batch}")
        if bound == "none":
            assert np.abs(want).max() > 1.0
    with pytest.raises(ValueError, match="ind_agg"):
        actor(torch.from_numpy(ds))           # pre-aggregated input refused


@pytest.mark.parametrize("gn", [True, False], ids=["gn", "no-gn"])
def test_critic_converters_round_trip(gn):
    jcfg, tcfg = _cfgs(2, gn)
    layers = _critic_layers(jcfg, seed=3)
    sd = tti.critic_params_from_numpy(layers)
    assert sorted(sd) == sorted(tcr.Critic(tcfg).state_dict())
    back = tti.critic_numpy_from_params(sd, tcfg)
    assert [sorted(l) for l in back] == [sorted(l) for l in layers]
    for b, l in zip(back, layers):
        for name in l:
            np.testing.assert_array_equal(b[name], l[name])
    # the DDPG actor's layers survive the actor converters as they are
    jacfg, tacfg = _actor_cfgs(2, "tanh")
    params = jac.init_actor(jax.random.key(1), jacfg)
    got = tti.actor_numpy_from_params(tti.actor_params_from_numpy(
        [{n: np.array(v) for n, v in l.items()} for l in params]), tacfg)
    for g, w in zip(got, params):
        for name in ("w", "b"):
            np.testing.assert_array_equal(g[name], np.asarray(w[name]))


def test_init_bounds():
    """Weights and biases uniform in ``±1/sqrt(c_in · w_in)``, spread over
    most of the range; GroupNorm scales one and biases zero."""
    tcfg = tcr.CriticConfig(n_s=6, n_a=2, hidden=(64, 64), k=3)
    critic = tcr.init_critic_(tcr.Critic(tcfg),
                              torch.Generator().manual_seed(0))
    for i, layer in enumerate(critic.layers):
        bound = 1.0 / np.sqrt(tcfg.in_channels(i) * tcfg.widths[i])
        w, b = layer.weight.detach(), layer.bias.detach()
        assert float(w.abs().max()) <= bound and float(b.abs().max()) <= bound
        assert float(w.abs().max()) > 0.9 * bound
    assert all(torch.equal(s, torch.ones_like(s)) for s in critic.gn_scale)
    assert all(torch.equal(b, torch.zeros_like(b)) for b in critic.gn_bias)
    assert len(critic.gn_scale) == 2


@pytest.mark.parametrize("name,gn,transform,bound", [
    ("ddpg_toy_k2", False, "asinh", "tanh"),
    ("ddpg_k2", True, "identity", "tanh"),
    ("ddpg_unbounded_k2", True, "identity", "none"),
])
def test_in_repo_ddpg_files_act_as_in_jax(name, gn, transform, bound):
    """The committed actor and critic files of each DDPG run, read by the
    port's loaders, give the JAX package's actions and Q values."""
    base = MODELS / f"actor_FlockingRelative-v0_{name}"
    jcfg, tcfg = _cfgs(2, gn, transform)
    jacfg, tacfg = _actor_cfgs(2, bound)
    clayers = tck.load_critic_npz(str(base) + "_critic.npz", tcfg)
    alayers = tck.load_actor_npz(str(base) + ".npz", tacfg)
    jcritic = jck.load(str(base) + "_critic.npz",
                       jcr.init_critic(jax.random.key(0), jcfg))
    jactor = jck.load(str(base) + ".npz",
                      jac.init_actor(jax.random.key(0), jacfg))
    for g, w in zip(clayers + alayers, jcritic + jactor):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    rng = np.random.default_rng(0)
    ds = rng.normal(size=(2, N, 6)).astype(np.float32)
    gso = _delay_gso(rng, (), 2)
    want_a = np.array(jac.actor_forward(jactor, jacfg, jnp.asarray(ds),
                                          jnp.asarray(gso)))
    actor = tac.Actor(tacfg)
    actor.load_state_dict(tti.actor_params_from_numpy(alayers))
    with torch.no_grad():
        got_a = actor(torch.from_numpy(ds), torch.from_numpy(gso))
    _close(got_a, want_a, "actions")
    _, powers = _gso(rng, (), k=2)
    want_q = np.asarray(jcr.critic_forward(
        jcritic, jcfg, jnp.asarray(ds[0]), jnp.asarray(want_a),
        jnp.asarray(powers)))
    with torch.no_grad():
        got_q = _port_critic(clayers, tcfg)(
            torch.from_numpy(ds[0]), torch.from_numpy(want_a),
            torch.from_numpy(powers))
    _close(got_q, want_q, "Q")


@pytest.mark.parametrize("gn", [True, False], ids=["gn", "no-gn"])
def test_critic_files_read_by_both_packages(tmp_path, gn):
    jcfg, tcfg = _cfgs(2, gn)
    # the port writes, the JAX package reads
    critic = tcr.init_critic_(tcr.Critic(tcfg),
                              torch.Generator().manual_seed(1))
    layers = tti.critic_numpy_from_params(critic.state_dict(), tcfg)
    path = str(tmp_path / "port_critic.npz")
    tck.save_layers_npz(path, layers)
    got = jck.load(path, jcr.init_critic(jax.random.key(0), jcfg))
    for g, w in zip(got, layers):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), w[k])
    # the JAX package writes, the port reads
    params = jcr.init_critic(jax.random.key(2), jcfg)
    path = str(tmp_path / "jax_critic.npz")
    jck.save(path, params)
    back = tck.load_critic_npz(path, tcfg)
    for g, w in zip(back, params):
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    # another architecture is refused
    with pytest.raises(ValueError, match="mismatch|layer"):
        tck.load_critic_npz(path, _cfgs(2, not gn)[1])


def _reference_state_dict(jcfg, seed, as_torch):
    """A reference-layout critic state_dict drawn with numpy:
    ``conv_layers.{i}.weight (W_out, C, W_in, 1)`` and ``.bias``, and
    ``layer_norms.{i}.{weight,bias}`` on the layers that normalise."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i, layer in enumerate(jcr.init_critic(jax.random.key(seed), jcfg)):
        w_out, c, w_in = layer["w"].shape
        sd[f"conv_layers.{i}.weight"] = rng.uniform(
            -0.4, 0.4, (w_out, c, w_in, 1)).astype(np.float32)
        sd[f"conv_layers.{i}.bias"] = rng.uniform(
            -0.4, 0.4, (w_out,)).astype(np.float32)
        if "gn_scale" in layer:
            sd[f"layer_norms.{i}.weight"] = rng.uniform(
                0.5, 1.5, (w_out,)).astype(np.float32)
            sd[f"layer_norms.{i}.bias"] = rng.normal(
                0, 0.2, (w_out,)).astype(np.float32)
    if as_torch:
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    return sd


@pytest.mark.parametrize("as_torch", [True, False], ids=["torch", "numpy"])
@pytest.mark.parametrize("gn", [True, False], ids=["gn", "no-gn"])
@pytest.mark.parametrize("k", [2, 3])
def test_critic_params_from_state_dict_matches_jax(k, gn, as_torch):
    """The reference critic's state_dict read by both packages gives the
    same layers bit for bit, and the port's ``Critic`` loaded from them
    gives JAX ``critic_forward``'s Q values."""
    jcfg, tcfg = _cfgs(k, gn)
    sd = _reference_state_dict(jcfg, 20 + k, as_torch)
    want = jti.critic_params_from_state_dict(sd)
    got = tti.critic_params_from_state_dict(sd)
    assert len(got) == len(want) == jcfg.n_layers
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].dtype == np.float32
            np.testing.assert_array_equal(g[name], np.asarray(w[name]))
    assert any("gn_scale" in l for l in got) == gn
    critic = _port_critic(got, tcfg)
    rng = np.random.default_rng(30 + k)
    s = (rng.normal(size=(N, 6)) * np.array([1, 50, 5, 1, 50, 5])
         ).astype(np.float32)
    a = rng.uniform(-1, 1, size=(N, 2)).astype(np.float32)
    _, gso = _gso(rng, k=k)
    want_q = np.asarray(jcr.critic_forward(want, jcfg, jnp.asarray(s),
                                           jnp.asarray(a), jnp.asarray(gso)))
    with torch.no_grad():
        got_q = critic(torch.from_numpy(s), torch.from_numpy(a),
                       torch.from_numpy(gso))
    _close(got_q, want_q, "Q")


@pytest.mark.parametrize("sd", [{}, {"layers.0.weight": np.zeros((2, 2))}],
                         ids=["empty", "no-conv-layers"])
def test_critic_params_from_state_dict_refuses_without_conv_layers(sd):
    for fn in (jti.critic_params_from_state_dict,
               tti.critic_params_from_state_dict):
        with pytest.raises(ValueError, match="conv_layers"):
            fn(sd)
