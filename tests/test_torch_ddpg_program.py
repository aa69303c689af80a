"""The port's compiled DDPG episode on the CPU, where each program runs the
body it captures on the card eagerly:

* the replay buffer's device insert (``ReplayBuffer.insert_device``,
  which writes at the device cursor and advances the device cursor and
  size by device arithmetic) writes the slots the host-int insert writes,
  bit for bit, into an empty, partly filled and full buffer and across
  the ring's end within one call;
* the training-episode programs (``algos/ddpg.py:DDPG._run_program``)
  equal the eager loop (``graph=False``) bit for bit over consecutive
  episodes whose update gate opens after the episode, mid-episode and at
  its first step, with a buffer that wraps within an episode: each
  episode's summed reward and losses and the final training state
  (networks, targets, both Adam states, the buffer, the generator), for
  the dense learner with and without GroupNorm and the positions record
  at N = 48;
* the evals through their programs (the dense episode program of
  ``algos/imitation.py``, the positions record's eval program) equal the
  eager loops bit for bit, the velocity-noise variant and the generator's
  state after included;
* a learner whose programs ran resumes a state file into the
  uninterrupted run's state; ``graph=True`` raises on the CPU.

The JAX comparisons (``test_torch_ddpg.py``, ``test_torch_ddpg_large.py``)
run through the same programs' bodies, the learners' default. Everything
here is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multiagent_gnn_policies_tpu_torch.algos import ddpg as tdd
from multiagent_gnn_policies_tpu_torch.algos import ddpg_large as tdl
from multiagent_gnn_policies_tpu_torch.algos.replay import ReplayBuffer
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.models import actor as tac
from multiagent_gnn_policies_tpu_torch.models import critic as tcr

T = 12                  # the dense episode's steps
T_LARGE = 8             # the positions record's


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the device insert ------------------------------------------------------

@pytest.mark.parametrize("fill,t", [(0, 3), (4, 2), (7, 3), (5, 5)],
                         ids=["empty", "partly", "full", "wraps"])
def test_device_insert_writes_the_host_int_slots(fill, t):
    cap = 7
    bufs = [ReplayBuffer(cap, {"i": torch.zeros((), dtype=torch.int64),
                               "v": torch.zeros(2)}) for _ in range(2)]
    for buf in bufs:
        for start in range(0, fill, 4):
            n = min(4, fill - start)
            buf.insert({"i": torch.arange(start, start + n),
                        "v": torch.full((n, 2), float(start))})
    chunk = {"i": torch.arange(100, 100 + t),
             "v": torch.arange(2.0 * t).reshape(t, 2)}
    host, dev = bufs
    host.insert(chunk)
    dev.insert_device(chunk)
    assert (dev.size, dev.cursor) == (min(fill, cap), fill % cap)
    dev.advance(t)
    for k in host.data:
        assert torch.equal(dev.data[k], host.data[k]), k
    for buf in bufs:
        assert (int(buf._size_dev), int(buf._cursor_dev)) == (
            buf.size, buf.cursor) == (min(fill + t, cap), (fill + t) % cap)
    dev.cursor = 2                   # the setter moves the device copy too
    assert int(dev._cursor_dev) == 2
    with pytest.raises(ValueError, match="exceeds buffer capacity"):
        dev.insert_device({"i": torch.zeros(cap + 1, dtype=torch.int64),
                           "v": torch.zeros(cap + 1, 2)})


# --- the training episode ---------------------------------------------------

def _cfg(gn=False, large=False, env="FlockingRelative-v0", **kw):
    """A tiny DDPG config whose gate opens after episode 0, in episode 1
    and at episode 2's first step, and whose buffer wraps in episode 2."""
    steps = T_LARGE if large else T
    d = dict(batch_size=10 if large else 16, buffer_size=19 if large else 30,
             updates_per_step=1, actor_lr=1e-3, critic_lr=1e-3, gamma=0.9,
             tau=0.1, n_train_episodes=20, n_test_episodes=2, seed=0,
             reward_scale=0.5)
    d.update(kw)
    hidden = (8, 8)
    return tdd.DDPGConfig(
        actor=tac.ActorConfig(n_s=6, n_a=2, hidden=hidden, k=2, ind_agg=1),
        critic=tcr.CriticConfig(n_s=6, n_a=2, hidden=hidden, k=2,
                                use_groupnorm=gn,
                                input_transform="identity" if gn
                                else "asinh"),
        env_name=env,
        env=tfl.FlockingParams(n_agents=48 if large else 8,
                               episode_steps=steps, max_resets=4),
        **d)


def _flat(lrn):
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = (v.detach().cpu().numpy()
                                   if isinstance(v, torch.Tensor)
                                   else np.asarray(v))

    walk(lrn.training_state(), "")
    return out


def _assert_same_state(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    assert any(k.startswith("critic_opt/") for k in fa)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("large,gn", [(False, False), (False, True),
                                      (True, False)],
                         ids=["dense", "dense_gn", "positions"])
def test_program_equals_the_eager_loop(large, gn):
    cls = tdl.DDPGLarge if large else tdd.DDPG
    cfg = _cfg(gn=gn, large=large)
    prog, eager = cls(cfg, device="cpu"), cls(cfg, device="cpu", graph=False)
    steps, b = cfg.env.episode_steps, cfg.batch_size
    opens = []
    for ep in range(3):
        opens.append(prog._gate_opens())
        got, want = prog.episode(), eager.episode()
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), ep
        assert prog.timing["updates"] == eager.timing["updates"]
    # after the episode, mid-episode, at the first step
    assert opens == [steps, b - steps, 0]
    assert sorted(prog._programs) == sorted(
        (t, False, False) for t in opens)
    assert not eager._programs
    assert float(got[1]) > 0.0 and prog.timing["updates"] == (
        2 * steps - (b - steps))
    # the ring wrapped in episode 2
    assert prog.buffer.size == cfg.buffer_size
    assert prog.buffer.cursor == 3 * steps - cfg.buffer_size
    assert int(prog.buffer._cursor_dev) == prog.buffer.cursor
    assert int(prog.buffer._size_dev) == prog.buffer.size
    _assert_same_state(prog, eager)


def test_injected_draws_run_through_their_own_program():
    """``episode(x0, noise, indices)`` (the JAX comparisons' form) keys a
    program of its own and equals the eager loop on the same draws."""
    cfg = _cfg(batch_size=4, buffer_size=50)
    prog, eager = tdd.DDPG(cfg, device="cpu"), tdd.DDPG(cfg, device="cpu",
                                                        graph=False)
    rng = np.random.default_rng(3)
    x0 = tfl._init_candidate(torch.Generator().manual_seed(3), cfg.env,
                             "cpu")
    noise = torch.from_numpy(rng.normal(size=(T, 8, 2)).astype(np.float32))
    idx = torch.from_numpy(np.stack([rng.permutation(max(t + 1, 4))[:4]
                                     for t in range(T)])[:, None]).long()
    got = prog.episode(x0, noise, idx)
    want = eager.episode(x0, noise, idx)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert list(prog._programs) == [(4, True, True)]
    _assert_same_state(prog, eager)


# --- the evals --------------------------------------------------------------

@pytest.mark.parametrize("env", ["FlockingRelative-v0",
                                 "FlockingStochastic-v0"])
def test_eval_program_equals_the_eager_loop(env):
    cfg = _cfg(env=env)
    actor = tac.init_actor_(tac.Actor(cfg.actor),
                            torch.Generator().manual_seed(1))
    e = tfl.make_env(env, cfg.env)
    out = []
    for graph in (False, None, None):     # eager, the program twice
        gen = torch.Generator().manual_seed(5)
        r = tdd.eval_episodes(actor, e, cfg.actor, gen, 3, graph=graph)
        out.append((r, gen.get_state()))
    (want, want_gen) = out[0]
    assert want.shape == (3,) and bool(torch.isfinite(want).all())
    for got, got_gen in out[1:]:
        assert torch.equal(got, want) and torch.equal(got_gen, want_gen)


@pytest.mark.parametrize("noise", [0.0, 0.1], ids=["noiseless", "noise"])
def test_positions_eval_program_equals_the_eager_loop(noise):
    cfg = _cfg(large=True)
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, dynamics_noise=noise))
    prog, eager = (tdl.DDPGLarge(cfg, device="cpu", graph=g)
                   for g in (None, False))
    for _ in range(2):
        np.testing.assert_array_equal(prog.eval_rewards(),
                                      eager.eval_rewards())
        assert torch.equal(prog.gen.get_state(), eager.gen.get_state())
    assert prog._eval_prog is not None and eager._eval_prog is None


# --- resume and refusals ----------------------------------------------------

@pytest.mark.parametrize("large", [False, True], ids=["dense", "positions"])
def test_resume_into_a_learner_whose_programs_ran(large, tmp_path):
    """Round 3 of a learner whose programs ran (another seed's three
    episodes), after it loads the state file of a run stopped after two:
    the uninterrupted run's training state, bit for bit."""
    cls = tdl.DDPGLarge if large else tdd.DDPG
    cfg = _cfg(large=large)
    state = str(tmp_path / "state.npz")
    full = cls(cfg, device="cpu")
    full.train(stop_after=3)
    part = cls(cfg, device="cpu")
    assert part.train(state_path=state, stop_after=2)["interrupted"]
    rest = cls(dataclasses.replace(cfg, seed=9), device="cpu")
    rest.train(stop_after=3)
    programs = dict(rest._programs)
    rest.load_training_state(state)
    rest.train(stop_after=3)
    assert rest._programs == programs        # the same programs, replayed
    _assert_same_state(full, rest)


def test_graph_true_raises_on_the_cpu():
    for cls, large in ((tdd.DDPG, False), (tdl.DDPGLarge, True)):
        with pytest.raises(ValueError, match="on the CPU"):
            cls(_cfg(large=large), device="cpu", graph=True)
    cfg = _cfg()
    with pytest.raises(ValueError, match="on the CPU"):
        tdd.eval_episodes(tac.Actor(cfg.actor),
                          tfl.make_env(cfg.env_name, cfg.env), cfg.actor,
                          torch.Generator(), 2, graph=True)
    with pytest.raises(ValueError, match="must be None"):
        tdd.DDPG(cfg, device="cpu", graph="yes")
