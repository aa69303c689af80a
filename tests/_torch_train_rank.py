"""One rank of a gloo process group on the CPU that trains the port's
imitation learners on a mesh (run by tests/test_torch_dp_training.py, one
subprocess per rank):

    python tests/_torch_train_rank.py RANK WORLD PORT CASES.json OUT_DIR

Each case of the JSON list names an ``op``, a mesh shape ``n_env`` x
``WORLD / n_env`` and the learner's config (``dense``: an
``ImitationConfig``, ``large``: a ``LargeNImitationConfig``, as keyword
arguments with ``hidden``, ``k``, ``n_agents``, ``episode_steps`` for the
actor and the env). The rank writes what it computed to
``OUT_DIR/<case>_<rank>.npz``. A case with ``graph`` passes it to the
learner (or the episode): by default their loops run through their
programs' bodies, ``false`` the eager loops:

* ``train``: ``ShardedImitationLearner`` (dense) or
  ``LargeNImitationLearner(mesh=)`` (large) trained through ``train()``:
  the actor's parameters, the buffer, the returned stats;
* ``resume``: the same learner stopped after round 1 with its state
  saved, then a fresh one resuming it to the end, its metrics logged to
  ``OUT_DIR/<case>_metrics_<rank>.jsonl``: its parameters, buffer and
  stats;
* ``update``: one ``ShardedImitationLearner._update`` of an actor
  ``state_dict`` file on a batch (.npz): the updated parameters and the
  all-reduced gradient Adam took;
* ``collect``: one ``collect_episode`` of the large path on the mesh with
  an injected initial state, coins and subsample indices (.npz, which the
  rank waits for: the test writes it while the ranks run): the records,
  the reward and the overflow;
* ``guards``: the ``dense`` and the ``large`` learner of the case's two
  configs on the mesh: the ValueError each raises, by learner;
* ``overflow``: a large-N round in which rank ``bad_rank``'s collection
  reports an overflow; every rank must raise the gate's error (the rank
  exits non-zero).

Imports no JAX.
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multiagent_gnn_policies_tpu_torch.algos import imitation as im  # noqa
from multiagent_gnn_policies_tpu_torch.algos import (  # noqa: E402
    imitation_large as il)
from multiagent_gnn_policies_tpu_torch.envs.flocking import (  # noqa: E402
    ENV_REGISTRY, FlockingParams)
from multiagent_gnn_policies_tpu_torch.models.actor import (  # noqa: E402
    Actor, ActorConfig)
from multiagent_gnn_policies_tpu_torch.parallel import distributed  # noqa
from multiagent_gnn_policies_tpu_torch.parallel import large_n as ln  # noqa
from multiagent_gnn_policies_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh)
from multiagent_gnn_policies_tpu_torch.parallel.sharded import (  # noqa
    ShardedImitationLearner)
from multiagent_gnn_policies_tpu_torch.utils.metrics import (  # noqa: E402
    MetricsLogger)

DRAWS_WAIT_S = 300


def make_config(kind, kw):
    """The learner config of a case: ``kind`` "dense" or "large"."""
    kw = dict(kw)
    actor = ActorConfig(n_s=6, n_a=2, hidden=tuple(kw.pop("hidden")),
                        k=kw.pop("k"))
    env = FlockingParams(n_agents=kw.pop("n_agents"),
                         episode_steps=kw.pop("episode_steps"),
                         **kw.pop("env_kw", {}))
    cls = im.ImitationConfig if kind == "dense" else il.LargeNImitationConfig
    kw.setdefault("env_name", "FlockingRelative-v0")
    return cls(actor=actor, env=env, **kw)


def make_learner(kind, cfg, mesh, logger=None, graph=None):
    """The case's learner: on ``mesh``, or one process's with None."""
    if kind == "dense":
        if mesh is None:
            return im.ImitationLearner(cfg, logger, device="cpu", graph=graph)
        return ShardedImitationLearner(cfg, mesh, logger, device="cpu",
                                       graph=graph)
    return il.LargeNImitationLearner(cfg, logger, device="cpu", mesh=mesh,
                                     graph=graph)


def learner_arrays(lrn, stats):
    """What a train or resume case writes."""
    out = {f"param/{k}": v.numpy() for k, v in lrn.actor.state_dict().items()}
    out.update({f"buffer/{k}": v[:lrn.buffer.size].numpy()
                for k, v in lrn.buffer.data.items()})
    out.update(mean=stats["mean"], std=stats["std"], rounds=lrn._rnd,
               loss_sum=float(lrn.last_loss_sum))
    return out


def run_case(case, mesh, out_dir):
    op, kind = case["op"], case.get("kind", "dense")
    cfg = make_config(kind, case["cfg"]) if "cfg" in case else None
    if op == "train":
        lrn = make_learner(kind, cfg, mesh, graph=case.get("graph"))
        return learner_arrays(lrn, lrn.train())
    if op == "resume":
        state = os.path.join(out_dir, f"{case['name']}_state.npz")
        metrics = os.path.join(out_dir, f"{case['name']}_metrics_"
                               f"{distributed.process_info()[0]}.jsonl")
        part = make_learner(kind, cfg, mesh)
        assert part.train(state_path=state, stop_after=1)["interrupted"]
        with MetricsLogger(metrics) as log:
            rest = make_learner(kind, cfg, mesh, log)
            return learner_arrays(rest, rest.train(state_path=state))
    if op == "update":
        lrn = make_learner(kind, cfg, mesh)
        lrn.actor.load_state_dict(torch.load(case["actor"],
                                             weights_only=True))
        batch = {k: torch.from_numpy(v)
                 for k, v in np.load(case["batch"]).items()}
        loss = lrn._update(batch)
        return {**{f"param/{k}": v.numpy()
                   for k, v in lrn.actor.state_dict().items()},
                **{f"grad/{k}": p.grad.numpy()
                   for k, p in lrn.actor.named_parameters()},
                "loss": float(loss)}
    if op == "collect":
        return collect(case, mesh)
    if op == "guards":
        errors = {}
        for k in ("dense", "large"):
            try:
                make_learner(k, make_config(k, case[k]), mesh)
            except ValueError as e:
                errors[k] = str(e)
        return errors
    if op == "overflow":
        lrn = make_learner(kind, cfg, mesh)
        if distributed.process_info()[0] == case["bad_rank"]:
            real = il.collect_episode

            def overflowing(*a, **kw):
                samples, reward, _ = real(*a, **kw)
                return samples, reward, torch.ones((), dtype=torch.int32)
            il.collect_episode = overflowing
        lrn.train()
        raise AssertionError("the overflow gate did not raise")
    raise ValueError(f"unknown op {op!r}")


def collect(case, mesh):
    """One collecting episode of the large path from injected draws, on
    ``mesh`` (None: one process on the grid the mesh uses)."""
    p = ENV_REGISTRY[case["env"]](FlockingParams(
        n_agents=case["n"], episode_steps=case["steps"]))
    acfg = ActorConfig(n_s=6, n_a=2, hidden=tuple(case["hidden"]), k=3)
    actor = Actor(acfg)
    actor.load_state_dict(torch.load(case["actor"], weights_only=True))
    waited = 0.0
    while not os.path.exists(case["draws"]):     # written by the test
        if waited > DRAWS_WAIT_S:
            raise TimeoutError(f"no {case['draws']} after {waited} s")
        time.sleep(0.1)
        waited += 0.1
    draws = np.load(case["draws"])
    cfg = ln.make_config(p, path=case["path"], centralized=True,
                         need_expert=True, mesh=mesh)
    if mesh is None and case["path"] == "pcells":
        cfg = cfg._replace(cell_spec=ln.cc.make_pcell_spec(
            p, n_dev=case["n_dev"]))
    samples, reward, ovf = il.collect_episode(
        cfg, actor, acfg, case["mode"], draws["idx"].shape[1], None, 0.5,
        "cpu", x0=torch.from_numpy(draws["x0"]),
        coins=torch.from_numpy(draws["coins"]),
        idx=torch.from_numpy(draws["idx"]), graph=case.get("graph"))
    return {"agg": samples["agg"].numpy(), "act": samples["act"].numpy(),
            "reward": float(reward), "overflow": int(ovf)}


def main(argv):
    rank, world, port = (int(a) for a in argv[:3])
    cases, out = json.load(open(argv[3])), argv[4]
    torch.set_num_threads(1)
    distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       platform="cpu")
    for case in cases:
        n_env = case.get("n_env", 1)
        mesh = make_mesh(n_env, world // n_env, device_type="cpu")
        arrays = run_case(case, mesh, out)
        np.savez(os.path.join(out, f"{case['name']}_{rank}.npz"), **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
