"""Experiment CLI of the port: the counterpart of ``train.py``.

    python -m multiagent_gnn_policies_tpu_torch.train cfg/dagger.cfg \\
        [--sections a,b] [--metrics PATH] [--state-dir DIR] \\
        [--checkpoint-every R] [--profile DIR] [--device cuda|cpu]

Reads an INI experiment file (one section = one experiment, ``[DEFAULT]``
inherited), runs each section's algorithm on the card (``--device cpu``
only when asked) and prints the same CSV as ``train.py``: the first
section's header, then ``section, mean, std`` per section (a file with
only ``[DEFAULT]`` prints the stats dict).

Algorithms: ``dagger``, ``cloning``, ``ddpg`` and ``baseline``. Sections
with ``trainer = large``, or ``trainer = auto`` and ``n_agents > 1024``,
train through the large-N learners: DAGGER and cloning through
``algos/imitation_large.py`` (cell-sweep collection, agent-subsampled
replay), DDPG through ``algos/ddpg_large.py`` (the positions record); the
others through the dense ones. On one card the imitation learners and
the baseline run their episodes' steps and their Adam updates as CUDA
graphs (``algos/imitation.py``'s programs), and DDPG its training
episodes, gradient steps included, and its evals (``algos/ddpg.py``).

Actor exports go to ``runs/torch/models/actor_{env}_{fname}[.npz]`` under
the working directory, never over the checkpoints in ``models/``; DDPG
adds the critic as ``actor_{env}_{fname}_critic.npz``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

MODELS_DIR = os.path.join("runs", "torch", "models")

def run_experiment(section, metrics_path=None, state_dir=None,
                   checkpoint_every=0, device="cuda"):
    from multiagent_gnn_policies_tpu_torch.algos.baseline import (
        train_baseline,
    )
    from multiagent_gnn_policies_tpu_torch.algos.imitation import (
        train_cloning,
        train_dagger,
    )
    from multiagent_gnn_policies_tpu_torch.envs.flocking import strict_fp32
    from multiagent_gnn_policies_tpu_torch.utils.config import (
        ExperimentConfig,
    )
    from multiagent_gnn_policies_tpu_torch.utils.metrics import MetricsLogger

    strict_fp32()
    cfg = ExperimentConfig.from_section(section)
    np.random.seed(cfg.seed)

    trainers = {"dagger": train_dagger, "cloning": train_cloning,
                "baseline": train_baseline}
    use_large = cfg.trainer == "large" or (
        cfg.trainer == "auto" and cfg.n_agents > 1024)
    if use_large and cfg.alg in ("dagger", "cloning"):
        # the dense (K, N, N) graph state would not fit (12.9 GB per step
        # at N = 32,768): cell-sweep collection and subsampled replay
        from multiagent_gnn_policies_tpu_torch.algos.imitation_large import (
            train_cloning_large,
            train_dagger_large,
        )
        trainers["dagger"] = train_dagger_large
        trainers["cloning"] = train_cloning_large
    if cfg.alg == "ddpg":
        if use_large:
            # the dense record holds (K, N, N) graphs: positions instead
            from multiagent_gnn_policies_tpu_torch.algos.ddpg_large import (
                train_ddpg_large,
            )
            trainers["ddpg"] = train_ddpg_large
        else:
            from multiagent_gnn_policies_tpu_torch.algos.ddpg import (
                train_ddpg,
            )
            trainers["ddpg"] = train_ddpg
    if cfg.alg not in trainers:
        raise SystemExit(f"Invalid algorithm/mode name: {cfg.alg!r}")

    save_path = None
    if cfg.fname:
        save_path = os.path.join(MODELS_DIR, f"actor_{cfg.env}_{cfg.fname}")
    extra = {}
    if state_dir and cfg.alg in ("dagger", "cloning", "ddpg"):
        os.makedirs(state_dir, exist_ok=True)
        extra = {"state_path": os.path.join(
                     state_dir, f"{section.name or 'DEFAULT'}_state.npz"),
                 "checkpoint_every": checkpoint_every}
    with MetricsLogger(metrics_path, echo=cfg.debug) as logger:
        stats = trainers[cfg.alg](cfg, logger=logger, save_path=save_path,
                                  device=device, **extra)
    return cfg, stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("config", help="INI experiment file")
    ap.add_argument("--metrics", default=None, help="JSONL metrics output path")
    ap.add_argument("--sections", default=None,
                    help="comma-separated subset of sections to run")
    ap.add_argument("--state-dir", default=None,
                    help="directory of training-state checkpoints; a state "
                         "file there resumes its section")
    ap.add_argument("--checkpoint-every", type=int, default=10,
                    help="rounds (DDPG: episodes) between state checkpoints "
                         "(with --state-dir)")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler Chrome trace of the whole "
                         "run into this directory")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu; nothing falls back")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False); pass --device cpu to run on the CPU")

    from multiagent_gnn_policies_tpu_torch.parallel import distributed
    from multiagent_gnn_policies_tpu_torch.utils.config import load_ini
    from multiagent_gnn_policies_tpu_torch.utils.profiling import trace

    # a multi-process launch (MAGNN_* or torchrun variables) joins its
    # process group before anything is built, as train.py does; the
    # learners here build no mesh
    distributed.maybe_initialize_distributed(
        "cpu" if args.device == "cpu" else None)
    config = load_ini(args.config)
    only = set(args.sections.split(",")) if args.sections else None
    sections = [s for s in config.sections() if only is None or s in only]
    with trace(args.profile):
        run_all(sections, config, args)


def run_all(sections, config, args):
    run = lambda sec: run_experiment(sec, args.metrics, args.state_dir,
                                     args.checkpoint_every, args.device)
    if not sections:
        _, stats = run(config[config.default_section])
        print(stats)
        return
    print(config[sections[0]].get("header"), flush=True)
    for name in sections:
        _, stats = run(config[name])
        print(f"{name}, {stats['mean']}, {stats['std']}", flush=True)


if __name__ == "__main__":
    main()
