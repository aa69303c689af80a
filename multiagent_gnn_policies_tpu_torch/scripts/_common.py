"""What the measurement tools share: the ``--device`` argument and its
refusal to fall back to the CPU, the device's identity line, a seeded
policy and the host clock around device work."""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from multiagent_gnn_policies_tpu_torch.models.actor import (
    Actor,
    ActorConfig,
    init_actor_,
)

HIDDEN = (32, 32)


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu; nothing falls back")


def device_of(name: str) -> torch.device:
    """``torch.device(name)``; exits non-zero for "cuda" without a card."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False); pass --device cpu to run on the CPU")
    return torch.device(name)


def device_line(device: torch.device) -> str:
    """The device every number of a run was taken on: on the card,
    ``nvidia-smi``'s name and power limit and torch's device name; on the
    CPU a line that says no number of the run is a device metric."""
    if device.type != "cuda":
        return ("device: cpu (plain PyTorch versions; no number of this run "
                "is a device metric)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return (f"device: {smi.strip()} | torch {torch.cuda.get_device_name(0)}"
            f", {torch.__version__}, CUDA {torch.version.cuda}")


def seeded_actor(k: int, seed: int, device: torch.device,
                 hidden=HIDDEN) -> tuple:
    """``(ActorConfig, Actor)``: a K-tap policy of the canonical widths
    (6 features, 2 actions, ``hidden``) with weights drawn from a
    generator seeded with ``seed``, in eval mode on ``device``."""
    acfg = ActorConfig(n_s=6, n_a=2, hidden=tuple(hidden), k=k)
    gen = torch.Generator(device=device).manual_seed(seed)
    return acfg, init_actor_(Actor(acfg).to(device), gen).eval()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device: torch.device):
    """``(fn(), seconds)`` by the host clock, the device synchronised
    before and after."""
    sync(device)
    t = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t
