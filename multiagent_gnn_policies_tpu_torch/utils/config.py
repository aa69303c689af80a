"""Experiment configuration: the reference's INI files, read unchanged.

A copy of the JAX package's ``utils/config.py`` cut to the fields that the
port's large-N policy evaluation reads. One INI section is one experiment;
``[DEFAULT]`` supplies shared keys. Key names, types and defaults are the
JAX package's, so a section parses to equal values in both packages.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Optional, Tuple


def load_ini(path: str) -> configparser.ConfigParser:
    # strict=False: some generated cfg files repeat a key (e.g.
    # cfg/default_baseline.cfg repeats `dt`); last value wins.
    cp = configparser.ConfigParser(strict=False)
    with open(path) as f:
        cp.read_file(f)
    return cp


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Typed view of one INI section (the fields evaluation reads)."""

    alg: str = "dagger"
    env: str = "FlockingRelative-v0"
    seed: int = 11
    header: Optional[str] = None
    fname: Optional[str] = None
    n_test_episodes: int = 20
    # architecture
    k: int = 3
    hidden_size: int = 32
    n_layers: int = 2
    # env
    v_max: float = 3.0
    comm_radius: float = 1.0
    n_agents: int = 100
    n_actions: int = 2
    n_states: int = 6
    dt: float = 0.01
    centralized: bool = True
    episode_steps: int = 200
    # cell grid of the large-N path: per-cell slot capacity (0 = the
    # path default, 16), grid-extent margin and cell-edge multiple
    cell_cap: int = 0
    cell_margin: float = 1.3
    cell_edge_mult: float = 1.0

    @classmethod
    def from_section(cls, sec) -> "ExperimentConfig":
        """Build from a configparser section proxy."""

        def get(getter, key, default):
            v = getter(key, fallback=None)
            return default if v is None else v

        d = cls()
        return cls(
            alg=get(sec.get, "alg", d.alg).lower(),
            env=get(sec.get, "env", d.env),
            seed=get(sec.getint, "seed", d.seed),
            header=get(sec.get, "header", d.header),
            fname=get(sec.get, "fname", d.fname),
            n_test_episodes=get(sec.getint, "n_test_episodes",
                                d.n_test_episodes),
            k=get(sec.getint, "k", d.k),
            hidden_size=get(sec.getint, "hidden_size", d.hidden_size),
            n_layers=sec.getint("n_layers", fallback=0) or d.n_layers,
            v_max=get(sec.getfloat, "v_max", d.v_max),
            comm_radius=get(sec.getfloat, "comm_radius", d.comm_radius),
            n_agents=get(sec.getint, "n_agents", d.n_agents),
            n_actions=get(sec.getint, "n_actions", d.n_actions),
            n_states=get(sec.getint, "n_states", d.n_states),
            dt=get(sec.getfloat, "dt", d.dt),
            centralized=get(sec.getboolean, "centralized", d.centralized),
            episode_steps=get(sec.getint, "episode_steps", d.episode_steps),
            cell_cap=get(sec.getint, "cell_cap", d.cell_cap),
            cell_margin=get(sec.getfloat, "cell_margin", d.cell_margin),
            cell_edge_mult=get(sec.getfloat, "cell_edge_mult",
                               d.cell_edge_mult),
        )

    @property
    def hidden(self) -> Tuple[int, ...]:
        return tuple([self.hidden_size] * self.n_layers)
