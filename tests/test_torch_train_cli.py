"""The port's train CLI (``python -m multiagent_gnn_policies_tpu_torch.train``)
on the CPU: the same CSV as ``train.py`` for a tiny INI, its outputs under
the working directory's ``runs/torch/`` and nowhere else, a resume from
``--state-dir``, the profiler trace, the ``[DEFAULT]``-only path, large-N
sections through the large-N learner, DDPG sections through the dense and
the positions-record learners, and a clear non-zero exit for every section
it cannot run.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch


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

TINY = """
[DEFAULT]
alg = dagger
env = FlockingRelative-v0
seed = 3
debug = False
header = reward
dt = 0.01
batch_size = 8
buffer_size = 200
updates_per_step = 10
actor_lr = 1e-4
n_train_episodes = 2
beta_coeff = 0.993
test_interval = 2
n_test_episodes = 2
k = 2
hidden_size = 8
gamma = 0.99
tau = 0.5
v_max = 3.0
comm_radius = 1.0
n_agents = 10
n_actions = 2
n_states = 6
episode_steps = 20
"""


def run_cli(cfg_text, tmp_path, *extra, device="cpu"):
    cfg = tmp_path / "exp.cfg"
    cfg.write_text(cfg_text)
    return subprocess.run(
        [sys.executable, "-m", "multiagent_gnn_policies_tpu_torch.train",
         str(cfg), "--device", device, *extra],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": str(tmp_path), "PYTHONPATH": str(ROOT),
             "PYTHONDONTWRITEBYTECODE": "1", "OMP_NUM_THREADS": "1"})


def _rows(stdout):
    return [[p.strip() for p in line.split(",")]
            for line in stdout.strip().splitlines() if line]


def test_dagger_csv_outputs_and_resume(tmp_path):
    before = sorted(p.name for p in tmp_path.iterdir())
    text = TINY + "\n[run1]\nseed = 4\nfname = clitest\n\n[run2]\n"
    out = run_cli(text, tmp_path, "--metrics", "m.jsonl", "--state-dir",
                  "state", "--profile", "prof", "--sections", "run1")
    assert out.returncode == 0, out.stderr[-2000:]
    rows = _rows(out.stdout)
    assert rows[0] == ["reward"] and len(rows) == 2
    assert rows[1][0] == "run1"
    mean, std = float(rows[1][1]), float(rows[1][2])
    # outputs: the actor export under runs/torch/models/, the state file,
    # the metrics and the trace; nothing else in the working directory
    models = tmp_path / "runs" / "torch" / "models"
    assert sorted(p.name for p in models.iterdir()) == [
        "actor_FlockingRelative-v0_clitest",
        "actor_FlockingRelative-v0_clitest.npz"]
    assert (tmp_path / "state" / "run1_state.npz").is_file()
    assert (tmp_path / "prof" / "trace.json").is_file()
    events = [json.loads(l)["event"]
              for l in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert events == ["eval", "final_eval", "timing"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        before + ["exp.cfg", "m.jsonl", "prof", "runs", "state"])
    assert not (ROOT / "runs" / "torch" / "models" /
                "actor_FlockingRelative-v0_clitest").exists()
    # a second call finds the finished state, resumes it (no round left),
    # runs a new final eval of the same params and exports them again
    npz = models / "actor_FlockingRelative-v0_clitest.npz"
    first = npz.read_bytes()
    again = run_cli(text, tmp_path, "--metrics", "m.jsonl", "--state-dir",
                    "state", "--sections", "run1")
    assert again.returncode == 0, again.stderr[-2000:]
    row = _rows(again.stdout)[1]
    assert row[0] == "run1" and all(map(np.isfinite, map(float, row[1:])))
    events = [json.loads(l)["event"]
              for l in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert events == ["eval", "final_eval", "timing", "resume", "final_eval",
                      "timing"]
    assert npz.read_bytes() == first
    assert np.isfinite([mean, std]).all()


def test_baseline_and_cloning_sections(tmp_path):
    text = (TINY.replace("alg = dagger", "alg = cloning")
            + "\n[clone]\n\n[expert]\nalg = baseline\ncentralized = False\n")
    out = run_cli(text, tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = _rows(out.stdout)
    assert rows[0] == ["reward"] and [r[0] for r in rows[1:]] == [
        "clone", "expert"]
    for r in rows[1:]:
        float(r[1]), float(r[2])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["exp.cfg"]


def test_default_only_file_prints_the_stats(tmp_path):
    out = run_cli(TINY.replace("alg = dagger", "alg = baseline"), tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("{'mean': ")


@pytest.mark.parametrize("change,store", [
    ("n_agents = 2048\nstore_agents = 64", 64),
    ("trainer = large\nalg = cloning", 10),
], ids=["large-n", "trainer-large"])
def test_large_sections_train_through_the_large_learner(tmp_path, change,
                                                        store):
    """DAGGER above 1024 agents (``trainer = auto``) and cloning under
    ``trainer = large`` train one round through the large-N learner
    (cell-sweep collection, records of ``store_agents`` agents; 0 means
    ``min(N, 4096)``) and print the CSV; the state file holds the
    subsampled buffer."""
    text = (TINY + f"\n[run1]\n{change}\nn_train_episodes = 1\n"
            "n_test_episodes = 1\nepisode_steps = 10\nfname = big\n")
    out = run_cli(text, tmp_path, "--metrics", "m.jsonl", "--state-dir",
                  "state")
    assert out.returncode == 0, out.stderr[-2000:]
    rows = _rows(out.stdout)
    assert rows[0] == ["reward"] and len(rows) == 2 and rows[1][0] == "run1"
    assert np.isfinite([float(rows[1][1]), float(rows[1][2])]).all()
    events = [json.loads(l)["event"]
              for l in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert events == ["eval", "final_eval", "timing"]
    models = tmp_path / "runs" / "torch" / "models"
    assert (models / "actor_FlockingRelative-v0_big.npz").is_file()
    with np.load(tmp_path / "state" / "run1_state.npz") as z:
        shapes = {z[k].shape for k in z.files}
    assert (200, 2, store, 6) in shapes and (200, store, 2) in shapes


@pytest.mark.parametrize("change,store", [
    ("n_agents = 10\nepisode_steps = 20", 10),
    ("n_agents = 1040\nepisode_steps = 6\nbatch_size = 4", 1040),
], ids=["dense", "large"])
def test_ddpg_sections_train(tmp_path, change, store):
    """A DDPG section trains through the dense learner at N = 10 and, above
    1024 agents, through the positions-record one: the CSV, the events,
    the actor (``.npz`` and torch format) and critic exports, the state
    file; a second call resumes the finished state and exports the same
    networks."""
    text = (TINY.replace("alg = dagger", "alg = ddpg")
            .replace("updates_per_step = 10", "updates_per_step = 1")
            + f"\n[run1]\n{change}\nn_train_episodes = 2\n"
            "n_test_episodes = 1\nfname = ddpgtest\n")
    args = ("--metrics", "m.jsonl", "--state-dir", "state")
    out = run_cli(text, tmp_path, *args)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = _rows(out.stdout)
    assert rows[0] == ["reward"] and len(rows) == 2 and rows[1][0] == "run1"
    assert np.isfinite([float(rows[1][1]), float(rows[1][2])]).all()
    events = [json.loads(l)["event"]
              for l in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert events == ["eval", "final_eval", "timing"]
    models = tmp_path / "runs" / "torch" / "models"
    base = "actor_FlockingRelative-v0_ddpgtest"
    assert sorted(p.name for p in models.iterdir()) == [
        base, base + ".npz", base + "_critic.npz"]
    with np.load(tmp_path / "state" / "run1_state.npz") as z:
        shapes = {z[k].shape for k in z.files}
    assert (200, 2, store, 6) in shapes
    assert ((200, 2, store, store) in shapes) == (store == 10)
    first = {n: (models / n).read_bytes()
             for n in (base + ".npz", base + "_critic.npz")}
    again = run_cli(text, tmp_path, *args)
    assert again.returncode == 0, again.stderr[-2000:]
    events = [json.loads(l)["event"]
              for l in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert events[3:] == ["resume", "final_eval", "timing"]
    assert {n: (models / n).read_bytes() for n in first} == first


@pytest.mark.parametrize("change,device,message", [
    ("alg = nonsense", "cpu", "Invalid algorithm/mode name: 'nonsense'"),
    ("alg = dagger", "cuda", "no CUDA device"),
], ids=["invalid-alg", "no-card"])
def test_sections_it_cannot_run_exit_non_zero(tmp_path, change, device,
                                              message):
    """Each exits non-zero with a message naming what is missing, prints no
    result and writes nothing. ``--device cuda`` is the default; without a
    card it refuses to run rather than fall back to the CPU."""
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")
    text = TINY + f"\n[run1]\n{change}\nfname = clitest\n"
    out = run_cli(text, tmp_path, device=device)
    assert out.returncode != 0
    assert message in out.stderr, out.stderr[-2000:]
    assert "run1," not in out.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ["exp.cfg"]
