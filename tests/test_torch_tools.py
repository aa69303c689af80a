"""The port's measurement tools on the CPU: ``utils/profiling.py`` (as the
JAX package's ``tests/test_profiling.py`` checks its own), and each
tool's ``main`` at a tiny size with ``--device cpu``: its output, its
files in the JAX scripts' schema, its refusal to run without a card, and
that the cell-sweep gate can fail (``rollout_large``'s blocked path and
chains are in ``tests/test_torch_large_paths.py``).
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from multiagent_gnn_policies_tpu.parallel import large_n as jln
from multiagent_gnn_policies_tpu_torch import bench as tbench
from multiagent_gnn_policies_tpu_torch.envs import flocking as tfl
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc
from multiagent_gnn_policies_tpu_torch.scripts import (
    bench_large_n,
    profile_large_n,
    run_1m,
    smoke_env,
    verify_cells,
)
from multiagent_gnn_policies_tpu_torch.utils.profiling import (
    Throughput,
    assert_finite,
    summarize_trace,
    trace,
    trace_events,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the suite runs several test
    processes side by side, and many small parallel operations on an
    oversubscribed CPU are far slower than on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load_script(name):
    """A JAX-side script of ``scripts/`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_throughput_rates():
    tp = Throughput()
    tp.add(100, edges=5000.0)
    r = tp.rates()
    assert r["steps_per_s"] > 0 and r["elapsed_s"] > 0
    assert r["edges_per_s"] == pytest.approx(r["steps_per_s"] * 50.0)
    tp.reset()
    tp.add(3)
    assert tp.steps == 3 and "edges_per_s" not in tp.rates()


def test_trace_noop_and_dir(tmp_path):
    with trace(None) as prof:
        assert prof is None
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").exists()
    assert len(prof.events()) > 0


def test_trace_events_read_the_layer_ranges():
    """``trace_events`` reads a host trace's ``"layer: "`` ranges as
    ``prof.events()`` has them (same count and durations within 1 us) and
    nothing else of the host; with no device event ``summarize_trace``
    reports device time not measured from either reading."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("layer: block"):
                torch.ones(4096).cumsum(0)
    got = trace_events(prof)
    want = [e for e in prof.events() if e.name.startswith("layer: ")]
    assert [e.name for e in got] == ["layer: block"] * 3 and len(want) == 3
    for g, w in zip(sorted(got, key=lambda e: e.time_range.start),
                    sorted(want, key=lambda e: e.time_range.start)):
        assert abs(g.time_range.elapsed_us()
                   - w.time_range.elapsed_us()) <= 1.0
        assert g.is_user_annotation
    assert summarize_trace(got, 3, 1.0, 1.0) is None
    assert summarize_trace(prof.events(), 3, 1.0, 1.0) is None


def test_assert_finite():
    assert_finite({"a": torch.ones(3), "b": {"c": torch.zeros(2)}})
    assert_finite([torch.ones(2), (torch.zeros(1),)])
    with pytest.raises(FloatingPointError, match="b.*c.*here"):
        assert_finite({"a": torch.ones(3),
                       "b": {"c": torch.tensor([float("nan")])}}, "here")
    with pytest.raises(FloatingPointError, match=r"\[1\]"):
        assert_finite([torch.ones(1), torch.tensor([float("inf")])])


def test_bench_prints_one_json_line(capsys):
    """stdout holds exactly one JSON line with the JAX bench's keys."""
    rc = tbench.main(["--device", "cpu", "--n-envs", "3", "--steps", "3",
                      "--reps", "1", "--chains", "1", "--no-large-n"])
    out = capsys.readouterr()
    assert rc == 0
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "rollout_steps_per_s"
    assert line["unit"] == "env steps/s" and line["value"] > 0
    assert "sustained" in out.err and "baseline" in out.err


def test_smoke_env_save_has_the_jax_schema(tmp_path, capsys):
    """Every env runs an ok expert episode; the ``--save`` file has the
    keys, shapes and dtypes of the JAX script's file on the same arguments,
    and ``scripts/render_trajectory.py`` plots it."""
    args = ["--episodes", "1", "--n-agents", "20"]
    assert smoke_env.main(args + ["--device", "cpu", "--save",
                                  str(tmp_path / "t.npz")]) == 0
    out = capsys.readouterr().out
    assert out.count(" ok\n") == len(tfl.ENV_REGISTRY)
    assert "SUSPECT" not in out
    jsmoke = _load_script("smoke_env")
    assert jsmoke.main(args + ["--env", "FlockingTwoFlocks-v0", "--save",
                               str(tmp_path / "j.npz")]) == 0
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files) == ["reward", "x"]
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        assert t["x"].shape == (200, 20, 4)
    render = _load_script("render_trajectory")
    assert render.main([str(tmp_path / "t.npz"),
                        str(tmp_path / "t.png")]) == 0
    assert (tmp_path / "t.png").stat().st_size > 0


def test_run_1m_small_writes_the_jax_schema(tmp_path, capsys):
    """At N = 2,048 (more than the 2,000 recorded agents), 3 steps: exit 0,
    both episodes printed, and the trajectory file of the JAX script: x (T,
    M, 4) and reward (T,) float32, final_x (N, 4), subset_indices (M,)
    int32 equal to the JAX package's ``traj_subset_indices``."""
    path = tmp_path / "traj.npz"
    assert run_1m.main(["--device", "cpu", "--n", "2048", "--steps", "3",
                        "--traj", str(path)]) == 0
    out = capsys.readouterr().out
    assert "first episode" in out and "steady:" in out and "rc=0" in out
    with np.load(path) as z:
        assert sorted(z.files) == ["final_x", "reward", "subset_indices",
                                   "x"]
        assert z["x"].shape == (3, 2000, 4) and z["x"].dtype == np.float32
        assert z["reward"].shape == (3,) and z["reward"].dtype == np.float32
        assert z["final_x"].shape == (2048, 4)
        want = np.asarray(jln.traj_subset_indices(2048, 2000))
        assert z["subset_indices"].dtype == want.dtype == np.int32
        np.testing.assert_array_equal(z["subset_indices"], want)
        np.testing.assert_array_equal(z["x"][-1],
                                      z["final_x"][z["subset_indices"]])


def test_bench_large_n_and_profile_print_their_tables(tmp_path, capsys):
    """Both paths at N = 600: a row each with its median and spread over
    the chains and a summary; the profile's episode lines and its trace
    file (the device columns read "not measured" on the CPU)."""
    assert bench_large_n.main(["--device", "cpu", "--n", "600", "--paths",
                               "blocked", "pcells", "--steps", "3",
                               "--repeats", "2", "--episodes", "1"]) == 0
    out = capsys.readouterr().out
    assert "median of 2" in out and "# summary" in out
    assert out.count("not measured") >= 2
    rows = [l for l in out.splitlines() if l.startswith("#        600")]
    assert [r.split()[2] for r in rows] == ["blocked", "pcells"]
    assert profile_large_n.main(["--device", "cpu", "--n", "600",
                                 "--steps", "3", "--out",
                                 str(tmp_path / "prof")]) == 0
    out = capsys.readouterr().out
    assert "warm episode" in out and "traced episode" in out
    assert (tmp_path / "prof" / "trace.json").exists()


def test_bench_large_n_and_profile_take_the_new_paths(tmp_path, capsys):
    """The cells and binned paths at N = 600 through ``bench_large_n`` (a
    row each, overflow 0) and binned through ``profile_large_n --path``;
    cells and binned are skipped above N = 100,000 and blocked above
    32,768 (here an N of 100,001 is never run: the skip line comes
    first)."""
    assert bench_large_n.main(["--device", "cpu", "--n", "600", "--paths",
                               "cells", "binned", "--steps", "3",
                               "--repeats", "2", "--episodes", "1"]) == 0
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if l.startswith("#        600")]
    assert [r.split()[2] for r in rows] == ["cells", "binned"]
    assert out.count("overflow=0 nonfinite_eps=0") == 2
    assert bench_large_n.main(["--device", "cpu", "--n", "100001",
                               "--paths", "cells", "binned", "blocked"]) == 0
    out = capsys.readouterr().out
    assert out.count("skipped (above N = ") == 3
    assert profile_large_n.main(["--device", "cpu", "--n", "600", "--path",
                                 "binned", "--steps", "3", "--out",
                                 str(tmp_path / "prof")]) == 0
    out = capsys.readouterr().out
    assert "traced episode" in out and "(overflow=0)" in out


VERIFY_ARGS = ["--device", "cpu", "--sizes", "600", "--big-n", "1200",
               "--chunk", "500"]


def test_verify_cells_passes_and_can_fail(monkeypatch, capsys):
    """At N = 600 (and the edge-2 cap-32 geometry at 1,200 in chunks of 500
    rows) every check passes; with K1's plain version off by 1e-3 (the CPU
    wrapper's own function) the oracle checks and the rollout parity fail
    and the gate exits 1."""
    assert verify_cells.main(VERIFY_ARGS) == 0
    out = capsys.readouterr().out
    assert "[FAIL]" not in out and "ALL PASSED" in out
    assert out.count("[PASS]") == 18
    plain = tcc.frame_sweep_plain
    monkeypatch.setattr(tcc, "frame_sweep_plain",
                        lambda *a, **k: plain(*a, **k) * (1 + 1e-3))
    assert verify_cells.main(VERIFY_ARGS) == 1
    out = capsys.readouterr().out
    assert "[FAIL] K1 frame vs blocked oracle N=600" in out
    assert "FAILURES" in out


@pytest.mark.parametrize("main", [
    tbench.main, smoke_env.main, bench_large_n.main, profile_large_n.main,
    run_1m.main, verify_cells.main],
    ids=["bench", "smoke_env", "bench_large_n", "profile_large_n", "run_1m",
         "verify_cells"])
def test_entry_points_refuse_without_a_card(main):
    """``--device cuda`` is the default; without a card each entry point
    exits non-zero rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")
    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
