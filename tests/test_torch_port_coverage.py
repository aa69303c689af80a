"""The port does all the JAX package does, as a check.

Every public name of the JAX package (``multiagent_gnn_policies_tpu/``),
of its root entry files (``train.py``, ``evaluate.py``, ``bench.py``,
``__graft_entry__.py``) and of ``scripts/*.py`` must have a counterpart in
the port (``multiagent_gnn_policies_tpu_torch/``), and every Pallas kernel
that a ``pl.pallas_call`` launches must have a ``__global__`` in the
port's CUDA source. The test reads source text only (``ast`` and a regex);
it imports neither package, so it takes seconds.

A public name is a top-level ``def`` or ``class`` whose name does not
start with ``_``, or a public method of such a class (``Class.method``).
It resolves in one of three ways:

(a) the same name in the port's module at the same relative path: the
    package's ``x/y.py`` -> the port's ``x/y.py``; a root file -> the
    port's file of that name; ``scripts/x.py`` -> the port's
    ``scripts/x.py``;
(b) an entry of ``COUNTERPARTS``, ``"jax_path:name" -> "port_path:name"``
    (a rename or a move), whose target must exist in the port; a name
    that only a route of several port functions covers is a ``Route``,
    which also names the test that holds the route to the JAX function;
(c) an entry of ``NO_COUNTERPART``, ``"jax_path:name"`` (or a whole
    ``"jax_path"``) -> the reason the port needs none.

A public name added to the JAX package must be mapped here: ported with a
parity test, or entered in a table. Run it on the CPU with
``python -m pytest tests/test_torch_port_coverage.py -q``.
"""

import ast
import pathlib
import re
from typing import NamedTuple, Tuple

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "multiagent_gnn_policies_tpu"
PORT = ROOT / "multiagent_gnn_policies_tpu_torch"
ROOT_FILES = ("train.py", "evaluate.py", "bench.py", "__graft_entry__.py")


class Route(NamedTuple):
    """A JAX function the port covers with several functions, and the
    test (``path::name``) that holds them together to the JAX function."""

    targets: Tuple[str, ...]
    test: str


COUNTERPARTS = {
    # the OU noise is a bare tensor that ou_reset makes and ou_step moves
    "algos/ddpg.py:OUState": "algos/ddpg.py:ou_reset",
    # the learner holds the actor, critic, targets and optimisers
    "algos/ddpg.py:TrainState": "algos/ddpg.py:DDPG",
    "algos/replay.py:replay_init": "algos/replay.py:ReplayBuffer",
    "algos/replay.py:replay_insert_batch":
        "algos/replay.py:ReplayBuffer.insert",
    "algos/replay.py:replay_sample": "algos/replay.py:ReplayBuffer.sample",
    "models/actor.py:init_actor": "models/actor.py:init_actor_",
    "models/actor.py:actor_forward": "models/actor.py:Actor.forward",
    "models/critic.py:init_critic": "models/critic.py:init_critic_",
    "models/critic.py:critic_forward": "models/critic.py:Critic.forward",
    "ops/pallas_cells.py:PCellSpec": "ops/cells_cuda.py:PCellSpec",
    "ops/pallas_cells.py:make_pcell_spec": "ops/cells_cuda.py:make_pcell_spec",
    "ops/pallas_cells.py:PCellGrid": "ops/cells_cuda.py:PCellGrid",
    "ops/pallas_cells.py:build_pcell_grid":
        "ops/cells_cuda.py:build_pcell_grid",
    "ops/pallas_cells.py:build_pcell_grid_sharded":
        "ops/cells_cuda.py:build_pcell_grid_sharded",
    "ops/pallas_cells.py:frame": "ops/cells_cuda.py:frame",
    "ops/pallas_cells.py:frame_apply": "ops/cells_cuda.py:frame_apply",
    "ops/pallas_cells.py:apply_adjT": "ops/cells_cuda.py:apply_adjT",
    # the s = 0 apply runs in the step's fused pass (K2), the historical
    # ones in ystack_pre (K3)
    "ops/pallas_cells.py:ystack": Route(
        ("ops/cells_cuda.py:frame_apply", "ops/cells_cuda.py:ystack_pre"),
        "tests/test_torch_cells.py::test_ystack_route_matches_jax_ystack"),
    "ops/pallas_cells.py:ystack_pre": "ops/cells_cuda.py:ystack_pre",
    "parallel/large_n.py:pick_block": "ops/blocked.py:pick_block",
    "utils/checkpoint.py:load": "utils/checkpoint.py:load_tree",
    "utils/debug.py:assert_finite": "utils/debug.py:check_finite",
    "evaluate.py:load_actor_params": "evaluate.py:load_actor_layers",
    "bench.py:bench_tpu_rollout": "bench.py:bench_dense",
    "__graft_entry__.py:dryrun_multichip": "scripts/dryrun_multichip.py:main",
    "scripts/profile_large_n.py:summarize_trace":
        "utils/profiling.py:summarize_trace",
    "scripts/verify_cells_tpu.py:check": "scripts/verify_cells.py:Gate.check",
    "scripts/verify_cells_tpu.py:frame_adjT_checks":
        "scripts/verify_cells.py:frame_apply_checks",
    "scripts/verify_cells_tpu.py:rollout_checks":
        "scripts/verify_cells.py:rollout_checks",
    "scripts/verify_cells_tpu.py:main": "scripts/verify_cells.py:main",
}

NO_COUNTERPART = {
    "utils/jax_setup.py": "JAX's platform switch and compilation cache; "
                          "the port imports no JAX",
    "algos/imitation.py:rollout_batch1": "a TPU compile workaround (a batch "
                                         "of one around the episode)",
    "algos/imitation.py:ImitationLearner.select_action": "a method with no "
                                                         "caller",
    "ops/precision.py:sum_twofloat": "the port takes the N-amplified "
                                     "consensus sum in float64 "
                                     "(centralized_consensus)",
    "ops/pallas_cells.py:PCellSpec.cy_pad": "the lane padding of the TPU "
                                            "slot layout; the port's "
                                            "per-agent layout has no lanes",
    "scripts/roofline_pcells.py": "a TPU VPU roofline; chip_smoke.py's "
                                  "bound column and the benchmark's "
                                  "k*_bound_share do this job on the card",
    "scripts/repro_frame_nan.py": "a repro of a round-2 TPU bug",
    "scripts/repro_rollout_nan.py": "a repro of a round-2 TPU bug",
    "scripts/render_trajectory.py": "imports no JAX and reads the schema "
                                    "that the port's --save-trajectory "
                                    "writes",
    "scripts/twoflocks_decent_expert.py": "the port's evaluate.py --expert "
                                          "on a decentralized section pairs "
                                          "episodes through "
                                          "episode_generator(seed, episode)",
    "__graft_entry__.py:entry": "a TPU compile check",
    "utils/debug.py:nan_debug": "a jax_debug_nans switch with no caller",
}

# Every function that calls pl.pallas_call, and every kernel body the
# calls launch -> its __global__ in the port's CUDA source.
PALLAS_SITES = {"ops/pallas_cells.py:_sweep", "ops/pallas_cells.py:_sweep_deg"}
KERNELS = {
    "ops/pallas_cells.py:_frame_kernel": "csrc/cells.cu:frame_kernel",
    "ops/pallas_cells.py:_apply_deg_kernel": "csrc/cells.cu:apply_deg_kernel",
    "ops/pallas_cells.py:_apply_kernel": "csrc/cells.cu:apply_kernel",
}

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def _jax_files():
    """``{key: path}``: package files keyed by their path in the package,
    root files and scripts by their path in the repository."""
    files = {str(p.relative_to(JAX)): p for p in sorted(JAX.rglob("*.py"))}
    files.update({f: ROOT / f for f in ROOT_FILES})
    files.update({f"scripts/{p.name}": p
                  for p in sorted((ROOT / "scripts").glob("*.py"))})
    return files


JAX_FILES = _jax_files()


def _public_names(path: pathlib.Path):
    names = []
    tree = ast.parse(path.read_text(), str(path))
    for node in tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
                and not node.name.startswith("_")):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and not m.name.startswith("_")]
    return names


def _port_names(rel: str):
    path = PORT / rel
    return set(_public_names(path)) if path.exists() else set()


def _target_exists(target: str) -> bool:
    rel, name = target.split(":")
    return name in _port_names(rel)


def _test_exists(test: str) -> bool:
    rel, name = test.split("::")
    path = ROOT / rel
    return path.exists() and any(
        isinstance(n, ast.FunctionDef) and n.name == name
        for n in ast.parse(path.read_text()).body)


def _unresolved(key: str):
    """The public names of JAX file ``key`` that no rule resolves, and the
    table entries of the file whose target or test is missing."""
    if key in NO_COUNTERPART:
        return [], []
    here = _port_names(key)
    missing, broken = [], []
    for name in _public_names(JAX_FILES[key]):
        entry = f"{key}:{name}"
        if name in here or entry in NO_COUNTERPART:
            continue
        target = COUNTERPARTS.get(entry)
        if target is None:
            missing.append(name)
        elif isinstance(target, Route):
            if not (all(map(_target_exists, target.targets))
                    and _test_exists(target.test)):
                broken.append(entry)
        elif not _target_exists(target):
            broken.append(entry)
    return missing, broken


@pytest.mark.parametrize("key", sorted(JAX_FILES))
def test_every_public_jax_name_has_a_port_counterpart(key):
    missing, broken = _unresolved(key)
    assert not missing, f"{key}: no counterpart in the port for {missing}"
    assert not broken, f"{key}: missing port target or test for {broken}"


def test_tables_name_jax_names_that_need_them():
    """Each entry names a JAX file or public name that exists and that
    rule (a) does not already resolve; no name is in both tables; every
    reason is given."""
    assert not set(COUNTERPARTS) & set(NO_COUNTERPART)
    for entry in [*COUNTERPARTS, *NO_COUNTERPART]:
        key, _, name = entry.partition(":")
        assert key in JAX_FILES, entry
        if name:
            assert name in _public_names(JAX_FILES[key]), entry
            assert name not in _port_names(key), (entry, "resolves by (a)")
    assert all(isinstance(r, str) and r.strip()
               for r in NO_COUNTERPART.values())


def _calls(fn):
    return [c for c in ast.walk(fn) if isinstance(c, ast.Call)]


def _resolve(expr, fn, funcs, key):
    """The module-level functions that kernel expression ``expr`` in
    function ``fn`` can name: followed through ``fn``'s parameters to its
    callers' arguments, local assignments and ``functools.partial``. An
    expression it cannot follow (a parameter with no caller in the module
    among them) comes back as ``?<file>:<expr>``."""
    unknown = {f"?{key}:{ast.unparse(expr)}"}
    if isinstance(expr, ast.Call) and ast.unparse(expr.func) in (
            "functools.partial", "partial"):
        return _resolve(expr.args[0], fn, funcs, key)
    if not isinstance(expr, ast.Name):
        return unknown
    params = [a.arg for a in fn.args.args]
    if expr.id in params:
        pos, out = params.index(expr.id), set()
        for caller in funcs.values():
            for c in _calls(caller):
                if isinstance(c.func, ast.Name) and c.func.id == fn.name:
                    arg = (c.args[pos] if pos < len(c.args) else
                           next(k.value for k in c.keywords
                                if k.arg == expr.id))
                    out |= _resolve(arg, caller, funcs, key)
        return out or unknown
    assigned = [a.value for a in ast.walk(fn) if isinstance(a, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == expr.id
                        for t in a.targets)]
    if assigned:
        return set().union(*(_resolve(v, fn, funcs, key) for v in assigned))
    return {f"{key}:{expr.id}"} if expr.id in funcs else unknown


def _kernel_bodies():
    """``(sites, bodies)``: the functions of the JAX package that call
    ``pallas_call``, and the kernel bodies those calls launch."""
    sites, bodies = set(), set()
    for path in sorted(JAX.rglob("*.py")):
        key = str(path.relative_to(JAX))
        tree = ast.parse(path.read_text(), str(path))
        funcs = {n.name: n for n in tree.body
                 if isinstance(n, ast.FunctionDef)}
        for fn in funcs.values():
            for c in _calls(fn):
                if ast.unparse(c.func).split(".")[-1] != "pallas_call":
                    continue
                sites.add(f"{key}:{fn.name}")
                kernel = c.args[0] if c.args else next(
                    k.value for k in c.keywords if k.arg == "kernel")
                bodies |= _resolve(kernel, fn, funcs, key)
    return sites, bodies


def test_every_pallas_kernel_has_a_cuda_kernel():
    """Every ``pl.pallas_call`` site is a known one, and every kernel body
    it launches maps to a ``__global__`` of the port's CUDA source."""
    sites, bodies = _kernel_bodies()
    assert sites == PALLAS_SITES, f"pallas_call sites: {sorted(sites)}"
    assert bodies == set(KERNELS), f"kernel bodies: {sorted(bodies)}"
    for body, target in KERNELS.items():
        rel, name = target.split(":")
        cuda = PORT / rel
        assert cuda.exists(), target
        assert name in _GLOBAL.findall(cuda.read_text()), (body, target)
