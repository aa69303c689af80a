"""``chip_smoke.py`` keeps its contract, as a check on its source text.

The port's smoke run (``chip_smoke.py`` at the repo root) runs only on a
card, so the CPU suite cannot drive it. This test reads it as text
(``ast``) and imports neither it nor either package:

* its budget and watchdog stay as they are: a run that outgrows them is
  cut in depth, never given more time;
* every phase that ``main()`` runs is described in the module docstring's
  numbered list, so a depth cut is written where its phase is;
* the ``{"kernels": [...]}`` line names its six entries, each beside the
  line of the TPU kernel it replaces in the JAX package's
  ``ops/pallas_cells.py``, and that line is the kernel's ``def``.

Run it on the CPU with ``python -m pytest
tests/test_torch_smoke_contract.py -q`` (well under a second).
"""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMOKE = ROOT / "chip_smoke.py"
TPU_SOURCE = "multiagent_gnn_policies_tpu/ops/pallas_cells.py"
# the kernels line's entries: name -> the line of the TPU kernel replaced
KERNELS = {"K1": 496, "K2 C=6": 613, "K2 C=12": 613, "K2 C=18": 613,
           "K3 C=6": 572, "K3 C=12": 572}
# the kernel whose ``def`` is at each of those lines
TPU_KERNELS = {496: "_frame_kernel", 572: "_apply_kernel",
               613: "_apply_deg_kernel"}


def _module():
    return ast.parse(SMOKE.read_text())


def _main(module):
    return next(node for node in module.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")


def _constant(module, name):
    """The value of the module-level ``name = <constant>``."""
    for node in module.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            return ast.literal_eval(node.value)
    raise AssertionError(f"chip_smoke.py sets no {name}")


@pytest.mark.parametrize("name,value", [("BUDGET_S", 300.0),
                                        ("WATCHDOG_S", 480)])
def test_budget_and_watchdog_stay(name, value):
    got = _constant(_module(), name)
    assert got == value and type(got) is type(value), (name, got)


def _docstring_phases(module):
    """``{number: name}`` of the docstring's numbered list (``12.
    variants: ...``, ``16. mesh, the ...``, ``14. ddpg (no ...``)."""
    doc = ast.get_docstring(module)
    found = re.findall(r"^(\d+)\. ([a-z][a-z ]*?)(?:[:,]| \()", doc, re.M)
    numbers = [int(n) for n, _ in found]
    assert len(numbers) == len(set(numbers)), numbers
    return {int(n): name for n, name in found}


def _main_phases(module):
    """The names ``main()`` passes to ``phase(...)``, in order."""
    return [node.args[0].value for node in ast.walk(_main(module))
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name) and node.func.id == "phase"
            and isinstance(node.args[0], ast.Constant)]


def test_every_phase_main_runs_is_in_the_docstring():
    module = _module()
    described = set(_docstring_phases(module).values())
    ran = _main_phases(module)
    assert len(ran) == len(set(ran)), ran
    assert set(ran) <= described, sorted(set(ran) - described)
    assert described <= set(ran), sorted(described - set(ran))


def test_the_budget_phase_runs_last_of_the_phases():
    ran = _main_phases(_module())
    assert ran[-1] == "budget", ran


def _kernel_entries(module):
    """``(name, key, wrapper, columns, line)`` of the loop that builds the
    kernels line in ``main()``."""
    for node in ast.walk(_main(module)):
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Tuple)
                and [e.id for e in node.target.elts] == [
                    "name", "key", "fn_name", "c", "line"]):
            return ast.literal_eval(node.iter)
    raise AssertionError("no kernels loop in main()")


def test_kernels_line_names_its_six_entries():
    entries = _kernel_entries(_module())
    assert {name: line for name, _, _, _, line in entries} == KERNELS
    assert len(entries) == len(KERNELS)
    for name, _, fn_name, columns, _ in entries:
        kernel = name.split()[0]
        assert fn_name == {"K1": "frame_sweep", "K2": "apply_deg_sweep",
                           "K3": "apply_sweep"}[kernel], name
        assert name == "K1" or name.endswith(f"C={columns}"), name


@pytest.mark.parametrize("line", sorted(TPU_KERNELS))
def test_replaced_lines_are_the_tpu_kernels(line):
    text = (ROOT / TPU_SOURCE).read_text().splitlines()
    assert text[line - 1].startswith(f"def {TPU_KERNELS[line]}("), (
        line, text[line - 1])
    assert f'TPU_SOURCE = "{TPU_SOURCE}"' in SMOKE.read_text()
