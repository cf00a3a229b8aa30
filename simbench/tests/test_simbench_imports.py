"""Nothing the harness runs loads JAX or the JAX package, and the
reference imports nothing of the program.  Module names are compared by
their top-level name, whole: ``ems_nbldpc_torch`` begins with
``ems_nbldpc`` but is not ``ems_nbldpc_tpu``."""
import ast
import os
import subprocess
import sys

import pytest

from simbench import cellrun, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "ems_nbldpc_tpu"}


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(spec.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax_import(path):
    tops = {name.split(".")[0] for name in imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in imports(path)}
    assert tops <= {"__future__", "numpy", "torch", "dataclasses",
                    "collections", "functools", "simbench"}, tops


def test_forbidden_compares_top_level_names_whole(monkeypatch):
    for name in ("ems_nbldpc_torch.sim", "jaxtyping", "flaxen",
                 "ems_nbldpc_tpux"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = cellrun.forbidden_modules()
    assert not {"ems_nbldpc_torch", "jaxtyping", "flaxen",
                "ems_nbldpc_tpux"} & set(found)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in cellrun.forbidden_modules()


def test_a_run_loads_no_jax_and_the_reference_no_program():
    code = (
        "import sys, time\n"
        "import simbench.check, simbench.reference.spa, "
        "simbench.reference.list_ems\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('ems_nbldpc_torch', 'jax', 'ems_nbldpc_tpu')]\n"
        "from simbench import cellrun\n"
        "from simbench.tests.test_simbench_faults import tiny_cell, SPA\n"
        "cellrun.run_rank(tiny_cell(SPA, 'spa'), 3, 0.3, False, 'cpu', "
        "time.perf_counter())\n"
        "assert 'ems_nbldpc_torch' in sys.modules\n"
        "print(cellrun.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=spec.ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
