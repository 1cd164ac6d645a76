"""No module under texbench/ imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole (``texcomp_torch`` begins with ``texcomp``)."""

import ast
import subprocess
import sys

import pytest

from texbench.manifest import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "texcomp"}


def _imports(path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_takes_nothing_of_the_port(path):
    assert not _imports(path) & (FORBIDDEN | {"texcomp_torch"})
    assert _imports(path) <= {"__future__", "functools", "numpy", "torch",
                              "texbench"}


def test_a_whole_cell_loads_neither():
    """Import what a run imports, drive a cell's inputs and reference, and
    read sys.modules, as the harness does once its window closes."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import texbench.run, texcomp_torch.dist.pipeline, texcomp_torch\n"
        "from texbench import drive, roofline\n"
        "from texbench.manifest import reader, Manifest\n"
        "[reader(m['name']) for m in Manifest().data['per_layer']]\n"
        "with roofline.CallRecorder(): pass\n"
        "print(texbench.run.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
