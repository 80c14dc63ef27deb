"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is the program, ``repro`` is not
allowed), and the reference imports nothing of the program."""
import ast

import pytest

from gpubench import bench

FILES = sorted(bench.HERE.rglob("*.py"))


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(bench.HERE)))
def test_no_jax(path):
    assert not set(_imported(path)) & set(bench.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted((bench.HERE / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imported(path))


def test_a_run_loads_no_jax_module():
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from gpubench.workloads import train\n"
            "import repro_torch.runtime.trainer\n"
            "from gpubench import bench\n"
            "print(bench.forbidden_loaded())\n"
            % (str(bench.ROOT), str(bench.SRC)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole():
    assert bench.forbidden_loaded(["repro_torch.models", "jaxtyping",
                                   "reprolib", "numpy"]) == []
    assert bench.forbidden_loaded(["repro.core", "jax.numpy", "flax",
                                   "repro_torch"]) == ["flax", "jax",
                                                       "repro"]
