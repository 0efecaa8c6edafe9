"""The benchmark imports neither JAX nor the JAX package, and its plain
reference nothing of the program; no file reads the JAX benchmark's
folder."""

import ast
import os

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "perfbench")
NEVER = {"jax", "jaxlib", "tpurt"}
JAX_BENCH = "benchmarks"  # the JAX package's benchmark folder
NOT_IN_REFERENCE = NEVER | {"tpurt_torch"}


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _strings(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    rel = os.path.relpath(path, BENCH)
    banned = NOT_IN_REFERENCE if rel.startswith("reference") else NEVER
    found = sorted(set(_imports(path)) & banned)
    assert not found, f"{rel} imports {found}"


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_read_of_the_jax_benchmark_folder(path):
    if os.path.samefile(path, __file__):  # it names the folder it forbids
        return
    assert not _names_jax_bench(path), os.path.relpath(path, ROOT)


def _names_jax_bench(path):
    """Strings of ``path`` that name the folder or a path under it."""
    return [s for s in _strings(path)
            if JAX_BENCH in s.replace("\\", "/").split("/")[:-1]
            or s == JAX_BENCH]


def test_guard_catches_a_planted_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom tpurt.render import x\n"
                   "import tpurt_torch\n")
    assert set(_imports(str(bad))) == {"jax", "tpurt", "tpurt_torch"}
    bad.write_text("import os\nos.path.join(root, 'benchmarks', 'a.json')\n"
                   "open('benchmarks/autotune.json')\n")
    assert len(_names_jax_bench(str(bad))) == 2
