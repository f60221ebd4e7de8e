"""Nothing the benchmark runs imports JAX or the JAX package (by whole
top-level name: the port's name begins with the JAX package's), and the
plain reference imports nothing of the program."""

import ast
import os
import sys

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "strotss_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(tiny.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    path = os.path.join(tiny.BENCH, "reference", "strotss_ref.py")
    assert set(_imports(path)) <= {"__future__", "math", "typing", "numpy",
                                   "torch"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "strotss_tpu_like", sys)
    assert "strotss_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "strotss_tpu.ops", sys)
    assert "strotss_tpu" in run.forbidden_modules()
