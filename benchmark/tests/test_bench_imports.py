"""Nothing under ``benchmark/`` imports JAX or the JAX package, and nothing
under ``benchmark/reference/`` imports the program, by the top-level name
of each imported module compared whole (the port's name begins with the
JAX package's)."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "legged_tracking_tpu"}


def sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources(BENCH)), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_a_reference_apart_from_the_program(path):
    names = set(top_level_imports(path))
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if os.path.join(BENCH, "reference") in path:
        assert "legged_tracking_torch" not in names, f"{path} imports the program"


def test_the_check_compares_whole_top_level_names():
    from benchmark import run
    import sys

    sys.modules["legged_tracking_tpu_like"] = sys
    try:
        assert "legged_tracking_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["legged_tracking_tpu_like"]
    assert "legged_tracking_torch" not in run.FORBIDDEN
