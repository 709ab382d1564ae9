"""The port stands alone: no file of ``legged_tracking_torch/`` and not
``chip_smoke.py`` imports JAX, flax, optax or the JAX package, and the port
imports and runs with those modules unavailable."""

import ast
import os
import subprocess
import sys

from torch_support import FORBIDDEN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "legged_tracking_torch")):
        paths += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return paths


def imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_sources_import_no_jax():
    sources = port_sources()
    assert len(sources) > 20
    bad = [f"{os.path.relpath(p, ROOT)}: {m}" for p in sources for m in imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, "the port imports JAX or the JAX package:\n" + "\n".join(bad)


def test_port_imports_and_steps_without_jax():
    """Every module of the port imports, and a 2-env step runs on the CPU,
    in a process where importing any JAX module raises."""
    code = f"""
import sys
for m in {FORBIDDEN!r}:
    sys.modules[m] = None
sys.path.insert(0, {ROOT!r})
import importlib, pkgutil
import legged_tracking_torch
for info in pkgutil.walk_packages(legged_tracking_torch.__path__, "legged_tracking_torch."):
    importlib.import_module(info.name)
import chip_smoke
import torch
from legged_tracking_torch.envs import LeggedEnv
env = LeggedEnv(chip_smoke.bench_cfg(4, tiles=2), seed=0, device="cpu")
state = env.reset_fn(True)
state, out = env.step_fn(state, torch.zeros(4, 12))
assert bool(torch.isfinite(out.obs).all())
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
