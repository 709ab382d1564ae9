"""Where the benchmark finds its pieces, by name.

A cell ``<cell>`` is ``workloads/<cell>.json``; it names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``).
A per-layer metric ``<metric>`` is read by ``metrics/<metric>.py``.  The
lists of metrics, their units and the cells each applies to are
``BENCHMARK.json``'s, at the root of the checkout.  Every loader takes the
benchmark's folder as ``root``, so a test can point it at a folder of its
own.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)


def _load(root: str, kind: str, name: str) -> dict:
    path = os.path.join(root, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        doc = json.load(f)
    if doc.get("name") != name:
        raise ValueError(f"{path} names itself {doc.get('name')!r}, not {name!r}")
    return doc


def config(name: str, root: str = BENCH_DIR) -> dict:
    return _load(root, "configs", name)


def policy_name(config: dict) -> str:
    """The policy class a configuration file names in ``policy``; the CSE
    MLP where it names none."""
    return config.get("policy", "ActorCriticCSE")


def traffic(name: str, root: str = BENCH_DIR) -> dict:
    return _load(root, "traffic", name)


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    why: str

    @property
    def num_envs(self) -> int:
        """The envs of the whole cell, over all its ranks."""
        return self.traffic["envs_per_rank"] * self.traffic["ranks"]

    @property
    def ppo(self) -> dict:
        """The PPO arguments the cell runs: the configuration's, with the
        traffic's overrides."""
        return {**self.config["ppo"], **self.traffic.get("ppo", {})}


def cell(name: str, root: str = BENCH_DIR) -> Cell:
    """The cell ``workloads/<name>.json`` with its configuration and traffic."""
    w = _load(root, "workloads", name)
    return Cell(name, config(w["config"], root), traffic(w["traffic"], root), int(w["chips"]),
                dict(w["limits"]), w["why"])


def metric_reader(name: str, root: str = BENCH_DIR):
    """The ``read(ctx)`` of ``metrics/<name>.py``, loaded from its file."""
    path = os.path.join(root, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark_json(checkout: str = CHECKOUT) -> dict:
    with open(os.path.join(checkout, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(doc: dict, cell_name: str, kind: str) -> list:
    """The entries of ``doc[kind]`` (``end_to_end`` or ``per_layer``) that
    cell ``cell_name`` reports: those without a ``workloads`` key and those
    that list it."""
    return [m for m in doc[kind] if cell_name in m.get("workloads", [cell_name])]


class Seeds(NamedTuple):
    """The streams one ``--seed`` is split into, as the port's Runner splits
    its one seed: the terrain, the policy's initial weights, the env's draws
    and the PPO generator (action noise and minibatch permutations)."""
    terrain: int
    init: int
    env: int
    act: int


def seeds(seed: int) -> Seeds:
    if seed < 0:
        raise ValueError(f"--seed {seed}: a whole number >= 0")
    return Seeds(*(int(s) for s in np.random.SeedSequence(seed).generate_state(4)))


def apply_config(cfg, doc: dict, overrides: dict | None = None):
    """Set every value of the configuration file ``doc`` (and of
    ``overrides``, as ``{section: {key: value}}``) on ``cfg``, a
    ``config_go1(Cfg())`` of the port or of the reference's copy."""
    for part in (doc["cfg"], overrides or {}):
        for section, values in part.items():
            target = getattr(cfg, section)
            for key, value in values.items():
                # as the port's builders do, a key the dataclass lacks is
                # set all the same (the env reads it with a default)
                setattr(target, key, value)
    return cfg
