"""``BENCHMARK.json`` and the files it names: the contract's shapes, and
the harness finding a configuration, a traffic mix, a cell and a per-layer
metric by name, also new ones dropped into a folder of their own."""

import json
import os
import re
import shutil

import pytest

from benchmark import compare, counts, manifest

from .conftest import small

DOC = manifest.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    assert set(DOC) == KEYS
    assert 1 <= len(DOC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                 and not p.startswith("/")
                                                 for p in DOC["paths"])
    assert len(DOC["command"]) <= 32 and all(one_line(w) for w in DOC["command"])
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    names = []
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(DOC["paths"][0] + "/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and one_line(w["why"]) and w["config"] in names
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in DOC[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in DOC["workloads"]}) == len(DOC["workloads"])
    assert sum(w["chips"] == 4 for w in DOC["workloads"]) <= max(1, len(DOC["workloads"]) // 4)
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"] for m in DOC["end_to_end"]}
    for w in DOC["workloads"]:
        mine = {m["name"] for m in manifest.cell_metrics(DOC, w["name"], "end_to_end")}
        layer = manifest.cell_metrics(DOC, w["name"], "per_layer")
        assert "setup_s" in mine and len(mine) >= 2 and layer
        for m in layer:
            assert m["moves"] in mine and m["moves"] in e2e
        for m in DOC["per_layer"]:
            for cell in m.get("workloads", []):
                assert cell in {x["name"] for x in DOC["workloads"]}


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_match_the_manifest():
    for c in DOC["configs"]:
        doc = manifest.config(c["name"])
        assert os.path.relpath(os.path.join(manifest.BENCH_DIR, "configs", c["name"] + ".json"),
                               manifest.CHECKOUT) == c["file"]
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
    for w in DOC["workloads"]:
        cell = manifest.cell(w["name"])
        assert (cell.config["name"], cell.traffic["name"], cell.chips, cell.why) == \
            (w["config"], w["traffic"], w["chips"], w["why"])
        assert cell.chips == cell.traffic["ranks"]
        assert set(cell.limits) == set(compare.NUMBERS)
    for m in DOC["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))


def test_seeds_take_large_numbers_and_repeat():
    big = 2 ** 31 + 2 ** 30 + 7
    assert manifest.seeds(big) == manifest.seeds(big)
    assert manifest.seeds(big) != manifest.seeds(big + 1)
    assert all(0 <= s < 2 ** 32 for s in manifest.seeds(big))


def test_frozen_flop_count_matches_the_bench_widths():
    tunnel = counts.iteration_flop(manifest.config("tunnel_cse"), 4096)
    assert tunnel["total"] / 1e12 == pytest.approx(16.042, abs=5e-4)
    vel = counts.iteration_flop(manifest.config("velocity_wtw"), 4000)
    assert 0 < vel["total"] < tunnel["total"]


def test_new_config_traffic_cell_and_metric_are_found_by_name(tmp_path):
    """Files dropped beside copies of the existing ones, with no edit to any
    of them, give a cell the harness runs and a metric it reports."""
    from benchmark import run

    root = tmp_path / "bench"
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(os.path.join(manifest.BENCH_DIR, kind), root / kind)
    cfg = manifest.config("tunnel_cse")
    cfg = {**cfg, "name": "tunnel_short", "cfg": {**cfg["cfg"],
                                                  "env": {**cfg["cfg"]["env"],
                                                          "episode_length_s": 5.0}}}
    (root / "configs" / "tunnel_short.json").write_text(json.dumps(cfg))
    (root / "traffic" / "train-8.json").write_text(json.dumps(
        {"name": "train-8", "why": "tiny", "envs_per_rank": 8, "ranks": 1,
         "setup_iterations": 1, "ppo": {"num_steps_per_env": 4, "num_learning_epochs": 1}}))
    (root / "workloads" / "tunnel-short-8.json").write_text(json.dumps(
        {"name": "tunnel-short-8", "config": "tunnel_short", "traffic": "train-8", "chips": 1,
         "why": "a new cell", "limits": manifest.cell("tunnel-train-4096").limits}))
    (root / "metrics" / "window_iterations.py").write_text(
        "def read(ctx):\n    return float(ctx['iterations'])\n")
    doc = json.loads(json.dumps(DOC))
    doc["per_layer"].append({"name": "window_iterations", "unit": "iterations",
                             "better": "higher", "source": "host_clock", "layer": "train step",
                             "moves": "env_steps_per_s", "workloads": ["tunnel-short-8"]})
    cell = manifest.cell("tunnel-short-8", str(root))
    assert cell.config["cfg"]["env"]["episode_length_s"] == 5.0 and cell.num_envs == 8
    _, overrides = small(cell)
    result, _ = run.run_cell(cell, 2 ** 31 + 99, 0.1, True, "cpu", overrides=overrides, doc=doc,
                          root=str(root))
    assert result["metrics"]["window_iterations"]["value"] >= 1
    assert result["correct"] and list(result["compared"]) == list(compare.NUMBERS)
    assert "breakdown" in result and result["device"]["platform"] == "cpu"
    # a CPU run reports no device number
    assert result["device"]["memory_peak_bytes"] is None
    assert not {"mfu_f32", "device_idle_share", "launches_per_step"} & set(result["metrics"])
