"""The goal recipe's cell ``goal-train-4096``: its files load, and its
configuration is what the port's train entry builds from stage A of
``tools/goal_recipe.sh`` (but the keys it lists under ``reduced`` and
``assumed``); at 8 envs on 2 x 2 tiles on the CPU it is ``correct`` and a
planted fault in the reward fails it; the readers of the trajectory
draw's two metrics on hand-built records; a traced run on the CPU reads
the draw's span.  On the card, at the cell's own size, the program within
its limits and the TF32 control outside them:

    python -m pytest benchmark/tests/test_bench_goal_cell.py -m cuda -q
"""

import dataclasses
import sys

import pytest

from benchmark import compare, control, manifest, run, spans
from benchmark.reference import train as reference

from .conftest import small
from .test_bench_spans import span, tracer  # noqa: F401,F811 (tracer is a fixture)

CELL = "goal-train-4096"
# stage A of tools/goal_recipe.sh, as the port's train entry parses it
STAGE_A = ["--strategy", "goal", "--terrain", "random_pyramid", "--num_envs", "4096",
           "--max_noise_std", "1.0", "--cl_goal_target_dist", "3.8", "--cl_downstep", "0.5"]


def plain(x):
    """A configuration value as the JSON file holds it."""
    if dataclasses.is_dataclass(x):
        return {k: plain(v) for k, v in vars(x).items() if not k.startswith("_")}
    if hasattr(x, "tolist"):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def test_the_configuration_is_the_train_entrys_stage_a(monkeypatch):
    """``cfg`` on ``config_go1(Cfg())`` gives the train entry's
    configuration, section by section; ``ppo`` is the ``PPOArgs`` its
    Runner gets, ``ac`` the ``ACCnnArgs`` of its default policy (the MLP
    height encoder, no GRU), and ``widths`` the env's; only the keys under
    ``reduced`` and ``assumed`` may differ, and they do not."""
    from legged_tracking_torch import train
    from legged_tracking_torch.config import Cfg, config_go1
    from legged_tracking_torch.envs import LeggedEnv
    from legged_tracking_torch.learn import runner

    cell = manifest.cell(CELL)
    doc = cell.config
    assert cell.traffic == manifest.cell("tunnel-train-4096").traffic and cell.chips == 1
    assert set(cell.limits) == set(compare.NUMBERS)
    assert doc["reduced"] == ["cl_goal_target_dist"]
    assert set(doc["assumed"]) == {"num_envs", "num_rows", "num_cols"}
    args = train.parse_args(STAGE_A)
    want = train.build_cfg(args)
    got = manifest.apply_config(config_go1(Cfg()), doc)
    loose = set(doc["reduced"]) | set(doc["assumed"])
    for f in dataclasses.fields(want):
        if dataclasses.is_dataclass(getattr(want, f.name)):
            w, g = plain(getattr(want, f.name)), plain(getattr(got, f.name))
            assert {k: v for k, v in g.items() if k not in loose} == \
                {k: v for k, v in w.items() if k not in loose}, f.name
    assert want.curriculum_thresholds.cl_goal_target_dist == \
        doc["cfg"]["curriculum_thresholds"]["cl_goal_target_dist"] == 3.8
    assert (want.env.num_envs, want.terrain.num_rows, want.terrain.num_cols) == \
        tuple(doc["assumed"][k] for k in ("num_envs", "num_rows", "num_cols"))

    want.env.num_envs, want.terrain.num_rows, want.terrain.num_cols = 8, 2, 2
    env = LeggedEnv(want, device="cpu")
    widths = {"num_obs": env.num_obs, "num_privileged_obs": env.num_privileged_obs,
              "history_frames": env.num_obs_history // env.num_obs,
              "num_actions": env.num_actions}
    assert doc["widths"] == widths and widths["history_frames"] == 1
    assert doc["policy"] == "ActorCriticCNN"
    assert doc["ac"] == plain(train.make_policy(args, want, env).args)
    assert not doc["ac"]["use_cnn"] and not doc["ac"]["use_gru"]
    built = {}
    monkeypatch.setattr(runner, "Runner", lambda env, **kw: built.update(kw))
    train.make_runner(args, want, env)
    assert doc["ppo"] == plain(built["ppo_args"])


# ``loss`` is a relative gap with no absolute floor: at 8 envs a step's
# loss can cancel to 1e-3, where float32 rounding alone (about 3e-7
# absolute) reads over its limit.  The CPU checks take the first seeds
# whose losses stay at least this far from 0, chosen by that rule and not
# by their verdict, so no one seed's draws decide them.
CLEAR_LOSS = 0.05


@pytest.fixture(scope="module")
def small_cell():
    return small(manifest.cell(CELL))


@pytest.fixture(scope="module")
def clear_seeds(small_cell):
    """The first two seeds from 2**31 + 150 whose first update steps'
    losses are all at least ``CLEAR_LOSS`` from 0, each with the program's
    readings."""
    import torch

    cell, overrides = small_cell
    found = []
    for seed in range(2 ** 31 + 150, 2 ** 31 + 180):
        got = control.readings(cell, seed, "program", torch.device("cpu"), overrides)
        if min(abs(float(x)) for x in got["loss"]) >= CLEAR_LOSS:
            found.append((seed, got))
            if len(found) == 2:
                return found
    pytest.fail(f"fewer than two of 30 seeds keep every loss {CLEAR_LOSS} from 0")


def test_the_cell_is_correct_at_a_small_size_and_a_reward_fault_fails(small_cell, clear_seeds):
    """``control.check`` of the cell's first iteration at 8 envs, whose
    episodes of 0.1 s reset within the rollout (each reset draws a
    ``valid_goal`` goal): within every limit; with env 0's reward raised
    at every step, ``env_off`` is over its limit."""
    import torch

    cell, overrides = small_cell
    (seed, got), cpu = clear_seeds[0], torch.device("cpu")
    g = control.check(cell, seed, got, cpu, overrides)
    correct, rows = compare.verdict(g, cell.limits)
    assert correct, rows
    assert g["step_parts"]["done"] > 0
    bad = control.readings(cell, seed, "reward", cpu, overrides)
    g = control.check(cell, seed, bad, cpu, overrides)
    assert g["env_off"] > cell.limits["env_off"], g


def hand_record(steps=2, draws=True):
    """A rollout of ``steps`` env steps (100 ms, 1 sync), each holding a
    reset (10 ms, 1 sync) with the trajectory draw inside it (4 ms, 2
    syncs; none without ``draws``); then the update."""
    rec = [span("ppo.rollout", 0, 1000)]
    for t in range(steps):
        t0 = 1 + 120 * t
        step = len(rec)
        rec += [span("env.step", t0, t0 + 100, parent=0, syncs=1),
                span("env.reset", t0 + 80, t0 + 90, parent=step, syncs=1)]
        if draws:
            rec.append(span("env.trajectory", t0 + 81, t0 + 85, parent=step + 1, syncs=2))
    rec.append(span("ppo.update", 1000, 1400, syncs=1))
    return rec


@pytest.mark.parametrize("name,want", [("trajectory_ms_per_step", 4.0),
                                       ("trajectory_syncs_per_step", 2.0)])
def test_trajectory_readers_read_the_draws_spans(tracer, monkeypatch, name, want):
    """Each reads the ``env.trajectory`` spans alone, over T; nothing where
    the program records no draw (as before the span), where the record is
    not whole, or where there is no tracer; the sync count only on CUDA."""
    read = manifest.metric_reader(name)
    ctx = {"steps_per_iteration": 2, "device_type": "cuda"}
    tracer.spans = hand_record()
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    tracer.spans = hand_record(draws=False)
    assert read(ctx) is None
    tracer.spans = hand_record(steps=3)
    assert read(ctx) is None
    tracer.spans = hand_record()
    if name == "trajectory_syncs_per_step":
        assert read({**ctx, "device_type": "cpu"}) is None
    monkeypatch.delitem(sys.modules, spans.TRACER)
    assert read(ctx) is None


def test_a_traced_run_reads_the_trajectory_draw_on_the_cpu(small_cell, clear_seeds):
    """A ``--trace 1`` run of the cell at 8 envs on the CPU: ``correct``,
    the draw's milliseconds read from the program's spans and within the
    env step's; of the device metrics none off CUDA."""
    cell, overrides = small_cell
    result, _ = run.run_cell(cell, clear_seeds[1][0], 0.1, True, "cpu", overrides=overrides)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"], result["compared"]
    assert {"trajectory_ms_per_step", "env_step_ms_per_step", "physics_ms_per_step"} <= set(got)
    assert not {"trajectory_syncs_per_step", "b1_roofline", "device_idle_share"} & set(got)
    step = spans.ms_per_step({"steps_per_iteration": cell.ppo["num_steps_per_env"]}, "env.step")
    assert 0 < got["trajectory_ms_per_step"] < step


@pytest.mark.cuda
def test_the_cell_on_the_card_within_its_limits_and_the_control_outside(cuda_device):
    cell = manifest.cell(CELL)
    got = control.readings(cell, 2 ** 31 + 97, "program", cuda_device)
    correct, rows = compare.verdict(control.check(cell, 2 ** 31 + 97, got, cuda_device),
                                    cell.limits)
    assert correct, rows
    del got
    low = reference.drive(cell.config, cell.num_envs, 2 ** 31 + 101, cuda_device,
                          ppo_overrides=cell.traffic["ppo"], tf32=True)
    correct, rows = compare.verdict(control.check(cell, 2 ** 31 + 101, low, cuda_device),
                                    cell.limits)
    assert not correct, rows
