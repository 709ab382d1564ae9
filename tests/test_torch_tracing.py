"""The port's tracer (``legged_tracking_torch/tracing.py``) on the CPU: off
while the profiler is off; under the profiler, one span a layer and a step
in a train iteration of the bench at 4 envs on 2 x 2 tiles (2 steps, one
epoch of two minibatches), each child inside its parent and a span on the
profiler's clock; the physics step eager on the CPU, its span's ``graph``
counter 0; sync warnings counted on the innermost span, other warnings
shown; one record a profiler session."""

import collections
import inspect
import json
import warnings

import pytest
import torch
import torch_support  # noqa: F401
from torch.utils._pytree import tree_leaves

from legged_tracking_torch import bench, tracing
from legged_tracking_torch.learn.ppo import PPOArgs
from legged_tracking_torch.physics.contact import ContactWindow
from legged_tracking_torch.physics.engine import control_step
from legged_tracking_torch.terrain.heightfield import contact_window

STEPS, EPOCHS, MINIBATCHES = 2, 1, 2
# (span, its parent) of a train iteration
PARENTS = {"ppo.act": "ppo.rollout", "env.step": "ppo.rollout", "env.physics": "env.step",
           "env.rewards": "env.step", "env.reset": "env.step", "env.observe": "env.step",
           "env.trajectory": "env.reset", "env.scan": "env.observe",
           "ppo.minibatch": "ppo.update", "ppo.adapt": "ppo.minibatch"}


def profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``, after a span with the
    profiler off (so its spans start a record); returns (its result, the
    profiler)."""
    with tracing.span("off"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module")
def short_train():
    env, alg, ts, state, obs = bench.build(4, device="cpu")
    alg.args = PPOArgs(num_steps_per_env=STEPS, num_learning_epochs=EPOCHS,
                       num_mini_batches=MINIBATCHES)
    return [alg, (ts, state, obs)]


def iterate(train):
    alg, carry = train
    ts, state, obs, _ = alg.train_iteration(*carry)
    train[1] = (ts, state, obs)


def test_off_reads_no_clock_and_records_nothing(short_train, monkeypatch):
    """With the profiler off, a train iteration reads no clock in the
    tracer and leaves its record as it was."""
    reads = []
    monkeypatch.setattr(tracing, "time_ns", lambda: reads.append(1) or 0)
    before = tracing.record()
    n = len(before)
    iterate(short_train)
    assert reads == [] and tracing.record() is before and len(before) == n


def test_profiled_iteration_records_each_layer(short_train):
    """Under the profiler: T act, step, physics, rewards, reset, trajectory
    and observe spans, epochs x minibatches minibatch spans, each span inside its
    parent, and no sync counted off CUDA."""
    profiled(lambda: iterate(short_train))
    spans = tracing.record()
    counts = collections.Counter(s.name for s in spans)
    for name in ("ppo.act", "env.step", "env.physics", "env.rewards", "env.reset",
                 "env.trajectory", "env.observe", "env.scan"):
        assert counts[name] == STEPS, counts
    assert counts["ppo.minibatch"] == counts["ppo.adapt"] == EPOCHS * MINIBATCHES
    assert counts["ppo.rollout"] == counts["ppo.gae"] == counts["ppo.update"] == 1
    for i, s in enumerate(spans):
        assert s.index == i and 0 < s.start_ns <= s.end_ns
        if s.parent < 0:
            assert s.name not in PARENTS
            continue
        parent = spans[s.parent]
        assert parent.name == PARENTS[s.name] and s.parent < i
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert sum(s.syncs for s in spans) == 0


def test_physics_step_is_eager_on_the_cpu(short_train):
    """On the CPU the env's physics step (``physics/graph.py``) runs the
    eager block: its outputs equal ``contact_window`` and ``control_step``
    run as written, bitwise; nothing is captured; and its ``env.physics``
    span carries ``graph`` 0 and no ``captures``."""
    alg, (_, state, _) = short_train
    env, cfg = alg.env, alg.env.cfg
    actions = torch.linspace(-0.4, 0.4, env.num_envs * 12).reshape(env.num_envs, 12)
    got, _ = profiled(lambda: env._physics(state, actions))
    (span,) = [s for s in tracing.record() if s.name == "env.physics"]
    assert span.counters == {"graph": 0} and env.physics_step.captures == 0

    phys, params, carry = env._physics_inputs(state, actions)
    xs, ys, PX, PY = contact_window(env.terrain, state.phys.base_pos[:, :2], cfg.sim.patch_x,
                                    cfg.sim.patch_y)
    window = ContactWindow(env.tile_table, env.terrain.env_tile, xs, ys, PX, PY)
    want = control_step(env.model, env.terrain, window, env.terrain.env_terrain_origin,
                        phys, env._torque_fn, carry, params, cfg.sim.dt,
                        cfg.control.decimation, cfg.sim.contact_stiffness,
                        cfg.sim.contact_damping, cfg.sim.joint_limit_stiffness,
                        cfg.sim.joint_limit_damping)
    flat = tree_leaves
    assert len(flat(got)) == len(flat(want)) == 4 + 6 + 5 + 4
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))


def test_span_lies_on_the_profilers_clock(tmp_path):
    """A span around a matrix product encloses the product's profiler event
    within 50 us, in the profiler's events and in its Chrome trace once the
    span is added to it."""
    a = torch.randn(256, 256)
    a @ a

    def product():
        with tracing.span("probe"):
            a @ a
    _, prof = profiled(product)
    (s,) = tracing.record()
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    slack = 50_000
    assert s.start_ns - slack <= mm.start_ns()
    assert mm.start_ns() + mm.duration_ns() <= s.end_ns + slack
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert tracing.add_to_chrome_trace(str(path)) == 1
    events = json.loads(path.read_text())["traceEvents"]
    (ev,) = [e for e in events if e.get("cat") == "program_span"]
    (op,) = [e for e in events if e.get("name") == "aten::mm"]
    assert ev["name"] == "probe" and ev["args"]["syncs"] == 0
    assert ev["ts"] - slack / 1e3 <= op["ts"]
    assert op["ts"] + op["dur"] <= ev["ts"] + ev["dur"] + slack / 1e3


def test_sync_warning_counts_on_the_innermost_span(monkeypatch):
    """A sync warning raised inside a nested span counts on the innermost
    one, with its file and line, and does not show; another warning shows,
    the one that setting the sync debug mode gives too; the mode, the
    warning filters and the display are restored after."""
    filters, shown = list(warnings.filters), warnings.showwarning
    modes = []

    def set_mode(mode):
        modes.append(mode)
        warnings.warn("the sync debug mode is a prototype")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)

    def nested():
        with tracing.span("outer"):
            with tracing.span("inner"):
                line = inspect.currentframe().f_lineno + 1
                warnings.warn(f"{tracing.SYNC_WARNING} (a fake one)")
                warnings.warn("another warning")
        return line

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        line, _ = profiled(nested)
    outer, inner = tracing.record()
    assert (inner.name, inner.syncs, inner.parent) == ("inner", 1, outer.index)
    assert inner.sites == {f"{__file__}:{line}": 1} and outer.syncs == 0
    assert [str(w.message) for w in caught] == ["the sync debug mode is a prototype",
                                                "another warning",
                                                "the sync debug mode is a prototype"]
    assert modes == ["warn", 0]
    assert warnings.filters == filters and warnings.showwarning is shown


def test_each_profiler_session_starts_a_record():
    """The first span under the profiler after spans without it starts a
    new record; a record handed out stays as it was."""
    def spans(*names):
        for name in names:
            with tracing.span(name) as s:
                s.add("bytes", 8)

    profiled(lambda: spans("a", "a"))
    first = tracing.record()
    spans("off")
    assert tracing.record() is first
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        spans("b")
    second = tracing.record()
    assert [s.name for s in first] == ["a", "a"] and [s.name for s in second] == ["b"]
    assert second[0].counters == {"bytes": 8} and second[0].parent == -1


def test_cnn_policy_spans_its_encoder_and_gru(monkeypatch):
    """``ActorCriticCNN.process_obs_history`` (conv encoder and GRU) at B =
    4 rows of H = 3 frames: under the profiler, one ``policy.encoder`` span
    (``frames`` 12) and then one ``policy.gru`` span (``steps`` 3, ``rows``
    4); with the profiler off, no clock read and nothing recorded."""
    from legged_tracking_torch.learn.actor_critic_cnn import ACCnnArgs, ActorCriticCNN

    torch.manual_seed(0)
    ac = ActorCriticCNN(261, 8, 3 * 261, 12, ACCnnArgs(use_cnn=True, use_gru=True,
                                                        height_map_shape=(2, 10, 11)))
    history = torch.randn(4, 3 * 261)
    with torch.no_grad():
        want = ac.process_obs_history(history)
        got, _ = profiled(lambda: ac.process_obs_history(history))
        encoder, gru = tracing.record()
        assert torch.equal(got, want)
        assert (encoder.name, encoder.counters, encoder.parent) == ("policy.encoder",
                                                                    {"frames": 12}, -1)
        assert (gru.name, gru.counters, gru.parent) == ("policy.gru", {"steps": 3, "rows": 4}, -1)
        assert encoder.end_ns <= gru.start_ns
        reads = []
        monkeypatch.setattr(tracing, "time_ns", lambda: reads.append(1) or 0)
        before = tracing.record()
        ac.process_obs_history(history)
    assert reads == [] and tracing.record() is before and len(before) == 2


def ancestors(spans, s):
    """The names of the spans that ``s`` opened inside."""
    names = set()
    while s.parent >= 0:
        s = spans[s.parent]
        names.add(s.name)
    return names


@pytest.mark.parametrize("policy", ["cse", "conv_gru"])
def test_heads_share_one_history_pass(short_train, policy):
    """A train iteration under the profiler with the bench's CSE policy,
    whose heads share no pass, and with a tiny ``ActorCriticCNN`` (conv
    encoder and GRU) on the same env: the CSE policy records no
    ``policy.heads`` and no ``policy.encoder``.  The conv + GRU policy
    records one ``policy.heads`` (``heads`` 2) around one ``policy.encoder``
    each rollout step and each minibatch, one more ``policy.encoder`` in
    each ``ppo.adapt`` and one for the last values; so 2 x (1 + 1) W1
    spans a minibatch (``policy.conv_wgrad``: both convs, in the loss's
    and the adaptation substep's backward)."""
    from legged_tracking_torch.learn.actor_critic_cnn import ACCnnArgs, ActorCriticCNN
    from legged_tracking_torch.learn.ppo import PPO

    alg, (ts, state, obs) = short_train
    if policy == "conv_gru":
        env = alg.env
        torch.manual_seed(0)
        ac = ActorCriticCNN(env.num_obs, env.num_privileged_obs, env.num_obs_history,
                            env.num_actions,
                            ACCnnArgs(actor_hidden_dims=(32,), critic_hidden_dims=(32,),
                                      adaptation_module_branch_hidden_dims=(32,),
                                      use_cnn=True, use_gru=True, height_map_shape=(2, 10, 11),
                                      cnn_num_embedding=16, gru_num_embedding=16))
        alg = PPO(env, args=alg.args, ac=ac, seed=0)
        ts = alg.init()
    profiled(lambda: alg.train_iteration(ts, state, obs))
    spans = tracing.record()
    where = collections.Counter(
        (s.name, "ppo.adapt" if "ppo.adapt" in up else "ppo.minibatch" if "ppo.minibatch" in up
         else "ppo.act" if "ppo.act" in up else "other")
        for s in spans for up in [ancestors(spans, s)])
    minibatches = EPOCHS * MINIBATCHES
    if policy == "cse":
        assert not any(name.startswith("policy.") for name, _ in where), where
        return
    heads = [s for s in spans if s.name == "policy.heads"]
    assert all(s.counters == {"heads": 2} for s in heads)
    assert all(spans[s.parent].name == "policy.heads" for s in spans
               if s.name == "policy.encoder" and "policy.heads" in ancestors(spans, s))
    assert where == {
        ("policy.heads", "ppo.act"): STEPS, ("policy.encoder", "ppo.act"): STEPS,
        ("policy.gru", "ppo.act"): STEPS,
        ("policy.heads", "ppo.minibatch"): minibatches,
        ("policy.encoder", "ppo.minibatch"): minibatches,
        ("policy.gru", "ppo.minibatch"): minibatches,
        ("policy.encoder", "ppo.adapt"): minibatches, ("policy.gru", "ppo.adapt"): minibatches,
        ("policy.conv_wgrad", "ppo.minibatch"): 2 * minibatches,
        ("policy.conv_wgrad", "ppo.adapt"): 2 * minibatches,
        ("policy.encoder", "other"): 1, ("policy.gru", "other"): 1,
        **{k: n for k, n in where.items() if not k[0].startswith("policy.")}}, where


def test_goal_env_records_one_trajectory_draw_a_step():
    """The goal recipe's env (``valid_goal``) at 4 envs on 2 x 2 tiles,
    stepped twice under the profiler: one ``env.trajectory`` span a step,
    inside that step's ``env.reset``, with ``envs`` 4 and ``waypoints`` 1;
    stepped with the profiler off, nothing recorded."""
    from legged_tracking_torch import train
    from legged_tracking_torch.envs import LeggedEnv

    cfg = train.build_cfg(train.parse_args(torch_support.GOAL_FLAGS + ["--num_envs", "4"]))
    env = LeggedEnv(cfg, device="cpu")
    state = env.reset_fn(True)
    actions = torch.zeros(env.num_envs, env.num_actions)

    def steps(state):
        for _ in range(STEPS):
            state, _ = env.step_fn(state, actions)
        return state

    state, _ = profiled(lambda: steps(state))
    spans = tracing.record()
    draws = [s for s in spans if s.name == "env.trajectory"]
    assert len(draws) == STEPS == sum(s.name == "env.step" for s in spans)
    for s in draws:
        assert spans[s.parent].name == "env.reset"
        assert s.counters == {"envs": 4, "waypoints": 1}
    before = tracing.record()
    n = len(before)
    steps(state)
    assert tracing.record() is before and len(before) == n
