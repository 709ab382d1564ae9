"""The port's deploy stack (``legged_tracking_torch/deploy/``, the two deploy
entries) against the JAX package's on the CPU: the LCM bytes and
fingerprints, ``PolicyRuntime`` against JAX ``act_student`` and the JAX
numpy runtime, the camera decode, the agents' observations, the planner
goal profile; then the port's C++ bridge, built from its own copy, on a
bus of each test's own (``LCM_DEFAULT_URL``; the JAX package's bridge tests
share the default bus and may run beside these): the wire interop, the
end-to-end loop, and both deploy entries' wiring for 20 steps with the
policy on the CPU."""

import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_support  # noqa: F401

import chip_smoke
from legged_tracking_torch import deploy_policy, deploy_traj_policy
from legged_tracking_torch import train_velocity_tracking as t_train_velocity
from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.deploy import go1_bridge
from legged_tracking_torch.deploy import command_profiles as t_profiles
from legged_tracking_torch.deploy import lcm_agent as t_agent
from legged_tracking_torch.deploy import lcm_lite as t_lite
from legged_tracking_torch.deploy import lcm_types as t_types
from legged_tracking_torch.deploy import state_estimator as t_se
from legged_tracking_torch.deploy.policy_runtime import PolicyRuntime
from legged_tracking_torch.envs import LeggedEnv
from legged_tracking_torch.envs.velocity_env import VelocityTrackingEnv
from legged_tracking_torch.io.checkpoint import export_policy_npz as t_export
from legged_tracking_torch.learn.actor_critic import ActorCriticCSE as TAC
from legged_tracking_tpu.config import Cfg as JCfg
from legged_tracking_tpu.config import config_go1 as j_config_go1
from legged_tracking_tpu.deploy import command_profiles as j_profiles
from legged_tracking_tpu.deploy import lcm_agent as j_agent
from legged_tracking_tpu.deploy import lcm_types as j_types
from legged_tracking_tpu.deploy import state_estimator as j_se
from legged_tracking_tpu.deploy.policy_runtime import PolicyRuntime as JRuntime
from legged_tracking_tpu.io.checkpoint import export_policy_npz as j_export
from legged_tracking_tpu.learn.actor_critic import ACArgs
from legged_tracking_tpu.learn.actor_critic import ActorCriticCSE as JAC


class FakeLC:
    """A transport that delivers nothing and keeps what is published."""

    def __init__(self):
        self.sent = []

    def subscribe(self, channel, cb):
        pass

    def publish(self, channel, data):
        self.sent.append((channel, data))


# ------------------------------------------------------------ the wire format
WIRE_TYPES = ["pd_tau_targets_lcmt", "leg_control_data_lcmt", "state_estimator_lcmt",
              "rc_command_lcmt"]


@pytest.mark.parametrize("name", WIRE_TYPES)
def test_lcm_bytes_match_jax(name):
    """Random field values encode to the same bytes, fingerprint included,
    and the port decodes the JAX bytes to the values."""
    rng = np.random.RandomState(WIRE_TYPES.index(name))
    tcls, jcls = getattr(t_types, name), getattr(j_types, name)
    assert tcls.MEMBERS == jcls.MEMBERS
    vals = {}
    for field, typ, dims in jcls.MEMBERS:
        n = int(np.prod(dims)) if dims else 1
        if typ == "double":
            v = rng.randn(n)
        elif typ == "float":
            v = rng.randn(n).astype(np.float32).astype(np.float64)
        else:
            v = rng.randint(-30000, 30000, n)
        vals[field] = v.tolist() if dims else v.tolist()[0]
    data = jcls(**vals).encode()
    assert tcls(**vals).encode() == data
    assert tcls._fingerprint() == jcls._fingerprint()
    out = tcls.decode(data)
    assert {f: getattr(out, f) for f in vals} == vals


@pytest.mark.parametrize("name", ["camera_message_lcmt", "camera_message_rect_wide"])
def test_camera_blob_bytes_match_jax(name):
    tcls, jcls = getattr(t_types, name), getattr(j_types, name)
    raw = np.random.RandomState(0).randint(0, 256, tcls.SIZE).astype(np.uint8).tobytes()
    assert tcls(data=raw).encode() == jcls(data=raw).encode()
    assert tcls._fingerprint() == jcls._fingerprint()


def test_lcm_default_url(monkeypatch):
    """``LCM_DEFAULT_URL`` sets the bus, options ignored; unset, the
    reference's; another scheme raises."""
    monkeypatch.delenv("LCM_DEFAULT_URL", raising=False)
    assert t_lite.default_url() == ("239.255.76.67", 7667)
    monkeypatch.setenv("LCM_DEFAULT_URL", "udpm://239.255.76.68:7750?ttl=0")
    assert t_lite.default_url() == ("239.255.76.68", 7750)
    monkeypatch.setenv("LCM_DEFAULT_URL", "tcpq://localhost:7700")
    with pytest.raises(ValueError, match="udpm"):
        t_lite.default_url()


# --------------------------------------------------------------- the runtime
def nested(flat):
    """'params/a/b/kernel' keys -> the flax tree."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


# float32 products summed in other orders (numpy, XLA, torch's CPU GEMM)
# over a 2,100-input history: at most 1.1e-6 apart here, of actions up to
# 1.8; the bar is 1e-5
RUNTIME_ATOL = 1e-5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_policy_runtime_matches_jax(tmp_path, writer):
    """The velocity policy's shapes (a 70-dim obs x 30 history): the port's
    runtime on the CPU against JAX ``act_student`` and the JAX numpy
    runtime, on an export written by either package."""
    n_obs, n_hist, n_priv = 70, 2100, 2
    path = str(tmp_path / "policy.npz")
    if writer == "jax":
        ac = JAC(num_obs=n_obs, num_privileged_obs=n_priv, num_obs_history=n_hist,
                 num_actions=12, args=ACArgs())
        j_export(path, jax.jit(ac.init)(jax.random.key(0), jnp.zeros((1, n_obs)),
                                        jnp.zeros((1, n_priv)), jnp.zeros((1, n_hist))))
    else:
        torch.manual_seed(0)
        t_export(path, TAC(n_obs, n_priv, n_hist, 12).state_dict())
    x = np.random.RandomState(1).randn(5, n_hist).astype(np.float32)
    rt = PolicyRuntime(path, device="cpu")
    y = rt(x)
    assert y.shape == (5, 12) and y.dtype == np.float32
    y_np = JRuntime(path)(x)
    params = nested({k: v for k, v in np.load(path).items() if k.startswith("params/")})
    jac = JAC(num_obs=n_obs, num_privileged_obs=n_priv, num_obs_history=n_hist,
              num_actions=12, args=ACArgs())
    y_jax = np.asarray(jax.jit(lambda p, x: jac.apply(p, x, x, method=JAC.act_student))(
        params, jnp.asarray(x)))
    np.testing.assert_allclose(y, y_np, atol=RUNTIME_ATOL, rtol=0)
    np.testing.assert_allclose(y, y_jax, atol=RUNTIME_ATOL, rtol=0)
    # one row at a time, as the control loop calls it
    np.testing.assert_allclose(rt(x[2:3]), y[2:3], atol=RUNTIME_ATOL, rtol=0)


def test_policy_runtime_refuses_cnn_export(tmp_path):
    """An export without the adaptation module (a CNN/GRU run) raises
    KeyError, as the reference's runtime does."""
    path = str(tmp_path / "policy.npz")
    np.savez(path, **{"params/actor_body/Dense_0/kernel": np.zeros((4, 12), np.float32),
                      "params/actor_body/Dense_0/bias": np.zeros(12, np.float32)})
    with pytest.raises(KeyError, match="adaptation_module"):
        PolicyRuntime(path, device="cpu")
    with pytest.raises(KeyError):
        JRuntime(path)


# ---------------------------------------------------- estimator and agents
def test_camera_decode_matches_jax():
    """Synthetic frames through both estimators' decode callbacks: the
    same images, in the reference's layouts."""
    raw = np.arange(3 * 200 * 464, dtype=np.uint8)
    raw2 = np.arange(3 * 100 * 116, dtype=np.uint8)
    images = []
    for se_mod, types in ((t_se, t_types), (j_se, j_types)):
        se = se_mod.StateEstimator(FakeLC(), use_cameras=True)
        se._camera_cb("camera1", types.camera_message_lcmt(data=raw.tobytes()).encode())
        se._rect_camera_cb("rect_image_rear",
                           types.camera_message_rect_wide(data=raw2.tobytes()).encode())
        images.append((se.camera_image_front, se.camera_image_rear))
        with pytest.raises(ValueError):
            types.camera_message_rect_wide.decode(
                types.camera_message_lcmt(data=raw.tobytes()).encode())
    (ft, rt), (fj, rj) = images
    assert ft.shape == (200, 464, 3) and rt.shape == (100, 116, 3)
    np.testing.assert_array_equal(ft, raw.reshape(3, 200, 464).transpose(1, 2, 0))
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(rt, rj)


def agent_cfg(cfg_cls, go1, task):
    """tests/test_deploy.py's velocity configuration (15 commands, gait
    clock) or the tunnel configuration with the height stub."""
    cfg = go1(cfg_cls())
    if task == "velocity":
        cfg.env.observe_heights = False
        cfg.terrain.measure_heights = False
        cfg.env.observe_vel = False
        cfg.env.observe_yaw = False
        cfg.env.observe_two_prev_actions = True
        cfg.env.observe_clock_inputs = True
        cfg.env.command_type = "velocity"
        cfg.commands.num_commands = 15
    else:
        cfg.env.command_type = "xy"
        cfg.terrain.measure_front_half = True
        cfg.env.observe_heights = True
    cfg.parse()
    return cfg


@pytest.mark.parametrize("task,width", [("velocity", 70), ("tunnel", 261)])
def test_agent_obs_and_targets_match_jax(task, width):
    """Both packages' LCMAgent under a fake transport, from the same
    estimator state and sticks: the same observations and gait clock, step
    by step, and the same published PD targets."""
    rng = np.random.RandomState(0)
    q, qd = rng.uniform(-1, 1, 12), rng.uniform(-2, 2, 12)
    actions = rng.uniform(-1, 1, (5, 12))
    runs = []
    for mods in ((TCfg, t_config_go1, t_se, t_profiles, t_agent),
                 (JCfg, j_config_go1, j_se, j_profiles, j_agent)):
        cfg_cls, go1, se_mod, prof_mod, agent_mod = mods
        cfg = agent_cfg(cfg_cls, go1, task)
        lc = FakeLC()
        se = se_mod.StateEstimator(lc)
        se.left_stick, se.right_stick = [0.3, 0.5], [-0.2, 0.4]
        se.joint_pos, se.joint_vel = q.copy(), qd.copy()
        dt = cfg.control.decimation * cfg.sim.dt
        profile = (prof_mod.RCControllerProfile(dt, se, x_scale=2.0, y_scale=0.6)
                   if task == "velocity" else prof_mod.DummyFrontGoalProfile(dt))
        agent = agent_mod.LCMAgent(cfg, se, profile, lc)
        obs, clocks = [agent.get_obs()], [agent.clock_inputs.copy()]
        for a in actions:
            agent.publish_action(a[None])
            agent.timestep += 1
            agent.last_actions, agent.actions = agent.actions, a[None]
            obs.append(agent.get_obs())
            clocks.append(agent.clock_inputs.copy())
        sent = [t_types.pd_tau_targets_lcmt.decode(d) for _, d in lc.sent]
        runs.append((obs, clocks, [(m.q_des, m.kp, m.kd, m.id) for m in sent]))
    (obs_t, clk_t, sent_t), (obs_j, clk_j, sent_j) = runs
    assert obs_t[0].shape == (1, width) and obs_t[0].dtype == np.float32
    for a, b in zip(obs_t, obs_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(clk_t), np.stack(clk_j))
    assert sent_t == sent_j and len(sent_t) == len(actions)
    if task == "velocity":
        assert not np.allclose(clk_t[0], clk_t[1])


def test_planner_goal_profile_matches_jax():
    """tests/test_deploy.py's planner goal profile (a wall with a gap, the
    goal behind it, replanning every 50 steps) driven 400 steps through
    both packages' profiles: the same commands and the same walk."""
    hs, nx, ny = 0.05, 80, 40
    emap = np.zeros((2, nx, ny), dtype=np.float32)
    emap[0] = 1.0
    emap[1, 38:42, 12:] = 1.0
    emap[0, 38:42, 12:] = 1.0

    class SE:
        def __init__(self):
            self.xy, self.yaw = np.array([0.4, 1.0]), 0.0

        def get_xy_yaw(self):
            return self.xy.copy(), self.yaw

    walks = []
    for mod in (t_profiles, j_profiles):
        se = SE()
        prof = mod.PlannerGoalProfile(0.02, se, emap, goal_xy=(3.6, 1.0), horizontal_scale=hs,
                                      replan_steps=50, seed=3)
        cmds = []
        for step in range(400):
            cmd, reset = prof.get_command(step)
            assert not reset
            cmds.append(cmd)
            n = np.linalg.norm(cmd[:2])
            if n > 1e-6:
                se.xy = se.xy + cmd[:2] / n * min(0.05, n)
        walks.append((np.stack(cmds), se.xy))
    (cmd_t, xy_t), (cmd_j, xy_j) = walks
    np.testing.assert_array_equal(cmd_t, cmd_j)
    np.testing.assert_array_equal(xy_t, xy_j)
    assert np.linalg.norm(xy_t - np.array([3.6, 1.0])) < 0.35, xy_t


# -------------------------------------------------------- the C++ bridge
@pytest.fixture(scope="module")
def bridge_exe():
    """The port's bridge, built from ``legged_tracking_torch/deploy/bridge``."""
    exe = go1_bridge.build()
    assert exe.startswith(go1_bridge.BRIDGE_DIR) and os.access(exe, os.X_OK)
    return exe


@pytest.fixture
def bus(request, monkeypatch):
    """A bus of this test's own, for the python side and the bridge it
    starts (the process inherits the variable); skips where the machine
    has no multicast loopback."""
    port = 7740 + BUS_PORTS.index(request.node.originalname)
    url = f"udpm://239.255.76.67:{port}?ttl=0"
    monkeypatch.setenv("LCM_DEFAULT_URL", url)
    try:
        lc = t_lite.LCMLite()
        lc.publish("ping", b"x")
        lc.close()
    except OSError as e:
        pytest.skip(f"no multicast loopback on this machine: {e}")
    return url


BUS_PORTS = ["test_bridge_interop", "test_full_deploy_loop", "test_deploy_entries_wiring"]


def stop(proc):
    proc.terminate()
    proc.wait(timeout=10)


def test_bridge_interop(bridge_exe, bus):
    """The bridge's telemetry decodes on the python side, on the bus
    ``LCM_DEFAULT_URL`` names, and it takes a PD command."""
    lc = t_lite.LCMLite()
    assert lc.port == 7740
    got = {}
    lc.subscribe("leg_control_data", lambda ch, d: got.update(
        {"legs": t_types.leg_control_data_lcmt.decode(d)}))
    lc.subscribe("state_estimator_data", lambda ch, d: got.update(
        {"imu": t_types.state_estimator_lcmt.decode(d)}))
    lc.subscribe("rc_command", lambda ch, d: got.update(
        {"rc": t_types.rc_command_lcmt.decode(d)}))
    proc = go1_bridge.start(500)
    try:
        t0 = time.time()
        while len(got) < 3 and time.time() - t0 < 5.0:
            lc.handle_once(0.2)
        cmd = t_types.pd_tau_targets_lcmt(q_des=[-0.1, 0.8, -1.5] * 4, kp=[20.0] * 12,
                                          kd=[0.5] * 12)
        lc.publish("pd_plustau_targets", cmd.encode())
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            stop(proc)
        lc.close()
    assert sorted(got) == ["imu", "legs", "rc"]
    assert abs(got["legs"].q[1] - 0.8) < 0.5         # the stub starts at the nominal pose
    assert got["imu"].quat[3] == pytest.approx(1.0)
    assert got["rc"].right_lower_right_switch == 0   # the loopback never presses R2


def test_full_deploy_loop(bridge_exe, bus):
    """tests/test_deploy_e2e.py on the port: telemetry, the tunnel obs
    layout on hardware (1, 261), and the stub's joints tracking the PD
    targets the agent publishes."""
    cfg = agent_cfg(TCfg, t_config_go1, "tunnel")
    proc = go1_bridge.start(3000)
    se = t_se.StateEstimator(t_lite.LCMLite())
    se.spin()
    try:
        t0 = time.time()
        while not se.received_first_legdata and time.time() - t0 < 5.0:
            time.sleep(0.05)
        assert se.received_first_legdata, "no leg telemetry from the bridge"
        agent = t_agent.LCMAgent(cfg, se, t_profiles.DummyFrontGoalProfile(
            cfg.control.decimation * cfg.sim.dt), se.lc)
        obs = agent.get_obs()
        assert obs.shape == (1, 261) and np.isfinite(obs).all()
        q0 = se.get_dof_pos().copy()
        action = np.zeros((1, 12))
        action[0, 1] = 0.8                  # FR thigh: +0.2 rad at scale 0.25
        for _ in range(120):
            agent.step(action)
        moved = se.get_dof_pos()[1] - q0[1]
        assert moved > 0.05, f"bridge joints did not track PD targets ({moved:.4f})"
    finally:
        se.close()
        stop(proc)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run directories as the Runner writes them (``parameters.pkl`` of the
    env's cfg, ``policy.npz``), random CSE policies: the velocity task
    (70-dim obs x 30) and the bench (261 x 15)."""
    root = tmp_path_factory.mktemp("runs")
    envs = {"velocity": VelocityTrackingEnv(t_train_velocity.build_cfg(t_train_velocity.parse_args(
                ["--num_envs", "4", "--terrain_rows", "2", "--terrain_cols", "2"])), device="cpu"),
            "bench": LeggedEnv(chip_smoke.bench_cfg(4, tiles=2), device="cpu")}
    out = {}
    for i, (name, env) in enumerate(envs.items()):
        d = str(root / name)
        os.makedirs(d)
        with open(os.path.join(d, "parameters.pkl"), "wb") as f:
            pickle.dump(env.cfg, f)
        torch.manual_seed(i)
        t_export(os.path.join(d, "policy.npz"),
                 TAC(env.num_obs, env.num_privileged_obs, env.num_obs_history, 12).state_dict())
        out[name] = (d, env.num_obs)
    return out


@pytest.mark.parametrize("entry", ["deploy_policy", "deploy_traj_policy"])
def test_deploy_entries_wiring(bridge_exe, bus, runs, entry):
    """Each entry's wiring (``build_runner``) against the bridge with the
    policy on the CPU, 20 control steps without the RC wait (the runner
    given no estimator): telemetry, finite obs of the run's width, finite
    actions, the log written."""
    run, width = runs["velocity" if entry == "deploy_policy" else "bench"]
    proc = go1_bridge.start(2500)
    se = t_se.StateEstimator(t_lite.LCMLite())
    se.spin()
    try:
        t0 = time.time()
        while not se.received_first_legdata and time.time() - t0 < 5.0:
            time.sleep(0.05)
        assert se.received_first_legdata, "no leg telemetry from the bridge"
        if entry == "deploy_policy":
            runner = deploy_policy.build_runner(run, se, device="cpu")
        else:
            runner = deploy_traj_policy.build_runner(run, se, "front_goal", device="cpu")
        assert runner.se is se and runner.policy.device == torch.device("cpu")
        # the loopback bridge never presses R2, which the runner waits for
        # through runner.se before it calibrates
        runner.se = None
        runner.run(max_steps=20)
    finally:
        se.close()
        stop(proc)
    assert len(runner.log) == 20
    obs = np.concatenate([r["obs"] for r in runner.log])
    act = np.concatenate([r["action"] for r in runner.log])
    assert obs.shape == (20, width) and np.isfinite(obs).all()
    assert act.shape == (20, 12) and np.isfinite(act).all()
    with open(os.path.join(run, "deploy_log.pkl"), "rb") as f:
        assert len(pickle.load(f)) == 20


def test_entries_parse_the_reference_flags():
    a = deploy_policy.parse_args(["--logdir", "D"])
    assert (a.max_vel, a.max_yaw_vel, a.device) == (1.0, 1.0, "cuda")
    b = deploy_traj_policy.parse_args(["--logdir", "D", "--profile", "rc", "--device", "cpu"])
    assert (b.profile, b.device) == ("rc", "cpu")
    with pytest.raises(SystemExit):
        deploy_traj_policy.parse_args(["--logdir", "D", "--profile", "nope"])
