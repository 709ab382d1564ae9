"""Parity of the port's env with the JAX package's ``LeggedEnv`` on the CPU.

The port draws every random number through ``LeggedEnv.draw``; here
:class:`JaxDraws` stands in for it and returns the values the JAX env draws
from its own keys, so both envs see the same domain randomization, noise and
auto-reset values.  The JAX env runs its env-major physics
(``lane_engine=False``), the oracle the port follows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_support import (N, JaxDraws, assert_state_close, bench_cfg, install_jax_draws,
                           to_numpy)

from legged_tracking_torch import convert
from legged_tracking_torch.actuation import actuators as t_act
from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.envs import LeggedEnv as TEnv
from legged_tracking_tpu.actuation import actuators
from legged_tracking_tpu.config import Cfg, config_go1
from legged_tracking_tpu.envs import LeggedEnv as JEnv

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "assets", "goldens",
                      "tunnel_rollout_v1.npz")


@pytest.fixture(scope="module")
def envs():
    """One JAX env (step_fn jitted once) and its port twin, and the JAX
    reset state with randomized episode lengths."""
    jenv = JEnv(bench_cfg(Cfg, config_go1), seed=3)
    tenv = TEnv(bench_cfg(TCfg, t_config_go1), seed=3, device="cpu")
    key = jax.random.key(5)
    jstate = jenv._reset_jit(key, True)
    return jenv, tenv, key, jstate


def test_actuators_match():
    """Actuator net and both torque laws over 3 substeps: float32 MLP
    reassociation only (atol 1e-5 on O(10) N m torques)."""
    rng = np.random.RandomState(0)
    net_j = actuators.load_actuator_net()
    net_t = t_act.load_actuator_net(device="cpu")
    x = rng.normal(size=(N, 12, 6)).astype(np.float32)
    np.testing.assert_allclose(net_t(torch.as_tensor(x)).numpy(),
                               np.asarray(actuators.actuator_net_torque(net_j, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    a = rng.normal(size=(N, 12)).astype(np.float32)
    np.testing.assert_allclose(t_act.scale_actions(torch.as_tensor(a), 0.25, 0.5).numpy(),
                               np.asarray(actuators.scale_actions(jnp.asarray(a), 0.25, 0.5)),
                               rtol=0, atol=0)
    q0 = rng.uniform(-0.5, 0.5, 12).astype(np.float32)
    effort = np.full(12, 23.7, np.float32)
    for ctype in ("P", "actuator_net"):
        fj = actuators.make_torque_fn(ctype, net_j, jnp.asarray(q0), 20.0, 0.5,
                                      jnp.asarray(effort), True)
        ft = t_act.make_torque_fn(ctype, net_t, torch.as_tensor(q0), 20.0, 0.5,
                                  torch.as_tensor(effort), True)
        ms, mo = (rng.uniform(0.9, 1.1, (N, 12)).astype(np.float32),
                  rng.uniform(-0.02, 0.02, (N, 12)).astype(np.float32))
        ones = np.ones((N, 12), np.float32)
        st = jax.tree.map(lambda z: jnp.tile(z, (N,) + (1,) * z.ndim),
                          actuators.init_actuator_state(6))
        cj = (st, *map(jnp.asarray, (ms, mo, ones, ones, a)))
        ct = (t_act.init_actuator_state(6, N, device="cpu"),
              *map(torch.as_tensor, (ms, mo, ones, ones, a)))
        for _ in range(3):
            qj = rng.uniform(-1, 1, (N, 12)).astype(np.float32)
            qd = rng.normal(size=(N, 12)).astype(np.float32)
            tau_j, cj = jax.vmap(fj)(jnp.asarray(qj), jnp.asarray(qd), cj)
            tau_t, ct = ft(torch.as_tensor(qj), torch.as_tensor(qd), ct)
            np.testing.assert_allclose(tau_t.numpy(), np.asarray(tau_j), rtol=0, atol=1e-5,
                                       err_msg=ctype)
        for name in ct[0]._fields:
            np.testing.assert_allclose(getattr(ct[0], name).numpy(),
                                       np.asarray(getattr(cj[0], name)), rtol=0, atol=1e-6,
                                       err_msg=name)


def test_convert_round_trips(envs):
    """convert.py carries a JAX EnvState, TerrainArrays and the actuator npz
    into the port and back without changing a bit."""
    jenv, tenv, key, jstate = envs
    j = to_numpy(jstate)
    back = convert.env_state_to_numpy(convert.env_state_from_numpy(j, device="cpu"))
    for name, x in back.items():
        for sub, a in (x.items() if isinstance(x, dict) else [(None, x)]):
            b = np.asarray(j[name][sub] if sub else j[name])
            np.testing.assert_array_equal(a, b.astype(np.float32) if b.dtype.name == "bfloat16"
                                          else b, err_msg=f"{name}.{sub}")
    jt = {k: (np.asarray(v) if hasattr(v, "shape") else v)
          for k, v in jenv.terrain._asdict().items()}
    tt = convert.terrain_from_numpy(jt, device="cpu")
    for name, v in convert.terrain_to_numpy(tt).items():
        np.testing.assert_array_equal(v, jt[name], err_msg=name)
        own = getattr(tenv.terrain, name)
        np.testing.assert_array_equal(v, own.numpy() if torch.is_tensor(own) else own,
                                      err_msg=name)
    net = convert.actuator_net_from_npz(t_act._ASSET_DIR + "/unitree_go1.npz", device="cpu")
    for a, b in zip(net.state_dict().values(), tenv.actuator_net.state_dict().values()):
        assert torch.equal(a, b)


def test_reset_fn_matches(envs):
    """reset_fn with the JAX draws injected rebuilds the JAX reset state:
    the same draws through the same float32 formulas (atol 1e-6)."""
    jenv, tenv, key, jstate = envs
    tenv.draw = JaxDraws(key, N)
    try:
        tstate = tenv.reset_fn(True)
    finally:
        del tenv.draw
    assert_state_close(tstate, jstate, atol=1e-6)


def test_observe_matches(envs):
    """observe from the converted JAX reset state: the height scan is
    bitwise, the rest float32 elementwise (atol 1e-5)."""
    jenv, tenv, key, jstate = envs
    ref = jenv._observe_jit(jstate)
    out = tenv.observe(convert.env_state_from_numpy(to_numpy(jstate), device="cpu"))
    for k in ("obs", "privileged_obs", "obs_history"):
        np.testing.assert_allclose(out[k].float().numpy(), np.asarray(ref[k], np.float32),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_step_fn_matches_five_steps(envs):
    """5 step_fns from the JAX reset state with JAX's draws (DR, obs noise,
    auto-resets of 3-step episodes); dones and episode bookkeeping exact.
    The float32 sums run in another order.  The errors read 6.0e-8
    (base_pos), 5.8e-5 (v), 2.9e-6 (obs), 0 (privileged obs) and 1.0e-8
    (rew, of rewards up to 0.025); each limit is about 10 times that, well
    inside tests/test_lane_engine.py:443-446's limits for a reassociated
    physics (1e-3, 5e-2, 1e-2, 5e-2)."""
    jenv, tenv, key, jstate = envs
    install_jax_draws(tenv, JaxDraws(key, N))
    try:
        tstate = convert.env_state_from_numpy(to_numpy(jstate), device="cpu")
        js = jstate
        step_j = jax.jit(jenv.step_fn)
        n_done = 0
        for i in range(5):
            a = 0.3 * np.sin(0.1 * i + np.arange(N * 12, dtype=np.float32)).reshape(N, 12)
            js, oj = step_j(js, jnp.asarray(a))
            tstate, ot = tenv.step_fn(tstate, torch.as_tensor(a))
            msg = f"step {i}"
            np.testing.assert_array_equal(ot.done.numpy(), np.asarray(oj.done), err_msg=msg)
            n_done += int(np.asarray(oj.done).sum())
            np.testing.assert_allclose(tstate.phys.base_pos.numpy(), np.asarray(js.phys.base_pos),
                                       rtol=0, atol=1e-6, err_msg=msg)
            np.testing.assert_allclose(tstate.phys.v.numpy(), np.asarray(js.phys.v),
                                       rtol=0, atol=5e-4, err_msg=msg)
            np.testing.assert_allclose(ot.obs.numpy(), np.asarray(oj.obs), rtol=0, atol=5e-5,
                                       err_msg=msg)
            np.testing.assert_allclose(ot.privileged_obs.numpy(), np.asarray(oj.privileged_obs),
                                       rtol=0, atol=1e-6, err_msg=msg)
            np.testing.assert_allclose(ot.rew.numpy(), np.asarray(oj.rew), rtol=0, atol=1e-7,
                                       err_msg=msg)
            for k in ("episode_length", "time_outs", "reached"):
                np.testing.assert_array_equal(ot.info[k].numpy(), np.asarray(oj.info[k]),
                                              err_msg=f"{msg} {k}")
        assert n_done > 0          # the auto-reset ran
        assert_state_close(tstate, js, atol=5e-2)
    finally:
        del tenv.draw, tenv.step_fn


def test_golden_rollout_through_port():
    """tests/test_golden_rollout.py's rollout, run by the port from the JAX
    reset state, held to that test's own tolerances (traj atol 1e-3, rew
    atol 1e-5)."""
    def golden_cfg(cfg_cls, go1):
        cfg = bench_cfg(cfg_cls, go1, episode_s=4.0)
        fresh = go1(cfg_cls())
        cfg.reward_scales = fresh.reward_scales
        cfg.asset = fresh.asset
        cfg.rewards = fresh.rewards
        cfg.commands = fresh.commands
        cfg.terrain.measured_points_x = fresh.terrain.measured_points_x
        cfg.terrain.measured_points_y = fresh.terrain.measured_points_y
        cfg.seed = 7
        return cfg

    jenv = JEnv(golden_cfg(Cfg, config_go1), seed=7)
    tenv = TEnv(golden_cfg(TCfg, t_config_go1), seed=7, device="cpu")
    key = jax.random.key(7)
    state = convert.env_state_from_numpy(to_numpy(jenv.reset_fn(key, False)), device="cpu")
    install_jax_draws(tenv, JaxDraws(key, N))
    a = torch.tensor([0.1, -0.2, 0.3, -0.1, 0.2, -0.3] * 2)[None].repeat(N, 1)
    traj = []
    for t in range(20):
        state, out = tenv.step_fn(state, a * np.float32(np.cos(0.1 * t)))
        traj.append(state.phys.base_pos.numpy())
    g = np.load(GOLDEN)
    np.testing.assert_allclose(np.stack(traj), g["traj"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(out.rew.numpy(), g["rew"], rtol=0, atol=1e-5)
