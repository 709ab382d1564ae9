"""The PhysX-calibration anchors of tests/test_calibration.py, on the port,
at that file's bounds, on the CPU:

- calm PD stance settles with feet-only contact (every non-foot report
  slot under 1 N, each foot 0.14-0.36 of m g, the feet carrying m g within
  2 %, the base at 0.24-0.30 m);
- the zero-gravity thigh step answers like a clean underdamped second-order
  system (90 % within 15 steps, peak under 1.6, the last 5 steps within
  0.05 of the target);
- the ji22 gate at calm stance: the velocity task's negative reward sum
  stays above -0.15 a step after settling, no env is done, feet-only
  contact.

The runs are chip_smoke.py's (``drop_and_stand``, ``thigh_response``,
``ji22_run``), which its physics-oracle phase runs on the card at 4096
envs.  The ji22 gate runs on the JAX test's own draws (its seed, 11,
through ``VelocityDraws``): the gate depends on the draws, and that sample
is the one the anchor was set on.  From the repo's root,
``PYTHONPATH=. python tests/test_torch_calibration.py [N]`` prints the
gate's shares over N envs (default 256) for the JAX package, for the port
on the JAX package's draws and for the port on its own.
"""

import sys

import jax
import numpy as np
import torch
from torch_support import VelocityDraws, install_velocity_draws

import chip_smoke
from legged_tracking_torch.physics.go1_model_data import FOOT_REPORT_SLOTS
from legged_tracking_torch.physics.model import make_go1_model

TM = make_go1_model("cpu")
MG = chip_smoke.GO1_MASS * chip_smoke.GRAVITY     # Go1 total weight (URDF masses, N)


def test_stance_feet_only_contact():
    """Nominal stance (4 envs, P control, 200 steps): all contact force lives
    in the 4 foot slots (reading 0 N elsewhere, each foot 0.219-0.280 of
    m g, the base at 0.2604 m)."""
    s, report, _ = chip_smoke.drop_and_stand(TM, 4, "cpu", "P", 1.0, steps=200)
    rep = report.numpy()                                      # (N, 17, 3)
    foot = rep[:, FOOT_REPORT_SLOTS, :]
    nonfoot = np.delete(rep, FOOT_REPORT_SLOTS, axis=1)
    assert np.abs(nonfoot).max() < 1.0, np.abs(nonfoot).max()
    fz = foot[:, :, 2]
    assert (fz > 0.14 * MG).all() and (fz < 0.36 * MG).all(), fz / MG
    np.testing.assert_allclose(fz.sum(axis=1), MG, rtol=0.02)
    h = s.base_pos[:, 2].numpy()
    assert (h > 0.24).all() and (h < 0.30).all(), h
    # the card's judge of the same readings agrees
    _, failed = chip_smoke.calibration_checks(chip_smoke.feet_only(s, report))
    assert failed == []


def test_pd_step_response():
    """Zero-gravity thigh step of 0.3 rad (2 envs, 50 steps of 20 ms): rise
    inside 15 steps (reading 1.159), peak under 1.6 (1.192), settled within
    0.05 by the last 5 steps (9.3e-5)."""
    x = chip_smoke.thigh_response(TM, 2, "cpu").numpy()      # (50, N, 4)
    assert np.isfinite(x).all()
    assert x[:15].max(axis=0).min() > 0.9, x[:15].max(axis=0)
    assert x.max() < 1.6, x.max()
    assert np.abs(x[-5:] - 1.0).max() < 0.05, x[-5:]


def jax_draws(n):
    """The JAX velocity env's draws from its reset key (the seed 11 of the
    script's configuration), routed into a port env by
    ``install_velocity_draws``."""
    return VelocityDraws(jax.random.key(11), n)


def port_on_jax_draws(n):
    env = install_velocity_draws(chip_smoke.ji22_env(n, "cpu"), jax_draws(n))
    return chip_smoke.ji22_run(env)


def test_ji22_gate_at_calm_stance():
    """Velocity task at 4 envs, zero velocity commands, zero actions: the
    negative reward sum per step after settling stays above -0.15 on every
    env (readings -0.081, -0.083, -0.104, -0.135, those of the JAX package
    on the same draws within 1e-4), no env is done, and the contact report
    is feet-only."""
    per_step, done, nonfoot = port_on_jax_draws(4)
    assert not bool(done.any())
    assert (per_step > -0.15).all(), per_step
    assert float(nonfoot.max()) < 1.0, nonfoot


def jax_ji22(n):
    """tests/test_calibration.py's ji22 run on the JAX package at n envs:
    per env the mean per-step change of rew_neg after step 30, whether it
    was done, the largest non-foot force of the last report."""
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import jax.numpy as jnp
    import train_velocity_tracking as tv

    from legged_tracking_tpu.envs.velocity_env import VelocityTrackingEnv
    cfg = tv.build_cfg(tv.parse_args(["--num_envs", str(n), "--terrain", "plane",
                                      "--pd_control", "--cpu"]))
    cfg.env.episode_length_s = 20.0
    env = VelocityTrackingEnv(cfg)
    env.reset(randomize_ep_len=False)
    env.state = env.state._replace(commands=env.state.commands.at[:, :3].set(0.0))
    a = jnp.zeros((n, 12))
    done_any, neg_prev, steps = np.zeros(n, bool), None, []
    for t in range(60):
        _, _, done, info = env.step(a)
        done_any |= np.asarray(done)
        neg = np.asarray(info["episode_sums"][:, -1])
        if neg_prev is not None and t >= 30:
            steps.append(neg - neg_prev)
        neg_prev = neg
    rep = np.delete(np.asarray(env.state.contact_forces), FOOT_REPORT_SLOTS, axis=1)
    return np.stack(steps).mean(axis=0), done_any, np.abs(rep).max(axis=(1, 2))


def shares(n):
    """The ji22 gate over n envs: each run's shares of envs past the bounds
    and its least per-step change, and how far the port on the JAX draws
    stands from the JAX package env by env."""
    import json
    runs = {"jax": jax_ji22(n),
            "port_on_jax_draws": [t.numpy() for t in port_on_jax_draws(n)],
            "port": [t.numpy() for t in chip_smoke.ji22_run(chip_smoke.ji22_env(n, "cpu"))]}
    for name, (per_step, done, nonfoot) in runs.items():
        print(json.dumps({"run": name, "envs": n, "below_share": float((per_step <= -0.15).mean()),
                          "done_share": float(done.mean()),
                          "nonfoot_share": float((nonfoot >= 1.0).mean()),
                          "neg_per_step_min": float(per_step.min())}))
    (jp, jd, jn), (tp, td, tn) = runs["jax"], runs["port_on_jax_draws"]
    print(json.dumps({"port_on_jax_draws_vs_jax": {
        "per_step_max_abs_err": float(np.abs(tp - jp).max()),
        "done_disagree": int((jd != td).sum()),
        "below_disagree": int(((jp <= -0.15) != (tp <= -0.15)).sum())}}))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    shares(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
