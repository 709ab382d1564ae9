"""The port's dense rigid-body oracle and the JAX package's last host-side
pieces, held to the JAX package on the CPU: ``kinematics.jacobians``, the
dense formulation of ``physics/dynamics.py`` and the dense
``contact.apparent_masses`` on 4 seeded states; the port's sparse engine
against the port's dense oracle at the JAX package's bars; the physical
anchors at N <= 4; the host curricula and the numpy policy runtime bitwise;
the rand helpers; the train entry's ``--no_wandb``; and the two recipes.

Each tolerance stands beside the reading it bounds, read on a CPU.  The JAX side
runs as one jitted, vmapped function of the single-env JAX functions.
"""

import dataclasses
import importlib.util
import os
import re
import shlex
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_support  # noqa: F401

import chip_smoke
from legged_tracking_torch import train as t_train
from legged_tracking_torch import train_velocity_tracking as t_tv
from legged_tracking_torch.deploy import policy_runtime as t_rt
from legged_tracking_torch.io.checkpoint import export_policy_npz
from legged_tracking_torch.learn.actor_critic import ActorCriticCSE
from legged_tracking_torch.physics import contact as t_contact
from legged_tracking_torch.physics import dynamics as t_dyn
from legged_tracking_torch.physics import kinematics as t_kin
from legged_tracking_torch.physics.model import make_go1_model as t_make_model
from legged_tracking_torch.tasks import curriculum as t_cur
from legged_tracking_torch.utils import math as t_math
from legged_tracking_tpu.deploy import policy_runtime as j_rt
from legged_tracking_tpu.physics import contact as j_contact
from legged_tracking_tpu.physics import dynamics as j_dyn
from legged_tracking_tpu.physics.model import make_go1_model as j_make_model
from legged_tracking_tpu.tasks import curriculum as j_cur

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
TM = t_make_model("cpu")


def close(t, j, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def states():
    """chip_smoke's oracle inputs at N envs (the ranges of
    tests/test_sparse_dynamics.py), as torch and as numpy."""
    x = chip_smoke.oracle_inputs(N)
    return x, {k: v.numpy() for k, v in x.items()}


@pytest.fixture(scope="module")
def jax_dense(states):
    """The JAX dense formulation on the same states, vmapped and jitted:
    with the base-COM offset, without it, and ``refresh_mass_matrix`` of the
    offset's mass matrix at the configuration advanced by 5 ms of v."""
    _, x = states
    jm = j_make_model()

    def one(bp, bq, qj, v, pl, com, tau, fx, g):
        out = {}
        for tag, off in (("com", com), ("nocom", None)):
            bs = j_dyn.body_state(jm, bp, bq, qj, v, off)
            mm = j_dyn.mass_matrix(jm, bs, pl, off, bp)
            qdd = j_dyn.forward_dynamics(jm, bp, bq, qj, v, tau, fx, g, bs, mm, off)
            out[tag] = (bs, mm, qdd, j_contact.apparent_masses(jm, bs, mm))
        bs1 = j_dyn.body_state(jm, bp + 0.005 * v[:3], bq, qj + 0.005 * v[6:], v, com)
        out["refresh"] = j_dyn.refresh_mass_matrix(jm, out["com"][1], bs1, com, bp)
        return out

    keys = ("base_pos", "base_quat", "qj", "v", "payload", "com_offset", "tau", "f_ext")
    args = [jnp.asarray(x[k]) for k in keys] + [jnp.asarray(x["gravity"])]
    return jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(*args))


def port_dense(x, com=True):
    off = x["com_offset"] if com else None
    args = (x["base_pos"], x["base_quat"], x["qj"], x["v"])
    bs = t_dyn.body_state(TM, *args, off)
    mm = t_dyn.mass_matrix(TM, bs, x["payload"])
    qdd = t_dyn.forward_dynamics(TM, *args, x["tau"], x["f_ext"], x["gravity"], bs, mm, off)
    return bs, mm, qdd, t_contact.apparent_masses(TM, bs, mm)


# ---------------------------------------------------------------- the dense oracle
def test_jacobians_match(states, jax_dense):
    """J (N, 13, 6, 18), entries up to 1, at atol 1e-6; reading 6.0e-8."""
    x, _ = states
    f = t_kin.fk(TM, x["base_pos"], x["base_quat"], x["qj"], x["com_offset"])
    J = t_kin.jacobians(TM, f, x["base_pos"])
    assert J.shape == (N, 13, 6, 18)
    close(J, jax_dense["com"][0].J, 1e-6)


def test_body_state_match(states, jax_dense):
    """FK (reading 1.2e-7) and the body velocities J v (omega 1.2e-7, u
    1.8e-7, entries up to 2.2) at atol 1e-6."""
    bs = port_dense(states[0])[0]
    jbs = jax_dense["com"][0]
    for name in bs.fk._fields:
        close(getattr(bs.fk, name), getattr(jbs.fk, name), 1e-6, msg=name)
    close(bs.omega, jbs.omega, 1e-6)
    close(bs.u, jbs.u, 1e-6)


def test_mass_matrix_match(states, jax_dense):
    """M (entries up to 11.8) at atol 5e-6, reading 3.3e-7; M^-1 (entries
    up to 419, through 18 unpivoted eliminations) at atol 5e-3, reading
    3.1e-4; the masses with payload (reading 0) and world inertias (3.7e-9,
    entries up to 0.043) at 1e-7; J as above."""
    mm = port_dense(states[0])[1]
    jmm = jax_dense["com"][1]
    close(mm.M, jmm.M, 5e-6)
    close(mm.Minv, jmm.Minv, 5e-3)
    close(mm.mass, jmm.mass, 1e-7)
    close(mm.Iw, jmm.Iw, 1e-7)
    close(mm.J, jmm.J, 1e-6)


def test_refresh_mass_matrix_match(states, jax_dense):
    """A later substep's J (reading 7.5e-8, atol 1e-6) and Iw (3.7e-9, atol
    1e-7) with the first substep's M and M^-1."""
    x, _ = states
    mm0 = port_dense(x)[1]
    bp, qj = x["base_pos"] + 0.005 * x["v"][:, :3], x["qj"] + 0.005 * x["v"][:, 6:]
    bs1 = t_dyn.body_state(TM, bp, x["base_quat"], qj, x["v"], x["com_offset"])
    mm1 = t_dyn.refresh_mass_matrix(TM, mm0, bs1)
    jmm1 = jax_dense["refresh"]
    assert mm1.M is mm0.M and mm1.Minv is mm0.Minv and mm1.mass is mm0.mass
    close(mm1.J, jmm1.J, 1e-6)
    close(mm1.Iw, jmm1.Iw, 1e-7)


@pytest.mark.parametrize("com", [True, False], ids=["com_offset", "no_com_offset"])
def test_forward_dynamics_match(states, jax_dense, com):
    """qdd under torques N(0, 5^2) and wrenches N(0, 10^2) (entries up to
    6.8e3) at atol 2e-2; reading 2.4e-3 either way."""
    qdd = port_dense(states[0], com)[2]
    close(qdd, jax_dense["com" if com else "nocom"][2], 2e-2)


def test_apparent_masses_match(states, jax_dense):
    """W (N, 48, 3, 3), entries up to 5.3, at atol 3e-5; reading 3.3e-6."""
    W = port_dense(states[0])[3]
    close(W, jax_dense["com"][3], 3e-5)


def test_sparse_engine_matches_dense_oracle(states):
    """The port's sparse engine against the port's dense oracle within the
    bars of tests/test_sparse_dynamics.py (``chip_smoke.SPARSE_BARS``);
    readings 0.001-0.012 of each bar."""
    x, _ = states
    errs = chip_smoke.sparse_vs_dense(TM, x, chip_smoke.dense_oracle(TM, x))
    assert set(errs) == set(chip_smoke.SPARSE_BARS)
    for k, (err, ratio) in errs.items():
        assert ratio <= 1.0, (k, err, ratio)


# -------------------------------------------------------------------- anchors
def test_free_fall_and_mass_matrix_anchors(states):
    """At rest under gravity every body falls at g (readings 1.7e-5 base,
    1.9e-5 joints); M symmetric (6e-8), positive definite (least eigenvalue
    2.0e-3) with the total mass 11.309932 kg plus payload on its
    translation block (1.9e-6); limits of tests/test_physics.py."""
    lim = chip_smoke.ANCHOR_LIMITS
    a = chip_smoke.anchor_free_fall(TM, states[0])
    for k in ("free_fall_base", "free_fall_joints", "M_asymmetry", "M_translation_mass"):
        assert a[k] <= lim[k], (k, a[k])
    assert a["M_min_eigenvalue"] > 0.0


def test_energy_conserved_passive(states):
    """100 passive dense substeps at 5 ms: relative drift of T + V under
    1 % (reading 0.12 %)."""
    assert chip_smoke.anchor_energy(TM, states[0]) < chip_smoke.ANCHOR_LIMITS["energy_drift"]


def test_drop_and_stand_P_with_friction_push():
    """Two Go1s (friction 1.5 and 0.0) dropped on the plane under P control
    for 150 steps: both stand in (0.18, 0.34) m (reading 0.260), |v| under
    0.05 (0.0096), the feet carry 111 N within 2 % (0.012 %); their copies
    pushed at 0.5 m/s after 100 steps slide 0.026 m (1.5) and 0.50 m (0.0)."""
    lim = chip_smoke.ANCHOR_LIMITS
    s, report, dy = chip_smoke.drop_and_stand(TM, 2, "cpu", "P", [1.5, 0.0], push_at=100)
    h = s.base_pos[:, 2]
    assert bool(torch.isfinite(s.base_pos).all() and torch.isfinite(s.v).all())
    assert bool(((h > lim["height"][0]) & (h < lim["height"][1])).all()), h
    assert float(s.v.abs().max()) < lim["speed_P"]
    fz = report[..., 2].sum(dim=1).numpy()
    np.testing.assert_allclose(fz, chip_smoke.GO1_MASS * chip_smoke.GRAVITY,
                               rtol=lim["weight_rtol"])
    assert float(dy[0]) < lim["dy_high_friction"] and float(dy[1]) > lim["dy_ratio"] * float(dy[0])


# ------------------------------------------------------- host-side pieces
def test_host_curricula_bitwise():
    """The numpy curricula against the JAX package's over one sequence of
    set_to / sample / update calls from one seed: weights, bins and samples
    equal."""
    ranges = dict(x=(-1.0, 1.0, 5), y=(-0.5, 0.5, 3), z=(0.0, 2.0, 4))
    low, high = np.array([-0.2, -0.2, 0.0]), np.array([0.2, 0.2, 1.0])
    t_plain, j_plain = t_cur.HostCurriculum(3, **ranges), j_cur.HostCurriculum(3, **ranges)
    t_rc = t_cur.HostRewardThresholdCurriculum(5, **ranges)
    j_rc = j_cur.HostRewardThresholdCurriculum(5, **ranges)
    for t, j in ((t_plain, j_plain), (t_rc, j_rc)):
        assert len(t) == len(j) == 60
        for a in ("grid", "bin_sizes", "lows", "highs", "indices"):
            np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
        t.set_to(low, high)
        j.set_to(low, high)
        t.set_to(low + 0.5, high + 0.5, value=0.5)
        j.set_to(low + 0.5, high + 0.5, value=0.5)
        np.testing.assert_array_equal(t.weights, j.weights)
        for i in range(3):
            kw = {} if i else dict(low=np.array([-1.0, -1.0, 0.0]), high=high + 0.5)
            (ts, tb), (js, jb) = t.sample(16, **kw), j.sample(16, **kw)
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_array_equal(tb, jb)
            if isinstance(t, t_cur.HostRewardThresholdCurriculum):
                rew = np.linspace(0.0, 1.0, 16) * (i + 1) / 3
                args = (tb, [rew, rew[::-1]], [0.3, 0.1])
                t.update(*args, local_range=np.array([0.4, 0.3, 0.5]))
                j.update(*args, local_range=np.array([0.4, 0.3, 0.5]))
                t.update(tb, [rew], [0.5])
                j.update(tb, [rew], [0.5])
                t.update(tb, [], [])
                j.update(tb, [], [])
                np.testing.assert_array_equal(t.get_local_bins(tb[:3]), j.get_local_bins(tb[:3]))
            np.testing.assert_array_equal(t.weights, j.weights)
    assert t_rc.weights.max() == 1.0 and (t_rc.weights > 0.5).sum() > 8    # updates moved them


def test_numpy_policy_runtime_bitwise(tmp_path):
    """The port's numpy runtime (``MLPParams``, ``_elu``) on one export of
    the port's CSE policy against the JAX package's numpy runtime: the
    actions equal, batch and single row; no torch at inference."""
    torch.manual_seed(0)
    n_obs, n_hist = 70, 2100
    path = export_policy_npz(str(tmp_path / "policy.npz"),
                             ActorCriticCSE(n_obs, 2, n_hist, 12).state_dict())
    x = np.random.RandomState(1).randn(5, n_hist).astype(np.float32)
    rt, jrt = t_rt.NumpyPolicyRuntime(path), j_rt.PolicyRuntime(path)
    y = rt(x)
    assert y.shape == (5, 12) and y.dtype == np.float32
    np.testing.assert_array_equal(y, jrt(x))
    np.testing.assert_array_equal(rt(x[2:3]), jrt(x[2:3]))
    z = np.linspace(-3, 3, 101, dtype=np.float32)
    np.testing.assert_array_equal(t_rt._elu(z), j_rt._elu(z))
    layers = rt.adaptation.layers
    np.testing.assert_array_equal(t_rt.MLPParams(layers)(x), j_rt.MLPParams(layers)(x))
    np.savez(str(tmp_path / "other.npz"), a=np.zeros(1))
    with pytest.raises(KeyError, match="adaptation_module"):
        t_rt.NumpyPolicyRuntime(str(tmp_path / "other.npz"))


@pytest.mark.parametrize("fn", ["rand_uniform", "rand_sqrt_uniform"])
def test_rand_helpers_range_and_shape(fn):
    """Draws of ``shape`` in [lo, hi] on the generator's device, from the
    generator alone (the same seed gives the same draws); the sqrt shape
    puts more mass near the ends than the uniform."""
    draw = getattr(t_math, fn)
    g = torch.Generator().manual_seed(0)
    x = draw(g, -0.5, 2.0, (1000, 3))
    assert x.shape == (1000, 3) and x.dtype == torch.float32 and x.device.type == "cpu"
    assert float(x.min()) >= -0.5 and float(x.max()) <= 2.0
    assert torch.equal(x, draw(torch.Generator().manual_seed(0), -0.5, 2.0, (1000, 3)))
    mid = float(((x > 0.25) & (x < 1.25)).float().mean())       # the middle 40 %
    assert (mid < 0.3) if fn == "rand_sqrt_uniform" else (0.35 < mid < 0.45)


# ---------------------------------------------------------- entries, recipes
def script(name):
    spec = importlib.util.spec_from_file_location(f"scripts_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_entry_takes_every_script_flag():
    """``--no_wandb`` parses (a no-op, as in scripts/train.py), and the
    port's train entry takes every flag of the script but ``--cpu``, which
    ``--device cpu`` replaces."""
    assert t_train.parse_args(["--no_wandb"]).no_wandb
    jargs = vars(script("train").parse_args([]))
    assert set(jargs) - {"cpu"} == set(vars(t_train.parse_args([]))) - {"device", "dist_backend"}


def cfg_tree(obj):
    """A configuration as nested dicts and lists of plain values."""
    if dataclasses.is_dataclass(obj):
        return {k: cfg_tree(v) for k, v in vars(obj).items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (list, tuple)):
        return [cfg_tree(x) for x in obj]
    return obj


def recipe_stages(path):
    """The ``timeout`` commands of a recipe, variables at their defaults,
    as argument lists."""
    text = open(path).read().replace("\\\n", " ")
    env = dict(re.findall(r"(\w+)=\$\{\w+:-([^}]*)\}", text))
    env.update(re.findall(r"^(\w+)=([^$\s][^\s;]*)$", text, re.M))
    expand = lambda s: re.sub(r"\$\{?(\w+)\}?", lambda m: env[m.group(1)], s)
    return [shlex.split(expand(line)) for line in text.splitlines()
            if line.startswith("timeout ")]


ENTRIES = {"scripts/train.py": t_train, "scripts/train_velocity_tracking.py": t_tv}


@pytest.mark.parametrize("recipe", ["goal_recipe", "velocity_recipe"])
def test_recipe_stages_match_scripts(recipe):
    """The port's recipe has the stages, time limits and flags of
    tools/<recipe>.sh, calls the port's entry with ``--device cuda``, and
    each stage's flags give the port's entry the configuration the JAX
    script builds; ``bash -n`` passes on both."""
    port = os.path.join(ROOT, "legged_tracking_torch", "recipes", f"{recipe}.sh")
    ref = os.path.join(ROOT, "tools", f"{recipe}.sh")
    for path in (port, ref):
        subprocess.run(["bash", "-n", path], check=True)
    j_stages, t_stages = recipe_stages(ref), recipe_stages(port)
    assert len(t_stages) == len(j_stages) >= 2
    for j, t in zip(j_stages, t_stages):
        assert j[:3] == ["timeout", j[1], "python"] and t[:2] == j[:2]
        entry = ENTRIES[j[3]]
        assert t[2:5] == ["python", "-m", entry.__name__]
        assert t[5:] == j[4:] + ["--device", "cuda"]
        jmod = script(os.path.basename(j[3])[:-3])
        jargs, targs = jmod.parse_args(j[4:]), entry.parse_args(t[5:])
        assert cfg_tree(entry.build_cfg(targs)) == cfg_tree(jmod.build_cfg(jargs))
        shared = set(vars(jargs)) - {"cpu"}
        assert {k: getattr(targs, k) for k in shared} == {k: getattr(jargs, k) for k in shared}
