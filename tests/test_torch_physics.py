"""Parity of the port's physics with the JAX package's env-major functions
(vmapped over envs) on the CPU, on the same numpy-made inputs.

Tolerances are those of tests/test_lane_engine.py, which holds the JAX
package's own reassociated (lane-major) physics to the same oracle: the port
computes the same sums in another order (batched matmuls where the JAX code
unrolls component arithmetic), so agreement is float32-reassociation level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_support  # noqa: F401

from legged_tracking_torch.actuation import actuators as t_act
from legged_tracking_torch.config import Cfg as TCfg
from legged_tracking_torch.config import config_go1 as t_config_go1
from legged_tracking_torch.physics import contact as t_contact
from legged_tracking_torch.physics import engine as t_engine
from legged_tracking_torch.physics import kinematics as t_kin
from legged_tracking_torch.physics import sparse as t_sparse
from legged_tracking_torch.physics import model as t_model
from legged_tracking_torch.physics.model import make_go1_model as t_make_model
from legged_tracking_torch.terrain import heightfield as t_hf
from legged_tracking_torch.terrain.tunnel import build_terrain as t_build_terrain
from legged_tracking_torch.utils import math as t_math
from legged_tracking_torch.utils import quat as t_qt
from legged_tracking_tpu.actuation import actuators
from legged_tracking_tpu.config import Cfg, config_go1
from legged_tracking_tpu.physics import contact, engine, kinematics, sparse
from legged_tracking_tpu.physics import model as j_model
from legged_tracking_tpu.physics.model import make_go1_model
from legged_tracking_tpu.terrain.heightfield import extract_patches_batched_granule
from legged_tracking_tpu.terrain.tunnel import build_terrain
from legged_tracking_tpu.utils import math as j_math
from legged_tracking_tpu.utils import quat as qt

JM = make_go1_model()
TM = t_make_model("cpu")
DEFAULT_Q = np.array([-0.1, 0.8, -1.5, 0.1, 0.8, -1.5, -0.1, 1.0, -1.5, 0.1, 1.0, -1.5],
                     np.float32)
E = 8


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def close(t, j, atol, msg=""):
    np.testing.assert_allclose(t.detach().numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), rtol=0, atol=atol, err_msg=msg)


def random_batch(seed, scale_v=1.0):
    rng = np.random.RandomState(seed)
    bp = (rng.uniform(-1, 1, (E, 3)) + [0.0, 0.0, 0.4]).astype(np.float32)
    ang = rng.uniform(-0.6, 0.6, (E, 3)).astype(np.float32)
    bq = np.asarray(jax.vmap(qt.quat_from_euler_xyz)(J(ang[:, 0]), J(ang[:, 1]), J(ang[:, 2])))
    qj = rng.uniform(-1.2, 1.2, (E, 12)).astype(np.float32)
    v = rng.uniform(-scale_v, scale_v, (E, 18)).astype(np.float32)
    return bp, bq, qj, v


def test_quat_and_math_match():
    """Elementwise float32 formulas: ulp-level agreement (atol 1e-6 on O(1)
    values; the transcendental functions of the two libraries may differ in
    the last ulp)."""
    rng = np.random.RandomState(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    ang = rng.uniform(-7, 7, (64, 3)).astype(np.float32)
    for name, args in [("quat_mul", (q, q2)), ("quat_apply", (q, v)),
                       ("quat_rotate_inverse", (q, v)), ("quat_to_matrix", (q,)),
                       ("quaternion_to_roll_pitch_yaw", (q,)), ("quat_apply_yaw", (q, v)),
                       ("quat_apply_yaw_inverse", (q, v)), ("quat_without_yaw", (q,)),
                       ("normalize", (q2,)), ("wrap_to_pi", (ang,)),
                       ("quat_from_euler_xyz", (ang[:, 0], ang[:, 1], ang[:, 2])),
                       ("quat_from_angle_axis", (ang[:, 0], v / np.linalg.norm(v, axis=-1,
                                                                               keepdims=True))),
                       ("quat_conjugate", (q,)), ("quat_yaw_only", (q,)),
                       ("get_euler_xyz", (q,))]:
        out_t, out_j = getattr(t_qt, name)(*map(T, args)), getattr(qt, name)(*map(J, args))
        for a, b in (zip(out_t, out_j) if isinstance(out_t, tuple) else [(out_t, out_j)]):
            close(a, b, 2e-6, name)
    close(t_qt.quat_integrate(T(q), T(v), 0.005), qt.quat_integrate(J(q), J(v), 0.005), 1e-6)
    close(t_qt.quat_identity((2, 3), device="cpu"), qt.quat_identity((2, 3)), 0.0)
    for rng_ in ([0.0, 1.0], [-2.5, 0.5], [0.9, 1.1]):
        assert t_math.get_scale_shift(rng_) == pytest.approx(j_math.get_scale_shift(rng_),
                                                             rel=1e-7)


def test_model_constants_match():
    """The Go1 model as tensors equals the JAX package's (a copied table),
    its device tables hold what they stand for (the spheres' report slots
    as the one-hot ``sphere_to_report``), and the contact report slots
    resolve the same body names."""
    sb, sr = np.asarray(JM.sphere_body), np.asarray(JM.sphere_report)
    twins = {
        "sphere_leg": ((sb - 1) // 3).clip(0, 3),
        "sphere_to_body": np.arange(13)[:, None] == sb[None, :],
        "sphere_to_report": np.arange(17)[:, None] == sr[None, :],
        "level_bodies": t_model.LEVEL_BODIES,
        "level_dofs": np.asarray(t_model.LEVEL_BODIES) - 1,
        "stack_to_body": t_model.STACK_TO_BODY,
        "leg_tril": np.tril(np.ones((3, 3))),
    }
    twins["sphere_leg_mask"] = np.asarray(JM.sphere_ancestor_mask).reshape(-1, 4, 3)[
        np.arange(48), twins["sphere_leg"]]
    assert set(TM._fields) == set(JM._fields) - {"sphere_report"} | set(twins)
    for name in TM._fields:
        a = getattr(TM, name)
        b = twins[name] if name in twins else getattr(JM, name)
        np.testing.assert_array_equal(a.numpy() if torch.is_tensor(a) else np.asarray(a),
                                      np.asarray(b), err_msg=name)
    for names in (["thigh", "calf", "base"], ["base"], ["foot"], ["calf", "foot"], []):
        assert t_model.report_slots_for(names) == j_model.report_slots_for(names), names


def test_fk_matches():
    bp, bq, qj, _ = random_batch(0)
    off = (0.01 * np.arange(E * 3, dtype=np.float32)).reshape(E, 3)
    f_j = jax.vmap(kinematics.fk, in_axes=(None, 0, 0, 0, 0))(JM, J(bp), J(bq), J(qj), J(off))
    f_t = t_kin.fk(TM, T(bp), T(bq), T(qj), T(off))
    for name in f_t._fields:
        close(getattr(f_t, name), getattr(f_j, name), 1e-6, name)


def test_velocity_jvp_matches():
    bp, bq, qj, v = random_batch(1)
    bs_j, al_j, ac_j = jax.vmap(sparse.velocity_jvp, in_axes=(None, 0, 0, 0, 0))(
        JM, J(bp), J(bq), J(qj), J(v))
    bs_t, al_t, ac_t = t_sparse.velocity_jvp(TM, T(bp), T(bq), T(qj), T(v))
    close(bs_t.omega, bs_j.omega, 1e-5)
    close(bs_t.u, bs_j.u, 1e-5)
    close(al_t, al_j, 1e-4)
    close(ac_t, ac_j, 1e-4)


def test_factorize_and_forward_dynamics_match():
    bp, bq, qj, v = random_batch(3)
    rng = np.random.RandomState(30)
    payload = np.linspace(0.0, 0.5, E).astype(np.float32)
    tau = rng.normal(size=(E, 12)).astype(np.float32)
    f_ext = rng.normal(size=(E, 13, 6)).astype(np.float32)
    grav = np.tile(np.array([0.0, 0.0, -9.81], np.float32), (E, 1))

    def one(bp1, bq1, qj1, v1, pl, tau1, fx1, g1):
        bs, al, ac = sparse.velocity_jvp(JM, bp1, bq1, qj1, v1)
        fac = sparse.factorize(JM, bs.fk, pl)
        return fac, sparse.forward_dynamics(JM, bp1, bq1, qj1, v1, tau1, fx1, g1, bs, fac,
                                            vp=(al, ac))

    fac_j, qdd_j = jax.vmap(one)(*map(J, (bp, bq, qj, v, payload, tau, f_ext, grav)))
    bs, al, ac = t_sparse.velocity_jvp(TM, T(bp), T(bq), T(qj), T(v))
    fac_t = t_sparse.factorize(TM, bs.fk, T(payload))
    qdd_t = t_sparse.forward_dynamics(TM, T(bp), T(bq), T(qj), T(v), T(tau), T(f_ext), T(grav),
                                      bs, fac_t, vp=(al, ac))
    for name, atol in [("A", 1e-4), ("B", 1e-5), ("D", 1e-5), ("Sinv", 2e-4),
                       ("P_bl", 2e-4), ("P_ll", 2e-3), ("mass", 1e-6), ("Iw", 1e-6)]:
        close(getattr(fac_t, name), getattr(fac_j, name), atol, name)
    close(qdd_t, qdd_j, 5e-3)
    # the Schur solve alone, on a right-hand side of its own
    rhs = torch.as_tensor(np.random.RandomState(31).normal(size=(E, 18)).astype(np.float32))
    x = t_sparse.solve(fac_t, rhs)
    close(x, jax.vmap(sparse.solve)(fac_j, J(rhs.numpy())), 5e-3)


def test_apparent_masses_match():
    bp, bq, qj, _ = random_batch(4)
    payload = np.zeros(E, np.float32)
    f_j = jax.vmap(kinematics.fk, in_axes=(None, 0, 0, 0))(JM, J(bp), J(bq), J(qj))
    W_j = jax.vmap(lambda f1, pl: sparse.apparent_masses(JM, f1, sparse.factorize(JM, f1, pl)))(
        f_j, J(payload))
    f_t = t_kin.fk(TM, T(bp), T(bq), T(qj))
    W_t = t_sparse.apparent_masses(TM, f_t, t_sparse.factorize(TM, f_t, T(payload)))
    close(W_t, W_j, 2e-4)


def _tunnel(n):
    def cfg(cfg_cls, go1):
        c = go1(cfg_cls())
        c.terrain.mesh_type = "trimesh"
        c.terrain.terrain_type = "single_path"
        c.terrain.num_rows = 2
        c.terrain.num_cols = 2
        c.terrain.terrain_length = 4.0
        c.terrain.terrain_width = 2.0
        c.terrain.terrain_ratio_x = 0.9
        c.terrain.terrain_ratio_y = 0.5
        c.terrain.ceiling_height = 0.8
        c.terrain.start_loc = 0.32
        return c
    return (build_terrain(cfg(Cfg, config_go1), n, seed=5),
            t_build_terrain(cfg(TCfg, t_config_go1), n, seed=5, device="cpu"))


def test_contact_forces_match():
    """Floor, ceiling-slab and top-face contacts on the tunnel terrain; the
    JAX side samples through the granule patch, the port gathers directly."""
    jt, tt = _tunnel(E)
    bp, bq, qj, v = random_batch(5)
    bp[:, :2] = np.asarray(jt.env_origin)[:E, :2] + bp[:, :2] * 0.3
    # low bases touch the floor, high ones the ceiling (0.8 m)
    bp[:, 2] = np.linspace(0.05, 0.75, E)
    friction = np.linspace(0.3, 1.2, E).astype(np.float32)
    restitution = np.linspace(0.0, 0.5, E).astype(np.float32)
    patches, xs, ys = extract_patches_batched_granule(
        jt, jt.env_tile, jt.env_terrain_origin, J(bp[:, :2]), 24, 16)

    def one(bp1, bq1, qj1, v1, patch1, xs1, ys1, to1, fr1, re1):
        bs, _, _ = sparse.velocity_jvp(JM, bp1, bq1, qj1, v1)
        W = sparse.apparent_masses(JM, bs.fk, sparse.factorize(JM, bs.fk, jnp.asarray(0.0)))
        return contact.contact_forces(JM, jt, (patch1, xs1, ys1), to1, bs, W, fr1, re1,
                                      5000.0, 50.0, 0.005)

    c_j = jax.vmap(one)(J(bp), J(bq), J(qj), J(v), patches, xs, ys, jt.env_terrain_origin,
                        J(friction), J(restitution))
    bs, _, _ = t_sparse.velocity_jvp(TM, T(bp), T(bq), T(qj), T(v))
    W = t_sparse.apparent_masses(TM, bs.fk, t_sparse.factorize(TM, bs.fk, torch.zeros(E)))
    win = t_contact.ContactWindow(t_hf.bf16_table(tt), tt.env_tile,
                                  *t_hf.contact_window(tt, T(bp[:, :2]), 24, 16))
    c_t = t_contact.contact_forces(TM, tt, win, tt.env_terrain_origin, bs, W, T(friction),
                                   T(restitution), 5000.0, 50.0, 0.005)
    assert float(np.abs(np.asarray(c_j.report)).max()) > 1.0   # contacts are live
    close(c_t.sphere_pos, c_j.sphere_pos, 1e-5)
    close(c_t.sphere_vel, c_j.sphere_vel, 1e-5)
    # forces scale with stiffness 5e3: atol 0.05 N on O(100 N) forces
    close(c_t.f_ext, c_j.f_ext, 5e-2)
    close(c_t.report, c_j.report, 5e-2)
    rng = np.random.RandomState(6)
    q, qd = rng.uniform(-2, 2, (E, 12)).astype(np.float32), rng.normal(size=(E, 12))
    close(t_contact.joint_limit_torque(TM, T(q), T(qd.astype(np.float32)), 80.0, 2.0),
          contact.joint_limit_torque(JM, J(q), J(qd.astype(np.float32)), 80.0, 2.0), 1e-5)


@pytest.mark.parametrize("control_type", ["P", "actuator_net"])
def test_control_step_matches(control_type):
    """Three decimated control steps (4 substeps each) on the tunnel terrain,
    the JAX env-major control_step vmapped against the port's batched one."""
    n = 4
    jt, tt = _tunnel(n)
    net_j = actuators.load_actuator_net()
    net_t = t_act.load_actuator_net(device="cpu")
    tf_j = actuators.make_torque_fn(control_type, net_j, J(DEFAULT_Q), 20.0, 0.5,
                                    JM.dof_effort, randomize_lag=True)
    tf_t = t_act.make_torque_fn(control_type, net_t, T(DEFAULT_Q), 20.0, 0.5,
                                TM.dof_effort, randomize_lag=True)
    fr = np.linspace(0.5, 1.0, n).astype(np.float32)
    pl = np.linspace(0.0, 0.5, n).astype(np.float32)
    com = np.zeros((n, 3), np.float32)
    com[:, 0] = 0.01
    grav = np.tile(np.array([0.0, 0.0, -9.81], np.float32), (n, 1))
    p_j = engine.PhysParams(friction=J(fr), restitution=jnp.zeros(n), gravity=J(grav),
                            payload=J(pl), com_offset=J(com))
    p_t = t_engine.PhysParams(friction=T(fr), restitution=torch.zeros(n), gravity=T(grav),
                              payload=T(pl), com_offset=T(com))
    ones, zeros = np.ones((n, 12), np.float32), np.zeros((n, 12), np.float32)
    act_np = 0.1 * np.sin(np.arange(n * 12, dtype=np.float32)).reshape(n, 12)
    ast = actuators.init_actuator_state(6)
    c_j = (jax.tree.map(lambda x: jnp.tile(x, (n,) + (1,) * x.ndim), ast),
           J(ones), J(zeros), J(ones), J(ones), J(act_np))
    c_t = (t_act.init_actuator_state(6, n, device="cpu"), T(ones), T(zeros), T(ones), T(ones),
           T(act_np))
    bp = (np.asarray(jt.env_origin) + [0.0, 0.0, 0.32]).astype(np.float32)
    bq = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (n, 1))
    s_j = engine.PhysState(base_pos=J(bp), base_quat=J(bq), qj=J(np.tile(DEFAULT_Q, (n, 1))),
                           v=jnp.zeros((n, 18)))
    s_t = t_engine.PhysState(base_pos=T(bp), base_quat=T(bq), qj=T(np.tile(DEFAULT_Q, (n, 1))),
                             v=torch.zeros(n, 18))

    @jax.jit
    def step_j(st, cr):
        patches = extract_patches_batched_granule(jt, jt.env_tile, jt.env_terrain_origin,
                                                  st.base_pos[:, :2], 24, 16)
        return jax.vmap(lambda s, c, p, pt, x, y, o: engine.control_step(
            JM, jt, (pt, x, y), o, s, tf_j, c, p, 0.005, 4, 12000.0, 150.0, 80.0, 2.0))(
            st, cr, p_j, *patches, jt.env_terrain_origin)

    table = t_hf.bf16_table(tt)
    for _ in range(3):
        s_j, c_j, aux_j = step_j(s_j, c_j)
        win = t_contact.ContactWindow(table, tt.env_tile,
                                      *t_hf.contact_window(tt, s_t.base_pos[:, :2], 24, 16))
        s_t, c_t, aux_t = t_engine.control_step(
            TM, tt, win, tt.env_terrain_origin, s_t, tf_t, c_t, p_t, 0.005, 4,
            12000.0, 150.0, 80.0, 2.0)
    close(s_t.base_pos, s_j.base_pos, 2e-4)
    close(s_t.base_quat, s_j.base_quat, 2e-4)
    close(s_t.qj, s_j.qj, 5e-4)
    close(s_t.v, s_j.v, 2e-2)
    close(aux_t.torques, aux_j.torques, 1e-3)
    close(aux_t.contact_report, aux_j.contact_report, 0.2)
    close(c_t[0].lag_buffer, c_j[0].lag_buffer, 1e-6)
    close(c_t[0].joint_pos_err_last, c_j[0].joint_pos_err_last, 5e-4)
