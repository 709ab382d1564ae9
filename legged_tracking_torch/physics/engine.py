"""The fused physics control step (port of ``physics/engine.py``).

One call = ``decimation`` soft-contact dynamics substeps at ``sim.dt`` with
per-substep torque recomputation, batched over a leading env dimension N —
the counterpart of the reference hot loop (legged_robot_trajectory_tracking.py
:82-88: _compute_torques -> set_dof_actuation_force_tensor -> gym.simulate x4).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..terrain.heightfield import TerrainArrays
from . import contact as _contact
from . import dynamics, sparse
from .model import Go1Model


class PhysState(NamedTuple):
    base_pos: torch.Tensor   # (N, 3)
    base_quat: torch.Tensor  # (N, 4) xyzw
    qj: torch.Tensor         # (N, 12)
    v: torch.Tensor          # (N, 18) [lin world, ang world, joint rates]


class PhysParams(NamedTuple):
    """Per-env randomized physical parameters."""
    friction: torch.Tensor     # (N,)
    restitution: torch.Tensor  # (N,)
    gravity: torch.Tensor      # (N, 3) full gravity vector (incl. DR offset)
    payload: torch.Tensor      # (N,) added base mass
    com_offset: torch.Tensor   # (N, 3) base COM displacement


class StepAux(NamedTuple):
    contact_report: torch.Tensor  # (N, num_report, 3) mean net contact force over substeps
    torques: torch.Tensor         # (N, 12) last-substep applied torques
    sphere_pos: torch.Tensor      # (N, ns, 3) world (last substep)
    sphere_vel: torch.Tensor      # (N, ns, 3) world (last substep)


def _scale_excess(x, limit: float):
    """Halve the norm of x above ``limit`` (the spin/velocity damper)."""
    mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x * torch.where(mag > limit, (limit + 0.5 * (mag - limit)) / torch.clamp(mag, min=1e-6),
                           torch.ones_like(mag))


def control_step(model: Go1Model, terrain: TerrainArrays, window: _contact.ContactWindow,
                 env_terrain_origin, state: PhysState, torque_fn: Callable, torque_carry,
                 params: PhysParams, sim_dt: float, decimation: int,
                 contact_stiffness: float, contact_damping: float,
                 joint_limit_stiffness: float, joint_limit_damping: float):
    """Decimation loop of ``_control_step_body`` for all N envs.

    The arrow-structure factorization and the contact apparent masses W are
    computed ONCE per control step (first substep) and reused; world
    inertias, FK, velocities, contact forces, torques and the bias term are
    exact every substep."""
    report_acc = None
    fac0 = W0 = c = tau = None
    for k in range(decimation):
        # ONE fused primal+tangent pass per substep
        bs, alpha_vp, acc_vp = sparse.velocity_jvp(
            model, state.base_pos, state.base_quat, state.qj, state.v, params.com_offset)
        if k == 0:
            fac0 = sparse.factorize(model, bs.fk, params.payload)
            W0 = sparse.apparent_masses(model, bs.fk, fac0)
            fac = fac0
        else:
            fac = fac0._replace(Iw=dynamics._world_inertia(bs.fk.R, model.inertia))
        tau, torque_carry = torque_fn(state.qj, state.v[:, 6:], torque_carry)
        c = _contact.contact_forces(
            model, terrain, window, env_terrain_origin, bs, W0,
            params.friction, params.restitution, contact_stiffness, contact_damping, sim_dt)
        tau_total = tau + _contact.joint_limit_torque(
            model, state.qj, state.v[:, 6:], joint_limit_stiffness, joint_limit_damping)
        qdd = sparse.forward_dynamics(
            model, state.base_pos, state.base_quat, state.qj, state.v, tau_total, c.f_ext,
            params.gravity, bs, fac, params.com_offset, vp=(alpha_vp, acc_vp))
        bp, bq, qj, v = dynamics.integrate(
            state.base_pos, state.base_quat, state.qj, state.v, qdd, sim_dt)
        # PhysX-style hard limits: joint position & velocity clamps, plus the
        # spin/velocity safety damper and a base-velocity ceiling
        qj = torch.clamp(qj, model.dof_lower, model.dof_upper)
        vj = torch.clamp(v[:, 6:], -model.dof_vel_limit, model.dof_vel_limit)
        w = _scale_excess(v[:, 3:6], 10.0)
        u = _scale_excess(v[:, :3], 15.0)
        v = torch.cat([torch.clamp(u, -100.0, 100.0), torch.clamp(w, -50.0, 50.0), vj], dim=1)
        state = PhysState(base_pos=bp, base_quat=bq, qj=qj, v=v)
        report_acc = c.report if report_acc is None else report_acc + c.report
    aux = StepAux(contact_report=report_acc / decimation, torques=tau,
                  sphere_pos=c.sphere_pos, sphere_vel=c.sphere_vel)
    return state, torque_carry, aux
