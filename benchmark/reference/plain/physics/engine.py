"""The physics control step of the reference, on the dense oracle.

One call = ``decimation`` soft-contact dynamics substeps at ``sim.dt`` with
the torques recomputed every substep, batched over a leading env dimension
N (the reference hot loop, legged_robot_trajectory_tracking.py:82-88:
_compute_torques -> set_dof_actuation_force_tensor -> gym.simulate x4).

The rigid-body solve is the dense composite formulation of ``dynamics.py``
(materialized Jacobians, the 18 x 18 mass matrix, its explicit inverse) and
the contacts' apparent masses are ``J_p M^-1 J_p^T`` from that inverse: no
part of the program's arrow-structure solver.  It runs in ``SOLVE_DTYPE``,
float64 unless the control asks for the configuration's float32, so that
the reference's own rounding stays far below the program's.  The mass
matrix, its inverse and the apparent masses are taken at the first substep
and kept for the control step, as the program's physics states.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..terrain.heightfield import TerrainArrays
from . import contact as _contact
from . import dynamics
from .model import Go1Model

# the dtype of the rigid-body solve (``benchmark.reference.train.precision``
# sets float32 for the control)
SOLVE_DTYPE = torch.float64


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


def _cast(x, dtype):
    """``x`` (a tensor or a NamedTuple of them) with its floating tensors in
    ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    return type(x)(*(_cast(v, dtype) for v in x))


def _model(model: Go1Model, dtype) -> Go1Model:
    return model._replace(**{k: v.to(dtype) for k, v in model._asdict().items()
                             if isinstance(v, torch.Tensor) and v.is_floating_point()})


def control_step(model: Go1Model, terrain: TerrainArrays, window: _contact.ContactWindow,
                 env_terrain_origin, state: PhysState, torque_fn: Callable, torque_carry,
                 params: PhysParams, sim_dt: float, decimation: int,
                 contact_stiffness: float, contact_damping: float,
                 joint_limit_stiffness: float, joint_limit_damping: float):
    """The decimation loop for all N envs, solved in :data:`SOLVE_DTYPE`;
    the state and the report come back in float32, the torques from the
    actuator net are computed in float32, as the env's net is."""
    dt = SOLVE_DTYPE
    f32 = state.base_pos.dtype
    m = _model(model, dt)
    state, params = _cast(state, dt), _cast(params, dt)
    report_acc = None
    mm0 = W0 = c = tau = None
    for k in range(decimation):
        bs = dynamics.body_state(m, state.base_pos, state.base_quat, state.qj, state.v,
                                 params.com_offset)
        if k == 0:
            mm0 = dynamics.mass_matrix(m, bs, params.payload)
            W0 = _contact.apparent_masses(m, bs, mm0)
            mm = mm0
        else:
            mm = dynamics.refresh_mass_matrix(m, mm0, bs)
        tau, torque_carry = torque_fn(state.qj.to(f32), state.v[:, 6:].to(f32), torque_carry)
        tau = tau.to(dt)
        c = _contact.contact_forces(
            m, terrain, window, env_terrain_origin, bs, W0,
            params.friction, params.restitution, contact_stiffness, contact_damping, sim_dt)
        tau_total = tau + _contact.joint_limit_torque(
            m, state.qj, state.v[:, 6:], joint_limit_stiffness, joint_limit_damping)
        qdd = dynamics.forward_dynamics(
            m, state.base_pos, state.base_quat, state.qj, state.v, tau_total, c.f_ext,
            params.gravity, bs, mm, params.com_offset)
        bp, bq, qj, v = dynamics.integrate(
            state.base_pos, state.base_quat, state.qj, state.v, qdd, sim_dt)
        # PhysX-style hard limits: joint position & velocity clamps, plus the
        # spin/velocity safety damper and a base-velocity ceiling
        qj = torch.clamp(qj, m.dof_lower, m.dof_upper)
        vj = torch.clamp(v[:, 6:], -m.dof_vel_limit, m.dof_vel_limit)
        w = _scale_excess(v[:, 3:6], 10.0)
        u = _scale_excess(v[:, :3], 15.0)
        v = torch.cat([torch.clamp(u, -100.0, 100.0), torch.clamp(w, -50.0, 50.0), vj], dim=1)
        state = PhysState(base_pos=bp, base_quat=bq, qj=qj, v=v)
        report_acc = c.report if report_acc is None else report_acc + c.report
    aux = StepAux(contact_report=report_acc / decimation, torques=tau,
                  sphere_pos=c.sphere_pos, sphere_vel=c.sphere_vel)
    return _cast(state, f32), torque_carry, _cast(aux, f32)
