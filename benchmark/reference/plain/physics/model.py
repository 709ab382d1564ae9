"""Go1 rigid-body model as tensors on a device (port of ``physics/model.py``).

The kinematic tree is fixed (13 bodies / 12 revolute DOFs / floating base),
so the tree-structure arrays stay numpy and index the batched tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import go1_model_data as D


class Go1Model(NamedTuple):
    """Static model constants (float tensors on one device; index arrays numpy)."""

    # tree
    parent: np.ndarray              # (nb,)
    ancestor_mask: torch.Tensor     # (nb, nd) 1.0 where dof j is an ancestor of body i
    joint_body: np.ndarray          # (nd,) body index driven by dof j

    # geometry
    joint_pos: torch.Tensor         # (nb, 3) joint origin in parent frame
    joint_axis: torch.Tensor        # (nb, 3) joint axis in child frame
    dof_lower: torch.Tensor         # (nd,)
    dof_upper: torch.Tensor         # (nd,)
    dof_effort: torch.Tensor        # (nd,) torque limits
    dof_vel_limit: torch.Tensor     # (nd,)

    # inertial
    mass: torch.Tensor              # (nb,)
    com: torch.Tensor               # (nb, 3) in body frame
    inertia: torch.Tensor           # (nb, 3, 3) about COM, body frame

    # collision spheres
    sphere_body: np.ndarray         # (ns,) int
    sphere_ancestor_mask: torch.Tensor  # (ns, nd) dof-ancestry of each sphere's body
    sphere_offset: torch.Tensor     # (ns, 3)
    sphere_radius: torch.Tensor     # (ns,)
    sphere_report: np.ndarray       # (ns,) report-slot index
    foot_sphere_idx: np.ndarray     # (4,) FR, FL, RR, RL

    num_bodies: int = D.NUM_BODIES
    num_dof: int = D.NUM_DOF
    num_report_bodies: int = D.NUM_REPORT_BODIES


def _ancestor_mask() -> np.ndarray:
    """mask[i, j] = 1 iff dof j is on the path from body i to the base."""
    nb, nd = D.NUM_BODIES, D.NUM_DOF
    mask = np.zeros((nb, nd), dtype=np.float32)
    for i in range(1, nb):
        b = i
        while b > 0:
            mask[i, b - 1] = 1.0  # dof j drives body j+1
            b = D.PARENT[b]
    return mask


def make_go1_model(device="cuda", dtype=torch.float32) -> Go1Model:
    f = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), dtype=dtype, device=device)
    return Go1Model(
        parent=np.asarray(D.PARENT),
        ancestor_mask=f(_ancestor_mask()),
        joint_body=np.arange(1, D.NUM_BODIES),
        joint_pos=f(D.JOINT_POS),
        joint_axis=f(D.JOINT_AXIS),
        dof_lower=f(D.DOF_LOWER),
        dof_upper=f(D.DOF_UPPER),
        dof_effort=f(D.DOF_EFFORT),
        dof_vel_limit=f(D.DOF_VEL_LIMIT),
        mass=f(D.MASS),
        com=f(D.COM),
        inertia=f(D.INERTIA),
        sphere_body=np.asarray(D.SPHERE_BODY),
        sphere_ancestor_mask=f(_ancestor_mask()[np.asarray(D.SPHERE_BODY)]),
        sphere_offset=f(D.SPHERE_OFFSET),
        sphere_radius=f(D.SPHERE_RADIUS),
        sphere_report=np.asarray(D.SPHERE_REPORT),
        foot_sphere_idx=np.asarray(D.FOOT_SPHERE_IDX),
    )


# convenient static index sets (URDF traversal order: FR, FL, RR, RL)
BODY_NAMES = D.BODY_NAMES
DOF_NAMES = D.DOF_NAMES
FOOT_REPORT_SLOTS = D.FOOT_REPORT_SLOTS
HIP_DOFS = [0, 3, 6, 9]
THIGH_BODIES = [i for i, n in enumerate(D.BODY_NAMES) if "thigh" in n]
CALF_BODIES = [i for i, n in enumerate(D.BODY_NAMES) if "calf" in n]
BASE_BODY = 0


def report_slots_for(names) -> list:
    """Report-slot indices for bodies whose name contains any of `names`
    (mirrors Isaac Gym's find_actor_rigid_body_handle indexing of
    penalised/termination contacts, legged_robot_trajectory_tracking.py:1647-1664)."""
    slots = []
    for i, n in enumerate(D.BODY_NAMES):
        if any(s in n for s in names):
            slots.append(i)
    if any("foot" in s for s in names):
        slots.extend(D.FOOT_REPORT_SLOTS)
    return slots
