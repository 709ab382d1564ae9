"""Go1 rigid-body model as tensors on a device (port of ``physics/model.py``).

The kinematic tree is fixed (13 bodies / 12 revolute DOFs / floating base).
The tree's own index arrays stay numpy, as the JAX package's are; whatever
the physics indexes the batched tensors with (``sphere_body`` and the
tables after it) is a device tensor built once here, so that a step copies
nothing from the host (and can be captured in a CUDA graph, ``graph.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import go1_model_data as D


class Go1Model(NamedTuple):
    """Static model constants (tensors on one device; the tree's index arrays numpy)."""

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
    sphere_body: torch.Tensor       # (ns,) long
    sphere_ancestor_mask: torch.Tensor  # (ns, nd) dof-ancestry of each sphere's body
    sphere_offset: torch.Tensor     # (ns, 3)
    sphere_radius: torch.Tensor     # (ns,)
    foot_sphere_idx: np.ndarray     # (4,) FR, FL, RR, RL

    # the step's static index tables
    sphere_leg: torch.Tensor        # (ns,) long: leg of the sphere's body (0 for the base)
    sphere_leg_mask: torch.Tensor   # (ns, 3) sphere_ancestor_mask within that leg
    sphere_to_body: torch.Tensor    # (nb, ns) one-hot of sphere_body
    sphere_to_report: torch.Tensor  # (nr, ns) one-hot of D.SPHERE_REPORT
    level_dofs: torch.Tensor        # (3, 4) long: the dofs of LEVEL_BODIES
    level_bodies: torch.Tensor      # (3, 4) long: LEVEL_BODIES
    stack_to_body: torch.Tensor     # (nb,) long: STACK_TO_BODY
    leg_tril: torch.Tensor          # (3, 3) LEG_TRIL

    num_bodies: int = D.NUM_BODIES
    num_dof: int = D.NUM_DOF
    num_report_bodies: int = D.NUM_REPORT_BODIES


# static level structure of FK: body indices per level (FR, FL, RR, RL order)
LEVEL_BODIES = (
    (1, 4, 7, 10),   # hips
    (2, 5, 8, 11),   # thighs
    (3, 6, 9, 12),   # calves
)
# permutation from [base, hips, thighs, calves] stacking order -> body order
STACK_TO_BODY = (0, 1, 5, 9, 2, 6, 10, 3, 7, 11, 4, 8, 12)
# lower-triangular (body-level >= joint-level) mask within a leg chain
LEG_TRIL = ((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (1.0, 1.0, 1.0))


def _one_hot(index, n) -> np.ndarray:
    """(n, len(index)) matrix with a 1 where row == index[col]."""
    return (np.arange(n)[:, None] == np.asarray(index)[None, :]).astype(np.float32)


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
    i = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
    sb = np.asarray(D.SPHERE_BODY)
    ns = sb.shape[0]
    sphere_leg = ((sb - 1) // 3).clip(0, 3)
    sphere_mask = _ancestor_mask()[sb]
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
        sphere_body=i(sb),
        sphere_ancestor_mask=f(sphere_mask),
        sphere_offset=f(D.SPHERE_OFFSET),
        sphere_radius=f(D.SPHERE_RADIUS),
        foot_sphere_idx=np.asarray(D.FOOT_SPHERE_IDX),
        sphere_leg=i(sphere_leg),
        sphere_leg_mask=f(sphere_mask.reshape(ns, 4, 3)[np.arange(ns), sphere_leg]),
        sphere_to_body=f(_one_hot(sb, D.NUM_BODIES)),
        sphere_to_report=f(_one_hot(D.SPHERE_REPORT, D.NUM_REPORT_BODIES)),
        level_dofs=i(np.asarray(LEVEL_BODIES) - 1),
        level_bodies=i(LEVEL_BODIES),
        stack_to_body=i(STACK_TO_BODY),
        leg_tril=f(LEG_TRIL),
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
