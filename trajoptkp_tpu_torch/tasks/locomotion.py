"""Planar walker locomotion, walker_walk and walker_run (counterpart of
`trajoptkp_tpu/tasks/locomotion.py`).

The model is `walker.xml` as `models/walker.npz`: a torso on three joints
(rootz and rootx slides, rooty hinge, in that order on one body) and two
legs of hip, knee and ankle hinges (six limited joints, six motors of range
+-1), seven capsules and a floor plane, 22 contact pairs (7 plane-capsule
with two slots each, 15 capsule-capsule with one); nq = nv = 9, nu = 6.

The residual (`Walker.cpp:59-88`) selects coordinates of the state and the
controls: torso height (rootz), torso angle (rooty), forward velocity
(rootx's qvel) and the six controls, each minus its target.  It is written
once, as the selection `WALKER_RESIDUAL`; the plain `walker_residual` reads
it here and the kernels read the same selection, packed into the task's
instance key (kernels/ops.py), through the device function
`select_residual` (kernels/csrc/residuals.cuh).

walker_uneven needs plane-box pairs (ROADMAP Queue 1 item 7b) and raises.
"""

from __future__ import annotations

import functools

import torch

from ..dynamics.model import load_model
from ..keypoints.methods import KeypointConfig
from ..state.statevector import full_state_vector
from ..utils.device import resolve_device
from .base import Task

NDOF = 9
NU = 6
# (source, index) per residual row: 0 qpos, 1 qvel, 2 ctrl (joint order
# rootz, rootx, rooty, then the legs, as walker.xml declares them)
WALKER_RESIDUAL = ((0, 0), (0, 2), (1, 1)) + tuple((2, a) for a in range(NU))


def select_residual(select, qpos, qvel, ctrl, targets):
    """r_k = x_k - target_k for the k-th selected coordinate x_k of (qpos,
    qvel, ctrl)."""
    src = (qpos, qvel, ctrl)
    return torch.stack([src[s][i] - targets[k]
                        for k, (s, i) in enumerate(select)])


walker_residual = functools.partial(select_residual, WALKER_RESIDUAL)


def walker_complete(qpos, targets):
    """Locomotion never completes (`Walker.cpp:27-30`, JAX `_complete_fn`):
    (False, distance 0) over the lanes."""
    return (torch.zeros_like(qpos[0], dtype=torch.bool),
            torch.zeros_like(qpos[0]))


def make_walker(run: bool = False, uneven: bool = False,
                device=None) -> Task:
    """walker_walk (target velocity 0.5) or walker_run (1.1); SI keypoints
    min_N 1, MPC horizon 40."""
    if uneven:
        raise NotImplementedError(
            "walker_uneven walks on a strip of boxes: plane-box pairs are "
            "ROADMAP Queue 1 item 7b (dynamics/box_collision.py)")
    device = resolve_device(device)
    model = load_model("walker", device=device)
    f64 = dict(dtype=model.dtype, device=device)
    target_vel = 1.1 if run else 0.5
    w = [1.0, 0.1, 0.1] + [0.0] * NU
    return Task(
        name="walker_run" if run else "walker_walk",
        residual_names=("body_height", "body_orientation", "body_velocity",
                        *(f"body_controls_{i}" for i in range(NU))),
        residual_fn=walker_residual,
        residual_kind=("select", WALKER_RESIDUAL),
        task_complete_fn=walker_complete,
        model=model,
        sv=full_state_vector(model),
        residual_targets=torch.tensor([0.0, 0.0, target_vel] + [0.0] * NU,
                                      **f64),
        weights=torch.tensor(w, **f64),
        weights_terminal=torch.tensor(w, **f64),
        qpos_start=torch.tensor([0.0, 0.0, 0.0, 1.0, -1.0, 0.2, 0.0, 0.0,
                                 0.0], **f64),
        qvel_start=torch.zeros(NDOF, **f64),
        keypoint_cfg=KeypointConfig(
            name="set_interval", min_N=1, max_N=20,
            jerk_thresholds=torch.full((NDOF,), 1e-15, **f64),
            accel_thresholds=torch.full((NDOF,), 1e-15, **f64),
            velocity_change_thresholds=torch.tensor(
                [0.1, 0.1, 0.01] + [1.0] * 6, **f64),
        ),
        openloop_horizon=500,
        mpc_horizon=40,
    )
