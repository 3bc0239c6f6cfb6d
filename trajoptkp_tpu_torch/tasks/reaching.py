"""Panda joint-space reaching (counterpart of
`trajoptkp_tpu/tasks/reaching.py`).

Residuals are the seven joint-position errors (weight 0.1, terminal 10) and
the seven joint velocities (0.01, terminal 1): the joint-space residual with
no control term, so l_uu = 0 and the backward pass leans on its λ.  All
seven hinges are limited; every step runs the joint-limit constraint solve
(dynamics/contact.py, kernels/csrc/constraint.cuh).  The task's own keypoint
method is velocity_change.
"""

from __future__ import annotations

import functools

import torch

from ..dynamics.model import load_model
from ..keypoints.methods import KeypointConfig
from ..state.statevector import full_state_vector
from ..utils.device import resolve_device
from .base import Task
from .toys import joint_space_residual

NJ = 7


def _complete_fn(qpos, targets):
    """Done within 0.05 rad of the goal in joint space, the proxy the JAX
    task uses for the reference's end-effector distance."""
    d = qpos[:NJ] - targets[:NJ]
    dist = torch.sqrt((d * d).sum(0))
    return dist < 0.05, dist


def make_reaching(device=None) -> Task:
    device = resolve_device(device)
    model = load_model("panda", device=device)
    f64 = dict(dtype=model.dtype, device=device)
    return Task(
        name="reaching",
        residual_names=tuple([f"EE_goal_{i}" for i in range(NJ)]
                             + [f"joint_velocities_{i}" for i in range(NJ)]),
        residual_fn=functools.partial(joint_space_residual, NJ, 0),
        residual_kind=("joint_space", NJ, 0),
        model=model,
        sv=full_state_vector(model),
        residual_targets=torch.tensor(
            [1.0, 0.5, 2.0, -1.4, 0.0, 0.6, 1.0] + [0.0] * NJ, **f64),
        weights=torch.tensor([0.1] * NJ + [0.01] * NJ, **f64),
        weights_terminal=torch.tensor([10.0] * NJ + [1.0] * NJ, **f64),
        qpos_start=torch.tensor([-1.0, 0.5, 0.0, -1.0, 0.0, 0.6, 1.0], **f64),
        qvel_start=torch.zeros(NJ, **f64),
        keypoint_cfg=KeypointConfig(
            name="velocity_change", min_N=1, max_N=50,
            jerk_thresholds=torch.full((NJ,), 10.0, **f64),
            accel_thresholds=torch.full((NJ,), 10.0, **f64),
            velocity_change_thresholds=torch.tensor(
                [2.0, 2.0, 2.0, 2.0, 0.5, 0.5, 0.5], **f64),
        ),
        task_complete_fn=_complete_fn,
        openloop_horizon=1500,
        mpc_horizon=50,
    )
