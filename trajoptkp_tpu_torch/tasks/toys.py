"""Toy tasks: acrobot and pentabot (counterpart of
`trajoptkp_tpu/tasks/toys.py:23-127`).

Residuals are per-joint position error, per-joint velocity error and
per-actuator control: the joint-space residual, whose CUDA twin is
`joint_space_residual` in kernels/csrc/residuals.cuh.  Acrobot is complete
when its joints are within 0.01 (summed) of the goal; pentabot has no
completion test, as in JAX.
"""

from __future__ import annotations

import functools

import torch

from ..dynamics.model import load_model
from ..keypoints.methods import KeypointConfig
from ..state.statevector import full_state_vector
from ..utils.device import resolve_device
from .base import Task


def joint_space_residual(nj: int, nu: int, qpos, qvel, ctrl, targets):
    """[q_i - tq_i]*nj, [v_i - tv_i]*nj, [u_i - tu_i]*nu; targets laid out
    as [pos (nj), vel (nj), ctrl (nu)] (Acrobot::Residuals).  `nu` counts
    the control terms of the residual, which may be fewer than the model's
    actuators (none in reaching)."""
    return torch.cat([
        qpos[:nj] - targets[:nj],
        qvel[:nj] - targets[nj:2 * nj],
        ctrl[:nu] - targets[2 * nj:2 * nj + nu],
    ])


def joint_space_complete(nj: int, qpos, targets):
    """Done when sum_i |q_i - tq_i| over the first nj joints is below 0.01
    (JAX `tasks/toys.py:35-38`) -> (done, distance) over the lanes."""
    d = (qpos[:nj] - targets[:nj]).abs()
    dist = d[0]
    for i in range(1, nj):
        dist = dist + d[i]
    return dist < 0.01, dist


def _joint_space_task(name, model, nj, nu, residual_names, targets, w, w_term,
                      qpos_start, kp_cfg, complete: bool):
    f64 = dict(dtype=model.dtype, device=model.device)
    return Task(
        name=name,
        residual_names=residual_names,
        residual_fn=functools.partial(joint_space_residual, nj, nu),
        residual_kind=("joint_space", nj, nu),
        model=model,
        sv=full_state_vector(model),
        residual_targets=torch.tensor(targets, **f64),
        weights=torch.tensor(w, **f64),
        weights_terminal=torch.tensor(w_term, **f64),
        qpos_start=torch.tensor(qpos_start, **f64),
        qvel_start=torch.zeros(nj, **f64),
        keypoint_cfg=kp_cfg,
        task_complete_fn=(functools.partial(joint_space_complete, nj)
                          if complete else None),
        openloop_horizon=500,
        mpc_horizon=100,
    )


def make_acrobot(device=None) -> Task:
    """Acrobot (reference Acrobot.cpp + TaskConfigs/toys/acrobot.yaml),
    scene TestTasks/acrobot/0.csv: start [0.248245, 2.08504], goal [pi, 0]."""
    device = resolve_device(device)
    model = load_model("acrobot", device=device)
    f64 = dict(dtype=model.dtype, device=device)
    return _joint_space_task(
        "acrobot", model, 2, 1,
        ("joint_0", "joint_1", "joint_0_vel", "joint_1_vel",
         "joint_0_torque"),
        [3.14152, 0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.001, 0.001, 100.0],
        [100.0, 100.0, 1.0, 1.0, 100.0],
        [0.248245, 2.08504],
        KeypointConfig(
            name="velocity_change", min_N=1, max_N=100,
            jerk_thresholds=torch.full((2,), 150.0, **f64),
            accel_thresholds=torch.full((2,), 150.0, **f64),
            velocity_change_thresholds=torch.full((2,), 6.0, **f64),
        ),
        complete=True,
    )


def make_pentabot(device=None) -> Task:
    """Pentabot: 5-link chain, joints 1-3 actuated, with the model's six
    capsule-capsule pairs between non-adjacent links (0-2, 0-3, 0-4, 1-3,
    1-4, 2-4), as JAX `make_pentabot`: a folded chain touches itself and
    the contact rows (K2b) enter the step."""
    device = resolve_device(device)
    model = load_model("pentabot", device=device)
    nj, nu = 5, 3
    f64 = dict(dtype=model.dtype, device=device)
    return _joint_space_task(
        "pentabot", model, nj, nu,
        tuple([f"joint_{i}" for i in range(nj)]
              + [f"joint_{i}_vel" for i in range(nj)]
              + [f"torque_{i}" for i in range(nu)]),
        [0.0] * (2 * nj + nu),
        [0.0] * nj + [0.001] * nj + [0.2] * nu,
        [100.0] * nj + [1.0] * nj + [0.2] * nu,
        [3.1415, 0.0, 0.0, 0.0, 0.0],
        KeypointConfig(
            name="set_interval", min_N=1, max_N=10,
            jerk_thresholds=torch.full((nj,), 0.001, **f64),
            accel_thresholds=torch.full((nj,), 0.001, **f64),
            velocity_change_thresholds=torch.full((nj,), 0.2, **f64),
        ),
        complete=False,       # as JAX make_pentabot: no completion test
    )
