"""Task: model + state vector + residual cost (counterpart of
`trajoptkp_tpu/tasks/base.py`).

Cost c = sum_i w_i r_i^2 per step, terminal weights at t = H-1; the cost
expansion is Gauss-Newton from residual Jacobians.  A task's residual exists
twice: as the plain torch function `residual_fn` and as a CUDA device
function of the same name for the kernels; `residual_kind` names it and its
static sizes: ("joint_space", nj, nr) is position and velocity errors of the
first nj joints and nr control terms, nres = 2 nj + nr (reaching has nr = 0
although its arm has seven actuators); ("push", n_obstacles, goal body, ee
site) is the pushing tasks' FK residual (tasks/pushing.py), read from
forward kinematics of the state, with the goal xy as its targets;
("sweep", box body, ee site) and ("tilt_push", box body, ee site) are the
box tasks' (tasks/manipulation.py: box_sweep, with the goal xy and
velocity as its targets, and threeD_push, with the goal xy).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..dynamics.model import Model
from ..keypoints.methods import KeypointConfig
from ..state.statevector import StateVector, apply_tangent


@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    residual_names: Tuple[str, ...]
    # residual_fn(qpos (nq,*L), qvel, ctrl, targets (nres,*L)) -> (nres,*L)
    residual_fn: Callable
    residual_kind: Tuple
    model: Model
    sv: StateVector
    residual_targets: torch.Tensor     # (nres,)
    weights: torch.Tensor              # (nres,)
    weights_terminal: torch.Tensor     # (nres,)
    qpos_start: torch.Tensor           # (nq,)
    qvel_start: torch.Tensor           # (nv,)
    keypoint_cfg: Optional[KeypointConfig] = None
    # task_complete_fn(qpos (nq,*L), targets (nres,*L)) -> (done, distance)
    task_complete_fn: Optional[Callable] = None
    # init_controls_fn(task, H, qpos (nq, B), qvel (nv, B), targets) ->
    # (qpos, qvel, U (H, nu, B)): the solve's start and initial controls
    # (setup and init servo of the pushing tasks); None = zero controls
    init_controls_fn: Optional[Callable] = None
    openloop_horizon: int = 500
    mpc_horizon: int = 100

    @property
    def nres(self) -> int:
        return len(self.residual_names)

    def replace(self, **changes) -> "Task":
        return dataclasses.replace(self, **changes)


def residuals_at(task: Task, qpos, qvel, ctrl, targets=None) -> torch.Tensor:
    """Residuals at a bare state; targets default to the task's."""
    if targets is None:
        targets = task.residual_targets.reshape(
            (-1,) + (1,) * (qpos.dim() - 1))
    return task.residual_fn(qpos, qvel, ctrl, targets)


def residual_derivatives(task: Task, qpos, qvel, ctrl):
    """r (nres,), r_x (nres, 2n), r_u (nres, nu) at one state, exact
    forward-mode Jacobians on the tangent space."""
    model, sv = task.model, task.sv
    zero = torch.zeros(sv.nx, dtype=qpos.dtype, device=qpos.device)

    def res_x(dx):
        qp, qv = apply_tangent(model, sv, qpos, qvel, dx)
        return residuals_at(task, qp, qv, ctrl)

    def res_u(u):
        return residuals_at(task, qpos, qvel, u)

    r = res_x(zero)
    r_x = torch.func.jacfwd(res_x)(zero)
    r_u = torch.func.jacfwd(res_u)(ctrl)
    return r, r_x, r_u


def cost_derivatives_gn(task: Task, r, r_x, r_u, terminal: bool):
    """l_x = 2 w r r_x, l_xx = 2 w r_x r_x^T, l_u = 2 w r r_u,
    l_uu = 2 w r_u r_u^T."""
    w = task.weights_terminal if terminal else task.weights
    l_x = 2.0 * torch.einsum("i,i,ij->j", w, r, r_x)
    l_xx = 2.0 * torch.einsum("i,ij,ik->jk", w, r_x, r_x)
    l_u = 2.0 * torch.einsum("i,i,ij->j", w, r, r_u)
    l_uu = 2.0 * torch.einsum("i,ij,ik->jk", w, r_u, r_u)
    return l_x, l_xx, l_u, l_uu


def control_limits(task: Task) -> torch.Tensor:
    """(nu, 2) lower/upper ctrl bounds; (-inf, inf) where ctrllimited is
    false (MuJoCo stores (0, 0) there)."""
    model = task.model
    lim = model.actuator_ctrlrange.clone()
    for a, limited in enumerate(model.actuator_ctrllimited):
        if not limited:
            lim[a, 0] = -float("inf")
            lim[a, 1] = float("inf")
    return lim
