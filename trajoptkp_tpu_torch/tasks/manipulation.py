"""Box manipulation (counterpart of `trajoptkp_tpu/tasks/manipulation.py`,
`make_box_sweep` and `make_threed_push`): the panda with its pusher rod on
a table moves a free box.

The scenes are the JAX tasks' `_panda_scene` with one box on a free joint,
carried as `models/box_sweep.npz` and `models/threeD_push.npz`; three
contact pairs in the model's order, table-pusher (plane-cylinder, 3
slots), table-box (plane-box, 4) and pusher-box (cylinder-box, 2).  nq 14,
nv 13, nu 7; the state vector is the seven arm joints and all six dofs of
the box (ndof 13, nx 26): its rotations too, whose tangent is the
quaternion's q * exp(dz) (`dynamics/integrate.py`).

- box_sweep (`BoxSweep.cpp`, box_sweep.yaml): sweep a large heavy box
  (half-sizes 0.15, 0.1, 0.06, 2 kg) to a goal; residuals
  [|box_xy - t01|, |box planar velocity - t23|, |ee - box|], each a square
  root of a sum of squares plus 1e-12, targets (4,) [x, y, vx, vy].  Its
  kind is ("sweep", box body, ee site).  Its own keypoint method is
  adaptive_jerk (AJ_1_1000), H 1500.
- threeD_push (`ThreeDPushing.cpp`, threeD_push.yaml): push a small box
  that can topple; residuals [box_x - tx, box_y - ty, vx, vy, tilt_x,
  tilt_y, |ee - box|] with the tilt [2 (x z + w y), 2 (y z - w x)] the
  planar part of the box's z axis from its quaternion, targets (2,).  Its
  kind is ("tilt_push", box body, ee site).  Its own method is
  set_interval (min_N 1), H 1000.

Each residual exists as a plain function and in closed form with its
Jacobian on the tangent space (the twin of kernels/csrc/cost_expansion.cu:
`sweep_jacobian`, `tilt_push_jacobian`), operation for operation as the
kernel.  Init controls are the pushing tasks' end-effector servo over the
horizon from the scene's start (`tasks/pushing.py:jacobian_ee_init_controls`);
these tasks have no setup servo (the JAX app's `_prepare_start`).  Scenes
are the JAX CLI's generic ones (`app.py:_generate_scenes`): the arm's seven
joints at qpos_start + 0.2 N(0, 1), the box at its default pose, the
targets + 0.1 N(0, 1), from a numpy seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dynamics.fk import body_frames, site_pose
from ..dynamics.model import FREE, load_model
from ..keypoints.methods import KeypointConfig
from ..state.statevector import state_vector_from_names
from ..utils import math as tm
from ..utils.device import resolve_device
from .base import Task
from .pushing import _norm, _path_dofs, jacobian_ee_init_controls

NJ = 7
ARM_START = (0.0, -0.183, 0.0, -3.1, 0.0, 1.34, 0.0)
SCENE_ARM_STD = 0.2
SCENE_TARGET_STD = 0.1


def _terms(model, goal_body: int, ee_site: int, qpos):
    """FK products of the residuals: cdof, the box origin, its quaternion,
    the end effector, the box's first dof."""
    xpos, xquat, cdof = body_frames(model, qpos)
    ee, _ = site_pose(model, xpos, xquat, ee_site)
    gd = model.jnt_dofadr[model.jnt_bodyid.index(goal_body)]
    return cdof, xpos[goal_body], xquat[goal_body], ee, gd


def sweep_residual(model, goal_body: int, ee_site: int, qpos, qvel, ctrl,
                   targets):
    """box_sweep: [|box_xy - t01|, |box planar velocity - t23|, |ee - box|]
    (nres 3), targets (4, *L)."""
    return _sweep(model, goal_body, ee_site, qpos, qvel, targets)[0]


def _sweep(model, goal_body, ee_site, qpos, qvel, targets):
    cdof, goal, _, ee, gd = _terms(model, goal_body, ee_site, qpos)
    g = [goal[0] - targets[0], goal[1] - targets[1]]
    gv = [qvel[gd] - targets[2], qvel[gd + 1] - targets[3]]
    d = [ee[0] - goal[0], ee[1] - goal[1], ee[2] - goal[2]]
    r = torch.stack([_norm(g), _norm(gv), _norm(d)])
    return r, (cdof, goal, ee, gd, g, gv, d)


def tilt(q):
    """The planar part of a body's z axis from its quaternion (4, *L):
    [2 (x z + w y), 2 (y z - w x)]."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return 2 * (x * z + w * y), 2 * (y * z - w * x)


def tilt_push_residual(model, goal_body: int, ee_site: int, qpos, qvel,
                       ctrl, targets):
    """threeD_push: [box_x - tx, box_y - ty, vx, vy, tilt_x, tilt_y,
    |ee - box|] (nres 7), targets (2, *L)."""
    return _tilt_push(model, goal_body, ee_site, qpos, qvel, targets)[0]


def _tilt_push(model, goal_body, ee_site, qpos, qvel, targets):
    cdof, goal, quat, ee, gd = _terms(model, goal_body, ee_site, qpos)
    d = [ee[0] - goal[0], ee[1] - goal[1], ee[2] - goal[2]]
    tx, ty = tilt(quat)
    r = torch.stack([goal[0] - targets[0], goal[1] - targets[1], qvel[gd],
                     qvel[gd + 1], tx, ty, _norm(d)])
    return r, (cdof, goal, quat, ee, gd, d)


def _point_rates(model, cdof, j, on_goal, on_ee, goal, ee, zero):
    """dp/dq_j = w_j x p + v_j of the box origin and the end effector (0
    off their root paths)."""
    w, v = cdof[j][:3], cdof[j][3:]
    pg = tm.cross(w, goal) + v if j in on_goal else [zero] * 3
    pe = tm.cross(w, ee) + v if j in on_ee else [zero] * 3
    return pg, pe


def quat_rate(q, k: int):
    """d/dz_k of q * exp(z) at z = 0 (the free rotation's tangent), 0.5 q
    (0, e_k): k = 0 (-x, w, z, -y), 1 (-y, -z, w, x), 2 (-z, y, -x, w),
    each times 0.5."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    rows = ((-x, w, z, -y), (-y, -z, w, x), (-z, y, -x, w))[k]
    return [0.5 * c for c in rows]


def sweep_residual_jacobian(model, goal_body: int, ee_site: int, sv,
                            nu: int, qpos, qvel, targets):
    """r (3, *L) and J (3, 2n + nu, *L) of the box_sweep residual on the
    tangent space, in closed form (kernels/csrc/cost_expansion.cu:
    sweep_jacobian).  A point fixed on a body moves with dof j at
    w_j x p + v_j: the box origin with its translations (its rotations
    turn it about itself: w x p + p x w, exactly 0), the end effector with
    the arm's hinges; d|x|/dx = x / |x|.  No control column."""
    r, (cdof, goal, ee, gd, g, gv, d) = _sweep(model, goal_body, ee_site,
                                               qpos, qvel, targets)
    n = sv.ndof
    zero = torch.zeros_like(r[0])
    J = [[zero] * (2 * n + nu) for _ in range(3)]
    on_goal = _path_dofs(model, goal_body)
    on_ee = _path_dofs(model, model.site_bodyid[ee_site])
    for s, j in enumerate(sv.order):
        if j in on_goal or j in on_ee:
            pg, pe = _point_rates(model, cdof, j, on_goal, on_ee, goal, ee,
                                  zero)
            J[0][s] = (g[0] * pg[0] + g[1] * pg[1]) / r[0]
            J[2][s] = (d[0] * (pe[0] - pg[0]) + d[1] * (pe[1] - pg[1])
                       + d[2] * (pe[2] - pg[2])) / r[2]
        if j == gd:
            J[1][n + s] = gv[0] / r[1]
        elif j == gd + 1:
            J[1][n + s] = gv[1] / r[1]
    return r, torch.stack([torch.stack(row) for row in J])


def tilt_push_residual_jacobian(model, goal_body: int, ee_site: int, sv,
                                nu: int, qpos, qvel, targets):
    """r (7, *L) and J (7, 2n + nu, *L) of the threeD_push residual in
    closed form (kernels/csrc/cost_expansion.cu:tilt_push_jacobian): the
    box's xy rates and the reach as in `sweep_residual_jacobian`, 1 at the
    box's planar velocity columns, and the tilt through the box rotation's
    tangent, dq/dz_k = 0.5 q (0, e_k) (`quat_rate`; q is the unit body
    quaternion of FK, so the normalisation's derivative drops out)."""
    r, (cdof, goal, quat, ee, gd, d) = _tilt_push(model, goal_body, ee_site,
                                                  qpos, qvel, targets)
    n = sv.ndof
    zero = torch.zeros_like(r[0])
    J = [[zero] * (2 * n + nu) for _ in range(7)]
    on_goal = _path_dofs(model, goal_body)
    on_ee = _path_dofs(model, model.site_bodyid[ee_site])
    w, x, y, z = quat[0], quat[1], quat[2], quat[3]
    for s, j in enumerate(sv.order):
        if j in on_goal or j in on_ee:
            pg, pe = _point_rates(model, cdof, j, on_goal, on_ee, goal, ee,
                                  zero)
            J[0][s] = pg[0]
            J[1][s] = pg[1]
            J[6][s] = (d[0] * (pe[0] - pg[0]) + d[1] * (pe[1] - pg[1])
                       + d[2] * (pe[2] - pg[2])) / r[6]
        if gd + 3 <= j < gd + 6:
            dw, dx, dy, dz = quat_rate(quat, j - gd - 3)
            J[4][s] = 2 * ((dx * z + x * dz) + (dw * y + w * dy))
            J[5][s] = 2 * ((dy * z + y * dz) - (dw * x + w * dx))
        if j == gd:
            J[2][n + s] = torch.ones_like(zero)
        elif j == gd + 1:
            J[3][n + s] = torch.ones_like(zero)
    return r, torch.stack([torch.stack(row) for row in J])


def _complete_fn(model, goal_body, tol: float):
    """Done when the box's xy is within `tol` of the target; the box hangs
    from the world on a free joint, so its position is its qpos."""
    j = model.jnt_bodyid.index(goal_body)
    if model.jnt_type[j] != FREE or model.body_parent[goal_body] != 0:
        raise ValueError("the box must be a free body of the world")
    qa = model.jnt_qposadr[j]

    def done(qpos, targets):
        d = _norm([qpos[qa] - targets[0], qpos[qa + 1] - targets[1]])
        return d < tol, d
    return done


def init_controls(task: Task, H: int, qpos0, qvel0, targets):
    """The end-effector servo over H from the scene's start, no setup servo
    (JAX `app.py:_prepare_start`: these tasks have no setup_controls_fn):
    qpos0 (nq, B), qvel0 (nv, B), targets (ntgt, B) -> (qpos0, qvel0, U
    (H, nu, B))."""
    return qpos0, qvel0, jacobian_ee_init_controls(task, H, qpos0, qvel0,
                                                   targets)


def _make(name: str, kind: str, residual, nres_names, targets, weights,
          weights_terminal, keypoint_cfg, horizon, mpc_horizon, tol,
          device):
    device = resolve_device(device)
    model = load_model(name, device=device)
    f64 = dict(dtype=model.dtype, device=device)
    goal_body = model.body_names.index("goal")
    ee_site = model.site_names.index("ee")
    names = list(model.joint_names[:NJ]) + [
        f"goal_{t}_{a}" for t in ("lin", "ang") for a in "xyz"]
    sv = state_vector_from_names(model, names)
    qpos_start = model.qpos0.clone()
    qpos_start[:NJ] = torch.tensor(ARM_START, **f64)

    def residual_fn(qpos, qvel, ctrl, tg):
        return residual(model, goal_body, ee_site, qpos, qvel, ctrl, tg)

    return Task(
        name=name, residual_names=nres_names, residual_fn=residual_fn,
        residual_kind=(kind, goal_body, ee_site), model=model, sv=sv,
        residual_targets=torch.tensor(targets, **f64),
        weights=torch.tensor(weights, **f64),
        weights_terminal=torch.tensor(weights_terminal, **f64),
        qpos_start=qpos_start, qvel_start=torch.zeros(model.nv, **f64),
        keypoint_cfg=keypoint_cfg(sv.ndof, f64),
        task_complete_fn=_complete_fn(model, goal_body, tol),
        init_controls_fn=init_controls, openloop_horizon=horizon,
        mpc_horizon=mpc_horizon)


def make_box_sweep(device=None) -> Task:
    """box_sweep: `make_box_sweep` of the JAX package."""
    def kp(ndof, f64):
        return KeypointConfig(
            name="adaptive_jerk", min_N=1, max_N=1000,
            jerk_thresholds=torch.full((ndof,), 10.0, **f64),
            accel_thresholds=torch.full((ndof,), 10.0, **f64),
            velocity_change_thresholds=torch.full((ndof,), 0.1, **f64))
    return _make("box_sweep", "sweep", sweep_residual,
                 ("goal_pos", "goal_vel", "reach"), (0.9, 0.4, 0.0, 0.0),
                 (0.0, 0.1, 0.01), (1000.0, 10.0, 0.01), kp, 1500, 50, 0.05,
                 device)


def make_threed_push(device=None) -> Task:
    """threeD_push: `make_threed_push` of the JAX package."""
    def kp(ndof, f64):
        return KeypointConfig(
            name="set_interval", min_N=1, max_N=20,
            jerk_thresholds=torch.cat([
                torch.full((NJ,), 0.002, **f64),
                torch.full((ndof - NJ,), 0.0005, **f64)]),
            accel_thresholds=torch.full((ndof,), 10.0, **f64),
            velocity_change_thresholds=torch.full((ndof,), 0.1, **f64))
    return _make("threeD_push", "tilt_push", tilt_push_residual,
                 ("goal_x", "goal_y", "goal_vx", "goal_vy", "tilt_x",
                  "tilt_y", "reach"), (0.7, 0.0),
                 (0.0, 0.0, 0.1, 0.1, 1.0, 1.0, 0.01),
                 (100.0, 100.0, 0.0, 0.0, 0.0, 0.0, 0.01), kp, 1000, 100,
                 0.03, device)


def box_scenes(task: Task, B: int, seed: int = 0):
    """B scenes of the JAX CLI's generic generator (`app.py:312-320`), from
    a numpy seed: per scene the arm's min(nu, nq) joints at qpos_start +
    0.2 N(0, 1), then the targets + 0.1 N(0, 1); the box at its default
    pose, zero qvel -> qpos (B, nq), qvel (B, nv), targets (B, ntgt)."""
    rng = np.random.default_rng(seed)
    model = task.model
    qp = np.tile(task.qpos_start.cpu().numpy(), (B, 1))
    tg0 = task.residual_targets.cpu().numpy()
    tg = np.zeros((B, tg0.shape[0]))
    n_rj = min(model.nu, model.nq)
    for i in range(B):
        qp[i, :n_rj] += SCENE_ARM_STD * rng.standard_normal(n_rj)
        tg[i] = tg0 + SCENE_TARGET_STD * rng.standard_normal(tg0.shape)
    f64 = dict(dtype=model.dtype, device=model.device)
    return (torch.as_tensor(qp, **f64), torch.zeros((B, model.nv), **f64),
            torch.as_tensor(tg, **f64))
