"""Non-prehensile pushing without clutter (counterpart of
`trajoptkp_tpu/tasks/pushing.py`, `make_pushing(0)`): the panda pushes a
free cylinder across a table to a goal.

The scene is `build_push_scene_xml(0)` of the JAX task, carried as
`models/push_ncl.npz`: panda with a pusher rod (cylinder, r 0.01) on its
hand, a table plane and the goal cylinder (r 0.05, half-height 0.03) on a
free joint; three contact pairs, table-pusher and table-goal
(plane-cylinder, 3 slots each) and pusher-goal (cylinder-cylinder, 1 slot).
nq 14, nv 13, nu 7; the state vector is the seven arm joints and the goal's
three translations (ndof 10, nx 20).

Residuals (`TwoDPushing.cpp:291-356`): goal xy distance to the target,
goal planar speed, joint-5 velocity and end-effector-to-goal distance, each
a square root of a sum of squares plus 1e-12 read from forward kinematics
(the FK residual, whose CUDA twin is `push_residual` in
kernels/csrc/residuals.cuh).  Its kind is ("push", 0, goal body, ee
site): no obstacles, and the body and site the residual reads.

Init controls are the JAX task's Jacobian-pseudo-inverse servo of the
end-effector along a straight path (`PushBaseClass.cpp:8-248`): a setup
servo of 1000 steps behind the object, then the init servo over the
horizon.  The control law (end-effector pose and error, pinv of the 6x7
Jacobian) is batched torch over the scenes; its FK products and bias force
come from one launch of the step's device function (`ops.fk_bias`) and the
dynamics step is kernel K3 at H = 1 on the card (their plain twins on the
CPU).  The task's own keypoint method is adaptive_jerk.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..dynamics.fk import body_frames, site_pose
from ..dynamics.model import FREE, load_model
from ..keypoints.methods import KeypointConfig
from ..state.statevector import state_vector_from_names
from ..utils import math as tm
from ..utils.device import resolve_device
from .base import Task

NJ = 7                  # panda joints lead qpos and qvel
JOINT5 = 5              # the JAX task's joint5_dadr
TARGET = (0.7, -0.1)
GOAL_START = (0.5, 0.1)
OBJECT_R = 0.05         # goal cylinder radius
SERVO_GAINS = (100.0, 100.0, 200.0, 80.0, 80.0, 80.0)
SETUP_STEPS = 1000


def _norm(parts):
    """sqrt(sum of squares, left to right, + 1e-12), as the kernel."""
    s = parts[0] * parts[0]
    for p in parts[1:]:
        s = s + p * p
    return torch.sqrt(s + 1e-12)


def _push_terms(model, goal_body: int, ee_site: int, qpos, qvel, targets):
    """The residual (4, *L) and the FK products and differences it is made
    of, for its Jacobian."""
    xpos, xquat, cdof = body_frames(model, qpos)
    goal = xpos[goal_body]
    ee, _ = site_pose(model, xpos, xquat, ee_site)
    gd = model.jnt_dofadr[model.jnt_bodyid.index(goal_body)]
    g = [goal[0] - targets[0], goal[1] - targets[1]]
    gv = [qvel[gd], qvel[gd + 1]]
    d = [ee[0] - goal[0], ee[1] - goal[1], ee[2] - goal[2]]
    r = torch.stack([_norm(g), _norm(gv), qvel[JOINT5], _norm(d)])
    return r, (cdof, goal, ee, gd, g, gv, d)


def push_residual(model, goal_body: int, ee_site: int, qpos, qvel, ctrl,
                  targets):
    """r = [|goal_xy - target|, |goal planar velocity|, joint-5 velocity,
    |ee - goal|] (nres 4), targets (2, *L) the goal xy."""
    return _push_terms(model, goal_body, ee_site, qpos, qvel, targets)[0]


def _path_dofs(model, b: int) -> set:
    """The dofs on body b's root path (its own included)."""
    out = set()
    while b > 0:
        for j, jb in enumerate(model.jnt_bodyid):
            if jb == b:
                nd = 6 if model.jnt_type[j] == FREE else 1
                da = model.jnt_dofadr[j]
                out.update(range(da, da + nd))
        b = model.body_parent[b]
    return out


def push_residual_jacobian(model, goal_body: int, ee_site: int, sv, nu: int,
                           qpos, qvel, targets):
    """The pushing residual r (4, *L) and its Jacobian J (4, 2n + nu, *L) on
    the tangent space of the state vector sv (positions, velocities,
    controls), in closed form from the FK products, operation for operation
    as kernels/csrc/cost_expansion.cu:push_jacobian.

    A point p fixed on body b moves with a dof j of b's root path at
    dp/dq_j = w_j x p + v_j, (w_j, v_j) = cdof_j: a x (p - anchor) for a
    hinge, the axis for a slide or a free joint's translation, 0 for a free
    joint's rotation about the body's own origin.  The goal is the free
    body's origin, so only its translations move it; the end effector moves
    with the arm's hinges.  d|x|/dx = x / |x| for the three norms (their
    1e-12 kept in |x|); joint 5's velocity and the goal's planar velocity
    are velocity columns.  No control column: l_u = l_uu = 0."""
    r, (cdof, goal, ee, gd, g, gv, d) = _push_terms(
        model, goal_body, ee_site, qpos, qvel, targets)
    n = sv.ndof
    zero = torch.zeros_like(r[0])
    J = [[zero] * (2 * n + nu) for _ in range(4)]
    on_goal = _path_dofs(model, goal_body)
    on_ee = _path_dofs(model, model.site_bodyid[ee_site])
    for s, j in enumerate(sv.order):
        if j in on_goal or j in on_ee:
            w, v = cdof[j][:3], cdof[j][3:]
            pg = tm.cross(w, goal) + v if j in on_goal else [zero] * 3
            pe = tm.cross(w, ee) + v if j in on_ee else [zero] * 3
            J[0][s] = (g[0] * pg[0] + g[1] * pg[1]) / r[0]
            J[3][s] = (d[0] * (pe[0] - pg[0]) + d[1] * (pe[1] - pg[1])
                       + d[2] * (pe[2] - pg[2])) / r[3]
        if j == gd:
            J[1][n + s] = gv[0] / r[1]
        elif j == gd + 1:
            J[1][n + s] = gv[1] / r[1]
        if j == JOINT5:
            J[2][n + s] = torch.ones_like(zero)
    return r, torch.stack([torch.stack(row) for row in J])


def _complete_fn(model, goal_body):
    """Done when the goal's xy is within 0.025 of the target.  The goal
    hangs from the world on a free joint, so its world position is its
    joint's qpos (what FK gives for it, without the FK)."""
    j = model.jnt_bodyid.index(goal_body)
    if model.jnt_type[j] != FREE or model.body_parent[goal_body] != 0:
        raise ValueError("the goal must be a free body of the world")
    qa = model.jnt_qposadr[j]

    def done(qpos, targets):
        d = _norm([qpos[qa] - targets[0], qpos[qa + 1] - targets[1]])
        return d < 0.025, d
    return done


def make_pushing(device=None) -> Task:
    """push_ncl: `make_pushing(0)` of the JAX package."""
    device = resolve_device(device)
    model = load_model("push_ncl", device=device)
    f64 = dict(dtype=model.dtype, device=device)
    goal_body = model.body_names.index("goal")
    ee_site = model.site_names.index("ee")
    names = list(model.joint_names[:NJ]) + [
        f"goal_lin_{a}" for a in "xyz"]
    sv = state_vector_from_names(model, names)
    qpos_start = model.qpos0.clone()
    qpos_start[:NJ] = torch.tensor(
        [0, -0.5763, 0, -2.7099, 0, 2.1309, 0], **f64)

    def residual_fn(qpos, qvel, ctrl, targets):
        return push_residual(model, goal_body, ee_site, qpos, qvel, ctrl,
                             targets)

    ndof = sv.ndof
    return Task(
        name="push_ncl",
        residual_names=("goal_pos", "goal_vel", "joint_5_velocity", "reach"),
        residual_fn=residual_fn,
        residual_kind=("push", 0, goal_body, ee_site),
        model=model,
        sv=sv,
        residual_targets=torch.tensor(TARGET, **f64),
        weights=torch.tensor([0.0, 0.2, 0.1, 0.01], **f64),
        weights_terminal=torch.tensor([1000.0, 10.0, 0.1, 0.01], **f64),
        qpos_start=qpos_start,
        qvel_start=torch.zeros(model.nv, **f64),
        keypoint_cfg=KeypointConfig(
            name="adaptive_jerk", min_N=1, max_N=100,
            jerk_thresholds=torch.cat([torch.full((NJ,), 10.0, **f64),
                                       torch.ones(ndof - NJ, **f64)]),
            accel_thresholds=torch.full((ndof,), 10.0, **f64),
            velocity_change_thresholds=torch.full((ndof,), 0.1, **f64),
        ),
        task_complete_fn=_complete_fn(model, goal_body),
        init_controls_fn=init_controls,
        openloop_horizon=1000,
        mpc_horizon=50,
    )


# ---------------------------------------------------------------------------
# scenes: TwoDPushing::ReturnRandomStartState without clutter
# ---------------------------------------------------------------------------


def scene(rng: np.random.Generator):
    """One no-clutter scene (JAX `_make_push_scene_generator(False, 0)`):
    object start (0.42, U(-0.05, 0.05)), goal 0.28-0.3 m away within 45
    degrees -> (object xy, target xy)."""
    start_x = 0.42
    start_y = rng.uniform(-0.05, 0.05)
    ang = rng.uniform(-np.pi / 4, np.pi / 4)
    dist = rng.uniform(0.28, 0.3)
    return ((start_x, start_y),
            (start_x + dist * np.cos(ang), start_y + dist * np.sin(ang)))


def push_scenes(task: Task, B: int, seed: int = 0):
    """B scenes from a numpy seed: qpos (B, nq) with the arm at qpos_start
    and the goal upright at its sampled start (z 0.032), zero qvel, targets
    (B, 2)."""
    rng = np.random.default_rng(seed)
    model = task.model
    qa = model.jnt_qposadr[model.joint_names.index("goal")]
    qp = np.tile(task.qpos_start.cpu().numpy(), (B, 1))
    tg = np.zeros((B, 2))
    for i in range(B):
        (sx, sy), tg[i] = scene(rng)
        qp[i, qa:qa + 7] = (sx, sy, 0.032, 1.0, 0.0, 0.0, 0.0)
    f64 = dict(dtype=model.dtype, device=model.device)
    return (torch.as_tensor(qp, **f64), torch.zeros((B, model.nv), **f64),
            torch.as_tensor(tg, **f64))


# ---------------------------------------------------------------------------
# init controls: end-effector waypoints + Jacobian-pseudo-inverse servo,
# batched over scenes (lanes last)
# ---------------------------------------------------------------------------


def _ee_and_goal(task: Task, qpos):
    model = task.model
    xpos, xquat, _ = body_frames(model, qpos)
    ee, _ = site_pose(model, xpos, xquat, model.site_names.index("ee"))
    return ee, xpos[model.body_names.index("goal")]


def ee_waypoint_path(task: Task, horizon: int, qpos, targets):
    """EEWayPointsPush (`PushBaseClass.cpp:46-140`): straight line from the
    end-effector to a point behind the goal's push line at z 0.28, capped at
    0.1 m/s over 5/6 of the horizon -> path (horizon + 1, 3, B), angle (B,).
    The push target is targets[0:2] (box_sweep's targets carry the goal
    velocity after it)."""
    ee_start, goal = _ee_and_goal(task, qpos)
    targets = targets[:2]
    diff = targets - goal[:2]
    angle = torch.atan2(diff[1], diff[0])
    cyl_r = 0.01
    end_x = targets[0] - cyl_r * torch.cos(angle)
    end_y = torch.where(diff[1] > 0, targets[1] + cyl_r * torch.sin(angle),
                        targets[1] - cyl_r * torch.sin(angle))
    inter = goal[:2]
    max_dist = 0.1 * (5.0 / 6.0) * horizon * float(task.model.timestep)
    desired = torch.sqrt((end_x - inter[0]) ** 2 + (end_y - inter[1]) ** 2)
    prop = torch.clamp(max_dist / torch.clamp(desired, min=1e-9), max=1.0)
    end = torch.stack([inter[0] + (end_x - inter[0]) * prop,
                       inter[1] + (end_y - inter[1]) * prop,
                       torch.full_like(prop, 0.28)])
    return _line(ee_start, end, horizon), angle


def _line(start, end, horizon):
    ts = torch.arange(horizon + 1, dtype=start.dtype,
                      device=start.device)[:, None, None] / horizon
    return start[None] + ts * (end - start)[None]


def setup_path(task: Task, horizon: int, qpos, targets):
    """EEWayPointsSetup (`PushBaseClass.cpp:8-44`): to 0.05 m behind the
    object along the push line, z 0.28 -> path (horizon + 1, 3, B), angle."""
    ee_start, obj = _ee_and_goal(task, qpos)
    angle = torch.atan2(targets[1] - obj[1], targets[0] - obj[0])
    end = torch.stack([obj[0] - 0.05 * torch.cos(angle),
                       obj[1] - 0.05 * torch.sin(angle),
                       torch.full_like(angle, 0.28)])
    return _line(ee_start, end, horizon), angle


def servo_along_path(task: Task, path, angle, qpos0, qvel0, targets,
                     plain: bool = False):
    """JacobianEEControl (`PushBaseClass.cpp:139-248`, JAX
    `_servo_along_path`): per step u = pinv(J[:, :7]) (gains * err) +
    qfrc_bias[:7] / gear, err = [target - ee; log(desired ee quat)], then one
    step -> (U (H, nu, B), qpos_end, qvel_end).  The FK products and the
    bias force come from the step's own device function (`ops.fk_bias`) and
    the step is K3 at H = 1 (`ops.rollout`), their plain twins for tensors
    on the CPU or with `plain`; the rest of the law is batched torch."""
    from ..kernels import ops

    model = task.model
    dt = dict(dtype=model.dtype, device=model.device)
    ee_site = model.site_names.index("ee")
    mask = model.ancestor_mask[model.site_bodyid[ee_site]][:NJ]
    gains = torch.tensor(SERVO_GAINS, **dt)[:, None]
    gear = model.actuator_gear[:, 0][:, None]
    a = angle - math.pi / 4
    a = torch.where(a < -math.pi / 2, 2 * math.pi + a, a)
    x_axis = torch.stack([torch.cos(a), torch.sin(a), torch.zeros_like(a)])
    z_axis = torch.zeros_like(x_axis)
    z_axis[2] = -1.0
    y_axis = tm.cross(z_axis, x_axis)
    dq = tm.mat_to_quat(torch.stack([x_axis, y_axis, z_axis], 1))
    qpos, qvel = qpos0, qvel0
    nl = qpos.dim() - 1
    U = []
    for target in path.unbind(0):
        xpos, xquat, cdof, bias = ops.fk_bias(task, qpos.contiguous(),
                                              qvel.contiguous(), plain=plain)
        ee_pos, ee_mat = site_pose(model, xpos, xquat, ee_site)
        ee_quat = tm.mat_to_quat(ee_mat)
        flip = (ee_quat * dq).sum(0) < 0
        dq = torch.where(flip[None], -dq, dq)
        err = torch.cat([target - ee_pos,
                         tm.quat_log(tm.quat_mul(dq, tm.quat_conj(ee_quat)))])
        w, v = cdof[:NJ, :3], cdof[:NJ, 3:]                # (7, 3, *L)
        ee_b = ee_pos[None].expand_as(w)
        jacp = (v + torch.stack([w[:, 1] * ee_b[:, 2] - w[:, 2] * ee_b[:, 1],
                                 w[:, 2] * ee_b[:, 0] - w[:, 0] * ee_b[:, 2],
                                 w[:, 0] * ee_b[:, 1] - w[:, 1] * ee_b[:, 0]],
                                1))
        mk = mask.reshape((NJ, 1) + (1,) * nl)
        jac = torch.cat([jacp * mk, w * mk], 1)             # (7, 6, *L)
        J = jac.movedim(0, 1).movedim((0, 1), (-2, -1))    # (*L, 6, 7)
        e = (gains * err).movedim(0, -1)[..., None]        # (*L, 6, 1)
        u = (torch.linalg.pinv(J) @ e)[..., 0].movedim(-1, 0)
        u = u + bias[:NJ] / gear
        qps, qvs, _ = ops.rollout(task, qpos.contiguous(), qvel.contiguous(),
                                  u[None].contiguous(), targets.contiguous(),
                                  plain=plain)
        qpos, qvel = qps[1], qvs[1]
        U.append(u)
    return torch.stack(U), qpos, qvel


def create_init_setup_controls(task: Task, qpos0, qvel0, targets,
                               horizon: int = SETUP_STEPS):
    """CreateInitSetupControls (`TwoDPushing.cpp:225-258`): servo behind the
    object over `horizon` steps -> (U, qpos_end, qvel_end); the end state is
    the optimisation's start."""
    path, angle = setup_path(task, horizon, qpos0, targets)
    return servo_along_path(task, path[:horizon], angle, qpos0, qvel0,
                            targets)


def jacobian_ee_init_controls(task: Task, horizon: int, qpos0, qvel0,
                              targets):
    """JacobianEEControl along `ee_waypoint_path` -> U (horizon, nu, B)."""
    path, angle = ee_waypoint_path(task, horizon, qpos0, targets)
    U, _, _ = servo_along_path(task, path[:horizon], angle, qpos0, qvel0,
                               targets)
    return U


def init_controls(task: Task, H: int, qpos0, qvel0, targets):
    """The JAX app's `_batch_init_controls`: setup servo (1000 steps), then
    the init servo over H from the state it reaches.  Lanes last: qpos0
    (nq, B), qvel0 (nv, B), targets (2, B) -> (qpos (nq, B), qvel (nv, B),
    U (H, nu, B)), the solve's start and its initial controls."""
    _, qp, qv = create_init_setup_controls(task, qpos0, qvel0, targets)
    U = jacobian_ee_init_controls(task, H, qp, qv, targets)
    return qp, qv, U
