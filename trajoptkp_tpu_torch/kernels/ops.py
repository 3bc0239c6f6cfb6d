"""Kernel wrappers: the hand-written CUDA kernels for tensors on a CUDA
device, their plain PyTorch twins for tensors on the CPU.  `plain=True`
runs the twin on any device; chip_smoke.py uses it to hold each kernel
against its twin on the card.

A build or launch failure raises; there is no quiet fallback to the plain
version on the card.  Each wrapper adds one to `LAUNCHES[name]` where it
launches its kernel, so a run can show that its main path went through the
kernels.

The kernels cover trees whose bodies carry hinge and slide joints (several per
body), one free joint alone, or none, joint limits and plane-cylinder,
plane-capsule, capsule-capsule, cylinder-cylinder, plane-box, capsule-box and
cylinder-box contacts (the contact rows K2b, csrc/contact.cuh, and the
constraint solve K2a, csrc/constraint.cuh, device functions inside the step), a
state vector of hinge, slide and free-joint dofs (a free rotation's three
together), and the joint-space, the FK residuals of the pushing and box tasks
or the walker's selected-coordinate residual.  Their topology (sizes, per
body and per dof tables, state-vector dofs, residual kind, contact pairs) is
a struct of compile-time tables (kernels/topology.py), a template argument;
the instances built are listed in csrc/instances.cuh.  `cost_expansion` (K6)
is the Gauss-Newton cost expansion from the closed-form residual Jacobian (the FK residuals' from the step's FK,
`fk_frames`).  `mpc_apply` (K8) is the MPC replan's apply step. One more entry
point runs a device function of the step alone: `fk_bias` (the FK products and
bias force, for the pushing tasks' servo).

The keypoint kernels K9 take no model topology and are built once, with
the sizes as runtime arguments: `keypoint_plan` (K9a, csrc/keypoints.cu:
the adaptive keypoint selectors and the per-lane slot plan),
`kp_interp` (K9b, csrc/kp_interp.cu: the per-column gather and lerp of the
slot Jacobians to the full horizon) and `ie_mse` (K9c, csrc/kp_interp.cu:
the iterative_error bisection test).  The slot Jacobians, `ad_jacobian`
(K5ad: exact, the step in dual numbers with the constraint solve's
implicit tangent K2c, its Newton iterate and gated-Hessian factor from a
primal pass once per (slot, lane), `ad_primal_entries`, `ad_chunk`; every
lane path's) and `fd_jacobian` (K5: central FD; the generic solve's at
deriv_mode "fd"), take slot times shared by every lane, or per lane with
a live count, or per lane scattered into a full-horizon cache at their
times (iterative_error).  `linesearch` (K4) runs a warp per (alpha,
scene) lane over the cooperative step (csrc/warp_step.cuh) where the
model has constraint rows (`linesearch_geometry`).  `backward` (K7)
runs the JAX lane solver's coupled λ loop in 1 + bp_rounds launches, a
thread block per lane (a warp per lane up to nx 10, `backward_geometry`).
"""

from __future__ import annotations

import ctypes
import functools
import re
import threading
from typing import NamedTuple, Tuple

import torch

from ..derivs.ad import ad_lane_slots, ad_slot_jacobians
from ..derivs.fd import fd_lane_slots, fd_slot_jacobians
from ..dynamics.contact import (LIMIT_FIELDS, contact_constants,
                                limit_constants)
from ..dynamics.fk import forward_kinematics
from ..dynamics.model import FREE, HINGE, SLIDE, Data, Model
from ..dynamics.smooth import bias_force
from ..keypoints import methods as kp_methods
from ..keypoints.interpolate import lerp_columns
from ..solver import ilqr as twins
from ..tasks.base import Task, control_limits
from . import build, topology
from .topology import Topology

# the dynamics Jacobians are central FD (K5, the generic solve's deriv_mode
# "fd") or forward mode (K5ad, every lane path, and deriv_mode "ad" and
# "ad_time"); an iteration launches one of the two
KERNELS = ("rollout", "linesearch", "fd_jacobian", "ad_jacobian",
           "cost_expansion", "backward")
# the MPC replan's apply step (K8), launched once per replan
MPC_KERNELS = ("mpc_apply",)
# the FK products and bias force of the pushing tasks' servo (in the rollout
# library), launched by the servo that starts a push solve
SERVO_KERNELS = ("fk_bias",)
# the keypoint kernels K9 of the adaptive and iterative_error methods
KEYPOINT_KERNELS = ("keypoint_plan", "kp_interp", "ie_mse")
LAUNCHES = {name: 0 for name in KERNELS + MPC_KERNELS + SERVO_KERNELS
            + KEYPOINT_KERNELS}

# replaced lane program of the JAX package, per kernel
REPLACES = {
    "rollout": "trajoptkp_tpu/solver/lanes.py:263",
    "linesearch": "trajoptkp_tpu/solver/lanes.py:750",
    "fd_jacobian": "trajoptkp_tpu/solver/lanes.py:282",
    "ad_jacobian": "trajoptkp_tpu/solver/lanes.py:282",
    "cost_expansion": "trajoptkp_tpu/solver/lanes.py:597",
    "backward": "trajoptkp_tpu/solver/lanes.py:632",
    "mpc_apply": "trajoptkp_tpu/mpc/sync.py:100",
    "keypoint_plan": "trajoptkp_tpu/keypoints/methods.py:266",
    "kp_interp": "trajoptkp_tpu/solver/lanes.py:415",
    "ie_mse": "trajoptkp_tpu/solver/lanes.py:459",
}
# the library each kernel is built into, where it is not its own name
SOURCES = {"fk_bias": "rollout", "ie_mse": "kp_interp",
           "keypoint_plan": "keypoints"}
# device functions inside rollout, linesearch, fd_jacobian, ad_jacobian and
# mpc_apply: the step (K1), for a model with joint limits or contacts the
# constraint solve (K2a; in ad_jacobian with the implicit tangent K2c), and
# for a model with contacts the narrow phase and contact rows (K2b)
DEVICE_FUNCTIONS = {
    "step": ("trajoptkp_tpu_torch/kernels/csrc/step.cuh",
             "trajoptkp_tpu/dynamics/lanes.py:1595"),
    "constraint": ("trajoptkp_tpu_torch/kernels/csrc/constraint.cuh",
                   "trajoptkp_tpu/dynamics/lanes.py:1523"),
    "contact": ("trajoptkp_tpu_torch/kernels/csrc/contact.cuh",
                "trajoptkp_tpu/dynamics/lanes.py:989"),
    "implicit_tangent": ("trajoptkp_tpu_torch/kernels/csrc/constraint.cuh",
                         "trajoptkp_tpu/dynamics/lanes.py:1490"),
}

# numeric model buffer layout, mirrored by csrc/step.cuh
BODY_FIELDS = (("body_pos", 3), ("body_quat", 4), ("body_ipos", 3),
               ("body_iquat", 4), ("body_mass", 1), ("body_inertia", 3))
DOF_FIELDS = ("dof_damping", "dof_armature")
JOINT_FIELDS = (("jnt_pos", 3), ("jnt_axis", 3), ("qpos0", 1),
                ("jnt_stiffness", 1), ("qpos_spring", 1))
# per body 1..nbody-1 BODY_FIELDS; per dof DOF_FIELDS then its joint's
# JOINT_FIELDS (zero for a free joint's dofs); per actuator: dof, gear,
# ctrllimited, lo, hi; per limited joint: dynamics/contact.py LIMIT_FIELDS;
# per contact pair: geom1 pos, quat, size, geom2 pos, quat, size,
# CONTACT_FIELDS; gravity (3); timestep
RES_KINDS = {"joint_space": 0, "push": 1, "select": 2, "sweep": 3,
             "tilt_push": 4}
# the FK residuals of a goal body and an end-effector site: ("push", n,
# goal, site, n obstacle bodies), ("sweep", goal, site), ("tilt_push",
# goal, site)
FK_KINDS = ("push", "sweep", "tilt_push")


# the async MPC's planner and actor launch from two threads
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(kernel: str) -> None:
    """Add one to the kernel's launch count (from any thread)."""
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1


# ---------------------------------------------------------------------------
# topology -> instance
# ---------------------------------------------------------------------------


def body_joints(model: Model):
    """The joints of each body in declaration order ([] for a body without a
    joint)."""
    joints = [[] for _ in range(model.nbody)]
    for j, b in enumerate(model.jnt_bodyid):
        joints[b].append(j)
    return joints


def _scope_error(why: str):
    return NotImplementedError(
        f"the kernels take trees whose bodies carry hinge and slide joints, "
        f"one free joint alone, or none: {why}; ball joints wait in "
        f"ROADMAP under the engine outside the lane scope")


def model_topology(model: Model) -> Topology:
    """The model's tables of a kernel instance (topology.Topology; the
    state vector and the residual left empty), or raise."""
    joints = body_joints(model)
    dof = 0
    for b in range(1, model.nbody):
        if model.body_parent[b] >= b:
            raise _scope_error("bodies must follow their parents")
        kinds = [model.jnt_type[j] for j in joints[b]]
        if any(k not in (HINGE, SLIDE, FREE) for k in kinds):
            raise _scope_error(f"body {model.body_names[b]} has a ball joint")
        if FREE in kinds and (len(kinds) > 1 or model.body_parent[b] != 0):
            raise _scope_error("a free joint must be its body's only joint "
                               "and the body must hang from the world")
        for j in joints[b]:
            if model.jnt_dofadr[j] != dof:
                raise _scope_error("dofs must follow the body order")
            dof += 6 if model.jnt_type[j] == FREE else 1
    for a in range(model.nu):
        if model.jnt_type[model.actuator_trnid[a]] not in (HINGE, SLIDE):
            raise _scope_error("actuators must drive hinge or slide joints")
    if any(model.jnt_limited) and not limit_constants(model).int_power:
        raise NotImplementedError(
            "the kernels multiply the impedance power out: solimp[4] must "
            "be an integer from 1 to 8")
    cc = contact_constants(model)
    if cc.pairs and not cc.int_power:
        raise NotImplementedError(
            "the kernels multiply the impedance power out: contact solimp[4] "
            "must be an integer from 1 to 8")
    nb, nv = model.nbody, model.nv
    first = [joints[b][0] if joints[b] else None for b in range(nb)]
    body_dof = tuple(-1 if j is None else model.jnt_dofadr[j] for j in first)
    body_ndof = tuple(sum(6 if model.jnt_type[j] == FREE else 1
                          for j in joints[b]) for b in range(nb))
    body_qadr = tuple(0 if j is None else model.jnt_qposadr[j]
                      for j in first)
    dof_body = [0] * nv
    for b in range(1, nb):
        for k in range(body_ndof[b]):
            dof_body[body_dof[b] + k] = b
    slide = [0] * nv
    for j in range(model.njnt):
        if model.jnt_type[j] == SLIDE:
            slide[model.jnt_dofadr[j]] = 1
    limited = [0] * nv
    for j in limit_constants(model).joints:
        limited[model.jnt_dofadr[j]] = 1
    return Topology(
        NV=nv, NU=model.nu, NBODY=nb, NDOF=0,
        PARENT=(0,) + tuple(model.body_parent[1:]), BODY_DOF=body_dof,
        BODY_NDOF=body_ndof, BODY_QADR=body_qadr,
        FREE=tuple(int(bool(joints[b]) and b > 0
                       and model.jnt_type[joints[b][0]] == FREE)
                   for b in range(nb)),
        SLIDE=tuple(slide), LIMITED=tuple(limited), DOF_BODY=tuple(dof_body),
        DOF_Q=tuple(body_qadr[dof_body[j]] + j - body_dof[dof_body[j]]
                    for j in range(nv)),
        SV=(), PAIRS=tuple((*pr.types, *pr.bodies) for pr in cc.pairs),
        RES=-1, RESARGS=())


def state_key(model: Model, sv) -> Tuple[int, ...]:
    """The qvel index of each state dof the kernels take, or raise: hinge,
    slide and free-joint dofs, all active.  A free joint's rotation dofs
    enter as a whole (its tangent is the quaternion's q * exp(dz), whose
    rows the kernels take per body)."""
    allowed = set()
    for j in range(model.njnt):
        d = model.jnt_dofadr[j]
        if model.jnt_type[j] in (HINGE, SLIDE):
            allowed.add(d)
        elif model.jnt_type[j] == FREE:
            allowed.update((d, d + 1, d + 2))
            rot = (d + 3, d + 4, d + 5)
            if all(i in sv.order for i in rot):
                allowed.update(rot)
    if (any(i not in allowed for i in sv.order)
            or not bool((sv.active > 0.5).all())):
        raise NotImplementedError(
            "the kernels take a state vector of active hinge, slide or "
            "free-joint dofs, a free rotation's three together (ball joints "
            "wait in ROADMAP under the engine outside the lane scope); it "
            f"has {sv.names}")
    return tuple(sv.order)


def _fk_kind(task: Task):
    """(kind, goal body, end-effector site, obstacle bodies) of a
    kernel-ready FK residual: ("push", n, goal, site, n obstacle bodies)
    with nres 4 + n and n obstacle layout points (task.obstacle_starts),
    ("sweep", goal, site) with nres 3 and 4 targets, ("tilt_push", goal,
    site) with nres 7 and 2 targets; else None."""
    model, kind = task.model, task.residual_kind
    nres, ntgt = task.nres, task.residual_targets.shape[0]
    obst = ()
    if (len(kind) >= 4 and kind[0] == "push" and isinstance(kind[1], int)
            and len(kind) == 4 + kind[1] and nres == 4 + kind[1]):
        name, goal, site, obst = "push", kind[2], kind[3], tuple(kind[4:])
        starts = task.obstacle_starts
        if len(obst) and (starts is None
                          or tuple(starts.shape) != (len(obst), 2)):
            return None
    elif (len(kind) == 3 and (kind[0], nres, ntgt) in (("sweep", 3, 4),
                                                      ("tilt_push", 7, 2))):
        name, goal, site = kind
    else:
        return None
    j = model.jnt_bodyid.index(goal) if goal in model.jnt_bodyid else -1
    if (0 < goal < model.nbody and 0 <= site < model.nsite
            and all(0 < b < model.nbody for b in obst)
            and (name == "push" or model.jnt_type[j] == FREE)):
        return name, goal, site, obst
    return None


def residual_key(task: Task) -> Tuple[int, Tuple[int, ...]]:
    """(RES, RESARGS) of the task's residual kind, or raise: joint_space
    (nj, nr), push (goal body, ee site body, obstacle bodies...), select
    (the index of each row's coordinate in [qpos, qvel, ctrl]), sweep and
    tilt_push (box body, ee site body)."""
    model, kind = task.model, task.residual_kind
    if (len(kind) == 3 and kind[0] == "joint_space"
            and 0 < kind[1] <= model.nv and 0 <= kind[2] <= model.nu
            and task.nres == 2 * kind[1] + kind[2]):
        return RES_KINDS["joint_space"], (kind[1], kind[2])
    fk = _fk_kind(task)
    if fk is not None:
        return RES_KINDS[fk[0]], (fk[1], model.site_bodyid[fk[2]]) + fk[3]
    if len(kind) == 2 and kind[0] == "select" and len(kind[1]) == task.nres:
        sizes = (model.nq, model.nv, model.nu)
        base = (0, model.nq, model.nq + model.nv)
        idx = tuple(base[s_] + i for s_, i in kind[1] if 0 <= i < sizes[s_])
        if len(idx) == task.nres:
            return RES_KINDS["select"], idx
    raise NotImplementedError(
        "the kernels compute the joint-space residual (\"joint_space\", "
        "nj <= nv, nr <= nu), the FK residuals (\"push\", n, goal body, "
        "ee site, n obstacle bodies), (\"sweep\", box, ee site) and "
        "(\"tilt_push\", box, ee site) of a free box, and a residual of "
        "selected coordinates (\"select\", ((source, index), ...)); task "
        f"residual is {kind}")


def residual_constants(task: Task) -> torch.Tensor:
    """The residual's constants at the end of the task buffer: for an FK
    residual the end-effector site's position on its body, then for the
    clutter residual each obstacle's layout point (x, y)."""
    model = task.model
    fk = _fk_kind(task)
    if fk is None:
        return torch.zeros(0, dtype=model.dtype, device=model.device)
    site = model.site_pos[fk[2]].reshape(3)
    if not fk[3]:
        return site
    return torch.cat([site, task.obstacle_starts.to(site).reshape(-1)])


@functools.lru_cache(maxsize=None)
def instances() -> dict:
    """instance key (topology.Topology) -> instance tag, from
    instances.cuh (read once).  The limited dofs and the pairs in the key
    fix the rows of the constraint solve, so a model with limits or
    contacts never runs through an instance without them."""
    tables = build.instance_tables()
    return {topo: tag for tag, topo in tables.items()}


@functools.lru_cache(maxsize=None)
def backward_instances() -> frozenset:
    """(NX, NU) pairs of the backward-pass instances in instances.cuh
    (read once)."""
    text = (build.CSRC / "instances.cuh").read_text()
    return frozenset((int(a), int(b))
                     for a, b in re.findall(r"\bB\((\d+),\s*(\d+)\)", text))


def instance_key(task: Task) -> Topology:
    """The instances.cuh tables of a task, or raise outside the scope."""
    res, args = residual_key(task)
    sv = state_key(task.model, task.sv)
    return model_topology(task.model)._replace(NDOF=len(sv), SV=sv, RES=res,
                                               RESARGS=args)


def instance_line(task: Task, tag: str) -> str:
    """The instances.cuh entry of a task (to add a topology): its tables'
    struct and its X entry."""
    return topology.emit(tag, instance_key(task))



class KernelArgs(NamedTuple):
    tag: str
    nq: int
    nv: int
    nu: int
    sv: object                # the state vector (ndof, order)
    ntgt: int                 # residual targets per lane
    model_buf: torch.Tensor   # packed model parameters
    task_buf: torch.Tensor    # w_run (nres), w_term (nres), lo (nu), hi (nu),
                              # residual_constants
    model: Model              # keeps the cache key alive


_ARGS_CACHE: dict = {}


def pack_model(model: Model) -> torch.Tensor:
    """The model buffer that csrc/step.cuh reads (layout above)."""
    rows = []
    dt = dict(dtype=model.dtype, device=model.device)
    for b in range(1, model.nbody):
        for field, width in BODY_FIELDS:
            rows.append(getattr(model, field)[b].reshape(width))
    for j in range(model.njnt):
        scalar = model.jnt_type[j] in (HINGE, SLIDE)
        da, qa = model.jnt_dofadr[j], model.jnt_qposadr[j]
        for k in range(6 if model.jnt_type[j] == FREE else 1):
            rows.append(torch.stack([getattr(model, f)[da + k]
                                     for f in DOF_FIELDS]))
            for field, width in JOINT_FIELDS:
                x = getattr(model, field)
                if not scalar:
                    rows.append(torch.zeros(width, **dt))
                elif field in ("qpos0", "qpos_spring"):
                    rows.append(x[qa].reshape(width))
                else:
                    rows.append(x[j].reshape(width))
    for a in range(model.nu):
        j = model.actuator_trnid[a]
        rng = model.actuator_ctrlrange[a]
        rows.append(torch.stack([
            torch.tensor(float(model.jnt_dofadr[j]), **dt),
            model.actuator_gear[a, 0],
            torch.tensor(float(model.actuator_ctrllimited[a]), **dt),
            rng[0], rng[1]]))
    lc = limit_constants(model)
    rows.append(lc.table.reshape(len(lc.joints) * len(LIMIT_FIELDS)))
    cc = contact_constants(model)
    for p, pr in enumerate(cc.pairs):
        for g in (pr.g1, pr.g2):
            rows += [model.geom_pos[g], model.geom_quat[g], model.geom_size[g]]
        rows.append(cc.table[p])
    rows.append(model.gravity.reshape(3))
    rows.append(model.timestep.reshape(1))
    return torch.cat(rows).contiguous()


def kernel_args(task: Task, device: torch.device) -> KernelArgs:
    """Validate the task for the kernels and pack its buffers (cached)."""
    model = task.model
    if model.device != device:
        raise ValueError(f"task is on {model.device}, tensors on {device}")
    key = (id(task), id(model))
    hit = _ARGS_CACHE.get(key)
    if hit is not None and hit[0] is task:
        return hit[1]
    topo = instance_key(task)
    tag = instances().get(topo)
    if tag is None:
        raise NotImplementedError(
            f"no kernel instance for topology {topo}; add it to "
            "kernels/csrc/instances.cuh")
    lim = control_limits(task)
    task_buf = torch.cat([task.weights, task.weights_terminal, lim[:, 0],
                          lim[:, 1], residual_constants(task)]).contiguous()
    args = KernelArgs(tag, model.nq, model.nv, model.nu, task.sv,
                      task.residual_targets.shape[0], pack_model(model),
                      task_buf, model)
    if len(_ARGS_CACHE) > 16:
        _ARGS_CACHE.clear()
    _ARGS_CACHE[key] = (task, args)
    return args


# ---------------------------------------------------------------------------
# launch helpers
# ---------------------------------------------------------------------------


def _check(name, t, shape, dtype=torch.float64):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, is on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, is {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _launch(kernel: str, instance: str, symbol: str, *args):
    """Launch `symbol` of the kernel's library (`SOURCES`) at `instance`,
    and count it."""
    lib = build.load(SOURCES.get(kernel, kernel), instance)
    fn = getattr(lib, symbol)
    fn.argtypes = [type(a) for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: cudaError {err} "
                           f"({build.error_string(lib, err)})")
    count_launch(kernel)


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed devices: {sorted(devs)}")


# ---------------------------------------------------------------------------
# the kernels of an iteration
# ---------------------------------------------------------------------------


def rollout(task: Task, qpos0, qvel0, U, targets, plain: bool = False):
    """K3.  qpos0 (nq, B), qvel0 (nv, B), U (H, nu, B), targets (ntgt, B)
    -> qpos (H+1, nq, B), qvel (H+1, nv, B), costs (H, B)."""
    if _on_cpu(qpos0, qvel0, U, targets) or plain:
        return twins.rollout(task, qpos0, qvel0, U, targets)
    ka = kernel_args(task, U.device)
    H, B = U.shape[0], U.shape[-1]
    nq, nv, nu = ka.nq, ka.nv, ka.nu
    _check("qpos0", qpos0, (nq, B))
    _check("qvel0", qvel0, (nv, B))
    _check("U", U, (H, nu, B))
    _check("targets", targets, (ka.ntgt, B))
    f64 = dict(dtype=torch.float64, device=U.device)
    qpos = torch.empty((H + 1, nq, B), **f64)
    qvel = torch.empty((H + 1, nv, B), **f64)
    costs = torch.empty((H, B), **f64)
    _launch("rollout", ka.tag, f"trajopt_rollout_{ka.tag}",
            _p(ka.model_buf), _p(ka.task_buf), _p(qpos0), _p(qvel0), _p(U),
            _p(targets), _p(qpos), _p(qvel), _p(costs), ctypes.c_int(H),
            ctypes.c_int(B))
    return qpos, qvel, costs


def linesearch(task: Task, qpos, qvel, U, k, K, alphas, targets,
               plain: bool = False, geometry: "LinesearchGeometry" = None):
    """K4.  All alphas' rollouts under u = clip(u_nom + α k + K dx), K over
    the state vector's 2 ndof tangent dofs:
    -> qpos (H+1, nq, A, B), qvel (H+1, nv, A, B), ctrl (H, nu, A, B),
    costs (H, A, B).  A warp per (alpha, scene) lane with the cooperative
    step where the model has constraint rows, else a thread per lane
    (`geometry`, by default `linesearch_geometry`; the C entry refuses one
    its kernel does not run)."""
    if _on_cpu(qpos, qvel, U, k, K, alphas, targets) or plain:
        return twins.forward_pass_rollouts(task, qpos, qvel, U, k, K, alphas,
                                           targets)
    ka = kernel_args(task, U.device)
    H, B = U.shape[0], U.shape[-1]
    nq, nv, nu, nA = ka.nq, ka.nv, ka.nu, alphas.shape[0]
    _check("qpos", qpos, (H + 1, nq, B))
    _check("qvel", qvel, (H + 1, nv, B))
    _check("U", U, (H, nu, B))
    _check("k", k, (H, nu, B))
    _check("K", K, (H, nu, ka.sv.nx, B))
    _check("alphas", alphas, (nA,))
    _check("targets", targets, (ka.ntgt, B))
    f64 = dict(dtype=torch.float64, device=U.device)
    qps = torch.empty((H + 1, nq, nA, B), **f64)
    qvs = torch.empty((H + 1, nv, nA, B), **f64)
    us = torch.empty((H, nu, nA, B), **f64)
    cs = torch.empty((H, nA, B), **f64)
    g = geometry or _linesearch_plan(ka.tag, nA, B, U.device)
    _launch("linesearch", ka.tag, f"trajopt_linesearch_{ka.tag}",
            _p(ka.model_buf), _p(ka.task_buf), _p(qpos), _p(qvel), _p(U),
            _p(k), _p(K), _p(alphas), _p(targets), _p(qps), _p(qvs), _p(us),
            _p(cs),
            ctypes.c_int(H), ctypes.c_int(nA), ctypes.c_int(B),
            ctypes.c_int(g.threads), ctypes.c_int(g.lanes),
            ctypes.c_int(g.smem_bytes))
    return qps, qvs, us, cs


def _slot_args(ka, qpos, qvel, U, times, counts, cache):
    """Check K5's and K5ad's inputs on the card -> (J, time strides)."""
    H, B = U.shape[0], U.shape[-1]
    nq, nv, nu, nx, nK = ka.nq, ka.nv, ka.nu, ka.sv.nx, times.shape[0]
    _check("qpos", qpos, (qpos.shape[0], nq, B))
    _check("qvel", qvel, (qvel.shape[0], nv, B))
    _check("U", U, (H, nu, B))
    if qpos.shape[0] < H or qvel.shape[0] < H:
        raise ValueError("trajectory shorter than the controls")
    if times.dim() == 2:
        _check("times", times, (nK, B), torch.int64)
        _check("counts", counts, (B,), torch.int32)
        stride = (B, 1)
    else:
        _check("times", times, (nK,), torch.int64)
        # one read back to the host: each one waits for the card
        lo, hi = torch.stack(torch.aminmax(times)).tolist() if nK else (0, 0)
        if not (0 <= lo and hi < H):
            raise ValueError(f"slot times must lie in [0, {H})")
        stride = (1, 0)
    if cache is not None:
        _check("cache", cache, (H, nx, nx + nu, B))
        return cache, stride
    return torch.empty((nK, nx, nx + nu, B), dtype=torch.float64,
                       device=U.device), stride


def _slot_modes(times, counts, cache) -> bool:
    """Whether the slot times are per lane; refuse inconsistent modes."""
    lanes = times.dim() == 2
    if (cache is not None or counts is not None) and not lanes:
        raise ValueError("counts and cache go with per-lane times (K, B)")
    if lanes and counts is None:
        raise ValueError("per-lane times need their live counts")
    return lanes


def fd_jacobian(task: Task, qpos, qvel, U, times, eps: float,
                plain: bool = False, counts=None, cache=None):
    """K5.  Central-FD [A|B] over the state vector at slot times of the
    trajectory qpos (>=H, nq, B), qvel, U (H, nu, B):

    - times (K,) int64, shared by every lane -> J (K, 2n, 2n+nu, B);
    - times (K, B) int64 per lane with counts (B,) int32 live slots -> J
      (K, 2n, 2n+nu, B), zero at the slots past a lane's count;
    - the same with cache (H, 2n, 2n+nu, B): each live slot's Jacobian is
      written into the cache at its time, in place, and the cache returned
      (iterative_error's full-horizon column cache; dead slots write
      nothing).

    Per-lane times are not checked against H on the card: that would read
    them back to the host."""
    lanes = _slot_modes(times, counts, cache)
    if _on_cpu(qpos, qvel, U, times) or plain:
        if not lanes:
            J = fd_slot_jacobians(task.model, task.sv,
                                  qpos[times].transpose(0, 1),
                                  qvel[times].transpose(0, 1),
                                  U[times].transpose(0, 1), eps)
            return J.movedim(2, 0)                     # (K, 2n, C, B)
        return fd_lane_slots(task.model, task.sv, qpos, qvel, U, times,
                             counts, eps, cache)
    ka = kernel_args(task, U.device)
    J, stride = _slot_args(ka, qpos, qvel, U, times, counts, cache)
    tag = build.step_shared().get(ka.tag, ka.tag)   # reads no residual
    _launch("fd_jacobian", tag,
            f"trajopt_fd_jacobian_{tag}", _p(ka.model_buf),
            _p(qpos), _p(qvel), _p(U), _p(times),
            ctypes.c_longlong(stride[0]), ctypes.c_longlong(stride[1]),
            ctypes.c_void_p(counts.data_ptr() if lanes else None),
            ctypes.c_int(cache is not None), ctypes.c_double(eps),
            _p(J), ctypes.c_int(times.shape[0]), ctypes.c_int(U.shape[-1]))
    return J


def ad_jacobian(task: Task, qpos, qvel, U, times, plain: bool = False,
                counts=None, cache=None):
    """K5ad (csrc/ad_jacobian.cu).  The exact [A|B] over the state vector
    by forward mode, the constraint solve differentiated implicitly at its
    Newton iterate (K2c), at the slot times of the trajectory, in the slot
    modes of `fd_jacobian` (shared times, per-lane times with live counts,
    the full-horizon cache).  On the card a primal pass per (slot, lane)
    writes what the slot's columns share into a buffer of `ad_chunk` slots
    (`ad_primal_entries` doubles per (slot, lane)), and the tangent pass
    reads it, launched to start while the primal pass runs; one C call
    runs both per chunk and counts one launch.  A model with no primal
    entries (acrobot) runs one pass.  Plain twin: derivs/ad.py."""
    lanes = _slot_modes(times, counts, cache)
    if _on_cpu(qpos, qvel, U, times) or plain:
        if not lanes:
            J = ad_slot_jacobians(task.model, task.sv,
                                  qpos[times].transpose(0, 1),
                                  qvel[times].transpose(0, 1),
                                  U[times].transpose(0, 1))
            return J.movedim(2, 0)                     # (K, 2n, C, B)
        return ad_lane_slots(task.model, task.sv, qpos, qvel, U, times,
                             counts, cache)
    ka = kernel_args(task, U.device)
    J, stride = _slot_args(ka, qpos, qvel, U, times, counts, cache)
    tag = build.step_shared().get(ka.tag, ka.tag)   # reads no residual
    nK, B = times.shape[0], U.shape[-1]
    entries = _ad_entries(tag)
    chunk = ad_chunk(entries, nK, B)
    prim = (torch.empty((chunk * entries * B,), dtype=torch.float64,
                        device=U.device) if chunk else None)
    _launch("ad_jacobian", tag,
            f"trajopt_ad_jacobian_{tag}", _p(ka.model_buf),
            _p(qpos), _p(qvel), _p(U), _p(times),
            ctypes.c_longlong(stride[0]), ctypes.c_longlong(stride[1]),
            ctypes.c_void_p(counts.data_ptr() if lanes else None),
            ctypes.c_int(cache is not None),
            ctypes.c_void_p(None if prim is None else prim.data_ptr()),
            ctypes.c_int(entries), ctypes.c_int(chunk), _p(J),
            ctypes.c_int(nK), ctypes.c_int(B))
    return J


def cost_expansion(task: Task, qpos, qvel, U, targets, plain: bool = False):
    """K6: the Gauss-Newton cost expansion (csrc/cost_expansion.cu) of the
    trajectory qpos (>=H, nq, B), qvel (>=H, nv, B), U (H, nu, B), targets
    (ntgt, B) -> l_x (H, 2n, B), l_xx (H, 2n, 2n, B), l_u (H, nu, B), l_uu
    (H, nu, nu, B).  Plain twin: solver/lanes.py:cost_expansion."""
    if _on_cpu(qpos, qvel, U, targets) or plain:
        from ..solver.lanes import cost_expansion as twin
        return twin(task, qpos, qvel, U, targets)
    ka = kernel_args(task, U.device)
    H, B = U.shape[0], U.shape[-1]
    nq, nv, nu, nx = ka.nq, ka.nv, ka.nu, ka.sv.nx
    _check("qpos", qpos, (qpos.shape[0], nq, B))
    _check("qvel", qvel, (qvel.shape[0], nv, B))
    _check("U", U, (H, nu, B))
    _check("targets", targets, (ka.ntgt, B))
    if qpos.shape[0] < H or qvel.shape[0] < H:
        raise ValueError("trajectory shorter than the controls")
    f64 = dict(dtype=torch.float64, device=U.device)
    l_x = torch.empty((H, nx, B), **f64)
    l_xx = torch.empty((H, nx, nx, B), **f64)
    l_u = torch.empty((H, nu, B), **f64)
    l_uu = torch.empty((H, nu, nu, B), **f64)
    _launch("cost_expansion", ka.tag, f"trajopt_cost_expansion_{ka.tag}",
            _p(ka.model_buf), _p(ka.task_buf), _p(qpos), _p(qvel), _p(U),
            _p(targets), _p(l_x), _p(l_xx), _p(l_u), _p(l_uu),
            ctypes.c_int(H), ctypes.c_int(B))
    return l_x, l_xx, l_u, l_uu


# K7's launch geometry (csrc/backward.cu): up to this nx a warp owns a lane
# and a block holds BP_WARP_LANES lanes; past it a block owns a lane, with
# about half as many threads as its largest phase has entries (each thread
# sums one entry of W, G or the new V_xx at a time), 128 to 512
BP_WARP_NX = 10
BP_WARP_LANES = 4
BP_THREADS = (128, 512)
# dynamic shared memory a block of an H100 may take (227 KB)
SMEM_LIMIT = 232448


class BackwardGeometry(NamedTuple):
    threads: int       # per block
    lanes: int         # per block: 1, or one per warp
    smem_bytes: int    # dynamic shared memory per block

    def blocks(self, B: int) -> int:
        return -(-B // self.lanes)

    def lane(self, block: int, thread: int) -> int:
        """The lane a thread works on (csrc/backward.cu:backward_kernel);
        past B the kernel returns."""
        return block * self.lanes + thread // (self.threads // self.lanes)


def backward_phase_entries(nx: int, nu: int) -> Tuple[int, int, int]:
    """Entries of K7's three wide phases per step: W and g, the Q blocks
    (G), and the upper triangle of V_xx with V_x."""
    nc = nx + nu
    return (nx * nc + nc, nx * nx + nu * nc, nx * (nx + 1) // 2 + nx)


def backward_solver_threads(nx: int) -> int:
    """Threads of the warps that hold K7's nx + 1 right-hand sides where a
    block owns a lane; the rest of the block loads the next inputs."""
    return 32 * ((nx + 32) // 32)


def backward_smem_bytes(nx: int, nu: int, lanes: int) -> int:
    """Dynamic shared memory of a K7 block (csrc/backward.cu:BpLayout): per
    lane the work arrays V_x, V_xx, W, Q_x|Q_u, Q_ux, Q_uu, k, K, Q_uu k,
    Q_uu K, and two input buffers of a step's [A|B], l_x, l_xx, l_u and
    l_uu, all doubles; then the block's table of V_xx's upper-triangle
    pairs (2 bytes each), rounded to 16 bytes."""
    nc = nx + nu
    work = (nx + nx * nx + nx * nc + nc + nu * nx + nu * nu + nu + nu * nx
            + nu + nu * nx)
    inputs = nx * nc + nx + nx * nx + nu + nu * nu
    per_lane = work + 2 * inputs
    return (8 * lanes * per_lane + 2 * (nx * (nx + 1) // 2) + 15) // 16 * 16


def backward_geometry(nx: int, nu: int) -> BackwardGeometry:
    """K7's block size, lanes per block and shared memory at (nx, nu);
    NotImplementedError where a block cannot hold them."""
    if nx <= BP_WARP_NX:
        lanes, threads = BP_WARP_LANES, 32 * BP_WARP_LANES
    else:
        half = -(-max(backward_phase_entries(nx, nu)) // 64) * 32
        lanes, threads = 1, min(BP_THREADS[1], max(BP_THREADS[0], half))
        # the warps that solve the nx + 1 right-hand sides and one more
        # that loads the next inputs meanwhile (csrc/backward.cu)
        if threads < backward_solver_threads(nx) + 32:
            raise NotImplementedError(f"K7 at nx={nx} needs more than "
                                      f"{BP_THREADS[1]} threads a block")
    smem = backward_smem_bytes(nx, nu, lanes)
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"K7 at nx={nx}, nu={nu} needs {smem} bytes of shared memory a "
            f"block, past the {SMEM_LIMIT} a block may take")
    return BackwardGeometry(threads, lanes, smem)


# ---------------------------------------------------------------------------
# K4's and K5ad's launch plans (csrc/linesearch.cu, csrc/ad_jacobian.cu)
# ---------------------------------------------------------------------------

# an H100 SXM: its SMs (the plans' default; K4's wrapper reads the card's
# own count) and the shared memory one SM holds
NUM_SMS = 132
SMEM_PER_SM = 233472
# lanes a block of the warp-per-lane K4 holds at most (linesearch.cu
# LS_MAX_LANES), and the block of its one-thread kernel
LS_MAX_LANES = 8
LS_THREAD_BLOCK = 64
# the cooperative step holds a row of M a thread (warp_step.cuh:
# warp_factor_solve)
LS_MAX_DOFS = 32
# doubles per contact slot of the cooperative step's narrow phase
# (warp_step.cuh SLOT_DOUBLES)
SLOT_DOUBLES = 16


def _direct(t1: int, t2: int) -> bool:
    plane, capsule, cylinder, box = 0, 3, 5, 6
    return ((t1 == plane and t2 in (cylinder, capsule, box))
            or (t1 == capsule and t2 in (capsule, box))
            or (t1 == cylinder and t2 in (cylinder, box)))


def pair_slots(t1: int, t2: int) -> int:
    """Contact slots of a pair of geom types (csrc/contact.cuh:pair_slots)."""
    if not _direct(t1, t2) and _direct(t2, t1):
        t1, t2 = t2, t1
    if t1 == 0:
        return {5: 3, 6: 4}.get(t2, 2)
    return 2 if t2 == 6 else 1


def _root_path(t: Topology, b: int) -> set:
    dofs = set()
    while b > 0:
        if t.BODY_DOF[b] >= 0:
            dofs.update(range(t.BODY_DOF[b], t.BODY_DOF[b] + t.BODY_NDOF[b]))
        b = t.PARENT[b]
    return dofs


class StepSizes(NamedTuple):
    """An instance's sizes as csrc/step.cuh:Topo derives them."""
    nq: int
    nlim: int
    rows: int
    nslot: int
    ncoef: int        # the rows' sparse coefficients
    nres: int
    ntgt: int
    has_rot: bool


def step_sizes(t: Topology) -> StepSizes:
    nlim = sum(1 for x in t.LIMITED if x)
    ncoef, nslot = 2 * nlim, 0
    for t1, t2, b1, b2 in t.PAIRS:
        nc = pair_slots(t1, t2)
        w = len(_root_path(t, b1) ^ _root_path(t, b2))
        nslot += nc
        ncoef += 4 * nc * w
    nres = {0: 2 * t.RESARGS[0] + (t.RESARGS[1] if len(t.RESARGS) > 1
                                   else 0),
            2: len(t.RESARGS), 3: 3, 4: 7}.get(t.RES, 4 + len(t.RESARGS) - 2)
    ntgt = {1: 2, 4: 2, 3: 4}.get(t.RES, nres)
    has_rot = any(t.FREE[t.DOF_BODY[j]] and j - t.BODY_DOF[t.DOF_BODY[j]] >= 3
                  for j in t.SV)
    return StepSizes(t.NV + sum(t.FREE), nlim, 2 * nlim + 4 * nslot, nslot,
                     ncoef, nres, ntgt, has_rot)


def linesearch_lane_doubles(t: Topology) -> int:
    """Doubles of one lane's shared memory in the warp-per-lane K4
    (csrc/warp_step.cuh:WarpLayout): q, v, u, xpos, xquat, cdof, the
    composite inertias, f, M and H packed (H at least the RNE's per-body
    arrays and the slots' narrow phase), seven dof vectors, the rows' coefficients, aref, invR, y, J dx,
    16 merit sums, the targets, the residual and the state difference."""
    z = step_sizes(t)
    nv, nb = t.NV, t.NBODY
    ntri = nv * (nv + 1) // 2
    return (z.nq + nv + t.NU + 3 * nb + 4 * nb + 6 * nv + 10 * nb + nv
            + ntri + max(ntri, SLOT_DOUBLES * z.nslot, 18 * nb) + 7 * nv
            + z.ncoef
            + 4 * z.rows + 16 + z.ntgt + z.nres + 2 * t.NDOF)


def warp_tables_bytes(t: Topology) -> int:
    """Bytes of the cooperative step's tables, which each block of the
    warp-per-lane K4 copies into its static shared memory (csrc/
    warp_step.cuh:WarpTables: int16 arrays, then the H items as int32, then
    33 int16 offsets, 4-byte aligned)."""
    z = step_sizes(t)
    nv, nb, npair = t.NV, t.NBODY, len(t.PAIRS)
    sup = [len(_root_path(t, b1) ^ _root_path(t, b2))
           for _, _, b1, b2 in t.PAIRS]
    ncon = [pair_slots(t1, t2) for t1, t2, _, _ in t.PAIRS]
    nji = sum(w * n for w, n in zip(sup, ncon))
    nhi = sum(w * (w + 1) // 2 + w for w in sup)
    one = lambda n: max(n, 1)  # noqa: E731  (C++ keeps one entry of none)
    shorts = (nb * nv + 3 * nv + one(z.nlim)
              + 2 * one(z.rows) + one(z.ncoef) + 10 * one(npair)
              + 2 * (npair * nv if npair else 1) + one(z.nslot)
              + 2 * one(nji))
    head = (2 * shorts + 3) // 4 * 4
    return (head + 4 * one(nhi) + 2 * 33 + 3) // 4 * 4


class LinesearchGeometry(NamedTuple):
    threads: int        # per block
    lanes: int          # (alpha, scene) lanes per block
    smem_bytes: int     # dynamic shared memory per block (the lanes')
    warp: bool          # a warp per lane (else a thread per lane)
    blocks_per_sm: int  # resident blocks an SM holds (by shared memory,
                        # threads and the 32-block limit)

    def blocks(self, A: int, B: int) -> int:
        return -(-A * B // self.lanes)

    def waves(self, A: int, B: int, sms: int = NUM_SMS) -> int:
        return -(-self.blocks(A, B) // (sms * self.blocks_per_sm))

    def lane(self, block: int, thread: int, A: int) -> Tuple[int, int]:
        """(alpha, scene) of a thread (csrc/linesearch.cu); a lane past
        A B returns."""
        per = 32 if self.warp else 1
        n = block * self.lanes + thread // per
        return n % A, n // A


def linesearch_geometry(t: Topology, A: int, B: int,
                        sms: int = NUM_SMS) -> LinesearchGeometry:
    """K4's plan: a thread per lane in blocks of 64 without constraint
    rows; else a warp per lane, as many lanes a block as the lanes need to
    fill `sms` SMs at one block each (ceil(A B / sms), the A alphas of a
    scene at B = 128), at most LS_MAX_LANES and what 227 KB hold beside
    the block's tables (warp_tables_bytes).  Raises past LS_MAX_DOFS dofs
    and where one lane does not fit a block."""
    if step_sizes(t).rows == 0:
        return LinesearchGeometry(LS_THREAD_BLOCK, LS_THREAD_BLOCK, 0, False,
                                  2048 // LS_THREAD_BLOCK)
    if t.NV > LS_MAX_DOFS:
        raise NotImplementedError(
            f"K4's cooperative step holds a row of M a thread: up to "
            f"{LS_MAX_DOFS} dofs, not {t.NV}")
    per_lane = 8 * linesearch_lane_doubles(t)
    tables = warp_tables_bytes(t)
    fit = (SMEM_LIMIT - tables) // per_lane
    if fit < 1:
        raise NotImplementedError(
            f"K4's lane needs {per_lane} bytes of shared memory beside "
            f"{tables} of tables, past the {SMEM_LIMIT} a block may take")
    lanes = max(1, min(LS_MAX_LANES, fit, -(-A * B // sms)))
    smem = per_lane * lanes
    # each resident block also holds 1 KB of shared memory of its own
    per_sm = min(SMEM_PER_SM // (smem + tables + 1024),
                 2048 // (32 * lanes), 32)
    return LinesearchGeometry(32 * lanes, lanes, smem, True, per_sm)


@functools.lru_cache(maxsize=64)
def _linesearch_plan(tag: str, A: int, B: int,
                     device: torch.device) -> "LinesearchGeometry":
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return linesearch_geometry(build.instance_tables()[tag], A, B, sms)


# the primal buffer K5ad's wrapper may take on the card; past it the C
# entry runs its two passes a chunk of slots at a time
AD_PRIMAL_CAP_BYTES = 1 << 30


def ad_primal_entries(t: Topology) -> int:
    """Doubles of K5ad's primal buffer per (slot, lane) (csrc/
    constraint.cuh:AdLayout): the Newton iterate and the gated Hessian's
    packed factor where the model has constraint rows, the nominal next
    positions where the state holds a free rotation; 0 for neither."""
    z = step_sizes(t)
    nv = t.NV
    return ((nv + nv * (nv + 1) // 2 if z.rows else 0)
            + (z.nq if z.has_rot else 0))


@functools.lru_cache(maxsize=None)
def _ad_entries(tag: str) -> int:
    return ad_primal_entries(build.instance_tables()[tag])


def ad_chunk(entries: int, K: int, B: int, cap: int = None) -> int:
    """Slots a K5ad pass takes at once: 0 (one pass, no primal buffer)
    where a (slot, lane) has no primal entries, else all K or as many as
    the primal buffer's cap (AD_PRIMAL_CAP_BYTES) holds, at least one."""
    cap = AD_PRIMAL_CAP_BYTES if cap is None else cap
    if entries == 0:
        return 0
    return max(1, min(K, cap // (8 * entries * B)))


_BP_ARGS: dict = {}


def backward_args(nx: int, nu: int, cfg, device) -> Tuple[str, torch.Tensor]:
    """(kernel symbol, λ schedule on the device) of the backward pass at
    (nx, nu), cached per configuration and device like `kernel_args`: the
    instance list is parsed once and the schedule uploaded once."""
    key = (nx, nu, cfg.lambda_factor, cfg.min_lambda, cfg.max_lambda,
           str(device))
    hit = _BP_ARGS.get(key)
    if hit is not None:
        return hit
    if (nx, nu) not in backward_instances():
        raise NotImplementedError(
            f"no backward-pass instance for nx={nx}, nu={nu}; add it to "
            "kernels/csrc/instances.cuh")
    sched = torch.tensor([cfg.lambda_factor, cfg.min_lambda, cfg.max_lambda],
                         dtype=torch.float64, device=device)
    if len(_BP_ARGS) > 16:
        _BP_ARGS.clear()
    _BP_ARGS[key] = out = (f"trajopt_backward_nx{nx}_nu{nu}", sched)
    return out


def backward(A, Bm, l_x, l_xx, l_u, l_uu, lamb, cfg, plain: bool = False,
             info: dict = None, geometry: BackwardGeometry = None):
    """K7.  Riccati sweep with the coupled λ retry of
    `backward_pass_lambda_loop` -> (k, K, dJ, new λ, λ-exit);
    `info["rounds"]` receives the retry rounds taken (a device tensor on
    the card).  On the card 1 + `bp_rounds(cfg)` launches run back to back
    without reading anything back (csrc/backward.cu: each lane's own sweeps
    first, then every lane up to the most any lane needed); a launch whose
    target the lanes have reached returns at once.  A block or a warp owns
    a lane (`geometry`, by default `backward_geometry`; the C entry refuses
    one that does not fit the kernel).  Each launch counts."""
    if _on_cpu(A, Bm, l_x, l_xx, l_u, l_uu, lamb) or plain:
        return twins.backward_pass_lambda_loop(A, Bm, l_x, l_xx, l_u, l_uu,
                                               lamb, cfg, info=info)
    H, nx, B = l_x.shape
    nu = l_u.shape[1]
    symbol, sched = backward_args(nx, nu, cfg, A.device)
    g = geometry or backward_geometry(nx, nu)
    _check("A", A, (H, nx, nx, B))
    _check("Bm", Bm, (H, nx, nu, B))
    _check("l_x", l_x, (H, nx, B))
    _check("l_xx", l_xx, (H, nx, nx, B))
    _check("l_u", l_u, (H, nu, B))
    _check("l_uu", l_uu, (H, nu, nu, B))
    _check("lamb", lamb, (B,))
    f64 = dict(dtype=torch.float64, device=A.device)
    k = torch.empty((H, nu, B), **f64)
    K = torch.empty((H, nu, nx, B), **f64)
    dJ = torch.empty((B,), **f64)
    lam = torch.empty((B,), **f64)
    exited = torch.empty((B,), dtype=torch.uint8, device=A.device)
    valid = torch.empty((B,), dtype=torch.uint8, device=A.device)
    count = torch.empty((B,), dtype=torch.int32, device=A.device)
    rounds = twins.bp_rounds(cfg)
    target = torch.zeros((rounds + 1,), dtype=torch.int32, device=A.device)
    geo = (ctypes.c_int(g.threads), ctypes.c_int(g.lanes),
           ctypes.c_int(g.smem_bytes))
    for launch in range(rounds + 1):
        _launch("backward", f"nx{nx}_nu{nu}", symbol, _p(A), _p(Bm),
                _p(l_x), _p(l_xx), _p(l_u), _p(l_uu), _p(lamb), _p(sched),
                _p(k), _p(K), _p(dJ), _p(lam), _p(exited), _p(valid),
                _p(count), _p(target), ctypes.c_int(launch),
                ctypes.c_int(rounds + 1), ctypes.c_int(H), ctypes.c_int(B),
                *geo)
    if info is not None:
        info["rounds"] = target[rounds] - 1      # sweeps per lane, less one
    return k, K, dJ, lam, exited.bool() & (valid == 0)


def mpc_apply(task: Task, qp, qv, U, U_n, accept, best, old, z, std,
              targets, plain: bool = False):
    """K8: the MPC replan after the forward pass (csrc/mpc_apply.cu): the
    accept blend of the controls and the replan cost, `num_apply` noisy
    controls applied (clip, running cost of the pre-step state, K1 step)
    and the shift-pad.  qp (nq, B), qv (nv, B), U and U_n (H, nu, B),
    accept (B,) bool, best, old (B,), z (num_apply, nu, B), std (nu,),
    targets (ntgt, B) -> qp2, qv2, U_shift (H, nu, B), qps (num_apply, nq,
    B), qvs (num_apply, nv, B), us (num_apply, nu, B), cs (num_apply, B),
    rcost (B,).  Plain twin: mpc/sync.py:apply_controls."""
    if _on_cpu(qp, qv, U, U_n, accept, best, old, z, std, targets) or plain:
        from ..mpc.sync import apply_controls
        return apply_controls(task, qp, qv, U, U_n, accept, best, old, z,
                              std, targets)
    ka = kernel_args(task, U.device)
    H, B = U.shape[0], U.shape[-1]
    nq, nv, nu, nA = ka.nq, ka.nv, ka.nu, z.shape[0]
    _check("qp", qp, (nq, B))
    _check("qv", qv, (nv, B))
    _check("U", U, (H, nu, B))
    _check("U_n", U_n, (H, nu, B))
    _check("accept", accept, (B,), torch.bool)
    _check("best", best, (B,))
    _check("old", old, (B,))
    _check("z", z, (nA, nu, B))
    _check("std", std, (nu,))
    _check("targets", targets, (ka.ntgt, B))
    if not 1 <= nA <= H:
        raise ValueError(f"num_apply {nA} must lie in [1, {H}]")
    f64 = dict(dtype=torch.float64, device=U.device)
    acc = accept.to(torch.float64)
    qp2 = torch.empty((nq, B), **f64)
    qv2 = torch.empty((nv, B), **f64)
    U_shift = torch.empty((H, nu, B), **f64)
    qps = torch.empty((nA, nq, B), **f64)
    qvs = torch.empty((nA, nv, B), **f64)
    us = torch.empty((nA, nu, B), **f64)
    cs = torch.empty((nA, B), **f64)
    rcost = torch.empty((B,), **f64)
    _launch("mpc_apply", ka.tag, f"trajopt_mpc_apply_{ka.tag}",
            _p(ka.model_buf), _p(ka.task_buf), _p(qp), _p(qv), _p(U),
            _p(U_n), _p(acc), _p(best), _p(old), _p(z), _p(std), _p(targets),
            _p(qp2), _p(qv2), _p(U_shift), _p(qps), _p(qvs), _p(us), _p(cs),
            _p(rcost), ctypes.c_int(H), ctypes.c_int(nA), ctypes.c_int(B))
    return qp2, qv2, U_shift, qps, qvs, us, cs, rcost


def fk_bias(task: Task, qpos, qvel, plain: bool = False):
    """The step's FK products and bias force (csrc/step.cuh:fk_bias, built
    into the rollout library): qpos (nq, B), qvel (nv, B) -> xpos
    (nbody, 3, B), xquat (nbody, 4, B), cdof (nv, 6, B), qfrc_bias (nv, B).
    Plain twin: forward_kinematics + bias_force."""
    model = task.model
    if _on_cpu(qpos, qvel) or plain:
        d = forward_kinematics(model, Data(qpos=qpos, qvel=qvel, ctrl=None))
        return d.xpos, d.xquat, d.cdof, bias_force(model, d)
    ka = kernel_args(task, qvel.device)
    B = qvel.shape[-1]
    _check("qpos", qpos, (model.nq, B))
    _check("qvel", qvel, (model.nv, B))
    f64 = dict(dtype=torch.float64, device=qvel.device)
    xpos = torch.empty((model.nbody, 3, B), **f64)
    xquat = torch.empty((model.nbody, 4, B), **f64)
    cdof = torch.empty((model.nv, 6, B), **f64)
    bias = torch.empty((model.nv, B), **f64)
    _launch("fk_bias", ka.tag, f"trajopt_fk_bias_{ka.tag}",
            _p(ka.model_buf), _p(qpos), _p(qvel), _p(xpos), _p(xquat),
            _p(cdof), _p(bias), ctypes.c_int(B))
    return xpos, xquat, cdof, bias


# ---------------------------------------------------------------------------
# the keypoint kernels (K9), built once for every model
# ---------------------------------------------------------------------------

# K9a's selectors: a mask given, or a method's profile and scan
SELECTORS = {"mask": 0, "adaptive_jerk": 1, "adaptive_accel": 2,
             "velocity_change": 3}
MAX_KP_DOFS = 31      # per-dof counters a K9a thread keeps (keypoints.cu MAXN)


class KeypointPlanArgs(NamedTuple):
    """K9a's constant arguments for one task and method (cached)."""

    name: str               # a key of SELECTORS
    order: torch.Tensor     # (n,) int32 qvel index of each state dof
    thr: torch.Tensor       # (n,) float64 thresholds (zeros for "mask")
    min_N: int
    max_N: int
    inv_dt: float           # 1 / timestep, as the JAX program folds it


def keypoint_plan_args(task: Task, name: str = None) -> KeypointPlanArgs:
    """The plan's arguments for the task's keypoint method (or `name`, of
    SELECTORS); reads the timestep back once."""
    kp, sv, model = task.keypoint_cfg, task.sv, task.model
    name = name or kp.name
    if name not in SELECTORS:
        raise ValueError(f"no keypoint plan for method {name!r}")
    if sv.ndof > MAX_KP_DOFS:
        raise NotImplementedError(
            f"the keypoint plan takes at most {MAX_KP_DOFS} state dofs; "
            f"{task.name} has {sv.ndof}")
    thr = kp_methods.thresholds_of(kp.replace(name=name))
    if thr is None:
        thr = torch.zeros(sv.ndof, dtype=torch.float64, device=model.device)
    return KeypointPlanArgs(
        name, torch.as_tensor([int(i) for i in sv.order], dtype=torch.int32,
                              device=model.device),
        thr.to(torch.float64).contiguous(), kp.min_N, kp.max_N,
        1.0 / float(model.timestep))


def keypoint_plan(pa: KeypointPlanArgs, qvel, H: int, K_max: int,
                  mask=None, time_slots: bool = False, plain: bool = False):
    """K9a: the keypoint mask of the method (`pa`) over the nominal's
    velocities qvel (>=H, nv, B), or the given mask (H, n, B) for
    pa.name == "mask", and its per-lane slot plan under the budget K_max
    -> methods.LanePlan.  Plain twin: methods.generate_keypoints on the
    state dofs' velocities, then methods.lane_plan."""
    n, B = pa.order.shape[0], qvel.shape[-1]
    if (mask is None) != (pa.name != "mask"):
        raise ValueError("a mask goes with the \"mask\" selector alone")
    if _on_cpu(qvel, pa.order) or plain:
        if mask is None:
            vel = qvel[:H].index_select(1, pa.order.long())
            cfg = kp_methods.KeypointConfig(
                name=pa.name, min_N=pa.min_N, max_N=pa.max_N,
                jerk_thresholds=pa.thr, accel_thresholds=pa.thr,
                velocity_change_thresholds=pa.thr)
            mask = kp_methods.generate_keypoints(cfg, vel, pa.inv_dt)
        return kp_methods.lane_plan(mask.clone(), K_max, time_slots)
    nv = qvel.shape[1]
    _check("qvel", qvel, (qvel.shape[0], nv, B))
    if qvel.shape[0] < H or not 2 <= K_max <= H:
        raise ValueError(f"need H={H} <= the trajectory's length and "
                         f"2 <= K_max={K_max} <= H")
    if mask is not None:
        _check("mask", mask, (H, n, B), torch.bool)
    dev = qvel.device
    f64 = dict(dtype=torch.float64, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = kp_methods.LanePlan(
        mask=torch.empty((H, n, B), dtype=torch.bool, device=dev),
        slot_t=torch.empty((K_max, B), dtype=torch.int64, device=dev),
        count=torch.empty((B,), **i32), overflow=torch.empty((B,), **i32),
        pslot=torch.empty((H, n, B), **i32),
        nslot=torch.empty((H, n, B), **i32),
        w=torch.empty((H, n, B), **f64), pct=torch.empty((B,), **f64))
    _launch("keypoint_plan", "generic", "trajopt_keypoint_plan",
            _p(qvel), _p(pa.order), _p(pa.thr),
            ctypes.c_void_p(mask.data_ptr() if mask is not None else None),
            ctypes.c_int(SELECTORS[pa.name]), ctypes.c_int(pa.min_N),
            ctypes.c_int(pa.max_N), ctypes.c_int(K_max),
            ctypes.c_int(int(time_slots)), ctypes.c_double(pa.inv_dt),
            ctypes.c_double(100.0 / (H * n)), ctypes.c_int(H),
            ctypes.c_int(n), ctypes.c_int(nv), ctypes.c_int(B),
            *(_p(x) for x in out))
    return out


def kp_interp(J, pslot, nslot, w, col_dof, nx: int, plain: bool = False):
    """K9b: slot Jacobians J (K, 2n, C, B) lerped per column to the full
    horizon between each column's dof's previous and next slot (pslot,
    nslot (H, n, B) int32, w (H, n, B)); col_dof (C,) int32 -> A (H, 2n,
    2n, B), Bm (H, 2n, C - 2n, B).  Plain twin:
    keypoints/interpolate.py:lerp_columns."""
    if _on_cpu(J, pslot, nslot, w, col_dof) or plain:
        return lerp_columns(J, pslot, nslot, w, col_dof.long(), nx)
    K, rows, C, B = J.shape
    H, n = pslot.shape[:2]
    _check("J", J, (K, nx, C, B))
    _check("pslot", pslot, (H, n, B), torch.int32)
    _check("nslot", nslot, (H, n, B), torch.int32)
    _check("w", w, (H, n, B))
    _check("col_dof", col_dof, (C,), torch.int32)
    f64 = dict(dtype=torch.float64, device=J.device)
    A = torch.empty((H, nx, nx, B), **f64)
    Bm = torch.empty((H, nx, C - nx, B), **f64)
    _launch("kp_interp", "generic", "trajopt_kp_interp", _p(J), _p(pslot),
            _p(nslot), _p(w), _p(col_dof), ctypes.c_int(K), ctypes.c_int(H),
            ctypes.c_int(n), ctypes.c_int(nx), ctypes.c_int(C),
            ctypes.c_int(B), _p(A), _p(Bm))
    return A, Bm


def ie_node_mse_plain(cache, s, mid, e, n: int):
    """K9c's twin: per (node, dof, lane) the mean squared difference over
    the n velocity rows between dof d's A columns d and n + d at the
    midpoint and the mean of the two ends, halved over the two columns;
    each sum runs left to right over the rows, as the kernel's, and the
    means multiply by 1/n, as the JAX program's."""
    inv_n = 1.0 / n
    cols = torch.arange(n, device=cache.device)
    s0 = s1 = None
    for r in range(n, 2 * n):
        X = cache[:, r]                                # (H, C, B)
        diff = X[mid] - 0.5 * (X[s] + X[e])            # (m, C, B)
        d0, d1 = diff[:, cols], diff[:, n + cols]
        s0 = d0 * d0 if s0 is None else s0 + d0 * d0
        s1 = d1 * d1 if s1 is None else s1 + d1 * d1
    return 0.5 * (s0 * inv_n + s1 * inv_n)


def ie_mse(cache, s, mid, e, n: int, plain: bool = False):
    """K9c: the iterative_error bisection test (JAX `solver/lanes.py:
    _ie_node_mse:459`) on the column cache (H, 2n, C, B) at nodes s, mid,
    e (m,) int32 -> mse (m, n, B)."""
    if _on_cpu(cache, s, mid, e) or plain:
        return ie_node_mse_plain(cache, s.long(), mid.long(), e.long(), n)
    H, nx, C, B = cache.shape
    m = s.shape[0]
    _check("cache", cache, (H, 2 * n, C, B))
    for name, x in (("s", s), ("mid", mid), ("e", e)):
        _check(name, x, (m,), torch.int32)
    out = torch.empty((m, n, B), dtype=torch.float64, device=cache.device)
    _launch("ie_mse", "generic", "trajopt_ie_mse", _p(cache), _p(s),
            _p(mid), _p(e), ctypes.c_int(m), ctypes.c_int(n), ctypes.c_int(C),
            ctypes.c_int(B), ctypes.c_double(1.0 / n), _p(out))
    return out
