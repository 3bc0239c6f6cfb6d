"""Kernel wrappers: the hand-written CUDA kernels for tensors on a CUDA
device, their plain PyTorch twins for tensors on the CPU.  `plain=True`
runs the twin on any device; chip_smoke.py uses it to hold each kernel
against its twin on the card.

A build or launch failure raises; there is no quiet fallback to the plain
version on the card.  Each wrapper adds one to `LAUNCHES[name]` where it
launches its kernel, so a run can show that its main path went through the
kernels.

The kernels cover trees whose bodies carry one hinge, slide or free joint or
none, joint limits and plane-cylinder and cylinder-cylinder contacts (the
contact rows K2b, csrc/contact.cuh, and the constraint solve K2a,
csrc/constraint.cuh, device functions inside the step), a state vector of
hinge, slide and free-translation dofs, and the joint-space or the pushing
tasks' FK residual.  Their topology (sizes, joint masks and codes, qpos
addresses, state-vector dofs, contact pairs, residual kind) is a template
argument; the instances built are listed in csrc/instances.cuh.  One more
entry point runs a device function of the step alone: `fk_bias` (the FK
products and bias force, for the pushing tasks' servo).
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple, Tuple

import torch

from ..derivs.fd import fd_slot_jacobians
from ..dynamics.contact import (LIMIT_FIELDS, contact_constants,
                                limit_constants)
from ..dynamics.fk import forward_kinematics
from ..dynamics.model import FREE, HINGE, SLIDE, Data, Model
from ..dynamics.smooth import bias_force
from ..solver import ilqr as twins
from ..tasks.base import Task, control_limits
from . import build

KERNELS = ("rollout", "linesearch", "fd_jacobian", "backward")
# the FK products and bias force of the pushing tasks' servo (in the rollout
# library), launched by the servo that starts a push solve
SERVO_KERNELS = ("fk_bias",)
LAUNCHES = {name: 0 for name in KERNELS + SERVO_KERNELS}

# replaced lane program of the JAX package, per kernel
REPLACES = {
    "rollout": "trajoptkp_tpu/solver/lanes.py:263",
    "linesearch": "trajoptkp_tpu/solver/lanes.py:750",
    "fd_jacobian": "trajoptkp_tpu/solver/lanes.py:282",
    "backward": "trajoptkp_tpu/solver/lanes.py:632",
}
# device functions inside rollout, linesearch and fd_jacobian: the step (K1),
# for a model with joint limits or contacts the constraint solve (K2a), and
# for a model with contacts the narrow phase and contact rows (K2b)
DEVICE_FUNCTIONS = {
    "step": ("trajoptkp_tpu_torch/kernels/csrc/step.cuh",
             "trajoptkp_tpu/dynamics/lanes.py:1595"),
    "constraint": ("trajoptkp_tpu_torch/kernels/csrc/constraint.cuh",
                   "trajoptkp_tpu/dynamics/lanes.py:1523"),
    "contact": ("trajoptkp_tpu_torch/kernels/csrc/contact.cuh",
                "trajoptkp_tpu/dynamics/lanes.py:989"),
}

# numeric model buffer layout, mirrored by csrc/step.cuh
BODY_FIELDS = (("body_pos", 3), ("body_quat", 4), ("body_ipos", 3),
               ("body_iquat", 4), ("body_mass", 1), ("body_inertia", 3),
               ("jnt_pos", 3), ("jnt_axis", 3), ("qpos0", 1),
               ("jnt_stiffness", 1), ("qpos_spring", 1))
DOF_FIELDS = ("dof_damping", "dof_armature")
# per body 1..nbody-1 (joint fields zero for a body without a joint or with
# a free one); per dof DOF_FIELDS; per actuator: dof, gear, ctrllimited, lo,
# hi; per limited joint: dynamics/contact.py LIMIT_FIELDS; per contact pair:
# geom1 pos, quat, size, geom2 pos, quat, size, CONTACT_FIELDS; gravity (3);
# timestep
RES_KINDS = {"joint_space": 0, "push": 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# topology -> instance
# ---------------------------------------------------------------------------


def body_joints(model: Model):
    """joint of each body, -1 for a body without a joint, or raise."""
    joints = [-1] * model.nbody
    for j, b in enumerate(model.jnt_bodyid):
        if joints[b] != -1:
            raise NotImplementedError(
                "the kernels take at most one joint per body")
        joints[b] = j
    return joints


def body_dofs(model: Model):
    """first dof of each body, -1 for a body without a joint, or raise."""
    return [model.jnt_dofadr[j] if j >= 0 else -1
            for j in body_joints(model)]


def _scope_error(why: str):
    return NotImplementedError(
        f"the kernels take trees of up to 16 bodies (qpos and qvel up to 15 "
        f"entries) with one hinge, slide or free joint per body or none: "
        f"{why}; ball joints are ROADMAP Queue 1 item 11")


def model_topology(model: Model) -> Tuple[int, ...]:
    """(NV, NU, NBODY, slide mask, free mask, parent code, body-dof code,
    qpos-address code, limited mask, contact-pair count, pair code) of a
    kernel-ready model, or raise."""
    nv, nq = model.nv, model.nq
    if nv > 15 or nq > 15 or model.nbody > 16:
        raise _scope_error(f"nq {nq}, nv {nv}, nbody {model.nbody}")
    joints = body_joints(model)
    dof = 0
    for b in range(1, model.nbody):
        j = joints[b]
        if model.body_parent[b] >= b:
            raise _scope_error("bodies must follow their parents")
        if j < 0:
            continue
        jt = model.jnt_type[j]
        if jt not in (HINGE, SLIDE, FREE):
            raise _scope_error(f"joint {model.joint_names[j]} is a ball")
        if jt == FREE and model.body_parent[b] != 0:
            raise _scope_error("a free joint's body must hang from the world")
        if model.jnt_dofadr[j] != dof:
            raise _scope_error("dofs must follow the body order")
        dof += 6 if jt == FREE else 1
    for a in range(model.nu):
        if model.jnt_type[model.actuator_trnid[a]] not in (HINGE, SLIDE):
            raise _scope_error("actuators must drive hinge or slide joints")
    if any(model.jnt_limited) and not limit_constants(model).int_power:
        raise NotImplementedError(
            "the kernels multiply the impedance power out: solimp[4] must "
            "be an integer from 1 to 8")
    cc = contact_constants(model)
    if len(cc.pairs) > 4 or cc.nslot > 32:
        raise _scope_error(f"{len(cc.pairs)} contact pairs, {cc.nslot} slots "
                           "(the kernels take 4 pairs, 32 slots)")
    if cc.pairs and not cc.int_power:
        raise NotImplementedError(
            "the kernels multiply the impedance power out: contact solimp[4] "
            "must be an integer from 1 to 8")
    dofs = body_dofs(model)
    slide = sum(1 << model.jnt_dofadr[j] for j in range(model.njnt)
                if model.jnt_type[j] == SLIDE)
    free = sum(1 << b for b in range(1, model.nbody)
               if joints[b] >= 0 and model.jnt_type[joints[b]] == FREE)
    parents = sum(model.body_parent[b] << (4 * b)
                  for b in range(1, model.nbody))
    bodydof = sum((dofs[b] + 1) << (4 * b) for b in range(1, model.nbody))
    qadr = sum(model.jnt_qposadr[joints[b]] << (4 * b)
               for b in range(1, model.nbody) if joints[b] >= 0)
    limited = sum(1 << model.jnt_dofadr[j]
                  for j in limit_constants(model).joints)
    pairs = sum((pr.types[0] | pr.types[1] << 4 | pr.bodies[0] << 8
                 | pr.bodies[1] << 12) << (16 * p)
                for p, pr in enumerate(cc.pairs))
    return (nv, model.nu, model.nbody, slide, free, parents, bodydof, qadr,
            limited, len(cc.pairs), pairs)


def state_key(model: Model, sv) -> Tuple[int, int]:
    """(NDOF, state-dof code) of a state vector the kernels take, or raise:
    hinge, slide or free-translation dofs, all active, at most 15."""
    scalar = set()
    for j in range(model.njnt):
        d = model.jnt_dofadr[j]
        if model.jnt_type[j] in (HINGE, SLIDE):
            scalar.add(d)
        elif model.jnt_type[j] == FREE:
            scalar.update((d, d + 1, d + 2))
    if (sv.ndof > 15 or any(i not in scalar for i in sv.order)
            or not bool((sv.active > 0.5).all())):
        raise NotImplementedError(
            "the kernels take a state vector of at most 15 active hinge, "
            "slide or free-translation dofs (a free rotation's tangent is "
            f"ROADMAP Queue 1 item 11); it has {sv.names}")
    return sv.ndof, sum(i << (4 * k) for k, i in enumerate(sv.order))


def _push_kind(task: Task) -> bool:
    """("push", 0, goal body, end-effector site) of a kernel-ready task."""
    model, kind = task.model, task.residual_kind
    return (len(kind) == 4 and kind[:2] == ("push", 0) and task.nres == 4
            and 0 < kind[2] < model.nbody and 0 <= kind[3] < model.nsite)


def residual_key(task: Task) -> Tuple[int, int, int]:
    """(RES, RESA, RESB) of the task's residual kind, or raise."""
    model, kind = task.model, task.residual_kind
    if (len(kind) == 3 and kind[0] == "joint_space"
            and 0 < kind[1] <= model.nv and 0 <= kind[2] <= model.nu
            and task.nres == 2 * kind[1] + kind[2]):
        return RES_KINDS["joint_space"], kind[1], kind[2]
    if _push_kind(task):
        return RES_KINDS["push"], kind[2], model.site_bodyid[kind[3]]
    raise NotImplementedError(
        "the kernels compute the joint-space residual (\"joint_space\", "
        "nj <= nv, nr <= nu) and the pushing FK residual (\"push\", 0, "
        f"goal body, ee site); task residual is {kind}; clutter (\"push\", "
        "n > 0) is ROADMAP Queue 1 item 7b")


def residual_constants(task: Task) -> torch.Tensor:
    """The residual's constants at the end of the task buffer: for the
    pushing residual the end-effector site's position on its body."""
    model = task.model
    if _push_kind(task):
        return model.site_pos[task.residual_kind[3]].reshape(3)
    return torch.zeros(0, dtype=model.dtype, device=model.device)


_HEX = r",\s*(0x[0-9a-fA-F]+)u(?:ll)?"
_INT = r",\s*(\d+)"


@functools.lru_cache(maxsize=None)
def instances() -> dict:
    """(NV, NU, NBODY, slide mask, free mask, parent code, body-dof code,
    qpos-address code, limited mask, NDOF, state-dof code, NPAIR, pair
    code, RES, RESA, RESB) -> instance tag, from instances.cuh (read once).
    The limited mask and the pairs in the key fix the rows of the constraint
    solve, so a model with limits or contacts never runs through an instance
    without them."""
    text = (build.CSRC / "instances.cuh").read_text().replace("\\\n", " ")
    pat = (r"X\((\w+)" + _INT * 3 + _HEX * 6 + _INT + _HEX + _INT + _HEX
           + _INT * 3 + r"\)")
    out = {}
    for m in re.findall(pat, text):
        out[tuple(int(x, 0) for x in m[1:])] = m[0]
    return out


@functools.lru_cache(maxsize=None)
def backward_instances() -> frozenset:
    """(NX, NU) pairs of the backward-pass instances in instances.cuh
    (read once)."""
    text = (build.CSRC / "instances.cuh").read_text()
    return frozenset((int(a), int(b))
                     for a, b in re.findall(r"B\((\d+),\s*(\d+)\)", text))


def instance_key(task: Task) -> Tuple[int, ...]:
    """The instances.cuh key of a task, or raise outside the scope."""
    topo = model_topology(task.model)
    return (topo[:9] + state_key(task.model, task.sv) + topo[9:]
            + residual_key(task))


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
    joints = body_joints(model)
    dt = dict(dtype=model.dtype, device=model.device)
    for b in range(1, model.nbody):
        j = joints[b]
        scalar = j >= 0 and model.jnt_type[j] in (HINGE, SLIDE)
        for field, width in BODY_FIELDS:
            x = getattr(model, field)
            if field.startswith("body_"):
                rows.append(x[b].reshape(width))
            elif not scalar:
                rows.append(torch.zeros(width, **dt))
            elif field in ("qpos0", "qpos_spring"):
                rows.append(x[model.jnt_qposadr[j]].reshape(width))
            else:
                rows.append(x[j].reshape(width))
    rows.append(torch.stack([getattr(model, f) for f in DOF_FIELDS],
                            1).reshape(-1))
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


def _launch(kernel: str, symbol: str, *args, library: str = None):
    fn = getattr(build.load(library or kernel), symbol)
    fn.argtypes = [type(a) for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: cudaError {err} "
                           f"({build.error_string(err)})")
    LAUNCHES[kernel] += 1


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed devices: {sorted(devs)}")


# ---------------------------------------------------------------------------
# the four kernels
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
    _launch("rollout", f"trajopt_rollout_{ka.tag}", _p(ka.model_buf),
            _p(ka.task_buf), _p(qpos0), _p(qvel0), _p(U), _p(targets),
            _p(qpos), _p(qvel), _p(costs), ctypes.c_int(H), ctypes.c_int(B))
    return qpos, qvel, costs


def linesearch(task: Task, qpos, qvel, U, k, K, alphas, targets,
               plain: bool = False):
    """K4.  All alphas' rollouts under u = clip(u_nom + α k + K dx), K over
    the state vector's 2 ndof tangent dofs:
    -> qpos (H+1, nq, A, B), qvel (H+1, nv, A, B), ctrl (H, nu, A, B),
    costs (H, A, B)."""
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
    _launch("linesearch", f"trajopt_linesearch_{ka.tag}", _p(ka.model_buf),
            _p(ka.task_buf), _p(qpos), _p(qvel), _p(U), _p(k), _p(K),
            _p(alphas), _p(targets), _p(qps), _p(qvs), _p(us), _p(cs),
            ctypes.c_int(H), ctypes.c_int(nA), ctypes.c_int(B))
    return qps, qvs, us, cs


def fd_jacobian(task: Task, qpos, qvel, U, times, eps: float,
                plain: bool = False):
    """K5.  Central-FD [A|B] over the state vector at the slot times: qpos
    (>=H, nq, B) trajectory, times (K,) int64 -> J (K, 2n, 2n+nu, B)."""
    if _on_cpu(qpos, qvel, U, times) or plain:
        J = fd_slot_jacobians(task.model, task.sv,
                              qpos[times].transpose(0, 1),
                              qvel[times].transpose(0, 1),
                              U[times].transpose(0, 1), eps)
        return J.movedim(2, 0)                         # (K, 2n, C, B)
    ka = kernel_args(task, U.device)
    H, B = U.shape[0], U.shape[-1]
    nq, nv, nu, nx, nK = ka.nq, ka.nv, ka.nu, ka.sv.nx, times.shape[0]
    _check("qpos", qpos, (qpos.shape[0], nq, B))
    _check("qvel", qvel, (qvel.shape[0], nv, B))
    _check("U", U, (H, nu, B))
    _check("times", times, (nK,), torch.int64)
    if qpos.shape[0] < H or qvel.shape[0] < H:
        raise ValueError("trajectory shorter than the controls")
    if nK and not (0 <= int(times.min()) and int(times.max()) < H):
        raise ValueError(f"slot times must lie in [0, {H})")
    J = torch.empty((nK, nx, nx + nu, B), dtype=torch.float64,
                    device=U.device)
    _launch("fd_jacobian", f"trajopt_fd_jacobian_{ka.tag}", _p(ka.model_buf),
            _p(qpos), _p(qvel), _p(U), _p(times), ctypes.c_double(eps),
            _p(J), ctypes.c_int(nK), ctypes.c_int(B))
    return J


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


def backward(A, Bm, l_x, l_xx, l_u, l_uu, lamb, cfg, plain: bool = False):
    """K7.  Riccati sweep with the per-lane λ retry of
    `backward_pass_lambda_loop` -> (k, K, dJ, new λ, λ-exit)."""
    if _on_cpu(A, Bm, l_x, l_xx, l_u, l_uu, lamb) or plain:
        return twins.backward_pass_lambda_loop(A, Bm, l_x, l_xx, l_u, l_uu,
                                               lamb, cfg)
    H, nx, B = l_x.shape
    nu = l_u.shape[1]
    symbol, sched = backward_args(nx, nu, cfg, A.device)
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
    _launch("backward", symbol, _p(A), _p(Bm), _p(l_x), _p(l_xx), _p(l_u),
            _p(l_uu), _p(lamb), _p(sched), _p(k), _p(K), _p(dJ), _p(lam),
            _p(exited), ctypes.c_int(H), ctypes.c_int(B))
    return k, K, dJ, lam, exited.bool()


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
    _launch("fk_bias", f"trajopt_fk_bias_{ka.tag}", _p(ka.model_buf),
            _p(qpos), _p(qvel), _p(xpos), _p(xquat), _p(cdof), _p(bias),
            ctypes.c_int(B), library="rollout")
    return xpos, xquat, cdof, bias
