"""Kernel wrappers: the hand-written CUDA kernels for tensors on a CUDA
device, their plain PyTorch twins for tensors on the CPU.  `plain=True`
runs the twin on any device; chip_smoke.py uses it to hold each kernel
against its twin on the card.

A build or launch failure raises; there is no quiet fallback to the plain
version on the card.  Each wrapper adds one to `LAUNCHES[name]` where it
launches its kernel, so a run can show that its main path went through the
kernels.

The kernels cover trees whose bodies carry one hinge or slide joint or none,
joint limits (the constraint solve K2a, csrc/constraint.cuh, a device
function inside the step), no contacts, a full state vector and the
joint-space residual.  Their topology (sizes, slide-joint mask, parent and
body-dof codes, limited-joint mask) is a template argument; the instances
built are listed in csrc/instances.cuh.
"""

from __future__ import annotations

import ctypes
import re
from typing import NamedTuple, Tuple

import torch

from ..derivs.fd import fd_slot_jacobians
from ..dynamics.contact import LIMIT_FIELDS, limit_constants
from ..dynamics.model import HINGE, SLIDE, Model
from ..dynamics.step import check_smooth
from ..solver import ilqr as twins
from ..tasks.base import Task, control_limits
from . import build

KERNELS = ("rollout", "linesearch", "fd_jacobian", "backward")
LAUNCHES = {name: 0 for name in KERNELS}

# replaced lane program of the JAX package, per kernel
REPLACES = {
    "rollout": "trajoptkp_tpu/solver/lanes.py:263",
    "linesearch": "trajoptkp_tpu/solver/lanes.py:750",
    "fd_jacobian": "trajoptkp_tpu/solver/lanes.py:282",
    "backward": "trajoptkp_tpu/solver/lanes.py:632",
}
# device functions inside rollout, linesearch and fd_jacobian: the step (K1)
# and, for a model with joint limits, the constraint solve (K2a)
DEVICE_FUNCTIONS = {
    "step": ("trajoptkp_tpu_torch/kernels/csrc/step.cuh",
             "trajoptkp_tpu/dynamics/lanes.py:1595"),
    "constraint": ("trajoptkp_tpu_torch/kernels/csrc/constraint.cuh",
                   "trajoptkp_tpu/dynamics/lanes.py:1523"),
}

# numeric model buffer layout, mirrored by csrc/step.cuh
BODY_FIELDS = (("body_pos", 3), ("body_quat", 4), ("body_ipos", 3),
               ("body_iquat", 4), ("body_mass", 1), ("body_inertia", 3),
               ("jnt_pos", 3), ("jnt_axis", 3), ("qpos0", 1),
               ("jnt_stiffness", 1), ("qpos_spring", 1), ("dof_damping", 1),
               ("dof_armature", 1))
# per body 1..nbody-1 (joint fields zero for a body without a joint); then
# per actuator: dof, gear, ctrllimited, lo, hi; per limited joint:
# dynamics/contact.py LIMIT_FIELDS; gravity (3); timestep


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# topology -> instance
# ---------------------------------------------------------------------------


def body_dofs(model: Model):
    """dof of each body, -1 for a body without a joint, or raise."""
    dofs = [-1] * model.nbody
    for j, b in enumerate(model.jnt_bodyid):
        if dofs[b] != -1:
            raise NotImplementedError(
                "the kernels take at most one joint per body")
        dofs[b] = model.jnt_dofadr[j]
    return dofs


def model_topology(model: Model) -> Tuple[int, ...]:
    """(NV, NU, NBODY, slide mask, parent code, body-dof code, limited
    mask) of a kernel-ready model, or raise."""
    check_smooth(model)
    nv = model.nv
    ok = model.nq == nv and model.njnt == nv and nv <= 15 \
        and model.nbody <= 16
    for j in range(model.njnt):
        ok = ok and (model.jnt_type[j] in (HINGE, SLIDE)
                     and model.jnt_qposadr[j] == j
                     and model.jnt_dofadr[j] == j)
    for b in range(1, model.nbody):
        ok = ok and model.body_parent[b] < b
    for a in range(model.nu):
        ok = ok and model.actuator_trnid[a] < model.njnt
    if not ok:
        raise NotImplementedError(
            "the kernels take trees of up to 16 bodies with one hinge or "
            "slide joint per body or none; free and ball joints are ROADMAP "
            "Queue 1 items 7b and 11")
    if any(model.jnt_limited) and not limit_constants(model).int_power:
        raise NotImplementedError(
            "the kernels multiply the impedance power out: solimp[4] must "
            "be an integer from 1 to 8")
    dofs = body_dofs(model)
    slide = sum(1 << j for j in range(nv) if model.jnt_type[j] == SLIDE)
    parents = sum(model.body_parent[b] << (4 * b)
                  for b in range(1, model.nbody))
    bodydof = sum((dofs[b] + 1) << (4 * b) for b in range(1, model.nbody))
    limited = sum(1 << model.jnt_dofadr[j]
                  for j in limit_constants(model).joints)
    return nv, model.nu, model.nbody, slide, parents, bodydof, limited


def instances() -> dict:
    """(NV, NU, NJ, NUR, NBODY, slide mask, parent code, body-dof code,
    limited mask) -> instance tag, from instances.cuh.  The limited mask in
    the key fixes the row count of the constraint solve, so a model with
    limits never runs through an instance without them."""
    text = (build.CSRC / "instances.cuh").read_text()
    out = {}
    pat = (r"X\((\w+)" + r",\s*(\d+)" * 5
           + r",\s*(0x[0-9a-fA-F]+)u,\s*(0x[0-9a-fA-F]+)ull"
             r",\s*(0x[0-9a-fA-F]+)ull,\s*(0x[0-9a-fA-F]+)u\)")
    for m in re.findall(pat, text):
        key = tuple(int(x) for x in m[1:6]) + tuple(int(x, 16) for x in m[6:])
        out[key] = m[0]
    return out


def backward_instances() -> set:
    """(NX, NU) pairs of the backward-pass instances in instances.cuh."""
    text = (build.CSRC / "instances.cuh").read_text()
    return {(int(a), int(b))
            for a, b in re.findall(r"B\((\d+),\s*(\d+)\)", text)}


class KernelArgs(NamedTuple):
    tag: str
    nv: int
    nu: int
    model_buf: torch.Tensor   # packed model parameters
    task_buf: torch.Tensor    # w_run (nres), w_term (nres), lo (nu), hi (nu)
    model: Model              # keeps the cache key alive


_ARGS_CACHE: dict = {}


def pack_model(model: Model) -> torch.Tensor:
    rows = []
    dofs = body_dofs(model)
    for b in range(1, model.nbody):
        j = dofs[b]            # joint index = dof index = qpos index
        for field, width in BODY_FIELDS:
            x = getattr(model, field)
            if field.startswith("body_"):
                rows.append(x[b].reshape(width))
            elif j < 0:
                rows.append(torch.zeros(width, dtype=x.dtype,
                                        device=x.device))
            else:
                rows.append(x[j].reshape(width))
    for a in range(model.nu):
        j = model.actuator_trnid[a]
        rng = model.actuator_ctrlrange[a]
        rows.append(torch.stack([
            torch.tensor(float(model.jnt_dofadr[j]), dtype=rng.dtype,
                         device=rng.device),
            model.actuator_gear[a, 0],
            torch.tensor(float(model.actuator_ctrllimited[a]), dtype=rng.dtype,
                         device=rng.device),
            rng[0], rng[1]]))
    lc = limit_constants(model)
    rows.append(lc.table.reshape(len(lc.joints) * len(LIMIT_FIELDS)))
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
    kind = task.residual_kind
    if (len(kind) != 3 or kind[0] != "joint_space"
            or not 0 < kind[1] <= model.nv or not 0 <= kind[2] <= model.nu
            or task.nres != 2 * kind[1] + kind[2]):
        raise NotImplementedError(
            "the kernels compute the joint-space residual (\"joint_space\", "
            f"nj <= nv, nr <= nu); task residual is {kind}; FK residuals are "
            "ROADMAP Queue 1 item 7b")
    topo = model_topology(model)
    topo = topo[:2] + tuple(kind[1:]) + topo[2:]
    tag = instances().get(topo)
    if tag is None:
        raise NotImplementedError(
            f"no kernel instance for topology {topo}; add it to "
            "kernels/csrc/instances.cuh")
    if not task.sv.is_full:
        raise NotImplementedError("the kernels need the full state vector")
    lim = control_limits(task)
    task_buf = torch.cat([task.weights, task.weights_terminal, lim[:, 0],
                          lim[:, 1]]).contiguous()
    args = KernelArgs(tag, model.nv, model.nu, pack_model(model), task_buf,
                      model)
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


def _launch(kernel: str, symbol: str, *args):
    fn = getattr(build.load(kernel), symbol)
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
    """K3.  qpos0 (nq, B), qvel0 (nv, B), U (H, nu, B), targets (nres, B)
    -> qpos (H+1, nq, B), qvel (H+1, nv, B), costs (H, B)."""
    if _on_cpu(qpos0, qvel0, U, targets) or plain:
        return twins.rollout(task, qpos0, qvel0, U, targets)
    ka = kernel_args(task, U.device)
    H, B = U.shape[0], U.shape[-1]
    nv, nu, nres = ka.nv, ka.nu, task.nres
    _check("qpos0", qpos0, (nv, B))
    _check("qvel0", qvel0, (nv, B))
    _check("U", U, (H, nu, B))
    _check("targets", targets, (nres, B))
    f64 = dict(dtype=torch.float64, device=U.device)
    qpos = torch.empty((H + 1, nv, B), **f64)
    qvel = torch.empty((H + 1, nv, B), **f64)
    costs = torch.empty((H, B), **f64)
    _launch("rollout", f"trajopt_rollout_{ka.tag}", _p(ka.model_buf),
            _p(ka.task_buf), _p(qpos0), _p(qvel0), _p(U), _p(targets),
            _p(qpos), _p(qvel), _p(costs), ctypes.c_int(H), ctypes.c_int(B))
    return qpos, qvel, costs


def linesearch(task: Task, qpos, qvel, U, k, K, alphas, targets,
               plain: bool = False):
    """K4.  All alphas' rollouts under u = clip(u_nom + α k + K dx):
    -> qpos (H+1, nq, A, B), qvel (H+1, nv, A, B), ctrl (H, nu, A, B),
    costs (H, A, B)."""
    if _on_cpu(qpos, qvel, U, k, K, alphas, targets) or plain:
        return twins.forward_pass_rollouts(task, qpos, qvel, U, k, K, alphas,
                                           targets)
    ka = kernel_args(task, U.device)
    H, B = U.shape[0], U.shape[-1]
    nv, nu, nres, nA = ka.nv, ka.nu, task.nres, alphas.shape[0]
    _check("qpos", qpos, (H + 1, nv, B))
    _check("qvel", qvel, (H + 1, nv, B))
    _check("U", U, (H, nu, B))
    _check("k", k, (H, nu, B))
    _check("K", K, (H, nu, 2 * nv, B))
    _check("alphas", alphas, (nA,))
    _check("targets", targets, (nres, B))
    f64 = dict(dtype=torch.float64, device=U.device)
    qps = torch.empty((H + 1, nv, nA, B), **f64)
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
    """K5.  Central-FD [A|B] at the slot times: qpos (>=H, nq, B) trajectory,
    times (K,) int64 -> J (K, 2n, 2n+nu, B)."""
    if _on_cpu(qpos, qvel, U, times) or plain:
        J = fd_slot_jacobians(task.model, task.sv,
                              qpos[times].transpose(0, 1),
                              qvel[times].transpose(0, 1),
                              U[times].transpose(0, 1), eps)
        return J.movedim(2, 0)                         # (K, 2n, C, B)
    ka = kernel_args(task, U.device)
    H, B = U.shape[0], U.shape[-1]
    nv, nu, nK = ka.nv, ka.nu, times.shape[0]
    _check("qpos", qpos, (qpos.shape[0], nv, B))
    _check("qvel", qvel, (qvel.shape[0], nv, B))
    _check("U", U, (H, nu, B))
    _check("times", times, (nK,), torch.int64)
    if qpos.shape[0] < H or qvel.shape[0] < H:
        raise ValueError("trajectory shorter than the controls")
    if nK and not (0 <= int(times.min()) and int(times.max()) < H):
        raise ValueError(f"slot times must lie in [0, {H})")
    J = torch.empty((nK, 2 * nv, 2 * nv + nu, B), dtype=torch.float64,
                    device=U.device)
    _launch("fd_jacobian", f"trajopt_fd_jacobian_{ka.tag}", _p(ka.model_buf),
            _p(qpos), _p(qvel), _p(U), _p(times), ctypes.c_double(eps),
            _p(J), ctypes.c_int(nK), ctypes.c_int(B))
    return J


def backward(A, Bm, l_x, l_xx, l_u, l_uu, lamb, cfg, plain: bool = False):
    """K7.  Riccati sweep with the per-lane λ retry of
    `backward_pass_lambda_loop` -> (k, K, dJ, new λ, λ-exit)."""
    if _on_cpu(A, Bm, l_x, l_xx, l_u, l_uu, lamb) or plain:
        return twins.backward_pass_lambda_loop(A, Bm, l_x, l_xx, l_u, l_uu,
                                               lamb, cfg)
    H, nx, B = l_x.shape
    nu = l_u.shape[1]
    tag = f"nx{nx}_nu{nu}"
    if (nx, nu) not in backward_instances():
        raise NotImplementedError(
            f"no backward-pass instance for nx={nx}, nu={nu}; add it to "
            "kernels/csrc/instances.cuh")
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
    sched = torch.tensor([cfg.lambda_factor, cfg.min_lambda, cfg.max_lambda],
                         **f64)
    _launch("backward", f"trajopt_backward_{tag}", _p(A), _p(Bm), _p(l_x),
            _p(l_xx), _p(l_u), _p(l_uu), _p(lamb), _p(sched), _p(k), _p(K),
            _p(dJ), _p(lam), _p(exited), ctypes.c_int(H), ctypes.c_int(B))
    return k, K, dJ, lam, exited.bool()
