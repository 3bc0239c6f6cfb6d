"""Smooth dynamics: mass matrix, bias, passive and actuator forces
(counterpart of `trajoptkp_tpu/dynamics/smooth.py:29-120`).

The JAX package writes CRBA and RNE as masked einsums over ancestor masks.
The port computes the same quantities by the recursions over the body tree
that the kernels run per thread (kernels/csrc/step.cuh), operation for
operation in the same order, so that on the card this plain twin and the
kernels round alike:

    cvel_b = cvel_parent + cdof_i qvel_i  (summed over the body's dofs)
    cacc_b = cacc_parent + (cvel_parent x cdof_i) qvel_i,  cacc_0 = [0; -g]
    f_b    = I_b cacc_b + cvel_b x* (I_b cvel_b)
    bias_i = cdof_i . (sum of f over the subtree of body_i)
    M_ij   = cdof_j . (Ic_body_i cdof_i) for j on the root path of i (the
             body's own earlier dofs included), Ic = composite inertia

Scope: bodies with one hinge, slide or free joint or with none (a welded
body carries its inertia and force to its parent without a dof; panda has
three).  A free joint's six dofs (JAX `model._path_dofs`): the translations
move along world axes and their cdof does not change; the rotations turn
about the body's own axes, so the whole body twist drives them:
cacc_b = cacc_parent + sum over the rotations of (cvel_b x cdof_i) qvel_i.
Ball joints wait in ROADMAP under the engine outside the lane scope.
"""

from __future__ import annotations

import torch

from ..utils.math import clip, cross, cross_force, cross_motion
from .model import FREE, HINGE, SLIDE, Data, Model, dof_width

_JROWS = ((0, 3, 4), (3, 1, 5), (4, 5, 2))  # symmetric 3x3 from SYM6


def body_dofs(model: Model):
    """Per body, its joints' dofs in declaration order (() for a body
    without a joint), or raise outside the scope: hinge and slide joints,
    or one free joint alone."""
    dofs = [()] * model.nbody
    free = free_bodies(model)
    for j, b in enumerate(model.jnt_bodyid):
        jt = model.jnt_type[j]
        if jt not in (HINGE, SLIDE, FREE) or (b in free and dofs[b]):
            raise NotImplementedError(
                "smooth dynamics take hinge and slide joints, or one free "
                "joint alone, per body; ball joints wait in ROADMAP "
                "under the engine outside the lane scope")
        dofs[b] = dofs[b] + tuple(range(model.jnt_dofadr[j],
                                        model.jnt_dofadr[j] + dof_width(jt)))
    return dofs


def free_bodies(model: Model):
    """The bodies whose joint is free."""
    return {model.jnt_bodyid[j] for j in range(model.njnt)
            if model.jnt_type[j] == FREE}


def inertia_mul(inert: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Compact inertia (10, *L) times a spatial vector s (6, *L):
    [J w + h x v; m v - h x w]."""
    m, h, J = inert[0], inert[1:4], inert[4:10]
    w, v = s[:3], s[3:]
    hv, hw = cross(h, v), cross(h, w)
    top = torch.stack([J[r[0]] * w[0] + J[r[1]] * w[1] + J[r[2]] * w[2]
                       for r in _JROWS]) + hv
    return torch.cat([top, m * v - hw])


def dot6(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[0] + p[1] + p[2] + p[3] + p[4] + p[5]


def _world(data: Data):
    lanes = tuple(data.qvel.shape[1:])
    return torch.zeros((6,) + lanes, dtype=data.qvel.dtype,
                       device=data.qvel.device)


def bias_force(model: Model, data: Data) -> torch.Tensor:
    """Coriolis, centrifugal and gravity force (nv, *L) (mj_rne)."""
    dofs, free = body_dofs(model), free_bodies(model)
    v, cdof = data.qvel, data.cdof
    zero = _world(data)
    g = -model.gravity
    cvel = [zero]
    cacc = [torch.cat([zero[:3], g.reshape((3,) + (1,) * (v.dim() - 1))
                       .expand(zero[3:].shape)])]
    cfrc = [None]
    for b in range(1, model.nbody):
        p = model.body_parent[b]
        cv, ca = cvel[p], cacc[p]        # welded: moves with its parent
        if b in free:                    # rotations: the whole body twist
            for i in dofs[b]:
                cv = cv + cdof[i] * v[i]
            for i in dofs[b][3:]:
                ca = ca + cross_motion(cv, cdof[i]) * v[i]
        else:                            # the twist of the dofs before i
            for i in dofs[b]:
                ca = ca + cross_motion(cv, cdof[i]) * v[i]
                cv = cv + cdof[i] * v[i]
        cvel.append(cv)
        cacc.append(ca)
        inert = data.cinert[b]
        cfrc.append(inertia_mul(inert, cacc[b])
                    + cross_force(cvel[b], inertia_mul(inert, cvel[b])))
    bias = [None] * model.nv
    for b in range(model.nbody - 1, 0, -1):
        p = model.body_parent[b]
        for i in dofs[b]:
            bias[i] = dot6(cdof[i], cfrc[b])
        if p > 0:
            cfrc[p] = cfrc[p] + cfrc[b]
    return torch.stack(bias)


def mass_matrix(model: Model, data: Data) -> torch.Tensor:
    """Joint-space inertia (nv, nv, *L) by the composite-rigid-body
    algorithm over the compact inertias."""
    dofs = body_dofs(model)
    comp = list(data.cinert.unbind(0))
    for b in range(model.nbody - 1, 0, -1):
        p = model.body_parent[b]
        if p > 0:
            comp[p] = comp[p] + comp[b]
    zero = torch.zeros_like(data.qvel[0])
    M = [[zero] * model.nv for _ in range(model.nv)]
    for b in range(1, model.nbody):
        for n, i in enumerate(dofs[b]):
            F = inertia_mul(comp[b], data.cdof[i])
            M[i][i] = dot6(data.cdof[i], F) + model.dof_armature[i]
            for k in dofs[b][:n]:
                M[i][k] = M[k][i] = dot6(data.cdof[k], F)
            a = model.body_parent[b]
            while a > 0:
                for k in dofs[a]:
                    M[i][k] = M[k][i] = dot6(data.cdof[k], F)
                a = model.body_parent[a]
    return torch.stack([torch.stack(row) for row in M])


def passive_force(model: Model, data: Data) -> torch.Tensor:
    """Joint dampers and scalar-joint springs (nv, *L) (mj_passive)."""
    nl = data.qvel.dim() - 1
    frc = -model.dof_damping.reshape((-1,) + (1,) * nl) * data.qvel
    rows = list(frc.unbind(0))
    for j in range(model.njnt):
        if model.jnt_type[j] in (HINGE, SLIDE):
            qa, da = model.jnt_qposadr[j], model.jnt_dofadr[j]
            rows[da] = rows[da] - model.jnt_stiffness[j] * (
                data.qpos[qa] - model.qpos_spring[qa])
    return torch.stack(rows) if rows else frc


def actuator_force(model: Model, data: Data) -> torch.Tensor:
    """Direct-drive motors from ctrl clamped to ctrlrange (mj_fwdActuation);
    actuators with ctrllimited false are not clamped.  A control exactly at
    its bound, as the line search leaves a saturated one, takes half its
    tangent in forward mode, as JAX's jnp.clip gives it (utils/math.py:
    clip)."""
    lanes = tuple(data.qvel.shape[1:])
    zero = torch.zeros(lanes, dtype=data.qvel.dtype, device=data.qvel.device)
    rows = [zero] * model.nv
    for a in range(model.nu):
        c = data.ctrl[a]
        if model.actuator_ctrllimited[a]:
            c = clip(c, model.actuator_ctrlrange[a, 0],
                     model.actuator_ctrlrange[a, 1])
        j = model.actuator_trnid[a]
        dadr = model.jnt_dofadr[j]
        for k in range(dof_width(model.jnt_type[j])):
            rows[dadr + k] = rows[dadr + k] + c * model.actuator_gear[a, k]
    return torch.stack(rows) if rows else zero.reshape((0,) + lanes)


def fwd_velocity_smooth(model: Model, data: Data) -> Data:
    """Fill qM, qfrc_bias, qfrc_passive and qfrc_actuator."""
    return data.replace(
        qM=mass_matrix(model, data),
        qfrc_bias=bias_force(model, data),
        qfrc_passive=passive_force(model, data),
        qfrc_actuator=actuator_force(model, data),
    )
