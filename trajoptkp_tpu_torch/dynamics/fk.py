"""Forward kinematics (counterpart of `trajoptkp_tpu/dynamics/fk.py:141`).

World poses of bodies and sites (position and orientation), the per-dof
motion subspace `cdof` and the
world-frame spatial inertia `cinert` of each body about the origin (compact
form; `cinert_matrix` gives the JAX 6x6), for hinge, slide and free joints.
The body loop unrolls in Python (topology is static and small); every
quantity carries the batch axes last.
"""

from __future__ import annotations

import torch

from ..utils import math as tm
from .model import BALL, FREE, HINGE, SLIDE, Data, Model


def _c(x: torch.Tensor, nl: int) -> torch.Tensor:
    """A model constant (k,) shaped to broadcast against (k, *L)."""
    return x.reshape(tuple(x.shape) + (1,) * nl)


# (row, col) of the six entries of a symmetric 3x3, in storage order
SYM6 = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def body_inertia(model: Model, b: int, xpos_b, xquat_b):
    """CoM, inertial frame and world spatial inertia of body b, the inertia
    in compact form [m, h = m c (3), J (6)] with J = I_c + m (c.c I - c c^T)
    stored as SYM6.  Operation for operation as kernels/csrc/step.cuh, so
    the kernels and this twin round alike."""
    nl = xpos_b.dim() - 1
    R = tm.quat_to_mat(xquat_b)                        # (3, 3, *L)
    Ri = tm.quat_to_mat(model.body_iquat[b])           # (3, 3)
    ip, d = model.body_ipos[b], model.body_inertia[b]
    c = xpos_b + (R[:, 0] * ip[0] + R[:, 1] * ip[1] + R[:, 2] * ip[2])
    X = torch.stack([R[:, 0] * Ri[0, s] + R[:, 1] * Ri[1, s]
                     + R[:, 2] * Ri[2, s] for s in range(3)], 1)
    m = model.body_mass[b]
    cc = c[0] * c[0] + c[1] * c[1] + c[2] * c[2]
    J = []
    for r, s in SYM6:
        ic = (X[r, 0] * d[0] * X[s, 0] + X[r, 1] * d[1] * X[s, 1]
              + X[r, 2] * d[2] * X[s, 2])
        J.append(ic + m * ((cc if r == s else 0.0) - c[r] * c[s]))
    m_l = m.reshape((1,) * nl).expand(c.shape[1:])
    inert = torch.stack([m_l, *(m * c).unbind(0), *J])
    return c, X, inert


def mat_vec(R: torch.Tensor, v: torch.Tensor, base: torch.Tensor):
    """base + R v for R (3, 3, *L), a model constant v (3,), sums left to
    right (kernels/csrc/residuals.cuh reads the end-effector site so)."""
    return base + (R[:, 0] * v[0] + R[:, 1] * v[1] + R[:, 2] * v[2])


def mat_mat(R: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """R S for R (3, 3, *L) and a model constant S (3, 3)."""
    return torch.stack([R[:, 0] * S[0, s] + R[:, 1] * S[1, s]
                        + R[:, 2] * S[2, s] for s in range(3)], 1)


def cinert_matrix(cinert: torch.Tensor) -> torch.Tensor:
    """Compact inertias (nbody, 10, *L) -> 6x6 spatial inertias
    [[J, hat(h)], [-hat(h), m I]] (nbody, 6, 6, *L), the JAX layout."""
    m, h, J = cinert[:, 0], cinert[:, 1:4], cinert[:, 4:]
    z = torch.zeros_like(m)
    Jm = torch.stack([torch.stack([J[:, 0], J[:, 3], J[:, 4]], 1),
                      torch.stack([J[:, 3], J[:, 1], J[:, 5]], 1),
                      torch.stack([J[:, 4], J[:, 5], J[:, 2]], 1)], 1)
    H = torch.stack([torch.stack([z, -h[:, 2], h[:, 1]], 1),
                     torch.stack([h[:, 2], z, -h[:, 0]], 1),
                     torch.stack([-h[:, 1], h[:, 0], z], 1)], 1)
    mI = torch.stack([torch.stack([m if i == k else z for k in range(3)], 1)
                      for i in range(3)], 1)
    return torch.cat([torch.cat([Jm, H], 2), torch.cat([-H, mI], 2)], 1)


def body_frames(model: Model, qpos: torch.Tensor):
    """World frames of every body and the per-dof cdof rows: lists xpos
    (3, *L), xquat (4, *L) per body and cdof (6, *L) per dof."""
    lanes = tuple(qpos.shape[1:])
    nl = len(lanes)
    dtype, device = qpos.dtype, qpos.device

    def full(v):
        return v.reshape((-1,) + (1,) * nl).expand((v.shape[0],) + lanes)

    xpos = [full(torch.zeros(3, dtype=dtype, device=device))]
    xquat = [full(torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                               device=device))]
    cdof = [None] * model.nv
    body_joints = [[] for _ in range(model.nbody)]
    for j, b in enumerate(model.jnt_bodyid):
        body_joints[b].append(j)

    for b in range(1, model.nbody):
        p = model.body_parent[b]
        xq = tm.quat_mul(xquat[p], _c(model.body_quat[b], nl))
        xp = xpos[p] + tm.quat_rotate(xquat[p], _c(model.body_pos[b], nl))
        for j in body_joints[b]:
            jt = model.jnt_type[j]
            qa, da = model.jnt_qposadr[j], model.jnt_dofadr[j]
            if jt == FREE:
                xp = qpos[qa:qa + 3]
                xq = tm.quat_normalize(qpos[qa + 3:qa + 7])
                zero = torch.zeros_like(xp)
                eye = torch.eye(3, dtype=dtype, device=device)
                for k in range(3):
                    cdof[da + k] = torch.cat([zero, full(eye[k])])
                R = tm.quat_to_mat(xq)
                for k in range(3):
                    a = R[:, k]
                    cdof[da + 3 + k] = torch.cat([a, tm.cross(xp, a)])
            elif jt == HINGE:
                jpos = _c(model.jnt_pos[j], nl)
                axis = _c(model.jnt_axis[j], nl)
                anchor = tm.quat_rotate(xq, jpos) + xp
                qloc = tm.quat_exp(axis * (qpos[qa:qa + 1] - model.qpos0[qa]))
                xq = tm.quat_mul(xq, qloc)
                xp = anchor - tm.quat_rotate(xq, jpos)
                a = tm.quat_rotate(xq, axis)
                cdof[da] = torch.cat([a, tm.cross(anchor, a)])
            elif jt == SLIDE:
                axis_w = tm.quat_rotate(xq, _c(model.jnt_axis[j], nl))
                xp = xp + axis_w * (qpos[qa:qa + 1] - model.qpos0[qa])
                cdof[da] = torch.cat([torch.zeros_like(axis_w), axis_w])
            elif jt == BALL:
                raise NotImplementedError(
                    "ball joints are not ported yet (ROADMAP: the engine "
                    "outside the lane scope)"
                )
        xpos.append(xp.expand((3,) + lanes))
        xquat.append(xq.expand((4,) + lanes))
    return xpos, xquat, cdof


def site_pose(model: Model, xpos, xquat, s: int):
    """World position (3, *L) and rotation (3, 3, *L) of site s."""
    sb = model.site_bodyid[s]
    R = tm.quat_to_mat(xquat[sb])
    return (mat_vec(R, model.site_pos[s], xpos[sb]),
            mat_mat(R, tm.quat_to_mat(model.site_quat[s])))


def forward_kinematics(model: Model, data: Data) -> Data:
    """Fill xpos, xquat, xipos, ximat, site_xpos, site_xmat, cdof and cinert
    (compact, see body_inertia)."""
    qpos = data.qpos
    lanes = tuple(qpos.shape[1:])
    dtype, device = qpos.dtype, qpos.device
    xpos, xquat, cdof = body_frames(model, qpos)

    xpos_t = torch.stack(xpos)                       # (nbody, 3, *L)
    xquat_t = torch.stack(xquat)                     # (nbody, 4, *L)
    cdof_t = (torch.stack(cdof) if model.nv
              else torch.zeros((0, 6) + lanes, dtype=dtype, device=device))

    xipos, ximat, cinert = [], [], []
    for b in range(model.nbody):
        xi, Ri, inert = body_inertia(model, b, xpos_t[b], xquat_t[b])
        xipos.append(xi)
        ximat.append(Ri)
        cinert.append(inert)

    site_xpos, site_xmat = [], []
    for s in range(model.nsite):
        sp, sm = site_pose(model, xpos_t, xquat_t, s)
        site_xpos.append(sp)
        site_xmat.append(sm)
    empty = torch.zeros((0, 3) + lanes, dtype=dtype, device=device)
    site_xpos = torch.stack(site_xpos) if model.nsite else empty
    site_xmat = (torch.stack(site_xmat) if model.nsite
                 else empty.reshape((0, 3, 3) + lanes))

    return data.replace(
        xpos=xpos_t, xquat=xquat_t, xipos=torch.stack(xipos),
        ximat=torch.stack(ximat), site_xpos=site_xpos, site_xmat=site_xmat,
        cdof=cdof_t,
        cinert=torch.stack(cinert),
    )
