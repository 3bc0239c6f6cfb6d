"""Position integration on the configuration manifold (counterpart of
`trajoptkp_tpu/dynamics/integrate.py:35,61`): mj_integratePos and
mj_differentiatePos, quaternion-aware for free and ball joints.  Arrays are
(nq, *L) / (nv, *L); the result is assembled row by row, so the functions
stay pure (no in-place writes) and work under `torch.func`.
"""

from __future__ import annotations

import torch

from ..utils import math as tm
from .model import BALL, FREE, HINGE, SLIDE, Model


def integrate_pos(model: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt) -> torch.Tensor:
    """qpos (+) qvel * dt: free-joint linear velocity in the world frame,
    free/ball angular velocity in the child frame (MuJoCo convention)."""
    rows = list(qpos.unbind(0))
    for j in range(model.njnt):
        jt = model.jnt_type[j]
        qa, da = model.jnt_qposadr[j], model.jnt_dofadr[j]
        if jt in (HINGE, SLIDE):
            rows[qa] = qpos[qa] + dt * qvel[da]
        elif jt == BALL:
            q = tm.quat_integrate(qpos[qa:qa + 4], qvel[da:da + 3], dt)
            rows[qa:qa + 4] = list(q.unbind(0))
        elif jt == FREE:
            for k in range(3):
                rows[qa + k] = qpos[qa + k] + dt * qvel[da + k]
            q = tm.quat_integrate(qpos[qa + 3:qa + 7], qvel[da + 3:da + 6], dt)
            rows[qa + 3:qa + 7] = list(q.unbind(0))
    return torch.stack(rows)


def differentiate_pos(model: Model, qpos1: torch.Tensor, qpos2: torch.Tensor,
                      dt=1.0) -> torch.Tensor:
    """v with qpos2 = qpos1 (+) v dt (mj_differentiatePos)."""
    lanes = tuple(torch.broadcast_shapes(qpos1.shape[1:], qpos2.shape[1:]))
    zero = torch.zeros(lanes, dtype=qpos1.dtype, device=qpos1.device)
    rows = [zero] * model.nv
    for j in range(model.njnt):
        jt = model.jnt_type[j]
        qa, da = model.jnt_qposadr[j], model.jnt_dofadr[j]
        if jt in (HINGE, SLIDE):
            rows[da] = (qpos2[qa] - qpos1[qa]) / dt
        elif jt == BALL:
            v = tm.quat_sub(qpos2[qa:qa + 4], qpos1[qa:qa + 4]) / dt
            rows[da:da + 3] = list(v.unbind(0))
        elif jt == FREE:
            for k in range(3):
                rows[da + k] = (qpos2[qa + k] - qpos1[qa + k]) / dt
            v = tm.quat_sub(qpos2[qa + 3:qa + 7], qpos1[qa + 3:qa + 7]) / dt
            rows[da + 3:da + 6] = list(v.unbind(0))
    return torch.stack([r.expand(lanes) for r in rows])
