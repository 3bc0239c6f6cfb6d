"""Central-FD dynamics Jacobians at keypoint slots (counterpart of
`trajoptkp_tpu/derivs/fd.py:75-122`, `fd_job_columns` semantics).

`fd_slot_jacobians` is the plain version of kernel K5
(kernels/csrc/fd_jacobian.cu).  At each slot time it evaluates all 2n+nu
tangent columns of [A|B] by central differences with eps = 1e-6: position
columns perturb qpos on the tangent space (integrate_pos), velocity columns
perturb qvel, control columns perturb ctrl (clamped inside the step, as
MuJoCo does).  Output rows are (state_plus - state_minus) / (2 eps) on the
tangent space (`_tangent_out`).  Control column c is the column the JAX
engine fills from state dof c, so the port matches it while nu <= n.
"""

from __future__ import annotations

import torch

from ..dynamics.integrate import differentiate_pos, integrate_pos
from ..dynamics.model import Model
from ..dynamics.step import step_state
from ..state.statevector import StateVector


def _tangent_out(model: Model, sv: StateVector, qpos_a, qvel_a, qpos_b,
                 qvel_b, scale):
    """(state_b - state_a) / scale on the tangent space, selected dofs."""
    idx = list(sv.order)
    dpos = differentiate_pos(model, qpos_a, qpos_b)[idx] / scale
    dvel = (qvel_b - qvel_a)[idx] / scale
    return torch.cat([dpos, dvel])


def fd_slot_jacobians(model: Model, sv: StateVector, qpos, qvel, ctrl,
                      eps: float = 1e-6) -> torch.Tensor:
    """qpos (nq, *L), qvel (nv, *L), ctrl (nu, *L) -> J (2n, 2n+nu, *L).

    All 2(2n+nu) perturbed states go through one batched step call."""
    n, nu, nv = sv.ndof, model.nu, model.nv
    ncol = 2 * n + nu
    lanes = tuple(qpos.shape[1:])
    dt = dict(dtype=qpos.dtype, device=qpos.device)
    qps, qvs, us = [], [], []
    for c in range(ncol):
        for sign in (1.0, -1.0):
            qp, qv, u = qpos, qvel, ctrl
            if c < n:
                e = torch.zeros(nv, **dt)
                e[sv.order[c]] = sign * eps
                qp = integrate_pos(model, qpos,
                                   e.reshape((nv,) + (1,) * len(lanes)), 1.0)
            elif c < 2 * n:
                e = torch.zeros(nv, **dt)
                e[sv.order[c - n]] = sign * eps
                qv = qvel + e.reshape((nv,) + (1,) * len(lanes))
            else:
                e = torch.zeros(nu, **dt)
                e[c - 2 * n] = sign * eps
                u = ctrl + e.reshape((nu,) + (1,) * len(lanes))
            qps.append(qp.expand((model.nq,) + lanes))
            qvs.append(qv.expand((nv,) + lanes))
            us.append(u.expand((nu,) + lanes))
    # (k, 2*ncol, *L): one step over every perturbation
    qp2, qv2 = step_state(model, torch.stack(qps, 1), torch.stack(qvs, 1),
                          torch.stack(us, 1))
    qp2 = qp2.unflatten(1, (ncol, 2))
    qv2 = qv2.unflatten(1, (ncol, 2))
    # a tensor divisor: PyTorch multiplies by the reciprocal of a Python
    # scalar on the card, the kernel divides
    scale = torch.tensor(2 * eps, **dt)
    J = _tangent_out(model, sv, qp2[:, :, 1], qv2[:, :, 1], qp2[:, :, 0],
                     qv2[:, :, 0], scale)
    return J                                           # (2n, ncol, *L)
