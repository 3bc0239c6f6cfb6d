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


def fd_lane_slots(model: Model, sv: StateVector, qpos, qvel, U, slot_t,
                  counts, eps: float = 1e-6, cache=None) -> torch.Tensor:
    """Per-lane slot times: the plain twin of K5's per-lane and cache
    modes.  qpos (>=H, nq, B), qvel, U (H, nu, B), slot_t (K, B) int64,
    counts (B,) live slots -> J (K, 2n, 2n+nu, B), zero past a lane's
    count; or, given cache (H, 2n, 2n+nu, B), the live slots' Jacobians
    written into it at their times (in place) and the cache returned."""
    H, B = U.shape[0], U.shape[-1]
    K = slot_t.shape[0]

    def at(x):
        return x[:H].gather(0, slot_t[:, None, :].expand(K, x.shape[1], B))

    J = fd_slot_jacobians(model, sv, at(qpos).transpose(0, 1),
                          at(qvel).transpose(0, 1), at(U).transpose(0, 1),
                          eps).movedim(2, 0)           # (K, 2n, C, B)
    live = torch.arange(K, device=U.device)[:, None] < counts[None, :]
    if cache is None:
        return torch.where(live[:, None, None, :], J, torch.zeros_like(J))
    s_idx, b_idx = live.nonzero(as_tuple=True)
    cache.permute(0, 3, 1, 2)[slot_t[s_idx, b_idx], b_idx] = \
        J.permute(0, 3, 1, 2)[s_idx, b_idx]
    return cache
