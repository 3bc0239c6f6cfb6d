"""Exact dynamics Jacobians at keypoint slots by forward mode (counterpart
of the JAX lane program's `solver/lanes.py:_slot_jacobians_chunk:282`,
jacfwd of the lane step, and of the generic engine's exact columns,
`derivs/fd.py:ad_job_columns:125`, `_time_ad_jacobian:285`).

`ad_slot_jacobians` is the plain version of kernel K5ad
(kernels/csrc/ad_jacobian.cu), with the contract of
`derivs/fd.py:fd_slot_jacobians`: at each slot the 2n + nu tangent columns
of [A|B] over the state vector, rows and columns on the tangent space, the
position columns as q (+) dz (`integrate_pos`), the velocity and control
columns as qvel + dz and ctrl + dz, the position rows as
`differentiate_pos(next nominal, next)` (a free joint's rotation rows are
the quaternion log about the identity, its small-angle branch: tangent
2 dq_vec), the velocity rows qvel' - qvel'_nominal.

One forward-mode pass (dual tensors, `torch.autograd.forward_ad`) runs the
plain step with the columns as a lane axis of their own, each lane seeded
on its column.  The
constraint solve inside the step is differentiated implicitly at the
Newton iterate it returns (`dynamics/contact.py:_NewtonSolve`, K2c's plain
version), as JAX's `custom_jvp` rules do.  The kernel runs each
(slot, column, lane) as one thread in dual numbers whose operations round
as torch's forward-mode formulas (csrc/dual.cuh).

Where the step clips (a control at its limit, the narrow phase's segment
clamps, the impedance's clip), it calls `utils/math.py:clip` and
`at_least` (torch.maximum and torch.minimum), which split the tangent of
a value exactly on its bound 0.5 / 0.5, as JAX's jnp.clip does (lax.max
and lax.min); the kernel does the same (csrc/dual.cuh).  torch.clamp would
pass such a tangent whole.  A saturated control sits exactly at its bound,
so the tie is common on the solver's path.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..dynamics.integrate import differentiate_pos, integrate_pos
from ..dynamics.model import Model
from ..dynamics.step import step_state
from ..state.statevector import StateVector, scatter_tangent


def ad_slot_jacobians(model: Model, sv: StateVector, qpos, qvel,
                      ctrl) -> torch.Tensor:
    """qpos (nq, *L), qvel (nv, *L), ctrl (nu, *L) -> J (2n, 2n+nu, *L)."""
    n, nu = sv.ndof, model.nu
    ncol = 2 * n + nu
    lanes = tuple(qpos.shape[1:])
    one = (1,) * len(lanes)
    idx = list(sv.order)
    qp_nom, qv_nom = step_state(model, qpos, qvel, ctrl)
    dt = dict(dtype=qpos.dtype, device=qpos.device)
    z0 = torch.zeros((ncol, ncol) + lanes, **dt)
    seed = torch.eye(ncol, **dt).reshape((ncol, ncol) + one).expand_as(z0)
    with fwAD.dual_level():
        z = fwAD.make_dual(z0, seed)               # (ncol, ncol, *L)
        dq = scatter_tangent(model, sv, z[:n])
        dv = scatter_tangent(model, sv, z[n:2 * n])
        qp2, qv2 = step_state(model,
                              integrate_pos(model, qpos[:, None], dq, 1.0),
                              qvel[:, None] + dv, ctrl[:, None] + z[2 * n:])
        dpos = differentiate_pos(model, qp_nom[:, None], qp2)[idx]
        out = torch.cat([dpos, (qv2 - qv_nom[:, None])[idx]])
        J = fwAD.unpack_dual(out).tangent
    return J                                           # (2n, ncol, *L)


def ad_lane_slots(model: Model, sv: StateVector, qpos, qvel, U, slot_t,
                  counts, cache=None) -> torch.Tensor:
    """Per-lane slot times: the plain twin of K5ad's per-lane and cache
    modes, with the contract of `derivs/fd.py:fd_lane_slots` (no eps)."""
    H, B = U.shape[0], U.shape[-1]
    K = slot_t.shape[0]

    def at(x):
        return x[:H].gather(0, slot_t[:, None, :].expand(K, x.shape[1], B))

    J = ad_slot_jacobians(model, sv, at(qpos).transpose(0, 1),
                          at(qvel).transpose(0, 1),
                          at(U).transpose(0, 1)).movedim(2, 0)
    live = torch.arange(K, device=U.device)[:, None] < counts[None, :]
    if cache is None:
        return torch.where(live[:, None, None, :], J, torch.zeros_like(J))
    s_idx, b_idx = live.nonzero(as_tuple=True)
    cache.permute(0, 3, 1, 2)[slot_t[s_idx, b_idx], b_idx] = \
        J.permute(0, 3, 1, 2)[s_idx, b_idx]
    return cache
