"""The step (counterpart of `trajoptkp_tpu/dynamics/step.py:27-92`).

MuJoCo's Euler with implicit joint damping, batch axes last, with the
constraint solve over joint-limit and contact rows between the smooth forces
and the integration.  This is the plain version of kernels K1, K2a and K2b,
the `__device__` step that the rollout, line search and FD-Jacobian kernels
share (kernels/csrc/step.cuh, constraint.cuh, contact.cuh).

Damping enters twice on purpose, as in the JAX package and MuJoCo's Euler:
explicitly in `passive_force` and implicitly in (M + h D) qacc = f.
"""

from __future__ import annotations

import torch

from ..utils.linalg import sym_solve
from .constraint import constraint_force
from .fk import forward_kinematics
from .integrate import integrate_pos
from .model import Data, Model
from .smooth import fwd_velocity_smooth


def smooth_force(data: Data) -> torch.Tensor:
    return data.qfrc_passive + data.qfrc_actuator - data.qfrc_bias


def forward(model: Model, data: Data, diag=None) -> Data:
    """FK products, smooth forces and, for a model with joint limits or
    contacts, the constraint force and the constrained qacc (mj_forward)."""
    data = forward_kinematics(model, data)
    data = fwd_velocity_smooth(model, data)
    if not model.has_constraints:
        return data
    return constraint_force(model, data, smooth_force(data), diag)


def advance(model: Model, data: Data) -> Data:
    """Euler step from forward() products: (M + hD) qacc = qfrc_smooth +
    qfrc_constraint, then qvel' = qvel + h qacc and qpos' = qpos (+) h qvel'."""
    h = model.timestep
    nl = data.qvel.dim() - 1
    f = smooth_force(data)
    if data.qfrc_constraint is not None:
        f = f + data.qfrc_constraint
    hD = torch.diag(h * model.dof_damping).reshape(
        (model.nv, model.nv) + (1,) * nl)
    qacc = sym_solve(data.qM + hD, f)
    qvel = data.qvel + h * qacc
    qpos = integrate_pos(model, data.qpos, qvel, h)
    return data.replace(qpos=qpos, qvel=qvel, qacc=qacc)


def step(model: Model, data: Data) -> Data:
    return advance(model, forward(model, data))


def step_state(model: Model, qpos: torch.Tensor, qvel: torch.Tensor,
               ctrl: torch.Tensor):
    """(qpos (nq, *L), qvel (nv, *L), ctrl (nu, *L)) -> (qpos', qvel')."""
    out = step(model, Data(qpos=qpos, qvel=qvel, ctrl=ctrl))
    return out.qpos, out.qvel
