"""The smooth step (counterpart of `trajoptkp_tpu/dynamics/step.py:27-92`).

MuJoCo's Euler with implicit joint damping, batch axes last.  This is the
plain version of kernel K1, the `__device__` step that the rollout, line
search and FD-Jacobian kernels share (kernels/csrc/step.cuh).

Damping enters twice on purpose, as in the JAX package and MuJoCo's Euler:
explicitly in `passive_force` and implicitly in (M + h D) qacc = f.
"""

from __future__ import annotations

import torch

from ..utils.linalg import sym_solve
from .fk import forward_kinematics
from .integrate import integrate_pos
from .model import Data, Model
from .smooth import fwd_velocity_smooth


def check_smooth(model: Model) -> None:
    """Raise for a model whose step needs the constraint solver."""
    if model.has_constraints:
        raise NotImplementedError(
            "joint limits and contacts are not ported yet (ROADMAP Queue 1 "
            f"item 7): the model has {len(model.contact_pairs)} contact "
            f"pairs and {sum(model.jnt_limited)} limited joints"
        )


def forward(model: Model, data: Data) -> Data:
    """FK products and smooth forces (mj_forward without constraints)."""
    check_smooth(model)
    data = forward_kinematics(model, data)
    return fwd_velocity_smooth(model, data)


def advance(model: Model, data: Data) -> Data:
    """Euler step from forward() products: (M + hD) qacc = f, then
    qvel' = qvel + h qacc and qpos' = qpos (+) h qvel'."""
    h = model.timestep
    nl = data.qvel.dim() - 1
    f = data.qfrc_passive + data.qfrc_actuator - data.qfrc_bias
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
