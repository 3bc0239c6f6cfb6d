"""State vector: selected tangent dofs (counterpart of
`trajoptkp_tpu/state/statevector.py:58-148`).

The optimisation state x = [position tangent; velocity] over the selected
dofs (all nv, or a reduced set with ndof < nv, e.g. the pushing tasks' arm
joints and object translations), quaternion-aware through integrate_pos /
differentiate_pos.  Arrays
keep the component axis first and the batch axes last.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..dynamics.integrate import differentiate_pos, integrate_pos
from ..dynamics.model import BALL, FREE, HINGE, SLIDE, Model

_FREE_SUFFIX = ("lin_x", "lin_y", "lin_z", "ang_x", "ang_y", "ang_z")
_BALL_SUFFIX = ("ang_x", "ang_y", "ang_z")


def dof_names(model: Model) -> Tuple[str, ...]:
    """One name per qvel index."""
    names = [""] * model.nv
    for j in range(model.njnt):
        jt = model.jnt_type[j]
        dadr = model.jnt_dofadr[j]
        bname = model.body_names[model.jnt_bodyid[j]]
        if jt in (HINGE, SLIDE):
            names[dadr] = model.joint_names[j]
        elif jt == BALL:
            for k, s in enumerate(_BALL_SUFFIX):
                names[dadr + k] = f"{bname}_{s}"
        elif jt == FREE:
            for k, s in enumerate(_FREE_SUFFIX):
                names[dadr + k] = f"{bname}_{s}"
    return tuple(names)


@dataclasses.dataclass(frozen=True)
class StateVector:
    """`order`: the qvel indices in the state, in state order.  `active`:
    (ndof,) 1.0/0.0 mask per state dof."""

    names: Tuple[str, ...]
    order: Tuple[int, ...]
    active: torch.Tensor

    @property
    def ndof(self) -> int:
        return len(self.order)

    @property
    def nx(self) -> int:
        return 2 * self.ndof

    @property
    def is_full(self) -> bool:
        return self.order == tuple(range(len(self.order))) and bool(
            torch.all(self.active > 0.5))


def full_state_vector(model: Model) -> StateVector:
    return StateVector(
        names=dof_names(model), order=tuple(range(model.nv)),
        active=torch.ones(model.nv, dtype=model.dtype, device=model.device),
    )


def state_vector_from_names(model: Model, selected) -> StateVector:
    """The state over the named dofs, in the given order (JAX
    `state_vector_from_names`): joint names for hinge/slide dofs,
    `<body>_lin_x` ... `<body>_ang_z` for free-joint dofs."""
    all_names = dof_names(model)
    order = tuple(all_names.index(n) for n in selected)
    return StateVector(
        names=tuple(selected), order=order,
        active=torch.ones(len(order), dtype=model.dtype, device=model.device),
    )


def _active(sv: StateVector, like: torch.Tensor) -> torch.Tensor:
    return sv.active.reshape((-1,) + (1,) * (like.dim() - 1))


def to_tangent(model: Model, sv: StateVector, qpos, qvel, qpos_ref,
               qvel_ref) -> torch.Tensor:
    """dx = [d_pos(qpos_ref -> qpos); qvel - qvel_ref][selected], masked."""
    idx = list(sv.order)
    dpos = differentiate_pos(model, qpos_ref, qpos)[idx]
    dvel = (qvel - qvel_ref)[idx]
    return torch.cat([dpos * _active(sv, dpos), dvel * _active(sv, dvel)])


def scatter_tangent(model: Model, sv: StateVector, z: torch.Tensor):
    """(ndof, *L) tangent over the state dofs -> (nv, *L) over all dofs."""
    rows = [torch.zeros_like(z[0])] * model.nv
    for k, i in enumerate(sv.order):
        rows[i] = z[k] * sv.active[k]
    return torch.stack(rows)


def apply_tangent(model: Model, sv: StateVector, qpos_ref, qvel_ref, dx):
    """(qpos, qvel) = ref (+) dx."""
    nd = sv.ndof
    qpos = integrate_pos(model, qpos_ref, scatter_tangent(model, sv, dx[:nd]),
                         1.0)
    qvel = qvel_ref + scatter_tangent(model, sv, dx[nd:])
    return qpos, qvel
