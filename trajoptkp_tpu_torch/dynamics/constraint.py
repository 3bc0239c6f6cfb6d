"""Constraint forces (counterpart of `trajoptkp_tpu/dynamics/constraint.py`):
fills `data.qfrc_constraint`, zeros for a model without limits or contacts."""

from __future__ import annotations

import torch

from .contact import solve_constraints
from .model import Data, Model


def constraint_force(model: Model, data: Data, qfrc_smooth: torch.Tensor,
                     diag=None) -> Data:
    if not model.has_constraints:
        return data.replace(qfrc_constraint=torch.zeros_like(qfrc_smooth))
    return solve_constraints(model, data, qfrc_smooth, diag)
