"""Keypoint configuration and the set_interval method (counterpart of
`trajoptkp_tpu/keypoints/methods.py:30-78, 231-235`).

A keypoint set is a boolean mask (H, ndof).  The other methods
(adaptive_jerk, adaptive_accel, velocity_change, iterative_error) are not
ported yet: ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

NOT_PORTED = ("ROADMAP Queue 1 item 9 ports the other keypoint methods; "
              "this slice has set_interval (SI_n) only")


@dataclasses.dataclass(frozen=True)
class KeypointConfig:
    """Mirror of the reference keypoint_method struct."""

    name: str = "set_interval"
    min_N: int = 1
    max_N: int = 1
    auto_adjust: bool = False
    jerk_thresholds: Optional[torch.Tensor] = None
    accel_thresholds: Optional[torch.Tensor] = None
    velocity_change_thresholds: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "KeypointConfig":
        return dataclasses.replace(self, **changes)


def set_interval(H: int, ndof: int, min_N: int) -> torch.Tensor:
    """Keypoints at every min_N-th step plus the last step."""
    t = torch.arange(H)
    row = (t % min_N == 0) | (t == H - 1)
    return row[:, None].expand(H, ndof)


def si_keypoint_times(H: int, min_N: int) -> np.ndarray:
    """The set_interval keypoint times, ascending."""
    ts = list(range(0, H - 1, min_N))
    if not ts or ts[-1] != H - 1:
        ts.append(H - 1)
    return np.asarray(ts, dtype=np.int64)


def percentage_derivs(mask: torch.Tensor) -> torch.Tensor:
    """Per-dof percentage of steps with computed derivatives."""
    return 100.0 * mask.sum(dim=0).to(torch.float64) / mask.shape[0]
