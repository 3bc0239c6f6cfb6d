"""Temporal filtering of the dynamics Jacobians' velocity rows (counterpart
of `trajoptkp_tpu/keypoints/filtering.py`; the reference's
Optimiser::FilterDynamicsMatrices, Optimiser.cpp:340-406).

Only the velocity rows (ndof..2 ndof-1) of A are filtered, along time:

  - low-pass: y_n = (1 - a) y_{n-1} + a (x_n + x_{n-1}) / 2, a = 0.25,
    started at y_0 = x_0 (a loop over time, every entry at once);
  - FIR: causal convolution with {0.1, 0.15, 0.5, 0.15, 0.1}, zero padded.

Host-side tensor code on the generic solve's derivatives (solver/lanes.py
applies it where `optimise` runs), not a lane program, so it has no kernel.
A is (H, 2n, 2n) or lane-last (H, 2n, 2n, B).
"""

from __future__ import annotations

import torch

LOW_PASS_A = 0.25
FIR_DEFAULT = (0.1, 0.15, 0.5, 0.15, 0.1)
FILTERS = ("none", "low_pass", "FIR")


def low_pass(x: torch.Tensor, a: float = LOW_PASS_A) -> torch.Tensor:
    """First-order IIR along axis 0."""
    y, yn1, xn1 = [], x[0], x[0]
    for xn in x:
        yn1 = (1.0 - a) * yn1 + a * (xn + xn1) / 2.0
        xn1 = xn
        y.append(yn1)
    return torch.stack(y)


def fir(x: torch.Tensor, coeffs=FIR_DEFAULT) -> torch.Tensor:
    """Causal FIR along axis 0 with zero left-padding."""
    H = x.shape[0]
    y = torch.zeros_like(x)
    for j, c in enumerate(coeffs):
        shifted = torch.cat([torch.zeros_like(x[:j]), x[:H - j]])
        y = y + c * shifted
    return y


def filter_dynamics(A: torch.Tensor, method: str, a: float = LOW_PASS_A,
                    coeffs=FIR_DEFAULT) -> torch.Tensor:
    """A with its velocity rows filtered along time by `method`."""
    if method in (None, "none"):
        return A
    n = A.shape[1] // 2
    if method == "low_pass":
        filt = low_pass(A[:, n:], a)
    elif method == "FIR":
        filt = fir(A[:, n:], coeffs)
    else:
        raise ValueError(f"unknown filtering method {method!r}; known: "
                         f"{FILTERS}")
    return torch.cat([A[:, :n], filt], dim=1)
