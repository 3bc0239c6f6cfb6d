"""Per-dof column interpolation of A/B between keypoints (counterpart of
`trajoptkp_tpu/keypoints/interpolate.py:22-78`), as gather + lerp.

Single trajectory: A_kp (H, 2n, 2n), B_kp (H, 2n, nu), mask (H, n).  For
state dof i the A columns i and n+i, and B column i when i < nu, are lerped
between dof i's previous and next keypoint times.

Lane-last (`lerp_columns`, JAX `solver/lanes.py:415-428` and `_ie_interp:
477`): slot Jacobians J (K, 2n, 2n+nu, B), each column c gathered at the
previous and next slot of the dof it follows (`column_dofs`) and lerped.
This is the plain twin of kernel K9b (kernels/csrc/kp_interp.cu), in its
operation order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def prev_next_keypoints(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """prev[t,i] = max{t' <= t : mask[t',i]}, next[t,i] = min{t' >= t : ...};
    mask[0] and mask[H-1] must be all true."""
    H = mask.shape[0]
    t = torch.arange(H, device=mask.device)[:, None].expand(mask.shape)
    prev = torch.cummax(torch.where(mask, t, torch.full_like(t, -1)), 0).values
    neg = torch.where(mask, -t, torch.full_like(t, -(H + 1)))
    nxt = -torch.cummax(neg.flip(0), 0).values.flip(0)
    return prev, nxt


def interpolate_derivatives(A_kp, B_kp, mask, nu: int):
    """Fill the non-keypoint columns by per-dof linear interpolation."""
    H, twon, _ = A_kp.shape
    n = twon // 2
    prev, nxt = prev_next_keypoints(mask)
    dtype = A_kp.dtype
    denom = torch.clamp(nxt - prev, min=1).to(dtype)
    t = torch.arange(H, device=A_kp.device)[:, None].to(dtype)
    w = (t - prev.to(dtype)) / denom                  # (H, n)

    def lerp_cols(M, col_idx):
        # M (H, rows, cols); one column per dof, each with its own schedule
        start = M[prev, :, col_idx[None, :]]          # (H, n, rows)
        end = M[nxt, :, col_idx[None, :]]
        return (start + w[:, :, None] * (end - start)).transpose(1, 2)

    cols = torch.arange(n, device=A_kp.device)
    A = torch.cat([lerp_cols(A_kp, cols), lerp_cols(A_kp, cols + n)], dim=2)
    if nu == 0:
        return A, B_kp
    m = min(n, nu)
    ctrl = torch.arange(m, device=A_kp.device)
    startB = B_kp[prev[:, :m], :, ctrl[None, :]]
    endB = B_kp[nxt[:, :m], :, ctrl[None, :]]
    B = (startB + w[:, :m, None] * (endB - startB)).transpose(1, 2)
    if nu > n:
        B = torch.cat([B, B_kp[:, :, n:]], dim=2)
    return A, B


def column_dofs(n: int, nu: int) -> list:
    """The dof each column of [A|B] follows: state column j follows dof
    j mod n, control column c dof min(c, n-1) (JAX `solver/lanes.py:
    232-235`)."""
    return [j % n for j in range(2 * n)] + [min(c, n - 1) for c in range(nu)]


def lerp_columns(J, pslot, nslot, w, col_dof, nx: int):
    """J (K, 2n, C, B) slot Jacobians; pslot, nslot (H, n, B) int slots and
    w (H, n, B) lerp weights per dof; col_dof (C,) int64 -> A (H, 2n, 2n,
    B), Bm (H, 2n, C - 2n, B): column c at step t is J_p + w (J_n - J_p),
    with J_p, J_n at dof col_dof[c]'s previous and next slot."""
    H, B = pslot.shape[0], pslot.shape[-1]
    rows, C = J.shape[1], J.shape[2]
    idx_p = pslot[:, col_dof, :].long()[:, None].expand(H, rows, C, B)
    idx_n = nslot[:, col_dof, :].long()[:, None].expand(H, rows, C, B)
    Jp = J.gather(0, idx_p)
    Jn = J.gather(0, idx_n)
    Jf = Jp + w[:, col_dof, :][:, None] * (Jn - Jp)
    return Jf[:, :, :nx].contiguous(), Jf[:, :, nx:].contiguous()
