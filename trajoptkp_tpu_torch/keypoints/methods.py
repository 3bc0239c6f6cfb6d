"""Keypoint selection methods (counterpart of
`trajoptkp_tpu/keypoints/methods.py`).

A keypoint set is a boolean mask (H, ndof), or lane-last (H, ndof, B).  The
methods: set_interval, adaptive_jerk and adaptive_accel (`adaptive` over a
jerk or acceleration profile), velocity_change, and the auto-adjust step
(`desired_percentages`, `order_of_importance`, `auto_adjust_mask`).
iterative_error drives the FD engine itself: solver/lanes.py:jacobians_ie.

The JAX scans over time become plain loops over t on tensors, vectorised
over every trailing axis (dof, lane): with the lane axis these are the plain
twins of kernel K9a's selectors (kernels/csrc/keypoints.cu), and they run
the kernel's operations in its order.  `lane_plan` is the rest of K9a's
twin: the per-lane union of the keypoint times under a slot budget and the
per-dof previous/next slot and lerp weight of every step.

The jerk profile multiplies by 1/dt where the JAX source divides by dt: the
JAX package's jitted programs hold dt as a constant, which XLA folds into a
multiply by its reciprocal, so the masks agree bit for bit with theirs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

METHODS = ("set_interval", "adaptive_jerk", "adaptive_accel",
           "velocity_change", "iterative_error")


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
    iterative_error_threshold: float = 1e-4

    def replace(self, **changes) -> "KeypointConfig":
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# profiles
# ---------------------------------------------------------------------------


def jerk_profile(vel: torch.Tensor, inv_dt: float) -> torch.Tensor:
    """|(a[t+1] - a[t]) / dt| with a[t] = (vel[t+1] - vel[t]) / dt, each
    division a multiply by inv_dt = 1/dt; zero in the last two rows.
    vel (H, ...)."""
    a1 = (vel[1:] - vel[:-1]) * inv_dt
    jerk = ((a1[1:] - a1[:-1]) * inv_dt).abs()
    return torch.cat([jerk, torch.zeros_like(vel[:2])])


def accel_profile(vel: torch.Tensor) -> torch.Tensor:
    """vel[t+1] - vel[t] (undivided, as the reference), zero last row."""
    return torch.cat([vel[1:] - vel[:-1], torch.zeros_like(vel[:1])])


# ---------------------------------------------------------------------------
# selectors
# ---------------------------------------------------------------------------


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


def adaptive(profile: torch.Tensor, thresholds: torch.Tensor, min_N: int,
             max_N: int) -> torch.Tensor:
    """adaptive_jerk / adaptive_accel (KeyPointGenerator.cpp:341-382): per
    dof a keypoint where the gap since the last one is >= min_N and the
    profile exceeds the threshold, or where the gap reaches max_N; the
    first and last steps always.  profile (H, ...); thresholds broadcast
    against profile[t]."""
    H = profile.shape[0]
    rest = profile.shape[1:]
    last = torch.zeros(rest, dtype=torch.int64, device=profile.device)
    rows = [torch.ones(rest, dtype=torch.bool, device=profile.device)]
    for t in range(1, H - 1):
        hit_thresh = (t - last >= min_N) & (profile[t] > thresholds)
        last = torch.where(hit_thresh, t, last)
        hit_max = (t - last) >= max_N
        last = torch.where(hit_max, t, last)
        rows.append(hit_thresh | hit_max)
    rows.append(torch.ones(rest, dtype=torch.bool, device=profile.device))
    return torch.stack(rows[:H])


def velocity_change(vel: torch.Tensor, thresholds: torch.Tensor, min_N: int,
                    max_N: int) -> torch.Tensor:
    """velocity_change (KeyPointGenerator.cpp:642-728): the summed |velocity|
    since the last keypoint above the threshold, a turning point of the
    velocity, or max_N steps, each once the gap is >= min_N.  The stored
    direction updates only while the counter is below min_N (reference
    :699-701); a turn does not count where the sum already hit; the last
    row is a keypoint for every dof.  vel (H, ...)."""
    H = vel.shape[0]
    rest = vel.shape[1:]
    dev = vel.device
    counter = torch.zeros(rest, dtype=torch.int32, device=dev)
    acc = torch.zeros(rest, dtype=vel.dtype, device=dev)
    last_dir = torch.zeros(rest, dtype=vel.dtype, device=dev)
    rows = [torch.ones(rest, dtype=torch.bool, device=dev)]
    for t in range(1, H):
        counter = counter + 1
        cur_dir = vel[t] - vel[t - 1]
        acc = acc + vel[t].abs()
        ge_min = counter >= min_N
        hit_acc = ge_min & (acc.abs() > thresholds)
        hit_turn = ge_min & ~hit_acc & (cur_dir * last_dir < 0)
        last_dir = torch.where(ge_min, last_dir, cur_dir)
        hit_max = ~hit_acc & ~hit_turn & (counter >= max_N)
        hit = hit_acc | hit_turn | hit_max
        counter = torch.where(hit, 0, counter)
        acc = torch.where(hit, 0.0, acc)
        rows.append(hit)
    rows[-1] = torch.ones(rest, dtype=torch.bool, device=dev)
    return torch.stack(rows)


def order_of_importance(vel: torch.Tensor, inv_dt: float,
                        num_keypoints: torch.Tensor) -> torch.Tensor:
    """Each dof's budget of keypoints (first and last step included) at its
    highest-jerk times t in [1, H-3] (KeyPointGenerator.cpp:384-447; stable
    ranks, as std::sort of SortIndices).  vel (H, ndof)."""
    H, ndof = vel.shape
    cand = jerk_profile(vel, inv_dt)[1:H - 2]
    order = torch.argsort(-cand, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True)
    chosen = ranks < torch.clamp(num_keypoints - 2, min=0)[None, :]
    mask = torch.zeros((H, ndof), dtype=torch.bool, device=vel.device)
    mask[1:H - 2] = chosen
    mask[0] = True
    mask[H - 1] = True
    return mask


def desired_percentages(expected, actual, last_percentages: torch.Tensor,
                        dof_importances: torch.Tensor,
                        surprise_lower: float = 0.1) -> torch.Tensor:
    """The surprise controller (DesiredPercentageDerivs,
    KeyPointGenerator.cpp:209-278)."""
    expected = torch.as_tensor(expected, dtype=last_percentages.dtype)
    actual = torch.as_tensor(actual, dtype=last_percentages.dtype)
    surprise = actual / expected
    raw_low = torch.clamp(-2.0 - expected ** 2, min=-5.0)
    raw_high = 3.0 * surprise ** 2 + 2.0
    raw = torch.clamp(torch.where(surprise < surprise_lower, raw_low,
                                  raw_high), max=5.0)
    zero = dof_importances == 0.0
    adj = torch.where(zero, raw, raw * (1.0 / torch.where(
        zero, torch.ones_like(dof_importances), dof_importances)))
    dec = last_percentages - adj
    inc = last_percentages + torch.clamp(expected ** 2, max=5.0) \
        * dof_importances
    return torch.where(actual > 0, dec, inc)


def auto_adjust_mask(vel: torch.Tensor, inv_dt: float, expected, actual,
                     last_percentages: torch.Tensor,
                     dof_importances: torch.Tensor, max_N: int):
    """AdjustKeyPointMethod (KeyPointGenerator.cpp:137-207): the percentages
    from the surprise, clamped to [ceil(H / max_N) + 1, H] keypoints, placed
    by order of importance."""
    H = vel.shape[0]
    pct = desired_percentages(expected, actual, last_percentages,
                              dof_importances)
    num_kp = torch.round(pct / 100.0 * H).to(torch.int32)
    lower = -(-H // max_N) + 1
    return order_of_importance(vel, inv_dt, torch.clamp(num_kp, lower, H))


def percentage_derivs(mask: torch.Tensor) -> torch.Tensor:
    """Per-dof percentage of steps with computed derivatives."""
    return 100.0 * mask.sum(dim=0).to(torch.float64) / mask.shape[0]


def thresholds_of(cfg: KeypointConfig) -> Optional[torch.Tensor]:
    """The thresholds the method compares its profile with."""
    return {"adaptive_jerk": cfg.jerk_thresholds,
            "adaptive_accel": cfg.accel_thresholds,
            "velocity_change": cfg.velocity_change_thresholds}.get(cfg.name)


def generate_keypoints(cfg: KeypointConfig, vel: torch.Tensor,
                       inv_dt: float) -> torch.Tensor:
    """Dispatch on the method (GenerateKeyPoints): vel (H, ndof) or
    lane-last (H, ndof, B) -> mask of the same shape."""
    H, ndof = vel.shape[:2]
    if cfg.name == "set_interval":
        return set_interval(H, ndof, cfg.min_N).to(vel.device).reshape(
            (H, ndof) + (1,) * (vel.dim() - 2)).expand(vel.shape)
    thr = thresholds_of(cfg)
    if thr is None:
        raise ValueError(f"no mask method {cfg.name!r}")
    thr = thr.reshape((ndof,) + (1,) * (vel.dim() - 2))
    if cfg.name == "adaptive_jerk":
        return adaptive(jerk_profile(vel, inv_dt), thr, cfg.min_N, cfg.max_N)
    if cfg.name == "adaptive_accel":
        return adaptive(accel_profile(vel), thr, cfg.min_N, cfg.max_N)
    return velocity_change(vel, thr, cfg.min_N, cfg.max_N)


# ---------------------------------------------------------------------------
# the lane plan (K9a's twin after the selector)
# ---------------------------------------------------------------------------


class LanePlan(NamedTuple):
    """Per-lane keypoint slots of one jacobians phase (K9a's outputs)."""

    mask: torch.Tensor      # (H, n, B) bool, capped, ends forced
    slot_t: torch.Tensor    # (K_max, B) int64: kept times, then padding
    count: torch.Tensor     # (B,) int32 live slots
    overflow: torch.Tensor  # (B,) int32 times dropped by the budget
    pslot: torch.Tensor     # (H, n, B) int32 slot of dof d's previous kp
    nslot: torch.Tensor     # (H, n, B) int32 slot of its next keypoint
    w: torch.Tensor         # (H, n, B) float64 lerp weight
    pct: torch.Tensor       # (B,) float64 masked share, percent


def lane_plan(mask: torch.Tensor, K_max: int, time_slots: bool = False,
              dtype=torch.float64) -> LanePlan:
    """JAX `solver/lanes.py:jacobians_adaptive:369-414` from a mask (H, n,
    B) whose rows 0 and H-1 are keypoints for every dof: the per-lane union
    of the keypoint times, capped at K_max slots by dropping the latest
    middle times (t = H-1 kept), the count of dropped times, the mask
    without them, the kept times in order then the earliest other times as
    padding (never read), and for every (t, dof) the slot of the previous
    and the next keypoint and the lerp weight (t - prev) / (next - prev).
    `time_slots` gives the previous and next times themselves (the IE
    cache is indexed by time).  pct = sum(mask) * (100 / (H n))."""
    H, n, B = mask.shape
    dev = mask.device
    t_col = torch.arange(H, device=dev)[:, None]
    union = mask.any(dim=1)                                # (H, B)
    rank = torch.cumsum(union, dim=0) - 1
    keep = union & ((rank < K_max - 1) | (t_col == H - 1))
    overflow = torch.clamp(union.sum(0) - K_max, min=0).to(torch.int32)
    mask = mask & keep[:, None, :]
    mask[0] = True
    mask[H - 1] = True
    key = torch.where(keep, t_col, H + 1 + t_col)
    slot_t = torch.argsort(key, dim=0, stable=True)[:K_max]
    count = keep.sum(0).to(torch.int32)
    cum = (torch.cumsum(keep, dim=0) - 1)                  # (H, B)
    t3 = t_col[:, :, None].expand(H, n, B)
    prev_t = torch.cummax(torch.where(mask, t3, -1), dim=0).values
    nxt_t = -torch.cummax(torch.where(mask, -t3, -(H + 1)).flip(0),
                          dim=0).values.flip(0)
    w = (t3 - prev_t).to(dtype) / torch.clamp(nxt_t - prev_t, min=1).to(dtype)
    if time_slots:
        pslot, nslot = prev_t, nxt_t
    else:
        cum_e = cum[:, None, :].expand(H, n, B)
        pslot = cum_e.gather(0, prev_t)
        nslot = cum_e.gather(0, nxt_t)
    pct = mask.sum(dim=(0, 1)).to(dtype) * (100.0 / (H * n))
    return LanePlan(mask, slot_t, count, overflow, pslot.to(torch.int32),
                    nslot.to(torch.int32), w, pct)
