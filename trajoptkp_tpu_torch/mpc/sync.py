"""Synchronous MPC: replan, apply, repeat (counterpart of
`trajoptkp_tpu/mpc/sync.py`).

Per replan (the reference's `main.cpp:630-744`, GenDataMPCHorizons
`GenTestingData.cpp:275-326`): one iLQR iteration from the current state,
then `num_apply` controls applied with Gaussian exploration noise of std
5% of the control range (`main.cpp:489-496`), then the consumed controls
shift out and the last control pads the horizon (`main.cpp:663-669`).

Two executors, as in the JAX package:

- the lane replan (`_build_lane_replan`, JAX `sync.py:100-179`), B episodes
  batch last, through the phases of solver/lanes.py and kernel K8: the
  rollout (K3), the keypoint Jacobians (set_interval: K5 and its lerp;
  adaptive_jerk, adaptive_accel, velocity_change: K9a, K5 at per-lane slots,
  K9b), the cost expansion (K6), the backward pass (K7), the line search
  (K4), then `mpc_apply`
  (K8, kernels/csrc/mpc_apply.cu), the part of the JAX replan after the
  forward pass.  `make_lane_sync_mpc` runs the replans back to back,
  `make_lane_sync_mpc_host` synchronises after each and times it;
- the generic replan (`make_sync_mpc`, JAX `sync.py:40-97` on
  `solver/fused.py`, which the port does not carry) on `solver/ilqr.py:
  optimise` at one iteration, one episode.

The lane replan keeps the JAX semantics: λ starts at `lambda_init` every
replan; the forward pass always runs and its accept is not gated by λ-exit;
the controls blend as acc U_n + (1 - acc) U and the replan cost is the best
line-search cost where accepted, else the nominal's; the apply loop costs
the pre-step state with the applied control under the running weights.  The
generic replan costs the post-step state, as JAX `make_sync_mpc` does.

Noise: `jax.random` cannot be repeated in torch.  The executors draw it
from a `torch.Generator` on the lanes' device, or take it as a tensor
(n_replans, num_apply, nu, B) of standard normals, which lets a test feed
the JAX stream.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from ..dynamics.model import Data
from ..dynamics.step import step_state
from ..kernels import ops
from ..solver.ilqr import ILQRConfig, optimise, step_cost
from ..solver.lanes import lane_phases
from ..tasks.base import Task, control_limits


class MPCRunResult(NamedTuple):
    qpos_hist: torch.Tensor     # (n_steps+1, nq[, B])
    qvel_hist: torch.Tensor     # (n_steps+1, nv[, B])
    ctrl_hist: torch.Tensor     # (n_steps, nu[, B])
    cost_hist: torch.Tensor     # (n_steps[, B]) running cost of visited states
    replan_costs: torch.Tensor  # (n_replans[, B]) the replans' final costs


def noise_std(task: Task, noise_pct: float) -> torch.Tensor:
    """(nu,) std of the exploration noise: noise_pct % of each control's
    range, 0 for an unlimited control."""
    lim = control_limits(task)
    width = lim[:, 1] - lim[:, 0]
    width = torch.where(torch.isfinite(width), width, torch.zeros_like(width))
    return width / 100.0 * noise_pct


def apply_controls(task: Task, qp, qv, U, U_n, accept, best, old, z, std,
                   targets):
    """The part of the lane replan after the forward pass (JAX
    `sync.py:148-177`), plain twin of kernel K8 (kernels/ops.py:mpc_apply).

    qp (nq, B), qv (nv, B), U and U_n (H, nu, B), accept (B,) bool, best
    and old (B,), z (num_apply, nu, B) standard normals, std (nu,), targets
    (ntgt, B) -> qp2, qv2, U_shift (H, nu, B), qps (num_apply, nq, B), qvs,
    us (num_apply, nu, B), cs (num_apply, B), rcost (B,)."""
    lim = control_limits(task)
    lo, hi = lim[:, 0, None], lim[:, 1, None]
    acc = accept.to(U.dtype)
    U_new = acc * U_n + (1.0 - acc) * U
    rcost = torch.where(accept, best, old)
    qps, qvs, us, cs = [], [], [], []
    for t in range(z.shape[0]):
        u = U_new[t] + std[:, None] * z[t]
        u = torch.minimum(torch.maximum(u, lo), hi)
        r = task.residual_fn(qp, qv, u, targets)
        qps.append(qp)
        qvs.append(qv)
        us.append(u)
        cs.append(step_cost(task, r, 0, 2))      # running weights
        qp, qv = step_state(task.model, qp, qv, u)
    n = z.shape[0]
    U_shift = torch.cat([U_new[n:], U_new[-1:].expand(n, -1, -1)])
    return (qp, qv, U_shift.contiguous(), torch.stack(qps), torch.stack(qvs),
            torch.stack(us), torch.stack(cs), rcost)


def _build_lane_replan(task: Task, cfg: ILQRConfig, horizon: int,
                       noise_pct: float, plain=False):
    """one_replan(qp (nq,B), qv (nv,B), U (H,nu,B), z (num_apply,nu,B),
    targets (ntgt,B)) -> (qp2, qv2, U_shift, qps, qvs, us, cs, rcost): one
    lane-last replan (JAX `sync.py:100`).  `plain` as in
    `solver/lanes.py:solve_lanes`, where K8 is named "mpc_apply"."""
    if task.keypoint_cfg.name == "iterative_error":
        raise NotImplementedError(
            "the lane MPC replan takes set_interval, adaptive_jerk, "
            "adaptive_accel and velocity_change keypoints; iterative_error's "
            "rounds are host-driven (as JAX mpc/sync.py:118 refuses it)")
    ph = lane_phases(task, cfg, horizon, plain)
    std = noise_std(task, noise_pct)
    plain_apply = plain if isinstance(plain, bool) else "mpc_apply" in plain

    def one_replan(qp, qv, U, z, targets):
        B = qp.shape[-1]
        lamb0 = torch.full((B,), cfg.lambda_init, dtype=qp.dtype,
                           device=qp.device)
        qpos, qvel, costs = ph["rollout"](qp, qv, U, targets)
        old = costs.sum(0)
        A, Bm, _, _ = ph["jacobians"](qpos, qvel, U)
        l_x, l_xx, l_u, l_uu = ph["cost_expansion"](qpos, qvel, U, targets)
        k, K, _, _, _ = ph["bp"](A, Bm, l_x, l_xx, l_u, l_uu, lamb0)
        traj, _, best, accept = ph["fp"](qpos, qvel, U, old, k, K, targets)
        return ops.mpc_apply(task, qp, qv, U, traj[2], accept, best, old, z,
                             std, targets, plain=plain_apply)

    return one_replan


def _noise_source(noise, n_replans, num_apply, nu, B, dtype, device):
    """z for replan r: noise[r] of a (n_replans, num_apply, nu, B) tensor,
    or standard normals drawn from the torch.Generator `noise`."""
    if torch.is_tensor(noise):
        want = (n_replans, num_apply, nu, B)
        if tuple(noise.shape) != want:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, "
                             f"want {want}")
        noise = noise.to(dtype=dtype, device=device)
        return lambda r: noise[r]
    return lambda r: torch.randn((num_apply, nu, B), generator=noise,
                                 dtype=dtype, device=device)


def _lane_executor(task, cfg, horizon, num_apply, noise_pct, plain, timed):
    model = task.model
    f64 = dict(dtype=model.dtype, device=model.device)
    one_replan = _build_lane_replan(task, cfg, horizon, noise_pct, plain)

    def mpc_run(qposB, qvelB, UB, targetsB, n_replans: int, noise):
        """qposB (B, nq), qvelB (B, nv), UB (B, H, nu), targetsB (B, ntgt);
        `noise` a torch.Generator or a tensor (n_replans, num_apply, nu,
        B) -> MPCRunResult, batch last on every field."""
        qp = torch.as_tensor(qposB, **f64).T.contiguous()
        qv = torch.as_tensor(qvelB, **f64).T.contiguous()
        U = torch.as_tensor(UB, **f64).permute(1, 2, 0).contiguous()
        tg = torch.as_tensor(targetsB, **f64).T.contiguous()
        if U.shape[0] != horizon:
            raise ValueError(f"controls have horizon {U.shape[0]}, "
                             f"not {horizon}")
        draw = _noise_source(noise, n_replans, num_apply, model.nu,
                             qp.shape[-1], **f64)
        cuda = qp.device.type == "cuda"
        outs, times = [], []
        for r in range(n_replans):
            z = draw(r)
            if timed and cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            qp, qv, U, *out = one_replan(qp, qv, U, z, tg)
            if timed:
                if cuda:
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
                else:
                    times.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        mpc_run.last_replan_ms = times
        return MPCRunResult(
            qpos_hist=torch.cat([torch.cat([o[0] for o in outs]), qp[None]]),
            qvel_hist=torch.cat([torch.cat([o[1] for o in outs]), qv[None]]),
            ctrl_hist=torch.cat([o[2] for o in outs]),
            cost_hist=torch.cat([o[3] for o in outs]),
            replan_costs=torch.stack([o[4] for o in outs]),
        )

    mpc_run.last_replan_ms = []
    return mpc_run


def make_lane_sync_mpc(task: Task, cfg: ILQRConfig, horizon: int,
                       num_apply: int, noise_pct: float = 5.0, plain=False):
    """Lane-last synchronous MPC (JAX `make_lane_sync_mpc`): the replans of
    B episodes run back to back, with no host synchronisation between them.
    mpc_run(qposB, qvelB, UB, targetsB, n_replans, noise) -> MPCRunResult
    with a trailing batch axis (qpos_hist (n_steps+1, nq, B), ...).
    `plain` as in `solver/lanes.py:solve_lanes` (True: every kernel's twin,
    K8's included; a collection of names runs those as twins, "mpc_apply"
    for K8)."""
    return _lane_executor(task, cfg, horizon, num_apply, noise_pct, plain,
                          timed=False)


def make_lane_sync_mpc_host(task: Task, cfg: ILQRConfig, horizon: int,
                            num_apply: int, noise_pct: float = 5.0,
                            plain=False):
    """The lane executor with each replan timed (JAX
    `make_lane_sync_mpc_host`): on the card by CUDA events around the replan
    and a synchronize after it, so a time is the replan's device work, not
    its dispatch; on the CPU by the host clock.  After a call,
    mpc_run.last_replan_ms holds one time per replan."""
    return _lane_executor(task, cfg, horizon, num_apply, noise_pct, plain,
                          timed=True)


def make_sync_mpc(task: Task, cfg: ILQRConfig, horizon: int, num_apply: int,
                  noise_pct: float = 5.0):
    """Generic synchronous MPC of one episode (JAX `make_sync_mpc`) on
    `solver/ilqr.py:optimise` at max_iterations = min_iterations = 1.
    mpc_run(qpos0 (nq,), qvel0 (nv,), U_init (H, nu), n_replans, noise)
    -> MPCRunResult without a batch axis; `noise` a torch.Generator or a
    tensor (n_replans, num_apply, nu)."""
    model = task.model
    f64 = dict(dtype=model.dtype, device=model.device)
    mpc_cfg = dataclasses.replace(cfg, max_iterations=1, min_iterations=1)
    std = noise_std(task, noise_pct)
    lim = control_limits(task)
    tg = task.residual_targets

    def mpc_run(qpos0, qvel0, U_init, n_replans: int, noise):
        qp = torch.as_tensor(qpos0, **f64)
        qv = torch.as_tensor(qvel0, **f64)
        U = torch.as_tensor(U_init, **f64)
        if U.shape[0] != horizon:
            raise ValueError(f"controls have horizon {U.shape[0]}, "
                             f"not {horizon}")
        if torch.is_tensor(noise):
            noise = noise[..., None]
        draw = _noise_source(noise, n_replans, num_apply, model.nu, 1, **f64)
        qps, qvs, us, cs, rcosts = [], [], [], [], []
        for r in range(n_replans):
            traj, stats = optimise(task, qp, qv, U, mpc_cfg)
            U_new = traj.ctrl
            z = draw(r)[..., 0]
            for t in range(num_apply):
                u = U_new[t] + std * z[t]
                u = torch.minimum(torch.maximum(u, lim[:, 0]), lim[:, 1])
                qn, vn = step_state(model, qp[:, None], qv[:, None],
                                    u[:, None])
                qps.append(qp)
                qvs.append(qv)
                us.append(u)
                qp, qv = qn[:, 0], vn[:, 0]
                r_ = task.residual_fn(qp, qv, u, tg)
                cs.append(step_cost(task, r_, 0, 2))
            U = torch.cat([U_new[num_apply:],
                           U_new[-1:].expand(num_apply, -1)])
            rcosts.append(stats.final_cost)
        return MPCRunResult(
            qpos_hist=torch.stack(qps + [qp]),
            qvel_hist=torch.stack(qvs + [qv]),
            ctrl_hist=torch.stack(us), cost_hist=torch.stack(cs),
            replan_costs=torch.tensor(rcosts, **f64))

    return mpc_run


def gravity_compensation_ctrl(task: Task, data: Data) -> torch.Tensor:
    """Hold-position controls from the bias force (nu, *L)
    (`MuJoCoHelper.cpp:200-232` GetRobotJointsGravityCompensationControls):
    u_a = qfrc_bias[dof of a] / gear_a."""
    model = task.model
    return torch.stack([
        data.qfrc_bias[model.jnt_dofadr[model.actuator_trnid[a]]]
        / model.actuator_gear[a, 0] for a in range(model.nu)])
