"""Lane-last batched iLQR (counterpart of `trajoptkp_tpu/solver/lanes.py`,
`make_lane_phase_optimise:869-959`).

B scenes ("lanes") are solved together with the lane axis last in every
array.  One host loop drives the phases with per-lane λ, per-lane accept and
per-lane early exit.  `lane_phases` hands out the phases of one iteration
by name, as the JAX `make_lane_batch_optimise(...).phases` does
(`solver/lanes.py:861-864`), for this loop and for the MPC replan
(mpc/sync.py):

  rollout         kernels.ops.rollout        (K3)
  jacobians       kernels.ops.fd_jacobian    (K5) + SI lerp in torch
  cost_expansion  torch.func.jacfwd of the residual + einsum (K6 stays torch)
  bp              kernels.ops.backward       (K7, λ retry per lane)
  fp              kernels.ops.linesearch     (K4) + argmin/accept in torch

On a CUDA device the ops launch the hand-written kernels; on the CPU they
run the plain twins.  `rule` picks the stopping rule: "lane" stops a lane
when converged and it + 1 >= min_iterations (JAX `lanes.py:942-944`),
"generic" when converged and it >= min_iterations (JAX `ilqr.py:699`).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops
from ..keypoints.methods import (NOT_PORTED, percentage_derivs, set_interval,
                                 si_keypoint_times)
from ..state.statevector import scatter_tangent
from ..dynamics.integrate import integrate_pos
from ..tasks.base import Task
from .ilqr import ILQRConfig, default_alphas


class SIPlan(NamedTuple):
    """Static set_interval schedule and its lerp between keypoint slots."""

    times: torch.Tensor   # (K,) keypoint times
    pidx: torch.Tensor    # (H,) slot of the previous keypoint
    nidx: torch.Tensor    # (H,) slot of the next keypoint
    w: torch.Tensor       # (H,) lerp weight
    pct: float            # percentage of steps with computed derivatives


def si_plan(task: Task, H: int) -> SIPlan:
    kp = task.keypoint_cfg
    if kp is None or kp.name != "set_interval":
        name = kp.name if kp is not None else None
        raise NotImplementedError(f"keypoint method {name!r}: {NOT_PORTED}")
    times = si_keypoint_times(H, kp.min_N)
    t = np.arange(H)
    pidx = np.searchsorted(times, t, side="right") - 1
    nidx = np.searchsorted(times, t, side="left")
    prev, nxt = times[pidx], times[nidx]
    w = (t - prev) / np.maximum(nxt - prev, 1)
    dev = task.model.device
    return SIPlan(
        times=torch.as_tensor(times, device=dev),
        pidx=torch.as_tensor(pidx, device=dev),
        nidx=torch.as_tensor(nidx, device=dev),
        w=torch.as_tensor(w, dtype=task.model.dtype, device=dev),
        pct=float(percentage_derivs(set_interval(H, 1, kp.min_N))[0]),
    )


def jacobians_si(task: Task, plan: SIPlan, qpos, qvel, U, eps: float,
                 plain: bool = False):
    """A (H, 2n, 2n, B), B (H, 2n, nu, B): FD at the SI keypoint slots,
    lerped in between (every dof shares the SI schedule, so the per-column
    lerp of InterpolateDerivatives is a whole-matrix lerp)."""
    n2 = task.sv.nx
    J = ops.fd_jacobian(task, qpos, qvel, U, plan.times, eps,
                        plain=plain)                   # (K, 2n, C, B)
    wL = plan.w[:, None, None, None]
    Jp, Jn = J[plan.pidx], J[plan.nidx]
    Jf = Jp + wL * (Jn - Jp)
    return Jf[:, :, :n2].contiguous(), Jf[:, :, n2:].contiguous()


def cost_expansion(task: Task, qpos, qvel, U, targets):
    """Gauss-Newton l_x, l_xx, l_u, l_uu (H, ., ., B) from forward-mode
    residual Jacobians on the tangent space."""
    model, sv = task.model, task.sv
    H = U.shape[0]
    n, nu = sv.ndof, model.nu
    qp = qpos[:H].transpose(0, 1)                      # (nq, H, B)
    qv = qvel[:H].transpose(0, 1)
    u = U.transpose(0, 1)
    tg = targets[:, None, :]

    def g(z):
        dq = scatter_tangent(model, sv, z[:n].reshape(n, 1, 1))
        dv = scatter_tangent(model, sv, z[n:2 * n].reshape(n, 1, 1))
        return task.residual_fn(integrate_pos(model, qp, dq, 1.0), qv + dv,
                                u + z[2 * n:].reshape(nu, 1, 1), tg)

    z0 = torch.zeros(2 * n + nu, dtype=qpos.dtype, device=qpos.device)
    r = g(z0)                                          # (nres, H, B)
    rJ = torch.func.jacfwd(g)(z0)                      # (nres, H, B, z)
    w = task.weights[:, None].expand(-1, H).clone()
    w[:, H - 1] = task.weights_terminal
    l_z = 2.0 * torch.einsum("rhb,rhbz->hzb", w[:, :, None] * r, rJ)
    l_zz = 2.0 * torch.einsum("rh,rhbz,rhby->hzyb", w, rJ, rJ)
    parts = (l_z[:, :2 * n], l_zz[:, :2 * n, :2 * n], l_z[:, 2 * n:],
             l_zz[:, 2 * n:, 2 * n:])
    return tuple(x.contiguous() for x in parts)


def forward_pass(task: Task, qpos, qvel, U, k, K, alphas, targets, old_cost,
                 plain: bool = False):
    """Line search over alphas; per lane the argmin, accepted when below
    the old cost.  Returns (qpos, qvel, ctrl, costs) of each lane's best
    alpha, its index, its total cost and the accept flags."""
    qps, qvs, us, cs = ops.linesearch(task, qpos, qvel, U, k, K, alphas,
                                      targets, plain=plain)
    total = cs.sum(0)                                  # (A, B)
    best = torch.argmin(total, dim=0)                  # (B,)
    best_cost = total.gather(0, best[None])[0]
    accept = best_cost < old_cost

    def pick(x):
        idx = best.reshape((1,) * (x.dim() - 1) + (-1,))
        idx = idx.expand(tuple(x.shape[:-2]) + (1, x.shape[-1]))
        return x.gather(x.dim() - 2, idx).squeeze(-2)

    return (pick(qps), pick(qvs), pick(us), pick(cs)), best, best_cost, accept


def lane_phases(task: Task, cfg: ILQRConfig, H: int, plain=False) -> dict:
    """The phases of one lane iteration at horizon H, by name (the JAX
    `.phases` dict): rollout(qp, qv, U, targets), jacobians(qpos, qvel, U)
    -> (A, Bm), cost_expansion(qpos, qvel, U, targets), bp(A, Bm, l_x, l_xx,
    l_u, l_uu, λ) -> (k, K, dJ, λ, λ-exit), fp(qpos, qvel, U, old, k, K,
    targets) -> (best trajectory (qpos, qvel, ctrl, costs), best alpha's
    index, its cost, accept); "pct" is the SI plan's percentage of steps
    with derivatives.  `plain` as in `solve_lanes`."""
    if not isinstance(plain, bool):
        unknown = set(plain) - set(ops.KERNELS + ops.MPC_KERNELS)
        if unknown:
            raise ValueError(f"unknown kernels {sorted(unknown)}")

    def twin(name: str) -> bool:
        return plain if isinstance(plain, bool) else name in plain

    plan = si_plan(task, H)
    alphas = default_alphas(cfg.num_parallel_rollouts, task.model.dtype,
                            task.model.device)
    return {
        "rollout": lambda qp, qv, U, tg: ops.rollout(
            task, qp, qv, U, tg, plain=twin("rollout")),
        "jacobians": lambda qpos, qvel, U: jacobians_si(
            task, plan, qpos, qvel, U, cfg.fd_eps, twin("fd_jacobian")),
        "cost_expansion": lambda qpos, qvel, U, tg: cost_expansion(
            task, qpos, qvel, U, tg),
        "bp": lambda A, Bm, l_x, l_xx, l_u, l_uu, lamb: ops.backward(
            A, Bm, l_x, l_xx, l_u, l_uu, lamb, cfg, plain=twin("backward")),
        "fp": lambda qpos, qvel, U, old, k, K, tg: forward_pass(
            task, qpos, qvel, U, k, K, alphas, tg, old, twin("linesearch")),
        "pct": plan.pct,
        "alphas": alphas,
    }


class LaneSolve(NamedTuple):
    qpos: torch.Tensor            # (H+1, nq, B) final nominal
    qvel: torch.Tensor            # (H+1, nv, B)
    ctrl: torch.Tensor            # (H, nu, B)
    costs: torch.Tensor           # (H, B) per-step costs of the nominal
    initial_cost: torch.Tensor    # (B,)
    final_cost: torch.Tensor      # (B,)
    num_iterations: torch.Tensor  # (B,)
    pct_derivs: torch.Tensor      # (B,)
    log: dict                     # per-iteration values of lane 0; "retried"
    #                               counts the lanes that took the λ retry
    opt_time_ms: float


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve_lanes(task: Task, cfg: ILQRConfig, qpos0, qvel0, U, targets,
                rule: str = "lane", verbose: bool = False,
                plain=False) -> LaneSolve:
    """The host iteration loop over B lanes.

    qpos0 (nq, B), qvel0 (nv, B), U (H, nu, B), targets (nres, B).
    `plain=True` runs the kernels' PyTorch twins on any device; a collection
    of kernel names (of `ops.KERNELS`) runs only those as twins, which tells
    apart the kernels a difference between the two paths comes from."""
    if rule not in ("lane", "generic"):
        raise ValueError(f"rule must be 'lane' or 'generic', not {rule!r}")
    dev = qpos0.device
    H, B = U.shape[0], U.shape[-1]
    ph = lane_phases(task, cfg, H, plain)
    pct, alphas = ph["pct"], ph["alphas"]
    log = {k: [] for k in ("cost", "pct", "alpha", "lambda", "retried",
                           "derivs_ms", "bp_ms", "fp_ms")}

    t_start = time.perf_counter()
    qpos, qvel, costs = ph["rollout"](qpos0, qvel0, U, targets)
    initial = costs.sum(0)
    old = initial
    lamb = torch.full((B,), cfg.lambda_init, dtype=U.dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), cfg.max_iterations, dtype=torch.int64,
                       device=dev)
    need_derivs = True
    for it in range(cfg.max_iterations):
        t0 = time.perf_counter()
        if need_derivs:
            A, Bm = ph["jacobians"](qpos, qvel, U)
            l_x, l_xx, l_u, l_uu = ph["cost_expansion"](qpos, qvel, U,
                                                        targets)
            _sync(dev)
        t1 = time.perf_counter()
        k, K, dJ, lam_n, lam_exit = ph["bp"](A, Bm, l_x, l_xx, l_u, l_uu,
                                             lamb)
        # live lanes whose backward pass went through the λ retry, read from
        # λ: a lane valid at once leaves clamp(λ / factor).  (One retry from
        # min_lambda leaves the same value and is not seen.)
        at_once = torch.clamp(lamb / cfg.lambda_factor, cfg.min_lambda,
                              cfg.max_lambda)
        log["retried"].append(int((~done & (lam_n > 1.5 * at_once)).sum()))
        lamb = torch.where(done, lamb, lam_n)
        _sync(dev)
        t2 = time.perf_counter()
        active = ~done & ~lam_exit
        if not bool(active.any()):
            # every live lane left through λ-exit: end before the forward
            # pass, as the generic solver does (ilqr.py:651)
            iters = torch.where(~done, it + 1, iters)
            done = torch.ones_like(done)
            break
        best_traj, best, best_cost, accept = ph["fp"](qpos, qvel, U, old, k,
                                                      K, targets)
        upd = accept & active
        qpos = torch.where(upd, best_traj[0], qpos)
        qvel = torch.where(upd, best_traj[1], qvel)
        U = torch.where(upd, best_traj[2], U)
        costs = torch.where(upd, best_traj[3], costs)
        new = torch.where(upd, best_cost, old)
        log["lambda"].append(float(lamb[0]))
        lamb = torch.where(
            upd | done, lamb,
            torch.clamp(lamb * cfg.lambda_factor ** 2, cfg.min_lambda,
                        cfg.max_lambda))
        converged = (old - new) / torch.clamp(new, min=1e-12) < cfg.eps_converge
        min_ok = (it >= cfg.min_iterations) if rule == "generic" \
            else (it + 1 >= cfg.min_iterations)
        _sync(dev)
        t3 = time.perf_counter()
        log["cost"].append(float(new[0]))
        log["pct"].append(pct)
        log["alpha"].append(float(alphas[best[0]]))
        log["derivs_ms"].append((t1 - t0) * 1e3)
        log["bp_ms"].append((t2 - t1) * 1e3)
        log["fp_ms"].append((t3 - t2) * 1e3)
        if verbose:
            print(f"iter {it}: cost {float(old[0]):.5f} -> {float(new[0]):.5f}"
                  f" lambda {log['lambda'][-1]:.2e} %derivs {pct:.1f} "
                  f"t(d/bp/fp) {log['derivs_ms'][-1]:.1f}/"
                  f"{log['bp_ms'][-1]:.1f}/{log['fp_ms'][-1]:.1f} ms")
        old = new
        newly = ~done & (lam_exit | (converged & min_ok))
        iters = torch.where(newly, it + 1, iters)
        done = done | newly
        need_derivs = bool(upd.any())
        if bool(done.all()):
            break
    _sync(dev)
    return LaneSolve(
        qpos=qpos, qvel=qvel, ctrl=U, costs=costs, initial_cost=initial,
        final_cost=old, num_iterations=iters,
        pct_derivs=torch.full((B,), pct, dtype=U.dtype, device=dev),
        log=log, opt_time_ms=(time.perf_counter() - t_start) * 1e3,
    )


class LaneBatchResult(NamedTuple):
    ctrl: torch.Tensor            # (B, H, nu)
    initial_cost: torch.Tensor    # (B,)
    final_cost: torch.Tensor      # (B,)
    num_iterations: torch.Tensor  # (B,)
    pct_derivs: torch.Tensor      # (B,)

    @property
    def cost_reduction(self):
        return 1.0 - self.final_cost / torch.clamp(self.initial_cost,
                                                   min=1e-12)


def make_lane_phase_optimise(task: Task, cfg: ILQRConfig, H: int,
                             plain=False):
    """run(qposB (B, nq), qvelB (B, nv), UB (B, H, nu), targetsB (B, nres))
    -> LaneBatchResult, on the task's device, with the lane stopping rule;
    `plain=True` runs the kernels' PyTorch twins (a reference on the card),
    a collection of kernel names only those (see `solve_lanes`)."""
    si_plan(task, H)  # refuse an unported keypoint method up front
    model = task.model
    f64 = dict(dtype=model.dtype, device=model.device)

    def run(qposB, qvelB, UB, targetsB) -> LaneBatchResult:
        if UB.shape[1] != H:
            raise ValueError(f"controls have horizon {UB.shape[1]}, not {H}")
        res = solve_lanes(
            task, cfg,
            torch.as_tensor(qposB, **f64).T.contiguous(),
            torch.as_tensor(qvelB, **f64).T.contiguous(),
            torch.as_tensor(UB, **f64).permute(1, 2, 0).contiguous(),
            torch.as_tensor(targetsB, **f64).T.contiguous(),
            rule="lane", plain=plain,
        )
        return LaneBatchResult(
            ctrl=res.ctrl.permute(2, 0, 1), initial_cost=res.initial_cost,
            final_cost=res.final_cost, num_iterations=res.num_iterations,
            pct_derivs=res.pct_derivs,
        )

    return run


def scenes(task: Task, B: int, seed: int = 0, spread: float = 0.3):
    """B scenes on the task's device: qpos_start + spread N(0, 1) from a
    numpy seed, zero qvel, the task's targets (the recipe of
    tests/test_lanes_solver.py)."""
    device = task.model.device
    rng = np.random.default_rng(seed)
    nq = task.model.nq
    qp = (task.qpos_start.cpu().numpy()[None, :]
          + spread * rng.standard_normal((B, nq)))
    f64 = dict(dtype=task.model.dtype, device=device)
    return (torch.as_tensor(qp, **f64),
            torch.zeros((B, task.model.nv), **f64),
            task.residual_targets.to(device)[None, :].expand(B, -1).clone())
