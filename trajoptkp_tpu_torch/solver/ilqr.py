"""iLQR with keypoint derivatives (counterpart of `trajoptkp_tpu/solver/ilqr.py`).

This module holds the configuration, the result types, `optimise` (the
open-loop solve of one scene) and the plain PyTorch twins of three kernels,
all batch-last over B lanes:

- `rollout` (JAX `ilqr.py:150`), twin of K3 (kernels/csrc/rollout.cu);
- `backward_pass` and `backward_pass_lambda_loop` (`:339,380`), twin of K7
  (kernels/csrc/backward.cu);
- `forward_pass_rollouts` (the rollouts of `forward_pass`, `:414`), twin of
  K4 (kernels/csrc/linesearch.cu); the argmin and accept stay torch in
  solver/lanes.py.

The λ retry is the JAX lane solver's coupled loop: while any lane is
invalid and not exited, every lane sweeps again (`backward_pass_lambda_loop`;
at B = 1 the generic loop).
`optimise` drives solver/lanes.py's host loop at B = 1 with the generic
convergence rule and the generic solve's keypoint semantics (every keypoint
method, iterative_error through the lane bisection at B = 1, `filtering`,
`auto_adjust`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..dynamics.model import Data
from ..dynamics.step import advance, forward
from ..state.statevector import to_tangent
from ..tasks.base import Task, control_limits
from ..utils.linalg import chol_solve_unrolled, chol_unrolled


DERIV_MODES = ("fd", "ad", "ad_time")


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    max_iterations: int = 10
    min_iterations: int = 5
    num_parallel_rollouts: int = 6      # line-search alphas
    fd_eps: float = 1e-6
    lambda_init: float = 0.1
    lambda_factor: float = 10.0
    min_lambda: float = 1e-4
    max_lambda: float = 10.0
    eps_converge: float = 0.02
    # the dynamics Jacobians of the generic solve (`optimise`, and the
    # asynchronous and generic MPC executors on it): "fd" central
    # differences at fd_eps (K5), "ad" and "ad_time" exact forward-mode
    # columns (K5ad; the two are one route here: the port evaluates whole
    # Jacobians at the keypoint times, which JAX's "ad_time" does, and a
    # column of an exact Jacobian does not depend on the others).  The lane
    # solver and the lane MPC replan take K5ad whatever this says, as the
    # JAX lane program has no FD.
    deriv_mode: str = "fd"
    # the generic solve (`optimise`) filters A's velocity rows along time:
    # "none", "low_pass" or "FIR" (keypoints/filtering.py)
    filtering: str = "none"
    # adaptive keypoints on lanes: slot budget K_max per lane (None: the
    # worst case min(H, 2 (H // min_N) + 2)); the latest middle keypoint
    # times past it are dropped and counted in LaneSolve.kp_overflow
    lane_kp_budget: Optional[int] = None


class Trajectory(NamedTuple):
    qpos: torch.Tensor   # (H+1, nq)
    qvel: torch.Tensor   # (H+1, nv)
    ctrl: torch.Tensor   # (H, nu)
    costs: torch.Tensor  # (H,)


@dataclasses.dataclass
class ILQRStats:
    initial_cost: float = 0.0
    final_cost: float = 0.0
    cost_reduction: float = 0.0
    num_iterations: int = 0
    cost_history: tuple = ()
    percent_derivs: tuple = ()
    best_alphas: tuple = ()
    lambdas: tuple = ()
    time_derivs_ms: tuple = ()
    time_bp_ms: tuple = ()
    time_fp_ms: tuple = ()
    opt_time_ms: float = 0.0


def default_alphas(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """(i/n)^2 for i = 1..n."""
    i = torch.arange(1, n + 1, dtype=dtype, device=device)
    return (i / n) ** 2


def step_cost(task: Task, r: torch.Tensor, t: int, H: int) -> torch.Tensor:
    """sum_i w_i r_i^2 over the residual axis, summed left to right as the
    kernels do; terminal weights at t = H-1."""
    w = task.weights_terminal if t == H - 1 else task.weights
    wrr = w.reshape((-1,) + (1,) * (r.dim() - 1)) * r * r
    c = wrr[0]
    for i in range(1, wrr.shape[0]):
        c = c + wrr[i]
    return c


# ---------------------------------------------------------------------------
# rollout (plain twin of K3)
# ---------------------------------------------------------------------------


def rollout(task: Task, qpos0, qvel0, U, targets):
    """qpos0 (nq, B), qvel0 (nv, B), U (H, nu, B), targets (nres, B) ->
    qpos (H+1, nq, B), qvel (H+1, nv, B), costs (H, B); cost c(x_t, u_t)
    with terminal weights at t = H-1."""
    model = task.model
    H = U.shape[0]
    qp, qv = qpos0, qvel0
    qps, qvs, costs = [qp], [qv], []
    for t in range(H):
        u = U[t]
        data = forward(model, Data(qpos=qp, qvel=qv, ctrl=u))
        r = task.residual_fn(qp, qv, u, targets)
        costs.append(step_cost(task, r, t, H))
        data = advance(model, data)
        qp, qv = data.qpos, data.qvel
        qps.append(qp)
        qvs.append(qv)
    return torch.stack(qps), torch.stack(qvs), torch.stack(costs)


# ---------------------------------------------------------------------------
# backward pass + λ loop (plain twin of K7)
# ---------------------------------------------------------------------------


def _contract(X, Y):
    """sum_j X[j] * Y[j] over the leading axis, left to right (no fused
    multiply-add), as the kernel's loops run: X (J, *a), Y (J, *b) with
    broadcasting shapes."""
    s = X[0] * Y[0]
    for j in range(1, X.shape[0]):
        s = s + X[j] * Y[j]
    return s


def sum_contract(X, Y):
    """The same contraction as `_contract` in torch's own reduction order,
    which is not the kernel's: the reference that tells rounding-order
    differences from faults (chip_smoke.py holds K7 against both)."""
    n = max(X.dim(), Y.dim())        # X[j] * Y[j] broadcasts from the right
    X = X.reshape(X.shape[:1] + (1,) * (n - X.dim()) + X.shape[1:])
    Y = Y.reshape(Y.shape[:1] + (1,) * (n - Y.dim()) + Y.shape[1:])
    return (X * Y).sum(0)


def backward_pass(A, Bm, l_x, l_xx, l_u, l_uu, lamb, contract=_contract):
    """One Riccati sweep with per-lane λ (B,), in the operation order of
    kernel K7 (kernels/csrc/backward.cu:riccati_sweep): every sum runs
    left to right over its index, so that on the card the two agree bit
    for bit (a matrix product would sum in cuBLAS's order, with fused
    multiply-adds).  `contract=sum_contract` sums in another order.

    A (H, 2n, 2n, B), Bm (H, 2n, nu, B), l_x (H, 2n, B), l_xx (H, 2n, 2n, B),
    l_u (H, nu, B), l_uu (H, nu, nu, B) -> k (H, nu, B), K (H, nu, 2n, B),
    dJ (B,), valid (B,) bool."""
    H, nx = l_x.shape[0], l_x.shape[1]
    nu = l_u.shape[1]
    eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)[:, :, None]
    V_x, V_xx = l_x[H - 1], l_xx[H - 1]
    ks, Ks, dJ = [None] * H, [None] * H, torch.zeros_like(lamb)
    for t in reversed(range(H)):
        AB = torch.cat([A[t], Bm[t]], dim=1)           # (2n, 2n+nu, B)
        W = contract(V_xx.transpose(0, 1)[:, :, None], AB[:, None])
        g = contract(AB, V_x[:, None])                 # (2n+nu, B)
        G = contract(AB[:, :, None], W[:, None])       # (2n+nu, 2n+nu, B)
        Q_x = l_x[t] + g[:nx]
        Q_u = l_u[t] + g[nx:]
        Q_xx = l_xx[t] + G[:nx, :nx]
        Q_uu = l_uu[t] + G[nx:, nx:]
        Q_ux = G[nx:, :nx]
        L = chol_unrolled(Q_uu + lamb * eye_u)
        k_t = -chol_solve_unrolled(L, Q_u)
        K_t = -chol_solve_unrolled(L, Q_ux)
        Quu_k = contract(Q_uu.transpose(0, 1), k_t)              # (nu, B)
        Quu_K = contract(Q_uu.transpose(0, 1)[:, :, None], K_t[:, None])
        V_x = ((Q_x + contract(K_t, Quu_k[:, None]))
               + contract(K_t, Q_u[:, None])) + contract(Q_ux, k_t[:, None])
        V_xx = (((Q_xx + contract(K_t[:, :, None], Quu_K[:, None]))
                 + contract(K_t[:, :, None], Q_ux[:, None]))
                + contract(Q_ux[:, :, None], K_t[:, None]))
        V_xx = 0.5 * (V_xx + V_xx.transpose(0, 1))
        dJ = dJ + (contract(k_t, Q_u) + contract(k_t, Quu_k))
        ks[t], Ks[t] = k_t, K_t
    k, K = torch.stack(ks), torch.stack(Ks)
    valid = (torch.isfinite(k).all(dim=(0, 1))
             & torch.isfinite(K).all(dim=(0, 1, 2)))
    return k, K, dJ, valid


def update_lambda(cfg: ILQRConfig, lamb, valid):
    """λ / factor when valid, λ * factor otherwise; exit above max_lambda."""
    # a tensor divisor divides on the card too, as the kernel does
    factor = torch.tensor(cfg.lambda_factor, dtype=lamb.dtype,
                          device=lamb.device)
    lam = torch.where(valid, lamb / factor, lamb * factor)
    return torch.clamp(lam, cfg.min_lambda, cfg.max_lambda), lam > cfg.max_lambda


def bp_rounds(cfg: ILQRConfig) -> int:
    """The retry rounds the λ loop may take after its first sweep:
    log_factor(max_lambda / min_lambda) + 2.  A lane invalid at every sweep
    exits within log_factor(max / min) + 1 of them; the JAX loop runs on
    past this only while some lane keeps turning invalid again at a lower
    λ, where it need not end at all."""
    return int(math.ceil(math.log(cfg.max_lambda / cfg.min_lambda)
                         / math.log(cfg.lambda_factor))) + 2


def backward_pass_lambda_loop(A, Bm, l_x, l_xx, l_u, l_uu, lamb,
                              cfg: ILQRConfig, contract=_contract,
                              info: Optional[dict] = None):
    """The JAX lane solver's coupled λ loop (`solver/lanes.py:
    bp_lambda_loop:720-746`): one sweep of every lane, λ / factor where
    valid and λ * factor where not; then, while any lane is invalid and
    not exited, every lane sweeps again at its updated λ (at most
    `bp_rounds` times).  At B = 1 this is the generic loop (JAX
    `ilqr.py:380`).  Returns (k, K, dJ, new λ (B,), λ-exit (B,) bool:
    exited and not valid at the last sweep); `info["rounds"]` receives the
    rounds taken."""
    k, K, dJ, valid = backward_pass(A, Bm, l_x, l_xx, l_u, l_uu, lamb,
                                    contract)
    lam, exited = update_lambda(cfg, lamb, valid)
    rounds = 0
    for _ in range(bp_rounds(cfg)):
        if not bool((~valid & ~exited).any()):
            break
        k, K, dJ, valid = backward_pass(A, Bm, l_x, l_xx, l_u, l_uu, lam,
                                        contract)
        lam, exited = update_lambda(cfg, lam, valid)
        rounds += 1
    if info is not None:
        info["rounds"] = torch.tensor(rounds, device=lamb.device)
    return k, K, dJ, lam, exited & ~valid


# ---------------------------------------------------------------------------
# line-search rollouts (plain twin of K4)
# ---------------------------------------------------------------------------


def forward_pass_rollouts(task: Task, qpos, qvel, U, k, K, alphas, targets):
    """All alphas' rollouts under u = clip(u_nom + α k + K dx).

    qpos (H+1, nq, B), qvel (H+1, nv, B), U (H, nu, B) nominal; k (H, nu, B),
    K (H, nu, 2n, B), alphas (A,), targets (nres, B) -> qpos (H+1, nq, A, B),
    qvel (H+1, nv, A, B), ctrl (H, nu, A, B), costs (H, A, B)."""
    model, sv = task.model, task.sv
    H = U.shape[0]
    lim = control_limits(task)
    lo, hi = lim[:, 0, None, None], lim[:, 1, None, None]
    al = alphas[None, :, None]
    n_a = alphas.shape[0]
    qp = qpos[0][:, None, :].expand(-1, n_a, -1)
    qv = qvel[0][:, None, :].expand(-1, n_a, -1)
    tg = targets[:, None, :]
    qps, qvs, us, costs = [qp], [qv], [], []
    for t in range(H):
        dx = to_tangent(model, sv, qp, qv, qpos[t][:, None, :],
                        qvel[t][:, None, :])             # (2n, A, B)
        fb = K[t][:, 0, None, :] * dx[0]
        for j in range(1, dx.shape[0]):
            fb = fb + K[t][:, j, None, :] * dx[j]
        u = U[t][:, None, :] + al * k[t][:, None, :] + fb
        u = torch.minimum(torch.maximum(u, lo), hi)
        data = forward(model, Data(qpos=qp, qvel=qv, ctrl=u))
        r = task.residual_fn(qp, qv, u, tg)
        costs.append(step_cost(task, r, t, H))
        data = advance(model, data)
        qp, qv = data.qpos, data.qvel
        qps.append(qp)
        qvs.append(qv)
        us.append(u)
    return (torch.stack(qps), torch.stack(qvs), torch.stack(us),
            torch.stack(costs))


# ---------------------------------------------------------------------------
# full optimisation of one scene
# ---------------------------------------------------------------------------


def optimise(task: Task, qpos0, qvel0, U_init, cfg: ILQRConfig = None,
             verbose: bool = False,
             plain=False) -> Tuple[Trajectory, ILQRStats]:
    """Open-loop iLQR of one scene (iLQR::Optimise): the batched phases of
    solver/lanes.py at B = 1, stopping as the generic JAX solver does
    (converged and it >= min_iterations; λ-exit ends the solve).

    Runs on the device of the task's tensors; qpos0 (nq,), qvel0 (nv,),
    U_init (H, nu).  `plain` as in `solver/lanes.py:solve_lanes`."""
    from .lanes import solve_lanes

    cfg = cfg or ILQRConfig()
    dev = task.model.device
    f64 = dict(dtype=task.model.dtype, device=dev)
    res = solve_lanes(
        task, cfg,
        torch.as_tensor(qpos0, **f64)[:, None],
        torch.as_tensor(qvel0, **f64)[:, None],
        torch.as_tensor(U_init, **f64)[:, :, None],
        task.residual_targets[:, None],
        rule="generic", verbose=verbose, plain=plain,
    )
    traj = Trajectory(res.qpos[..., 0], res.qvel[..., 0], res.ctrl[..., 0],
                      res.costs[..., 0])
    initial, final = float(res.initial_cost[0]), float(res.final_cost[0])
    stats = ILQRStats(
        initial_cost=initial,
        final_cost=final,
        cost_reduction=1.0 - final / max(initial, 1e-12),
        num_iterations=int(res.num_iterations[0]),
        cost_history=tuple(res.log["cost"]),
        percent_derivs=tuple(res.log["pct"]),
        best_alphas=tuple(res.log["alpha"]),
        lambdas=tuple(res.log["lambda"]),
        time_derivs_ms=tuple(res.log["derivs_ms"]),
        time_bp_ms=tuple(res.log["bp_ms"]),
        time_fp_ms=tuple(res.log["fp_ms"]),
        opt_time_ms=res.opt_time_ms,
    )
    return traj, stats
