"""Lane-last batched iLQR (counterpart of `trajoptkp_tpu/solver/lanes.py`,
`make_lane_phase_optimise:869-959`).

B scenes ("lanes") are solved together with the lane axis last in every
array.  One host loop drives the phases with per-lane λ, per-lane accept and
per-lane early exit.  `lane_phases` hands out the phases of one iteration
by name, as the JAX `make_lane_batch_optimise(...).phases` does
(`solver/lanes.py:861-864`), for this loop and for the MPC replan
(mpc/sync.py):

  rollout         kernels.ops.rollout        (K3)
  jacobians       set_interval: kernels.ops.ad_jacobian (K5ad) + lerp in
                  torch; adaptive_jerk, adaptive_accel, velocity_change:
                  ops.keypoint_plan (K9a) + ops.ad_jacobian at per-lane
                  slots (K5ad) + ops.kp_interp (K9b);
                  iterative_error: host-driven bisection rounds of
                  ops.ad_jacobian into a full-horizon cache (K5ad) and
                  ops.ie_mse (K9c), then K9a + K9b on the cache.
                  The lane path's Jacobians are exact, as the JAX lane
                  program's (jacfwd); the generic rule follows
                  cfg.deriv_mode: "fd" runs ops.fd_jacobian (K5, central
                  differences) in K5ad's place
  cost_expansion  kernels.ops.cost_expansion (K6: the closed-form residual
                  Jacobian and its Gauss-Newton products)
  bp              kernels.ops.backward       (K7, the coupled λ retry)
  fp              kernels.ops.linesearch     (K4) + argmin/accept in torch

The jacobians phase returns (A, Bm, pct (B,), overflow (B,)) as the JAX
one does.  pct is each solver's own: the share of steps with a keypoint
(set_interval), the masked share sum(mask) / (H n) (adaptive), the share of
computed times (iterative_error on lanes); the generic solve (`optimise`)
reports the mean over dofs of each dof's share, as JAX `optimise`.  No
phase of the adaptive methods reads anything back to the host; the
iterative_error rounds are host-driven, as in JAX.

On a CUDA device the ops launch the hand-written kernels; on the CPU they
run the plain twins.  `rule` picks the stopping rule: "lane" stops a lane
when converged and it + 1 >= min_iterations (JAX `lanes.py:942-944`),
"generic" when converged and it >= min_iterations (JAX `ilqr.py:699`).
The generic rule also takes the generic solver's keypoint semantics
(`solver/ilqr.py:optimise:564-700`): no slot budget, `cfg.filtering`
applied to A, and with `auto_adjust` the surprise-driven mask of the last
iteration in place of the method's.  The lane rule refuses both, where the
JAX lane solver ignores them.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops
from ..keypoints.filtering import FILTERS, filter_dynamics
from ..keypoints.interpolate import column_dofs
from ..keypoints.methods import (METHODS, auto_adjust_mask,
                                 percentage_derivs, set_interval,
                                 si_keypoint_times)
from ..dynamics.integrate import integrate_pos
from ..dynamics.model import FREE
from ..state.statevector import scatter_tangent
from ..tasks.base import Task
from .ilqr import DERIV_MODES, ILQRConfig, _contract, default_alphas


class SIPlan(NamedTuple):
    """Static set_interval schedule and its lerp between keypoint slots."""

    times: torch.Tensor   # (K,) keypoint times
    pidx: torch.Tensor    # (H,) slot of the previous keypoint
    nidx: torch.Tensor    # (H,) slot of the next keypoint
    w: torch.Tensor       # (H,) lerp weight
    pct: float            # percentage of steps with computed derivatives


def si_plan(task: Task, H: int) -> SIPlan:
    """The set_interval schedule every task.keypoint_cfg.min_N steps."""
    kp = task.keypoint_cfg
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


def slot_jacobians(task: Task, deriv: str, plain: bool = False,
                   eps: float = 1e-6):
    """jac(qpos, qvel, U, times, counts=None, cache=None) -> J of one
    derivative route, in the slot modes of `ops.fd_jacobian`: "ad" the
    exact forward-mode Jacobians (K5ad, `ops.ad_jacobian`), "fd" central
    differences at eps (K5); `plain` runs the route's twin."""
    if deriv == "ad":
        return lambda qpos, qvel, U, times, **kw: ops.ad_jacobian(
            task, qpos, qvel, U, times, plain=plain, **kw)
    if deriv == "fd":
        return lambda qpos, qvel, U, times, **kw: ops.fd_jacobian(
            task, qpos, qvel, U, times, eps, plain=plain, **kw)
    raise ValueError(f"derivative route {deriv!r}: 'ad' or 'fd'")


def jacobians_si(task: Task, plan: SIPlan, qpos, qvel, U, jac):
    """A (H, 2n, 2n, B), B (H, 2n, nu, B): `jac` (a route of
    `slot_jacobians`) at the SI keypoint slots, lerped in between (every dof
    shares the SI schedule, so the per-column lerp of
    InterpolateDerivatives is a whole-matrix lerp)."""
    n2 = task.sv.nx
    J = jac(qpos, qvel, U, plan.times)                 # (K, 2n, C, B)
    wL = plan.w[:, None, None, None]
    Jp, Jn = J[plan.pidx], J[plan.nidx]
    Jf = Jp + wL * (Jn - Jp)
    return Jf[:, :, :n2].contiguous(), Jf[:, :, n2:].contiguous()


def _dof_qpos(model, j: int) -> int:
    """The qpos index of a hinge, slide or free-translation dof j; -1 for a
    free rotation's (no one coordinate)."""
    for jn in range(model.njnt):
        da = model.jnt_dofadr[jn]
        if da <= j < da + (6 if model.jnt_type[jn] == FREE else 1):
            if j - da >= 3:
                return -1
            return model.jnt_qposadr[jn] + j - da
    raise ValueError(f"dof {j} has no joint")


def selection_jacobian(task: Task) -> torch.Tensor:
    """J (nres, 2n + nu) of a residual that selects coordinates minus their
    targets ("joint_space", "select"): 1 at (row, the tangent column of its
    coordinate), 0 elsewhere (a row whose coordinate is not in the state
    vector is 0)."""
    model, sv = task.model, task.sv
    kind = task.residual_kind
    if kind[0] == "joint_space":
        nj, nr = kind[1], kind[2]
        rows = ([(0, i) for i in range(nj)] + [(1, i) for i in range(nj)]
                + [(2, a) for a in range(nr)])
    else:
        rows = list(kind[1])
    n = sv.ndof
    J = torch.zeros((len(rows), 2 * n + model.nu), dtype=model.dtype,
                    device=model.device)
    for k, (src, i) in enumerate(rows):
        if src == 2:
            J[k, 2 * n + i] = 1.0
        for s, j in enumerate(sv.order):
            if (src == 0 and _dof_qpos(model, j) == i) or (src == 1
                                                          and j == i):
                J[k, s + n * src] = 1.0
    return J


def residual_jacobian(task: Task, qp, qv, u, tg):
    """The residual r (nres, *L) and its Jacobian J on the tangent space
    (positions, velocities and controls of the state vector) in closed
    form: (nres, 2n + nu, 1, ...) for a residual that selects coordinates
    (a constant), (nres, 2n + nu, *L) for the pushing FK residual
    (tasks/pushing.py:push_residual_jacobian) and the box tasks'
    (tasks/manipulation.py).  The twin of
    kernels/csrc/cost_expansion.cu's `residual_jacobian`; a residual kind
    the kernels do not take is differentiated by forward mode."""
    kind = task.residual_kind
    if kind[0] in ("joint_space", "select"):
        J = selection_jacobian(task)
        return (task.residual_fn(qp, qv, u, tg),
                J.reshape(tuple(J.shape) + (1,) * (qp.dim() - 1)))
    if kind[0] == "push" and kind[1] == 0:
        from ..tasks.pushing import push_residual_jacobian
        return push_residual_jacobian(task.model, kind[2], kind[3], task.sv,
                                      task.model.nu, qp, qv, tg)
    if kind[0] in ("sweep", "tilt_push"):
        from ..tasks import manipulation as mt
        fn = (mt.sweep_residual_jacobian if kind[0] == "sweep"
              else mt.tilt_push_residual_jacobian)
        return fn(task.model, kind[1], kind[2], task.sv, task.model.nu, qp,
                  qv, tg)
    # a residual without a closed form (no kernel takes it; a task made in
    # a test): forward mode over the tangent columns
    model, sv = task.model, task.sv
    n, nu = sv.ndof, model.nu
    one = (1,) * (qp.dim() - 1)

    def g(z):
        dq = scatter_tangent(model, sv, z[:n].reshape((n,) + one))
        dv = scatter_tangent(model, sv, z[n:2 * n].reshape((n,) + one))
        return task.residual_fn(integrate_pos(model, qp, dq, 1.0), qv + dv,
                                u + z[2 * n:].reshape((nu,) + one), tg)

    z0 = torch.zeros(2 * n + nu, dtype=qp.dtype, device=qp.device)
    return g(z0), torch.func.jacfwd(g)(z0).movedim(-1, 1)


def cost_expansion(task: Task, qpos, qvel, U, targets):
    """Gauss-Newton l_x (H, 2n, B), l_xx (H, 2n, 2n, B), l_u (H, nu, B),
    l_uu (H, nu, nu, B) from the closed-form residual Jacobian J at each
    (t, b): l_z = 2 sum_r w_r r_r J_r and l_zz = 2 sum_r (w_r J_r) J_r^T,
    terminal weights at t = H-1.  The sums run left to right over the
    residual rows, as kernel K6 (kernels/csrc/cost_expansion.cu) and
    `ilqr._contract` do, so that on the card the two agree bit for bit.
    Plain twin of K6 (kernels/ops.py:cost_expansion)."""
    nx = task.sv.nx
    H, B = U.shape[0], U.shape[-1]
    r, J = residual_jacobian(task, qpos[:H].transpose(0, 1),
                             qvel[:H].transpose(0, 1), U.transpose(0, 1),
                             targets[:, None, :])      # (nres, H, B), J
    w = task.weights[:, None].expand(-1, H).clone()
    w[:, H - 1] = task.weights_terminal                # (nres, H)
    l_z = 2.0 * _contract((w[:, :, None] * r)[:, None], J)    # (nz, H, B)
    wJ = w[:, None, :, None] * J
    l_xx = 2.0 * _contract(wJ[:, :nx, None], J[:, None, :nx])
    l_uu = 2.0 * _contract(wJ[:, nx:, None], J[:, None, nx:])
    return (l_z[:nx].transpose(0, 1).contiguous(),
            l_xx.expand(-1, -1, H, B).permute(2, 0, 1, 3).contiguous(),
            l_z[nx:].transpose(0, 1).contiguous(),
            l_uu.expand(-1, -1, H, B).permute(2, 0, 1, 3).contiguous())


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


def kp_budget(cfg: ILQRConfig, task: Task, H: int) -> int:
    """K_max, the slot budget per lane of the adaptive methods (JAX
    `solver/lanes.py:223-226`): cfg.lane_kp_budget, or the worst case
    min(H, 2 (H // min_N) + 2)."""
    K_max = cfg.lane_kp_budget or min(
        H, 2 * (H // max(task.keypoint_cfg.min_N, 1)) + 2)
    if not 2 <= K_max <= H:
        raise ValueError(f"lane_kp_budget {K_max} must lie in [2, H={H}]")
    return K_max


def ie_levels(H: int, min_split: int):
    """The static dyadic bisection tree over [0, H-1] (JAX `solver/lanes.py:
    _ie_levels:55`): levels [(s, mid, e, parent)], a segment tested while
    e - s > min_split, parent[j] the previous level's node that spawned
    node j (None at level 0)."""
    levels = []
    nodes = [(0, H - 1)] if (H - 1) > min_split else []
    parent = None
    while nodes:
        s = np.array([a for a, _ in nodes], np.int32)
        e = np.array([b for _, b in nodes], np.int32)
        levels.append((s, (s + e) // 2, e, parent))
        nxt, par = [], []
        for i, (a, b) in enumerate(nodes):
            m = (a + b) // 2
            for ca, cb in ((a, m), (m, b)):
                if (cb - ca) > min_split:
                    nxt.append((ca, cb))
                    par.append(i)
        nodes = nxt
        parent = np.array(par, np.int32) if par else None
    return levels


def jacobians_adaptive(task: Task, pa, K_max: int, col_dof, qpos, qvel, U,
                       jac, twin, mask=None):
    """AJ, AA, VC on lanes (JAX `jacobians_adaptive:363`): K9a's keypoint
    mask (or `mask`, (H, n, B)) and per-lane slot plan, `jac` (K5ad or K5)
    at each lane's live slots, K9b's per-column lerp -> (A, Bm, plan)."""
    H = U.shape[0]
    plan = ops.keypoint_plan(pa, qvel, H, K_max, mask=mask,
                             plain=twin("keypoint_plan"))
    J = jac(qpos, qvel, U, plan.slot_t, counts=plan.count)
    A, Bm = ops.kp_interp(J, plan.pslot, plan.nslot, plan.w, col_dof,
                          task.sv.nx, plain=twin("kp_interp"))
    return A, Bm, plan


def jacobians_ie(task: Task, levels, threshold: float, pa_mask, col_dof,
                 qpos, qvel, U, jac, twin):
    """iterative_error on lanes (JAX `jacobians_ie:507`): host-driven
    bisection rounds.  Each round evaluates the Jacobians (`jac`, K5ad or
    K5) at the times some lane still needs into the full-horizon cache (H,
    2n, 2n+nu, B), then tests every open node per (dof, lane) on the cache
    (K9c); finally each dof's keypoints are the pairs it computed, and K9a
    (time slots) and K9b lerp the cache between them -> (A, Bm, pct of
    computed times (B,), the pair mask (H, n, B) bool)."""
    n, nx = task.sv.ndof, task.sv.nx
    H, B = U.shape[0], U.shape[-1]
    dev = U.device
    C = nx + task.model.nu
    computed_t = np.zeros((H, B), bool)
    pair = np.zeros((H, n, B), bool)
    cache = torch.zeros((H, nx, C, B), dtype=U.dtype, device=dev)
    tcol = np.arange(H)[:, None]

    def eval_times(need):
        need = need & ~computed_t
        counts = need.sum(axis=0)
        K = int(counts.max())
        if K == 0:
            return
        order = np.argsort(np.where(need, tcol, H + 1 + tcol), axis=0,
                           kind="stable")[:K]
        jac(qpos, qvel, U,
            torch.as_tensor(order, dtype=torch.int64, device=dev),
            counts=torch.as_tensor(counts, dtype=torch.int32, device=dev),
            cache=cache)
        computed_t[:] = computed_t | need

    # seed: both ends and the root midpoint, every dof and lane
    seed = np.zeros((H, B), bool)
    ends = [0, H - 1, (H - 1) // 2]
    seed[ends] = True
    eval_times(seed)
    pair[ends] = True
    open_ = split_prev = None
    for s_arr, mid_arr, e_arr, parent in levels:
        open_ = (np.ones((len(s_arr), n, B), bool) if open_ is None
                 else split_prev[parent])
        if not open_.any():
            break
        open_any = open_.any(axis=1)                   # (m, B)
        need = np.zeros((H, B), bool)
        for arr in (s_arr, mid_arr, e_arr):
            np.logical_or.at(need, arr, open_any)
        eval_times(need)
        for arr in (s_arr, mid_arr, e_arr):
            np.logical_or.at(pair, arr, open_)
        nodes = [torch.as_tensor(a, dtype=torch.int32, device=dev)
                 for a in (s_arr, mid_arr, e_arr)]
        mse = ops.ie_mse(cache, *nodes, n, plain=twin("ie_mse")).cpu().numpy()
        split_prev = open_ & (mse >= threshold)
    mask = torch.as_tensor(pair, device=dev)
    plan = ops.keypoint_plan(pa_mask, qvel, H, H, mask=mask, time_slots=True,
                             plain=twin("keypoint_plan"))
    A, Bm = ops.kp_interp(cache, plan.pslot, plan.nslot, plan.w, col_dof, nx,
                          plain=twin("kp_interp"))
    pct = torch.as_tensor(100.0 * computed_t.mean(axis=0), dtype=U.dtype,
                          device=dev)
    return A, Bm, pct, mask


def lane_phases(task: Task, cfg: ILQRConfig, H: int, plain=False,
                generic: bool = False) -> dict:
    """The phases of one lane iteration at horizon H, by name (the JAX
    `.phases` dict): rollout(qp, qv, U, targets), jacobians(qpos, qvel, U,
    mask=None) -> (A, Bm, pct (B,), overflow (B,)), cost_expansion(qpos,
    qvel, U, targets), bp(A, Bm, l_x, l_xx, l_u, l_uu, λ) -> (k, K, dJ, λ,
    λ-exit), fp(qpos, qvel, U, old, k, K, targets) -> (best trajectory
    (qpos, qvel, ctrl, costs), best alpha's index, its cost, accept).
    "keypoints" holds the last jacobians call's keypoint mask (H, n, B)
    under "mask".  `plain` as in `solve_lanes`.  `generic` takes the
    generic solve's keypoint semantics (module docstring); the jacobians
    phase then takes a mask (H, n, B) that replaces an adaptive method's
    (auto-adjust)."""
    if cfg.deriv_mode not in DERIV_MODES:
        raise ValueError(f"deriv_mode {cfg.deriv_mode!r}; known: "
                         f"{DERIV_MODES}")
    if not isinstance(plain, bool):
        unknown = set(plain) - set(ops.KERNELS + ops.MPC_KERNELS
                                   + ops.KEYPOINT_KERNELS)
        if unknown:
            raise ValueError(f"unknown kernels {sorted(unknown)}")

    def twin(name: str) -> bool:
        return plain if isinstance(plain, bool) else name in plain

    kp = task.keypoint_cfg
    if kp is None or kp.name not in METHODS:
        raise ValueError(f"keypoint method {getattr(kp, 'name', None)!r}; "
                         f"known: {METHODS}")
    if cfg.filtering not in FILTERS:
        raise ValueError(f"unknown filtering {cfg.filtering!r}; known: "
                         f"{FILTERS}")
    if not generic and (cfg.filtering != "none" or kp.auto_adjust):
        raise NotImplementedError(
            "the lane solver applies neither filtering nor auto_adjust "
            "(the JAX lane solver ignores them; its generic `optimise` "
            "applies them): use solver/ilqr.py:optimise")
    model = task.model
    dev = model.device
    n, f64 = task.sv.ndof, dict(dtype=model.dtype, device=dev)
    alphas = default_alphas(cfg.num_parallel_rollouts, model.dtype, dev)
    col_dof = torch.as_tensor(column_dofs(n, model.nu), dtype=torch.int32,
                              device=dev)
    state = {"mask": None}
    bp_info = {"rounds": 0}
    pa_mask = ops.keypoint_plan_args(task, "mask")
    # the lane path's Jacobians are exact (K5ad), as the JAX lane program's;
    # the generic solve's follow cfg.deriv_mode
    deriv = "fd" if generic and cfg.deriv_mode == "fd" else "ad"
    jac = slot_jacobians(task, deriv, twin(f"{deriv}_jacobian"), cfg.fd_eps)

    def filtered(A):
        return filter_dynamics(A, cfg.filtering) if generic else A

    if generic:
        def given(qpos, qvel, U, mask):
            """auto-adjust: the generic solve's mask replaces the method's"""
            A, Bm, lp = jacobians_adaptive(task, pa_mask, H, col_dof, qpos,
                                           qvel, U, jac, twin, mask)
            state["mask"] = lp.mask
            return filtered(A), Bm, lp.pct, lp.overflow

    if kp.name == "set_interval":
        plan = si_plan(task, H)
        si_mask = set_interval(H, n, kp.min_N).to(dev)

        def jacobians(qpos, qvel, U, mask=None):
            if mask is not None:
                return given(qpos, qvel, U, mask)
            B = U.shape[-1]
            A, Bm = jacobians_si(task, plan, qpos, qvel, U, jac)
            state["mask"] = si_mask[:, :, None].expand(H, n, B)
            return (filtered(A), Bm, torch.full((B,), plan.pct, **f64),
                    torch.zeros(B, dtype=torch.int32, device=dev))
    elif kp.name == "iterative_error":
        levels = ie_levels(H, max(kp.min_N, 1))

        def jacobians(qpos, qvel, U, mask=None):
            A, Bm, pct, state["mask"] = jacobians_ie(
                task, levels, float(kp.iterative_error_threshold), pa_mask,
                col_dof, qpos, qvel, U, jac, twin)
            return (filtered(A), Bm, pct,
                    torch.zeros(U.shape[-1], dtype=torch.int32, device=dev))
    else:
        pa = ops.keypoint_plan_args(task)
        K_max = H if generic else kp_budget(cfg, task, H)

        def jacobians(qpos, qvel, U, mask=None):
            if mask is not None:
                return given(qpos, qvel, U, mask)
            A, Bm, lp = jacobians_adaptive(task, pa, K_max, col_dof, qpos,
                                           qvel, U, jac, twin)
            state["mask"] = lp.mask
            return filtered(A), Bm, lp.pct, lp.overflow

    return {
        "rollout": lambda qp, qv, U, tg: ops.rollout(
            task, qp, qv, U, tg, plain=twin("rollout")),
        "jacobians": jacobians,
        "cost_expansion": lambda qpos, qvel, U, tg: ops.cost_expansion(
            task, qpos, qvel, U, tg, plain=twin("cost_expansion")),
        "bp": lambda A, Bm, l_x, l_xx, l_u, l_uu, lamb: ops.backward(
            A, Bm, l_x, l_xx, l_u, l_uu, lamb, cfg, plain=twin("backward"),
            info=bp_info),
        "fp": lambda qpos, qvel, U, old, k, K, tg: forward_pass(
            task, qpos, qvel, U, k, K, alphas, tg, old, twin("linesearch")),
        "alphas": alphas,
        "keypoints": state,
        "bp_info": bp_info,
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
    kp_overflow: torch.Tensor     # (B,) int32: the most keypoint times the
    #                               slot budget dropped in one iteration
    #                               (adaptive methods; 0 elsewhere)
    log: dict                     # per-iteration values of lane 0; "retried"
    #                               counts the λ loop's retry rounds (every
    #                               lane sweeps again in each)
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
    of kernel names (of `ops.KERNELS` and `ops.KEYPOINT_KERNELS`) runs only
    those as twins, which tells apart the kernels a difference between the
    two paths comes from.  rule="generic" also takes the generic solve's
    keypoint semantics (module docstring)."""
    if rule not in ("lane", "generic"):
        raise ValueError(f"rule must be 'lane' or 'generic', not {rule!r}")
    generic = rule == "generic"
    dev = qpos0.device
    H, B = U.shape[0], U.shape[-1]
    ph = lane_phases(task, cfg, H, plain, generic=generic)
    alphas, kp_state = ph["alphas"], ph["keypoints"]
    kp = task.keypoint_cfg
    adjust = generic and kp.auto_adjust and kp.name != "iterative_error"
    if adjust:
        inv_dt = 1.0 / float(task.model.timestep)
        order = torch.as_tensor(list(task.sv.order), device=dev)
        importances = torch.ones(task.sv.ndof, dtype=U.dtype, device=dev)
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
    pct_b = torch.zeros(B, dtype=U.dtype, device=dev)
    ovf = torch.zeros(B, dtype=torch.int32, device=dev)
    adjusted = None
    need_derivs = True
    for it in range(cfg.max_iterations):
        t0 = time.perf_counter()
        if need_derivs:
            A, Bm, pct_i, ovf_i = ph["jacobians"](qpos, qvel, U, adjusted)
            pct_b = torch.where(done, pct_b, pct_i)
            ovf = torch.maximum(ovf, torch.where(done, 0, ovf_i))
            if generic:
                # the generic solve's %derivs: the mean of the per-dof shares
                pct_dof = percentage_derivs(kp_state["mask"][..., 0])
                pct_b = pct_dof.mean().reshape(1).to(U.dtype)
            l_x, l_xx, l_u, l_uu = ph["cost_expansion"](qpos, qvel, U,
                                                        targets)
            _sync(dev)
        t1 = time.perf_counter()
        k, K, dJ, lam_n, lam_exit = ph["bp"](A, Bm, l_x, l_xx, l_u, l_uu,
                                             lamb)
        # the λ loop's retry rounds, in each of which every lane swept again
        log["retried"].append(int(ph["bp_info"]["rounds"]))
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
        if adjust:
            # AdjustKeyPointMethod (JAX ilqr.py:661-669): expected against
            # actual cost reduction sets the next derivatives' mask
            a, dj = float(alphas[best[0]]), float(dJ[0])
            expected = -(a * dj + (a * a / 2.0) * dj)
            actual = float(old[0]) - float(torch.where(upd, best_cost,
                                                       old)[0])
            vel = torch.where(upd, best_traj[1], qvel)[:H, order, 0]
            adjusted = auto_adjust_mask(vel, inv_dt, expected, actual,
                                        pct_dof, importances,
                                        kp.max_N)[:, :, None]
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
        min_ok = (it >= cfg.min_iterations) if generic \
            else (it + 1 >= cfg.min_iterations)
        _sync(dev)
        t3 = time.perf_counter()
        log["cost"].append(float(new[0]))
        log["pct"].append(float(pct_b[0]))
        log["alpha"].append(float(alphas[best[0]]))
        log["derivs_ms"].append((t1 - t0) * 1e3)
        log["bp_ms"].append((t2 - t1) * 1e3)
        log["fp_ms"].append((t3 - t2) * 1e3)
        if verbose:
            print(f"iter {it}: cost {float(old[0]):.5f} -> {float(new[0]):.5f}"
                  f" lambda {log['lambda'][-1]:.2e} %derivs "
                  f"{log['pct'][-1]:.1f} t(d/bp/fp) "
                  f"{log['derivs_ms'][-1]:.1f}/{log['bp_ms'][-1]:.1f}/"
                  f"{log['fp_ms'][-1]:.1f} ms")
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
        final_cost=old, num_iterations=iters, pct_derivs=pct_b,
        kp_overflow=ovf, log=log,
        opt_time_ms=(time.perf_counter() - t_start) * 1e3,
    )


class LaneBatchResult(NamedTuple):
    ctrl: torch.Tensor            # (B, H, nu)
    initial_cost: torch.Tensor    # (B,)
    final_cost: torch.Tensor      # (B,)
    num_iterations: torch.Tensor  # (B,)
    pct_derivs: torch.Tensor      # (B,)
    kp_overflow: torch.Tensor     # (B,) int32, as LaneSolve's

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
    lane_phases(task, cfg, H, plain)  # refuse what the lane path lacks
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
            pct_derivs=res.pct_derivs, kp_overflow=res.kp_overflow,
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
