"""Exact Jacobians on the port's lane path: K5ad's plain twin
(`derivs/ad.py`, forward mode through the plain step) with the constraint
solve differentiated implicitly at its Newton iterate (K2c's twin,
`dynamics/contact.py:_NewtonSolve`), against the JAX package, float64 on
the CPU; the generic solve's `deriv_mode` and the CLI's `--deriv_mode`.

JAX lane programs and exact columns at push_ncl and walker width do not
compile in tier-1 time on this CPU (minutes each), so:

- the implicit tangent is held against JAX `contact._newton_solver`'s and
  `lanes._solve_rows_x`'s jvp on panda's limit rows and on the slide-pusher
  contact fixture of tests/test_torch_push_solve.py (push_ncl's pair kinds);
- the slot Jacobians against the JAX lane program's jacobians phase
  (`make_lane_batch_optimise(...).phases["jacobians"]`, H = 4, B = 2) at
  acrobot; against JAX `derivs/fd.py:_time_ad_jacobian` (the generic
  engine's exact columns) at pentabot with its links touching, the walker
  pressed into the floor and reaching with one of its two lanes at its
  joint limits (reaching's run eagerly: jitted, it compiles for over two
  minutes on a CPU); push_ncl from its servo starts against the port's
  central-FD twin (held against JAX's FD in tests/test_torch_push.py) on
  the lanes where no gate lies within the perturbation: there FD at eps
  and at 2 eps agree; reaching the same way too.

Tolerances, relative to the largest entry of the reference, with the
measured values: acrobot 1e-12 against the lane program (measured 5.9e-15);
pentabot folded, the walker pressed and reaching at its limits 1e-8, 1e-8
and 1e-10 against the generic engine's exact columns (measured 2.4e-10,
6.8e-11 and 3.3e-15: its Newton solve sums in its own order, at
stiff rows that 8 cold iterations leave unconverged); reaching and
push_ncl 1e-5 against their FD twins (measured 7.3e-8 and 1.3e-7, FD's
own error); the implicit tangents in test_implicit_tangent_matches_jax.
The central-FD route's bars against JAX are 1e-3 (panda, push_ncl), 5e-3
(the walker) and, at pentabot's touching links, 7.1e-2
(tests/test_torch_derivs.py, test_torch_push.py, test_torch_walker.py,
test_torch_pentabot.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.derivs.fd import _time_ad_jacobian
from trajoptkp_tpu.dynamics import contact as jcontact
from trajoptkp_tpu.dynamics import lanes as jlanes_dyn
from trajoptkp_tpu.solver import ilqr as jilqr
from trajoptkp_tpu.solver.lanes import make_lane_batch_optimise
from trajoptkp_tpu.tasks.locomotion import make_walker as jax_walker
from trajoptkp_tpu.tasks.reaching import make_reaching as jax_reaching
from trajoptkp_tpu.tasks.toys import make_acrobot as jax_acrobot
from trajoptkp_tpu.tasks.toys import make_pentabot as jax_pentabot
from trajoptkp_tpu.utils import math as jmath
from trajoptkp_tpu_torch import app
from trajoptkp_tpu_torch.derivs.ad import ad_slot_jacobians
from trajoptkp_tpu_torch.derivs.fd import fd_slot_jacobians
from trajoptkp_tpu_torch.dynamics.contact import (assemble_constraints,
                                                  newton_solve,
                                                  rows_jacobian)
from trajoptkp_tpu_torch.dynamics.fk import forward_kinematics
from trajoptkp_tpu_torch.dynamics.model import Data
from trajoptkp_tpu_torch.dynamics.smooth import fwd_velocity_smooth
from trajoptkp_tpu_torch.dynamics.step import smooth_force
from trajoptkp_tpu_torch.solver import ilqr as pilqr
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.tasks.locomotion import make_walker
from trajoptkp_tpu_torch.tasks.pushing import make_pushing, push_scenes
from trajoptkp_tpu_torch.tasks.reaching import make_reaching
from trajoptkp_tpu_torch.tasks.toys import make_acrobot, make_pentabot
from trajoptkp_tpu_torch.utils import math as tm
from trajoptkp_tpu_torch.utils.linalg import sym_solve

jax.config.update("jax_enable_x64", True)

H, NLANE = 4, 2


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


# ---- the implicit tangent of the constraint solve (K2c's twin) ------------


def _solve_operands(pt, qpos, qvel, ctrl):
    """M, a0 and the rows of one state (one lane) of the port's step."""
    d = forward_kinematics(pt.model, Data(qpos=qpos, qvel=qvel, ctrl=ctrl))
    d = fwd_velocity_smooth(pt.model, d)
    rows = assemble_constraints(pt.model, d)
    M = d.qM
    return M, sym_solve(M, smooth_force(d)), rows


def _implicit_case(name):
    """(port task, qpos, qvel, ctrl) with active rows: reaching at its
    joint limits, or the slide-pusher contact fixture from its first
    scene after a few steps (pusher and goal touching the table and each
    other)."""
    rng = np.random.default_rng(3)
    if name == "reaching":
        pt = make_reaching(device="cpu")
        rngl = pt.model.jnt_range.numpy()
        q = np.where(rng.integers(0, 2, 7) == 0, rngl[:, 0], rngl[:, 1])
        q = q + 0.01 * rng.standard_normal(7)
        return (pt, torch.tensor(q[:, None]),
                torch.tensor(0.5 * rng.standard_normal((7, 1))),
                torch.tensor(5.0 * rng.standard_normal((7, 1))))
    from test_torch_push_solve import _scenes, _tasks
    _, pt = _tasks()
    qp, qv, U, tg = _scenes(pt)
    qpos, qvel, _ = pilqr.rollout(
        pt, torch.from_numpy(qp[:1].T.copy()),
        torch.from_numpy(qv[:1].T.copy()),
        torch.from_numpy(U[:1].transpose(1, 2, 0).copy()),
        torch.from_numpy(tg[:1].T.copy()))
    return pt, qpos[5], qvel[5], torch.from_numpy(U[0, 5][:, None].copy())


@pytest.mark.parametrize("name", ["reaching", "slide_push"])
def test_implicit_tangent_matches_jax(name):
    """x and dx of the port's Newton solve (`newton_solve`, forward mode
    over M, a0, aref, invR and the contact coefficients) against JAX
    `contact._newton_solver` (dense J) and the lane engine's two forms,
    `lanes._solve_rows_x` (stacked) and `_solve_rows_x_regs` (registers),
    under jax.jvp, at a state with active rows and random tangents; and
    torch.func.jacfwd through the same Function equals its jvp columns (the
    Function carries a vmap rule).  Bars: 1e-6 against the generic solver
    (measured: reaching 2.1e-11 in x, 1.4e-11 in dx; slide-push 8.4e-8 and
    1.6e-7, where the two take different step lengths at the fourth of the
    8 cold iterations, which have not converged: their merits tie to
    rounding, and JAX sums the penalty in its own order), 1e-9 against the
    lane engine's forms, whose sums run in the port's order (measured
    2.1e-11 and 1.4e-11; slide-push 2.6e-15 and 6.0e-15 stacked, 1.5e-15
    and 3.4e-15 in registers)."""
    pt, qpos, qvel, ctrl = _implicit_case(name)
    M, a0, rows = _solve_operands(pt, qpos, qvel, ctrl)
    invR = rows.active / rows.R
    assert bool((rows.active > 0).any())
    nv, R = M.shape[0], rows.aref.shape[0]
    rng = np.random.default_rng(4)
    S = rng.standard_normal((nv, nv))
    dM = torch.tensor(0.1 * (S + S.T))[..., None]
    da0 = torch.tensor(rng.standard_normal((nv, 1)))
    daref = torch.tensor(rng.standard_normal((R, 1)))
    dinvR = torch.tensor(rng.standard_normal((R, 1))) * invR
    dblocks = [torch.tensor(0.1 * rng.standard_normal(tuple(b.coef.shape)))
               for b in rows.pairs]

    def port(M_, a0_, aref_, invR_, *coefs):
        r = rows._replace(aref=aref_, pairs=tuple(
            b._replace(coef=c) for b, c in zip(rows.pairs, coefs)))
        return newton_solve(M_, a0_, r, invR_)

    prim = (M, a0, rows.aref, invR, *(b.coef for b in rows.pairs))
    tang = (dM, da0, daref, dinvR, *dblocks)
    x, dx = torch.func.jvp(port, prim, tang)

    J = rows_jacobian(rows, nv)
    dJ = rows_jacobian(rows._replace(
        coefs=tuple((0.0,) * len(c) for c in rows.coefs),
        pairs=tuple(b._replace(coef=c) for b, c in zip(rows.pairs,
                                                       dblocks))), nv)
    J, dJ = (j if j.dim() == 2 else j[..., 0] for j in (J, dJ))
    lane = lambda t: jnp.asarray(t[..., 0].numpy())  # noqa: E731
    solve = jcontact._newton_solver(nv, 8)
    jx, jdx = jax.jvp(solve, (lane(M), lane(a0), jnp.asarray(J.numpy()),
                              lane(rows.aref), lane(invR), lane(a0)),
                      (lane(dM), lane(da0), jnp.asarray(dJ.numpy()),
                       lane(daref), lane(dinvR), jnp.zeros(nv)))
    assert _rel(x[:, 0], jx) < 1e-6
    assert _rel(dx[:, 0], jdx) < 1e-6

    # the lane engine's register rows: (dofs, (coeffs, aref, invR))
    dofs = [tuple(d) for d in rows.dofs]
    coefs = [tuple(jnp.asarray(c) for c in cs) for cs in rows.coefs]
    dcoefs = [tuple(jnp.zeros(()) for _ in cs) for cs in rows.coefs]
    for b, db in zip(rows.pairs, dblocks):
        for r_ in range(b.coef.shape[0]):
            dofs.append(tuple(b.support))
            coefs.append(tuple(jnp.asarray(b.coef[r_, w, 0].item())
                               for w in range(len(b.support))))
            dcoefs.append(tuple(jnp.asarray(db[r_, w, 0].item())
                                for w in range(len(b.support))))
    dyn = tuple((c, jnp.asarray(rows.aref[r_, 0].item()),
                 jnp.asarray(invR[r_, 0].item()))
                for r_, c in enumerate(coefs))
    ddyn = tuple((c, jnp.asarray(daref[r_, 0].item()),
                  jnp.asarray(dinvR[r_, 0].item()))
                 for r_, c in enumerate(dcoefs))
    lx, ldx = jax.jvp(
        lambda M_, a0_, dyn_: jlanes_dyn._solve_rows_x(tuple(dofs), 8, 1, M_,
                                                       a0_, dyn_),
        (lane(M), lane(a0), dyn), (lane(dM), lane(da0), ddyn))
    assert _rel(x[:, 0], lx) < 1e-9
    assert _rel(dx[:, 0], ldx) < 1e-9
    # and the register form, `_solve_rows_x_regs` (M and a0 as registers)
    regs = lambda t: tuple(tuple(jnp.asarray(t[i, j, 0].item())  # noqa: E731
                                 for j in range(nv)) for i in range(nv))
    vec = lambda t: tuple(jnp.asarray(t[i, 0].item())  # noqa: E731
                          for i in range(nv))
    rx, rdx = jax.jvp(
        lambda M_, a0_, dyn_: jlanes_dyn._solve_rows_x_regs(
            tuple(dofs), 8, 1, M_, a0_, dyn_),
        (regs(M), vec(a0), dyn), (regs(dM), vec(da0), ddyn))
    assert _rel(x[:, 0], rx) < 1e-9
    assert _rel(dx[:, 0], rdx) < 1e-9

    # jacfwd over a0 through the Function: its columns are the jvp's
    cols = torch.func.jacfwd(lambda a: port(M, a, *prim[2:]))(a0)
    for k in range(nv):
        e = torch.zeros_like(a0)
        e[k] = 1.0
        _, dk = torch.func.jvp(lambda a: port(M, a, *prim[2:]), (a0,), (e,))
        assert torch.equal(cols[:, 0, k, 0], dk[:, 0])


def test_quat_exp_and_log_tangents_at_zero():
    """The exp and log maps at a zero rotation and at the identity, the
    points every Jacobian column differentiates them at: no NaN (sqrt at 0
    is never differentiated), exp's tangent 0.5 dv, log's 2 dq_vec, as
    JAX's double-where guarded forms give."""
    rng = np.random.default_rng(1)
    dv = rng.standard_normal(3)
    zero = torch.zeros(3, 1, dtype=torch.float64)
    _, t = torch.func.jvp(tm.quat_exp, (zero,), (torch.tensor(dv[:, None]),))
    _, jt = jax.jvp(jmath.quat_exp, (jnp.zeros(3),), (jnp.asarray(dv),))
    assert torch.equal(t[:, 0], torch.tensor([0.0, *(0.5 * dv)]))
    np.testing.assert_array_equal(t[:, 0].numpy(), np.asarray(jt))
    dq = rng.standard_normal(4)
    one = torch.tensor([[1.0], [0.0], [0.0], [0.0]], dtype=torch.float64)
    _, t = torch.func.jvp(tm.quat_log, (one,), (torch.tensor(dq[:, None]),))
    _, jt = jax.jvp(jmath.quat_log, (jnp.asarray([1.0, 0, 0, 0]),),
                    (jnp.asarray(dq),))
    assert bool(torch.isfinite(t).all())
    np.testing.assert_allclose(t[:, 0].numpy(), 2.0 * dq[1:], rtol=1e-15)
    np.testing.assert_allclose(t[:, 0].numpy(), np.asarray(jt), rtol=1e-15)


def test_clip_halves_a_tangent_at_its_bound_as_jax_does():
    """A control the line search left exactly at its bound: the step's clip
    passes half its tangent, as jnp.clip does (torch.clamp would pass all
    of it); inside the bounds all of it, outside none."""
    x = torch.tensor([-1.0, 0.3, 1.0, 2.0], dtype=torch.float64)
    _, t = torch.func.jvp(lambda v: tm.clip(v, -1.0, 1.0), (x,),
                          (torch.ones_like(x),))
    _, jt = jax.jvp(lambda v: jnp.clip(v, -1.0, 1.0),
                    (jnp.asarray(x.numpy()),), (jnp.ones(4),))
    assert t.tolist() == [0.5, 1.0, 0.5, 0.0]
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


# ---- the slot Jacobians (K5ad's twin) -------------------------------------


def _states(pt, rng):
    """N(0, 1) states and controls, qpos (H+1, nq, B), qvel, U (H, nu, B),
    as tests/test_torch_cost_expansion.py makes them."""
    m = pt.model
    return (rng.standard_normal((H + 1, m.nq, NLANE)),
            rng.standard_normal((H + 1, m.nv, NLANE)),
            rng.standard_normal((H, m.nu, NLANE)))


def test_lane_jacobians_match_jax_lane_program():
    """Acrobot: the lane jacobians phase (SI_1: K5ad's twin at every step)
    against the JAX lane program's, jitted."""
    jt, pt = jax_acrobot(dtype=jnp.float64), make_acrobot(device="cpu")
    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    pt = pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    qp, qv, U = _states(pt, np.random.default_rng(11))
    A, Bm, pct, ovf = planes.lane_phases(pt, pilqr.ILQRConfig(), H)[
        "jacobians"](*map(torch.from_numpy, (qp, qv, U)))
    jA, jB, jpct, jovf = jax.jit(make_lane_batch_optimise(
        jt, jilqr.ILQRConfig(), H).phases["jacobians"])(qp, qv, U)
    np.testing.assert_array_equal(pct.numpy(), np.asarray(jpct))
    got = np.concatenate([A.numpy(), Bm.numpy()], axis=2)
    want = np.concatenate([np.asarray(jA), np.asarray(jB)], axis=2)
    assert _rel(got, want) <= 1e-12, _rel(got, want)


def _rows_active(pt, qp, qv, u):
    """Per lane, whether any constraint row is active at (qp, qv, u)."""
    rows = assemble_constraints(pt.model, fwd_velocity_smooth(
        pt.model, forward_kinematics(pt.model, Data(qp, qv, u))))
    return (rows.active > 0).any(0)


def _touching(name, pt, rng):
    """(qpos (nq, B), qvel, ctrl) with constraint rows active: pentabot
    folded at random (+-3 rad a joint; the first NLANE folds in which two
    links touch), the walker's feet pressed into the floor, reaching's
    first lane with every joint within 0.01 of one of its limits and its
    second inside the middle half of its range."""
    m = pt.model
    if name == "reaching":
        lo, hi = pt.model.jnt_range.numpy().T
        side = rng.integers(0, 2, m.nq)
        qp = np.stack([np.where(side == 0, lo, hi)
                       + 0.01 * rng.standard_normal(m.nq),
                       lo + (hi - lo) * (0.25 + 0.5 * rng.random(m.nq))], 1)
    elif name == "pentabot":
        folds = 6.0 * rng.random((m.nq, 8 * NLANE)) - 3.0
        z = torch.zeros((m.nv, folds.shape[1]), dtype=torch.float64)
        touch = _rows_active(pt, torch.from_numpy(folds), z, z[:m.nu])
        qp = folds[:, touch.numpy()][:, :NLANE]
    else:
        qp = np.tile(pt.qpos_start.numpy()[:, None], (1, NLANE))
        qp[0] = -0.02 * rng.random(NLANE)
        qp[3:] = rng.random((6, NLANE)) - 0.5
    return (qp, 0.3 * rng.standard_normal((m.nv, NLANE)),
            2.0 * rng.random((m.nu, NLANE)) - 1.0)


@pytest.mark.parametrize("name,tol", [("pentabot", 1e-8), ("walker", 1e-8),
                                      ("reaching", 1e-10)])
def test_jacobians_match_jax_exact_columns(name, tol):
    """K5ad's twin against JAX `_time_ad_jacobian` (jacfwd of the generic
    engine's step, its solve differentiated implicitly), jitted once, at
    two states with contact rows active (asserted); reaching's at one state
    with its limit rows active and one with none (asserted), run eagerly."""
    if name == "pentabot":
        jt, pt = jax_pentabot(dtype=jnp.float64), make_pentabot(device="cpu")
    elif name == "reaching":
        jt, pt = jax_reaching(dtype=jnp.float64), make_reaching(device="cpu")
    else:
        jt = jax_walker(run=True, dtype=jnp.float64)
        pt = make_walker(run=True, device="cpu")
    qp, qv, u = _touching(name, pt, np.random.default_rng(5))
    args = tuple(map(torch.from_numpy, (qp, qv, u)))
    active = _rows_active(pt, *args).tolist()
    assert qp.shape[1] == NLANE
    assert active == ([True, False] if name == "reaching" else
                      [True] * NLANE), active
    J = ad_slot_jacobians(pt.model, pt.sv, *args)

    def columns(a, b, c):
        return _time_ad_jacobian(jt.model, jt.sv, a, b, c)

    if name == "reaching":
        def jac(a, b, c):
            with jax.disable_jit():
                return columns(*map(jnp.asarray, (a, b, c)))
    else:
        jac = jax.jit(columns)
    for b in range(NLANE):
        want = jac(qp[:, b], qv[:, b], u[:, b])
        assert _rel(J[..., b], want) <= tol, _rel(J[..., b], want)


def _fd_smooth_lanes(pt, qp, qv, u):
    """K5ad's twin and the FD twin, and the lanes where no contact, limit or
    step-length gate lies within the perturbation: there FD at eps and at
    2 eps agree to 1e-6 of the largest entry."""
    J = ad_slot_jacobians(pt.model, pt.sv, qp, qv, u)
    f1 = fd_slot_jacobians(pt.model, pt.sv, qp, qv, u, 1e-6)
    f2 = fd_slot_jacobians(pt.model, pt.sv, qp, qv, u, 2e-6)
    smooth = [b for b in range(qp.shape[1])
              if _rel(f1[..., b], f2[..., b]) < 1e-6]
    return J, f1, smooth


@pytest.mark.parametrize("name", ["reaching", "push_ncl"])
def test_jacobians_match_fd_away_from_gates(name):
    """Reaching with every joint at a limit and push_ncl from its servo
    starts (the task's scenes, the arm moved by 0.05 N(0, 1), the goal on
    the table), where the JAX programs do not compile in tier-1 time:
    K5ad's twin against the port's central-FD twin (held against JAX's FD
    in tests/test_torch_reaching.py and tests/test_torch_push.py) at 1e-5
    of the largest entry on the lanes without a gate within the
    perturbation (`_fd_smooth_lanes`; at least half of them qualify, and
    rows are active in one at least).  The implicit tangent at active rows
    is held against JAX above."""
    g = torch.Generator().manual_seed(3)
    f64 = dict(dtype=torch.float64)
    if name == "reaching":
        pt = make_reaching(device="cpu")
        rngl = pt.model.jnt_range
        side = torch.randint(0, 2, (7, 6), generator=g)
        qp = torch.where(side == 0, rngl[:, :1], rngl[:, 1:]) + \
            0.01 * torch.randn((7, 6), generator=g, **f64)
        qv = 0.5 * torch.randn((7, 6), generator=g, **f64)
        u = 5.0 * torch.randn((7, 6), generator=g, **f64)
    else:
        pt = make_pushing(device="cpu")
        qp, _, _ = push_scenes(pt, 6, seed=2)
        qp = qp.T.contiguous()
        qp[:7] += 0.05 * torch.randn((7, 6), generator=g, **f64)
        qv = 0.1 * torch.randn((pt.model.nv, 6), generator=g, **f64)
        u = 0.3 * torch.randn((7, 6), generator=g, **f64)
    J, f1, smooth = _fd_smooth_lanes(pt, qp, qv, u)
    assert 2 * len(smooth) >= qp.shape[1], smooth
    assert bool(_rows_active(pt, qp, qv, u)[smooth].any())
    for b in smooth:
        assert _rel(J[..., b], f1[..., b]) <= 1e-5, (b, _rel(J[..., b],
                                                             f1[..., b]))


# ---- deriv_mode: the generic solve and the CLI ----------------------------


def test_generic_optimise_ad_matches_jax_ad_time():
    """`optimise` with deriv_mode "ad" (K5ad's twin in the generic solve),
    3 iterations of acrobot SI_2 at H = 30, against JAX `optimise` with
    deriv_mode "ad_time": costs to 1e-12 relative, controls to 1e-12
    (measured 1.7e-16 and 9.4e-16); "ad" and "ad_time" are one route here,
    and "fd" is another."""
    jt = jax_acrobot(dtype=jnp.float64)
    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(
        name="set_interval", min_N=2))
    pt = make_acrobot(device="cpu")
    pt = pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(
        name="set_interval", min_N=2))
    rng = np.random.default_rng(2)
    qp = pt.qpos_start.numpy() + 0.3 * rng.standard_normal(2)
    qv, U = np.zeros(2), np.zeros((30, 1))
    cfg = pilqr.ILQRConfig(max_iterations=3, min_iterations=3,
                           deriv_mode="ad")
    jtraj, jstats = jilqr.optimise(
        jt, jnp.asarray(qp), jnp.asarray(qv), jnp.asarray(U),
        jilqr.ILQRConfig(max_iterations=3, min_iterations=3,
                         deriv_mode="ad_time"))
    for mode in ("ad", "ad_time"):
        traj, stats = pilqr.optimise(pt, torch.from_numpy(qp),
                                     torch.from_numpy(qv), torch.from_numpy(U),
                                     dataclasses.replace(cfg, deriv_mode=mode))
        np.testing.assert_allclose(stats.cost_history, jstats.cost_history,
                                   rtol=1e-12)
        np.testing.assert_allclose(traj.ctrl.numpy(), np.asarray(jtraj.ctrl),
                                   rtol=0, atol=1e-12)
    fd = pilqr.optimise(pt, torch.from_numpy(qp), torch.from_numpy(qv),
                        torch.from_numpy(U),
                        dataclasses.replace(cfg, deriv_mode="fd"))[1]
    assert fd.cost_history != stats.cost_history


def test_deriv_mode_parsing_and_routes():
    """--deriv_mode: auto is fd (the JAX rule in float64 off a TPU), ad
    with a set_interval --keypoint becomes ad_time, ad with another method
    or the task's own stays ad, an unknown mode is refused; the lane path
    takes the exact Jacobians whatever deriv_mode says, the generic rule
    follows it; an unknown deriv_mode is refused by the phases."""
    kp = make_acrobot(device="cpu").keypoint_cfg
    parse = app.build_parser().parse_args
    assert parse([]).deriv_mode == "auto"
    with pytest.raises(SystemExit):
        parse(["--deriv_mode", "exact"])
    si = app.parse_keypoint_name(kp, "SI_5")
    assert app.resolve_deriv_mode("auto", si, True) == "fd"
    assert app.resolve_deriv_mode("ad", si, True) == "ad_time"
    assert app.resolve_deriv_mode("ad", kp, False) == "ad"
    assert app.resolve_deriv_mode("ad", app.parse_keypoint_name(
        kp, "AJ_1_50"), True) == "ad"
    assert app.resolve_deriv_mode("fd", si, True) == "fd"

    pt = make_acrobot(device="cpu")
    pt = pt.replace(keypoint_cfg=si.replace(min_N=1))
    qp, qv, U = _states(pt, np.random.default_rng(0))
    args = tuple(map(torch.from_numpy, (qp, qv, U)))
    times = torch.arange(H)
    exact = ad_slot_jacobians(pt.model, pt.sv, *(x[times].transpose(0, 1)
                                                  for x in args))
    central = fd_slot_jacobians(pt.model, pt.sv, *(x[times].transpose(0, 1)
                                                    for x in args))
    fd_cfg = pilqr.ILQRConfig(deriv_mode="fd")
    for generic, want in ((False, exact), (True, central)):
        A, Bm = planes.lane_phases(pt, fd_cfg, H, generic=generic)[
            "jacobians"](*args)[:2]
        got = torch.cat([A, Bm], 2).permute(1, 2, 0, 3)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="deriv_mode"):
        planes.lane_phases(pt, pilqr.ILQRConfig(deriv_mode="exact"), H)
