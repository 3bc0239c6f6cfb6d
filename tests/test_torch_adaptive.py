"""Adaptive keypoints (adaptive_jerk, adaptive_accel, velocity_change) on the
port's lane path and in its generic solve, against the JAX package, float64
on the CPU (the plain twins of K9a, K5ad at per-lane slots and K9b).

- acrobot: the jacobians phase against the JAX lane program's, jitted as
  JAX `make_lane_phase_optimise` runs it: pct and overflow equal, the masks
  equal to the JAX selector's, A and B within 1e-12 (both take exact
  Jacobians; measured 4.1e-14 on entries up to 13), also under a slot
  budget small enough to
  overflow;
- reaching and push_ncl: a JAX lane jacobians program at panda width does
  not compile on this CPU in minutes (tests/test_torch_reaching.py), so
  they are held piece by piece: the masks equal to the jitted JAX selector
  on the same velocities (push_ncl's through its state vector, the free
  cylinder's translations included), each lane's slot Jacobians equal to
  the exact ones at the same times (K5ad's twin, held against JAX and
  against FD in tests/test_torch_ad.py), and A, B equal to JAX
  `interpolate_derivatives` of those columns under that mask;
- a whole acrobot velocity_change solve, lane and generic, and a sync MPC
  run: within tests/test_torch_solver.py's 1e-6 on cost reduction and
  tests/test_torch_mpc.py's 1e-6 on states and costs; the generic solve's
  filtering and auto-adjust likewise, and the lane path refuses both;
- the CLI runs acrobot with its own method, velocity_change.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.keypoints import interpolate as jinterp
from trajoptkp_tpu.keypoints import methods as jm
from trajoptkp_tpu.mpc import sync as jsync
from trajoptkp_tpu.solver import ilqr as jilqr
from trajoptkp_tpu.solver.lanes import make_lane_batch_optimise
from trajoptkp_tpu.tasks.toys import make_acrobot as jax_acrobot
from trajoptkp_tpu_torch.kernels import ops
from trajoptkp_tpu_torch.mpc import sync as psync
from trajoptkp_tpu_torch.solver import ilqr as pilqr
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.tasks.pushing import make_pushing
from trajoptkp_tpu_torch.tasks.reaching import make_reaching
from trajoptkp_tpu_torch.tasks.toys import make_acrobot

jax.config.update("jax_enable_x64", True)

H, B = 60, 3
JAC_ATOL = 1e-12        # acrobot, exact on both sides
SOLVE_TOL = 1e-6        # tests/test_torch_solver.py


def _tasks(name, min_N, max_N, **extra):
    kw = dict(name=name, min_N=min_N, max_N=max_N, **extra)
    jt = jax_acrobot(dtype=jnp.float64)
    pt = make_acrobot(device="cpu")
    return (jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(**kw)),
            pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(**kw)))


def _nominal(pt, seed=0, Hh=H, nl=B):
    rng = np.random.default_rng(seed)
    nq, nu = pt.model.nq, pt.model.nu
    qp = pt.qpos_start.numpy()[:, None] + 0.3 * rng.standard_normal((nq, nl))
    U = 0.5 * rng.standard_normal((Hh, nu, nl))
    tg = pt.residual_targets[:, None].expand(-1, nl)
    qpos, qvel, _ = pilqr.rollout(pt, torch.from_numpy(qp),
                                  torch.zeros((pt.model.nv, nl),
                                              dtype=torch.float64),
                                  torch.from_numpy(U), tg)
    return qpos, qvel, torch.from_numpy(U)


def _jax_mask(jt, qvel, Hh):
    """The JAX lane selector, jitted with the model closed over as in the
    JAX jacobians phase, on the velocities of the state vector's dofs."""
    order = jnp.asarray([int(i) for i in jt.sv.order])
    return np.asarray(jax.jit(lambda v: jm.generate_keypoints_lanes(
        jt.keypoint_cfg, v[:Hh][:, order, :], jt.model.timestep))(
            jnp.asarray(qvel.numpy())))


@pytest.mark.parametrize("name,min_N,max_N,budget", [
    ("adaptive_jerk", 1, 10, None), ("adaptive_accel", 2, 15, None),
    ("velocity_change", 1, 100, None), ("adaptive_jerk", 1, 10, 24)])
def test_lane_jacobians_match_jax_acrobot(name, min_N, max_N, budget):
    jt, pt = _tasks(name, min_N, max_N)
    qpos, qvel, U = _nominal(pt)
    cfg = pilqr.ILQRConfig(lane_kp_budget=budget)
    ph = planes.lane_phases(pt, cfg, H)
    A, Bm, pct, ovf = ph["jacobians"](qpos, qvel, U)
    jph = make_lane_batch_optimise(
        jt, jilqr.ILQRConfig(max_iterations=1, min_iterations=1,
                             lane_kp_budget=budget), H).phases
    jA, jB, jpct, jovf = jax.jit(jph["jacobians"])(
        jnp.asarray(qpos.numpy()), jnp.asarray(qvel.numpy()),
        jnp.asarray(U.numpy()))
    np.testing.assert_array_equal(pct.numpy(), np.asarray(jpct))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    assert (int(ovf.min()) > 0) == (budget is not None)
    mask = _jax_mask(jt, qvel, H)
    if budget is None:
        np.testing.assert_array_equal(ph["keypoints"]["mask"].numpy(), mask)
    else:
        # the capped mask is the method's mask without the dropped times
        got = ph["keypoints"]["mask"].numpy()
        assert not (got & ~mask).any()
        np.testing.assert_array_equal(got[:H - 1].any(1).sum(0),
                                      [budget - 1] * B)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=0,
                               atol=JAC_ATOL)
    np.testing.assert_allclose(Bm.numpy(), np.asarray(jB), rtol=0,
                               atol=JAC_ATOL)


@functools.lru_cache(maxsize=None)
def _arm(task_name):
    """(port task, nominal qpos, qvel, U) of reaching (velocity_change, its
    own method) or push_ncl (adaptive_jerk, its own) at H 16, two lanes."""
    Hh, nl = 16, 2
    rng = np.random.default_rng(7)
    if task_name == "reaching":
        pt = make_reaching(device="cpu")
        U = 5.0 * rng.standard_normal((Hh, 7, nl))
    else:
        pt = make_pushing(device="cpu")
        U = 2.0 * rng.standard_normal((Hh, 7, nl))
    pt = pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(min_N=2, max_N=8))
    m = pt.model
    qp = pt.qpos_start[:, None].expand(-1, nl).clone()
    qv = torch.from_numpy(0.3 * rng.standard_normal((m.nv, nl)))
    tg = pt.residual_targets[:, None].expand(-1, nl)
    qpos, qvel, _ = pilqr.rollout(pt, qp, qv, torch.from_numpy(U), tg)
    return pt, qpos, qvel, torch.from_numpy(U)


@pytest.mark.parametrize("task_name", ["reaching", "push_ncl"])
def test_lane_jacobians_reaching_and_push_ncl(task_name):
    pt, qpos, qvel, U = _arm(task_name)
    if task_name == "reaching":
        from trajoptkp_tpu.tasks.reaching import make_reaching as jmake
        jt = jmake(dtype=jnp.float64)
    else:
        from trajoptkp_tpu.tasks.pushing import make_pushing as jmake
        jt = jmake(0)
    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(min_N=2, max_N=8))
    Hh, nl = U.shape[0], U.shape[-1]
    n, nu = pt.sv.ndof, pt.model.nu
    cfg = pilqr.ILQRConfig()
    ph = planes.lane_phases(pt, cfg, Hh)
    A, Bm, pct, ovf = ph["jacobians"](qpos, qvel, U)
    mask = ph["keypoints"]["mask"]
    np.testing.assert_array_equal(mask.numpy(), _jax_mask(jt, qvel, Hh))
    assert int(ovf.max()) == 0
    np.testing.assert_allclose(
        pct.numpy(), 100.0 * mask.numpy().sum((0, 1)) / (Hh * n),
        rtol=1e-15)
    assert 0.0 < float(pct.min()) and float(pct.max()) < 100.0
    union = mask.any(1)
    for b in range(nl):
        times = torch.nonzero(union[:, b]).flatten()
        cols = ops.ad_jacobian(pt, qpos[..., b:b + 1], qvel[..., b:b + 1],
                               U[..., b:b + 1], times)[..., 0]
        full = np.zeros((Hh, 2 * n, 2 * n + nu))
        full[times.numpy()] = cols.numpy()
        jA, jB = jinterp.interpolate_derivatives(
            jnp.asarray(full[:, :, :2 * n]), jnp.asarray(full[:, :, 2 * n:]),
            jnp.asarray(mask[..., b].numpy()), nu)
        np.testing.assert_allclose(A[..., b].numpy(), np.asarray(jA),
                                   rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(Bm[..., b].numpy(), np.asarray(jB),
                                   rtol=1e-14, atol=1e-14)
    # a forced budget: the latest middle times go, the overflow counts them
    tight = planes.lane_phases(pt, pilqr.ILQRConfig(lane_kp_budget=4), Hh)
    _, _, _, ovf4 = tight["jacobians"](qpos, qvel, U)
    np.testing.assert_array_equal(ovf4.numpy(), (union.sum(0) - 4).numpy())


def _scenes(pt, seed, nl):
    rng = np.random.default_rng(seed)
    qp = pt.qpos_start.numpy()[None, :] + 0.3 * rng.standard_normal((nl, 2))
    return qp, np.zeros((nl, 2)), np.zeros((nl, 40, 1))


def test_vc_solve_lane_and_generic_match_jax():
    """acrobot velocity_change, H 40, 4 iterations: the port's lane solve
    against JAX `make_lane_phase_optimise` per scene, and the port's generic
    `optimise` against JAX `optimise` (cost history, %derivs, iterations)."""
    from trajoptkp_tpu.solver.lanes import make_lane_phase_optimise as jlane
    jt, pt = _tasks("velocity_change", 1, 100)
    qp, qv, U = _scenes(pt, 0, 3)
    cfg = pilqr.ILQRConfig(max_iterations=4, min_iterations=4)
    res = planes.make_lane_phase_optimise(pt, cfg, 40)(
        torch.from_numpy(qp), torch.from_numpy(qv), torch.from_numpy(U),
        pt.residual_targets[None, :].expand(3, -1))
    jcfg = jilqr.ILQRConfig(max_iterations=4, min_iterations=4)
    jres = jlane(jt, jcfg, 40)(jnp.asarray(qp), jnp.asarray(qv),
                               jnp.asarray(U),
                               jnp.tile(jt.residual_targets, (3, 1)))
    np.testing.assert_allclose(res.cost_reduction.numpy(),
                               np.asarray(jres.cost_reduction), rtol=0,
                               atol=SOLVE_TOL)
    np.testing.assert_allclose(res.pct_derivs.numpy(),
                               np.asarray(jres.pct_derivs), rtol=1e-14)
    np.testing.assert_array_equal(res.kp_overflow.numpy(),
                                  np.asarray(jres.kp_overflow))
    assert float(res.pct_derivs.max()) < 100.0
    traj, stats = pilqr.optimise(pt, torch.from_numpy(qp[1]),
                                 torch.from_numpy(qv[1]),
                                 torch.from_numpy(U[1]), cfg)
    jtraj, jstats = jilqr.optimise(jt, jnp.asarray(qp[1]), jnp.asarray(qv[1]),
                                   jnp.asarray(U[1]), jcfg)
    assert stats.num_iterations == jstats.num_iterations
    assert abs(stats.cost_reduction - jstats.cost_reduction) < SOLVE_TOL
    np.testing.assert_allclose(stats.cost_history, jstats.cost_history,
                               rtol=SOLVE_TOL)
    np.testing.assert_allclose(stats.percent_derivs, jstats.percent_derivs,
                               rtol=1e-12)


@pytest.mark.parametrize("filtering,auto_adjust", [
    ("low_pass", False), ("FIR", True)])
def test_generic_filtering_and_auto_adjust_match_jax(filtering, auto_adjust):
    """acrobot adaptive_jerk, H 40: the generic solve filters A's velocity
    rows and, with auto-adjust, takes the surprise-driven mask on the next
    iteration, as JAX `optimise` does; the lane path refuses both."""
    jt, pt = _tasks("adaptive_jerk", 1, 10, auto_adjust=auto_adjust)
    qp, qv, U = _scenes(pt, 2, 1)
    cfg = pilqr.ILQRConfig(max_iterations=4, min_iterations=4,
                           filtering=filtering)
    traj, stats = pilqr.optimise(pt, torch.from_numpy(qp[0]),
                                 torch.from_numpy(qv[0]),
                                 torch.from_numpy(U[0]), cfg)
    jtraj, jstats = jilqr.optimise(
        jt, jnp.asarray(qp[0]), jnp.asarray(qv[0]), jnp.asarray(U[0]),
        jilqr.ILQRConfig(max_iterations=4, min_iterations=4,
                         filtering=filtering))
    assert stats.num_iterations == jstats.num_iterations
    np.testing.assert_allclose(stats.cost_history, jstats.cost_history,
                               rtol=SOLVE_TOL)
    np.testing.assert_allclose(stats.percent_derivs, jstats.percent_derivs,
                               rtol=1e-12)
    if auto_adjust:
        # the adjusted masks moved the solve off the method's own
        _, own = pilqr.optimise(
            pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(
                auto_adjust=False)), torch.from_numpy(qp[0]),
            torch.from_numpy(qv[0]), torch.from_numpy(U[0]), cfg)
        assert own.cost_history[1:] != stats.cost_history[1:]
    with pytest.raises(NotImplementedError, match="neither filtering"):
        planes.make_lane_phase_optimise(pt, cfg, 40)


def test_vc_sync_mpc_matches_jax_lane_mpc():
    """acrobot velocity_change, H 40, 6 replans of one iteration, two
    controls applied each, noise off: the port's lane replan (K9a, K5 at
    per-lane slots, K9b twins) against JAX `make_lane_sync_mpc`."""
    jt, pt = _tasks("velocity_change", 1, 100)
    n_rep, na = 6, 2
    jcfg = jilqr.ILQRConfig(max_iterations=1, min_iterations=1)
    lane = jsync.make_lane_sync_mpc(jt, jcfg, 40, num_apply=na, noise_pct=0.0)
    res_j = jax.jit(lambda qp, qv, U, tg, k: lane(qp, qv, U, tg, n_rep, k))(
        jt.qpos_start[None], jt.qvel_start[None],
        jnp.zeros((1, 40, 1), jnp.float64), jt.residual_targets[None],
        jax.random.PRNGKey(3))
    run = psync.make_lane_sync_mpc(pt, pilqr.ILQRConfig(), 40, na, 0.0)
    res = run(pt.qpos_start[None], pt.qvel_start[None],
              torch.zeros((1, 40, 1), dtype=torch.float64),
              pt.residual_targets[None], n_rep,
              torch.zeros((n_rep, na, 1, 1), dtype=torch.float64))
    np.testing.assert_allclose(res.qpos_hist.numpy(),
                               np.asarray(res_j.qpos_hist), atol=1e-6)
    np.testing.assert_allclose(res.replan_costs.numpy(),
                               np.asarray(res_j.replan_costs), rtol=1e-6)
    np.testing.assert_allclose(res.cost_hist.numpy(),
                               np.asarray(res_j.cost_hist), rtol=1e-6)


def test_cli_runs_acrobot_with_its_own_method(capsys):
    from trajoptkp_tpu_torch import app

    app.main(["--device", "cpu", "--horizon", "30", "--maxIter", "2",
              "--minIter", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["keypoint_method"] == "velocity_change"
    assert 0.0 < out["mean_pct_derivs"] < 100.0
    assert out["final_cost"] < out["initial_cost"]
    for name in ("AJ_1_50", "AA_2_20"):
        app.main(["--device", "cpu", "--keypoint", name, "--horizon", "30",
                  "--maxIter", "1", "--minIter", "1"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["keypoint_method"] == app.KEYPOINT_KINDS[name[:2]]
