"""The port's batched solver and its one-scene `optimise` (plain path)
against the JAX generic `optimise`, scene by scene, on acrobot SI_2.

Tolerance: cost reduction within 1e-6.  Both sides take FD Jacobians whose
noise (~1e-9) the solve amplifies; at H = 40 and 4 iterations that stays
far below 1e-6 (see tests/test_torch_golden.py for a longer solve).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trajoptkp_tpu.solver import ilqr as jilqr
from trajoptkp_tpu.tasks.toys import make_acrobot as jax_acrobot
from trajoptkp_tpu_torch.solver import ilqr as pilqr
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.solver.lanes import make_lane_phase_optimise
from trajoptkp_tpu_torch.tasks.toys import make_acrobot

jax.config.update("jax_enable_x64", True)

H, NLANE = 40, 3
F64 = dict(dtype=torch.float64)


def _tasks(min_N=2):
    jt = jax_acrobot()
    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(
        name="set_interval", min_N=min_N))
    pt = make_acrobot(device="cpu")
    pt = pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(
        name="set_interval", min_N=min_N))
    return jt, pt


def _scenes(pt):
    rng = np.random.default_rng(0)
    qp = pt.qpos_start.numpy()[None, :] + 0.3 * rng.standard_normal((NLANE, 2))
    return qp, np.zeros((NLANE, 2)), np.zeros((NLANE, H, 1))


def test_batched_solver_matches_jax_per_scene():
    """No lane needs a λ retry here (acrobot's l_uu = 2 w_u > 0), so the
    JAX lane solver's coupled retry (ROADMAP Queue 3) cannot show."""
    jt, pt = _tasks()
    qp, qv, U = _scenes(pt)
    cfg = pilqr.ILQRConfig(max_iterations=4, min_iterations=4)
    tg0 = pt.residual_targets[:, None].expand(-1, NLANE)
    qpos, qvel, _ = pilqr.rollout(pt, torch.from_numpy(qp.T.copy()),
                                  torch.from_numpy(qv.T.copy()),
                                  torch.from_numpy(U.transpose(1, 2, 0).copy()),
                                  tg0)
    Ut = torch.from_numpy(U.transpose(1, 2, 0).copy())
    A, Bm = planes.jacobians_si(pt, planes.si_plan(pt, H), qpos, qvel, Ut,
                                planes.slot_jacobians(pt, "fd",
                                                      eps=cfg.fd_eps))
    l = planes.cost_expansion(pt, qpos, qvel, Ut, tg0)
    assert bool(pilqr.backward_pass(A, Bm, *l, torch.full((NLANE,), 0.1,
                                                          **F64))[3].all())
    run = make_lane_phase_optimise(pt, cfg, H)
    tg = pt.residual_targets[None, :].expand(NLANE, -1)
    res = run(torch.from_numpy(qp), torch.from_numpy(qv), torch.from_numpy(U),
              tg)
    jcfg = jilqr.ILQRConfig(max_iterations=4, min_iterations=4)
    phase_fns = jilqr.make_phase_fns(jt, jcfg, H)
    red = res.cost_reduction.numpy()
    for b in range(NLANE):
        traj, stats = jilqr.optimise(jt, jnp.asarray(qp[b]), jnp.asarray(qv[b]),
                                     jnp.asarray(U[b]), jcfg,
                                     phase_fns=phase_fns)
        assert abs(red[b] - stats.cost_reduction) < 1e-6, (b, red[b],
                                                          stats.cost_reduction)
        assert int(res.num_iterations[b]) == stats.num_iterations
        np.testing.assert_allclose(res.ctrl[b].numpy(), np.asarray(traj.ctrl),
                                   atol=1e-5)


def test_optimise_follows_generic_stopping_rule():
    """min < max: the generic rule stops at `converged and it >= min`,
    one iteration later than the lane rule would; the port's one-scene
    optimise takes the generic rule and matches JAX's iteration count."""
    jt, pt = _tasks(min_N=4)
    qp, qv, U = _scenes(pt)
    cfg = pilqr.ILQRConfig(max_iterations=12, min_iterations=2)
    traj, stats = pilqr.optimise(pt, torch.from_numpy(qp[1]),
                                 torch.from_numpy(qv[1]),
                                 torch.from_numpy(U[1]), cfg)
    jtraj, jstats = jilqr.optimise(
        jt, jnp.asarray(qp[1]), jnp.asarray(qv[1]), jnp.asarray(U[1]),
        jilqr.ILQRConfig(max_iterations=12, min_iterations=2))
    assert stats.num_iterations == jstats.num_iterations
    assert stats.num_iterations < 12  # the convergence exit was taken
    assert abs(stats.cost_reduction - jstats.cost_reduction) < 1e-6
    np.testing.assert_allclose(stats.cost_history, jstats.cost_history,
                               rtol=1e-6)
    lane = make_lane_phase_optimise(pt, cfg, H)(
        torch.from_numpy(qp[1:2]), torch.from_numpy(qv[1:2]),
        torch.from_numpy(U[1:2]), pt.residual_targets[None, :])
    assert int(lane.num_iterations[0]) == stats.num_iterations - 1
