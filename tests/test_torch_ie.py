"""iterative_error keypoints on the port (solver/lanes.py:jacobians_ie, the
plain twins of K5ad's cache mode, K9c, K9a with time slots and K9b) against
the JAX package, float64 on the CPU, in the pattern of
tests/test_lane_ie.py.

- the lane jacobians phase against the JAX lane program (exact Jacobians)
  on the same trajectories: pct (the share of computed times) equal, A and
  B within 1e-12 (both exact; measured 8.5e-15 on entries up to 1.1), and
  each lane's keypoint set equal to JAX `iterative_error_keypoints` (the
  generic bisection, FD mode) on that lane;
- lanes are independent: a batch of three gives each lane's own result;
- the generic solve (`optimise`, the lane bisection at B = 1) against JAX
  `optimise`: cost history within 1e-6 relative (tests/test_torch_solver.py),
  %derivs (the per-dof share of the computed pairs) to 1e-12, iterations
  equal;
- the lane MPC replan refuses iterative_error, as JAX's does; the CLI runs
  IE_a_b.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.keypoints.iterative import iterative_error_keypoints
from trajoptkp_tpu.solver import ilqr as jilqr
from trajoptkp_tpu.solver.lanes import make_lane_batch_optimise
from trajoptkp_tpu.tasks.toys import make_acrobot as jax_acrobot
from trajoptkp_tpu_torch.mpc import sync as psync
from trajoptkp_tpu_torch.solver import ilqr as pilqr
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.tasks.toys import make_acrobot

jax.config.update("jax_enable_x64", True)

H, B = 32, 3
MIN_N, THR = 4, 1e-5


def _tasks(min_N=MIN_N, thr=THR):
    kw = dict(name="iterative_error", min_N=min_N, max_N=min_N,
              iterative_error_threshold=thr)
    jt = jax_acrobot(dtype=jnp.float64)
    pt = make_acrobot(device="cpu")
    return (jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(**kw)),
            pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(**kw)))


def _nominal(pt, seed=0):
    rng = np.random.default_rng(seed)
    qp = pt.qpos_start.numpy()[:, None] + 0.4 * rng.standard_normal((2, B))
    U = 0.5 * rng.standard_normal((H, 1, B))
    tg = pt.residual_targets[:, None].expand(-1, B)
    qpos, qvel, _ = pilqr.rollout(pt, torch.from_numpy(qp),
                                  torch.zeros((2, B), dtype=torch.float64),
                                  torch.from_numpy(U), tg)
    return qpos, qvel, torch.from_numpy(U)


def test_lane_ie_matches_jax_lane_and_generic_keypoints():
    jt, pt = _tasks()
    qpos, qvel, U = _nominal(pt)
    ph = planes.lane_phases(pt, pilqr.ILQRConfig(), H)
    A, Bm, pct, ovf = ph["jacobians"](qpos, qvel, U)
    pair = ph["keypoints"]["mask"]
    jph = make_lane_batch_optimise(
        jt, jilqr.ILQRConfig(max_iterations=1, min_iterations=1), H).phases
    jA, jB, jpct, jovf = jph["jacobians"](
        jnp.asarray(qpos.numpy()), jnp.asarray(qvel.numpy()),
        jnp.asarray(U.numpy()))
    np.testing.assert_array_equal(pct.numpy(), np.asarray(jpct))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Bm.numpy(), np.asarray(jB), rtol=0, atol=1e-12)
    for b in range(B):
        mask, *_ = iterative_error_keypoints(
            jt, jnp.asarray(qpos[:H, :, b].numpy()),
            jnp.asarray(qvel[:H, :, b].numpy()), jnp.asarray(U[:, :, b]),
            MIN_N, THR, mode="fd")
        np.testing.assert_array_equal(pair[..., b].numpy(), np.asarray(mask))
    assert 0.0 < float(pct.min()) and float(pct.max()) < 100.0


def test_lane_ie_lanes_are_independent():
    _, pt = _tasks()
    qpos, qvel, U = _nominal(pt, seed=3)
    ph = planes.lane_phases(pt, pilqr.ILQRConfig(), H)
    A, Bm, pct, _ = ph["jacobians"](qpos, qvel, U)
    for b in range(B):
        A1, B1, pct1, _ = ph["jacobians"](qpos[..., b:b + 1],
                                          qvel[..., b:b + 1],
                                          U[..., b:b + 1])
        assert torch.equal(A[..., b:b + 1], A1)
        assert torch.equal(Bm[..., b:b + 1], B1)
        assert torch.equal(pct[b:b + 1], pct1)


def test_generic_ie_solve_matches_jax():
    jt, pt = _tasks(min_N=4, thr=1e-4)
    rng = np.random.default_rng(5)
    qp = pt.qpos_start.numpy() + 0.3 * rng.standard_normal(2)
    cfg = pilqr.ILQRConfig(max_iterations=3, min_iterations=3)
    traj, stats = pilqr.optimise(pt, torch.from_numpy(qp),
                                 torch.zeros(2, dtype=torch.float64),
                                 torch.zeros((H, 1), dtype=torch.float64),
                                 cfg)
    jtraj, jstats = jilqr.optimise(
        jt, jnp.asarray(qp), jnp.zeros(2), jnp.zeros((H, 1)),
        jilqr.ILQRConfig(max_iterations=3, min_iterations=3))
    assert stats.num_iterations == jstats.num_iterations
    np.testing.assert_allclose(stats.cost_history, jstats.cost_history,
                               rtol=1e-6)
    np.testing.assert_allclose(stats.percent_derivs, jstats.percent_derivs,
                               rtol=1e-12)
    assert max(stats.percent_derivs) < 100.0


def test_ie_mpc_is_refused_and_the_cli_runs_ie(capsys):
    from trajoptkp_tpu_torch import app

    _, pt = _tasks()
    with pytest.raises(NotImplementedError, match="iterative_error"):
        psync.make_lane_sync_mpc(pt, pilqr.ILQRConfig(), 20, 1)
    app.main(["--device", "cpu", "--keypoint", "IE_2_50", "--horizon", "30",
              "--maxIter", "2", "--minIter", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["keypoint_method"] == "iterative_error"
    assert 0.0 < out["mean_pct_derivs"] <= 100.0
