"""The adaptive keypoints' slot budget at push_lcl (`make_pushing(3)`: 19
state dofs, the campaign method adaptive_jerk) against the JAX package,
float64 on the CPU, where the budget binds (`lane_kp_budget` 3 at H 8):
the times a lane keeps, the ones it drops (`kp_overflow`) and the share
of masked (time, dof) entries (`pct_derivs`).

- The port's slot plan (K9a's twin, `ops.keypoint_plan`) on the nominal of
  random controls from the task's scenes, against the JAX lane selector
  (`generate_keypoints_lanes`, jitted as the JAX jacobians phase runs it)
  and the JAX budget rule (`solver/lanes.py:jacobians_adaptive`, lines
  375-387: the latest middle times go first, the last time is kept):
  masks, kept slot times and overflow exactly, pct at 1e-14.
- `-m slow`: one iteration of the port's lane solve against JAX
  `make_lane_phase_optimise` on the same scenes and controls: kp_overflow
  exactly, pct_derivs at 1e-14.  Jitted, the JAX lane programs at
  push_lcl's width were still compiling after 20 minutes on a CPU, past
  20 GB of memory, so JAX runs them eagerly (`jax.disable_jit`), for
  minutes; hence slow.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.keypoints import methods as jm
from trajoptkp_tpu.solver import ilqr as jilqr
from trajoptkp_tpu.solver.lanes import make_lane_phase_optimise as jlane
from trajoptkp_tpu.tasks.pushing import make_pushing as jax_pushing
from trajoptkp_tpu_torch.kernels import ops
from trajoptkp_tpu_torch.solver import ilqr as pilqr
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.tasks import pushing

jax.config.update("jax_enable_x64", True)

H, NL, BUDGET = 8, 2, 3
METHOD = dict(name="adaptive_jerk", min_N=1, max_N=100)


@functools.lru_cache(maxsize=None)
def _case():
    """(JAX task, port task, qpos (NL, nq), qvel, targets, controls (NL, H,
    nu)): push_lcl's scenes (seed 0) under 0.5 N(0, 1) controls (seed 1),
    both tasks on adaptive_jerk."""
    jt = jax_pushing(3)
    pt = pushing.make_pushing(3, device="cpu")
    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(**METHOD))
    pt = pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(**METHOD))
    qp, qv, tg = pushing.push_scenes(pt, NL, seed=0)
    rng = np.random.default_rng(1)
    U = 0.5 * rng.standard_normal((NL, H, pt.model.nu))
    return jt, pt, np.asarray(qp), np.asarray(qv), np.asarray(tg), U


@functools.lru_cache(maxsize=None)
def _nominal():
    _, pt, qp, qv, tg, U = _case()
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return pilqr.rollout(pt, t(qp.T), t(qv.T), t(U.transpose(1, 2, 0)),
                         t(tg.T))[:2]


def _jax_budget(mask, K):
    """JAX `jacobians_adaptive`'s budget (solver/lanes.py:375-387) on the
    selector's mask (H, n, B) -> (capped mask, kept times per lane,
    overflow, pct)."""
    union = jnp.any(mask, axis=1)
    t_col = jnp.arange(H)[:, None]
    rank = jnp.cumsum(union, axis=0) - 1
    keep = union & ((rank < K - 1) | (t_col == H - 1))
    overflow = jnp.maximum(jnp.sum(union, axis=0) - K, 0)
    mask = (mask & keep[:, None, :]).at[0].set(True).at[H - 1].set(True)
    pct = 100.0 * jnp.sum(mask, axis=(0, 1)) / (H * mask.shape[1])
    kept = [np.flatnonzero(np.asarray(keep[:, b])) for b in range(NL)]
    return np.asarray(mask), kept, np.asarray(overflow), np.asarray(pct)


def test_clutter_slot_plan_under_budget_matches_jax():
    """push_lcl, adaptive_jerk at H 8 with a budget of 3 slots: every lane
    drops times, and the port keeps the JAX times, drops as many, and
    masks the same entries."""
    jt, pt, *_ = _case()
    qpos, qvel = _nominal()
    order = jnp.asarray([int(i) for i in jt.sv.order])
    jmask = jax.jit(lambda v: jm.generate_keypoints_lanes(
        jt.keypoint_cfg, v[:H][:, order, :], jt.model.timestep))(
            jnp.asarray(qvel.numpy()))
    want_mask, kept, overflow, pct = _jax_budget(jmask, BUDGET)
    assert (overflow > 0).all(), overflow
    cfg = pilqr.ILQRConfig(lane_kp_budget=BUDGET)
    plan = ops.keypoint_plan(ops.keypoint_plan_args(pt), qvel, H,
                             planes.kp_budget(cfg, pt, H))
    np.testing.assert_array_equal(plan.overflow.numpy(), overflow)
    np.testing.assert_array_equal(plan.mask.numpy(), want_mask)
    for b in range(NL):
        n = int(plan.count[b])
        np.testing.assert_array_equal(plan.slot_t[:n, b].numpy(), kept[b])
    np.testing.assert_allclose(plan.pct.numpy(), pct, rtol=1e-14, atol=0)


@pytest.mark.slow
def test_clutter_lane_solve_under_budget_matches_jax():
    """One iteration of the lane solve at the same scenes, controls and
    budget: the port's kp_overflow equals JAX `make_lane_phase_optimise`'s,
    its pct_derivs within 1e-14."""
    jt, pt, qp, qv, tg, U = _case()
    cfg = pilqr.ILQRConfig(max_iterations=1, min_iterations=1,
                           lane_kp_budget=BUDGET)
    res = planes.make_lane_phase_optimise(pt, cfg, H)(
        torch.from_numpy(qp), torch.from_numpy(qv), torch.from_numpy(U),
        torch.from_numpy(tg))
    jcfg = jilqr.ILQRConfig(max_iterations=1, min_iterations=1,
                            lane_kp_budget=BUDGET)
    with jax.disable_jit():
        jres = jlane(jt, jcfg, H)(jnp.asarray(qp), jnp.asarray(qv),
                                  jnp.asarray(U), jnp.asarray(tg))
    print("push_lcl budget", BUDGET, "kp_overflow port",
          res.kp_overflow.tolist(), "jax", np.asarray(jres.kp_overflow),
          "pct port", res.pct_derivs.tolist(), "jax",
          np.asarray(jres.pct_derivs))
    assert int(res.kp_overflow.min()) > 0
    np.testing.assert_array_equal(res.kp_overflow.numpy(),
                                  np.asarray(jres.kp_overflow))
    np.testing.assert_allclose(res.pct_derivs.numpy(),
                               np.asarray(jres.pct_derivs), rtol=1e-14,
                               atol=0)
