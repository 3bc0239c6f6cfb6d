"""The port's keypoint methods (trajoptkp_tpu_torch/keypoints) against the
JAX package on the fixtures of tests/test_keypoints.py, float64 on the CPU.

Masks must be equal.  The JAX programs hold dt as a constant, which XLA
folds into a multiply by 1/dt; the port's jerk profile multiplies by 1/dt,
so the JAX side runs under `jit` with dt closed over, as its solvers do.
XLA's CPU code may still round the difference of two scaled accelerations
differently (a fused multiply-add), so the jerk profiles agree to a few
rounding steps of those terms, 8 eps max|a| / dt, where the difference
cancels; filters 1e-14.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.keypoints import filtering as jfilt
from trajoptkp_tpu.keypoints import interpolate as jinterp
from trajoptkp_tpu.keypoints import methods as jm
from trajoptkp_tpu_torch.keypoints import filtering as pfilt
from trajoptkp_tpu_torch.keypoints import interpolate as pinterp
from trajoptkp_tpu_torch.keypoints import methods as pm
from trajoptkp_tpu_torch.kernels import ops

jax.config.update("jax_enable_x64", True)

H, NDOF = 100, 3
DT = 0.01
THRESH = {"adaptive_jerk": [5.0, 50.0, 1.0],
          "adaptive_accel": [0.02, 0.2, 0.005],
          "velocity_change": [2.0, 10.0, 0.5]}


@pytest.fixture(scope="module")
def vel_traj():
    """tests/test_keypoints.py's smooth synthetic trajectory (H, 3)."""
    t = np.linspace(0, 2 * np.pi, H)[:, None]
    phases = np.array([0.0, 1.0, 2.5])[None, :]
    freqs = np.array([1.0, 2.0, 0.5])[None, :]
    return np.sin(freqs * t + phases) * np.array([1.0, 3.0, 0.3])


@pytest.fixture(scope="module")
def vel_lanes(vel_traj):
    """Four lanes: the fixture and three noisy copies (H, 3, 4)."""
    rng = np.random.default_rng(0)
    noisy = vel_traj[:, :, None] + 0.05 * rng.standard_normal((H, NDOF, 3))
    return np.concatenate([vel_traj[:, :, None], noisy], axis=2)


def _cfgs(name, min_N, max_N):
    thr = np.asarray(THRESH.get(name, [1.0] * NDOF))
    jc = jm.KeypointConfig(name=name, min_N=min_N, max_N=max_N,
                           jerk_thresholds=jnp.asarray(thr),
                           accel_thresholds=jnp.asarray(thr),
                           velocity_change_thresholds=jnp.asarray(thr))
    t = torch.from_numpy(thr)
    pc = pm.KeypointConfig(name=name, min_N=min_N, max_N=max_N,
                           jerk_thresholds=t, accel_thresholds=t,
                           velocity_change_thresholds=t)
    return jc, pc


def test_profiles_match_jax(vel_traj):
    v = jnp.asarray(vel_traj)
    dt = jnp.asarray(DT)
    jerk = jax.jit(lambda x: jm.jerk_profile(x, dt))(v)
    got = pm.jerk_profile(torch.from_numpy(vel_traj), 1.0 / DT)
    acc = np.abs(np.diff(vel_traj, axis=0)).max() / DT
    np.testing.assert_allclose(got.numpy(), np.asarray(jerk), rtol=0,
                               atol=8 * np.finfo(float).eps * acc / DT)
    np.testing.assert_array_equal(
        pm.accel_profile(torch.from_numpy(vel_traj)).numpy(),
        np.asarray(jm.accel_profile(v)))


@pytest.mark.parametrize("name,min_N,max_N", [
    ("set_interval", 5, 5), ("adaptive_jerk", 1, 10), ("adaptive_jerk", 3, 20),
    ("adaptive_accel", 2, 15), ("velocity_change", 1, 10),
    ("velocity_change", 2, 25)])
def test_selectors_match_jax(vel_traj, vel_lanes, name, min_N, max_N):
    """One trajectory (H, n) and lane-last (H, n, B): masks equal, and every
    selector keeps the first and last step."""
    jc, pc = _cfgs(name, min_N, max_N)
    dt = jnp.asarray(DT)
    want = jax.jit(lambda x: jm.generate_keypoints(jc, x, dt))(
        jnp.asarray(vel_traj))
    got = pm.generate_keypoints(pc, torch.from_numpy(vel_traj), 1.0 / DT)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(got[0].all() and got[-1].all())
    want_l = jax.jit(lambda x: jm.generate_keypoints_lanes(jc, x, dt))(
        jnp.asarray(vel_lanes))
    got_l = pm.generate_keypoints(pc, torch.from_numpy(vel_lanes), 1.0 / DT)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_order_of_importance_matches_jax(vel_traj):
    dt = jnp.asarray(DT)
    for num in ([2, 10, 50], [5, 97, 3], [40, 40, 40]):
        want = jax.jit(lambda x, k: jm.order_of_importance(x, dt, k))(
            jnp.asarray(vel_traj), jnp.asarray(num))
        got = pm.order_of_importance(torch.from_numpy(vel_traj), 1.0 / DT,
                                     torch.tensor(num))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.sum(0).numpy(), num)


@pytest.mark.parametrize("expected,actual", [
    (1.0, 0.5), (2.0, 0.05), (0.3, -0.1), (0.5, 0.0), (1.5, 4.0)])
def test_auto_adjust_mask_matches_jax(vel_traj, expected, actual):
    """The surprise controller's branches (cost reduced a little, much, not
    at all) and the placement, with unequal importances."""
    dt = jnp.asarray(DT)
    last = np.array([30.0, 12.5, 80.0])
    imp = np.array([1.0, 0.5, 0.0])
    want_pct = jm.desired_percentages(jnp.asarray(expected),
                                      jnp.asarray(actual), jnp.asarray(last),
                                      jnp.asarray(imp))
    got_pct = pm.desired_percentages(expected, actual, torch.from_numpy(last),
                                     torch.from_numpy(imp))
    np.testing.assert_allclose(got_pct.numpy(), np.asarray(want_pct),
                               rtol=1e-14)
    want = jax.jit(lambda x, e, a: jm.auto_adjust_mask(
        x, dt, e, a, jnp.asarray(last), jnp.asarray(imp), 10))(
            jnp.asarray(vel_traj), jnp.asarray(expected), jnp.asarray(actual))
    got = pm.auto_adjust_mask(torch.from_numpy(vel_traj), 1.0 / DT, expected,
                              actual, torch.from_numpy(last),
                              torch.from_numpy(imp), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["low_pass", "FIR", "none"])
def test_filter_dynamics_matches_jax(method):
    """One trajectory's A (H, 2n, 2n) and lane-last (H, 2n, 2n, B): the
    velocity rows filtered along time, the position rows untouched."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((40, 6, 6, 2))
    want = np.stack([np.asarray(jfilt.filter_dynamics(jnp.asarray(A[..., b]),
                                                      method))
                     for b in range(2)], axis=-1)
    got = pfilt.filter_dynamics(torch.from_numpy(A), method).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(got[:, :3], A[:, :3])
    one = pfilt.filter_dynamics(torch.from_numpy(A[..., 0]), method).numpy()
    np.testing.assert_array_equal(one, got[..., 0])
    with pytest.raises(ValueError, match="unknown filtering"):
        pfilt.filter_dynamics(torch.from_numpy(A), "median")


def test_lane_column_lerp_matches_per_dof_interpolation(vel_lanes):
    """K9b's twin (lerp_columns over the lane plan's slots) equals the JAX
    per-dof `interpolate_derivatives` on each lane's keypoint columns."""
    jc, pc = _cfgs("velocity_change", 1, 10)
    nu = 2
    mask = pm.generate_keypoints(pc, torch.from_numpy(vel_lanes), 1.0 / DT)
    plan = pm.lane_plan(mask, H)
    K, B, n = H, vel_lanes.shape[-1], NDOF
    rng = np.random.default_rng(5)
    J = rng.standard_normal((K, 2 * n, 2 * n + nu, B))
    col = torch.tensor(pinterp.column_dofs(n, nu))
    A, Bm = pinterp.lerp_columns(torch.from_numpy(J), plan.pslot, plan.nslot,
                                 plan.w, col, 2 * n)
    for b in range(B):
        # slot k holds time slot_t[k]: spread the slots over the horizon
        full = np.zeros((H, 2 * n, 2 * n + nu))
        cnt = int(plan.count[b])
        full[plan.slot_t[:cnt, b].numpy()] = J[:cnt, :, :, b]
        jA, jB = jinterp.interpolate_derivatives(
            jnp.asarray(full[:, :, :2 * n]), jnp.asarray(full[:, :, 2 * n:]),
            jnp.asarray(plan.mask[..., b].numpy()), nu)
        np.testing.assert_allclose(A[..., b].numpy(), np.asarray(jA),
                                   rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(Bm[..., b].numpy(), np.asarray(jB),
                                   rtol=1e-14, atol=1e-15)


def test_lane_plan_budget_drops_the_latest_middle_times(vel_lanes):
    """A slot budget below the union: the overflow counts the dropped times,
    t = 0 and H-1 keep their slots, the kept times are the earliest, the
    padding slots follow in time order, and the plan from K9a's twin is
    the plan of the method's mask."""
    jc, pc = _cfgs("adaptive_jerk", 1, 10)
    mask = pm.generate_keypoints(pc, torch.from_numpy(vel_lanes), 1.0 / DT)
    union = mask.any(1)
    K_max = 12
    plan = pm.lane_plan(mask, K_max)
    n_union = union.sum(0)
    assert bool((n_union > K_max).all())
    np.testing.assert_array_equal(plan.overflow.numpy(),
                                  (n_union - K_max).numpy())
    np.testing.assert_array_equal(plan.count.numpy(), [K_max] * 4)
    for b in range(4):
        times = torch.nonzero(union[:, b]).flatten()
        kept = torch.cat([times[:K_max - 1], times[-1:]])
        np.testing.assert_array_equal(plan.slot_t[:, b].numpy(),
                                      kept.numpy())
        assert bool(plan.mask[0, :, b].all() and plan.mask[-1, :, b].all())
        assert not bool(plan.mask[kept[-2] + 1:H - 1, :, b].any())
    pa = ops.KeypointPlanArgs("adaptive_jerk", torch.arange(NDOF,
                                                            dtype=torch.int32),
                              pc.jerk_thresholds, 1, 10, 1.0 / DT)
    qvel = torch.cat([torch.from_numpy(vel_lanes),
                      torch.from_numpy(vel_lanes[-1:])])
    via = ops.keypoint_plan(pa, qvel, H, K_max)
    for a, b in zip(via, plan):
        assert torch.equal(a, b)
