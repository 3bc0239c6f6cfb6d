"""The solver with joint limits as a whole, at a small size: a limited
acrobot solved by the port (plain path) and by the JAX package.

The JAX solvers at panda width compile for many minutes on the CPU, so the
whole-solve parity runs on acrobot.xml with both joints limited, built in the
test and carried to the port as data; reaching itself is held phase by phase
in tests/test_torch_reaching.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trajoptkp_tpu.solver import ilqr as jilqr
from trajoptkp_tpu.tasks.toys import make_acrobot as jax_acrobot
from trajoptkp_tpu_torch.solver import ilqr as pilqr
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.tasks.toys import make_acrobot

jax.config.update("jax_enable_x64", True)


def _tasks(min_N=2):
    jt = jax_acrobot()
    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(
        name="set_interval", min_N=min_N))
    pt = make_acrobot(device="cpu")
    pt = pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(
        name="set_interval", min_N=min_N))
    return jt, pt


LH, LLANES = 60, 4


def _limited_acrobot(control_weight=None):
    """acrobot.xml with both joints limited (shoulder [-30, 40] deg, elbow
    [-125, 125] deg), built by the JAX package's MJCF loader and carried to
    the port as data; SI_2.  From the task's start both joints reach a limit
    within the first 20 steps under zero controls.  `control_weight`
    replaces the control residual's weight (0: l_uu = 0, as in reaching)."""
    import os

    from test_torch_model import _npz_fields as npz_fields
    from trajoptkp_tpu.dynamics.mjcf import load_mjcf_string
    from trajoptkp_tpu_torch.dynamics.model import model_from_numpy

    path = os.path.join(os.path.dirname(__file__), "..", "trajoptkp_tpu",
                        "models", "acrobot.xml")
    with open(path) as f:
        xml = f.read()
    xml = xml.replace('<joint name="shoulder"/>',
                      '<joint name="shoulder" limited="true" range="-30 40"/>')
    xml = xml.replace('<joint name="elbow"/>',
                      '<joint name="elbow" limited="true" range="-125 125"/>')
    jm = load_mjcf_string(xml)
    pm = model_from_numpy(npz_fields(jm), device="cpu")
    jt, pt = _tasks()
    jt, pt = jt.replace(model=jm), pt.replace(model=pm)
    if control_weight is not None:
        w = np.asarray(jt.weights).copy()
        wt = np.asarray(jt.weights_terminal).copy()
        w[4] = wt[4] = control_weight
        jt = jt.replace(weights=jnp.asarray(w), weights_terminal=jnp.asarray(wt))
        pt = pt.replace(weights=torch.from_numpy(w),
                        weights_terminal=torch.from_numpy(wt))
    return jt, pt


def _limited_scenes(pt, draw):
    """The draw-th set of LLANES scenes of numpy seed 0."""
    rng = np.random.default_rng(0)
    for _ in range(draw + 1):
        noise = rng.standard_normal((LLANES, 2))
    qp = pt.qpos_start.numpy()[None, :] + 0.1 * noise
    return qp, np.zeros((LLANES, 2)), np.zeros((LLANES, LH, 1))


def _solve_all_ways(jt, pt, draw=0):
    """Cost reductions and controls of the port (lanes B = 4, `optimise` per
    scene in fd mode and in ad mode) and of JAX (`optimise` in fd mode per
    scene, the lane solver per scene at B = 1 and coupled at B = 4), 3
    iterations each."""
    from trajoptkp_tpu.solver import lanes as jlanes
    from trajoptkp_tpu_torch.dynamics.contact import limits_active

    qp, qv, U = _limited_scenes(pt, draw)
    cfg = pilqr.ILQRConfig(max_iterations=3, min_iterations=3)
    jcfg = jilqr.ILQRConfig(max_iterations=3, min_iterations=3,
                            deriv_mode="fd")
    tq, tv, tU = map(torch.from_numpy, (qp, qv, U))
    tg0 = pt.residual_targets[:, None].expand(-1, LLANES)
    qpos, _, _ = pilqr.rollout(pt, tq.T.contiguous(), tv.T.contiguous(),
                               tU.permute(1, 2, 0).contiguous(), tg0)
    hit = limits_active(pt.model, qpos[:LH].transpose(0, 1)).any(0)
    assert bool(hit.all()), "every scene must reach a joint limit"
    lane = planes.solve_lanes(
        pt, cfg, tq.T.contiguous(), tv.T.contiguous(),
        tU.permute(1, 2, 0).contiguous(), tg0, rule="lane")
    out = {"lane": lane, "port": [], "port_ad": [], "jax": [],
           "jax_lane_1": []}
    cfg_ad = dataclasses.replace(cfg, deriv_mode="ad")
    phase_fns = jilqr.make_phase_fns(jt, jcfg, LH)
    jrun = jlanes.make_lane_phase_optimise(jt, jcfg, LH)
    for b in range(LLANES):
        out["port"].append(pilqr.optimise(pt, tq[b], tv[b], tU[b], cfg))
        out["port_ad"].append(
            pilqr.optimise(pt, tq[b], tv[b], tU[b], cfg_ad)[1].cost_reduction)
        out["jax"].append(jilqr.optimise(
            jt, jnp.asarray(qp[b]), jnp.asarray(qv[b]), jnp.asarray(U[b]),
            jcfg, phase_fns=phase_fns))
        r = jrun(jnp.asarray(qp[b:b + 1]), jnp.asarray(qv[b:b + 1]),
                 jnp.asarray(U[b:b + 1]), jt.residual_targets[None, :])
        out["jax_lane_1"].append(float(r.cost_reduction[0]))
    r = jrun(jnp.asarray(qp), jnp.asarray(qv), jnp.asarray(U),
             jnp.tile(jt.residual_targets, (LLANES, 1)))
    out["jax_lane_coupled"] = np.asarray(r.cost_reduction)
    return out


def test_limited_acrobot_solve_matches_jax():
    """Port `optimise` against JAX `optimise(deriv_mode="fd")`: controls to
    1e-5, costs to 1e-6 relative (measured 3e-8 and 5e-9); the port's batch
    of 4 (exact Jacobians, K5ad's twin, as the JAX lane solver's jacfwd with
    implicit tangents) against the JAX lane solver run one scene at a time,
    cost reduction to 1e-12 (measured 1.6e-14), and against the port's
    `optimise` in ad mode to 1e-12 (measured 4.4e-16)."""
    jt, pt = _limited_acrobot()
    out = _solve_all_ways(jt, pt)
    red = (1.0 - out["lane"].final_cost / out["lane"].initial_cost).numpy()
    for b in range(LLANES):
        (ptraj, pstats), (jtraj, jstats) = out["port"][b], out["jax"][b]
        np.testing.assert_allclose(ptraj.ctrl.numpy(), np.asarray(jtraj.ctrl),
                                   atol=1e-5)
        np.testing.assert_allclose(pstats.cost_history, jstats.cost_history,
                                   rtol=1e-6)
        assert pstats.num_iterations == jstats.num_iterations == 3
        assert abs(red[b] - out["jax_lane_1"][b]) < 1e-12
        assert abs(red[b] - out["port_ad"][b]) < 1e-12
    assert sum(out["lane"].log["retried"]) == 0


def test_limited_acrobot_solve_without_control_cost():
    """The l_uu = 0 case of reaching: Q_uu = B'V'B + λI.  What the run
    shows: no lane takes the λ retry on either side (V_xx stays positive
    semi-definite under the regularised gains, so Q_uu + λI factors at the
    first λ; the retry itself is held against JAX on crafted inputs in
    tests/test_torch_ilqr.py), so the coupled JAX batch equals its own
    B = 1 runs to 1e-9 here.  Without a control cost the solve amplifies the
    FD noise of the limit rows (tests/test_torch_derivs.py): the JAX generic
    solve (central FD) and the JAX lane solver (exact) differ by 4e-4 in the
    worst scene.  The port's lanes take exact Jacobians as the JAX lane
    solver does and land within 1e-8 of it (measured 2.0e-9), within 1e-3
    of the JAX generic solve (measured 4.2e-4), and equal the port's
    `optimise` in ad mode to 1e-9 (measured 4.4e-16).  The port's
    `optimise` at the default deriv_mode (central FD) lands within 1e-3 of
    the JAX generic solve in fd mode (measured 7.1e-4).  Saturated controls
    sit exactly at their bound, where the step's clip halves the tangent in
    both packages (utils/math.py:clip)."""
    jt, pt = _limited_acrobot(control_weight=0.0)
    out = _solve_all_ways(jt, pt, draw=1)
    red = (1.0 - out["lane"].final_cost / out["lane"].initial_cost).numpy()
    assert red.max() > 0.1                        # the solve does real work
    for b in range(LLANES):
        jstats = out["jax"][b][1]
        assert abs(red[b] - jstats.cost_reduction) < 1e-3
        assert abs(out["port"][b][1].cost_reduction
                   - jstats.cost_reduction) < 1e-3
        assert abs(red[b] - out["jax_lane_1"][b]) < 1e-8
        assert abs(out["port_ad"][b] - red[b]) < 1e-9
    np.testing.assert_allclose(out["jax_lane_coupled"], out["jax_lane_1"],
                               atol=1e-9)
    assert sum(out["lane"].log["retried"]) == 0
