"""A whole lane solve with contacts, a free joint, limits, a reduced state
vector and an FK residual, at a size the JAX solvers compile for in tier-1
time: a cylinder pusher on a chain of x, y and z slides (x and z limited) and
a free goal cylinder on a plane, built in the test with the JAX package's
MJCF loader and carried to the port as data.  Its three contact pairs are
the push_ncl kinds: plane-cylinder twice (table-pusher, table-goal) and
cylinder-cylinder (pusher-goal).  State vector: the three slides and the
goal's translations (ndof 6 of nv 9, nq 10).  Residual: goal xy to the
target, goal planar speed and end-effector site to goal (read from forward
kinematics, as push_ncl's), plus the three controls.

The port's lane solver over 4 scenes (plain path), one iteration, SI_2, is
held against the JAX lane solver run one scene at a time and against the
JAX generic solver with FD derivatives: initial costs (the rollouts) to
1e-7 relative; cost reduction within 2e-6 of the JAX lane solver
(measured 4.1e-7; both take exact Jacobians with the implicit tangents of
the contact solve, and their steps differ by ~1e-9) and within 1e-3 of the
generic solver (measured 5.1e-4): it differentiates by central FD through
8-iteration contact solves, and a 1e-6 perturbation that crosses a contact
gate turns the step difference into FD columns 3.3e-3 apart (B up to 4% of
its largest entry).  After three iterations the solvers part further (the
JAX package's own two solvers end up to 0.1 apart here; ROADMAP Queue 3),
so three iterations are only held to keep reducing the cost.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trajoptkp_tpu.dynamics.mjcf import load_mjcf_string
from trajoptkp_tpu.solver import ilqr as jilqr
from trajoptkp_tpu.solver import lanes as jlanes
from trajoptkp_tpu.state.statevector import \
    state_vector_from_names as jax_sv_from_names
from trajoptkp_tpu.tasks.pushing import make_pushing as jax_pushing
from trajoptkp_tpu_torch.dynamics.contact import contacts_active
from trajoptkp_tpu_torch.dynamics.fk import body_frames, site_pose
from trajoptkp_tpu_torch.dynamics.model import model_from_numpy
from trajoptkp_tpu_torch.solver import ilqr as pilqr
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.state.statevector import state_vector_from_names
from trajoptkp_tpu_torch.tasks.pushing import make_pushing

jax.config.update("jax_enable_x64", True)

XML = """
<mujoco model="slide_push">
  <option timestep="0.01" gravity="0 0 -9.81"/>
  <compiler angle="radian"/>
  <default>
    <joint damping="1" armature="0.01"/>
    <geom contype="1" conaffinity="1" density="1000"/>
  </default>
  <worldbody>
    <geom name="table" type="plane" size="2 2 0.1"
          friction="0.5 0.005 0.0001"/>
    <body name="carriage_x" pos="0 0 0.06">
      <joint name="px" type="slide" axis="1 0 0" limited="true"
             range="-0.2 0.3"/>
      <inertial pos="0 0 0" mass="0.05" diaginertia="1e-4 1e-4 1e-4"/>
      <body name="carriage_y">
        <joint name="py" type="slide" axis="0 1 0"/>
        <inertial pos="0 0 0" mass="0.05" diaginertia="1e-4 1e-4 1e-4"/>
        <body name="pusher">
          <joint name="pz" type="slide" axis="0 0 1" limited="true"
                 range="-0.05 0.05"/>
          <geom name="pusher" type="cylinder" size="0.01 0.05" mass="0.2"/>
          <site name="ee" pos="0 0 0" size="0.01"/>
        </body>
      </body>
    </body>
    <body name="goal" pos="0.1 0 0.032">
      <freejoint name="goal"/>
      <geom name="goal" type="cylinder" size="0.05 0.03" mass="0.1"/>
    </body>
  </worldbody>
  <actuator>
    <motor joint="px" gear="1" ctrllimited="true" ctrlrange="-5 5"/>
    <motor joint="py" gear="1" ctrllimited="true" ctrlrange="-5 5"/>
    <motor joint="pz" gear="1" ctrllimited="true" ctrlrange="-5 5"/>
  </actuator>
</mujoco>
"""
SV_NAMES = ("px", "py", "pz", "goal_lin_x", "goal_lin_y", "goal_lin_z")
RES_NAMES = ("goal_pos", "goal_vel", "reach", "u_x", "u_y", "u_z")
TARGET = (0.25, 0.05)
W = (0.0, 0.1, 0.5, 0.01, 0.01, 0.01)
W_TERM = (500.0, 5.0, 0.5, 0.01, 0.01, 0.01)
H, LANES, ITERS = 40, 4, 3


def _norm(parts):
    s = parts[0] * parts[0]
    for p in parts[1:]:
        s = s + p * p
    return s


def _tasks():
    from test_torch_model import _npz_fields as npz_fields

    jm = load_mjcf_string(XML)
    pm = model_from_numpy(npz_fields(jm), device="cpu")
    gb, site = jm.body_names.index("goal"), jm.site_names.index("ee")
    gd = jm.jnt_dofadr[jm.joint_names.index("goal")]

    def jax_res(model, data, targets):
        goal, ee = data.xpos[gb], data.site_xpos[site]
        return jnp.stack([
            jnp.sqrt(_norm([goal[0] - targets[0], goal[1] - targets[1]])
                     + 1e-12),
            jnp.sqrt(_norm([data.qvel[gd], data.qvel[gd + 1]]) + 1e-12),
            jnp.sqrt(_norm([ee[k] - goal[k] for k in range(3)]) + 1e-12),
            data.ctrl[0], data.ctrl[1], data.ctrl[2]])

    def port_res(qpos, qvel, ctrl, targets):
        xpos, xquat, _ = body_frames(pm, qpos)
        goal = xpos[gb]
        ee, _ = site_pose(pm, xpos, xquat, site)
        return torch.stack([
            torch.sqrt(_norm([goal[0] - targets[0], goal[1] - targets[1]])
                       + 1e-12),
            torch.sqrt(_norm([qvel[gd], qvel[gd + 1]]) + 1e-12),
            torch.sqrt(_norm([ee[k] - goal[k] for k in range(3)]) + 1e-12),
            ctrl[0], ctrl[1], ctrl[2]])

    jt = jax_pushing(0)
    jt = jt.replace(
        name="slide_push", model=jm, residual_fn=jax_res,
        residual_names=RES_NAMES,
        sv=jax_sv_from_names(jm, SV_NAMES),
        residual_targets=jnp.asarray(TARGET), weights=jnp.asarray(W),
        weights_terminal=jnp.asarray(W_TERM),
        qpos_start=jnp.asarray(jm.qpos0), qvel_start=jnp.zeros(jm.nv),
        keypoint_cfg=jt.keypoint_cfg.replace(name="set_interval", min_N=2),
        init_controls_fn=None, setup_controls_fn=None)
    pt = make_pushing(device="cpu")
    f64 = dict(dtype=torch.float64)
    pt = pt.replace(
        name="slide_push", model=pm, residual_fn=port_res,
        residual_kind=("slide_push",), residual_names=RES_NAMES,
        sv=state_vector_from_names(pm, SV_NAMES),
        residual_targets=torch.tensor(TARGET, **f64),
        weights=torch.tensor(W, **f64),
        weights_terminal=torch.tensor(W_TERM, **f64),
        qpos_start=pm.qpos0.clone(), qvel_start=torch.zeros(pm.nv, **f64),
        keypoint_cfg=pt.keypoint_cfg.replace(name="set_interval", min_N=2),
        init_controls_fn=None)
    return jt, pt


def _scenes(pt):
    """LANES scenes of numpy seed 0: the pusher 0.5-2 cm behind the goal,
    1 cm above the table (it falls onto it), the goal 2 mm above it;
    controls push along x and down, with noise."""
    rng = np.random.default_rng(0)
    qp = np.tile(pt.qpos_start.numpy(), (LANES, 1))
    qp[:, 0] = rng.uniform(0.02, 0.035, LANES)
    qp[:, 1] = rng.uniform(-0.02, 0.02, LANES)
    qv = np.zeros((LANES, pt.model.nv))
    U = np.tile([3.0, 0.0, -0.2], (LANES, H, 1)) \
        + 0.3 * rng.standard_normal((LANES, H, 3))
    tg = np.tile(TARGET, (LANES, 1))
    return qp, qv, U, tg


def test_contact_fixture_lane_solve_matches_jax():
    jt, pt = _tasks()
    qp, qv, U, tg = _scenes(pt)
    tq, tv, tU, ttg = map(torch.from_numpy, (qp, qv, U, tg))
    args = (tq.T.contiguous(), tv.T.contiguous(),
            tU.permute(1, 2, 0).contiguous(), ttg.T.contiguous())
    qpos, _, _ = pilqr.rollout(pt, *args)
    act = contacts_active(pt.model, qpos[:H].transpose(0, 1))  # (3, H, B)
    # every pair touches along every scene's initial rollout
    assert bool(act.any(1).all()), act.sum(1).tolist()

    def port(iters):
        cfg = pilqr.ILQRConfig(max_iterations=iters, min_iterations=iters)
        res = planes.solve_lanes(pt, cfg, *args, rule="lane")
        return res, (1.0 - res.final_cost / res.initial_cost).numpy()

    lane, red = port(1)
    jcfg = jilqr.ILQRConfig(max_iterations=1, min_iterations=1,
                            deriv_mode="fd")
    jrun = jlanes.make_lane_phase_optimise(jt, jcfg, H)
    phase_fns = jilqr.make_phase_fns(jt, jcfg, H)
    for b in range(LANES):
        r = jrun(*(jnp.asarray(x[b:b + 1]) for x in (qp, qv, U, tg)))
        _, jstats = jilqr.optimise(
            jt, jnp.asarray(qp[b]), jnp.asarray(qv[b]), jnp.asarray(U[b]),
            jcfg, phase_fns=phase_fns)
        # the rollouts: the JAX lane engine's step is itself ~1e-8 from
        # the generic one with contacts (tests/test_lanes.py:51)
        np.testing.assert_allclose(float(lane.initial_cost[b]),
                                   float(r.initial_cost[0]), rtol=1e-7)
        np.testing.assert_allclose(float(lane.initial_cost[b]),
                                   jstats.initial_cost, rtol=1e-7)
        assert abs(red[b] - jstats.cost_reduction) < 1e-3, (
            b, red[b], jstats.cost_reduction)
        assert abs(red[b] - float(r.cost_reduction[0])) < 2e-6, (
            b, red[b], float(r.cost_reduction[0]))
    # three iterations keep reducing the cost in every scene
    _, red3 = port(ITERS)
    assert (red3 > red).all() and red3.min() > 0.2, (red, red3)
