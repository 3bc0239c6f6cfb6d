"""The box slice of the port against the JAX package, on the CPU in float64:
box_sweep and threeD_push (a panda with a pusher rod and a free box on a
table; pairs plane-cylinder, plane-box and cylinder-box).

- The colliders (dynamics/collision.py: plane_box, sphere_box_core,
  capsule_box and a pair given in the other order) against the JAX lane
  engine's `_collide_regs` / `_pair_slots_regs` on crafted poses: a box
  resting flat (its four bottom corners tie; compared as a set), tilted
  20 degrees (two corners below the plane) and at a general pose, a
  capsule probing the box from outside and with an end point inside it,
  and the reversed pair.  Bar 1e-12 absolute (the same formulas in the
  same order; a tie in the corner sort is compared as a set).
- The step (dynamics/step.py with the box rows) against the JAX lane step
  `build_smooth_step` on contact-active states of a driven rollout, at
  both tasks, with the JAX package's own bars for these pairs
  (tests/test_lanes.py:199-207): qpos rtol 3e-6 atol 1e-9, qvel rtol
  3e-6 atol 1e-7.
- K6's twin (solver/lanes.py:cost_expansion, the closed-form residual
  Jacobians of tasks/manipulation.py) against the JAX lane program's
  `cost_expansion` phase at H = 6, B = 3: 1e-12 relative to each output's
  largest magnitude.
- K5ad's twin (derivs/ad.py, the constraint tangents through the box rows)
  against JAX `jacfwd` of the lane step on a few contact-active states,
  run eagerly under `jax.disable_jit()` (~1.5 min): 1e-11 relative to the
  largest entry of the Jacobians (measured 1.9e-13: the JAX Newton solve
  and the twin sum the rows in other orders).
- Both CLI modes at `--device cpu --horizon 10 --maxIter 1`; and, marked
  slow (full-suite runs only, ~5 min), box_sweep's generic solve at H = 15
  against the JAX CLI's, both ending in λ-exit at their first iteration.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.dynamics import lanes as jl
from trajoptkp_tpu.tasks.manipulation import make_box_sweep as jax_box_sweep
from trajoptkp_tpu.tasks.manipulation import make_threed_push as jax_threed
from trajoptkp_tpu_torch.dynamics import collision as pcol
from trajoptkp_tpu_torch.dynamics.step import step_state
from trajoptkp_tpu_torch.tasks.manipulation import (box_scenes,
                                                    make_box_sweep,
                                                    make_threed_push)

jax.config.update("jax_enable_x64", True)

BOX = (0.15, 0.1, 0.06)
PUSHER = (0.012, 0.05)


def rot(axis, angle):
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _jax_regs(p, m):
    return (tuple(jnp.asarray(p[k]) for k in range(3)),
            tuple(tuple(jnp.asarray(m[r, c]) for c in range(3))
                  for r in range(3)))


def _jax_slots(t1, t2, p1, m1, s1, p2, m2, s2):
    """JAX `_collide_regs`, or with the geoms swapped and the normals
    flipped where it has no collider in this order (`_pair_slots_regs`)."""
    a, b = _jax_regs(p1, m1), _jax_regs(p2, m2)
    try:
        return jl._collide_regs(t1, t2, *a, s1, *b, s2)
    except NotImplementedError:
        out = jl._collide_regs(t2, t1, *b, s2, *a, s1)
        return [(d, p, (tuple(-x for x in fr[0]), fr[1], fr[2]))
                for d, p, fr in out]


def _port_slots(t1, t2, p1, m1, s1, p2, m2, s2):
    t = [torch.as_tensor(x, dtype=torch.float64) for x in (p1, m1, p2, m2)]
    return pcol.pair_contacts(t1, t2, t[0], t[1], s1, t[2], t[3], s2)


def _as_rows(jout, slots):
    """(dist, pos, frame) per slot, numpy, JAX's and the port's."""
    j = [(float(d), np.array([float(x) for x in p]),
          np.array([[float(x) for x in row] for row in fr]))
         for d, p, fr in jout]
    p = [(float(d), pos.numpy(), torch.stack(fr).numpy())
         for d, pos, fr in zip(slots.dist, slots.pos, slots.frames)]
    return j, p


def _assert_slots(jout, slots, as_set=False):
    j, p = _as_rows(jout, slots)
    assert len(j) == len(p)
    if as_set:
        key = lambda s: (round(s[0], 9), round(s[1][0], 9), round(s[1][1], 9))
        j, p = sorted(j, key=key), sorted(p, key=key)
    for (jd, jp, jf), (pd, pp, pf) in zip(j, p):
        assert abs(jd - pd) <= 1e-12
        np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-12)
        np.testing.assert_allclose(pf, jf, rtol=0, atol=1e-12)


PLANE = (np.zeros(3), np.eye(3), (3.0, 3.0, 0.1))


@pytest.mark.parametrize("case", ["flat", "tilted_20", "general"])
def test_plane_box_against_the_jax_lane_collider(case):
    """Four deepest corners of eight: the bottom four tie on a flat box
    (compared as a set), two corners below the plane at 20 degrees, all
    depths distinct at a general pose."""
    if case == "flat":
        m, z = rot((0, 0, 1), 0.3), BOX[2] - 1e-4
    elif case == "tilted_20":
        m, z = rot((1, 0, 0), np.deg2rad(20.0)), 0.085
    else:
        m, z = rot((0.3, -0.5, 0.8), 0.7), 0.12
    p = np.array([0.6, 0.1, z])
    args = (pcol.GEOM_PLANE, pcol.GEOM_BOX, *PLANE, p, m, BOX)
    slots = _port_slots(*args)
    _assert_slots(_jax_slots(*args), slots, as_set=case == "flat")
    depths = sorted(float(d) for d in slots.dist)
    if case == "tilted_20":
        assert depths[0] < 0 and depths[1] < 0 and depths[2] > 0
    if case == "flat":
        assert all(d < 0 for d in depths)


@pytest.mark.parametrize("case", ["outside", "endpoint_inside",
                                  "across_a_corner", "reversed"])
def test_cylinder_box_probes_against_the_jax_lane_collider(case):
    """Two sphere-box probes at the pusher's end points: outside the box
    near a face, one end point inside it (the least-margin face), across a
    corner, and the pair given box first (normals flipped)."""
    box_p, box_m = np.array([0.6, 0.1, 0.06]), rot((0, 0, 1), 0.4)
    if case == "outside":
        p, m = np.array([0.6 + 0.16, 0.1, 0.1]), np.eye(3)
    elif case == "endpoint_inside":
        p, m = box_p + box_m @ np.array([0.13, 0.02, 0.07]), \
            rot((1, 0, 0), 0.1)
    else:
        p, m = box_p + box_m @ np.array([0.16, 0.11, 0.1]), \
            rot((0.2, 1, 0), 0.5)
    args = (pcol.GEOM_CYLINDER, pcol.GEOM_BOX, p, m, PUSHER, box_p, box_m,
            BOX)
    if case == "reversed":
        args = (pcol.GEOM_BOX, pcol.GEOM_CYLINDER, box_p, box_m, BOX, p, m,
                PUSHER)
    slots = _port_slots(*args)
    _assert_slots(_jax_slots(*args), slots)
    assert pcol.pair_ncon(*args[:2]) == 2
    if case == "endpoint_inside":
        assert float(slots.dist[1]) < -PUSHER[0] < float(slots.dist[0])


def test_sphere_box_core_inside_ties_and_capsule_pairs():
    """The centre-inside branch at a tie of two margins (the lower axis
    wins), and a capsule (type 3) takes the same probes as a cylinder."""
    box_p, box_m = np.zeros(3), np.eye(3)
    for p in (np.array([0.1, 0.05, 0.0]), np.array([0.0, 0.0, 0.0]),
              np.array([0.12, -0.07, 0.03])):
        q = torch.as_tensor(p)[:, None]
        d, pos, n = pcol.sphere_box_core(q, 0.01, torch.zeros(3, 1),
                                         torch.eye(3)[..., None], BOX)
        jd, jp, jn = jl._sphere_box_core_reg(
            tuple(jnp.asarray(x) for x in p), 0.01,
            tuple(jnp.zeros(()) for _ in range(3)),
            tuple(tuple(jnp.asarray(box_m[r, c]) for c in range(3))
                  for r in range(3)), BOX)
        assert abs(float(d[0]) - float(jd)) <= 1e-15
        np.testing.assert_allclose(pos[:, 0].numpy(),
                                   [float(x) for x in jp], atol=1e-15)
        np.testing.assert_allclose(n[:, 0].numpy(), [float(x) for x in jn],
                                   atol=1e-15)
    args = (pcol.GEOM_CAPSULE, pcol.GEOM_BOX, np.array([0.2, 0.0, 0.0]),
            rot((0, 1, 0), 1.2), PUSHER, box_p, box_m, BOX)
    _assert_slots(_jax_slots(*args), _port_slots(*args))


# ---------------------------------------------------------------------------
# the step on contact-active states
# ---------------------------------------------------------------------------

MAKERS = {"box_sweep": (jax_box_sweep, make_box_sweep),
          "threeD_push": (jax_threed, make_threed_push)}


def _driven_states(name):
    """Contact-active states of a driven rollout of the port's step from
    the task's start (the box resting on the table, the arm driven with
    0.4 N(0, 1) controls, seed 3) at steps 0, 8 and 16, and the box tilted
    20 degrees (two corners below the table) -> qpos (nq, L), qvel, ctrl
    (numpy copies of one rollout per task)."""
    return tuple(x.copy() for x in _driven_rollout(name))


@functools.lru_cache(maxsize=None)
def _driven_rollout(name, n_steps=17, every=8):
    pt = MAKERS[name][1](device="cpu")
    m = pt.model
    rng = np.random.default_rng(3)
    u = 0.4 * rng.standard_normal((n_steps, m.nu))
    qp, qv = pt.qpos_start[:, None], pt.qvel_start[:, None]
    out = []
    for t in range(n_steps):
        if t % every == 0:
            out.append((qp[:, 0].numpy().copy(), qv[:, 0].numpy().copy(),
                        u[t]))
        qp, qv = step_state(m, qp, qv, torch.as_tensor(u[t])[:, None])
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    tilted = pt.qpos_start.numpy().copy()
    a = np.deg2rad(20.0) / 2
    tilted[qa + 3:qa + 7] = [np.cos(a), np.sin(a), 0.0, 0.0]
    out.append((tilted, np.zeros(m.nv), u[0]))
    return tuple(np.stack([s[k] for s in out], 1) for k in range(3))


@pytest.mark.parametrize("name", ["box_sweep", "threeD_push"])
def test_step_against_the_jax_lane_step(name):
    jt = MAKERS[name][0](dtype=jnp.float64)
    pt = MAKERS[name][1](device="cpu")
    qp, qv, ct = _driven_states(name)
    with jax.disable_jit():    # eager: ~3-13 s against ~65 s of compile
        qp2, qv2 = jl.build_smooth_step(jt.model)(
            jnp.asarray(qp), jnp.asarray(qv), jnp.asarray(ct))
    pq, pv = step_state(pt.model, torch.as_tensor(qp), torch.as_tensor(qv),
                        torch.as_tensor(ct))
    np.testing.assert_allclose(pq.numpy(), np.asarray(qp2), rtol=3e-6,
                               atol=1e-9)
    np.testing.assert_allclose(pv.numpy(), np.asarray(qv2), rtol=3e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,method", [("box_sweep", "adaptive_jerk"),
                                         ("threeD_push", "set_interval")])
def test_cli_optimise_once_on_the_cpu(name, method, capsys):
    from trajoptkp_tpu_torch import app

    app.main(["--device", "cpu", "--task", name, "--runMode",
              "Optimise_once", "--horizon", "10", "--maxIter", "1",
              "--minIter", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["task"] == name and out["horizon"] == 10
    assert out["keypoint_method"] == method and out["iterations"] == 1
    assert np.isfinite(out["final_cost"])
    assert out["final_cost"] <= out["initial_cost"]


@pytest.mark.slow
def test_box_sweep_generic_solve_lambda_exits_as_the_jax_cli_does():
    """The CLI's Optimise_once on box_sweep (the generic solve, deriv_mode
    fd, AJ_1_1000) from the task's start and its init servo, one iteration
    at H = 15, against the JAX CLI's (`_prepare_start`, then `optimise`,
    its phases run eagerly: jitted, its FD derivatives compile for many
    minutes on a CPU; ~5 min in all): both end at their first iteration
    through λ-exit (no λ recorded, the initial controls kept), from
    initial costs within 1e-12 relative.  The card's CLI run at the task's
    H = 1500 ends the same way."""
    from trajoptkp_tpu import app as japp
    from trajoptkp_tpu.solver.ilqr import ILQRConfig as JConfig
    from trajoptkp_tpu.solver.ilqr import optimise as joptimise
    from trajoptkp_tpu_torch.solver.ilqr import ILQRConfig, optimise

    H = 15
    pt = make_box_sweep(device="cpu")
    qp, qv, U = pt.init_controls_fn(pt, H, pt.qpos_start[:, None],
                                    pt.qvel_start[:, None],
                                    pt.residual_targets[:, None])
    _, got = optimise(pt, qp[:, 0], qv[:, 0], U[..., 0],
                      ILQRConfig(max_iterations=1, min_iterations=1,
                                 deriv_mode="fd"))
    jt = jax_box_sweep(dtype=jnp.float64)
    q0, v0, UJ = japp._prepare_start(jt, H)
    jt = jt.replace(qpos_start=q0, qvel_start=v0)
    with jax.disable_jit():
        _, want = joptimise(jt, q0, v0, UJ, JConfig(
            max_iterations=1, min_iterations=1, deriv_mode="fd"))
    assert want.num_iterations == got.num_iterations == 1
    assert want.lambdas == () and got.lambdas == ()
    assert want.cost_reduction == got.cost_reduction == 0.0
    assert abs(got.initial_cost - want.initial_cost) <= (
        1e-12 * abs(want.initial_cost))
    assert got.final_cost == got.initial_cost


def test_box_scenes_are_the_jax_generic_scenes():
    """The JAX CLI's generic scene branch (`app.py:312-320`), seed 0."""
    pt = make_box_sweep(device="cpu")
    qp, qv, tg = box_scenes(pt, 3, seed=0)
    rng = np.random.default_rng(0)
    q0 = pt.qpos_start.numpy()
    for i in range(3):
        start = q0[:7] + 0.2 * rng.standard_normal(7)
        t = np.array([0.9, 0.4, 0.0, 0.0]) + 0.1 * rng.standard_normal(4)
        np.testing.assert_array_equal(qp[i, :7].numpy(), start)
        np.testing.assert_array_equal(qp[i, 7:].numpy(), q0[7:])
        np.testing.assert_array_equal(tg[i].numpy(), t)
    assert float(qv.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K6's twin and K5ad's twin against the JAX lane program
# ---------------------------------------------------------------------------

H6, NL6 = 6, 3


def _box_trajectory(pt, rng, H_, NL):
    """qpos (H+1, nq, B), qvel, U (H, nu, B), targets (ntgt, B): the arm
    at its start pose moved by 0.1 N(0, 1), the box on the table at random
    in xy and yaw, lane 1 tilted 20 degrees about x, random velocities
    0.1 N(0, 1), targets the task's + 0.1 N(0, 1)."""
    m = pt.model
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    q = np.tile(pt.qpos_start.numpy()[None, :, None], (H_ + 1, 1, NL))
    q[:, :7] += 0.1 * rng.standard_normal((H_ + 1, 7, NL))
    for b in range(NL):
        yaw, roll = rng.uniform(-1, 1), (np.deg2rad(20.0) if b == 1 else 0.0)
        qz = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
        qx = np.array([np.cos(roll / 2), np.sin(roll / 2), 0, 0])
        quat = np.array([qz[0] * qx[0], qz[0] * qx[1], qz[3] * qx[1],
                         qz[3] * qx[0]])
        q[:, qa:qa + 7, b] = np.concatenate(
            [[rng.uniform(0.4, 0.7), rng.uniform(-0.2, 0.2),
              float(q[0, qa + 2, b])], quat])[None]
    tg = (pt.residual_targets.numpy()[:, None]
          + 0.1 * rng.standard_normal((pt.residual_targets.shape[0], NL)))
    return (q, 0.1 * rng.standard_normal((H_ + 1, m.nv, NL)),
            0.3 * rng.standard_normal((H_, m.nu, NL)), tg)


@pytest.mark.parametrize("name", ["box_sweep", "threeD_push"])
def test_cost_expansion_twin_matches_the_jax_lane_program(name):
    from trajoptkp_tpu.solver.ilqr import ILQRConfig as JConfig
    from trajoptkp_tpu.solver.lanes import make_lane_batch_optimise
    from trajoptkp_tpu_torch.solver import lanes as planes

    jt = MAKERS[name][0](dtype=jnp.float64)
    pt = MAKERS[name][1](device="cpu")
    qpos, qvel, U, tg = _box_trajectory(pt, np.random.default_rng(11), H6,
                                        NL6)
    got = planes.cost_expansion(pt, *map(torch.from_numpy,
                                         (qpos, qvel, U, tg)))
    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    want = jax.jit(make_lane_batch_optimise(jt, JConfig(), H6).phases[
        "cost_expansion"])(*map(jnp.asarray, (qpos, qvel, U, tg)))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        if scale == 0.0:
            assert float(np.abs(g).max()) == 0.0
        else:
            assert float(np.abs(g - w).max()) <= 1e-12 * scale, (
                float(np.abs(g - w).max()) / scale)


def test_exact_jacobians_twin_matches_jax_jacfwd_of_the_lane_step():
    """box_sweep: K5ad's twin (forward mode through the plain step, the
    constraint solve's tangent implicit through the box rows, the box's
    rotation rows as the tangent of the quaternion log) against the JAX
    lane program's jacobians phase at SI_1 (jacfwd of the lane step),
    eagerly (jitted it compiles for over 10 min on a CPU), on the driven
    states at steps 0 and 16 (contact rows active) and the tilted box."""
    from trajoptkp_tpu.solver.ilqr import ILQRConfig as JConfig
    from trajoptkp_tpu.solver.lanes import make_lane_batch_optimise
    from trajoptkp_tpu_torch.derivs.ad import ad_slot_jacobians

    jt = jax_box_sweep(dtype=jnp.float64)
    pt = make_box_sweep(device="cpu")
    qp, qv, ct = (x[:, [0, 2, 3]] for x in _driven_states("box_sweep"))
    J = ad_slot_jacobians(pt.model, pt.sv, *map(torch.from_numpy,
                                                  (qp, qv, ct)))
    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    with jax.disable_jit():     # H = 2: the states at both steps
        A, Bm, _, _ = make_lane_batch_optimise(jt, JConfig(), 2).phases[
            "jacobians"](*(jnp.asarray(np.stack([x] * n)) for x, n in
                           ((qp, 3), (qv, 3), (ct, 2))))
    want = np.concatenate([np.asarray(A[0]), np.asarray(Bm[0])], axis=1)
    got = J.numpy()
    scale = np.abs(want).max()
    assert float(np.abs(got - want).max()) <= 1e-11 * scale, (
        float(np.abs(got - want).max()) / scale)
