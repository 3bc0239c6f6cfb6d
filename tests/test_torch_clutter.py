"""The clutter slice of the port against the JAX package, on the CPU in
float64: push_lcl (`make_pushing(3)`, the panda pushing a cylinder among
three free cylinder obstacles) and push_ccl (`make_pushing("constrained")`,
the same topology in a corridor).  15 contact pairs (the table with the
pusher, the goal and each obstacle; every pair of the four cylinders and
the pusher), 25 slots, 114 constraint rows over nv 31; nx 38.

- The scenes of the task's generator, seed 0, exactly (JAX
  `_make_push_scene_generator`).
- The residual and K6's twin (solver/lanes.py:cost_expansion with the
  obstacles' rows) against the JAX lane program's `cost_expansion` phase
  at H = 5, B = 3: 1e-12 relative to each output's largest magnitude.
- The step (push_lcl's) against the JAX lane step `build_smooth_step`,
  eagerly, at contact-active states (the objects pressed into the table, obstacles
  pressed into each other and into the goal, the pusher pressed into an
  obstacle), with the JAX package's bars for these pairs
  (tests/test_lanes.py:199-207).
- K5ad's twin (derivs/ad.py) against JAX forward mode of the lane step at
  those states, eagerly, one `jax.jvp` that gives the step too: 1e-11
  relative to the Jacobians' largest entry (measured 1.6e-13).
- The topology tables (kernels/topology.py) of every shipped instance and
  of push_mcl (seven obstacles, built on the host only) written and read
  back; push_lcl and push_ccl share one instance.
- The CLI's Optimise_once on both tasks at H = 4, the setup servo cut to 3
  steps (1000 on the card).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.dynamics import lanes as jl
from trajoptkp_tpu.dynamics.mjcf import load_mjcf_string
from trajoptkp_tpu.tasks.pushing import build_push_scene_xml
from trajoptkp_tpu.tasks.pushing import make_pushing as jax_pushing
from trajoptkp_tpu_torch.dynamics.contact import contacts_active
from trajoptkp_tpu_torch.dynamics.step import step_state
from trajoptkp_tpu_torch.kernels import build, ops, topology
from trajoptkp_tpu_torch.tasks import pushing

jax.config.update("jax_enable_x64", True)

LEVELS = {"push_lcl": 3, "push_ccl": "constrained"}
H5, NL = 5, 3


@functools.lru_cache(maxsize=None)
def _tasks(name):
    return jax_pushing(LEVELS[name]), pushing.make_pushing(LEVELS[name],
                                                           device="cpu")


def _qadr(m, body):
    return m.jnt_qposadr[m.joint_names.index(body)]


@functools.lru_cache(maxsize=None)
def _contact_states(name):
    """Three contact-active states (qpos (nq, 3), qvel, ctrl): the goal and
    obstacles 1 and 2 in a triangle pressed 0.5 mm into each other, obstacle
    3 pressed into the goal, all 0.5 mm into the table; obstacles 1-3 in a
    triangle elsewhere; the pusher's lower end 2 mm into obstacle 1 (the
    arm at its start pose, the obstacle moved to the pusher).  Velocities
    0.1 N(0, 1), controls N(0, 1), seed 4."""
    _, pt = _tasks(name)
    m = pt.model
    rng = np.random.default_rng(4)
    qp = np.tile(pt.qpos_start.numpy()[:, None], (1, 3))
    bodies = ("goal", "obstacle_1", "obstacle_2", "obstacle_3")
    qa = [_qadr(m, b) for b in bodies]
    d = 2 * pushing.OBJECT_R - 0.0005
    tri = [(0.5, 0.0), (0.5 + d, 0.0), (0.5 + d / 2, d * np.sqrt(0.75))]
    far = [(0.3, -0.4), (0.4, 0.4), (0.6, -0.4), (0.7, 0.4)]
    for lane in range(3):
        for i, a in enumerate(qa):
            qp[a:a + 7, lane] = (*far[i], pushing.OBJECT_Z - 0.0025, 1.0,
                                 0.0, 0.0, 0.0)
    for a, (x, y) in zip(qa[:3], tri):
        qp[a:a + 2, 0] = (x, y)
    qp[qa[3]:qa[3] + 2, 0] = (0.5 - d, 0.0)
    for a, (x, y) in zip(qa[1:], tri):
        qp[a:a + 2, 1] = (x + 0.1, y - 0.3)
    # the pusher's axis end nearer the table, obstacle 1 2 mm into it
    from trajoptkp_tpu_torch.dynamics.collision import geom_pose
    from trajoptkp_tpu_torch.dynamics.fk import forward_kinematics
    from trajoptkp_tpu_torch.dynamics.model import Data

    q2 = torch.as_tensor(qp[:, 2:3])
    z = torch.zeros((m.nv, 1), dtype=torch.float64)
    dat = forward_kinematics(m, Data(qpos=q2, qvel=z, ctrl=z[:m.nu]))
    g = next(i for i in range(m.ngeom) if m.geom_names[i] == "pusher")
    xp, xm = geom_pose(m, dat, g)
    hl = float(m.geom_size[g][1])
    e1, e2 = xp + xm[:, 2] * hl, xp - xm[:, 2] * hl
    e = (e1 if float(e1[2]) < float(e2[2]) else e2)[:, 0].numpy()
    r = float(m.geom_size[g][0]) + pushing.OBJECT_R - 0.002
    qp[qa[1]:qa[1] + 2, 2] = (e[0] + r, e[1])
    qv = 0.1 * rng.standard_normal((m.nv, 3))
    ct = rng.standard_normal((m.nu, 3))
    return qp, qv, ct


@pytest.mark.parametrize("name", list(LEVELS))
def test_contact_states_touch_every_kind_of_pair(name):
    """The states above hold the table rows of every object, obstacle-
    obstacle and goal-obstacle rows and a pusher-obstacle row."""
    _, pt = _tasks(name)
    qp, _, _ = _contact_states(name)
    act = contacts_active(pt.model, torch.as_tensor(qp)).numpy()  # (P, L)
    pairs = pt.model.contact_pairs
    names = pt.model.geom_names
    touching = {(names[a], names[b]) for p, (a, b) in enumerate(pairs)
                if act[p].any()}
    for obj in ("goal", "obstacle_1", "obstacle_2", "obstacle_3"):
        assert ("table", obj) in touching, obj
    assert {("goal", "obstacle_1"), ("obstacle_1", "obstacle_2"),
            ("obstacle_2", "obstacle_3"), ("goal", "obstacle_3"),
            ("pusher", "obstacle_1")} <= touching, touching


@functools.lru_cache(maxsize=None)
def _jax_step_jvp():
    """JAX forward mode of push_lcl's lane step (`build_smooth_step`) at the
    three contact states, over the state vector's tangent and the
    controls, eagerly (a jitted lane step compiles for minutes): one
    `jax.jvp` whose lanes are the 3 x 45 (state, column) pairs, each lane a
    copy of its state with its column's unit tangent (~1 min; `jacfwd`
    batches the 45 tangents over a vmap and took ~11 min) -> (next qpos
    (nq, 3), next qvel (nv, 3), J (2n, 2n + nu, 3)).  Its primal is the
    step at the three states."""
    jt, pt = _tasks("push_lcl")
    qp, qv, ct = _contact_states("push_lcl")
    step = jl.build_smooth_step(jt.model)
    n, nu = pt.sv.ndof, pt.model.nu
    C, S = 2 * n + nu, qp.shape[1]
    # the clutter state holds translations and hinges alone: its position
    # tangent adds to their qpos
    iq = np.asarray([_sv_q(pt, k) for k in range(n)])
    iv = np.asarray(pt.sv.order)
    rep = np.repeat(np.arange(S), C)                # lane -> its state
    Q, V, U = (jnp.asarray(x[:, rep]) for x in (qp, qv, ct))

    def f(z):
        return step(Q.at[iq].add(z[:n]), V.at[iv].add(z[n:2 * n]),
                    U + z[2 * n:])

    with jax.disable_jit():
        (qn, vn), (dq, dv) = jax.jvp(
            f, (jnp.zeros((C, S * C)),),
            (jnp.asarray(np.tile(np.eye(C), (1, S))),))
    d = np.concatenate([np.asarray(dq)[iq], np.asarray(dv)[iv]])
    first = np.arange(S) * C                        # each state's first lane
    return (np.asarray(qn)[:, first], np.asarray(vn)[:, first],
            d.reshape(2 * n, S, C).transpose(0, 2, 1))


def test_step_against_the_jax_lane_step_in_contact():
    """push_lcl (push_ccl's step is the same: its model differs in the free
    bodies' initial poses alone, which the step takes from qpos), against
    the primal of the JAX step's forward mode (_jax_step_jvp)."""
    _, pt = _tasks("push_lcl")
    qp, qv, ct = _contact_states("push_lcl")
    qp2, qv2, _ = _jax_step_jvp()
    pq, pv = step_state(pt.model, torch.as_tensor(qp), torch.as_tensor(qv),
                        torch.as_tensor(ct))
    np.testing.assert_allclose(pq.numpy(), qp2, rtol=3e-6, atol=1e-9)
    np.testing.assert_allclose(pv.numpy(), qv2, rtol=3e-6, atol=1e-7)


def test_exact_jacobians_twin_matches_jax_forward_mode_of_the_lane_step():
    """push_lcl: K5ad's twin (forward mode through the plain step, the
    constraint solve's tangent implicit through the 114 rows) against JAX
    forward mode of the lane step (_jax_step_jvp) at the three contact
    states."""
    from trajoptkp_tpu_torch.derivs.ad import ad_slot_jacobians

    _, pt = _tasks("push_lcl")
    qp, qv, ct = _contact_states("push_lcl")
    J = ad_slot_jacobians(pt.model, pt.sv, *map(torch.from_numpy,
                                                  (qp, qv, ct)))
    want = _jax_step_jvp()[2]
    got = J.numpy()
    scale = np.abs(want).max()
    assert float(np.abs(got - want).max()) <= 1e-11 * scale, (
        float(np.abs(got - want).max()) / scale)


def _sv_q(pt, k):
    """The qpos of state dof k (the clutter state holds no rotation)."""
    m, j = pt.model, pt.sv.order[k]
    for jn in range(m.njnt):
        da = m.jnt_dofadr[jn]
        if da <= j < da + (6 if m.jnt_type[jn] == 0 else 1):
            return m.jnt_qposadr[jn] + j - da
    raise ValueError(j)


def _trajectory(pt, rng):
    """qpos (H+1, nq, B) with the arm at its start moved by 0.1 N(0, 1),
    the goal and obstacles at the scenes' places moved by 0.02 N(0, 1)
    (lane 1 tilted a quarter turn), velocities 0.1 N(0, 1), controls 0.3
    N(0, 1), the scenes' targets."""
    qp, _, tg = pushing.push_scenes(pt, NL, seed=7)
    m = pt.model
    q = np.tile(qp.numpy().T[None], (H5 + 1, 1, 1))
    q[:, :7] += 0.1 * rng.standard_normal((H5 + 1, 7, NL))
    for body in ("goal", "obstacle_1", "obstacle_2", "obstacle_3"):
        a = _qadr(m, body)
        q[:, a:a + 2] += 0.02 * rng.standard_normal((H5 + 1, 2, NL))
        q[:, a + 3:a + 5, 1] = (np.cos(0.2), np.sin(0.2))
    return (q, 0.1 * rng.standard_normal((H5 + 1, m.nv, NL)),
            0.3 * rng.standard_normal((H5, m.nu, NL)), tg.numpy().T.copy())


@pytest.mark.parametrize("name", list(LEVELS))
def test_cost_expansion_twin_matches_the_jax_lane_program(name):
    from trajoptkp_tpu.solver.ilqr import ILQRConfig as JConfig
    from trajoptkp_tpu.solver.lanes import make_lane_batch_optimise
    from trajoptkp_tpu_torch.solver import lanes as planes

    jt, pt = _tasks(name)
    qpos, qvel, U, tg = _trajectory(pt, np.random.default_rng(11))
    # the residual itself, obstacles' rows included
    r = pt.residual_fn(*(torch.from_numpy(x[0]) for x in (qpos, qvel, U)),
                       torch.from_numpy(tg))
    from trajoptkp_tpu.dynamics.fk import forward_kinematics as jfk
    from trajoptkp_tpu.dynamics.model import Data as JData

    for b in range(NL):
        d = jfk(jt.model, JData(qpos=jnp.asarray(qpos[0, :, b]),
                                qvel=jnp.asarray(qvel[0, :, b]),
                                ctrl=jnp.asarray(U[0, :, b]),
                                time=jnp.zeros(())))
        want_r = np.asarray(jt.residual_fn(jt.model, d, jnp.asarray(tg[:, b])))
        np.testing.assert_allclose(r[:, b].numpy(), want_r, rtol=1e-13,
                                   atol=1e-15)
    got = planes.cost_expansion(pt, *map(torch.from_numpy,
                                         (qpos, qvel, U, tg)))
    jt = jt.replace(keypoint_cfg=jt.keypoint_cfg.replace(
        name="set_interval", min_N=1))
    want = jax.jit(make_lane_batch_optimise(jt, JConfig(), H5).phases[
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
    # the obstacles' rows reach l_x through their x and y position columns
    n = pt.sv.ndof
    cols = [s for s, j in enumerate(pt.sv.order)
            if pt.sv.names[s].startswith("obstacle")
            and pt.sv.names[s][-1] in "xy"]
    assert len(cols) == 6 and bool(got[0][:, cols].abs().min() > 0)
    assert got[0].shape == (H5, 2 * n, NL)


@pytest.mark.parametrize("name", list(LEVELS))
def test_scenes_are_the_jax_generator_scenes(name):
    """Seed 0: the object start, the targets and every obstacle, drawn as
    the JAX generator draws them; push_scenes places them as free-joint
    qpos at z 0.032, upright."""
    jt, pt = _tasks(name)
    jrng, prng = np.random.default_rng(0), np.random.default_rng(0)
    constrained = name == "push_ccl"
    for _ in range(16):
        _, bodies, tg = jt.scene_generator_fn(jt, jrng)
        start, ptg, obst = pushing.clutter_scene(prng, constrained, 3)
        assert tuple(tg) == tuple(ptg)
        assert [tuple(b[:2]) for b in bodies] == [start] + list(obst)
    qp, qv, tgs = pushing.push_scenes(pt, 4, seed=0)
    jrng = np.random.default_rng(0)
    m = pt.model
    for i in range(4):
        _, bodies, tg = jt.scene_generator_fn(jt, jrng)
        assert tgs[i].tolist() == list(tg)
        for body, b in zip(("goal", "obstacle_1", "obstacle_2",
                            "obstacle_3"), bodies):
            a = _qadr(m, body)
            assert qp[i, a:a + 7].tolist() == [b[0], b[1], 0.032, 1.0, 0.0,
                                               0.0, 0.0]
    assert not bool(qv.any())
    # the displacement residual is measured from the fixed layout (the JAX
    # task's _OBSTACLE_LAYOUTS), not from the scene's obstacles
    assert pt.obstacle_starts.tolist() == [
        list(p) for p in pushing.OBSTACLE_LAYOUTS[LEVELS[name]]]


def _mcl_topology():
    """push_mcl's tables, from the JAX scene with seven obstacles carried
    as the port's Model (host only: no instance is built for it)."""
    from tests.test_torch_model import _npz_fields
    from trajoptkp_tpu_torch.dynamics import model as pm
    from trajoptkp_tpu_torch.state.statevector import state_vector_from_names

    jm = load_mjcf_string(build_push_scene_xml(7))
    model = pm.model_from_numpy(_npz_fields(jm), device="cpu")
    names = list(model.joint_names[:7])
    for body in ["goal"] + [f"obstacle_{i + 1}" for i in range(7)]:
        names += [f"{body}_lin_{a}" for a in "xyz"]
    sv = state_vector_from_names(model, names)
    bodies = tuple(model.body_names.index(b) for b in
                   ["goal"] + [f"obstacle_{i + 1}" for i in range(7)])
    ee = model.site_names.index("ee")
    return model, ops.model_topology(model)._replace(
        NDOF=sv.ndof, SV=ops.state_key(model, sv), RES=ops.RES_KINDS["push"],
        RESARGS=(bodies[0], model.site_bodyid[ee]) + bodies[1:])


def test_topology_tables_round_trip():
    """Every instance in instances.cuh reads back as the tables its task
    computes (push_ccl's are push_lcl's), and push_mcl's tables (nq 63, nv
    55, 18 bodies, 31 state dofs, 45 pairs, past every 4-bit code) survive
    being written and read back."""
    from trajoptkp_tpu_torch.config.loader import make_task

    shipped = build.instance_tables()
    for task_name, tag in (("acrobot", "acrobot"), ("pentabot", "pentabot"),
                           ("reaching", "reaching"),
                           ("pushing_no_clutter", "push_ncl"),
                           ("walker_run", "walker"), ("box_sweep", "box_sweep"),
                           ("threeD_push", "threeD_push"),
                           ("pushing_low_clutter", "push_lcl"),
                           ("pushing_moderate_clutter_constrained",
                            "push_lcl")):
        key = ops.instance_key(make_task(task_name, device="cpu"))
        assert shipped[tag] == key, task_name
        assert topology.parse(topology.emit(tag, key)) == {tag: key}
    lcl = shipped["push_lcl"]
    assert (lcl.NV, lcl.NDOF, len(lcl.PAIRS), sum(lcl.LIMITED)) == (31, 19,
                                                                    15, 7)
    assert build.step_shared()["push_lcl"] == "push_lcl"
    model, mcl = _mcl_topology()
    assert (model.nq, mcl.NV, mcl.NBODY, mcl.NDOF, len(mcl.PAIRS)) == (
        63, 55, 18, 31, 45)
    back = topology.parse(topology.emit("push_mcl", mcl))["push_mcl"]
    assert back == mcl
    assert max(mcl.DOF_Q) == 61 and max(mcl.SV) == 51


@pytest.mark.parametrize("task_name,level", [
    ("pushing_low_clutter", "push_lcl"),
    ("pushing_moderate_clutter_constrained", "push_ccl")])
def test_cli_optimise_once_on_the_cpu(task_name, level, monkeypatch, capsys):
    from trajoptkp_tpu_torch import app

    monkeypatch.setattr(pushing, "create_init_setup_controls",
                        functools.partial(pushing.create_init_setup_controls,
                                          horizon=3))
    app.main(["--device", "cpu", "--task", task_name, "--runMode",
              "Optimise_once", "--horizon", "4", "--maxIter", "1",
              "--minIter", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["task"] == level and out["horizon"] == 4
    assert out["keypoint_method"] == "adaptive_jerk"
    assert out["iterations"] == 1 and np.isfinite(out["final_cost"])
    assert out["final_cost"] <= out["initial_cost"]
