"""The walker (walker_run) on the port's plain path against the JAX package,
float64: several joints on one body (the torso's rootz and rootx slides and
rooty hinge), plane-capsule and capsule-capsule contacts, and the
selected-coordinate residual.

The JAX step is compiled once for one state (`jit` of `step_state`) and
called per state, as tests/test_torch_push.py does (`jit(vmap(...))` of a
contact step compiles for tens of minutes on the CPU).  States: 8 lanes
driven 16 steps from the start pose pressed into the floor and random leg
angles (plane-capsule rows active), the steps 2, 6, 10 and 15 kept, and one
crafted state with a shin pressed into the torso (capsule-capsule rows
active, `_legs_touching`).

Tolerances (measured values in brackets):
- FK and cdof with all three torso joints moving: 1e-12;
- one step: qpos 1e-9, qvel 1e-7 absolute, and half the states within 1e-10
  in qvel [qpos 1.4e-10, qvel 2.8e-8 at the worst state (|qvel| up to 27),
  20 of 33 states within 1e-10: stiff floor and limit rows leave the 8 cold
  Newton iterations unconverged, so summation order shows, as at push_ncl
  (ROADMAP Queue 3); the port runs the JAX lane engine's row order, the JAX
  generic engine its own];
- contact rows: J 1e-12 absolute, R 1e-12 relative, aref 1e-10 relative,
  gates equal;
- FD columns (eps 1e-6): 1e-6 absolute at a state without active rows
  [5.4e-9]; 5e-3 absolute where rows are active [2.8e-6 and 1.04e-3, entries
  up to ~50] (FD across the rows' gates, ROADMAP Queue 3: push_ncl's 2.2e-5
  at its bar of 1e-3);
- the residual and the cost expansion: 1e-12 (the residual is linear).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.derivs.fd import fd_job_columns
from trajoptkp_tpu.dynamics import contact as jcon
from trajoptkp_tpu.dynamics import step_state as jax_step_state
from trajoptkp_tpu.dynamics.fk import forward_kinematics as jax_fk
from trajoptkp_tpu.dynamics.model import Data as JData
from trajoptkp_tpu.tasks import base as jbase
from trajoptkp_tpu.tasks.locomotion import make_walker as jax_walker
from trajoptkp_tpu_torch.config.loader import make_task
from trajoptkp_tpu_torch.derivs.fd import fd_slot_jacobians
from trajoptkp_tpu_torch.dynamics import contact as pcon
from trajoptkp_tpu_torch.dynamics.fk import forward_kinematics
from trajoptkp_tpu_torch.dynamics.model import Data
from trajoptkp_tpu_torch.dynamics.smooth import body_dofs
from trajoptkp_tpu_torch.dynamics.step import step_state
from trajoptkp_tpu_torch.kernels import ops
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.tasks.locomotion import make_walker

jax.config.update("jax_enable_x64", True)

LANES, T = 8, 16
EPS = 1e-6
PLANE_CAPSULE = 7        # the first 7 pairs are floor-capsule


@pytest.fixture(scope="module")
def walker():
    """(JAX task, port task, the compiled JAX step over lanes last)."""
    jt = jax_walker(run=True)
    jm = jt.model
    one = jax.jit(lambda q, v, u: jax_step_state(jm, q, v, u))

    def step(qp, qv, u):
        outs = [one(qp[:, i], qv[:, i], u[:, i]) for i in range(qp.shape[1])]
        return (np.stack([np.asarray(o[0]) for o in outs], 1),
                np.stack([np.asarray(o[1]) for o in outs], 1))
    return jt, make_walker(run=True, device="cpu"), step


def _legs_touching(pt):
    """Legs folded until the right shin's capsule presses ~1 cm into the
    torso's (a capsule-capsule pair).  The legs of this model are planar and
    0.1 apart across the body, so a capsule pair touches only with a joint
    far past its limits: walker.xml gives its ranges in degrees (MuJoCo's
    default angle unit), about +-1 degree, and the limit rows hold the legs
    softly (ROADMAP Queue 3)."""
    q = pt.qpos_start.numpy().copy()
    q[0] = 0.5                                     # clear of the floor
    q[3:9] = (0.78, 2.86, 2.57, -2.66, -2.88, 2.59)
    return q


@pytest.fixture(scope="module")
def states(walker):
    """(qpos (nq, K), qvel (nv, K), ctrl (nu, K)): the driven rollout's kept
    steps, then the legs-touching state."""
    jt, pt, step = walker
    m = pt.model
    rng = np.random.default_rng(0)
    qp = np.tile(pt.qpos_start.numpy()[:, None], (1, LANES))
    qp[0] = rng.uniform(-0.04, 0.0, LANES)         # into the floor
    qp[2] = rng.uniform(-0.3, 0.3, LANES)
    qp[3:] = rng.uniform(-0.5, 0.5, (6, LANES))
    qv = 0.3 * rng.standard_normal((m.nv, LANES))
    keep = []
    for t in range(T):
        u = rng.uniform(-1.0, 1.0, (m.nu, LANES))
        if t in (2, 6, 10, 15):
            keep.append((qp, qv, u))
        qp, qv = step(qp, qv, u)
    keep.append((_legs_touching(pt)[:, None], 0.2 * rng.standard_normal(
        (m.nv, 1)), rng.uniform(-1.0, 1.0, (m.nu, 1))))
    return tuple(np.concatenate([k[i] for k in keep], 1) for i in range(3))


def test_walker_has_several_joints_on_one_body_and_its_kernel_instance():
    pt = make_task("walker_run", device="cpu")
    m = pt.model
    assert (m.nq, m.nv, m.nu, m.nbody) == (9, 9, 6, 8)
    assert body_dofs(m)[1] == (0, 1, 2)
    assert ops.body_joints(m)[1] == [0, 1, 2]
    cc = pcon.contact_constants(m)
    assert len(cc.pairs) == 22 and cc.nslot == 29
    assert [p.ncon for p in cc.pairs] == [2] * 7 + [1] * 15
    ka = ops.kernel_args(pt, torch.device("cpu"))
    assert ka.tag == "walker" and pt.sv.nx == 18
    assert (18, 6) in ops.backward_instances()
    with pytest.raises(NotImplementedError, match="plane-box"):
        make_task("walker_uneven", device="cpu")
    assert make_task("walker_walk", device="cpu").residual_targets[2] == 0.5


def test_walker_fk_and_cdof_with_the_torso_joints_moving(walker):
    jt, pt, _ = walker
    m = pt.model
    rng = np.random.default_rng(1)
    qp = np.tile(pt.qpos_start.numpy()[:, None], (1, 4))
    qp[:3] = rng.uniform(-0.6, 0.6, (3, 4))        # rootz, rootx, rooty
    qp[3:] += 0.3 * rng.standard_normal((6, 4))
    d = forward_kinematics(m, Data(qpos=torch.from_numpy(qp),
                                   qvel=torch.zeros(m.nv, 4),
                                   ctrl=torch.zeros(m.nu, 4)))
    for i in range(4):
        jd = jax_fk(jt.model, JData(qpos=jnp.asarray(qp[:, i]),
                                    qvel=jnp.zeros(m.nv), ctrl=jnp.zeros(m.nu),
                                    time=jnp.zeros(())))
        for got, want in ((d.xpos, jd.xpos), (d.xquat, jd.xquat),
                          (d.cdof, jd.cdof)):
            np.testing.assert_allclose(got[..., i].numpy(), np.asarray(want),
                                       rtol=0, atol=1e-12)
    # rooty's axis passes through the torso after the two slides moved it
    np.testing.assert_allclose(d.cdof[2, 3:, 0].numpy(), np.cross(
        d.xpos[1, :, 0].numpy(), d.cdof[2, :3, 0].numpy()), atol=1e-12)


def test_walker_step_matches_jax(walker, states):
    jt, pt, step = walker
    qp, qv, u = states
    act = pcon.contacts_active(pt.model, torch.from_numpy(qp)).numpy()
    assert act[:PLANE_CAPSULE].any(), "no floor contact"
    assert act[PLANE_CAPSULE:, -1].any(), "no capsule-capsule contact"
    pq, pv = step_state(pt.model, *map(torch.from_numpy, (qp, qv, u)))
    jq, jv = step(qp, qv, u)
    np.testing.assert_allclose(pq.numpy(), jq, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pv.numpy(), jv, rtol=0, atol=1e-7)
    close = np.abs(pv.numpy() - jv).max(0) < 1e-10
    assert close.mean() >= 0.5, close


def test_walker_contact_rows_match_jax(walker, states):
    jt, pt, _ = walker
    jm, m = jt.model, pt.model
    qp, qv, _ = states
    d = forward_kinematics(m, Data(qpos=torch.from_numpy(qp),
                                   qvel=torch.from_numpy(qv),
                                   ctrl=torch.zeros(m.nu, qp.shape[1])))
    rows = pcon._contact_rows(m, d)
    J = pcon.rows_jacobian(rows, m.nv).numpy()
    S = pcon.contact_constants(m).nslot
    perm = [blk * S + s for s in range(S) for blk in range(4)]
    seen = np.zeros(S, dtype=bool)
    for i in range(qp.shape[1]):
        jd = jax_fk(jm, JData(qpos=jnp.asarray(qp[:, i]),
                              qvel=jnp.asarray(qv[:, i]),
                              ctrl=jnp.zeros(m.nu), time=jnp.zeros(())))
        jr = jcon._contact_rows(jm, jd)
        np.testing.assert_allclose(J[..., i], np.asarray(jr.J)[perm],
                                   atol=1e-12, rtol=0)
        np.testing.assert_allclose(rows.R[:, i].numpy(),
                                   np.asarray(jr.R)[perm], rtol=1e-12)
        ja = np.asarray(jr.aref)[perm]
        np.testing.assert_allclose(rows.aref[:, i].numpy(), ja,
                                   rtol=1e-10, atol=1e-10 * np.abs(ja).max())
        act = rows.active[:, i].numpy()
        np.testing.assert_array_equal(act, np.asarray(jr.active)[perm])
        seen |= act[::4] > 0
    # floor slots and capsule-capsule slots among the active ones
    assert seen[:2 * PLANE_CAPSULE].any() and seen[2 * PLANE_CAPSULE:].any()


def test_walker_fd_columns_match_jax(walker, states):
    """At an interior state (off the floor, every leg joint inside its
    range: no row active) and at two with floor rows active, against
    `fd_job_columns`."""
    jt, pt, _ = walker
    m = pt.model
    qp, qv, u = states
    rng = np.random.default_rng(2)
    inner = pt.qpos_start.numpy().copy()
    inner[:3] = (0.5, 0.1, 0.2)
    inner[3:] = m.jnt_range[3:].mean(1).numpy()
    act = pcon.contacts_active(m, torch.from_numpy(qp)).numpy().any(0)
    touching = [int(k) for k in np.nonzero(act)[0][:2]]
    qp = np.concatenate([inner[:, None], qp[:, touching]], 1)
    qv = np.concatenate([0.01 * rng.standard_normal((m.nv, 1)),
                         qv[:, touching]], 1)
    u = np.concatenate([0.1 * rng.standard_normal((m.nu, 1)),
                        u[:, touching]], 1)
    d = forward_kinematics(m, Data(qpos=torch.from_numpy(qp[:, :1]),
                                   qvel=torch.from_numpy(qv[:, :1]),
                                   ctrl=torch.zeros(m.nu, 1)))
    rows = pcon.assemble_constraints(m, d)
    assert float(rows.active.abs().max()) == 0.0
    picks = [0, 1, 2]
    sel = lambda x: torch.from_numpy(x[:, picks])  # noqa: E731
    pj = fd_slot_jacobians(m, pt.sv, sel(qp), sel(qv), sel(u), EPS).numpy()
    cols = jax.jit(lambda a, b, c, d: fd_job_columns(jt.model, jt.sv, a, b, c,
                                                     d, EPS))
    n = pt.sv.ndof
    for i, k in enumerate(picks):
        jj = np.zeros_like(pj[..., i])
        for d in range(n):
            a_pos, a_vel, b_col = cols(qp[:, k], qv[:, k], u[:, k], d)
            jj[:, d], jj[:, n + d] = np.asarray(a_pos), np.asarray(a_vel)
            if d < m.nu:
                jj[:, 2 * n + d] = np.asarray(b_col)
        np.testing.assert_allclose(pj[..., i], jj, rtol=0,
                                   atol=1e-6 if i == 0 else 5e-3)


def test_walker_residual_and_cost_expansion_match_jax(walker, states):
    jt, pt, _ = walker
    qp, qv, u = states
    H = 4
    qpos = torch.from_numpy(qp[:, :H + 1].T.copy())[:, :, None]
    qvel = torch.from_numpy(qv[:, :H + 1].T.copy())[:, :, None]
    U = torch.from_numpy(u[:, :H].T.copy())[:, :, None]
    tg = pt.residual_targets[:, None]
    r = pt.residual_fn(qpos[:H, :, 0].T, qvel[:H, :, 0].T, U[:, :, 0].T, tg)
    got = planes.cost_expansion(pt, qpos, qvel, U, tg)

    @jax.jit
    def expansion(qp_, qv_, u_):
        rr, rx, ru = jax.vmap(
            lambda a, b, c: jbase.residual_derivatives(jt, a, b, c))(qp_, qv_,
                                                                     u_)
        return rr, jax.vmap(lambda a, x, v, t: jbase.cost_derivatives_gn(
            jt, a, x, v, t))(rr, rx, ru, jnp.arange(H) == H - 1)

    jr, want = expansion(qp[:, :H].T, qv[:, :H].T, u[:, :H].T)
    np.testing.assert_allclose(r.numpy().T, np.asarray(jr), rtol=0,
                               atol=1e-12)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[..., 0].numpy(), np.asarray(w),
                                   rtol=1e-12, atol=1e-12)


def test_walker_replan_phases_match_jax(walker):
    """One lane-last replan of walker_run (the executor's phases and K8's
    twin) held phase by phase: a whole JAX replan (`_build_lane_replan`)
    compiles for minutes under XLA:CPU (6.5 min at H = 8, far over a test's
    budget), so the JAX side is the compiled step, `backward_pass_lambda_loop` and the residual.  H = 6,
    one lane started 1 cm into the floor: the rollout 1e-9 (qpos) / 1e-7
    (qvel) per state as one step above, the backward pass on the port's own
    expansions 1e-8 relative (l_uu = 0, as at reaching), the applied step
    and its running cost 1e-9 / 1e-7 and 1e-9 relative."""
    from trajoptkp_tpu.solver import ilqr as jilqr
    from trajoptkp_tpu_torch.mpc import sync as psync
    from trajoptkp_tpu_torch.solver.ilqr import ILQRConfig

    jt, pt, step = walker
    H = 6
    pt = pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(min_N=1))
    rng = np.random.default_rng(5)
    qp = pt.qpos_start.numpy()[:, None].copy()
    qp[0] = -0.01
    qv = np.zeros((9, 1))
    U = 0.5 * rng.standard_normal((H, 6, 1))
    tg = pt.residual_targets.numpy()[:, None]
    cfg = ILQRConfig()
    ph = planes.lane_phases(pt, cfg, H)
    qpos, qvel, costs = ph["rollout"](*map(torch.from_numpy, (qp, qv, U, tg)))
    q, v = qp, qv
    for t in range(H):
        q, v = step(q, v, U[t])
        np.testing.assert_allclose(qpos[t + 1].numpy(), q, rtol=0, atol=1e-9)
        np.testing.assert_allclose(qvel[t + 1].numpy(), v, rtol=0, atol=1e-7)
    Ut = torch.from_numpy(U)
    A, Bm, pct, ovf = ph["jacobians"](qpos, qvel, Ut)
    assert float(pct[0]) == 100.0 and int(ovf[0]) == 0      # SI_1
    l = ph["cost_expansion"](qpos, qvel, Ut, torch.from_numpy(tg))
    lamb = torch.full((1,), cfg.lambda_init, dtype=torch.float64)
    k, K, dJ, lam, ex = ph["bp"](A, Bm, *l, lamb)
    jk, jK, jdJ, jlam, jex = jax.jit(
        lambda *a: jilqr.backward_pass_lambda_loop(*a, jilqr.ILQRConfig()))(
        A[..., 0].numpy(), Bm[..., 0].numpy(),
        *(x[..., 0].numpy() for x in l), jnp.asarray(cfg.lambda_init))
    assert bool(ex[0]) == bool(jex)
    np.testing.assert_allclose(float(lam[0]), float(jlam), rtol=1e-12)
    for got, want in ((k[..., 0], jk), (K[..., 0], jK)):
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                                   atol=1e-8 * scale)
    old = costs.sum(0)
    traj, _, best, accept = ph["fp"](qpos, qvel, Ut, old, k, K,
                                     torch.from_numpy(tg))
    z = torch.from_numpy(rng.standard_normal((1, 6, 1)))
    std = psync.noise_std(pt, 5.0)
    out = psync.apply_controls(pt, torch.from_numpy(qp), torch.from_numpy(qv),
                               Ut, traj[2], accept, best, old, z, std,
                               torch.from_numpy(tg))
    u = out[5][0].numpy()
    U_new = traj[2].numpy() if bool(accept[0]) else U
    np.testing.assert_array_equal(
        u, np.clip(U_new[0] + std.numpy()[:, None] * z[0].numpy(), -1, 1))
    jq, jv = step(qp, qv, u)
    np.testing.assert_allclose(out[0].numpy(), jq, rtol=0, atol=1e-9)
    np.testing.assert_allclose(out[1].numpy(), jv, rtol=0, atol=1e-7)
    jr = np.asarray(jt.residual_fn(jt.model, JData(
        qpos=jnp.asarray(qp[:, 0]), qvel=jnp.asarray(qv[:, 0]),
        ctrl=jnp.asarray(u[:, 0]), time=jnp.zeros(())), jt.residual_targets))
    np.testing.assert_allclose(float(out[6][0, 0]),
                               float(np.sum(np.asarray(jt.weights) * jr * jr)),
                               rtol=1e-9)
    np.testing.assert_array_equal(out[2][:-1].numpy(), U_new[1:])
