"""The port's joint-limit rows and constraint solve (dynamics/contact.py,
the plain twin of kernel K2a) against the JAX package on panda, and the
reaching task's constants against the JAX task.

Lanes: half start with every joint at one of its limits +- 0.01 N(0, 1), half
in the interior.  The recipe of tests/test_lanes.py:95-106 (2% inside the
range) never activates a row, because panda's limit margin is 0: a row is
active only beyond the limit.  Velocities (2 N) and controls (20 N) are
larger than there so that some lane's Newton iteration takes a step length
below 1; the test asserts both on the twin's own diagnostics.

Tolerances: rows 1e-12 relative (elementwise arithmetic on the same
constants); qfrc_constraint and qacc 1e-9 relative (both sides run 8 Newton
iterations; the stiff rows, 1/R ~ 1e2-1e3, amplify summation-order
differences of the mass matrix).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.dynamics import contact as jcontact
from trajoptkp_tpu.dynamics.model import Data as JData
from trajoptkp_tpu.dynamics.step import forward as jax_forward
from trajoptkp_tpu.tasks.reaching import make_reaching as jax_reaching
from trajoptkp_tpu_torch.dynamics import contact as pcontact
from trajoptkp_tpu_torch.dynamics.model import Data, load_model
from trajoptkp_tpu_torch.dynamics.step import forward
from trajoptkp_tpu_torch.tasks.reaching import make_reaching
from trajoptkp_tpu_torch.tasks.toys import make_acrobot

jax.config.update("jax_enable_x64", True)

L = 8


def limit_lanes(model, n, seed=2, qv_scale=2.0, ctrl_scale=20.0):
    """(qpos, qvel, ctrl), each (7, n): the first half at the limits."""
    rng = np.random.default_rng(seed)
    lo = model.jnt_range[:, 0].numpy()
    hi = model.jnt_range[:, 1].numpy()
    half = n // 2
    side = rng.integers(0, 2, (model.nq, half))
    qp = np.empty((model.nq, n))
    qp[:, :half] = np.where(side == 0, lo[:, None], hi[:, None]) \
        + 0.01 * rng.standard_normal((model.nq, half))
    qp[:, half:] = (0.5 * (lo + hi))[:, None] \
        + 0.3 * rng.standard_normal((model.nq, n - half))
    qv = qv_scale * rng.standard_normal((model.nv, n))
    ct = ctrl_scale * rng.standard_normal((model.nu, n))
    return qp, qv, ct


@pytest.fixture(scope="module")
def tasks():
    return jax_reaching(dtype=jnp.float64), make_reaching(device="cpu")


def _jdata(qp, qv, ct):
    return JData(qpos=jnp.asarray(qp), qvel=jnp.asarray(qv),
                 ctrl=jnp.asarray(ct), time=jnp.zeros(()))


def test_limit_rows_match_jax(tasks):
    jt, pt = tasks
    qp, qv, ct = limit_lanes(pt.model, L)
    rows = pcontact._limit_rows(pt.model, Data(
        qpos=torch.from_numpy(qp), qvel=torch.from_numpy(qv),
        ctrl=torch.from_numpy(ct)))
    J = pcontact.rows_jacobian(rows, pt.model.nv).numpy()
    assert rows.active.sum(0)[:L // 2].min() > 0     # every limit lane
    assert rows.active.sum(0)[L // 2:].max() == 0    # no interior lane
    for b in range(L):
        want = jcontact._limit_rows(jt.model, _jdata(qp[:, b], qv[:, b],
                                                     ct[:, b]))
        np.testing.assert_array_equal(J, np.asarray(want.J))
        np.testing.assert_array_equal(rows.active[:, b].numpy(),
                                      np.asarray(want.active))
        np.testing.assert_allclose(rows.aref[:, b].numpy(),
                                   np.asarray(want.aref), rtol=1e-12)
        np.testing.assert_allclose(rows.R[:, b].numpy(), np.asarray(want.R),
                                   rtol=1e-12)


def test_solve_constraints_matches_jax(tasks):
    jt, pt = tasks
    qp, qv, ct = limit_lanes(pt.model, L)
    diag = {}
    data = forward(pt.model, Data(qpos=torch.from_numpy(qp),
                                  qvel=torch.from_numpy(qv),
                                  ctrl=torch.from_numpy(ct)), diag)
    alphas = torch.stack(diag["alpha"])                # (8, L)
    active = diag["rows"].active.sum(0)
    assert int((active > 0).sum()) >= L // 2, active
    assert bool(((alphas > 0) & (alphas < 1)).any()), \
        f"no lane took a step length below 1: {alphas.tolist()}"
    assert bool((alphas == 1).any())

    @jax.jit
    def jforward(a, b, c):
        d = jax_forward(jt.model, _jdata(a, b, c))
        return d.qfrc_constraint, d.qacc

    for b in range(L):
        fc, qacc = jforward(qp[:, b], qv[:, b], ct[:, b])
        scale = max(float(np.abs(np.asarray(fc)).max()), 1.0)
        np.testing.assert_allclose(data.qfrc_constraint[:, b].numpy(),
                                   np.asarray(fc), rtol=1e-9,
                                   atol=1e-9 * scale)
        np.testing.assert_allclose(data.qacc[:, b].numpy(), np.asarray(qacc),
                                   rtol=1e-9, atol=1e-9 * scale)
    # interior lanes feel no constraint force
    assert float(data.qfrc_constraint[:, L // 2:].abs().max()) == 0.0


def test_unlimited_model_has_no_rows_and_contacts_are_refused():
    acro = make_acrobot(device="cpu").model
    d = Data(qpos=torch.zeros(2, 3), qvel=torch.zeros(2, 3),
             ctrl=torch.zeros(1, 3))
    assert pcontact.assemble_constraints(acro, d) is None
    out = forward(acro, d)
    assert out.qfrc_constraint is None
    assert not bool(pcontact.limits_active(acro, d.qpos).any())
    # pentabot's six capsule-capsule pairs are ported; a sphere in a pair
    # is not (the sphere pairs: ROADMAP, K2b's other pairs)
    penta = load_model("pentabot", device="cpu")
    assert pcontact.contact_constants(penta).nslot == 6
    g = penta.contact_pairs[0][0]
    boxed = penta.replace(geom_type=tuple(
        2 if i == g else t for i, t in enumerate(penta.geom_type)))
    with pytest.raises(NotImplementedError, match="K2b's other pairs"):
        pcontact.assemble_constraints(boxed, Data(
            qpos=torch.zeros(5, 1), qvel=torch.zeros(5, 1),
            ctrl=torch.zeros(3, 1)))


def test_limits_active_and_limit_constants(tasks):
    _, pt = tasks
    m = pt.model
    qp, _, _ = limit_lanes(m, L)
    act = pcontact.limits_active(m, torch.from_numpy(qp))
    assert act[:L // 2].all() and not act[L // 2:].any()
    lc = pcontact.limit_constants(m)
    assert lc.joints == tuple(range(7)) and lc.int_power
    assert pcontact.limit_constants(m) is lc           # cached per model
    tab = dict(zip(pcontact.LIMIT_FIELDS, lc.table.T.numpy()))
    np.testing.assert_array_equal(tab["lo"], m.jnt_range[:, 0].numpy())
    np.testing.assert_array_equal(tab["power"], m.jnt_solimp[:, 4].numpy())
    np.testing.assert_allclose(
        tab["b"], 2.0 / (m.jnt_solimp[:, 1] * m.jnt_solref[:, 0]).numpy(),
        rtol=1e-15)


def test_reaching_task_matches_jax(tasks):
    jt, pt = tasks
    assert pt.name == jt.name and pt.residual_names == jt.residual_names
    assert pt.openloop_horizon == jt.openloop_horizon == 1500
    assert pt.mpc_horizon == jt.mpc_horizon
    assert pt.residual_kind == ("joint_space", 7, 0) and pt.nres == 14
    for f in ("residual_targets", "weights", "weights_terminal", "qpos_start",
              "qvel_start"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    kp, jkp = pt.keypoint_cfg, jt.keypoint_cfg
    assert (kp.name, kp.min_N, kp.max_N) == (jkp.name, jkp.min_N, jkp.max_N)
    for f in ("jerk_thresholds", "accel_thresholds",
              "velocity_change_thresholds"):
        np.testing.assert_array_equal(getattr(kp, f).numpy(),
                                      np.asarray(getattr(jkp, f)))
    rng = np.random.default_rng(0)
    qp, qv, ct = (rng.standard_normal((7, 3)) for _ in range(3))
    tg = np.repeat(pt.residual_targets.numpy()[:, None], 3, axis=1)
    r = pt.residual_fn(*map(torch.from_numpy, (qp, qv, ct, tg)))
    done, dist = pt.task_complete_fn(torch.from_numpy(qp),
                                     torch.from_numpy(tg))
    for b in range(3):
        d = _jdata(qp[:, b], qv[:, b], ct[:, b])
        np.testing.assert_allclose(
            r[:, b].numpy(),
            np.asarray(jt.residual_fn(jt.model, d, jt.residual_targets)),
            rtol=1e-15)
        jdone, jdist = jt.task_complete_fn(jt.model, d, jt.residual_targets)
        assert bool(done[b]) == bool(jdone)
        np.testing.assert_allclose(float(dist[b]), float(jdist), rtol=1e-14)
