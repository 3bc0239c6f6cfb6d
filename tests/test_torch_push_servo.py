"""push_ncl's task layer against the JAX task (`trajoptkp_tpu/tasks/pushing.py`),
float64: the FK residual and its forward-mode Jacobian over the reduced
state vector (the cost expansion's input), the scene generator, the
end-effector waypoint paths and the Jacobian-pseudo-inverse servo that makes
the initial controls.

Tolerances: residuals 1e-12 and their Jacobians 1e-10 absolute (the same FK
formulas in another summation order); scenes exactly (the same numpy draws);
paths 1e-12; the servo over a 10-step path (JAX `_servo_along_path`, a
scan that compiles the push step once, ~90 s here) 1e-8 relative on the
controls and 1e-10 absolute on the end state (`torch.linalg.pinv` and
`jnp.linalg.pinv` factor the 6x7 Jacobian by different SVD routines).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.dynamics.fk import forward_kinematics as jax_fk
from trajoptkp_tpu.dynamics.model import Data as JData
from trajoptkp_tpu.tasks import pushing as jpush
from trajoptkp_tpu.tasks.base import residual_derivatives as jax_rderiv
from trajoptkp_tpu.tasks.base import residuals_at as jax_residuals_at
from trajoptkp_tpu_torch.tasks import pushing
from trajoptkp_tpu_torch.tasks.base import (residual_derivatives,
                                            residuals_at)

jax.config.update("jax_enable_x64", True)

SERVO_STEPS = 10


@pytest.fixture(scope="module")
def push():
    return jpush.make_pushing(0), pushing.make_pushing(device="cpu")


def _states(pt, n=3, seed=0):
    """Arm around its start, the goal tilted at random on the table,
    random velocities -> qpos (nq, n), qvel (nv, n), ctrl (nu, n)."""
    m = pt.model
    rng = np.random.default_rng(seed)
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    q = np.tile(pt.qpos_start.numpy()[:, None], (1, n))
    q[:7] += 0.2 * rng.standard_normal((7, n))
    for i in range(n):
        quat = rng.standard_normal(4)
        q[qa:qa + 7, i] = np.concatenate([rng.uniform(0.3, 0.7, 2), [0.04],
                                          quat / np.linalg.norm(quat)])
    return (q, rng.standard_normal((m.nv, n)),
            rng.standard_normal((m.nu, n)))


def test_push_residual_and_jacobian_match_jax(push):
    jt, pt = push
    qp, qv, u = _states(pt)
    targets = pt.residual_targets[:, None]
    r = residuals_at(pt, *map(torch.from_numpy, (qp, qv, u)), targets)
    assert r.shape == (4, qp.shape[1])
    for i in range(qp.shape[1]):
        args = tuple(x[:, i] for x in (qp, qv, u))
        jr = jax_residuals_at(jt, *map(jnp.asarray, args))
        np.testing.assert_allclose(r[:, i].numpy(), np.asarray(jr),
                                   atol=1e-12, rtol=0)
        pr, prx, pru = residual_derivatives(pt, *map(torch.from_numpy, args))
        jr, jrx, jru = jax_rderiv(jt, *map(jnp.asarray, args))
        assert prx.shape == (4, pt.sv.nx)
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), atol=1e-12)
        np.testing.assert_allclose(prx.numpy(), np.asarray(jrx), atol=1e-10)
        np.testing.assert_allclose(pru.numpy(), np.asarray(jru), atol=1e-10)


def test_push_scenes_match_the_jax_generator(push):
    jt, pt = push
    gen = jpush._make_push_scene_generator(False, 0)
    jrng, prng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(6):
        robot, bodies, targets = gen(jt, jrng)
        start, tg = pushing.scene(prng)
        np.testing.assert_array_equal(np.asarray(start), bodies[0][:2])
        np.testing.assert_array_equal(np.asarray(tg), targets)
        np.testing.assert_array_equal(robot, pt.qpos_start.numpy()[:7])
    qp, qv, tg = pushing.push_scenes(pt, 4, seed=5)
    jrng = np.random.default_rng(5)
    for i in range(4):
        _, bodies, targets = gen(jt, jrng)
        np.testing.assert_array_equal(qp[i, 7:9].numpy(), bodies[0][:2])
        np.testing.assert_array_equal(tg[i].numpy(), targets)


def _jax_data(jt, q):
    return jax_fk(jt.model, JData(qpos=jnp.asarray(q), qvel=jnp.zeros(13),
                                  ctrl=jnp.zeros(7), time=jnp.zeros(())))


def test_push_paths_match_jax(push):
    jt, pt = push
    qp, _, tg = pushing.push_scenes(pt, 2, seed=1)
    H = 50
    path, angle = pushing.ee_waypoint_path(pt, H, qp.T, tg.T)
    for i in range(2):
        t = jt.replace(residual_targets=jnp.asarray(tg[i].numpy()))
        jpath, jangle = jpush.ee_waypoint_path(t, H, _jax_data(t, qp[i]))
        np.testing.assert_allclose(path[..., i].numpy(), np.asarray(jpath),
                                   atol=1e-12, rtol=0)
        assert abs(float(angle[i]) - float(jangle)) < 1e-12


def test_servo_matches_jax(push):
    """The setup servo's first SERVO_STEPS steps from two scenes: the port
    batched over the scenes (lanes last, the plain step on the CPU), JAX
    `_servo_along_path` one scene at a time."""
    jt, pt = push
    qp, qv, tg = pushing.push_scenes(pt, 2, seed=2)
    path, angle = pushing.setup_path(pt, pushing.SETUP_STEPS, qp.T, tg.T)
    path = path[:SERVO_STEPS]
    U, qe, ve = pushing.servo_along_path(pt, path, angle, qp.T.contiguous(),
                                         qv.T.contiguous(), tg.T.contiguous())
    assert U.shape == (SERVO_STEPS, 7, 2)
    for i in range(2):
        t = jt.replace(residual_targets=jnp.asarray(tg[i].numpy()))
        jU, jq, jv = jpush._servo_along_path(
            t, jnp.asarray(path[..., i].numpy()), jnp.asarray(float(angle[i])),
            jnp.asarray(qp[i].numpy()), jnp.asarray(qv[i].numpy()))
        np.testing.assert_allclose(U[..., i].numpy(), np.asarray(jU),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(qe[:, i].numpy(), np.asarray(jq),
                                   atol=1e-10, rtol=0)
        np.testing.assert_allclose(ve[:, i].numpy(), np.asarray(jv),
                                   atol=1e-10, rtol=0)


def test_cli_runs_push_from_its_servo(monkeypatch, capsys):
    """`app --task pushing_no_clutter` starts from the setup servo's end
    state and the init servo's controls (the JAX app's
    `_batch_init_controls`); the setup servo is cut to 5 steps here (1000
    on the card)."""
    import functools
    import json

    from trajoptkp_tpu_torch import app

    monkeypatch.setattr(pushing, "create_init_setup_controls",
                        functools.partial(pushing.create_init_setup_controls,
                                          horizon=5))
    app.main(["--device", "cpu", "--task", "pushing_no_clutter",
              "--keypoint", "SI_2", "--horizon", "6", "--maxIter", "2",
              "--minIter", "2"])
    out = capsys.readouterr().out
    assert "init controls (setup and init servo)" in out
    res = json.loads(out.strip().splitlines()[-1])
    assert res["task"] == "push_ncl" and res["horizon"] == 6
    assert res["iterations"] == 2 and res["init_controls_s"] > 0
    assert res["final_cost"] <= res["initial_cost"]
