"""Port step (plain path, batch last) against the JAX generic step and the
JAX lane step, at the 1e-10 bar of tests/test_lanes.py (both sides float64;
the differences are summation order only).

Pentabot's six capsule self-contact pairs are not ported (ROADMAP Queue 1
item 7b): both sides run it with `contact_pairs=()`.

Panda (reaching) adds three bodies without a joint and seven limited hinges:
its step runs the joint-limit constraint solve, held to rtol 1e-9 / atol
1e-11, the bar of tests/test_lanes.py:114-117 for the JAX lane engine's own
limit solve (the stiff rows amplify summation-order differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.dynamics import step_state as jax_step_state
from trajoptkp_tpu.dynamics.fk import forward_kinematics as jax_fk
from trajoptkp_tpu.dynamics.lanes import build_smooth_step
from trajoptkp_tpu.dynamics.model import Data as JData
from trajoptkp_tpu.dynamics.smooth import \
    fwd_velocity_smooth as jax_fwd_velocity_smooth
from trajoptkp_tpu.tasks.reaching import make_reaching
from trajoptkp_tpu.tasks.toys import make_acrobot, make_pentabot
from trajoptkp_tpu_torch.dynamics.fk import cinert_matrix, forward_kinematics
from trajoptkp_tpu_torch.dynamics.model import Data, load_model
from trajoptkp_tpu_torch.dynamics.smooth import fwd_velocity_smooth
from trajoptkp_tpu_torch.dynamics.step import step_state

jax.config.update("jax_enable_x64", True)

CASES = [("acrobot", make_acrobot), ("pentabot", make_pentabot)]
RTOL, ATOL = 1e-10, 1e-12


def _models(name, make):
    jm = make(dtype=jnp.float64).model.replace(contact_pairs=())
    pm = load_model(name, device="cpu").replace(contact_pairs=())
    return jm, pm


def _states(model, L, seed=0):
    rng = np.random.default_rng(seed)
    qp = rng.standard_normal((model.nq, L))
    qv = 0.5 * rng.standard_normal((model.nv, L))
    ct = 2.0 * rng.standard_normal((model.nu, L))
    return qp, qv, ct


@pytest.mark.parametrize("name,make", CASES)
def test_step_matches_jax_generic_and_lane(name, make):
    jm, pm = _models(name, make)
    qp, qv, ct = _states(jm, 16)
    qp2, qv2 = step_state(pm, torch.from_numpy(qp), torch.from_numpy(qv),
                          torch.from_numpy(ct))
    ref = jax.vmap(lambda a, b, c: jax_step_state(jm, a, b, c),
                   in_axes=1, out_axes=1)(qp, qv, ct)
    lane = jax.jit(build_smooth_step(jm))(jnp.asarray(qp), jnp.asarray(qv),
                                          jnp.asarray(ct))
    for got, want in ((qp2, ref[0]), (qv2, ref[1]), (qp2, lane[0]),
                      (qv2, lane[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,make", CASES)
def test_fk_matches_jax(name, make):
    jm, pm = _models(name, make)
    qp, qv, ct = _states(jm, 1, seed=3)
    d = forward_kinematics(pm, Data(qpos=torch.from_numpy(qp[:, 0]),
                                    qvel=torch.from_numpy(qv[:, 0]),
                                    ctrl=torch.from_numpy(ct[:, 0])))
    jd = jax_fk(jm, JData(qpos=jnp.asarray(qp[:, 0]),
                          qvel=jnp.asarray(qv[:, 0]),
                          ctrl=jnp.asarray(ct[:, 0]), time=jnp.zeros(())))
    d = d.replace(cinert=cinert_matrix(d.cinert))
    for f in ("xpos", "xquat", "xipos", "ximat", "site_xpos", "cdof",
              "cinert"):
        np.testing.assert_allclose(getattr(d, f).numpy(),
                                   np.asarray(getattr(jd, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def _panda_lanes(pm, n, seed=2):
    """Half the lanes with every joint at a limit +- 0.01 N (rows active:
    panda's margin is 0), half interior; qvel ~ 0.5 N, ctrl ~ 2 N."""
    rng = np.random.default_rng(seed)
    lo, hi = pm.jnt_range[:, 0].numpy(), pm.jnt_range[:, 1].numpy()
    half = n // 2
    side = rng.integers(0, 2, (pm.nq, half))
    qp = np.empty((pm.nq, n))
    qp[:, :half] = np.where(side == 0, lo[:, None], hi[:, None]) \
        + 0.01 * rng.standard_normal((pm.nq, half))
    qp[:, half:] = (0.5 * (lo + hi))[:, None] \
        + 0.3 * rng.standard_normal((pm.nq, n - half))
    return (qp, 0.5 * rng.standard_normal((pm.nv, n)),
            2.0 * rng.standard_normal((pm.nu, n)))


def test_panda_step_with_limits_matches_jax_generic_and_lane():
    from trajoptkp_tpu_torch.dynamics.contact import limits_active

    jm = make_reaching(dtype=jnp.float64).model
    pm = load_model("panda", device="cpu")
    n = 8
    qp, qv, ct = _panda_lanes(pm, n)
    assert int(limits_active(pm, torch.from_numpy(qp)).sum()) >= n // 2
    qp2, qv2 = step_state(pm, torch.from_numpy(qp), torch.from_numpy(qv),
                          torch.from_numpy(ct))
    gstep = jax.jit(lambda a, b, c: jax_step_state(jm, a, b, c))
    ref = [gstep(qp[:, i], qv[:, i], ct[:, i]) for i in range(n)]
    lane = jax.jit(build_smooth_step(jm))(jnp.asarray(qp), jnp.asarray(qv),
                                          jnp.asarray(ct))
    for got, want in ((qp2, np.stack([r[0] for r in ref], 1)),
                      (qv2, np.stack([r[1] for r in ref], 1)),
                      (qp2, lane[0]), (qv2, lane[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-9, atol=1e-11)


def test_panda_smooth_dynamics_with_jointless_bodies_match_jax():
    """world, panda_link0 and panda_hand carry no joint: their inertia and
    force reach the mass matrix and the bias through their parents."""
    jm = make_reaching(dtype=jnp.float64).model
    pm = load_model("panda", device="cpu")
    assert sorted(set(range(pm.nbody)) - set(pm.jnt_bodyid)) == [0, 1, 9]
    qp, qv, ct = _panda_lanes(pm, 4, seed=5)
    d = fwd_velocity_smooth(pm, forward_kinematics(pm, Data(
        qpos=torch.from_numpy(qp), qvel=torch.from_numpy(qv),
        ctrl=torch.from_numpy(ct))))
    for b in range(4):
        jd = JData(qpos=jnp.asarray(qp[:, b]), qvel=jnp.asarray(qv[:, b]),
                   ctrl=jnp.asarray(ct[:, b]), time=jnp.zeros(()))
        jd = jax_fwd_velocity_smooth(jm, jax_fk(jm, jd))
        for f in ("qM", "qfrc_bias", "qfrc_passive", "qfrc_actuator"):
            np.testing.assert_allclose(getattr(d, f)[..., b].numpy(),
                                       np.asarray(getattr(jd, f)),
                                       rtol=1e-10, atol=1e-10, err_msg=f)


def test_step_refuses_constraints():
    """A contact pair the port has no collider for (a box: ROADMAP Queue 1
    item 7b) is refused; pentabot's own capsule pairs are ported."""
    pm = load_model("pentabot", device="cpu")
    g = pm.contact_pairs[0][0]
    boxed = pm.replace(geom_type=tuple(
        6 if i == g else t for i, t in enumerate(pm.geom_type)))
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        step_state(boxed, torch.zeros(5, 1), torch.zeros(5, 1),
                   torch.zeros(3, 1))
    qn, vn = step_state(pm, torch.zeros(5, 1), torch.zeros(5, 1),
                        torch.zeros(3, 1))
    assert bool(torch.isfinite(qn).all() and torch.isfinite(vn).all())
