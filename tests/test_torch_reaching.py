"""Reaching (panda, seven limited hinges) through the port's solver phases
on the plain path, phase by phase against the JAX package with cheap jits
only: one jitted `step_state`, one jitted `fd_job_columns`, the residual
expansion and the generic backward pass.  A whole JAX solve at panda width
does not compile on the CPU in minutes (the generic `optimise`, H = 30, had
not finished after 6.5 minutes; a vmapped `step_state` not after 20), so the
whole-solve parity runs on a limited acrobot (tests/test_torch_limits.py).

Scenes: lane 0 starts at the task's start, lane 1 with joint 3 beyond its
upper limit and joint 1 beyond its lower one, so limit rows are active from
the first step; controls 5 N(0, 1) Nm.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.derivs.fd import fd_job_columns
from trajoptkp_tpu.dynamics import step_state as jax_step_state
from trajoptkp_tpu.dynamics.model import Data as JData
from trajoptkp_tpu.solver import ilqr as jilqr
from trajoptkp_tpu.tasks import base as jbase
from trajoptkp_tpu.tasks.reaching import make_reaching as jax_reaching
from trajoptkp_tpu_torch.dynamics.contact import limits_active
from trajoptkp_tpu_torch.solver import ilqr as pilqr
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.tasks.reaching import make_reaching

jax.config.update("jax_enable_x64", True)

H, NLANE = 20, 2


@pytest.fixture(scope="module")
def setup():
    jt = jax_reaching(dtype=jnp.float64)
    pt = make_reaching(device="cpu")
    pt = pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(
        name="set_interval", min_N=4))
    rng = np.random.default_rng(4)
    qp = np.repeat(pt.qpos_start.numpy()[:, None], NLANE, axis=1)
    qp[3, 1] = float(pt.model.jnt_range[3, 1]) + 0.03
    qp[1, 1] = float(pt.model.jnt_range[1, 0]) - 0.02
    qv = 0.3 * rng.standard_normal((7, NLANE))
    U = 5.0 * rng.standard_normal((H, 7, NLANE))
    tg = np.repeat(pt.residual_targets.numpy()[:, None], NLANE, axis=1)
    qpos, qvel, costs = pilqr.rollout(pt, *map(torch.from_numpy,
                                               (qp, qv, U, tg)))
    jstep = jax.jit(lambda a, b, c: jax_step_state(jt.model, a, b, c))
    return dict(jt=jt, pt=pt, qp=qp, qv=qv, U=U, tg=tg, qpos=qpos, qvel=qvel,
                costs=costs, jstep=jstep)


def _jres(jt, q, v, u):
    d = JData(qpos=jnp.asarray(q), qvel=jnp.asarray(v), ctrl=jnp.asarray(u),
              time=jnp.zeros(()))
    return np.asarray(jt.residual_fn(jt.model, d, jt.residual_targets))


def test_rollout_matches_jax_step_loop(setup):
    """States to rtol 1e-9 / atol 1e-11 per step compounded over 20 steps
    (1e-8 / 1e-10), costs to 1e-9 relative."""
    s = setup
    jt, pt = s["jt"], s["pt"]
    act = limits_active(pt.model, s["qpos"][:H].transpose(0, 1))
    assert not act[:, 0].all() and act[0, 1]      # lane 1 starts in a limit
    for b in range(NLANE):
        q, v = s["qp"][:, b], s["qv"][:, b]
        for t in range(H):
            r = _jres(jt, q, v, s["U"][t, :, b])
            w = np.asarray(jt.weights_terminal if t == H - 1 else jt.weights)
            np.testing.assert_allclose(float(s["costs"][t, b]),
                                       float(np.sum(w * r * r)), rtol=1e-9)
            q, v = s["jstep"](q, v, s["U"][t, :, b])
            np.testing.assert_allclose(s["qpos"][t + 1, :, b].numpy(),
                                       np.asarray(q), rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(s["qvel"][t + 1, :, b].numpy(),
                                       np.asarray(v), rtol=1e-8, atol=1e-10)


def test_slot_jacobians_match_jax_fd(setup):
    """[A|B] at two keypoint slots of the lane that stays inside its limits,
    against `fd_job_columns`: atol 1e-6 (FD noise at seven links).  The
    row-active case and its looser bar are in tests/test_torch_derivs.py."""
    s = setup
    jt, pt = s["jt"], s["pt"]
    plan = planes.si_plan(pt, H)
    A, Bm = planes.jacobians_si(pt, plan, s["qpos"], s["qvel"],
                                torch.from_numpy(s["U"]),
                                planes.slot_jacobians(pt, "fd", eps=1e-6))
    cols = jax.jit(lambda a, b, c, d: fd_job_columns(jt.model, jt.sv, a, b, c,
                                                     d, 1e-6))
    act = limits_active(pt.model, s["qpos"][:H].transpose(0, 1))
    slots = [int(t) for t in plan.times.tolist() if not bool(act[t, 0])][:2]
    assert len(slots) == 2
    for t in slots:
        for d in range(7):
            a_pos, a_vel, b_col = cols(s["qpos"][t, :, 0].numpy(),
                                       s["qvel"][t, :, 0].numpy(),
                                       s["U"][t, :, 0], d)
            for got, want in ((A[t, :, d, 0], a_pos), (A[t, :, 7 + d, 0], a_vel),
                              (Bm[t, :, d, 0], b_col)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=0, atol=1e-6)


def _expansions(s):
    pt = s["pt"]
    U = torch.from_numpy(s["U"])
    plan = planes.si_plan(pt, H)
    A, Bm = planes.jacobians_si(pt, plan, s["qpos"], s["qvel"], U,
                                planes.slot_jacobians(pt, "fd", eps=1e-6))
    l = planes.cost_expansion(pt, s["qpos"], s["qvel"], U,
                              torch.from_numpy(s["tg"]))
    return A, Bm, l


def test_cost_expansion_matches_jax(setup):
    """l_x, l_xx, l_u, l_uu at 1e-12: the residual is linear.  nres = 14 is
    not 2 nv + nu = 21, and l_u, l_uu are exactly zero."""
    s = setup
    jt = s["jt"]
    _, _, got = _expansions(s)
    assert float(got[2].abs().max()) == 0.0 and float(got[3].abs().max()) == 0.0

    @jax.jit
    def expansion(qp, qv, u):
        r, rx, ru = jax.vmap(
            lambda a, b, c: jbase.residual_derivatives(jt, a, b, c))(qp, qv, u)
        return jax.vmap(lambda a, x, v, t: jbase.cost_derivatives_gn(
            jt, a, x, v, t))(r, rx, ru, jnp.arange(H) == H - 1)

    for b in range(NLANE):
        want = expansion(s["qpos"][:H, :, b].numpy(),
                         s["qvel"][:H, :, b].numpy(), s["U"][:, :, b])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[..., b].numpy(), np.asarray(w),
                                       rtol=1e-12, atol=1e-12)


def test_backward_pass_matches_jax(setup):
    """The port's λ loop (twin of K7, instance nx 14, nu 7) on reaching's own
    expansions against JAX `backward_pass_lambda_loop` per lane, 1e-8
    relative: with l_uu = 0, Q_uu = B'V'B + λI is ill-conditioned and
    amplifies the summation-order differences of the two sweeps (measured
    ~1e-10).  The JAX jit takes a few seconds."""
    s = setup
    A, Bm, l = _expansions(s)
    cfg = pilqr.ILQRConfig()
    lamb = torch.full((NLANE,), cfg.lambda_init, dtype=torch.float64)
    k, K, dJ, lam, ex = pilqr.backward_pass_lambda_loop(A, Bm, *l, lamb, cfg)
    jcfg = jilqr.ILQRConfig()
    t0 = time.perf_counter()
    jbp = jax.jit(lambda *a: jilqr.backward_pass_lambda_loop(*a, jcfg))
    for b in range(NLANE):
        jk, jK, jdJ, jlam, jex = jbp(
            A[..., b].numpy(), Bm[..., b].numpy(),
            *(x[..., b].numpy() for x in l), jnp.asarray(cfg.lambda_init))
        assert bool(ex[b]) == bool(jex) is False
        np.testing.assert_allclose(float(lam[b]), float(jlam), rtol=1e-12)
        for got, want in ((k[..., b], jk), (K[..., b], jK), (dJ[b], jdJ)):
            scale = float(np.abs(np.asarray(want)).max())
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-8, atol=1e-8 * scale)
    assert time.perf_counter() - t0 < 60.0


def test_line_search_rollouts_match_jax_step_loop(setup):
    """The port's line-search rollouts (twin of K4) under
    u = clip(u_nom + alpha k + K dx), against a loop over the jitted JAX step
    with the feedback law written out in numpy; states 1e-8 / 1e-10, costs
    1e-9.  (JAX `forward_pass` vmaps the panda step over the alphas, which
    does not compile here in minutes.)"""
    s = setup
    jt, pt = s["jt"], s["pt"]
    rng = np.random.default_rng(9)
    k = 0.5 * rng.standard_normal((H, 7, NLANE))
    K = 0.5 * rng.standard_normal((H, 7, 14, NLANE))
    alphas = torch.tensor([1.0, 0.25], dtype=torch.float64)
    qps, qvs, us, cs = pilqr.forward_pass_rollouts(
        pt, s["qpos"], s["qvel"], torch.from_numpy(s["U"]),
        torch.from_numpy(k), torch.from_numpy(K), alphas,
        torch.from_numpy(s["tg"]))
    lim = np.asarray(jbase.control_limits(jt))
    b = 1                                            # the lane in its limits
    for a, alpha in enumerate(alphas.tolist()):
        q, v = s["qp"][:, b], s["qv"][:, b]
        for t in range(H):
            dx = np.concatenate([np.asarray(q) - s["qpos"][t, :, b].numpy(),
                                 np.asarray(v) - s["qvel"][t, :, b].numpy()])
            u = np.clip(s["U"][t, :, b] + alpha * k[t, :, b]
                        + K[t, :, :, b] @ dx, lim[:, 0], lim[:, 1])
            np.testing.assert_allclose(us[t, :, a, b].numpy(), u, rtol=1e-8,
                                       atol=1e-9)
            r = _jres(jt, q, v, u)
            w = np.asarray(jt.weights_terminal if t == H - 1 else jt.weights)
            np.testing.assert_allclose(float(cs[t, a, b]),
                                       float(np.sum(w * r * r)), rtol=1e-8)
            q, v = s["jstep"](q, v, u)
            np.testing.assert_allclose(qps[t + 1, :, a, b].numpy(),
                                       np.asarray(q), rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(qvs[t + 1, :, a, b].numpy(),
                                       np.asarray(v), rtol=1e-8, atol=1e-10)
