"""Set-interval keypoint Jacobians: the port's FD slot Jacobians plus lerp
(solver/lanes.py:jacobians_si on the plain path) against the JAX engine's
`keypoint_jacobians` in fd mode plus `interpolate_derivatives`, per scene.

Both sides take central differences with eps 1e-6 in float64, so they
differ by FD noise: step rounding divided by 2 eps.  Acrobot meets 1e-8
absolute.  Pentabot's five-link mass matrix amplifies the rounding: there
the JAX engine's own FD columns lie 5.5e-8 from its exact forward-mode
Jacobian, and the bar is 1e-7, set from that noise floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.derivs.fd import jobs_from_mask, keypoint_jacobians
from trajoptkp_tpu.keypoints.interpolate import \
    interpolate_derivatives as jax_interp
from trajoptkp_tpu.keypoints.methods import set_interval as jax_si
from trajoptkp_tpu.tasks import toys as jtoys
from trajoptkp_tpu_torch.keypoints.interpolate import interpolate_derivatives
from trajoptkp_tpu_torch.keypoints.methods import set_interval
from trajoptkp_tpu_torch.solver import ilqr as pilqr
from trajoptkp_tpu_torch.solver import lanes as planes
from trajoptkp_tpu_torch.tasks import toys as ptoys

jax.config.update("jax_enable_x64", True)

H, NLANE = 20, 2


@pytest.mark.parametrize("name,min_N,atol",
                         [("acrobot", 3, 1e-8), ("pentabot", 4, 1e-7)])
def test_si_jacobians_match_jax_fd(name, min_N, atol):
    jt = getattr(jtoys, f"make_{name}")(dtype=jnp.float64)
    jm = jt.model.replace(contact_pairs=())
    pt = getattr(ptoys, f"make_{name}")(device="cpu")
    pt = pt.replace(keypoint_cfg=pt.keypoint_cfg.replace(
        name="set_interval", min_N=min_N))
    nq, nu, n = pt.model.nq, pt.model.nu, pt.sv.ndof
    rng = np.random.default_rng(5)
    qp = pt.qpos_start.numpy()[:, None] + 0.3 * rng.standard_normal((nq, NLANE))
    qv = 0.2 * rng.standard_normal((nq, NLANE))
    U = 0.5 * rng.standard_normal((H, nu, NLANE))
    tg = np.repeat(pt.residual_targets.numpy()[:, None], NLANE, axis=1)
    qpos, qvel, _ = pilqr.rollout(pt, *map(torch.from_numpy, (qp, qv, U, tg)))
    plan = planes.si_plan(pt, H)
    A, Bm = planes.jacobians_si(pt, plan, qpos, qvel, torch.from_numpy(U),
                                planes.slot_jacobians(pt, "fd", eps=1e-6))

    mask = jax_si(H, n, min_N)
    jobs = jobs_from_mask(mask, int(mask.sum()))
    np.testing.assert_array_equal(set_interval(H, n, min_N).numpy(),
                                  np.asarray(mask))
    for b in range(NLANE):
        A_kp, B_kp, _ = keypoint_jacobians(
            jm, jt.sv, jnp.asarray(qpos[:H, :, b].numpy()),
            jnp.asarray(qvel[:H, :, b].numpy()), jnp.asarray(U[:, :, b]),
            jobs, eps=1e-6, mode="fd")
        jA, jB = jax_interp(A_kp, B_kp, mask, nu)
        np.testing.assert_allclose(A[..., b].numpy(), np.asarray(jA),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(Bm[..., b].numpy(), np.asarray(jB),
                                   rtol=0, atol=atol)
        # the port's per-dof interpolation gives the same from the same slots
        pA, pB = interpolate_derivatives(torch.tensor(np.asarray(A_kp)),
                                         torch.tensor(np.asarray(B_kp)),
                                         set_interval(H, n, min_N), nu)
        np.testing.assert_allclose(pA.numpy(), np.asarray(jA), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(pB.numpy(), np.asarray(jB), rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("name", ["acrobot", "pentabot"])
def test_cost_expansion_matches_jax(name):
    """Gauss-Newton l_x, l_xx, l_u, l_uu: the lane phase (solver/lanes.py,
    jacfwd over (nres, H, B)) and the one-state `residual_derivatives` +
    `cost_derivatives_gn` against JAX's, at 1e-12 relative (the residual is
    linear, so both Jacobians are exact)."""
    from trajoptkp_tpu.tasks import base as jbase
    from trajoptkp_tpu_torch.tasks import base as pbase

    jt = getattr(jtoys, f"make_{name}")(dtype=jnp.float64)
    pt = getattr(ptoys, f"make_{name}")(device="cpu")
    nq, nu = pt.model.nq, pt.model.nu
    rng = np.random.default_rng(7)
    qpos = rng.standard_normal((H + 1, nq, NLANE))
    qvel = rng.standard_normal((H + 1, nq, NLANE))
    U = rng.standard_normal((H, nu, NLANE))
    tg = np.repeat(pt.residual_targets.numpy()[:, None], NLANE, axis=1)
    got = planes.cost_expansion(pt, *map(torch.from_numpy, (qpos, qvel, U, tg)))
    @jax.jit
    def expansion(qp, qv, u):
        r, rx, ru = jax.vmap(
            lambda a, b, c: jbase.residual_derivatives(jt, a, b, c))(qp, qv, u)
        return jax.vmap(lambda a, x, v, t: jbase.cost_derivatives_gn(
            jt, a, x, v, t))(r, rx, ru, jnp.arange(H) == H - 1)

    for b in range(NLANE):
        want = expansion(qpos[:H, :, b], qvel[:H, :, b], U[:, :, b])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[..., b].numpy(), np.asarray(w),
                                       rtol=1e-12, atol=1e-12)
        one = pbase.cost_derivatives_gn(pt, *pbase.residual_derivatives(
            pt, torch.from_numpy(qpos[H - 1, :, b]),
            torch.from_numpy(qvel[H - 1, :, b]),
            torch.from_numpy(U[H - 1, :, b])), terminal=True)
        for g, w in zip(one, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w[H - 1]),
                                       rtol=1e-12, atol=1e-12)


def test_panda_fd_columns_match_jax_with_limits():
    """Reaching's [A|B] by central FD of the constrained step at 4 states
    away from the joint limits and 2 with one joint 0.02 rad beyond a limit
    (a row active), against the JAX engine's `fd_job_columns`, column by
    column.

    Interior: atol 1e-6 (FD noise at seven links; measured 1.1e-9).  With a
    row active: atol 1e-3 against entries up to ~17 (measured 1.1e-4).  There
    the step runs 8 Newton iterations whose step lengths and `y < 0` gates
    are branches: the two packages' steps agree to ~1e-12 at the nominal
    state (tests/test_torch_step.py), but a +-1e-6 perturbation can land the
    two on different branches of the not fully converged solve, and central
    FD divides that ~1e-10 jump by 2e-6.  The JAX package differentiates
    this solve by the implicit-function rule for that reason
    (`dynamics/contact.py:94-107`); the port's kernel and twin take the same
    branches bit for bit (chip_smoke.py), so the port's FD is consistent
    with its own rollouts."""
    from trajoptkp_tpu.derivs.fd import fd_job_columns
    from trajoptkp_tpu.tasks.reaching import make_reaching as jax_reaching
    from trajoptkp_tpu_torch.derivs.fd import fd_slot_jacobians
    from trajoptkp_tpu_torch.dynamics.contact import limits_active
    from trajoptkp_tpu_torch.tasks.reaching import make_reaching

    jt = jax_reaching(dtype=jnp.float64)
    pt = make_reaching(device="cpu")
    m = pt.model
    rng = np.random.default_rng(11)
    lo, hi = m.jnt_range[:, 0].numpy(), m.jnt_range[:, 1].numpy()
    n_in, n_at = 4, 2
    qp = (0.5 * (lo + hi))[:, None] + 0.3 * rng.standard_normal(
        (7, n_in + n_at))
    qp[1, n_in] = lo[1] - 0.02
    qp[3, n_in + 1] = hi[3] + 0.02
    qv = 0.5 * rng.standard_normal((7, n_in + n_at))
    ct = 2.0 * rng.standard_normal((7, n_in + n_at))
    act = limits_active(m, torch.from_numpy(qp))
    assert not act[:n_in].any() and act[n_in:].all()
    J = fd_slot_jacobians(m, pt.sv, *map(torch.from_numpy, (qp, qv, ct)),
                          eps=1e-6).numpy()               # (14, 21, L)
    cols = jax.jit(lambda a, b, c, d: fd_job_columns(jt.model, jt.sv, a, b, c,
                                                     d, 1e-6))
    worst = {"interior": 0.0, "row active": 0.0}
    for b in range(n_in + n_at):
        key = "interior" if b < n_in else "row active"
        for d in range(7):
            a_pos, a_vel, b_col = cols(qp[:, b], qv[:, b], ct[:, b], d)
            for got, want in ((J[:, d, b], a_pos), (J[:, 7 + d, b], a_vel),
                              (J[:, 14 + d, b], b_col)):
                worst[key] = max(worst[key],
                                 float(np.abs(got - np.asarray(want)).max()))
    print("panda FD vs JAX fd_job_columns, max abs difference:", worst)
    assert worst["interior"] < 1e-6 and worst["row active"] < 1e-3, worst
