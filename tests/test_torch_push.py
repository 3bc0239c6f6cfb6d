"""push_ncl's step and its FD Jacobians over the reduced state vector (the
plain twins of kernels K1 + K2a + K2b and K5) against the JAX package's
generic engine, float64, on contact-active states from a driven rollout.

The JAX step is compiled once for the module, for one state (`jit` of
`step_state`, ~15 s here; under `vmap` its compile takes tens of minutes on
this CPU), and called per state: it drives the rollout and steps every FD
perturbation (~0.13 s a call).  The pattern of tests/test_lanes.py:51 (a
slow test there).

Tolerances:
- one step from the same state: qvel 5e-7 and qpos 5e-9 absolute, and half
  of the states within 1e-10 in qvel.  Both run the 8-iteration projected
  Newton over the same 42 rows (the port in the JAX lane engine's row
  order); where the goal lands on the table the stiff contact rows make
  its Hessian ill-conditioned and 8 iterations do not converge, so
  summation-order differences grow: measured up to 1.3e-7 in qvel (|qvel|
  ~1) at 5 of 32 states, below 1e-10 at 22 (ROADMAP Queue 3; the JAX lane
  engine itself is held to its generic engine at rtol 1e-8,
  tests/test_lanes.py:51);
- FD columns, ten state dofs (seven arm joints, the goal's translations)
  and seven controls, eps 1e-6, as `derivs/fd.py:_batched_fd_columns`
  builds them: 1e-6 absolute where no constraint row is active (the
  interior), and where rows are active the looser bar ROADMAP Queue 3
  records for FD across gates, 1e-3 absolute (a 1e-6 perturbation can put
  the two 8-iteration solves on different step lengths; FD divides the jump
  by 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.derivs import fd as jfd
from trajoptkp_tpu.dynamics import step_state as jax_step_state
from trajoptkp_tpu.dynamics.integrate import integrate_pos as jax_integrate
from trajoptkp_tpu.tasks.pushing import make_pushing as jax_pushing
from trajoptkp_tpu_torch.derivs.fd import fd_slot_jacobians
from trajoptkp_tpu_torch.dynamics.contact import contacts_active
from trajoptkp_tpu_torch.dynamics.step import step_state
from trajoptkp_tpu_torch.tasks.pushing import make_pushing

jax.config.update("jax_enable_x64", True)

LANES = 8        # driven lanes
T = 16           # driven steps
EPS = 1e-6


@pytest.fixture(scope="module")
def push():
    """(JAX task, port task, the compiled JAX step over lanes last)."""
    jt = jax_pushing(0)
    jm = jt.model
    one = jax.jit(lambda q, v, u: jax_step_state(jm, q, v, u))

    def step(qp, qv, u):
        outs = [one(qp[:, i], qv[:, i], u[:, i]) for i in range(qp.shape[1])]
        return (np.stack([np.asarray(o[0]) for o in outs], 1),
                np.stack([np.asarray(o[1]) for o in outs], 1))
    return jt, make_pushing(device="cpu"), step


def _starts(pt, rng):
    """LANES start states (nq, LANES): a quarter with the goal against the
    pusher rod's lower end, a quarter with the arm lowered onto the table,
    the rest with the goal tilted on the table at random; arm joints
    perturbed by 0.05 N(0, 1), goal 2 mm above the table so that it lands."""
    m = pt.model
    qa = m.jnt_qposadr[m.joint_names.index("goal")]
    q = np.tile(pt.qpos_start.numpy()[:, None], (1, LANES))
    q[:7] += 0.05 * rng.standard_normal((7, LANES))
    n4 = LANES // 4
    q[1, n4:2 * n4] += 0.12                   # rod onto the table
    for i in range(LANES):
        if i < n4:
            x, y = 0.353 + 0.059, 0.0          # against the rod at the start
            tilt = 0.0
        else:
            x, y = rng.uniform(0.4, 0.6), rng.uniform(-0.2, 0.2)
            tilt = rng.uniform(-0.2, 0.2) if i >= 2 * n4 else 0.0
        z = 0.03 * np.cos(tilt) + 0.05 * abs(np.sin(tilt)) + 0.002
        q[qa:qa + 7, i] = (x, y, z, np.cos(tilt / 2), np.sin(tilt / 2), 0, 0)
    return q


@pytest.fixture(scope="module")
def rollout(push):
    """States (nq, K), (nv, K) and controls (nu, K) of the driven rollout at
    steps 2, 6, 10 and 15, from the compiled JAX step."""
    jt, pt, step = push
    m = pt.model
    rng = np.random.default_rng(0)
    qp = _starts(pt, rng)
    qv = 0.1 * rng.standard_normal((m.nv, LANES))
    keep = []
    for t in range(T):
        u = 0.3 * rng.standard_normal((m.nu, LANES))
        if t in (2, 6, 10, 15):
            keep.append((qp, qv, u))
        qp, qv = step(qp, qv, u)
    return tuple(np.concatenate([k[i] for k in keep], 1) for i in range(3))


def test_push_step_matches_jax(push, rollout):
    jt, pt, step = push
    qp, qv, u = rollout
    act = contacts_active(pt.model, torch.from_numpy(qp))
    # every pair is in contact somewhere among the compared states
    assert bool(act.any(1).all()), act.sum(1).tolist()
    pq, pv = step_state(pt.model, *map(torch.from_numpy, (qp, qv, u)))
    jq, jv = step(qp, qv, u)
    np.testing.assert_allclose(pq.numpy(), jq, rtol=0, atol=5e-9)
    np.testing.assert_allclose(pv.numpy(), jv, rtol=0, atol=5e-7)
    close = np.abs(pv.numpy() - jv).max(0) < 1e-10
    assert close.mean() >= 0.5, close


def _jax_fd(jt, step, q, v, u):
    """[A|B] (2n, 2n + nu) at one state, built as
    `derivs/fd.py:_batched_fd_columns` builds it (six perturbations per
    state dof, control column d from dof d while d < nu), stepped by the
    module's compiled step and mapped back by `derivs/fd.py:_tangent_out`."""
    jm, sv = jt.model, jt.sv
    n, nu = sv.ndof, jm.nu
    cols = []
    for d in range(n):
        e_v = np.zeros(jm.nv)
        e_v[sv.order[d]] = EPS
        e_u = np.zeros(nu)
        e_u[min(d, nu - 1)] = EPS
        qpp = np.asarray(jax_integrate(jm, jnp.asarray(q), jnp.asarray(e_v),
                                       1.0))
        qpm = np.asarray(jax_integrate(jm, jnp.asarray(q), jnp.asarray(-e_v),
                                       1.0))
        cols += [(qpp, v, u), (qpm, v, u), (q, v + e_v, u), (q, v - e_v, u),
                 (q, v, u + e_u), (q, v, u - e_u)]
    oq, ov = step(*(np.stack([c[i] for c in cols], 1) for i in range(3)))

    def tang(a, b):
        return np.asarray(jfd._tangent_out(jm, sv, oq[:, a], ov[:, a],
                                           oq[:, b], ov[:, b], 2 * EPS))

    A = np.zeros((2 * n, 2 * n))
    Bm = np.zeros((2 * n, nu))
    for d in range(n):
        base = 6 * d
        A[:, d] = tang(base + 1, base)
        A[:, n + d] = tang(base + 3, base + 2)
        if d < nu:
            Bm[:, d] = tang(base + 5, base + 4)
    return np.concatenate([A, Bm], 1)


def test_push_fd_columns_match_jax(push, rollout):
    """At one state without active rows (the interior) and at three with
    rows active on each pair."""
    jt, pt, step = push
    m = pt.model
    qp, qv, u = rollout
    act = contacts_active(m, torch.from_numpy(qp)).numpy()   # (np, K)
    picks = [int(np.nonzero(~act.any(0))[0][0])]
    picks += [int(np.nonzero(act[p])[0][0]) for p in range(act.shape[0])]
    sel = lambda x: torch.from_numpy(x[:, picks])  # noqa: E731
    pj = fd_slot_jacobians(m, pt.sv, sel(qp), sel(qv), sel(u), EPS).numpy()
    n = pt.sv.ndof
    assert pj.shape == (2 * n, 2 * n + m.nu, len(picks))
    for i, k in enumerate(picks):
        jj = _jax_fd(jt, step, qp[:, k], qv[:, k], u[:, k])
        bar = 1e-6 if i == 0 else 1e-3
        np.testing.assert_allclose(pj[..., i], jj, rtol=0, atol=bar)
