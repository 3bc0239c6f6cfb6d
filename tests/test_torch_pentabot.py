"""Pentabot with its six capsule-capsule pairs (non-adjacent links) on the
port's plain path against JAX `make_pentabot`, float64, at folded states
where links touch.

The JAX step is compiled once for one state and called per state, as
tests/test_torch_walker.py does.  States: joint angles uniform in +-3 rad
(about one in ten touches per pair), the first 12 with a pair within its
margin, and a rollout of 8 steps from them under U(-1, 1) controls.

Tolerances, those of tests/test_torch_walker.py's contact cases: one step
qpos 1e-9, qvel 1e-7 absolute and half the states within 1e-10 in qvel
[measured 7.1e-8 at the worst state]; FD columns (eps 1e-6) 1e-6 absolute
at a state without active rows.  Where rows are active the walker's FD bar
(5e-3) does not hold here: FD divides the two engines' step difference by
2 eps, and pentabot's stiff capsule rows leave the 8 cold Newton iterations
unconverged, so their row orders show in the step (ROADMAP Queue 3; the FD
columns measured 2.3e-4 to 7.1e-2 apart over the first ten touching states,
entries up to ~160).  So at touching states every perturbed step of the FD
is held to the step bars above, and the FD columns to the difference those
steps make, max |step difference| / eps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.derivs.fd import fd_job_columns
from trajoptkp_tpu.dynamics import step_state as jax_step_state
from trajoptkp_tpu.tasks.toys import make_pentabot as jax_pentabot
from trajoptkp_tpu_torch.derivs.fd import fd_slot_jacobians
from trajoptkp_tpu_torch.dynamics.contact import contacts_active
from trajoptkp_tpu_torch.dynamics.step import step_state
from trajoptkp_tpu_torch.kernels import ops
from trajoptkp_tpu_torch.tasks.toys import make_pentabot

jax.config.update("jax_enable_x64", True)

EPS = 1e-6


@pytest.fixture(scope="module")
def penta():
    jt = jax_pentabot(dtype=jnp.float64)
    one = jax.jit(lambda q, v, u: jax_step_state(jt.model, q, v, u))

    def step(qp, qv, u):
        outs = [one(qp[:, i], qv[:, i], u[:, i]) for i in range(qp.shape[1])]
        return (np.stack([np.asarray(o[0]) for o in outs], 1),
                np.stack([np.asarray(o[1]) for o in outs], 1))

    pt = make_pentabot(device="cpu")
    rng = np.random.default_rng(0)
    q = rng.uniform(-3.0, 3.0, (5, 400))
    act = contacts_active(pt.model, torch.from_numpy(q)).numpy().any(0)
    qp = q[:, np.nonzero(act)[0][:12]]
    qv = 0.3 * rng.standard_normal((5, qp.shape[1]))
    states = []
    for _ in range(8):
        u = rng.uniform(-1.0, 1.0, (3, qp.shape[1]))
        states.append((qp, qv, u))
        qp, qv = step_state(pt.model, *map(torch.from_numpy, (qp, qv, u)))
        qp, qv = qp.numpy(), qv.numpy()
    return jt, pt, step, tuple(np.concatenate([s[i] for s in states], 1)
                               for i in range(3))


def test_pentabot_keeps_its_six_pairs_and_instance(penta):
    jt, pt, _, _ = penta
    pairs = ((0, 2), (0, 3), (0, 4), (1, 3), (1, 4), (2, 4))
    assert pt.model.contact_pairs == pairs
    assert tuple(tuple(p) for p in jt.model.contact_pairs) == pairs
    key = ops.instance_key(pt)
    assert len(key.PAIRS) == 6 and ops.instances()[key] == "pentabot"


def test_pentabot_step_matches_jax_with_links_touching(penta):
    jt, pt, step, (qp, qv, u) = penta
    act = contacts_active(pt.model, torch.from_numpy(qp)).numpy()
    assert act.any(1).all(), "a pair never touched"
    pq, pv = step_state(pt.model, *map(torch.from_numpy, (qp, qv, u)))
    jq, jv = step(qp, qv, u)
    np.testing.assert_allclose(pq.numpy(), jq, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pv.numpy(), jv, rtol=0, atol=1e-7)
    close = np.abs(pv.numpy() - jv).max(0) < 1e-10
    assert close.mean() >= 0.5, close


def test_pentabot_fd_columns_match_jax_with_links_touching(penta):
    """At the straight start (no row active), against `fd_job_columns` at
    1e-6; at two touching states, each of the 2 (2n + nu) perturbed steps
    against the JAX step and the FD columns within what those steps'
    differences make."""
    jt, pt, step, (qp, qv, u) = penta
    m = pt.model
    act = contacts_active(m, torch.from_numpy(qp)).numpy().any(0)
    touching = [int(k) for k in np.nonzero(act)[0][:2]]
    qp = np.concatenate([pt.qpos_start.numpy()[:, None], qp[:, touching]], 1)
    qv = np.concatenate([np.zeros((5, 1)), qv[:, touching]], 1)
    u = np.concatenate([np.zeros((3, 1)), u[:, touching]], 1)
    assert not contacts_active(m, torch.from_numpy(qp[:, :1])).any()
    pj = fd_slot_jacobians(m, pt.sv, *map(torch.from_numpy, (qp, qv, u)),
                           EPS).numpy()
    cols = jax.jit(lambda a, b, c, d: fd_job_columns(jt.model, jt.sv, a, b, c,
                                                     d, EPS))
    n, nu = pt.sv.ndof, m.nu
    for k in range(3):
        jj = np.zeros_like(pj[..., k])
        for d in range(n):
            a_pos, a_vel, b_col = cols(qp[:, k], qv[:, k], u[:, k], d)
            jj[:, d], jj[:, n + d] = np.asarray(a_pos), np.asarray(a_vel)
            if d < nu:
                jj[:, 2 * n + d] = np.asarray(b_col)
        if k == 0:
            np.testing.assert_allclose(pj[..., k], jj, rtol=0, atol=1e-6)
            continue
        # the FD's perturbed inputs (all hinges: q + e), both engines' steps
        pert = []
        for c in range(2 * n + nu):
            for sign in (1.0, -1.0):
                q, v, w = qp[:, k].copy(), qv[:, k].copy(), u[:, k].copy()
                (q if c < n else v if c < 2 * n else w)[c % n if c < 2 * n
                                                       else c - 2 * n] += \
                    sign * EPS
                pert.append((q, v, w))
        q, v, w = (np.stack([p[i] for p in pert], 1) for i in range(3))
        pq, pv = step_state(m, *map(torch.from_numpy, (q, v, w)))
        jq, jv = step(q, v, w)
        gap_q = np.abs(pq.numpy() - jq).max()
        gap_v = np.abs(pv.numpy() - jv).max()
        assert gap_q <= 1e-9 and gap_v <= 1e-7, (gap_q, gap_v)
        np.testing.assert_allclose(pj[..., k], jj, rtol=0,
                                   atol=max(gap_q, gap_v) / EPS + 1e-6)
