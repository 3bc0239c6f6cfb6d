"""The narrow phase and the pyramidal contact rows (dynamics/collision.py and
dynamics/contact.py:_contact_rows, the plain twin of kernel K2b) against the
JAX package's `dynamics/collision.py` and `contact._contact_rows`, eager JAX
(no jit), float64.

Narrow phase at hand-made poses: plane-cylinder with the cylinder upright
(its axis along the plane normal: the aligned branch, whose rim starts from
the cylinder's x axis), upside down, tilted and lying (axis . normal exactly
0: the cap-side sign's zero case), each cap just inside and just outside the
margin; cylinder-cylinder (capsules) parallel (denominator 0), crossing,
tilted and on one axis (closest points coincide: the normal falls back to
+z).  Bar 1e-12 absolute on distances, points and frames (the same formulas;
measured ~1e-17).

Rows on the push_ncl model at hand-made states with slots just inside and
just outside the margin on each pair: J 1e-12 absolute, R 1e-12 relative,
aref 1e-10 relative (k (dist - margin) with k up to 1e5), the gates equal.
The port orders the rows slot by slot, four per slot (the JAX lane engine's
order, `dynamics/lanes.py:989`); the JAX generic engine orders them in four
blocks over the slots, so the test permutes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajoptkp_tpu.dynamics import collision as jcol
from trajoptkp_tpu.dynamics import contact as jcon
from trajoptkp_tpu.dynamics.fk import forward_kinematics as jax_fk
from trajoptkp_tpu.dynamics.model import Data as JData
from trajoptkp_tpu.tasks.pushing import make_pushing as jax_pushing
from trajoptkp_tpu_torch.dynamics import collision as pcol
from trajoptkp_tpu_torch.dynamics import contact as pcon
from trajoptkp_tpu_torch.dynamics.fk import forward_kinematics
from trajoptkp_tpu_torch.dynamics.model import Data
from trajoptkp_tpu_torch.tasks.pushing import make_pushing

jax.config.update("jax_enable_x64", True)

GOAL = (0.05, 0.03)      # goal cylinder radius, half-length
PUSHER = (0.01, 0.13)
EPS_MARGIN = 1e-7        # just inside / outside the (zero) margin


def rot(axis, angle):
    """Rotation matrix about a unit axis (numpy, Rodrigues)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


LYING = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])


def _lowest_cap_offset(xm, hl, r):
    """Height of the lowest rim point of a cylinder above its centre."""
    axis = xm[:, 2]
    an = axis[2]
    rad = np.array([0.0, 0.0, 1.0]) - axis * an
    nr = np.linalg.norm(rad)
    low = -abs(an) * hl - (r * nr if nr > 1e-9 else 0.0)
    return low


PLANE_CASES = {
    "upright": rot((0, 0, 1), 0.4),
    "upside_down": rot((1, 0, 0), np.pi) @ rot((0, 0, 1), 0.2),
    "tilted": rot((0, 0, 1), 0.2) @ rot((1, 0, 0), 0.3),
    "lying": LYING,
}


def _compare_slots(jout, slots, tol=1e-12):
    jd, jp, jf = (np.asarray(x) for x in jout)
    pd = np.array([float(d.reshape(-1)[0]) for d in slots.dist])
    pp = np.stack([p.reshape(3, -1)[:, 0].numpy() for p in slots.pos])
    pf = torch.stack(slots.frame).reshape(3, 3, -1)[..., 0].numpy()
    np.testing.assert_allclose(pd, jd, atol=tol, rtol=0)
    np.testing.assert_allclose(pp, jp, atol=tol, rtol=0)
    for s in range(jf.shape[0]):
        np.testing.assert_allclose(pf, jf[s], atol=tol, rtol=0)
    return pd


def _port_args(xp1, xm1, s1, xp2, xm2, s2):
    t = lambda x: torch.tensor(x)[..., None]  # noqa: E731  (one lane)
    return t(xp1), t(xm1), tuple(s1), t(xp2), t(xm2), tuple(s2)


@pytest.mark.parametrize("side", [-1.0, 1.0])
@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_plane_cylinder_matches_jax(case, side):
    """The lowest rim point EPS_MARGIN inside (side -1) or outside the
    plane; the upright case is the aligned branch."""
    xm2 = PLANE_CASES[case]
    xp1, xm1 = np.array([0.1, -0.2, 0.0]), np.eye(3)
    r, hl = GOAL
    z = -_lowest_cap_offset(xm2, hl, r) + side * EPS_MARGIN
    xp2 = np.array([0.3, 0.1, z])
    s1 = (3.0, 3.0, 0.1)
    jout = jcol.plane_cylinder(jnp.asarray(xp1), jnp.asarray(xm1),
                               jnp.asarray(s1), jnp.asarray(xp2),
                               jnp.asarray(xm2), jnp.asarray(GOAL))
    dist = _compare_slots(
        jout, pcol.plane_cylinder(*_port_args(xp1, xm1, s1, xp2, xm2, GOAL)))
    # the lowest slot sits on the intended side of the margin
    assert (dist.min() < 0) == (side < 0)
    if case == "upright":
        # aligned: the first rim point lies along the cylinder's x axis
        p0 = np.asarray(jout[1])[0]
        cap = xp2 - xm2[:, 2] * hl
        np.testing.assert_allclose((p0 - cap)[:2] / r, xm2[:2, 0], atol=1e-3)


CAPSULE_CASES = {
    # (pusher rotation, offset of the goal's centre from the pusher's)
    "parallel": (np.eye(3), np.array([0.06, 0.0, -0.1])),
    "crossing": (rot((1, 0, 0), np.pi / 2), np.array([0.07, 0.0, 0.0])),
    "tilted": (rot((0, 1, 0), 0.5), np.array([0.08, 0.01, -0.12])),
    "one_axis": (np.eye(3), np.array([0.0, 0.0, -0.1])),
}


@pytest.mark.parametrize("side", [-1.0, 1.0])
@pytest.mark.parametrize("case", sorted(CAPSULE_CASES))
def test_cylinder_cylinder_matches_jax(case, side):
    """Capsule-capsule between the pusher and the goal; the goal is moved
    along the contact normal so that the distance is EPS_MARGIN inside or
    outside the margin (except on one axis, where the segments overlap)."""
    xm1, off = CAPSULE_CASES[case]
    xp1 = np.array([0.4, 0.0, 0.16])
    xm2 = rot((0, 0, 1), 0.3)
    xp2 = xp1 + off

    def both(xp2):
        args = (xp1, xm1, PUSHER, xp2, xm2, GOAL)
        j = jcol.capsule_capsule(*(jnp.asarray(a) for a in args))
        return j, pcol.capsule_capsule(*_port_args(*args))

    if case != "one_axis":
        j, _ = both(xp2)
        d0, n = float(np.asarray(j[0])[0]), np.asarray(j[2])[0, 0]
        xp2 = xp2 + n * (side * EPS_MARGIN - d0)
    j, p = both(xp2)
    dist = _compare_slots(j, p)
    if case == "one_axis":
        np.testing.assert_array_equal(np.asarray(j[2])[0, 0], [0.0, 0.0, 1.0])
    else:
        assert (dist[0] < 0) == (side < 0)
        assert abs(abs(dist[0]) - EPS_MARGIN) < 1e-12


def test_other_pairs_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7b"):
        pcol.pair_ncon(pcol.GEOM_PLANE, pcol.GEOM_BOX)
    x, m = torch.zeros(3, 1), torch.eye(3)[..., None]
    with pytest.raises(NotImplementedError, match="Queue 1 item 7b"):
        pcol.pair_contacts(pcol.GEOM_SPHERE, pcol.GEOM_SPHERE, x, m, (0.1,),
                           x, m, (0.1,))


# ---------------------------------------------------------------------------
# rows on the push_ncl model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def push():
    return jax_pushing(0), make_pushing(device="cpu")


def _slots(pt, qpos):
    m = pt.model
    d = forward_kinematics(m, Data(qpos=torch.tensor(qpos)[:, None],
                                   qvel=torch.zeros(m.nv, 1),
                                   ctrl=torch.zeros(m.nu, 1)))
    return pcon.contact_slots(m, d)


def _pusher_bottom(pt, qpos):
    """World position of the pusher rod's lower end at qpos (nq,)."""
    m = pt.model
    g = m.contact_pairs[2][0]
    d = forward_kinematics(m, Data(qpos=torch.tensor(qpos)[:, None],
                                   qvel=torch.zeros(m.nv, 1),
                                   ctrl=torch.zeros(m.nu, 1)))
    xp, xm = pcol.geom_pose(m, d, g)
    ends = [(xp[:, 0] + sgn * xm[:, 2, 0] * PUSHER[1]).numpy()
            for sgn in (-1.0, 1.0)]
    return min(ends, key=lambda e: e[2])


def _states(pt):
    """Hand-made push_ncl states (nq, 6): the goal on the table 1e-7 in and
    out, tilted onto one rim point, against the pusher's lower end 1e-7 in
    and out, and the arm lowered until the rod's lower rim meets the table
    (the table-pusher pair, ~1 cm under the start pose)."""
    q0 = pt.qpos_start.numpy().copy()
    qa = pt.model.jnt_qposadr[pt.model.joint_names.index("goal")]
    cols = []
    for dz in (-EPS_MARGIN, EPS_MARGIN):
        q = q0.copy()
        q[qa:qa + 7] = (0.5, 0.1, GOAL[1] + dz, 1.0, 0.0, 0.0, 0.0)
        cols.append(q)
    q = q0.copy()
    tilt = 0.25
    q[qa:qa + 7] = (0.45, -0.05, GOAL[1] * np.cos(tilt) + GOAL[0]
                    * np.sin(tilt) - 2e-4, np.cos(tilt / 2),
                    np.sin(tilt / 2), 0.0, 0.0)
    cols.append(q)
    bottom = _pusher_bottom(pt, q0)
    q = q0.copy()
    q[qa:qa + 7] = (bottom[0] + PUSHER[0] + GOAL[0], bottom[1],
                    GOAL[1] + 1e-3, 1.0, 0.0, 0.0, 0.0)
    slots = _slots(pt, q)[2]
    d0, n = float(slots.dist[0]), slots.frame[0][:, 0].numpy()
    for gap in (-EPS_MARGIN, EPS_MARGIN):
        # along the pair's normal (geom1 into geom2) to `gap`
        qg = q.copy()
        qg[qa:qa + 3] += n * (gap - d0)
        cols.append(qg)
    q = q0.copy()
    q[1] += 0.16       # shoulder down: the rod's rim reaches the table
    cols.append(q)
    return np.stack(cols, 1)


def test_contact_rows_match_jax(push):
    jt, pt = push
    jm, m = jt.model, pt.model
    qp = _states(pt)
    L = qp.shape[1]
    rng = np.random.default_rng(4)
    qv = 0.3 * rng.standard_normal((m.nv, L))
    d = forward_kinematics(m, Data(qpos=torch.tensor(qp),
                                   qvel=torch.tensor(qv),
                                   ctrl=torch.zeros(m.nu, L)))
    rows = pcon._contact_rows(m, d)
    J = pcon.rows_jacobian(rows, m.nv).numpy()
    S = pcon.contact_constants(m).nslot
    perm = [blk * S + s for s in range(S) for blk in range(4)]
    seen = np.zeros(S, dtype=bool)
    for i in range(L):
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
    # every slot of every pair is active in some state, and each of the
    # margin pairs above lands on both sides of the gate
    assert seen.all(), seen
    act = rows.active.numpy()[::4]                   # (S, L) per slot
    assert act[3:6, 0].all() and not act[3:6, 1].any()   # table-goal
    assert act[6, 3] and not act[6, 4]                   # pusher-goal
    assert act[0:3, 5].any()                              # table-pusher
