"""Narrow phase (counterpart of `trajoptkp_tpu/dynamics/collision.py`).

The geom pairs the ported tasks collide: plane-cylinder (three rim points of
the lower cap), plane-capsule (the two end points of the axis),
capsule-capsule (one slot between the axis segments' closest points) and
cylinder-cylinder (cylinders as equal-radius capsules, the JAX package's
dispatch).  Each pair function returns a FIXED number of
contact slots, dist > 0 meaning separated; the constraint assembler
(dynamics/contact.py) gates each slot on dist < margin.  Normals point from
geom1 into geom2; a frame's rows are (normal, tangent1, tangent2).

This module is the plain twin of the narrow phase of kernel K2b
(kernels/csrc/contact.cuh), batch axes last: every vector is (3, *L) and
every sum runs left to right in the kernel's order, because the gates of
the narrow phase (the cap side, the aligned-axis test, the segment clamps)
are branches that central FD divides by 2 eps.  Two deliberate departures
from the JAX formulas, both inside rounding: geom poses come from the body
quaternion (quaternion product and rotation, as the kernel's FK), and the
plane-cylinder radial norm is sqrt(max(r.r, 1e-24)) as in the JAX lane
engine (`dynamics/lanes.py:862`).

Other geom pairs raise: box pairs, spheres and clutter are ROADMAP Queue 1
item 7b.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import math as tm
from .model import Data, Model

GEOM_PLANE = 0
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_CYLINDER = 5
GEOM_BOX = 6


class Slots(NamedTuple):
    dist: Tuple[torch.Tensor, ...]              # per slot (*L)
    pos: Tuple[torch.Tensor, ...]               # per slot (3, *L)
    frame: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # rows (3, *L)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def frame_from_normal(n: torch.Tensor):
    """(n, t1, t2) from a unit normal: t1 = n x ref / |n x ref| with ref the
    x axis unless |n_x| >= 0.5, then the y axis (JAX `_frame_from_normal`)."""
    one = torch.where(n[0].abs() < 0.5, 1.0, 0.0).to(n.dtype)
    ref = torch.stack([one, 1.0 - one, torch.zeros_like(one)])
    t1 = tm.cross(n, ref)
    t1n = tm.at_least(torch.sqrt(_dot(t1, t1)), 1e-12)
    t1 = t1 / t1n[None]
    return n, t1, tm.cross(n, t1)


def geom_pose(model: Model, data: Data, g: int):
    """World position (3, *L) and rotation matrix (3, 3, *L) of geom g, from
    its body's frame: quaternion product and rotation, as the kernel."""
    b = model.geom_bodyid[g]
    nl = data.xpos.dim() - 2
    xq = data.xquat[b]
    gq = tm.quat_mul(xq, model.geom_quat[g].reshape((4,) + (1,) * nl))
    gp = data.xpos[b] + tm.quat_rotate(
        xq, model.geom_pos[g].reshape((3,) + (1,) * nl))
    return gp, tm.quat_to_mat(gq)


def plane_cylinder(xp1, xm1, s1, xp2, xm2, s2) -> Slots:
    """Three rim points of the cylinder's cap nearer the plane (JAX
    `plane_cylinder`).  When the axis is parallel to the normal (an upright
    cylinder on a table) the rim starts from the cylinder's x axis."""
    n = xm1[:, 2]
    r, hl = s2[0], s2[1]
    axis = xm2[:, 2]
    an = _dot(axis, n)
    sign = -torch.sign(an)
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    cap = xp2 + axis * (hl * sign)[None]
    rad = n - axis * an[None]
    rad_norm = torch.sqrt(tm.at_least(_dot(rad, rad), 1e-24))
    aligned = (rad_norm < 1e-9)[None]
    rad = torch.where(aligned, xm2[:, 0],
                      -rad / tm.at_least(rad_norm, 1e-9)[None])
    t = tm.cross(axis, rad)
    half = -0.5 * r
    arc = 0.866 * r
    pts = (cap + rad * r,
           (cap + rad * half) + t * arc,
           (cap + rad * half) + t * (-arc))
    dists, poss = [], []
    for p in pts:
        d = _dot(n, p - xp1)
        dists.append(d)
        poss.append(p - n * (0.5 * d)[None])
    return Slots(tuple(dists), tuple(poss), frame_from_normal(n))


def plane_capsule(xp1, xm1, s1, xp2, xm2, s2) -> Slots:
    """The capsule's two axis end points, +half-length first (JAX
    `plane_capsule`, lane form `dynamics/lanes.py:841-852`)."""
    n = xm1[:, 2]
    r, hl = s2[0], s2[1]
    axis = xm2[:, 2]
    dists, poss = [], []
    for sgn in (1.0, -1.0):
        e = xp2 + axis * (hl * sgn)
        dist = _dot(n, e - xp1) - r
        dists.append(dist)
        poss.append(e - n * (r + 0.5 * dist)[None])
    return Slots(tuple(dists), tuple(poss), frame_from_normal(n))


def sphere_sphere_core(p1, r1, p2, r2):
    """(dist, pos, n) between two spheres; n = +z when the centres meet."""
    d = p2 - p1
    L = torch.sqrt(_dot(d, d))
    deg = (L < 1e-9)[None]
    up = torch.zeros_like(d)
    up[2] = 1.0
    n = torch.where(deg, up, d / tm.at_least(L, 1e-9)[None])
    dist = (L - r1) - r2
    pos = p1 + n * (r1 + 0.5 * dist)[None]
    return dist, pos, n


def closest_seg_seg(p0, p1, q0, q1):
    """Closest points of segments [p0, p1] and [q0, q1], clamped (JAX
    `_closest_seg_seg`)."""
    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12,
                    tm.clip((b * f - c * e) / tm.at_least(denom, 1e-12),
                            0.0, 1.0),
                    torch.zeros_like(denom))
    t = (b * s + f) / tm.at_least(e, 1e-12)
    t_cl = tm.clip(t, 0.0, 1.0)
    s = tm.clip((b * t_cl - c) / tm.at_least(a, 1e-12), 0.0, 1.0)
    return p0 + d1 * s[None], q0 + d2 * t_cl[None]


def capsule_capsule(xp1, xm1, s1, xp2, xm2, s2) -> Slots:
    """One slot between the two axis segments' closest points, each geom's
    own radius (JAX `capsule_capsule`; cylinders dispatch here as
    equal-radius capsules)."""
    a_axis = xm1[:, 2] * s1[1]
    b_axis = xm2[:, 2] * s2[1]
    pa, pb = closest_seg_seg(xp1 - a_axis, xp1 + a_axis,
                             xp2 - b_axis, xp2 + b_axis)
    dist, pos, n = sphere_sphere_core(pa, s1[0], pb, s2[0])
    return Slots((dist,), (pos,), frame_from_normal(n))


# (contact slots, collider) per (geom1 type, geom2 type) of the ported pairs
_COLLIDERS = {
    (GEOM_PLANE, GEOM_CYLINDER): (3, plane_cylinder),
    (GEOM_PLANE, GEOM_CAPSULE): (2, plane_capsule),
    (GEOM_CAPSULE, GEOM_CAPSULE): (1, capsule_capsule),
    (GEOM_CYLINDER, GEOM_CYLINDER): (1, capsule_capsule),
}


def _collider(t1: int, t2: int):
    if (t1, t2) not in _COLLIDERS:
        raise NotImplementedError(
            f"no collider for geom types ({t1}, {t2}): the port's narrow "
            "phase has plane-cylinder, plane-capsule, capsule-capsule and "
            "cylinder-cylinder; the other geom pairs (boxes: plane-box for "
            "walker_uneven) are ROADMAP Queue 1 item 7b")
    return _COLLIDERS[(t1, t2)]


def pair_ncon(t1: int, t2: int) -> int:
    """The fixed number of contact slots of a pair, or raise."""
    return _collider(t1, t2)[0]


def pair_contacts(t1: int, t2: int, xp1, xm1, s1, xp2, xm2, s2) -> Slots:
    """Dispatch on static geom types; the pair's fixed slots, normals from
    geom1 into geom2.  `s1`, `s2` are the geoms' sizes as Python floats."""
    return _collider(t1, t2)[1](xp1, xm1, s1, xp2, xm2, s2)
