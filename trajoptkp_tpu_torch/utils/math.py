"""Quaternion and spatial helpers (counterpart of `trajoptkp_tpu/utils/math.py`).

Only what forward kinematics, the smooth dynamics, integration and the
pushing tasks' end-effector servo use (JAX `utils/math.py:33-208,
251-266`).  Every function takes its vector component axis FIRST and
broadcasts over any trailing batch axes: a quaternion is (4, *L), a
3-vector (3, *L), a spatial vector (6, *L).  Quaternions are wxyz.
"""

from __future__ import annotations

import torch


def _bound(v, like: torch.Tensor) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.tensor(v, dtype=like.dtype,
                                                       device=like.device)


def at_least(x: torch.Tensor, lo) -> torch.Tensor:
    """max(x, lo), keeping NaN.  In forward mode a tangent exactly at the
    bound is halved, as JAX's lax.max does (jnp.maximum); torch.clamp would
    pass it whole (kernels/csrc/dual.cuh:at_least does the same)."""
    return torch.maximum(x, _bound(lo, x))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(max(x, lo), hi), keeping NaN, with JAX's tie rule in forward mode
    (jnp.clip halves a tangent exactly at a bound)."""
    return torch.minimum(torch.maximum(x, _bound(lo, x)), _bound(hi, x))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """q / max(|q|, eps), the squares summed left to right as the kernels do
    (kernels/csrc/step.cuh:quat_normalize)."""
    sumsq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
    return q / at_least(torch.sqrt(sumsq), eps)[None]


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[:1], -q[1:]])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v as v + 2w (u x v) + 2 u x (u x v)."""
    w = q[:1]
    u = q[1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(4, *L) -> (3, 3, *L)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ])
    return r.reshape((3, 3) + tuple(q.shape[1:]))


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (3, *L) -> quaternion (4, *L), with the series
    0.5 - |v|^2/48 for sin(|v|/2)/|v| near zero (JAX `quat_exp`).  Sums
    run left to right, as in kernels/csrc/step.cuh."""
    sumsq = (v[0] * v[0] + v[1] * v[1] + v[2] * v[2])[None]
    small = sumsq < 1e-18
    angle = torch.sqrt(torch.where(small, torch.ones_like(sumsq), sumsq))
    half = 0.5 * angle
    sinc_half = torch.where(small, 0.5 - sumsq * (1.0 / 48.0),
                            torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sumsq / 8.0, torch.cos(half))
    return torch.cat([w, v * sinc_half])


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (3, 3, *L) -> quaternion (4, *L), the four Shepperd
    cases selected branch-free (JAX `mat_to_quat`)."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]

    def case(wsq, build):
        return build(torch.sqrt(torch.clamp(wsq, min=1e-16)) * 2.0)

    q0 = case(tr + 1.0, lambda s: torch.stack([
        s / 4.0, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
        (m[1, 0] - m[0, 1]) / s]))
    q1 = case(1.0 + m[0, 0] - m[1, 1] - m[2, 2], lambda s: torch.stack([
        (m[2, 1] - m[1, 2]) / s, s / 4.0, (m[0, 1] + m[1, 0]) / s,
        (m[0, 2] + m[2, 0]) / s]))
    q2 = case(1.0 - m[0, 0] + m[1, 1] - m[2, 2], lambda s: torch.stack([
        (m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, s / 4.0,
        (m[1, 2] + m[2, 1]) / s]))
    q3 = case(1.0 - m[0, 0] - m[1, 1] + m[2, 2], lambda s: torch.stack([
        (m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
        (m[1, 2] + m[2, 1]) / s, s / 4.0]))
    c0 = (tr > 0)[None]
    c1 = ((m[0, 0] > m[1, 1]) & (m[0, 0] > m[2, 2]))[None]
    c2 = (m[1, 1] > m[2, 2])[None]
    q = torch.where(c0, q0, torch.where(c1, q1, torch.where(c2, q2, q3)))
    return quat_normalize(q)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> rotation vector, short geodesic (JAX `quat_log`)."""
    q = quat_normalize(q)
    q = torch.where(q[:1] < 0, -q, q)
    w = clip(q[:1], -1.0, 1.0)
    xyz = q[1:]
    # summed left to right, as kernels/csrc/geometry.cuh:quat_log
    sumsq = (xyz[0] * xyz[0] + xyz[1] * xyz[1] + xyz[2] * xyz[2])[None]
    small = sumsq < 1e-18
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(sumsq), sumsq))
    angle = 2.0 * torch.atan2(sin_half, w)
    # a tensor divisor: PyTorch multiplies by the reciprocal of a Python
    # scalar on the card, the kernels divide
    scale = torch.where(small, 2.0 + sumsq / torch.full_like(sumsq, 3.0),
                        angle / sin_half)
    return xyz * scale


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """q * exp(omega dt), omega in the local frame (mju_quatIntegrate)."""
    return quat_normalize(quat_mul(q, quat_exp(omega * dt)))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """v with qa = qb * exp(v): log(qb^-1 qa) (mju_subQuat)."""
    return quat_log(quat_mul(quat_conj(qb), qa))


def cross_motion(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m, with [angular; linear] 6-vectors."""
    w, vl = v[:3], v[3:]
    mw, ml = m[:3], m[3:]
    return torch.cat([cross(w, mw), cross(w, ml) + cross(vl, mw)])


def cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f."""
    w, vl = v[:3], v[3:]
    fw, fl = f[:3], f[3:]
    return torch.cat([cross(w, fw) + cross(vl, fl), cross(w, fl)])
