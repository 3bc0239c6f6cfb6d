// K2b: the narrow phase and the pyramidal contact rows for one lane, in
// double precision.
//
// Replaces, in the JAX lane engine trajoptkp_tpu/dynamics/lanes.py, the
// contact rows (_contact_rows_regs:989) over the pair slots
// (_pair_slots_regs:963) of the narrow phase (_collide_regs:826:
// plane-capsule :841-852, plane-cylinder :853-881, capsule-capsule and
// cylinder-cylinder :897-913), i.e. the semantics
// of trajoptkp_tpu/dynamics/contact.py:_contact_rows:190 and collision.py.
// It is a __device__ function called by smooth_step (step.cuh) between the
// force assembly and the constraint solve of constraint.cuh (K2a), from the
// FK products the step already has (body frames, cdof), so it runs inside
// the rollout (K3), line-search (K4) and FD-Jacobian (K5) kernels.  Plain
// twin: trajoptkp_tpu_torch/dynamics/collision.py and
// dynamics/contact.py:_contact_rows.
//
// Per contact pair (geom types and bodies are compile-time, T::pair_*): the
// geom poses from their bodies' frames, the pair's fixed slots (3 for
// plane-cylinder: rim points of the cap nearer the plane; 2 for
// plane-capsule: the axis end points; 1 for capsule-capsule, and for
// cylinder-cylinder as equal-radius capsules), and four rows per slot,
// J = Jn + mu Jt1, Jn - mu Jt1, Jn + mu Jt2, Jn - mu Jt2, over the pair's
// support: the dofs on exactly one of the two bodies' root paths (known at
// compile time, T::supp_code), the point Jacobian cdof_lin + cdof_ang x pos
// signed +1 on geom2's path and -1 on geom1's.  aref = -b (J qvel) -
// k (dist - margin); R = max((1-d)/max(d, 1e-6), 1e-9) rconst, one per
// slot; the row is active when dist < margin.  The rows are written after
// the limit rows, and the solver of constraint.cuh takes them unchanged.
//
// Model buffer, PAIR_STRIDE per pair (kernels/ops.py:pack_model): geom1
// pos (3), quat (4), size (3), geom2 likewise, then the pair's constants in
// the layout of dynamics/contact.py CONTACT_FIELDS, whose impedance fields
// sit at the LimField offsets of constraint.cuh, so `impedance` reads both.
//
// Rounding: the branches of the narrow phase (the cap side, the aligned
// axis test rad_norm < 1e-9, the segment clamps) and the gate
// dist < margin are taken by the same comparisons on bit-equal operands as
// the twin's: every sum runs left to right in the twin's order
// (-fmad=false).
//
// Bound: per pair ~100 operations of geometry and per slot ~30 + 25 W
// (Jacobian) + 4 x 3 W (rows) with W the support size: about 2.5k at
// push_ncl (7 slots, W 7/6/13), small beside the solve it feeds.
#pragma once

#include <utility>

#include "constraint.cuh"
#include "geometry.cuh"
#include "linalg.cuh"

namespace trajopt {

constexpr int GEOM_PLANE = 0;
constexpr int GEOM_SPHERE = 2;
constexpr int GEOM_CAPSULE = 3;
constexpr int GEOM_CYLINDER = 5;
constexpr int GEOM_BOX = 6;
constexpr int MAX_SLOTS = 4;  // slots of the largest ported pair

// the pairs with a collider in this order (dynamics/collision.py
// _COLLIDERS); a pair given the other way round runs its collider with the
// geoms swapped and the normals flipped
__host__ __device__ constexpr bool pair_direct(int t1, int t2) {
  return (t1 == GEOM_PLANE &&
          (t2 == GEOM_CYLINDER || t2 == GEOM_CAPSULE || t2 == GEOM_BOX)) ||
         (t1 == GEOM_CAPSULE && (t2 == GEOM_CAPSULE || t2 == GEOM_BOX)) ||
         (t1 == GEOM_CYLINDER && (t2 == GEOM_CYLINDER || t2 == GEOM_BOX));
}
__host__ __device__ constexpr bool pair_flipped(int t1, int t2) {
  return !pair_direct(t1, t2) && pair_direct(t2, t1);
}
// slots of a pair in its collider's order: plane-cylinder 3 rim points,
// plane-box 4 corners, plane-capsule and the box probes 2, else 1
__host__ __device__ constexpr int pair_slots(int t1, int t2) {
  return pair_flipped(t1, t2)   ? pair_slots(t2, t1)
         : t1 == GEOM_PLANE     ? (t2 == GEOM_CYLINDER ? 3
                                   : t2 == GEOM_BOX    ? 4
                                                       : 2)
         : t2 == GEOM_BOX       ? 2
                                : 1;
}
constexpr int PAIR_STRIDE = 33;
enum PairField {
  G1_POS = 0, G1_QUAT = 3, G1_SIZE = 7, G2_POS = 10, G2_QUAT = 13,
  G2_SIZE = 17, PAIR_CONST = 20
};
// inside the pair's constants (dynamics/contact.py CONTACT_FIELDS)
enum ContactField { C_MU = 0, C_RCONST = 3 };

// (n, t1, t2): t1 = n x ref / max(|n x ref|, 1e-12), ref the x axis unless
// |n_x| >= 0.5, then the y axis; t2 = n x t1
template <class S>
__device__ __forceinline__ void frame_from_normal(const S* n, S (&fr)[3][3]) {
  const double one = fabs(n[0]) < 0.5 ? 1.0 : 0.0;
  const double ref[3] = {one, 1.0 - one, 0.0};
  S t1[3];
  cross3(n, ref, t1);
  const S t1n = at_least(sqrt(dot3(t1, t1)), 1e-12);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    fr[0][k] = n[k];
    fr[1][k] = t1[k] / t1n;
  }
  cross3(n, fr[1], fr[2]);
}

// world pose of a geom on a body frame: position, rotation matrix
template <class S>
__device__ __forceinline__ void geom_pose(const S* bpos, const S* bquat,
                                          const double* gpos,
                                          const double* gquat, S* xp, S* xm) {
  S q[4], t[3];
  quat_mul(bquat, gquat, q);
  quat_rotate(bquat, gpos, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) xp[k] = bpos[k] + t[k];
  quat_to_mat(q, xm);
}

// collision.py:plane_cylinder: three rim points of the cap nearer the plane
template <class S>
__device__ __forceinline__ void plane_cylinder(
    const S* xp1, const S* xm1, const S* xp2, const S* xm2, const double* s2,
    S* dist, S (*pos)[3], S (&fr)[3][3]) {
  const S n[3] = {xm1[2], xm1[5], xm1[8]};
  const double r = s2[0], hl = s2[1];
  const S axis[3] = {xm2[2], xm2[5], xm2[8]};
  const S an = dot3(axis, n);
  // a sign's tangent is zero; a NaN passes
  S sign = an > 0.0 ? S(-1.0)
                    : (an < 0.0 ? S(1.0) : (isnan(an) ? an : S(1.0)));
  S cap[3], rad[3], radu[3], t[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cap[k] = xp2[k] + axis[k] * (hl * sign);
    rad[k] = n[k] - axis[k] * an;
  }
  const S rad_norm = sqrt(at_least(dot3(rad, rad), 1e-24));
  const bool aligned = rad_norm < 1e-9;
  const S den = at_least(rad_norm, 1e-9);
#pragma unroll
  for (int k = 0; k < 3; ++k) radu[k] = aligned ? xm2[3 * k] : -rad[k] / den;
  cross3(axis, radu, t);
  const double half = -0.5 * r;
  const double arc = 0.866 * r;
  S p[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[0][k] = cap[k] + radu[k] * r;
    p[1][k] = (cap[k] + radu[k] * half) + t[k] * arc;
    p[2][k] = (cap[k] + radu[k] * half) + t[k] * (-arc);
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    S d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = p[s][k] - xp1[k];
    dist[s] = dot3(n, d);
    const S hd = 0.5 * dist[s];
#pragma unroll
    for (int k = 0; k < 3; ++k) pos[s][k] = p[s][k] - n[k] * hd;
  }
  frame_from_normal(n, fr);
}

// collision.py:plane_capsule: the two end points of the capsule's axis,
// +half-length first
template <class S>
__device__ __forceinline__ void plane_capsule(
    const S* xp1, const S* xm1, const S* xp2, const S* xm2, const double* s2,
    S* dist, S (*pos)[3], S (&fr)[3][3]) {
  const S n[3] = {xm1[2], xm1[5], xm1[8]};
  const double r = s2[0], hl = s2[1];
  const S axis[3] = {xm2[2], xm2[5], xm2[8]};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const double h = s == 0 ? hl : -hl;
    S e[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e[k] = xp2[k] + axis[k] * h;
      d[k] = e[k] - xp1[k];
    }
    dist[s] = dot3(n, d) - r;
    const S off = r + 0.5 * dist[s];
#pragma unroll
    for (int k = 0; k < 3; ++k) pos[s][k] = e[k] - n[k] * off;
  }
  frame_from_normal(n, fr);
}

// collision.py:capsule_capsule over _closest_seg_seg and
// _sphere_sphere_core: one slot between the axis segments' closest points
template <class S>
__device__ __forceinline__ void capsule_capsule(
    const S* xp1, const S* xm1, const double* s1, const S* xp2, const S* xm2,
    const double* s2, S* dist, S (*pos)[3], S (&fr)[3][3]) {
  S p0[3], p1[3], q0[3], q1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const S a = xm1[3 * k + 2] * s1[1];
    const S b = xm2[3 * k + 2] * s2[1];
    p0[k] = xp1[k] - a;
    p1[k] = xp1[k] + a;
    q0[k] = xp2[k] - b;
    q1[k] = xp2[k] + b;
  }
  S d1[3], d2[3], rr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d1[k] = p1[k] - p0[k];
    d2[k] = q1[k] - q0[k];
    rr[k] = p0[k] - q0[k];
  }
  const S a = dot3(d1, d1), e = dot3(d2, d2), f = dot3(d2, rr);
  const S c = dot3(d1, rr), b = dot3(d1, d2);
  const S denom = a * e - b * b;
  S s = denom > 1e-12
            ? clip((b * f - c * e) / at_least(denom, 1e-12), 0.0, 1.0)
            : S(0.0);
  const S t = (b * s + f) / at_least(e, 1e-12);
  const S t_cl = clip(t, 0.0, 1.0);
  s = clip((b * t_cl - c) / at_least(a, 1e-12), 0.0, 1.0);
  S pa[3], pb[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pa[k] = p0[k] + d1[k] * s;
    pb[k] = q0[k] + d2[k] * t_cl;
    d[k] = pb[k] - pa[k];
  }
  const S L = sqrt(dot3(d, d));
  const bool deg = L < 1e-9;
  const S Ld = at_least(L, 1e-9);
  S n[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    n[k] = deg ? S(k == 2 ? 1.0 : 0.0) : d[k] / Ld;
  dist[0] = (L - s1[0]) - s2[0];
  const S off = s1[0] + 0.5 * dist[0];
#pragma unroll
  for (int k = 0; k < 3; ++k) pos[0][k] = pa[k] + n[k] * off;
  frame_from_normal(n, fr);
}

// collision.py:plane_box: the four deepest of the box's eight corners
// xp2 + (bx hx + (by hy + bz hz)) (x slowest, z fastest), sorted by
// Knuth's 19-comparator network, a compare-exchange keeping the first when
// di <= dj (JAX dynamics/lanes.py:914-941)
template <class S>
__device__ __forceinline__ void plane_box(const S* xp1, const S* xm1,
                                          const S* xp2, const S* xm2,
                                          const double* s2, S* dist,
                                          S (*pos)[3], S (&fr)[3][3]) {
  const S n[3] = {xm1[2], xm1[5], xm1[8]};
  S cd[8], cp[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const double hx = ((i >> 2) & 1 ? 1.0 : -1.0) * s2[0];
    const double hy = ((i >> 1) & 1 ? 1.0 : -1.0) * s2[1];
    const double hz = (i & 1 ? 1.0 : -1.0) * s2[2];
    S d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cp[i][k] = xp2[k] + (xm2[3 * k] * hx +
                           (xm2[3 * k + 1] * hy + xm2[3 * k + 2] * hz));
      d[k] = cp[i][k] - xp1[k];
    }
    cd[i] = dot3(n, d);
  }
  constexpr int NET[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2},
                              {1, 3}, {4, 6}, {5, 7}, {1, 2}, {5, 6},
                              {0, 4}, {3, 7}, {1, 5}, {2, 6}, {1, 4},
                              {3, 6}, {2, 4}, {3, 5}, {3, 4}};
#pragma unroll
  for (int e = 0; e < 19; ++e) {
    const int i = NET[e][0], j = NET[e][1];
    if (!(cd[i] <= cd[j])) {
      const S t = cd[i];
      cd[i] = cd[j];
      cd[j] = t;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const S c = cp[i][k];
        cp[i][k] = cp[j][k];
        cp[j][k] = c;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    dist[s] = cd[s];
    const S hd = 0.5 * cd[s];
#pragma unroll
    for (int k = 0; k < 3; ++k) pos[s][k] = cp[s][k] - n[k] * hd;
  }
  frame_from_normal(n, fr);
}

// collision.py:sphere_box_core (JAX dynamics/lanes.py:764-812): a sphere
// (centre p, radius r) against a box (xp2, xm2, half-sizes s2) -> dist,
// pos and the normal from the sphere into the box.  Outside: the clamped
// point on the surface and the direction to it; a centre inside pushes out
// through the face of least margin (ties to the lower axis).  Each branch
// selects its value and tangent as torch.where does; the branch not taken
// is not used.
template <class S>
__device__ __forceinline__ void sphere_box_core(const S* p, double r,
                                                const S* xp2, const S* xm2,
                                                const double* s2, S& dist,
                                                S* pos, S* n) {
  S d[3], pl[3], cl[3], de[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = p[k] - xp2[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pl[k] = xm2[k] * d[0] + xm2[3 + k] * d[1] + xm2[6 + k] * d[2];
    cl[k] = clip(pl[k], -s2[k], s2[k]);
    de[k] = pl[k] - cl[k];
  }
  const S L = sqrt(at_least(de[0] * de[0] + de[1] * de[1] + de[2] * de[2],
                            0.0));
  const bool outside = L > 1e-9;
  S nl[3], pol[3];
  if (outside) {
    const S inv = recip(at_least(L, 1e-9));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      nl[k] = de[k] * inv;
      pol[k] = cl[k];
    }
    dist = L - r;
  } else {
    S m[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) m[k] = s2[k] - fabs(pl[k]);
    const bool is0 = (m[0] <= m[1]) && (m[0] <= m[2]);
    const bool is1 = !is0 && (m[1] <= m[2]);
    const S m_min = is0 ? m[0] : (is1 ? m[1] : m[2]);
    const int face = is0 ? 0 : (is1 ? 1 : 2);
    dist = -(m_min + r);
    const S off = dist * 0.5 + r;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double ni = k == face ? (pl[k] < 0.0 ? -1.0 : 1.0) : 0.0;
      nl[k] = S(ni);
      pol[k] = pl[k] - ni * off;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    n[k] = -((xm2[3 * k] * nl[0] + xm2[3 * k + 1] * nl[1]) +
             xm2[3 * k + 2] * nl[2]);
    pos[k] = xp2[k] + ((xm2[3 * k] * pol[0] + xm2[3 * k + 1] * pol[1]) +
                       xm2[3 * k + 2] * pol[2]);
  }
}

// collision.py:capsule_box: two sphere-box probes at the capsule's (or
// cylinder's) axis end points, +half-length first, a frame each
template <class S>
__device__ __forceinline__ void capsule_box(const S* xp1, const S* xm1,
                                            const double* s1, const S* xp2,
                                            const S* xm2, const double* s2,
                                            S* dist, S (*pos)[3],
                                            S (*fr)[3][3]) {
  const S axis[3] = {xm1[2], xm1[5], xm1[8]};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const double h = s == 0 ? s1[1] : -s1[1];
    S e[3], n[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) e[k] = xp1[k] + axis[k] * h;
    sphere_box_core(e, s1[0], xp2, xm2, s2, dist[s], pos[s], n);
    frame_from_normal(n, fr[s]);
  }
}

// the slots of a pair in its collider's order (types A, B): geom A's pose
// (xpa, xma) and sizes sa, geom B's likewise; NFR frames (one per slot for
// the box probes, else one shared)
template <int A, int B, int NFR, class S>
__device__ __forceinline__ void collide(const S* xpa, const S* xma,
                                        const double* sa, const S* xpb,
                                        const S* xmb, const double* sb,
                                        S* dist, S (*pos)[3],
                                        S (&fr)[NFR][3][3]) {
  if constexpr (A == GEOM_PLANE && B == GEOM_CYLINDER) {
    plane_cylinder(xpa, xma, xpb, xmb, sb, dist, pos, fr[0]);
  } else if constexpr (A == GEOM_PLANE && B == GEOM_CAPSULE) {
    plane_capsule(xpa, xma, xpb, xmb, sb, dist, pos, fr[0]);
  } else if constexpr (A == GEOM_PLANE && B == GEOM_BOX) {
    plane_box(xpa, xma, xpb, xmb, sb, dist, pos, fr[0]);
  } else if constexpr (B == GEOM_BOX) {
    static_assert(A == GEOM_CAPSULE || A == GEOM_CYLINDER,
                  "the port's box pairs are plane-box, capsule-box and "
                  "cylinder-box");
    capsule_box(xpa, xma, sa, xpb, xmb, sb, dist, pos, fr);
  } else {
    static_assert((A == GEOM_CYLINDER && B == GEOM_CYLINDER) ||
                      (A == GEOM_CAPSULE && B == GEOM_CAPSULE),
                  "the port's narrow phase has plane-cylinder, "
                  "plane-capsule, capsule-capsule, cylinder-cylinder, "
                  "plane-box, capsule-box and cylinder-box pairs only");
    capsule_capsule(xpa, xma, sa, xpb, xmb, sb, dist, pos, fr[0]);
  }
}

// The rows of contact pair PI, written from row T::R_LIM + 4 first_slot(PI).
template <class T, int PI, class S>
__device__ __forceinline__ void pair_rows(
    const double* __restrict__ P, const S (&xpos)[T::NBODY][3],
    const S (&xquat)[T::NBODY][4], const S (&cdof)[T::NV][6], const S* v,
    Rows<T::R, T::ROW_W, S>& rows) {
  constexpr int t1 = T::pair_t1(PI), t2 = T::pair_t2(PI);
  constexpr int b1 = T::pair_b1(PI), b2 = T::pair_b2(PI);
  constexpr int NC = T::pair_ncon(PI), W = T::nsup(PI);
  constexpr int ROW0 = 2 * T::NLIM + 4 * T::first_slot(PI);
  // the support's dofs (4 bits each) and signs (a bit each), constants
  constexpr unsigned long long SUP = T::supp_code(PI);
  constexpr unsigned SGN = T::sgn_code(PI);
  const double* pp = P + T::PAIRB + PI * PAIR_STRIDE;
  const double* pc = pp + PAIR_CONST;
  S xp1[3], xm1[9], xp2[3], xm2[9];
  geom_pose(xpos[b1], xquat[b1], pp + G1_POS, pp + G1_QUAT, xp1, xm1);
  geom_pose(xpos[b2], xquat[b2], pp + G2_POS, pp + G2_QUAT, xp2, xm2);
  // a pair given the other way round: its collider with the geoms swapped,
  // each normal negated and its tangents kept (JAX _pair_slots_regs)
  constexpr bool FLIP = pair_flipped(t1, t2);
  constexpr int A = FLIP ? t2 : t1, Bt = FLIP ? t1 : t2;
  constexpr int NFR = Bt == GEOM_BOX && A != GEOM_PLANE ? NC : 1;
  S dist[MAX_SLOTS], pos[MAX_SLOTS][3], fr[NFR][3][3];
  if constexpr (FLIP) {
    collide<A, Bt, NFR>(xp2, xm2, pp + G2_SIZE, xp1, xm1, pp + G1_SIZE, dist,
                        pos, fr);
#pragma unroll
    for (int f = 0; f < NFR; ++f)
#pragma unroll
      for (int k = 0; k < 3; ++k) fr[f][0][k] = -fr[f][0][k];
  } else {
    collide<A, Bt, NFR>(xp1, xm1, pp + G1_SIZE, xp2, xm2, pp + G2_SIZE, dist,
                        pos, fr);
  }
  const double mu = pc[C_MU];
#pragma unroll
  for (int s = 0; s < NC; ++s) {
    const double inc = dist[s] < pc[L_MARGIN] ? 1.0 : 0.0;
    const S imp = dist[s] - pc[L_MARGIN];
    const S dd = impedance(pc, imp);
    const S kk = dd / pc[L_KDEN];
    const S Rr =
        at_least((1.0 - dd) / at_least(dd, 1e-6), 1e-9) * pc[C_RCONST];
    const S invR = inc / Rr;
    S J[3][W];  // Jn, Jt1, Jt2 over the support
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int i = code_dof(SUP, w);
      const double sg = ((SGN >> w) & 1u) ? 1.0 : -1.0;
      S wp[3], jac[3];
      cross3(cdof[i], pos[s], wp);
#pragma unroll
      for (int k = 0; k < 3; ++k) jac[k] = (cdof[i][3 + k] + wp[k]) * sg;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        J[a][w] = (fr[NFR == 1 ? 0 : s][a][0] * jac[0] +
                   fr[NFR == 1 ? 0 : s][a][1] * jac[1]) +
                  fr[NFR == 1 ? 0 : s][a][2] * jac[2];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ROW0 + 4 * s + e;
      const S* Jt = J[1 + e / 2];
      const double smu = (e % 2 == 0) ? mu : -mu;
      S vel = 0.0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const S c = J[0][w] + smu * Jt[w];
        rows.coef[r][w] = c;
        const S cv = c * v[code_dof(SUP, w)];
        vel = w == 0 ? cv : vel + cv;
      }
      rows.aref[r] = (-pc[L_B]) * vel - kk * imp;
      rows.invR[r] = invR;
    }
  }
}

template <class T, class S, int... PS>
__device__ __forceinline__ void contact_rows_of(
    const double* __restrict__ P, const S (&xpos)[T::NBODY][3],
    const S (&xquat)[T::NBODY][4], const S (&cdof)[T::NV][6], const S* v,
    Rows<T::R, T::ROW_W, S>& rows, std::integer_sequence<int, PS...>) {
  (pair_rows<T, PS>(P, xpos, xquat, cdof, v, rows), ...);
}

// Rows 2 NLIM .. R-1: every pair's slots in pair order, four rows each.
template <class T, class S>
__device__ __forceinline__ void contact_rows(
    const double* __restrict__ P, const S (&xpos)[T::NBODY][3],
    const S (&xquat)[T::NBODY][4], const S (&cdof)[T::NV][6], const S* v,
    Rows<T::R, T::ROW_W, S>& rows) {
  contact_rows_of<T>(P, xpos, xquat, cdof, v, rows,
                     std::make_integer_sequence<int, T::NPAIR>{});
}

}  // namespace trajopt
