// Kernel instances built into each library: one per model topology the
// port ships.  kernels/ops.py reads these lists to map a task to an
// instance (ops.instance_key computes the same key from the model, its
// state vector and its residual), so they are the one place a new topology
// is added.
//
// X(tag, NV, NU, NBODY, slide mask, free mask, parent code, body-dof code,
//   qpos-address code, limited mask, NDOF, state-dof code, NPAIR, pair code,
//   RES, RESA, RESB), the arguments of Topo (step.cuh): the joint of dof j
// is a slide when bit j of the slide mask is set, else a hinge, and limited
// when bit j of the limited mask is set (two constraint rows each); body b's
// joint is free when bit b of the free mask is set; the parent of body b
// (1..NBODY-1) is (parent code >> 4b) & 15, its first dof
// ((body-dof code >> 4b) & 15) - 1 (-1 for a body without a joint), its
// joint's first qpos (qpos-address code >> 4b) & 15; state dof k is qvel
// index (state-dof code >> 4k) & 15; contact pair p is the 16 bits
// (pair code >> 16p): geom1 type, geom2 type, geom1 body, geom2 body, 4
// bits each.  RES 0 is the joint-space residual over the first RESA joints
// and RESB controls; RES 1 the pushing FK residual of goal body RESA and
// end-effector site body RESB.
#pragma once

#define TRAJOPT_MODEL_INSTANCES(X)                                            \
  X(acrobot, 2, 1, 3, 0x0u, 0x0u, 0x100ull, 0x210ull, 0x100ull, 0x0u, 2,      \
    0x10ull, 0, 0x0ull, 0, 2, 1)                                              \
  X(pentabot, 5, 3, 6, 0x0u, 0x0u, 0x432100ull, 0x543210ull, 0x432100ull,     \
    0x0u, 5, 0x43210ull, 0, 0x0ull, 0, 5, 3)                                  \
  X(reaching, 7, 7, 10, 0x0u, 0x0u, 0x8765432100ull, 0x765432100ull,         \
    0x654321000ull, 0x7fu, 7, 0x6543210ull, 0, 0x0ull, 0, 7, 0)               \
  X(push_ncl, 13, 7, 11, 0x0u, 0x400u, 0x8765432100ull, 0x80765432100ull,    \
    0x70654321000ull, 0x7fu, 10, 0x9876543210ull, 3, 0xa955a0509050ull, 1,   \
    10, 9)

// Backward-pass instances, B(NX, NU) with NX = 2 NDOF of a model above.
#define TRAJOPT_BP_INSTANCES(B) \
  B(4, 1)                       \
  B(10, 3)                      \
  B(14, 7)                      \
  B(20, 7)
