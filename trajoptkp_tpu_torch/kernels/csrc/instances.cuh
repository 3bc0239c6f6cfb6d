// Kernel instances built into each library: one per model topology the
// port ships.  kernels/ops.py reads these lists to map a model and its
// residual to an instance, so they are the one place a new topology is
// added.
//
// X(tag, NV, NU, NJ, NUR, NBODY, slide mask, parent code, body-dof code,
// limited mask), the arguments of Topo (step.cuh): the joint-space residual
// covers the first NJ joints and NUR controls; the joint of dof j is a slide
// when bit j of the slide mask is set, else a hinge, and limited when bit j
// of the limited mask is set (two constraint rows each); the parent of body
// b (1..NBODY-1) is (parent code >> 4b) & 15 and its dof is
// ((body-dof code >> 4b) & 15) - 1, -1 for a body without a joint.
#pragma once

#define TRAJOPT_MODEL_INSTANCES(X)                                         \
  X(acrobot, 2, 1, 2, 1, 3, 0x0u, 0x100ull, 0x210ull, 0x0u)                \
  X(pentabot, 5, 3, 5, 3, 6, 0x0u, 0x432100ull, 0x543210ull, 0x0u)         \
  X(reaching, 7, 7, 7, 0, 10, 0x0u, 0x8765432100ull, 0x0765432100ull, 0x7fu)

// Backward-pass instances, B(NX, NU) with NX = 2 NV of a model above.
#define TRAJOPT_BP_INSTANCES(B) \
  B(4, 1)                       \
  B(10, 3)                      \
  B(14, 7)
