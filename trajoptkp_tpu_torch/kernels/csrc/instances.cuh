// Kernel instances built into each library: one per model topology the
// port ships.  kernels/ops.py reads these lists to map a model to its
// instance, so they are the one place a new topology is added.
//
// X(tag, NV, NU, slide-joint mask, parent code): joint j (body j+1) is a
// slide when bit j of the mask is set, else a hinge; the parent of body b
// (1..NV) is (code >> 4b) & 15.
#pragma once

#define TRAJOPT_MODEL_INSTANCES(X)      \
  X(acrobot, 2, 1, 0x0u, 0x100ull)      \
  X(pentabot, 5, 3, 0x0u, 0x432100ull)

// Backward-pass instances, B(NX, NU) with NX = 2 NV of a model above.
#define TRAJOPT_BP_INSTANCES(B) \
  B(4, 1)                       \
  B(10, 3)
