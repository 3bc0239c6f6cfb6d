// Kernel instances: one per model topology the port ships.  kernels/ops.py
// reads these lists to map a task to an instance (ops.instance_key computes
// the same key from the model, its state vector and its residual;
// ops.instance_line writes a task's entry), so they are the one place a new
// topology is added.  The build (kernels/build.py) compiles each instance of
// each library by its own nvcc, naming it with -DTRAJOPT_ONLY, so that the
// instances compile side by side.
//
// An entry holds the tag and the arguments of Topo (step.cuh): NV, NU,
// NBODY, slide mask, free mask, parent code, body-dof code, body-ndof code,
// qpos-address code, limited mask, NDOF, state-dof code, RES, RESA, RESB,
// then one code per contact pair.  The joint of dof j is a slide when bit j
// of the slide mask is set, else a hinge, and limited when bit j of the
// limited mask is set (two constraint rows each); body b's joint is free
// when bit b of the free mask is set; the parent of body b (1..NBODY-1) is
// (parent code >> 4b) & 15, its first dof ((body-dof code >> 4b) & 15) - 1
// (-1 for a body without a joint), its number of dofs (body-ndof code >> 4b)
// & 15, its first joint's first qpos (qpos-address code >> 4b) & 15; state
// dof k is qvel index (state-dof code >> 4k) & 15; a contact pair's code is
// 16 bits: geom1 type, geom2 type, geom1 body, geom2 body, 4 bits each.
// RES 0 is the joint-space residual over the first RESA joints and RESB
// controls; RES 1 the pushing FK residual of goal body RESA and
// end-effector site body RESB; RES 2 the residual of RESA selected
// coordinates, entry k of RESB (5 bits each) indexing [qpos, qvel, ctrl];
// RES 3 and 4 box_sweep's and threeD_push's FK residuals of box body RESA
// and end-effector site body RESB.  The residual is not read by the step
// alone: instances that differ in RES, RESA and RESB only share their
// ad_jacobian and fd_jacobian libraries, built once for the first of them
// (kernels/build.py:step_shared).
#pragma once

#define TRAJOPT_MODEL_acrobot(X)                                               \
  X(acrobot, 2, 1, 3, 0x0u, 0x0u, 0x100ull, 0x210ull, 0x110ull, 0x100ull,     \
    0x0u, 2, 0x10ull, 0, 2, 0x1ull)
#define TRAJOPT_MODEL_pentabot(X)                                              \
  X(pentabot, 5, 3, 6, 0x0u, 0x0u, 0x432100ull, 0x543210ull, 0x111110ull,     \
    0x432100ull, 0x0u, 5, 0x43210ull, 0, 5, 0x3ull, 0x3133u, 0x4133u,         \
    0x5133u, 0x4233u, 0x5233u, 0x5333u)
#define TRAJOPT_MODEL_reaching(X)                                              \
  X(reaching, 7, 7, 10, 0x0u, 0x0u, 0x8765432100ull, 0x765432100ull,         \
    0x111111100ull, 0x654321000ull, 0x7fu, 7, 0x6543210ull, 0, 7, 0x0ull)
#define TRAJOPT_MODEL_push_ncl(X)                                              \
  X(push_ncl, 13, 7, 11, 0x0u, 0x400u, 0x8765432100ull, 0x80765432100ull,    \
    0x60111111100ull, 0x70654321000ull, 0x7fu, 10, 0x9876543210ull, 1, 10,   \
    0x9ull, 0x9050u, 0xa050u, 0xa955u)
#define TRAJOPT_MODEL_walker(X)                                                \
  X(walker, 9, 6, 8, 0x3u, 0x0u, 0x65132100ull, 0x98765410ull, 0x11111130ull, \
    0x87654300ull, 0x1f8u, 9, 0x876543210ull, 2, 9, 0x17b569392840ull,       \
    0x1030u, 0x2030u, 0x3030u, 0x4030u, 0x5030u, 0x6030u, 0x7030u, 0x3133u,   \
    0x4133u, 0x6133u, 0x7133u, 0x4233u, 0x5233u, 0x6233u, 0x7233u, 0x5333u,   \
    0x6333u, 0x7333u, 0x5433u, 0x6433u, 0x7433u, 0x7533u)
#define TRAJOPT_MODEL_box_sweep(X)                                             \
  X(box_sweep, 13, 7, 11, 0x0u, 0x400u, 0x8765432100ull, 0x80765432100ull,   \
    0x60111111100ull, 0x70654321000ull, 0x7fu, 13, 0xcba9876543210ull, 3,    \
    10, 0x9ull, 0x9050u, 0xa060u, 0xa965u)
#define TRAJOPT_MODEL_threeD_push(X)                                           \
  X(threeD_push, 13, 7, 11, 0x0u, 0x400u, 0x8765432100ull,                   \
    0x80765432100ull, 0x60111111100ull, 0x70654321000ull, 0x7fu, 13,         \
    0xcba9876543210ull, 4, 10, 0x9ull, 0x9050u, 0xa060u, 0xa965u)

#define TRAJOPT_MODEL_INSTANCES(X)                                            \
  TRAJOPT_MODEL_acrobot(X) TRAJOPT_MODEL_pentabot(X)                          \
      TRAJOPT_MODEL_reaching(X) TRAJOPT_MODEL_push_ncl(X)                     \
          TRAJOPT_MODEL_walker(X) TRAJOPT_MODEL_box_sweep(X)                  \
              TRAJOPT_MODEL_threeD_push(X)

// Backward-pass instances, B(NX, NU) with NX = 2 NDOF of a model above.
#define TRAJOPT_BP_nx4_nu1(B) B(4, 1)
#define TRAJOPT_BP_nx10_nu3(B) B(10, 3)
#define TRAJOPT_BP_nx14_nu7(B) B(14, 7)
#define TRAJOPT_BP_nx20_nu7(B) B(20, 7)
#define TRAJOPT_BP_nx18_nu6(B) B(18, 6)
#define TRAJOPT_BP_nx26_nu7(B) B(26, 7)
#define TRAJOPT_BP_INSTANCES(B)                                               \
  TRAJOPT_BP_nx4_nu1(B) TRAJOPT_BP_nx10_nu3(B) TRAJOPT_BP_nx14_nu7(B)         \
      TRAJOPT_BP_nx20_nu7(B) TRAJOPT_BP_nx18_nu6(B) TRAJOPT_BP_nx26_nu7(B)

// The instances a translation unit defines: with -DTRAJOPT_ONLY=
// TRAJOPT_MODEL_<tag> (or TRAJOPT_BP_nx<NX>_nu<NU>) the one named, else all.
#ifdef TRAJOPT_ONLY
#define TRAJOPT_INSTANCES(X) TRAJOPT_ONLY(X)
#define TRAJOPT_BP_BUILT(B) TRAJOPT_ONLY(B)
#else
#define TRAJOPT_INSTANCES(X) TRAJOPT_MODEL_INSTANCES(X)
#define TRAJOPT_BP_BUILT(B) TRAJOPT_BP_INSTANCES(B)
#endif

// Every library names CUDA's errors for its wrapper (kernels/ops.py).
#define TRAJOPT_DEFINE_ERROR_STRING                                           \
  extern "C" const char* trajopt_error_string(int err) {                      \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                 \
  }
