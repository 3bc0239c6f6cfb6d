// Kernel instances: one per model topology the port ships.  kernels/ops.py
// and kernels/build.py read these lists to map a task to an instance
// (ops.instance_key computes the same tables from the model, its state
// vector and its residual; ops.instance_line writes a task's entry, with
// kernels/topology.py), so they are the one place a new topology is added.
// The build compiles each instance of each library by its own nvcc, naming
// it with -DTRAJOPT_ONLY, so that the instances compile side by side.
//
// An entry is a struct of C++17 static constexpr tables, sized by the
// instance, and its X entry naming the tag and the struct; step.cuh's
// Topo reads the struct (its comment lists the tables).  RES 0 is the
// joint-space residual over the first RESARGS[0] joints and RESARGS[1]
// controls; RES 1 the pushing FK residual of goal body RESARGS[0],
// end-effector site body RESARGS[1] and the obstacle bodies after them;
// RES 2 the residual of selected coordinates, RESARGS[k] indexing [qpos,
// qvel, ctrl]; RES 3 and 4 box_sweep's and threeD_push's FK residuals of
// box body RESARGS[0] and end-effector site body RESARGS[1].  The residual
// is not read by the step alone: instances whose tables differ in RES and
// RESARGS only share their ad_jacobian and fd_jacobian libraries, built
// once for the first of them (kernels/build.py:step_shared).  push_ccl has
// push_lcl's tables (the constrained corridor differs in the model's
// numbers and the task's constants), so it runs push_lcl's instance.
#pragma once

struct Topo_acrobot {
  static constexpr int NV = 2;
  static constexpr int NU = 1;
  static constexpr int NBODY = 3;
  static constexpr int NDOF = 2;
  static constexpr int NPAIR = 0;
  static constexpr int RES = 0;
  static constexpr int PARENT[3] = {0, 0, 1};
  static constexpr int BODY_DOF[3] = {-1, 0, 1};
  static constexpr int BODY_NDOF[3] = {0, 1, 1};
  static constexpr int BODY_QADR[3] = {0, 0, 1};
  static constexpr int FREE[3] = {0, 0, 0};
  static constexpr int SLIDE[2] = {0, 0};
  static constexpr int LIMITED[2] = {0, 0};
  static constexpr int DOF_BODY[2] = {1, 2};
  static constexpr int DOF_Q[2] = {0, 1};
  static constexpr int SV[2] = {0, 1};
  static constexpr int RESARGS[2] = {2, 1};
  static constexpr int PAIRS[1][4] = {{0, 0, 0, 0}};
};
#define TRAJOPT_MODEL_acrobot(X) X(acrobot, Topo_acrobot)

struct Topo_pentabot {
  static constexpr int NV = 5;
  static constexpr int NU = 3;
  static constexpr int NBODY = 6;
  static constexpr int NDOF = 5;
  static constexpr int NPAIR = 6;
  static constexpr int RES = 0;
  static constexpr int PARENT[6] = {0, 0, 1, 2, 3, 4};
  static constexpr int BODY_DOF[6] = {-1, 0, 1, 2, 3, 4};
  static constexpr int BODY_NDOF[6] = {0, 1, 1, 1, 1, 1};
  static constexpr int BODY_QADR[6] = {0, 0, 1, 2, 3, 4};
  static constexpr int FREE[6] = {0, 0, 0, 0, 0, 0};
  static constexpr int SLIDE[5] = {0, 0, 0, 0, 0};
  static constexpr int LIMITED[5] = {0, 0, 0, 0, 0};
  static constexpr int DOF_BODY[5] = {1, 2, 3, 4, 5};
  static constexpr int DOF_Q[5] = {0, 1, 2, 3, 4};
  static constexpr int SV[5] = {0, 1, 2, 3, 4};
  static constexpr int RESARGS[2] = {5, 3};
  static constexpr int PAIRS[6][4] = {{3, 3, 1, 3}, {3, 3, 1, 4}, {3, 3, 1, 5},
      {3, 3, 2, 4}, {3, 3, 2, 5}, {3, 3, 3, 5}};
};
#define TRAJOPT_MODEL_pentabot(X) X(pentabot, Topo_pentabot)

struct Topo_reaching {
  static constexpr int NV = 7;
  static constexpr int NU = 7;
  static constexpr int NBODY = 10;
  static constexpr int NDOF = 7;
  static constexpr int NPAIR = 0;
  static constexpr int RES = 0;
  static constexpr int PARENT[10] = {0, 0, 1, 2, 3, 4, 5, 6, 7, 8};
  static constexpr int BODY_DOF[10] = {-1, -1, 0, 1, 2, 3, 4, 5, 6, -1};
  static constexpr int BODY_NDOF[10] = {0, 0, 1, 1, 1, 1, 1, 1, 1, 0};
  static constexpr int BODY_QADR[10] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 0};
  static constexpr int FREE[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  static constexpr int SLIDE[7] = {0, 0, 0, 0, 0, 0, 0};
  static constexpr int LIMITED[7] = {1, 1, 1, 1, 1, 1, 1};
  static constexpr int DOF_BODY[7] = {2, 3, 4, 5, 6, 7, 8};
  static constexpr int DOF_Q[7] = {0, 1, 2, 3, 4, 5, 6};
  static constexpr int SV[7] = {0, 1, 2, 3, 4, 5, 6};
  static constexpr int RESARGS[2] = {7, 0};
  static constexpr int PAIRS[1][4] = {{0, 0, 0, 0}};
};
#define TRAJOPT_MODEL_reaching(X) X(reaching, Topo_reaching)

struct Topo_push_ncl {
  static constexpr int NV = 13;
  static constexpr int NU = 7;
  static constexpr int NBODY = 11;
  static constexpr int NDOF = 10;
  static constexpr int NPAIR = 3;
  static constexpr int RES = 1;
  static constexpr int PARENT[11] = {0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 0};
  static constexpr int BODY_DOF[11] = {-1, -1, 0, 1, 2, 3, 4, 5, 6, -1, 7};
  static constexpr int BODY_NDOF[11] = {0, 0, 1, 1, 1, 1, 1, 1, 1, 0, 6};
  static constexpr int BODY_QADR[11] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 0, 7};
  static constexpr int FREE[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1};
  static constexpr int SLIDE[13] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  static constexpr int LIMITED[13] = {1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0};
  static constexpr int DOF_BODY[13] = {2, 3, 4, 5, 6, 7, 8, 10, 10, 10, 10, 10,
      10};
  static constexpr int DOF_Q[13] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12};
  static constexpr int SV[10] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9};
  static constexpr int RESARGS[2] = {10, 9};
  static constexpr int PAIRS[3][4] = {{0, 5, 0, 9}, {0, 5, 0, 10}, {5, 5, 9,
      10}};
};
#define TRAJOPT_MODEL_push_ncl(X) X(push_ncl, Topo_push_ncl)

struct Topo_walker {
  static constexpr int NV = 9;
  static constexpr int NU = 6;
  static constexpr int NBODY = 8;
  static constexpr int NDOF = 9;
  static constexpr int NPAIR = 22;
  static constexpr int RES = 2;
  static constexpr int PARENT[8] = {0, 0, 1, 2, 3, 1, 5, 6};
  static constexpr int BODY_DOF[8] = {-1, 0, 3, 4, 5, 6, 7, 8};
  static constexpr int BODY_NDOF[8] = {0, 3, 1, 1, 1, 1, 1, 1};
  static constexpr int BODY_QADR[8] = {0, 0, 3, 4, 5, 6, 7, 8};
  static constexpr int FREE[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  static constexpr int SLIDE[9] = {1, 1, 0, 0, 0, 0, 0, 0, 0};
  static constexpr int LIMITED[9] = {0, 0, 0, 1, 1, 1, 1, 1, 1};
  static constexpr int DOF_BODY[9] = {1, 1, 1, 2, 3, 4, 5, 6, 7};
  static constexpr int DOF_Q[9] = {0, 1, 2, 3, 4, 5, 6, 7, 8};
  static constexpr int SV[9] = {0, 1, 2, 3, 4, 5, 6, 7, 8};
  static constexpr int RESARGS[9] = {0, 2, 10, 18, 19, 20, 21, 22, 23};
  static constexpr int PAIRS[22][4] = {{0, 3, 0, 1}, {0, 3, 0, 2}, {0, 3, 0,
      3}, {0, 3, 0, 4}, {0, 3, 0, 5}, {0, 3, 0, 6}, {0, 3, 0, 7}, {3, 3, 1, 3},
      {3, 3, 1, 4}, {3, 3, 1, 6}, {3, 3, 1, 7}, {3, 3, 2, 4}, {3, 3, 2, 5}, {3,
      3, 2, 6}, {3, 3, 2, 7}, {3, 3, 3, 5}, {3, 3, 3, 6}, {3, 3, 3, 7}, {3, 3,
      4, 5}, {3, 3, 4, 6}, {3, 3, 4, 7}, {3, 3, 5, 7}};
};
#define TRAJOPT_MODEL_walker(X) X(walker, Topo_walker)

struct Topo_box_sweep {
  static constexpr int NV = 13;
  static constexpr int NU = 7;
  static constexpr int NBODY = 11;
  static constexpr int NDOF = 13;
  static constexpr int NPAIR = 3;
  static constexpr int RES = 3;
  static constexpr int PARENT[11] = {0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 0};
  static constexpr int BODY_DOF[11] = {-1, -1, 0, 1, 2, 3, 4, 5, 6, -1, 7};
  static constexpr int BODY_NDOF[11] = {0, 0, 1, 1, 1, 1, 1, 1, 1, 0, 6};
  static constexpr int BODY_QADR[11] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 0, 7};
  static constexpr int FREE[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1};
  static constexpr int SLIDE[13] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  static constexpr int LIMITED[13] = {1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0};
  static constexpr int DOF_BODY[13] = {2, 3, 4, 5, 6, 7, 8, 10, 10, 10, 10, 10,
      10};
  static constexpr int DOF_Q[13] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12};
  static constexpr int SV[13] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12};
  static constexpr int RESARGS[2] = {10, 9};
  static constexpr int PAIRS[3][4] = {{0, 5, 0, 9}, {0, 6, 0, 10}, {5, 6, 9,
      10}};
};
#define TRAJOPT_MODEL_box_sweep(X) X(box_sweep, Topo_box_sweep)

struct Topo_threeD_push {
  static constexpr int NV = 13;
  static constexpr int NU = 7;
  static constexpr int NBODY = 11;
  static constexpr int NDOF = 13;
  static constexpr int NPAIR = 3;
  static constexpr int RES = 4;
  static constexpr int PARENT[11] = {0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 0};
  static constexpr int BODY_DOF[11] = {-1, -1, 0, 1, 2, 3, 4, 5, 6, -1, 7};
  static constexpr int BODY_NDOF[11] = {0, 0, 1, 1, 1, 1, 1, 1, 1, 0, 6};
  static constexpr int BODY_QADR[11] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 0, 7};
  static constexpr int FREE[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1};
  static constexpr int SLIDE[13] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  static constexpr int LIMITED[13] = {1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0};
  static constexpr int DOF_BODY[13] = {2, 3, 4, 5, 6, 7, 8, 10, 10, 10, 10, 10,
      10};
  static constexpr int DOF_Q[13] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12};
  static constexpr int SV[13] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12};
  static constexpr int RESARGS[2] = {10, 9};
  static constexpr int PAIRS[3][4] = {{0, 5, 0, 9}, {0, 6, 0, 10}, {5, 6, 9,
      10}};
};
#define TRAJOPT_MODEL_threeD_push(X) X(threeD_push, Topo_threeD_push)

struct Topo_push_lcl {
  static constexpr int NV = 31;
  static constexpr int NU = 7;
  static constexpr int NBODY = 14;
  static constexpr int NDOF = 19;
  static constexpr int NPAIR = 15;
  static constexpr int RES = 1;
  static constexpr int PARENT[14] = {0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 0, 0, 0, 0};
  static constexpr int BODY_DOF[14] = {-1, -1, 0, 1, 2, 3, 4, 5, 6, -1, 7, 13,
      19, 25};
  static constexpr int BODY_NDOF[14] = {0, 0, 1, 1, 1, 1, 1, 1, 1, 0, 6, 6, 6,
      6};
  static constexpr int BODY_QADR[14] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 0, 7, 14,
      21, 28};
  static constexpr int FREE[14] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1};
  static constexpr int SLIDE[31] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  static constexpr int LIMITED[31] = {1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0,
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  static constexpr int DOF_BODY[31] = {2, 3, 4, 5, 6, 7, 8, 10, 10, 10, 10, 10,
      10, 11, 11, 11, 11, 11, 11, 12, 12, 12, 12, 12, 12, 13, 13, 13, 13, 13,
      13};
  static constexpr int DOF_Q[31] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
      14, 15, 16, 17, 18, 19, 21, 22, 23, 24, 25, 26, 28, 29, 30, 31, 32, 33};
  static constexpr int SV[19] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 13, 14, 15, 19,
      20, 21, 25, 26, 27};
  static constexpr int RESARGS[5] = {10, 9, 11, 12, 13};
  static constexpr int PAIRS[15][4] = {{0, 5, 0, 9}, {0, 5, 0, 10}, {0, 5, 0,
      11}, {0, 5, 0, 12}, {0, 5, 0, 13}, {5, 5, 9, 10}, {5, 5, 9, 11}, {5, 5,
      9, 12}, {5, 5, 9, 13}, {5, 5, 10, 11}, {5, 5, 10, 12}, {5, 5, 10, 13},
      {5, 5, 11, 12}, {5, 5, 11, 13}, {5, 5, 12, 13}};
};
#define TRAJOPT_MODEL_push_lcl(X) X(push_lcl, Topo_push_lcl)

#define TRAJOPT_MODEL_INSTANCES(X)                                            \
  TRAJOPT_MODEL_acrobot(X) TRAJOPT_MODEL_pentabot(X)                          \
      TRAJOPT_MODEL_reaching(X) TRAJOPT_MODEL_push_ncl(X)                     \
          TRAJOPT_MODEL_walker(X) TRAJOPT_MODEL_box_sweep(X)                  \
              TRAJOPT_MODEL_threeD_push(X) TRAJOPT_MODEL_push_lcl(X)

// Backward-pass instances, B(NX, NU) with NX = 2 NDOF of a model above.
#define TRAJOPT_BP_nx4_nu1(B) B(4, 1)
#define TRAJOPT_BP_nx10_nu3(B) B(10, 3)
#define TRAJOPT_BP_nx14_nu7(B) B(14, 7)
#define TRAJOPT_BP_nx20_nu7(B) B(20, 7)
#define TRAJOPT_BP_nx18_nu6(B) B(18, 6)
#define TRAJOPT_BP_nx26_nu7(B) B(26, 7)
#define TRAJOPT_BP_nx38_nu7(B) B(38, 7)
#define TRAJOPT_BP_INSTANCES(B)                                               \
  TRAJOPT_BP_nx4_nu1(B) TRAJOPT_BP_nx10_nu3(B) TRAJOPT_BP_nx14_nu7(B)         \
      TRAJOPT_BP_nx20_nu7(B) TRAJOPT_BP_nx18_nu6(B) TRAJOPT_BP_nx26_nu7(B)    \
          TRAJOPT_BP_nx38_nu7(B)

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
