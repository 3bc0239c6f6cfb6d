// Small per-thread 3-vector and quaternion helpers shared by the step
// (step.cuh), the narrow phase and contact rows (contact.cuh) and the
// residuals (residuals.cuh).  Their plain twins are
// trajoptkp_tpu_torch/utils/math.py, operation for operation (quaternions
// wxyz, sums left to right), in double or in dual numbers (dual.cuh):
// each pointer's scalar is its own template argument, so that a model
// constant (double) meets a state value (double or Dual).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <utility>

#include "dual.cuh"
#include "linalg.cuh"

namespace trajopt {

// the scalar of a product of an A and a B: double, or Dual when either is
template <class A, class B>
using prod_t = decltype(std::declval<A>() * std::declval<B>());

template <class A, class B>
__device__ __forceinline__ prod_t<A, B> dot3(const A* a, const B* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <class A, class B, class O>
__device__ __forceinline__ void cross3(const A* a, const B* b, O* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <class A, class B, class O>
__device__ __forceinline__ void quat_mul(const A* a, const B* b, O* o) {
  const auto w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  const auto x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  const auto y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  const auto z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// R(q) v = v + 2 w (u x v) + 2 u x (u x v)
template <class A, class B, class O>
__device__ __forceinline__ void quat_rotate(const A* q, const B* v, O* o) {
  using P = prod_t<A, B>;
  const A u[3] = {q[1], q[2], q[3]};
  P uv[3], uuv[3];
  cross3(u, v, uv);
  cross3(u, uv, uuv);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.0 * (q[0] * uv[k] + uuv[k]);
}

template <class A, class O>
__device__ __forceinline__ void quat_to_mat(const A* q, O* R) {
  const A w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z);
  R[2] = 2 * (x * z + w * y);     R[3] = 2 * (x * y + w * z);
  R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y);     R[7] = 2 * (y * z + w * x);
  R[8] = 1 - 2 * (x * x + y * y);
}

// rotation vector -> quaternion, with the series form near zero
template <class A, class O>
__device__ __forceinline__ void quat_exp(const A* v, O* o) {
  const A sumsq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  A w, s;
  if (sumsq < 1e-18) {
    s = 0.5 - sumsq * (1.0 / 48.0);
    w = 1.0 - sumsq / 8.0;
  } else {
    const A angle = sqrt(sumsq);
    const A half = 0.5 * angle;
    s = sin(half) / angle;
    w = cos(half);
  }
  o[0] = w; o[1] = v[0] * s; o[2] = v[1] * s; o[3] = v[2] * s;
}

// q / max(|q|, 1e-12)
template <class A, class O>
__device__ __forceinline__ void quat_normalize(const A* q, O* o) {
  const A n =
      at_least(sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]),
               1e-12);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = q[k] / n;
}

}  // namespace trajopt
