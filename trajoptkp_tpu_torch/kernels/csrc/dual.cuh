// Dual numbers for forward-mode derivatives of the step (K5ad,
// ad_jacobian.cu): a value and one tangent, in double precision.
//
// Each operation computes its tangent with the formula PyTorch's forward
// mode uses for the same operation, in the same order, so that a kernel in
// dual numbers and the plain twin under torch.autograd.forward_ad round
// alike (derivs/ad.py):
//   a + b: a' + b'          a - b: a' - b'          -a: -a'
//   a * b: b' a + a' b      a / b: (a' - b' (a / b)) / b
//   c / b (c a constant tensor): (-(b' (c / b))) / b
//   recip(b) (PyTorch's `1.0 / b`, reciprocal times 1.0): (-b') (r r)
//   sqrt(a): a' / (2 sqrt(a))   sin(a): a' cos(a)   cos(a): a' (-sin(a))
//   fabs(a): a' sgn(a)
//   atan2(y, x): (-y x' + x y') / (y y + x x)
//   at_least, clip (torch.maximum, torch.minimum): a' w, w = 1 inside,
//     0 outside, 0.5 exactly at a bound (JAX's rule for jnp.clip too)
// A constant operand (a double) contributes no tangent term.  Comparisons
// read the value, so branches and gates follow the primal; a branch
// selects its tangent with its value, as torch.where does.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace trajopt {

struct Dual {
  double v, d;
  Dual() = default;
  __host__ __device__ constexpr Dual(double x) : v(x), d(0.0) {}
  __host__ __device__ constexpr Dual(double x, double t) : v(x), d(t) {}
};

template <class S>
struct is_dual : std::false_type {};
template <>
struct is_dual<Dual> : std::true_type {};

__host__ __device__ __forceinline__ double val(double x) { return x; }
__host__ __device__ __forceinline__ double val(const Dual& x) { return x.v; }

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  return Dual(a.v + b.v, a.d + b.d);
}
__device__ __forceinline__ Dual operator+(const Dual& a, double c) {
  return Dual(a.v + c, a.d);
}
__device__ __forceinline__ Dual operator+(double c, const Dual& b) {
  return Dual(c + b.v, b.d);
}
__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  return Dual(a.v - b.v, a.d - b.d);
}
__device__ __forceinline__ Dual operator-(const Dual& a, double c) {
  return Dual(a.v - c, a.d);
}
__device__ __forceinline__ Dual operator-(double c, const Dual& b) {
  return Dual(c - b.v, -b.d);
}
__device__ __forceinline__ Dual operator-(const Dual& a) {
  return Dual(-a.v, -a.d);
}
__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  return Dual(a.v * b.v, b.d * a.v + a.d * b.v);
}
__device__ __forceinline__ Dual operator*(const Dual& a, double c) {
  return Dual(a.v * c, a.d * c);
}
__device__ __forceinline__ Dual operator*(double c, const Dual& b) {
  return Dual(c * b.v, b.d * c);
}
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  const double r = a.v / b.v;
  return Dual(r, (a.d - b.d * r) / b.v);
}
__device__ __forceinline__ Dual operator/(const Dual& a, double c) {
  return Dual(a.v / c, a.d / c);
}
__device__ __forceinline__ Dual operator/(double c, const Dual& b) {
  const double r = c / b.v;
  return Dual(r, (-(b.d * r)) / b.v);
}
__device__ __forceinline__ Dual& operator+=(Dual& a, const Dual& b) {
  return a = a + b;
}
__device__ __forceinline__ Dual& operator+=(Dual& a, double c) {
  return a = a + c;
}
__device__ __forceinline__ Dual& operator-=(Dual& a, const Dual& b) {
  return a = a - b;
}

#define TRAJOPT_DUAL_COMPARE(OP)                                              \
  __device__ __forceinline__ bool operator OP(const Dual& a, const Dual& b) { \
    return a.v OP b.v;                                                        \
  }                                                                           \
  __device__ __forceinline__ bool operator OP(const Dual& a, double c) {      \
    return a.v OP c;                                                          \
  }                                                                           \
  __device__ __forceinline__ bool operator OP(double c, const Dual& b) {      \
    return c OP b.v;                                                          \
  }
TRAJOPT_DUAL_COMPARE(<)
TRAJOPT_DUAL_COMPARE(>)
TRAJOPT_DUAL_COMPARE(<=)
TRAJOPT_DUAL_COMPARE(>=)
#undef TRAJOPT_DUAL_COMPARE

// the double forms, so that an unqualified call in namespace trajopt with a
// double argument finds them and not the Dual overloads below
__device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
__device__ __forceinline__ double sin(double x) { return ::sin(x); }
__device__ __forceinline__ double cos(double x) { return ::cos(x); }
__device__ __forceinline__ double fabs(double x) { return ::fabs(x); }
__device__ __forceinline__ bool isnan(double x) { return ::isnan(x); }
__device__ __forceinline__ double atan2(double y, double x) {
  return ::atan2(y, x);
}

__device__ __forceinline__ Dual sqrt(const Dual& a) {
  const double r = ::sqrt(a.v);
  return Dual(r, a.d / (2.0 * r));
}
__device__ __forceinline__ Dual sin(const Dual& a) {
  return Dual(::sin(a.v), a.d * ::cos(a.v));
}
__device__ __forceinline__ Dual cos(const Dual& a) {
  return Dual(::cos(a.v), a.d * (-::sin(a.v)));
}
__device__ __forceinline__ Dual fabs(const Dual& a) {
  const double sg =
      a.v > 0.0 ? 1.0 : (a.v < 0.0 ? -1.0 : (a.v == 0.0 ? 0.0 : a.v));
  return Dual(::fabs(a.v), a.d * sg);
}
__device__ __forceinline__ bool isnan(const Dual& a) { return ::isnan(a.v); }
__device__ __forceinline__ Dual atan2(const Dual& y, const Dual& x) {
  return Dual(::atan2(y.v, x.v),
              ((-y.v) * x.d + x.v * y.d) / (y.v * y.v + x.v * x.v));
}
__device__ __forceinline__ Dual atan2(double y, const Dual& x) {
  return atan2(Dual(y), x);
}

// max(x, lo) and min(max(x, lo), hi) keeping NaN, with the tie rule of
// torch.maximum / torch.minimum and of JAX's lax.max / lax.min (jnp.clip):
// a tangent exactly at a bound is halved (linalg.cuh has the double forms)
__device__ __forceinline__ Dual at_least(const Dual& x, double lo) {
  const double w = x.v == lo ? 0.5 : (x.v > lo ? 1.0 : 0.0);
  return Dual(x.v < lo ? lo : x.v, w * x.d);
}
__device__ __forceinline__ Dual clip(const Dual& x, double lo, double hi) {
  const Dual m = at_least(x, lo);
  const double w = m.v == hi ? 0.5 : (m.v < hi ? 1.0 : 0.0);
  return Dual(m.v > hi ? hi : m.v, w * m.d);
}

// PyTorch's `1.0 / x` (reciprocal, then times 1.0)
__device__ __forceinline__ double recip(double x) { return 1.0 / x; }
__device__ __forceinline__ Dual recip(const Dual& x) {
  const double r = 1.0 / x.v;
  return Dual(r, (-x.d) * (r * r));
}

}  // namespace trajopt
