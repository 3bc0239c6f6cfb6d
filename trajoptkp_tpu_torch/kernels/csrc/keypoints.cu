// K9a: adaptive keypoints and the per-lane slot plan, one thread per lane.
//
// Replaces the JAX lane program of the adaptive keypoint methods:
// trajoptkp_tpu/keypoints/methods.py:generate_keypoints_lanes:266 (the
// adaptive_jerk, adaptive_accel and velocity_change scans over time with
// (dof, lane) carries) and trajoptkp_tpu/solver/lanes.py:369-414 (the
// per-lane union of the keypoint times, its rank cap to K_max slots, the
// overflow count, the time-ordered slot assignment and every step's per-dof
// previous/next slot and lerp weight).  Plain twin:
// trajoptkp_tpu_torch/keypoints/methods.py (generate_keypoints, lane_plan),
// in the same operation order, so the two agree bit for bit.
//
// The selector is a template argument (0: a mask given, as iterative_error
// and the generic solve's auto-adjust give one; 1 adaptive_jerk; 2
// adaptive_accel; 3 velocity_change).  The sizes (H, n, nv, B), the
// thresholds, min_N, max_N, K_max and 1/dt are runtime arguments: the
// library is built once for every model.  A thread keeps its lane's per-dof
// counters in registers (loops over the fixed MAXN with a guard): the
// kernel is instantiated at MAXN 15 for the models up to 15 state dofs and
// at 31 for the larger (push_lcl's 19, push_mcl's 31)
// and walks the horizon twice: forwards for the mask, the slots and each
// dof's previous keypoint, backwards for its next keypoint and the weight.
// Pass 1 leaves each step's previous keypoint time in nslot; pass 2 reads
// it back and overwrites it.
//
// Precondition (every selector guarantees it): rows 0 and H-1 of the
// method's mask are keypoints for every dof, so a step's time is a kept
// slot exactly when some dof of the capped mask has a keypoint there.
//
// Bound: bytes.  Per lane it reads H n velocities (three times for the
// jerk profile, through L1) and writes the mask (1 byte), pslot, nslot (4)
// and w (8) per (t, dof) plus K_max slot times; 21 bytes per (t, dof) and a
// few operations each.  One thread per lane leaves the card mostly idle at
// B = 128 (a dependent scan of H steps): latency, not bandwidth, is what a
// faster version would attack (a warp per lane over the dofs).
#include <cuda_runtime.h>

namespace trajopt {

constexpr int MAXN_SMALL = 15;
constexpr int MAXN_LARGE = 31;

template <int SEL, int MAXN>
__global__ void __launch_bounds__(64)
keypoint_plan_kernel(const double* __restrict__ qvel,
                     const int* __restrict__ order,
                     const double* __restrict__ thr,
                     const unsigned char* __restrict__ mask_in, int min_N,
                     int max_N, int K_max, int time_slots, double inv_dt,
                     double pct_scale, int H, int n, int nv, int B,
                     unsigned char* __restrict__ mask,
                     long long* __restrict__ slot_t, int* __restrict__ count,
                     int* __restrict__ overflow, int* __restrict__ pslot,
                     int* __restrict__ nslot, double* __restrict__ w,
                     double* __restrict__ pct) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int ord[MAXN];
  double th[MAXN];
  int last[MAXN];        // adaptive: the last keypoint time
  int counter[MAXN];     // velocity_change: steps since the last keypoint
  double acc[MAXN];      // velocity_change: summed |velocity| since then
  double ldir[MAXN];     // velocity_change: the stored direction
  int prev_t[MAXN], prev_s[MAXN];
#pragma unroll
  for (int d = 0; d < MAXN; ++d) {
    ord[d] = d < n ? order[d] : 0;
    th[d] = (SEL != 0 && d < n) ? thr[d] : 0.0;
    last[d] = 0;
    counter[d] = 0;
    acc[d] = 0.0;
    ldir[d] = 0.0;
    prev_t[d] = 0;
    prev_s[d] = 0;
  }
  auto vel = [&](int t, int d) -> double {
    return qvel[(size_t(t) * nv + ord[d]) * B + b];
  };
  auto at = [&](int t, int d) -> size_t { return (size_t(t) * n + d) * B + b; };

  // pass 1: forwards
  int rank = 0, kept = 0, msum = 0;
#pragma unroll 1
  for (int t = 0; t < H; ++t) {
    bool m[MAXN];
    const bool end = t == 0 || t == H - 1;
#pragma unroll
    for (int d = 0; d < MAXN; ++d) {
      m[d] = false;
      if (d >= n) continue;
      if (SEL == 0) {
        m[d] = mask_in[at(t, d)] != 0;
      } else if (SEL == 1 || SEL == 2) {
        if (end) {
          m[d] = true;
        } else {
          double prof;
          if (SEL == 1) {
            // jerk_profile: zero in the last two rows
            if (t <= H - 3) {
              const double a0 = (vel(t + 1, d) - vel(t, d)) * inv_dt;
              const double a1 = (vel(t + 2, d) - vel(t + 1, d)) * inv_dt;
              prof = fabs((a1 - a0) * inv_dt);
            } else {
              prof = 0.0;
            }
          } else {
            prof = vel(t + 1, d) - vel(t, d);
          }
          const bool hit_thresh = (t - last[d] >= min_N) && (prof > th[d]);
          if (hit_thresh) last[d] = t;
          const bool hit_max = (t - last[d]) >= max_N;
          if (hit_max) last[d] = t;
          m[d] = hit_thresh || hit_max;
        }
      } else {
        if (t == 0) {
          m[d] = true;
        } else {
          const int c = counter[d] + 1;
          const double v = vel(t, d);
          const double cur = v - vel(t - 1, d);
          const double a = acc[d] + fabs(v);
          const bool ge_min = c >= min_N;
          const bool hit_acc = ge_min && (fabs(a) > th[d]);
          const bool hit_turn = ge_min && !hit_acc && (cur * ldir[d] < 0);
          if (!ge_min) ldir[d] = cur;
          const bool hit_max = !hit_acc && !hit_turn && (c >= max_N);
          const bool hit = hit_acc || hit_turn || hit_max;
          counter[d] = hit ? 0 : c;
          acc[d] = hit ? 0.0 : a;
          m[d] = hit || t == H - 1;
        }
      }
    }
    bool uni = false;
#pragma unroll
    for (int d = 0; d < MAXN; ++d) uni = uni || m[d];
    // rank cap: drop the latest middle times, keep t = H-1
    const bool keep = uni && (rank < K_max - 1 || t == H - 1);
    if (uni) ++rank;
    if (keep) {
      slot_t[size_t(kept) * B + b] = t;
      ++kept;
    }
#pragma unroll
    for (int d = 0; d < MAXN; ++d) {
      if (d >= n) continue;
      const bool f = (m[d] && keep) || end;
      mask[at(t, d)] = f;
      if (f) {
        ++msum;
        prev_t[d] = t;
        prev_s[d] = kept - 1;
      }
      pslot[at(t, d)] = time_slots ? prev_t[d] : prev_s[d];
      nslot[at(t, d)] = prev_t[d];
    }
  }
  count[b] = kept;
  overflow[b] = rank > K_max ? rank - K_max : 0;
  pct[b] = double(msum) * pct_scale;
  // padding slots: the earliest times without a slot (never read)
  int pad = kept;
#pragma unroll 1
  for (int t = 0; t < H && pad < K_max; ++t) {
    bool any = false;
    for (int d = 0; d < n; ++d) any = any || mask[at(t, d)];
    if (!any) slot_t[size_t(pad++) * B + b] = t;
  }

  // pass 2: backwards
  int next_t[MAXN], next_s[MAXN];
#pragma unroll
  for (int d = 0; d < MAXN; ++d) {
    next_t[d] = H - 1;
    next_s[d] = kept - 1;
  }
  int cum = kept - 1;
#pragma unroll 1
  for (int t = H - 1; t >= 0; --t) {
    bool f[MAXN];
    bool any = false;
#pragma unroll
    for (int d = 0; d < MAXN; ++d) {
      f[d] = d < n && mask[at(t, d)];
      any = any || f[d];
    }
#pragma unroll
    for (int d = 0; d < MAXN; ++d) {
      if (d >= n) continue;
      if (f[d]) {
        next_t[d] = t;
        next_s[d] = cum;
      }
      const int p = nslot[at(t, d)];
      const int span = next_t[d] - p;
      w[at(t, d)] = double(t - p) / double(span > 1 ? span : 1);
      nslot[at(t, d)] = time_slots ? next_t[d] : next_s[d];
    }
    if (any) --cum;
  }
}

}  // namespace trajopt

extern "C" int trajopt_keypoint_plan(
    const double* qvel, const int* order, const double* thr,
    const unsigned char* mask_in, int selector, int min_N, int max_N,
    int K_max, int time_slots, double inv_dt, double pct_scale, int H, int n,
    int nv, int B, unsigned char* mask, long long* slot_t, int* count,
    int* overflow, int* pslot, int* nslot, double* w, double* pct,
    void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > trajopt::MAXN_LARGE || H < 2 || K_max < 2 || K_max > H)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool small = n <= trajopt::MAXN_SMALL;
  const dim3 grid((B + 63) / 64), block(64);
  auto s = static_cast<cudaStream_t>(stream);
#define TRAJOPT_KP_LAUNCH_N(SEL, N)                                           \
  trajopt::keypoint_plan_kernel<SEL, N><<<grid, block, 0, s>>>(               \
      qvel, order, thr, mask_in, min_N, max_N, K_max, time_slots, inv_dt,     \
      pct_scale, H, n, nv, B, mask, slot_t, count, overflow, pslot, nslot, w, \
      pct)
#define TRAJOPT_KP_LAUNCH(SEL)                                                \
  if (small)                                                                  \
    TRAJOPT_KP_LAUNCH_N(SEL, trajopt::MAXN_SMALL);                            \
  else                                                                        \
    TRAJOPT_KP_LAUNCH_N(SEL, trajopt::MAXN_LARGE)
  switch (selector) {
    case 0: TRAJOPT_KP_LAUNCH(0); break;
    case 1: TRAJOPT_KP_LAUNCH(1); break;
    case 2: TRAJOPT_KP_LAUNCH(2); break;
    case 3: TRAJOPT_KP_LAUNCH(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRAJOPT_KP_LAUNCH
#undef TRAJOPT_KP_LAUNCH_N
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trajopt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
