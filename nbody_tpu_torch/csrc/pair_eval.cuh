// Device functions shared by the list-evaluation kernels (K2-K4 in
// runs_eval.cu, K6/K7 in list_eval.cu): the Barnes-Hut pair force over
// staged lanes (pair_window, for K6, K7) or of one lane (pair_force, for
// K2-K4), with the same bits.
#pragma once

#include <cuda_runtime.h>

namespace nbody {

// The pair force of staged lanes [lo, hi) on the target (px, py, pz),
// added to (tx, ty, tz): w = gm / (d2 * (d + eps)) with d = d2 * rsqrt(d2),
// as the TPU kernels factor it, under the guard (d2 > 0) & (gm > 0).
template <int DIMS>
__device__ __forceinline__ void pair_window(const float4* stile, int lo,
                                            int hi, float px, float py,
                                            float pz, float eps, float* tx,
                                            float* ty, float* tz) {
  for (int j = lo; j < hi; ++j) {
    const float4 s = stile[j];
    const float dx = s.x - px;
    const float dy = s.y - py;
    const float dz = s.z - pz;
    float d2 = dx * dx + dy * dy;
    if (DIMS == 3) d2 += dz * dz;
    const float inv_d = rsqrtf(d2);
    const float dist = d2 * inv_d;
    float w = s.w / (d2 * (dist + eps));
    w = (d2 > 0.f && s.w > 0.f) ? w : 0.f;
    *tx += w * dx;
    *ty += w * dy;
    if (DIMS == 3) *tz += w * dz;
  }
}

// The pair force of one staged lane s on the target (px, py, pz), added to
// (tx, ty, tz): one step of pair_window, with the roundings nvcc gives
// pair_window's loop spelled out (d2 = fma(dx, dx, dy * dy), then
// fma(dz, dz, d2); d = fma(d2, rsqrt, eps) folded into d2 * (d + eps);
// the sums as fmas), so that no unrolling or if-conversion around a call
// can contract them otherwise: the same bits as pair_window.
template <int DIMS>
__device__ __forceinline__ void pair_force(const float4 s, float px,
                                           float py, float pz, float eps,
                                           float* tx, float* ty, float* tz) {
  const float dx = __fsub_rn(s.x, px);
  const float dy = __fsub_rn(s.y, py);
  const float dz = __fsub_rn(s.z, pz);
  float d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
  if (DIMS == 3) d2 = __fmaf_rn(dz, dz, d2);
  const float inv_d = rsqrtf(d2);
  float w = __fdiv_rn(s.w, __fmul_rn(d2, __fmaf_rn(d2, inv_d, eps)));
  w = (d2 > 0.f && s.w > 0.f) ? w : 0.f;
  *tx = __fmaf_rn(w, dx, *tx);
  *ty = __fmaf_rn(w, dy, *ty);
  if (DIMS == 3) *tz = __fmaf_rn(w, dz, *tz);
}

}  // namespace nbody
