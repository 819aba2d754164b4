// All-pairs gravity on Hopper (sm_90a): kernels K1 (accelerations) and K5
// (potential) of the port.
//
// Replaces the TPU kernel nbody_tpu/ops/allpairs.py::_allpairs_kernel
// (entered through allpairs_accelerations_vs / allpairs_accelerations),
// instantiated for DIMS = 2 and DIMS = 3.  Semantics:
// a_i = sum_j w_ij * (p_j - p_i) with w = gm_j / d^3 when softening == 0
// and w = gm_j / (d2 * (d + eps)) otherwise; pairs with d2 == 0 (self,
// coincident bodies) are dropped.  Optional Kahan compensation chains
// 128-source partial sums, as the TPU kernel chains its 128-lane chunks
// and source tiles.
//
// What bounds it on an H100: arithmetic, not bytes.  Each pair costs
// ~10 FP32 instructions (2D; 3 more in 3D) plus one SFU rsqrtf (and one
// IEEE divide when softened); a source tile of 16 B per body is reused by
// every thread of the block, so device-memory traffic is
// ~N^2 * 16 B / threads_per_block, negligible.  The SFU (16 rsqrt per SM
// per clock, against 128 FP32 lanes) and the FP32 pipe set the pairs/s
// ceiling.
//
// Design: one thread per target, as the reference's own CUDA kernel maps
// one thread per body (project.cu:703).  The block stages a tile of
// sources as float4 (x, y, z, gm) in shared memory (z = 0 in 2D; the mass
// is always .w), so each pair is one broadcast 16-byte shared load.  A
// loop over source tiles inside the block replaces the TPU grid's
// sequential source axis; the per-tile partial sum is added to the
// running sum (or Kahan-chained), mirroring the TPU kernel's per-tile
// lane reduction.  No atomics: each thread owns its target's sum, so the
// result is deterministic.
//
// K5 (potential_kernel) replaces nbody_tpu/ops/allpairs.py::_potential_kernel
// (entered through allpairs_potential, the metrics CSV's potential energy
// at N > 4096), for DIMS = 2 and 3: phi_i = sum_j -gm_j / d_ij, unsoftened,
// under (d2 > 0) & (gm > 0).  Bound like K1 by arithmetic: ~7 FP32
// instructions (2D; 2 more in 3D) and one SFU rsqrtf per pair, and the SFU's
// 16 rsqrt per SM per clock set the floor; bytes are N * 16 B staged once
// per block.  Design: K1's loop, one thread per target, one float4 source
// tile in shared memory, per-tile partial sums added to the running sum.

#include <cuda_runtime.h>

namespace {

template <int DIMS, bool SOFT>
__device__ __forceinline__ void pair_accum(const float4 s, const float px,
                                           const float py, const float pz,
                                           const float eps, float* t) {
  const float dx = s.x - px;
  const float dy = s.y - py;
  const float dz = s.z - pz;
  float d2 = dx * dx + dy * dy;
  if (DIMS == 3) d2 += dz * dz;
  const float inv_d = rsqrtf(d2);
  float w;
  if (SOFT) {
    const float d = d2 * inv_d;
    w = s.w / (d2 * (d + eps));
  } else {
    w = s.w * (inv_d * inv_d * inv_d);
  }
  w = d2 > 0.f ? w : 0.f;  // self-pairs and coincident bodies
  t[0] += w * dx;
  t[1] += w * dy;
  if (DIMS == 3) t[2] += w * dz;
}

__device__ __forceinline__ void kahan_add(float& sum, float& comp,
                                          const float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

template <int DIMS, bool SOFT, bool COMP>
__global__ void allpairs_kernel(const float* __restrict__ tgt,  // [nt, DIMS]
                                const int nt,
                                const float* __restrict__ src,  // [DIMS+1, ns]
                                const int ns, const float eps,
                                const int tile,
                                float* __restrict__ out) {  // [nt, DIMS]
  extern __shared__ float4 stile[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < nt;
  const float px = live ? tgt[DIMS * i] : 0.f;
  const float py = live ? tgt[DIMS * i + 1] : 0.f;
  const float pz = (DIMS == 3 && live) ? tgt[DIMS * i + DIMS - 1] : 0.f;
  float a[3] = {0.f, 0.f, 0.f}, c[3] = {0.f, 0.f, 0.f};

  for (int base = 0; base < ns; base += tile) {
    const int cnt = min(tile, ns - base);
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      stile[j] = make_float4(src[base + j], src[ns + base + j],
                             DIMS == 3 ? src[2 * ns + base + j] : 0.f,
                             src[DIMS * ns + base + j]);
    }
    __syncthreads();
    if (COMP) {
      for (int c0 = 0; c0 < cnt; c0 += 128) {
        const int c1 = min(cnt, c0 + 128);
        float t[3] = {0.f, 0.f, 0.f};
        for (int j = c0; j < c1; ++j) {
          pair_accum<DIMS, SOFT>(stile[j], px, py, pz, eps, t);
        }
#pragma unroll
        for (int d = 0; d < DIMS; ++d) kahan_add(a[d], c[d], t[d]);
      }
    } else {
      float t[3] = {0.f, 0.f, 0.f};
      for (int j = 0; j < cnt; ++j) {
        pair_accum<DIMS, SOFT>(stile[j], px, py, pz, eps, t);
      }
#pragma unroll
      for (int d = 0; d < DIMS; ++d) a[d] += t[d];
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < DIMS; ++d) out[DIMS * i + d] = COMP ? a[d] - c[d] : a[d];
  }
}

template <int DIMS, bool SOFT, bool COMP>
cudaError_t launch(const float* tgt, int nt, const float* src, int ns,
                   float eps, int threads, int tile, float* out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float4) * static_cast<size_t>(tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        allpairs_kernel<DIMS, SOFT, COMP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (nt + threads - 1) / threads;
  allpairs_kernel<DIMS, SOFT, COMP><<<blocks, threads, smem, stream>>>(
      tgt, nt, src, ns, eps, tile, out);
  return cudaGetLastError();
}

template <int DIMS>
cudaError_t dispatch(const float* tgt, int nt, const float* src, int ns,
                     float* out, float softening, int compensated,
                     int threads, int tile, cudaStream_t s) {
  if (softening != 0.f) {
    return compensated
        ? launch<DIMS, true, true>(tgt, nt, src, ns, softening, threads, tile, out, s)
        : launch<DIMS, true, false>(tgt, nt, src, ns, softening, threads, tile, out, s);
  }
  return compensated
      ? launch<DIMS, false, true>(tgt, nt, src, ns, 0.f, threads, tile, out, s)
      : launch<DIMS, false, false>(tgt, nt, src, ns, 0.f, threads, tile, out, s);
}

// K5: phi_i = sum_j -gm_j * rsqrt(d2_ij) under (d2 > 0) & (gm > 0),
// unsoftened.  The same staging as K1; the per-tile partial is added to
// the running sum, as the TPU kernel adds each source tile's lane sum.
// A thread past nt holds the far sentinel the TPU wrapper pads targets
// with (its result is never written); sources past ns are never staged,
// which is what the sentinel's gm = 0 padding gives on the TPU.
template <int DIMS>
__global__ void potential_kernel(const float* __restrict__ tgt,  // [nt, DIMS]
                                 const int nt,
                                 const float* __restrict__ src,  // [DIMS+1, ns]
                                 const int ns, const int tile,
                                 float* __restrict__ out) {  // [nt]
  extern __shared__ float4 stile[];
  const float kPadSentinel = 1e15f;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < nt;
  const float px = live ? tgt[DIMS * i] : kPadSentinel;
  const float py = live ? tgt[DIMS * i + 1] : kPadSentinel;
  const float pz = DIMS == 3 ? (live ? tgt[DIMS * i + 2] : kPadSentinel) : 0.f;
  float phi = 0.f;
  for (int base = 0; base < ns; base += tile) {
    const int cnt = min(tile, ns - base);
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      stile[j] = make_float4(src[base + j], src[ns + base + j],
                             DIMS == 3 ? src[2 * ns + base + j] : 0.f,
                             src[DIMS * ns + base + j]);
    }
    __syncthreads();
    float t = 0.f;
    for (int j = 0; j < cnt; ++j) {
      const float4 s = stile[j];
      const float dx = s.x - px;
      const float dy = s.y - py;
      const float dz = s.z - pz;
      float d2 = dx * dx + dy * dy;
      if (DIMS == 3) d2 += dz * dz;
      const float v = -s.w * rsqrtf(d2);
      t += (d2 > 0.f && s.w > 0.f) ? v : 0.f;
    }
    phi += t;
    __syncthreads();
  }
  if (live) out[i] = phi;
}

template <int DIMS>
cudaError_t launch_potential(const float* tgt, int nt, const float* src,
                             int ns, int threads, int tile, float* out,
                             cudaStream_t stream) {
  const size_t smem = sizeof(float4) * static_cast<size_t>(tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        potential_kernel<DIMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (nt + threads - 1) / threads;
  potential_kernel<DIMS><<<blocks, threads, smem, stream>>>(tgt, nt, src, ns,
                                                            tile, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nbody_allpairs_potential(const float* tgt, int nt,
                                        const float* src, int ns, float* out,
                                        int threads, int tile, int dims,
                                        void* stream) {
  if (nt == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dims == 3) {
    e = launch_potential<3>(tgt, nt, src, ns, threads, tile, out, s);
  } else if (dims == 2) {
    e = launch_potential<2>(tgt, nt, src, ns, threads, tile, out, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" int nbody_allpairs_accel(const float* tgt, int nt,
                                    const float* src, int ns, float* out,
                                    float softening, int compensated,
                                    int threads, int tile, int dims,
                                    void* stream) {
  if (nt == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dims == 3) {
    e = dispatch<3>(tgt, nt, src, ns, out, softening, compensated, threads, tile, s);
  } else if (dims == 2) {
    e = dispatch<2>(tgt, nt, src, ns, out, softening, compensated, threads, tile, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* nbody_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
