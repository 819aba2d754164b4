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
// under (d2 > 0) & (gm > 0).  What bounds it on an H100: issuing the pair
// arithmetic.  The SFU's 16 rsqrt per SM per clock set the floor (a warp's
// rsqrt holds its scheduler's SFU for 8 clocks); bytes are N * 16 B staged
// once per block.  One thread per target with rsqrtf issued ~15
// instructions per pair: ~8 FP32 (2D; 2 more in 3D), a compare, a select,
// the mass test, a shared load, and rsqrtf's subnormal fixup (4).  Design:
//  * two targets per thread (kPotTargets), so one broadcast float4 load
//    feeds two independent sums (one and four measured slower, PERF.md);
//  * the bare MUFU.RSQ, the guard folded into a predicated add;
//  * only gm > 0 sources staged (compacted in order): no mass test;
//  * each target may get several threads (slices), each summing whole
//    source tiles, so a small N still fills the card;
//    ops/allpairs.potential_launch_shape picks the slices from N.
// Every shape keeps the TPU kernel's order (one partial per 1,024-source
// tile, added in tile order), so all shapes give the same bits.

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
// unsoftened.  The order of the sum is the TPU kernel's: each source tile
// of kPotTile sources gives one partial per target, summed over the tile's
// lanes in order, and the partials enter the running sum in tile order.
// Targets past nt hold the far sentinel the TPU wrapper pads targets with
// (their result is never written); sources past ns are never staged.
// The constants' twins in ops/allpairs.py: POTENTIAL_THREADS (a block),
// POTENTIAL_SOURCE_BLOCK (the sources of one partial) and
// POTENTIAL_TARGETS_PER_THREAD.
constexpr int kPotThreads = 256;
constexpr int kPotWarps = kPotThreads / 32;
constexpr int kPotTile = 1024;
constexpr int kPotTargets = 2;
constexpr int kPotPer = 2;  // source lanes each thread loads per step
constexpr int kPotChunk = kPotPer * kPotThreads;  // lanes staged per step
constexpr int kPotChunkLog = 9;
static_assert(kPotChunk == 1 << kPotChunkLog && kPotTile % kPotChunk == 0,
              "a tile is a whole number of steps");

// rsqrtf for a normal d2 is one MUFU.RSQ; nvcc wraps it in a fixup for
// subnormal input (scale, compare, select, rescale: four issue slots of
// the pair's ~15).  K5 takes the bare MUFU.RSQ, whose bits for a normal
// input are rsqrtf's, and treats 0 < d2 < 2^-126 as coincident, as the TPU
// (which flushes subnormals) does.
constexpr float kMinNormal = 1.17549435e-38f;  // FLT_MIN

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// A block is `slices` runs of kPotThreads / slices threads (slice q), each
// thread holding kPotTargets targets.  Sources go in rounds of `slices`
// tiles: slice q takes tile round * slices + q whole, so each of its targets
// sums that tile's lanes in order.  A round is kPotTile / L steps; step c
// stages lanes [c L, (c + 1) L) of each of the round's tiles, L =
// kPotChunk / slices, and only those with gm > 0, in order (a warp ballot,
// __popc of the lower lanes and a prefix over the segment's warp groups).
// At a round's end the slices' tile partials enter the running sum in tile
// order through shared memory.  The next step's lanes are loaded into
// registers before this step's pair loop.
template <int DIMS>
__global__ void __launch_bounds__(kPotThreads, 4)
    potential_kernel(const float* __restrict__ tgt,  // [nt, DIMS]
                     const int nt,
                     const float* __restrict__ src,  // [DIMS+1, ns]
                     const int ns, const int slices, const int slices_log,
                     float* __restrict__ out) {  // [nt]
  __shared__ float4 buf[kPotChunk];
  __shared__ int cnt[kPotPer][kPotWarps];
  __shared__ float red[kPotTargets][kPotThreads];
  const float kPadSentinel = 1e15f;
  const int per_slice = kPotThreads / slices;
  const int q = threadIdx.x / per_slice;  // this thread's slice
  const int r = threadIdx.x % per_slice;
  const int seg_log = kPotChunkLog - slices_log;
  const int seg = 1 << seg_log;  // lanes of one tile per step (>= 64)
  const int per_round = kPotTile >> seg_log;  // steps per round
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;

  float px[kPotTargets], py[kPotTargets], pz[kPotTargets];
  float phi[kPotTargets], t[kPotTargets];  // running sums; tile partials
#pragma unroll
  for (int k = 0; k < kPotTargets; ++k) {
    const int i = (blockIdx.x * kPotTargets + k) * per_slice + r;
    const bool live = i < nt;
    px[k] = live ? tgt[DIMS * i] : kPadSentinel;
    py[k] = live ? tgt[DIMS * i + 1] : kPadSentinel;
    pz[k] = DIMS == 3 ? (live ? tgt[DIMS * i + 2] : kPadSentinel) : 0.f;
    phi[k] = t[k] = 0.f;
  }
  const int n_tiles = (ns + kPotTile - 1) / kPotTile;
  const int n_steps = (n_tiles + slices - 1) / slices * per_round;

  float4 v[kPotPer];  // step `s` in flight: lanes p * kPotThreads + tid
  auto fetch = [&](int s) {
    const int round = s / per_round, c = s % per_round;
#pragma unroll
    for (int p = 0; p < kPotPer; ++p) {
      const int l = p * kPotThreads + static_cast<int>(threadIdx.x);
      const int j = (round * slices + (l >> seg_log)) * kPotTile +
                    (c << seg_log) + (l & (seg - 1));
      v[p] = j < ns ? make_float4(src[j], src[ns + j],
                                  DIMS == 3 ? src[2 * ns + j] : 0.f,
                                  src[DIMS * ns + j])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      v[p].w = -v[p].w;  // staged as -gm: live lanes have .w < 0
    }
  };

  if (n_steps > 0) fetch(0);
  for (int s = 0; s < n_steps; ++s) {  // uniform across the block
    // compact each segment's gm > 0 lanes into its part of buf, in order
    unsigned bal[kPotPer];
#pragma unroll
    for (int p = 0; p < kPotPer; ++p) {
      bal[p] = __ballot_sync(0xffffffffu, v[p].w < 0.f);
    }
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < kPotPer; ++p) cnt[p][warp] = __popc(bal[p]);
    }
    __syncthreads();  // also: every slice is done with the last step's buf
    // warp group (p, w) holds lanes [32 (p kPotWarps + w), +32), all in one
    // segment (seg >= 64); a running count restarts at each segment
    int m = 0, run = 0, pos[kPotPer] = {};
#pragma unroll
    for (int p = 0; p < kPotPer; ++p) {
#pragma unroll
      for (int w = 0; w < kPotWarps; ++w) {
        const int l0 = 32 * (p * kPotWarps + w);
        if ((l0 & (seg - 1)) == 0) run = 0;
        if (w == warp) pos[p] = run;
        run += cnt[p][w];
        if ((l0 >> seg_log) == q) m += cnt[p][w];
      }
    }
#pragma unroll
    for (int p = 0; p < kPotPer; ++p) {
      const int l = p * kPotThreads + static_cast<int>(threadIdx.x);
      if (v[p].w < 0.f) {
        buf[((l >> seg_log) << seg_log) + pos[p] + __popc(bal[p] & below)] =
            v[p];
      }
    }
    __syncthreads();
    if (s + 1 < n_steps) fetch(s + 1);  // in flight during the pair loop

    const float4* sb = buf + (q << seg_log);
    for (int j = 0; j < m; ++j) {
      const float4 sl = sb[j];
#pragma unroll
      for (int k = 0; k < kPotTargets; ++k) {
        const float dx = __fsub_rn(sl.x, px[k]);
        const float dy = __fsub_rn(sl.y, py[k]);
        const float dz = __fsub_rn(sl.z, pz[k]);
        float d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
        if (DIMS == 3) d2 = __fmaf_rn(dz, dz, d2);
        if (d2 >= kMinNormal) {
          t[k] = __fadd_rn(t[k], __fmul_rn(sl.w, rsqrt_ftz(d2)));
        }
      }
    }
    if (s % per_round == per_round - 1) {  // the round's tiles, in order
      if (slices > 1) {
#pragma unroll
        for (int k = 0; k < kPotTargets; ++k) red[k][threadIdx.x] = t[k];
        __syncthreads();
      }
      if (q == 0) {
#pragma unroll
        for (int k = 0; k < kPotTargets; ++k) {
          phi[k] += t[k];
          for (int o = 1; o < slices; ++o) {
            phi[k] += red[k][o * per_slice + r];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPotTargets; ++k) t[k] = 0.f;
    }
  }
  if (q == 0) {
#pragma unroll
    for (int k = 0; k < kPotTargets; ++k) {
      const int i = (blockIdx.x * kPotTargets + k) * per_slice + r;
      if (i < nt) out[i] = phi[k];
    }
  }
}

using PotentialFn = void (*)(const float*, int, const float*, int, int, int,
                             float*);

PotentialFn potential_for(int dims) {
  return dims == 3 ? potential_kernel<3>
                   : (dims == 2 ? potential_kernel<2> : nullptr);
}

}  // namespace

// One launch of K5: `threads` must be kPotThreads and `slices` one of 1,
// 2, 4, 8; blocks of kPotThreads / slices * kPotTargets targets over nt.
extern "C" int nbody_allpairs_potential(const float* tgt, int nt,
                                        const float* src, int ns, float* out,
                                        int threads, int slices, int dims,
                                        void* stream) {
  if (nt == 0) return 0;
  const PotentialFn kernel = potential_for(dims);
  if (kernel == nullptr || threads != kPotThreads ||
      (slices != 1 && slices != 2 && slices != 4 && slices != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = kPotThreads / slices * kPotTargets;
  kernel<<<(nt + per_block - 1) / per_block, kPotThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(tgt, nt, src, ns, slices,
                                                __builtin_ctz(slices), out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K5 (`dims`) an SM of the current card holds at once, into
// *blocks_per_sm.
extern "C" int nbody_potential_occupancy(int dims, int threads,
                                         int* blocks_per_sm) {
  const PotentialFn kernel = potential_for(dims);
  if (kernel == nullptr || threads != kPotThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kPotThreads, 0));
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
