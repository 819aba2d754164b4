// All-pairs gravity on Hopper (sm_90a): kernels K1 (accelerations) and K5
// (potential) of the port.
//
// K1 (allpairs_kernel) replaces the TPU kernel
// nbody_tpu/ops/allpairs.py::_allpairs_kernel (entered through
// allpairs_accelerations_vs / allpairs_accelerations), instantiated for
// DIMS = 2 and DIMS = 3.  Semantics: a_i = sum_j w_ij * (p_j - p_i) with
// w = gm_j / d^3 when softening == 0 and w = gm_j / (d2 * (d + eps))
// otherwise; pairs with d2 < 2^-126 (self, coincident bodies, and bodies
// closer than 1.1e-19, as on the TPU, which flushes subnormals) are
// dropped.  The order of the sum: each source tile of `tile` sources gives
// one partial per target, summed over the tile's lanes in order, and the
// partials enter the running sum in tile order; with Kahan compensation
// (COMP) the partials are those of 128-source chunks of each tile, chained
// with compensation in chunk order.
//
// What bounds K1 on an H100: issuing the pair arithmetic.  The SFU's 16
// rsqrt per SM per clock and the FP32 pipe set the pairs/s ceiling; bytes
// are N * 16 B staged once per block.  One thread per target with rsqrtf
// issued ~17 instructions a pair in 2D (~20 in 3D): a broadcast 16-byte
// shared load, ~11 FP32, a select for the guard and rsqrtf's subnormal
// fixup (4).  Design (K5's, below, with K1's arithmetic):
//  * kApTargets targets a thread, so one broadcast float4 load feeds
//    independent sums (one and four measured against two, PERF.md);
//  * the bare MUFU.RSQ, the guard d2 >= FLT_MIN folded into predicated
//    adds;
//  * each target may get several threads (slices), each summing whole
//    units (tiles, or COMP's chunks), so a small Nt still fills the card;
//    ops/allpairs.allpairs_launch_shape picks the slices from Nt;
//  * sources streamed through a fixed 8 KiB buffer, the next step's loads
//    in registers during the pair loop.  No mass test: a gm = 0 lane
//    keeps its 0 * inv_d^3, as the TPU kernel's does.
// Every shape keeps the order above, so all shapes give the same bits.
// The roundings are spelled out (__fmaf_rn, __fmul_rn, ...) as nvcc
// contracted the one-target-a-thread kernel before it, so a thread holding
// several targets cannot split them otherwise.
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

// rsqrtf for a normal d2 is one MUFU.RSQ; nvcc wraps it in a fixup for
// subnormal input (scale, compare, select, rescale: four issue slots of
// a pair's ~15).  K1 and K5 take the bare MUFU.RSQ, whose bits for a normal
// input are rsqrtf's, and treat 0 < d2 < 2^-126 as coincident, as the TPU
// (which flushes subnormals) does.
constexpr float kMinNormal = 1.17549435e-38f;  // FLT_MIN

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// K1's constants; their twins in ops/allpairs.py: ALLPAIRS_THREADS (a
// block), ALLPAIRS_TARGETS_PER_THREAD and COMP_UNIT.
constexpr int kApThreads = 256;
constexpr int kApThreadsLog = 8;
constexpr int kApTargets = 2;
constexpr int kApPer = 2;  // source lanes each thread loads per step
constexpr int kApChunk = kApPer * kApThreads;  // lanes staged per step
constexpr int kApChunkLog = 9;
constexpr int kCompUnit = 128;  // sources of one Kahan-chained partial
static_assert(kApThreads == 1 << kApThreadsLog &&
                  kApChunk == 1 << kApChunkLog,
              "shifts stand for the block's and the step's sizes");

// One pair into target sums t (the operations of the one-target-a-thread
// kernel this design replaced, each rounding as nvcc contracted it there).
template <int DIMS, bool SOFT>
__device__ __forceinline__ void pair_accum(const float4 s, const float px,
                                           const float py, const float pz,
                                           const float eps, float* t) {
  const float dx = __fsub_rn(s.x, px);
  const float dy = __fsub_rn(s.y, py);
  const float dz = __fsub_rn(s.z, pz);
  float d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
  if (DIMS == 3) d2 = __fmaf_rn(dz, dz, d2);
  const float inv_d = rsqrt_ftz(d2);
  float w;
  if (SOFT) {
    w = s.w / __fmul_rn(d2, __fmaf_rn(d2, inv_d, eps));
  } else {
    w = __fmul_rn(s.w, __fmul_rn(__fmul_rn(inv_d, inv_d), inv_d));
  }
  if (d2 >= kMinNormal) {  // self-pairs and coincident bodies
    t[0] = __fmaf_rn(w, dx, t[0]);
    t[1] = __fmaf_rn(w, dy, t[1]);
    if (DIMS == 3) t[2] = __fmaf_rn(w, dz, t[2]);
  }
}

__device__ __forceinline__ void kahan_add(float& sum, float& comp,
                                          const float v) {
  const float y = __fsub_rn(v, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// A block is 2^slices_log runs of kApThreads >> slices_log threads (slice
// q), each thread holding kApTargets targets.  A unit is a tile of `tile`
// sources or, with COMP, one kCompUnit-source chunk of a tile (the last of
// a tile, and the array's last, may be shorter).  Units go in rounds of
// one per slice: slice q sums unit round * slices + q whole, lane by lane
// in order.  A round is per_round steps; step c stages lanes
// [c seg, (c + 1) seg) of each of the round's units (seg = 2^seg_log,
// slices * seg <= kApChunk), and the next step's lanes are loaded into
// registers before this step's pair loop.  At a round's end slice 0 adds
// the units' partials to its running sums in unit order (Kahan-chained
// with COMP), reading the other slices' from shared memory.
template <int DIMS, bool SOFT, bool COMP>
__global__ void __launch_bounds__(kApThreads, 4)
    allpairs_kernel(const float* __restrict__ tgt,  // [nt, DIMS]
                    const int nt,
                    const float* __restrict__ src,  // [DIMS+1, ns]
                    const int ns, const float eps, const int tile,
                    const int n_units, const int slices_log,
                    const int seg_log, const int per_round,
                    float* __restrict__ out) {  // [nt, DIMS]
  __shared__ float4 buf[kApChunk];
  __shared__ float red[kApTargets * DIMS][kApThreads];
  const int slices = 1 << slices_log;
  const int per_slice_log = kApThreadsLog - slices_log;
  const int q = threadIdx.x >> per_slice_log;  // this thread's slice
  const int r = threadIdx.x & ((1 << per_slice_log) - 1);
  const int seg = 1 << seg_log;
  const int ulen = COMP ? min(kCompUnit, tile) : tile;
  const int upt = COMP ? (tile + kCompUnit - 1) / kCompUnit : 1;
  // unit u's first source, into *start, and its length
  auto span = [&](const int u, int* start) {
    const int ti = COMP ? u / upt : u;  // the unit's tile
    const int c = u - ti * upt;  // and its chunk there
    *start = ti * tile + c * ulen;
    return min(min(ulen, tile - c * ulen), ns - *start);
  };

  float px[kApTargets], py[kApTargets], pz[kApTargets];
  float a[kApTargets][DIMS], cmp[kApTargets][DIMS], t[kApTargets][DIMS];
#pragma unroll
  for (int k = 0; k < kApTargets; ++k) {
    const int i = ((blockIdx.x * kApTargets + k) << per_slice_log) + r;
    const bool live = i < nt;
    px[k] = live ? tgt[DIMS * i] : 0.f;
    py[k] = live ? tgt[DIMS * i + 1] : 0.f;
    pz[k] = DIMS == 3 && live ? tgt[DIMS * i + DIMS - 1] : 0.f;
#pragma unroll
    for (int d = 0; d < DIMS; ++d) a[k][d] = cmp[k][d] = t[k][d] = 0.f;
  }
  const int n_steps = ((n_units + slices - 1) >> slices_log) * per_round;

  float4 v[kApPer];  // step `s` in flight: lanes p * kApThreads + tid
  auto fetch = [&](const int s) {
    const int round = s / per_round, c = s - round * per_round;
#pragma unroll
    for (int p = 0; p < kApPer; ++p) {
      const int l = p * kApThreads + static_cast<int>(threadIdx.x);
      const int u = (round << slices_log) + (l >> seg_log);
      const int o = (c << seg_log) + (l & (seg - 1));
      int j = 0;
      const bool in = (l >> seg_log) < slices && u < n_units &&
                      o < span(u, &j);
      j += o;
      v[p] = in ? make_float4(src[j], src[ns + j],
                              DIMS == 3 ? src[2 * ns + j] : 0.f,
                              src[DIMS * ns + j])
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  if (n_steps > 0) fetch(0);
  for (int s = 0; s < n_steps; ++s) {  // uniform across the block
    const int round = s / per_round, c = s - round * per_round;
    __syncthreads();  // every slice is done with the last step's buf
#pragma unroll
    for (int p = 0; p < kApPer; ++p) buf[p * kApThreads + threadIdx.x] = v[p];
    __syncthreads();
    if (s + 1 < n_steps) fetch(s + 1);  // in flight during the pair loop

    const int u = (round << slices_log) + q;
    int first;
    const int m = u < n_units
        ? max(0, min(seg, span(u, &first) - (c << seg_log))) : 0;
    const float4* sb = buf + (q << seg_log);
    for (int j = 0; j < m; ++j) {
      const float4 sl = sb[j];
#pragma unroll
      for (int k = 0; k < kApTargets; ++k) {
        pair_accum<DIMS, SOFT>(sl, px[k], py[k], pz[k], eps, t[k]);
      }
    }
    if (c == per_round - 1) {  // the round's units, in order
      if (slices > 1) {
#pragma unroll
        for (int k = 0; k < kApTargets; ++k) {
#pragma unroll
          for (int d = 0; d < DIMS; ++d) red[k * DIMS + d][threadIdx.x] = t[k][d];
        }
        __syncthreads();
      }
      if (q == 0) {
        const int live = min(slices, n_units - (round << slices_log));
#pragma unroll
        for (int k = 0; k < kApTargets; ++k) {
#pragma unroll
          for (int d = 0; d < DIMS; ++d) {
            for (int o = 0; o < live; ++o) {
              const float part =
                  o == 0 ? t[k][d] : red[k * DIMS + d][(o << per_slice_log) + r];
              if (COMP) {
                kahan_add(a[k][d], cmp[k][d], part);
              } else {
                a[k][d] = __fadd_rn(a[k][d], part);
              }
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kApTargets; ++k) {
#pragma unroll
        for (int d = 0; d < DIMS; ++d) t[k][d] = 0.f;
      }
    }
  }
  if (q == 0) {
#pragma unroll
    for (int k = 0; k < kApTargets; ++k) {
      const int i = ((blockIdx.x * kApTargets + k) << per_slice_log) + r;
      if (i < nt) {
#pragma unroll
        for (int d = 0; d < DIMS; ++d) {
          out[DIMS * i + d] = COMP ? __fsub_rn(a[k][d], cmp[k][d]) : a[k][d];
        }
      }
    }
  }
}

using AccelFn = void (*)(const float*, int, const float*, int, float, int,
                         int, int, int, int, float*);

template <int DIMS>
AccelFn accel_for_dims(bool soft, bool comp) {
  if (soft) {
    return comp ? allpairs_kernel<DIMS, true, true>
                : allpairs_kernel<DIMS, true, false>;
  }
  return comp ? allpairs_kernel<DIMS, false, true>
              : allpairs_kernel<DIMS, false, false>;
}

AccelFn accel_for(int dims, bool soft, bool comp) {
  return dims == 3 ? accel_for_dims<3>(soft, comp)
                   : (dims == 2 ? accel_for_dims<2>(soft, comp) : nullptr);
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

int log2_of(int x) { return 31 - __builtin_clz(static_cast<unsigned>(x)); }

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

// One launch of K1: `threads` must be kApThreads, `slices` one of 1, 2, 4,
// 8 and `tile` (the sources of one partial) at least 1; blocks of
// kApThreads / slices * kApTargets targets over nt.
extern "C" int nbody_allpairs_accel(const float* tgt, int nt,
                                    const float* src, int ns, float* out,
                                    float softening, int compensated,
                                    int threads, int slices, int tile,
                                    int dims, void* stream) {
  if (nt == 0) return 0;
  const AccelFn kernel = accel_for(dims, softening != 0.f, compensated != 0);
  if (kernel == nullptr || threads != kApThreads || tile < 1 ||
      (slices != 1 && slices != 2 && slices != 4 && slices != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ulen = compensated ? (tile < kCompUnit ? tile : kCompUnit) : tile;
  const int upt = compensated ? (tile + kCompUnit - 1) / kCompUnit : 1;
  const int n_units = ns / tile * upt + (ns % tile + ulen - 1) / ulen;
  const int slices_log = log2_of(slices);
  int seg_log = kApChunkLog - slices_log;  // the step's lanes of a unit
  while (seg_log > 0 && (1 << (seg_log - 1)) >= ulen) --seg_log;
  const int per_round = (ulen + (1 << seg_log) - 1) >> seg_log;
  const int per_block = kApThreads / slices * kApTargets;
  kernel<<<(nt + per_block - 1) / per_block, kApThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      tgt, nt, src, ns, softening, tile, n_units, slices_log, seg_log,
      per_round, out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K1 (`dims`, softened or not, compensated or not) an SM of the
// current card holds at once, into *blocks_per_sm.
extern "C" int nbody_allpairs_occupancy(int dims, int soft, int compensated,
                                        int threads, int* blocks_per_sm) {
  const AccelFn kernel = accel_for(dims, soft != 0, compensated != 0);
  if (kernel == nullptr || threads != kApThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kApThreads, 0));
}

extern "C" const char* nbody_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
