// Padded-list Barnes-Hut evaluation on Hopper (sm_90a): kernels K6 and K7.
//
// K6 replaces the TPU kernel nbody_tpu/ops/list_eval.py::_kernel (entered
// through list_eval_pallas, the "grid" evaluator and the home of the
// compensated path); K7 replaces nbody_tpu/ops/list_eval.py::_dyn_kernel
// (entered through list_eval_dynamic).  Both compute, for each group g, the
// Barnes-Hut pair force
//     w = gm / (d2 * (d + eps)),  guard (d2 > 0) & (gm > 0)
// of the S targets tgt[g] against a packed list src[g] = [8, K] (rows x, y,
// (z,) gm, zero rows) that holds two left-compacted sections: approx cells
// in lanes [0, a_n) and direct bodies in [off, off + d_n), with
// lens[:, g] = (a_n, d_n) and off = section_offset, a multiple of k_tile.
// Work is walked in k-tiles, as the TPU kernels walk it:
//   K6 (the TPU grid): tile j of ceil(K / k_tile) is visited iff it
//     overlaps either section, j * k < a_n or (j * k + k > off and
//     j * k < off + d_n); with COMP the per-tile partial sums are chained
//     with Kahan compensation, as the TPU kernel chains its k steps.
//   K7 (the TPU dynamic trip count): exactly ceil(a_n / k) approx tiles
//     from tile 0, then ceil(d_n / k) direct tiles from tile off / k; no
//     compensation.
// Each visited tile yields one partial sum per target, added in tile order
// (approx tiles, then direct) or Kahan-chained.
//
// What bounds them on an H100: issuing the pair arithmetic.  A pair is ~12
// FP32 instructions (3D), one SFU rsqrtf and one IEEE divide; a group's
// list is read by each block of its targets, once, and stays in L2, so
// device memory is not the limit.  The kernel gets near the issue rate
// only if (a) no pair is spent on a padding lane: about half the lanes of
// a visited tile carry gm = 0 (the approx section is padded to 2,048
// lanes, each 8-body superblock carries lanes outside its range's
// [lo, hi), the last tile has a tail); and (b) enough warps are resident
// to hide the latency of the rsqrt, the divide and the shared-memory
// loads: one thread per target fills ~15% of the card's thread slots at
// 2D N=40,960.
//
// Design:
//  * Live lanes only.  A tile is streamed through shared memory in chunks
//    of kChunk lanes.  Each thread holds kPer lanes of the chunk in
//    registers; a warp ballot of gm > 0, __popc of the lower lanes and a
//    prefix over the block's warp counts give each live lane its place, and
//    the live lanes are stored as float4 (x, y, z, gm), z = 0 in 2D, in
//    their original order.  The pair loop (nbody::pair_window) runs over
//    the live lanes only.  This is exact: a skipped lane has w = 0 and
//    finite coordinates, so it would have added +-0 to the partial.  The
//    d2 > 0 guard stays: the direct section holds the group's own bodies.
//  * Streaming.  The walk's next chunk (in this tile or the next visited
//    one) is loaded into registers before the current chunk's pair loop, so
//    its loads are in flight while the loop runs.  Shared memory is one
//    chunk plus small tables (~11 KB a block) whatever k_tile is.
//  * Slices.  Each target has r = `slices` threads (1, 2, 4 or 8); a block
//    is r runs of kThreads / r targets, so every warp belongs to one slice
//    and all its threads read the same staged lane (a broadcast).  Slice q
//    sums the live lanes [q m / r, (q + 1) m / r) of each chunk of m live
//    lanes; at the end of a tile the slices' sums are added in slice order
//    through shared memory into the tile's partial, which then enters the
//    running sum or the Kahan chain (__fadd_rn / __fsub_rn, which nvcc's FMA
//    contraction cannot fold away).  ops/list_eval.py picks r from (G, S)
//    so that the grid holds at least two waves of warps.
// The bits depend only on the inputs and r: with r = 1 a tile's lanes are
// summed in lane order by one thread.  With the same r, K6 and K7 give the
// same bits on a list whose approx tiles end before the direct section.

#include <cuda_runtime.h>

#include "pair_eval.cuh"

namespace {

using nbody::pair_window;

constexpr int kThreads = 256;  // a block; LIST_THREADS in ops/list_eval.py
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 2;  // lanes each thread loads per chunk
constexpr int kChunk = kPer * kThreads;

__device__ __forceinline__ void kahan_add(float& sum, float& comp,
                                          const float v) {
  const float y = __fsub_rn(v, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// (x, y, z, gm) of column c of a [DIMS + 1, K] row-major list, z = 0 in 2D.
template <int DIMS>
__device__ __forceinline__ float4 load_lane(const float* sp, long long K,
                                            long long c) {
  return make_float4(sp[c], sp[K + c], DIMS == 3 ? sp[2 * K + c] : 0.f,
                     sp[DIMS * K + c]);
}

template <int DIMS, bool COMP, bool DYN>
__global__ void __launch_bounds__(kThreads, 4)
    list_eval_kernel(const float* __restrict__ tgt,  // [G, S, DIMS]
                     const float* __restrict__ src,  // [G, 8, K]
                     const int* __restrict__ lens,   // [2, G]
                     float* __restrict__ out,        // [G, S, DIMS]
                     const int n_groups, const int S, const long long K,
                     const int k_tile, const int n_k_tiles,
                     const int off_tile, const float eps, const int slices) {
  __shared__ float4 buf[kChunk];
  __shared__ int cnt[kPer][kWarps];
  __shared__ float red[DIMS][kThreads];

  const int g = blockIdx.y;
  const int per_block = kThreads / slices;
  const int q = threadIdx.x / per_block;  // this thread's slice
  const int i = blockIdx.x * per_block + threadIdx.x % per_block;
  const bool live = i < S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t ti_base = (static_cast<size_t>(g) * S + i) * DIMS;
  const float px = live ? tgt[ti_base] : 0.f;
  const float py = live ? tgt[ti_base + 1] : 0.f;
  const float pz = (DIMS == 3 && live) ? tgt[ti_base + DIMS - 1] : 0.f;
  const float* sp = src + static_cast<size_t>(g) * 8 * K;

  const long long a_n = lens[g];
  const long long d_n = lens[n_groups + g];
  const int a_t = static_cast<int>((a_n + k_tile - 1) / k_tile);
  const int d_t = static_cast<int>((d_n + k_tile - 1) / k_tile);
  const long long off = static_cast<long long>(off_tile) * k_tile;
  const int n_iter = DYN ? a_t + d_t : n_k_tiles;

  // Step `it` of the walk visits tile tile_of(it); lanes_of(it) is the
  // number of its lanes inside the list, 0 where the walk skips it (K6: a
  // tile overlapping neither section; K7: a tile past K, which holds no
  // lanes and would add +0).
  auto tile_of = [&](int it) {
    return DYN ? (it < a_t ? it : off_tile + (it - a_t)) : it;
  };
  auto lanes_of = [&](int it) {
    const long long start = static_cast<long long>(tile_of(it)) * k_tile;
    if (!DYN && !(start < a_n || (start + k_tile > off && start < off + d_n)))
      return 0;
    const long long rem = K - start;
    return rem <= 0 ? 0 : static_cast<int>(rem < k_tile ? rem : k_tile);
  };
  auto next_visit = [&](int it) {
    while (it < n_iter && lanes_of(it) == 0) ++it;
    return it;
  };

  float4 v[kPer];  // the chunk in flight: lanes cc + p * kThreads + tid
  auto fetch = [&](long long tile0, int tile_n, int first) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int l = first + p * kThreads + static_cast<int>(threadIdx.x);
      v[p] = l < tile_n ? load_lane<DIMS>(sp, K, tile0 + l)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float a[3] = {0.f, 0.f, 0.f}, c[3] = {0.f, 0.f, 0.f};
  float t[3] = {0.f, 0.f, 0.f};  // this slice's share of the tile partial
  int it = next_visit(0);
  int n = it < n_iter ? lanes_of(it) : 0;
  long long c0 = static_cast<long long>(tile_of(it)) * k_tile;
  int cc = 0;  // the chunk's first lane in its tile
  if (it < n_iter) fetch(c0, n, 0);
  while (it < n_iter) {  // uniform across the block
    // compact the chunk's live lanes into buf, in lane order
    unsigned bal[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      bal[p] = __ballot_sync(0xffffffffu, v[p].w > 0.f);
    }
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) cnt[p][warp] = __popc(bal[p]);
    }
    __syncthreads();  // also: every slice is done with the last chunk
    int m = 0, pos[kPer] = {};
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp) pos[p] = m;
        m += cnt[p][w];
      }
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (v[p].w > 0.f) buf[pos[p] + __popc(bal[p] & below)] = v[p];
    }
    __syncthreads();

    // the walk's next chunk: its loads fly while this chunk is evaluated
    int nit = it, ncc = cc + kChunk;
    if (ncc >= n) {
      nit = next_visit(it + 1);
      ncc = 0;
    }
    const bool tile_end = ncc == 0;
    if (tile_end && nit < n_iter) {
      n = lanes_of(nit);
      c0 = static_cast<long long>(tile_of(nit)) * k_tile;
    }
    if (nit < n_iter) fetch(c0, n, ncc);

    if (live) {
      pair_window<DIMS>(buf, m * q / slices, m * (q + 1) / slices, px, py,
                        pz, eps, &t[0], &t[1], &t[2]);
    }
    if (tile_end) {
      if (slices > 1) {  // the slices' sums, in slice order
#pragma unroll
        for (int d = 0; d < DIMS; ++d) red[d][threadIdx.x] = t[d];
        __syncthreads();
        if (q == 0) {
#pragma unroll
          for (int d = 0; d < DIMS; ++d) {
            for (int r = 1; r < slices; ++r) {
              t[d] += red[d][r * per_block + threadIdx.x];
            }
          }
        }
      }
      if (q == 0) {
#pragma unroll
        for (int d = 0; d < DIMS; ++d) {
          if (COMP) {
            kahan_add(a[d], c[d], t[d]);
          } else {
            a[d] += t[d];
          }
        }
      }
#pragma unroll
      for (int d = 0; d < DIMS; ++d) t[d] = 0.f;
    }
    it = nit;
    cc = ncc;
  }
  if (live && q == 0) {
#pragma unroll
    for (int d = 0; d < DIMS; ++d) {
      out[ti_base + d] = COMP ? __fsub_rn(a[d], c[d]) : a[d];
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const int*, float*,
                          int, int, long long, int, int, int, float, int);

// mode: 0 = K6, 1 = K6 compensated, 2 = K7.
template <int DIMS>
KernelFn kernel_for(int mode) {
  switch (mode) {
    case 0:
      return list_eval_kernel<DIMS, false, false>;
    case 1:
      return list_eval_kernel<DIMS, true, false>;
    case 2:
      return list_eval_kernel<DIMS, false, true>;
    default:
      return nullptr;
  }
}

KernelFn kernel_for(int dims, int mode) {
  return dims == 3 ? kernel_for<3>(mode)
                   : (dims == 2 ? kernel_for<2>(mode) : nullptr);
}

}  // namespace

// One launch of K6 / K7: `threads` must be kThreads and `slices` one of
// 1, 2, 4, 8; blocks of kThreads / slices targets over S, one row per group.
extern "C" int nbody_list_eval(const float* tgt, const float* src,
                               const int* lens, float* out, int n_groups,
                               int S, long long K, int k_tile, int n_k_tiles,
                               int off_tile, float softening, int dims,
                               int mode, int threads, int slices,
                               void* stream) {
  if (n_groups == 0 || S == 0) return 0;
  const KernelFn kernel = kernel_for(dims, mode);
  if (kernel == nullptr || k_tile < 1 || threads != kThreads ||
      (slices != 1 && slices != 2 && slices != 4 && slices != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = kThreads / slices;
  const dim3 grid((S + per_block - 1) / per_block, n_groups);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tgt, src, lens, out, n_groups, S, K, k_tile, n_k_tiles, off_tile,
      softening, slices);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one K6 / K7 instantiation an SM of the current card holds at
// once, into *blocks_per_sm.
extern "C" int nbody_list_eval_occupancy(int dims, int mode, int threads,
                                         int* blocks_per_sm) {
  const KernelFn kernel = kernel_for(dims, mode);
  if (kernel == nullptr || threads != kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, 0));
}
