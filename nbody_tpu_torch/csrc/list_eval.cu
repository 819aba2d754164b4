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
// Work is counted in k-tiles: a tile is visited whole (its zero-gm lanes
// drop out through the guard) or not at all, whatever data it holds.
//   K6 (the TPU grid): tile j of ceil(K / k_tile) is visited iff it
//     overlaps either section, j * k < a_n or (j * k + k > off and
//     j * k < off + d_n); with COMP the per-tile partial sums are chained
//     with Kahan compensation, as the TPU kernel chains its k steps.
//   K7 (the TPU dynamic trip count): exactly ceil(a_n / k) approx tiles
//     from tile 0, then ceil(d_n / k) direct tiles from tile off / k; no
//     compensation.
// On the GPU both are the same loop over tiles (K6 tests and skips, K7
// walks only the occupied ones), two instantiations of one template.
//
// What bounds them on an H100: arithmetic.  Each pair is ~12 FP32
// instructions (3D), one SFU rsqrtf and one IEEE divide; a staged lane
// (16 B) is reused by all the block's targets, so device-memory traffic is
// the list once per block of targets (S / threads blocks per group) plus
// the targets once.  The padding a list carries past its occupied tiles
// costs K6 one skipped iteration per tile and K7 nothing.
//
// Design: one block per (slice of S targets, group), one thread per target,
// so each thread owns its sum: no atomics, deterministic.  There is no
// scalar prefetch on the GPU: each block reads its group's lens entry
// itself.  Each visited tile stages its lanes of (x, y, z, gm) as float4
// in shared memory (lanes past K are not staged: the K padding of the TPU
// wrapper is only a tile count here), then every thread loops over them
// with the runs kernels' pair function; the tile's partial sum is added to
// the running sum or, with COMP, Kahan-chained through __fadd_rn /
// __fsub_rn so that nvcc's FMA contraction cannot fold the compensation
// away.  The tile order is the TPU kernels' order: approx tiles, then
// direct tiles.

#include <cuda_runtime.h>

#include "pair_eval.cuh"

namespace {

using nbody::pair_window;
using nbody::stage;

__device__ __forceinline__ void kahan_add(float& sum, float& comp,
                                          const float v) {
  const float y = __fsub_rn(v, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

template <int DIMS, bool COMP, bool DYN>
__global__ void list_eval_kernel(const float* __restrict__ tgt,  // [G, S, DIMS]
                                 const float* __restrict__ src,  // [G, 8, K]
                                 const int* __restrict__ lens,   // [2, G]
                                 float* __restrict__ out,        // [G, S, DIMS]
                                 const int n_groups, const int S,
                                 const long long K, const int k_tile,
                                 const int n_k_tiles, const int off_tile,
                                 const float eps) {
  extern __shared__ float4 stile[];
  const int g = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < S;
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

  float a[3] = {0.f, 0.f, 0.f}, c[3] = {0.f, 0.f, 0.f};
  for (int it = 0; it < n_iter; ++it) {
    int j = it;
    if (DYN) {
      j = it < a_t ? it : off_tile + (it - a_t);
    } else {
      const long long start = static_cast<long long>(j) * k_tile;
      const bool occupied =
          start < a_n || (start + k_tile > off && start < off + d_n);
      if (!occupied) continue;  // uniform across the block
    }
    const long long c0 = static_cast<long long>(j) * k_tile;
    long long rem = K - c0;  // lanes of this tile inside the list
    if (rem > k_tile) rem = k_tile;
    if (rem < 0) rem = 0;
    const int n = static_cast<int>(rem);
    stage<DIMS>(stile, sp, K, c0, 0, n);
    __syncthreads();
    float t[3] = {0.f, 0.f, 0.f};
    pair_window<DIMS>(stile, 0, n, px, py, pz, eps, &t[0], &t[1], &t[2]);
#pragma unroll
    for (int d = 0; d < DIMS; ++d) {
      if (COMP) {
        kahan_add(a[d], c[d], t[d]);
      } else {
        a[d] += t[d];
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < DIMS; ++d) {
      out[ti_base + d] = COMP ? __fsub_rn(a[d], c[d]) : a[d];
    }
  }
}

template <int DIMS, bool COMP, bool DYN>
cudaError_t launch(const float* tgt, const float* src, const int* lens,
                   float* out, int n_groups, int S, long long K, int k_tile,
                   int n_k_tiles, int off_tile, float softening, int threads,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float4) * static_cast<size_t>(k_tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        list_eval_kernel<DIMS, COMP, DYN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + threads - 1) / threads, n_groups);
  list_eval_kernel<DIMS, COMP, DYN><<<grid, threads, smem, stream>>>(
      tgt, src, lens, out, n_groups, S, K, k_tile, n_k_tiles, off_tile,
      softening);
  return cudaGetLastError();
}

template <int DIMS>
cudaError_t dispatch(int mode, const float* tgt, const float* src,
                     const int* lens, float* out, int n_groups, int S,
                     long long K, int k_tile, int n_k_tiles, int off_tile,
                     float softening, int threads, cudaStream_t s) {
  switch (mode) {
    case 0:  // K6
      return launch<DIMS, false, false>(tgt, src, lens, out, n_groups, S, K,
                                        k_tile, n_k_tiles, off_tile,
                                        softening, threads, s);
    case 1:  // K6, compensated
      return launch<DIMS, true, false>(tgt, src, lens, out, n_groups, S, K,
                                       k_tile, n_k_tiles, off_tile, softening,
                                       threads, s);
    case 2:  // K7
      return launch<DIMS, false, true>(tgt, src, lens, out, n_groups, S, K,
                                       k_tile, n_k_tiles, off_tile, softening,
                                       threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 = K6, 1 = K6 compensated, 2 = K7.
extern "C" int nbody_list_eval(const float* tgt, const float* src,
                               const int* lens, float* out, int n_groups,
                               int S, long long K, int k_tile, int n_k_tiles,
                               int off_tile, float softening, int dims,
                               int mode, int threads, void* stream) {
  if (n_groups == 0 || S == 0) return 0;
  if (k_tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dims == 3) {
    e = dispatch<3>(mode, tgt, src, lens, out, n_groups, S, K, k_tile,
                    n_k_tiles, off_tile, softening, threads, s);
  } else if (dims == 2) {
    e = dispatch<2>(mode, tgt, src, lens, out, n_groups, S, K, k_tile,
                    n_k_tiles, off_tile, softening, threads, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
