// Grouped Barnes-Hut list evaluation on Hopper (sm_90a): kernels K2, K3
// and K4.
//
// K2 and K3 replace the TPU kernel nbody_tpu/ops/list_eval.py::_runs_kernel
// (entered through list_eval_runs): the instantiations P = 1 are K2
// (seg_pack=1), P = 2, 4, 8 are K3 (seg_pack=P, the segment-packed
// variant), each for DIMS = 2 and DIMS = 3.  Per Morton group g, the S
// target bodies take the Barnes-Hut pair force
//     w = gm / (d2 * (d + eps)),  guard (d2 > 0) & (gm > 0)
// from two source streams:
//   (a) the occupied tiles of the group's approx list approx[g, 0:DIMS+1, :]
//       (zero-padded, so every lane of an occupied tile is used);
//   (b) the group's direct table entries, read straight from the
//       Morton-sorted transposed source table srct[0:DIMS+1, :].  Entry e
//       is tiles[g, :, e] = (128-aligned start, lo, hi): lanes [lo, hi) of
//       the window of k_tile / P lanes at start.  Lanes outside the window
//       are real neighbouring bodies: they are masked before the guard by
//       never being staged or visited.  One step stages P entries ("segments")
//       e = d*P + p at lane offset p * (k_tile / P); entries past T are
//       empty, and padded entries carry lo == hi == 0.
// lens[0, g] counts approx lanes, lens[1, g] direct steps (packed tiles).
//
// K4 replaces nbody_tpu/ops/list_eval.py::_runs_split_kernel (entered
// through list_eval_runs_split), the quarter-split evaluator, for DIMS = 2
// and 3.  Its unit is a Morton quarter i = 4g + q: the S/4 targets
// [qS/4, (q+1)S/4) of group g take the same pair force from three
// sections, in this order:
//   (a) the group's approx tiles, ceil(lens[0, i] / k_tile) of approx[g];
//   (b) the quarter's extension tiles, min(ceil(lens[1, i] / k_tile),
//       e_tiles) of ext[i] (COMs of the group's direct cells that pass
//       theta for this quarter, compacted to a prefix; gm = 0 pads), with
//       e_tiles = ceil(E / k_tile) fixed by the table's width;
//   (c) the quarter's own direct tiles, min(lens[2, i], T) entries of
//       tiles[i], each (start, lo, hi) staged over [lo, hi) only, as in K2.
// The TPU kernel's VMEM approx cache (one HBM load per group, served to
// its four quarters) is not carried over: on the card the four quarter
// blocks of a group read the same approx list through the 50 MB L2.
//
// What bounds them on an H100: arithmetic.  Each pair is ~12 FP32
// instructions (3D), one SFU rsqrtf and one IEEE divide; a staged lane
// (16 B) is reused by every target of the block, so bytes are negligible
// next to the pair work.  K4 exists to cut that pair work: a cell that
// only some quarters of a group need direct is summed body by body by
// those quarters alone, and as one COM by the others.
//
// What packing changes on this card: on the TPU every step DMAs a whole
// k_tile and computes all of its lanes, so short Morton runs waste most
// of a tile and K3 packs P short windows into one step.  Here K2 already
// stages and visits only the [lo, hi) lanes of each tile, so packing
// saves no pair work; it only cuts the number of steps (two block
// barriers each) per group.  Whether K3 beats K2 on the H100 is a
// measurement (PERF.md), not a given.
//
// Design: one block per (slice of targets, group or quarter), one thread
// per target, so each thread owns its sum: no atomics, deterministic.
// There is no scalar prefetch on the GPU, so each block reads its own lens
// entry and table entries.  Each step stages its lanes of (x, y, z, gm) as
// float4 in shared memory (z = 0 in 2D; the mass is always .w), then every
// thread loops over the staged windows; the per-step partial sum is added
// to the running sum, as the TPU kernels add each step's lane reduction.
// The TPU kernels' k_tile VMEM ceiling (list_eval.runs_k_max) does not
// apply: a k-tile costs 16 B of shared memory per lane.  Every table read
// is bounded by T, every list read by its width.

#include <cuda_runtime.h>

#include "pair_eval.cuh"

namespace {

using nbody::pair_window;
using nbody::stage;

// Direct entry e of one table row tb [3, T]: its start and its [lo, hi)
// lanes within a window of sw, clipped to the source table (npad).
// Entries past T are empty.
__device__ __forceinline__ void direct_entry(const int* tb, int T, int e,
                                             int sw, long long npad,
                                             long long* start, int* lo,
                                             int* hi) {
  *start = 0;
  *lo = *hi = 0;
  if (e < T) {  // never read past the table
    *start = tb[e];
    long long h_ll = min(tb[2 * T + e], sw);
    if (h_ll > npad - *start) h_ll = npad - *start;  // table tail
    *hi = static_cast<int>(h_ll);
    *lo = max(tb[T + e], 0);
  }
}

template <int DIMS, int P>
__global__ void runs_kernel(const float* __restrict__ tgt,     // [G, S, DIMS]
                            const float* __restrict__ approx,  // [G, 8, A]
                            const float* __restrict__ srct,    // [8, npad]
                            const int* __restrict__ tiles,     // [G, 3, T]
                            const int* __restrict__ lens,      // [2, G]
                            float* __restrict__ out,           // [G, S, DIMS]
                            const int n_groups, const int S, const int A,
                            const long long npad, const int T,
                            const int k_tile, const float eps) {
  extern __shared__ float4 stile[];
  const int g = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < S;
  const size_t ti_base = (static_cast<size_t>(g) * S + i) * DIMS;
  const float px = live ? tgt[ti_base] : 0.f;
  const float py = live ? tgt[ti_base + 1] : 0.f;
  const float pz = (DIMS == 3 && live) ? tgt[ti_base + DIMS - 1] : 0.f;

  const int sw = k_tile / P;  // lanes per segment
  const int a_t = (lens[g] + k_tile - 1) / k_tile;
  const int d_t = min(lens[n_groups + g], (T + P - 1) / P);
  const float* ap = approx + static_cast<size_t>(g) * 8 * A;
  const int* tb = tiles + static_cast<size_t>(g) * 3 * T;

  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int t = 0; t < a_t + d_t; ++t) {
    int lo[P], hi[P];
    if (t < a_t) {
      // an approx tile is one window [0, n) from lane 0
      const int c0 = t * k_tile;
      const int n = min(k_tile, A - c0);
      stage<DIMS>(stile, ap, A, c0, 0, n);
      lo[0] = 0;
      hi[0] = n;
#pragma unroll
      for (int p = 1; p < P; ++p) lo[p] = hi[p] = 0;
    } else {
      const int base = (t - a_t) * P;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        long long start;
        int l, h;
        direct_entry(tb, T, base + p, sw, npad, &start, &l, &h);
        const int off = p * sw;
        // stile[off + j] = source column start + j, for j in [l, h)
        stage<DIMS>(stile + off, srct, npad, start, l, h);
        lo[p] = off + l;
        hi[p] = off + h;
      }
    }
    __syncthreads();
    float tx = 0.f, ty = 0.f, tz = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      pair_window<DIMS>(stile, lo[p], hi[p], px, py, pz, eps, &tx, &ty, &tz);
    }
    ax += tx;
    ay += ty;
    az += tz;
    __syncthreads();
  }
  if (live) {
    out[ti_base] = ax;
    out[ti_base + 1] = ay;
    if (DIMS == 3) out[ti_base + DIMS - 1] = az;
  }
}

template <int DIMS>
__global__ void runs_split_kernel(
    const float* __restrict__ tgt,     // [G, S, DIMS]
    const float* __restrict__ approx,  // [G, 8, A]
    const float* __restrict__ ext,     // [4G, 8, E]
    const float* __restrict__ srct,    // [8, npad]
    const int* __restrict__ tiles,     // [4G, 3, T]
    const int* __restrict__ lens,      // [3, 4G]
    float* __restrict__ out,           // [G, S, DIMS]
    const int n_quarters, const int S, const int A, const int E,
    const long long npad, const int T, const int k_tile, const int e_tiles,
    const float eps) {
  extern __shared__ float4 stile[];
  const int qi = blockIdx.y;  // quarter i = 4g + q
  const int g = qi >> 2;
  const int sq = S / 4;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // within the quarter
  const bool live = i < sq;
  const size_t ti_base =
      (static_cast<size_t>(g) * S + (qi & 3) * sq + i) * DIMS;
  const float px = live ? tgt[ti_base] : 0.f;
  const float py = live ? tgt[ti_base + 1] : 0.f;
  const float pz = (DIMS == 3 && live) ? tgt[ti_base + DIMS - 1] : 0.f;

  const int a_t = (lens[qi] + k_tile - 1) / k_tile;
  const int e_t = min((lens[n_quarters + qi] + k_tile - 1) / k_tile, e_tiles);
  const int d_t = min(lens[2 * n_quarters + qi], T);
  const float* ap = approx + static_cast<size_t>(g) * 8 * A;
  const float* ep = ext + static_cast<size_t>(qi) * 8 * E;
  const int* tb = tiles + static_cast<size_t>(qi) * 3 * T;

  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int t = 0; t < a_t + e_t + d_t; ++t) {
    int lo = 0, hi;
    if (t < a_t + e_t) {
      // an approx or extension tile is one window [0, n) from lane 0
      const bool is_a = t < a_t;
      const int c0 = (is_a ? t : t - a_t) * k_tile;
      const int width = is_a ? A : E;
      hi = min(k_tile, width - c0);
      stage<DIMS>(stile, is_a ? ap : ep, width, c0, 0, hi);
    } else {
      long long start;
      direct_entry(tb, T, t - a_t - e_t, k_tile, npad, &start, &lo, &hi);
      stage<DIMS>(stile, srct, npad, start, lo, hi);
    }
    __syncthreads();
    float tx = 0.f, ty = 0.f, tz = 0.f;
    pair_window<DIMS>(stile, lo, hi, px, py, pz, eps, &tx, &ty, &tz);
    ax += tx;
    ay += ty;
    az += tz;
    __syncthreads();
  }
  if (live) {
    out[ti_base] = ax;
    out[ti_base + 1] = ay;
    if (DIMS == 3) out[ti_base + DIMS - 1] = az;
  }
}

template <int DIMS, int P>
cudaError_t launch(const float* tgt, const float* approx, const float* srct,
                   const int* tiles, const int* lens, float* out,
                   int n_groups, int S, int A, long long npad, int T,
                   int k_tile, float softening, int threads,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float4) * static_cast<size_t>(k_tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        runs_kernel<DIMS, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + threads - 1) / threads, n_groups);
  runs_kernel<DIMS, P><<<grid, threads, smem, stream>>>(
      tgt, approx, srct, tiles, lens, out, n_groups, S, A, npad, T, k_tile,
      softening);
  return cudaGetLastError();
}

template <int DIMS>
cudaError_t dispatch_p(int seg_pack, const float* tgt, const float* approx,
                       const float* srct, const int* tiles, const int* lens,
                       float* out, int n_groups, int S, int A, long long npad,
                       int T, int k_tile, float softening, int threads,
                       cudaStream_t stream) {
  switch (seg_pack) {
    case 1:
      return launch<DIMS, 1>(tgt, approx, srct, tiles, lens, out, n_groups, S,
                             A, npad, T, k_tile, softening, threads, stream);
    case 2:
      return launch<DIMS, 2>(tgt, approx, srct, tiles, lens, out, n_groups, S,
                             A, npad, T, k_tile, softening, threads, stream);
    case 4:
      return launch<DIMS, 4>(tgt, approx, srct, tiles, lens, out, n_groups, S,
                             A, npad, T, k_tile, softening, threads, stream);
    case 8:
      return launch<DIMS, 8>(tgt, approx, srct, tiles, lens, out, n_groups, S,
                             A, npad, T, k_tile, softening, threads, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int DIMS>
cudaError_t launch_split(const float* tgt, const float* approx,
                         const float* ext, const float* srct, const int* tiles,
                         const int* lens, float* out, int n_quarters, int S,
                         int A, int E, long long npad, int T, int k_tile,
                         int e_tiles, float softening, int threads,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float4) * static_cast<size_t>(k_tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        runs_split_kernel<DIMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S / 4 + threads - 1) / threads, n_quarters);
  runs_split_kernel<DIMS><<<grid, threads, smem, stream>>>(
      tgt, approx, ext, srct, tiles, lens, out, n_quarters, S, A, E, npad, T,
      k_tile, e_tiles, softening);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nbody_runs_eval_split(const float* tgt, const float* approx,
                                     const float* ext, const float* srct,
                                     const int* tiles, const int* lens,
                                     float* out, int n_quarters, int S, int A,
                                     int E, long long npad, int T, int k_tile,
                                     int e_tiles, float softening, int dims,
                                     int threads, void* stream) {
  if (n_quarters == 0 || S == 0) return 0;
  if (S % 4 || n_quarters % 4 || k_tile < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dims == 3) {
    e = launch_split<3>(tgt, approx, ext, srct, tiles, lens, out, n_quarters,
                        S, A, E, npad, T, k_tile, e_tiles, softening, threads,
                        s);
  } else if (dims == 2) {
    e = launch_split<2>(tgt, approx, ext, srct, tiles, lens, out, n_quarters,
                        S, A, E, npad, T, k_tile, e_tiles, softening, threads,
                        s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" int nbody_runs_eval(const float* tgt, const float* approx,
                               const float* srct, const int* tiles,
                               const int* lens, float* out, int n_groups,
                               int S, int A, long long npad, int T,
                               int k_tile, float softening, int dims,
                               int seg_pack, int threads, void* stream) {
  if (n_groups == 0 || S == 0) return 0;
  if (seg_pack < 1 || k_tile % seg_pack) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dims == 3) {
    e = dispatch_p<3>(seg_pack, tgt, approx, srct, tiles, lens, out, n_groups,
                      S, A, npad, T, k_tile, softening, threads, s);
  } else if (dims == 2) {
    e = dispatch_p<2>(seg_pack, tgt, approx, srct, tiles, lens, out, n_groups,
                      S, A, npad, T, k_tile, softening, threads, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
