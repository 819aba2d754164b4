// Grouped Barnes-Hut list evaluation on Hopper (sm_90a), kernel K2.
//
// Replaces the TPU kernel nbody_tpu/ops/list_eval.py::_runs_kernel at
// seg_pack=1 (entered through list_eval_runs).  Per Morton group g, the
// S target bodies take the Barnes-Hut pair force
//     w = gm / (d2 * (d + eps)),  guard (d2 > 0) & (gm > 0)
// from two source streams:
//   (a) the occupied tiles of the group's approx list approx[g, 0:3, :]
//       (zero-padded, so every lane of an occupied tile is used);
//   (b) the group's direct tiles, read straight from the Morton-sorted
//       transposed source table srct[0:3, :] at tiles[g, 0, t] (a
//       128-aligned start), keeping only lanes [lo, hi) =
//       [tiles[g, 1, t], tiles[g, 2, t]).  Lanes outside the window are
//       real neighbouring bodies: they are masked before the guard by
//       never being staged or visited.
// lens[0, g] counts approx lanes, lens[1, g] direct tiles.
//
// What bounds it on an H100: arithmetic.  Each pair is ~10 FP32
// instructions, one SFU rsqrtf and one IEEE divide; a staged k-tile
// (16 B per source) is reused by every target of the block, so bytes
// are negligible next to the pair work.
//
// Design: one block per (slice of S targets, group), one thread per
// target.  There is no scalar prefetch on the GPU, so each block reads
// its own lens entry and tile-table row.  It walks the occupied approx
// tiles, then the direct tiles, staging each k-tile of (x, y, gm) as
// float4 in shared memory; the per-tile partial sum is added to the
// running sum, as the TPU kernel adds each tile's lane reduction.  The
// TPU kernel's k_tile VMEM ceiling (list_eval.runs_k_max) does not apply:
// a k-tile costs 16 B of shared memory per lane.

#include <cuda_runtime.h>

namespace {

__global__ void runs_kernel(const float* __restrict__ tgt,     // [G, S, 2]
                            const float* __restrict__ approx,  // [G, 8, A]
                            const float* __restrict__ srct,    // [8, npad]
                            const int* __restrict__ tiles,     // [G, 3, T]
                            const int* __restrict__ lens,      // [2, G]
                            float* __restrict__ out,           // [G, S, 2]
                            const int n_groups, const int S, const int A,
                            const long long npad, const int T,
                            const int k_tile, const float eps) {
  extern __shared__ float4 stile[];
  const int g = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < S;
  const size_t ti_base = (static_cast<size_t>(g) * S + i) * 2;
  const float px = live ? tgt[ti_base] : 0.f;
  const float py = live ? tgt[ti_base + 1] : 0.f;

  const int a_t = (lens[g] + k_tile - 1) / k_tile;
  const int d_t = min(lens[n_groups + g], T);
  const float* ap = approx + static_cast<size_t>(g) * 8 * A;
  const int* tb = tiles + static_cast<size_t>(g) * 3 * T;

  float ax = 0.f, ay = 0.f;
  for (int t = 0; t < a_t + d_t; ++t) {
    int lo, hi;
    if (t < a_t) {
      const int c0 = t * k_tile;
      lo = 0;
      hi = min(k_tile, A - c0);
      for (int j = threadIdx.x; j < hi; j += blockDim.x) {
        stile[j] = make_float4(ap[c0 + j], ap[A + c0 + j], ap[2 * A + c0 + j], 0.f);
      }
    } else {
      const int d = t - a_t;
      const long long start = tb[d];
      long long hi_ll = min(tb[2 * T + d], k_tile);
      if (hi_ll > npad - start) hi_ll = npad - start;  // table tail
      hi = static_cast<int>(hi_ll);
      lo = max(tb[T + d], 0);
      for (int j = lo + static_cast<int>(threadIdx.x); j < hi; j += blockDim.x) {
        const long long c = start + j;
        stile[j] = make_float4(srct[c], srct[npad + c], srct[2 * npad + c], 0.f);
      }
    }
    __syncthreads();
    float tx = 0.f, ty = 0.f;
    for (int j = lo; j < hi; ++j) {
      const float4 s = stile[j];
      const float dx = s.x - px;
      const float dy = s.y - py;
      const float d2 = dx * dx + dy * dy;
      const float inv_d = rsqrtf(d2);
      const float dist = d2 * inv_d;
      float w = s.z / (d2 * (dist + eps));
      w = (d2 > 0.f && s.z > 0.f) ? w : 0.f;
      tx += w * dx;
      ty += w * dy;
    }
    ax += tx;
    ay += ty;
    __syncthreads();
  }
  if (live) {
    out[ti_base] = ax;
    out[ti_base + 1] = ay;
  }
}

}  // namespace

extern "C" int nbody_runs_eval(const float* tgt, const float* approx,
                               const float* srct, const int* tiles,
                               const int* lens, float* out, int n_groups,
                               int S, int A, long long npad, int T,
                               int k_tile, float softening, int threads,
                               void* stream) {
  if (n_groups == 0 || S == 0) return 0;
  const size_t smem = sizeof(float4) * static_cast<size_t>(k_tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + threads - 1) / threads, n_groups);
  runs_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      tgt, approx, srct, tiles, lens, out, n_groups, S, A, npad, T, k_tile,
      softening);
  return static_cast<int>(cudaGetLastError());
}
