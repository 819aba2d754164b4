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
// Design of K2/K3: one block per (slice of targets, group), one thread
// per target, so each thread owns its sum: no atomics, deterministic.
// There is no scalar prefetch on the GPU, so each block reads its own lens
// entry and table entries.  Each step stages its lanes of (x, y, z, gm) as
// float4 in shared memory (z = 0 in 2D; the mass is always .w), then every
// thread loops over the staged windows; the per-step partial sum is added
// to the running sum, as the TPU kernels add each step's lane reduction.
// The TPU kernels' k_tile VMEM ceiling (list_eval.runs_k_max) does not
// apply: a k-tile costs 16 B of shared memory per lane.  Every table read
// is bounded by T, every list read by its width.
//
// Design of K4: what held its first design (K2's loop, one unit a step)
// back was the step: 2.4x K2's direct tiles, ~218 live lanes each, every
// one between two block barriers with no load in flight, and the gm = 0
// tails of approx and extension tiles evaluated.  Now:
//  * Packed units.  A quarter's units (approx tiles, extension tiles,
//    direct entries, in that order) form one stream of the lanes they
//    need: an approx tile's lanes below lens[0, i], an extension tile's
//    below lens[1, i], a direct entry's [lo, hi).  The stream goes through
//    shared memory in chunks of kSplitChunk lanes, as many units to a
//    chunk as fit.  Dropping the tails is exact: every lane past lens in
//    an occupied tile is gm = 0 and finite, so it would add +-0.
//  * One partial per unit.  Each target sums a unit's lanes, in lane
//    order, into a fresh partial that enters its running sum when the unit
//    ends, in unit order, as the first design added each step's partial;
//    nbody::pair_force pins pair_window's roundings.  The same operations
//    in the same order, so the same bits.  A unit that runs past a chunk
//    carries its partial over.
//  * Streaming.  The next chunk is loaded into registers before this
//    chunk's pair loop, so its loads fly during it.  Shared memory is one
//    chunk and two tables of kUnits unit bounds (~16 KB), whatever k_tile.
//  * Heaviest quarters first.  A quarter's lanes are heavy-tailed (at 1M:
//    mean ~16,550, max ~280,000), so the kernel's time is the heaviest
//    quarters' blocks; one target a thread keeps each of them short (two
//    or more targets a thread measured slower: PERF.md), and the wrapper's
//    `order` starts the heaviest first.
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

constexpr int kSplitThreads = 256;  // SPLIT_THREADS in ops/list_eval.py
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitPer = 2;  // lanes each thread loads per chunk
constexpr int kSplitChunk = kSplitPer * kSplitThreads;  // lanes per chunk
constexpr int kUnits = kSplitThreads;  // units per batch, one per thread

// The stream of one quarter: its units, in table order, are the approx
// tiles (lanes < lens[0, i] of each), the extension tiles (lanes
// < lens[1, i]) and the direct entries ([lo, hi) of each, clipped as
// direct_entry clips it).  The stream is cut into chunks of at most
// kSplitChunk lanes that never cross a batch of kUnits units; a batch's
// table in shared memory gives each unit its first stream position (an
// exclusive prefix over the block), its list and its first column.
template <int DIMS>
__global__ void __launch_bounds__(kSplitThreads, 3) runs_split_kernel(
    const float* __restrict__ tgt,     // [G, S, DIMS]
    const float* __restrict__ approx,  // [G, 8, A]
    const float* __restrict__ ext,     // [4G, 8, E]
    const float* __restrict__ srct,    // [8, npad]
    const int* __restrict__ tiles,     // [4G, 3, T]
    const int* __restrict__ lens,      // [3, 4G]
    float* __restrict__ out,           // [G, S, DIMS]
    const int n_quarters, const int S, const int A, const int E,
    const long long npad, const int T, const int k_tile, const int e_tiles,
    const float eps, const int* __restrict__ order,
    unsigned long long* __restrict__ staged) {
  __shared__ float4 buf[kSplitChunk];
  __shared__ int upos[2][kUnits + 1];     // stream position of each unit
  __shared__ long long ucol[2][kUnits];   // its first column in its list
  __shared__ int ukind[2][kUnits];        // 0 approx, 1 extension, 2 direct
  __shared__ int wsum[kSplitWarps];
  const int qi = order[blockIdx.y];  // quarter i = 4g + q, heaviest first
  const int g = qi >> 2;
  const int sq = S / 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int i = blockIdx.x * kSplitThreads + threadIdx.x;  // in the quarter
  const bool live = i < sq;
  const size_t ti_base =
      (static_cast<size_t>(g) * S + (qi & 3) * sq + i) * DIMS;
  const float px = live ? tgt[ti_base] : 0.f;
  const float py = live ? tgt[ti_base + 1] : 0.f;
  const float pz = (DIMS == 3 && live) ? tgt[ti_base + DIMS - 1] : 0.f;

  const int a_t = (lens[qi] + k_tile - 1) / k_tile;
  const int e_t = min((lens[n_quarters + qi] + k_tile - 1) / k_tile, e_tiles);
  const int d_t = min(lens[2 * n_quarters + qi], T);
  const int a_lim = min(lens[qi], A);  // lanes the approx tiles hold
  const int e_lim = min(lens[n_quarters + qi], E);
  const int n_units = a_t + e_t + d_t;
  const float* ap = approx + static_cast<size_t>(g) * 8 * A;
  const float* ep = ext + static_cast<size_t>(qi) * 8 * E;
  const int* tb = tiles + static_cast<size_t>(qi) * 3 * T;

  // Units [u0, u0 + kUnits) into table `slot`, from stream position base;
  // returns the batch's end position.  Every thread takes part.
  auto build = [&](int slot, int u0, int base) {
    const int u = u0 + static_cast<int>(threadIdx.x);
    int w = 0, kind = 2;
    long long col = 0;
    if (u < a_t) {
      kind = 0;
      col = static_cast<long long>(u) * k_tile;
      w = min(k_tile, a_lim - u * k_tile);
    } else if (u < a_t + e_t) {
      kind = 1;
      col = static_cast<long long>(u - a_t) * k_tile;
      w = min(k_tile, e_lim - (u - a_t) * k_tile);
    } else if (u < n_units) {
      long long start;
      int lo, hi;
      direct_entry(tb, T, u - a_t - e_t, k_tile, npad, &start, &lo, &hi);
      col = start + lo;
      w = hi - lo;
    }
    w = max(w, 0);
    int x = w;  // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    int before = base, end = base;
#pragma unroll
    for (int ww = 0; ww < kSplitWarps; ++ww) {
      if (ww < warp) before += wsum[ww];
      end += wsum[ww];
    }
    upos[slot][threadIdx.x + 1] = before + x;
    if (threadIdx.x == 0) upos[slot][0] = base;
    ucol[slot][threadIdx.x] = col;
    ukind[slot][threadIdx.x] = kind;
    __syncthreads();
    return end;
  };

  // the chunk in flight: stream positions p0 + p * kSplitThreads + tid
  float4 v[kSplitPer];
  auto fetch = [&](int slot, int p0, int p1) {
#pragma unroll
    for (int p = 0; p < kSplitPer; ++p) {
      const int pos = p0 + p * kSplitThreads + static_cast<int>(threadIdx.x);
      v[p] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pos < p1) {
        // the unit holding pos: upos[lo] <= pos < upos[lo + 1]
        int lo = 0, hi = kUnits;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (upos[slot][mid] <= pos) {
            lo = mid;
          } else {
            hi = mid;
          }
        }
        const int kind = ukind[slot][lo];
        const float* sp = kind == 0 ? ap : (kind == 1 ? ep : srct);
        const long long pitch = kind == 0 ? A : (kind == 1 ? E : npad);
        const long long c = ucol[slot][lo] + (pos - upos[slot][lo]);
        v[p] = make_float4(sp[c], sp[pitch + c],
                           DIMS == 3 ? sp[2 * pitch + c] : 0.f,
                           sp[DIMS * pitch + c]);
      }
    }
  };

  // the first batch that holds lanes (an empty batch holds only empty
  // units, each of which would add +0)
  int slot = 0, u0 = 0;
  int bend = build(0, 0, 0);
  while (bend == 0 && u0 + kUnits < n_units) {
    u0 += kUnits;
    bend = build(0, u0, 0);
  }
  int pos0 = 0, pos1 = min(bend, kSplitChunk);
  int u = u0;  // the unit the pair loop is in
  if (pos1 > pos0) fetch(slot, pos0, pos1);

  float a[3] = {0.f, 0.f, 0.f};  // the running sum
  float t[3] = {0.f, 0.f, 0.f};  // this unit's partial
  unsigned long long n_staged = 0;
  while (pos1 > pos0) {  // uniform across the block
    const int m = pos1 - pos0;
    __syncthreads();  // every thread is done with the last chunk
#pragma unroll
    for (int p = 0; p < kSplitPer; ++p) {
      const int l = p * kSplitThreads + static_cast<int>(threadIdx.x);
      if (l < m) buf[l] = v[p];
    }
    n_staged += m;
    // the next chunk, from the next batch that holds lanes when this one
    // ends; its loads fly while this chunk is evaluated
    int nslot = slot, nu0 = u0, nbend = bend;
    const int np0 = pos1;
    if (np0 == bend) {
      nslot = slot ^ 1;
      while (nbend == np0 && nu0 + kUnits < n_units) {
        nu0 += kUnits;
        nbend = build(nslot, nu0, np0);
      }
    }
    const int np1 = min(nbend, np0 + kSplitChunk);
    __syncthreads();
    if (np1 > np0) fetch(nslot, np0, np1);

    // each unit's lanes into its partial, which enters the running sum
    // when the unit ends (an empty unit adds +0); a unit that runs on past
    // the chunk carries its partial into the next
    int j = 0;
    while (j < m) {
      const int uend = upos[slot][u - u0 + 1] - pos0;
      const int e = min(uend, m);
      for (; j < e; ++j) {
        nbody::pair_force<DIMS>(buf[j], px, py, pz, eps, &t[0], &t[1],
                                &t[2]);
      }
      if (uend <= m) {
#pragma unroll
        for (int d = 0; d < DIMS; ++d) {
          a[d] += t[d];
          t[d] = 0.f;
        }
        ++u;
      }
    }
    if (nslot != slot) u = nu0;  // a batch ends at a unit's end
    slot = nslot;
    u0 = nu0;
    bend = nbend;
    pos0 = np0;
    pos1 = np1;
  }
  if (staged != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(staged, n_staged);
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < DIMS; ++d) out[ti_base + d] = a[d];
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

using SplitFn = void (*)(const float*, const float*, const float*,
                        const float*, const int*, const int*, float*, int,
                        int, int, int, long long, int, int, int, float,
                        const int*, unsigned long long*);

SplitFn split_for(int dims) {
  return dims == 3 ? runs_split_kernel<3>
                   : (dims == 2 ? runs_split_kernel<2> : nullptr);
}

}  // namespace

// One launch of K4: `threads` must be kSplitThreads; blocks of
// kSplitThreads targets over each quarter's S / 4, one row per quarter,
// row r taking quarter order[r] (a permutation of the 4G quarters).  A
// non-null `staged` gets the lanes the first block of each quarter
// staged.
extern "C" int nbody_runs_eval_split(const float* tgt, const float* approx,
                                     const float* ext, const float* srct,
                                     const int* tiles, const int* lens,
                                     float* out, int n_quarters, int S, int A,
                                     int E, long long npad, int T, int k_tile,
                                     int e_tiles, float softening, int dims,
                                     int threads, const int* order,
                                     unsigned long long* staged,
                                     void* stream) {
  if (n_quarters == 0 || S == 0) return 0;
  const SplitFn kernel = split_for(dims);
  if (kernel == nullptr || threads != kSplitThreads || S % 4 ||
      n_quarters % 4 || k_tile < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S / 4 + kSplitThreads - 1) / kSplitThreads, n_quarters);
  kernel<<<grid, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tgt, approx, ext, srct, tiles, lens, out, n_quarters, S, A, E, npad, T,
      k_tile, e_tiles, softening, order, staged);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K4 (`dims`) an SM of the current card holds at once, into
// *blocks_per_sm.
extern "C" int nbody_runs_split_occupancy(int dims, int threads,
                                          int* blocks_per_sm) {
  const SplitFn kernel = split_for(dims);
  if (kernel == nullptr || threads != kSplitThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kSplitThreads, 0));
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
