// The tree builds' leaf sums on Hopper (sm_90a): leaf_sums_kernel, behind
// ops/tree.leaf_sums (the 2D quadtree's leaf_raw, 8 columns, and the 3D
// octree's leaf_raw_3d, 16 columns).  Not a TPU kernel: the JAX package
// takes XLA's segment_sum (nbody_tpu/ops/tree.py, tree3d.py), and the port
// took torch.segment_reduce before this kernel.
//
// Semantics: out[leaf, c] = the sum of rows[r, c] over the leaf's rows
// [end - len, end) of the Morton-sorted rows, one serial sum in row order
// from 0, as torch.segment_reduce adds; an empty leaf is 0 and a
// singleton leaf keeps its row's bits.  No atomics, so every launch gives
// the same bits.
//
// What bounds it on an H100: bytes (N x W x 4 read, leaves x W x 4
// written, leaves x 8 of lengths and ends read: ~0.07 ms at 3D 1M, depth
// 7) for uniform states, whose leaves hold ~0.5 bodies.  An evolved state
// piles most bodies into a few leaves at max depth, and then the serial
// order is the bound: a leaf's column is one chain of dependent adds.
// torch.segment_reduce runs that chain in one thread per (leaf, column)
// on global loads (100.52 ms of a 269 ms 1M step, PERF.md).  Design:
//  * light leaves (at most kLight rows): one thread per (leaf, column),
//    neighbouring threads on neighbouring columns of a row, so each row is
//    one coalesced load; the light blocks are one wave of the card and
//    stride over the leaves (a block a few leaves wide would make the
//    launch a queue of near-empty blocks: 1.01 ms against
//    segment_reduce's 0.31 at 3D 1M uniform, PERF.md);
//  * heavy leaves: one block a leaf streams its rows through shared memory
//    in coalesced chunks, the next chunk in registers while W threads add
//    this one in row order, so the chain waits on FADD latency, not on
//    memory.  The first kHeavyBlocks blocks of the grid take the heavy
//    leaves (leaf i goes to block i mod kHeavyBlocks, so neighbouring
//    heavy leaves, as a blob's are, go to different blocks), found by
//    scanning the lengths; the rest take the light ones.  (Scanning in
//    coalesced runs of kThreads leaves, run r to block r mod
//    kHeavyBlocks, read 0.329 against 0.270 ms on a 262,144-body blob
//    state, whose 201 heavy leaves then queue in a few blocks.)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLight = 64;  // rows of the longest light leaf
constexpr int kHeavyBlocks = 264;  // 2 per SM
constexpr int kChunkBytes = 16384;  // a heavy leaf's rows staged per step

template <typename T>
__device__ __forceinline__ T add_rn(T a, T b);
template <>
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
template <>
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    leaf_sums_kernel(const T* __restrict__ rows,
                     const long long* __restrict__ lengths,
                     const long long* __restrict__ ends, T* __restrict__ out,
                     long long n_leaf, int w) {
  constexpr int kElems = kChunkBytes / sizeof(T);
  constexpr int kPer = kElems / kThreads;  // elements a thread stages
  __shared__ T stage[kElems];
  __shared__ long long found[kThreads];
  __shared__ int n_found;
  const int tid = threadIdx.x;

  if (blockIdx.x >= kHeavyBlocks) {  // light leaves, grid-strided
    // w divides kThreads, so it is a power of two: (leaf, column) of a
    // thread index by a shift and a mask, not a 64-bit division
    const int shift = __ffs(w) - 1;
    const long long stride =
        static_cast<long long>(gridDim.x - kHeavyBlocks) * kThreads;
    for (long long g =
             static_cast<long long>(blockIdx.x - kHeavyBlocks) * kThreads +
             tid;
         g < n_leaf * w; g += stride) {
      const long long leaf = g >> shift;
      const int col = static_cast<int>(g) & (w - 1);
      const long long len = lengths[leaf];
      if (len > kLight) continue;
      const T* p = rows + (ends[leaf] - len) * w + col;
      T acc = T(0);
#pragma unroll 4
      for (long long r = 0; r < len; ++r) acc = add_rn(acc, p[r * w]);
      out[leaf * w + col] = acc;
    }
    return;
  }

  // heavy leaves: this block's are leaf = blockIdx.x + k * kHeavyBlocks
  const long long per_row = static_cast<long long>(kElems / w);
  for (long long k0 = 0; blockIdx.x + k0 * kHeavyBlocks < n_leaf;
       k0 += kThreads) {
    if (tid == 0) n_found = 0;
    __syncthreads();
    const long long cand = blockIdx.x + (k0 + tid) * kHeavyBlocks;
    if (cand < n_leaf && lengths[cand] > kLight) {
      found[atomicAdd(&n_found, 1)] = cand;  // any order: leaves are apart
    }
    __syncthreads();
    const int nf = n_found;
    for (int f = 0; f < nf; ++f) {
      const long long leaf = found[f];
      const long long len = lengths[leaf];
      const T* base = rows + (ends[leaf] - len) * w;
      const long long total = len * w;  // elements of this leaf
      const long long step = per_row * w;  // elements a chunk
      T acc = T(0);
      T reg[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const long long i = static_cast<long long>(j) * kThreads + tid;
        reg[j] = i < total && i < step ? base[i] : T(0);
      }
      for (long long c0 = 0; c0 < total; c0 += step) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) stage[j * kThreads + tid] = reg[j];
        __syncthreads();
        const long long c1 = c0 + step;  // the next chunk, in flight
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const long long i = static_cast<long long>(j) * kThreads + tid;
          reg[j] = i < step && c1 + i < total ? base[c1 + i] : T(0);
        }
        if (tid < w) {
          const long long rows_here =
              (total - c0 < step ? total - c0 : step) / w;
#pragma unroll 8
          for (long long r = 0; r < rows_here; ++r) {
            acc = add_rn(acc, stage[r * w + tid]);
          }
        }
        __syncthreads();
      }
      if (tid < w) out[leaf * w + tid] = acc;
    }
    __syncthreads();  // n_found is rewritten next round
  }
}

template <typename T>
int launch(const void* rows, const long long* lengths, const long long* ends,
           void* out, long long n_leaf, int w, cudaStream_t stream) {
  // one wave of light blocks: the card's SMs x the blocks one SM holds
  // (asked once; no stream work, so a graph capture may ask)
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, leaf_sums_kernel<T>, kThreads, 0);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    wave = sms * per_sm;
  }
  const long long needed = (n_leaf * w + kThreads - 1) / kThreads;
  const long long light = needed < wave ? needed : wave;
  leaf_sums_kernel<T><<<static_cast<unsigned>(kHeavyBlocks + light),
                        kThreads, 0, stream>>>(
      static_cast<const T*>(rows), lengths, ends, static_cast<T*>(out),
      n_leaf, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch: rows [N, w] (f32, or f64 when is_double), lengths and ends
// (inclusive prefix sums of lengths) [n_leaf] int64, out [n_leaf, w].
// w must divide kThreads and be at most 32.
extern "C" int nbody_leaf_sums(const void* rows, const long long* lengths,
                               const long long* ends, void* out,
                               long long n_leaf, int w, int is_double,
                               void* stream) {
  if (n_leaf == 0) return 0;
  if (w < 1 || w > 32 || kThreads % w != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(rows, lengths, ends, out, n_leaf, w, s)
                   : launch<float>(rows, lengths, ends, out, n_leaf, w, s);
}
