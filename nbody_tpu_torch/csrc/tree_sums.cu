// The tree builds' leaf sums on Hopper (sm_90a), behind ops/tree.leaf_sums
// (the 2D quadtree's leaf_raw, 8 columns, and the 3D octree's leaf_raw_3d,
// 16 columns).  Not a TPU kernel: the JAX package takes XLA's segment_sum
// (nbody_tpu/ops/tree.py, tree3d.py), which fixes no order of addition;
// the port took torch.segment_reduce before these kernels.
//
// Semantics: out[leaf, c] sums rows[r, c] over the leaf's rows
// [end - len, end) of the Morton-sorted rows in a fixed two-level order
// with one constant, kChunk = C = 16,384 rows (ops/tree.LEAF_CHUNK):
//  * a leaf of at most C rows is one serial sum from 0 in row order
//    (torch.segment_reduce's bits; an empty leaf is 0, a singleton keeps
//    its row's bits);
//  * a longer leaf is cut into chunks of C rows from its first row (the
//    last one shorter); each chunk is a serial sum from 0 in row order, and
//    the leaf is the chunk partials summed serially from 0 in chunk order.
// The order depends on the lengths alone, never on the card or the launch
// shape, and no sum takes an atomic: every launch gives the same bits, and
// leaf_sums_plain computes them with two segment_reduce calls.  C bounds a
// chain at 16,384 dependent adds (~33 us at 4 cycles and 1.98 GHz) and
// keeps the serial bits on every leaf of up to 16,384 rows.
//
// What bounds it on an H100: bytes (N x W x 4 read, leaves x W x 4 written,
// leaves x 8 of ends read: ~0.065 ms at 3D 1M, depth 7).  A uniform state's
// leaves hold ~0.5 bodies; an evolved one piles most bodies into a few
// leaves (one of 1,048,522 rows after 10 steps at 1M), which one serial
// chain would hold to ~2.1 ms; cut into chunks it is 64 chains of 16,384
// adds on 64 SMs and one of 64.  Two launches after the wrapper's prefix
// sum of the lengths, each grid sized from the tensors' shapes (a CUDA
// graph holds them with no host read):
//  * leaf_sums_kernel: persistent blocks (one wave, three an SM) of two
//    roles.
//    - Warps 1-7, the light leaves: a leaf of at most kLight rows is
//      summed by one thread, all W columns in registers, 16-byte loads and
//      stores, its start and length read from ends alone (32-bit indices
//      where they fit); the warps stride over the leaves.
//    - Warp 0, every chunk of every leaf longer than kLight, as (leaf,
//      chunk) work items spread over the whole card: each warp owns a
//      contiguous range of kLight-row blocks; a row block holds the start
//      of at most two such chunks (a longer leaf cannot start twice in
//      it), found by binary search in ends for the leaves holding its
//      first row and the next block's.  A chunk streams into shared memory
//      in 16 KB stages, each one cp.async.bulk on an mbarrier, through a
//      ring of kStages; W lanes add a stage's columns in blocks of 16 rows
//      while the next stages land, and the next round's searches (bounded
//      by the warp's own leaves) run while a round's first copies land.  A
//      one-chunk leaf's sum goes to out; a longer leaf's to its slot
//      2 * floor(start / C) + chunk of the partials (distinct, below
//      2 * (N / C)).  The light warps run beside these chains.  On an
//      evolved state the chunks' streams, 1 MB into one SM each beside the
//      light warps' writes, bound the launch, not the adds (PERF.md).
//  * leaf_finish_kernel: one warp a C-row block; the leaf longer than C
//    that starts there (at most one) sums its partials in chunk order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 16384;  // C: the order's chunk (ops/tree.LEAF_CHUNK)
constexpr int kLight = 32;  // longest leaf of the light warps (row block)
constexpr int kFinishThreads = 256;  // leaf_finish_kernel's block
constexpr int kStageBytes = 16384;  // a stage of the ring
constexpr int kStages = 4;  // stages a ring warp has in flight
constexpr int kRound = 31;  // row blocks a warp searches at once
constexpr int kItems = 2 * kRound;  // chunks one round can yield
// dynamic shared memory of a block (its ring): stages, mbarriers, two item
// lists; three blocks an SM
constexpr int kRingBytes =
    kStages * kStageBytes + kStages * 8 + 2 * kItems * (8 + 8 + 4);
constexpr int kBlock = 256;  // leaf_sums_kernel's: the ring warp, 7 light

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

// 16 bytes of a row: its vector type, and adding one into W accumulators
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ void add(float* acc, const float4& v) {
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
    acc[2] = __fadd_rn(acc[2], v.z);
    acc[3] = __fadd_rn(acc[3], v.w);
  }
  static __device__ __forceinline__ float4 pack(const float* a) {
    return make_float4(a[0], a[1], a[2], a[3]);
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ void add(double* acc, const double2& v) {
    acc[0] = __dadd_rn(acc[0], v.x);
    acc[1] = __dadd_rn(acc[1], v.y);
  }
  static __device__ __forceinline__ double2 pack(const double* a) {
    return make_double2(a[0], a[1]);
  }
};

// -- the light leaves --------------------------------------------------------

// Sum `leaf` if it holds at most kLight rows (else the ring warps do).
template <typename T, int W, typename I>
__device__ __forceinline__ void light_leaf(const T* __restrict__ rows,
                                           const long long* __restrict__ ends,
                                           T* __restrict__ out, I leaf) {
  using V = Vec16<T>;
  using VT = typename V::type;
  constexpr int kVecs = W / V::n;  // vectors a row
  constexpr int kBatch = W * sizeof(T) >= 128 ? 1 : 128 / (W * sizeof(T));
  const I end = static_cast<I>(ends[leaf]);
  const I start = leaf == 0 ? I(0) : static_cast<I>(ends[leaf - 1]);
  const I len = end - start;
  if (len > kLight) return;
  T acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = T(0);
  const VT* p = reinterpret_cast<const VT*>(rows + start * W);
  for (I r0 = 0; r0 < len; r0 += kBatch) {
    VT buf[kBatch][kVecs];  // the batch's loads, all issued before adding
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r0 + u < len) {
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          buf[u][v] = __ldg(p + (r0 + u) * kVecs + v);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r0 + u < len) {
#pragma unroll
        for (int v = 0; v < kVecs; ++v) V::add(acc + v * V::n, buf[u][v]);
      }
    }
  }
  VT* o = reinterpret_cast<VT*>(out + leaf * W);
#pragma unroll
  for (int v = 0; v < kVecs; ++v) o[v] = V::pack(acc + v * V::n);
}

// -- the ring: shared-memory stages filled by cp.async.bulk ------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one lane: expect `bytes` on `bar` and start their copy into `dst`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wait for the phase of `parity` to complete; a copy that never lands
// (a fault of this file) traps after ~10 s rather than hang the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// The ring of one warp (a block): kStages stages of kStageBytes, their
// mbarriers, then two lists of work items (a round's and the next one's).
template <typename T>
struct Ring {
  T* stage;
  uint64_t* bar;
  long long* src;  // [2][kItems] the chunk's first row
  long long* dst;  // [2][kItems] out row (>= 0) or -(partials row) - 1
  int* rows;  // [2][kItems] the chunk's rows

  __device__ explicit Ring(unsigned char* smem) {
    stage = reinterpret_cast<T*>(smem);
    bar = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
    src = reinterpret_cast<long long*>(bar + kStages);
    dst = src + 2 * kItems;
    rows = reinterpret_cast<int*>(dst + 2 * kItems);
  }

  // lane 0 of the warp, before any other use
  __device__ void init() {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bar + s))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // lane 0: ring position `pos` takes `n` rows of w columns from `from`
  __device__ void issue(uint32_t pos, const T* from, int n, int w) {
    const int s = static_cast<int>(pos % kStages);
    bulk_load(reinterpret_cast<unsigned char*>(stage) + s * kStageBytes,
              from, static_cast<uint32_t>(n) * w * sizeof(T), bar + s);
  }

  // the stage of ring position `pos`, once its copy has landed
  __device__ const T* wait(uint32_t pos) {
    const int s = static_cast<int>(pos % kStages);
    bar_wait(bar + s, (pos / kStages) & 1u);
    return reinterpret_cast<const T*>(
        reinterpret_cast<const unsigned char*>(stage) + s * kStageBytes);
  }
};

// The leaf holding `row`: the first whose end is past it, known to lie in
// [lo, hi].
__device__ __forceinline__ long long leaf_of(const long long* ends,
                                             long long lo, long long hi,
                                             long long row) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) > row) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__device__ __forceinline__ long long start_of(const long long* ends,
                                              long long leaf) {
  return leaf == 0 ? 0 : __ldg(ends + leaf - 1);
}

// -- the chunks of the leaves longer than kLight -----------------------------

// One stage's serial adds: acc + st[0] + st[w] + ... + st[(m - 1) * w]
// (st: this lane's column of the stage).
template <typename T>
__device__ __forceinline__ T stage_sum(T acc, const T* st, int m, int w) {
  // whole blocks of 16 rows, their loads issued together before the adds
  int r = 0;
  for (; r + 16 <= m; r += 16) {
    T v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = st[(r + u) * w];
#pragma unroll
    for (int u = 0; u < 16; ++u) acc = add_rn(acc, v[u]);
  }
  for (; r < m; ++r) acc = add_rn(acc, st[r * w]);
  return acc;
}

// The chunks starting in row blocks [k0, k0 + kRound) of the warp's
// [k0, k1), into list `buf` of the ring; returns their count.  The leaves
// searched lie in [first, last]; first moves up to the next round's.
template <typename T>
__device__ int find_chunks(const long long* ends, long long& first,
                           long long last, long long n_rows, long long k0,
                           long long k1, Ring<T>& ring, int buf) {
  const int lane = threadIdx.x & 31;
  const long long row = (k0 + lane) * kLight;
  const long long here =
      row < n_rows ? leaf_of(ends, first, last, row) : -1;
  const long long next = __shfl_down_sync(0xffffffffu, here, 1);
  const long long after = __shfl_sync(0xffffffffu, here, 31);
  if (after >= 0) first = after;
  const long long k = k0 + lane;
  bool has_a = false, has_b = false;
  long long a_src = 0, a_dst = 0, b_src = 0, b_dst = 0;
  int a_n = 0, b_n = 0;
  if (lane < kRound && k < k1) {
    const long long lo = k * kLight, hi = lo + kLight;
    // (a) the chunk of the leaf holding row lo that starts in [lo, hi)
    const long long sa = start_of(ends, here), ea = __ldg(ends + here);
    const long long la = ea - sa;
    if (la > kLight) {
      const long long c = (lo - sa + kChunk - 1) / kChunk;
      const long long cs = sa + c * kChunk;
      if (cs < hi && cs < ea) {
        has_a = true;
        a_src = cs;
        a_n = static_cast<int>(ea - cs < kChunk ? ea - cs : kChunk);
        a_dst = la <= kChunk ? here : -(2 * (sa / kChunk) + c) - 1;
      }
    }
    // (b) a leaf longer than kLight that starts inside (lo, hi) holds row
    // hi, the next lane's search
    if (hi < n_rows && next != here) {
      const long long sb = start_of(ends, next), lb = __ldg(ends + next) - sb;
      if (sb > lo && sb < hi && lb > kLight) {
        has_b = true;
        b_src = sb;
        b_n = static_cast<int>(lb < kChunk ? lb : kChunk);
        b_dst = lb <= kChunk ? next : -(2 * (sb / kChunk)) - 1;
      }
    }
  }
  const unsigned ma = __ballot_sync(0xffffffffu, has_a);
  const unsigned mb = __ballot_sync(0xffffffffu, has_b);
  __syncwarp();  // every lane is done with the list this round rewrites
  const unsigned below = (1u << lane) - 1u;
  int i = buf * kItems + __popc(ma & below) + __popc(mb & below);
  if (has_a) {
    ring.src[i] = a_src;
    ring.dst[i] = a_dst;
    ring.rows[i] = a_n;
    ++i;
  }
  if (has_b) {
    ring.src[i] = b_src;
    ring.dst[i] = b_dst;
    ring.rows[i] = b_n;
  }
  __syncwarp();
  return __popc(ma) + __popc(mb);
}

// Warp 0 of a leaf_sums_kernel block: the chunks starting in its range of
// kLight-row blocks.
template <typename T, int W>
__device__ void ring_warp(const T* __restrict__ rows,
                          const long long* __restrict__ ends,
                          T* __restrict__ out, T* __restrict__ partials,
                          long long n_leaf, long long n_rows,
                          unsigned char* smem) {
  constexpr int w = W;
  const long long blocks = (n_rows + kLight - 1) / kLight;
  const long long per = (blocks + gridDim.x - 1) / gridDim.x;
  const long long k_lo = blockIdx.x * per;
  const long long k_hi = k_lo + per < blocks ? k_lo + per : blocks;
  if (k_lo >= k_hi) return;
  const int lane = threadIdx.x;  // warp 0
  constexpr int stage_rows = kStageBytes / (W * static_cast<int>(sizeof(T)));
  Ring<T> ring(smem);
  if (lane == 0) ring.init();
  __syncwarp();

  // every row this warp searches lies in [k_lo * kLight, last_row]
  const long long last_row =
      ((k_hi + kRound) * kLight < n_rows ? (k_hi + kRound) * kLight
                                         : n_rows) - 1;
  const long long bound = leaf_of(ends, 0, n_leaf - 1,
                                  lane == 0 ? k_lo * kLight : last_row);
  long long first = __shfl_sync(0xffffffffu, bound, 0);
  const long long last = __shfl_sync(0xffffffffu, bound, 1);
  int buf = 0;
  int n = find_chunks(ends, first, last, n_rows, k_lo, k_hi, ring, buf);
  uint32_t seq = 0;  // ring positions used so far
  for (long long k0 = k_lo; k0 < k_hi; k0 += kRound) {
    const long long* src = ring.src + buf * kItems;
    const long long* dst = ring.dst + buf * kItems;
    const int* cnt = ring.rows + buf * kItems;
    // lane 0's cursor over the round's stages: chunk `pi`, its row `pr`
    int pi = 0, pr = 0;
    uint32_t issued = 0;
    auto issue_next = [&]() {
      if (pi >= n) return;
      const int m = cnt[pi] - pr < stage_rows ? cnt[pi] - pr : stage_rows;
      ring.issue(seq + issued, rows + (src[pi] + pr) * w, m, w);
      ++issued;
      pr += m;
      if (pr == cnt[pi]) {
        ++pi;
        pr = 0;
      }
    };
    if (lane == 0) {
      for (int q = 0; q < kStages; ++q) issue_next();
    }
    // the next round's searches while these copies are in flight
    const int n_next = k0 + kRound < k_hi
                           ? find_chunks(ends, first, last, n_rows,
                                         k0 + kRound, k_hi, ring, buf ^ 1)
                           : 0;
    uint32_t q = 0;  // stages consumed this round
    for (int i = 0; i < n; ++i) {
      const int m_all = cnt[i];
      T acc = T(0);
      for (int r0 = 0; r0 < m_all; r0 += stage_rows) {
        if (lane < w) {
          const int m = m_all - r0 < stage_rows ? m_all - r0 : stage_rows;
          acc = stage_sum(acc, ring.wait(seq + q) + lane, m, w);
        }
        ++q;
        __syncwarp();
        if (lane == 0) {  // the stage just read takes the next copy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue_next();
        }
      }
      if (lane < w) {
        const long long d = dst[i];
        if (d >= 0) {
          out[d * w + lane] = acc;
        } else {
          partials[(-d - 1) * w + lane] = acc;
        }
      }
    }
    seq += q;
    n = n_next;
    buf ^= 1;
  }
}

template <typename T, int W, typename I>
__global__ void __launch_bounds__(kBlock, 3)
    leaf_sums_kernel(const T* __restrict__ rows,
                     const long long* __restrict__ ends,
                     T* __restrict__ out, T* __restrict__ partials,
                     long long n_leaf, long long n_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x < 32) {
    ring_warp<T, W>(rows, ends, out, partials, n_leaf, n_rows, smem);
    return;
  }
  constexpr int kLightThreads = kBlock - 32;
  const I stride = static_cast<I>(gridDim.x) * kLightThreads;
  for (I leaf = static_cast<I>(blockIdx.x) * kLightThreads + threadIdx.x - 32;
       leaf < static_cast<I>(n_leaf); leaf += stride) {
    light_leaf<T, W, I>(rows, ends, out, leaf);
  }
}

// -- the leaves longer than kChunk: their partials in chunk order ------------

template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
    leaf_finish_kernel(const long long* __restrict__ ends,
                       const T* __restrict__ partials, T* __restrict__ out,
                       long long n_leaf, long long n_rows, int w) {
  // warp k takes C-row block k; a leaf longer than C that starts there
  // holds row (k + 1) * C, and its partials are rows 2k, 2k + 1, ...
  const long long k =
      (static_cast<long long>(blockIdx.x) * kFinishThreads + threadIdx.x) /
      32;
  const int lane = threadIdx.x & 31;
  if ((k + 1) * kChunk >= n_rows || lane >= w) return;
  const long long leaf = leaf_of(ends, 0, n_leaf - 1, (k + 1) * kChunk);
  const long long s = start_of(ends, leaf), len = __ldg(ends + leaf) - s;
  if (s < k * kChunk || s >= (k + 1) * kChunk || len <= kChunk) return;
  const long long chunks = (len + kChunk - 1) / kChunk;
  const T* p = partials + 2 * k * w + lane;
  T acc = T(0);
#pragma unroll 8
  for (long long j = 0; j < chunks; ++j) acc = add_rn(acc, p[j * w]);
  out[leaf * w + lane] = acc;
}

// -- launches ----------------------------------------------------------------

// One wave of leaf_sums_kernel<T, W, I> (asked once; no stream work, so a
// graph capture may ask).
template <typename T, int W, typename I>
int wave(int* grid) {
  static int blocks = 0;
  if (blocks == 0) {
    auto* kernel = leaf_sums_kernel<T, W, I>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kBlock, kRingBytes);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks = sms * per_sm;
  }
  *grid = blocks;
  return 0;
}

template <typename T, int W>
int launch_sums(const T* rows, const long long* ends, T* out, T* partials,
                long long n_leaf, long long n_rows, cudaStream_t s) {
  const long long most = n_rows > n_leaf ? n_rows : n_leaf;
  int grid = 0, code = 0;
  if (most * W < (1LL << 31)) {
    if ((code = wave<T, W, int>(&grid)) != 0) return code;
    leaf_sums_kernel<T, W, int><<<grid, kBlock, kRingBytes,
                                  s>>>(
        rows, ends, out, partials, n_leaf, n_rows);
  } else {
    if ((code = wave<T, W, long long>(&grid)) != 0) return code;
    leaf_sums_kernel<T, W, long long><<<grid, kBlock,
                                        kRingBytes, s>>>(
        rows, ends, out, partials, n_leaf, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* rows_v, const long long* ends, void* out_v,
           void* partials_v, long long n_rows, long long n_leaf, int w,
           cudaStream_t s) {
  const T* rows = static_cast<const T*>(rows_v);
  T* out = static_cast<T*>(out_v);
  T* partials = static_cast<T*>(partials_v);
  int code = 0;
  switch (w) {
    case 2:
      if constexpr (sizeof(T) == 8) {  // 16 bytes a row
        code = launch_sums<T, 2>(rows, ends, out, partials, n_leaf, n_rows,
                                 s);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    case 4:
      code = launch_sums<T, 4>(rows, ends, out, partials, n_leaf, n_rows, s);
      break;
    case 8:
      code = launch_sums<T, 8>(rows, ends, out, partials, n_leaf, n_rows, s);
      break;
    case 16:
      code = launch_sums<T, 16>(rows, ends, out, partials, n_leaf, n_rows, s);
      break;
    case 32:
      code = launch_sums<T, 32>(rows, ends, out, partials, n_leaf, n_rows, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  if (n_rows > kChunk) {  // else no leaf is longer than kChunk
    const long long warps = (n_rows + kChunk - 1) / kChunk;
    const unsigned blocks = static_cast<unsigned>(
        (warps * 32 + kFinishThreads - 1) / kFinishThreads);
    leaf_finish_kernel<T><<<blocks, kFinishThreads, 0, s>>>(
        ends, partials, out, n_leaf, n_rows, w);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// One call: rows [n_rows, w] (f32, or f64 when is_double; 16-byte aligned),
// ends [n_leaf] int64 (the inclusive prefix sums of the leaves' lengths),
// out [n_leaf, w], partials [2 * (n_rows / 16384), w] of scratch (at least
// one row).  w is a power of two, at most 32, of at least 16 bytes a row
// (the wrapper pads narrower rows with zero columns).
extern "C" int nbody_leaf_sums(const void* rows, const long long* ends,
                               void* out, void* partials, long long n_rows,
                               long long n_leaf, int w, int is_double,
                               void* stream) {
  if (n_leaf == 0) return 0;
  const int width_bytes = w * (is_double ? 8 : 4);
  if (w < 1 || w > 32 || (w & (w - 1)) != 0 || width_bytes < 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(rows, ends, out, partials, n_rows, n_leaf,
                                    w, s)
                   : launch<float>(rows, ends, out, partials, n_rows, n_leaf,
                                   w, s);
}
