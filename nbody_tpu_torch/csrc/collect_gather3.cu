// The 3D gather walk on Hopper (sm_90a), behind ops/bh3d._collect_lists_3d
// for CUDA tensors.  Not a TPU kernel: the JAX package's gather walk
// (nbody_tpu/ops/bh3d.py) is XLA.  Added because the port's torch body of
// the walk (bh3d._gather_lists, the kernel's plain twin) spent hundreds of
// operators a level: [G, F, 16] row gathers, [G, Q/4, F] distance
// temporaries, an eightfold repeat of the frontier and a stable argsort
// compaction a level, then three stable sorts over the concatenation of
// all levels.  It is the whole collector of the adaptive engine (every
// group, down into the refinement) and the dense collector's spill pass
// and 4x-cap retries.
//
// Semantics, bit for bit the twin's: group g walks levels 0..n_levels-1
// from the root.  Level l's frontier has a fixed width F_l (F_0 = 1, then
// min(8 F_{l-1}, the level's cap)); a slot holds a cell of level l or a
// hole.  A cell of count > 0 and mass > mass_skip is
//  * approx when it holds one body, or passes theta
//    (size < theta * (sqrt(min d2 over the Q sub-boxes) + softening)), or
//    sits at leaf_level;
//  * direct when it fails theta, holds at most direct_cell_max bodies, is
//    above leaf_level and (with a window) its leaf span lies in
//    [c_lo, c_hi]: (start, count), start its first body's index
//    (leaf_cum of its first leaf on the pyramid, the refinement's start
//    below it);
//  * opened otherwise, above the last level: its children enter the next
//    frontier in frontier order, occupied octants in octant order on the
//    pyramid, the child range in order below it.
// Where F_{l+1} = 8 F_l the cap cannot bind, and the next frontier keeps
// every parent's eight slots, holes where an octant is not taken; else
// it is the opened children compacted to the left and cut at F_{l+1}
// (the group overflows when more opened), holes after them.  The approx
// list is the approx cells in slot order, level after level, cut to
// list_w = min(sum F_l, list_cap) slots; the slots past the count hold the
// first unselected slots in the same order (a hole reads as cell 0 of its
// level: com, mass 0), as the twin's stable argsort leaves them.  The
// direct list likewise (start, count interleaved; with quarters the fail
// bits of each Morton quarter of the sub-boxes, com, mass; the
// unselected: 0, 0; 0, com, 0).  overflow: a frontier cut, or more approx
// cells than list_cap or more direct than direct_cap.  Every float step
// is the twin's, rounded as it rounds: com = m x / safe (the singleton's
// stored position where count == 1), the distance max(max(lo - c, c - hi),
// 0) per axis, squared and summed x, y, z (separate __fmul_rn /
// __fadd_rn, no contraction), the min exact, then sqrt and + softening,
// each correctly rounded.
//
// What bounds it on an H100: bytes.  A group reads the 32-byte head of
// each row it visits (mass, mass moments, singleton position, count; the
// occupancy or the child range only of a cell it opens) and writes every
// slot of its lists once; the frontier and the tails' scratch stay in
// L2.  The floor (the heads of the cells the lists hold, the sub-boxes,
// the outputs): at the 1M Plummer pass (G = 512, levels 0-11, widths
// 14,336 / 32,768) 2.0e6 held cells and G x (4 x 14,336 + 7 x 32,768) x
// 4 B = 0.59 GB written, 0.195 ms at 3.35 TB/s; the bh3d 1M spill pass
// (128 rows, 14,336 / 8,192) 0.018 ms; the 4x retry (512 rows, 57,344 /
// 32,768) 0.281 ms.  Opened and rejected cells come on top of the floor
// (PERF.md section 6).  The design:
//  * one block a group, walking the levels in order; its sub-boxes in
//    shared memory, its frontier double-buffered in a scratch row of
//    global memory ([G, 2, max F_l]);
//  * a level's filled slots in tiles of one slot a thread: a hole costs
//    nothing, a cell the head of its row, and the 16 sub-box tests only
//    when it holds more than one body;
//  * the compaction is three block-wide exclusive scans a tile (ballots
//    for approx and direct, a warp scan of the children counts; the warps'
//    totals in shared memory, double-buffered so one barrier a tile
//    does), carried across tiles and levels in registers: a selected cell
//    writes its slot at once, an opened one its children; an unselected
//    slot (and each hole past the filled slots) writes its (cell, level)
//    code to a scratch row while its rank among the unselected is below
//    the row's width, and once the counts are known the block fills the
//    tails from those codes;
//  * a group whose frontier empties only runs through the remaining
//    levels' holes (their tail codes, bounded by the widths).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;  // threads a block: one group, a slot a thread
constexpr int kWarps = kBlock / 32;
constexpr int kMaxLevels = 22;     // ops/bh3d.GATHER_MAX_LEVELS
constexpr int kMaxSubBoxes = 256;  // ops/bh3d.GATHER_MAX_SUB_BOXES
constexpr int kLevelBits = 5;      // a tail code: cell << 5 | level
constexpr int kOcc = 8;            // R3_OCC

struct Levels {
  const float* rows[kMaxLevels];  // [K_l, 16] packed rows, stride[l] apart
  const int* start[kMaxLevels];   // refined levels: first body [K_l]
  const int* child[kMaxLevels];   // levels >= base with a refinement:
                                  // children's (first, count) [K_l, 2]
  int stride[kMaxLevels];         // floats from a row to the next
  int width[kMaxLevels];          // F_l
  int offset[kMaxLevels + 1];     // level l's first slot (concatenated)
};

struct Outs {
  float* lx;  // [G, list_w] each
  float* ly;
  float* lz;
  float* lm;
  int* ranges;  // [G, direct_w, 2] (start, count)
  int* qbits;   // [G, direct_w] each, with quarters (else null)
  float* qx;
  float* qy;
  float* qz;
  float* qm;
  unsigned char* overflow;  // [G] bool
  unsigned char* entered;   // [G] bool: opened a pyramid leaf's children
  int* demand;              // [G, n_levels - 1] children opened a level
  int* totals;              // [G, 2] approx and direct cells, uncut
  int* frontier;            // [G, 2, front_w] scratch
  int* tail_a;              // [G, list_w] scratch: the first unselected
  int* tail_d;              // [G, direct_w] scratch (quarters)
};

// ops/tree3d.level_cell_size_3d: the largest cell extent at a level (the
// division by 2^l is exact)
__device__ __forceinline__ float cell_size(const float* bounds, int level) {
  const float div = static_cast<float>(1 << level);
  const float sx = __fdiv_rn(__fsub_rn(bounds[1], bounds[0]), div);
  const float sy = __fdiv_rn(__fsub_rn(bounds[3], bounds[2]), div);
  const float sz = __fdiv_rn(__fsub_rn(bounds[5], bounds[4]), div);
  return fmaxf(fmaxf(sx, sy), sz);
}

// squared distance from (cx, cy, cz) to sub-box j of box ([6][q]: x0, x1,
// y0, y1, z0, z1), rounded as _theta_distances rounds it
__device__ __forceinline__ float box_d2(const float* box, int q, int j,
                                        float cx, float cy, float cz) {
  const float dx = fmaxf(
      fmaxf(__fsub_rn(box[j], cx), __fsub_rn(cx, box[q + j])), 0.0f);
  const float dy = fmaxf(
      fmaxf(__fsub_rn(box[2 * q + j], cy), __fsub_rn(cy, box[3 * q + j])),
      0.0f);
  const float dz = fmaxf(
      fmaxf(__fsub_rn(box[4 * q + j], cz), __fsub_rn(cz, box[5 * q + j])),
      0.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// a row's com as the twin takes it: the singleton's stored position where
// count == 1, else the mass moments over the mass (1 where it is not > 0)
__device__ __forceinline__ void head_com(float4 a, float4 b, float* com) {
  if (b.w == 1.0f) {
    com[0] = b.x;
    com[1] = b.y;
    com[2] = b.z;
  } else {
    const float safe = a.x > 0.0f ? a.x : 1.0f;
    com[0] = __fdiv_rn(a.y, safe);
    com[1] = __fdiv_rn(a.z, safe);
    com[2] = __fdiv_rn(a.w, safe);
  }
}

// the com of the cell a tail code names
__device__ __forceinline__ void code_com(const Levels& lv, int code,
                                         float* com) {
  const int l = code & ((1 << kLevelBits) - 1);
  const float* r =
      lv.rows[l] + static_cast<long long>(code >> kLevelBits) * lv.stride[l];
  head_com(__ldg(reinterpret_cast<const float4*>(r)),
           __ldg(reinterpret_cast<const float4*>(r + 4)), com);
}

template <bool QUARTERS, bool REFINE>
__global__ void __launch_bounds__(kBlock) gather_collect3_kernel(
    const Levels lv, int n_levels, int base, int leaf_level,
    const int* __restrict__ leaf_cum, const float* __restrict__ bbox,
    const float* __restrict__ bounds, const int* __restrict__ window,
    int g_count, int q, int front_w, float theta, float softening,
    float mass_skip, float direct_cell_max, int list_w, int direct_w,
    int list_cap, int direct_cap, const Outs out) {
  __shared__ float box[6 * kMaxSubBoxes];
  __shared__ int warp_a[2][kWarps];
  __shared__ int warp_d[2][kWarps];
  __shared__ int warp_c[2][kWarps];
  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < 6 * q; j += kBlock) {
    box[j] = bbox[(static_cast<long long>(j / q) * g_count + g) * q + j % q];
  }
  const bool windowed = window != nullptr;
  const int c_lo = windowed ? window[0] : 0;
  const int c_hi = windowed ? window[1] : 0;
  __syncthreads();

  const long long row_a = static_cast<long long>(g) * list_w;
  const long long row_d = static_cast<long long>(g) * direct_w;
  int* front = out.frontier + static_cast<long long>(g) * 2 * front_w;
  const unsigned lanes_below = (1u << lane) - 1u;
  int run_a = 0, run_d = 0;  // cells selected so far (the same in each thread)
  int parity = 0;            // which warp_* buffer this tile fills
  int filled = 1;            // this level's slots before its trailing holes
  int cur = 0;               // which frontier buffer holds this level
  bool cut = false;          // a frontier was cut at its cap
  bool entered = false;      // opened a pyramid leaf (the refinement)
  for (int l = 0; l < n_levels; ++l) {
    const int width = lv.width[l], k0 = lv.offset[l];
    const bool last = l == n_levels - 1;
    const bool sparse = REFINE && l > base;
    const bool ranges = REFINE && l >= base;
    const int next_w = last ? 0 : lv.width[l + 1];
    const bool expand = !last && next_w == 8 * width;
    const bool at_leaf = l == leaf_level;
    const int shift = 3 * (base - l);  // a pyramid cell's first leaf
    const float size = cell_size(bounds, l);
    const float* rows = lv.rows[l];
    const int stride = lv.stride[l];
    const int* cur_f = front + cur * front_w;
    int* nxt_f = front + (cur ^ 1) * front_w;
    int run_c = 0;  // children opened this level (uncut)

    for (int t0 = 0; t0 < filled; t0 += kBlock) {
      const int j = t0 + tid;
      bool approx = false, direct = false;
      int cell = -1, nkids = 0, kid0 = 0, bits = 0, st = 0;
      unsigned occ = 0;  // the occupied octants of an opened pyramid cell
      float m = 0.0f, cnt = 0.0f;
      float com[3] = {0.0f, 0.0f, 0.0f};
      if (j < filled) cell = l == 0 ? 0 : cur_f[j];
      if (cell >= 0) {
        const float* r = rows + static_cast<long long>(cell) * stride;
        const float4 a = __ldg(reinterpret_cast<const float4*>(r));
        const float4 b = __ldg(reinterpret_cast<const float4*>(r + 4));
        m = a.x;
        cnt = b.w;
        if (cnt > 0.0f && m > mass_skip) {
          head_com(a, b, com);
          if (cnt == 1.0f) {
            approx = true;
          } else if (cnt > 1.0f) {
            // min d2 over each quarter of the sub-boxes (one part
            // without quarters: the same min)
            float dq[4];
            const int parts = QUARTERS ? 4 : 1, per = q / parts;
#pragma unroll
            for (int s = 0; s < parts; ++s) {
              float mn = __int_as_float(0x7f800000);  // +inf
              for (int k = s * per; k < (s + 1) * per; ++k) {
                mn = fminf(mn, box_d2(box, q, k, com[0], com[1], com[2]));
              }
              dq[s] = mn;
            }
            float dmin2 = dq[0];
            if (QUARTERS) {
              dmin2 = fminf(fminf(dq[0], dq[1]), fminf(dq[2], dq[3]));
            }
            const float d_min = __fadd_rn(__fsqrt_rn(dmin2), softening);
            const bool theta_ok = size < __fmul_rn(theta, d_min);
            approx = theta_ok || at_leaf;
            if (!theta_ok) {
              direct = !at_leaf && cnt <= direct_cell_max;
              if (direct && windowed) {
                direct = (cell << shift) >= c_lo &&
                         ((cell + 1) << shift) <= c_hi + 1;
              }
              if (direct) {
                st = sparse ? lv.start[l][cell] : leaf_cum[cell << shift];
                if (QUARTERS) {
#pragma unroll
                  for (int s = 0; s < 4; ++s) {
                    const float d_q = __fadd_rn(__fsqrt_rn(dq[s]), softening);
                    if (size >= __fmul_rn(theta, d_q)) bits |= 1 << s;
                  }
                }
              } else if (!last) {  // opened
                if (ranges) {
                  const int2 k = __ldg(
                      reinterpret_cast<const int2*>(lv.child[l]) + cell);
                  kid0 = k.x;
                  nkids = min(max(k.y, 0), 8);
                } else {
                  occ = static_cast<unsigned>(static_cast<int>(r[kOcc])) &
                        0xffu;
                  nkids = __popc(occ);
                }
              }
            }
          }
        }
      }

      const unsigned ba = __ballot_sync(0xffffffffu, approx);
      const unsigned bd = __ballot_sync(0xffffffffu, direct);
      int kin = nkids;  // inclusive scan of the children over the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, kin, d);
        if (lane >= d) kin += v;
      }
      if (lane == 31) {
        warp_a[parity][warp] = __popc(ba);
        warp_d[parity][warp] = __popc(bd);
        warp_c[parity][warp] = kin;
      }
      __syncthreads();
      int before_a = run_a + __popc(ba & lanes_below);
      int before_d = run_d + __popc(bd & lanes_below);
      int before_c = run_c + kin - nkids;
      int tile_a = 0, tile_d = 0, tile_c = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int a = warp_a[parity][k], b = warp_d[parity][k],
                  c = warp_c[parity][k];
        if (k < warp) {
          before_a += a;
          before_d += b;
          before_c += c;
        }
        tile_a += a;
        tile_d += b;
        tile_c += c;
      }
      if (j < filled) {
        const int kc = k0 + j;  // the slot's index in the concatenation
        const int code = (max(cell, 0) << kLevelBits) | l;
        if (approx) {
          if (before_a < list_w) {
            out.lx[row_a + before_a] = com[0];
            out.ly[row_a + before_a] = com[1];
            out.lz[row_a + before_a] = com[2];
            out.lm[row_a + before_a] = m;
          }
        } else if (kc - before_a < list_w) {
          out.tail_a[row_a + kc - before_a] = code;
        }
        if (direct) {
          if (before_d < direct_w) {
            out.ranges[2 * (row_d + before_d)] = st;
            out.ranges[2 * (row_d + before_d) + 1] = static_cast<int>(cnt);
            if (QUARTERS) {
              out.qbits[row_d + before_d] = bits;
              out.qx[row_d + before_d] = com[0];
              out.qy[row_d + before_d] = com[1];
              out.qz[row_d + before_d] = com[2];
              out.qm[row_d + before_d] = m;
            }
          }
        } else if (QUARTERS && kc - before_d < direct_w) {
          out.tail_d[row_d + kc - before_d] = code;
        }
        if (expand) {
          // every parent keeps its eight slots
#pragma unroll
          for (int o = 0; o < 8; ++o) {
            const bool taken = ranges ? o < nkids : ((occ >> o) & 1u);
            nxt_f[8 * j + o] =
                taken ? (ranges ? kid0 + o : 8 * cell + o) : -1;
          }
        } else if (nkids) {
          int s = before_c;
#pragma unroll
          for (int o = 0; o < 8; ++o) {
            const bool taken = ranges ? o < nkids : ((occ >> o) & 1u);
            if (taken) {
              if (s < next_w) nxt_f[s] = ranges ? kid0 + o : 8 * cell + o;
              ++s;
            }
          }
        }
      }
      run_a += tile_a;
      run_d += tile_d;
      run_c += tile_c;
      parity ^= 1;
    }

    // the holes after the filled slots: unselected, each read as cell 0
    for (int j = filled + tid; j < width; j += kBlock) {
      const int ua = k0 + j - run_a, ud = k0 + j - run_d;
      const bool in_a = ua < list_w, in_d = QUARTERS && ud < direct_w;
      if (!in_a && !in_d) break;
      if (in_a) out.tail_a[row_a + ua] = l;
      if (in_d) out.tail_d[row_d + ud] = l;
    }
    if (last) break;
    if (out.demand != nullptr && tid == 0) {
      out.demand[static_cast<long long>(g) * (n_levels - 1) + l] = run_c;
    }
    if (REFINE && l == base) entered = run_c > 0;
    if (expand) {
      filled *= 8;
    } else {
      cut = cut || run_c > next_w;
      filled = min(run_c, next_w);
    }
    cur ^= 1;
    __syncthreads();  // the next frontier is complete
  }
  __syncthreads();  // the scratch rows are complete

  if (tid == 0) {
    out.overflow[g] = cut || run_a > list_cap || run_d > direct_cap;
    out.entered[g] = entered;
    out.totals[2 * g] = run_a;
    out.totals[2 * g + 1] = run_d;
  }
  // the tails: the first unselected slots, in order
  for (int j = min(run_a, list_w) + tid; j < list_w; j += kBlock) {
    float com[3];
    code_com(lv, out.tail_a[row_a + j - run_a], com);
    out.lx[row_a + j] = com[0];
    out.ly[row_a + j] = com[1];
    out.lz[row_a + j] = com[2];
    out.lm[row_a + j] = 0.0f;
  }
  for (int j = min(run_d, direct_w) + tid; j < direct_w; j += kBlock) {
    out.ranges[2 * (row_d + j)] = 0;
    out.ranges[2 * (row_d + j) + 1] = 0;
    if (QUARTERS) {
      float com[3];
      code_com(lv, out.tail_d[row_d + j - run_d], com);
      out.qbits[row_d + j] = 0;
      out.qx[row_d + j] = com[0];
      out.qy[row_d + j] = com[1];
      out.qz[row_d + j] = com[2];
      out.qm[row_d + j] = 0.0f;
    }
  }
}

}  // namespace

// One walk: level_ptrs holds n_levels row pointers, then n_levels start
// pointers, then n_levels child pointers (null where a level has none);
// strides each level's floats from a row to the next (a multiple of 4, at
// least 16: rows are read 16 bytes at a time); widths the frontier widths
// F_l (n_levels at most 22); leaf_cum [8^base
// + 1] int32; bbox [6, G, Q] f32 (x0, x1, y0, y1, z0, z1); bounds [6]
// f32; window null or [2] int32 (c_lo, c_hi) on the device; outs the 17
// pointers of the Outs struct, in its order (the five quarter ones and
// tail_d null without quarters, demand null unless asked).  refine: the
// levels past base are a refinement's (child ranges from base down).
// Host arrays, read before the launch; nothing is read back.
extern "C" int nbody_gather_collect3(
    const void* const* level_ptrs, const int* strides, const int* widths,
    int n_levels,
    int base, int leaf_level, const void* leaf_cum, const void* bbox,
    const void* bounds, const void* window, int g, int q, float theta,
    float softening, float mass_skip, float direct_cell_max, int list_w,
    int direct_w, int list_cap, int direct_cap, void* const* outs,
    int quarters, int refine, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || base < 0 ||
      base >= n_levels + (refine ? 0 : 1) || q < 1 || q > kMaxSubBoxes ||
      (quarters && q % 4) || list_w < 0 || direct_w < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g == 0) return 0;
  Levels lv{};
  int front_w = 1;
  lv.offset[0] = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int w = widths[l];
    if (w < 1 || (l == 0 && w != 1) || (l > 0 && w > 8 * widths[l - 1]) ||
        strides[l] < 16 || strides[l] % 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    lv.stride[l] = strides[l];
    lv.rows[l] = static_cast<const float*>(level_ptrs[l]);
    lv.start[l] = static_cast<const int*>(level_ptrs[n_levels + l]);
    lv.child[l] = static_cast<const int*>(level_ptrs[2 * n_levels + l]);
    lv.width[l] = w;
    lv.offset[l + 1] = lv.offset[l] + w;
    front_w = w > front_w ? w : front_w;
  }
  Outs o{};
  o.lx = static_cast<float*>(outs[0]);
  o.ly = static_cast<float*>(outs[1]);
  o.lz = static_cast<float*>(outs[2]);
  o.lm = static_cast<float*>(outs[3]);
  o.ranges = static_cast<int*>(outs[4]);
  o.qbits = static_cast<int*>(outs[5]);
  o.qx = static_cast<float*>(outs[6]);
  o.qy = static_cast<float*>(outs[7]);
  o.qz = static_cast<float*>(outs[8]);
  o.qm = static_cast<float*>(outs[9]);
  o.overflow = static_cast<unsigned char*>(outs[10]);
  o.entered = static_cast<unsigned char*>(outs[11]);
  o.demand = static_cast<int*>(outs[12]);
  o.totals = static_cast<int*>(outs[13]);
  o.frontier = static_cast<int*>(outs[14]);
  o.tail_a = static_cast<int*>(outs[15]);
  o.tail_d = static_cast<int*>(outs[16]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lc = static_cast<const int*>(leaf_cum);
  const float* b = static_cast<const float*>(bbox);
  const float* bnd = static_cast<const float*>(bounds);
  const int* win = static_cast<const int*>(window);
#define NBODY_GATHER_LAUNCH(Q, R)                                          \
  gather_collect3_kernel<Q, R><<<g, kBlock, 0, s>>>(                       \
      lv, n_levels, base, leaf_level, lc, b, bnd, win, g, q, front_w, theta,  \
      softening, mass_skip, direct_cell_max, list_w, direct_w, list_cap,   \
      direct_cap, o)
  if (quarters && refine) {
    NBODY_GATHER_LAUNCH(true, true);
  } else if (quarters) {
    NBODY_GATHER_LAUNCH(true, false);
  } else if (refine) {
    NBODY_GATHER_LAUNCH(false, true);
  } else {
    NBODY_GATHER_LAUNCH(false, false);
  }
#undef NBODY_GATHER_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
