// The dense 3D collector's window walk on Hopper (sm_90a), behind
// ops/collect_dense3.collect_lists_3d_dense.  Not a TPU kernel: the JAX
// package's dense collector (nbody_tpu/ops/collect_dense3.py) is XLA, and
// the port's torch body of the same walk (collect_dense3._dense_lists,
// the kernel's plain twin) spent ~150 operators a level on [G, Q/4, W^3]
// temporaries, then a stable argsort over [G, F] masks (F = the window
// cells of all levels, 73,225 a group at 1M) and eleven gathers.
//
// Semantics, bit for bit the twin's: group g walks levels 0..L-1; at
// level l its [W, W, W] window (origin origins[l, g], x slowest, z
// fastest) holds cells of the row-major pyramid grid[l] ([D, D, D, 5]:
// mass, com x, y, z, count).  A cell is reached at level 0, and below it
// where the parent window's cell over it (at o / 2 - o_parent + i / 2 a
// axis) was opened and its children all fell inside this window.  A
// reached cell of count > 0 and mass > mass_skip is
//  * approx when it holds one body, or when it passes theta
//    (size < theta * (sqrt(min d2 over the Q sub-boxes) + softening)),
//    or at the last level;
//  * direct when it fails theta, holds at most direct_cell_max bodies and
//    is above the last level;
//  * opened when it fails theta and holds more; an opened cell whose
//    children leave the next window marks the group escaped (the spill
//    pass collects it again) and opens nothing.
// The approx list is each level's approx cells in window order, level
// after level (torch.cat over levels, then a stable compaction), cut to
// list_w = min(F, list_cap) slots; the slots past the count hold the
// first unselected cells in the same order (com, mass 0), as the twin's
// stable argsort leaves them.  The direct list likewise (start, count;
// with quarters the fail bits of each Morton quarter of the sub-boxes,
// com, mass; the unselected: 0, 0; 0, com, 0).  overflow: more approx
// cells than list_cap or more direct than direct_cap.  Every float step
// is the twin's, rounded as it rounds: the distance is
// max(max(lo - c, c - hi), 0) per axis, squared and summed x, y, z
// (separate __fmul_rn / __fadd_rn, no contraction), the min is exact, then
// sqrt and + softening, each correctly rounded.
//
// What bounds it on an H100: bytes.  At 1M (G = 512 groups, Q = 16, depth
// 7, widths 1, 2, 4, 8, 16, 28, 24, 32) the windows hold 37.5 M cells, and
// the outputs are G x (4 x 14,336 + 7 x 8,192) x 4 B = 235 MB; only the
// reached cells are gathered (24 B each).  The design:
//  * one block a group, walking the levels in order; its sub-boxes in
//    shared memory, the parent level's and this level's open flags as
//    bitmasks there (32^3 bits = 4 KB each), each warp's 32 flags one
//    word of a ballot;
//  * a level's window in tiles of one cell a thread, in window order; an
//    unreached cell costs a shared-memory bit, a reached one its gather
//    (5 floats and, when direct, the Morton prefix), and the theta tests
//    only for cells of more than one body;
//  * the compaction is a block-wide exclusive scan a tile (ballots, the
//    warps' counts in shared memory, double-buffered so one barrier a
//    tile does), carried across tiles and levels in registers: a selected
//    cell writes its slot at once; an unselected one writes its index in
//    the concatenation to a scratch row while its rank among the
//    unselected is below the row's width, and once the counts are known
//    the block fills the tail from those indices.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;  // threads a block: one group, a cell a thread
constexpr int kWarps = kBlock / 32;
constexpr int kMaxLevels = 16;  // ops/collect_dense3.KERNEL_MAX_LEVELS
constexpr int kMaxWidth = 32;   // ops/collect_dense3.KERNEL_MAX_WIDTH
constexpr int kMaskWords = kMaxWidth * kMaxWidth * kMaxWidth / 32;
constexpr int kMaxSubBoxes = 256;  // ops/collect_dense3.KERNEL_MAX_SUB_BOXES

struct Levels {
  const float* grid[kMaxLevels];  // [D, D, D, 5], D = 2^l
  const int* start[kMaxLevels];   // [D, D, D] Morton body prefix
  int width[kMaxLevels];          // W of each level's window
  int offset[kMaxLevels + 1];     // first window cell's concatenated index
};

struct Outs {
  float* lx;  // [G, list_w] each
  float* ly;
  float* lz;
  float* lm;
  int* ds;  // [G, direct_w] each
  int* dc;
  int* qbits;  // [G, direct_w] each, with quarters (else null)
  float* qx;
  float* qy;
  float* qz;
  float* qm;
  unsigned char* overflow;  // [G] bool
  unsigned char* escape;    // [G] bool
  int* tail_a;  // [G, list_w] scratch: the first unselected cells
  int* tail_d;  // [G, direct_w] scratch
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

// the com of the cell at concatenated index k (level found from the
// offsets, window origin from origins)
__device__ __forceinline__ void cell_com(const Levels& lv, int n_levels,
                                         const int* origins, int g_count,
                                         int g, int k, float* com) {
  int l = 0;
  while (l + 1 < n_levels && k >= lv.offset[l + 1]) ++l;
  const int w = lv.width[l], d = 1 << l, i = k - lv.offset[l];
  const int* o = origins + (static_cast<long long>(l) * g_count + g) * 3;
  const long long flat =
      (static_cast<long long>(o[0] + i / (w * w)) * d + o[1] + (i / w) % w) *
          d +
      o[2] + i % w;
  const float* c = lv.grid[l] + flat * 5;
  com[0] = c[1];
  com[1] = c[2];
  com[2] = c[3];
}

template <bool QUARTERS>
__global__ void __launch_bounds__(kBlock) dense_collect3_kernel(
    const Levels lv, int n_levels, const float* __restrict__ bbox,
    const int* __restrict__ origins, const float* __restrict__ bounds,
    int g_count, int q, float theta, float softening, float mass_skip,
    float direct_cell_max, int list_w, int direct_w, int list_cap,
    int direct_cap, const Outs out) {
  __shared__ float box[6 * kMaxSubBoxes];
  __shared__ uint32_t mask[2][kMaskWords];
  __shared__ int warp_a[2][kWarps];
  __shared__ int warp_d[2][kWarps];
  __shared__ int escaped;
  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < 6 * q; j += kBlock) {
    box[j] = bbox[(static_cast<long long>(j / q) * g_count + g) * q + j % q];
  }
  if (tid == 0) escaped = 0;
  __syncthreads();

  const long long row_a = static_cast<long long>(g) * list_w;
  const long long row_d = static_cast<long long>(g) * direct_w;
  const unsigned lanes_below = (1u << lane) - 1u;
  int run_a = 0, run_d = 0;  // cells selected so far (the same in each thread)
  int parity = 0;            // which warp_a / warp_d buffer this tile fills
  int px = 0, py = 0, pz = 0;  // the parent window's origin
  for (int l = 0; l < n_levels; ++l) {
    const int w = lv.width[l], p = w * w * w, d = 1 << l;
    const int* o = origins + (static_cast<long long>(l) * g_count + g) * 3;
    const int ox = o[0], oy = o[1], oz = o[2];
    const bool last = l == n_levels - 1;
    // the parent span's offset in the parent window (even origins)
    const int rx = ox / 2 - px, ry = oy / 2 - py, rz = oz / 2 - pz;
    const int wp = l > 0 ? lv.width[l - 1] : 1;
    int nx = 0, ny = 0, nz = 0, wn = 0;
    if (!last) {
      const int* on =
          origins + (static_cast<long long>(l + 1) * g_count + g) * 3;
      nx = on[0];
      ny = on[1];
      nz = on[2];
      wn = lv.width[l + 1];
    }
    const float size = cell_size(bounds, l);
    const float* grid = lv.grid[l];
    const int* start = lv.start[l];
    const uint32_t* pmask = mask[(l + 1) & 1];
    uint32_t* cmask = mask[l & 1];
    const int k0 = lv.offset[l];

    for (int base = 0; base < p; base += kBlock) {
      const int i = base + tid;
      bool approx = false, direct = false, open_in = false;
      float m = 0.0f, cx = 0.0f, cy = 0.0f, cz = 0.0f, cnt = 0.0f;
      int bits = 0, st = 0;
      if (i < p) {
        const int ix = i / (w * w), iy = (i / w) % w, iz = i % w;
        bool reached = true;
        if (l > 0) {
          const int b = ((rx + ix / 2) * wp + ry + iy / 2) * wp + rz + iz / 2;
          reached = (pmask[b >> 5] >> (b & 31)) & 1u;
        }
        if (reached) {
          const long long flat =
              (static_cast<long long>(ox + ix) * d + oy + iy) * d + oz + iz;
          const float* c = grid + flat * 5;
          m = c[0];
          cnt = c[4];
          if (cnt > 0.0f && m > mass_skip) {
            cx = c[1];
            cy = c[2];
            cz = c[3];
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
                for (int j = s * per; j < (s + 1) * per; ++j) {
                  mn = fminf(mn, box_d2(box, q, j, cx, cy, cz));
                }
                dq[s] = mn;
              }
              float dmin2 = dq[0];
              if (QUARTERS) {
                dmin2 = fminf(fminf(dq[0], dq[1]), fminf(dq[2], dq[3]));
              }
              const float d_min = __fadd_rn(__fsqrt_rn(dmin2), softening);
              const bool theta_ok = size < __fmul_rn(theta, d_min);
              approx = theta_ok || last;
              if (!theta_ok && !last) {
                direct = cnt <= direct_cell_max;
                if (direct) {
                  st = start[flat];
                  if (QUARTERS) {
#pragma unroll
                    for (int s = 0; s < 4; ++s) {
                      const float d_q =
                          __fadd_rn(__fsqrt_rn(dq[s]), softening);
                      if (size >= __fmul_rn(theta, d_q)) bits |= 1 << s;
                    }
                  }
                } else {
                  // opened: its children must land in the next window
                  const int cx2 = 2 * (ox + ix), cy2 = 2 * (oy + iy),
                            cz2 = 2 * (oz + iz);
                  const bool within =
                      cx2 >= nx && cx2 + 1 <= nx + wn - 1 && cy2 >= ny &&
                      cy2 + 1 <= ny + wn - 1 && cz2 >= nz &&
                      cz2 + 1 <= nz + wn - 1;
                  if (within) {
                    open_in = true;
                  } else {
                    escaped = 1;
                  }
                }
              }
            }
          }
        }
      }

      const unsigned ba = __ballot_sync(0xffffffffu, approx);
      const unsigned bd = __ballot_sync(0xffffffffu, direct);
      const unsigned bo = __ballot_sync(0xffffffffu, open_in);
      if (lane == 0) {
        warp_a[parity][warp] = __popc(ba);
        warp_d[parity][warp] = __popc(bd);
        if (!last) cmask[(base >> 5) + warp] = bo;
      }
      __syncthreads();
      int before_a = run_a + __popc(ba & lanes_below);
      int before_d = run_d + __popc(bd & lanes_below);
      int tile_a = 0, tile_d = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int a = warp_a[parity][k], b = warp_d[parity][k];
        if (k < warp) {
          before_a += a;
          before_d += b;
        }
        tile_a += a;
        tile_d += b;
      }
      if (i < p) {
        const int kc = k0 + i;  // the cell's index in the concatenation
        if (approx) {
          if (before_a < list_w) {
            out.lx[row_a + before_a] = cx;
            out.ly[row_a + before_a] = cy;
            out.lz[row_a + before_a] = cz;
            out.lm[row_a + before_a] = m;
          }
        } else if (kc - before_a < list_w) {
          out.tail_a[row_a + kc - before_a] = kc;
        }
        if (direct) {
          if (before_d < direct_w) {
            out.ds[row_d + before_d] = st;
            out.dc[row_d + before_d] = static_cast<int>(cnt);
            if (QUARTERS) {
              out.qbits[row_d + before_d] = bits;
              out.qx[row_d + before_d] = cx;
              out.qy[row_d + before_d] = cy;
              out.qz[row_d + before_d] = cz;
              out.qm[row_d + before_d] = m;
            }
          }
        } else if (kc - before_d < direct_w) {
          out.tail_d[row_d + kc - before_d] = kc;
        }
      }
      run_a += tile_a;
      run_d += tile_d;
      parity ^= 1;
    }
    px = ox;
    py = oy;
    pz = oz;
  }
  __syncthreads();  // the scratch rows and `escaped` are complete

  if (tid == 0) {
    out.overflow[g] = run_a > list_cap || run_d > direct_cap;
    out.escape[g] = escaped != 0;
  }
  // the tails: the first unselected cells, in order
  for (int j = min(run_a, list_w) + tid; j < list_w; j += kBlock) {
    float com[3];
    cell_com(lv, n_levels, origins, g_count, g, out.tail_a[row_a + j - run_a],
             com);
    out.lx[row_a + j] = com[0];
    out.ly[row_a + j] = com[1];
    out.lz[row_a + j] = com[2];
    out.lm[row_a + j] = 0.0f;
  }
  for (int j = min(run_d, direct_w) + tid; j < direct_w; j += kBlock) {
    out.ds[row_d + j] = 0;
    out.dc[row_d + j] = 0;
    if (QUARTERS) {
      float com[3];
      cell_com(lv, n_levels, origins, g_count, g,
               out.tail_d[row_d + j - run_d], com);
      out.qbits[row_d + j] = 0;
      out.qx[row_d + j] = com[0];
      out.qy[row_d + j] = com[1];
      out.qz[row_d + j] = com[2];
      out.qm[row_d + j] = 0.0f;
    }
  }
}

}  // namespace

// One pass: level_ptrs holds n_levels grid pointers, then n_levels start
// pointers; widths the windows' widths (each at most 32; n_levels at most
// 16); bbox [6, G, Q] f32 (x0, x1, y0, y1, z0, z1); origins [n_levels, G,
// 3] int32; bounds [6] f32; outs the 15 pointers of the Outs struct, in
// its order (the five quarter ones null without quarters).  Host arrays,
// read before the launch; nothing is read back.
extern "C" int nbody_dense_collect3(
    const void* const* level_ptrs, const int* widths, int n_levels,
    const void* bbox, const void* origins, const void* bounds, int g, int q,
    float theta, float softening, float mass_skip, float direct_cell_max,
    int list_w, int direct_w, int list_cap, int direct_cap,
    void* const* outs, int quarters, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || q < 1 ||
      q > kMaxSubBoxes || (quarters && q % 4) || list_w < 0 ||
      direct_w < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g == 0) return 0;
  Levels lv{};
  lv.offset[0] = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int w = widths[l];
    if (w < 1 || w > kMaxWidth) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    lv.grid[l] = static_cast<const float*>(level_ptrs[l]);
    lv.start[l] = static_cast<const int*>(level_ptrs[n_levels + l]);
    lv.width[l] = w;
    lv.offset[l + 1] = lv.offset[l] + w * w * w;
  }
  Outs o{};
  o.lx = static_cast<float*>(outs[0]);
  o.ly = static_cast<float*>(outs[1]);
  o.lz = static_cast<float*>(outs[2]);
  o.lm = static_cast<float*>(outs[3]);
  o.ds = static_cast<int*>(outs[4]);
  o.dc = static_cast<int*>(outs[5]);
  o.qbits = static_cast<int*>(outs[6]);
  o.qx = static_cast<float*>(outs[7]);
  o.qy = static_cast<float*>(outs[8]);
  o.qz = static_cast<float*>(outs[9]);
  o.qm = static_cast<float*>(outs[10]);
  o.overflow = static_cast<unsigned char*>(outs[11]);
  o.escape = static_cast<unsigned char*>(outs[12]);
  o.tail_a = static_cast<int*>(outs[13]);
  o.tail_d = static_cast<int*>(outs[14]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bbox);
  const int* org = static_cast<const int*>(origins);
  const float* bnd = static_cast<const float*>(bounds);
  if (quarters) {
    dense_collect3_kernel<true><<<g, kBlock, 0, s>>>(
        lv, n_levels, b, org, bnd, g, q, theta, softening, mass_skip,
        direct_cell_max, list_w, direct_w, list_cap, direct_cap, o);
  } else {
    dense_collect3_kernel<false><<<g, kBlock, 0, s>>>(
        lv, n_levels, b, org, bnd, g, q, theta, softening, mass_skip,
        direct_cell_max, list_w, direct_w, list_cap, direct_cap, o);
  }
  return static_cast<int>(cudaGetLastError());
}
