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
// of a tile and K3 packs P short windows into one step.  Here both stage
// only the lanes they need, so K3 and K2 do the same pair work; K3's
// units are just P entries long.
//
// Design of K2/K3 (one kernel, runs_kernel<DIMS, P>).  What held the first
// design back: one thread per target (15-48% of the card's thread slots
// at the main path's shapes, each thread one serial chain of 5,000-15,000
// pairs), one tile a step between two barriers with no load in flight,
// and the gm = 0 approx lanes past lens[0] evaluated.  Now:
//  * Packed units.  A group's units, in table order, are its approx tiles
//    (lanes < min(lens[0, g], A) of each) and its direct steps (P entries
//    e = d P + p, each a piece: its [lo, hi) clipped as direct_entry clips
//    it).  Their lanes form one stream, staged through shared memory in
//    rounds of at most kRunsChunk lanes.  A table of kRunsPieces pieces
//    (block scan, binary-searched) maps a stream position to its column,
//    and a table of the nonempty units' ends marks where partials close.
//    Dropping the approx tails is exact: every lane past lens in an
//    occupied tile is gm = 0 and finite, so it would add +-0.  An empty
//    unit would add +0 to the running sum, which leaves it as it is, so it
//    is skipped.
//  * One partial per unit, in unit order.  A unit's lanes are summed in
//    lane order into a fresh partial (nbody::pair_force pins pair_window's
//    roundings), which enters the running sum when the unit ends, in unit
//    order: the first design's operations in its order, so its bits.
//  * Thread slices.  Each target has r = `slices` threads (1, 2, 4, 8); a
//    block is r runs of kRunsThreads / r targets, so every warp is in one
//    slice and reads one staged lane at a time (a broadcast).  A round's
//    lanes are cut into r spans at unit ends, each cut the unit end
//    nearest to an equal share of lanes.  Slice 0 adds the partials of its
//    units to the running sum as they end; slices 1..r-1 leave theirs in
//    shared-memory slots, which slice 0 adds in unit order after the
//    round.  A unit that runs past the round leaves its partial in a carry
//    slot, and slice 0 goes on summing it next round.  Every partial is
//    one thread's chain in lane order and every partial enters in unit
//    order, so the bits do not depend on r; ops/list_eval.py picks r from
//    (G, S) so that the grid holds two waves.  A round holds at most as
//    many units as the slots do.
//  * Heaviest groups first.  A group's lanes are heavy-tailed (3D
//    N=131,072: mean ~15,300, max ~65,900), so the wrapper's `order`
//    starts the heaviest first.
//  * Fixed shared memory (~46 KB a block, whatever k_tile): every list
//    read is bounded by its width, every table read by T.
// The TPU kernels' k_tile VMEM ceiling (list_eval.runs_k_max) does not
// apply to K2-K4.
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
//    chunk's pair loop, so its loads fly during it.  The light path's
//    shared memory is one chunk and two tables of kUnits unit bounds
//    (~16 KB), whatever k_tile.
//  * Heaviest quarters first.  A quarter's lanes are heavy-tailed (at 1M:
//    mean ~16,550, max ~280,000), so the kernel's time is the heaviest
//    quarters' blocks; one target a thread keeps each of them short (two
//    or more targets a thread measured slower: PERF.md), and the wrapper's
//    `order` starts the heaviest first.
//  * Thread slices for the heaviest.  On a clustered state one quarter can
//    hold 1M lanes (the 1M Plummer sphere: mean ~23,900), and its two
//    blocks, each target one serial chain, outlast the rest of the card.
//    A row of the wrapper's schedule whose block would hold more than a
//    fair share of the pass's pairs (the pairs over the card's block
//    slots) gets r = 2, 4 or 8 thread slices a target and 2r blocks,
//    which take K2's rounds (split_sliced): the same partials in the same
//    order, so the bits do not depend on r.  Other rows keep the light
//    path (split_light).  One launch holds both, so its shared memory is
//    the larger, the sliced path's (~73 KB), which still lets three blocks
//    share an SM, as the registers do.
#include <cuda_runtime.h>

#include "pair_eval.cuh"

namespace {

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

// K2/K3's shape; RUNS_THREADS in ops/list_eval.py is kRunsThreads.
constexpr int kRunsThreads = 256;
constexpr int kRunsWarps = kRunsThreads / 32;
constexpr int kRunsChunk = 2048;           // lanes staged a round
constexpr int kRunsPieces = kRunsThreads;  // pieces a table, one a thread
// Unit partials of one round's slices 1..r-1 (and the carry slot): U + 1
// slots of DIMS x (kRunsThreads / r) floats.
constexpr int kRunsSlotFloats = 2560;

// The first index k in [k, end) with v[k] > x (`end` if none): v ascends.
__device__ __forceinline__ int first_above(const int* v, int k, int end,
                                           int x) {
  while (k < end) {
    const int mid = (k + end) >> 1;
    if (v[mid] > x) {
      end = mid;
    } else {
      k = mid + 1;
    }
  }
  return k;
}

// The stream of group g: pieces j in table order, kRunsPieces to a table.
// j < a_t: approx tile j, lanes [j k_tile, min((j + 1) k_tile, a_lim)), a
// unit of its own; j in [a_t, a_al): empty fillers, so that each direct
// step's P pieces sit in one table and one P-aligned run of threads;
// j = a_al + e: direct entry e, its [lo, hi), closing a unit when
// e % P == P - 1.
template <int DIMS, int P>
__global__ void __launch_bounds__(kRunsThreads, 4) runs_kernel(
    const float* __restrict__ tgt,     // [G, S, DIMS]
    const float* __restrict__ approx,  // [G, 8, A]
    const float* __restrict__ srct,    // [8, npad]
    const int* __restrict__ tiles,     // [G, 3, T]
    const int* __restrict__ lens,      // [2, G]
    float* __restrict__ out,           // [G, S, DIMS]
    const int n_groups, const int S, const int A, const long long npad,
    const int T, const int k_tile, const float eps, const int slices,
    const int* __restrict__ order, unsigned long long* __restrict__ staged) {
  __shared__ float4 buf[kRunsChunk];
  __shared__ float slot[kRunsSlotFloats];
  __shared__ int upos[kRunsPieces + 1];    // stream position of each piece
  __shared__ long long ucol[kRunsPieces];  // its first column, ~col approx
  __shared__ int uend[kRunsPieces];        // the nonempty units' ends
  __shared__ int wsum[kRunsWarps], wcnt[kRunsWarps];
  const int g = order[blockIdx.y];  // heaviest first
  const int per_block = kRunsThreads / slices;
  const int q = threadIdx.x / per_block;  // this thread's slice
  const int il = threadIdx.x % per_block;
  const int i = blockIdx.x * per_block + il;
  const bool live = i < S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t ti_base = (static_cast<size_t>(g) * S + i) * DIMS;
  const float px = live ? tgt[ti_base] : 0.f;
  const float py = live ? tgt[ti_base + 1] : 0.f;
  const float pz = (DIMS == 3 && live) ? tgt[ti_base + DIMS - 1] : 0.f;

  // slots: unit k of a round at [(k DIMS + d) per_block + il], k < n_slot,
  // the carry at k = n_slot; one slice adds every partial itself
  const int n_slot =
      slices == 1 ? 0 : kRunsSlotFloats / (DIMS * per_block) - 1;
  const int max_units = slices == 1 ? kRunsPieces : n_slot;  // a round's
  float* carry = slot + n_slot * DIMS * per_block + il;
  const int sw = k_tile / P;  // lanes per segment
  const int a_t = (lens[g] + k_tile - 1) / k_tile;
  const int a_lim = min(lens[g], A);  // lanes the approx tiles hold
  const int a_al = (a_t + P - 1) / P * P;
  const int d_t = min(lens[n_groups + g], (T + P - 1) / P);
  const int n_pieces = a_al + d_t * P;
  const float* ap = approx + static_cast<size_t>(g) * 8 * A;
  const int* tb = tiles + static_cast<size_t>(g) * 3 * T;

  // Pieces [u0, u0 + kRunsPieces) into the tables, from stream position
  // base; returns the table's end position and sets *n_u to its nonempty
  // units.  Every thread takes part.
  auto build = [&](int u0, int base, int* n_u) {
    const int j = u0 + static_cast<int>(threadIdx.x);
    int w = 0;
    long long col = 0;
    bool direct = false, ends = false;
    if (j < a_t) {
      col = ~(static_cast<long long>(j) * k_tile);
      w = min(k_tile, a_lim - j * k_tile);
      ends = true;
    } else if (j >= a_al && j < n_pieces) {
      const int e = j - a_al;
      long long start;
      int lo, hi;
      direct_entry(tb, T, e, sw, npad, &start, &lo, &hi);
      col = start + lo;
      w = hi - lo;
      direct = true;
      ends = e % P == P - 1;
    }
    w = max(w, 0);
    int uw = w;  // a direct step's lanes: the sum over its P pieces
#pragma unroll
    for (int o = 1; o < P; o <<= 1) {
      uw += __shfl_xor_sync(0xffffffffu, uw, o);
    }
    const bool unit_end = ends && (direct ? uw : w) > 0;
    int x = w;  // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, unit_end);
    if (lane == 31) wsum[warp] = x;
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int before = base, end = base, ubefore = 0, units = 0;
#pragma unroll
    for (int ww = 0; ww < kRunsWarps; ++ww) {
      if (ww < warp) {
        before += wsum[ww];
        ubefore += wcnt[ww];
      }
      end += wsum[ww];
      units += wcnt[ww];
    }
    upos[threadIdx.x + 1] = before + x;
    if (threadIdx.x == 0) upos[0] = base;
    ucol[threadIdx.x] = col;
    if (unit_end) {
      uend[ubefore + __popc(bal & ((1u << lane) - 1u))] = before + x;
    }
    __syncthreads();
    *n_u = units;
    return end;
  };

  // the table's lanes [p0, p0 + m) into buf
  auto fill = [&](int p0, int m) {
    for (int l = threadIdx.x; l < m; l += kRunsThreads) {
      const int pos = p0 + l;
      // the piece holding pos: upos[lo] <= pos < upos[lo + 1]
      int lo = 0, hi = kRunsPieces;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (upos[mid] <= pos) {
          lo = mid;
        } else {
          hi = mid;
        }
      }
      const long long c0 = ucol[lo];
      const float* sp = c0 < 0 ? ap : srct;
      const long long pitch = c0 < 0 ? A : npad;
      const long long c = (c0 < 0 ? ~c0 : c0) + (pos - upos[lo]);
      buf[l] = make_float4(sp[c], sp[pitch + c],
                           DIMS == 3 ? sp[2 * pitch + c] : 0.f,
                           sp[DIMS * pitch + c]);
    }
  };

  if (q == 0) {
#pragma unroll
    for (int d = 0; d < DIMS; ++d) carry[d * per_block] = 0.f;
  }
  float a[3] = {0.f, 0.f, 0.f};  // the running sum (slice 0)
  int u0 = -kRunsPieces;  // the table's first piece
  int n_u = 0;            // its nonempty units
  int bend = 0;           // its end position
  int pos0 = 0;           // the round's first lane
  int kb = 0;             // the round's first unit in the table
  int n_fold = 0, n_own = 0;  // the last round's units, slice 0's own
  unsigned long long n_staged = 0;
  while (true) {  // one round; uniform across the block
    __syncthreads();  // the last round's buf reads, slots and carry are done
    float t[3] = {0.f, 0.f, 0.f};  // the partial of the unit in progress
    if (q == 0) {  // slices 1..r-1's partials, in unit order; the carry
      for (int k = n_own; k < n_fold; ++k) {
#pragma unroll
        for (int d = 0; d < DIMS; ++d) {
          a[d] += slot[(k * DIMS + d) * per_block + il];
        }
      }
#pragma unroll
      for (int d = 0; d < DIMS; ++d) t[d] = carry[d * per_block];
    }
    // at a table's end (a unit's end), the next table that holds lanes
    if (pos0 == bend) {
      bool more = false;
      while (!more && u0 + kRunsPieces < n_pieces) {
        u0 += kRunsPieces;
        bend = build(u0, pos0, &n_u);
        kb = 0;
        more = bend > pos0;
      }
      if (!more) break;
    }
    // the round: at most kRunsChunk lanes and max_units units of the table
    int pos1 = min(pos0 + kRunsChunk, bend);
    if (kb + max_units - 1 < n_u) pos1 = min(pos1, uend[kb + max_units - 1]);
    const int k1 = first_above(uend, kb, n_u, pos1);  // units past pos1
    const int m = pos1 - pos0;
    fill(pos0, m);
    n_staged += m;
    __syncthreads();

    // slice q's span [b0, b1): cut at the unit ends in (pos0, pos1) nearest
    // to pos0 + q m / r (slice 0 always starts at pos0, the last ends at
    // pos1)
    auto cut = [&](int qq) {
      if (qq == slices) return pos1;
      if (qq == 0) return pos0;
      const int x = pos0 + static_cast<int>(
          static_cast<long long>(qq) * m / slices);
      const int k = first_above(uend, kb, k1, x - 1);  // first end >= x
      const int hi_c = k < k1 ? uend[k] : pos1;
      if (k == kb) return hi_c;
      const int lo_c = uend[k - 1];
      return x - lo_c <= hi_c - x ? lo_c : hi_c;
    };
    const int b0 = cut(q), b1 = cut(q + 1);
    int k = first_above(uend, kb, k1, b0);  // the unit holding lane b0
    int own = 0;
    for (int j = b0; j < b1;) {
      const int ue = k < k1 ? uend[k] : pos1 + 1;  // past pos1: carried
      const int e = min(ue, b1);
      for (; j < e; ++j) {
        nbody::pair_force<DIMS>(buf[j - pos0], px, py, pz, eps, &t[0],
                                &t[1], &t[2]);
      }
      if (e == ue) {  // the unit ends: its partial, in unit order
#pragma unroll
        for (int d = 0; d < DIMS; ++d) {
          if (q == 0) {
            a[d] += t[d];
          } else {
            slot[((k - kb) * DIMS + d) * per_block + il] = t[d];
          }
          t[d] = 0.f;
        }
        own += q == 0;
        ++k;
      }
    }
    // the slice with the round's last lanes leaves the carry (0 when the
    // round ends at a unit's end)
    if (b0 < b1 && b1 == pos1) {
#pragma unroll
      for (int d = 0; d < DIMS; ++d) carry[d * per_block] = t[d];
    }
    n_fold = k1 - kb;
    n_own = own;
    kb = k1;
    pos0 = pos1;
  }
  if (staged != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(staged, n_staged);
  }
  if (live && q == 0) {
#pragma unroll
    for (int d = 0; d < DIMS; ++d) out[ti_base + d] = a[d];
  }
}

constexpr int kSplitThreads = 256;  // SPLIT_THREADS in ops/list_eval.py
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitPer = 2;  // lanes each thread loads per chunk
constexpr int kSplitChunk = kSplitPer * kSplitThreads;  // lanes per chunk
constexpr int kUnits = kSplitThreads;  // units per batch, one per thread
// The sliced path (a row's r > 1): lanes staged a round (7.5 direct
// entries of 512 lanes, so eight slices have a unit each), and the unit
// partials of one round's slices 1..r-1 and the carry, U + 1 slots of
// DIMS x (kSplitThreads / r) floats.
constexpr int kSliceChunk = 3840;
constexpr int kSliceSlotFloats = 2048;

// One quarter's stream (runs_split_kernel): its units, in table order,
// are the approx tiles (lanes < lens[0, i] of each), the extension tiles
// (lanes < lens[1, i]) and the direct entries ([lo, hi) of each, clipped
// as direct_entry clips it).
template <int DIMS>
struct SplitStream {
  const float* ap;    // the group's approx list [8, A]
  const float* ep;    // the quarter's extension table [8, E]
  const float* srct;  // the source table [8, npad]
  const int* tb;      // the quarter's direct table [3, T]
  int A, E, T, k_tile, a_t, e_t, n_units, a_lim, e_lim;
  long long npad;

  // unit u's lanes (0 past the stream), its list (0 approx, 1 extension,
  // 2 direct) and its first column in that list
  __device__ __forceinline__ int unit(int u, int* kind,
                                      long long* col) const {
    int w = 0;
    *kind = 2;
    *col = 0;
    if (u < a_t) {
      *kind = 0;
      *col = static_cast<long long>(u) * k_tile;
      w = min(k_tile, a_lim - u * k_tile);
    } else if (u < a_t + e_t) {
      *kind = 1;
      *col = static_cast<long long>(u - a_t) * k_tile;
      w = min(k_tile, e_lim - (u - a_t) * k_tile);
    } else if (u < n_units) {
      long long start;
      int lo, hi;
      direct_entry(tb, T, u - a_t - e_t, k_tile, npad, &start, &lo, &hi);
      *col = start + lo;
      w = hi - lo;
    }
    return max(w, 0);
  }

  // column c of list `kind`: (x, y, z, gm), through the read-only cache
  // (the kernel writes none of the lists)
  __device__ __forceinline__ float4 lane(int kind, long long c) const {
    const float* sp = kind == 0 ? ap : (kind == 1 ? ep : srct);
    const long long pitch = kind == 0 ? A : (kind == 1 ? E : npad);
    return make_float4(__ldg(sp + c), __ldg(sp + pitch + c),
                       DIMS == 3 ? __ldg(sp + 2 * pitch + c) : 0.f,
                       __ldg(sp + DIMS * pitch + c));
  }
};

// The unit holding stream position pos in a batch table upos[0..kUnits]:
// upos[lo] <= pos < upos[lo + 1].
__device__ __forceinline__ int unit_at(const int* upos, int pos) {
  int lo = 0, hi = kUnits;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (upos[mid] <= pos) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Shared memory of one block: the light path's or the sliced path's.
struct SplitLight {
  float4 buf[kSplitChunk];
  int upos[2][kUnits + 1];     // stream position of each unit
  long long ucol[2][kUnits];   // its first column in its list
  int ukind[2][kUnits];        // 0 approx, 1 extension, 2 direct
  int wsum[kSplitWarps];
};
struct SplitSliced {
  float4 buf[kSliceChunk];
  float slot[kSliceSlotFloats];
  long long ucol[kUnits];
  int upos[kUnits + 1];
  int ukind[kUnits];
  int uend[kUnits];  // the nonempty units' ends
  int wsum[kSplitWarps], wcnt[kSplitWarps];
};
union SplitShared {
  SplitLight light;
  SplitSliced sliced;
};

// The light path (r = 1): one target a thread.  The stream is cut into
// chunks of at most kSplitChunk lanes that never cross a batch of kUnits
// units; a batch's table in shared memory gives each unit its first stream
// position (an exclusive prefix over the block), its list and its first
// column.  Adds the quarter's force on the thread's target to a.
template <int DIMS>
__device__ __forceinline__ void split_light(SplitLight& sm,
                                            const SplitStream<DIMS>& st,
                                            float px, float py, float pz,
                                            float eps, float* a,
                                            unsigned long long* n_staged) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Units [u0, u0 + kUnits) into table `slot`, from stream position base;
  // returns the batch's end position.  Every thread takes part.
  auto build = [&](int slot, int u0, int base) {
    int kind;
    long long col;
    const int w = st.unit(u0 + static_cast<int>(threadIdx.x), &kind, &col);
    int x = w;  // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) sm.wsum[warp] = x;
    __syncthreads();
    int before = base, end = base;
#pragma unroll
    for (int ww = 0; ww < kSplitWarps; ++ww) {
      if (ww < warp) before += sm.wsum[ww];
      end += sm.wsum[ww];
    }
    sm.upos[slot][threadIdx.x + 1] = before + x;
    if (threadIdx.x == 0) sm.upos[slot][0] = base;
    sm.ucol[slot][threadIdx.x] = col;
    sm.ukind[slot][threadIdx.x] = kind;
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
        const int lo = unit_at(sm.upos[slot], pos);
        v[p] = st.lane(sm.ukind[slot][lo],
                       sm.ucol[slot][lo] + (pos - sm.upos[slot][lo]));
      }
    }
  };

  // the first batch that holds lanes (an empty batch holds only empty
  // units, each of which would add +0)
  int slot = 0, u0 = 0;
  int bend = build(0, 0, 0);
  while (bend == 0 && u0 + kUnits < st.n_units) {
    u0 += kUnits;
    bend = build(0, u0, 0);
  }
  int pos0 = 0, pos1 = min(bend, kSplitChunk);
  int u = u0;  // the unit the pair loop is in
  if (pos1 > pos0) fetch(slot, pos0, pos1);

  float t[3] = {0.f, 0.f, 0.f};  // this unit's partial
  while (pos1 > pos0) {  // uniform across the block
    const int m = pos1 - pos0;
    __syncthreads();  // every thread is done with the last chunk
#pragma unroll
    for (int p = 0; p < kSplitPer; ++p) {
      const int l = p * kSplitThreads + static_cast<int>(threadIdx.x);
      if (l < m) sm.buf[l] = v[p];
    }
    *n_staged += m;
    // the next chunk, from the next batch that holds lanes when this one
    // ends; its loads fly while this chunk is evaluated
    int nslot = slot, nu0 = u0, nbend = bend;
    const int np0 = pos1;
    if (np0 == bend) {
      nslot = slot ^ 1;
      while (nbend == np0 && nu0 + kUnits < st.n_units) {
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
      const int uend = sm.upos[slot][u - u0 + 1] - pos0;
      const int e = min(uend, m);
      for (; j < e; ++j) {
        nbody::pair_force<DIMS>(sm.buf[j], px, py, pz, eps, &t[0], &t[1],
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
}

// The sliced path (r = `slices` > 1), K2's rounds: thread il of slice q
// holds target il of the block's kSplitThreads / r.  A round stages at most
// kSliceChunk lanes and as many nonempty units as the slots hold; its lanes
// are cut into r spans at the unit ends nearest to equal shares.  Every
// unit's partial is one thread's chain in lane order: slice 0 adds its own
// units' partials to the running sum as they end, slices 1..r-1 leave
// theirs in slots that slice 0 adds in unit order after the round, and a
// unit that runs past the round leaves its partial in the carry slot,
// which slice 0 goes on summing.  Empty units are skipped: each would add
// +0, which leaves a sum that starts at +0 as it is.  So the running sum
// (slice 0's a) takes the light path's operations in its order.
template <int DIMS>
__device__ __forceinline__ void split_sliced(SplitSliced& sm,
                                             const SplitStream<DIMS>& st,
                                             int slices, float px, float py,
                                             float pz, float eps, float* a,
                                             unsigned long long* n_staged) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_block = kSplitThreads / slices;
  const int q = threadIdx.x / per_block;  // this thread's slice
  const int il = threadIdx.x % per_block;
  // slots: unit k of a round at [(k DIMS + d) per_block + il], k < n_slot,
  // the carry at k = n_slot
  const int n_slot = kSliceSlotFloats / (DIMS * per_block) - 1;
  float* carry = sm.slot + n_slot * DIMS * per_block + il;

  // Units [u0, u0 + kUnits) into the tables, from stream position base;
  // returns the table's end position and sets *n_u to its nonempty units.
  // Every thread takes part.
  auto build = [&](int u0, int base, int* n_u) {
    int kind;
    long long col;
    const int w = st.unit(u0 + static_cast<int>(threadIdx.x), &kind, &col);
    int x = w;  // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, w > 0);
    if (lane == 31) sm.wsum[warp] = x;
    if (lane == 0) sm.wcnt[warp] = __popc(bal);
    __syncthreads();
    int before = base, end = base, ubefore = 0, units = 0;
#pragma unroll
    for (int ww = 0; ww < kSplitWarps; ++ww) {
      if (ww < warp) {
        before += sm.wsum[ww];
        ubefore += sm.wcnt[ww];
      }
      end += sm.wsum[ww];
      units += sm.wcnt[ww];
    }
    sm.upos[threadIdx.x + 1] = before + x;
    if (threadIdx.x == 0) sm.upos[0] = base;
    sm.ucol[threadIdx.x] = col;
    sm.ukind[threadIdx.x] = kind;
    if (w > 0) {
      sm.uend[ubefore + __popc(bal & ((1u << lane) - 1u))] = before + x;
    }
    __syncthreads();
    *n_u = units;
    return end;
  };

  if (q == 0) {
#pragma unroll
    for (int d = 0; d < DIMS; ++d) carry[d * per_block] = 0.f;
  }
  int u0 = -kUnits;  // the table's first unit
  int n_u = 0;       // its nonempty units
  int bend = 0;      // its end position
  int pos0 = 0;      // the round's first lane
  int kb = 0;        // the round's first nonempty unit in the table
  int n_fold = 0, n_own = 0;  // the last round's units, slice 0's own
  while (true) {  // one round; uniform across the block
    __syncthreads();  // the last round's buf reads, slots and carry are done
    float t[3] = {0.f, 0.f, 0.f};  // the partial of the unit in progress
    if (q == 0) {  // slices 1..r-1's partials, in unit order; the carry
      for (int k = n_own; k < n_fold; ++k) {
#pragma unroll
        for (int d = 0; d < DIMS; ++d) {
          a[d] += sm.slot[(k * DIMS + d) * per_block + il];
        }
      }
#pragma unroll
      for (int d = 0; d < DIMS; ++d) t[d] = carry[d * per_block];
    }
    // at a table's end (a unit's end), the next table that holds lanes
    if (pos0 == bend) {
      bool more = false;
      while (!more && u0 + kUnits < st.n_units) {
        u0 += kUnits;
        bend = build(u0, pos0, &n_u);
        kb = 0;
        more = bend > pos0;
      }
      if (!more) break;
    }
    // the round: at most kSliceChunk lanes and n_slot units of the table
    int pos1 = min(pos0 + kSliceChunk, bend);
    if (kb + n_slot - 1 < n_u) pos1 = min(pos1, sm.uend[kb + n_slot - 1]);
    const int k1 = first_above(sm.uend, kb, n_u, pos1);  // units past pos1
    const int m = pos1 - pos0;
    for (int l = threadIdx.x; l < m; l += kSplitThreads) {
      const int lo = unit_at(sm.upos, pos0 + l);
      sm.buf[l] = st.lane(sm.ukind[lo],
                          sm.ucol[lo] + (pos0 + l - sm.upos[lo]));
    }
    *n_staged += m;
    __syncthreads();

    // slice q's span [b0, b1): cut at the unit ends in (pos0, pos1) nearest
    // to pos0 + q m / r (slice 0 always starts at pos0, the last ends at
    // pos1)
    auto cut = [&](int qq) {
      if (qq == slices) return pos1;
      if (qq == 0) return pos0;
      const int x = pos0 + static_cast<int>(
          static_cast<long long>(qq) * m / slices);
      const int k = first_above(sm.uend, kb, k1, x - 1);  // first end >= x
      const int hi_c = k < k1 ? sm.uend[k] : pos1;
      if (k == kb) return hi_c;
      const int lo_c = sm.uend[k - 1];
      return x - lo_c <= hi_c - x ? lo_c : hi_c;
    };
    const int b0 = cut(q), b1 = cut(q + 1);
    int k = first_above(sm.uend, kb, k1, b0);  // the unit holding lane b0
    int own = 0;
    for (int j = b0; j < b1;) {
      const int ue = k < k1 ? sm.uend[k] : pos1 + 1;  // past pos1: carried
      const int e = min(ue, b1);
      for (; j < e; ++j) {
        nbody::pair_force<DIMS>(sm.buf[j - pos0], px, py, pz, eps, &t[0],
                                &t[1], &t[2]);
      }
      if (e == ue) {  // the unit ends: its partial, in unit order
#pragma unroll
        for (int d = 0; d < DIMS; ++d) {
          if (q == 0) {
            a[d] += t[d];
          } else {
            sm.slot[((k - kb) * DIMS + d) * per_block + il] = t[d];
          }
          t[d] = 0.f;
        }
        own += q == 0;
        ++k;
      }
    }
    // the slice with the round's last lanes leaves the carry (0 when the
    // round ends at a unit's end)
    if (b0 < b1 && b1 == pos1) {
#pragma unroll
      for (int d = 0; d < DIMS; ++d) carry[d * per_block] = t[d];
    }
    n_fold = k1 - kb;
    n_own = own;
    kb = k1;
    pos0 = pos1;
  }
}

// K4: block b of the grid takes row r of the schedule (row_start[r] <= b
// < row_start[r + 1]; blocks past row_start[4G] exit), quarter order[r]
// (heaviest first) with slices[r] thread slices a target, so the row's
// blocks hold kSplitThreads / slices[r] targets each.
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
    const int* __restrict__ row_slices, const int* __restrict__ row_start,
    unsigned long long* __restrict__ staged) {
  extern __shared__ float4 split_shared[];
  SplitShared& sm = *reinterpret_cast<SplitShared*>(split_shared);
  const int b = blockIdx.x;
  if (b >= row_start[n_quarters]) return;  // a surplus block
  const int row = first_above(row_start, 0, n_quarters + 1, b) - 1;
  const int slices = row_slices[row];
  const int bx = b - row_start[row];  // the block within its row
  const int qi = order[row];  // quarter i = 4g + q
  const int g = qi >> 2;
  const int sq = S / 4;
  const int per_block = kSplitThreads / slices;

  const int i = bx * per_block + threadIdx.x % per_block;  // in the quarter
  const bool live = i < sq;
  const size_t ti_base =
      (static_cast<size_t>(g) * S + (qi & 3) * sq + i) * DIMS;
  const float px = live ? tgt[ti_base] : 0.f;
  const float py = live ? tgt[ti_base + 1] : 0.f;
  const float pz = (DIMS == 3 && live) ? tgt[ti_base + DIMS - 1] : 0.f;

  SplitStream<DIMS> st;
  st.ap = approx + static_cast<size_t>(g) * 8 * A;
  st.ep = ext + static_cast<size_t>(qi) * 8 * E;
  st.srct = srct;
  st.tb = tiles + static_cast<size_t>(qi) * 3 * T;
  st.A = A;
  st.E = E;
  st.T = T;
  st.k_tile = k_tile;
  st.npad = npad;
  st.a_t = (lens[qi] + k_tile - 1) / k_tile;
  st.e_t = min((lens[n_quarters + qi] + k_tile - 1) / k_tile, e_tiles);
  st.a_lim = min(lens[qi], A);  // lanes the approx tiles hold
  st.e_lim = min(lens[n_quarters + qi], E);
  st.n_units = st.a_t + st.e_t + min(lens[2 * n_quarters + qi], T);

  float a[3] = {0.f, 0.f, 0.f};  // the running sum
  unsigned long long n_staged = 0;
  if (slices == 1) {  // uniform across the block
    split_light<DIMS>(sm.light, st, px, py, pz, eps, a, &n_staged);
  } else {
    split_sliced<DIMS>(sm.sliced, st, slices, px, py, pz, eps, a,
                       &n_staged);
  }
  if (staged != nullptr && bx == 0 && threadIdx.x == 0) {
    atomicAdd(staged, n_staged);
  }
  if (live && threadIdx.x < per_block) {  // slice 0
#pragma unroll
    for (int d = 0; d < DIMS; ++d) out[ti_base + d] = a[d];
  }
}

using RunsFn = void (*)(const float*, const float*, const float*,
                        const int*, const int*, float*, int, int, int,
                        long long, int, int, float, int, const int*,
                        unsigned long long*);

template <int DIMS>
RunsFn runs_for(int seg_pack) {
  switch (seg_pack) {
    case 1:
      return runs_kernel<DIMS, 1>;
    case 2:
      return runs_kernel<DIMS, 2>;
    case 4:
      return runs_kernel<DIMS, 4>;
    case 8:
      return runs_kernel<DIMS, 8>;
    default:
      return nullptr;
  }
}

RunsFn runs_for(int dims, int seg_pack) {
  return dims == 3 ? runs_for<3>(seg_pack)
                   : (dims == 2 ? runs_for<2>(seg_pack) : nullptr);
}

using SplitFn = void (*)(const float*, const float*, const float*,
                        const float*, const int*, const int*, float*, int,
                        int, int, int, long long, int, int, int, float,
                        const int*, const int*, const int*,
                        unsigned long long*);

// K4 for `dims`, allowed the dynamic shared memory its sliced path needs
// (past the 48 KB a block gets unasked); nullptr for other dims
SplitFn split_for(int dims, cudaError_t* err) {
  const SplitFn kernel = dims == 3 ? runs_split_kernel<3>
                         : (dims == 2 ? runs_split_kernel<2> : nullptr);
  *err = kernel == nullptr
             ? cudaErrorInvalidValue
             : cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   static_cast<int>(sizeof(SplitShared)));
  return kernel;
}

}  // namespace

// One launch of K4: `threads` must be kSplitThreads; `blocks` blocks, row
// r of the schedule (quarter order[r], a permutation of the 4G quarters,
// with slices[r] in 1, 2, 4, 8 thread slices a target) taking blocks
// [row_start[r], row_start[r + 1]) of kSplitThreads / slices[r] targets
// each; blocks past row_start[4G] exit.  A non-null `staged` gets the lanes
// the first block of each quarter staged.
extern "C" int nbody_runs_eval_split(const float* tgt, const float* approx,
                                     const float* ext, const float* srct,
                                     const int* tiles, const int* lens,
                                     float* out, int n_quarters, int S, int A,
                                     int E, long long npad, int T, int k_tile,
                                     int e_tiles, float softening, int dims,
                                     int threads, const int* order,
                                     const int* slices, const int* row_start,
                                     int blocks, unsigned long long* staged,
                                     void* stream) {
  if (n_quarters == 0 || S == 0) return 0;
  if (threads != kSplitThreads || S % 4 || n_quarters % 4 || k_tile < 1 ||
      blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const SplitFn kernel = split_for(dims, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kSplitThreads, sizeof(SplitShared),
           static_cast<cudaStream_t>(stream)>>>(
      tgt, approx, ext, srct, tiles, lens, out, n_quarters, S, A, E, npad, T,
      k_tile, e_tiles, softening, order, slices, row_start, staged);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K4 (`dims`) an SM of the current card holds at once, into
// *blocks_per_sm.
extern "C" int nbody_runs_split_occupancy(int dims, int threads,
                                          int* blocks_per_sm) {
  cudaError_t err;
  const SplitFn kernel = split_for(dims, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (threads != kSplitThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kSplitThreads, sizeof(SplitShared)));
}

// One launch of K2 (seg_pack 1) or K3 (seg_pack 2, 4, 8): `threads` must
// be kRunsThreads and `slices` one of 1, 2, 4, 8; blocks of
// kRunsThreads / slices targets over S, row r taking group order[r] (a
// permutation of the G groups).  A non-null `staged` gets the lanes the
// first block of each group staged.
extern "C" int nbody_runs_eval(const float* tgt, const float* approx,
                               const float* srct, const int* tiles,
                               const int* lens, float* out, int n_groups,
                               int S, int A, long long npad, int T,
                               int k_tile, float softening, int dims,
                               int seg_pack, int threads, int slices,
                               const int* order, unsigned long long* staged,
                               void* stream) {
  if (n_groups == 0 || S == 0) return 0;
  const RunsFn kernel = runs_for(dims, seg_pack);
  if (kernel == nullptr || k_tile < seg_pack || k_tile % seg_pack ||
      threads != kRunsThreads ||
      (slices != 1 && slices != 2 && slices != 4 && slices != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = kRunsThreads / slices;
  const dim3 grid((S + per_block - 1) / per_block, n_groups);
  kernel<<<grid, kRunsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tgt, approx, srct, tiles, lens, out, n_groups, S, A, npad, T, k_tile,
      softening, slices, order, staged);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K2/K3 (`dims`, `seg_pack`) an SM of the current card holds at
// once, into *blocks_per_sm.
extern "C" int nbody_runs_occupancy(int dims, int seg_pack, int threads,
                                    int* blocks_per_sm) {
  const RunsFn kernel = runs_for(dims, seg_pack);
  if (kernel == nullptr || threads != kRunsThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kRunsThreads, 0));
}
