// The pass-1 tail bias, score_inverted, as one kernel for Hopper (sm_90a):
// B4 redesigned.
//
// Replaces the Pallas TPU kernel repro/kernels/block_sparse.py:
// inverted_value_forward_pallas (body _vf_kernel), and computes what
// repro/core/sparse_index.py:score_inverted computes:
//
//   out[q, r] = sum over slots s (in order) and list positions p (in order)
//               with rows[q_dims[q, s], p] == r of
//               vals[q_dims[q, s], p] * q_vals[q, s]
//
// from the padded inverted index (rows (d, L) int32 with the sentinel N,
// vals (d, L) f32) and the padded queries (q_dims (Q, nq) int32 or int64,
// q_vals (Q, nq) f32) into a contiguous (Q, N) f32 output.  A slot whose
// dim is < 0 or >= d adds nothing; a list entry whose row is not in [0, N)
// (the sentinel) adds nothing.
//
// The TPU kernel took a stream that the host planned per call (rows sorted
// within (query-block, row-block) segments, cut into BlockSpec chunks and
// scalar-prefetched) and scatter-added each chunk as two one-hot matrices
// on the MXU.  The planner cost 130-180 ms a call on the host, which kept
// the TPU layout's kernel off every search.  Here a CTA loads its own
// indices, so there is no plan: the kernel reads the index and the queries
// as the search holds them.
//
// The design.  A CTA owns one query q and a range of output rows
// [c0, c1), cut into tiles of rows_per_tile rows; the launch plan
// (kernels/inverted.py:plan_score_inverted) gives a query as many CTAs as
// make two waves of two per SM, so that one CTA's list reads and tile work
// hide behind another's stores (at Q = 1, 512 CTAs of one 1024-row tile;
// at Q = 128, four CTAs a query, of 11 or 10 tiles of 12288 rows).  Each
// of the 8 warps owns a contiguous eighth of a tile's rows.
//   A. Read the query's lists once.  For each window of 256 slots, compact
//      the valid slots (in slot order) with warp ballots; stage the
//      window's lists, flattened in (slot, position) order, 2048 entries
//      at a time: each thread issues the loads of its 8 entries before it
//      uses one (coalesced: the positions of one list are contiguous),
//      rounds each product vals * q_val once (__fmul_rn), as
//      score_inverted's `contrib = vals_g * q_vals` rounds it, and the
//      entries whose row lies in [c0, c1) (the sentinel never does) are
//      appended, in staging order, to a resident buffer of `cap` entries
//      in shared memory (warp ballots, one scan of the 64 (entry, warp)
//      counts).  At the slice a query's lists hold 3600 live entries on
//      average (460840 at Q = 128), 29 KB.
//   B. For each tile: zero it in shared memory; take the resident entries
//      2048 at a time, keep those in the tile's rows in order (the same
//      compaction, into a second buffer), and let each warp walk the kept
//      entries in order, 32 at a time, adding those in its own rows
//      (__fadd_rn: nothing is contracted into an FMA); store the tile with
//      16-byte stores, aligned to the output's address (the tile is kept
//      shifted by that address's offset in floats, so the two line up at
//      any N), scalar stores at its ends.
//   If a CTA's entries overflow the resident buffer, it streams instead:
//   each tile reads the lists again, piece by piece, from L2, and keeps and
//   walks each piece's entries the same way; slower, the same bits.
//
// Why the bits equal score_inverted's.  That function scatter-adds one
// slot at a time into zeros, so every output is the sum of its
// contributions in (slot, position) order from +0.  Here a cell belongs to
// one warp, which reaches its contributions in staging order, and staging
// order is (slot, position) order.  One 32-entry step can hold a row
// twice: kept entries of two slots, or of one list that repeats a row
// (DeltaPostings' do when an inserted row repeats a dim).  Lanes with the
// same row (__match_any_sync) then add one after another in lane order,
// which is staging order.  __syncwarp orders each step's adds before the
// next's.  No atomics, so the bits do not depend on the run.  One
// difference remains, outside any data this repository makes: CUDA's
// atomic f32 add, which scatter_add_ uses on the card, flushes subnormal
// inputs and results to zero, and __fadd_rn keeps them (as the CPU's
// scatter_add_ does).
//
// What bounds it on the H100: bytes.  It writes the (Q, N) f32 output once
// and needs each live posting (row and value, 8 B) of each valid slot once,
// plus the queries: at the slice (Q = 128, N = 524288, 460840 live
// entries) 268 MB + 3.7 MB, 0.081 ms at 3.35 TB/s; the adds (one per live
// entry) are nothing beside that.  What the design does about it: the
// output is written once, from shared memory, 16 bytes a thread, with no
// read of it and no second pass; a query's lists are read once per CTA
// (four times a query at Q = 128), with 8 loads in flight a thread, and a
// tile's work reads only shared memory, so after the first reads each SM
// streams its tiles out one after another while its other CTA works.
// Why not simpler (PERF.md, Findings): reading the lists again for each tile
// left the list reads in the way; letting every warp walk all of a
// query's entries for each tile, the walk; storing a tile's zeros straight
// from registers and writing its touched cells after them was slower
// than storing the tile from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = kThreads;         // slots compacted at once
constexpr int kStage = 2048;              // list entries staged at once
constexpr int kPerThread = kStage / kThreads;
constexpr int kCounts = 96;               // 8 window counts, 64 + 1 stage
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of one CTA: the tile (rows_per_tile + 4 floats: up
// to 3 of shift), the resident buffer (row, product) of cap entries, the
// kept buffer of kStage, the window's compacted dims and values, and the
// counts of the compactions.
__host__ __device__ constexpr size_t smem_bytes(int rows_per_tile, int cap) {
  return sizeof(float) * ((size_t)rows_per_tile + 4)
         + (sizeof(int) + sizeof(float)) * ((size_t)cap + kStage)
         + (sizeof(int) + sizeof(float)) * kWindow
         + sizeof(int) * kCounts;
}

struct Shared {
  float* acc;     // [rows_per_tile + 4]
  int* brow;      // [cap] resident: global rows
  float* bval;    // [cap] resident: products
  int* krow;      // [kStage] kept for a tile: global rows
  float* kval;    // [kStage] kept for a tile: products
  int* wdim;      // [kWindow]
  float* wqv;     // [kWindow]
  int* wsum;      // [kWarps]
  int* scnt;      // [kPerThread * kWarps + 1]
};

struct Lane {
  int tid, lane, warp;
  unsigned below;     // lanes below this one
};

// Compacts the valid slots of window [w0, w0 + kWindow) of one query into
// sh.wdim / sh.wqv, in slot order; returns their count.
template <typename DimT>
__device__ int window_slots(const DimT* qd, const float* qv, int nq, int d,
                            int w0, const Shared& sh, const Lane& t) {
  const int s = w0 + t.tid;
  bool valid = false;
  int dim = 0;
  float val = 0.f;
  if (s < nq) {
    const long long dd = (long long)qd[s];
    valid = dd >= 0 && dd < d;
    dim = (int)dd;
    val = qv[s];
  }
  const unsigned ballot = __ballot_sync(kFull, valid);
  if (t.lane == 0) sh.wsum[t.warp] = __popc(ballot);
  __syncthreads();
  int off = 0, count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = sh.wsum[w];
    off += (w < t.warp) ? c : 0;
    count += c;
  }
  if (valid) {
    const int at = off + __popc(ballot & t.below);
    sh.wdim[at] = dim;
    sh.wqv[at] = val;
  }
  __syncthreads();
  return count;
}

// Loads staged entries [e0, e0 + m) of the window's flattened lists (entry
// e is position e % l of the (e / l)-th valid slot's list) into registers:
// this thread's u-th entry is e0 + u * kThreads + tid.  Every load is
// issued before any is used.  rr = global row (-1 past m), cc = the
// rounded product.
__device__ void load_piece(const int* __restrict__ rows,
                           const float* __restrict__ vals, const Shared& sh,
                           int l, int e0, int m, const Lane& t,
                           int (&rr)[kPerThread], float (&cc)[kPerThread]) {
  float vv[kPerThread], qq[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int i = t.tid + u * kThreads;
    rr[u] = -1;
    vv[u] = 0.f;
    qq[u] = 0.f;
    if (i < m) {
      const int e = e0 + i;
      const int k = e / l;
      const size_t at = (size_t)sh.wdim[k] * l + (e - k * l);
      rr[u] = rows[at];
      vv[u] = vals[at];
      qq[u] = sh.wqv[k];
    }
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) cc[u] = __fmul_rn(vv[u], qq[u]);
}

// Loads resident entries [e0, e0 + m) into registers as load_piece does.
__device__ void load_resident(const Shared& sh, int e0, int m, const Lane& t,
                              int (&rr)[kPerThread], float (&cc)[kPerThread]) {
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int i = t.tid + u * kThreads;
    rr[u] = (i < m) ? sh.brow[e0 + i] : -1;
    cc[u] = (i < m) ? sh.bval[e0 + i] : 0.f;
  }
}

// Appends the registers' entries with row in [lo, hi) to drow / dval from
// `base` on, in staging order (u, warp, lane), unless they would pass
// `cap`; returns how many there are (the same in every thread).
__device__ int compact_piece(const int (&rr)[kPerThread],
                             const float (&cc)[kPerThread], int lo, int hi,
                             int* drow, float* dval, int base, int cap,
                             const Shared& sh, const Lane& t) {
  unsigned kept[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    kept[u] = __ballot_sync(kFull, rr[u] >= lo && rr[u] < hi);
    if (t.lane == 0) sh.scnt[u * kWarps + t.warp] = __popc(kept[u]);
  }
  __syncthreads();                // the counts
  if (t.warp == 0) {
    // exclusive scan of the 64 counts in (u, warp) order, 2 a lane
    const int a = sh.scnt[2 * t.lane], b = sh.scnt[2 * t.lane + 1];
    int incl = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, o);
      if (t.lane >= o) incl += x;
    }
    sh.scnt[2 * t.lane] = incl - a - b;
    sh.scnt[2 * t.lane + 1] = incl - b;
    if (t.lane == 31) sh.scnt[kPerThread * kWarps] = incl;
  }
  __syncthreads();                // the offsets
  const int total = sh.scnt[kPerThread * kWarps];
  if (base + total <= cap) {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      if ((kept[u] >> t.lane) & 1u) {
        const int at = base + sh.scnt[u * kWarps + t.warp]
                       + __popc(kept[u] & t.below);
        drow[at] = rr[u];
        dval[at] = cc[u];
      }
    }
  }
  __syncthreads();                // the entries, and the counts free
  return total;
}

// Each warp adds the kept entries [0, count) that fall in its rows
// [lo_w, hi_w) of the tile at r0, in order, 32 at a time.
__device__ void walk(const Shared& sh, int count, float* tile, int r0,
                     int lo_w, int hi_w, const Lane& t) {
  for (int i0 = 0; i0 < count; i0 += 32) {
    const int i = i0 + t.lane;
    int rl = -1;
    float c = 0.f;
    if (i < count) {
      rl = sh.krow[i] - r0;
      c = sh.kval[i];
    }
    const bool mine = rl >= lo_w && rl < hi_w;
    if (__ballot_sync(kFull, mine) == 0u) continue;
    const unsigned peers = __match_any_sync(kFull, mine ? rl : -1 - t.lane);
    const bool repeated = mine && (peers & ~(1u << t.lane)) != 0u;
    if (!__any_sync(kFull, repeated)) {
      if (mine) tile[rl] = __fadd_rn(tile[rl], c);
    } else {
      // a row repeated inside this step: its lanes add in lane order
      const int rank = __popc(peers & t.below);
      for (int k = 0;; ++k) {
        if (mine && rank == k) tile[rl] = __fadd_rn(tile[rl], c);
        __syncwarp();
        if (!__any_sync(kFull, mine && rank > k)) break;
      }
    }
    __syncwarp();
  }
}

template <typename DimT>
__global__ void __launch_bounds__(kThreads, 2)
score_inverted_kernel(const int* __restrict__ rows,
                      const float* __restrict__ vals,
                      const DimT* __restrict__ q_dims,
                      const float* __restrict__ q_vals,
                      float* __restrict__ out, int n, int d, int l, int nq,
                      int rows_per_tile, int tiles_per_cta,
                      int ctas_per_query, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared sh;
  sh.acc = reinterpret_cast<float*>(smem);
  sh.brow = reinterpret_cast<int*>(sh.acc + rows_per_tile + 4);
  sh.bval = reinterpret_cast<float*>(sh.brow + cap);
  sh.krow = reinterpret_cast<int*>(sh.bval + cap);
  sh.kval = reinterpret_cast<float*>(sh.krow + kStage);
  sh.wdim = reinterpret_cast<int*>(sh.kval + kStage);
  sh.wqv = reinterpret_cast<float*>(sh.wdim + kWindow);
  sh.wsum = reinterpret_cast<int*>(sh.wqv + kWindow);
  sh.scnt = sh.wsum + kWarps;
  Lane t;
  t.tid = threadIdx.x;
  t.lane = t.tid & 31;
  t.warp = t.tid >> 5;
  t.below = (1u << t.lane) - 1u;

  const int q = blockIdx.x / ctas_per_query;
  const int g = blockIdx.x - q * ctas_per_query;
  const long long span_rows = (long long)tiles_per_cta * rows_per_tile;
  const int c0 = (int)(g * span_rows);
  const int c1 = (int)min((long long)n, c0 + span_rows);
  const DimT* qd = q_dims + (size_t)q * nq;
  const float* qv = q_vals + (size_t)q * nq;
  int rr[kPerThread];
  float cc[kPerThread];

  // A. the query's lists, once: the entries in [c0, c1), resident
  int res_n = 0;                  // -1: they overflow cap
  for (int w0 = 0; w0 < nq && res_n >= 0; w0 += kWindow) {
    const int entries = window_slots(qd, qv, nq, d, w0, sh, t) * l;
    for (int e0 = 0; e0 < entries && res_n >= 0; e0 += kStage) {
      load_piece(rows, vals, sh, l, e0, min(kStage, entries - e0), t, rr, cc);
      const int kept = compact_piece(rr, cc, c0, c1, sh.brow, sh.bval, res_n,
                                     cap, sh, t);
      res_n = (res_n + kept <= cap) ? res_n + kept : -1;
    }
  }

  // B. the tiles, one after another
  const int rw = rows_per_tile / kWarps;
  const int lo_w = t.warp * rw;
  float4* acc4 = reinterpret_cast<float4*>(sh.acc);
  for (int r0 = c0; r0 < c1; r0 += rows_per_tile) {
    const int len = min(rows_per_tile, c1 - r0);
    const int hi_w = min(lo_w + rw, len);
    float* dst = out + (size_t)q * n + r0;
    // acc[mis + i] holds dst[i]: the two are 16-byte aligned at the same i
    const int mis = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3u);
    float* tile = sh.acc + mis;
    for (int i = t.tid; i < (rows_per_tile + 4) / 4; i += kThreads)
      acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();              // the zeros
    if (res_n >= 0) {
      for (int e0 = 0; e0 < res_n; e0 += kStage) {
        load_resident(sh, e0, min(kStage, res_n - e0), t, rr, cc);
        const int kept = compact_piece(rr, cc, r0, r0 + len, sh.krow, sh.kval,
                                       0, kStage, sh, t);
        walk(sh, kept, tile, r0, lo_w, hi_w, t);
        __syncthreads();          // walked: the kept buffer is free
      }
    } else {
      // streaming: the lists again, piece by piece, for this tile alone
      for (int w0 = 0; w0 < nq; w0 += kWindow) {
        const int entries = window_slots(qd, qv, nq, d, w0, sh, t) * l;
        for (int e0 = 0; e0 < entries; e0 += kStage) {
          load_piece(rows, vals, sh, l, e0, min(kStage, entries - e0), t, rr,
                     cc);
          const int kept = compact_piece(rr, cc, r0, r0 + len, sh.krow,
                                         sh.kval, 0, kStage, sh, t);
          walk(sh, kept, tile, r0, lo_w, hi_w, t);
          __syncthreads();        // walked: the kept buffer is free
        }
      }
    }
    // store acc[mis, mis + len) to dst[0, len), 16 bytes where aligned
    const int span = mis + len;
    for (int j4 = t.tid; 4 * j4 < span; j4 += kThreads) {
      const int j0 = 4 * j4;
      if (j0 >= mis && j0 + 4 <= span) {
        *reinterpret_cast<float4*>(dst + (j0 - mis)) = acc4[j4];
      } else {
        for (int j = max(j0, mis); j < min(j0 + 4, span); ++j)
          dst[j - mis] = sh.acc[j];
      }
    }
    __syncthreads();              // the tile read, before the next zeroes it
  }
}

template <typename DimT>
int launch(const int* rows, const float* vals, const DimT* q_dims,
           const float* q_vals, float* out, int n, int d, int l, int q,
           int nq, int rows_per_tile, int tiles_per_cta, int ctas_per_query,
           int cap, cudaStream_t stream) {
  const size_t smem = smem_bytes(rows_per_tile, cap);
  cudaError_t e = cudaFuncSetAttribute(
      score_inverted_kernel<DimT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  score_inverted_kernel<DimT>
      <<<(unsigned)((long long)q * ctas_per_query), kThreads, smem, stream>>>(
          rows, vals, q_dims, q_vals, out, n, d, l, nq, rows_per_tile,
          tiles_per_cta, ctas_per_query, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows (d, l) i32, vals (d, l) f32, q_dims (q, nq) i32 (dims_are_64 == 0)
// or i64, q_vals (q, nq) f32, out (q, n) f32 16-byte aligned, all
// contiguous; rows_per_tile a multiple of 32; CTA (query, g)
// owns tiles [g * tiles_per_cta, (g + 1) * tiles_per_cta).  Returns the
// cudaError_t.
int score_inverted_launch(const void* rows, const void* vals,
                          const void* q_dims, int dims_are_64,
                          const void* q_vals, void* out, int n, int d, int l,
                          int q, int nq, int rows_per_tile, int tiles_per_cta,
                          int ctas_per_query, int cap, void* stream) {
  if (q == 0 || n == 0) return 0;
  const int* r = static_cast<const int*>(rows);
  const float* v = static_cast<const float*>(vals);
  const float* qv = static_cast<const float*>(q_vals);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims_are_64)
    return launch(r, v, static_cast<const long long*>(q_dims), qv, o, n, d, l,
                  q, nq, rows_per_tile, tiles_per_cta, ctas_per_query, cap,
                  st);
  return launch(r, v, static_cast<const int*>(q_dims), qv, o, n, d, l, q, nq,
                rows_per_tile, tiles_per_cta, ctas_per_query, cap, st);
}

// Dynamic shared memory of one CTA, in bytes.
int score_inverted_smem_bytes(int rows_per_tile, int cap) {
  return (int)smem_bytes(rows_per_tile, cap);
}

// CTAs one SM holds at once, or a negative cudaError_t.
int score_inverted_ctas_per_sm(int rows_per_tile, int cap) {
  const size_t smem = smem_bytes(rows_per_tile, cap);
  cudaError_t e = cudaFuncSetAttribute(
      score_inverted_kernel<int>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, score_inverted_kernel<int>, kThreads, smem);
  return (e != cudaSuccess) ? -(int)e : blocks;
}

const char* score_inverted_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
