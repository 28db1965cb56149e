// LUT16 ADC scan (K1) and fused scan-and-select (K2) for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K1  repro/kernels/lut16.py:lut16_adc_pallas       (body _kernel)
//   K2  repro/kernels/lut16.py:lut16_adc_topk_pallas  (bodies _fused_kernel,
//       _block_partial)
//
// Both compute   score[q, n] = sum_k lut[q, k, codes[n, k]]   over 4-bit PQ
// codes, stored one per byte (N, K) or packed two per byte (N, ceil(K/2),
// subspace 2j in the low nibble of byte j).  K2 adds a bias base[q, n] after
// the full sum and keeps only the top `cbuf` (score, row) pairs per query,
// ordered by score descending and row ascending (lax.top_k's tie-break).
//
// What bounds them on the H100: every (query, row, subspace) triple is one
// shared-memory LUT read and one f32 add, Q*N*K of them; the code stream is
// only N*Kc bytes and is read once per query block.  At the pass-1 shapes
// (Q=128, K=100) the LUT reads, not HBM, are the limit.  The design keeps a
// query block's whole LUT (bq x K x 16 f32) in shared memory, so each code
// byte fetched from HBM feeds bq lookups, and lays each subspace's 16 entries
// on 16 consecutive banks, so the 32 lookups of a warp never conflict.  K1
// writes the (Q, N) matrix.  K2 never does; its selection must cost little
// beside the scan and must not take the scan's occupancy:
//
// - Shared memory: 4 queries per CTA, one sorted buffer of cbuf keys and one
//   chunk (256 keys) of staging per query; at K = 100, cbuf = 512 that is
//   75,840 B, and at most 80 registers, so three CTAs (24 warps) fit on an
//   SM, as K1 has.  Only queries that staged anything merge, each by the
//   256 / bq threads that own it (a named barrier per query): the staged
//   keys are ordered (a count of ranks when there are few, else a bitonic
//   sort), then every key goes straight to its rank in the merged list
//   (binary searches, no sorting network over the buffer).  Rows are
//   staged with one shared atomic per warp and query (ballot + popc).
// - Latency: each chunk's bias and the next chunk's code words (into
//   registers) are loaded before the scan and the words stored after it, so
//   no HBM round trip stands between two chunks; the copy of codes into
//   shared memory (shared with K1) divides once per thread, not per word.
// - One u32 per query in device memory, the shared threshold: the ordered
//   encoding of a score, raised only with atomicMax.  A CTA whose buffer
//   holds cbuf real keys publishes the worst of them.  Those are cbuf
//   distinct rows of the query, so the query's cbuf-th best score is at
//   least the published one: every value the array ever holds is a lower
//   bound of it, and a stale read is a lower one still, so relaxed loads
//   suffice.  The grid puts query blocks on x, so the first wave holds the
//   first ranges of every query block and later ranges start from it.
// - A row is staged only if its score is >= the shared threshold and > the
//   CTA's own cbuf-th buffered score.  Exactness: a row of the query's
//   top cbuf has a score >= the cbuf-th best >= the shared threshold, so the
//   first test never drops it (it is not strict: a row that ties the
//   threshold may have a lower id than the row that set it).  A row that
//   fails the second test has a score <= cbuf buffered rows of the same CTA,
//   all of lower id (a CTA visits its rows in increasing order), so cbuf
//   keys beat it.  So every CTA keeps every row of its range that belongs to
//   the top cbuf, and the reduction over the ranges' lists (merge rounds of
//   16 lists, keys below the final threshold dropped first) returns exactly
//   the top cbuf keys.  The keys order (score, row) totally, so the result
//   does not depend on which CTA published first: repeated launches give the
//   same bits.
//
// Exactness rules: f32 accumulation in subspace order k = 0..K-1 (shared by
// K1 and K2 through score_row, so fused and materialised pass 1 agree bit for
// bit), no fast-math, no tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // rows per chunk: each thread owns one row
constexpr int kLutWidth = 16;   // LUT entries per subspace (4-bit codes)
constexpr unsigned long long kEmpty = ~0ull;   // sorts after every real key

__host__ __device__ inline int code_words(int kc) { return (kc + 3) / 4; }

// Shared-memory row stride of the staged codes, in 32-bit words.  Odd, so
// that thread t reading word w of its own row hits bank (t*stride + w) % 32:
// the 32 rows of a warp fall on 32 different banks.
__host__ __device__ inline int code_stride(int kc) { return code_words(kc) | 1; }

// Copy the LUTs of queries [q0, q0 + BQ) into shared memory; queries past
// the end read as zeros (their sums are computed and never stored).
template <int BQ>
__device__ void load_lut(const float* __restrict__ lut, int q, int kl, int q0,
                         float* lut_s) {
  const int per_q = kl * kLutWidth;
  for (int i = threadIdx.x; i < BQ * per_q; i += blockDim.x) {
    const int qi = i / per_q;
    lut_s[i] = (q0 + qi < q) ? lut[(size_t)q0 * per_q + i] : 0.f;
  }
}

// Stage the code bytes of rows [row0, row0 + rows) into shared memory, one
// row per `code_stride(kc)` words.  The rows are contiguous in HBM, so the
// copy reads 32-bit words with neighbouring threads on neighbouring words;
// `codes` must be 4-byte aligned and row0 * kc a multiple of 4.  Each
// thread steps its (row, column) by a fixed amount per word, so the copy
// divides only once.
__device__ void load_codes(const uint8_t* __restrict__ codes, int kc,
                           long long row0, int rows, uint32_t* codes_s) {
  const int stride = code_stride(kc);
  const uint32_t* src32 = reinterpret_cast<const uint32_t*>(codes + row0 * kc);
  if ((kc & 3) == 0) {
    // whole words per row: word w of row r goes to codes_s[r * stride + w]
    const int wpr = kc >> 2;
    const int total = rows * wpr;
    const int dr = blockDim.x / wpr, dw = blockDim.x - dr * wpr;
    int r = threadIdx.x / wpr, w = threadIdx.x - r * wpr;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      codes_s[r * stride + w] = src32[i];
      r += dr;
      w += dw;
      if (w >= wpr) { w -= wpr; ++r; }
    }
    return;
  }
  // rows straddle words: byte stores
  const int stride_bytes = 4 * stride;
  const int nbytes = rows * kc;
  const int nwords = nbytes / 4;
  uint8_t* dst = reinterpret_cast<uint8_t*>(codes_s);
  const int step = 4 * blockDim.x;
  const int dr = step / kc, dc = step - dr * kc;
  int r = 4 * threadIdx.x / kc, c = 4 * threadIdx.x - r * kc;
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) {
    const uint32_t word = src32[w];
    int rr = r, cc = c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[rr * stride_bytes + cc] = (uint8_t)(word >> (8 * j));
      if (++cc == kc) { cc = 0; ++rr; }
    }
    r += dr;
    c += dc;
    if (c >= kc) { c -= kc; ++r; }
  }
  const uint8_t* src = codes + row0 * kc;
  for (int i = 4 * nwords + threadIdx.x; i < nbytes; i += blockDim.x) {
    const int ri = i / kc;
    dst[ri * stride_bytes + (i - ri * kc)] = src[i];
  }
}

template <int BQ>
__device__ __forceinline__ void add_lut(float (&acc)[BQ], const float* lut_s,
                                        int kl, int k, uint32_t code) {
  const float* p = lut_s + k * kLutWidth + (code & (kLutWidth - 1));
#pragma unroll
  for (int qi = 0; qi < BQ; ++qi) acc[qi] += p[qi * kl * kLutWidth];
}

// The per-row sum shared by K1 and K2: acc[qi] = sum over subspaces k in
// order 0..kl-1 of lut[qi, k, code(row, k)], starting from +0.
template <int BQ, bool PACKED>
__device__ __forceinline__ void score_row(const uint32_t* row_words, int kc,
                                          const float* lut_s, int kl,
                                          float (&acc)[BQ]) {
#pragma unroll
  for (int qi = 0; qi < BQ; ++qi) acc[qi] = 0.f;
  const int nw = code_words(kc);
  for (int w = 0; w < nw; ++w) {
    const uint32_t word = row_words[w];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int byte_idx = 4 * w + j;
      if (byte_idx < kc) {
        const uint32_t byte = (word >> (8 * j)) & 0xFFu;
        if (PACKED) {
          add_lut<BQ>(acc, lut_s, kl, 2 * byte_idx, byte & 0x0Fu);
          add_lut<BQ>(acc, lut_s, kl, 2 * byte_idx + 1, byte >> 4);
        } else {
          add_lut<BQ>(acc, lut_s, kl, byte_idx, byte);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K1: materialised scan.  Grid (row ranges, query blocks); each CTA walks its
// row range in chunks of kThreads rows.
// ---------------------------------------------------------------------------

template <int BQ, bool PACKED>
__global__ void __launch_bounds__(kThreads)
lut16_adc_kernel(const uint8_t* __restrict__ codes,
                 const float* __restrict__ lut, float* __restrict__ out,
                 long long n, int kc, int q, int kl, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);
  uint32_t* codes_s = reinterpret_cast<uint32_t*>(lut_s + BQ * kl * kLutWidth);
  const int q0 = blockIdx.y * BQ;
  const int stride = code_stride(kc);
  load_lut<BQ>(lut, q, kl, q0, lut_s);
  const long long start = (long long)blockIdx.x * rows_per_cta;
  const long long end = min(n, start + rows_per_cta);
  for (long long row0 = start; row0 < end; row0 += kThreads) {
    const int rows = (int)min((long long)kThreads, end - row0);
    __syncthreads();
    load_codes(codes, kc, row0, rows, codes_s);
    __syncthreads();
    if ((int)threadIdx.x < rows) {
      float acc[BQ];
      score_row<BQ, PACKED>(codes_s + threadIdx.x * stride, kc, lut_s, kl, acc);
      const long long row = row0 + threadIdx.x;
#pragma unroll
      for (int qi = 0; qi < BQ; ++qi)
        if (q0 + qi < q) out[(size_t)(q0 + qi) * n + row] = acc[qi];
    }
  }
}

// ---------------------------------------------------------------------------
// K2: fused scan-and-select.
//
// A key packs (score, row) into 64 bits so that ascending key order is score
// descending, then row ascending.  Keys are unique (a row is scanned once per
// query), so a key's place in a merged list is its rank.  Empty slots hold
// kEmpty, which no real key equals (its score would be a NaN).
// ---------------------------------------------------------------------------

constexpr int kMergeGroup = 16;   // partial lists one merge CTA reduces

__device__ __forceinline__ uint32_t float_to_ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ordered_to_float(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ unsigned long long make_key(float s, uint32_t row) {
  return ((unsigned long long)(~float_to_ordered(s)) << 32) | row;
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  return ordered_to_float(~(uint32_t)(key >> 32));
}

// Number of keys of the ascending a[0, n) that are below `key`.
__device__ __forceinline__ int count_below(const unsigned long long* a, int n,
                                           unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A relaxed read of a value other CTAs raise with atomicMax: it may be
// stale, never torn, and is read from L2 each time.
__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Barrier of the kThreads / BQ threads that merge one query of a block:
// named barrier 1 + group (barrier 0 is __syncthreads).
template <int BQ>
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" : : "r"(group + 1), "r"(kThreads / BQ)
               : "memory");
}

// The kThreads / BQ threads of `group` (t is a thread's rank in it) merge
// the m (1 <= m <= kThreads) unsorted keys of stage into the ascending
// buf[0, len), keeping the best cbuf: afterwards buf[0, min(cbuf, len + m))
// is sorted.  stage has kThreads slots.
template <int BQ>
__device__ void group_merge(unsigned long long* buf, int len,
                            unsigned long long* stage, int m, int cbuf,
                            int group, int t) {
  constexpr int kGroup = kThreads / BQ;
  if (m <= kGroup && m <= kThreads - kGroup) {
    // 1. few keys: each is written at its rank among the staged keys,
    //    counted, into the free upper part of the staging area
    unsigned long long key = 0;
    int rnk = 0;
    if (t < m) {
      key = stage[t];
      for (int j = 0; j < m; ++j) rnk += stage[j] < key;
    }
    group_sync<BQ>(group);
    if (t < m) stage[kGroup + rnk] = key;
    group_sync<BQ>(group);
    stage += kGroup;
  } else {
    // 1. more keys: a bitonic sort over the next power of two of m
    int width = 1;
    while (width < m) width <<= 1;
    for (int i = m + t; i < width; i += kGroup) stage[i] = kEmpty;
    group_sync<BQ>(group);
    for (int k = 2; k <= width; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < width; i += kGroup) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long a = stage[i], b = stage[ixj];
            if ((a > b) == ((i & k) == 0)) { stage[i] = b; stage[ixj] = a; }
          }
        }
        group_sync<BQ>(group);
      }
    }
  }
  // 2. each staged key lands at its rank among the staged keys plus the
  //    number of buffered keys ahead of it, read before the buffer moves
  int dest[BQ];
#pragma unroll
  for (int u = 0; u < BQ; ++u) {
    const int j = t + kGroup * u;
    dest[u] = (j < m) ? j + count_below(buf, len, stage[j]) : cbuf;
  }
  const unsigned long long first = stage[0];
  group_sync<BQ>(group);
  // 3. each buffered key moves up by the number of staged keys ahead of it.
  //    Rounds go from the top down: a key only moves up, so no round
  //    overwrites a key that a later (lower) round has still to read.  Keys
  //    ahead of every staged key stay put, so the walk stops at them.
  for (int top = len; top > 0 && buf[top - 1] > first; top -= kGroup) {
    const int i = top - kGroup + t;
    unsigned long long key = 0;
    int to = cbuf;
    if (i >= 0) {
      key = buf[i];
      to = i + count_below(stage, m, key);
    }
    group_sync<BQ>(group);
    if (to < cbuf && to != i) buf[to] = key;
    group_sync<BQ>(group);
  }
  // 4. the staged keys fill the gaps
#pragma unroll
  for (int u = 0; u < BQ; ++u)
    if (dest[u] < cbuf) buf[dest[u]] = stage[t + kGroup * u];
  group_sync<BQ>(group);
}

// Phase 1.  Grid (query blocks, P row ranges): the query blocks vary
// fastest, so the first wave holds the first ranges of every query block
// and later ranges start with a published threshold.  Writes partial[q, p,
// :cbuf], the sorted best cbuf keys of query q over row range p that pass
// the staging rule (kEmpty after them).
//
// Staging rule for a row of score s: s > the CTA's own cbuf-th buffered
// score (strict: rows are visited in increasing order inside a CTA, so a
// row that ties it has a higher id than every buffered row and cannot
// displace one), and ordered(s) >= thresholds[q] (not strict: a tie may have
// a lower id than the ties of the range that published it).
//
// Each chunk: the next chunk's code words are fetched into registers and
// this chunk's bias is read before the scan, so neither load's latency
// stands between two chunks; the words go to shared memory once the scan
// is done, before the merges.  At most 80 registers (three CTAs per SM).
template <int BQ, bool PACKED>
__global__ void __launch_bounds__(kThreads, 3)
lut16_topk_partial_kernel(const uint8_t* __restrict__ codes,
                          const float* __restrict__ lut,
                          const float* __restrict__ base,
                          long long base_qstride,
                          unsigned long long* __restrict__ partial,
                          uint32_t* __restrict__ thresholds,
                          long long n, int kc, int q, int kl,
                          int rows_per_cta, int cbuf) {
  static_assert(BQ <= kThreads / 32, "at least one warp per query");
  constexpr int kPrefetch = 32;   // code words a thread holds: kc <= 128
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* stage = buf + BQ * cbuf;
  float* lut_s = reinterpret_cast<float*>(stage + BQ * kThreads);
  uint32_t* codes_s = reinterpret_cast<uint32_t*>(lut_s + BQ * kl * kLutWidth);
  const int stride = code_stride(kc);
  int* len = reinterpret_cast<int*>(codes_s + kThreads * stride);
  int* count = len + BQ;
  float* own_t = reinterpret_cast<float*>(count + BQ);
  uint32_t* shared_t = reinterpret_cast<uint32_t*>(own_t + BQ);

  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x / (kThreads / BQ);   // the query it merges
  const int rank = threadIdx.x % (kThreads / BQ);
  // whole code words per row and few enough to prefetch: the fast path
  const int wpr = kc >> 2;
  const bool prefetch = (kc & 3) == 0 && wpr <= kPrefetch;
  load_lut<BQ>(lut, q, kl, q0, lut_s);
  if (threadIdx.x < BQ) {
    len[threadIdx.x] = 0;
    count[threadIdx.x] = 0;
    own_t[threadIdx.x] = -INFINITY;
    shared_t[threadIdx.x] = (q0 + (int)threadIdx.x < q)
                                ? load_relaxed(&thresholds[q0 + threadIdx.x])
                                : 0u;
  }
  const long long start = (long long)blockIdx.y * rows_per_cta;
  const long long end = min(n, start + rows_per_cta);
  if (start < end)
    load_codes(codes, kc, start, (int)min((long long)kThreads, end - start),
               codes_s);
  __syncthreads();
  for (long long row0 = start; row0 < end; row0 += kThreads) {
    const int rows = (int)min((long long)kThreads, end - row0);
    const int next_rows =
        (int)max(0ll, min((long long)kThreads, end - row0 - kThreads));
    const bool mine = (int)threadIdx.x < rows;
    const long long row = row0 + threadIdx.x;
    uint32_t published = 0;
    if (rank == 0 && q0 + group < q)
      published = load_relaxed(&thresholds[q0 + group]);
    uint32_t next[kPrefetch];
    if (prefetch && next_rows > 0) {
      const uint32_t* src32 = reinterpret_cast<const uint32_t*>(
          codes + (row0 + kThreads) * kc);
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int i = threadIdx.x + kThreads * u;
        if (u < wpr && i < next_rows * wpr) next[u] = src32[i];
      }
    }
    float bias[BQ], own[BQ];
    uint32_t shared[BQ];
#pragma unroll
    for (int qi = 0; qi < BQ; ++qi) {
      bias[qi] = (mine && q0 + qi < q)
                     ? base[(size_t)(q0 + qi) * base_qstride + row] : 0.f;
      own[qi] = own_t[qi];
      shared[qi] = shared_t[qi];
    }
    float acc[BQ];
    if (mine)
      score_row<BQ, PACKED>(codes_s + threadIdx.x * stride, kc, lut_s, kl, acc);
#pragma unroll
    for (int qi = 0; qi < BQ; ++qi) {
      float s = 0.f;
      bool take = false;
      if (mine && q0 + qi < q) {
        // bias after the full sum: base + (sum_k ...), as the
        // materialise-then-select path adds it
        s = bias[qi] + acc[qi];
        take = s > own[qi] && float_to_ordered(s) >= shared[qi];
      }
      // one shared atomic per warp and query
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, take);
      if (ballot) {
        int slot = 0;
        if (lane == 0) slot = atomicAdd(&count[qi], __popc(ballot));
        slot = __shfl_sync(0xFFFFFFFFu, slot, 0);
        if (take)
          stage[qi * kThreads + slot + __popc(ballot & ((1u << lane) - 1u))] =
              make_key(s, (uint32_t)row);
      }
    }
    __syncthreads();
    // the scan is done with this chunk's codes: store the next chunk's
    if (prefetch && next_rows > 0) {
      const int dr = kThreads / wpr, dw = kThreads - dr * wpr;
      int r = threadIdx.x / wpr, w = threadIdx.x - r * wpr;
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int i = threadIdx.x + kThreads * u;
        if (u < wpr && i < next_rows * wpr) codes_s[r * stride + w] = next[u];
        r += dr;
        w += dw;
        if (w >= wpr) { w -= wpr; ++r; }
      }
    } else if (next_rows > 0) {
      load_codes(codes, kc, row0 + kThreads, next_rows, codes_s);
    }
    // the threads of group qi merge query qi if it staged anything
    if (q0 + group < q) {
      const int m = count[group];
      if (m > 0) {
        unsigned long long* b = buf + group * cbuf;
        const int l = len[group];
        group_merge<BQ>(b, l, stage + group * kThreads, m, cbuf, group,
                        rank);
        const int nl = min(cbuf, l + m);
        if (rank == 0) {
          len[group] = nl;
          count[group] = 0;
          if (nl == cbuf) {
            // cbuf real keys of this query: their worst bounds the query's
            // cbuf-th best score from below, so every CTA may use it
            own_t[group] = key_score(b[cbuf - 1]);
            const uint32_t o = float_to_ordered(own_t[group]);
            if (o > shared_t[group]) atomicMax(&thresholds[q0 + group], o);
          }
        }
      }
      if (rank == 0) shared_t[group] = max(shared_t[group], published);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < BQ * cbuf; i += blockDim.x) {
    const int qi = i / cbuf;
    const int j = i - qi * cbuf;
    if (q0 + qi < q)
      partial[((size_t)(q0 + qi) * gridDim.y + blockIdx.y) * cbuf + j] =
          (j < len[qi]) ? buf[i] : kEmpty;
  }
}

// Phase 2, the cross-range reduction.  Grid (ceil(p_in / kMergeGroup), Q):
// CTA (g, q) merges lists [g * G, (g + 1) * G) of query q into the best cbuf
// keys.  A key whose score is below the query's final threshold cannot be in
// the result and is dropped before merging; each list is sorted, so what is
// left of it is a prefix.  With out_keys == nullptr it is the last round and
// decodes into (score, row), empty slots as (-inf, -1).
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const unsigned long long* __restrict__ in, int p_in,
                  const uint32_t* __restrict__ thresholds,
                  unsigned long long* __restrict__ out_keys,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int cbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* cur = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* nxt = cur + cbuf;
  unsigned long long* lst = nxt + cbuf;
  const int qrow = blockIdx.y;
  const int g0 = blockIdx.x * kMergeGroup;
  const int g1 = min(p_in, g0 + kMergeGroup);
  const int p_out = (p_in + kMergeGroup - 1) / kMergeGroup;
  // the largest key whose score is >= the threshold (every real key while
  // nothing was published)
  const unsigned long long limit =
      min(kEmpty - 1,
          ((unsigned long long)(~thresholds[qrow]) << 32) | 0xFFFFFFFFull);
  int len = 0;
  for (int p = g0; p < g1; ++p) {
    const unsigned long long* src = in + ((size_t)qrow * p_in + p) * cbuf;
    int m = 0;
    for (int b = 0; b < cbuf; b += kThreads) {
      const int i = b + threadIdx.x;
      bool keep = false;
      if (i < cbuf) {
        const unsigned long long key = src[i];
        lst[i] = key;
        keep = key <= limit;
      }
      m += __syncthreads_count(keep);
    }
    if (m == 0) continue;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int to = i + count_below(lst, m, cur[i]);
      if (to < cbuf) nxt[to] = cur[i];
    }
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const int to = j + count_below(cur, len, lst[j]);
      if (to < cbuf) nxt[to] = lst[j];
    }
    __syncthreads();
    unsigned long long* t = cur;
    cur = nxt;
    nxt = t;
    len = min(cbuf, len + m);
  }
  for (int i = threadIdx.x; i < cbuf; i += kThreads) {
    const unsigned long long key = (i < len) ? cur[i] : kEmpty;
    if (out_keys != nullptr) {
      out_keys[((size_t)qrow * p_out + blockIdx.x) * cbuf + i] = key;
    } else {
      const size_t o = (size_t)qrow * cbuf + i;
      out_s[o] = (key == kEmpty) ? -INFINITY : key_score(key);
      out_i[o] = (key == kEmpty) ? -1 : (int)(uint32_t)key;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

size_t adc_smem(int bq, int kc, int kl) {
  return (size_t)bq * kl * kLutWidth * sizeof(float) +
         (size_t)kThreads * code_stride(kc) * sizeof(uint32_t);
}

size_t topk_smem(int bq, int kc, int kl, int cbuf) {
  return (size_t)bq * (cbuf + kThreads) * sizeof(unsigned long long) +
         adc_smem(bq, kc, kl) + (size_t)bq * 4 * sizeof(uint32_t);
}

template <int BQ, bool PACKED>
int launch_adc(const uint8_t* codes, const float* lut, float* out, long long n,
               int kc, int q, int kl, int rows_per_cta, cudaStream_t stream) {
  const size_t smem = adc_smem(BQ, kc, kl);
  cudaError_t e = cudaFuncSetAttribute(lut16_adc_kernel<BQ, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + rows_per_cta - 1) / rows_per_cta),
                  (unsigned)((q + BQ - 1) / BQ));
  lut16_adc_kernel<BQ, PACKED><<<grid, kThreads, smem, stream>>>(
      codes, lut, out, n, kc, q, kl, rows_per_cta);
  return (int)cudaGetLastError();
}

template <int BQ, bool PACKED>
int launch_topk(const uint8_t* codes, const float* lut, const float* base,
                long long base_qstride, uint32_t* thresholds,
                unsigned long long* scratch_a, unsigned long long* scratch_b,
                float* out_s, int* out_i, long long n, int kc, int q, int kl,
                int rows_per_cta, int cbuf, cudaStream_t stream) {
  const size_t smem = topk_smem(BQ, kc, kl, cbuf);
  cudaError_t e = cudaFuncSetAttribute(lut16_topk_partial_kernel<BQ, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int p = (int)((n + rows_per_cta - 1) / rows_per_cta);
  const dim3 grid((unsigned)((q + BQ - 1) / BQ), (unsigned)p);
  lut16_topk_partial_kernel<BQ, PACKED><<<grid, kThreads, smem, stream>>>(
      codes, lut, base, base_qstride, scratch_a, thresholds, n, kc, q, kl,
      rows_per_cta, cbuf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t msmem = (size_t)3 * cbuf * sizeof(unsigned long long);
  unsigned long long* in = scratch_a;
  unsigned long long* other = scratch_b;
  while (true) {
    const int p_out = (p + kMergeGroup - 1) / kMergeGroup;
    const bool last = p_out == 1;
    topk_merge_kernel<<<dim3((unsigned)p_out, (unsigned)q), kThreads, msmem,
                        stream>>>(in, p, thresholds, last ? nullptr : other,
                                  out_s, out_i, cbuf);
    e = cudaGetLastError();
    if (e != cudaSuccess || last) return (int)e;
    unsigned long long* t = in;
    in = other;
    other = t;
    p = p_out;
  }
}

// CTAs of K2's partial kernel one SM holds at once, or a negative
// cudaError_t.
template <int BQ, bool PACKED>
int topk_ctas_per_sm(int kc, int kl, int cbuf) {
  const size_t smem = topk_smem(BQ, kc, kl, cbuf);
  cudaError_t e = cudaFuncSetAttribute(lut16_topk_partial_kernel<BQ, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, lut16_topk_partial_kernel<BQ, PACKED>, kThreads, smem);
  return (e != cudaSuccess) ? -(int)e : blocks;
}

}  // namespace

#define DISPATCH_BQ(FN, ...)                                              \
  switch (bq * 2 + (packed ? 1 : 0)) {                                    \
    case 2: return FN<1, false>(__VA_ARGS__);                             \
    case 3: return FN<1, true>(__VA_ARGS__);                              \
    case 4: return FN<2, false>(__VA_ARGS__);                             \
    case 5: return FN<2, true>(__VA_ARGS__);                              \
    case 8: return FN<4, false>(__VA_ARGS__);                             \
    case 9: return FN<4, true>(__VA_ARGS__);                              \
    case 16: return FN<8, false>(__VA_ARGS__);                            \
    case 17: return FN<8, true>(__VA_ARGS__);                             \
    default: return (int)cudaErrorInvalidValue;                          \
  }

// K2 serves at most 4 queries per CTA (kTopkMaxBq in kernels/ops.py).
#define DISPATCH_TOPK_BQ(FN, ...)                                         \
  switch (bq * 2 + (packed ? 1 : 0)) {                                    \
    case 2: return FN<1, false>(__VA_ARGS__);                             \
    case 3: return FN<1, true>(__VA_ARGS__);                              \
    case 4: return FN<2, false>(__VA_ARGS__);                             \
    case 5: return FN<2, true>(__VA_ARGS__);                              \
    case 8: return FN<4, false>(__VA_ARGS__);                             \
    case 9: return FN<4, true>(__VA_ARGS__);                              \
    default: return (int)cudaErrorInvalidValue;                          \
  }

extern "C" {

// K1.  codes (n, kc) u8; lut (q, kl, 16) f32 with kl == kc, or kl == 2*kc
// when packed; out (q, n) f32.  Returns the launch's cudaError_t.
int lut16_adc_launch(const void* codes, const void* lut, void* out,
                     long long n, int kc, int q, int kl, int packed, int bq,
                     int rows_per_cta, void* stream) {
  if (n == 0 || q == 0) return 0;
  DISPATCH_BQ(launch_adc, static_cast<const uint8_t*>(codes),
              static_cast<const float*>(lut), static_cast<float*>(out), n, kc,
              q, kl, rows_per_cta, static_cast<cudaStream_t>(stream))
}

// K2.  base (q, n) f32 with base_qstride == n, or (1, n) with 0.
// thresholds: q u32, zeroed.  Scratch: u64 keys, q * P * cbuf in scratch_a
// and q * ceil(P / 16) * cbuf in scratch_b, P = ceil(n / rows_per_cta).
// Output (q, cbuf) scores and row ids.
int lut16_topk_launch(const void* codes, const void* lut, const void* base,
                      long long base_qstride, void* thresholds,
                      void* scratch_a, void* scratch_b, void* out_s,
                      void* out_i, long long n, int kc, int q, int kl,
                      int packed, int bq, int rows_per_cta, int cbuf,
                      void* stream) {
  if (n == 0 || q == 0) return 0;
  DISPATCH_TOPK_BQ(launch_topk, static_cast<const uint8_t*>(codes),
                   static_cast<const float*>(lut),
                   static_cast<const float*>(base), base_qstride,
                   static_cast<uint32_t*>(thresholds),
                   static_cast<unsigned long long*>(scratch_a),
                   static_cast<unsigned long long*>(scratch_b),
                   static_cast<float*>(out_s), static_cast<int*>(out_i), n,
                   kc, q, kl, rows_per_cta, cbuf,
                   static_cast<cudaStream_t>(stream))
}

long long lut16_adc_smem_bytes(int bq, int kc, int kl) {
  return (long long)adc_smem(bq, kc, kl);
}

long long lut16_topk_smem_bytes(int bq, int kc, int kl, int cbuf) {
  return (long long)topk_smem(bq, kc, kl, cbuf);
}

// CTAs of K2's partial kernel per SM, or a negative cudaError_t.
int lut16_topk_ctas_per_sm(int bq, int packed, int kc, int kl, int cbuf) {
  DISPATCH_TOPK_BQ(topk_ctas_per_sm, kc, kl, cbuf)
}

const char* lut16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
