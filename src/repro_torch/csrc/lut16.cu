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
// shared-memory LUT lookup and one f32 add, Q*N*K of them; the code stream is
// only N*Kc bytes and is read once per query block.  At the pass-1 shapes
// (Q=128, K=100) the LUT reads, not HBM, are the limit: a warp's 32 rows
// look up at most 32 entries per shared-memory wavefront.  Both kernels keep
// a query block's whole LUT (bq x K x 16 f32) in shared memory, so each code
// byte fetched from HBM feeds bq lookups, in a query-interleaved image that
// one LDS.64 reads for 2 queries, with one address per (row, subspace) for
// all bq queries, and unroll whole code words in the per-row sum.  K1
// writes the (Q, N) matrix; it takes 16 queries per CTA, copies each chunk's
// codes with cp.async into a second buffer while the first is scanned, and
// its chunk (a row a thread) is as wide as the shared memory allows.  K2
// never writes the matrix; its selection must cost little beside the scan
// and must not take the scan's occupancy:
//
// - Shared memory: 4 queries per CTA, one sorted buffer of cbuf keys and one
//   chunk (256 keys) of staging per query; at K = 100, cbuf = 512 that is
//   75,840 B, and at most 80 registers, so three CTAs (24 warps) fit on an
//   SM.  Only queries that staged anything merge, each by the
//   256 / bq threads that own it (a named barrier per query): the staged
//   keys are ordered (a count of ranks when there are few, else a bitonic
//   sort), then every key goes straight to its rank in the merged list
//   (binary searches, no sorting network over the buffer).  Rows are
//   staged with one shared atomic per warp and query (ballot + popc).
// - Latency: each chunk's bias and the next chunk's code words (into
//   registers) are loaded before the scan and the words stored after it, so
//   no HBM round trip stands between two chunks; the copy of codes into
//   shared memory divides once per thread, not per word.
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
// Wide K (the reference walks K in blocks on its grid, so it takes any K):
// where a query block's whole LUT image leaves K1 fewer than 8 warps an SM,
// or does not fit K2 beside its buffers (K of the PQ LM head, d/2 = 1792 to
// 4096), the kernels' wide variants stage the image and the codes in
// chunks of cw code bytes' subspaces.  K1 walks its row range once per
// chunk and carries each (query, row) partial sum in `out`; K2 takes each
// 256-row chunk's sum chunk by chunk in registers before it selects.
// Shapes whose image fits as before keep the kernels and plans above.
//
// Exactness rules: f32 accumulation in subspace order k = 0..K-1 (shared by
// K1 and K2 through add_row, so fused and materialised pass 1 agree bit for
// bit, chunked or not), no fast-math, no tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // K2's rows per chunk (a row a thread), merge threads
constexpr int kLutWidth = 16;   // LUT entries per subspace (4-bit codes)
constexpr unsigned long long kEmpty = ~0ull;   // sorts after every real key

__host__ __device__ inline int code_words(int kc) { return (kc + 3) / 4; }

// Shared-memory row stride, in 32-bit words, of codes staged one row to a
// word-aligned slot (K2's staging; K1's when kc % 4 == 0).  Odd, so that
// thread t reading word w of its own row hits bank (t*stride + w) % 32: the
// 32 rows of a warp fall on 32 different banks.
__host__ __device__ inline int code_stride(int kc) { return code_words(kc) | 1; }

// ---------------------------------------------------------------------------
// The scan shared by K1 and K2.
//
// The LUT image in shared memory is query-interleaved: subspace-major, then
// the BQ / QV query groups, then the 16 codes, then the QV queries of a group.
// A thread looking up code c of subspace k reads the QV = 2 queries' entries
// of a group with one LDS.64, and the 16 entries a warp can ask for lie in
// one 128-byte span, two on every bank pair, so it never conflicts.  The
// card serves a warp's LDS.64 in two wavefronts (a half-warp each), so the
// rate stays at 32 lookups per wavefront, as with one LDS.32 per lookup, but
// with half the load instructions.  At QV = 4 (LDS.128, a quarter-warp per
// wavefront) the 8 threads of a phase pick among 16 entries on 8 bank
// groups and conflict: K1 ran 1.6x slower (tools/lut16_probe.py).
// ---------------------------------------------------------------------------

constexpr int kQueryVec = 2;   // queries per shared LUT load (LDS.64)

template <int BQ>
__host__ __device__ constexpr int query_vec() {
  return BQ < kQueryVec ? BQ : kQueryVec;
}

// Float index of LUT entry (query qi, subspace k, code c) in the image.
template <int BQ, int QV>
__host__ __device__ inline int lut_image_index(int qi, int k, int c) {
  return ((k * (BQ / QV) + qi / QV) * kLutWidth + c) * QV + qi % QV;
}

// Copy subspaces [k0, k0 + kl) of the LUTs of queries [q0, q0 + BQ) into
// the image (kl_src: the LUT's subspaces a query; the whole LUT is k0 = 0,
// kl = kl_src); queries past the end read as zeros (their sums are computed
// and never stored).  The reads follow the LUT's own (query, k, code) order,
// so they coalesce.
template <int BQ, int QV>
__device__ void load_lut(const float* __restrict__ lut, int q, int kl_src,
                         int k0, int kl, int q0, float* lut_s) {
  const int per_q = kl * kLutWidth;
  for (int i = threadIdx.x; i < BQ * per_q; i += blockDim.x) {
    const int qi = i / per_q;
    const int kcode = i - qi * per_q;   // k * 16 + code
    lut_s[lut_image_index<BQ, QV>(qi, kcode / kLutWidth, kcode % kLutWidth)] =
        (q0 + qi < q)
            ? lut[((size_t)(q0 + qi) * kl_src + k0) * kLutWidth + kcode]
            : 0.f;
  }
}

template <int QV>
__device__ __forceinline__ void add_vec(float* acc, const float* p) {
  if constexpr (QV == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
  } else if constexpr (QV == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    acc[0] += v.x; acc[1] += v.y;
  } else {
    acc[0] += *p;
  }
}

// acc[qi] += lut[qi, k, code & 15] for the BQ queries; lut_k is subspace
// k's part of the image.  One address for all BQ queries; the query groups
// are immediate offsets from it.
template <int BQ, int QV>
__device__ __forceinline__ void add_code(float (&acc)[BQ], const float* lut_k,
                                         uint32_t code) {
  const float* p = lut_k + (code & (kLutWidth - 1)) * QV;
#pragma unroll
  for (int g = 0; g < BQ / QV; ++g)
    add_vec<QV>(&acc[g * QV], p + g * kLutWidth * QV);
}

// The subspaces of code byte `byte` (bits above the byte are ignored): one,
// or two when packed (low nibble first).
template <int BQ, int QV, bool PACKED>
__device__ __forceinline__ void add_byte(float (&acc)[BQ], const float* lut_b,
                                         uint32_t byte) {
  add_code<BQ, QV>(acc, lut_b, byte);
  if (PACKED) add_code<BQ, QV>(acc, lut_b + kLutWidth * BQ, byte >> 4);
}

// The code words of one staged row, in order, when the row starts on a word.
struct AlignedWords {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t next() { return *p++; }
};

// The code words of a row that starts at any byte (K1's bytes staged back to
// back, kc % 4 != 0): each is funnel-shifted out of two aligned words, so a
// row costs one shared load more than it has words, and the last may read
// the word after the row (the staging buffer is padded for it).
struct ShiftedWords {
  const uint32_t* p;
  uint32_t lo;
  uint32_t shift;
  __device__ __forceinline__ ShiftedWords(const unsigned char* base, int byte0)
      : p(reinterpret_cast<const uint32_t*>(base) + (byte0 >> 2) + 1),
        lo(p[-1]), shift(8u * (byte0 & 3)) {}
  __device__ __forceinline__ uint32_t next() {
    const uint32_t hi = *p++;
    const uint32_t w = __funnelshift_r(lo, hi, shift);
    lo = hi;
    return w;
  }
};

// acc[qi] += lut[qi, k, code(row, k)] over the kc code bytes of one row, one
// add per subspace in subspace order (packed: the low nibble of byte j is
// subspace 2j).  Whole code words are unrolled with no test per byte; only
// the last partial word (kc % 4 bytes) is bounded.
template <int BQ, int QV, bool PACKED, class Words>
__device__ __forceinline__ void add_row(Words words, int kc,
                                        const float* lut_s,
                                        float (&acc)[BQ]) {
  constexpr int kByte = (PACKED ? 2 : 1) * kLutWidth * BQ;   // floats a byte
  const float* lut_w = lut_s;
  const int whole = kc >> 2;
  for (int w = 0; w < whole; ++w, lut_w += 4 * kByte) {
    const uint32_t word = words.next();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      add_byte<BQ, QV, PACKED>(acc, lut_w + j * kByte, word >> (8 * j));
  }
  const int tail = kc & 3;
  if (tail) {
    const uint32_t word = words.next();
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < tail)
        add_byte<BQ, QV, PACKED>(acc, lut_w + j * kByte, word >> (8 * j));
  }
}

// The per-row sum shared by K1 and K2: acc[qi] = sum over subspaces k in
// order 0..K-1 of lut[qi, k, code(row, k)], starting from +0.  The kernels'
// wide variants take the same sum a chunk of subspaces at a time, the
// partial sum carried from one chunk to the next, so every variant adds
// the same terms in the same order.
template <int BQ, int QV, bool PACKED, class Words>
__device__ __forceinline__ void score_row(Words words, int kc,
                                          const float* lut_s,
                                          float (&acc)[BQ]) {
#pragma unroll
  for (int qi = 0; qi < BQ; ++qi) acc[qi] = 0.f;
  add_row<BQ, QV, PACKED>(words, kc, lut_s, acc);
}

// ---------------------------------------------------------------------------
// K1: materialised scan.  Grid (row ranges, query blocks); each CTA loads its
// query block's LUT image once and walks its row range in chunks of
// blockDim.x rows, one row a thread.  Chunk i + 1's codes are copied with
// cp.async into the other of two buffers while chunk i is scanned, so a
// chunk never waits for HBM, and one barrier per chunk suffices.  The
// planner (kernels/lut16.py:plan_adc) sizes blockDim.x for the most
// resident warps the shared memory allows (20 at K = 100, bq = 16).
// ---------------------------------------------------------------------------

constexpr int kMaxAdcThreads = 1024;

__host__ __device__ inline size_t adc_lut_bytes(int bq, int kl) {
  return (size_t)bq * kl * kLutWidth * sizeof(float);
}

// One chunk's staging buffer: kc % 4 == 0, rows in slots of code_stride(kc)
// words; else the chunk's bytes back to back, rounded up to 16 bytes, plus
// the 16 bytes a row's last funnel shift may read.
__host__ __device__ inline size_t adc_stage_bytes(int kc, int threads) {
  if ((kc & 3) == 0)
    return (size_t)threads * code_stride(kc) * sizeof(uint32_t);
  return ((size_t)threads * kc + 15) / 16 * 16 + 16;
}

// K1's dynamic shared memory.  cw >= kc: one chunk, the whole LUT image and
// two buffers of whole rows.  cw < kc (the wide variant): the image of cw
// code bytes' subspaces (cw * kl / kc of them) and two buffers of
// word-aligned slots of cw bytes.
__host__ __device__ inline size_t adc_smem(int bq, int kc, int kl,
                                           int threads, int cw) {
  if (cw >= kc)
    return adc_lut_bytes(bq, kl) + 2 * adc_stage_bytes(kc, threads);
  return adc_lut_bytes(bq, cw * (kl / kc)) +
         2 * (size_t)threads * code_stride(cw) * sizeof(uint32_t);
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               : : "r"(shared_addr(dst)), "l"(__cvta_generic_to_global(src))
               : "memory");
}

// 16 bytes, of which the first src_bytes are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               : : "r"(shared_addr(dst)), "l"(__cvta_generic_to_global(src)),
                 "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" : : : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" : : : "memory");
}

// Start the copy of rows [row0, row0 + rows) into a staging buffer (see
// adc_stage_bytes).  kc % 4 == 0: word by word, each thread stepping its
// (row, word) by a fixed amount, so the copy divides once.  Else 16-byte
// pieces: the chunk starts 16-byte aligned (row0 is a multiple of 32 rows
// and the codes are 16-byte aligned), and the last piece is zero-filled
// past the end of the codes.
__device__ void stage_codes(const uint8_t* __restrict__ codes, int kc,
                            long long row0, int rows, unsigned char* dst) {
  if ((kc & 3) == 0) {
    const int wpr = kc >> 2;
    const int stride = code_stride(kc);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(codes + row0 * kc);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    const int total = rows * wpr;
    const int dr = blockDim.x / wpr, dw = blockDim.x - dr * wpr;
    int r = threadIdx.x / wpr, w = threadIdx.x - r * wpr;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      cp_async4(d + r * stride + w, src + i);
      r += dr;
      w += dw;
      if (w >= wpr) { w -= wpr; ++r; }
    }
    return;
  }
  const uint8_t* src = codes + row0 * kc;
  const int nbytes = rows * kc;
  for (int i = 16 * threadIdx.x; i < nbytes; i += 16 * blockDim.x)
    cp_async16(dst + i, src + i, min(16, nbytes - i));
}

// The wide variants' copy: bytes [c0, c0 + cb) of rows [row0, row0 + rows)
// into slots of code_stride(cb) words, a row's piece from the slot's first
// byte.  When every piece starts on a word (kc % 4 == 0 and c0 % 4 == 0,
// so cb % 4 == 0 too) the words go by cp.async, each thread stepping its
// (row, word) by a fixed amount; else byte by byte, synchronously (the
// codes of odd kc, off every timed path).  `codes` must be 4-byte aligned.
__device__ void stage_chunk(const uint8_t* __restrict__ codes, int kc, int c0,
                            int cb, long long row0, int rows, uint32_t* dst) {
  const int stride = code_stride(cb);
  if (((kc | c0) & 3) == 0) {
    const int wpr = cb >> 2;
    const int pitch = kc >> 2;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(codes + row0 * kc + c0);
    const int total = rows * wpr;
    const int dr = blockDim.x / wpr, dw = blockDim.x - dr * wpr;
    int r = threadIdx.x / wpr, w = threadIdx.x - r * wpr;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      cp_async4(dst + r * stride + w, src + (size_t)r * pitch + w);
      r += dr;
      w += dw;
      if (w >= wpr) { w -= wpr; ++r; }
    }
    return;
  }
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  const uint8_t* src = codes + row0 * kc + c0;
  const int total = rows * cb;
  const int dr = blockDim.x / cb, dc = blockDim.x - dr * cb;
  int r = threadIdx.x / cb, c = threadIdx.x - r * cb;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    d[r * 4 * stride + c] = src[(size_t)r * kc + c];
    r += dr;
    c += dc;
    if (c >= cb) { c -= cb; ++r; }
  }
}

template <int BQ, int QV, bool PACKED, bool ALIGNED>
__device__ __forceinline__ void adc_scan(const uint8_t* __restrict__ codes,
                                         float* __restrict__ out, long long n,
                                         int kc, int q, int q0,
                                         long long start, long long end,
                                         const float* lut_s,
                                         unsigned char* stage0) {
  const int chunk = blockDim.x;
  const size_t stage_bytes = adc_stage_bytes(kc, chunk);
  const int stride = code_stride(kc);
  int buf = 0;
  for (long long row0 = start; row0 < end; row0 += chunk, buf ^= 1) {
    // this chunk's codes (and, the first time, the LUT image) are visible
    // to all threads, and every thread is done with the other buffer
    cp_async_wait_all();
    __syncthreads();
    const long long next = row0 + chunk;
    if (next < end)
      stage_codes(codes, kc, next, (int)min((long long)chunk, end - next),
                  stage0 + (buf ^ 1) * stage_bytes);
    cp_async_commit();
    const int rows = (int)min((long long)chunk, end - row0);
    if ((int)threadIdx.x >= rows) continue;
    const unsigned char* cur = stage0 + buf * stage_bytes;
    float acc[BQ];
    if constexpr (ALIGNED)
      score_row<BQ, QV, PACKED>(
          AlignedWords{reinterpret_cast<const uint32_t*>(cur) +
                       threadIdx.x * stride}, kc, lut_s, acc);
    else
      score_row<BQ, QV, PACKED>(ShiftedWords(cur, threadIdx.x * kc), kc,
                                lut_s, acc);
    const long long row = row0 + threadIdx.x;
#pragma unroll
    for (int qi = 0; qi < BQ; ++qi)
      if (q0 + qi < q) out[(size_t)(q0 + qi) * n + row] = acc[qi];
  }
}

template <int BQ, bool PACKED, int QV = query_vec<BQ>()>
__global__ void __launch_bounds__(kMaxAdcThreads, 1)
lut16_adc_kernel(const uint8_t* __restrict__ codes,
                 const float* __restrict__ lut, float* __restrict__ out,
                 long long n, int kc, int q, int kl, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);
  unsigned char* stage0 = smem + adc_lut_bytes(BQ, kl);
  const int q0 = blockIdx.y * BQ;
  const long long start = (long long)blockIdx.x * rows_per_cta;
  const long long end = min(n, start + rows_per_cta);
  // the first chunk's copy runs while the LUT image is built
  if (start < end)
    stage_codes(codes, kc, start, (int)min((long long)blockDim.x, end - start),
                stage0);
  cp_async_commit();
  load_lut<BQ, QV>(lut, q, kl, 0, kl, q0, lut_s);
  if ((kc & 3) == 0)
    adc_scan<BQ, QV, PACKED, true>(codes, out, n, kc, q, q0, start, end,
                                   lut_s, stage0);
  else
    adc_scan<BQ, QV, PACKED, false>(codes, out, n, kc, q, q0, start, end,
                                    lut_s, stage0);
}

// K1's wide variant, for a K whose LUT image leaves too few warps on an SM
// (or does not fit): the same grid, and the same walk of a CTA's rows, once
// per chunk of cw code bytes (cw * kl / kc subspaces), chunk by chunk.  A
// chunk's LUT image is loaded once a CTA; its codes go through the two
// buffers as in lut16_adc_kernel.  The (query, row) partial sum lives in
// `out` between chunks: the thread that owns the cell reads it back
// (+0 before the first chunk) and adds the chunk's subspaces in order, so
// the sum is score_row's, add for add.  The CTA's slice of `out` is
// re-read from L2 (at the head's shapes a range's slice is ~150 KB).
template <int BQ, bool PACKED, int QV = query_vec<BQ>()>
__global__ void __launch_bounds__(kMaxAdcThreads, 1)
lut16_adc_wide_kernel(const uint8_t* __restrict__ codes,
                      const float* __restrict__ lut, float* __restrict__ out,
                      long long n, int kc, int q, int kl, int rows_per_cta,
                      int cw) {
  constexpr int kSpb = PACKED ? 2 : 1;   // subspaces a code byte
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);
  uint32_t* stage0 =
      reinterpret_cast<uint32_t*>(smem + adc_lut_bytes(BQ, cw * kSpb));
  const int chunk = blockDim.x;
  const int stage_words = chunk * code_stride(cw);
  const int q0 = blockIdx.y * BQ;
  const long long start = (long long)blockIdx.x * rows_per_cta;
  const long long end = min(n, start + rows_per_cta);
  if (start >= end) return;
  for (int c0 = 0; c0 < kc; c0 += cw) {
    const int cb = min(cw, kc - c0);
    const int stride = code_stride(cb);
    // every thread is done with the last chunk's image and buffers
    __syncthreads();
    stage_chunk(codes, kc, c0, cb, start, (int)min((long long)chunk,
                                                   end - start), stage0);
    cp_async_commit();
    load_lut<BQ, QV>(lut, q, kl, c0 * kSpb, cb * kSpb, q0, lut_s);
    int buf = 0;
    for (long long row0 = start; row0 < end; row0 += chunk, buf ^= 1) {
      cp_async_wait_all();
      __syncthreads();
      const long long next = row0 + chunk;
      if (next < end)
        stage_chunk(codes, kc, c0, cb, next,
                    (int)min((long long)chunk, end - next),
                    stage0 + (buf ^ 1) * stage_words);
      cp_async_commit();
      const int rows = (int)min((long long)chunk, end - row0);
      if ((int)threadIdx.x >= rows) continue;
      const long long row = row0 + threadIdx.x;
      float acc[BQ];
#pragma unroll
      for (int qi = 0; qi < BQ; ++qi)
        acc[qi] = (c0 > 0 && q0 + qi < q) ? out[(size_t)(q0 + qi) * n + row]
                                          : 0.f;
      add_row<BQ, QV, PACKED>(
          AlignedWords{stage0 + buf * stage_words + threadIdx.x * stride}, cb,
          lut_s, acc);
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

// K2's copy: stage the code bytes of rows [row0, row0 + rows) into shared
// memory, one row per `code_stride(kc)` words.  The rows are contiguous in HBM, so the
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
//
// WIDE (a K whose LUT image does not fit beside the buffers): the image and
// the code slots hold cw code bytes' subspaces; each 256-row chunk's sum is
// taken chunk of subspaces by chunk (the LUT chunk re-read from L2, the
// chunk's code bytes staged), the partial sum in registers, so the score
// is score_row's, add for add, before the bias and the selection.
template <int BQ, bool PACKED, bool WIDE, int QV = query_vec<BQ>()>
__global__ void __launch_bounds__(kThreads, 3)
lut16_topk_partial_kernel(const uint8_t* __restrict__ codes,
                          const float* __restrict__ lut,
                          const float* __restrict__ base,
                          long long base_qstride,
                          unsigned long long* __restrict__ partial,
                          uint32_t* __restrict__ thresholds,
                          long long n, int kc, int q, int kl,
                          int rows_per_cta, int cbuf, int cw) {
  static_assert(BQ <= kThreads / 32, "at least one warp per query");
  constexpr int kPrefetch = 32;   // code words a thread holds: kc <= 128
  constexpr int kSpb = PACKED ? 2 : 1;   // subspaces a code byte
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* stage = buf + BQ * cbuf;
  float* lut_s = reinterpret_cast<float*>(stage + BQ * kThreads);
  uint32_t* codes_s = reinterpret_cast<uint32_t*>(
      lut_s + BQ * (WIDE ? cw * kSpb : kl) * kLutWidth);
  const int stride = code_stride(WIDE ? cw : kc);
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
  const bool prefetch = !WIDE && (kc & 3) == 0 && wpr <= kPrefetch;
  if constexpr (!WIDE) load_lut<BQ, QV>(lut, q, kl, 0, kl, q0, lut_s);
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
  if (!WIDE && start < end)
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
    if constexpr (WIDE) {
#pragma unroll
      for (int qi = 0; qi < BQ; ++qi) acc[qi] = 0.f;
      for (int c0 = 0; c0 < kc; c0 += cw) {
        const int cb = min(cw, kc - c0);
        // the last chunk's image and codes are read (the first chunk: the
        // merges of the 256 rows before are done)
        if (c0 > 0) __syncthreads();
        stage_chunk(codes, kc, c0, cb, row0, rows, codes_s);
        cp_async_commit();
        load_lut<BQ, QV>(lut, q, kl, c0 * kSpb, cb * kSpb, q0, lut_s);
        cp_async_wait_all();
        __syncthreads();
        if (mine)
          add_row<BQ, QV, PACKED>(
              AlignedWords{codes_s + threadIdx.x * code_stride(cb)}, cb,
              lut_s, acc);
      }
    } else if (mine) {
      score_row<BQ, QV, PACKED>(AlignedWords{codes_s + threadIdx.x * stride},
                                kc, lut_s, acc);
    }
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
    } else if (!WIDE && next_rows > 0) {
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

// K2's partial kernel's dynamic shared memory; cw < kc: the wide variant
// (an image of cw code bytes' subspaces, slots of cw bytes).
size_t topk_smem(int bq, int kc, int kl, int cbuf, int cw) {
  const bool wide = cw < kc;
  return (size_t)bq * (cbuf + kThreads) * sizeof(unsigned long long) +
         adc_lut_bytes(bq, wide ? cw * (kl / kc) : kl) +
         (size_t)kThreads * code_stride(wide ? cw : kc) * sizeof(uint32_t) +
         (size_t)bq * 4 * sizeof(uint32_t);
}

// cw: code bytes a chunk of subspaces (a multiple of 4); cw >= kc is one
// chunk, today's kernels, anything below takes the wide variants.
inline bool valid_chunk(int kc, int cw) { return cw >= kc || (cw > 0 && cw % 4 == 0); }

template <int BQ, bool PACKED, int QV = query_vec<BQ>()>
void* adc_kernel(bool wide) {
  return wide ? (void*)lut16_adc_wide_kernel<BQ, PACKED, QV>
              : (void*)lut16_adc_kernel<BQ, PACKED, QV>;
}

// K1 at `threads` rows per chunk (a multiple of 32, at most 1024),
// rows_per_cta a multiple of it and cw code bytes a chunk of subspaces;
// anything else is refused.
template <int BQ, bool PACKED, int QV = query_vec<BQ>()>
int launch_adc(const uint8_t* codes, const float* lut, float* out, long long n,
               int kc, int q, int kl, int threads, int rows_per_cta, int cw,
               cudaStream_t stream) {
  if (threads <= 0 || threads % 32 || threads > kMaxAdcThreads ||
      rows_per_cta <= 0 || rows_per_cta % threads || !valid_chunk(kc, cw))
    return (int)cudaErrorInvalidValue;
  const bool wide = cw < kc;
  const size_t smem = adc_smem(BQ, kc, kl, threads, cw);
  cudaError_t e = cudaFuncSetAttribute(adc_kernel<BQ, PACKED, QV>(wide),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + rows_per_cta - 1) / rows_per_cta),
                  (unsigned)((q + BQ - 1) / BQ));
  if (wide)
    lut16_adc_wide_kernel<BQ, PACKED, QV><<<grid, threads, smem, stream>>>(
        codes, lut, out, n, kc, q, kl, rows_per_cta, cw);
  else
    lut16_adc_kernel<BQ, PACKED, QV><<<grid, threads, smem, stream>>>(
        codes, lut, out, n, kc, q, kl, rows_per_cta);
  return (int)cudaGetLastError();
}

// CTAs of K1 one SM holds at once, or a negative cudaError_t.
template <int BQ, bool PACKED>
int adc_ctas_per_sm(int kc, int kl, int threads, int cw) {
  if (!valid_chunk(kc, cw)) return -(int)cudaErrorInvalidValue;
  const size_t smem = adc_smem(BQ, kc, kl, threads, cw);
  const void* fn = adc_kernel<BQ, PACKED>(cw < kc);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    smem);
  return (e != cudaSuccess) ? -(int)e : blocks;
}

template <int BQ, bool PACKED, int QV = query_vec<BQ>()>
void* topk_kernel(bool wide) {
  return wide ? (void*)lut16_topk_partial_kernel<BQ, PACKED, true, QV>
              : (void*)lut16_topk_partial_kernel<BQ, PACKED, false, QV>;
}

template <int BQ, bool PACKED, int QV = query_vec<BQ>()>
int launch_topk(const uint8_t* codes, const float* lut, const float* base,
                long long base_qstride, uint32_t* thresholds,
                unsigned long long* scratch_a, unsigned long long* scratch_b,
                float* out_s, int* out_i, long long n, int kc, int q, int kl,
                int rows_per_cta, int cbuf, int cw, cudaStream_t stream) {
  if (!valid_chunk(kc, cw)) return (int)cudaErrorInvalidValue;
  const bool wide = cw < kc;
  const size_t smem = topk_smem(BQ, kc, kl, cbuf, cw);
  cudaError_t e = cudaFuncSetAttribute(topk_kernel<BQ, PACKED, QV>(wide),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int p = (int)((n + rows_per_cta - 1) / rows_per_cta);
  const dim3 grid((unsigned)((q + BQ - 1) / BQ), (unsigned)p);
  if (wide)
    lut16_topk_partial_kernel<BQ, PACKED, true, QV><<<grid, kThreads, smem,
                                                      stream>>>(
        codes, lut, base, base_qstride, scratch_a, thresholds, n, kc, q, kl,
        rows_per_cta, cbuf, cw);
  else
    lut16_topk_partial_kernel<BQ, PACKED, false, QV><<<grid, kThreads, smem,
                                                       stream>>>(
        codes, lut, base, base_qstride, scratch_a, thresholds, n, kc, q, kl,
        rows_per_cta, cbuf, cw);
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
int topk_ctas_per_sm(int kc, int kl, int cbuf, int cw) {
  if (!valid_chunk(kc, cw)) return -(int)cudaErrorInvalidValue;
  const size_t smem = topk_smem(BQ, kc, kl, cbuf, cw);
  const void* fn = topk_kernel<BQ, PACKED>(cw < kc);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    smem);
  return (e != cudaSuccess) ? -(int)e : blocks;
}

}  // namespace

// K1 serves up to 16 queries per CTA, 8 on packed codes (MAX_ADC_BQ in
// kernels/lut16.py).
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
    case 32: return FN<16, false>(__VA_ARGS__);                           \
    default: return (int)cudaErrorInvalidValue;                          \
  }

// K2 serves at most 4 queries per CTA (TOPK_MAX_BQ in kernels/lut16.py).
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

// K1.  codes (n, kc) u8, 16-byte aligned; lut (q, kl, 16) f32 with
// kl == kc, or kl == 2*kc when packed; out (q, n) f32; cw code bytes a chunk
// of subspaces (>= kc: one chunk).  Returns the launch's cudaError_t.
int lut16_adc_launch(const void* codes, const void* lut, void* out,
                     long long n, int kc, int q, int kl, int packed, int bq,
                     int threads, int rows_per_cta, int cw, void* stream) {
  if (n == 0 || q == 0) return 0;
  DISPATCH_BQ(launch_adc, static_cast<const uint8_t*>(codes),
              static_cast<const float*>(lut), static_cast<float*>(out), n, kc,
              q, kl, threads, rows_per_cta, cw,
              static_cast<cudaStream_t>(stream))
}

// K2.  base (q, n) f32 with base_qstride == n, or (1, n) with 0.
// thresholds: q u32, zeroed.  Scratch: u64 keys, q * P * cbuf in scratch_a
// and q * ceil(P / 16) * cbuf in scratch_b, P = ceil(n / rows_per_cta).
// Output (q, cbuf) scores and row ids.  cw as for K1.
int lut16_topk_launch(const void* codes, const void* lut, const void* base,
                      long long base_qstride, void* thresholds,
                      void* scratch_a, void* scratch_b, void* out_s,
                      void* out_i, long long n, int kc, int q, int kl,
                      int packed, int bq, int rows_per_cta, int cbuf, int cw,
                      void* stream) {
  if (n == 0 || q == 0) return 0;
  DISPATCH_TOPK_BQ(launch_topk, static_cast<const uint8_t*>(codes),
                   static_cast<const float*>(lut),
                   static_cast<const float*>(base), base_qstride,
                   static_cast<uint32_t*>(thresholds),
                   static_cast<unsigned long long*>(scratch_a),
                   static_cast<unsigned long long*>(scratch_b),
                   static_cast<float*>(out_s), static_cast<int*>(out_i), n,
                   kc, q, kl, rows_per_cta, cbuf, cw,
                   static_cast<cudaStream_t>(stream))
}

long long lut16_adc_smem_bytes(int bq, int kc, int kl, int threads,
                               int cw) {
  return (long long)adc_smem(bq, kc, kl, threads, cw);
}

// CTAs of K1 per SM, or a negative cudaError_t.
int lut16_adc_ctas_per_sm(int bq, int packed, int kc, int kl, int threads,
                          int cw) {
  DISPATCH_BQ(adc_ctas_per_sm, kc, kl, threads, cw)
}

long long lut16_topk_smem_bytes(int bq, int kc, int kl, int cbuf, int cw) {
  return (long long)topk_smem(bq, kc, kl, cbuf, cw);
}

// CTAs of K2's partial kernel per SM, or a negative cudaError_t.
int lut16_topk_ctas_per_sm(int bq, int packed, int kc, int kl, int cbuf,
                           int cw) {
  DISPATCH_TOPK_BQ(topk_ctas_per_sm, kc, kl, cbuf, cw)
}

const char* lut16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
