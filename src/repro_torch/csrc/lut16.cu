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
// writes the (Q, N) matrix; K2 never does: each CTA keeps a sorted candidate
// buffer per query in shared memory and writes only its top `cbuf`, and a
// merge kernel reduces those partial lists pairwise.
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
// `codes` must be 4-byte aligned and row0 * kc a multiple of 4.
__device__ void load_codes(const uint8_t* __restrict__ codes, int kc,
                           long long row0, int rows, uint32_t* codes_s) {
  const int stride_bytes = 4 * code_stride(kc);
  const long long nbytes = (long long)rows * kc;
  const uint8_t* src = codes + row0 * kc;
  uint8_t* dst = reinterpret_cast<uint8_t*>(codes_s);
  const long long nwords = nbytes / 4;
  const uint32_t* src32 = reinterpret_cast<const uint32_t*>(src);
  for (long long w = threadIdx.x; w < nwords; w += blockDim.x) {
    const uint32_t word = src32[w];
    long long b = 4 * w;
    int r = (int)(b / kc);
    int c = (int)(b - (long long)r * kc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[r * stride_bytes + c] = (uint8_t)(word >> (8 * j));
      if (++c == kc) { c = 0; ++r; }
    }
  }
  for (long long b = 4 * nwords + threadIdx.x; b < nbytes; b += blockDim.x) {
    const int r = (int)(b / kc);
    const int c = (int)(b - (long long)r * kc);
    dst[r * stride_bytes + c] = src[b];
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
// descending, then row ascending.  Empty slots hold kEmpty.
// ---------------------------------------------------------------------------

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

// Sort each of the total/len segments of `keys` ascending (len a power of
// two); every thread of the block takes part.
__device__ void bitonic_sort_segments(unsigned long long* keys, int total,
                                      int len) {
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = ((i & (len - 1)) & k) == 0;
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == up) { keys[i] = b; keys[ixj] = a; }
        }
      }
      __syncthreads();
    }
  }
}

// Per query: buffer = keys[0, half) (sorted; the first cbuf are the
// candidates), staging = keys[half, 2*half) (count[qi] filled slots).
// Sorts buffer and staging together, empties the staging half and sets the
// threshold to the cbuf-th best score (-inf while fewer than cbuf are held).
template <int BQ>
__device__ void merge_staging(unsigned long long* keys, int half, int cbuf,
                              float* thresh, int* count) {
  const int len = 2 * half;
  for (int i = threadIdx.x; i < BQ * half; i += blockDim.x) {
    const int qi = i / half;
    const int j = i - qi * half;
    if (j >= count[qi]) keys[qi * len + half + j] = kEmpty;
  }
  __syncthreads();
  bitonic_sort_segments(keys, BQ * len, len);
  for (int i = threadIdx.x; i < BQ * half; i += blockDim.x) {
    const int qi = i / half;
    keys[qi * len + half + (i - qi * half)] = kEmpty;
  }
  if (threadIdx.x < BQ) {
    const unsigned long long last = keys[threadIdx.x * len + cbuf - 1];
    thresh[threadIdx.x] = (last == kEmpty) ? -INFINITY : key_score(last);
    count[threadIdx.x] = 0;
  }
  __syncthreads();
}

// Phase 1.  Grid (P row ranges, query blocks).  Writes partial[q, p, :cbuf],
// the sorted top cbuf keys of query q over row range p.
//
// A row enters the staging area only if its score is STRICTLY above the
// current threshold.  Rows are visited in increasing order inside a CTA, so
// a row that ties the cbuf-th candidate has a higher id than every buffered
// row and could never displace one: the skip cannot change the result.
template <int BQ, bool PACKED>
__global__ void __launch_bounds__(kThreads)
lut16_topk_partial_kernel(const uint8_t* __restrict__ codes,
                          const float* __restrict__ lut,
                          const float* __restrict__ base,
                          long long base_qstride,
                          unsigned long long* __restrict__ partial,
                          long long n, int kc, int q, int kl,
                          int rows_per_cta, int cbuf, int half) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int len = 2 * half;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* lut_s = reinterpret_cast<float*>(keys + BQ * len);
  uint32_t* codes_s = reinterpret_cast<uint32_t*>(lut_s + BQ * kl * kLutWidth);
  const int stride = code_stride(kc);
  float* thresh = reinterpret_cast<float*>(codes_s + kThreads * stride);
  int* count = reinterpret_cast<int*>(thresh + BQ);
  int* need_merge = count + BQ;

  const int q0 = blockIdx.y * BQ;
  load_lut<BQ>(lut, q, kl, q0, lut_s);
  for (int i = threadIdx.x; i < BQ * len; i += blockDim.x) keys[i] = kEmpty;
  if (threadIdx.x < BQ) {
    thresh[threadIdx.x] = -INFINITY;
    count[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) *need_merge = 0;

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
      for (int qi = 0; qi < BQ; ++qi) {
        if (q0 + qi < q) {
          // bias after the full sum: base + (sum_k ...), as the
          // materialise-then-select path adds it
          const float s = base[(size_t)(q0 + qi) * base_qstride + row] + acc[qi];
          if (s > thresh[qi]) {
            const int pos = atomicAdd(&count[qi], 1);
            keys[qi * len + half + pos] = make_key(s, (uint32_t)row);
          }
        }
      }
    }
    __syncthreads();
    // merge before the next chunk could overflow a staging area
    if (threadIdx.x < BQ && count[threadIdx.x] > half - kThreads) *need_merge = 1;
    __syncthreads();
    if (*need_merge) {
      merge_staging<BQ>(keys, half, cbuf, thresh, count);
      if (threadIdx.x == 0) *need_merge = 0;
    }
  }
  __syncthreads();
  merge_staging<BQ>(keys, half, cbuf, thresh, count);
  for (int i = threadIdx.x; i < BQ * cbuf; i += blockDim.x) {
    const int qi = i / cbuf;
    const int j = i - qi * cbuf;
    if (q0 + qi < q)
      partial[((size_t)(q0 + qi) * gridDim.x + blockIdx.x) * cbuf + j] =
          keys[qi * len + j];
  }
}

// Phase 2.  Grid (ceil(p_in/2), Q).  Merges lists 2b and 2b+1 of each query
// (each sorted, cbuf keys) into the best cbuf.  With out_keys == nullptr it
// is the last round and decodes into (score, row), empty slots as (-inf, -1).
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const unsigned long long* __restrict__ in, int p_in,
                  unsigned long long* __restrict__ out_keys,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int cbuf, int half) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* mk = reinterpret_cast<unsigned long long*>(smem);
  const int qrow = blockIdx.y;
  const int pair = blockIdx.x;
  const int p_out = (p_in + 1) / 2;
  const unsigned long long* a = in + ((size_t)qrow * p_in + 2 * pair) * cbuf;
  const bool has_b = 2 * pair + 1 < p_in;
  const unsigned long long* b = a + cbuf;
  // A ascending, then B reversed: one bitonic sequence of 2*half keys
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    mk[i] = (i < cbuf) ? a[i] : kEmpty;
    mk[2 * half - 1 - i] = (has_b && i < cbuf) ? b[i] : kEmpty;
  }
  __syncthreads();
  for (int j = half; j > 0; j >>= 1) {
    for (int i = threadIdx.x; i < 2 * half; i += blockDim.x) {
      const int ixj = i ^ j;
      if (ixj > i) {
        const unsigned long long x = mk[i], y = mk[ixj];
        if (x > y) { mk[i] = y; mk[ixj] = x; }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < cbuf; i += blockDim.x) {
    const unsigned long long key = mk[i];
    if (out_keys != nullptr) {
      out_keys[((size_t)qrow * p_out + pair) * cbuf + i] = key;
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

size_t topk_smem(int bq, int kc, int kl, int half) {
  return (size_t)bq * 2 * half * sizeof(unsigned long long) + adc_smem(bq, kc, kl) +
         (size_t)bq * (sizeof(float) + sizeof(int)) + sizeof(int);
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
                long long base_qstride, unsigned long long* scratch_a,
                unsigned long long* scratch_b, float* out_s, int* out_i,
                long long n, int kc, int q, int kl, int rows_per_cta, int cbuf,
                int half, cudaStream_t stream) {
  const size_t smem = topk_smem(BQ, kc, kl, half);
  cudaError_t e = cudaFuncSetAttribute(lut16_topk_partial_kernel<BQ, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int p = (int)((n + rows_per_cta - 1) / rows_per_cta);
  const dim3 grid((unsigned)p, (unsigned)((q + BQ - 1) / BQ));
  lut16_topk_partial_kernel<BQ, PACKED><<<grid, kThreads, smem, stream>>>(
      codes, lut, base, base_qstride, scratch_a, n, kc, q, kl, rows_per_cta,
      cbuf, half);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t msmem = (size_t)2 * half * sizeof(unsigned long long);
  unsigned long long* in = scratch_a;
  unsigned long long* other = scratch_b;
  while (true) {
    const int p_out = (p + 1) / 2;
    const bool last = p <= 2;
    topk_merge_kernel<<<dim3((unsigned)p_out, (unsigned)q), kThreads, msmem,
                        stream>>>(in, p, last ? nullptr : other, out_s, out_i,
                                  cbuf, half);
    e = cudaGetLastError();
    if (e != cudaSuccess || last) return (int)e;
    unsigned long long* t = in;
    in = other;
    other = t;
    p = p_out;
  }
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

// K2.  base (q, n) f32 with base_qstride == n, or (1, n) with 0.  Scratch:
// two u64 buffers of q * P * cbuf keys, P = ceil(n / rows_per_cta).  Output
// (q, cbuf) scores and row ids.  half = max(next_pow2(cbuf), 256).
int lut16_topk_launch(const void* codes, const void* lut, const void* base,
                      long long base_qstride, void* scratch_a, void* scratch_b,
                      void* out_s, void* out_i, long long n, int kc, int q,
                      int kl, int packed, int bq, int rows_per_cta, int cbuf,
                      int half, void* stream) {
  if (n == 0 || q == 0) return 0;
  DISPATCH_BQ(launch_topk, static_cast<const uint8_t*>(codes),
              static_cast<const float*>(lut), static_cast<const float*>(base),
              base_qstride, static_cast<unsigned long long*>(scratch_a),
              static_cast<unsigned long long*>(scratch_b),
              static_cast<float*>(out_s), static_cast<int*>(out_i), n, kc, q,
              kl, rows_per_cta, cbuf, half, static_cast<cudaStream_t>(stream))
}

long long lut16_adc_smem_bytes(int bq, int kc, int kl) {
  return (long long)adc_smem(bq, kc, kl);
}

long long lut16_topk_smem_bytes(int bq, int kc, int kl, int half) {
  return (long long)topk_smem(bq, kc, kl, half);
}

const char* lut16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
