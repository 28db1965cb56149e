// Fixed-order kernels of the search's small reductions for Hopper (sm_90a):
// the ADC lookup table (R0), pass 2's int8 dense residual (R1), pass 3's
// sparse residual (R2) and the PQ LM head's exact columns (R3).
//
// They replace no Pallas kernel.  In the JAX package these steps are plain
// jnp (repro/core/pq.py:adc_lut, repro/core/residual.py:
// dense_residual_scores, repro/core/sparse_index.py:score_rows,
// repro/serve/hybrid_head.py's exact columns).  They are kernels here for
// one property no library call promises: each output is summed in an order
// that depends only on the length of its reduction (p, d or R), never on
// the number of queries, of candidates, the grid or the launch geometry.
// cuBLAS (the einsums, q @ zero) and torch.sum pick their split of a
// reduction from the shape, so a query's scores could move by an ulp with
// the batch it came in, and its top-h could swap near-ties: a query alone,
// padded into a bucket or inside a block of 128 must get the same bits
// (the reference's QueryService contract).
//
// The order.  R1, R2 and R3 give each output one warp.  Lane j adds the
// terms j, j + 32, j + 64, ... in turn into a sum that starts at +0, then
// the 32 lane sums meet in a fixed xor butterfly (offsets 16, 8, 4, 2, 1;
// each step adds two values, so every lane ends with the same bits).  R0's
// reduction is one subspace, p terms (p = 2 in every configuration of this
// repository): one thread adds them in turn from +0.  Every product and
// every add rounds on its own (__fmul_rn, __fadd_rn): nothing is
// contracted into an FMA, so kernels/ref.py's plain versions, which replay
// this order with tensor ops (a product, then adds), give the same bits.
// A padded term of the plain versions adds +0 to a sum that cannot be -0
// (it starts at +0), which changes no bit; here the padded terms are
// skipped.
//
//   R0 adc_lut          out[q, k, c] = sum_j q[q, k*p + j] * U[k, c, j]
//   R1 dense_residual   out[q, c] = sum_j qs_j * r[cand, j] + base[q],
//                       qs = q * scale, base = 128 * sum_j qs_j
//                       + sum_j q_j * zero_j (three warp sums; the order
//                       of repro/core/residual.py's terms)
//   R2 sparse_residual  out[q, c] = sum_r vals[cand, r] *
//                       q_cols[q, cols[cand, r]]
//   R3 gathered_dot     out[q, c] = sum_j h[q, j] * rows[cand, j], f32
//                       rows, each element rounded to bf16 first when
//                       asked (the head's bf16 pass 3)
// Candidates are clipped into [0, N) as the reference's take(mode="clip")
// does; R2's column ids into [0, d_active].
//
// What bounds them on the H100: bytes.  Each reads its gathered rows once
// (R1 at the slice: Q = 128 queries x C = 500 candidates x d = 200 int8 =
// 12.8 MB, 13.3 MB with the ids, outputs and queries, 4.0 us at 3.35 TB/s)
// and does one multiply and one add a byte or element, far below the f32
// rate.  The design keeps the rule first: a warp reads a row as 32
// consecutive elements a step (one 32-byte sector of int8, one 128-byte
// line of f32), the query vector stays in L1 across the candidates of a
// block, and R1's base is computed once a warp for its candidates of one
// query.  Speed beyond that (wider loads, several rows a warp) is later
// work; any change must keep the order above, and the plain versions with
// it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 4;              // candidates a warp takes in turn
constexpr int kPerBlock = kWarps * kPerWarp;

__device__ __forceinline__ float butterfly(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

__device__ __forceinline__ long long clip(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// ---------------------------------------------------------------------------
// R0: one thread an output, p terms in turn from +0.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
adc_lut_kernel(const float* __restrict__ q, const float* __restrict__ centers,
               float* __restrict__ out, long long total, int k, int l,
               int p) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % l);
  const int kk = (int)((i / l) % k);
  const long long qi = i / ((long long)l * k);
  const float* a = q + (qi * k + kk) * p;
  const float* u = centers + ((long long)kk * l + c) * p;
  float acc = 0.0f;
  for (int j = 0; j < p; ++j) acc = __fadd_rn(acc, __fmul_rn(a[j], u[j]));
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// R1 / R3: a warp an output; block b holds candidates
// [g * kPerBlock, (g + 1) * kPerBlock) of query b / groups.
// ---------------------------------------------------------------------------
template <bool kAffine, typename RowT>
__global__ void __launch_bounds__(kThreads)
gathered_dot_kernel(const RowT* __restrict__ rows,
                    const int* __restrict__ cand, const float* __restrict__ q,
                    const float* __restrict__ scale,
                    const float* __restrict__ zero, float* __restrict__ out,
                    int c_count, int groups, long long n, int d,
                    int bf16_rows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long qi = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const float* qv = q + qi * d;
  float base = 0.0f;
  if (kAffine) {
    // base = 128 * sum(q * scale) + q . zero, each a warp sum
    float s = 0.0f, z = 0.0f;
    for (int j = lane; j < d; j += 32) {
      s = __fadd_rn(s, __fmul_rn(qv[j], scale[j]));
      z = __fadd_rn(z, __fmul_rn(qv[j], zero[j]));
    }
    base = __fadd_rn(__fmul_rn(128.0f, butterfly(s)), butterfly(z));
  }
  for (int t = 0; t < kPerWarp; ++t) {
    const int c = g * kPerBlock + t * kWarps + warp;
    if (c >= c_count) break;
    const long long o = qi * c_count + c;
    const RowT* r = rows + clip(cand[o], n) * d;
    float acc = 0.0f;
    for (int j = lane; j < d; j += 32) {
      float x = (float)r[j];
      if (!kAffine && bf16_rows)
        x = __bfloat162float(__float2bfloat16_rn(x));
      const float w = kAffine ? __fmul_rn(qv[j], scale[j]) : qv[j];
      acc = __fadd_rn(acc, __fmul_rn(w, x));
    }
    acc = butterfly(acc);
    if (lane == 0) out[o] = kAffine ? __fadd_rn(acc, base) : acc;
  }
}

// ---------------------------------------------------------------------------
// R2: a warp an output, the row's R entries.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sparse_residual_kernel(const int* __restrict__ cols,
                       const float* __restrict__ vals,
                       const int* __restrict__ cand,
                       const float* __restrict__ q_cols,
                       float* __restrict__ out, int c_count, int groups,
                       long long n, int r_max, int width) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long qi = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const float* qc = q_cols + qi * width;
  for (int t = 0; t < kPerWarp; ++t) {
    const int c = g * kPerBlock + t * kWarps + warp;
    if (c >= c_count) break;
    const long long o = qi * c_count + c;
    const long long row = clip(cand[o], n) * r_max;
    float acc = 0.0f;
    for (int j = lane; j < r_max; j += 32) {
      const int col = (int)clip(cols[row + j], width);
      acc = __fadd_rn(acc, __fmul_rn(vals[row + j], qc[col]));
    }
    acc = butterfly(acc);
    if (lane == 0) out[o] = acc;
  }
}

int check_grid(long long blocks) {
  return blocks >= (1LL << 31) ? (int)cudaErrorInvalidConfiguration : 0;
}

}  // namespace

extern "C" {

// q (nq, k * p) f32, centers (k, l, p) f32, out (nq, k, l) f32, all
// contiguous.  Returns the cudaError_t.
int adc_lut_launch(const void* q, const void* centers, void* out, int nq,
                   int k, int l, int p, void* stream) {
  const long long total = (long long)nq * k * l;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (int e = check_grid(blocks)) return e;
  adc_lut_kernel<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(centers),
      static_cast<float*>(out), total, k, l, p);
  return (int)cudaGetLastError();
}

// rows (n, d) i8, cand (nq, c) i32, q (nq, d) f32, scale and zero (d,) f32,
// out (nq, c) f32, all contiguous.
int dense_residual_launch(const void* rows, const void* cand, const void* q,
                          const void* scale, const void* zero, void* out,
                          int nq, int c, long long n, int d, void* stream) {
  if (nq == 0 || c == 0) return 0;
  const int groups = (c + kPerBlock - 1) / kPerBlock;
  const long long blocks = (long long)nq * groups;
  if (int e = check_grid(blocks)) return e;
  gathered_dot_kernel<true, int8_t><<<(unsigned)blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(rows), static_cast<const int*>(cand),
      static_cast<const float*>(q), static_cast<const float*>(scale),
      static_cast<const float*>(zero), static_cast<float*>(out), c, groups, n,
      d, 0);
  return (int)cudaGetLastError();
}

// rows (n, d) f32, cand (nq, c) i32, q (nq, d) f32, out (nq, c) f32, all
// contiguous; bf16_rows != 0 rounds each row element to bf16 first.
int gathered_dot_launch(const void* rows, const void* cand, const void* q,
                        void* out, int nq, int c, long long n, int d,
                        int bf16_rows, void* stream) {
  if (nq == 0 || c == 0) return 0;
  const int groups = (c + kPerBlock - 1) / kPerBlock;
  const long long blocks = (long long)nq * groups;
  if (int e = check_grid(blocks)) return e;
  gathered_dot_kernel<false, float><<<(unsigned)blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(cand),
      static_cast<const float*>(q), nullptr, nullptr,
      static_cast<float*>(out), c, groups, n, d, bf16_rows);
  return (int)cudaGetLastError();
}

// cols (n, r_max) i32, vals (n, r_max) f32, cand (nq, c) i32, q_cols
// (nq, width) f32 (width = d_active + 1, the last slot zero), out (nq, c)
// f32, all contiguous.
int sparse_residual_launch(const void* cols, const void* vals,
                           const void* cand, const void* q_cols, void* out,
                           int nq, int c, long long n, int r_max, int width,
                           void* stream) {
  if (nq == 0 || c == 0) return 0;
  const int groups = (c + kPerBlock - 1) / kPerBlock;
  const long long blocks = (long long)nq * groups;
  if (int e = check_grid(blocks)) return e;
  sparse_residual_kernel<<<(unsigned)blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const int*>(cand), static_cast<const float*>(q_cols),
      static_cast<float*>(out), c, groups, n, r_max, width);
  return (int)cudaGetLastError();
}

const char* residual_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
