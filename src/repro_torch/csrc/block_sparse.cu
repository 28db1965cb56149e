// Block-sparse head scoring (K3) and value-forward inverted scoring (B4)
// for Hopper (sm_90a), kept together as the JAX package keeps their Pallas
// kernels in one file.
//
// ---------------------------------------------------------------------------
// K3
//
// Replaces the Pallas TPU kernel repro/kernels/block_sparse.py:
// block_sparse_matmul_pallas (body _kernel).
//
// Computes out = q @ X_head^T, with X_head (N_pad, D_pad) stored as BCSR:
// the nonzero 128 x 128 f32 tiles in row-block order, tile_ptr (NB + 1)
// offsets per 128-row block and tile_col the column block of each tile.
// Zero tiles are never read; a row block without tiles writes zeros.
//
// What bounds it on the H100.  The work is 2 * Q * T * 128 * 128 operations
// against 4 * (T * 128 * 128 + Q * N_pad + Q * D_pad) bytes.  On the f32
// CUDA cores (67 TFLOP/s) the operations would bound it: 0.256 ms at the
// slice shapes (Q = 128, T = 4088 tiles, N_pad = 524288).  Here they run on
// the tensor cores as 3xTF32, three TF32 products per f32 product: 0.104 ms
// at 495 TFLOP/s.  So the bound is bytes: 268 MB of tiles in and 268 MB of
// scores out, 0.160 ms at 3.35 TB/s.
//
// 3xTF32, and why it holds the port's rtol 1e-5 / atol 1e-4.  TF32 keeps
// 10 of f32's 23 mantissa bits, too few alone (about 2^-11 relative per
// product).  Each operand is split in registers: hi = rna(x),
// lo = rna(x - hi), rounding to nearest with ties away from zero.  x - hi
// is exact in f32 (the rounding residual; __fsub_rn keeps it out of any
// FMA), |x - hi| <= 2^-11 |x| and |x - hi - lo| <= 2^-22 |x|.  Per k-step
// of 8 the kernel adds a_lo*b_hi, then a_hi*b_lo, then a_hi*b_hi (small
// terms first) and drops a_lo*b_lo (<= 2^-22 |a b|); a product of two TF32
// values is exact in f32.  So each product is off by at most about
// 3 * 2^-22 |a b| (7e-7), an output by 7e-7 * sum_d |q_d x_d| plus the sum's
// own rounding.  That sum needs care: the tensor cores do not round their
// f32 accumulation to nearest but truncate, so one accumulator carried
// through a row block's 48 mma.sync per tile drifts toward zero by up to
// 2^-23 per step, which at D_pad = 512 with positive values leaves rtol
// 1e-5.  Each k-step's three products therefore start from zero and are
// added to the running sum with a rounded f32 add (__fadd_rn), so the drift
// stays within one k-step's sum at any D_pad (chip_smoke.py checks
// D_pad = 512 with positive values).
// tests/test_torch_tf32_split.py emulates the split (kernels/ref.py:
// tf32_split) and this order of sums on the CPU, up to D_pad = 512 with
// positive values, and shows that a_hi*b_hi alone misses the tolerance.
// Its f32 sums round to nearest, so it cannot show the truncation; the
// D_pad = 512 positive case of chip_smoke.py checks that on the card.
//
// The split.  cvt.rna.tf32.f32 compiles on sm_90a to four instructions, two
// of them only to pass inf and NaN through; hi uses the two-instruction
// integer form (add half of the 13 dropped bits, clear them), which gives
// the same bits for every finite input, and the splits are most of the
// instructions the kernel issues; lo keeps cvt.rna, so a NaN operand still
// comes out NaN.  An infinite operand comes out NaN as well (inf - inf in
// lo): K3, like any 3xTF32 product, takes finite inputs.
//
// What the design does about each loss of the first, CUDA-core K3:
// - f32 FMAs bound by shared-memory issue (one tile read and 16 broadcast
//   query reads per 16 FMAs): the products run as
//   mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  A is the tile (rows n,
//   K = d, row-major as stored), B the queries (K = d contiguous per query:
//   "col").  At Q > 16 a warp owns a (64 rows x 32 queries) block of the
//   output, so each A fragment feeds 4 n-tiles and each B fragment 4
//   m-tiles; at Q <= 16 a warp owns 16 rows and all queries, so that every
//   warp has work.  The query loop runs over ceil(Q / 8) n-tiles only.
// - Each tile crossed HBM ceil(Q / 32) times: a CTA serves all of up to 128
//   queries, so at Q <= 128 each tile is read from HBM once; only Q > 128
//   adds a query group on blockIdx.y.  CTAs are persistent (one per SM),
//   each owning a contiguous range of row blocks, so its tiles are one
//   contiguous range that the loader streams with no dependent index
//   reads; the 128 x 128 query slice stays in shared memory while the
//   tiles' column block stays the same (always, at D_pad = 128).
// - Scalar synchronous tile loads: a tile is 64 KB of contiguous memory,
//   copied with cp.async.cg 16 bytes a thread into a ring of two stages
//   (three at Q <= 16, where the query slice is small), so the next tiles
//   load while one multiplies.  Rows are padded to 132 floats (132 mod 32
//   = 4), so the fragment loads (row lane / 4, column lane % 4) fall on 32
//   distinct banks.
// - The epilogue stages the (128 rows x Q) sums in the stage that is not
//   being filled and writes each query's 512 contiguous bytes with 16-byte
//   streaming stores.
// Deterministic: each output element is summed by one thread, over its row
// block's tiles in BCSR order and k-steps in order; no split-K, no atomics.
//
// mma.sync, not wgmma: wgmma reads B from shared memory, so the split
// operand would have to be written back there as two more copies (hi and
// lo of the query slice, 128 KB) beside the two tile stages, which the
// 227 KB do not hold.  What holds mma.sync back on this card: it runs
// TF32 at a fraction of wgmma's rate, and at Q = 128 the splits (each tile
// element is split by the 4 warps that share its rows) and the rounded adds
// take most of the issue slots beside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 128;                  // tile rows == tile cols == queries per group
constexpr int kS = kB + 4;               // padded shared-memory row stride (floats)
constexpr int kThreads = 256;            // 8 warps
constexpr int kStage = kB * kS;          // floats of one tile stage

// x = hi + lo + O(2^-22 |x|), both TF32 (see "The split" above).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  const float rest = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// c += a * b on one m16n8k8 tile; a (16 x 8) row-major, b (8 x 8) col-major.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

// WM warps along the 128 tile rows and 8 / WM along the queries, each warp
// holding NT n8 tiles of queries; STAGES tile buffers in the ring.
template <int WM, int NT, int STAGES>
struct K3Shape {
  static constexpr int kWM = WM, kNT = NT, kStages = STAGES;
  static constexpr int kWN = 8 / WM;
  static constexpr int kMT = kB / 16 / WM;          // m16 tiles per warp
  static constexpr int kQRows = NT * 8 * kWN;       // queries per CTA
  static constexpr size_t kSmemBytes =
      (size_t)(STAGES * kStage + kQRows * kS) * sizeof(float);
};

template <int WM, int NT, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
block_sparse_kernel(const float* __restrict__ q, const float* __restrict__ tiles,
                    const int* __restrict__ tile_ptr,
                    const int* __restrict__ tile_col, float* __restrict__ out,
                    int nq, int d_pad, int nb) {
  using Shape = K3Shape<WM, NT, STAGES>;
  constexpr int WN = Shape::kWN;
  constexpr int MT = Shape::kMT;
  extern __shared__ __align__(16) float sm[];
  float* q_s = sm + STAGES * kStage;     // [query][d], stride kS
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  const int wn = warp / WM;
  const int m_base = (warp % WM) * MT * 16;
  const int q0 = blockIdx.y * Shape::kQRows;
  const int nqg = min(Shape::kQRows, nq - q0);   // queries of this group
  const int nt = (nqg + 7) >> 3;                 // n8 tiles that hold them
  const size_t n_pad = (size_t)nb * kB;
  // this CTA's row blocks [rb0, rb1) and their tiles [t_first, t_last)
  const int rb0 = (int)((long long)blockIdx.x * nb / gridDim.x);
  const int rb1 = (int)((long long)(blockIdx.x + 1) * nb / gridDim.x);
  const int t_first = tile_ptr[rb0];
  const int t_last = tile_ptr[rb1];

  int ld_t = t_first;                    // the next tile to copy
  auto load_next = [&](int stage) {
    if (ld_t < t_last) {
      const float* src = tiles + (size_t)ld_t * kB * kB;
      float* dst = sm + stage * kStage;
      for (int i = threadIdx.x; i < kB * kB / 4; i += kThreads)
        cp_async16(dst + (i >> 5) * kS + 4 * (i & 31), src + 4 * i);
      ++ld_t;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next(s);

  int q_col = -1;                        // the column block q_s holds
  int t = t_first;
  int c_next = t < t_last ? tile_col[t] : 0;
  int t_end = tile_ptr[rb0 + 1];
  for (int jn = rb0; jn < rb1; ++jn) {
    const int t_end_next = jn + 1 < rb1 ? tile_ptr[jn + 2] : 0;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

    for (; t < t_end; ++t) {
      const int it = t - t_first;
      const float* cur = sm + (it % STAGES) * kStage;
      load_next((it + STAGES - 1) % STAGES);
      const int c = c_next;
      if (t + 1 < t_last) c_next = tile_col[t + 1];
      asm volatile("cp.async.wait_group %0;" :: "n"(STAGES - 1) : "memory");
      __syncthreads();
      if (c != q_col) {                  // uniform: every thread reads c
        for (int i = threadIdx.x; i < nt * 8 * 32; i += kThreads) {
          const int qq = i >> 5;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (qq < nqg)
            v = __ldg(reinterpret_cast<const float4*>(
                q + (size_t)(q0 + qq) * d_pad + (size_t)c * kB) + (i & 31));
          *reinterpret_cast<float4*>(q_s + qq * kS + 4 * (i & 31)) = v;
        }
        q_col = c;
        __syncthreads();
      }
#pragma unroll
      for (int k0 = 0; k0 < kB; k0 += 8) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* a = cur + (m_base + mt * 16 + g) * kS + k0 + tq;
          split_tf32(a[0], ah[mt][0], al[mt][0]);
          split_tf32(a[8 * kS], ah[mt][1], al[mt][1]);
          split_tf32(a[4], ah[mt][2], al[mt][2]);
          split_tf32(a[8 * kS + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (wn + j * WN < nt) {
            const float* b = q_s + ((wn + j * WN) * 8 + g) * kS + k0 + tq;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(b[0], bh0, bl0);
            split_tf32(b[4], bh1, bl1);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              float p[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(p, al[mt], bh0, bh1);
              mma_tf32(p, ah[mt], bl0, bl1);
              mma_tf32(p, ah[mt], bh0, bh1);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[mt][j][e] = __fadd_rn(acc[mt][j][e], p[e]);
            }
          }
        }
      }
      __syncthreads();                   // cur may be refilled or staged into
    }
    t_end = t_end_next;

    // Epilogue through the stage no copy is filling: [query][row].
    float* o_s = sm + ((t - t_first + STAGES - 1) % STAGES) * kStage;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n8 = wn + j * WN;
        if (n8 < nt) {
          const int r = m_base + mt * 16 + g;
          const int qq = n8 * 8 + 2 * tq;
          o_s[qq * kS + r] = acc[mt][j][0];
          o_s[(qq + 1) * kS + r] = acc[mt][j][1];
          o_s[qq * kS + r + 8] = acc[mt][j][2];
          o_s[(qq + 1) * kS + r + 8] = acc[mt][j][3];
        }
      }
    __syncthreads();
    for (int i = threadIdx.x; i < nqg * 32; i += kThreads) {
      const int qq = i >> 5;
      const float4 v = *reinterpret_cast<const float4*>(o_s + qq * kS + 4 * (i & 31));
      __stcs(reinterpret_cast<float4*>(out + (size_t)(q0 + qq) * n_pad
                                       + (size_t)jn * kB) + (i & 31), v);
    }
    __syncthreads();
  }
}

template <class Shape>
cudaError_t launch_block_sparse(const float* q, const float* tiles,
                                const int* tile_ptr, const int* tile_col,
                                float* out, int nq, int d_pad, int nb,
                                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      block_sparse_kernel<Shape::kWM, Shape::kNT, Shape::kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Shape::kSmemBytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess)
    return e;
  const dim3 grid((unsigned)(nb < sms ? nb : sms),
                  (unsigned)((nq + Shape::kQRows - 1) / Shape::kQRows));
  block_sparse_kernel<Shape::kWM, Shape::kNT, Shape::kStages>
      <<<grid, kThreads, Shape::kSmemBytes, stream>>>(
          q, tiles, tile_ptr, tile_col, out, nq, d_pad, nb);
  return cudaGetLastError();
}

// Q <= 16: every warp takes 16 rows and both n8 tiles, three stages.
// Q > 16: 2 x 4 warps of 64 rows x 32 queries, two stages.
using K3Small = K3Shape<8, 2, 3>;
using K3Large = K3Shape<2, 4, 2>;

// ---------------------------------------------------------------------------
// B4: inverted_value_forward_kernel
//
// Replaces the Pallas TPU kernel repro/kernels/block_sparse.py:
// inverted_value_forward_pallas (body _vf_kernel).
//
// Input: the host-planned stream of core/sparse_index.py:
// build_value_forward_stream.  For query block b and row block j, the
// entries [ptr[b*(NB+1)+j] * chunk, ptr[b*(NB+1)+j+1] * chunk) of
// rows/qidx/contrib[b] are sorted by block-local row (pad entries carry row
// bn and sort last); per (query, row) they keep the query's slot order.
// Output: out[(b*bq + q), j*bn + row] = sum of the matching contributions.
//
// The TPU kernel scatter-adds a chunk at a time as two one-hot matrices
// contracted on the MXU.  Here one CTA owns one (b, j) output tile of
// bq x bn f32 in shared memory (8 x 512 x 4 B = 16 KB at the defaults),
// and each thread owns whole rows of it: a binary search finds the row's
// run inside the sorted segment, and the thread adds the run's entries in
// stream order.  No two threads write one accumulator, so there are no
// atomics, and each (query, row) sum is taken in slot order from +0 — the
// order of the port's score_inverted (one scatter per query slot), so the
// two agree bit for bit.  The contributions were multiplied on the host;
// the kernel only adds (__fadd_rn, so nothing is contracted).  An empty
// segment still writes its zeros.
//
// What bounds it on the H100: it needs 12 bytes (row, query, contribution)
// per real stream entry (neither the chunk padding nor the tail past a
// block's last chunk), 4 * QB * (NB+1) of ptr, and writes 4 * Q * N bytes
// of scores, for one add per stream entry; at the pass-1 shapes (Q = 128,
// N = 524288) the dense (Q, N) output write dominates, so the bound is
// bytes.  Writes
// are coalesced: consecutive threads own consecutive rows.
// ---------------------------------------------------------------------------

constexpr int kVfThreads = 256;

__global__ void __launch_bounds__(kVfThreads)
inverted_value_forward_kernel(const int* __restrict__ ptr,
                              const int* __restrict__ rows,
                              const int* __restrict__ qidx,
                              const float* __restrict__ contrib,
                              float* __restrict__ out, int bq, int bn,
                              int chunk, int nb, int p_pad) {
  extern __shared__ float acc[];               // [bq][bn]
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int* seg_ptr = ptr + (size_t)b * (nb + 1) + j;
  const int s0 = seg_ptr[0] * chunk;
  const int s1 = seg_ptr[1] * chunk;
  const int* r_b = rows + (size_t)b * p_pad;
  const int* q_b = qidx + (size_t)b * p_pad;
  const float* c_b = contrib + (size_t)b * p_pad;
  const size_t width = (size_t)nb * bn;
  for (int r = threadIdx.x; r < bn; r += blockDim.x) {
    for (int q = 0; q < bq; ++q) acc[q * bn + r] = 0.f;
    int lo = s0, hi = s1;                      // first entry with row >= r
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (r_b[mid] < r) lo = mid + 1; else hi = mid;
    }
    for (int p = lo; p < s1 && r_b[p] == r; ++p) {
      const int q = q_b[p];
      if (q >= 0 && q < bq) acc[q * bn + r] = __fadd_rn(acc[q * bn + r], c_b[p]);
    }
    float* o = out + (size_t)b * bq * width + (size_t)j * bn + r;
    for (int q = 0; q < bq; ++q) o[(size_t)q * width] = acc[q * bn + r];
  }
}

}  // namespace

extern "C" {

// q (nq, d_pad) f32; tiles (T, 128, 128) f32; tile_ptr (nb + 1) i32;
// tile_col (T) i32; out (nq, nb * 128) f32; q, tiles and out 16-byte
// aligned.  Returns the cudaError_t.
int block_sparse_matmul_launch(const void* q, const void* tiles,
                               const void* tile_ptr, const void* tile_col,
                               void* out, int nq, int d_pad, int nb,
                               void* stream) {
  if (nq == 0 || nb == 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* tf = static_cast<const float*>(tiles);
  const int* pp = static_cast<const int*>(tile_ptr);
  const int* cp = static_cast<const int*>(tile_col);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq <= K3Small::kQRows)
    return (int)launch_block_sparse<K3Small>(qf, tf, pp, cp, of, nq, d_pad, nb, st);
  return (int)launch_block_sparse<K3Large>(qf, tf, pp, cp, of, nq, d_pad, nb, st);
}

// Dynamic shared memory of one K3 CTA at nq queries, in bytes.
int block_sparse_matmul_smem_bytes(int nq) {
  return (int)(nq <= K3Small::kQRows ? K3Small::kSmemBytes
                                     : K3Large::kSmemBytes);
}

// ptr (qb * (nb + 1)) i32 chunk offsets; rows, qidx (qb, p_pad) i32;
// contrib (qb, p_pad) f32; out (qb * bq, nb * bn) f32.  Returns the
// cudaError_t.
int inverted_value_forward_launch(const void* ptr, const void* rows,
                                  const void* qidx, const void* contrib,
                                  void* out, int qb, int bq, int bn,
                                  int chunk, int nb, int p_pad, void* stream) {
  if (qb == 0 || nb == 0) return 0;
  const size_t smem = (size_t)bq * bn * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      inverted_value_forward_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)nb, (unsigned)qb);
  inverted_value_forward_kernel<<<grid, kVfThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(rows),
      static_cast<const int*>(qidx), static_cast<const float*>(contrib),
      static_cast<float*>(out), bq, bn, chunk, nb, p_pad);
  return (int)cudaGetLastError();
}

const char* block_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
