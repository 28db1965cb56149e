// Block-sparse head scoring (K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/block_sparse.py:
// block_sparse_matmul_pallas (body _kernel).
//
// Computes out = q @ X_head^T, with X_head (N_pad, D_pad) stored as BCSR:
// the nonzero 128 x 128 f32 tiles in row-block order, tile_ptr (NB + 1)
// offsets per 128-row block and tile_col the column block of each tile.
// Zero tiles are never read; a row block without tiles writes zeros.
//
// What bounds it on the H100: 2 * Q * T * 128 * 128 f32 operations against
// 4 * (T * 128 * 128 + Q * N_pad) bytes.  At the pass-1 shapes (Q = 128 and
// about one tile per row block) the f32 FMAs outweigh the bytes, and without
// tensor cores (no TF32: the head scores must hold rtol 1e-5) the FMA rate is
// the limit.  The design stages each tile once per CTA in shared memory with
// a padded row stride (129 floats, so the 32 rows a warp reads at one column
// fall on 32 banks), and lets each thread reuse the tile element it loads
// for 16 queries; the query slice is read as a shared-memory broadcast.
// One CTA serves 32 queries, so a tile crosses HBM ceil(Q / 32) times.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 128;                  // tile rows == tile cols
constexpr int kTileStride = kB + 1;      // padded shared-memory row stride
constexpr int kQPerThread = 16;
constexpr int kThreads = 256;            // 128 rows x 2 query groups
constexpr int kBQ = kQPerThread * (kThreads / kB);   // 32 queries per CTA

__global__ void __launch_bounds__(kThreads)
block_sparse_kernel(const float* __restrict__ q, const float* __restrict__ tiles,
                    const int* __restrict__ tile_ptr,
                    const int* __restrict__ tile_col, float* __restrict__ out,
                    int nq, int d_pad, int nb) {
  extern __shared__ __align__(16) float sm[];
  float* tile_s = sm;                          // [kB][kTileStride]
  float* q_s = sm + kB * kTileStride;          // [kBQ][kB]
  const int jn = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int r = threadIdx.x & (kB - 1);
  const int g = threadIdx.x / kB;
  float acc[kQPerThread];
#pragma unroll
  for (int j = 0; j < kQPerThread; ++j) acc[j] = 0.f;

  const int t0 = tile_ptr[jn];
  const int t1 = tile_ptr[jn + 1];
  for (int t = t0; t < t1; ++t) {
    const int c0 = tile_col[t] * kB;
    __syncthreads();
    const float* tp = tiles + (size_t)t * kB * kB;
    for (int i = threadIdx.x; i < kB * kB; i += kThreads)
      tile_s[(i / kB) * kTileStride + (i % kB)] = tp[i];
    for (int i = threadIdx.x; i < kBQ * kB; i += kThreads) {
      const int qi = q0 + i / kB;
      q_s[i] = (qi < nq) ? q[(size_t)qi * d_pad + c0 + (i % kB)] : 0.f;
    }
    __syncthreads();
    const float* trow = tile_s + r * kTileStride;
    const float* qg = q_s + g * kQPerThread * kB;
    for (int c = 0; c < kB; ++c) {
      const float x = trow[c];
#pragma unroll
      for (int j = 0; j < kQPerThread; ++j)
        acc[j] = fmaf(qg[j * kB + c], x, acc[j]);
    }
  }
  const size_t n_pad = (size_t)nb * kB;
#pragma unroll
  for (int j = 0; j < kQPerThread; ++j) {
    const int qi = q0 + g * kQPerThread + j;
    if (qi < nq) out[(size_t)qi * n_pad + (size_t)jn * kB + r] = acc[j];
  }
}

size_t smem_bytes() { return (size_t)(kB * kTileStride + kBQ * kB) * sizeof(float); }

}  // namespace

extern "C" {

// q (nq, d_pad) f32; tiles (T, 128, 128) f32; tile_ptr (nb + 1) i32;
// tile_col (T) i32; out (nq, nb * 128) f32.  Returns the cudaError_t.
int block_sparse_matmul_launch(const void* q, const void* tiles,
                               const void* tile_ptr, const void* tile_col,
                               void* out, int nq, int d_pad, int nb,
                               void* stream) {
  if (nq == 0 || nb == 0) return 0;
  const size_t smem = smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      block_sparse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)nb, (unsigned)((nq + kBQ - 1) / kBQ));
  block_sparse_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(tiles),
      static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_col),
      static_cast<float*>(out), nq, d_pad, nb);
  return (int)cudaGetLastError();
}

const char* block_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
