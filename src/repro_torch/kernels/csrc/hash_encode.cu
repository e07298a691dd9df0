// Weighted LSH hash encode for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by kernels/hash_encode.py).
//
// Replaces the Pallas TPU kernel hash_encode_pallas of the JAX package
// (src/repro/kernels/hash_encode.py, body _kernel):
//
//   codes = floor(((X o w) @ A) / width + b_frac) + b_int      (int32)
//
// a float32 (n, d) x (d, beta) product whose epilogue fuses the weighting
// (on the X tile as it is staged), the division by the bucket width, the
// fractional offset, the floor and the exact integer offset, so the codes
// never reach device memory as floats.
//
// What bounds it on this card: float32 arithmetic.  2*n*d*beta operations
// outside the tensor cores (TF32 keeps ~3 digits and would move floors)
// against (n*d + d*beta + n*beta)*4 bytes.
//
// What the design does about it, right and simple first:
//   * A plain shared-memory SGEMM tile: a block of 256 threads computes
//     64 x 64 codes, 4 x 4 per thread, staging X o w and A 32 dims at a
//     time; ragged n, d and beta are masked.  wgmma and TF32 are later
//     work.
//   * Determinism: each code is summed by one thread, over d, in one fixed
//     order that does not depend on n, on the grid or on where the row
//     lies: products rounded on their own, summed in runs of 8 dims, each
//     run added to its 32-dim tile's sum, each tile's sum to the total;
//     __fmul_rn / __fadd_rn keep multiply and add apart (no FMA).  No
//     split-K and no atomics.  So a query's codes equal its stored row's
//     codes bit for bit, and kernels/ref.py::hash_encode_ref, which sums in
//     the same order, agrees exactly.  This order also keeps heavy-tailed
//     (p <= 1) sums within ~10 * 2^-24 * sum|x_i w_i a_ij| of the exact
//     value at d = 400, where one sequential sum reaches ~40.
//   * Epilogue: true division by width (__fdiv_rn), + b_frac, then
//     __float2int_rd, which rounds toward minus infinity and saturates
//     (u >= 2^31 -> INT_MAX, u < -2^31 -> INT_MIN, as XLA's convert), then
//     + b_int with int32 wraparound.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;    // rows per block
constexpr int BN = 64;    // codes (hash functions) per block
constexpr int BK = 32;    // dims staged per tile
constexpr int RUN = 8;    // dims per innermost run
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // codes per thread
constexpr int THREADS = (BM / TM) * (BN / TN);

__global__ void __launch_bounds__(THREADS)
hash_encode_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ a, const int* __restrict__ b_int,
                   const float* __restrict__ b_frac, float width, int n,
                   int d, int beta, int* __restrict__ out) {
  __shared__ float s_x[BK][BM + 1];  // (x o w) tile, transposed
  __shared__ float s_a[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    const int kc = min(BK, d - k0);
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, k = e % BK;
      const int gr = m0 + r, gk = k0 + k;
      s_x[k][r] = (gr < n && k < kc)
                      ? __fmul_rn(x[(size_t)gr * d + gk], w[gk]) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, j = e % BN;
      const int gk = k0 + k, gj = n0 + j;
      s_a[k][j] = (k < kc && gj < beta) ? a[(size_t)gk * beta + gj] : 0.0f;
    }
    __syncthreads();
    float tile[TM][TN], run[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) tile[i][j] = run[i][j] = 0.0f;
    for (int k = 0; k < kc; ++k) {
      float xv[TM], av[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = s_x[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) av[j] = s_a[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          run[i][j] = __fadd_rn(run[i][j], __fmul_rn(xv[i], av[j]));
      if (k % RUN == RUN - 1 || k == kc - 1) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            tile[i][j] = __fadd_rn(tile[i][j], run[i][j]);
            run[i][j] = 0.0f;
          }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __fadd_rn(acc[i][j], tile[i][j]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col >= beta) continue;
      const float u = __fadd_rn(__fdiv_rn(acc[i][j], width), b_frac[col]);
      const unsigned v = (unsigned)__float2int_rd(u) + (unsigned)b_int[col];
      out[(size_t)r * beta + col] = (int)v;
    }
  }
}

}  // namespace

extern "C" {

// out (n, beta) int32.  Returns cudaGetLastError() after the launch
// (0 = launched).
int wlsh_hash_encode(const float* x, const float* w, const float* a,
                     const int* b_int, const float* b_frac, float width,
                     int n, int d, int beta, int* out, void* stream) {
  if ((beta + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  if (n <= 0 || beta <= 0) return (int)cudaGetLastError();
  const dim3 grid((n + BM - 1) / BM, (beta + BN - 1) / BN);
  hash_encode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, a, b_int, b_frac, width, n, d, beta, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
