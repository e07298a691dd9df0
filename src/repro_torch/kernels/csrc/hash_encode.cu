// Weighted LSH hash encode for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by kernels/hash_encode.py).
//
// Replaces the Pallas TPU kernel hash_encode_pallas of the JAX package
// (src/repro/kernels/hash_encode.py, body _kernel):
//
//   codes = floor(((X o w) @ A) / width + b_frac) + b_int      (int32)
//
// a float32 (n, d) x (d, beta) product whose epilogue fuses the weighting
// (on the X slab as it is staged), the division by the bucket width, the
// fractional offset, the floor and the exact integer offset, so the codes
// never reach device memory as floats.
//
// What bounds it on this card: float32 arithmetic.  n*d*beta fused
// multiply-adds (2*n*d*beta operations) outside the tensor cores (TF32
// keeps ~3 digits and would move floors; no wgmma) against
// (n*d + d*beta + n*beta)*4 bytes.
//
// The summation order, the contract with kernels/ref.py::hash_encode_ref.
// Each code is summed by one thread, over d ascending:
//   xw_k = RN(x_k * w_k);  the dims fall into 32-dim tiles and each tile
//   into 8-dim runs (the last run and tile may be ragged);
//   run  = fma(xw_k, a_kj, run) from 0, rounded once (__fmaf_rn);
//   tile = RN(tile + run) after each run, acc = RN(acc + tile) after each
//   tile (__fadd_rn, which nvcc never contracts into a neighbouring FMA).
// The order depends on neither n, the grid nor where the row lies: no
// split-K, no atomics.  So a query's codes equal its stored row's codes
// bit for bit, and the plain version, which rounds each FMA once (exact
// float64 product, TwoSum, round to odd, then float32), agrees exactly.
// This order keeps heavy-tailed (p <= 1) sums within ~10 * 2^-24 *
// sum|x_i w_i a_ij| of the exact value at d = 400, where one sequential
// sum reaches ~40; an FMA rounds once where a multiply and an add round
// twice, so it can only come closer.
//
// What the design does about the bound:
//   * One FMA per term, so the float32 pipes issue n*d*beta FMAs plus an
//     add per code per run and per tile (1/8 + 1/32 more).
//   * A 128 x 64 block of 256 threads, 8 x 4 codes per thread: the run,
//     tile and acc sums take 96 registers, so one block fills an SM's
//     register file and 8 warps hide latency with 32 independent FMAs
//     per k.
//   * Shared slabs laid out for 128-bit loads: X o w transposed,
//     [BK][BM], its 16-byte chunks XOR-swizzled by k % 8 (the transposing
//     stores hit all 32 banks, the reads stay 16-byte aligned), A as
//     [BK][BN].  Per k a thread reads its 8 rows in two LDS.128 and its 4
//     codes in one: 3 loads for 32 FMAs.
//   * Double-buffered staging: the next 32-dim slab's global loads are
//     issued into registers before the current slab's math, and stored
//     (x times w, rounded as the order says) into the other shared buffer
//     after it; one __syncthreads per slab.  BK = 32 is the order's tile,
//     so each slab's tile sum ends inside it.  Blocks and slabs inside n,
//     d and beta load without masks.
//   * Ragged edges are zero-padded in shared memory: past d an FMA adds
//     0 * 0 and leaves a run as it was, so the last run sums as the order
//     says; the ragged last slab runs only its ceil(kc / 8) runs (a loop,
//     where a full slab's 4 runs are unrolled without branches).  Rows
//     past n and codes past beta are not stored.
//   * Block ids walk the code blocks of one row block first, so the
//     blocks that read the same X rows run together and share them in L2.
//   * Epilogue: true division by width (__fdiv_rn), + b_frac, then
//     __float2int_rd, which rounds toward minus infinity and saturates
//     (u >= 2^31 -> INT_MAX, u < -2^31 -> INT_MIN, as XLA's convert), then
//     + b_int with int32 wraparound; 128-bit stores where beta % 4 == 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int TM = 8;     // rows per thread
constexpr int TN = 4;     // codes per thread
constexpr int BM = 16 * TM;  // rows per block
constexpr int BN = 16 * TN;  // codes (hash functions) per block
constexpr int BK = 32;    // dims per slab: one tile of the order
constexpr int RUN = 8;    // dims per run
constexpr int THREADS = 256;
constexpr int XPT = BM * BK / THREADS;  // X slab values staged per thread
constexpr int APT = BK * BN / THREADS;  // A slab values staged per thread
static_assert(TM == 8 && TN == 4 && BK == 4 * RUN,
              "the staging maps below assume these sizes");

// Offset of row r in the k-th row of the transposed X slab: 16-byte
// chunk r / 4 XOR k % 8.
__device__ __forceinline__ int swz(int k, int r) {
  return (((r >> 2) ^ (k & 7)) << 2) | (r & 3);
}

// The slab at dims k0..k0+31 into registers; with EDGE, zero past n, d
// and beta (without, the caller knows the slab lies inside all three).
// X: value i of a thread is dim (i % 4) * 8 + lane % 8 of row lane / 8 +
// 4 * (warp + 8 * (i / 4)), so a warp reads 4 rows x 32 bytes (whole
// sectors) and stores to 32 distinct banks; w: one value per dim group.
// A: value i is element tid + THREADS * i of the [BK][BN] slab.
template <bool EDGE>
__device__ __forceinline__ void load_slab(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ a, int n, int d, int beta, int m0, int n0,
    int k0, int tid, float (&xr)[XPT], float (&wr)[4], float (&ar)[APT]) {
  const int lane = tid & 31, warp = tid >> 5;
  const int kx = k0 + (lane & 7), rx = m0 + (lane >> 3) + 4 * warp;
  const float* xp = x + (size_t)rx * d + kx;
  const size_t x_step = (size_t)32 * d;  // 32 rows: the next 4 values
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wr[q] = (!EDGE || kx + q * RUN < d) ? w[kx + q * RUN] : 0.0f;
#pragma unroll
  for (int i = 0; i < XPT; ++i) {
    const bool in = rx + 32 * (i >> 2) < n && kx + (i & 3) * RUN < d;
    xr[i] = (!EDGE || in) ? xp[(i >> 2) * x_step + (i & 3) * RUN] : 0.0f;
  }
  constexpr int A_ROWS = THREADS / BN;  // slab rows between values
  const int ka = k0 + tid / BN, ja = n0 + tid % BN;
  const float* ap = a + (size_t)ka * beta + ja;
#pragma unroll
  for (int i = 0; i < APT; ++i) {
    const bool in = ka + A_ROWS * i < d && ja < beta;
    ar[i] = (!EDGE || in) ? ap[(size_t)(A_ROWS * i) * beta] : 0.0f;
  }
}

__device__ __forceinline__ void load_slab(
    bool edge, const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ a, int n, int d, int beta, int m0, int n0,
    int k0, int tid, float (&xr)[XPT], float (&wr)[4], float (&ar)[APT]) {
  if (edge || k0 + BK > d)
    load_slab<true>(x, w, a, n, d, beta, m0, n0, k0, tid, xr, wr, ar);
  else
    load_slab<false>(x, w, a, n, d, beta, m0, n0, k0, tid, xr, wr, ar);
}

__device__ __forceinline__ void store_slab(float* sx, float* sa, int tid,
                                           const float (&xr)[XPT],
                                           const float (&wr)[4],
                                           const float (&ar)[APT]) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < XPT; ++i) {
    const int k = (i & 3) * RUN + (lane & 7);
    const int r = (lane >> 3) + 4 * (warp + 8 * (i >> 2));
    sx[k * BM + swz(k, r)] = __fmul_rn(xr[i], wr[i & 3]);
  }
#pragma unroll
  for (int i = 0; i < APT; ++i) sa[tid + THREADS * i] = ar[i];
}

// run q of a slab (dims 8q..8q+7), summed from 0 in the order
__device__ __forceinline__ void sum_run(const float* sx, const float* sa,
                                        int tx, int ty, int q,
                                        float (&run)[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < RUN; ++kk) {
    const int k = q * RUN + kk;  // k % 8 == kk
    float xv[TM];
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {  // this thread's rows, 4 at once
      const float4 x4 = *reinterpret_cast<const float4*>(
          sx + k * BM + ((((TM / 4) * ty + h) ^ kk) << 2));
      xv[4 * h] = x4.x, xv[4 * h + 1] = x4.y;
      xv[4 * h + 2] = x4.z, xv[4 * h + 3] = x4.w;
    }
    const float4 a4 = *reinterpret_cast<const float4*>(sa + k * BN + tx * TN);
    const float av[TN] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        run[i][j] = __fmaf_rn(xv[i], av[j], kk == 0 ? 0.0f : run[i][j]);
  }
}

// One slab's tile (its first nruns runs; all 4 where the slab is full)
// added into acc, in the order.  The full slab's runs are unrolled; the
// ragged last slab's are a loop.
template <bool FULL>
__device__ __forceinline__ void sum_slab(const float* sx, const float* sa,
                                         int tx, int ty, int nruns,
                                         float (&acc)[TM][TN]) {
  float tile[TM][TN], run[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) tile[i][j] = 0.0f;
  if (FULL) {
#pragma unroll
    for (int q = 0; q < BK / RUN; ++q) {
      sum_run(sx, sa, tx, ty, q, run);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          tile[i][j] = __fadd_rn(tile[i][j], run[i][j]);
    }
  } else {
#pragma unroll 1
    for (int q = 0; q < nruns; ++q) {
      sum_run(sx, sa, tx, ty, q, run);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          tile[i][j] = __fadd_rn(tile[i][j], run[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = __fadd_rn(acc[i][j], tile[i][j]);
}

__global__ void __launch_bounds__(THREADS, 1)
hash_encode_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ a, const int* __restrict__ b_int,
                   const float* __restrict__ b_frac, float width, int n,
                   int d, int beta, int* __restrict__ out) {
  __shared__ __align__(16) float s_x[2][BK * BM];  // X o w, [k][row]
  __shared__ __align__(16) float s_a[2][BK * BN];  // A, [k][code]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int col_blocks = (beta + BN - 1) / BN;
  const int m0 = (int)(blockIdx.x / col_blocks) * BM;
  const int n0 = (int)(blockIdx.x % col_blocks) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  float xr[XPT], wr[4], ar[APT];  // the next slab, in flight
  const bool edge = m0 + BM > n || n0 + BN > beta;
  const int nslabs = (d + BK - 1) / BK;
  load_slab(edge, x, w, a, n, d, beta, m0, n0, 0, tid, xr, wr, ar);
  store_slab(s_x[0], s_a[0], tid, xr, wr, ar);
  __syncthreads();
  for (int t = 0; t < nslabs; ++t) {
    const int k0 = t * BK;
    if (t + 1 < nslabs)
      load_slab(edge, x, w, a, n, d, beta, m0, n0, k0 + BK, tid, xr, wr,
                ar);
    if (k0 + BK <= d)
      sum_slab<true>(s_x[t & 1], s_a[t & 1], tx, ty, BK / RUN, acc);
    else
      sum_slab<false>(s_x[t & 1], s_a[t & 1], tx, ty,
                      (d - k0 + RUN - 1) / RUN, acc);
    if (t + 1 < nslabs)
      store_slab(s_x[(t + 1) & 1], s_a[(t + 1) & 1], tid, xr, wr, ar);
    __syncthreads();
  }

  const int col0 = n0 + tx * TN;
  float bf[TN];
  unsigned bi[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const bool in = col0 + j < beta;
    bf[j] = in ? b_frac[col0 + j] : 0.0f;
    bi[j] = in ? (unsigned)b_int[col0 + j] : 0u;
  }
  const bool vec = (beta & 3) == 0 && col0 + TN <= beta;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r < n) {
      int v[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float u = __fadd_rn(__fdiv_rn(acc[i][j], width), bf[j]);
        v[j] = (int)((unsigned)__float2int_rd(u) + bi[j]);
      }
      int* o = out + (size_t)r * beta + col0;
      if (vec) {
        *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (col0 + j < beta) o[j] = v[j];
      }
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
  if (n <= 0 || beta <= 0) return (int)cudaGetLastError();
  const long long blocks =
      (((long long)n + BM - 1) / BM) * (((long long)beta + BN - 1) / BN);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  hash_encode_kernel<<<(unsigned)blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, w, a, b_int, b_frac, width, n, d, beta, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
