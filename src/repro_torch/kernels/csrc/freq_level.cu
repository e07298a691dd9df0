// First-frequent-level matrix for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by kernels/freq_level.py).
//
// Replaces the Pallas TPU kernel freq_level_pallas of the JAX package
// (src/repro/kernels/freq_level.py, body _kernel): out[q, o] = the first
// virtual-rehashing level j <= L at which at least mu[q] of the query's
// first beta_q[q] tables put point o in the query's bucket,
// floor(code / c^j) equal; L+1 if never.  This is stage 1 of the engine's
// unfused route (use_kernels="off"); dead rows and the ragged tail are the
// caller's business, as in the reference.
//
// What bounds it on this card: integer work.  It reads n*beta*4 bytes of
// codes and writes Q*n*4, but makes sum_q beta_q*n level-agreement tests,
// the same tests as the fused pass 1.  Each costs about a dozen
// instructions (one a quarter-rate bit scan) and one shared-memory atomic,
// so instruction issue and the shared-memory pipe bound it together.
//
// What the design does about it: it is the fused passes' matching half
// (level_match.cuh, first_frequent), with their tile and their rules.
//   * c = 2 and c = 3 find a (row, lane)'s first agreeing level in
//     constant time from base-c digit words (count_agreements_words:
//     an XOR and one bit scan, no branches); the word test is narrow for
//     c = 2 and for c = 3 at L <= 16, wide for c = 3 above (wlsh::wide3).
//     Each test adds one to a per-(query, row) level count with one shared
//     atomic, in slot order so that a warp's 32 updates hit 32 banks.
//   * Any other c (a run-time c) walks the levels with floor division
//     (count_agreements).
//   * A block takes ROWS rows (one thread each) and QT queries, so each
//     staged code tile serves QT queries (the Pallas grid walks one query
//     at a time and re-reads the codes for each).  The grid is 1-D with
//     the QT-query blocks of one row tile side by side, so all but the
//     first read the tile from L2, not HBM.
//   * Shared memory is the matching's alone (about 47 KB at c = 3, L = 16),
//     so 4 blocks of 128 threads fit on an SM, as in the fused pass.
//   * The output is written once, coalesced along the rows.  Integer
//     results equal the plain version's exactly.

#include <cuda_runtime.h>
#include <stddef.h>

#include "level_match.cuh"

namespace {

constexpr int ROWS = 128;  // rows per block, one thread per row
constexpr int QT = 8;      // queries per block
constexpr int TC = 16;     // code lanes staged per chunk

struct Args {
  const int* codes_p;  // (n, beta)
  const int* codes_q;  // (Q, beta)
  const int* mu;       // (Q,)
  const int* beta_q;   // (Q,)
  int* out;            // (Q, n)
  int n, beta, Q, c, L;
};

// The matching's arrays, then mu and beta_q of the block's queries.
template <int C>
__host__ __device__ inline size_t meta_offset(int L) {
  return wlsh::match_layout<ROWS, QT, TC, C>(L).end;
}

template <int C>
__host__ __device__ inline size_t smem_bytes(int L) {
  return meta_offset<C>(L) + sizeof(int) * 2 * QT;
}

// WIDE picks the c = 3 word test for L > 16 (level_match.cuh, Digits).
template <int C, bool WIDE>
__global__ void __launch_bounds__(ROWS) freq_level_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_mu = reinterpret_cast<int*>(smem + meta_offset<C>(a.L));
  int* s_bq = s_mu + QT;

  const int tid = threadIdx.x;
  // the query blocks of one row tile are neighbours in launch order
  const int nqb = (a.Q + QT - 1) / QT;
  const int row0 = (blockIdx.x / nqb) * ROWS;
  const int q0 = (blockIdx.x % nqb) * QT;
  const int nq = min(QT, a.Q - q0);
  const int row = row0 + tid;

  if (tid < QT) {
    const bool live = tid < nq;
    s_mu[tid] = live ? a.mu[q0 + tid] : 0;
    s_bq[tid] = live ? min(max(a.beta_q[q0 + tid], 0), a.beta) : 0;
  }
  wlsh::match_init<ROWS, QT, TC, C>(smem, a.L);
  __syncthreads();

  int lf[QT];
  wlsh::first_frequent<ROWS, QT, TC, C, WIDE>(a.codes_p, a.codes_q, a.n,
                                              a.beta, row0, q0, nq, a.c, a.L,
                                              s_mu, s_bq, smem, lf);
  if (row >= a.n) return;
#pragma unroll
  for (int q = 0; q < QT; ++q)
    if (q < nq) a.out[(size_t)(q0 + q) * a.n + row] = lf[q];
}

template <int C, bool WIDE>
cudaError_t set_smem(size_t* smem, int L) {
  *smem = smem_bytes<C>(L);
  if (*smem > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(freq_level_kernel<C, WIDE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <int C, bool WIDE>
int launch_c(const Args& a, cudaStream_t stream) {
  size_t smem;
  const cudaError_t err = set_smem<C, WIDE>(&smem, a.L);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = ((a.n + ROWS - 1) / ROWS) * ((a.Q + QT - 1) / QT);
  freq_level_kernel<C, WIDE><<<nblocks, ROWS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int C, bool WIDE>
int occupancy_c(int L, int* out) {
  size_t smem;
  cudaError_t err = set_smem<C, WIDE>(&smem, L);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, freq_level_kernel<C, WIDE>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], freq_level_kernel<C, WIDE>, ROWS, smem);
  out[0] = (int)smem;
  out[2] = attr.numRegs;
  return (int)err;
}

}  // namespace

extern "C" {

// out (Q, n) int32.  Returns cudaGetLastError() after the launch
// (0 = launched).
int wlsh_freq_level(const int* codes_p, const int* codes_q, const int* mu,
                    const int* beta_q, int n, int beta, int Q, int c, int L,
                    int* out, void* stream) {
  Args a{codes_p, codes_q, mu, beta_q, out, n, beta, Q, c, L};
  if (L < 0 || beta > 65535 ||
      (long long)((n + ROWS - 1) / ROWS) * ((Q + QT - 1) / QT) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || Q <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 2: return launch_c<2, false>(a, s);
    case 3: return wlsh::wide3(L) ? launch_c<3, true>(a, s)
                                  : launch_c<3, false>(a, s);
    default: return launch_c<0, false>(a, s);
  }
}

// What one launch at (c, L) gets: out[0] dynamic shared bytes per block,
// out[1] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[2] registers per
// thread.  Returns the CUDA error code.
int wlsh_freq_level_occupancy(int c, int L, int* out) {
  switch (c) {
    case 2: return occupancy_c<2, false>(L, out);
    case 3: return wlsh::wide3(L) ? occupancy_c<3, true>(L, out)
                                  : occupancy_c<3, false>(L, out);
    default: return occupancy_c<0, false>(L, out);
  }
}

}  // extern "C"
