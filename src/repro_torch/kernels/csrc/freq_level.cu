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
// each up to L+1 levels deep, the same tests as the fused pass 1.
//
// What the design does about it: the level matching is the fused passes'
// own (level_match.cuh): a block takes ROWS rows (one thread each) and QT
// queries, so each staged code tile serves QT queries (the Pallas grid
// walks one query at a time and re-reads the codes for each); per-level
// query codes are computed once per block; the first agreeing level of a
// (row, lane) is counted without branches.  The output is written once,
// coalesced along the rows.  Integer results equal the plain version's
// exactly.

#include <cuda_runtime.h>
#include <stddef.h>

#include "level_match.cuh"

namespace {

constexpr int ROWS = 128;  // rows per block, one thread per row
constexpr int QT = 8;      // queries per block
constexpr int TC = 16;     // code lanes staged per chunk

using Match = wlsh::MatchSmem<ROWS, QT, TC>;

struct Args {
  const int* codes_p;  // (n, beta)
  const int* codes_q;  // (Q, beta)
  const int* mu;       // (Q,)
  const int* beta_q;   // (Q,)
  int* out;            // (Q, n)
  int n, beta, Q, c, L;
};

__host__ __device__ inline size_t smem_bytes(int L) {
  return Match::qb(L) + Match::ctile() + sizeof(int) * 2 * QT + Match::cnt(L);
}

template <int C>
__global__ void __launch_bounds__(ROWS) freq_level_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_qb = reinterpret_cast<int*>(smem);
  int* s_ctile = reinterpret_cast<int*>(smem + Match::qb(a.L));
  int* s_mu = reinterpret_cast<int*>(smem + Match::qb(a.L) + Match::ctile());
  int* s_bq = s_mu + QT;
  unsigned short* s_cnt = reinterpret_cast<unsigned short*>(s_bq + QT);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, a.Q - q0);
  const int row = row0 + tid;
  const bool live_row = row < a.n;

  if (tid < QT) {
    const bool live = tid < nq;
    s_mu[tid] = live ? a.mu[q0 + tid] : 0;
    s_bq[tid] = live ? min(max(a.beta_q[q0 + tid], 0), a.beta) : 0;
  }
  for (int i = tid; i < QT * (a.L + 2) * ROWS; i += ROWS) s_cnt[i] = 0;
  __syncthreads();

  int bmax = 0;
  for (int q = 0; q < nq; ++q) bmax = max(bmax, s_bq[q]);
  wlsh::count_agreements<ROWS, QT, TC, C>(a.codes_p, a.codes_q, a.n, a.beta,
                                          row0, q0, nq, a.c, a.L, s_bq, bmax,
                                          s_qb, s_ctile, s_cnt);
  int lf[QT];
  wlsh::first_frequent_levels<ROWS, QT>(s_cnt, s_mu, nq, live_row, a.L, lf);
  if (!live_row) return;
#pragma unroll
  for (int q = 0; q < QT; ++q)
    if (q < nq) a.out[(size_t)(q0 + q) * a.n + row] = lf[q];
}

template <int C>
int launch_c(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.L);
  cudaError_t err = cudaFuncSetAttribute(
      freq_level_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + ROWS - 1) / ROWS, (a.Q + QT - 1) / QT);
  freq_level_kernel<C><<<grid, ROWS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (Q, n) int32.  Returns cudaGetLastError() after the launch
// (0 = launched).
int wlsh_freq_level(const int* codes_p, const int* codes_q, const int* mu,
                    const int* beta_q, int n, int beta, int Q, int c, int L,
                    int* out, void* stream) {
  Args a{codes_p, codes_q, mu, beta_q, out, n, beta, Q, c, L};
  if (L < 0 || beta > 65535 || Q > 65535 * QT || smem_bytes(L) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || Q <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 2: return launch_c<2>(a, s);
    case 3: return launch_c<3>(a, s);
    default: return launch_c<0>(a, s);
  }
}

}  // extern "C"
