// First-agreeing-level matching shared by the fused query passes
// (fused_query.cu) and the standalone freq_level kernel (freq_level.cu),
// so one fix serves both.
//
// For a block of ROWS rows (one thread each) and QT queries: the first
// level j <= L at which at least mu[q] of the query's first beta_q[q]
// lanes put the row in the query's bucket, floor(code / c^j) equal; L+1
// if none.
//
//   * Codes are staged TC lanes at a time (a 256 x 1024 int32 tile would
//     not fit in 227 KB).  For each lane the query's code is divided down
//     once per block into its L+1 level codes (in shared memory, read as
//     warp-wide broadcasts), and the row's code once per level.
//     Agreement is monotone in the level (a//c^j == b//c^j implies
//     equality at every higher level), so the first agreeing level of a
//     lane is the number of levels that disagree, counted without
//     branches.
//   * Each (query, row) keeps a count per first-agreement level,
//     cnt[0..L+1], in shared memory; the first frequent level is the first
//     level whose running count reaches mu, which equals the reference's
//     per-level recount exactly.
//   * Floor division rounds toward minus infinity (codes can be negative),
//     with c a template constant for c = 2 and c = 3 (0 = read it at run
//     time).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace wlsh {

template <int C>
__device__ __forceinline__ int floor_div(int x, int c) {
  const int dv = C > 0 ? C : c;
  const int q = x / dv;
  const int r = x - q * dv;
  return (r != 0 && ((r < 0) != (dv < 0))) ? q - 1 : q;
}

// Shared-memory sizes of the matching, for the callers' layouts.
template <int ROWS, int QT, int TC>
struct MatchSmem {
  // int [QT][TC][L+1] per-level query codes
  static __host__ __device__ size_t qb(int L) {
    return sizeof(int) * QT * TC * (L + 1);
  }
  // int [ROWS][TC+1] row codes of one lane chunk
  static __host__ __device__ size_t ctile() {
    return sizeof(int) * ROWS * (TC + 1);
  }
  // u16 [QT][L+2][ROWS] first-agreement level counts
  static __host__ __device__ size_t cnt(int L) {
    return sizeof(unsigned short) * QT * (L + 2) * ROWS;
  }
};

// Adds, for every live row (row0 + tid < B) and query q < nq of the block,
// one to s_cnt[(q * (L+2) + m) * ROWS + tid] per lane < s_bq[q] whose first
// agreeing level is m (L+1 = never).  s_cnt must be zeroed and s_bq
// (per-query lane counts, clamped to [0, beta]) visible to every thread
// before the call; bmax is the largest s_bq.  Synchronises the block.
template <int ROWS, int QT, int TC, int C>
__device__ __forceinline__ void count_agreements(
    const int* __restrict__ codes_p, const int* __restrict__ codes_q, int B,
    int beta, int row0, int q0, int nq, int c, int L, const int* s_bq,
    int bmax, int* s_qb, int* s_ctile, unsigned short* s_cnt) {
  const int L1 = L + 1, L2 = L + 2;
  const int tid = threadIdx.x;
  const bool live_row = row0 + tid < B;
  for (int t0 = 0; t0 < bmax; t0 += TC) {
    const int tc = min(TC, bmax - t0);
    for (int e = tid; e < QT * TC; e += ROWS) {
      const int q = e / TC, t = e % TC;
      if (q < nq && t < tc) {
        int b = codes_q[(size_t)(q0 + q) * beta + t0 + t];
        int* dst = s_qb + (q * TC + t) * L1;
        for (int j = 0; j < L1; ++j) {
          dst[j] = b;
          b = floor_div<C>(b, c);
        }
      }
    }
    for (int e = tid; e < ROWS * TC; e += ROWS) {
      const int r = e / TC, t = e % TC;
      const int gr = row0 + r;
      s_ctile[r * (TC + 1) + t] =
          (gr < B && t < tc) ? codes_p[(size_t)gr * beta + t0 + t] : 0;
    }
    __syncthreads();
    if (live_row) {
      for (int t = 0; t < tc; ++t) {
        int av = s_ctile[tid * (TC + 1) + t];
        int m[QT];
#pragma unroll
        for (int q = 0; q < QT; ++q) m[q] = 0;
        const int* qb = s_qb + t * L1;
        for (int j = 0; j < L1; ++j) {
#pragma unroll
          for (int q = 0; q < QT; ++q) m[q] += (av != qb[q * TC * L1 + j]);
          av = floor_div<C>(av, c);
        }
        const int lane = t0 + t;
#pragma unroll
        for (int q = 0; q < QT; ++q)
          if (q < nq && lane < s_bq[q]) s_cnt[(q * L2 + m[q]) * ROWS + tid] += 1;
      }
    }
    __syncthreads();
  }
}

// lf[q] = the first level whose running count reaches s_mu[q], L+1 if none
// (also for a dead row or a query past nq).
template <int ROWS, int QT>
__device__ __forceinline__ void first_frequent_levels(
    const unsigned short* s_cnt, const int* s_mu, int nq, bool live_row,
    int L, int (&lf)[QT]) {
  const int L1 = L + 1, L2 = L + 2;
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    int v = L1;
    if (live_row && q < nq) {
      int run = 0;
      for (int j = 0; j < L1; ++j) {
        run += s_cnt[(q * L2 + j) * ROWS + tid];
        if (run >= s_mu[q]) {
          v = j;
          break;
        }
      }
    }
    lf[q] = v;
  }
}

}  // namespace wlsh
