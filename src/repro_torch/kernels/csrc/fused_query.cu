// Fused WLSH query passes for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by kernels/fused_query.py).
//
// Replaces the two Pallas TPU kernels of the JAX package,
// src/repro/kernels/fused_query.py:
//   pass 1  fused_query_hist_pallas   (_hist_kernel, _lf_and_dist, _row_ok)
//   pass 2  fused_query_scores_pallas (_scores_kernel)
// Both compute, per (query, row): the first-frequent level lf (the first
// virtual-rehashing level j <= L at which at least mu of the query's first
// beta_q tables put the row in the query's bucket, L+1 if none), and the
// weighted l_p distance.  Pass 1 adds the good level
// max(lf, ceil(max(log_c dist - log_c(c r_min), 0))) and accumulates
// one-hot histograms of the frequent and good levels per query (dead rows
// in bin L+2); pass 2 writes the distance, or +inf where lf > stop[q] or
// the row is dead.
//
// What bounds it on this card: integer work.  Pass 1 reads n*beta*4 +
// n*d*4 bytes per launch but makes Q*n*beta_q level-agreement tests, each
// up to L+1 levels deep, so it sits far above the memory roofline; the
// distance adds Q*n*d multiply-adds in float32.
//
// What the design does about it:
//   * One launch covers the whole state; the TPU grid's sequential block
//     axis becomes parallel blocks, and histogram sums are order-free
//     integer atomics (shared memory per block, then one global add per
//     nonzero bin), so the result equals the reference's running sums.
//   * A block takes ROWS rows (one thread each) and QT queries, so every
//     code and vector tile it stages in shared memory serves QT queries
//     (the Pallas grid re-reads codes for every query).
//   * The first-frequent level comes from level_match.cuh, shared with the
//     standalone freq_level kernel: codes staged TC lanes at a time,
//     per-level query codes computed once per block, branch-free
//     first-agreement counts per (query, row) in shared memory, floor
//     division toward minus infinity with c = 2 and c = 3 as template
//     constants.
//   * Float order follows the reference: p = 2 uses the norms expansion
//     qw2 - 2 cross + onorm clamped at 0, then sqrtf; the good-level ceil
//     is logf(max(dist, 1e-30)) / log(c) - logf(c r_min) / log(c).  The
//     file is built without fast math, so logf, powf, sqrtf and division
//     are the accurate ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "level_match.cuh"

namespace {

constexpr int ROWS = 128;  // rows per block, one thread per row
constexpr int QT = 8;      // queries per block
constexpr int TC = 16;     // code lanes staged per chunk
constexpr int DC = 32;     // vector dims staged per chunk

struct Args {
  const int* codes_p;     // (B, beta)
  const float* points;    // (B, d)
  const int* codes_q;     // (Q, beta)
  const float* queries;   // (Q, d)
  const float* q_weight;  // (Q, d)
  const int* mu;          // (Q,)
  const int* beta_q;      // (Q,)
  const float* r_min;     // (Q,)  pass 1
  const int* stop;        // (Q,)  pass 2
  int* hist_f;            // (Q, L+3) pass 1, zeroed by the caller
  int* hist_g;            // (Q, L+3) pass 1, zeroed by the caller
  float* scores;          // (Q, B) pass 2
  int B, beta, Q, d, boff, n_valid, c, L, pkind;
  float p, inv_p, logc;
};

using Match = wlsh::MatchSmem<ROWS, QT, TC>;

// Shared-memory carve-up, shared by the kernel and the host size check.
struct Layout {
  size_t qb, ctile, ptile, wa, wb, meta, hist, cnt, total;
};

__host__ __device__ inline Layout layout(int L) {
  Layout s;
  const size_t L3 = L + 3;
  s.qb = 0;                                             // int [QT][TC][L+1]
  s.ctile = s.qb + Match::qb(L);                        // int [ROWS][TC+1]
  s.ptile = s.ctile + Match::ctile();                   // float [ROWS][DC+1]
  s.wa = s.ptile + sizeof(float) * ROWS * (DC + 1);     // float [QT][DC]
  s.wb = s.wa + sizeof(float) * QT * DC;                // float [QT][DC]
  s.meta = s.wb + sizeof(float) * QT * DC;              // 5 x [QT] words
  s.hist = s.meta + sizeof(int) * 5 * QT;               // int [2][QT][L+3]
  s.cnt = s.hist + sizeof(int) * 2 * QT * L3;           // u16 [QT][L+2][ROWS]
  s.total = s.cnt + Match::cnt(L);
  return s;
}

// MODE 0 = pass 1 (histograms), MODE 1 = pass 2 (scores).
template <int MODE, int C>
__global__ void __launch_bounds__(ROWS) fused_query_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(a.L);
  int* s_qb = reinterpret_cast<int*>(smem + lay.qb);
  int* s_ctile = reinterpret_cast<int*>(smem + lay.ctile);
  float* s_ptile = reinterpret_cast<float*>(smem + lay.ptile);
  float* s_wa = reinterpret_cast<float*>(smem + lay.wa);
  float* s_wb = reinterpret_cast<float*>(smem + lay.wb);
  int* s_mu = reinterpret_cast<int*>(smem + lay.meta);
  int* s_bq = s_mu + QT;
  float* s_rmin = reinterpret_cast<float*>(s_bq + QT);
  int* s_stop = reinterpret_cast<int*>(s_rmin + QT);
  float* s_qw2 = reinterpret_cast<float*>(s_stop + QT);
  int* s_hf = reinterpret_cast<int*>(smem + lay.hist);
  int* s_hg = s_hf + QT * (a.L + 3);
  unsigned short* s_cnt = reinterpret_cast<unsigned short*>(smem + lay.cnt);

  const int L2 = a.L + 2, L3 = a.L + 3;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, a.Q - q0);
  const int row = row0 + tid;
  const bool live_row = row < a.B;

  if (tid < QT) {
    const bool live = tid < nq;
    const int q = q0 + tid;
    s_mu[tid] = live ? a.mu[q] : 0;
    s_bq[tid] = live ? min(max(a.beta_q[q], 0), a.beta) : 0;
    s_rmin[tid] = (live && MODE == 0) ? a.r_min[q] : 1.0f;
    s_stop[tid] = (live && MODE == 1) ? a.stop[q] : -1;
    float qw2 = 0.0f;
    if (live && a.pkind == 0) {  // sum((w2 * q) * q), blocked like the rows
      for (int i0 = 0; i0 < a.d; i0 += DC) {
        float part = 0.0f;
        for (int i = i0; i < min(i0 + DC, a.d); ++i) {
          const float w = a.q_weight[(size_t)q * a.d + i];
          const float x = a.queries[(size_t)q * a.d + i];
          part += (w * w * x) * x;
        }
        qw2 += part;
      }
    }
    s_qw2[tid] = qw2;
  }
  for (int i = tid; i < QT * L2 * ROWS; i += ROWS) s_cnt[i] = 0;
  if (MODE == 0)
    for (int i = tid; i < 2 * QT * L3; i += ROWS) s_hf[i] = 0;
  __syncthreads();

  int bmax = 0;
  for (int q = 0; q < nq; ++q) bmax = max(bmax, s_bq[q]);

  // ---- first-frequent level (level_match.cuh) ---------------------------
  wlsh::count_agreements<ROWS, QT, TC, C>(a.codes_p, a.codes_q, a.B, a.beta,
                                          row0, q0, nq, a.c, a.L, s_bq, bmax,
                                          s_qb, s_ctile, s_cnt);
  int lf[QT];
  wlsh::first_frequent_levels<ROWS, QT>(s_cnt, s_mu, nq, live_row, a.L, lf);

  // ---- weighted l_p distance, DC dims at a time ---------------------------
  float acc0[QT], acc1[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) acc0[q] = acc1[q] = 0.0f;
  for (int i0 = 0; i0 < a.d; i0 += DC) {
    const int dc = min(DC, a.d - i0);
    for (int e = tid; e < QT * DC; e += ROWS) {
      const int q = e / DC, i = e % DC;
      float va = 0.0f, vb = 0.0f;
      if (q < nq && i < dc) {
        const float x = a.queries[(size_t)(q0 + q) * a.d + i0 + i];
        const float w = a.q_weight[(size_t)(q0 + q) * a.d + i0 + i];
        if (a.pkind == 0) {
          va = (w * w) * x;
          vb = w * w;
        } else {
          va = x;
          vb = w;
        }
      }
      s_wa[e] = va;
      s_wb[e] = vb;
    }
    for (int e = tid; e < ROWS * DC; e += ROWS) {
      const int r = e / DC, i = e % DC;
      const int gr = row0 + r;
      s_ptile[r * (DC + 1) + i] =
          (gr < a.B && i < dc) ? a.points[(size_t)gr * a.d + i0 + i] : 0.0f;
    }
    __syncthreads();
    if (live_row) {
      // Two-level sums: each DC-dim chunk is summed on its own, then added
      // to the running total, which keeps the float32 rounding error of a
      // d = 400 sum near that of a blocked matrix product.
      const float* xr = s_ptile + tid * (DC + 1);
      float part0[QT], part1[QT];
#pragma unroll
      for (int q = 0; q < QT; ++q) part0[q] = part1[q] = 0.0f;
      if (a.pkind == 0) {
        for (int i = 0; i < dc; ++i) {
          const float x = xr[i];
          const float x2 = x * x;
#pragma unroll
          for (int q = 0; q < QT; ++q) {
            part0[q] += s_wa[q * DC + i] * x;
            part1[q] += s_wb[q * DC + i] * x2;
          }
        }
      } else if (a.pkind == 1) {
        for (int i = 0; i < dc; ++i) {
          const float x = xr[i];
#pragma unroll
          for (int q = 0; q < QT; ++q)
            part0[q] += fabsf((s_wa[q * DC + i] - x) * s_wb[q * DC + i]);
        }
      } else {
        for (int i = 0; i < dc; ++i) {
          const float x = xr[i];
#pragma unroll
          for (int q = 0; q < QT; ++q)
            part0[q] += powf(fabsf((s_wa[q * DC + i] - x) * s_wb[q * DC + i]),
                             a.p);
        }
      }
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        acc0[q] += part0[q];
        acc1[q] += part1[q];
      }
    }
    __syncthreads();
  }

  const bool ok = live_row && (a.boff + row) < a.n_valid;
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    if (!live_row || q >= nq) continue;
    float dist;
    if (a.pkind == 0) {
      const float d2 = (s_qw2[q] - 2.0f * acc0[q]) + acc1[q];
      dist = sqrtf(fmaxf(d2, 0.0f));
    } else if (a.pkind == 1) {
      dist = acc0[q];
    } else {
      dist = powf(acc0[q], a.inv_p);
    }
    if (MODE == 0) {
      int bf = L2, bg = L2;
      if (ok) {
        const float base = logf((float)a.c * s_rmin[q]) / a.logc;
        const float lg = logf(fmaxf(dist, 1e-30f)) / a.logc;
        const int jg = (int)ceilf(fmaxf(lg - base, 0.0f));
        bf = lf[q];
        bg = max(lf[q], jg);
      }
      atomicAdd(&s_hf[q * L3 + bf], 1);
      if (bg <= L2) atomicAdd(&s_hg[q * L3 + bg], 1);
    } else {
      a.scores[(size_t)(q0 + q) * a.B + row] =
          (ok && lf[q] <= s_stop[q]) ? dist : INFINITY;
    }
  }

  if (MODE == 0) {
    __syncthreads();
    for (int e = tid; e < nq * L3; e += ROWS) {
      const int vf = s_hf[e], vg = s_hg[e];
      const size_t g = (size_t)q0 * L3 + e;  // rows q0.. of (Q, L+3)
      if (vf) atomicAdd(&a.hist_f[g], vf);
      if (vg) atomicAdd(&a.hist_g[g], vg);
    }
  }
}

template <int MODE, int C>
int launch_c(const Args& a, cudaStream_t stream) {
  const size_t smem = layout(a.L).total;
  cudaError_t err = cudaFuncSetAttribute(
      fused_query_kernel<MODE, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + ROWS - 1) / ROWS, (a.Q + QT - 1) / QT);
  fused_query_kernel<MODE, C><<<grid, ROWS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(Args& a, void* stream) {
  if (a.L < 0 || a.beta > 65535 || layout(a.L).total > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0 || a.Q <= 0) return (int)cudaGetLastError();
  a.pkind = fabsf(a.p - 2.0f) < 1e-6f ? 0 : (fabsf(a.p - 1.0f) < 1e-6f ? 1 : 2);
  a.inv_p = (float)(1.0 / (double)a.p);
  a.logc = (float)log((double)a.c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.c) {
    case 2: return launch_c<MODE, 2>(a, s);
    case 3: return launch_c<MODE, 3>(a, s);
    default: return launch_c<MODE, 0>(a, s);
  }
}

}  // namespace

extern "C" {

// Pass 1: hist_f, hist_g (Q, L+3) int32, zero-filled by the caller.
// Returns cudaGetLastError() after the launch (0 = launched).
int wlsh_fused_query_hist(const int* codes_p, const float* points,
                          const int* codes_q, const float* queries,
                          const float* q_weight, const int* mu,
                          const int* beta_q, const float* r_min, int B,
                          int beta, int Q, int d, int boff, int n_valid,
                          int c, int L, float p, int* hist_f, int* hist_g,
                          void* stream) {
  Args a{};
  a.codes_p = codes_p; a.points = points; a.codes_q = codes_q;
  a.queries = queries; a.q_weight = q_weight; a.mu = mu; a.beta_q = beta_q;
  a.r_min = r_min; a.hist_f = hist_f; a.hist_g = hist_g;
  a.B = B; a.beta = beta; a.Q = Q; a.d = d; a.boff = boff;
  a.n_valid = n_valid; a.c = c; a.L = L; a.p = p;
  return launch<0>(a, stream);
}

// Pass 2: scores (Q, B) float32.  Returns cudaGetLastError().
int wlsh_fused_query_scores(const int* codes_p, const float* points,
                            const int* codes_q, const float* queries,
                            const float* q_weight, const int* mu,
                            const int* beta_q, const int* stop, int B,
                            int beta, int Q, int d, int boff, int n_valid,
                            int c, int L, float p, float* scores,
                            void* stream) {
  Args a{};
  a.codes_p = codes_p; a.points = points; a.codes_q = codes_q;
  a.queries = queries; a.q_weight = q_weight; a.mu = mu; a.beta_q = beta_q;
  a.stop = stop; a.scores = scores;
  a.B = B; a.beta = beta; a.Q = Q; a.d = d; a.boff = boff;
  a.n_valid = n_valid; a.c = c; a.L = L; a.p = p;
  return launch<1>(a, stream);
}

}  // extern "C"
