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
// n*d*4 bytes per launch but makes Q*n*beta_q level-agreement tests, so it
// sits far above the memory roofline; the distance adds Q*n*d
// multiply-adds in float32.  Each test costs about 13 instructions (one a
// quarter-rate bit scan) and one shared-memory atomic, so issue and the
// shared-memory pipe bound the matching together.
//
// What the design does about it:
//   * One launch covers the whole state; the TPU grid's sequential block
//     axis becomes parallel blocks, and histogram sums are order-free
//     integer atomics (shared memory per block, then one global add per
//     nonzero bin), so the result equals the reference's running sums.
//   * A block takes ROWS rows (one thread each) and QT queries, so every
//     code and vector tile it stages serves QT queries.  The QT-query
//     blocks of one row tile are neighbours in launch order, so all but
//     the first read the tile's codes and vectors from L2, not HBM.
//   * Level test in constant time (level_match.cuh,
//     count_agreements_words): for c = 2 and c = 3 the first agreeing
//     level of a (row, lane) is one more than the highest differing base-c
//     digit of the two codes, from an XOR and a bit scan of their digit
//     words, without branches; a query's words are made once per block, a
//     row's once per block for all QT queries, and each test adds one to a
//     per-(query, row) level count in shared memory with one atomic, laid
//     out so that a warp's 32 updates hit 32 banks.  Any other c walks the
//     levels with floor division (count_agreements).
//   * The matching (query words, code tile, counts) and the distance
//     (vector tile, query weights) are never live together: lf[] is in
//     registers once the counts are read.  They share one region of
//     shared memory, so more blocks fit on an SM (4 of 128 threads at
//     L = 16).
//   * Vector storage: float32 or bfloat16 rows (VT).  A bfloat16 row is
//     widened to float32 as it is staged into shared memory, exactly (a
//     bfloat16 is a float32 with its low 16 mantissa bits zero), so every
//     sum after the load is the float32 one, and the state's rows are never
//     copied to float32 in device memory.  The JAX package widens the
//     whole block before its Pallas call; the result is the same.
//   * Float order follows the reference: p = 2 uses the norms expansion
//     qw2 - 2 cross + onorm clamped at 0, then sqrtf; the good-level ceil
//     is logf(max(dist, 1e-30)) / log(c) - logf(c r_min) / log(c).  The
//     file is built without fast math, so logf, powf, sqrtf and division
//     are the accurate ones.
//
// ROWS, QT and TC and the narrow c = 3 word test at L <= 16 were chosen by
// timing variants on the card (PERF.md, the fused passes' variants table).

#include <cuda_bf16.h>
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
  const void* points;     // (B, d) float or __nv_bfloat16 (vec_bf16)
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
  int B, beta, Q, d, boff, n_valid, c, L, vec_bf16, pkind;
  float p, inv_p, logc;
};

using wlsh::align16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared-memory carve-up, shared by the kernel and the host size check.
// The matching's arrays and the distance's share [0, meta).
struct Layout {
  size_t ptile, wa, wb, meta, hist, total;
};

template <int C>
__host__ __device__ inline Layout layout(int L) {
  Layout s;
  const size_t L3 = L + 3;
  // matching: wlsh::match_layout (digit table, query words or level codes,
  // code tile, level counts)
  const size_t match_end = wlsh::match_layout<ROWS, QT, TC, C>(L).end;
  // distance, over the same bytes
  s.ptile = 0;                                           // float [ROWS][DC+1]
  s.wa = s.ptile + sizeof(float) * ROWS * (DC + 1);      // float [QT][DC]
  s.wb = s.wa + sizeof(float) * QT * DC;                 // float [QT][DC]
  const size_t dist_end = s.wb + sizeof(float) * QT * DC;
  s.meta = align16(match_end > dist_end ? match_end : dist_end);  // 5 x [QT]
  s.hist = s.meta + sizeof(int) * 5 * QT;                // int [2][QT][L+3]
  s.total = s.hist + sizeof(int) * 2 * QT * L3;
  return s;
}

// MODE 0 = pass 1 (histograms), MODE 1 = pass 2 (scores); WIDE picks the
// c = 3 word test for L > 16 (level_match.cuh, Digits); VT is the vector
// storage type (float or __nv_bfloat16).
template <int MODE, int C, bool WIDE, typename VT>
__global__ void __launch_bounds__(ROWS) fused_query_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout<C>(a.L);
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
  const VT* points = static_cast<const VT*>(a.points);

  const int L2 = a.L + 2, L3 = a.L + 3;
  const int tid = threadIdx.x;
  // the query blocks of one row tile are neighbours in launch order
  const int nqb = (a.Q + QT - 1) / QT;
  const int row0 = (blockIdx.x / nqb) * ROWS;
  const int q0 = (blockIdx.x % nqb) * QT;
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
  wlsh::match_init<ROWS, QT, TC, C>(smem, a.L);
  if (MODE == 0)
    for (int i = tid; i < 2 * QT * L3; i += ROWS) s_hf[i] = 0;
  __syncthreads();

  // ---- first-frequent level (level_match.cuh) ---------------------------
  int lf[QT];
  wlsh::first_frequent<ROWS, QT, TC, C, WIDE>(a.codes_p, a.codes_q, a.B,
                                              a.beta, row0, q0, nq, a.c, a.L,
                                              s_mu, s_bq, smem, lf);
  __syncthreads();  // the distance's tiles overwrite the counts

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
          (gr < a.B && i < dc) ? widen(points[(size_t)gr * a.d + i0 + i])
                               : 0.0f;
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

template <int MODE, int C, bool WIDE, typename VT>
cudaError_t set_smem(size_t* smem, int L) {
  *smem = layout<C>(L).total;
  return cudaFuncSetAttribute(fused_query_kernel<MODE, C, WIDE, VT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <int MODE, int C, bool WIDE, typename VT>
int launch_t(const Args& a, cudaStream_t stream) {
  if (layout<C>(a.L).total > 227 * 1024) return (int)cudaErrorInvalidValue;
  size_t smem;
  const cudaError_t err = set_smem<MODE, C, WIDE, VT>(&smem, a.L);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = ((a.B + ROWS - 1) / ROWS) * ((a.Q + QT - 1) / QT);
  fused_query_kernel<MODE, C, WIDE, VT><<<nblocks, ROWS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE, int C, bool WIDE>
int launch_c(const Args& a, cudaStream_t stream) {
  return a.vec_bf16 ? launch_t<MODE, C, WIDE, __nv_bfloat16>(a, stream)
                    : launch_t<MODE, C, WIDE, float>(a, stream);
}

template <int MODE>
int launch(Args& a, void* stream) {
  if (a.L < 0 || a.beta > 65535 ||
      (long long)((a.B + ROWS - 1) / ROWS) * ((a.Q + QT - 1) / QT) >
          0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0 || a.Q <= 0) return (int)cudaGetLastError();
  a.pkind = fabsf(a.p - 2.0f) < 1e-6f ? 0 : (fabsf(a.p - 1.0f) < 1e-6f ? 1 : 2);
  a.inv_p = (float)(1.0 / (double)a.p);
  a.logc = (float)log((double)a.c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.c) {
    case 2: return launch_c<MODE, 2, false>(a, s);
    case 3: return wlsh::wide3(a.L) ? launch_c<MODE, 3, true>(a, s)
                              : launch_c<MODE, 3, false>(a, s);
    default: return launch_c<MODE, 0, false>(a, s);
  }
}

// (for float32 rows; the bfloat16 build takes the same shared memory)
template <int MODE, int C, bool WIDE>
int occupancy_c(int L, int* out) {
  size_t smem;
  cudaError_t err = set_smem<MODE, C, WIDE, float>(&smem, L);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr,
                                fused_query_kernel<MODE, C, WIDE, float>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], fused_query_kernel<MODE, C, WIDE, float>, ROWS, smem);
  out[0] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = ROWS;
  out[4] = QT;
  out[5] = TC;
  return (int)err;
}

template <int MODE>
int occupancy(int c, int L, int* out) {
  switch (c) {
    case 2: return occupancy_c<MODE, 2, false>(L, out);
    case 3: return wlsh::wide3(L) ? occupancy_c<MODE, 3, true>(L, out)
                            : occupancy_c<MODE, 3, false>(L, out);
    default: return occupancy_c<MODE, 0, false>(L, out);
  }
}

}  // namespace

extern "C" {

// Pass 1: hist_f, hist_g (Q, L+3) int32, zero-filled by the caller.
// points is float32 (vec_bf16 = 0) or bfloat16 (vec_bf16 = 1).
// Returns cudaGetLastError() after the launch (0 = launched).
int wlsh_fused_query_hist(const int* codes_p, const void* points,
                          const int* codes_q, const float* queries,
                          const float* q_weight, const int* mu,
                          const int* beta_q, const float* r_min, int B,
                          int beta, int Q, int d, int boff, int n_valid,
                          int c, int L, int vec_bf16, float p, int* hist_f,
                          int* hist_g, void* stream) {
  Args a{};
  a.codes_p = codes_p; a.points = points; a.codes_q = codes_q;
  a.queries = queries; a.q_weight = q_weight; a.mu = mu; a.beta_q = beta_q;
  a.r_min = r_min; a.hist_f = hist_f; a.hist_g = hist_g;
  a.B = B; a.beta = beta; a.Q = Q; a.d = d; a.boff = boff;
  a.n_valid = n_valid; a.c = c; a.L = L; a.vec_bf16 = vec_bf16; a.p = p;
  return launch<0>(a, stream);
}

// Pass 2: scores (Q, B) float32; points as in pass 1.  Returns
// cudaGetLastError().
int wlsh_fused_query_scores(const int* codes_p, const void* points,
                            const int* codes_q, const float* queries,
                            const float* q_weight, const int* mu,
                            const int* beta_q, const int* stop, int B,
                            int beta, int Q, int d, int boff, int n_valid,
                            int c, int L, int vec_bf16, float p,
                            float* scores, void* stream) {
  Args a{};
  a.codes_p = codes_p; a.points = points; a.codes_q = codes_q;
  a.queries = queries; a.q_weight = q_weight; a.mu = mu; a.beta_q = beta_q;
  a.stop = stop; a.scores = scores;
  a.B = B; a.beta = beta; a.Q = Q; a.d = d; a.boff = boff;
  a.n_valid = n_valid; a.c = c; a.L = L; a.vec_bf16 = vec_bf16; a.p = p;
  return launch<1>(a, stream);
}

// What one launch of pass `mode` (0 = hist, 1 = scores) at (c, L) gets:
// out[0] dynamic shared bytes per block, out[1] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[2] registers per
// thread, out[3..5] ROWS, QT, TC.  Returns the CUDA error code.
int wlsh_fused_query_occupancy(int mode, int c, int L, int* out) {
  return mode == 0 ? occupancy<0>(c, L, out) : occupancy<1>(c, L, out);
}

}  // extern "C"
