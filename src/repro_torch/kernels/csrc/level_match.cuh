// First-agreeing-level matching, shared by the fused query passes
// (fused_query.cu) and the standalone freq_level kernel (freq_level.cu).
//
// For a block of ROWS rows (one thread each) and QT queries: the first
// level j <= L at which at least mu[q] of the query's first beta_q[q]
// lanes put the row in the query's bucket, floor(code / c^j) equal; L+1
// if none.  Codes are staged TC lanes at a time (a 256 x 1024 int32 tile
// would not fit in 227 KB).  Each (query, row) keeps a count per first
// agreeing level m of a lane, cnt[0..L+1], in shared memory; the first
// frequent level is the first level whose running count reaches mu, which
// equals the reference's per-level recount exactly, since agreement is
// monotone in the level (a//c^j == b//c^j implies equality at every
// higher level).  Two ways to find m:
//
//   * count_agreements_words (c = 2 and c = 3): a constant-time test on
//     base-c digit words.  Agreement at level j holds exactly when the
//     base-c digits of a and b agree from position j up, so m is one more
//     than the highest differing digit, read off the XOR of two words
//     with one bit scan (FLO).  Each query code becomes its word once per
//     block (8 B in shared memory, two queries per 128-bit load), each row
//     code once per block for all QT queries (c = 3: one int32 floor
//     division by 3^10 and three lookups in a 3^6-entry table).  A test is
//     branch-free: an XOR, the scan, a shift, a compare, a select and a
//     min, then one shared-memory atomic add on the count.  The counts sit
//     in slot order (count_slot), so a warp's 32 updates hit 32 banks.
//     wide3(L) picks the word test for c = 3 (Digits).
//   * count_agreements (any other c, including a run-time one): the
//     query's code divided down once per block into its L+1 level codes
//     (in shared memory, read as warp-wide broadcasts), the row's code
//     once per level, and m counted as the number of disagreeing levels,
//     without branches.  Floor division rounds toward minus infinity
//     (codes can be negative), with c a template constant where the
//     caller has one (0 = read it at run time).
//
// match_layout, match_init and first_frequent wrap both for a kernel:
// where the arrays sit in shared memory, their set-up, and lf[] per query.

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

// c = 3 takes the wide word test above L = 16, the narrow one up to it
// (Digits); ref._wide is the same rule.
__host__ __device__ constexpr bool wide3(int L) { return L > 16; }

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

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

// ---- digit words ---------------------------------------------------------
//
// A word is two 32-bit halves: x holds the low digits, 32 / (bits per
// digit) of them, and y the rest of the code.
//   c = 2: x = bits 0..30 of the code, y its sign (0 or ~0).  Codes of
//          opposite signs agree at no level (floor(a / 2^j) is -1
//          against >= 0 for every j >= 31); codes of one sign agree from
//          one past their highest differing bit.
//   c = 3: a + 3^20 lies in [0, 3^21) for every int32 a, and adding a
//          multiple of 3^j changes no level-j equality for j <= 20, so
//          its 21 base-3 digits decide: x = digits 0..15, 2 bits each;
//          y = digits 16..20 as their value (< 3^5, narrow) or 2 bits
//          each (wide).  Digit 20 is 1 exactly when a >= 0, and for
//          j >= 21 floor(a / 3^j) is -1 or 0 by sign, so digit 20 plays
//          the sign's part.
// First agreeing level m, with hd the highest differing digit of x (-1
// for equal halves):
//   narrow (c = 2 at any L, c = 3 at L <= 16): L+1 where y differs (the
//     codes differ at a digit >= 16 or in sign), else min(hd + 1, L+1);
//   wide (c = 3 at any L): hd over both halves; L+1 where hd >= 20, else
//     min(hd + 1, L+1).
// dead() differs in y from every code's word (at the sign digit, for the
// wide form): a (query, lane) outside the query's lanes gets that word
// and counts in bin L+1, which first_frequent_levels never reads.
template <int C, bool WIDE>
struct Digits;

// the highest set bit of x, -1 for x = 0
__device__ __forceinline__ int top_bit(unsigned x) { return 31 - __clz(x); }

// min(hd + 1, L+1) from the low halves' highest differing digit (2^SHIFT
// bits a digit), or L+1 where the high halves differ.  Branch-free: the
// bit scan runs whatever the high halves hold (a select around it
// compiles into a divergent branch per query).
template <int SHIFT>
__device__ __forceinline__ int narrow_level(uint2 a, uint2 b, int L1) {
  const int m = (top_bit(a.x ^ b.x) >> SHIFT) + 1;  // 0 for equal halves
  return min(m + (a.y != b.y ? L1 : 0), L1);
}

template <>
struct Digits<2, false> {
  __device__ static __forceinline__ uint2 dead() { return make_uint2(0u, 1u); }
  __device__ static __forceinline__ uint2 word(int a, const unsigned short*) {
    return make_uint2((unsigned)a & 0x7fffffffu, (unsigned)(a >> 31));
  }
  __device__ static __forceinline__ int level(uint2 a, uint2 b, int L1) {
    return narrow_level<0>(a, b, L1);
  }
};

constexpr int kTab3 = 729;  // 3^6: the c = 3 table's six-digit entries

// tab[v] = v's six base-3 digits, 2 bits each (v < 3^6).  a + 3^20 =
// hi * 3^10 + lo with hi = floor(a / 3^10) + 3^10 < 3^11 and lo =
// a mod 3^10, both from one int32 floor division; digits 0..15 come from
// three table entries, and digits 16..20 are hi / 3^6.
struct Base3 {
  // Fills tab (kTab3 entries) cooperatively; the caller synchronises.
  __device__ static __forceinline__ void fill(unsigned short* tab,
                                              int nthreads) {
    for (int v = threadIdx.x; v < kTab3; v += nthreads) {
      unsigned w = 0;
      for (int k = 0, x = v; k < 6; ++k, x /= 3) w |= (unsigned)(x % 3) << 2 * k;
      tab[v] = (unsigned short)w;
    }
  }
  // digits 0..15 of a + 3^20 (2 bits each) and digits 16..20's value
  __device__ static __forceinline__ uint2 split(int a,
                                                const unsigned short* tab) {
    constexpr int P10 = 59049;  // 3^10
    int q = a / P10;
    int r = a - q * P10;
    if (r < 0) {
      q -= 1;
      r += P10;
    }
    const unsigned lo = (unsigned)r, hi = (unsigned)(q + P10);
    const unsigned l1 = lo / kTab3, h1 = hi / kTab3;
    return make_uint2(tab[lo - l1 * kTab3] | ((unsigned)tab[l1] << 12) |
                          ((unsigned)tab[hi - h1 * kTab3] << 20),
                      h1);
  }
};

template <>
struct Digits<3, false> {  // L <= 16
  __device__ static __forceinline__ uint2 dead() {  // y > 3^5 - 1
    return make_uint2(0u, 255u);
  }
  __device__ static __forceinline__ uint2 word(int a,
                                               const unsigned short* tab) {
    return Base3::split(a, tab);
  }
  __device__ static __forceinline__ int level(uint2 a, uint2 b, int L1) {
    return narrow_level<1>(a, b, L1);
  }
};

template <>
struct Digits<3, true> {
  __device__ static __forceinline__ uint2 dead() {  // digit 20 = 2
    return make_uint2(0u, 2u << 8);
  }
  __device__ static __forceinline__ uint2 word(int a,
                                               const unsigned short* tab) {
    const uint2 w = Base3::split(a, tab);
    return make_uint2(w.x, tab[w.y]);
  }
  __device__ static __forceinline__ int level(uint2 a, uint2 b, int L1) {
    const int lo = top_bit(a.x ^ b.x) >> 1;  // -1 >> 1 = -1 if equal
    const int hi = top_bit(a.y ^ b.y) >> 1;
    const int hd = max(lo, (16 + hi) | (hi >> 31));  // hi = -1: lo
    return min(hd + 1 + (hd >= 20 ? L1 : 0), L1);
  }
};

// Thread tid's slot in the [QT][L+2][ROWS] counts: lane i of warp w at
// 2 i + (w & 1) within the 64-slot group of warps w & ~1, so warps 2k and
// 2k+1 share 32-bit words (one half each) and lane i always hits bank i.
template <int ROWS>
__device__ __forceinline__ int count_slot(int tid) {
  static_assert(ROWS % 64 == 0, "slot order pairs whole warps");
  return (tid & ~63) + ((tid & 31) << 1) + ((tid >> 5) & 1);
}

// As count_agreements, for c = 2 or 3 through digit words (narrow or
// WIDE, see Digits), with the counts in slot order: adds one to
// s_cnt[(q * (L+2) + m) * ROWS + count_slot(tid)] per lane < s_bq[q] whose
// first agreeing level is m, for every live row and query q < nq (other
// queries and lanes add to bin L+1).  s_cnt must be zeroed, s_bq visible
// to every thread and, for c = 3, s_tab filled (Base3::fill) before the
// call; bmax is the largest s_bq.  Synchronises the block.
template <int ROWS, int QT, int TC, int C, bool WIDE>
__device__ __forceinline__ void count_agreements_words(
    const int* __restrict__ codes_p, const int* __restrict__ codes_q, int B,
    int beta, int row0, int q0, int nq, int L, const int* s_bq, int bmax,
    const unsigned short* s_tab, uint2* s_qw, int* s_ctile,
    unsigned short* s_cnt) {
  static_assert(QT % 2 == 0, "query words are read in pairs");
  using D = Digits<C, WIDE>;
  const int L1 = L + 1, L2 = L + 2;
  const int tid = threadIdx.x;
  const bool live_row = row0 + tid < B;
  const int slot = count_slot<ROWS>(tid);
  unsigned* cw = reinterpret_cast<unsigned*>(s_cnt + (slot & ~1));
  const unsigned inc = 1u << 16 * (slot & 1);  // the slot's u16 half
  for (int t0 = 0; t0 < bmax; t0 += TC) {
    const int tc = min(TC, bmax - t0);
    for (int e = tid; e < QT * TC; e += ROWS) {
      const int q = e / TC, t = e % TC;
      uint2 w = D::dead();
      if (q < nq && t0 + t < s_bq[q])
        w = D::word(codes_q[(size_t)(q0 + q) * beta + t0 + t], s_tab);
      s_qw[t * QT + q] = w;
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
        const uint2 rw = D::word(s_ctile[tid * (TC + 1) + t], s_tab);
        const uint4* qw = reinterpret_cast<const uint4*>(s_qw + t * QT);
        int at[QT];
#pragma unroll
        for (int k = 0; k < QT / 2; ++k) {
          const uint4 w = qw[k];  // two queries' words
          at[2 * k] =
              (2 * k * L2 + D::level(rw, make_uint2(w.x, w.y), L1)) * ROWS;
          at[2 * k + 1] =
              ((2 * k + 1) * L2 + D::level(rw, make_uint2(w.z, w.w), L1)) *
              ROWS;
        }
        // one shared atomic per count, on the 32-bit word of its slot (one
        // instruction where a load, an add and a store take three)
#pragma unroll
        for (int q = 0; q < QT; ++q) atomicAdd(cw + at[q] / 2, inc);
      }
    }
    __syncthreads();
  }
}

// lf[q] = the first level whose running count s_cnt[(q * (L+2) + j) *
// ROWS + slot] reaches s_mu[q], L+1 if none (also for a dead row or a
// query past nq).
template <int ROWS, int QT>
__device__ __forceinline__ void first_frequent_levels_at(
    const unsigned short* s_cnt, const int* s_mu, int nq, bool live_row,
    int L, int slot, int (&lf)[QT]) {
  const int L1 = L + 1, L2 = L + 2;
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    int v = L1;
    if (live_row && q < nq) {
      int run = 0;
      for (int j = 0; j < L1; ++j) {
        run += s_cnt[(q * L2 + j) * ROWS + slot];
        if (run >= s_mu[q]) {
          v = j;
          break;
        }
      }
    }
    lf[q] = v;
  }
}

// The same, for count_agreements' counts (slot = the thread's index).
template <int ROWS, int QT>
__device__ __forceinline__ void first_frequent_levels(
    const unsigned short* s_cnt, const int* s_mu, int nq, bool live_row,
    int L, int (&lf)[QT]) {
  first_frequent_levels_at<ROWS, QT>(s_cnt, s_mu, nq, live_row, L,
                                     (int)threadIdx.x, lf);
}

// ---- a kernel's matching half ---------------------------------------------

// Byte offsets of the matching's arrays in a block's shared memory, from
// 0: the c = 3 digit table (u16 [3^6]), the query words (uint2 [TC][QT];
// c = 2, 3) or per-level query codes (int [QT][TC][L+1]; any other c),
// the code tile (int [ROWS][TC+1]), the level counts (u16
// [QT][L+2][ROWS]); end is 16-B aligned.
struct MatchLayout {
  size_t tab, qw, ctile, cnt, end;
};

template <int ROWS, int QT, int TC, int C>
__host__ __device__ inline MatchLayout match_layout(int L) {
  MatchLayout s;
  s.tab = 0;
  s.qw = s.tab + (C == 3 ? align16(sizeof(unsigned short) * kTab3) : 0);
  s.ctile = s.qw + align16(C ? sizeof(uint2) * TC * QT
                             : sizeof(int) * QT * TC * (L + 1));
  s.cnt = s.ctile + align16(sizeof(int) * ROWS * (TC + 1));
  // the counts are 16 B whole (ROWS is a multiple of 64)
  s.end = s.cnt + sizeof(unsigned short) * QT * (L + 2) * ROWS;
  return s;
}

// Zeroes the level counts (16-B stores) and, for c = 3, fills the digit
// table.  The caller synchronises the block before first_frequent.
template <int ROWS, int QT, int TC, int C>
__device__ __forceinline__ void match_init(unsigned char* smem, int L) {
  const MatchLayout lay = match_layout<ROWS, QT, TC, C>(L);
  uint4* c4 = reinterpret_cast<uint4*>(smem + lay.cnt);
  for (int i = threadIdx.x; i < (int)((lay.end - lay.cnt) / 16); i += ROWS)
    c4[i] = make_uint4(0, 0, 0, 0);
  if (C == 3) Base3::fill(reinterpret_cast<unsigned short*>(smem + lay.tab),
                          ROWS);
}

// lf[q] = the first frequent level of row row0 + tid for query q0 + q
// (L+1 if none, also for a dead row or q >= nq): count_agreements_words
// for C = 2 and 3 (WIDE: wide3(L)), count_agreements for C = 0 (c read at
// run time).  s_mu and s_bq (per-query lane counts, clamped to [0, beta])
// lie outside the matching's arrays and are visible to every thread, and
// match_init has run.  Synchronises the block; the matching's arrays are
// free again once every thread has returned.
template <int ROWS, int QT, int TC, int C, bool WIDE>
__device__ __forceinline__ void first_frequent(
    const int* __restrict__ codes_p, const int* __restrict__ codes_q, int B,
    int beta, int row0, int q0, int nq, int c, int L, const int* s_mu,
    const int* s_bq, unsigned char* smem, int (&lf)[QT]) {
  const MatchLayout lay = match_layout<ROWS, QT, TC, C>(L);
  int* s_ctile = reinterpret_cast<int*>(smem + lay.ctile);
  unsigned short* s_cnt = reinterpret_cast<unsigned short*>(smem + lay.cnt);
  const bool live_row = row0 + (int)threadIdx.x < B;
  int bmax = 0;
  for (int q = 0; q < nq; ++q) bmax = max(bmax, s_bq[q]);
  if constexpr (C == 0) {
    count_agreements<ROWS, QT, TC, C>(
        codes_p, codes_q, B, beta, row0, q0, nq, c, L, s_bq, bmax,
        reinterpret_cast<int*>(smem + lay.qw), s_ctile, s_cnt);
    first_frequent_levels<ROWS, QT>(s_cnt, s_mu, nq, live_row, L, lf);
  } else {
    count_agreements_words<ROWS, QT, TC, C, WIDE>(
        codes_p, codes_q, B, beta, row0, q0, nq, L, s_bq, bmax,
        reinterpret_cast<const unsigned short*>(smem + lay.tab),
        reinterpret_cast<uint2*>(smem + lay.qw), s_ctile, s_cnt);
    first_frequent_levels_at<ROWS, QT>(s_cnt, s_mu, nq, live_row, L,
                                       count_slot<ROWS>(threadIdx.x), lf);
  }
}

}  // namespace wlsh
