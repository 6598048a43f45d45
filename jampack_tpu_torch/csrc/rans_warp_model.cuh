// The adaptive model bank of one wide rANS chain spread over the 32 lanes of
// its warp: the one device copy of the model update, shared by K1 (the
// decode, which searches for each symbol) and K4 (the encode model pass,
// which knows it).  Semantics: rans_wide.decode_lanes_wide and
// model_pairs_wide (reference model.cpp:60-204).
//
// Layout: every model's entries are spread over the lanes by their index
// within the model, so a search touches only the registers of the model it
// searches.  All state is in registers, indexed statically:
//   - the exponent model's 7 interior entries: entry j on lane j (lanes 7..31
//     hold 2^16, which no range value reaches);
//   - the two adaptive mantissa entries, and each quasi model's countdown
//     to its next rescale with the log of its period (one register a
//     model): a copy on every lane;
//   - quasi model k (exponent 2 + k, interior width w = 3, 7, 15, 31, 63,
//     128): entry j in slot j / 32 of the model's slot group, on lane
//     j % 32; the groups take 1, 1, 1, 1, 2 and 4 slots (10 registers), and
//     a slot past the model's width holds 0xFFFFFFFF.  Count j (0 <= j <= w)
//     sits beside entry j, so a rescale's prefix sums land on the lanes that
//     write them; the one count with no room, j = 128 of model 5, is the
//     spare register of lane 0 (tests/test_torch_rans.py checks the widths
//     against the tables).
//
// Symbol search.  Every model's entries are strictly increasing, for any
// payload: the mixing update floor((31 b + t) / 32) keeps the order of
// strictly increasing entries b and targets t, and a quasi rescale writes
// 2^16 - qsum plus a prefix of counts q_j >= 1 whose sum stays below 2^16
// (t2 <= 2^16 by the choice of the stretch shift), so no entry wraps.  So
// the symbol m (the number of entries <= the range value) is the popcount
// of a ballot, and cum[m] and cum[m + 1] are entries m - 1 and m, which one
// shuffle each brings from their lanes.  The quasi rescale is cooperative:
// the sums are warp reductions and the cumulative entries a warp prefix
// scan in the models' entry order, all in uint32 (int32 where the serial
// loop is), so the bits equal the serial loop's.
#pragma once

#include "common.cuh"

namespace jt_warp_model {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kExp = 7;      // interior entries of the exponent model
constexpr int kNQ = 6;       // quasi models (exponents 2..7)
constexpr uint32_t kRansL = 1u << 23;
constexpr int kProbScale = 1 << 16;
constexpr int kUpdateLog = 16;  // log2 of the largest period, 64 << 10
constexpr int kRate = 5;
constexpr uint32_t kPast = 0xFFFFFFFFu;  // a slot past its model's width
constexpr int kQSlots = 10;

// Quasi model k's interior width, first slot and slot count.
__host__ __device__ constexpr int q_width(int k) {
  return k == 5 ? 128 : (4 << k) - 1;
}
__host__ __device__ constexpr int q_first(int k) { return k < 5 ? k : 6; }
__host__ __device__ constexpr int q_slots(int k) {
  return k < 4 ? 1 : (k == 4 ? 2 : 4);
}

// The constant tables, in shared memory.
struct Tables {
  int32_t mix[8 * 8];  // exponent model interior mix targets, [e][j], j < 7
  int32_t ma[4];       // adaptive mantissa targets, [model][min(m, 1)]
  int32_t boff[10];    // segment offsets of the 9 models in the bank
  int32_t base[8];     // EXPONENT[e]
};

// Fills `tb`; every thread of the block calls it.
__device__ __forceinline__ void load_tables(Tables& tb, const int32_t* exp_mix,
                                            const int32_t* ma_mix,
                                            const int32_t* boff,
                                            const int32_t* exp_base) {
  for (int k = threadIdx.x; k < 8 * 8; k += blockDim.x)
    tb.mix[k] = k % 8 < kExp ? exp_mix[(k / 8) * kExp + k % 8] : 0;
  if (threadIdx.x < 4) tb.ma[threadIdx.x] = ma_mix[threadIdx.x];
  if (threadIdx.x < 10) tb.boff[threadIdx.x] = boff[threadIdx.x];
  if (threadIdx.x < 8) tb.base[threadIdx.x] = exp_base[threadIdx.x];
  __syncthreads();
}

// c ? a : b, as a PTX selp the optimizer cannot see through: selects over
// the elements of a register array by an index compare are otherwise
// folded into a dynamic index, which puts the array in local memory.
__device__ __forceinline__ uint32_t sel(bool c, uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\t"
      "selp.b32 %0, %1, %2, p;\n\t}"
      : "=r"(r) : "r"(a), "r"(b), "r"(uint32_t(c)));
  return r;
}

struct WarpModel {
  uint32_t ex;               // exponent entry `lane` (2^16 past 6)
  int32_t A0, A1;            // adaptive entries (bank 7, 8), every lane
  uint32_t B[kQSlots];       // quasi entries, by model slot group
  int32_t C[kQSlots];        // quasi counts beside them
  int32_t spare;             // count 128 of model 5, on lane 0
  int32_t ctr[kNQ];          // log2(period) << 24 | symbols to the rescale
  int lane;

  __device__ __forceinline__ void init(const Tables& tb,
                                       const int32_t* bank_init, int l) {
    lane = l;
    ex = l < kExp ? uint32_t(bank_init[l]) : uint32_t(kProbScale);
    A0 = bank_init[kExp];
    A1 = bank_init[kExp + 1];
#pragma unroll
    for (int k = 0; k < kNQ; ++k) {
#pragma unroll
      for (int s = 0; s < q_slots(k); ++s) {
        const int j = 32 * s + l;
        B[q_first(k) + s] =
            j < q_width(k) ? uint32_t(bank_init[tb.boff[3 + k] + j]) : kPast;
        C[q_first(k) + s] = 0;
      }
      ctr[k] = 3 << 24 | 8;  // period 8
    }
    spare = 0;
  }

  // Exponent model: e = entries <= rc, low = cum[e], freq = cum[e + 1] -
  // cum[e] (cum[0] = 0, cum[8] = 2^16).
  __device__ __forceinline__ void find_exp(uint32_t rc, int& e, uint32_t& lo,
                                           uint32_t& fq) const {
    e = __popc(__ballot_sync(kFull, ex <= rc));
    const uint32_t l = __shfl_sync(kFull, ex, (e - 1) & 31);
    const uint32_t h = __shfl_sync(kFull, ex, e);
    lo = e > 0 ? l : 0u;
    fq = h - lo;
  }

  // Adaptive mantissa model 1 + e (e < 2): one interior entry.
  __device__ __forceinline__ void find_adaptive(int e, uint32_t rc, int& m,
                                                uint32_t& lo,
                                                uint32_t& fq) const {
    const uint32_t a = uint32_t(e == 0 ? A0 : A1);
    m = a <= rc;
    lo = m ? a : 0u;
    fq = (m ? uint32_t(kProbScale) : a) - lo;
  }

  // Entry j (0 <= j < 32 * slots) of quasi model K, on every lane.
  template <int K>
  __device__ __forceinline__ uint32_t entry(int j) const {
    uint32_t v = B[q_first(K)];
#pragma unroll
    for (int s = 1; s < q_slots(K); ++s)
      v = sel(j >> 5 == s, B[q_first(K) + s], v);
    return __shfl_sync(kFull, v, j & 31);
  }

  // Quasi model K: m = entries <= rc by ballots, cum[m] and cum[m + 1] by
  // a shuffle each.
  template <int K>
  __device__ __forceinline__ void find_quasi(uint32_t rc, int& m, uint32_t& lo,
                                             uint32_t& fq) const {
    int n = 0;
#pragma unroll
    for (int s = 0; s < q_slots(K); ++s)
      n += __popc(__ballot_sync(kFull, B[q_first(K) + s] <= rc));
    m = n;
    const uint32_t l = entry<K>((n - 1) & (32 * q_slots(K) - 1));
    const uint32_t h = entry<K>(n & (32 * q_slots(K) - 1));
    lo = n > 0 ? l : 0u;
    fq = (n < q_width(K) ? h : uint32_t(kProbScale)) - lo;
  }

  // The encode direction (K4) knows the symbol, so there is no search: the
  // pair_* lookups give a known symbol's (low, freq), both uint16 (freq mod
  // 2^16), on every lane, and return false for a zero-frequency op.  The
  // model's last symbol m = w has freq 2^16 - cum[w - 1].

  // Exponent model, symbol e (0..7): entries e - 1 and e by a shuffle each
  // (lane 7 holds 2^16).
  __device__ __forceinline__ bool pair_exp(int e, uint32_t& lo,
                                           uint32_t& fq) const {
    const uint32_t l = __shfl_sync(kFull, ex, (e - 1) & 31);
    const uint32_t h = __shfl_sync(kFull, ex, e);
    lo = e > 0 ? l : 0u;
    fq = (h - lo) & 0xFFFFu;
    return e == kExp || fq != 0;
  }

  // Adaptive mantissa model 1 + e (e < 2), whose symbols are m = 0, 1.
  __device__ __forceinline__ bool pair_adaptive(int e, int m, uint32_t& lo,
                                                uint32_t& fq) const {
    const uint32_t a = uint32_t(e == 0 ? A0 : A1);
    lo = m > 0 ? a : 0u;
    fq = ((m > 0 ? uint32_t(kProbScale) : a) - lo) & 0xFFFFu;
    return m > 0 || fq != 0;
  }

  // Quasi model K, mantissa m: entries m - 1 and m.  A mantissa past the
  // alphabet (m > w, only an invalid symbol of model 5 has one) reads low =
  // cum[w - 1] and freq 0; the index is clamped first, since entry<K> masks
  // its index and m >= 129 would wrap onto another lane.
  template <int K>
  __device__ __forceinline__ bool pair_quasi(int m, uint32_t& lo,
                                             uint32_t& fq) const {
    constexpr int w = q_width(K);
    const int mm = min(m, w);
    const uint32_t l = entry<K>((mm - 1) & (32 * q_slots(K) - 1));
    const uint32_t h = entry<K>(min(m, w - 1));
    lo = mm > 0 ? l : 0u;
    fq = (m < w ? h : (m == w ? uint32_t(kProbScale) : lo)) - lo;
    fq &= 0xFFFFu;
    return m == w || (m < w && fq != 0);
  }

  // The exponent model's mixing update (int32, arithmetic >> 5): lane j
  // moves entry j towards row e of the targets.
  __device__ __forceinline__ void update_exp(const Tables& tb, int e) {
    const int32_t t = tb.mix[e * 8 + (lane & 7)];
    const int32_t x = int32_t(ex);
    ex = lane < kExp ? uint32_t(x + ((t - x) >> kRate)) : ex;
  }

  __device__ __forceinline__ void update_adaptive(const Tables& tb, int e,
                                                  int m) {
    const int32_t t = tb.ma[e * 2 + min(m, 1)];
    if (e == 0) A0 += (t - A0) >> kRate;
    else A1 += (t - A1) >> kRate;
  }

  // The quasi count of mantissa m and, after period + 1 symbols, the
  // rescale, which doubles the period up to UPDATE_RATE (model.cpp).  A
  // decoded mantissa is <= the width; an encoded one past the alphabet (m >=
  // 129 in model 5) matches no count and counts nothing, as model_pairs_wide
  // and rans_common.model_update do, but still counts towards the period.
  template <int K>
  __device__ __forceinline__ void update_quasi(int m) {
    // PROB_BITS per symbol (model.cpp)
#pragma unroll
    for (int s = 0; s < q_slots(K); ++s)
      C[q_first(K) + s] += int32_t(m == 32 * s + lane) << 4;
    if (K == kNQ - 1) spare += int32_t(m == 128 && lane == 0) << 4;
    if (ctr[K] & 0xFFFFFF) {
      --ctr[K];
      return;
    }
    rescale<K>();
    const int shift = min((ctr[K] >> 24) + 1, kUpdateLog);
    ctr[K] = shift << 24 | 1 << shift;
  }

  // Quasi rescale of model K (model.cpp:160-204, unsigned stretch): every
  // lane divides its own counts; total, t2 and qsum are warp sums and the
  // cumulative entries a warp prefix scan in entry order.
  template <int K>
  __device__ __forceinline__ void rescale() {
    constexpr int kS = q_slots(K), k0 = q_first(K), w = q_width(K);
    const bool sp = K == kNQ - 1 && lane == 0;  // count 128 of model 5
    int32_t total = sp ? spare : 0;
#pragma unroll
    for (int s = 0; s < kS; ++s) total += C[k0 + s];
    total = __reduce_add_sync(kFull, total);
    int logv = 0;
    for (int it = 0; it < 21; ++it) logv += ((total >> logv) + w + 1) > kProbScale;
    // counts 0..w, the spare's included
    uint32_t f[kS];
    const uint32_t fs = sp ? uint32_t((spare >> logv) + 1) : 0u;
    uint32_t t2 = fs;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      f[s] = 32 * s + lane <= w ? uint32_t((C[k0 + s] >> logv) + 1) : 0u;
      t2 += f[s];
    }
    t2 = __reduce_add_sync(kFull, t2);
    uint32_t q[kS];
    uint32_t own = sp ? (fs << 16) / t2 : 0u;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      q[s] = f[s] ? (f[s] << 16) / t2 : 0u;
      own += q[s];
    }
    const uint32_t qsum = __reduce_add_sync(kFull, own);
    // cum_j = 2^16 - qsum + q_0 + ... + q_j for the entries j < w
    uint32_t carry = uint32_t(kProbScale) - qsum;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      uint32_t incl = q[s];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t t = __shfl_up_sync(kFull, incl, d);
        incl += lane >= d ? t : 0u;
      }
      B[k0 + s] = 32 * s + lane < w ? (carry + incl) & 0xFFFFu : B[k0 + s];
      C[k0 + s] = 0;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (sp) spare = 0;
  }
};

}  // namespace jt_warp_model
