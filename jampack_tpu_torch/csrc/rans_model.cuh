// The adaptive model bank of the wide rANS coder for K4 (the encode model
// pass), one thread per chain.  K1 (the decode) keeps the same model in
// the registers of a warp (rans_warp_model.cuh); the tests hold both
// kernels to the same plain model update (rans_common.model_update).
//
// Semantics: rans_wide.decode_lanes_wide / model_pairs_wide (reference:
// model.cpp:60-204).  One thread owns one chain.  A chain's state (the
// 256-entry uint16 interior-CDF bank of the 9 models, 253 quasi counts, 6
// seen and 6 threshold counters: ~1.6 KB) lives in dynamic shared memory
// laid out [entry][thread], so the 32 threads of a block touching the same
// entry hit 32 different banks.
#pragma once

#include "common.cuh"

namespace jt_model {

constexpr int kThreads = 32;      // chains per block
constexpr int kBank = 256;        // interior CDF entries of the 9 models
constexpr int kQCounts = 253;     // quasi counts (sum of the 6 quasi alphabets)
constexpr int kNQ = 6;            // quasi models (exponents 2..7)
constexpr uint32_t kRansL = 1u << 23;
constexpr int kProbScale = 1 << 16;
constexpr int kUpdateRate = 64 << 10;
constexpr int kRate = 5;

constexpr size_t kSmemBytes =
    size_t(kThreads) * (kBank * sizeof(uint16_t) + kQCounts * sizeof(int32_t) +
                        2 * kNQ * sizeof(int32_t));

// The constant tables every thread of a block reads (static shared memory).
struct Tables {
  int32_t mix[8 * 7];  // exponent model interior mix targets, [e][j]
  int32_t ma[4];       // adaptive mantissa targets, [model][min(m, 1)]
  int32_t boff[10];    // segment offsets of the 9 models in the bank
  int32_t base[8];     // EXPONENT[e]
  int32_t qoff[kNQ];   // quasi model k's first count
};

// Fills `tb` from device memory; every thread of the block must call it.
__device__ __forceinline__ void load_tables(Tables& tb, const int32_t* exp_mix,
                                            const int32_t* ma_mix,
                                            const int32_t* boff,
                                            const int32_t* exp_base) {
  const int t = threadIdx.x;
  for (int k = t; k < 8 * 7; k += kThreads) tb.mix[k] = exp_mix[k];
  if (t < 4) tb.ma[t] = ma_mix[t];
  if (t < 10) tb.boff[t] = boff[t];
  if (t < 8) tb.base[t] = exp_base[t];
  __syncthreads();
  if (t == 0) {
    // quasi model k's alphabet is its interior width + 1
    int q = 0;
    for (int k = 0; k < kNQ; ++k) {
      tb.qoff[k] = q;
      q += tb.boff[4 + k] - tb.boff[3 + k] + 1;
    }
  }
  __syncthreads();
}

// One thread's view of its model state in the [entry][thread] layout.
struct State {
  uint16_t* bank_;
  int32_t* qf_;
  int32_t* seen_;
  int32_t* exp_;
  int t;

  __device__ __forceinline__ State(unsigned char* smem, int thread) : t(thread) {
    bank_ = reinterpret_cast<uint16_t*>(smem);
    qf_ = reinterpret_cast<int32_t*>(bank_ + kBank * kThreads);
    seen_ = qf_ + kQCounts * kThreads;
    exp_ = seen_ + kNQ * kThreads;
  }
  __device__ __forceinline__ uint16_t& bank(int k) { return bank_[k * kThreads + t]; }
  __device__ __forceinline__ int32_t& qf(int k) { return qf_[k * kThreads + t]; }
  __device__ __forceinline__ int32_t& seen(int k) { return seen_[k * kThreads + t]; }
  __device__ __forceinline__ int32_t& qexp(int k) { return exp_[k * kThreads + t]; }

  __device__ __forceinline__ void init(const int32_t* bank_init) {
    for (int k = 0; k < kBank; ++k) bank(k) = static_cast<uint16_t>(bank_init[k]);
    for (int k = 0; k < kQCounts; ++k) qf(k) = 0;
    for (int k = 0; k < kNQ; ++k) {
      seen(k) = 0;
      qexp(k) = 8;
    }
  }

  // The model update after one symbol (exponent e, mantissa m): adaptive
  // CDF mixing (int32, arithmetic >> 5) of the exponent model and of an
  // adaptive mantissa model, or the quasi count and the periodic rescale.
  __device__ __forceinline__ void update(const Tables& tb, int e, int m) {
    for (int j = 0; j < 7; ++j) {
      const int b = bank(j);
      bank(j) = static_cast<uint16_t>(b + ((tb.mix[e * 7 + j] - b) >> kRate));
    }
    if (e < 2) {
      const int b = bank(7 + e);
      const int mix = tb.ma[e * 2 + min(m, 1)];
      bank(7 + e) = static_cast<uint16_t>(b + ((mix - b) >> kRate));
      return;
    }
    const int k = e - 2;
    const int b0 = tb.boff[3 + k];
    const int alpha = tb.boff[4 + k] - b0 + 1;
    const int q0 = tb.qoff[k];
    // a decoded mantissa is always < alpha; an encoded symbol past its
    // model's alphabet counts nothing, as model_pairs_wide's one-hot does
    if (m < alpha) qf(q0 + m) += 16;  // PROB_BITS per symbol (model.cpp)
    const int sn = seen(k) + 1;
    seen(k) = sn;
    if (sn <= qexp(k)) return;
    // quasi rescale (model.cpp:160-204, unsigned stretch)
    int32_t total = 0;
    for (int j = 0; j < alpha; ++j) total += qf(q0 + j);
    int logv = 0;
    for (int it = 0; it < 21; ++it) logv += ((total >> logv) + alpha) > kProbScale;
    uint32_t t2 = 0;
    for (int j = 0; j < alpha; ++j) t2 += uint32_t((qf(q0 + j) >> logv) + 1);
    int32_t qsum = 0;
    for (int j = 0; j < alpha; ++j)
      qsum += int32_t((uint32_t((qf(q0 + j) >> logv) + 1) << 16) / t2);
    int32_t cum = kProbScale - qsum;  // remainder folded into symbol 0
    for (int j = 0; j < alpha - 1; ++j) {
      cum += int32_t((uint32_t((qf(q0 + j) >> logv) + 1) << 16) / t2);
      bank(b0 + j) = static_cast<uint16_t>(cum & 0xFFFF);
    }
    for (int j = 0; j < alpha; ++j) qf(q0 + j) = 0;
    seen(k) = 0;
    qexp(k) = qexp(k) < kUpdateRate ? qexp(k) << 1 : kUpdateRate;
  }
};

}  // namespace jt_model
