// K4: the encode model pass, one launch for every chain's whole walk.
//
// Replaces jampack_tpu/kernels/rans_pallas.py::_model_pairs_kernel (one
// lockstep step per pallas_call, driven by model_pairs_wide_pallas); the
// semantics are those of rans_wide.model_pairs_wide (reference:
// ans.cpp:152-187).  For every known 16-bit RLE0 symbol of a chain it gives
// the (low, freq) of the exponent op and of the mantissa op from the
// chain's model bank, clears the chain's ok flag on a zero-frequency op,
// and then updates the bank exactly as the decoder does.
//
// What bounds it here: like K1, a chain is a serial walk of a few thousand
// dependent steps through ~1.6 KB of model state, so the walk is latency
// bound; the symbols are read once and the pairs written once.
//
// Design: one thread per chain, the model state in dynamic shared memory
// laid out [entry][thread] (rans_model.cuh).
// The symbol is known, so there is no range search: with the model's
// interior cums cum[0..w-1] in the bank, low = cum[m-1] (0 at m = 0) and
// freq = cum[m] - low, or 2^16 - low for the model's last symbol m = w.
// Both are uint16, as the TPU pass stores them; the bank arithmetic is
// mod 2^16, which is what the TPU pass's uint16 segment sums give in the
// wrap regime too.  A mantissa past its model's alphabet (only an invalid
// symbol has one) reads low = cum[w-1], freq 0, and clears ok, as the TPU
// pass does.  Slots past a chain's 2 * rlen ops are written as zeros.
#include "rans_model.cuh"

using namespace jt_model;

namespace {

__global__ void __launch_bounds__(kThreads) model_pairs_kernel(
    const uint16_t* __restrict__ chains, const int32_t* __restrict__ rlens,
    int num_chains, int max_rlen,
    const int32_t* __restrict__ bank_init, const int32_t* __restrict__ exp_mix,
    const int32_t* __restrict__ ma_mix, const int32_t* __restrict__ boff,
    const int32_t* __restrict__ exp_base, uint16_t* __restrict__ lows,
    uint16_t* __restrict__ fqs, uint8_t* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Tables tb;
  load_tables(tb, exp_mix, ma_mix, boff, exp_base);

  const int t = threadIdx.x;
  const int c = blockIdx.x * kThreads + t;
  if (c >= num_chains) return;
  State st(smem, t);
  st.init(bank_init);

  const int rl = rlens[c];
  const int steps = rl < 0 ? 0 : min(rl, max_rlen);
  const uint16_t* sy = chains + int64_t(c) * max_rlen;
  uint16_t* lo_out = lows + int64_t(c) * 2 * max_rlen;
  uint16_t* fq_out = fqs + int64_t(c) * 2 * max_rlen;

  // (low, freq) of symbol m in model s; false for a zero-frequency op
  auto pair = [&](int s, int m, uint16_t& lo, uint16_t& fq) -> bool {
    const int b0 = tb.boff[s], w = tb.boff[s + 1] - b0;
    const int mm = min(m, w);
    const uint32_t low = mm > 0 ? st.bank(b0 + mm - 1) : 0u;
    lo = static_cast<uint16_t>(low);
    if (m == w) {  // the model's last symbol: no interior entry above it
      fq = static_cast<uint16_t>(uint32_t(kProbScale) - low);
      return true;
    }
    const uint32_t f = m < w ? (uint32_t(st.bank(b0 + m)) - low) & 0xFFFFu : 0u;
    fq = static_cast<uint16_t>(f);
    return f != 0;
  };

  bool good = true;
  for (int i = 0; i < steps; ++i) {
    const int sym = sy[i];
    int e = 0;
    for (int k = 1; k < 8; ++k) e += sym >= tb.base[k];
    const int m = sym - tb.base[e];
    uint16_t lo, fq;
    good &= pair(0, e, lo, fq);
    lo_out[2 * i] = lo;
    fq_out[2 * i] = fq;
    // mantissa model of exponent e: adaptive 1+e for e < 2, quasi 3+(e-2)
    good &= pair(1 + e, m, lo, fq);
    lo_out[2 * i + 1] = lo;
    fq_out[2 * i + 1] = fq;
    st.update(tb, e, m);
  }
  for (int i = 2 * steps; i < 2 * max_rlen; ++i) {
    lo_out[i] = 0;
    fq_out[i] = 0;
  }
  ok[c] = good;
}

}  // namespace

// chains: (num_chains, max_rlen) uint16; rlens: (num_chains,) int32;
// lows, fqs: (num_chains, 2 * max_rlen) uint16; ok: (num_chains,) uint8.
JT_EXPORT int jt_model_pairs(const void* chains, const void* rlens,
                             int num_chains, int max_rlen,
                             const void* bank_init, const void* exp_mix,
                             const void* ma_mix, const void* boff,
                             const void* exp_base, void* lows, void* fqs,
                             void* ok, void* stream) {
  if (num_chains <= 0) return 0;
  cudaError_t err = jt_allow_smem(model_pairs_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks = (num_chains + kThreads - 1) / kThreads;
  model_pairs_kernel<<<blocks, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(chains), static_cast<const int32_t*>(rlens),
      num_chains, max_rlen, static_cast<const int32_t*>(bank_init),
      static_cast<const int32_t*>(exp_mix), static_cast<const int32_t*>(ma_mix),
      static_cast<const int32_t*>(boff), static_cast<const int32_t*>(exp_base),
      static_cast<uint16_t*>(lows), static_cast<uint16_t*>(fqs),
      static_cast<uint8_t*>(ok));
  return cudaGetLastError();
}
