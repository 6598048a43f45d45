// K4: the encode model pass, one warp per chain, one launch for the walk.
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
// dependent steps (4,095 symbols at an 8 MiB block's 16 KiB chunks dealt
// over 4 chains), so the walk is latency and issue bound; the symbols are
// read once and the pairs written once.
//
// Design: K1's launch shape and K1's model.  One warp a chain, four chains a
// block; the chain's model lives in the registers of its 32 lanes
// (rans_warp_model.cuh, the one device copy of the model update).  The
// symbol is known, so there is no search: its exponent e is a ballot of the
// lanes holding the exponent bases, the exponent pair is entries e - 1 and
// e of the exponent model, the mantissa pair entries m - 1 and m of model
// 1 + e (pair_exp, pair_adaptive, pair_quasi), each a shuffle.  The step's
// code is specialised by exponent, so the warp never diverges.  I/O: lane k
// loads symbol k of a 32-step tile (the next tile's load is in flight
// during the current one), the step's symbol reaches the warp by shuffle,
// lane i % 32 keeps step i's two ops as one uint32 of lows and one of fqs
// (little endian: the exponent op in the low half), and the warp stores a
// tile's 32 steps with one coalesced store per array.  Slots past a chain's
// 2 * rlen ops are written as zeros; ok is one warp-uniform AND per chain.
#include "rans_warp_model.cuh"

using namespace jt_warp_model;

namespace {

constexpr int kWarps = 4;  // chains a block

template <int K>
struct Model {  // quasi model K, as a type the step's code specialises on
  static constexpr int value = K;
};

__global__ void __launch_bounds__(kWarps * 32, 1) model_pairs_kernel(
    const uint16_t* __restrict__ chains, const int32_t* __restrict__ rlens,
    int num_chains, int max_rlen,
    const int32_t* __restrict__ bank_init, const int32_t* __restrict__ exp_mix,
    const int32_t* __restrict__ ma_mix, const int32_t* __restrict__ boff,
    const int32_t* __restrict__ exp_base, uint16_t* __restrict__ lows,
    uint16_t* __restrict__ fqs, uint8_t* __restrict__ ok) {
  __shared__ Tables tb;
  load_tables(tb, exp_mix, ma_mix, boff, exp_base);

  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= num_chains) return;  // the whole warp
  WarpModel md;
  md.init(tb, bank_init, lane);
  // lane j holds EXPONENT[j % 8]: a symbol's exponent is the number of
  // bases 1..7 at or below it
  const int base_l = tb.base[lane & 7];

  const int rl = rlens[c];
  const int steps = rl < 0 ? 0 : min(rl, max_rlen);
  const uint16_t* sy = chains + int64_t(c) * max_rlen;
  // ops 2i and 2i + 1 of step i as one uint32 (rows of 4 * max_rlen bytes)
  const int64_t row = int64_t(c) * 2 * max_rlen;
  uint32_t* lo_out = reinterpret_cast<uint32_t*>(lows + row);
  uint32_t* fq_out = reinterpret_cast<uint32_t*>(fqs + row);

  bool good = true;
  uint32_t next = lane < steps ? sy[lane] : 0u;
  for (int base = 0; base < steps; base += 32) {
    const uint32_t tile = next;
    if (base + 32 + lane < steps) next = sy[base + 32 + lane];
    const int n32 = min(32, steps - base);
    uint32_t my_lo = 0, my_fq = 0;
    for (int k = 0; k < n32; ++k) {
      const int sym = int(__shfl_sync(kFull, tile, k));
      const int e = __popc(
          __ballot_sync(kFull, lane >= 1 && lane < 8 && sym >= base_l));
      const int m = sym - __shfl_sync(kFull, base_l, e);
      uint32_t lo_e, fq_e, lo_m, fq_m;
      good &= md.pair_exp(e, lo_e, fq_e);
      // mantissa model of exponent e: adaptive 1+e for e < 2, quasi 3+(e-2)
      auto quasi = [&](auto model) {
        constexpr int K = decltype(model)::value;
        good &= md.pair_quasi<K>(m, lo_m, fq_m);
        md.update_quasi<K>(m);
      };
      // the exponents in the order of their frequency in BWT rank streams
      // of text, as in K1
      if (e == 4) quasi(Model<2>());
      else if (e == 3) quasi(Model<1>());
      else if (e == 2) quasi(Model<0>());
      else if (e < 2) {
        good &= md.pair_adaptive(e, m, lo_m, fq_m);
        md.update_adaptive(tb, e, m);
      } else if (e == 5) quasi(Model<3>());
      else if (e == 6) quasi(Model<4>());
      else quasi(Model<5>());
      md.update_exp(tb, e);
      if (lane == k) {
        my_lo = lo_e | lo_m << 16;
        my_fq = fq_e | fq_m << 16;
      }
    }
    if (lane < n32) {
      lo_out[base + lane] = my_lo;
      fq_out[base + lane] = my_fq;
    }
  }
  for (int i = steps + lane; i < max_rlen; i += 32) {
    lo_out[i] = 0;
    fq_out[i] = 0;
  }
  if (lane == 0) ok[c] = good;
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
  const int blocks = (num_chains + kWarps - 1) / kWarps;
  model_pairs_kernel<<<blocks, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(chains), static_cast<const int32_t*>(rlens),
      num_chains, max_rlen, static_cast<const int32_t*>(bank_init),
      static_cast<const int32_t*>(exp_mix), static_cast<const int32_t*>(ma_mix),
      static_cast<const int32_t*>(boff), static_cast<const int32_t*>(exp_base),
      static_cast<uint16_t*>(lows), static_cast<uint16_t*>(fqs),
      static_cast<uint8_t*>(ok));
  return cudaGetLastError();
}
