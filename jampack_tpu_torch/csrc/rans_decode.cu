// K1: wide rANS chain decode, one launch for the whole walk.
//
// Replaces jampack_tpu/kernels/rans_pallas.py::_rans_step_kernel (one
// lockstep decode step per pallas_call) and its per-step host loop
// decode_lanes_wide_pallas; the semantics are those of
// rans_wide.decode_lanes_wide (reference: ans.cpp:30-111, model.cpp:60-204).
//
// What bounds it here: each chain is a serial walk of a few thousand
// dependent steps (a 16 KiB chunk dealt over 4 lanes is ~4K symbols), and a
// step is a handful of dependent shared-memory reads (range search, model
// update).  So the walk is latency bound, not bandwidth bound: the payload
// is read once, byte by byte, and the model state never leaves the SM.
//
// Design: one thread per chain, the scalar shape of native/src/jn_ans.cpp
// decode_chain.  A chain's model state lives in dynamic shared memory laid
// out [entry][thread] (rans_model.cuh, shared with K4's encode pass).
// Symbols are found by binary search over each model's segment (the bank
// is strictly increasing within a segment), and the quasi rescale divides
// in native uint32.  None of the TPU kernel's MXU workarounds (bf16 byte
// planes, indicator matmuls, the f32 division fixup, lanes-minor layout,
// the XLA-side payload window) are needed.  Symbols are written straight
// into the per-chunk slab layout (chunk g's symbol j at column j), so the
// consumer needs no lane undeal.
#include "rans_model.cuh"

using namespace jt_model;

namespace {

__global__ void __launch_bounds__(kThreads) rans_decode_kernel(
    const uint8_t* __restrict__ buf, int64_t n,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ rlens,
    int num_chains, int max_rlen, int lanes_per,
    const int32_t* __restrict__ bank_init,   // (256,)
    const int32_t* __restrict__ exp_mix,     // (8, 7) interior mix targets
    const int32_t* __restrict__ ma_mix,      // (2, 2) [model][min(m, 1)]
    const int32_t* __restrict__ boff,        // (10,) segment offsets
    const int32_t* __restrict__ exp_base,    // (8,) EXPONENT[e]
    int32_t* __restrict__ syms, uint8_t* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Tables tb;
  load_tables(tb, exp_mix, ma_mix, boff, exp_base);

  const int t = threadIdx.x;
  const int c = blockIdx.x * kThreads + t;
  if (c >= num_chains) return;
  State st(smem, t);
  st.init(bank_init);

  // payload bytes past the buffer read as the clamped gather of the
  // reference does: the index clamps to the last byte
  auto byte_at = [&](int64_t p) -> uint32_t {
    if (n <= 0) return 0;
    return buf[jt_clamp<int64_t>(p, 0, n - 1)];
  };
  const int64_t s0 = starts[c];
  uint32_t R[4];
  for (int k = 0; k < 4; ++k) {
    const int64_t p = s0 + 4 * k;
    R[k] = byte_at(p) | (byte_at(p + 1) << 8) | (byte_at(p + 2) << 16) |
           (byte_at(p + 3) << 24);
  }
  int64_t ptr = s0 + 16;

  const int rl = rlens[c];
  const int steps = rl < 0 ? 0 : min(rl, max_rlen);
  int32_t* out;
  int64_t stride;
  if (lanes_per > 0) {  // chunk slab: chain l of chunk g owns columns j*lanes_per + l
    const int g = c / lanes_per, l = c % lanes_per;
    out = syms + int64_t(g) * max_rlen * lanes_per + l;
    stride = lanes_per;
  } else {
    out = syms + int64_t(c) * max_rlen;
    stride = 1;
  }

  // model `s` segment search: m = number of interior cum entries <= rc,
  // low = cum[m], freq = cum[m + 1] - cum[m] (cum[0] = 0, cum[alpha] = 2^16)
  auto find = [&](int s, uint32_t rc, int& m, uint32_t& lo, uint32_t& fq) {
    const int b0 = tb.boff[s], w = tb.boff[s + 1] - b0;
    int a = 0, b = w;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (st.bank(b0 + mid) <= rc) a = mid + 1; else b = mid;
    }
    m = a;
    lo = a > 0 ? st.bank(b0 + a - 1) : 0u;
    const uint32_t hi = a < w ? st.bank(b0 + a) : uint32_t(kProbScale);
    fq = hi - lo;
  };

  for (int i = 0; i < steps; ++i) {
    // the step's 4-byte lookahead window (two renorms read <= 4 bytes)
    uint32_t wb[4];
    const int64_t wp = n > 0 ? jt_clamp<int64_t>(ptr, 0, n - 1) : 0;
    for (int k = 0; k < 4; ++k) wb[k] = (wp + k < n) ? buf[wp + k] : 0u;
    int kb = 0;
    auto renorm = [&](uint32_t x) {
      for (int r = 0; r < 2; ++r) {
        if (x < kRansL) {
          x = (x << 8) | wb[kb];
          ++kb;
        }
      }
      return x;
    };

    const uint32_t rng1 = R[0] & 0xFFFFu, rng2 = R[1] & 0xFFFFu;
    int e, m;
    uint32_t lo, fq;
    find(0, rng1, e, lo, fq);
    uint32_t x = renorm(fq * (R[0] >> 16) + (R[0] & 0xFFFFu) - lo);
    R[0] = R[1]; R[1] = R[2]; R[2] = R[3]; R[3] = x;
    // mantissa model of exponent e: adaptive 1+e for e < 2, quasi 3+(e-2)
    find(1 + e, rng2, m, lo, fq);
    x = renorm(fq * (R[0] >> 16) + (R[0] & 0xFFFFu) - lo);
    R[0] = R[1]; R[1] = R[2]; R[2] = R[3]; R[3] = x;
    ptr += kb;

    st.update(tb, e, m);
    out[int64_t(i) * stride] = tb.base[e] + m;
  }
  for (int i = steps; i < max_rlen; ++i) out[int64_t(i) * stride] = 0;
  ok[c] = (rl < 0) ||
          (R[0] == kRansL && R[1] == kRansL && R[2] == kRansL && R[3] == kRansL);
}

}  // namespace

// syms: (num_chains, max_rlen) int32, or with lanes_per > 0 the chunk slab
// (num_chains / lanes_per, max_rlen * lanes_per); ok: (num_chains,) uint8.
JT_EXPORT int jt_rans_decode(const void* buf, int64_t n, const void* starts,
                             const void* rlens, int num_chains, int max_rlen,
                             int lanes_per, const void* bank_init,
                             const void* exp_mix, const void* ma_mix,
                             const void* boff, const void* exp_base,
                             void* syms, void* ok, void* stream) {
  if (num_chains <= 0) return 0;
  cudaError_t err = jt_allow_smem(rans_decode_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks = (num_chains + kThreads - 1) / kThreads;
  rans_decode_kernel<<<blocks, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), n, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(rlens), num_chains, max_rlen, lanes_per,
      static_cast<const int32_t*>(bank_init),
      static_cast<const int32_t*>(exp_mix), static_cast<const int32_t*>(ma_mix),
      static_cast<const int32_t*>(boff), static_cast<const int32_t*>(exp_base),
      static_cast<int32_t*>(syms), static_cast<uint8_t*>(ok));
  return cudaGetLastError();
}

JT_EXPORT const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
