// K1: wide rANS chain decode, one warp per chain, one launch for the walk.
//
// Replaces jampack_tpu/kernels/rans_pallas.py::_rans_step_kernel (one
// lockstep decode step per pallas_call) and its per-step host loop
// decode_lanes_wide_pallas; the semantics are those of
// rans_wide.decode_lanes_wide (reference: ans.cpp:30-111, model.cpp:60-204).
//
// What bounds it here: each chain is a serial walk of a few thousand
// dependent steps (a 16 KiB chunk dealt over 4 lanes is ~4K symbols), and an
// 8 MiB block has ~2K chains.  One thread a chain gave 65 warps on 132 SMs:
// every step paid the full latency of its dependent shared-memory reads and
// of its payload read, and the 32 chains of a warp diverged on their
// exponents and rescales.
//
// Design: one warp a chain (four chains a block), so ~15 warps an SM hide
// each other's latency.  The chain's model lives in the registers of its
// 32 lanes (rans_warp_model.cuh), each model's entries spread over the
// lanes: a symbol is found by a ballot and two shuffles, with no search
// loop, and a rescale is shared by the lanes.  Every lane carries the same
// rANS states and cursor and takes the same branch (the step's code is
// specialised by exponent), so the warp never diverges.  The payload is
// read through a 128-byte window spread over the lanes (4 bytes a lane); a
// step's 4 bytes come by two shuffles and a funnel shift, and the window's
// next half is loaded 16 steps or more before it is needed, so no global
// read sits on the step's chain.  Lane i % 32 keeps symbol i, and every 32
// steps the warp stores 32 symbols with one instruction, straight into the
// per-chunk slab layout (chunk g's symbol j at column j) or the flat one.
#include "rans_warp_model.cuh"

using namespace jt_warp_model;

namespace {

constexpr int kWarps = 4;  // chains a block
constexpr int kSlide = 64;  // the 128-byte window moves by half its width

template <int K>
struct Model {  // quasi model K, as a type the step's code specialises on
  static constexpr int value = K;
};

// Payload bytes a .. a+3, little endian; bytes outside [0, n) read as 0.
__device__ __forceinline__ uint32_t load4(const uint8_t* buf, int64_t n,
                                          int64_t a) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (a + k >= 0 && a + k < n) w |= uint32_t(buf[a + k]) << (8 * k);
  return w;
}

__global__ void __launch_bounds__(kWarps * 32, 1) rans_decode_kernel(
    const uint8_t* __restrict__ buf, int64_t n,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ rlens,
    int num_chains, int max_rlen, int lanes_per,
    const int32_t* __restrict__ bank_init,   // (256,)
    const int32_t* __restrict__ exp_mix,     // (8, 7) interior mix targets
    const int32_t* __restrict__ ma_mix,      // (2, 2) [model][min(m, 1)]
    const int32_t* __restrict__ boff,        // (10,) segment offsets
    const int32_t* __restrict__ exp_base,    // (8,) EXPONENT[e]
    int32_t* __restrict__ syms, uint8_t* __restrict__ ok) {
  __shared__ Tables tb;
  load_tables(tb, exp_mix, ma_mix, boff, exp_base);

  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= num_chains) return;  // the whole warp
  WarpModel md;
  md.init(tb, bank_init, lane);

  // payload bytes past the buffer read as the clamped gather of the
  // reference does: the index clamps to [0, n - 1]
  auto byte_at = [&](int64_t p) -> uint32_t {
    return n > 0 ? buf[jt_clamp<int64_t>(p, 0, n - 1)] : 0u;
  };
  const int64_t s0 = starts[c];
  uint32_t R[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t p = s0 + 4 * k;
    R[k] = byte_at(p) | (byte_at(p + 1) << 8) | (byte_at(p + 2) << 16) |
           (byte_at(p + 3) << 24);
  }
  // A step reads the 4 bytes at clamp(ptr, 0, n - 1), those past the end
  // as 0: the window's bytes while 0 <= ptr < n, else one of these two.
  const uint32_t head4 = load4(buf, n, 0);
  const uint32_t last1 = n > 0 ? buf[n - 1] : 0u;
  // The window holds bytes [wbase, wbase + 128): lane l bytes wbase + 4l ..
  // +3; the cursor is ptr = wbase + off.  The window slides by 64 once off
  // reaches 64, so off stays below 68; lanes 16..31 hold the next half in
  // `ahead`.  ptr < 0 is off < below, ptr >= n is off >= above.
  int64_t wbase = s0 + 16;
  int off = 0, below, above;
  auto bounds = [&]() {
    below = int(jt_clamp<int64_t>(-wbase, 0, 1 << 30));
    above = int(jt_clamp<int64_t>(n - wbase, -1, 1 << 30));
  };
  bounds();
  uint32_t win = load4(buf, n, wbase + 4 * lane);
  uint32_t ahead = lane >= 16 ? load4(buf, n, wbase + kSlide + 4 * lane) : 0u;

  const int rl = rlens[c];
  const int steps = rl < 0 ? 0 : min(rl, max_rlen);
  int32_t* out;
  int stride;
  if (lanes_per > 0) {  // chunk slab: chain l of chunk g owns columns j*lanes_per + l
    const int g = c / lanes_per, l = c % lanes_per;
    out = syms + int64_t(g) * max_rlen * lanes_per + l;
    stride = lanes_per;
  } else {
    out = syms + int64_t(c) * max_rlen;
    stride = 1;
  }

  // 32 steps at a time: lane k keeps symbol base + k, then one store
  for (int base = 0; base < steps; base += 32) {
    const int n32 = min(32, steps - base);
    int32_t mine = 0;
    for (int k = 0; k < n32; ++k) {
      const uint32_t w0 = __shfl_sync(kFull, win, off >> 2);
      const uint32_t w1 = __shfl_sync(kFull, win, (off >> 2) + 1);
      uint32_t w4 = __funnelshift_r(w0, w1, 8 * (off & 3));
      w4 = off < below ? head4 : (off >= above ? last1 : w4);
      int kb = 0;
      // one rANS op: state R[0] with the op's (low, freq), renormalised from
      // the step's bytes (two renorms read <= 4 bytes), then the rotation
      auto op = [&](uint32_t lo, uint32_t fq) {
        uint32_t x = fq * (R[0] >> 16) + (R[0] & 0xFFFFu) - lo;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (x < kRansL) {
            x = (x << 8) | ((w4 >> (8 * kb)) & 0xFFu);
            ++kb;
          }
        }
        R[0] = R[1]; R[1] = R[2]; R[2] = R[3]; R[3] = x;
      };

      const uint32_t rng2 = R[1] & 0xFFFFu;
      int e, m;
      uint32_t lo, fq;
      md.find_exp(R[0] & 0xFFFFu, e, lo, fq);
      op(lo, fq);
      // mantissa model of exponent e: adaptive 1+e for e < 2, quasi 3+(e-2)
      auto quasi = [&](auto model) {
        constexpr int K = decltype(model)::value;
        md.find_quasi<K>(rng2, m, lo, fq);
        op(lo, fq);
        md.update_quasi<K>(m);
      };
      // the exponents in the order of their frequency in BWT rank streams of
      // text (e = 4 is about half the symbols): 4% faster than a switch
      if (e == 4) quasi(Model<2>());
      else if (e == 3) quasi(Model<1>());
      else if (e == 2) quasi(Model<0>());
      else if (e < 2) {
        md.find_adaptive(e, rng2, m, lo, fq);
        op(lo, fq);
        md.update_adaptive(tb, e, m);
      } else if (e == 5) quasi(Model<3>());
      else if (e == 6) quasi(Model<4>());
      else quasi(Model<5>());
      md.update_exp(tb, e);
      off += kb;
      if (off >= kSlide) {
        const uint32_t up = __shfl_down_sync(kFull, win, 16);
        win = lane < 16 ? up : ahead;
        wbase += kSlide;
        off -= kSlide;
        bounds();
        if (lane >= 16) ahead = load4(buf, n, wbase + kSlide + 4 * lane);
      }

      mine = lane == k ? tb.base[e] + m : mine;
    }
    if (lane < n32) out[(base + lane) * stride] = mine;
  }
  for (int i = steps + lane; i < max_rlen; i += 32) out[i * stride] = 0;
  if (lane == 0)
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
  const int blocks = (num_chains + kWarps - 1) / kWarps;
  rans_decode_kernel<<<blocks, kWarps * 32, 0,
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
