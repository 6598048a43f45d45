// K8: the LPC filter recurrence, both directions, one launch.
//
// Replaces two XLA loops: the encode direction of
// jampack_tpu/kernels/filters_search.py::_lpc_all (:125, the lax.fori_loop
// over every (chunk, width) lane of the -f2 sweep, also run by
// encode_stages._filters_apply_rows) and the decode direction inside
// jampack_tpu/kernels/device_stages.py::filters_decode_dyn_core
// (:468-490).  Reference: filters.cpp:49-65 (encode), LPC decode.
//
// The integer rules, the same both ways (int32, filters.cpp:44):
//   pred   = weight + ((p1 - p2) + p1)
//   encode: err = (pred - cur) & 0xFF, out = err
//   decode: cur = (pred - err) & 0xFF, out = cur
//   weight += (err - weight) >> 6    (arithmetic shift: nvcc compiles >>
//                                     of a signed int to an arithmetic
//                                     shift, and weight - err can be < 0)
//   p2 = p1, p1 = cur
// Positions at or past lens[lane] are written 0 and update nothing.
//
// What bounds it here: the serial dependency.  A lane is a chain of up to
// 65,536 steps of 4-6 dependent integer ops (through weight, and on decode
// through p1 too); the bytes (one read and one write of each lane) take far
// less time than the chain.
//
// Design: one thread per lane (4,128 lanes on the -f2 sweep of an 8 MiB
// block, one per 64 KiB chunk on apply and decode), 32 lanes per block so
// the lanes spread over the SMs.  A thread reads and writes its row 16
// bytes at a time and keeps the state in registers.
#include "common.cuh"

namespace {

constexpr int kThreads = 32;

template <bool kDecode>
__global__ void __launch_bounds__(kThreads) lpc_kernel(
    const uint8_t* __restrict__ in, int64_t width,
    const int32_t* __restrict__ lens, int lanes, uint8_t* __restrict__ out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const uint8_t* src = in + int64_t(lane) * width;
  uint8_t* dst = out + int64_t(lane) * width;
  const int64_t n = jt_clamp<int64_t>(lens[lane], 0, width);
  int32_t weight = 0, p1 = 0, p2 = 0;
  for (int64_t i0 = 0; i0 < width; i0 += 16) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i0 < n) {
      const uint4 x = *reinterpret_cast<const uint4*>(src + i0);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
      uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (i0 + b < n) {
          const int32_t byte = (w[b >> 2] >> (8 * (b & 3))) & 0xFF;
          const int32_t pred = weight + ((p1 - p2) + p1);
          int32_t err, cur;
          if (kDecode) {
            err = byte;
            cur = (pred - err) & 0xFF;
          } else {
            cur = byte;
            err = (pred - cur) & 0xFF;
          }
          weight += (err - weight) >> 6;
          p2 = p1;
          p1 = cur;
          o[b >> 2] |= uint32_t(kDecode ? cur : err) << (8 * (b & 3));
        }
      }
      v = make_uint4(o[0], o[1], o[2], o[3]);
    }
    *reinterpret_cast<uint4*>(dst + i0) = v;
  }
}

}  // namespace

// in, out: (lanes, width) uint8, width a multiple of 16, rows 16-byte
// aligned; lens: (lanes,) int32; decode: 0 = encode, 1 = decode.
JT_EXPORT int jt_lpc(const void* in, int64_t width, const void* lens,
                     int lanes, int decode, void* out, void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  auto kernel = decode ? lpc_kernel<true> : lpc_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), width,
      static_cast<const int32_t*>(lens), lanes, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}
