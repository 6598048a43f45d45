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
//   weight += (err - weight) >> 6    (arithmetic shift)
//   p2 = p1, p1 = cur
// Positions at or past lens[lane] are written 0 and update nothing.
//
// What bounds it here: the serial dependency.  A lane is a chain of up to
// 65,536 steps; the bytes (one read and one write of each lane) take far
// less time.  So the design shortens the chain and keeps every load off it.
// What is left is the one warp a scheduler that walks its lanes' steps:
// 9 instructions a step on encode and 7 on decode (ptxas for sm_90a),
// which no other warp's work can overlap.
//
// A two-op chain, exact.  The weight stays in [0, 255]: from any w there,
// w + ((e - w) >> 6) lies between w and e.
//   encode: b = (2 p1 - p2 - cur) & 0xFF needs only input bytes, and
//           err = (w + b) & 0xFF, w' = (w + (b >> 6)) - 4 ((w + b) >> 8)
//           (the three-op step lpc_plain runs, checked for every (w, b) by
//           tests/test_torch_filters.py).  Carrying S = w + b instead:
//           S' = (S + k) - 4 (S >> 8), k = b' - b + (b >> 6) from input
//           bytes alone, err = S & 0xFF: a shift and a multiply-add.
//   decode: w' = w + ((e - w) >> 6) = (63 w + e) >> 6 (floor division by
//           64 distributes over 64 w): a multiply-add and a shift on the
//           input e alone.  The bytes are the double prefix sum mod 256 of
//           c = w - e: u_i = 2 u_{i-1} + (c_i - u_{i-2}), cur_i = u_i &
//           0xFF, kept in wrapping uint32 (only the low byte is ever
//           stored), on their own chain beside the weight's.
// Bytes staged ahead.  Each warp keeps a ring of kStages tiles of kTile
// bytes a lane in shared memory, filled by cp.async kStages - 1 tiles ahead
// of its walk (a tile's walk, ~256 x 20 cycles, covers a DRAM round trip);
// the walk reads and writes 16 bytes at a time in place, rows padded by 16
// bytes so the lanes' reads fall in distinct banks.  The warp then sends
// the tile's outputs out in 16-byte pieces.  Each thread moves the pieces
// of one row, its length in a register, all its loads issued before the
// first is used: with one warp a scheduler nothing else hides a load's
// latency, and a copy phase that waited on each piece in turn cost up to
// two cycles a step.
// Warps over the schedulers.  A block holds 32 lanes, kLanes a warp: the
// 4,128 sweep lanes are 516 warps, one a scheduler (8 lanes a warp beat 16
// and 32 on the card).  The other 24 threads of a warp only move bytes.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kLanes = 8;         // lanes a warp
constexpr int kBlockLanes = 32;   // lanes a block
constexpr int kTile = 256;        // bytes a lane a stage
constexpr int kStages = 3;
constexpr int kRow = kTile + 16;  // a lane's padded row in a stage
constexpr int kChunks = kTile / 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t byte_of(uint32_t x, int i) {
  return __byte_perm(x, 0, 0x4440 | i);
}

// The low bytes of s0..s3 as one little-endian word.
__device__ __forceinline__ uint32_t pack4(uint32_t s0, uint32_t s1,
                                          uint32_t s2, uint32_t s3) {
  return __byte_perm(__byte_perm(s0, s1, 0x0040), __byte_perm(s2, s3, 0x0040),
                     0x5410);
}

// Keeps bytes [0, keep) of a 16-byte piece, zeroes the rest.
__device__ __forceinline__ uint4 keep_first(uint4 v, int keep) {
  if (keep >= 16) return v;
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = keep - 4 * j;
    w[j] &= k >= 4 ? 0xFFFFFFFFu : (k <= 0 ? 0u : (1u << (8 * k)) - 1u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One step of each weight chain, written in PTX: from the same C++ form
// the compiler re-associates the chain into three dependent ops.
// encode: S' = (S + k) - 4 (S >> 8); the add runs beside the shift.
__device__ __forceinline__ int encode_chain(int S, int k) {
  int out;
  asm("{\n\t.reg .s32 sh, t;\n\tshr.s32 sh, %1, 8;\n\t"
      "add.s32 t, %1, %2;\n\tmad.lo.s32 %0, sh, -4, t;\n\t}"
      : "=r"(out)
      : "r"(S), "r"(k));
  return out;
}

// decode: w' = (63 w + e) >> 6.
__device__ __forceinline__ int decode_chain(int w, int e) {
  int out;
  asm("{\n\t.reg .s32 t;\n\tmad.lo.s32 t, %1, 63, %2;\n\t"
      "shr.s32 %0, t, 6;\n\t}"
      : "=r"(out)
      : "r"(w), "r"(e));
  return out;
}

struct Encode {
  int S = 0, bp = 0, p1 = 0, p2 = 0;  // S = w + b; bp = the last b
  __device__ __forceinline__ uint32_t word(uint32_t x) {
    uint32_t s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cur = byte_of(x, i);
      const int b = (2 * p1 - p2 - cur) & 0xFF;
      S = encode_chain(S, b - bp + (bp >> 6));  // err = S & 0xFF
      s[i] = S;
      bp = b;
      p2 = p1;
      p1 = cur;
    }
    return pack4(s[0], s[1], s[2], s[3]);
  }
};

struct Decode {
  int w = 0;
  uint32_t u1 = 0, u2 = 0;
  __device__ __forceinline__ uint32_t word(uint32_t x) {
    uint32_t s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = byte_of(x, i);
      const uint32_t c = uint32_t(w - e);
      w = decode_chain(w, e);
      const uint32_t u = 2u * u1 + (c - u2);  // cur = u & 0xFF
      s[i] = u;
      u2 = u1;
      u1 = u;
    }
    return pack4(s[0], s[1], s[2], s[3]);
  }
};

template <bool kDecode>
__global__ void __launch_bounds__(32 * (kBlockLanes / kLanes)) lpc_kernel(
    const uint8_t* __restrict__ in, int64_t width,
    const int32_t* __restrict__ lens, int lanes, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t ring[kBlockLanes * kStages * kRow];
  const int tid = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lane0 = blockIdx.x * kBlockLanes + warp * kLanes;
  int n = 0;
  if (tid < kLanes && lane0 + tid < lanes)
    n = int(jt_clamp<int64_t>(lens[lane0 + tid], 0, width));
  const int tiles = (__reduce_max_sync(kFull, n) + kTile - 1) / kTile;

  // The bytes move in 16-byte pieces, kPer a thread a tile, all of one
  // row, so a thread keeps its row's length in a register and sends its
  // pieces back to back: thread tid serves row tid / kSpan, pieces
  // tid % kSpan + kSpan j of each tile.
  constexpr int kSpan = 32 / kLanes;     // threads a row
  constexpr int kPer = kChunks / kSpan;  // pieces a thread a tile
  const int r = tid / kSpan, first = tid % kSpan;
  const int nr = __shfl_sync(kFull, n, r);
  const bool live = lane0 + r < lanes;
  const uint8_t* src = in + int64_t(lane0 + r) * width;
  uint8_t* dst = out + int64_t(lane0 + r) * width;
  uint8_t* my = ring + warp * (kStages * kLanes * kRow);
  auto pos_of = [&](int t, int j) {
    return t * kTile + 16 * (first + kSpan * j);
  };
  auto cell = [&](int t, int j) {
    return my + (t % kStages) * (kLanes * kRow) + r * kRow +
           16 * (first + kSpan * j);
  };
  auto load = [&](int t) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (pos_of(t, j) < nr) cp_async16(cell(t, j), src + pos_of(t, j));
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }

  typename std::conditional<kDecode, Decode, Encode>::type walk;
  for (int t = 0; t < tiles; ++t) {
    if (t + kStages - 1 < tiles) load(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    if (tid < kLanes) {
      uint8_t* row = my + (t % kStages) * (kLanes * kRow) + tid * kRow;
#pragma unroll 2
      for (int k = 0; k < kChunks; ++k) {
        uint4 v = *reinterpret_cast<const uint4*>(row + 16 * k);
        v.x = walk.word(v.x);
        v.y = walk.word(v.y);
        v.z = walk.word(v.z);
        v.w = walk.word(v.w);
        *reinterpret_cast<uint4*>(row + 16 * k) = v;
      }
    }
    __syncwarp();
#pragma unroll
    for (int j0 = 0; j0 < kPer; j0 += 4) {
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4 && j0 + j < kPer; ++j)
        v[j] = *reinterpret_cast<const uint4*>(cell(t, j0 + j));
#pragma unroll
      for (int j = 0; j < 4 && j0 + j < kPer; ++j) {
        const int pos = pos_of(t, j0 + j);
        if (live && pos < width)
          *reinterpret_cast<uint4*>(dst + pos) = keep_first(v[j], nr - pos);
      }
    }
    __syncwarp();
  }
  // past the walked tiles every row is zero
  if (live)
    for (int64_t pos = int64_t(tiles) * kTile + 16 * first; pos < width;
         pos += 16 * kSpan)
      *reinterpret_cast<uint4*>(dst + pos) = make_uint4(0, 0, 0, 0);
}

}  // namespace

// in, out: (lanes, width) uint8, width a multiple of 16, rows 16-byte
// aligned; lens: (lanes,) int32; decode: 0 = encode, 1 = decode.
JT_EXPORT int jt_lpc(const void* in, int64_t width, const void* lens,
                     int lanes, int decode, void* out, void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes + kBlockLanes - 1) / kBlockLanes;
  auto kernel = decode ? lpc_kernel<true> : lpc_kernel<false>;
  kernel<<<blocks, 32 * (kBlockLanes / kLanes), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), width,
      static_cast<const int32_t*>(lens), lanes, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}
