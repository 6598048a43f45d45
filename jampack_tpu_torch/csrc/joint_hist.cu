// K7: exact order-1 joint histogram of (prev, cur) byte pairs per lane.
//
// Replaces the Pallas kernel jampack_tpu/kernels/pallas_hist.py::
// _hist_kernel (:27, called from joint_hist_pallas :68), whose spec is
// filters_search._group_joint_xla.  It feeds every -f1/-f2 filter score.
//
// What it computes: for lane b of length n = lens[b], the counts of the
// pairs (prev_i, s_i), i < n, with prev_0 = 0 and prev_i = s_{i-1}, into a
// (256, 256) int32 table [prev][cur].  Pairs at or past n do not count;
// n = 0 gives an all-zero table.  Counts are exact integers (<= 2^16: the
// wrapper takes lanes of at most 65,536 bytes).  The TPU kernel's bf16
// one-hot MXU products are not carried over.
//
// What bounds it here: the bytes.  A 64 KiB lane in, a 256 KiB int32 table
// out (the table dominates: 3.3 GB for the 12,513 lanes of an 8 MiB -f2
// block), one shared-memory atomic per run of equal pairs.  Next to it,
// the instructions that walk the bytes: a design that counts half the
// table a block walks every lane twice and is bound by that walk, not by
// its stores, even at three blocks an SM.
//
// Design: one block a lane, the WHOLE table in shared memory as uint16
// counters packed two to a 32-bit word (128 KiB), so each lane is walked
// once and every atomic counts.  A uint16 counter can only overflow on the
// cell (0, 0): a count of 65,536 needs every pair equal, and the first
// pair's prev is 0, so the lane is 65,536 zeros.  That one cell is counted
// apart, in a register a thread, summed over the block in int32.  Each of
// the 1,024 threads walks one contiguous 64-byte segment, loaded as four
// 16-byte words at once, so the whole 64 KiB lane is in flight together,
// as one bulk copy into shared memory would put it.  A pair's key comes
// from one byte permute of the word and the word shifted by a byte, and
// runs of equal pairs merge before their atomicAdd, so a lane of one
// repeated pair costs one atomic per thread, not one per byte.  Only a
// word that holds the lane's end checks positions.  The table leaves
// widened to int32, 16 bytes a thread, neighbouring threads on
// neighbouring addresses, with streaming (evict-first) stores: the tables
// are not read again before they would leave L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kCells = 65536;
constexpr size_t kSmemBytes = kCells * sizeof(uint16_t);  // 131,072

// (prev << 8 | cur) * 0x10001 for byte i of x, where byte i of p is the
// byte before x's byte i: injective, nonzero unless the pair is (0, 0), and
// key >> 17 is the pair's 32-bit word of the packed table.
__device__ __forceinline__ uint32_t pair_key(uint32_t x, uint32_t p, int i) {
  return __byte_perm(x, p, i | (4 + i) << 4 | i << 8 | (4 + i) << 12);
}

struct Counter {
  uint32_t* tab;
  uint32_t key = 0;
  int count = 0, zeros = 0;
  __device__ __forceinline__ void flush() {
    if (key)
      atomicAdd(&tab[key >> 17], uint32_t(count) << ((key & 1) << 4));
    else
      zeros += count;
  }
  __device__ __forceinline__ void add(uint32_t k) {
    if (k != key) {
      flush();
      key = k;
      count = 0;
    }
    ++count;
  }
};

__global__ void __launch_bounds__(kThreads, 1) joint_hist_kernel(
    const uint8_t* __restrict__ streams, int64_t width,
    const int32_t* __restrict__ lens, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t tab[];
  __shared__ int zeros;
  const int64_t lane = blockIdx.x;
  uint4* tab4 = reinterpret_cast<uint4*>(tab);
  for (int k = threadIdx.x; k < kCells / 8; k += kThreads)
    tab4[k] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) zeros = 0;
  __syncthreads();

  const uint8_t* s = streams + lane * width;
  const int n = int(jt_clamp<int64_t>(lens[lane], 0, width));
  // segments are whole 16-byte words (width is a multiple of 16)
  const int seg = int(((width + kThreads - 1) / kThreads + 15) / 16 * 16);
  const int begin = threadIdx.x * seg;
  const int end = min(begin + seg, n);
  Counter c{tab};
  if (begin < end) {
    uint32_t pw = begin ? uint32_t(__ldg(s + begin - 1)) << 24 : 0u;
    for (int i0 = begin; i0 < end; i0 += 64) {
      uint4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = i0 + 16 * q < end
                   ? __ldg(reinterpret_cast<const uint4*>(s + i0 + 16 * q))
                   : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
        const int base = i0 + 16 * q;
        if (base + 16 <= end) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t p = __funnelshift_l(pw, w[j], 8);
#pragma unroll
            for (int i = 0; i < 4; ++i) c.add(pair_key(w[j], p, i));
            pw = w[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t p = __funnelshift_l(pw, w[j], 8);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (base + 4 * j + i < end) c.add(pair_key(w[j], p, i));
            pw = w[j];
          }
        }
      }
    }
    c.flush();
  }
  int z = c.zeros;
#pragma unroll
  for (int o = 16; o; o >>= 1) z += __shfl_xor_sync(0xFFFFFFFFu, z, o);
  if ((threadIdx.x & 31) == 0 && z) atomicAdd(&zeros, z);
  __syncthreads();

  const uint2* tab2 = reinterpret_cast<const uint2*>(tab);
  int4* o4 = reinterpret_cast<int4*>(out + lane * kCells);
  for (int k = threadIdx.x; k < kCells / 4; k += kThreads) {
    const uint2 v = tab2[k];
    __stcs(o4 + k, make_int4(k ? int(v.x & 0xFFFF) : zeros, int(v.x >> 16),
                             int(v.y & 0xFFFF), int(v.y >> 16)));
  }
}

}  // namespace

// streams: (lanes, width) uint8, width a multiple of 16 and at most 65,536,
// rows 16-byte aligned; lens: (lanes,) int32; out: (lanes, 256, 256) int32.
JT_EXPORT int jt_joint_hist(const void* streams, int64_t width,
                            const void* lens, int lanes, void* out,
                            void* stream) {
  if (lanes <= 0) return 0;
  cudaError_t err = jt_allow_smem(joint_hist_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  joint_hist_kernel<<<lanes, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams), width,
      static_cast<const int32_t*>(lens), static_cast<int32_t*>(out));
  return cudaGetLastError();
}
