// K7: exact order-1 joint histogram of (prev, cur) byte pairs per lane.
//
// Replaces the Pallas kernel jampack_tpu/kernels/pallas_hist.py::
// _hist_kernel (:27, called from joint_hist_pallas :68), whose spec is
// filters_search._group_joint_xla.  It feeds every -f1/-f2 filter score.
//
// What it computes: for lane b of length n = lens[b], the counts of the
// pairs (prev_i, s_i), i < n, with prev_0 = 0 and prev_i = s_{i-1}, into a
// (256, 256) int32 table [prev][cur].  Pairs at or past n do not count;
// n = 0 gives an all-zero table.  Counts are exact integers (<= 2^16).
// The TPU kernel's bf16 one-hot MXU products are not carried over.
//
// What bounds it here: the bytes.  A 64 KiB lane in, a 256 KiB int32 table
// out (the table dominates: 3.3 GB for the 12,513 lanes of an 8 MiB -f2
// block), one shared-memory atomic per run of equal pairs.
//
// Design: a (256, 256) int32 table is 262,144 bytes, more than the 232,448
// a block may have.  So each block counts HALF the context rows: grid
// (lanes, 2), block y counts the pairs whose prev lies in rows
// [128 y, 128 y + 128) into 128 KiB of shared memory, and the lane is read
// twice (the second read mostly from L2).  Each of the 1,024 threads walks
// one contiguous segment of the lane with 16-byte loads and merges runs of
// equal pairs before its atomicAdd, so a lane of one repeated pair costs
// one atomic per thread, not one per byte.  Then the half table goes out
// with 16-byte stores.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 128;           // context rows per block: half the table
constexpr int kCells = kRows * 256;  // 32,768 counters
constexpr size_t kSmemBytes = kCells * sizeof(int32_t);  // 131,072

__device__ __forceinline__ void flush(int32_t* tab, int key, int count,
                                      int row0) {
  const int r = (key >> 8) - row0;
  if (key >= 0 && static_cast<unsigned>(r) < kRows)
    atomicAdd(&tab[(r << 8) | (key & 0xFF)], count);
}

__global__ void __launch_bounds__(kThreads) joint_hist_kernel(
    const uint8_t* __restrict__ streams, int64_t width,
    const int32_t* __restrict__ lens, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t tab[];
  int4* tab4 = reinterpret_cast<int4*>(tab);
  const int64_t lane = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  for (int k = threadIdx.x; k < kCells / 4; k += kThreads)
    tab4[k] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const uint8_t* s = streams + lane * width;
  const int64_t n = jt_clamp<int64_t>(lens[lane], 0, width);
  // segments are whole 16-byte words (width is a multiple of 16)
  const int64_t seg = ((width + kThreads - 1) / kThreads + 15) / 16 * 16;
  const int64_t begin = int64_t(threadIdx.x) * seg;
  const int64_t end = begin + seg < n ? begin + seg : n;
  if (begin < end) {
    int prev = begin ? s[begin - 1] : 0;
    int key = -1, count = 0;
    for (int64_t i0 = begin; i0 < end; i0 += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(s + i0);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (i0 + b < end) {
          const int cur = (w[b >> 2] >> (8 * (b & 3))) & 0xFF;
          const int k = (prev << 8) | cur;
          if (k != key) {
            flush(tab, key, count, row0);
            key = k;
            count = 0;
          }
          ++count;
          prev = cur;
        }
      }
    }
    flush(tab, key, count, row0);
  }
  __syncthreads();

  int4* o4 = reinterpret_cast<int4*>(out + lane * 65536 + int64_t(row0) * 256);
  for (int k = threadIdx.x; k < kCells / 4; k += kThreads) o4[k] = tab4[k];
}

}  // namespace

// streams: (lanes, width) uint8, width a multiple of 16, rows 16-byte
// aligned; lens: (lanes,) int32; out: (lanes, 256, 256) int32.
JT_EXPORT int jt_joint_hist(const void* streams, int64_t width,
                            const void* lens, int lanes, void* out,
                            void* stream) {
  if (lanes <= 0) return 0;
  cudaError_t err = jt_allow_smem(joint_hist_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  joint_hist_kernel<<<dim3(lanes, 256 / kRows), kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams), width,
      static_cast<const int32_t*>(lens), static_cast<int32_t*>(out));
  return cudaGetLastError();
}
