// K9: block scatter, out[offs[i] * S : (offs[i] + 1) * S] = src[i * S :
// (i + 1) * S] for int32 blocks of S elements.
//
// Replaces the pallas_call of tools/pallas_dma_bench.py (:83, its kernel
// :43): one DMA a block at a dynamic destination, issued through a ring of
// four DMA semaphores, the block indices scalar-prefetched.  The tool
// measures the descriptor rate of a DMA-binning sort; no path of the codec
// runs it.
//
// What bounds it here: bytes, each element read once and written once.
//
// Design: one block of 256 threads per source block, which reads its
// destination index once; a thread moves 16 bytes at a time when S is a
// multiple of 4 and both arrays are 16-byte aligned, else 4.  An index
// outside [0, nblocks) writes nothing, so a bad index cannot write past
// `out`; a block that no index names is left as it was.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) block_scatter_kernel(
    const T* __restrict__ src, const int32_t* __restrict__ offs, int nblocks,
    int64_t words, T* __restrict__ out) {
  const int d = offs[blockIdx.x];
  if (d < 0 || d >= nblocks) return;
  const T* from = src + int64_t(blockIdx.x) * words;
  T* to = out + int64_t(d) * words;
  for (int64_t k = threadIdx.x; k < words; k += kThreads) to[k] = from[k];
}

}  // namespace

// src, out: (nblocks * S,) int32; offs: (nblocks,) int32 block indices.
JT_EXPORT int jt_block_scatter(const void* src, const void* offs, int nblocks,
                               int64_t S, void* out, void* stream) {
  if (nblocks <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide =
      S % 4 == 0 && ((reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (wide)
    block_scatter_kernel<uint4><<<nblocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(src), static_cast<const int32_t*>(offs),
        nblocks, S / 4, static_cast<uint4*>(out));
  else
    block_scatter_kernel<int32_t><<<nblocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(offs),
        nblocks, S, static_cast<int32_t*>(out));
  return cudaGetLastError();
}
