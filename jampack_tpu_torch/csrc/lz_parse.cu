// K11: the LZ77 token parse, one thread walking the tokens.
//
// Replaces the XLA loop of jampack_tpu/kernels/device_stages.py::
// lz_parse_core (:269, a lax.while_loop; its varint reader _leb_from :244).
// Reference: lz77.cpp:678-714, utils.cpp:73-90.  A token is a tag byte
// (match - 4 in 5 bits, 31 = extended; literal in 3 bits, 7 = extended),
// the offset, then the extensions, each a LEB128-with-carry varint; offset
// 0 ends the stream, whose rest is one raw literal run.
//
// Outputs, as lz_parse_core gives them: (dst, src, lit, off, match) int32
// arrays of max_tokens + 1 slots (unused dst = out_cap + 1), and a status
// (token count, output length, bad), so the caller fetches three ints once
// instead of syncing on every token.  bad is set on
// truncation, on an output past out_cap, on more tokens than the slots, and
// on a match that reaches before the output's start.
//
// What bounds it here: the serial dependency.  Each token's position is
// the previous token's end, known only after its varints are decoded: a
// load of the 16-byte window (byte k = buf[clip(pos + k, 0, N - 1)] where
// pos + k < N, else 0) and the varint arithmetic, a chain a token.  The
// window's 16 loads are issued together; consecutive windows share cache
// lines.  The block's other threads only fill the unused slots.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Byte k (0..15) of the window held in two little-endian words.
__device__ __forceinline__ uint32_t win_byte(uint64_t lo, uint64_t hi,
                                             int k) {
  return uint32_t((k < 8 ? lo >> (8 * k) : hi >> (8 * (k - 8))) & 0xFF);
}

// One varint at window offset q (device_stages._leb_from): the first byte
// with bit 7 set ends it (at most 5 bytes).  Returns the value in int32,
// with its byte count and whether it runs to or past n.
__device__ __forceinline__ int leb_from(uint64_t lo, uint64_t hi, int base,
                                        int q, int n, int& nb, bool& bad) {
  uint32_t b[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) b[k] = win_byte(lo, hi, q + k);
  int d = 4;
#pragma unroll
  for (int k = 3; k >= 0; --k)
    if (b[k] & 0x80) d = k;
  bad = base + q + d >= n;
  uint32_t val = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < d) val = (val << 7) | b[k];
  uint32_t last = b[4];
#pragma unroll
  for (int k = 3; k >= 0; --k)
    if (d == k) last = b[k];
  // the cumulative bases of format/varint.py CONSTANTS
  const uint32_t add = d == 0   ? 0u
                       : d == 1 ? 127u
                       : d == 2 ? 16510u
                       : d == 3 ? 2113661u
                                : 270549116u;
  nb = d + 1;
  return int(((val << 7) | (last & 0x7F)) + add);
}

__global__ void __launch_bounds__(kThreads) lz_parse_kernel(
    const uint8_t* __restrict__ buf, int N, int n, int slots, int out_cap,
    int32_t* __restrict__ d_, int32_t* __restrict__ s_,
    int32_t* __restrict__ l_, int32_t* __restrict__ o_,
    int32_t* __restrict__ m_, int32_t* __restrict__ status) {
  for (int k = threadIdx.x; k < slots; k += kThreads) {
    d_[k] = out_cap + 1;
    s_[k] = l_[k] = o_[k] = m_[k] = 0;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  int pos = 0, out_len = 0, t = 0;
  bool done = false, bad = false;
  while (!done && !bad && pos < n) {
    uint64_t lo = 0, hi = 0;
    if (N > 0) {
      uint32_t w[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int at = pos + k;  // pos < n <= N, so no overflow
        w[k] = at < N ? __ldg(buf + jt_clamp(at, 0, N - 1)) : 0u;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        lo |= uint64_t(w[k]) << (8 * k);
        hi |= uint64_t(w[k + 8]) << (8 * k);
      }
    }
    const int token = int(lo & 0xFF);
    int q = 1, nb, nb1, nb2;
    bool b1, b2, b3;
    const int off = leb_from(lo, hi, pos, q, n, nb, b1);
    q += nb;
    const int ext1 = leb_from(lo, hi, pos, q, n, nb1, b2);
    const bool has_mext = (token >> 3) == 31;
    if (has_mext) q += nb1;
    const int match =
        int((has_mext ? uint32_t(ext1) + 31u : uint32_t(token >> 3)) + 4u);
    const int ext2 = leb_from(lo, hi, pos, q, n, nb2, b3);
    const bool has_lext = (token & 7) == 7;
    if (has_lext) q += nb2;
    const int lit = has_lext ? int(uint32_t(ext2) + 7u) : (token & 7);
    const int p = pos + q;
    bad = bad || b1 || (has_mext && b2) || (has_lext && b3) || match < 0 ||
          lit < 0 || off < 0 || t >= slots;
    const int ts = jt_clamp(t, 0, slots - 1);
    const bool is_end = off == 0;
    const int rec_lit = is_end ? int(uint32_t(n) - uint32_t(p)) : lit;
    const int rec_match = is_end ? 0 : match;
    const int new_out =
        int(uint32_t(out_len) + uint32_t(rec_lit) + uint32_t(rec_match));
    const int end = int(uint32_t(p) + uint32_t(lit));
    bad = bad || new_out > out_cap ||
          (!is_end &&
           (end >= n || int(uint32_t(out_len) + uint32_t(lit) -
                            uint32_t(off)) < 0));
    if (!bad) d_[ts] = out_len;
    s_[ts] = p;
    l_[ts] = rec_lit;
    o_[ts] = is_end ? 0 : off;
    m_[ts] = rec_match;
    pos = is_end ? n : end;
    if (!bad) out_len = new_out;
    ++t;
    done = is_end;
  }
  // a stream that ran out without the end token is truncated
  bad = bad || (!done && t > 0 && pos >= n && n > 0);
  status[0] = t;
  status[1] = out_len;
  status[2] = bad;
}

}  // namespace

// buf: (N,) uint8, the first n bytes parsed; d, s, l, o, m: (slots,) int32
// with slots = max_tokens + 1; status: (3,) int32.
JT_EXPORT int jt_lz_parse(const void* buf, int N, int n, int slots,
                          int out_cap, void* d, void* s, void* l, void* o,
                          void* m, void* status, void* stream) {
  if (slots <= 0) return cudaErrorInvalidValue;
  lz_parse_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), N, n, slots, out_cap,
      static_cast<int32_t*>(d), static_cast<int32_t*>(s),
      static_cast<int32_t*>(l), static_cast<int32_t*>(o),
      static_cast<int32_t*>(m), static_cast<int32_t*>(status));
  return cudaGetLastError();
}
