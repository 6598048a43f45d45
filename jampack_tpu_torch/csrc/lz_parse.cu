// K11: the LZ77 token parse: a short serial head, then candidate tokens at
// every byte and the token chain found by pointer jumping.
//
// Replaces the XLA loop of jampack_tpu/kernels/device_stages.py::
// lz_parse_core (:269, a lax.while_loop; its varint reader _leb_from :244).
// Reference: lz77.cpp:678-714, utils.cpp:73-90.  A token is a tag byte
// (match - 4 in 5 bits, 31 = extended; literal in 3 bits, 7 = extended),
// the offset, then the extensions, each a LEB128-with-carry varint; offset
// 0 ends the stream, whose rest is one raw literal run.
//
// Outputs, as lz_parse_core gives them: (dst, src, lit, off, match) int32
// arrays of `slots` = max_tokens + 1 entries (unused dst = out_cap + 1),
// and a status (token count, output length, bad).  bad is set on
// truncation, on an output past out_cap, on more tokens than the slots,
// and on a match that reaches before the output's start.
//
// What bounds it: the walk is a chain.  A token starts where the one
// before ends, known only after its varints are decoded; one thread
// walking it took about 1,000 cycles a token.  The design cuts the chain:
//
//   jt_lz_parse, the head.  One thread walks the first `head` tokens while
//   the grid fills the other slots with their unused values; the status
//   says whether the stream goes on, and from where.  A stream of one
//   token (every store-mode block) ends here.
//   jt_lz_parse_chain, when the stream goes on at position p0 in [0, n)
//   after t0 tokens:
//     1. candidates: a thread a position p in [p0, n) decodes the token
//        that would start there and writes its end, or ~p where a chain
//        stops at that token (the end token, a token bad on its own, an end
//        that wrapped below 0);
//     2. jumps: log2(D) squaring passes give next^D: the position D tokens
//        on, or ~(the first stopping token within them);
//     3. hops: one thread walks from p0 by next^D and records where each
//        sub-chain of D tokens starts, up to the token with index `slots`,
//        the first that has no slot;
//     4. sub-chains: a thread a sub-chain decodes its tokens again and
//        writes their fields by token index;
//     5. finish: one block scans the tokens' output lengths, finds the first
//        token at which the walk stops (bad on its own or by its prefix:
//        output past out_cap, a match before the output's start, no slot;
//        or the end token, or a wrapped end), writes the slots up to it as
//        the serial walk writes them, and the status.  A chain that left
//        [0, n) by a wrapped end is walked on serially from there, as
//        lz_parse_core's loop carries on at that position.
//   With p0 outside [0, n) only step 5's serial walk runs.
// The serial part is t / D hops.  A token's window (byte k =
// buf[clip(pos + k, 0, N - 1)] where pos + k < N, else 0) is read as five
// aligned words where it lies inside the buffer.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScan = 1024;  // the finishing block

struct Window {
  uint64_t lo, hi;  // bytes 0-7 and 8-15, little-endian
};

__device__ __forceinline__ Window window(const uint8_t* __restrict__ buf,
                                         int N, int pos, bool words) {
  if (words && pos >= 0 && pos <= N - 20) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(buf) + (pos >> 2);
    const uint32_t sh = 8u * uint32_t(pos & 3);
    uint32_t v[5], b[4];
#pragma unroll
    for (int k = 0; k < 5; ++k) v[k] = __ldg(w + k);
#pragma unroll
    for (int k = 0; k < 4; ++k) b[k] = __funnelshift_r(v[k], v[k + 1], sh);
    return {b[0] | (uint64_t(b[1]) << 32), b[2] | (uint64_t(b[3]) << 32)};
  }
  Window win{0, 0};
  if (N > 0) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int64_t at = int64_t(pos) + k;
      const uint64_t b =
          at < N ? __ldg(buf + jt_clamp<int64_t>(at, 0, N - 1)) : 0u;
      if (k < 8)
        win.lo |= b << (8 * k);
      else
        win.hi |= b << (8 * (k - 8));
    }
  }
  return win;
}

// Byte k (0..15) of a window.
__device__ __forceinline__ uint32_t win_byte(const Window& w, int k) {
  return uint32_t((k < 8 ? w.lo >> (8 * k) : w.hi >> (8 * (k - 8))) & 0xFF);
}

// One varint at window offset q (device_stages._leb_from): the first byte
// with bit 7 set ends it (at most 5 bytes).  Returns the value in int32,
// with its byte count and whether it runs to or past n.
__device__ __forceinline__ int leb_from(const Window& w, int base, int q,
                                        int n, int& nb, bool& bad) {
  uint32_t b[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) b[k] = win_byte(w, q + k);
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

struct Token {
  int p;      // where its literals start: pos + header
  int lit;    // literal length, match length and offset as read
  int match;
  int off;
  int end;    // p + lit, uint32 wrap: the next token's position
  bool is_end;
  bool bad;   // what makes it bad on its own
};

__device__ __forceinline__ Token decode(const uint8_t* __restrict__ buf,
                                        int N, int n, int pos, bool words) {
  const Window w = window(buf, N, pos, words);
  const int token = int(w.lo & 0xFF);
  Token tk;
  int q = 1, nb, nb1, nb2;
  bool b1, b2, b3;
  tk.off = leb_from(w, pos, q, n, nb, b1);
  q += nb;
  const int ext1 = leb_from(w, pos, q, n, nb1, b2);
  const bool has_mext = (token >> 3) == 31;
  if (has_mext) q += nb1;
  tk.match =
      int((has_mext ? uint32_t(ext1) + 31u : uint32_t(token >> 3)) + 4u);
  const int ext2 = leb_from(w, pos, q, n, nb2, b3);
  const bool has_lext = (token & 7) == 7;
  if (has_lext) q += nb2;
  tk.lit = has_lext ? int(uint32_t(ext2) + 7u) : (token & 7);
  tk.p = int(uint32_t(pos) + uint32_t(q));
  tk.end = int(uint32_t(tk.p) + uint32_t(tk.lit));
  tk.is_end = tk.off == 0;
  tk.bad = b1 || (has_mext && b2) || (has_lext && b3) || tk.match < 0 ||
           tk.lit < 0 || tk.off < 0 || (!tk.is_end && tk.end >= n);
  return tk;
}

// A token at which a chain stops: the end token, a token bad on its own,
// or an end that wrapped below 0 (no candidate lies there).
__device__ __forceinline__ bool stops(const Token& tk) {
  return tk.bad || tk.is_end || tk.end < 0;
}

struct Slots {
  int32_t *d, *s, *l, *o, *m;
  int count, out_cap;
};

struct Walk {
  int pos, t, out_len;
  bool done, bad;
};

__device__ __forceinline__ void unused_slot(const Slots& sl, int k) {
  sl.d[k] = sl.out_cap + 1;
  sl.s[k] = sl.l[k] = sl.o[k] = sl.m[k] = 0;
}

// The serial walk (lz_parse_core's loop) from w for at most `limit`
// tokens, writing their slots.
__device__ void walk_serial(const uint8_t* __restrict__ buf, int N, int n,
                            bool words, const Slots& sl, Walk& w,
                            int limit) {
  for (int k = 0; k < limit && !w.done && !w.bad && w.pos < n; ++k) {
    const Token tk = decode(buf, N, n, w.pos, words);
    const int rec_lit = tk.is_end ? int(uint32_t(n) - uint32_t(tk.p)) : tk.lit;
    const int rec_match = tk.is_end ? 0 : tk.match;
    const int new_out = int(uint32_t(w.out_len) + uint32_t(rec_lit) +
                            uint32_t(rec_match));
    w.bad = tk.bad || w.t >= sl.count || new_out > sl.out_cap ||
            (!tk.is_end && int(uint32_t(w.out_len) + uint32_t(tk.lit) -
                               uint32_t(tk.off)) < 0);
    const int ts = jt_clamp(w.t, 0, sl.count - 1);
    if (!w.bad) sl.d[ts] = w.out_len;
    sl.s[ts] = tk.p;
    sl.l[ts] = rec_lit;
    sl.o[ts] = tk.is_end ? 0 : tk.off;
    sl.m[ts] = rec_match;
    w.pos = tk.is_end ? n : tk.end;
    if (!w.bad) w.out_len = new_out;
    ++w.t;
    w.done = tk.is_end;
  }
}

// status: (token count, output length, bad, the stream goes on, position)
__device__ void put_status(Walk w, int n, bool more, int32_t* status) {
  // a stream that ran out without the end token is truncated
  if (!more) w.bad = w.bad || (!w.done && w.t > 0 && w.pos >= n && n > 0);
  status[0] = w.t;
  status[1] = w.out_len;
  status[2] = w.bad;
  status[3] = more;
  status[4] = w.pos;
}

__global__ void __launch_bounds__(kThreads) lz_head(
    const uint8_t* __restrict__ buf, int N, int n, bool words, Slots sl,
    int head, int32_t* __restrict__ status) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t k = head + int64_t(blockIdx.x) * kThreads + threadIdx.x;
       k < sl.count; k += stride)
    unused_slot(sl, int(k));
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  for (int k = 0; k < min(head, sl.count); ++k) unused_slot(sl, k);
  Walk w{0, 0, 0, false, false};
  walk_serial(buf, N, n, words, sl, w, head);
  put_status(w, n, !(w.done || w.bad || w.pos >= n), status);
}

// 1. jump[p - p0]: the end of the token at p, or ~p where a chain stops.
__global__ void __launch_bounds__(kThreads) lz_candidates(
    const uint8_t* __restrict__ buf, int N, int n, bool words, int p0,
    int32_t* __restrict__ jump) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t p = p0 + int64_t(blockIdx.x) * kThreads + threadIdx.x; p < n;
       p += stride) {
    const Token tk = decode(buf, N, n, int(p), words);
    jump[p - p0] = stops(tk) ? ~int(p) : tk.end;
  }
}

// 2. b = a composed with itself; a stop carries over.
__global__ void __launch_bounds__(kThreads) lz_square(
    const int32_t* __restrict__ a, int p0, int64_t len,
    int32_t* __restrict__ b) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t k = int64_t(blockIdx.x) * kThreads + threadIdx.x; k < len;
       k += stride) {
    const int32_t v = a[k];
    b[k] = v < 0 ? v : a[v - p0];
  }
}

// 3. hops[j]: where sub-chain j (tokens t0 + jD .. t0 + jD + D - 1)
// starts; counts[0] = the sub-chains.
__global__ void lz_hops(const int32_t* __restrict__ jump, int p0, int t0,
                        int slots, int depth, int32_t* __restrict__ hops,
                        int32_t* __restrict__ counts) {
  int h = p0, j = 0;
  for (;;) {
    hops[j++] = h;
    if (int64_t(t0) + int64_t(j) * depth > slots) break;
    const int v = jump[h - p0];
    if (v < 0) break;
    h = v;
  }
  counts[0] = j;
}

// 4. The tokens of each sub-chain by index u = t - t0: tok holds five rows
// of `cap` (src, rec_lit, off, rec_match, flags: 1 bad on its own, 2 the
// end token, 4 a wrapped end); counts[1] = the tokens up to the stop.
__global__ void __launch_bounds__(kThreads) lz_subchains(
    const uint8_t* __restrict__ buf, int N, int n, bool words,
    const int32_t* __restrict__ hops, int t0, int slots, int depth,
    int32_t* __restrict__ tok, int cap, int32_t* __restrict__ counts) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= counts[0]) return;
  int pos = hops[j];
  for (int k = 0; k < depth; ++k) {
    const int u = j * depth + k;
    const Token tk = decode(buf, N, n, pos, words);
    tok[u] = tk.p;
    tok[cap + u] = tk.is_end ? int(uint32_t(n) - uint32_t(tk.p)) : tk.lit;
    tok[2 * cap + u] = tk.is_end ? 0 : tk.off;
    tok[3 * cap + u] = tk.is_end ? 0 : tk.match;
    tok[4 * cap + u] = int(tk.bad) | (int(tk.is_end) << 1) |
                       (int(!tk.bad && !tk.is_end && tk.end < 0) << 2);
    if (stops(tk) || t0 + u == slots) {
      counts[1] = u + 1;
      return;
    }
    pos = tk.end;
  }
}

// 5. One block: the first token at which the walk stops, the slots up to
// it, the serial walk on from a wrapped end, the status.  serial: the
// stream goes on outside [0, n), at pos0.
__global__ void __launch_bounds__(kScan) lz_finish(
    const uint8_t* __restrict__ buf, int N, int n, bool words, Slots sl,
    const int32_t* __restrict__ tok, int cap,
    const int32_t* __restrict__ counts, int t0, int out0, int pos0,
    bool serial, int32_t* __restrict__ status) {
  __shared__ uint32_t part[kScan];
  __shared__ int first;
  __shared__ Walk last;
  if (threadIdx.x == 0) {
    first = INT32_MAX;
    last = Walk{pos0, t0, out0, false, false};
  }
  const int T = serial ? 0 : counts[1];
  const int per = (T + kScan - 1) / kScan;
  const int lo = min(T, int(threadIdx.x) * per), hi = min(T, lo + per);
  const int32_t *s = tok, *l = tok + cap, *o = tok + 2 * cap,
                *m = tok + 3 * cap, *f = tok + 4 * cap;
  uint32_t sum = 0;
  for (int u = lo; u < hi; ++u) sum += uint32_t(l[u]) + uint32_t(m[u]);
  // exclusive scan of the threads' sums, uint32 wrap (int32 in the walk)
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int step = 1; step < kScan; step <<= 1) {
    const uint32_t add = threadIdx.x >= step ? part[threadIdx.x - step] : 0u;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  const uint32_t base = uint32_t(out0) + part[threadIdx.x] - sum;
  // the first token of this thread's range at which the walk stops
  uint32_t out = base;
  for (int u = lo; u < hi; ++u) {
    const uint32_t len = uint32_t(l[u]) + uint32_t(m[u]);
    const bool is_end = f[u] & 2;
    const bool bad = (f[u] & 1) || t0 + u >= sl.count ||
                     int(out + len) > sl.out_cap ||
                     (!is_end && int(out + uint32_t(l[u]) - uint32_t(o[u])) < 0);
    if (bad || (f[u] & 6)) {
      atomicMin(&first, u);
      break;
    }
    out += len;
  }
  __syncthreads();
  const int stop = first;
  // the slots up to the stop; the slot of index slots - 1 takes src, lit,
  // off and match from the token of index slots when the walk reaches it
  out = base;
  for (int u = lo; u < hi && u <= stop; ++u) {
    const int t = t0 + u;
    const uint32_t len = uint32_t(l[u]) + uint32_t(m[u]);
    const bool is_end = f[u] & 2;
    const bool bad = (f[u] & 1) || t >= sl.count ||
                     int(out + len) > sl.out_cap ||
                     (!is_end && int(out + uint32_t(l[u]) - uint32_t(o[u])) < 0);
    const int ts = min(t, sl.count - 1);
    if (!bad) sl.d[ts] = int(out);
    if (!(t == sl.count - 1 && t0 + stop == sl.count)) {
      sl.s[ts] = s[u];
      sl.l[ts] = l[u];
      sl.o[ts] = o[u];
      sl.m[ts] = m[u];
    }
    if (u == stop)
      last = Walk{is_end ? n : int(uint32_t(s[u]) + uint32_t(l[u])), t + 1,
                  int(bad ? out : out + len), is_end, bad};
    out += len;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  Walk w = last;
  walk_serial(buf, N, n, words, sl, w, INT32_MAX);
  put_status(w, n, false, status);
}

// Blocks for a grid-stride pass over len items: up to 16 an SM.  The SM
// count is read once, from the first card that launches (the cards of one
// host are alike).
int grid_for(int64_t len) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const int64_t blocks = (len + kThreads - 1) / kThreads;
  return int(blocks < 1 ? 1 : blocks < 16 * sms ? blocks : 16 * sms);
}

bool word_aligned(const void* buf) {
  return (reinterpret_cast<uintptr_t>(buf) & 3) == 0;
}

// The rest of the walk after the head, up to phase `stop` (1 candidates,
// 2 jumps, 3 hops, 4 sub-chains, 5 finish: the slots and the status
// written).
int walk_chain(const void* buf, int N, int n, int slots, int out_cap,
               int p0, int t0, int out0, int depth, int stop, void* ja,
               void* jb, void* hops, void* tok, void* counts, void* d,
               void* s, void* l, void* o, void* m, void* status,
               void* stream) {
  if (slots <= 0 || t0 < 0 || t0 > slots || depth < 1 ||
      (depth & (depth - 1)) || stop < 1 || stop > 5)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* b = static_cast<const uint8_t*>(buf);
  const bool words = word_aligned(buf);
  const Slots sl{static_cast<int32_t*>(d), static_cast<int32_t*>(s),
                 static_cast<int32_t*>(l), static_cast<int32_t*>(o),
                 static_cast<int32_t*>(m), slots, out_cap};
  const int cap = slots - t0 + 1;
  auto* c = static_cast<int32_t*>(counts);
  auto* tk = static_cast<int32_t*>(tok);
  const bool chain = p0 >= 0 && p0 < n;
  if (chain) {
    const int64_t len = int64_t(n) - p0;
    auto* a = static_cast<int32_t*>(ja);
    auto* z = static_cast<int32_t*>(jb);
    lz_candidates<<<grid_for(len), kThreads, 0, st>>>(b, N, n, words, p0, a);
    if (stop < 2) return cudaGetLastError();
    for (int k = 1; k < depth; k <<= 1) {
      lz_square<<<grid_for(len), kThreads, 0, st>>>(a, p0, len, z);
      int32_t* t = a;
      a = z;
      z = t;
    }
    if (stop < 3) return cudaGetLastError();
    auto* h = static_cast<int32_t*>(hops);
    lz_hops<<<1, 1, 0, st>>>(a, p0, t0, slots, depth, h, c);
    if (stop < 4) return cudaGetLastError();
    const int most = cap / depth + 2;
    lz_subchains<<<(most + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        b, N, n, words, h, t0, slots, depth, tk, cap, c);
    if (stop < 5) return cudaGetLastError();
  } else if (stop < 5) {
    return 0;
  }
  lz_finish<<<1, kScan, 0, st>>>(b, N, n, words, sl, tk, cap, c, t0, out0,
                                 p0, !chain, static_cast<int32_t*>(status));
  return cudaGetLastError();
}

}  // namespace

// buf: (N,) uint8, the first n bytes parsed; d, s, l, o, m: (slots,) int32
// with slots = max_tokens + 1; status: (5,) int32, see put_status.  The
// head walks at most `head` tokens; status[3] says whether the stream goes
// on, at status[4] after status[0] tokens (then jt_lz_parse_chain).
JT_EXPORT int jt_lz_parse(const void* buf, int N, int n, int slots,
                          int out_cap, int head, void* d, void* s, void* l,
                          void* o, void* m, void* status, void* stream) {
  if (slots <= 0 || head < 0) return cudaErrorInvalidValue;
  const Slots sl{static_cast<int32_t*>(d), static_cast<int32_t*>(s),
                 static_cast<int32_t*>(l), static_cast<int32_t*>(o),
                 static_cast<int32_t*>(m), slots, out_cap};
  lz_head<<<grid_for(slots), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), N, n, word_aligned(buf), sl, head,
      static_cast<int32_t*>(status));
  return cudaGetLastError();
}

// The rest of the walk after the head: from position p0 after t0 tokens
// and out0 output bytes.  depth: D, a power of two; ja, jb: (n - p0,) int32
// scratch, used when p0 lies in [0, n); hops: (cap / depth + 2,) int32;
// tok: (5 * cap,) int32 with cap = slots - t0 + 1; counts: (2,) int32.
JT_EXPORT int jt_lz_parse_chain(const void* buf, int N, int n, int slots,
                                int out_cap, int p0, int t0, int out0,
                                int depth, void* ja, void* jb, void* hops,
                                void* tok, void* counts, void* d, void* s,
                                void* l, void* o, void* m, void* status,
                                void* stream) {
  return walk_chain(buf, N, n, slots, out_cap, p0, t0, out0, depth, 5, ja,
                    jb, hops, tok, counts, d, s, l, o, m, status, stream);
}

// For measurement only: jt_lz_parse_chain ending after phase `stop` (1-4
// leave the slots and the status unwritten).
JT_EXPORT int jt_lz_parse_chain_at(const void* buf, int N, int n, int slots,
                                   int out_cap, int p0, int t0, int out0,
                                   int depth, int stop, void* ja, void* jb,
                                   void* hops, void* tok, void* counts,
                                   void* d, void* s, void* l, void* o,
                                   void* m, void* status, void* stream) {
  return walk_chain(buf, N, n, slots, out_cap, p0, t0, out0, depth, stop,
                    ja, jb, hops, tok, counts, d, s, l, o, m, status, stream);
}
