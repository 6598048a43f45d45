// Entropy stage: SRC rank -> RLE0 -> structured 4-way interleaved rANS.
// Stream-exact with the reference chunk layout (ans.cpp:113-302) and model
// arithmetic (model.cpp, rank.cpp, rle.cpp, rans_byte.hpp); fresh
// implementation organized around flat state structs instead of classes.
#include <omp.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#include "jn_common.hpp"

namespace jpt {

// ---- symbol structure tables (tables.hpp semantics, generated) ----
struct SymTables {
  int exponent[9];
  int log2c[257];
  int mant[257];
  SymTables() {
    const int bounds[9] = {0, 2, 4, 8, 16, 32, 64, 128, 257};
    for (int i = 0; i < 9; i++) exponent[i] = bounds[i];
    for (int s = 0; s < 257; s++) {
      int e = 0;
      while (e < 8 && s >= bounds[e + 1]) e++;
      log2c[s] = e;
      mant[s] = s - bounds[e];
    }
  }
};
static const SymTables kSym;

constexpr int kMaxModels = 8;
constexpr int kSwitch = 2;  // exponents 0..1 adaptive, rest quasi
constexpr int kRate = 5;
constexpr int kUpdateRate = 64 << 10;

// ---- adaptive CDF-mixing model (model.cpp:11-113 semantics) ----
struct Adaptive {
  int alpha = 0;
  std::vector<i32> mix;  // (alpha) x (alpha+1)
  std::vector<i32> cum;  // alpha+1

  void init(int a) {
    alpha = a;
    mix.assign(size_t(a) * (a + 1), 0);
    cum.assign(a + 1, 0);
    for (int sym = 0; sym < a; sym++) {
      i32 rm = 0;
      i32* row = &mix[size_t(sym) * (a + 1)];
      for (int st = 0; st <= a; st++) {
        row[st] = rm;
        rm += (st == sym) ? (kProbScale - a + 1) : 1;
      }
    }
    reset();
  }
  void reset() {
    i32 scale = kProbScale / alpha;
    cum[0] = 0;
    for (int i = 0; i < alpha; i++)
      cum[i + 1] = cum[i] + scale + ((i == 0) ? (kProbScale - scale * alpha) : 0);
  }
  inline void update(int sym) {
    const i32* row = &mix[size_t(sym) * (alpha + 1)];
    // fixed-trip-count bodies for the two alphabets in use (exponent model
    // alpha=8, adaptive mantissa alpha=2) so the mixing loop vectorizes;
    // the generic loop's runtime bound kept it scalar
    if (alpha == 8) {
      for (int i = 1; i < 8; i++) cum[i] += (row[i] - cum[i]) >> kRate;
    } else if (alpha == 2) {
      cum[1] += (row[1] - cum[1]) >> kRate;
    } else {
      for (int i = 1; i < alpha; i++) cum[i] += (row[i] - cum[i]) >> kRate;
    }
  }
  inline int range_to_sym(u32 r) const {
    // cum is monotone with cum[0] = 0 <= r < cum[alpha] = 2^16, so the
    // answer is the first k in [1, alpha] with cum[k] > r, minus one —
    // identical to the linear scan, including on empty intervals
#if defined(__AVX2__)
    if (alpha == 8) {
      __m256i c = _mm256_loadu_si256((const __m256i*)&cum[1]);
      __m256i rv = _mm256_set1_epi32(int(r));
      u32 gt = u32(_mm256_movemask_ps(
          _mm256_castsi256_ps(_mm256_cmpgt_epi32(c, rv))));
      return __builtin_ctz(gt | 0x80u);  // bit 7 (cum[8] = 2^16) always set
    }
#endif
    if (alpha == 2) return int(r >= u32(cum[1]));
    int i = 0;
    while (!(u32(cum[i]) <= r && r < u32(cum[i + 1]))) i++;
    return i;
  }
};

// ---- quasi-static model (model.cpp:115-235 semantics) ----
struct Quasi {
  int alpha = 0;
  int seen = 0, exp = 8;
  std::vector<i32> freqs, cum;
  std::vector<u16> r2s;  // kProbScale entries

  void init(int a) {
    alpha = a;
    freqs.assign(a, 0);
    cum.assign(a + 1, 0);
    r2s.assign(kProbScale, 0);
    reset();
  }
  void rebuild_lut() {
    cum[0] = 0;
    for (int i = 0; i < alpha; i++) cum[i + 1] = cum[i] + freqs[i];
    for (int s = 0; s < alpha; s++)
      for (i32 i = cum[s]; i < cum[s + 1]; i++) r2s[i] = u16(s);
  }
  void reset() {
    seen = 0;
    exp = 8;
    i32 scale = kProbScale / alpha;
    for (int i = 0; i < alpha; i++) freqs[i] = scale;
    freqs[0] += kProbScale - scale * alpha;
    rebuild_lut();
    std::fill(freqs.begin(), freqs.end(), 0);
  }
  inline void update(int sym) {
    freqs[sym] += kProbBits;
    if (++seen > exp) {
      i32 total = 0, lg = 0;
      for (int i = 0; i < alpha; i++) total += freqs[i];
      while (((total >> lg) + alpha) > kProbScale) lg++;
      total = 0;
      for (int i = 0; i < alpha; i++) total += freqs[i] = (freqs[i] >> lg) + 1;
      // model.cpp:183 is UNSIGNED arithmetic (ProbScale is unsigned int)
      // and the product never exceeds 2^32: exact, always >= 1
      for (int i = 0; i < alpha; i++)
        freqs[i] = i32((u32(kProbScale) * u32(freqs[i])) / u32(total));
      i32 t2 = 0;
      for (int i = 0; i < alpha; i++) t2 += freqs[i];
      freqs[0] += kProbScale - t2;
      rebuild_lut();
      std::fill(freqs.begin(), freqs.end(), 0);
      seen = 0;
      exp = (exp < kUpdateRate) ? exp << 1 : kUpdateRate;
    }
  }
};

// ---- SRC rank transform (rank.cpp semantics) ----
static void sorted_map(const i32* freq, u8* out_map, int* out_n) {
  i32 copy[256];
  memcpy(copy, freq, sizeof(copy));
  int n = 0;
  for (int j = 0; j < 256; j++) {
    i32 mx = 0;
    int bsym = 0;
    for (int i = 0; i < 256; i++)
      if (copy[i] > mx) { bsym = i; mx = copy[i]; }
    if (mx == 0) break;
    out_map[n++] = u8(bsym);
    copy[bsym] = 0;
  }
  *out_n = n;
}

void rank_encode(u8* t, i32* freq, i32 len) {
  memset(freq, 0, 256 * sizeof(i32));
  u8 r2s[256];  // MTF list in rank order, seeded by first occurrence
  memset(r2s, 0, sizeof(r2s));
  int unique = 0;
  for (i32 i = 0; i < len; i++) {
    u8 sym = t[i];
    if (freq[sym]++ == 0) r2s[unique++] = sym;
  }
  u8 smap[256];
  int nsyms;
  sorted_map(freq, smap, &nsyms);
  i32 bucket[256];
  for (int i = 0, pos = 0; i < nsyms; i++) {
    bucket[smap[i]] = pos;
    pos += freq[smap[i]];
  }
  std::vector<u8> out(len);
  // MTF on the dense rank->symbol list.  BWT output averages rank ~15, so
  // the textbook two-table shift is O(rank) DEPENDENT scalar stores — the
  // single hottest loop of the whole encoder.  One 64-wide compare finds
  // the rank and one masked store does the shift whenever rank < 64 (the
  // overwhelming majority); entries at or above `unique` are never the
  // first match because every scanned symbol already occurs below it.
#if defined(__AVX512BW__)
  for (i32 i = 0; i < len; i++) {
    u8 sym = t[i];
    __m512i v = _mm512_loadu_si512(r2s);
    uint64_t m = _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8(char(sym)));
    u8 rank;
    if (__builtin_expect(m != 0, 1)) {
      rank = u8(_tzcnt_u64(m));
      _mm512_mask_storeu_epi8(r2s + 1, _bzhi_u64(~0ull, rank), v);
      r2s[0] = sym;
    } else {
      int r = 64;
      while (r2s[r] != sym) r++;
      rank = u8(r);
      memmove(r2s + 1, r2s, size_t(r));
      r2s[0] = sym;
    }
    out[bucket[sym]++] = rank;
  }
#else
  for (i32 i = 0; i < len; i++) {
    u8 sym = t[i];
    int r = 0;
    while (r2s[r] != sym) r++;
    out[bucket[sym]++] = u8(r);
    if (r > 0) {
      memmove(r2s + 1, r2s, size_t(r));
      r2s[0] = sym;
    }
  }
#endif
  memcpy(t, out.data(), len);
}

bool rank_decode(u8* ranks, const i32* freq, i32 len) {
  i64 total = 0;
  for (int i = 0; i < 256; i++) total += freq[i];
  if (total != len) return false;
  int unique = 0;
  for (int i = 0; i < 256; i++) unique += (freq[i] > 0);
  u8 smap[256];
  int nsyms;
  sorted_map(freq, smap, &nsyms);
  i32 bucket[256], bucket_end[256];
  u8 r2s[256];
  for (int i = 0, pos = 0; i < nsyms; i++) {
    u8 sym = smap[i];
    r2s[ranks[pos]] = sym;
    bucket[sym] = pos + 1;
    pos += freq[sym];
    bucket_end[sym] = pos;
  }
  std::vector<u8> out(len);
  u8 sym = r2s[0];
  for (i32 i = 0; i < len; i++) {
    out[i] = sym;
    if (bucket[sym] < bucket_end[sym]) {
      u8 rank = ranks[bucket[sym]++];
      if (rank > 0) {
        // shift ranks [1, rank] down one: a masked 64-wide store beats the
        // memmove call's size dispatch at the ~15-byte average
#if defined(__AVX512BW__)
        if (__builtin_expect(rank <= 64, 1)) {
          __m512i v = _mm512_loadu_si512(r2s + 1);
          _mm512_mask_storeu_epi8(r2s, _bzhi_u64(~0ull, rank), v);
        } else {
          memmove(r2s, r2s + 1, rank);
        }
#else
        memmove(r2s, r2s + 1, rank);
#endif
        r2s[rank] = sym;
        sym = r2s[0];
      }
    } else if (unique > 0) {
      unique--;
      memmove(r2s, r2s + 1, unique > 0 ? unique : 1);
      sym = r2s[0];
    } else {
      unique--;  // reference post-decrements past zero; harmless
    }
  }
  memcpy(ranks, out.data(), len);
  return true;
}

// ---- RLE0 (rle.cpp semantics) ----
i32 rle0_encode(const u8* in, u16* out, i32 len) {
  i32 op = 0;
  for (i32 i = 0; i < len;) {
    if (in[i] == 0) {
      i32 run = 1;
      while ((i + run) < len && in[i + run] == 0) run++;
      i += run;
      i32 L = run + 1;
      int msb = 0;
      for (i32 v = L; v; v >>= 1) msb++;
      for (int k = msb - 2; k >= 0; k--) out[op++] = u16((L >> k) & 1);
    } else {
      out[op++] = u16(in[i++] + 1);
    }
  }
  return op;
}

bool rle0_decode(const u16* in, i32 len, u8* out, i32 real_len) {
  i32 op = 0;
  for (i32 i = 0; i < len;) {
    if (in[i] > 1) {
      if (op >= real_len) return false;
      out[op++] = u8(in[i++] - 1);
    } else {
      i64 rle = 1;
      while (i < len && in[i] <= 1) {
        rle = (rle << 1) | in[i++];
        // a legal run cannot exceed the output size; bail before the
        // accumulator can overflow i64 on crafted bit streams
        if (rle > i64(real_len) + 2) return false;
      }
      rle -= 1;
      if (op + rle > real_len) return false;
      while (rle--) out[op++] = 0;
    }
  }
  return op == real_len;
}

// ---- rANS primitives (rans_byte.hpp semantics) ----
static inline void renc_put(u32* r, u8** pp, u32 start, u32 freq, u32 bits) {
  u32 x = *r;
  u32 x_max = ((kRansL >> bits) << 8) * freq;
  // Renorm emits 0..2 bytes (x < 2^31 and x_max >= 2^15 bound the shift):
  // write both candidate bytes unconditionally, then bump the pointer by
  // the real count — the data-dependent while loop mispredicts ~per op.
  u32 nb = u32(x >= x_max) + u32((x >> 8) >= x_max);
  u8* p = *pp;
  p[-1] = u8(x);
  p[-2] = u8(x >> 8);
  *pp = p - nb;
  x >>= 8 * nb;
  // Exact u32/u16 quotient via f64: operands are exact, the true quotient's
  // fractional part is 0 or >= 2^-16, and the rounding error at <= 2^31 is
  // <= 2^-22 — so truncation can't cross an integer.  f64 divide has ~half
  // the latency of the integer divider on the critical 4-state chain.
  u32 q = u32(double(x) / double(freq));
  *r = (q << bits) + (x - q * freq) + start;
}

static inline void renc_flush(u32 r, u8** pp) {
  u8* p = *pp - 4;
  p[0] = u8(r);
  p[1] = u8(r >> 8);
  p[2] = u8(r >> 16);
  p[3] = u8(r >> 24);
  *pp = p;
}

static inline u32 rdec_init(const u8** pp, const u8* end) {
  const u8* p = *pp;
  if (p + 4 > end) { *pp = end; return 0; }  // corrupt: fails state check
  u32 x = u32(p[0]) | (u32(p[1]) << 8) | (u32(p[2]) << 16) | (u32(p[3]) << 24);
  *pp = p + 4;
  return x;
}

static inline u32 rdec_advance(u32 x, const u8** pp, const u8* end, u32 start,
                               u32 freq, u32 bits) {
  u32 mask = (1u << bits) - 1;
  x = freq * (x >> bits) + (x & mask) - start;
  const u8* p = *pp;
  if (__builtin_expect(end - p >= 2, 1)) {
    // refill is 0..2 bytes (kRansL = 2^23, byte renorm): branchless count +
    // one 16-bit big-endian window replaces the mispredicting while loop
    u32 n = u32(x < kRansL) + u32(x < (kRansL >> 8));
    u32 w = (u32(p[0]) << 8) | p[1];
    x = (x << (8 * n)) | (w >> (16 - 8 * n));
    *pp = p + n;
    // valid streams refill <= 2 bytes (encode emits <= 2); only corrupt
    // data can still be low here — keep the byte loop so corrupt-stream
    // behavior is identical to the original
    if (__builtin_expect(x < kRansL, 0))
      while (x < kRansL && *pp < end) x = (x << 8) | *(*pp)++;
  } else {
    // corrupt/short streams must not renormalize past the chunk payload
    while (x < kRansL && *pp < end) x = (x << 8) | *(*pp)++;
  }
  return x;
}

// ---- chunk models bundle ----
struct Models {
  Adaptive expm;
  Adaptive mant_a[kSwitch];
  Quasi mant_q[kMaxModels - kSwitch];
  Models() {
    expm.init(kMaxModels);
    for (int c = 0; c < kSwitch; c++)
      mant_a[c].init(kSym.exponent[c + 1] - kSym.exponent[c]);
    for (int c = 0; c < kMaxModels - kSwitch; c++)
      mant_q[c].init(kSym.exponent[c + kSwitch + 1] - kSym.exponent[c + kSwitch]);
  }
  void reset() {
    expm.reset();
    for (auto& m : mant_a) m.reset();
    for (auto& m : mant_q) m.reset();
  }
};

// Forward model pass over one symbol chain; fills (low,freq) op pairs.
// Returns op count, or -1 on model failure (the reference aborts there).
static i64 model_chain(const u16* syms, i32 cnt, Models& M, u32* lows,
                       u32* fqs) {
  M.reset();
  i64 sp = 0;
  for (i32 i = 0; i < cnt; i++) {
    int sym = syms[i];
    int e = kSym.log2c[sym];
    int m = kSym.mant[sym];
    lows[sp] = u32(M.expm.cum[e]);
    fqs[sp] = u32(M.expm.cum[e + 1] - M.expm.cum[e]);
    M.expm.update(e);
    if (e < kSwitch) {
      Adaptive& a = M.mant_a[e];
      lows[sp + 1] = u32(a.cum[m]);
      i32 f = a.cum[m + 1] - a.cum[m];
      if (f <= 0) return -1;
      fqs[sp + 1] = u32(f);
      a.update(m);
    } else {
      Quasi& q = M.mant_q[e - kSwitch];
      lows[sp + 1] = u32(q.cum[m]);
      i32 f = q.cum[m + 1] - q.cum[m];
      if (f <= 0) return -1;
      fqs[sp + 1] = u32(f);
      q.update(m);
    }
    sp += 2;
  }
  return sp;
}

// Reverse 4-state rANS pass; writes backward from tmp_end, returns size and
// sets *out_ptr to the payload start.
static i64 chain_encode(const u32* lows, const u32* fqs, i64 sp, u8* tmp_end,
                        u8** out_ptr) {
  u32 R[4] = {kRansL, kRansL, kRansL, kRansL};
  u8* ptr = tmp_end;
  for (i64 i = sp; i > 0; i--) {
    u32 x = R[3];
    renc_put(&x, &ptr, lows[i - 1], fqs[i - 1], kProbBits);
    R[3] = R[2];
    R[2] = R[1];
    R[1] = R[0];
    R[0] = x;
  }
  renc_flush(R[3], &ptr);
  renc_flush(R[2], &ptr);
  renc_flush(R[1], &ptr);
  renc_flush(R[0], &ptr);
  *out_ptr = ptr;
  return tmp_end - ptr;
}

// Encode one chunk; returns bytes written to out (header + payload), -1 on
// model failure, -2 if out of space.  lanes >= 2 selects the JTX
// wide-interleave layout: symbols dealt round-robin over `lanes`
// independent model+rANS chains sharing one rank/freq header, payload
// prefixed by per-lane length varints (see stages/ans.py).
static i64 encode_chunk(const u8* in, i32 len, u8* out, i64 out_cap, Models& M,
                        std::vector<u16>& rlebuf, std::vector<u32>& lows,
                        std::vector<u32>& fqs, std::vector<u8>& tmp,
                        i32 lanes) {
  std::vector<u8> ranked(in, in + len);
  i32 freq[256];
  rank_encode(ranked.data(), freq, len);
  i32 rlen = rle0_encode(ranked.data(), rlebuf.data(), len);

  u8 lane_table[64 * 1024];
  i64 lt_pos = 0;
  u8* payload = nullptr;
  i64 csize = 0;
  if (lanes >= 2) {
    // per-lane chains, packed forward into tmp via per-lane scratch tails
    std::vector<u16> lane_syms(size_t(rlen + lanes) / size_t(lanes) + 1);
    std::vector<u8> scratch(lane_syms.size() * 8 + 64);
    u8* w = tmp.data();
    for (i32 l = 0; l < lanes; l++) {
      i32 cnt = 0;
      for (i32 i = l; i < rlen; i += lanes) lane_syms[cnt++] = rlebuf[i];
      i64 sp = model_chain(lane_syms.data(), cnt, M, lows.data(), fqs.data());
      if (sp < 0) return -1;
      u8* ptr;
      i64 sz = chain_encode(lows.data(), fqs.data(), sp,
                            scratch.data() + scratch.size(), &ptr);
      lt_pos += var_encode(i32(sz), lane_table + lt_pos);
      memcpy(w, ptr, sz);
      w += sz;
    }
    payload = tmp.data();
    csize = (w - tmp.data()) + lt_pos;
  } else {
    i64 sp = model_chain(rlebuf.data(), rlen, M, lows.data(), fqs.data());
    if (sp < 0) return -1;
    csize = chain_encode(lows.data(), fqs.data(), sp,
                         tmp.data() + tmp.size(), &payload);
  }

  u8 header[256 * 5 + 16];
  i64 pos = 0;
  for (int i = 0; i < 256; i++) pos += var_encode(freq[i], header + pos);
  pos += var_encode(len, header + pos);
  pos += var_encode(i32(csize), header + pos);
  pos += var_encode(rlen, header + pos);
  if (pos + lt_pos + csize > out_cap) return -2;
  memcpy(out, header, pos);
  if (lanes >= 2) {
    memcpy(out + pos, lane_table, lt_pos);
    memcpy(out + pos + lt_pos, payload, csize - lt_pos);
  } else {
    memcpy(out + pos, payload, csize);
  }
  return pos + csize;
}

// Decode one chunk payload (after its header) into out.
static bool decode_chain(const u8* in, const u8* end, u16* syms, i32 cnt,
                         Models& M) {
  M.reset();
  const u8* ptr = in;
  u32 R[4];
  for (int i = 0; i < 4; i++) R[i] = rdec_init(&ptr, end);
  for (i32 s = 0; s < cnt; s++) {
    u32 x = R[0];
    u32 rng = x & (kProbScale - 1);
    int e = M.expm.range_to_sym(rng);
    x = rdec_advance(x, &ptr, end, u32(M.expm.cum[e]),
                     u32(M.expm.cum[e + 1] - M.expm.cum[e]), kProbBits);
    M.expm.update(e);
    R[0] = R[1]; R[1] = R[2]; R[2] = R[3]; R[3] = x;

    x = R[0];
    rng = x & (kProbScale - 1);
    int m;
    if (e < kSwitch) {
      Adaptive& a = M.mant_a[e];
      m = a.range_to_sym(rng);
      x = rdec_advance(x, &ptr, end, u32(a.cum[m]),
                       u32(a.cum[m + 1] - a.cum[m]), kProbBits);
      a.update(m);
    } else {
      Quasi& q = M.mant_q[e - kSwitch];
      m = q.r2s[rng];
      x = rdec_advance(x, &ptr, end, u32(q.cum[m]),
                       u32(q.cum[m + 1] - q.cum[m]), kProbBits);
      q.update(m);
    }
    R[0] = R[1]; R[1] = R[2]; R[2] = R[3]; R[3] = x;
    syms[s] = u16(kSym.exponent[e] + m);
  }
  return R[0] == kRansL && R[1] == kRansL && R[2] == kRansL && R[3] == kRansL;
}

// Decode one chunk payload (after its header) into out.
static bool decode_chunk(const u8* in, u8* out, i32 olen, i32 rlen,
                         const i32* freq, Models& M, std::vector<u16>& rlebuf,
                         i32 lanes, i32 clen) {
  const u8* chunk_end = in + clen;
  if (lanes >= 2) {
    const u8* p = in;
    std::vector<i32> lane_clens(lanes);
    i64 table = 0, total = 0;
    for (i32 l = 0; l < lanes; l++) {
      int adv = var_decode_n(p, chunk_end - p, &lane_clens[l]);
      if (adv < 0 || lane_clens[l] < 16 || lane_clens[l] > clen) return false;
      p += adv;
      table += adv;
      total += lane_clens[l];
    }
    if (table + total != clen) return false;
    std::vector<u16> lane_syms((rlen + lanes - 1) / lanes + 1);
    for (i32 l = 0; l < lanes; l++) {
      i32 cnt = (rlen - l + lanes - 1) / lanes;
      if (p + lane_clens[l] > chunk_end) return false;
      if (!decode_chain(p, p + lane_clens[l], lane_syms.data(), cnt, M))
        return false;
      for (i32 i = 0; i < cnt; i++) rlebuf[size_t(i) * lanes + l] = lane_syms[i];
      p += lane_clens[l];
    }
  } else {
    if (!decode_chain(in, chunk_end, rlebuf.data(), rlen, M)) return false;
  }
  if (!rle0_decode(rlebuf.data(), rlen, out, olen)) return false;
  return rank_decode(out, freq, olen);
}

}  // namespace jpt

extern "C" {

// chunk: model-reset interval; <= kAnsChunk keeps streams decodable by the
// reference decoder (it honors per-chunk olen from the header), smaller
// values buy parallel-decode granularity at a small ratio cost.
int64_t jam_ans_encode_c(const uint8_t* in, int64_t n, uint8_t* out,
                         int64_t cap, int32_t chunk, int32_t lanes) {
  using namespace jpt;
  if (chunk <= 0 || chunk > kAnsChunk) chunk = kAnsChunk;
  if (lanes < 2) lanes = 0;
  if (lanes > 4096) lanes = 4096;
  Models M;
  std::vector<u16> rlebuf(kAnsChunk);
  std::vector<u32> lows(size_t(kAnsChunk) * 2), fqs(size_t(kAnsChunk) * 2);
  // 4 bytes/encode-op worst case + per-lane flushes
  std::vector<u8> tmp(size_t(kAnsChunk) * 4 + 64 + size_t(lanes) * 16);
  i64 ip = 0, op = 0;
  while (ip < n) {
    i32 len = i32(((ip + chunk) < n) ? chunk : (n - ip));
    i64 w = encode_chunk(in + ip, len, out + op, cap - op, M, rlebuf, lows,
                         fqs, tmp, lanes);
    if (w < 0) return w;
    op += w;
    ip += len;
  }
  return op;
}

int64_t jam_ans_encode(const uint8_t* in, int64_t n, uint8_t* out,
                       int64_t cap) {
  return jam_ans_encode_c(in, n, out, cap, 0, 0);
}

int64_t jam_ans_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap,
                       int32_t threads, int32_t lanes) {
  using namespace jpt;
  // scan headers first to slice chunks for parallel decode (ans.cpp:243-265)
  struct Chunk { i64 in_off, out_off; i32 olen, clen, rlen; i32 freq[256]; };
  std::vector<Chunk> chunks;
  i64 ip = 0, op = 0;
  while (ip < n) {
    Chunk c;
    int adv;
    for (int i = 0; i < 256; i++) {
      if ((adv = var_decode_n(in + ip, n - ip, &c.freq[i])) < 0) return -1;
      ip += adv;
    }
    if ((adv = var_decode_n(in + ip, n - ip, &c.olen)) < 0) return -1;
    ip += adv;
    if ((adv = var_decode_n(in + ip, n - ip, &c.clen)) < 0) return -1;
    ip += adv;
    if ((adv = var_decode_n(in + ip, n - ip, &c.rlen)) < 0) return -1;
    ip += adv;
    if (c.olen < 0 || c.olen > kAnsChunk || c.rlen < 0 || c.rlen > kAnsChunk)
      return -1;
    // every chunk carries at least one 4-state flush (16 bytes); negative
    // clen would rewind the scan into an infinite loop
    if (c.clen < 16 || c.clen > n - ip) return -1;
    c.in_off = ip;
    c.out_off = op;
    if (op + c.olen > cap) return -1;
    chunks.push_back(c);
    ip += c.clen;
    op += c.olen;
  }
  bool ok = true;
#pragma omp parallel num_threads(threads > 0 ? threads : omp_get_max_threads())
  {
    Models M;
    std::vector<u16> rlebuf(kAnsChunk);
#pragma omp for schedule(dynamic)
    for (i64 k = 0; k < i64(chunks.size()); k++) {
      const Chunk& c = chunks[k];
      if (!decode_chunk(in + c.in_off, out + c.out_off, c.olen, c.rlen, c.freq,
                        M, rlebuf, lanes >= 2 ? lanes : 0, c.clen)) {
#pragma omp atomic write
        ok = false;
      }
    }
  }
  return ok ? op : -1;
}

uint32_t jam_checksum(const uint8_t* p, int64_t n) {
  return jpt::block_checksum(p, n);
}
}
