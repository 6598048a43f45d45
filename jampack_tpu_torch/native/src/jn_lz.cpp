// LZ77 stage: anti-context parsing with three match finders (m0 fast
// dedupe, m1 lazy hash-chain, m2 suffix-array neighborhood) plus the cyclic
// hashed history model (CHHM) used to keep only positionally-structured
// tokens for the BWT's benefit.  Token stream layout is format-exact
// (lz77.cpp:53-102); match-finder decisions replicate lz77.cpp:126-625 with
// the out-of-tail context reads defined as zero-padding.
#include "jn_common.hpp"

namespace jpt {
void suffix_array(const u8* t, i32* sa, i32 n);
namespace lz {

constexpr int kMinMatch = 4;
constexpr int kDupeMatch = 256;
constexpr int kTokenBuf = 1 << 16;
constexpr int kHashBits = 22;
constexpr i32 kHashSize = 1 << kHashBits;

static inline u32 load32(const u8* p) {
  return (u32(p[0]) << 24) | (u32(p[1]) << 16) | (u32(p[2]) << 8) | u32(p[3]);
}
static inline u32 hash32(const u8* p) {
  return (load32(p) * kGoldenPrime) >> (32 - kHashBits);
}
static inline u32 hash_val(u32 v) {
  return (v * kGoldenPrime) >> (32 - kHashBits);
}

static i64 write_token(u8* out, i32 match, i32 literal, i32 offset) {
  i64 pos = 0;
  match -= kMinMatch;
  i32 mfield = match < 31 ? match : 31;
  i32 lfield = literal < 7 ? literal : 7;
  out[pos++] = u8((mfield << 3) | lfield);
  pos += var_encode(offset, out + pos);
  if (mfield == 31) pos += var_encode(match - 31, out + pos);
  if (lfield == 7) pos += var_encode(literal - 7, out + pos);
  return pos;
}

// Bounded token parse for the (untrusted) decode path: returns bytes
// consumed or -1 on truncation/malformed varints/negative fields.
static i64 read_token(const u8* in, i64 rem, i32* match, i32* literal,
                      i32* offset) {
  i64 pos = 0;
  if (rem < 1) return -1;
  u8 token = in[pos++];
  int adv = var_decode_n(in + pos, rem - pos, offset);
  if (adv < 0) return -1;
  pos += adv;
  *match = token >> 3;
  if (*match == 31) {
    i32 ext;
    if ((adv = var_decode_n(in + pos, rem - pos, &ext)) < 0) return -1;
    pos += adv;
    *match = ext + 31;
  }
  *match += kMinMatch;
  *literal = token & 7;
  if (*literal == 7) {
    i32 ext;
    if ((adv = var_decode_n(in + pos, rem - pos, &ext)) < 0) return -1;
    pos += adv;
    *literal = ext + 7;
  }
  // oversized varints wrap i32 negative and would defeat the bounds math
  if (*match < 0 || *literal < 0 || *offset < 0) return -1;
  return pos;
}

static float compressible(i32 match, i32 literal, i32 offset) {
  int cost = 1;
  cost += ((match - kMinMatch) < 31) ? 0 : var_size(match - kMinMatch - 31);
  cost += (literal < 7) ? 0 : var_size(literal - 7);
  cost += var_size(offset);
  if (match < kMinMatch || match <= cost) return 0;
  return float(match) / float(cost);
}

// ---- CHHM (cyclichhm.cpp semantics) ----
struct Chhm {
  static constexpr int kBits = 16;
  static constexpr i32 kSize = 1 << kBits;
  std::vector<u16> ring;
  std::vector<u32> hist, mod;
  u32 ring_size, pos = 0, prev = 0;
  u32 avg = 0, uniques = 0, width = 1;

  explicit Chhm(u32 size)
      : ring(size, 0), hist(kSize, 0), mod(kSize, 0), ring_size(size) {}

  static inline u32 hashv(u32 v) { return (v * kGoldenPrime) >> (32 - kBits); }

  void update(i32 value) {
    u32 h = hashv(u32(value));
    u32 old = ring[pos % ring_size];
    ring[pos % ring_size] = u16(h);
    hist[h]++;
    if (pos >= ring_size) hist[old]--;
    // cyclichhm.cpp:63 computes PreviousValue ^ value, but PreviousValue is
    // never assigned after construction — the "XOR delta" is the raw value.
    // Replicated as-is: the parsing decisions ARE the behavior contract.
    mod[(prev ^ u32(value)) % kSize]++;
    pos++;
  }

  void build() {
    avg = 0;
    u32 zeros = 0;
    u64 sum = 0;
    for (i32 j = 0; j < kSize; j++) {
      sum += mod[j];
      if (mod[j] == 0) zeros++;
    }
    if (u32(kSize) > zeros) avg = u32(sum / (kSize - zeros));
    uniques = kSize - zeros;
    u32 mx = mod[0];
    i32 bsym = 0;
    for (i32 i = 1; i < kSize; i++)
      if (mod[i] > mx) { bsym = i; mx = mod[i]; }
    width = bsym == 0 ? 1 : u32(bsym);
  }

  bool peaks(i32 value) const {
    i32 k = value;
    i32 reduce = (width <= 1) ? 2 : i32(width);
    while (k) {
      u32 div = (avg == 0) ? 1 : avg;
      if (mod[u32(k) % kSize] > (uniques / (div * div))) return true;
      k /= reduce;
    }
    return false;
  }

  void clean() {
    avg = 0;
    std::fill(mod.begin(), mod.end(), 0);
    width = 1;
  }

  typedef unsigned long long u64;
};

struct Token {
  i32 offset, match, position;
};

// Shared token-chunk emitter used by m1/m2: model offsets/lengths with the
// CHHM, then keep only structured or very long matches (lz77.cpp:398-425).
static void emit_tokens(const u8* in, const Token* toks, i32 ntok,
                        Chhm& chhm_off, Chhm& chhm_match, u8* out, i64* out_pos,
                        i64* bbpos) {
  for (i32 i = 0; i < ntok; i++) {
    chhm_off.update(toks[i].offset);
    chhm_match.update(toks[i].match);
  }
  chhm_off.build();
  chhm_match.build();
  for (i32 i = 0; i < ntok; i++) {
    i32 match = toks[i].match, offset = toks[i].offset;
    i64 position = toks[i].position;
    // both peak tests consult the OFFSET model — so does the reference
    // (lz77.cpp:421 "ChhmOffset->FindPeaks(match)"); its ChhmMatch is
    // built but never read.  Replicated: parsing decisions are format-
    // visible behavior.
    if (chhm_off.peaks(offset) || chhm_off.peaks(match) || match > kDupeMatch) {
      i32 literal = i32(position - *bbpos);
      *out_pos += write_token(out + *out_pos, match, literal, offset);
      memcpy(out + *out_pos, in + position - literal, literal);
      *out_pos += literal;
      *bbpos = position + match;
    }
  }
  chhm_off.clean();
  chhm_match.clean();
}

// m0: fast dedupe (lz77.cpp:544-625); `padded` has >= n + kDupeMatch + 8
// bytes with the tail zeroed.
static i64 encode_dedupe(const u8* in, i64 n, u8* out) {
  // kPF: the hash table is 16 MB (cache-miss per byte), but the rolling
  // context is a pure function of stream position — so a second context
  // running kPF bytes ahead yields the EXACT future hash to prefetch.
  constexpr i64 kPF = 16;
  std::vector<u8> padded(size_t(n) + kDupeMatch + 8 + kPF, 0);
  memcpy(padded.data(), in, n);
  const u8* b = padded.data();
  std::vector<i32> table(kHashSize, 0);

  const int shift = (kDupeMatch > 32) ? 1 : 32 / kDupeMatch;
  u32 cxt = 0, cxt_pf = 0;
  for (i64 i = 0; i < kPF; i++) cxt_pf = (cxt_pf << shift) ^ b[i + kDupeMatch];
  i64 pos = 0, lit = 0, out_pos = 0;
  while (pos < n) {
    i64 back = 0, len = 0, off = 0;
    bool found = false;
    u32 h = hash_val(cxt);
    if (table[h] > 0) {
      i64 cpos = pos, ppos = table[h];
      i64 mb = 0, mf = 0;
      while (b[ppos - mb - 1] == b[cpos - mb - 1] && (ppos - mb - 1) > 0 &&
             mb < lit)
        mb++;
      while (b[ppos + mf] == b[cpos + mf] && (cpos + mf + kMinMatch) < n) mf++;
      if ((mf + mb) >= kDupeMatch) {
        found = true;
        len = mf;
        back = mb;
        off = cpos - ppos;
      }
    }
    if (found) {
      len += back;
      lit -= back;
      pos -= back;
      out_pos += write_token(out + out_pos, i32(len), i32(lit), i32(off));
      memcpy(out + out_pos, b + pos - lit, lit);
      out_pos += lit;
      for (i64 i = 0; i < len; i++) {
        h = hash_val(cxt);
        // the reference stores the fixed match start (not pos + i) for
        // every rolled context here (lz77.cpp:603-607); replicated
        table[h] = i32(pos);
        cxt = (cxt << shift) ^ b[pos + kDupeMatch + i];
        cxt_pf = (cxt_pf << shift) ^ b[pos + kPF + kDupeMatch + i];
        __builtin_prefetch(&table[hash_val(cxt_pf)], 1);
      }
      pos += len;
      lit = 0;
    }
    h = hash_val(cxt);
    table[h] = i32(pos);
    cxt = (cxt << shift) ^ b[pos + kDupeMatch];
    cxt_pf = (cxt_pf << shift) ^ b[pos + kPF + kDupeMatch];
    __builtin_prefetch(&table[hash_val(cxt_pf)], 1);
    pos++;
    lit++;
  }
  out_pos += write_token(out + out_pos, kMinMatch, kMinMatch, 0);
  memcpy(out + out_pos, b + pos - lit, lit);
  return out_pos + lit;
}

// m1: lazy hash-chain with CHHM token filtering (lz77.cpp:278-441)
static i64 encode_hashchain(const u8* in, i64 n, u8* out) {
  std::vector<u8> padded(size_t(n) + kMinMatch + 8, 0);
  memcpy(padded.data(), in, n);
  const u8* b = padded.data();

  Chhm chhm_off(kTokenBuf), chhm_match(kTokenBuf);
  std::vector<Token> toks(kTokenBuf);
  i64 window = n > 0 ? n : 1;
  std::vector<i32> chain(window, 0), table(kHashSize, 0);

  i64 pos = 0, lit = 0, bbpos = 0, out_pos = 0;
  i32 ntok = 0;
  while (pos < n) {
    while (pos < n && ntok < kTokenBuf) {
      i64 back = 0, forward = 0, len = 0, off = 0;
      float lowest = 1.0f;
      for (int k = 0; k < kMinMatch; k++) {
        // the reference hashes at `pos` for every lazy offset k
        // (lz77.cpp:321), so all k iterations walk the same chain while
        // comparing at pos+k.  Replicated for parse parity.
        u32 h = hash32(b + pos);
        if (table[h] > 0 && (pos + k) < n) {
          i64 cpos = pos + k;
          i64 ppos = table[h];
          i32 chain_len = 32, miss = 0;
          i64 winstart = pos - window > 0 ? pos - window : 0;
          while (ppos > winstart) {
            i64 distance = cpos - ppos;
            i64 mf = 0, mb = 0;
            if (load32(b + ppos) == load32(b + cpos)) {
              while (b[ppos - mb - 1] == b[cpos - mb - 1] &&
                     (ppos - mb - 1) > 0 && mb < lit)
                mb++;
              while (b[ppos + mf] == b[cpos + mf] && (cpos + mf + kMinMatch) < n)
                mf++;
              float ratio =
                  compressible(i32(mf + mb), i32(lit + (mb - k)), i32(distance));
              if (ratio > lowest || (mf + mb) >= kDupeMatch) {
                lowest = ratio;
                len = mf;
                back = mb;
                off = distance;
                forward = k;
              }
              if (mf > kDupeMatch) break;
              miss = 0;
            } else {
              miss++;
            }
            if (!--chain_len || !(chain_len >> miss)) break;
            ppos = chain[ppos % window];
          }
        }
      }
      if (lowest > 1.0f || (len + back) > kDupeMatch) {
        len += back;
        pos -= back - forward;
        toks[ntok].match = i32(len);
        toks[ntok].offset = i32(off);
        toks[ntok].position = i32(pos);
        ntok++;
        for (i64 i = 0; i < len; i++) {
          u32 h = hash32(b + pos + i);
          chain[(pos + i) % window] = table[h];
          table[h] = i32(pos + i);
        }
        pos += len;
        lit = 0;
      }
      u32 h = hash32(b + pos);
      chain[pos % window] = table[h];
      table[h] = i32(pos);
      pos++;
      lit++;
    }
    emit_tokens(b, toks.data(), ntok, chhm_off, chhm_match, out, &out_pos,
                &bbpos);
    ntok = 0;
  }
  i64 remainder = pos - bbpos;
  out_pos += write_token(out + out_pos, kMinMatch, kMinMatch, 0);
  memcpy(out + out_pos, b + n - remainder, remainder);
  return out_pos + remainder;
}

// m2: suffix-array neighborhood anti-context search (lz77.cpp:134-274)
static i64 encode_suffixarray(const u8* in, i64 n, u8* out) {
  std::vector<u8> padded(size_t(n) + kMinMatch + 8, 0);
  memcpy(padded.data(), in, n);
  const u8* b = padded.data();

  std::vector<i32> sa(n > 0 ? n : 1), isa(n > 0 ? n : 1);
  suffix_array(in, sa.data(), i32(n));
  for (i64 i = 0; i < n; i++) isa[sa[i]] = i32(i);

  Chhm chhm_off(kTokenBuf), chhm_match(kTokenBuf);
  std::vector<Token> toks(kTokenBuf);

  i64 pos = 0, lit = 0, bbpos = 0, out_pos = 0;
  i32 ntok = 0;
  while (pos < n) {
    while (pos < n && ntok < kTokenBuf) {
      i64 forward = 0, len = 0, off = 0;
      float lowest = 1.0f;
      for (int k = 0; k < kMinMatch; k++) {
        i64 cpos = pos + k;
        if (cpos >= n) break;
        i64 ptr = isa[cpos];
        const i64 bucket = 1 << 12;
        i64 itr = ptr - bucket > 0 ? ptr - bucket : 0;
        i64 limit = ptr + bucket < n ? ptr + bucket : n;
        for (; itr <= limit && itr < n; itr++) {
          i64 ppos = sa[itr];
          if (ppos < cpos) {
            i64 match = 0;
            while (b[ppos + match] == b[cpos + match] &&
                   (cpos + match + kMinMatch) < n)
              match++;
            i64 curoff = cpos - ppos;
            float ratio = compressible(i32(match), i32(lit - k), i32(curoff));
            if (ratio > lowest || match >= kDupeMatch) {
              lowest = ratio;
              len = match;
              off = curoff;
              forward = k;
            }
          }
        }
      }
      if (lowest > 1.0f || len > kDupeMatch) {
        pos += forward;
        toks[ntok].match = i32(len);
        toks[ntok].offset = i32(off);
        toks[ntok].position = i32(pos);
        ntok++;
        pos += len;
        lit = 0;
      }
      pos++;
      lit++;
    }
    emit_tokens(b, toks.data(), ntok, chhm_off, chhm_match, out, &out_pos,
                &bbpos);
    ntok = 0;
  }
  i64 remainder = pos - bbpos;
  out_pos += write_token(out + out_pos, kMinMatch, kMinMatch, 0);
  memcpy(out + out_pos, b + n - remainder, remainder);
  return out_pos + remainder;
}

static i64 decode(const u8* in, i64 n, u8* out, i64 cap) {
  i64 pos = 0, op = 0;
  while (pos < n) {
    i32 match, literal, offset;
    i64 adv = read_token(in + pos, n - pos, &match, &literal, &offset);
    if (adv < 0) return -1;
    pos += adv;
    if (offset) {
      if (pos + literal > n || op + literal + match > cap) return -1;
      memcpy(out + op, in + pos, literal);
      op += literal;
      pos += literal;
      if (pos >= n || op - offset < 0) return -1;
      const u8* src = out + op - offset;
      u8* dst = out + op;
      for (i32 k = 0; k < match; k++) dst[k] = src[k];
      op += match;
    } else {
      i64 remainder = n - pos;
      if (op + remainder > cap) return -1;
      memcpy(out + op, in + pos, remainder);
      op += remainder;
      break;
    }
  }
  return op;
}

}  // namespace lz
}  // namespace jpt

extern "C" {

int64_t jam_lz_encode(const uint8_t* in, int64_t n, uint8_t* out,
                      int32_t mode) {
  using namespace jpt::lz;
  if (mode <= 0) return encode_dedupe(in, n, out);
  if (mode == 1) return encode_hashchain(in, n, out);
  return encode_suffixarray(in, n, out);
}

int64_t jam_lz_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  return jpt::lz::decode(in, n, out, cap);
}
}
