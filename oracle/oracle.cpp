// dcomp_oracle — scalar C++ implementation of the DCF1 codec (docs/FORMAT.md).
//
// Role (SURVEY.md §2.1 "Oracle codec"): the native bit-exactness target that the
// JAX/XLA implementations are tested against byte-for-byte. The original
// C reference is unavailable in this environment (SURVEY.md §0); when it
// appears, cross-check this oracle against it and swap it in as the arbiter.
//
// Deliberately scalar and dependency-free. Build: make -C oracle
// CLI:
//   dcomp_oracle encode in.dcr out.dcf [--block-len N] [--no-lpc] [--no-dd]
//   dcomp_oracle decode in.dcf out.dcr
//   dcomp_oracle verify in.dcr          (in-memory round trip + stats)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

// ----------------------------------------------------------------- constants

static constexpr uint32_t ESCAPE_Q = 16;
static constexpr uint32_t RAW_BITS = 32;
static constexpr uint32_t MAX_CODE_BITS = ESCAPE_Q + RAW_BITS;  // 48
static constexpr int K_MAX = 24;
static constexpr uint32_t SUB_BLOCK = 128;  // sync-table granularity (FORMAT §2.1)

static inline uint32_t subs_per_block(uint32_t L) { return (L + SUB_BLOCK - 1) / SUB_BLOCK; }
static inline uint32_t sync_word_count(uint32_t L) { return (subs_per_block(L) + 1) / 2; }
static constexpr int HISTORY_LEN = 4;
static constexpr int LPC_SHIFT = 16;
static constexpr uint16_t DCF_VERSION = 2;  // v2: vertical sync e-field + bit-planed exception values

enum Predictor : uint8_t { DELTA = 0, DOUBLE_DELTA = 1, LPC = 2 };
enum Coder : uint8_t { CODER_RICE = 0, CODER_VERTICAL = 1 };

struct LpcTable {
  uint8_t order;
  int32_t c[4];
};

// Must match dctpu/config.py DEFAULT_LPC_TABLES exactly.
static const LpcTable kDefaultTables[] = {
    {3, {3 << 16, -(3 << 16), 1 << 16, 0}},
    {2, {(3 << 16) / 2, -(1 << 16) / 2, 0, 0}},
    {2, {1 << 15, 1 << 15, 0, 0}},
    {4, {4 << 16, -(6 << 16), 4 << 16, -(1 << 16)}},
};
static constexpr int kNumDefaultTables = 4;

// ----------------------------------------------------------------- crc32 (zlib)

static uint32_t crc_table[256];
static void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int j = 0; j < 8; j++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
}
static uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ----------------------------------------------------------------- wrapping math

static inline int32_t wrap32(uint32_t v) { return static_cast<int32_t>(v); }
static inline int32_t addw(int32_t a, int32_t b) {
  return wrap32(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
static inline int32_t subw(int32_t a, int32_t b) {
  return wrap32(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// LPC prediction: wrap64(sum c_j * x_{t-j}) >> 16, truncated to int32.
static inline int32_t lpc_predict(const int32_t* hist, const LpcTable& t) {
  uint64_t acc = 0;
  for (int j = 0; j < t.order; j++)
    acc += static_cast<uint64_t>(static_cast<int64_t>(t.c[j]) *
                                 static_cast<int64_t>(hist[j]));
  int64_t s = static_cast<int64_t>(acc);  // two's-complement wrap
  return wrap32(static_cast<uint32_t>(static_cast<uint64_t>(s >> LPC_SHIFT)));
}

// ----------------------------------------------------------------- zigzag

static inline uint32_t zigzag(int32_t r) {
  return (static_cast<uint32_t>(r) << 1) ^ static_cast<uint32_t>(r >> 31);
}
static inline int32_t unzigzag(uint32_t z) {
  return wrap32((z >> 1) ^ (0u - (z & 1u)));
}

// ----------------------------------------------------------------- bit I/O

struct BitWriter {
  std::vector<uint32_t> words;
  uint64_t acc = 0;
  uint32_t nbits = 0;
  uint64_t total_bits = 0;

  void put(uint32_t v, uint32_t len) {  // len <= 32
    if (len == 0) return;
    acc |= static_cast<uint64_t>(v & (len == 32 ? 0xFFFFFFFFu : ((1u << len) - 1)))
           << nbits;
    nbits += len;
    total_bits += len;
    if (nbits >= 32) {
      words.push_back(static_cast<uint32_t>(acc));
      acc >>= 32;
      nbits -= 32;
    }
  }
  void put_code(uint64_t code, uint32_t len) {  // len <= 48
    put(static_cast<uint32_t>(code), len < 32 ? len : 32);
    if (len > 32) put(static_cast<uint32_t>(code >> 32), len - 32);
  }
  void flush_block() {
    if (nbits > 0) {
      words.push_back(static_cast<uint32_t>(acc));
      acc = 0;
      nbits = 0;
    }
  }
};

struct BitReader {
  const uint32_t* words;
  size_t nwords;
  uint64_t pos = 0;

  uint32_t word(size_t i) const { return i < nwords ? words[i] : 0; }
  // 32-bit window starting at bit p
  uint32_t win32(uint64_t p) const {
    size_t j = p >> 5;
    uint32_t s = p & 31;
    uint32_t lo = word(j), hi = word(j + 1);
    return s == 0 ? lo : (lo >> s) | (hi << (32 - s));
  }
  uint32_t get(uint32_t len) {  // len <= 32
    uint32_t v = win32(pos);
    if (len < 32) v &= (1u << len) - 1;
    pos += len;
    return v;
  }
};

// ----------------------------------------------------------------- rice

static inline uint32_t rice_len(uint32_t z, int k) {
  uint32_t q = z >> k;
  return q < ESCAPE_Q ? q + 1 + k : MAX_CODE_BITS;
}

static inline void rice_emit(BitWriter& bw, uint32_t z, int k) {
  uint32_t q = z >> k;
  if (q < ESCAPE_Q) {
    uint64_t code = ((1ull << q) - 1) |
                    (static_cast<uint64_t>(z & ((1u << k) - 1)) << (q + 1));
    bw.put_code(code, q + 1 + k);
  } else {
    bw.put_code(0xFFFFull | (static_cast<uint64_t>(z) << ESCAPE_Q), MAX_CODE_BITS);
  }
}

static uint32_t rice_read(BitReader& br, int k) {
  uint32_t ones = 0;
  while (ones < ESCAPE_Q && ((br.win32(br.pos + ones)) & 1u)) ones++;
  if (ones >= ESCAPE_Q) {
    br.pos += ESCAPE_Q;
    return br.get(RAW_BITS);
  }
  uint32_t q = ones;
  br.pos += q + 1;
  uint32_t v = k ? br.get(k) : 0;
  return (q << k) | v;
}

// ----------------------------------------------------------------- predictors

static void residuals(const int32_t* x, int n, const int32_t* h, Predictor pred,
                      const LpcTable* table, int32_t* r) {
  switch (pred) {
    case DELTA:
      for (int t = 0; t < n; t++) r[t] = subw(x[t], t ? x[t - 1] : h[0]);
      break;
    case DOUBLE_DELTA:
      for (int t = 0; t < n; t++) {
        int32_t x1 = t >= 1 ? x[t - 1] : h[0];
        int32_t x2 = t >= 2 ? x[t - 2] : h[1 - t];
        r[t] = addw(subw(x[t], addw(x1, x1)), x2);
      }
      break;
    case LPC: {
      int32_t hist[HISTORY_LEN] = {h[0], h[1], h[2], h[3]};
      for (int t = 0; t < n; t++) {
        r[t] = subw(x[t], lpc_predict(hist, *table));
        hist[3] = hist[2]; hist[2] = hist[1]; hist[1] = hist[0]; hist[0] = x[t];
      }
      break;
    }
  }
}

static void reconstruct(const int32_t* r, int n, const int32_t* h, Predictor pred,
                        const LpcTable* table, int32_t* x) {
  switch (pred) {
    case DELTA: {
      int32_t prev = h[0];
      for (int t = 0; t < n; t++) x[t] = prev = addw(prev, r[t]);
      break;
    }
    case DOUBLE_DELTA: {
      int32_t prev = h[0], d = subw(h[0], h[1]);
      for (int t = 0; t < n; t++) {
        d = addw(d, r[t]);
        x[t] = prev = addw(prev, d);
      }
      break;
    }
    case LPC: {
      int32_t hist[HISTORY_LEN] = {h[0], h[1], h[2], h[3]};
      for (int t = 0; t < n; t++) {
        x[t] = addw(r[t], lpc_predict(hist, *table));
        hist[3] = hist[2]; hist[2] = hist[1]; hist[1] = hist[0]; hist[0] = x[t];
      }
      break;
    }
  }
}

// ----------------------------------------------------------------- block encode

struct BlockMeta {
  uint8_t predictor, k, table_idx, coder;
  uint16_t n;
  uint32_t bit_len;
  int32_t history[HISTORY_LEN];
};

struct EncodeConfig {
  uint32_t block_len = 4096;
  bool use_dd = true;
  bool use_lpc = true;
  Coder coder = CODER_RICE;
  bool adaptive = false;  // FORMAT §4.1: per-block coder by exact words
};

// --------------------------------------------------- vertical coder (FORMAT §2.2)

static inline uint32_t sub_cap(uint32_t L, uint32_t s) {
  uint32_t start = s * SUB_BLOCK;
  return start < L ? std::min(SUB_BLOCK, L - start) : 0;
}

// Exact (b*, words); ties -> smallest b.
static constexpr uint32_t EXC_CAP = 16;  // normative (FORMAT §2.2)

static void vertical_choose_b(const uint32_t* z, int count, uint32_t cap,
                              uint32_t* best_b, uint32_t* best_words) {
  uint32_t pw = (cap + 31) / 32;
  uint32_t zmax = 0;
  for (int i = 0; i < count; i++) zmax = std::max(zmax, z[i]);
  uint32_t blmax = zmax ? 32 - __builtin_clz(zmax) : 0;
  *best_b = 32;
  *best_words = pw * 32;
  for (uint32_t b = 0; b <= 32; b++) {
    uint32_t n_exc = 0;
    if (b < 32)
      for (int i = 0; i < count; i++) n_exc += (z[i] >> b) != 0;
    if (n_exc > EXC_CAP) continue;
    // exception values: cheaper of raw (n_exc words) and bit-planed
    // (ceil(e/2) words), e = blmax - b (FORMAT §2.2)
    uint32_t vw = n_exc ? std::min(n_exc, (blmax - b + 1) / 2) : 0;
    uint32_t words = pw * b + (n_exc + 3) / 4 + vw;
    if (words < *best_words || (words == *best_words && b < *best_b)) {
      *best_words = words;
      *best_b = b;
    }
  }
}

// Exact VERTICAL coded word count for one block (FORMAT §4.1 VW).
static uint64_t vertical_block_words(const uint32_t* z, int n, uint32_t L) {
  uint64_t total = 0;
  for (uint32_t s = 0; s * SUB_BLOCK < static_cast<uint32_t>(n); s++) {
    uint32_t cap = sub_cap(L, s);
    int count = std::min<int>(cap, n - s * SUB_BLOCK);
    uint32_t b, words;
    vertical_choose_b(z + s * SUB_BLOCK, count, cap, &b, &words);
    total += words;
  }
  return total;
}

// Predictor-selection proxy (FORMAT §2.2): sum of bitlengths of valid z.
static uint64_t vertical_block_cost(const uint32_t* z, int n, uint32_t L) {
  (void)L;
  uint64_t total = 0;
  for (int t = 0; t < n; t++)
    total += z[t] ? 32 - __builtin_clz(z[t]) : 0;
  return total;
}

static void vertical_emit_block(const uint32_t* z, int n, uint32_t L,
                                std::vector<uint32_t>& out, uint32_t* bit_len) {
  uint32_t subs = subs_per_block(L);
  std::vector<uint16_t> sync(2 * sync_word_count(L), 0);
  std::vector<uint32_t> body;
  for (uint32_t s = 0; s < subs && s * SUB_BLOCK < static_cast<uint32_t>(n); s++) {
    uint32_t cap = sub_cap(L, s);
    int count = std::min<int>(cap, n - s * SUB_BLOCK);
    const uint32_t* zz = z + s * SUB_BLOCK;
    uint32_t b, w_unused;
    vertical_choose_b(zz, count, cap, &b, &w_unused);
    uint32_t pw = (cap + 31) / 32;
    for (uint32_t p = 0; p < b; p++)
      for (uint32_t w = 0; w < pw; w++) {
        uint32_t word = 0;
        for (int i = 32 * w; i < std::min<int>(32 * (w + 1), count); i++)
          word |= ((zz[i] >> p) & 1u) << (i - 32 * w);
        body.push_back(word);
      }
    std::vector<uint8_t> pos;
    if (b < 32)
      for (int i = 0; i < count; i++)
        if (zz[i] >> b) pos.push_back(static_cast<uint8_t>(i));
    uint32_t n_exc = pos.size();
    uint32_t e = 0;
    for (uint8_t pi : pos) {
      uint32_t v = zz[pi] >> b;
      e = std::max(e, v ? 32 - __builtin_clz(v) : 0u);
    }
    sync[s] = static_cast<uint16_t>(b | (n_exc << 6) |
                                    (n_exc ? (e - 1) << 11 : 0));
    for (uint32_t w = 0; w < (n_exc + 3) / 4; w++) {
      uint32_t word = 0;
      for (uint32_t j = 4 * w; j < std::min(4 * w + 4, n_exc); j++)
        word |= static_cast<uint32_t>(pos[j]) << (8 * (j - 4 * w));
      body.push_back(word);
    }
    // exception values: raw when n_exc <= ceil(e/2), else bit-planed
    // (plane p = bit p of every value, 2 planes per word) — FORMAT §2.2
    if (n_exc <= (e + 1) / 2) {
      for (uint8_t pi : pos) body.push_back(zz[pi] >> b);
    } else {
      for (uint32_t w = 0; w < (e + 1) / 2; w++) {
        uint32_t word = 0;
        for (uint32_t h = 0; h < 2; h++) {
          uint32_t p = 2 * w + h;
          if (p >= e) break;
          uint32_t plane = 0;
          for (uint32_t j = 0; j < n_exc; j++)
            plane |= (((zz[pos[j]] >> b) >> p) & 1u) << j;
          word |= plane << (16 * h);
        }
        body.push_back(word);
      }
    }
  }
  const uint32_t* sp = reinterpret_cast<const uint32_t*>(sync.data());
  out.insert(out.end(), sp, sp + sync.size() / 2);
  out.insert(out.end(), body.begin(), body.end());
  *bit_len = 32 * static_cast<uint32_t>(body.size());
}

static void vertical_decode_block_words(const uint32_t* words, int n, uint32_t L,
                                        uint32_t* z_out) {
  uint32_t sw = sync_word_count(L);
  const uint16_t* sync = reinterpret_cast<const uint16_t*>(words);
  const uint32_t* body = words + sw;
  uint32_t off = 0;
  for (uint32_t s = 0; s * SUB_BLOCK < static_cast<uint32_t>(n); s++) {
    uint32_t cap = sub_cap(L, s);
    int count = std::min<int>(cap, n - s * SUB_BLOCK);
    uint32_t b = sync[s] & 0x3F, n_exc = (sync[s] >> 6) & 0x1F;
    uint32_t e = n_exc ? ((sync[s] >> 11) & 0x1F) + 1 : 0;
    uint32_t pw = (cap + 31) / 32;
    uint32_t* zz = z_out + s * SUB_BLOCK;
    for (int i = 0; i < count; i++) zz[i] = 0;
    for (uint32_t p = 0; p < b; p++)
      for (uint32_t w = 0; w < pw; w++) {
        uint32_t word = body[off + p * pw + w];
        for (int i = 32 * w; i < std::min<int>(32 * (w + 1), count); i++)
          zz[i] |= ((word >> (i - 32 * w)) & 1u) << p;
      }
    uint32_t base = off + b * pw, pos_words = (n_exc + 3) / 4;
    bool raw = n_exc <= (e + 1) / 2;
    for (uint32_t j = 0; j < n_exc; j++) {
      uint32_t pos = (body[base + j / 4] >> (8 * (j % 4))) & 0xFF;
      uint32_t val = 0;
      if (raw) {
        val = body[base + pos_words + j];
      } else {
        for (uint32_t p = 0; p < e; p++) {
          uint32_t plane = (body[base + pos_words + p / 2] >> (16 * (p % 2))) & 0xFFFF;
          val |= ((plane >> j) & 1u) << p;
        }
      }
      zz[pos] |= val << b;
    }
    off += b * pw + pos_words + (n_exc < (e + 1) / 2 ? n_exc : (e + 1) / 2);
  }
}

// Exact k selection (FORMAT.md §4): argmin over k in [0, K_MAX], ties -> smallest.
static void choose_k(const uint32_t* z, int n, int* best_k, uint64_t* best_bits) {
  *best_k = 0;
  *best_bits = ~0ull;
  for (int k = 0; k <= K_MAX; k++) {
    uint64_t bits = 0;
    for (int t = 0; t < n; t++) bits += rice_len(z[t], k);
    if (bits < *best_bits) { *best_bits = bits; *best_k = k; }
  }
}

static void encode_block(const int32_t* x, int n, const int32_t* h,
                         const EncodeConfig& cfg, BitWriter& bw, BlockMeta* meta) {
  std::vector<int32_t> r(n);
  std::vector<uint32_t> z(n), best_z(n);
  uint64_t best_bits = ~0ull;
  int best_k = 0, best_pred = -1, best_ti = 0;

  // Candidate order is normative: DELTA, DOUBLE_DELTA, LPC tables in order.
  struct Cand { Predictor p; int ti; };
  std::vector<Cand> cands{{DELTA, 0}};
  if (cfg.use_dd) cands.push_back({DOUBLE_DELTA, 0});
  if (cfg.use_lpc)
    for (int ti = 0; ti < kNumDefaultTables; ti++) cands.push_back({LPC, ti});

  Coder emit_coder = cfg.coder;
  if (cfg.adaptive) {
    // FORMAT §4.1: exact word count over (candidate, coder) pairs, order
    // c0-RICE, c0-VERTICAL, c1-RICE, ...; strict < implements first-wins.
    uint64_t best_words = ~0ull;
    for (const Cand& c : cands) {
      const LpcTable* table = c.p == LPC ? &kDefaultTables[c.ti] : nullptr;
      residuals(x, n, h, c.p, table, r.data());
      for (int t = 0; t < n; t++) z[t] = zigzag(r[t]);
      int k; uint64_t bits;
      choose_k(z.data(), n, &k, &bits);
      uint64_t rw = (bits + 31) / 32;
      if (rw < best_words) {
        best_words = rw; emit_coder = CODER_RICE;
        best_bits = bits; best_k = k; best_pred = c.p;
        best_ti = c.p == LPC ? c.ti : 0;
        best_z = z;
      }
      uint64_t vw = vertical_block_words(z.data(), n, cfg.block_len);
      if (vw < best_words) {
        best_words = vw; emit_coder = CODER_VERTICAL;
        best_pred = c.p;
        best_ti = c.p == LPC ? c.ti : 0;
        best_z = z;
      }
    }
  } else {
  for (const Cand& c : cands) {
    const LpcTable* table = c.p == LPC ? &kDefaultTables[c.ti] : nullptr;
    residuals(x, n, h, c.p, table, r.data());
    for (int t = 0; t < n; t++) z[t] = zigzag(r[t]);
    if (cfg.coder == CODER_VERTICAL) {
      uint64_t cost = vertical_block_cost(z.data(), n, cfg.block_len);
      if (cost < best_bits) {
        best_bits = cost; best_pred = c.p;
        best_ti = c.p == LPC ? c.ti : 0;
        best_z = z;
      }
      continue;
    }
    int k; uint64_t bits;
    choose_k(z.data(), n, &k, &bits);
    if (bits < best_bits) {
      best_bits = bits; best_k = k; best_pred = c.p;
      best_ti = c.p == LPC ? c.ti : 0;
      best_z = z;
    }
  }
  }

  if (emit_coder == CODER_VERTICAL) {
    // Pad candidate z to block_len-extent access (vertical indexes by sub).
    uint32_t bl;
    vertical_emit_block(best_z.data(), n, cfg.block_len, bw.words, &bl);
    meta->predictor = static_cast<uint8_t>(best_pred);
    meta->k = 0;
    meta->table_idx = static_cast<uint8_t>(best_ti);
    meta->coder = CODER_VERTICAL;
    meta->n = static_cast<uint16_t>(n);
    meta->bit_len = bl;
    memcpy(meta->history, h, sizeof(meta->history));
    return;
  }

  // Sync table: per-sub-block code bit lengths (u16 pairs packed into u32).
  uint32_t L = cfg.block_len;
  uint32_t subs = subs_per_block(L);
  std::vector<uint16_t> sub_lens(subs, 0);
  for (int t = 0; t < n; t++)
    sub_lens[t / SUB_BLOCK] += static_cast<uint16_t>(rice_len(best_z[t], best_k));
  for (uint32_t w = 0; w < sync_word_count(L); w++) {
    uint32_t lo = sub_lens[2 * w];
    uint32_t hi = (2 * w + 1 < subs) ? sub_lens[2 * w + 1] : 0;
    bw.words.push_back(lo | (hi << 16));
  }

  for (int t = 0; t < n; t++) rice_emit(bw, best_z[t], best_k);
  meta->predictor = static_cast<uint8_t>(best_pred);
  meta->k = static_cast<uint8_t>(best_k);
  meta->table_idx = static_cast<uint8_t>(best_ti);
  meta->coder = CODER_RICE;
  meta->n = static_cast<uint16_t>(n);
  meta->bit_len = static_cast<uint32_t>(best_bits);  // bitstream bits only
  memcpy(meta->history, h, sizeof(meta->history));
  bw.flush_block();
}

// ----------------------------------------------------------------- file structs

#pragma pack(push, 1)
struct FileHeader {
  char magic[4];
  uint16_t version, flags;
  uint32_t block_len, num_streams;
  uint64_t num_blocks, off_dir, off_btab, off_tables, off_payload, payload_bytes;
};
struct StreamDirEntry {
  uint64_t stream_id;
  uint32_t cadence_s, num_blocks;
  uint64_t num_samples;
  uint32_t first_block, reserved;
};
struct BlockHeaderRec {
  uint8_t predictor, k;
  uint16_t n;
  uint32_t bit_len;
  uint8_t table_idx, coder, reserved[2];
  int32_t history[4];
  uint32_t reserved2;
};
struct TableRec {
  uint8_t order, pad[3];
  int32_t c[4];
};
struct RawEntry {
  uint64_t stream_id;
  uint32_t cadence_s, reserved;
  uint64_t num_samples;
};
#pragma pack(pop)
static_assert(sizeof(FileHeader) == 64);
static_assert(sizeof(StreamDirEntry) == 32);
static_assert(sizeof(BlockHeaderRec) == 32);
static_assert(sizeof(TableRec) == 20);
static_assert(sizeof(RawEntry) == 24);

// ----------------------------------------------------------------- corpus I/O

struct Corpus {
  std::vector<uint64_t> ids;
  std::vector<uint32_t> cadences;
  std::vector<std::vector<int32_t>> streams;
};

static std::vector<uint8_t> read_file(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(2); }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  if (fread(buf.data(), 1, n, f) != static_cast<size_t>(n)) { fprintf(stderr, "short read\n"); exit(2); }
  fclose(f);
  return buf;
}

static void write_file(const char* path, const std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "wb");
  if (!f) { fprintf(stderr, "cannot open %s for write\n", path); exit(2); }
  fwrite(buf.data(), 1, buf.size(), f);
  fclose(f);
}

static Corpus parse_raw(const std::vector<uint8_t>& buf) {
  if (buf.size() < 8 || memcmp(buf.data(), "DCR1", 4) != 0) {
    fprintf(stderr, "bad DCR1 magic\n"); exit(2);
  }
  uint32_t n; memcpy(&n, buf.data() + 4, 4);
  Corpus c;
  size_t off = 8;
  std::vector<uint64_t> lens;
  for (uint32_t i = 0; i < n; i++) {
    RawEntry e; memcpy(&e, buf.data() + off, sizeof(e)); off += sizeof(e);
    c.ids.push_back(e.stream_id);
    c.cadences.push_back(e.cadence_s);
    lens.push_back(e.num_samples);
  }
  for (uint32_t i = 0; i < n; i++) {
    std::vector<int32_t> s(lens[i]);
    memcpy(s.data(), buf.data() + off, lens[i] * 4);
    off += lens[i] * 4;
    c.streams.push_back(std::move(s));
  }
  return c;
}

static std::vector<uint8_t> emit_raw(const Corpus& c) {
  std::vector<uint8_t> out;
  out.insert(out.end(), {'D', 'C', 'R', '1'});
  uint32_t n = c.streams.size();
  out.insert(out.end(), reinterpret_cast<uint8_t*>(&n), reinterpret_cast<uint8_t*>(&n) + 4);
  for (uint32_t i = 0; i < n; i++) {
    RawEntry e{c.ids[i], c.cadences[i], 0, c.streams[i].size()};
    out.insert(out.end(), reinterpret_cast<uint8_t*>(&e), reinterpret_cast<uint8_t*>(&e) + sizeof(e));
  }
  for (auto& s : c.streams) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(s.data());
    out.insert(out.end(), p, p + s.size() * 4);
  }
  return out;
}

// ----------------------------------------------------------------- encode/decode

static std::vector<uint8_t> encode_corpus(const Corpus& corpus, const EncodeConfig& cfg) {
  const uint32_t L = cfg.block_len;
  std::vector<StreamDirEntry> dir;
  std::vector<BlockHeaderRec> btab;
  BitWriter bw;

  uint32_t first_block = 0;
  for (size_t si = 0; si < corpus.streams.size(); si++) {
    const auto& x = corpus.streams[si];
    uint64_t ns = x.size();
    uint32_t nb = static_cast<uint32_t>((ns + L - 1) / L);
    dir.push_back({corpus.ids[si], corpus.cadences[si], nb, ns, first_block, 0});
    first_block += nb;
    for (uint64_t start = 0; start < ns; start += L) {
      int n = static_cast<int>(std::min<uint64_t>(L, ns - start));
      int32_t h[HISTORY_LEN] = {0, 0, 0, 0};
      for (int j = 0; j < HISTORY_LEN; j++)
        if (start >= static_cast<uint64_t>(j + 1)) h[j] = x[start - 1 - j];
      BlockMeta meta;
      encode_block(x.data() + start, n, h, cfg, bw, &meta);
      BlockHeaderRec rec{};
      rec.predictor = meta.predictor; rec.k = meta.k; rec.n = meta.n;
      rec.bit_len = meta.bit_len; rec.table_idx = meta.table_idx;
      rec.coder = meta.coder;
      memcpy(rec.history, meta.history, sizeof(rec.history));
      btab.push_back(rec);
    }
  }

  // Assemble frame
  std::vector<uint8_t> dir_b(dir.size() * sizeof(StreamDirEntry));
  memcpy(dir_b.data(), dir.data(), dir_b.size());
  std::vector<uint8_t> btab_b(btab.size() * sizeof(BlockHeaderRec));
  memcpy(btab_b.data(), btab.data(), btab_b.size());

  std::vector<uint8_t> tables_b;
  uint16_t nt = kNumDefaultTables, zero16 = 0;
  tables_b.insert(tables_b.end(), reinterpret_cast<uint8_t*>(&nt), reinterpret_cast<uint8_t*>(&nt) + 2);
  tables_b.insert(tables_b.end(), reinterpret_cast<uint8_t*>(&zero16), reinterpret_cast<uint8_t*>(&zero16) + 2);
  for (int i = 0; i < kNumDefaultTables; i++) {
    TableRec tr{};
    tr.order = kDefaultTables[i].order;
    memcpy(tr.c, kDefaultTables[i].c, sizeof(tr.c));
    tables_b.insert(tables_b.end(), reinterpret_cast<uint8_t*>(&tr), reinterpret_cast<uint8_t*>(&tr) + sizeof(tr));
  }

  const uint8_t* pay = reinterpret_cast<const uint8_t*>(bw.words.data());
  size_t pay_n = bw.words.size() * 4;

  FileHeader hdr{};
  memcpy(hdr.magic, "DCF1", 4);
  hdr.version = DCF_VERSION;
  hdr.block_len = L;
  hdr.num_streams = dir.size();
  hdr.num_blocks = btab.size();
  hdr.off_dir = sizeof(FileHeader);
  hdr.off_btab = hdr.off_dir + dir_b.size();
  hdr.off_tables = hdr.off_btab + btab_b.size();
  hdr.off_payload = hdr.off_tables + tables_b.size();
  hdr.payload_bytes = pay_n;

  std::vector<uint8_t> out;
  auto app = [&out](const uint8_t* p, size_t n) { out.insert(out.end(), p, p + n); };
  app(reinterpret_cast<uint8_t*>(&hdr), sizeof(hdr));
  app(dir_b.data(), dir_b.size());
  app(btab_b.data(), btab_b.size());
  app(tables_b.data(), tables_b.size());
  app(pay, pay_n);
  uint32_t crcs[5] = {
      crc32(dir_b.data(), dir_b.size()),
      crc32(btab_b.data(), btab_b.size()),
      crc32(tables_b.data(), tables_b.size()),
      crc32(pay, pay_n),
      crc32(reinterpret_cast<uint8_t*>(&hdr), sizeof(hdr)),
  };
  app(reinterpret_cast<uint8_t*>(crcs), sizeof(crcs));
  return out;
}

static Corpus decode_frame(const std::vector<uint8_t>& buf) {
  FileHeader hdr;
  if (buf.size() < sizeof(hdr)) { fprintf(stderr, "truncated frame\n"); exit(2); }
  memcpy(&hdr, buf.data(), sizeof(hdr));
  if (memcmp(hdr.magic, "DCF1", 4) != 0) { fprintf(stderr, "bad DCF1 magic\n"); exit(2); }

  std::vector<StreamDirEntry> dir(hdr.num_streams);
  memcpy(dir.data(), buf.data() + hdr.off_dir, dir.size() * sizeof(StreamDirEntry));
  std::vector<BlockHeaderRec> btab(hdr.num_blocks);
  memcpy(btab.data(), buf.data() + hdr.off_btab, btab.size() * sizeof(BlockHeaderRec));

  uint16_t ntables;
  memcpy(&ntables, buf.data() + hdr.off_tables, 2);
  std::vector<LpcTable> tables(ntables);
  for (int i = 0; i < ntables; i++) {
    TableRec tr;
    memcpy(&tr, buf.data() + hdr.off_tables + 4 + i * sizeof(TableRec), sizeof(TableRec));
    tables[i].order = tr.order;
    memcpy(tables[i].c, tr.c, sizeof(tr.c));
  }

  const uint32_t* payload = reinterpret_cast<const uint32_t*>(buf.data() + hdr.off_payload);
  size_t pay_words = hdr.payload_bytes / 4;

  // Prefix sum of per-block word counts -> parallel-decodable offsets.
  uint32_t sw = sync_word_count(hdr.block_len);
  std::vector<uint64_t> word_off(btab.size() + 1, 0);
  for (size_t b = 0; b < btab.size(); b++)
    word_off[b + 1] = word_off[b] + sw + (btab[b].bit_len + 31) / 32;

  Corpus c;
  for (const auto& d : dir) {
    std::vector<int32_t> x(d.num_samples);
    uint64_t written = 0;
    for (uint32_t bi = d.first_block; bi < d.first_block + d.num_blocks; bi++) {
      const BlockHeaderRec& bh = btab[bi];
      (void)pay_words;
      std::vector<int32_t> r(bh.n);
      if (bh.coder == CODER_VERTICAL) {
        std::vector<uint32_t> zbuf(((bh.n + SUB_BLOCK - 1) / SUB_BLOCK) * SUB_BLOCK, 0);
        vertical_decode_block_words(payload + word_off[bi], bh.n, hdr.block_len,
                                    zbuf.data());
        for (int t = 0; t < bh.n; t++) r[t] = unzigzag(zbuf[t]);
      } else {
        // Skip the sync table; scalar decode reads the bitstream sequentially.
        BitReader br{payload + word_off[bi] + sw,
                     static_cast<size_t>(word_off[bi + 1] - word_off[bi] - sw)};
        for (int t = 0; t < bh.n; t++) r[t] = unzigzag(rice_read(br, bh.k));
      }
      const LpcTable* table =
          bh.predictor == LPC ? &tables[bh.table_idx] : nullptr;
      reconstruct(r.data(), bh.n, bh.history, static_cast<Predictor>(bh.predictor),
                  table, x.data() + written);
      written += bh.n;
    }
    c.ids.push_back(d.stream_id);
    c.cadences.push_back(d.cadence_s);
    c.streams.push_back(std::move(x));
  }
  return c;
}

// ----------------------------------------------------------------- main

int main(int argc, char** argv) {
  crc_init();
  if (argc < 3) {
    fprintf(stderr, "usage: %s encode|decode|verify in [out] [--block-len N] [--no-lpc] [--no-dd]\n", argv[0]);
    return 2;
  }
  std::string mode = argv[1];
  EncodeConfig cfg;
  std::vector<std::string> pos;
  for (int i = 2; i < argc; i++) {
    std::string a = argv[i];
    if (a == "--block-len" && i + 1 < argc) cfg.block_len = atoi(argv[++i]);
    else if (a == "--no-lpc") cfg.use_lpc = false;
    else if (a == "--coder" && i + 1 < argc) {
      std::string c = argv[++i];
      cfg.adaptive = (c == "adaptive");
      cfg.coder = (c == "vertical") ? CODER_VERTICAL : CODER_RICE;
    }
    else if (a == "--no-dd") cfg.use_dd = false;
    else pos.push_back(a);
  }

  if (mode == "encode") {
    if (pos.size() != 2) { fprintf(stderr, "encode needs in.dcr out.dcf\n"); return 2; }
    Corpus c = parse_raw(read_file(pos[0].c_str()));
    auto frame = encode_corpus(c, cfg);
    write_file(pos[1].c_str(), frame);
    uint64_t raw = 0;
    for (auto& s : c.streams) raw += s.size() * 4;
    fprintf(stderr, "encoded %zu streams, %llu -> %zu bytes (%.3fx)\n",
            c.streams.size(), (unsigned long long)raw, frame.size(),
            raw ? static_cast<double>(raw) / frame.size() : 0.0);
    return 0;
  }
  if (mode == "decode") {
    if (pos.size() != 2) { fprintf(stderr, "decode needs in.dcf out.dcr\n"); return 2; }
    Corpus c = decode_frame(read_file(pos[0].c_str()));
    write_file(pos[1].c_str(), emit_raw(c));
    return 0;
  }
  if (mode == "verify") {
    if (pos.size() != 1) { fprintf(stderr, "verify needs in.dcr\n"); return 2; }
    Corpus c = parse_raw(read_file(pos[0].c_str()));
    auto frame = encode_corpus(c, cfg);
    Corpus d = decode_frame(frame);
    uint64_t raw = 0;
    for (auto& s : c.streams) raw += s.size() * 4;
    bool ok = c.streams.size() == d.streams.size();
    for (size_t i = 0; ok && i < c.streams.size(); i++)
      ok = c.streams[i] == d.streams[i];
    fprintf(stderr, "verify: %s  ratio=%.3fx\n", ok ? "OK" : "MISMATCH",
            raw ? static_cast<double>(raw) / frame.size() : 0.0);
    return ok ? 0 : 1;
  }
  fprintf(stderr, "unknown mode %s\n", mode.c_str());
  return 2;
}
