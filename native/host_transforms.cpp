// libdctpu_host — native host-side ragged layout transforms.
//
// The codec runtime's host half (SURVEY.md §2.1 "C++ host bitstream
// assembly"): converts between the device's fixed-shape payload regions and
// the canonical DCF1 disk layout. These are memory-bound gather/scatter loops
// that numpy fancy indexing runs at ~140 ns/element; here they are simple
// OpenMP-parallel loops at memcpy-class speed.
//
// Exposed via ctypes (dctpu/native.py). Layout contracts mirror
// docs/FORMAT.md §2.1/§2.2 and dctpu/codec/vertical_host.py exactly.
//
// Build: make -C native   (g++ -O3 -fopenmp -shared -fPIC)

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr uint32_t SUB_BLOCK = 128;
// Round 4: device payload rows are PACKED — each sub's region_pad slot
// holds its live disk words verbatim (dctpu/kernels/vertical_xla.py), so
// compact/stage are per-sub memcpys of the live prefix.

inline uint32_t subs_per_block(uint32_t L) { return (L + SUB_BLOCK - 1) / SUB_BLOCK; }
inline uint32_t sync_word_count(uint32_t L) { return (subs_per_block(L) + 1) / 2; }
inline uint32_t sub_cap(uint32_t L, uint32_t s) {
  uint32_t start = s * SUB_BLOCK;
  return start < L ? (L - start < SUB_BLOCK ? L - start : SUB_BLOCK) : 0;
}
inline uint32_t plane_words(uint32_t L, uint32_t s) { return (sub_cap(L, s) + 31) / 32; }

// FORMAT §2.2 sync entry: b | n_exc<<6 | (e-1)<<11; exception values are
// bit-planed, ceil(e/2) disk words (the device region's val slots hold the
// packed planes verbatim).
inline uint32_t val_words(uint16_t sync) {
  uint32_t n_exc = (sync >> 6) & 0x1F;
  if (!n_exc) return 0;
  uint32_t ew = ((((sync >> 11) & 0x1F) + 1) + 1) / 2;  // ceil(e/2)
  return n_exc < ew ? n_exc : ew;
}

inline uint32_t sub_live_words(uint32_t sync, uint32_t L, uint32_t s) {
  uint32_t b = sync & 0x3F, n_exc = (sync >> 6) & 0x1F;
  return plane_words(L, s) * b + (n_exc + 3) / 4 +
         val_words(static_cast<uint16_t>(sync));
}

}  // namespace

extern "C" {

// Per-block disk word counts from device payload sync rows.
// payload: [B, W] u32 rows (sync at word 0). out_wc: [B] i64.
void dctpu_vert_block_words(const uint32_t* payload, int64_t B, int64_t W,
                            uint32_t block_len, int64_t* out_wc) {
  uint32_t S = subs_per_block(block_len);
  uint32_t SW = sync_word_count(block_len);
#pragma omp parallel for schedule(static)
  for (int64_t bi = 0; bi < B; bi++) {
    const uint16_t* sync = reinterpret_cast<const uint16_t*>(payload + bi * W);
    int64_t wc = SW;
    for (uint32_t s = 0; s < S; s++) {
      uint32_t b = sync[s] & 0x3F, n_exc = (sync[s] >> 6) & 0x1F;
      wc += plane_words(block_len, s) * b + (n_exc + 3) / 4 + val_words(sync[s]);
    }
    out_wc[bi] = wc;
  }
}

// Packed device payload rows [B, SW + S*region_pad] -> canonical disk words.
// block_off: [B+1] exclusive word offsets (from dctpu_vert_block_words).
void dctpu_vert_compact(const uint32_t* payload, int64_t B, int64_t W,
                        uint32_t block_len, uint32_t region_pad,
                        const int64_t* block_off, uint32_t* out) {
  uint32_t S = subs_per_block(block_len);
  uint32_t SW = sync_word_count(block_len);
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t bi = 0; bi < B; bi++) {
    const uint32_t* row = payload + bi * W;
    uint32_t* dst = out + block_off[bi];
    memcpy(dst, row, SW * 4);
    const uint16_t* sync = reinterpret_cast<const uint16_t*>(row);
    uint32_t* d = dst + SW;
    for (uint32_t s = 0; s < S; s++) {
      uint32_t wc = sub_live_words(sync[s], block_len, s);
      memcpy(d, row + SW + s * region_pad, wc * 4);
      d += wc;
    }
  }
}

// Canonical disk words -> packed payload rows [B, SW + S*region_pad] (zeroed).
void dctpu_vert_stage(const uint32_t* disk, const int64_t* word_off, int64_t B,
                      uint32_t block_len, uint32_t region_pad, uint32_t* out,
                      int64_t W) {
  uint32_t S = subs_per_block(block_len);
  uint32_t SW = sync_word_count(block_len);
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t bi = 0; bi < B; bi++) {
    const uint32_t* src = disk + word_off[bi];
    uint32_t* row = out + bi * W;
    memcpy(row, src, SW * 4);
    const uint16_t* sync = reinterpret_cast<const uint16_t*>(row);
    const uint32_t* d = src + SW;
    for (uint32_t s = 0; s < S; s++) {
      uint32_t wc = sub_live_words(sync[s], block_len, s);
      memcpy(row + SW + s * region_pad, d, wc * 4);
      d += wc;
    }
  }
}

// Rice-mode helpers: segmented copy between compact disk words and padded rows.
// Equivalent to api.compact_payload / api.pad_payload.
void dctpu_segment_gather(const uint32_t* rows, int64_t B, int64_t W,
                          const int64_t* word_off, uint32_t* out) {
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t bi = 0; bi < B; bi++) {
    int64_t n = word_off[bi + 1] - word_off[bi];
    memcpy(out + word_off[bi], rows + bi * W, n * 4);
  }
}

void dctpu_segment_scatter(const uint32_t* words, const int64_t* word_off,
                           int64_t B, uint32_t* rows, int64_t W) {
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t bi = 0; bi < B; bi++) {
    int64_t n = word_off[bi + 1] - word_off[bi];
    memcpy(rows + bi * W, words + word_off[bi], n * 4);
  }
}

// Host feed (config 5, 10M-stream scale): pack concatenated stream samples
// into padded [B, L] blocks + per-block valid counts + 4-sample histories.
// Per-stream memcpy at memory speed, OpenMP over streams; mirrors
// dctpu.codec.api.build_blocks_flat exactly (tests enforce equality).
// flat: [total] i32; sstart: [S+1] i64 exclusive sample offsets;
// first: [S] i64 first-block index per stream; x: [B, L]; n: [B]; hist: [B,4].
void dctpu_build_blocks(const int32_t* flat, const int64_t* sstart,
                        const int64_t* first, int64_t S, uint32_t L,
                        int32_t* x, int32_t* n, int32_t* hist) {
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t s = 0; s < S; s++) {
    int64_t len = sstart[s + 1] - sstart[s];
    int64_t k = (len + L - 1) / L;
    const int32_t* src = flat + sstart[s];
    int64_t f = first[s];
    for (int64_t b = 0; b < k; b++) {
      int64_t off = b * L;
      int64_t m = len - off < (int64_t)L ? len - off : (int64_t)L;
      int32_t* row = x + (f + b) * L;
      std::memcpy(row, src + off, m * 4);
      if (m < (int64_t)L) std::memset(row + m, 0, (L - m) * 4);
      n[f + b] = (int32_t)m;
      for (int j = 0; j < 4; j++) {
        int64_t idx = off - 1 - j;
        hist[(f + b) * 4 + j] = idx >= 0 ? src[idx] : 0;
      }
    }
  }
}

// Squeeze tile-alignment gaps out of a semi-compact stream: concatenate
// src[src_off[s] : src_off[s]+len[s]] for every segment (kernels/ragged.py
// squeeze_host). dst_off: [nseg+1] exclusive output offsets (cumsum of len).
void dctpu_squeeze(const uint32_t* src, const int64_t* src_off,
                   const int64_t* dst_off, int64_t nseg, uint32_t* out) {
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t s = 0; s < nseg; s++) {
    memcpy(out + dst_off[s], src + src_off[s],
           (dst_off[s + 1] - dst_off[s]) * 4);
  }
}

}  // extern "C"
