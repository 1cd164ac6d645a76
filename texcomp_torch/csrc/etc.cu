// ETC1 encode (four strategies), decode, one fused mip level, and the HQ
// search, for Hopper (sm_90a).
//
// Four kernels, each byte-exact with the plain PyTorch codec in
// texcomp_torch/codecs/etc.py, which follows the reference's
// etc_compressor.cc: integer arithmetic, but for the HQ candidate fit,
// which takes the twin's float32 steps one by one. The three encoders
// share one packed subblock search (below): pixels and candidate colours
// packed r | g << 8 | b << 16, a pixel's error against a colour from one
// __dp4a.
// The reference encode, the fused level and the decode run one thread per
// 4x4 block, the HQ search 8 lanes per block over its candidates, which
// the kernel is given or, in its other variant, fits itself. At the
// bottom, micro-kernels measure the card's rate for the search's inner
// loop (the operation bound of the encoders). The entry points have a
// plain C interface: pointers, ints and a stream, returning
// cudaGetLastError() so the caller sees a refused launch.
//
// A block is the reference's 64-bit word as two 32-bit words, hi and lo,
// stored big-endian hi then big-endian lo (EtcHelper::BuildBlock,
// etc_compressor.cc:158-194): the bytes codecs/etc.words_to_bytes gives.
//
// Tie-breaks are the reference's: strict '<' over the four modifiers of a
// pixel and over the eight codewords of a subblock, in scan order, and
// SMALLER_ERROR keeps the left/right split on equal errors.
//
// Errors are exact in int32: a pixel's squared error is at most
// 3 * 255^2 and a subblock's at most 8 times that.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "etc_hq_tables.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Strategy codes (etc_compressor.h:57-66).
constexpr int kSplitHorizontally = 0;
constexpr int kSplitVertically = 1;
constexpr int kSmallerError = 2;
constexpr int kHeuristic = 3;

// The codebook's rows are [a, b, -a, -b] (etc_compressor.cc:101-110).
// Written as select chains: they fold to immediates for a constant
// codeword.
__device__ __forceinline__ int cb_a(int cw) {
  return cw == 0 ? 2 : cw == 1 ? 5 : cw == 2 ? 9 : cw == 3 ? 13
       : cw == 4 ? 18 : cw == 5 ? 24 : cw == 6 ? 33 : 47;
}
__device__ __forceinline__ int cb_b(int cw) {
  return cw == 0 ? 8 : cw == 1 ? 17 : cw == 2 ? 29 : cw == 3 ? 42
       : cw == 4 ? 60 : cw == 5 ? 80 : cw == 6 ? 106 : 183;
}

// (a, b) of a codeword that differs from thread to thread: byte cw of the
// codebook's columns packed into two words each, one byte permute apiece
// (a constant-memory load would serialize on the distinct addresses).
__device__ __forceinline__ void cb_pair(int cw, int& a, int& b) {
  a = int(__byte_perm(0x0D090502u, 0x2F211812u, unsigned(cw)) & 0xFFu);
  b = int(__byte_perm(0x2A1D1108u, 0xB76A503Cu, unsigned(cw)) & 0xFFu);
}

__device__ __forceinline__ int clamp8(int v) { return min(max(v, 0), 255); }

// Extend5Bit with the replicated bits masked (color_util.h:200-202). In a
// malformed differential block the decoder passes v outside 0..31, even
// below 0; `v * 8` keeps that free of an undefined left shift and gives
// the same bits as the reference's int32 shift.
__device__ __forceinline__ int ext5(int v) { return (v * 8) | ((v >> 2) & 7); }
__device__ __forceinline__ int ext4(int v) { return (v << 4) | v; }

// The 3-bit two's-complement delta of the differential mode.
__device__ __forceinline__ int sext3(int v) { return v >= 4 ? v - 8 : v; }

__device__ __forceinline__ uint32_t bswap(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);
}

// Row-major pixel p = 4y + x in ETC's pixel-index order x*4 + y
// (etc_compressor.cc:131-137).
__device__ __forceinline__ constexpr int etc_order(int p) {
  return (p & 3) * 4 + (p >> 2);
}

// The k-th pixel (row-major) of subblock s: flipped, the top (s = 0) or
// bottom 4x2 half; otherwise the left (s = 0) or right 2x4 half
// (etc_compressor.cc:206). Under unrolled loops this is a constant.
template <bool kFlip>
__device__ __forceinline__ constexpr int member(int s, int k) {
  return kFlip ? 8 * s + k : 4 * (k >> 1) + (k & 1) + 2 * s;
}

// ---------------------------------------------------------------------------
// The packed subblock search, shared by the reference encode, the fused
// level and the HQ search.
//
// A candidate is one packed word per subblock: q555 r, g, b at bits 0, 5,
// 10 and q444 r, g, b at bits 15, 19, 23 (codecs/etc.pack_q_word). The
// reference encoder packs its truncated subblock means into it; the HQ
// search reads its candidates in it.
//
// Pixels and colours stay packed, r | g << 8 | b << 16. The squared error
// of pixel p against a candidate colour c is |c|^2 - 2 c.p + |p|^2, the dot
// product one __dp4a, exact in int32. |p|^2 is the same for every candidate
// colour, so the searches compare |c|^2 - 2 c.p alone (the first argmin
// over the modifiers is unchanged); both flips cover all 16 pixels, so
// SMALLER_ERROR compares the two flips' sums without it too. A candidate
// colour is clamp8(base +- m) per channel, by Hopper's DPX add-min and
// add-max on 16-bit halves. Bases travel byte-packed: an encoder's base is
// always in 0..255 (ext5 and ext4 of 555 and 444 values in range).
// ---------------------------------------------------------------------------

// The codebook's (a, b) of each codeword, for a codeword loop that is not
// unrolled and the same on every thread of a warp.
__constant__ int c_cb[8][2] = {{2, 8},   {5, 17},  {9, 29},  {13, 42},
                               {18, 60}, {24, 80}, {33, 106}, {47, 183}};

__device__ __forceinline__ int dot(uint32_t a, uint32_t b) {
  return int(__dp4a(a, b, 0u));
}

// The candidate word of a subblock whose truncated mean is (r, g, b)
// (QuantizeRgbFast, etc_compressor.cc:474-516).
__device__ __forceinline__ uint32_t q_word(int r, int g, int b) {
  return uint32_t(r >> 3) | (uint32_t(g >> 3) << 5) | (uint32_t(b >> 3) << 10) |
         (uint32_t(r >> 4) << 15) | (uint32_t(g >> 4) << 19) |
         (uint32_t(b >> 4) << 23);
}

// The decoded bases of the candidate (w1, w2), packed: differential if the
// 555 values are within the window (-4..3 per channel), else individual
// (etc_compressor.cc:480-516). Returns use_diff.
__device__ __forceinline__ bool bases(uint32_t w1, uint32_t w2, uint32_t& b0,
                                      uint32_t& b1) {
  bool diff = true;
  uint32_t d0 = 0, d1 = 0, i0 = 0, i1 = 0;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int a5 = (w1 >> (5 * ch)) & 31, c5 = (w2 >> (5 * ch)) & 31;
    diff = diff && c5 - a5 >= -4 && c5 - a5 <= 3;
    d0 |= uint32_t(ext5(a5)) << (8 * ch);
    d1 |= uint32_t(ext5(c5)) << (8 * ch);
    i0 |= uint32_t(ext4((w1 >> (15 + 4 * ch)) & 15)) << (8 * ch);
    i1 |= uint32_t(ext4((w2 >> (15 + 4 * ch)) & 15)) << (8 * ch);
  }
  b0 = diff ? d0 : i0;
  b1 = diff ? d1 : i1;
  return diff;
}

// The logical hi word of the candidate (w1, w2) of a flip under codewords
// cw0, cw1 (:485-541). Differential: base 555 at 27/19/11 and delta 333 at
// 24/16/8 (StoreDiffModeColors, :328-337); individual: 444 + 444 at
// 28/20/12 and 24/16/8 (StoreNormalModeColors, :316-324).
__device__ __forceinline__ uint32_t hi_word(bool flip, uint32_t w1, uint32_t w2,
                                            int cw0, int cw1) {
  uint32_t b0, b1;
  const bool diff = bases(w1, w2, b0, b1);
  constexpr int kS1[3] = {27, 19, 11};
  constexpr int kS2[3] = {24, 16, 8};
  constexpr int kT1[3] = {28, 20, 12};
  uint32_t h = (flip ? 1u : 0u) | (diff ? 2u : 0u);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const uint32_t a5 = (w1 >> (5 * ch)) & 31, c5 = (w2 >> (5 * ch)) & 31;
    h |= diff ? (a5 << kS1[ch]) | (((c5 - a5) & 7) << kS2[ch])
              : (((w1 >> (15 + 4 * ch)) & 15) << kT1[ch]) |
                    (((w2 >> (15 + 4 * ch)) & 15) << kS2[ch]);
  }
  return h | (uint32_t(cw0) << 5) | (uint32_t(cw1) << 2);
}

// The four candidate colours of base under modifiers (a, b), in codebook
// order [a, b, -a, -b], and their |c|^2.
__device__ __forceinline__ void colors(uint32_t base, int a, int b,
                                       uint32_t (&c)[4], int (&k)[4]) {
  // r and b as the 16-bit halves of one word, g of the +-a and +-b colours
  // as the halves of another: a DPX add-min (add-max) per word, then a
  // byte permute per colour.
  const uint32_t rb = base & 0xFF00FFu;
  const uint32_t gg = ((base >> 8) & 0xFFu) * 0x10001u;
  const uint32_t pa = uint32_t(a) * 0x10001u, pb = uint32_t(b) * 0x10001u;
  const uint32_t na = (0x10000u - uint32_t(a)) * 0x10001u;
  const uint32_t nb = (0x10000u - uint32_t(b)) * 0x10001u;
  const uint32_t g_p = __viaddmin_s16x2(gg, (pa & 0xFFFFu) | (pb & 0xFFFF0000u), 0xFF00FFu);
  const uint32_t g_m = __viaddmax_s16x2(gg, (na & 0xFFFFu) | (nb & 0xFFFF0000u), 0u);
  c[0] = __byte_perm(__viaddmin_s16x2(rb, pa, 0xFF00FFu), g_p, 0x1240);
  c[1] = __byte_perm(__viaddmin_s16x2(rb, pb, 0xFF00FFu), g_p, 0x1260);
  c[2] = __byte_perm(__viaddmax_s16x2(rb, na, 0u), g_m, 0x1240);
  c[3] = __byte_perm(__viaddmax_s16x2(rb, nb, 0u), g_m, 0x1260);
#pragma unroll
  for (int m = 0; m < 4; ++m) k[m] = dot(c[m], c[m]);
}

// |c|^2 - 2 c.p of pixel p against colour m.
__device__ __forceinline__ int partial(const uint32_t (&c)[4], const int (&k)[4],
                                       int m, uint32_t p) {
  return k[m] - 2 * dot(c[m], p);
}

// The error of the 8 pixels px of a subblock under base and modifiers
// (a, b), less their |p|^2 sum: per pixel the least |c|^2 - 2 c.p over the
// four colours.
__device__ __forceinline__ int sub_err(const uint32_t (&px)[8], uint32_t base,
                                       int a, int b) {
  uint32_t c[4];
  int k[4];
  colors(base, a, b, c, k);
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int e[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) e[m] = partial(c, k, m, px[j]);
    sum += min(min(e[0], e[1]), min(e[2], e[3]));
  }
  return sum;
}

// FindBestCodeword (etc_compressor.cc:391-409): the first of the 8
// codewords of least error for the subblock's pixels px under base (strict
// '<' in scan order). Returns its error less the |p|^2 sum.
__device__ __forceinline__ int sub_search(const uint32_t (&px)[8], uint32_t base,
                                          int& cw) {
  int best = 0;
#pragma unroll 1
  for (int c = 0; c < 8; ++c) {
    const int e = sub_err(px, base, c_cb[c][0], c_cb[c][1]);
    if (c == 0 || e < best) {
      best = e;
      cw = c;
    }
  }
  return best;
}

// The first modifier of least error for pixel p (StorePixelIndex's index,
// :150-156).
__device__ __forceinline__ uint32_t modifier(const uint32_t (&c)[4],
                                             const int (&k)[4], uint32_t p) {
  int e = partial(c, k, 0, p);
  uint32_t best = 0;
#pragma unroll
  for (int m = 1; m < 4; ++m) {
    const int em = partial(c, k, m, p);
    if (em < e) {
      e = em;
      best = m;
    }
  }
  return best;
}

// Subblock kS's 8 pixels of the 16 (row-major) under flip f: a renaming
// of registers when f is known at compile time, 8 selects when it is not.
template <int kS>
__device__ __forceinline__ void subblock(const uint32_t (&px)[16], bool f,
                                         uint32_t (&sub)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    sub[j] = f ? px[member<true>(kS, j)] : px[member<false>(kS, j)];
}

// The exact SMALLER_ERROR search of a flip for the candidate (w1, w2).
// Returns its error less the block's |p|^2 sum, and its codewords as
// cw0 | cw1 << 3.
template <bool kFlip>
__device__ __forceinline__ int flip_search(const uint32_t (&px)[16], uint32_t w1,
                                           uint32_t w2, int& cws) {
  uint32_t b0, b1, s0[8], s1[8];
  bases(w1, w2, b0, b1);
  subblock<0>(px, kFlip, s0);
  subblock<1>(px, kFlip, s1);
  int cw0 = 0, cw1 = 0;
  const int e = sub_search(s0, b0, cw0) + sub_search(s1, b1, cw1);
  cws = cw0 | (cw1 << 3);
  return e;
}

// A decoded block: base colors, the four codebook magnitudes of its two
// codewords, the flip and the index word (Etc1BlockDecoder,
// etc_compressor.cc:227-273).
struct EtcBlock {
  int c1[3], c2[3];
  int a0, b0, a1, b1;
  bool flip;
  uint32_t lo;
};

__device__ __forceinline__ EtcBlock unpack_block(uint2 stored) {
  const uint32_t hi = bswap(stored.x);
  EtcBlock blk;
  blk.lo = bswap(stored.y);
  blk.flip = hi & 1;
  const bool diff = (hi >> 1) & 1;
  const int cw0 = (hi >> 5) & 7, cw1 = (hi >> 2) & 7;
  blk.a0 = cb_a(cw0);
  blk.b0 = cb_b(cw0);
  blk.a1 = cb_a(cw1);
  blk.b1 = cb_b(cw1);
  constexpr int kS1[3] = {27, 19, 11};
  constexpr int kS2[3] = {24, 16, 8};
  constexpr int kT1[3] = {28, 20, 12};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    if (diff) {
      const int v = (hi >> kS1[ch]) & 31;
      blk.c1[ch] = ext5(v);
      blk.c2[ch] = ext5(v + sext3((hi >> kS2[ch]) & 7));
    } else {
      blk.c1[ch] = ext4((hi >> kT1[ch]) & 15);
      blk.c2[ch] = ext4((hi >> kS2[ch]) & 15);
    }
  }
  return blk;
}

// Pixel p (row-major) of a decoded block, each channel clamped to 0..255.
__device__ __forceinline__ void block_pixel(const EtcBlock& blk, int p, int& r,
                                            int& g, int& b) {
  const int x = p & 3, y = p >> 2;
  const bool first = blk.flip ? y < 2 : x < 2;
  const int e = etc_order(p);
  const uint32_t idx = ((blk.lo >> e) & 1u) | (((blk.lo >> (e + 16)) & 1u) << 1);
  const int mag = (idx & 1) ? (first ? blk.b0 : blk.b1) : (first ? blk.a0 : blk.a1);
  const int mod = idx >= 2 ? -mag : mag;
  r = clamp8((first ? blk.c1[0] : blk.c2[0]) + mod);
  g = clamp8((first ? blk.c1[1] : blk.c2[1]) + mod);
  b = clamp8((first ? blk.c1[2] : blk.c2[2]) + mod);
}

// The destination quadrant that one source block of a fused level makes:
// pixel j (row-major in the 2x2 quadrant) is the truncating average (>> 2
// on the non-negative sums, ComputeAveragePixel2x2) of the source pixels
// (2 (j / 2) + {0, 1}, 2 (j % 2) + {0, 1}), packed. The decode stays per
// channel in int: a malformed differential block's base leaves 0..255
// (ext5 of 34 is 272), where a byte-packed base would wrap.
__device__ __forceinline__ void quadrant(uint2 stored, uint32_t (&quad)[4]) {
  const EtcBlock blk = unpack_block(stored);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int r = 0, g = 0, b = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      int pr, pg, pb;
      block_pixel(blk, (2 * (j >> 1) + (d >> 1)) * 4 + 2 * (j & 1) + (d & 1), pr,
                  pg, pb);
      r += pr;
      g += pg;
      b += pb;
    }
    quad[j] = uint32_t(r >> 2) | (uint32_t(g >> 2) << 8) | (uint32_t(b >> 2) << 16);
  }
}

// ---------------------------------------------------------------------------
// The reference encode and the fused level: one thread per 4x4 block, its 16
// pixels packed in registers, row-major.
// ---------------------------------------------------------------------------

// The candidate word of a subblock: its truncating mean
// (ComputeAverageColor, :299-312), r and b summed as the 16-bit halves of
// one word.
__device__ __forceinline__ uint32_t mean_word(const uint32_t (&px)[8]) {
  uint32_t rb = 0, g = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    rb += px[t] & 0xFF00FFu;
    g += (px[t] >> 8) & 0xFFu;
  }
  return q_word(int(rb & 0xFFFFu) >> 3, int(g) >> 3, int(rb >> 16) >> 3);
}

// FindCodewordHeuristic (:415-455, called at :524-527): the codeword from
// the largest per-channel mean absolute deviation from the decoded base.
__device__ __forceinline__ int heuristic_codeword(const uint32_t (&px)[8],
                                                  uint32_t base) {
  uint32_t rb = 0, g = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const uint32_t d = __vabsdiffu4(base, px[t]);
    rb += d & 0xFF00FFu;
    g += (d >> 8) & 0xFFu;
  }
  const int dev = max(max(int(rb & 0xFFFFu) >> 3, int(g) >> 3), int(rb >> 16) >> 3);
  return (dev > 12) + (dev > 23) + (dev > 35) + (dev > 51) + (dev > 70) +
         (dev > 93) + (dev > 144);
}

// One channel's terms of the kHeuristic flip errors from its quadrant sums.
__device__ __forceinline__ void flip_terms(int s1, int s2, int s3, int s4,
                                           int& e_lr, int& e_tb) {
  const int lr = ((s1 + s2) >> 3) - ((s3 + s4) >> 3);
  const int tb = ((s1 + s3) >> 3) - ((s2 + s4) >> 3);
  e_lr += lr * lr;
  e_tb += tb * tb;
}

// The flip of kHeuristic (etc_compressor.cc:553-574): true for the
// top/bottom split. The quadrant sums s1 (top left), s2 (bottom left), s3
// (top right) and s4 (bottom right), r and b as 16-bit halves; s4 counts
// pixel (2,2) twice and omits (3,3), as the reference does (:563-564).
__device__ __forceinline__ bool heuristic_flip(const uint32_t (&px)[16]) {
  constexpr int kQuads[4][4] = {{0, 1, 4, 5}, {8, 9, 12, 13}, {2, 3, 6, 7},
                                {10, 11, 14, 10}};
  int r[4], g[4], b[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t rb = 0, gs = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rb += px[kQuads[q][i]] & 0xFF00FFu;
      gs += (px[kQuads[q][i]] >> 8) & 0xFFu;
    }
    r[q] = int(rb & 0xFFFFu);
    g[q] = int(gs);
    b[q] = int(rb >> 16);
  }
  int e_lr = 0, e_tb = 0;
  flip_terms(r[0], r[1], r[2], r[3], e_lr, e_tb);
  flip_terms(g[0], g[1], g[2], g[3], e_lr, e_tb);
  flip_terms(b[0], b[1], b[2], b[3], e_lr, e_tb);
  return !(e_lr > e_tb);
}

// The index word lo of flip f under bases b0, b1 and codewords cw0, cw1:
// per pixel the first modifier of least error; bit etc_order(p) holds its
// low bit and bit etc_order(p) + 16 its high bit (StorePixelIndex,
// :150-156).
__device__ __forceinline__ uint32_t index_word(const uint32_t (&px)[16], bool f,
                                               uint32_t b0, uint32_t b1,
                                               int cw0, int cw1) {
  uint32_t lo = 0;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    int a, b;
    cb_pair(s ? cw1 : cw0, a, b);
    uint32_t c[4];
    int k[4];
    colors(s ? b1 : b0, a, b, c, k);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pt = member<true>(s, j), pl = member<false>(s, j);
      const uint32_t m = modifier(c, k, f ? px[pt] : px[pl]);
      const int e = f ? etc_order(pt) : etc_order(pl);
      lo |= ((m & 1u) << e) | ((m >> 1) << (e + 16));
    }
  }
  return lo;
}

// The candidate words of flip f's two subblock means.
__device__ __forceinline__ void mean_words(const uint32_t (&px)[16], bool f,
                                           uint32_t& w1, uint32_t& w2) {
  uint32_t s0[8], s1[8];
  subblock<0>(px, f, s0);
  subblock<1>(px, f, s1);
  w1 = mean_word(s0);
  w2 = mean_word(s1);
}

// EncodeEtc1Block (etc_compressor.cc:545-586) with the reference's
// truncating quantization (FindBestSubblockEncoding, :460-542): per flip
// the subblock means' words, then the flip's search (flip_search, as in
// the HQ search) or the heuristic's codewords; then the index word of the
// chosen flip only. Returns the block's two words as stored: byte-swapped,
// so that a little-endian store writes big-endian hi then big-endian lo.
template <int kStrategy>
__device__ __forceinline__ uint2 encode_block(const uint32_t (&px)[16]) {
  bool f;
  uint32_t w1, w2, b0, b1;
  int cws = 0;
  if (kStrategy == kSmallerError) {
    uint32_t t1, t2;
    int t_cws;
    mean_words(px, false, w1, w2);
    mean_words(px, true, t1, t2);
    const int e_lr = flip_search<false>(px, w1, w2, cws);
    const int e_tb = flip_search<true>(px, t1, t2, t_cws);
    f = !(e_lr <= e_tb);  // lr wins ties (:583)
    if (f) {
      w1 = t1;
      w2 = t2;
      cws = t_cws;
    }
    bases(w1, w2, b0, b1);
  } else if (kStrategy == kHeuristic) {
    // The reference encodes both flips and keeps the heuristic's; only
    // that one is computed here.
    f = heuristic_flip(px);
    mean_words(px, f, w1, w2);
    bases(w1, w2, b0, b1);
    uint32_t s0[8], s1[8];
    subblock<0>(px, f, s0);
    subblock<1>(px, f, s1);
    cws = heuristic_codeword(s0, b0) | (heuristic_codeword(s1, b1) << 3);
  } else {
    constexpr bool kFlip = kStrategy == kSplitHorizontally;
    f = kFlip;
    mean_words(px, kFlip, w1, w2);
    flip_search<kFlip>(px, w1, w2, cws);
    bases(w1, w2, b0, b1);
  }
  const uint32_t lo = index_word(px, f, b0, b1, cws & 7, cws >> 3);
  return make_uint2(bswap(hi_word(f, w1, w2, cws & 7, cws >> 3)), bswap(lo));
}

// Replaces texcomp/ops/etc_pallas.py:_etc1_kernel, and with it the
// TPU-side edge pad, u32 pack, _PERM_F regrouping and block transposes of
// etc1_encode_padded_image.
//
// Reads an (h, w, channels) uint8 image as it arrives (channels 3, or 4 for
// the transcoder's RGBX) and writes (nbr * nbc, 8) uint8 blocks. Pixels
// outside the image replicate its edge by clamped coordinates. A thread
// indexes its subblocks' pixels directly, so _PERM_F goes.
//
// Bound on the H100: integer issue. A 4096^2 RGB image is 48 MiB in and
// 8 MiB out, 17.5 us at 3.35 TB/s, but SMALLER_ERROR scores 2 flips x 2
// subblocks x 8 codewords x 8 pixels x 4 colours, 1,024 (pixel, colour)
// pairs a block, and 64 more for the indices of the chosen flip. Packed, a
// pair is a __dp4a, a multiply-add and half a min (a 3-input min and a min
// per pixel); chip_smoke.py measures the rate of that inner loop on the
// card for the bound.
template <int kStrategy>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint8_t* __restrict__ img, int channels, int h, int w,
              int nbr, int nbc, uint8_t* __restrict__ out) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)nbr * nbc) return;
  const int by = int(n / nbc), bx = int(n % nbc);
  const long long stride = (long long)w * channels;

  uint32_t px[16];
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const uint8_t* row = img + min(4 * by + y, h - 1) * stride;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const uint8_t* p = row + (long long)min(4 * bx + x, w - 1) * channels;
      px[4 * y + x] = uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
    }
  }
  reinterpret_cast<uint2*>(out)[n] = encode_block<kStrategy>(px);
}

// Replaces texcomp/ops/etc_pallas.py:_etc1_decode_kernel, and with it
// blocks_to_words and _unblock_transpose_u32.
//
// Reads (nbr * nbc, 8) uint8 blocks and writes the (4 * nbr, 4 * nbc, 4)
// uint8 RGBX image with X = 0, one 16-byte store per block row.
//
// Bound on the H100: memory traffic. A 4096^2 decode reads 8 MiB and
// writes 64 MiB, 22.5 us at 3.35 TB/s; the per-block work is a few
// hundred integer operations.
__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint8_t* __restrict__ blocks, int nbr, int nbc,
              uint8_t* __restrict__ out) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)nbr * nbc) return;
  const int by = int(n / nbc), bx = int(n % nbc);
  const EtcBlock blk = unpack_block(reinterpret_cast<const uint2*>(blocks)[n]);

  uint4* dst = reinterpret_cast<uint4*>(out);
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    uint32_t px[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      int r, g, b;
      block_pixel(blk, 4 * y + x, r, g, b);
      px[x] = uint32_t(r) | (uint32_t(g) << 8) | (uint32_t(b) << 16);
    }
    dst[(4LL * by + y) * nbc + bx] = make_uint4(px[0], px[1], px[2], px[3]);
  }
}

// Replaces texcomp/ops/etc_pallas.py:_etc1_down_kernel, with its two
// bf16 one-hot matmuls (_avg_regroup, natural and _PERM_F order), which
// existed for the TPU layout.
//
// One fused mip level: destination block (dy, dx) of the (nby/2, nbx/2)
// grid comes from the four source blocks q = 2 qy + qx at rows 2dy + qy
// and columns 2dx + qx of the (nby * nbx, 8) payload. Each destination
// pixel's four source pixels lie in one source block, so source block q
// makes destination quadrant q (`quadrant`); then the encode of
// encode_kernel. Equal to decode -> 2x2 average -> encode.
//
// Bound on the H100: integer issue, as encode_kernel at a quarter of the
// blocks, plus the 64 source pixels a block decodes.
template <int kStrategy>
__global__ void __launch_bounds__(kThreads)
downsample_kernel(const uint8_t* __restrict__ src, int nby, int nbx,
                  uint8_t* __restrict__ out) {
  const int dnbx = nbx / 2;
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)(nby / 2) * dnbx) return;
  const int dy = int(n / dnbx), dx = int(n % dnbx);
  const uint2* words = reinterpret_cast<const uint2*>(src);

  uint32_t px[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t quad[4];
    quadrant(words[(2LL * dy + (q >> 1)) * nbx + 2 * dx + (q & 1)], quad);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      px[(2 * (q >> 1) + (j >> 1)) * 4 + 2 * (q & 1) + (j & 1)] = quad[j];
  }
  reinterpret_cast<uint2*>(out)[n] = encode_block<kStrategy>(px);
}

// ---------------------------------------------------------------------------
// The HQ search (quality="high").
//
// The searches of the packed section above; each step's |p|^2 sum is added
// once to the winner's error.
// ---------------------------------------------------------------------------

constexpr int kHqRefits = 2;
constexpr int kHqProbes = 24;
constexpr int kHqLanes = 8;                     // lanes per 4x4 block
constexpr int kHqBlocks = kThreads / kHqLanes;  // blocks per CTA
constexpr int kHqChunk = kHqLanes;              // candidates per staged chunk
static_assert(kHqProbes % kHqLanes == 0, "probes split evenly over lanes");

// Blinn's round-exact quantization of 0..255 to num_bits (color_util.h:
// 156-164).
__device__ __forceinline__ int quantize8(int v, int num_bits) {
  const int i = v * ((1 << num_bits) - 1) + 128;
  return (i + (i >> 8)) >> 8;
}

// Probe j of the +-1 neighbourhood of (w1, w2), in codecs/etc.
// _neighborhood_qs order: subblock, channel, -1 then +1, 555 then 444.
__device__ __forceinline__ void probe_words(uint32_t w1, uint32_t w2, int j,
                                            uint32_t& p1, uint32_t& p2) {
  const int sb = j / 12, ch = (j % 12) / 4;
  const int d = ((j % 4) / 2) == 0 ? -1 : 1;
  const bool q555 = (j % 2) == 0;
  const int sh = q555 ? 5 * ch : 15 + 4 * ch;
  const int top = q555 ? 31 : 15;
  const uint32_t w = sb == 0 ? w1 : w2;
  const int f = min(max(int((w >> sh) & uint32_t(top)) + d, 0), top);
  const uint32_t moved = (w & ~(uint32_t(top) << sh)) | (uint32_t(f) << sh);
  p1 = sb == 0 ? moved : w1;
  p2 = sb == 0 ? w2 : moved;
}

// Subblock kS's error under flip kFlip, base and modifiers (a, b), less its
// |p|^2 sum.
template <bool kFlip, int kS>
__device__ __forceinline__ int hq_sub_err(const uint32_t (&px)[16],
                                          uint32_t base, int a, int b) {
  uint32_t sub[8];
  subblock<kS>(px, kFlip, sub);
  return sub_err(sub, base, a, b);
}

// The lexicographic least (e, s) over the 8 lanes of a block, on every
// lane: with s the step, the first step of least error.
__device__ __forceinline__ void group_min(int& e, int& s) {
#pragma unroll
  for (int o = 1; o < kHqLanes; o <<= 1) {
    const int oe = __shfl_xor_sync(kFull, e, o);
    const int os = __shfl_xor_sync(kFull, s, o);
    if (oe < e || (oe == e && os < s)) {
      e = oe;
      s = os;
    }
  }
}

// The index word lo of the candidate (w1, w2) under codewords cws, on
// every lane of the block: lane l finds the first modifier of least error
// for its pixels 2l and 2l + 1 (row-major, `mine`), and the lanes OR
// their bits together (StorePixelIndex).
template <bool kFlip>
__device__ __forceinline__ uint32_t hq_lo(const uint32_t (&mine)[2], int l,
                                          uint32_t w1, uint32_t w2, int cws) {
  uint32_t b0, b1;
  bases(w1, w2, b0, b1);
  uint32_t lo = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = 2 * l + j;
    const bool first = kFlip ? p < 8 : (p & 3) < 2;
    const int cw = first ? cws & 7 : cws >> 3;
    uint32_t c[4];
    int k[4];
    colors(first ? b0 : b1, c_cb[cw][0], c_cb[cw][1], c, k);
    const uint32_t m = modifier(c, k, mine[j]);
    const int eo = etc_order(p);
    lo |= ((m & 1u) << eo) | ((m >> 1) << (eo + 16));
  }
#pragma unroll
  for (int o = 1; o < kHqLanes; o <<= 1) lo |= __shfl_xor_sync(kFull, lo, o);
  return lo;
}

// The least-squares bases of subblock s for the modifiers that codeword cw
// and the index word lo give its pixels: per channel the mean of pixel -
// modifier, rounded half to even (s * 0.125 is exact) and clamped, then
// quantized to 555 and 444 and packed (codecs/etc._refit_bases).
template <bool kFlip, int kS>
__device__ __forceinline__ uint32_t hq_refit_word(const uint32_t (&px)[16],
                                                  int cw, uint32_t lo) {
  const int a = c_cb[cw][0], b = c_cb[cw][1];
  int sum[3] = {0, 0, 0}, msum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = member<kFlip>(kS, j);
    const int e = etc_order(p);
    const uint32_t idx = ((lo >> e) & 1u) | (((lo >> (e + 16)) & 1u) << 1);
    const int mag = (idx & 1) ? b : a;
    msum += idx >= 2 ? -mag : mag;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) sum[ch] += (px[p] >> (8 * ch)) & 255;
  }
  uint32_t w = 0;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int v = clamp8(__float2int_rn(float(sum[ch] - msum) * 0.125f));
    w |= (uint32_t(quantize8(v, 5)) << (5 * ch)) |
         (uint32_t(quantize8(v, 4)) << (15 + 4 * ch));
  }
  return w;
}

// Issues the cp.async copies of candidate chunk `chunk` of the CTA's
// blocks into dst ([subblock][block][candidate]): 2 x 32 words of each
// candidate, coalesced 128-byte rows of the (k, 2, n) array. Words past
// the last candidate or block are zero-filled.
__device__ __forceinline__ void hq_stage(
    uint32_t (&dst)[2][kHqBlocks][kHqChunk], const uint32_t* cands, int n,
    int k_cands, long long block0, int chunk) {
  for (int e = threadIdx.x; e < 2 * kHqBlocks * kHqChunk; e += kThreads) {
    const int kl = e / (2 * kHqBlocks), s = (e / kHqBlocks) % 2;
    const int b = e % kHqBlocks;
    const int k = chunk * kHqChunk + kl;
    const bool ok = k < k_cands && block0 + b < n;
    const uint32_t* src = ok ? cands + (2LL * k + s) * n + block0 + b : cands;
    const uint32_t saddr =
        static_cast<uint32_t>(__cvta_generic_to_shared(&dst[s][b][kl]));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

// ---------------------------------------------------------------------------
// The HQ candidate fit: the 40 candidates of one flip
// (codecs/etc._hq_base_candidates, in its order, which is the tie-break
// order), computed inside the search launch (hq_search_kernel<kFlip, true>).
//
// The twin computes them in float32, op by op. Here every float step is
// __fadd_rn / __fsub_rn / __fmul_rn, so that nvcc contracts nothing into
// a fused multiply-add, and torch.round is __float2int_rn (half to even).
// Most values of the fit are multiples of 1/8 far inside float32's 24
// bits, exact in any order; the alternating fit's 16-pixel error sum and
// the re-solves' penalised errors are not, and keep the twin's order.
// Lane l of a block takes codeword l in both cluster fits; the lanes'
// results merge by shuffles on lexicographic (error, index), which is the
// twin's first-occurrence argmin and its strict '<' best and runner-up.
// ---------------------------------------------------------------------------

constexpr int kHqCands = 40;     // candidates a flip
constexpr int kHqCuts = 165;     // cuts of a subblock's 8 sorted pixels
static_assert(sizeof(kHqMu) == sizeof(float) * kHqCuts * 8 &&
                  sizeof(kHqConst) == sizeof(kHqMu),
              "one (cut, codeword) entry each");
constexpr int kHqFitIters = 2;   // alternating rounds before the error
constexpr int kHqNone = 0x7FFFFFFF;
// Resident CTAs per SM the fit variant is built for. On the H100, a flip
// of a 1024^2 image: at 1 it took 241 registers and 1.45 ms; capped for
// 3, 80 registers and 1.15 ms.
constexpr int kHqFitCtas = 3;

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float clamp255f(float v) {
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

__device__ __forceinline__ int channel(uint32_t p, int ch) {
  return int((p >> (8 * ch)) & 255u);
}

// A subblock's quantized bases as its packed candidate word
// (codecs/etc.pack_q_word).
__device__ __forceinline__ uint32_t pack_q(const int (&q555)[3],
                                           const int (&q444)[3]) {
  return uint32_t(q555[0]) | (uint32_t(q555[1]) << 5) |
         (uint32_t(q555[2]) << 10) | (uint32_t(q444[0]) << 15) |
         (uint32_t(q444[1]) << 19) | (uint32_t(q444[2]) << 23);
}

// Real-valued bases, rounded half to even and quantized to 555 and 444
// (codecs/etc._quantize_pair, one subblock).
__device__ __forceinline__ void quantize_real(const float (&b)[3],
                                              int (&q555)[3], int (&q444)[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int r = __float2int_rn(b[ch]);
    q555[ch] = quantize8(r, 5);
    q444[ch] = quantize8(r, 4);
  }
}

__device__ __forceinline__ bool lex_less(float e, int k, float f, int j) {
  return e < f || (e == f && k < j);
}

// The least (e, k) of the 8 lanes of a block, on every lane.
__device__ __forceinline__ void group_min_f(float& e, int& k) {
#pragma unroll
  for (int o = 1; o < kHqLanes; o <<= 1) {
    const float oe = __shfl_xor_sync(kFull, e, o);
    const int ok = __shfl_xor_sync(kFull, k, o);
    if (lex_less(oe, ok, e, k)) {
      e = oe;
      k = ok;
    }
  }
}

// The least and second-least (e, k) of the 8 lanes' own two (each lane's
// pair ordered, the k of different lanes distinct), on every lane.
__device__ __forceinline__ void group_top2(float& e1, int& k1, float& e2,
                                           int& k2) {
#pragma unroll
  for (int o = 1; o < kHqLanes; o <<= 1) {
    const float f1 = __shfl_xor_sync(kFull, e1, o);
    const float f2 = __shfl_xor_sync(kFull, e2, o);
    const int j1 = __shfl_xor_sync(kFull, k1, o);
    const int j2 = __shfl_xor_sync(kFull, k2, o);
    if (lex_less(f1, j1, e1, k1)) {
      if (!lex_less(e1, k1, f2, j2)) {
        e1 = f2;
        k1 = j2;
      }
      e2 = e1;
      k2 = k1;
      e1 = f1;
      k1 = j1;
    } else if (lex_less(f1, j1, e2, k2)) {
      e2 = f1;
      k2 = j1;
    }
  }
}

// Subblock kS's channel sums under flip kFlip.
template <bool kFlip, int kS>
__device__ __forceinline__ void sub_sums(const uint32_t (&px)[16], int (&sum)[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    sum[ch] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum[ch] += channel(px[member<kFlip>(kS, j)], ch);
  }
}

__device__ __forceinline__ void sort_pair(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// The exhaustive fit's inputs of subblock kS (codecs/etc.
// _cluster_fit_enum_bases' subblock): its channel means, and the prefix
// sums T[0..8] of its 8 centred luminances in ascending order (Batcher's
// 19-comparator network).
template <bool kFlip, int kS>
__device__ __forceinline__ void enum_inputs(const uint32_t (&px)[16],
                                            const int (&sum)[3], float (&mean)[3],
                                            float (&cum)[9]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) mean[ch] = fmul(float(sum[ch]), 0.125f);
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t p = px[member<kFlip>(kS, j)];
    t[j] = fadd(fadd(fsub(float(channel(p, 0)), mean[0]),
                     fsub(float(channel(p, 1)), mean[1])),
                fsub(float(channel(p, 2)), mean[2]));
  }
  constexpr int kNet[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3},
                               {4, 6}, {5, 7}, {1, 2}, {5, 6}, {0, 4}, {1, 5},
                               {2, 6}, {3, 7}, {2, 4}, {3, 5}, {1, 2}, {3, 4},
                               {5, 6}};
#pragma unroll
  for (int c = 0; c < 19; ++c) sort_pair(t[kNet[c][0]], t[kNet[c][1]]);
  cum[0] = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) cum[j + 1] = fadd(cum[j], t[j]);
}

// The closed-form error of cut (p1, p2, p3) under the codeword whose
// coefficients are c13 = a - b and c2 = -2a and whose constant is konst:
// const - 2 ((T[p1] + T[p3]) c13 + T[p2] c2).
__device__ __forceinline__ float enum_err(const float* cum, int p1, int p2,
                                          int p3, float c13, float c2,
                                          float konst) {
  const float tm = fadd(fmul(fadd(cum[p1], cum[p3]), c13), fmul(cum[p2], c2));
  return fsub(konst, fmul(2.0f, tm));
}

// The cut after (p1, p2, p3) in the nesting 0 <= p1 <= p2 <= p3 <= 8.
__device__ __forceinline__ void next_cut(int& p1, int& p2, int& p3) {
  if (p3 < 8) {
    ++p3;
  } else if (p2 < 8) {
    p3 = ++p2;
  } else {
    p3 = p2 = ++p1;
  }
}

// Lane cw's two least (error, 8 cut + cw) over a subblock's 165 cuts, in
// cut order by strict '<'. cum is the subblock's T[0..8] in shared memory.
__device__ __forceinline__ void enum_top2(const float* cum, int cw, float c13,
                                          float c2, const float* konst,
                                          float& e1, int& k1, float& e2,
                                          int& k2) {
  e1 = e2 = INFINITY;
  k1 = k2 = kHqNone;
  int p1 = 0, p2 = 0, p3 = 0;
#pragma unroll 3
  for (int k = cw; k < 8 * kHqCuts; k += 8, next_cut(p1, p2, p3)) {
    const float e = enum_err(cum, p1, p2, p3, c13, c2, konst[k]);
    if (e < e1) {
      e2 = e1;
      k2 = k1;
      e1 = e;
      k1 = k;
    } else if (e < e2) {
      e2 = e;
      k2 = k;
    }
  }
}

// A subblock's re-solve with its base held, per channel, to the 555
// window [lo_c, hi_c] that the other subblock's winner `other` allows
// (offsets lo_off, hi_off): the least error + 8 * penalty over all cuts
// and codewords, the penalty the squared distance of each channel's
// optimal base from [8 lo_c, 8 hi_c + 7]; then that base clamped into the
// window and quantized, its 555 code clamped to [lo_c, hi_c] too
// (codecs/etc._cluster_fit_enum_bases' constrained). Returns its word.
__device__ __forceinline__ uint32_t enum_constrained(
    const float* cum, const float (&mean)[3], int cw, float c13, float c2,
    const float* mu, const float* konst, const int (&other)[3], int lo_off,
    int hi_off) {
  int lo_c[3], hi_c[3];
  float lo_v[3], hi_v[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    lo_c[ch] = min(max(other[ch] + lo_off, 0), 31);
    hi_c[ch] = min(max(other[ch] + hi_off, 0), 31);
    lo_v[ch] = float(lo_c[ch] * 8);
    hi_v[ch] = float(hi_c[ch] * 8 + 7);
  }
  float best = INFINITY;
  int k = kHqNone;
  int p1 = 0, p2 = 0, p3 = 0;
#pragma unroll 3
  for (int kc = cw; kc < 8 * kHqCuts; kc += 8, next_cut(p1, p2, p3)) {
    const float m = mu[kc];
    float pen = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float b_opt = fsub(mean[ch], m);
      const float d = fadd(fmaxf(fsub(lo_v[ch], b_opt), 0.0f),
                           fmaxf(fsub(b_opt, hi_v[ch]), 0.0f));
      pen = ch == 0 ? fmul(d, d) : fadd(pen, fmul(d, d));
    }
    const float e = fadd(enum_err(cum, p1, p2, p3, c13, c2, konst[kc]),
                         fmul(8.0f, pen));
    if (e < best) {
      best = e;
      k = kc;
    }
  }
  group_min_f(best, k);
  int q555[3], q444[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float b = fminf(fmaxf(fsub(mean[ch], mu[k]), lo_v[ch]), hi_v[ch]);
    const int r = __float2int_rn(b);
    q555[ch] = min(max(quantize8(r, 5), lo_c[ch]), hi_c[ch]);
    q444[ch] = quantize8(r, 4);
  }
  return pack_q(q555, q444);
}

// The squared error of pixel p against base + m, each channel clamped to
// 0..255 (exact: multiples of 1/64 below 2^18).
__device__ __forceinline__ float mod_err(uint32_t p, const float (&base)[3],
                                         float m) {
  float e = 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float d = fsub(clamp255f(fadd(base[ch], m)), float(channel(p, ch)));
    e = ch == 0 ? fmul(d, d) : fadd(e, fmul(d, d));
  }
  return e;
}

// The luminance-split seed of subblock kS (codecs/etc._cluster_fit_bases'
// split_seed): the midpoint of the means of its pixels at or above its mean
// luminance and of the rest, rounded half up to eighths, in integers.
template <bool kFlip, int kS>
__device__ __forceinline__ void split_seed(const uint32_t (&px)[16],
                                           const int (&sum)[3], float (&seed)[3]) {
  int lum[8], slum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t p = px[member<kFlip>(kS, j)];
    lum[j] = channel(p, 0) + channel(p, 1) + channel(p, 2);
    slum += lum[j];
  }
  int n_hi = 0, s_hi[3] = {0, 0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool hi = 8 * lum[j] >= slum;
    n_hi += hi;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      s_hi[ch] += hi ? channel(px[member<kFlip>(kS, j)], ch) : 0;
  }
  const int hi_n = max(n_hi, 1), lo_n = max(8 - n_hi, 1);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int a = 8 * (s_hi[ch] * lo_n + (sum[ch] - s_hi[ch]) * hi_n);
    const int b = 2 * hi_n * lo_n;
    seed[ch] = fmul(float((2 * a + b) / (2 * b)), 0.125f);
  }
}

// One codeword's alternating fit from the bases b (codecs/etc.
// _cluster_fit_bases), updated in place: kHqFitIters rounds of each
// pixel's first least-error modifier of mods (a, b, -a, -b) against the
// real bases, then the bases that least squares gives those modifiers
// (the subblock mean of pixel - modifier, clamped); returns the error of
// the last bases, each pixel's least over the modifiers, summed in
// _sum16_lanes' order.
template <bool kFlip>
__device__ __forceinline__ float alt_fit(const uint32_t (&px)[16],
                                         const int (&mods)[4], float (&b)[2][3]) {
  float mf[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) mf[m] = float(mods[m]);
#pragma unroll 1
  for (int it = 0; it < kHqFitIters; ++it) {
    int rsum[2][3] = {{0, 0, 0}, {0, 0, 0}};
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int s = (kFlip ? p < 8 : (p & 3) < 2) ? 0 : 1;
      float e = mod_err(px[p], b[s], mf[0]);
      int mod = mods[0];
#pragma unroll
      for (int m = 1; m < 4; ++m) {
        const float em = mod_err(px[p], b[s], mf[m]);
        if (em < e) {
          e = em;
          mod = mods[m];
        }
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) rsum[s][ch] += channel(px[p], ch) - mod;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        b[s][ch] = clamp255f(fmul(float(rsum[s][ch]), 0.125f));
  }
  float e[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int s = (kFlip ? p < 8 : (p & 3) < 2) ? 0 : 1;
    e[p] = mod_err(px[p], b[s], mf[0]);
#pragma unroll
    for (int m = 1; m < 4; ++m) e[p] = fminf(e[p], mod_err(px[p], b[s], mf[m]));
  }
#pragma unroll
  for (int w = 8; w >= 1; w >>= 1)
#pragma unroll
    for (int k = 0; k < w; ++k) e[k] = fadd(e[k], e[k + w]);
  return e[0];
}

// The 40 candidate word pairs of the block into w1s[k], w2s[k], in
// codecs/etc._hq_base_candidates' order. Every lane of the block computes
// the same words (lane l takes codeword l in the cluster fits and the
// merges give every lane their result); lane 0 stores them, but the
// probes, which lane l stores for j = l (mod 8). mu and konst are the
// exhaustive fit's tables (kHqMu, kHqConst) in shared memory; cums takes
// the block's two subblocks' prefix sums T (2 x 9 floats of shared
// memory), which the cut loops read at indices that vary with the cut.
template <bool kFlip>
__device__ __forceinline__ void hq_fit(const uint32_t (&px)[16], int l,
                                       const float* mu, const float* konst,
                                       float* cums, uint32_t* w1s,
                                       uint32_t* w2s) {
  const bool store = l == 0;
  auto put = [&](int k, uint32_t w1, uint32_t w2) {
    if (store) {
      w1s[k] = w1;
      w2s[k] = w2;
    }
  };
  int sum[2][3];
  sub_sums<kFlip, 0>(px, sum[0]);
  sub_sums<kFlip, 1>(px, sum[1]);

  // 0-27: the truncated and the rounded subblock averages, the rounded
  // pair with either 555 code clamped into the other's differential
  // window, and the 24 probes around the rounded pair.
  int r555[2][3], r444[2][3];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      r555[s][ch] = quantize8(sum[s][ch] >> 3, 5);
      r444[s][ch] = quantize8(sum[s][ch] >> 3, 4);
    }
  put(0, q_word(sum[0][0] >> 3, sum[0][1] >> 3, sum[0][2] >> 3),
      q_word(sum[1][0] >> 3, sum[1][1] >> 3, sum[1][2] >> 3));
  const uint32_t r1 = pack_q(r555[0], r444[0]), r2 = pack_q(r555[1], r444[1]);
  put(1, r1, r2);
  int c555[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    c555[ch] = min(max(r555[1][ch], r555[0][ch] - 4), r555[0][ch] + 3);
  put(2, r1, pack_q(c555, r444[1]));
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    c555[ch] = min(max(r555[0][ch], r555[1][ch] - 3), r555[1][ch] + 4);
  put(3, pack_q(c555, r444[0]), r2);
#pragma unroll
  for (int j = l; j < kHqProbes; j += kHqLanes) {
    uint32_t p1, p2;
    probe_words(r1, r2, j, p1, p2);
    w1s[4 + j] = p1;
    w2s[4 + j] = p2;
  }

  // 34-39: the exhaustive fit (lane = codeword), its top 2, the two
  // re-solves with the other subblock's winner fixed, and the winner with
  // either 555 code clamped into the other's window.
  int a, b;
  cb_pair(l, a, b);
  const float c13 = kHqCoef13[l], c2 = kHqCoef2[l];
  float mean[2][3], cum[2][9];
  enum_inputs<kFlip, 0>(px, sum[0], mean[0], cum[0]);
  enum_inputs<kFlip, 1>(px, sum[1], mean[1], cum[1]);
  if (store) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < 9; ++j) cums[9 * s + j] = cum[s][j];
  }
  __syncwarp();
  float win[2][3];
  int w555[2][3], w444[2][3];
  uint32_t ww[2], ws[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float e1, e2;
    int k1, k2;
    enum_top2(cums + 9 * s, l, c13, c2, konst, e1, k1, e2, k2);
    group_top2(e1, k1, e2, k2);
    float sec[3];
    int s555[3], s444[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      win[s][ch] = clamp255f(fsub(mean[s][ch], mu[k1]));
      sec[ch] = clamp255f(fsub(mean[s][ch], mu[k2]));
    }
    quantize_real(win[s], w555[s], w444[s]);
    quantize_real(sec, s555, s444);
    ww[s] = pack_q(w555[s], w444[s]);
    ws[s] = pack_q(s555, s444);
  }
  put(34, ww[0], ww[1]);
  put(35, ws[0], ws[1]);
  put(36, ww[0], enum_constrained(cums + 9, mean[1], l, c13, c2, mu, konst,
                                  w555[0], -4, 3));
  put(37, enum_constrained(cums, mean[0], l, c13, c2, mu, konst, w555[1], -3,
                           4),
      ww[1]);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    c555[ch] = min(max(w555[1][ch], w555[0][ch] - 4), w555[0][ch] + 3);
  put(38, ww[0], pack_q(c555, w444[1]));
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    c555[ch] = min(max(w555[0][ch], w555[1][ch] - 3), w555[1][ch] + 4);
  put(39, pack_q(c555, w444[0]), ww[1]);

  // 28-33: the alternating fit (lane = codeword) from three seeds, the
  // subblock means, the luminance split and the exhaustive winner's real
  // bases; per seed the best and the runner-up codeword's bases.
  float split[2][3];
  split_seed<kFlip, 0>(px, sum[0], split[0]);
  split_seed<kFlip, 1>(px, sum[1], split[1]);
  const int mods[4] = {a, b, -a, -b};
  const int lane0 = threadIdx.x & 31 & ~(kHqLanes - 1);
#pragma unroll 1
  for (int seed = 0; seed < 3; ++seed) {
    float bs[2][3];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        bs[s][ch] = seed == 0 ? mean[s][ch] : seed == 1 ? split[s][ch] : win[s][ch];
    float e1 = alt_fit<kFlip>(px, mods, bs), e2 = INFINITY;
    int k1 = l, k2 = kHqNone;
    group_top2(e1, k1, e2, k2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int src = lane0 | (r == 0 ? k1 : k2);
      uint32_t w[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float q[3];
        int q555[3], q444[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) q[ch] = __shfl_sync(kFull, bs[s][ch], src);
        quantize_real(q, q555, q444);
        w[s] = pack_q(q555, q444);
      }
      put(28 + 2 * seed + r, w[0], w[1]);
    }
  }
}

// Replaces texcomp/ops/etc_pallas.py:_etc1_hq_kernel (one flip per launch,
// as there).
//
// Reads (n, 16) int32 packed pixels (r | g << 8 | b << 16, row-major) and
// (k, 2, n) packed candidate words, and writes (3, n) int32: the logical hi
// and lo words and the error of the first step of least error, in step
// order: the k candidates, refit 0 from the winner so far, refit 1 from
// refit 0's own words (whether or not they won), and the 24 probes around
// refit 1's bases. Each step is the exact SMALLER_ERROR search of one flip
// (flip_search), so the error is an exact int32.
//
// Layout: 8 lanes per block, 32 blocks per 256-thread CTA. Only the two
// refits chain; the rest is split over the lanes:
//   - candidates: lane l takes k = l (mod 8) in order, each chunk of 8
//     staged in shared memory by cp.async, double-buffered so that the
//     next chunk loads during this one's search;
//   - each refit: lane l scores codeword l in both subblocks, and a
//     first-occurrence argmin over (error, codeword) per subblock follows;
//   - probes: lane l takes probes l, l + 8, l + 16.
// Each lane keeps its first best (error, step) by strict '<'; the
// lexicographic least over the lanes is the serial search's first best.
// The critical path is 5 + 3 steps (k = 40) and two eighths of a step for
// the refits, not 66 steps.
//
// Bound on the H100: integer issue. Each step is a flip's exhaustive
// search, 2 subblocks x 8 codewords x 8 pixels x 4 colours, 512 (pixel,
// colour) pairs; chip_smoke.py measures the rate of that inner loop on the
// card for the bound.
//
// With kFit the kernel takes no candidates (cands is null, k_cands is
// kHqCands): the block's 8 lanes fit its 40 (hq_fit) into shared memory,
// in place of the staging, and lane l searches k = l (mod 8) from there.
// The candidates never leave the SM; the fit is float and integer issue,
// some 20-25 thousand instructions a lane, so this variant is built for
// kHqFitCtas CTAs per SM. A minimum of 0 leaves the other as it was built
// without one (a minimum of 1 let it take 96 registers, not 74).
template <bool kFlip, bool kFit>
__global__ void __launch_bounds__(kThreads, kFit ? kHqFitCtas : 0)
hq_search_kernel(const int32_t* __restrict__ pixels, int n,
                 const uint32_t* __restrict__ cands, int k_cands,
                 int32_t* __restrict__ out) {
  const int g = threadIdx.x / kHqLanes, l = threadIdx.x % kHqLanes;
  const long long block0 = (long long)blockIdx.x * kHqBlocks;
  const long long i = block0 + g;
  const bool valid = i < n;

  // All 16 pixels, and this lane's two (2l and 2l + 1) for the index
  // words.
  uint32_t px[16], mine[2];
  int psum = 0;  // the block's |p|^2 sum
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    px[p] = valid ? uint32_t(pixels[16 * i + p]) & 0xFFFFFFu : 0u;
    psum += dot(px[p], px[p]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    mine[j] = valid ? uint32_t(pixels[16 * i + 2 * l + j]) & 0xFFFFFFu : 0u;

  // This lane's first best step: its error (less psum), step, words and
  // codewords. 16 * 3 * 255^2 < 2^24: the first step always wins.
  int best = 0x7FFFFFFF, best_step = 0x7FFFFFFF, best_cws = 0;
  uint32_t best_w1 = 0, best_w2 = 0;
  auto consider = [&](int e, int step, uint32_t w1, uint32_t w2, int cws) {
    if (e < best) {
      best = e;
      best_step = step;
      best_w1 = w1;
      best_w2 = w2;
      best_cws = cws;
    }
  };
  // The winner of the block so far, on every lane.
  auto winner = [&](uint32_t& w1, uint32_t& w2, int& cws) {
    int e = best, s = best_step;
    group_min(e, s);
    const int owner = s < k_cands ? s % kHqLanes
                      : s < k_cands + kHqRefits ? 0
                                                : (s - k_cands - kHqRefits) % kHqLanes;
    const int src = (threadIdx.x & 31 & ~(kHqLanes - 1)) | owner;
    w1 = __shfl_sync(kFull, best_w1, src);
    w2 = __shfl_sync(kFull, best_w2, src);
    cws = __shfl_sync(kFull, best_cws, src);
    return e;
  };

  // Candidates.
  if constexpr (kFit) {
    __shared__ float tables[2][kHqCuts * 8];
    __shared__ float cums[kHqBlocks][2 * 9];
    __shared__ uint32_t fit[2][kHqBlocks][kHqCands];
    for (int e = threadIdx.x; e < kHqCuts * 8; e += kThreads) {
      tables[0][e] = kHqMu[e];
      tables[1][e] = kHqConst[e];
    }
    __syncthreads();
    hq_fit<kFlip>(px, l, tables[0], tables[1], cums[g], fit[0][g], fit[1][g]);
    __syncwarp();
#pragma unroll 1
    for (int k = l; k < kHqCands; k += kHqLanes) {
      const uint32_t w1 = fit[0][g][k], w2 = fit[1][g][k];
      int cws;
      const int e = flip_search<kFlip>(px, w1, w2, cws);
      consider(e, k, w1, w2, cws);
    }
  } else {
    __shared__ uint32_t stage[2][2][kHqBlocks][kHqChunk];
    const int n_chunks = (k_cands + kHqChunk - 1) / kHqChunk;
    if (n_chunks > 0) hq_stage(stage[0], cands, n, k_cands, block0, 0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks)
        hq_stage(stage[(c + 1) & 1], cands, n, k_cands, block0, c + 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      const int k = c * kHqChunk + l;
      if (k < k_cands) {
        const uint32_t w1 = stage[c & 1][0][g][l], w2 = stage[c & 1][1][g][l];
        int cws;
        const int e = flip_search<kFlip>(px, w1, w2, cws);
        consider(e, k, w1, w2, cws);
      }
      __syncthreads();
    }
  }

  // Refits: refit 0 from the winner so far (the all-zero words when there
  // was no candidate), refit 1 from refit 0's own words.
  uint32_t w1, w2;
  int cws;
  const bool any = winner(w1, w2, cws) != 0x7FFFFFFF;
  uint32_t lo = hq_lo<kFlip>(mine, l, w1, w2, cws);
  if (!any) {
    cws = 0;
    lo = 0;
  }
  for (int r = 0; r < kHqRefits; ++r) {
    w1 = hq_refit_word<kFlip, 0>(px, cws & 7, lo);
    w2 = hq_refit_word<kFlip, 1>(px, cws >> 3, lo);
    uint32_t b0, b1;
    bases(w1, w2, b0, b1);
    int e0 = hq_sub_err<kFlip, 0>(px, b0, c_cb[l][0], c_cb[l][1]);
    int e1 = hq_sub_err<kFlip, 1>(px, b1, c_cb[l][0], c_cb[l][1]);
    int cw0 = l, cw1 = l;
    group_min(e0, cw0);
    group_min(e1, cw1);
    cws = cw0 | (cw1 << 3);
    consider(e0 + e1, k_cands + r, w1, w2, cws);
    if (r + 1 < kHqRefits) lo = hq_lo<kFlip>(mine, l, w1, w2, cws);
  }

  // Probes around refit 1's bases (w1, w2).
#pragma unroll 1
  for (int j = l; j < kHqProbes; j += kHqLanes) {
    uint32_t p1, p2;
    probe_words(w1, w2, j, p1, p2);
    int pcws;
    const int e = flip_search<kFlip>(px, p1, p2, pcws);
    consider(e, k_cands + kHqRefits + j, p1, p2, pcws);
  }

  const int e = winner(w1, w2, cws);
  const uint32_t hi = hi_word(kFlip, w1, w2, cws & 7, cws >> 3);
  lo = hq_lo<kFlip>(mine, l, w1, w2, cws);
  if (valid && l == 0) {
    out[i] = int32_t(hi);
    out[n + i] = int32_t(lo);
    out[2LL * n + i] = e + psum;
  }
}

// ---------------------------------------------------------------------------
// Rate micro-kernels, for the operation bound of the packed kernels. Each
// thread runs, from registers only, either kRateChains independent chains
// of instructions (kind 0: __dp4a; 1: integer multiply-add; 2: a min and a
// max; 4: __dp4a and multiply-add on alternate chains; 5: __dp4a and
// min + max on alternate chains) or the packed search's inner loop (kind
// 3: sub_err, one codeword's 4 colours against 8 pixels, 32 (pixel,
// colour) pairs a call), so that the card's pipes, not memory, bound the
// time. Kinds 4 and 5 show which instructions share a pipe. The result is
// stored so that nothing is dead.
// ---------------------------------------------------------------------------

constexpr int kRateChains = 8;
constexpr int kRateUnroll = 16;

template <int kKind>
__global__ void __launch_bounds__(kThreads)
rate_kernel(uint32_t seed, int iters, uint32_t* __restrict__ out) {
  uint32_t x[kRateChains];
#pragma unroll
  for (int i = 0; i < kRateChains; ++i)
    x[i] = (seed * (threadIdx.x + 1) + 0x9E3779B9u * i) & 0xFFFFFFu;
  const uint32_t y = seed ^ 0x5A5A5Au, z = seed + 0x10101u;
  uint32_t base = seed & 0xFFFFFFu;
  int acc = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kRateUnroll; ++u) {
      if (kKind == 3) {
        acc += sub_err(x, base, c_cb[u & 7][0], c_cb[u & 7][1]);
        base = (base + 0x030507u) & 0xFFFFFFu;
      } else {
#pragma unroll
        for (int i = 0; i < kRateChains; ++i) {
          const int kind = kKind == 4 ? (i & 1) : kKind == 5 ? 2 * (i & 1) : kKind;
          if (kind == 0)
            asm volatile("dp4a.u32.u32 %0, %0, %1, %2;" : "+r"(x[i]) : "r"(y), "r"(z));
          else if (kind == 1)
            asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x[i]) : "r"(y), "r"(z));
          else
            asm volatile("min.s32 %0, %0, %1;\n\tmax.s32 %0, %0, %2;"
                         : "+r"(x[i]) : "r"(y), "r"(z));
        }
      }
    }
  }
  uint32_t r = uint32_t(acc);
#pragma unroll
  for (int i = 0; i < kRateChains; ++i) r ^= x[i];
  out[blockIdx.x * (long long)blockDim.x + threadIdx.x] = r;
}

inline int grid_for(long long n) { return int((n + kThreads - 1) / kThreads); }

template <int kStrategy>
void launch_encode(const void* img, int channels, int h, int w, int nbr,
                   int nbc, void* out, cudaStream_t stream) {
  encode_kernel<kStrategy><<<grid_for((long long)nbr * nbc), kThreads, 0,
                             stream>>>(static_cast<const uint8_t*>(img),
                                       channels, h, w, nbr, nbc,
                                       static_cast<uint8_t*>(out));
}

template <int kStrategy>
void launch_downsample(const void* src, int nby, int nbx, void* out,
                       cudaStream_t stream) {
  downsample_kernel<kStrategy><<<grid_for((long long)(nby / 2) * (nbx / 2)),
                                 kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(src), nby, nbx, static_cast<uint8_t*>(out));
}

// The encode kernel of a strategy, or with `fused` its fused level's.
template <int kStrategy>
const void* strategy_kernel(bool fused) {
  return fused ? reinterpret_cast<const void*>(downsample_kernel<kStrategy>)
               : reinterpret_cast<const void*>(encode_kernel<kStrategy>);
}

const void* strategy_kernel(int strategy, bool fused) {
  switch (strategy) {
    case kSplitHorizontally: return strategy_kernel<kSplitHorizontally>(fused);
    case kSplitVertically: return strategy_kernel<kSplitVertically>(fused);
    case kSmallerError: return strategy_kernel<kSmallerError>(fused);
    case kHeuristic: return strategy_kernel<kHeuristic>(fused);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

int texcomp_etc1_encode(const void* img, int channels, int h, int w, int nbr,
                        int nbc, void* out, int strategy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (strategy) {
    case kSplitHorizontally:
      launch_encode<kSplitHorizontally>(img, channels, h, w, nbr, nbc, out, s);
      break;
    case kSplitVertically:
      launch_encode<kSplitVertically>(img, channels, h, w, nbr, nbc, out, s);
      break;
    case kSmallerError:
      launch_encode<kSmallerError>(img, channels, h, w, nbr, nbc, out, s);
      break;
    case kHeuristic:
      launch_encode<kHeuristic>(img, channels, h, w, nbr, nbc, out, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int texcomp_etc1_decode(const void* blocks, int nbr, int nbc, void* out,
                        void* stream) {
  decode_kernel<<<grid_for((long long)nbr * nbc), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), nbr, nbc, static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}

int texcomp_etc1_downsample(const void* src, int nby, int nbx, void* out,
                            int strategy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (strategy) {
    case kSplitHorizontally:
      launch_downsample<kSplitHorizontally>(src, nby, nbx, out, s);
      break;
    case kSplitVertically:
      launch_downsample<kSplitVertically>(src, nby, nbx, out, s);
      break;
    case kSmallerError:
      launch_downsample<kSmallerError>(src, nby, nbx, out, s);
      break;
    case kHeuristic:
      launch_downsample<kHeuristic>(src, nby, nbx, out, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int texcomp_etc1_hq_search(const void* px, int n, const void* cands,
                           int k_cands, int flip, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* p = static_cast<const int32_t*>(px);
  const uint32_t* c = static_cast<const uint32_t*>(cands);
  int32_t* o = static_cast<int32_t*>(out);
  const int grid = int(((long long)n + kHqBlocks - 1) / kHqBlocks);
  if (flip) hq_search_kernel<true, false><<<grid, kThreads, 0, s>>>(p, n, c, k_cands, o);
  else hq_search_kernel<false, false><<<grid, kThreads, 0, s>>>(p, n, c, k_cands, o);
  return int(cudaGetLastError());
}

// The HQ search of one flip with its candidates fitted in the kernel: (n,
// 16) packed pixels in, (3, n) out as texcomp_etc1_hq_search's.
int texcomp_etc1_hq_fit_search(const void* px, int n, int flip, void* out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* p = static_cast<const int32_t*>(px);
  int32_t* o = static_cast<int32_t*>(out);
  const int grid = int(((long long)n + kHqBlocks - 1) / kHqBlocks);
  if (flip) hq_search_kernel<true, true><<<grid, kThreads, 0, s>>>(p, n, nullptr, kHqCands, o);
  else hq_search_kernel<false, true><<<grid, kThreads, 0, s>>>(p, n, nullptr, kHqCands, o);
  return int(cudaGetLastError());
}

// Registers per thread, static shared memory in bytes, and resident CTAs
// per SM of the strategy's encode, fused level, or the flip's HQ search
// kernel, into out[0..2].
int texcomp_etc1_encode_info(int strategy, int* out) {
  const void* fn = strategy_kernel(strategy, false);
  return fn ? texcomp::kernel_info(fn, kThreads, out)
            : int(cudaErrorInvalidValue);
}

int texcomp_etc1_downsample_info(int strategy, int* out) {
  const void* fn = strategy_kernel(strategy, true);
  return fn ? texcomp::kernel_info(fn, kThreads, out)
            : int(cudaErrorInvalidValue);
}

int texcomp_etc1_hq_search_info(int flip, int* out) {
  const void* fn = flip ? reinterpret_cast<const void*>(hq_search_kernel<true, false>)
                        : reinterpret_cast<const void*>(hq_search_kernel<false, false>);
  return texcomp::kernel_info(fn, kThreads, out);
}

int texcomp_etc1_hq_fit_search_info(int flip, int* out) {
  const void* fn = flip ? reinterpret_cast<const void*>(hq_search_kernel<true, true>)
                        : reinterpret_cast<const void*>(hq_search_kernel<false, true>);
  return texcomp::kernel_info(fn, kThreads, out);
}

// Launches rate micro-kernel `kind` (0-5) on `ctas` CTAs of kThreads, each
// thread running `iters` iterations; out takes one word per thread.
int texcomp_etc1_rate(int kind, int ctas, int iters, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t seed = 0x2468ACu;
  switch (kind) {
    case 0: rate_kernel<0><<<ctas, kThreads, 0, s>>>(seed, iters, o); break;
    case 1: rate_kernel<1><<<ctas, kThreads, 0, s>>>(seed, iters, o); break;
    case 2: rate_kernel<2><<<ctas, kThreads, 0, s>>>(seed, iters, o); break;
    case 3: rate_kernel<3><<<ctas, kThreads, 0, s>>>(seed, iters, o); break;
    case 4: rate_kernel<4><<<ctas, kThreads, 0, s>>>(seed, iters, o); break;
    case 5: rate_kernel<5><<<ctas, kThreads, 0, s>>>(seed, iters, o); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
