// ETC1 encode (four strategies), decode, one fused mip level, and the HQ
// search, for Hopper (sm_90a).
//
// Four kernels, integer arithmetic only: one thread per 4x4 block, and for
// the HQ search eight lanes per block. Each is byte-exact with the plain
// PyTorch codec in texcomp_torch/codecs/etc.py, which follows the
// reference's etc_compressor.cc. The entry points at the
// bottom have a plain C interface: pointers, ints and a stream, returning
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Strategy codes (etc_compressor.h:57-66).
constexpr int kSplitHorizontally = 0;
constexpr int kSplitVertically = 1;
constexpr int kSmallerError = 2;
constexpr int kHeuristic = 3;

// The codebook's rows are [a, b, -a, -b] (etc_compressor.cc:101-110).
// Written as select chains: under an unrolled codeword loop they fold to
// immediates, and for a per-thread codeword they are a few selects rather
// than a local-memory table.
__device__ __forceinline__ int cb_a(int cw) {
  return cw == 0 ? 2 : cw == 1 ? 5 : cw == 2 ? 9 : cw == 3 ? 13
       : cw == 4 ? 18 : cw == 5 ? 24 : cw == 6 ? 33 : 47;
}
__device__ __forceinline__ int cb_b(int cw) {
  return cw == 0 ? 8 : cw == 1 ? 17 : cw == 2 ? 29 : cw == 3 ? 42
       : cw == 4 ? 60 : cw == 5 ? 80 : cw == 6 ? 106 : 183;
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

// The squared error of pixel p against candidate color (cr, cg, cb).
__device__ __forceinline__ int px_err(int cr, int cg, int cb, int r, int g,
                                      int b) {
  const int dr = cr - r, dg = cg - g, db = cb - b;
  return dr * dr + dg * dg + db * db;
}

// The four candidate colors of base (br, bg, bb) under codeword cw.
__device__ __forceinline__ void candidates(int cw, int br, int bg, int bb,
                                           int (&cr)[4], int (&cg)[4],
                                           int (&cbl)[4]) {
  const int a = cb_a(cw), b = cb_b(cw);
  const int mod[4] = {a, b, -a, -b};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    cr[m] = clamp8(br + mod[m]);
    cg[m] = clamp8(bg + mod[m]);
    cbl[m] = clamp8(bb + mod[m]);
  }
}

// FindBestCodeword / FindCodewordHeuristic and the pixel indices for one
// subblock (etc_compressor.cc:350-455). Returns the subblock's error under
// the chosen codeword (0 for the heuristic, whose flip does not use it)
// and ORs the subblock's pixel indices into `lo`.
template <bool kFlip, bool kHeur>
__device__ __forceinline__ int search_subblock(const int (&r)[16],
                                               const int (&g)[16],
                                               const int (&b)[16], int s,
                                               int br, int bg, int bb,
                                               int& cw_out, uint32_t& lo) {
  int cw = 0, best = 0;
  if (kHeur) {
    // The codeword from the largest per-channel mean absolute deviation
    // from the decoded base color (:415-455, called at :524-527).
    int dr = 0, dg = 0, db = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int p = member<kFlip>(s, k);
      dr += abs(br - r[p]);
      dg += abs(bg - g[p]);
      db += abs(bb - b[p]);
    }
    const int dev = max(max(dr >> 3, dg >> 3), db >> 3);
    cw = (dev > 12) + (dev > 23) + (dev > 35) + (dev > 51) + (dev > 70) +
         (dev > 93) + (dev > 144);
  } else {
    // Exhaustive over 8 codewords x 4 modifiers, strict '<' in scan order.
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int cr[4], cg[4], cbl[4];
      candidates(c, br, bg, bb, cr, cg, cbl);
      int sum = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int p = member<kFlip>(s, k);
        int e = px_err(cr[0], cg[0], cbl[0], r[p], g[p], b[p]);
#pragma unroll
        for (int m = 1; m < 4; ++m)
          e = min(e, px_err(cr[m], cg[m], cbl[m], r[p], g[p], b[p]));
        sum += e;
      }
      if (c == 0 || sum < best) { best = sum; cw = c; }
    }
  }
  // Pixel indices under the chosen codeword: the first modifier of least
  // error; bit etc_order(p) holds its low bit and bit etc_order(p) + 16 its
  // high bit (StorePixelIndex, :150-156).
  int cr[4], cg[4], cbl[4];
  candidates(cw, br, bg, bb, cr, cg, cbl);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int p = member<kFlip>(s, k);
    int e = px_err(cr[0], cg[0], cbl[0], r[p], g[p], b[p]);
    uint32_t m_best = 0;
#pragma unroll
    for (int m = 1; m < 4; ++m) {
      const int em = px_err(cr[m], cg[m], cbl[m], r[p], g[p], b[p]);
      if (em < e) { e = em; m_best = m; }
    }
    lo |= ((m_best & 1u) << etc_order(p)) | ((m_best >> 1) << (etc_order(p) + 16));
  }
  cw_out = cw;
  return best;
}

// The tail of FindBestSubblockEncoding for given quantized subblock bases
// q5 (555) and q4 (444) (etc_compressor.cc:480-542): the mode by the
// differential window, the codeword and pixel-index search, and the word
// packing. Writes the logical hi and lo words and returns the block's error
// (the sum of its two subblocks').
template <bool kFlip, bool kHeur>
__device__ __forceinline__ int finish_flip(const int (&r)[16],
                                           const int (&g)[16],
                                           const int (&b)[16],
                                           const int (&q5)[2][3],
                                           const int (&q4)[2][3], uint32_t& hi,
                                           uint32_t& lo) {
  int d[3];
  bool use_diff = true;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    d[ch] = q5[1][ch] - q5[0][ch];
    use_diff = use_diff && d[ch] >= -4 && d[ch] <= 3;
  }
  int dec[2][3];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      dec[s][ch] = use_diff ? ext5(q5[s][ch]) : ext4(q4[s][ch]);

  lo = 0;
  int cw0, cw1;
  const int e0 = search_subblock<kFlip, kHeur>(r, g, b, 0, dec[0][0],
                                               dec[0][1], dec[0][2], cw0, lo);
  const int e1 = search_subblock<kFlip, kHeur>(r, g, b, 1, dec[1][0],
                                               dec[1][1], dec[1][2], cw1, lo);

  // hi (:485-541). Differential: base 555 at 27/19/11 and delta 333 at
  // 24/16/8 (StoreDiffModeColors, :328-337); individual: 444 + 444 at
  // 28/20/12 and 24/16/8 (StoreNormalModeColors, :316-324).
  constexpr int kS1[3] = {27, 19, 11};
  constexpr int kS2[3] = {24, 16, 8};
  constexpr int kT1[3] = {28, 20, 12};
  uint32_t h = (kFlip ? 1u : 0u) | (use_diff ? 2u : 0u);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    h |= use_diff
        ? (uint32_t(q5[0][ch]) << kS1[ch]) | (uint32_t(d[ch] & 7) << kS2[ch])
        : (uint32_t(q4[0][ch]) << kT1[ch]) | (uint32_t(q4[1][ch]) << kS2[ch]);
  }
  hi = h | (uint32_t(cw0) << 5) | (uint32_t(cw1) << 2);
  return e0 + e1;
}

// FindBestSubblockEncoding for one flip with the reference's truncating
// quantization (etc_compressor.cc:460-542): the subblock averages
// (ComputeAverageColor, :299-312) shifted to 555 and 444 (QuantizeRgbFast),
// then finish_flip.
template <bool kFlip, bool kHeur>
__device__ __forceinline__ int encode_flip(const int (&r)[16], const int (&g)[16],
                           const int (&b)[16], uint32_t& hi, uint32_t& lo) {
  int q5[2][3], q4[2][3];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    int sr = 0, sg = 0, sb = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int p = member<kFlip>(s, k);
      sr += r[p];
      sg += g[p];
      sb += b[p];
    }
    const int avg[3] = {sr >> 3, sg >> 3, sb >> 3};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      q5[s][ch] = avg[ch] >> 3;
      q4[s][ch] = avg[ch] >> 4;
    }
  }
  return finish_flip<kFlip, kHeur>(r, g, b, q5, q4, hi, lo);
}

// One channel's terms of the kHeuristic flip errors. sum4 counts pixel
// (2,2) twice and omits (3,3), as the reference does (:563-564).
__device__ __forceinline__ void flip_terms(const int (&v)[16], int& e_lr,
                                           int& e_tb) {
  const int s1 = v[0] + v[1] + v[4] + v[5];
  const int s2 = v[8] + v[9] + v[12] + v[13];
  const int s3 = v[2] + v[3] + v[6] + v[7];
  const int s4 = v[10] + v[11] + v[14] + v[10];
  const int lr = ((s1 + s2) >> 3) - ((s3 + s4) >> 3);
  const int tb = ((s1 + s3) >> 3) - ((s2 + s4) >> 3);
  e_lr += lr * lr;
  e_tb += tb * tb;
}

// The flip of kHeuristic (etc_compressor.cc:553-574): true for the
// top/bottom split.
__device__ __forceinline__ bool heuristic_flip(const int (&r)[16],
                                               const int (&g)[16],
                                               const int (&b)[16]) {
  int e_lr = 0, e_tb = 0;
  flip_terms(r, e_lr, e_tb);
  flip_terms(g, e_lr, e_tb);
  flip_terms(b, e_lr, e_tb);
  return !(e_lr > e_tb);
}

// EncodeEtc1Block (etc_compressor.cc:545-586). Returns the block's two
// words as stored: byte-swapped, so that a little-endian store writes
// big-endian hi then big-endian lo.
template <int kStrategy>
__device__ __forceinline__ uint2 encode_etc1(const int (&r)[16], const int (&g)[16],
                             const int (&b)[16]) {
  uint32_t hi, lo;
  if (kStrategy == kSplitHorizontally) {
    encode_flip<true, false>(r, g, b, hi, lo);
  } else if (kStrategy == kSplitVertically) {
    encode_flip<false, false>(r, g, b, hi, lo);
  } else if (kStrategy == kHeuristic) {
    // The reference encodes both flips and keeps the heuristic's; only
    // that one is computed here.
    if (heuristic_flip(r, g, b)) encode_flip<true, true>(r, g, b, hi, lo);
    else encode_flip<false, true>(r, g, b, hi, lo);
  } else {
    uint32_t hi_t, lo_t;
    const int err_f = encode_flip<false, false>(r, g, b, hi, lo);
    const int err_t = encode_flip<true, false>(r, g, b, hi_t, lo_t);
    if (!(err_f <= err_t)) { hi = hi_t; lo = lo_t; }  // lr wins ties (:583)
  }
  return make_uint2(bswap(hi), bswap(lo));
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
// 8 MiB out, 17.5 us at 3.35 TB/s, but SMALLER_ERROR evaluates 2 flips x
// 16 pixels x 8 codewords x 4 modifiers, about 12,300 integer operations a
// block (chip_smoke.py counts them). This first version is one thread per
// block with the whole search unrolled in registers; sharing candidate
// colors across the threads of a warp, or pruning codewords exactly, is
// left to later work.
template <int kStrategy>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint8_t* __restrict__ img, int channels, int h, int w,
              int nbr, int nbc, uint8_t* __restrict__ out) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)nbr * nbc) return;
  const int by = int(n / nbc), bx = int(n % nbc);
  const long long stride = (long long)w * channels;

  int r[16], g[16], b[16];
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const uint8_t* row = img + min(4 * by + y, h - 1) * stride;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const uint8_t* p = row + (long long)min(4 * bx + x, w - 1) * channels;
      r[4 * y + x] = p[0];
      g[4 * y + x] = p[1];
      b[4 * y + x] = p[2];
    }
  }
  reinterpret_cast<uint2*>(out)[n] = encode_etc1<kStrategy>(r, g, b);
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
// grid decodes its four source blocks at rows 2dy + {0, 1} and columns
// 2dx + {0, 1} straight from the (nby * nbx, 8) payload, adds each source
// pixel into its destination pixel's 2x2 sum, takes the truncating average
// (>> 2 on the non-negative sums, ComputeAveragePixel2x2) and encodes it
// under the strategy. Equal to decode -> 2x2 average -> encode.
//
// Bound on the H100: integer issue, as encode_kernel; it reads 4 source
// blocks for each block it writes.
template <int kStrategy>
__global__ void __launch_bounds__(kThreads)
downsample_kernel(const uint8_t* __restrict__ src, int nby, int nbx,
                  uint8_t* __restrict__ out) {
  const int dnbx = nbx / 2;
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)(nby / 2) * dnbx) return;
  const int dy = int(n / dnbx), dx = int(n % dnbx);
  const uint2* words = reinterpret_cast<const uint2*>(src);

  int r[16] = {}, g[16] = {}, b[16] = {};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int sy = s >> 1, sx = s & 1;
    const EtcBlock blk =
        unpack_block(words[(2LL * dy + sy) * nbx + 2 * dx + sx]);
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      // Source pixel (y, x) lands in destination pixel
      // (2 sy + y / 2, 2 sx + x / 2).
      const int d = (2 * sy + (p >> 3)) * 4 + 2 * sx + ((p & 3) >> 1);
      int pr, pg, pb;
      block_pixel(blk, p, pr, pg, pb);
      r[d] += pr;
      g[d] += pg;
      b[d] += pb;
    }
  }
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    r[d] >>= 2;
    g[d] >>= 2;
    b[d] >>= 2;
  }
  reinterpret_cast<uint2*>(out)[n] = encode_etc1<kStrategy>(r, g, b);
}

// ---------------------------------------------------------------------------
// The HQ search (quality="high").
//
// A candidate is one packed word per subblock: q555 r, g, b at bits 0, 5,
// 10 and q444 r, g, b at bits 15, 19, 23 (codecs/etc.pack_q_word).
//
// Pixels and colours stay packed, r | g << 8 | b << 16 (the input's own
// format). The squared error of pixel p against a candidate colour c is
// |c|^2 - 2 c.p + |p|^2, the dot product one __dp4a, exact in int32. |p|^2
// is the same for every candidate colour, so the searches compare
// |c|^2 - 2 c.p alone (the first argmin over the modifiers is unchanged)
// and the block's |p|^2 sum is added once to the winner's error. A
// candidate colour is clamp8(base +- m) per channel: __vaddus4 and
// __vsubus4, saturated per byte.
// ---------------------------------------------------------------------------

constexpr int kHqRefits = 2;
constexpr int kHqProbes = 24;
constexpr int kHqLanes = 8;                     // lanes per 4x4 block
constexpr int kHqBlocks = kThreads / kHqLanes;  // blocks per CTA
constexpr int kHqChunk = kHqLanes;              // candidates per staged chunk
static_assert(kHqProbes % kHqLanes == 0, "probes split evenly over lanes");

// The codebook's (a, b) of each codeword, for a codeword loop that is not
// unrolled (cb_a and cb_b fold to immediates only under an unrolled one)
// and for a per-lane codeword.
__constant__ int c_hq_cb[8][2] = {{2, 8},   {5, 17},  {9, 29},  {13, 42},
                                  {18, 60}, {24, 80}, {33, 106}, {47, 183}};

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

__device__ __forceinline__ uint32_t splat(int v) { return uint32_t(v) * 0x010101u; }

__device__ __forceinline__ int dot(uint32_t a, uint32_t b) {
  return int(__dp4a(a, b, 0u));
}

// The decoded bases of the candidate (w1, w2), packed: the mode by the
// differential window, as finish_flip. Returns use_diff.
__device__ __forceinline__ bool hq_bases(uint32_t w1, uint32_t w2,
                                         uint32_t& b0, uint32_t& b1) {
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

// The logical hi word of the candidate (w1, w2) under codewords cw0, cw1,
// packed as finish_flip packs it.
template <bool kFlip>
__device__ __forceinline__ uint32_t hq_hi(uint32_t w1, uint32_t w2, int cw0,
                                          int cw1) {
  uint32_t b0, b1;
  const bool diff = hq_bases(w1, w2, b0, b1);
  constexpr int kS1[3] = {27, 19, 11};
  constexpr int kS2[3] = {24, 16, 8};
  constexpr int kT1[3] = {28, 20, 12};
  uint32_t h = (kFlip ? 1u : 0u) | (diff ? 2u : 0u);
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
__device__ __forceinline__ void hq_colors(uint32_t base, int a, int b,
                                          uint32_t (&c)[4], int (&k)[4]) {
  c[0] = __vaddus4(base, splat(a));
  c[1] = __vaddus4(base, splat(b));
  c[2] = __vsubus4(base, splat(a));
  c[3] = __vsubus4(base, splat(b));
#pragma unroll
  for (int m = 0; m < 4; ++m) k[m] = dot(c[m], c[m]);
}

// Subblock s's error under base and modifiers (a, b), less its |p|^2 sum:
// per pixel the least |c|^2 - 2 c.p over the four colours.
template <bool kFlip, int kS>
__device__ __forceinline__ int hq_sub_err(const uint32_t (&px)[16],
                                          uint32_t base, int a, int b) {
  uint32_t c[4];
  int k[4];
  hq_colors(base, a, b, c, k);
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t p = px[member<kFlip>(kS, j)];
    int e[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) e[m] = k[m] - 2 * dot(c[m], p);
    sum += min(min(e[0], e[1]), min(e[2], e[3]));
  }
  return sum;
}

// FindBestCodeword for subblock s: the first of the 8 codewords of least
// error (strict '<' in scan order).
template <bool kFlip, int kS>
__device__ __forceinline__ int hq_sub_search(const uint32_t (&px)[16],
                                             uint32_t base, int& cw) {
  int best = 0;
#pragma unroll 1
  for (int c = 0; c < 8; ++c) {
    const int e = hq_sub_err<kFlip, kS>(px, base, c_hq_cb[c][0], c_hq_cb[c][1]);
    if (c == 0 || e < best) {
      best = e;
      cw = c;
    }
  }
  return best;
}

// One step: the exact SMALLER_ERROR search of the flip for the candidate
// (w1, w2). Returns its error less the block's |p|^2 sum, and its
// codewords as cw0 | cw1 << 3.
template <bool kFlip>
__device__ __forceinline__ int hq_step(const uint32_t (&px)[16], uint32_t w1,
                                       uint32_t w2, int& cws) {
  uint32_t b0, b1;
  hq_bases(w1, w2, b0, b1);
  int cw0 = 0, cw1 = 0;
  const int e = hq_sub_search<kFlip, 0>(px, b0, cw0) +
                hq_sub_search<kFlip, 1>(px, b1, cw1);
  cws = cw0 | (cw1 << 3);
  return e;
}

// The lexicographic least (e, s) over the 8 lanes of a block, on every
// lane: with s the step, the first step of least error.
__device__ __forceinline__ void group_min(int& e, int& s) {
#pragma unroll
  for (int o = 1; o < kHqLanes; o <<= 1) {
    const int oe = __shfl_xor_sync(0xFFFFFFFFu, e, o);
    const int os = __shfl_xor_sync(0xFFFFFFFFu, s, o);
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
  hq_bases(w1, w2, b0, b1);
  uint32_t lo = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = 2 * l + j;
    const bool first = kFlip ? p < 8 : (p & 3) < 2;
    const int cw = first ? cws & 7 : cws >> 3;
    uint32_t c[4];
    int k[4];
    hq_colors(first ? b0 : b1, c_hq_cb[cw][0], c_hq_cb[cw][1], c, k);
    int e = k[0] - 2 * dot(c[0], mine[j]);
    uint32_t m_best = 0;
#pragma unroll
    for (int m = 1; m < 4; ++m) {
      const int em = k[m] - 2 * dot(c[m], mine[j]);
      if (em < e) {
        e = em;
        m_best = m;
      }
    }
    const int eo = etc_order(p);
    lo |= ((m_best & 1u) << eo) | ((m_best >> 1) << (eo + 16));
  }
#pragma unroll
  for (int o = 1; o < kHqLanes; o <<= 1)
    lo |= __shfl_xor_sync(0xFFFFFFFFu, lo, o);
  return lo;
}

// The least-squares bases of subblock s for the modifiers that codeword cw
// and the index word lo give its pixels: per channel the mean of pixel -
// modifier, rounded half to even (s * 0.125 is exact) and clamped, then
// quantized to 555 and 444 and packed (codecs/etc._refit_bases).
template <bool kFlip, int kS>
__device__ __forceinline__ uint32_t hq_refit_word(const uint32_t (&px)[16],
                                                  int cw, uint32_t lo) {
  const int a = c_hq_cb[cw][0], b = c_hq_cb[cw][1];
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

// Replaces texcomp/ops/etc_pallas.py:_etc1_hq_kernel (one flip per launch,
// as there).
//
// Reads (n, 16) int32 packed pixels (r | g << 8 | b << 16, row-major) and
// (k, 2, n) packed candidate words, and writes (3, n) int32: the logical hi
// and lo words and the error of the first step of least error, in step
// order: the k candidates, refit 0 from the winner so far, refit 1 from
// refit 0's own words (whether or not they won), and the 24 probes around
// refit 1's bases. Each step is the exact SMALLER_ERROR search of
// finish_flip, so the error is an exact int32.
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
// search, 2 subblocks x 8 codewords x 8 pixels x 4 colours. The bound
// counts a (pixel, colour) as 8 scalar operations (3 subtracts, a multiply,
// 2 multiply-adds and a min); packed it issues a __dp4a, a multiply-add
// and a min, so the kernel can come near that bound or pass it.
template <bool kFlip>
__global__ void __launch_bounds__(kThreads)
hq_search_kernel(const int32_t* __restrict__ pixels, int n,
                 const uint32_t* __restrict__ cands, int k_cands,
                 int32_t* __restrict__ out) {
  __shared__ uint32_t stage[2][2][kHqBlocks][kHqChunk];
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
    w1 = __shfl_sync(0xFFFFFFFFu, best_w1, src);
    w2 = __shfl_sync(0xFFFFFFFFu, best_w2, src);
    cws = __shfl_sync(0xFFFFFFFFu, best_cws, src);
    return e;
  };

  // Candidates.
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
      const int e = hq_step<kFlip>(px, w1, w2, cws);
      consider(e, k, w1, w2, cws);
    }
    __syncthreads();
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
    hq_bases(w1, w2, b0, b1);
    int e0 = hq_sub_err<kFlip, 0>(px, b0, c_hq_cb[l][0], c_hq_cb[l][1]);
    int e1 = hq_sub_err<kFlip, 1>(px, b1, c_hq_cb[l][0], c_hq_cb[l][1]);
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
    const int e = hq_step<kFlip>(px, p1, p2, pcws);
    consider(e, k_cands + kHqRefits + j, p1, p2, pcws);
  }

  const int e = winner(w1, w2, cws);
  const uint32_t hi = hq_hi<kFlip>(w1, w2, cws & 7, cws >> 3);
  lo = hq_lo<kFlip>(mine, l, w1, w2, cws);
  if (valid && l == 0) {
    out[i] = int32_t(hi);
    out[n + i] = int32_t(lo);
    out[2LL * n + i] = e + psum;
  }
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
  if (flip) hq_search_kernel<true><<<grid, kThreads, 0, s>>>(p, n, c, k_cands, o);
  else hq_search_kernel<false><<<grid, kThreads, 0, s>>>(p, n, c, k_cands, o);
  return int(cudaGetLastError());
}

// Registers per thread, static shared memory in bytes, and resident CTAs
// per SM of the flip's HQ search kernel, into out[0..2].
int texcomp_etc1_hq_search_info(int flip, int* out) {
  const void* fn = flip ? reinterpret_cast<const void*>(hq_search_kernel<true>)
                        : reinterpret_cast<const void*>(hq_search_kernel<false>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads, 0);
  if (err != cudaSuccess) return int(err);
  out[0] = attr.numRegs;
  out[1] = int(attr.sharedSizeBytes);
  out[2] = ctas;
  return 0;
}

}  // extern "C"
