// PVRTC v1 2bpp encode for Hopper (sm_90a): morph (single image and
// batched), bilinear upscale + modulation, and mode decision + packing.
//
// Four kernels, one thread per 8x4 block, integer arithmetic only, and two
// variants for a strip of a taller image (an atlas's "data" shard): upscale
// + modulate with the low-res rows above and below handed in as halo rows,
// and mode + pack with the modulation row below handed in, its records
// row-major. The morph takes a strip as it is. The morph and the upscale +
// modulate work on 16-bit lane pairs. Each is byte-exact with its plain
// twin in texcomp_torch/ops/pvrtc_cuda.py, built from
// texcomp_torch/codecs/pvrtc.py, which follows the reference's
// pvrtc_compressor.cc. The entry points at the bottom have a plain C
// interface: pointers, ints and a stream, returning cudaGetLastError() so
// the caller sees a refused launch.
//
// Layouts. Images are (B, H, W, 4) uint8, read as one 32-bit word a pixel
// (r | g << 8 | b << 16 | a << 24). A block n = b * nby * nbx + by * nbx + bx
// has ab[n] = (A, B), its packed reduced colors, and 32 modulation bytes at
// mod[32 n + py * 8 + px]. The records of image b go to out[b * nb + slot],
// slot the block's Z-order position. Neighbor blocks wrap within their own
// image, or in a strip variant come from the halo rows above and below.
//
// What the TPU kernels needed and these do not: the nine pre-rolled low-res
// variants (_make_var_words) and the right/below edge tiles (_mode_edges),
// since a thread reads its wrapped neighbors itself; the one-hot bf16
// upscale matmul (_upscale_weights), since the four corner weights of a
// pixel are compile-time constants here; and the MXU Z-order permutation
// (_zorder_words), since the last kernel stores each record in its slot.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int chan(uint32_t w, int c) {
  return (w >> (8 * c)) & 255;
}

__device__ __forceinline__ uint32_t pack(int r, int g, int b, int a) {
  return uint32_t(r) | (uint32_t(g) << 8) | (uint32_t(b) << 16) |
         (uint32_t(a) << 24);
}

// Encode to d bits, decode to 8 by bit replication
// (pvrtc_compressor.cc:93-106).
__device__ __forceinline__ int bit_depth(int v, int d) {
  const int enc = v & (((1 << d) - 1) << (8 - d));
  int out = enc | (enc >> d);
  if (d <= 3) out |= enc >> (2 * d);
  return out;
}

// ApplyColorChannelReduction (pvrtc_compressor.cc:337-349): 554 (A) or 555
// (B) opaque, 3443 (A) or 3444 (B) translucent.
template <bool kIsB>
__device__ __forceinline__ uint32_t reduce_color(uint32_t w) {
  const int r = chan(w, 0), g = chan(w, 1), b = chan(w, 2), a = chan(w, 3);
  if (a == 255)
    return pack(bit_depth(r, 5), bit_depth(g, 5), bit_depth(b, kIsB ? 5 : 4),
                255);
  return pack(bit_depth(r, 4), bit_depth(g, 4), bit_depth(b, kIsB ? 4 : 3),
              bit_depth(a, 3));
}

// Both 16-bit lanes' low bytes: w & kLanes is (r, b), (w >> 8) & kLanes is
// (g, a). Every lane sum below stays under 2^16, so the lanes never carry
// into each other, and a mask after each shift keeps a lane's bits in it.
constexpr uint32_t kLanes = 0x00FF00FFu;
// __dp4a weights of the lightness 77 r + 150 g + 28 b (pvrtc_compressor.cc:
// 270), r in byte 0; unsigned, as 150 is no signed byte.
constexpr uint32_t kLightness = 0x001C964Du;

// Block n's image, row and column on a (nby, nbx) grid of powers of two
// (the wrappers check it): shifts and masks, not divisions.
__device__ __forceinline__ void block_coords(long long n, int nby, int nbx,
                                             long long& image, int& by,
                                             int& bx) {
  const int lx = __ffs(nbx) - 1, ly = __ffs(nby) - 1;
  image = n >> (lx + ly);
  by = int(n >> lx) & (nby - 1);
  bx = int(n) & (nbx - 1);
}

// The least key of a lane pair's values at scan position s, and the
// greatest: v * 32 + s and v * 32 + (31 - s) in each lane.
__device__ __forceinline__ uint32_t min_key(uint32_t pair, uint32_t s) {
  return pair * 32 + s * 0x10001u;
}
__device__ __forceinline__ uint32_t max_key(uint32_t pair, uint32_t s) {
  return pair * 32 + (31 - s) * 0x10001u;
}

// Both lightness keys of pixel p at scan position s in one word: the min
// key L * 32 + s in the low lane and 8,191 less the max key L * 32 +
// (31 - s) in the high lane, so one 16x2 min reduces both ends. L is the
// truncated lightness (77 r + 150 g + 28 b) >> 8 by one unsigned __dp4a;
// the word is L * (32 - 32 * 2^16) + s * 0x10001 + 8160 * 2^16 modulo 2^32,
// both lanes in 0..8191.
__device__ __forceinline__ uint32_t light_key(uint32_t p, uint32_t s) {
  return (__dp4a(p, kLightness, 0u) >> 8) * 0xFFE00020u +
         (s * 0x10001u + 0x1FE00000u);
}

// Pixel (py, px) of block (bx, by) in a (W)-wide image of words.
__device__ __forceinline__ void load_block_row(const uint32_t* img, int w,
                                               int by, int bx, int py,
                                               uint32_t (&p)[8]) {
  const uint4* row =
      reinterpret_cast<const uint4*>(img + (long long)(4 * by + py) * w + 8 * bx);
  const uint4 q0 = row[0], q1 = row[1];
  p[0] = q0.x; p[1] = q0.y; p[2] = q0.z; p[3] = q0.w;
  p[4] = q1.x; p[5] = q1.y; p[6] = q1.z; p[7] = q1.w;
}

// Replaces texcomp/ops/pvrtc_fast.py:_morph_kernel (kBatched false) and
// _morph_kernel_rowp00 (kBatched true), both on _morph_words.
//
// GetExtremesFast + ApplyColorChannelReduction (pvrtc_compressor.cc:
// 255-349, :506-521) on one block's 32 pixels in scan order s = py*8+px:
// per axis (lightness, r, g, b, a) the first-occurrence min and max (strict
// '<' / '>'), the max of an axis that is 0 everywhere in the block falling
// back to the origin pixel; the first axis of largest L1 spread (strict
// '>'); the darker of the pair (four-channel sum) as A.
//
// The origin pixel is one word for a single image (the image's own pixel
// (0, 0), or any pixel the caller names), and image b's pixel (0, 0) in
// the batched form.
//
// Index-carrying keys. The first pixel of least value v is the least key
// v * 32 + s, the first of greatest value the greatest v * 32 + (31 - s),
// so one min or max a pixel and axis replaces a compare and two selects.
// The channels go in lane pairs, (r, b) and (g, a): one multiply-add
// makes a pair's two keys (at most 8,191 a lane) and a DPX 3-input 16x2 min
// or max reduces two pixels' keys into the running one. The lightness keys
// go in one word, its min key and the complement of its max key
// (light_key), keyed by the truncated value: pixels that tie after the
// shift go by index. The extremes' words come back by index from the
// thread's 32 words, staged in shared memory word-major (word j of thread t
// at j * 256 + t, no bank conflicts).
//
// Bound on the H100: memory traffic. At 4096^2 it reads 64 MiB and writes
// 4 MiB, 21 us at 3.35 TB/s; the keys are about 890 integer operations a
// block, 7 us at 67 T op/s (as scalar code about 1,900 and 15 us;
// chip_smoke.py counts both). A thread reads its block as eight 16-byte
// loads; a warp's loads of one pixel row cover 1 KiB.
template <bool kBatched>
__global__ void __launch_bounds__(kThreads)
morph_kernel(const uint32_t* __restrict__ img, int batch, int nby, int nbx,
             const uint32_t* __restrict__ origin, uint2* __restrict__ ab) {
  __shared__ uint32_t staged[32 * kThreads];
  uint32_t* const mine = staged + threadIdx.x;
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)batch * nby * nbx) return;
  long long image;
  int by, bx;
  block_coords(n, nby, nbx, image, by, bx);
  const int w = 8 * nbx;
  const uint32_t* base = img + image * nby * nbx * 32;
  const uint32_t o = kBatched ? base[0] : origin[0];

  uint32_t light = 0xFFFFFFFFu;             // lightness keys, both ends
  uint32_t rbmin = 0xFFFFFFFFu, rbmax = 0;  // (r, b) keys
  uint32_t gamin = 0xFFFFFFFFu, gamax = 0;  // (g, a) keys
#pragma unroll
  for (int py = 0; py < 4; ++py) {
    uint32_t row[8];
    load_block_row(base, w, by, bx, py, row);
#pragma unroll
    for (int px = 0; px < 8; px += 2) {  // two pixels a 3-input min / max
      const uint32_t s = 8 * py + px, p = row[px], q = row[px + 1];
      mine[s * kThreads] = p;
      mine[(s + 1) * kThreads] = q;
      light = __vimin3_u16x2(light, light_key(p, s), light_key(q, s + 1));
      const uint32_t rbp = p & kLanes, rbq = q & kLanes;
      const uint32_t gap = (p >> 8) & kLanes, gaq = (q >> 8) & kLanes;
      rbmin = __vimin3_u16x2(rbmin, min_key(rbp, s), min_key(rbq, s + 1));
      rbmax = __vimax3_u16x2(rbmax, max_key(rbp, s), max_key(rbq, s + 1));
      gamin = __vimin3_u16x2(gamin, min_key(gap, s), min_key(gaq, s + 1));
      gamax = __vimax3_u16x2(gamax, max_key(gap, s), max_key(gaq, s + 1));
    }
  }

  // Axis order 0-4: lightness, r, g, b, a.
  const uint32_t kmin[5] = {light & 0xFFFFu, rbmin & 0xFFFFu,
                            gamin & 0xFFFFu, rbmin >> 16, gamin >> 16};
  const uint32_t kmax[5] = {8191 - (light >> 16), rbmax & 0xFFFFu,
                            gamax & 0xFFFFu, rbmax >> 16, gamax >> 16};
  uint32_t best_lo = 0, best_hi = 0, best_diff = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint32_t smin = kmin[k] & 31, smax = 31 - (kmax[k] & 31);
    const uint32_t wmin = mine[smin * kThreads];
    // The all-zero-axis quirk: decided by the max's value, not its key.
    const uint32_t wmax = kmax[k] < 32 ? o : mine[smax * kThreads];
    const uint32_t diff = __vsadu4(wmax, wmin);  // the L1 spread
    if (k == 0 || diff > best_diff) {
      best_diff = diff;
      best_lo = wmin;
      best_hi = wmax;
    }
  }
  if (__dp4a(best_hi, 0x01010101u, 0u) < __dp4a(best_lo, 0x01010101u, 0u)) {
    const uint32_t t = best_lo;
    best_lo = best_hi;
    best_hi = t;
  }
  ab[n] = make_uint2(reduce_color<false>(best_lo), reduce_color<true>(best_hi));
}

// The 32 modulation values of block (bx, by), n its index in ``mod``, from
// its 3x3 low-res neighbourhood q (both kernels below fill q, each with its
// own rows above and below).
__device__ __forceinline__ void modulate_block(const uint32_t* base, int w,
                                               int by, int bx,
                                               const uint32_t (&q)[3][3][4],
                                               uint4* __restrict__ mod,
                                               long long n) {
  uint32_t out[8];
#pragma unroll
  for (int py = 0; py < 4; ++py) {
    uint32_t row[8];
    load_block_row(base, w, by, bx, py, row);
    const int top = py < 2 ? 0 : 1;
    const uint32_t yw = (py + 2) & 3;
    uint32_t vs[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vs[c][j] = (4 - yw) * q[top][c][j] + yw * q[top + 1][c][j];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int px = 4 * half + k;
        const int left = px < 4 ? 0 : 1;
        const uint32_t xw = (px + 4) & 7;
        uint32_t up[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          up[j] = (((8 - xw) * vs[left][j] + xw * vs[left + 1][j]) >> 5) & kLanes;
        const uint32_t c1rb = ((5 * up[0] + 3 * up[2]) >> 3) & kLanes;
        const uint32_t c1ga = ((5 * up[1] + 3 * up[3]) >> 3) & kLanes;
        const uint32_t c2rb = ((3 * up[0] + 5 * up[2]) >> 3) & kLanes;
        const uint32_t c2ga = ((3 * up[1] + 5 * up[3]) >> 3) & kLanes;
        const uint32_t v = row[px];
        // L1 distances (_color_diff): one byte SAD, VABSDIFF4 on sm_90.
        const uint32_t d0 = __vsadu4(v, up[0] | (up[1] << 8));
        const uint32_t d1 = __vsadu4(v, c1rb | (c1ga << 8));
        const uint32_t d2 = __vsadu4(v, c2rb | (c2ga << 8));
        const uint32_t d3 = __vsadu4(v, up[2] | (up[3] << 8));
        // Early exit (BestModulation, pvrtc_compressor.cc:148-166).
        const uint32_t t1 = d1 < d0, t2 = t1 & (d2 < d1), t3 = t2 & (d3 < d2);
        word |= (t1 + t2 + t3) << (8 * k);
      }
      out[2 * py + half] = word;
    }
  }
  mod[2 * n] = make_uint4(out[0], out[1], out[2], out[3]);
  mod[2 * n + 1] = make_uint4(out[4], out[5], out[6], out[7]);
}

// Replaces texcomp/ops/pvrtc_fast.py:_upmod_kernel (_upscale_modulate_16).
//
// GetInterpolatedColor2BPP + BestModulation (pvrtc_compressor.cc:148-237,
// :527-540). The thread reads the 3x3 low-res neighborhood of its block,
// wrapped within the image. Pixel (py, px) takes the left column bx-1 iff
// px < 4 and the top row by-1 iff py < 2, with weights xw = (px+4) & 7 and
// yw = (py+2) & 3: the upscaled channel is the 4-corner integer sum >> 5.
// The modulation is the best of A, (5A+3B)>>3, (3A+5B)>>3 and B by L1
// distance under the reference's early exit: a candidate counts only if
// every earlier one improved.
//
// Packed lanes. Each low-res word is two lane pairs, (r, b) and (g, a).
// The sum is separable, as the twin computes it: per pixel row the
// vertical sums V = (4-yw) top + yw bottom of the three columns (at most
// 1,020 a lane), then per pixel (8-xw) V_left + xw V_right (at most 8,160),
// shifted and masked: 8 multiply-adds a pixel for both colors' 4
// channels. The blended candidates are lane sums too (at most 2,040); each
// candidate goes back to a byte word, and its distance to the pixel is one
// byte SAD. The early exit is branch-free: t1 = d1 < d0, t2 = t1 & d2 < d1,
// t3 = t2 & d3 < d2, m = t1 + t2 + t3.
//
// Bound on the H100: memory traffic. At 4096^2 it reads 64 MiB of pixels
// and 4 MiB of colors and writes 16 MiB, 26 us at 3.35 TB/s; in packed
// lanes the two upscales and four candidate distances are about 2,300
// integer operations a block, 18 us at 67 T op/s (as scalar code about 160
// a pixel and 41 us; chip_smoke.py counts both).
__global__ void __launch_bounds__(kThreads)
upscale_modulate_kernel(const uint32_t* __restrict__ img,
                        const uint2* __restrict__ ab, int batch, int nby,
                        int nbx, uint4* __restrict__ mod) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)batch * nby * nbx) return;
  long long image;
  int by, bx;
  block_coords(n, nby, nbx, image, by, bx);
  const int w = 8 * nbx;
  const uint32_t* base = img + image * nby * nbx * 32;
  const uint2* low = ab + image * nby * nbx;

  // q[r][c][j]: rows by-1, by, by+1, columns bx-1, bx, bx+1; lane pairs
  // j = A (r, b), A (g, a), B (r, b), B (g, a).
  uint32_t q[3][3][4];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int y = (by + r - 1) & (nby - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint2 v = low[y * nbx + ((bx + c - 1) & (nbx - 1))];
      q[r][c][0] = v.x & kLanes;
      q[r][c][1] = (v.x >> 8) & kLanes;
      q[r][c][2] = v.y & kLanes;
      q[r][c][3] = (v.y >> 8) & kLanes;
    }
  }

  modulate_block(base, w, by, bx, q, mod, n);
}

// Upscale + modulate of one strip of a taller image (the block rows of one
// "data" shard of an atlas, dist/mesh.py): an (nby, nbx) power-of-two grid
// with nby as small as 1. The low-res row above the strip's first block row
// is halo_top (the previous strip's last row) and the row below its last is
// halo_bot (the next strip's first); columns wrap within the row as in
// upscale_modulate_kernel, which computes the same function with both
// halos taken from the image's own wrap. Replaces the halo path of texcomp/
// ops/pvrtc_fast.py:_make_var_words (halo_top / halo_bot) feeding
// _upmod_kernel; the bound is upscale_modulate_kernel's, per block.
__global__ void __launch_bounds__(kThreads)
upscale_modulate_halo_kernel(const uint32_t* __restrict__ img,
                             const uint2* __restrict__ ab,
                             const uint2* __restrict__ halo_top,
                             const uint2* __restrict__ halo_bot, int nby,
                             int nbx, uint4* __restrict__ mod) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)nby * nbx) return;
  long long image;
  int by, bx;
  block_coords(n, nby, nbx, image, by, bx);
  const uint2* rows[3] = {by > 0 ? ab + (long long)(by - 1) * nbx : halo_top,
                          ab + (long long)by * nbx,
                          by + 1 < nby ? ab + (long long)(by + 1) * nbx
                                       : halo_bot};
  uint32_t q[3][3][4];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint2 v = rows[r][(bx + c - 1) & (nbx - 1)];
      q[r][c][0] = v.x & kLanes;
      q[r][c][1] = (v.x >> 8) & kLanes;
      q[r][c][2] = v.y & kLanes;
      q[r][c][3] = (v.y >> 8) & kLanes;
    }
  }
  modulate_block(img, 8 * nbx, by, bx, q, mod, n);
}

// Bits j of v at positions 2j (v < 2^16).
__device__ __forceinline__ uint32_t spread_bits(uint32_t v) {
  v &= 0xFFFF;
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

// The even bits of v, packed: the inverse of spread_bits.
__device__ __forceinline__ uint32_t compact_bits(uint32_t v) {
  v &= 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0F0F0F0Fu;
  v = (v | (v >> 4)) & 0x00FF00FFu;
  return (v | (v >> 8)) & 0xFFFFu;
}

// Byte 0 of each of four words, as bytes 0-3 of one: a block's pixel 0 of
// rows 0-3 from its words 0, 2, 4 and 6.
__device__ __forceinline__ uint32_t column0(uint32_t w0, uint32_t w2,
                                            uint32_t w4, uint32_t w6) {
  return __byte_perm(__byte_perm(w0, w2, 0x40u), __byte_perm(w4, w6, 0x40u),
                     0x5410u);
}

// Byte 3 of each of four words, as bytes 0-3 of one.
__device__ __forceinline__ uint32_t top_bytes(const uint32_t (&p)[4]) {
  return __byte_perm(__byte_perm(p[0], p[1], 0x73u),
                     __byte_perm(p[2], p[3], 0x73u), 0x5410u);
}

// The record of one block from its 8 modulation words w (row py: pixels 0-3
// in w[2 py], 4-7 in w[2 py + 1]), its right neighbour's pixel 0 of rows
// 0-3 (byte py of right), its lower neighbour's row 0 (below0, below1) and
// its packed colors *ab: the mode decision, the modulation word and the
// color word (both mode + pack kernels below).
__device__ __forceinline__ uint2 mode_record(const uint32_t (&w)[8],
                                             uint32_t right, uint32_t below0,
                                             uint32_t below1,
                                             const uint2* __restrict__ ab) {
  uint32_t vertical_count = 0, horizontal_count = 0;  // crossed
  uint32_t one[4], two[4];
#pragma unroll
  for (int py = 0; py < 4; ++py) {
    const uint32_t a = w[2 * py], b = w[2 * py + 1];
    vertical_count += __vsadu4(a, __byte_perm(a, b, 0x4321u));
    vertical_count += __vsadu4(b, __byte_perm(b, right, 0x4321u + 0x1000u * py));
    horizontal_count += __vsadu4(a, py < 3 ? w[2 * py + 2] : below0);
    horizontal_count += __vsadu4(b, py < 3 ? w[2 * py + 3] : below1);
    one[py] = (((a >> 1) | (b << 3)) & 0x11111111u) * 0x01020408u;
    two[py] = __byte_perm(a, b, py & 1 ? 0x7531u : 0x6420u) * 0x01041040u;
  }
  const uint32_t z0 = w[0] | (w[1] << 2) | (w[2] << 4) | (w[3] << 6);
  const uint32_t z1 = w[4] | (w[5] << 2) | (w[6] << 4) | (w[7] << 6);
  const int intermediate = __popc((z0 ^ (z0 >> 1)) & 0x55555555u) +
                           __popc((z1 ^ (z1 >> 1)) & 0x55555555u);
  int mode;  // 0 = 1bpp, 1 = average4, 2 = vertical, 3 = horizontal
  if (intermediate <= 4) mode = 0;
  else if (vertical_count > 10 && vertical_count > 2 * horizontal_count) mode = 2;
  else if (horizontal_count > 10 && horizontal_count > 2 * vertical_count) mode = 3;
  else mode = 1;
  const uint32_t mod_word =
      mode == 0 ? top_bytes(one)
                : (top_bytes(two) & ~0x00100001u) | (mode != 1 ? 1u : 0u) |
                      (mode == 2 ? 1u << 20 : 0u);

  const uint2 c = *ab;
  const int ar = chan(c.x, 0), ag = chan(c.x, 1), ab_ = chan(c.x, 2),
            aa = chan(c.x, 3);
  const int br = chan(c.y, 0), bg = chan(c.y, 1), bb = chan(c.y, 2),
            ba = chan(c.y, 3);
  uint32_t color = aa == 255
      ? (1u << 15) | (uint32_t(ab_ >> 4) << 1) | (uint32_t(ag >> 3) << 5) |
            (uint32_t(ar >> 3) << 10)
      : (uint32_t(ab_ >> 5) << 1) | (uint32_t(ag >> 4) << 4) |
            (uint32_t(ar >> 4) << 8) | (uint32_t(aa >> 5) << 12);
  color |= ba == 255
      ? (1u << 31) | (uint32_t(bb >> 3) << 16) | (uint32_t(bg >> 3) << 21) |
            (uint32_t(br >> 3) << 26)
      : (uint32_t(bb >> 4) << 16) | (uint32_t(bg >> 4) << 20) |
            (uint32_t(br >> 4) << 24) | (uint32_t(ba >> 5) << 28);
  color |= mode != 0 ? 1u : 0u;
  return make_uint2(mod_word, color);
}

// Designs of mode + pack (the thread layout and where the neighbours' bytes
// come from). The entry point launches kSlotLoad; chip_smoke.py's
// pvrtc_pack_probe times all three on the same inputs (PERF.md keeps the
// readings).
enum PackDesign {
  kSlotShuffle = 0,  // thread = Z-order slot, neighbours by __shfl_sync
  kSlotLoad = 1,     // thread = Z-order slot, neighbours loaded
  kRowMajor = 2,     // thread = row-major block, neighbours loaded
};

// Replaces texcomp/ops/pvrtc_fast.py:_mpc_kernel (_modes_pack_colors_body),
// and with it _mode_edges and the Z-order permutation (_zorder_words).
//
// CalculateBlockModulationMode (pvrtc_compressor.cc:395-447) with the
// reference's crossed counters: horizontal_count sums the deltas to the
// pixel below, vertical_count those to the pixel on the right; the pixel
// right of px = 7 is px = 0 of the block to the right and the one below
// py = 3 is py = 0 of the block below, both wrapped within the image. Then
// CalculateBlockModulationData (:456-496; the 2bpp sub-mode flags steal bit
// positions 0 and 20) and EncodeColors (:356-388). The record, LE
// modulation word then LE color word, goes to Z-order slot y-bits-even,
// x-bits-odd of (bx, by): a bijection onto [0, nb) for the (2 * nbx, nbx)
// power-of-two grids of square images, which the wrapper checks.
//
// Thread t of image b takes slot t (kSlotLoad, kSlotShuffle): (by, bx) are
// the even and odd bits of t, the image a shift, since nb = 2 nbx^2 is a
// power of two, and the record one coalesced 8-byte store. A warp's 32
// slots are 8 block rows of 4 blocks, so its modulation reads are 8 whole
// 128-byte lines, and a block's right neighbour (bx + 1) lies in them
// unless bx = 3 (mod 4), its lower one unless by = 7 (mod 8): the
// neighbours' loads are L1 or L2 hits. kSlotShuffle instead takes a
// neighbour in the warp by shuffle from the lane that holds it, the lane
// found by dilated increments of t's x and y bits; images of fewer than 32
// blocks lie whole in a warp, and a spare lane past the last block takes
// part in the shuffles and stores nothing. kRowMajor: thread n takes
// row-major block n and stores its record to its slot, a scattered store.
//
// Modulation values are 0..3, as upscale + modulate writes them, so a
// block row is two words of four pixels and the arithmetic goes four
// pixels a word:
//   - the counters are byte SADs: to the right, a word against itself
//     moved one byte, filled from the next word or the right neighbour's
//     pixel; below, a word against the next row's (or the lower
//     neighbour's row 0), 16 __vsadu4 a block;
//   - m in {1, 2} is bit 0 of m ^ (m >> 1): the 8 words two bits a field
//     into two words, two popcounts;
//   - the 1bpp word (bit py * 8 + px = m >> 1): per row, bit 1 of the
//     first word's bytes to bits 0, 8, 16, 24 and of the second's to 4,
//     12, 20, 28, and one multiply by 0x01020408 gathers the 8 bits into
//     byte 3;
//   - the 2bpp word (bits 8 py + 2 j = m at px = 2 j + (py & 1)): per row
//     the checkerboard's four bytes by __byte_perm, and one multiply by
//     0x01041040 gathers their 2-bit fields into byte 3.
// Both multiplies' terms land on distinct bits below bit 32, so nothing
// carries; tests/test_torch_pvrtc_modes.py models each step.
//
// Bound on the H100: memory traffic. At 4096^2 it reads 16 MiB of
// modulation and 4 MiB of colors and writes 4 MiB, 7.5 us at 3.35 TB/s;
// about 220 integer operations a block (chip_smoke.py counts them).
template <int kDesign>
__global__ void __launch_bounds__(kThreads)
modes_pack_kernel(const uint8_t* __restrict__ mod, const uint2* __restrict__ ab,
                  long long total, int nbx, uint2* __restrict__ out) {
  const int lx = __ffs(nbx) - 1;
  const uint32_t last = (2u << (2 * lx)) - 1;  // nb - 1
  long long n = blockIdx.x * (long long)kThreads + threadIdx.x;
  const bool live = n < total;
  if (kDesign != kSlotShuffle && !live) return;
  if (!live) n = total - 1;
  const long long first = n & ~(long long)last;
  const uint32_t t = uint32_t(n) & last;
  uint32_t by, bx;
  if (kDesign == kRowMajor) {
    by = t >> lx;
    bx = t & (nbx - 1);
  } else {
    by = compact_bits(t);
    bx = compact_bits(t >> 1);
  }
  const long long row = first + ((long long)by << lx);
  const uint32_t rx = (bx + 1) & (nbx - 1);
  const uint32_t ry = (by + 1) & (2 * nbx - 1);
  const uint4* blocks = reinterpret_cast<const uint4*>(mod);

  uint32_t w[8];  // row py: pixels 0-3 in w[2 py], 4-7 in w[2 py + 1]
  {
    const uint4 q0 = blocks[2 * (row + bx)], q1 = blocks[2 * (row + bx) + 1];
    w[0] = q0.x; w[1] = q0.y; w[2] = q0.z; w[3] = q0.w;
    w[4] = q1.x; w[5] = q1.y; w[6] = q1.z; w[7] = q1.w;
  }
  // The right neighbour's pixel 0 of rows 0-3 (byte py), the lower
  // neighbour's row 0.
  uint32_t right = 0, below0 = 0, below1 = 0;
  bool load_right = true, load_below = true;
  if (kDesign == kSlotShuffle) {
    const uint32_t xs = 0xAAAAAAAAu & last, ys = 0x55555555u & last;
    const uint32_t sr = (((t | ~xs) + 2) & xs) | (t & ys);
    const uint32_t sb = (((t | ~ys) + 1) & ys) | (t & xs);
    const uint32_t lane0 = uint32_t(first);
    right = __shfl_sync(0xFFFFFFFFu, column0(w[0], w[2], w[4], w[6]),
                        (lane0 + sr) & 31);
    below0 = __shfl_sync(0xFFFFFFFFu, w[0], (lane0 + sb) & 31);
    below1 = __shfl_sync(0xFFFFFFFFu, w[1], (lane0 + sb) & 31);
    load_right = (sr ^ t) >> 5;
    load_below = (sb ^ t) >> 5;
  }
  if (load_right) {
    const uint4 r0 = blocks[2 * (row + rx)], r1 = blocks[2 * (row + rx) + 1];
    right = column0(r0.x, r0.z, r1.x, r1.z);
  }
  if (load_below) {
    const uint2 b = reinterpret_cast<const uint2*>(
        mod)[4 * (first + ((long long)ry << lx) + bx)];
    below0 = b.x;
    below1 = b.y;
  }

  const uint2 rec = mode_record(w, right, below0, below1, ab + row + bx);
  if (live) {
    const long long slot =
        kDesign == kRowMajor ? first + (spread_bits(by) | (spread_bits(bx) << 1))
                             : n;
    out[slot] = rec;
  }
}

// Mode + pack of one strip of a taller image (the block rows of one "data"
// shard of an atlas, dist/mesh.py), an (nby, nbx) power-of-two grid with
// nby as small as 1, in the kRowMajor layout: thread n takes row-major block
// n and stores its record to out[n]; the Z-order permutation of the whole
// atlas is applied once to the gathered strips. The pixel right of px = 7
// wraps within the block row; the row below the strip's last block row is
// halo_v, the next strip's first modulation row group (bytes 0-7, py = 0,
// of its first nbx blocks, 8 bytes a block). Replaces the halo path of
// texcomp/ops/pvrtc_fast.py:_mode_edges (halo_v) feeding _mpc_kernel; the
// bound is modes_pack_kernel's, per block.
__global__ void __launch_bounds__(kThreads)
modes_pack_strip_kernel(const uint8_t* __restrict__ mod,
                        const uint2* __restrict__ ab,
                        const uint2* __restrict__ halo_v, int nby, int nbx,
                        uint2* __restrict__ out) {
  const int lx = __ffs(nbx) - 1;
  const long long n = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (n >= (long long)nby << lx) return;
  const uint32_t by = uint32_t(n >> lx), bx = uint32_t(n) & (nbx - 1);
  const long long row = (long long)by << lx;
  const uint32_t rx = (bx + 1) & (nbx - 1);
  const uint4* blocks = reinterpret_cast<const uint4*>(mod);

  uint32_t w[8];
  {
    const uint4 q0 = blocks[2 * n], q1 = blocks[2 * n + 1];
    w[0] = q0.x; w[1] = q0.y; w[2] = q0.z; w[3] = q0.w;
    w[4] = q1.x; w[5] = q1.y; w[6] = q1.z; w[7] = q1.w;
  }
  const uint4 r0 = blocks[2 * (row + rx)], r1 = blocks[2 * (row + rx) + 1];
  const uint32_t right = column0(r0.x, r0.z, r1.x, r1.z);
  const uint2 b = by + 1 < uint32_t(nby)
      ? reinterpret_cast<const uint2*>(mod)[4 * (n + nbx)]
      : halo_v[bx];
  out[n] = mode_record(w, right, b.x, b.y, ab + n);
}

inline int grid_for(long long n) { return int((n + kThreads - 1) / kThreads); }

template <int kDesign>
int launch_modes_pack(const void* mod, const void* ab, int batch, int nby,
                      int nbx, void* out, void* stream) {
  const long long total = (long long)batch * nby * nbx;
  modes_pack_kernel<kDesign><<<grid_for(total), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mod), static_cast<const uint2*>(ab), total,
      nbx, static_cast<uint2*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int texcomp_pvrtc_morph(const void* img, int nby, int nbx, const void* origin,
                        void* ab, void* stream) {
  morph_kernel<false><<<grid_for((long long)nby * nbx), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(img), 1, nby, nbx,
      static_cast<const uint32_t*>(origin), static_cast<uint2*>(ab));
  return int(cudaGetLastError());
}

int texcomp_pvrtc_morph_batched(const void* img, int batch, int nby, int nbx,
                                void* ab, void* stream) {
  morph_kernel<true><<<grid_for((long long)batch * nby * nbx), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(img), batch, nby, nbx, nullptr,
      static_cast<uint2*>(ab));
  return int(cudaGetLastError());
}

int texcomp_pvrtc_upscale_modulate(const void* img, const void* ab, int batch,
                                   int nby, int nbx, void* mod, void* stream) {
  upscale_modulate_kernel<<<grid_for((long long)batch * nby * nbx), kThreads,
                            0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(img), static_cast<const uint2*>(ab), batch,
      nby, nbx, static_cast<uint4*>(mod));
  return int(cudaGetLastError());
}

// Upscale + modulate of an (nby, nbx) strip whose low-res rows above and
// below are the (nbx,) rows halo_top and halo_bot.
int texcomp_pvrtc_upscale_modulate_halo(const void* img, const void* ab,
                                        const void* halo_top,
                                        const void* halo_bot, int nby, int nbx,
                                        void* mod, void* stream) {
  upscale_modulate_halo_kernel<<<grid_for((long long)nby * nbx), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(img), static_cast<const uint2*>(ab),
      static_cast<const uint2*>(halo_top), static_cast<const uint2*>(halo_bot),
      nby, nbx, static_cast<uint4*>(mod));
  return int(cudaGetLastError());
}

int texcomp_pvrtc_modes_pack(const void* mod, const void* ab, int batch,
                             int nby, int nbx, void* out, void* stream) {
  return launch_modes_pack<kSlotLoad>(mod, ab, batch, nby, nbx, out, stream);
}

// Mode + pack of an (nby, nbx) strip whose modulation row below is the
// (nbx, 8) bytes halo_v; records row-major.
int texcomp_pvrtc_modes_pack_strip(const void* mod, const void* ab,
                                   const void* halo_v, int nby, int nbx,
                                   void* out, void* stream) {
  modes_pack_strip_kernel<<<grid_for((long long)nby * nbx), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mod), static_cast<const uint2*>(ab),
      static_cast<const uint2*>(halo_v), nby, nbx, static_cast<uint2*>(out));
  return int(cudaGetLastError());
}

// Mode + pack in design `design` (PackDesign), for chip_smoke.py's probe.
int texcomp_pvrtc_modes_pack_design(int design, const void* mod,
                                    const void* ab, int batch, int nby,
                                    int nbx, void* out, void* stream) {
  switch (design) {
    case kSlotShuffle:
      return launch_modes_pack<kSlotShuffle>(mod, ab, batch, nby, nbx, out, stream);
    case kSlotLoad:
      return launch_modes_pack<kSlotLoad>(mod, ab, batch, nby, nbx, out, stream);
    case kRowMajor:
      return launch_modes_pack<kRowMajor>(mod, ab, batch, nby, nbx, out, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// Registers per thread, static shared memory in bytes, and resident CTAs
// per SM of kernel 0 (the morph), 1 (the batched morph), 2 (upscale +
// modulate), 3 (mode + pack), 4 (upscale + modulate with halo rows) or 5
// (mode + pack of a strip), into out[0..2].
int texcomp_pvrtc_info(int kernel, int* out) {
  const void* fns[6] = {reinterpret_cast<const void*>(morph_kernel<false>),
                        reinterpret_cast<const void*>(morph_kernel<true>),
                        reinterpret_cast<const void*>(upscale_modulate_kernel),
                        reinterpret_cast<const void*>(modes_pack_kernel<kSlotLoad>),
                        reinterpret_cast<const void*>(upscale_modulate_halo_kernel),
                        reinterpret_cast<const void*>(modes_pack_strip_kernel)};
  if (kernel < 0 || kernel > 5) return int(cudaErrorInvalidValue);
  return texcomp::kernel_info(fns[kernel], kThreads, out);
}

}  // extern "C"
