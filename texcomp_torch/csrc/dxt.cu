// DXT1 (BC1) and DXT5 (BC3) encode, decode and one fused mip level for
// Hopper (sm_90a).
//
// Three kernels (each for DXT1 and DXT5), one thread per 4x4 block,
// integer arithmetic only. Each is byte-exact with the plain PyTorch codec
// in texcomp_torch/codecs/dxt.py, which follows the reference's
// dxtc_compressor.cc. The entry points at the
// bottom have a plain C interface: pointers, ints and a stream, returning
// cudaGetLastError() so the caller sees a refused launch.
//
// Tie-breaks are the reference's: the first pixel at the min/max
// luminance, and strict '<' across palette entries 0..3 and alpha ramp
// entries 0..7, both in scan order y*4+x.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLutBytes = 256 * 8;

__device__ __forceinline__ int ext5(int v) { return (v << 3) | (v >> 2); }
__device__ __forceinline__ int ext6(int v) { return (v << 2) | (v >> 4); }

// Blinn's exact 8-bit -> `bits` quantization (color_util.h:156-164).
__device__ __forceinline__ int q8(int v, int bits) {
  const int i = v * ((1 << bits) - 1) + 128;
  return (i + (i >> 8)) >> 8;
}

__device__ __forceinline__ int pack565(int r5, int g6, int b5) {
  return (r5 << 11) | (g6 << 5) | b5;
}

__device__ __forceinline__ int lum(int r, int g, int b) {
  return 4 * r + 8 * g + b;
}

// CombineIntFast on non-negative operands: C '/' truncates, which equals
// the reference's division, and a constant divisor is strength-reduced.
template <int S0, int S1>
__device__ __forceinline__ int combine(int v0, int v1) {
  return (S0 * v0 + S1 * v1) / (S0 + S1);
}

__device__ __forceinline__ int diff_lum_err(int r0, int g0, int b0, int r1,
                                            int g1, int b1) {
  const int d = lum(abs(r0 - r1), abs(g0 - g1), abs(b0 - b1));
  return d * d;
}

// GetBestDxtcConstColors (dxtc_const_color_table.cc:322-392). `lut` is the
// 256x8 const-color table (in shared memory for the fused levels, in global
// memory for the encode): row = channel value, columns
// [r/b 1/3 pair, r/b 1/2 pair, g 1/3 pair, g 1/2 pair].
__device__ void best_const_colors(const uint8_t* lut, int tr, int tg, int tb,
                                  bool always4, uint32_t& which,
                                  uint32_t& c0, uint32_t& c1) {
  const int sr = q8(tr, 5), sg = q8(tg, 6), sb = q8(tb, 5);
  const uint32_t single = pack565(sr, sg, sb);
  int min_err = diff_lum_err(tr, tg, tb, ext5(sr), ext6(sg), ext5(sb));
  which = 0;
  c0 = single;
  c1 = single;
  const uint8_t* lr = lut + 8 * tr;
  const uint8_t* lg = lut + 8 * tg;
  const uint8_t* lb = lut + 8 * tb;
  if (!always4) {
    const int h0r = lr[2], h0g = lg[6], h0b = lb[2];
    const int h1r = lr[3], h1g = lg[7], h1b = lb[3];
    const int err = diff_lum_err(
        tr, tg, tb, combine<1, 1>(ext5(h0r), ext5(h1r)),
        combine<1, 1>(ext6(h0g), ext6(h1g)),
        combine<1, 1>(ext5(h0b), ext5(h1b)));
    if (err < min_err) {
      const uint32_t h0 = pack565(h0r, h0g, h0b);
      const uint32_t h1 = pack565(h1r, h1g, h1b);
      which = 2;  // halves need c0 < c1 (3-color decode)
      c0 = min(h0, h1);
      c1 = max(h0, h1);
      min_err = err;
    }
  }
  const int t0r = lr[0], t0g = lg[4], t0b = lb[0];
  const int t1r = lr[1], t1g = lg[5], t1b = lb[1];
  const int err = diff_lum_err(
      tr, tg, tb, combine<2, 1>(ext5(t0r), ext5(t1r)),
      combine<2, 1>(ext6(t0g), ext6(t1g)), combine<2, 1>(ext5(t0b), ext5(t1b)));
  if (err < min_err) {
    // Thirds need c0 > c1; otherwise flip and use the 2/3 point.
    const uint32_t t0 = pack565(t0r, t0g, t0b);
    const uint32_t t1 = pack565(t1r, t1g, t1b);
    const bool gt = t0 > t1;
    which = gt ? 2 : 3;
    c0 = gt ? t0 : t1;
    c1 = gt ? t1 : t0;
  }
}

// The nearest searches below take the reference's first k with the least
// (x - v_k)^2 (strict '<' in order k = 0, 1, ...) as the least key
// (x - v_k)^2 * 2^s + k, 2^s > the largest k. Less the term x^2 * 2^s,
// common to every candidate, the key is linear in x: one multiply-add a
// candidate, x * (-2^(s+1) v_k) + (2^s v_k^2 + k), and the code is the
// key's low s bits. The keys are negative for most x, so the code is taken
// by `&` (two's complement), never by `%` or an arithmetic shift.

// The back half of EncodeDxt1Block (dxtc_compressor.cc:482-513): the
// block's base colours of least (lo*) and greatest (hi*) luminance, their
// channels already swapped for BGR, and the luminance l[i] of each pixel.
// Returns the two little-endian words of the 8-byte block: c0 | c1 << 16,
// then the four index rows.
__device__ __forceinline__ uint2 encode_color_bases(
    int lor, int log_, int lob, int hir, int hig, int hib, const int (&l)[16],
    const uint8_t* lut, bool swap, bool always4) {
  const uint32_t lo16 = pack565(q8(lor, 5), q8(log_, 6), q8(lob, 5));
  const uint32_t hi16 = pack565(q8(hir, 5), q8(hig, 6), q8(hib, 5));

  uint32_t c0, c1, rows;
  if (lo16 == hi16) {
    // Constant-color path on base color 0, swapped back to source order
    // for BGR: the reference swaps it twice (dxtc_compressor.cc:360).
    uint32_t which;
    best_const_colors(lut, swap ? lob : lor, log_, swap ? lor : lob, always4,
                      which, c0, c1);
    rows = which * 0x55555555u;
  } else {
    const bool flip = lo16 < hi16;
    const int b0r = flip ? hir : lor, b0g = flip ? hig : log_,
              b0b = flip ? hib : lob;
    const int b1r = flip ? lor : hir, b1g = flip ? log_ : hig,
              b1b = flip ? lob : hib;
    c0 = max(lo16, hi16);
    c1 = min(lo16, hi16);
    const int p0 = lum(b0r, b0g, b0b);
    const int p1 = lum(b1r, b1g, b1b);
    const int p2 = lum(combine<2, 1>(b0r, b1r), combine<2, 1>(b0g, b1g),
                       combine<2, 1>(b0b, b1b));
    const int p3 = lum(combine<1, 2>(b0r, b1r), combine<1, 2>(b0g, b1g),
                       combine<1, 2>(b0b, b1b));
    // Keys with s = 2; luminances lie in 0..3315, so |key| < 44 M.
    int m0 = -8 * p0, m1 = -8 * p1, m2 = -8 * p2, m3 = -8 * p3;
    // Opaque to the compiler, which would otherwise factor each key into
    // p_j * (4 p_j - 8 x) + j: two multiply-adds a candidate, not one.
    asm("" : "+r"(m0), "+r"(m1), "+r"(m2), "+r"(m3));
    const int k0 = 4 * p0 * p0, k1 = 4 * p1 * p1 + 1, k2 = 4 * p2 * p2 + 2,
              k3 = 4 * p3 * p3 + 3;
    rows = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int x = l[i];
      const int key = min(min(x * m0 + k0, x * m1 + k1),
                          min(x * m2 + k2, x * m3 + k3));
      rows |= uint32_t(key & 3) << (2 * i);  // pixel (y, x) at bit 8y + 2x
    }
  }
  return make_uint2(c0 | (c1 << 16), rows);
}

// EncodeDxt1Block (dxtc_compressor.cc:482-513) on a block whose channels
// are already swapped for BGR: the first pixels of least and greatest
// luminance by a select scan, then encode_color_bases. The fused levels'
// encode; the encode kernel finds its base colours by luminance keys.
__device__ uint2 encode_color(const int (&r)[16], const int (&g)[16],
                              const int (&b)[16], const uint8_t* lut,
                              bool swap, bool always4) {
  int l[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) l[i] = lum(r[i], g[i], b[i]);

  int lo = l[0], hi = l[0];
  int lor = r[0], log_ = g[0], lob = b[0];
  int hir = r[0], hig = g[0], hib = b[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    if (l[i] < lo) { lo = l[i]; lor = r[i]; log_ = g[i]; lob = b[i]; }
    if (l[i] > hi) { hi = l[i]; hir = r[i]; hig = g[i]; hib = b[i]; }
  }
  return encode_color_bases(lor, log_, lob, hir, hig, hib, l, lut, swap,
                            always4);
}

// Bit 8n + 7 set where byte n of v is 0, every other bit clear.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t v) {
  return ~(((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v | 0x7F7F7F7Fu);
}

// ComputeBaseAlphas + ComputeAlphaBits (dxtc_compressor.cc:374-479).
// Returns the first two little-endian words of the 16-byte DXT5 block.
__device__ uint2 encode_alpha(const int (&a)[16], bool outside) {
  if (outside) {
    // has_one_pixel: both endpoints are pixel 0 and every code is 0.
    return make_uint2(uint32_t(a[0]) | (uint32_t(a[0]) << 8), 0u);
  }
  // The 0s and 255s counted four alphas at a time, one a byte: byte n of
  // v is 0 exactly where bit 8n + 7 of zero_bytes(v) is set (no carry
  // crosses a byte). The least and greatest alpha strictly between 0 and
  // 255 as unsigned minima of a - 1 and of 254 - a, where a 0 (a 255)
  // wraps above every alpha in range.
  int num_t = 0, num_o = 0;
  uint32_t low1 = 0xFFFFFFFFu, high1 = 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t v = __byte_perm(__byte_perm(a[4 * j], a[4 * j + 1], 0x40),
                                   __byte_perm(a[4 * j + 2], a[4 * j + 3], 0x40),
                                   0x5410);
    num_t += __popc(zero_bytes(v));
    num_o += __popc(zero_bytes(~v));
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    low1 = min(low1, uint32_t(a[i]) - 1u);
    high1 = min(high1, 254u - uint32_t(a[i]));
  }
  // No alpha between 0 and 255: low 0 and high 255.
  const bool any_mid = low1 < 254u;
  const int low = any_mid ? int(low1) + 1 : 0;
  const int high = any_mid ? 254 - int(high1) : 255;
  const bool explicit_mode = num_t > 1 || num_o > 1;
  const int a0 = explicit_mode ? low : (num_o > 0 ? 255 : high);
  const int a1 = explicit_mode ? high : (num_t > 0 ? 0 : low);

  int ramp[8];
  ramp[0] = a0;
  ramp[1] = a1;
  if (a0 <= a1) {
    ramp[2] = combine<4, 1>(a0, a1);
    ramp[3] = combine<3, 2>(a0, a1);
    ramp[4] = combine<2, 3>(a0, a1);
    ramp[5] = combine<1, 4>(a0, a1);
    ramp[6] = 0;
    ramp[7] = 255;
  } else {
    ramp[2] = combine<6, 1>(a0, a1);
    ramp[3] = combine<5, 2>(a0, a1);
    ramp[4] = combine<4, 3>(a0, a1);
    ramp[5] = combine<3, 4>(a0, a1);
    ramp[6] = combine<2, 5>(a0, a1);
    ramp[7] = combine<1, 6>(a0, a1);
  }
  // Keys with s = 3; alphas lie in 0..255, so keys in [-520200, 520207].
  int m[8], k[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = -16 * ramp[j];
    asm("" : "+r"(m[j]));  // as in encode_color_bases: one multiply-add a key
    k[j] = 8 * ramp[j] * ramp[j] + j;
  }
  uint32_t half0 = 0, half1 = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int x = a[i];
    const int key = min(min(min(x * m[0] + k[0], x * m[1] + k[1]),
                            min(x * m[2] + k[2], x * m[3] + k[3])),
                        min(min(x * m[4] + k[4], x * m[5] + k[5]),
                            min(x * m[6] + k[6], x * m[7] + k[7])));
    const uint32_t code = key & 7;
    if (i < 8) half0 |= code << (3 * i);
    else half1 |= code << (3 * (i - 8));
  }
  return make_uint2(uint32_t(a0) | (uint32_t(a1) << 8) | ((half0 & 0xFFFFu) << 16),
                    (half0 >> 16) | (half1 << 8));
}

// Replaces texcomp/ops/dxt_pallas.py:_dxt1_kernel and :_dxt5_kernel, and
// with them the TPU-side edge pad, u32 pack, block transposes and
// words_to_blocks of dxtc_encode_padded_image.
//
// Reads an (h, w, channels) uint8 image as it arrives and writes
// (nbr * nbc, 8 | 16) uint8 blocks. Pixels outside the valid extent
// replicate the edge by clamped coordinates (Pixel4x4, pixel4x4.cc:44-53);
// a block wholly outside in both dimensions is has_one_pixel
// (pixel4x4.cc:56-58). A block on the constant-colour path reads the
// const-color table from global memory through the L1 cache; copying the
// table into shared memory cost every CTA a serial prologue of byte loads
// and a barrier before its first pixel load.
//
// Bound on the H100: memory traffic by its bytes (a 4096^2 RGB encode
// reads 48 MiB and writes 8 MiB), but integer issue in practice: with byte
// loads, a compare and two selects a (pixel, candidate) and selects that
// carried three channels through the min/max scan, a DXT5 block took some
// 1,900 instructions. So each pixel is one packed word, loaded by vector
// loads where the block allows; the first pixels of least and greatest
// luminance come from one key a pixel each (lum * 16 + i by __dp4a, and
// its mirror for the maximum), and the palette and alpha searches are one
// multiply-add and one min a candidate (the keys above).
//
// Block (by, bx)'s 16 pixels as words c0 | c1 << 8 | c2 << 16 | c3 << 24 in
// source channel order and scan order y*4+x: c3 is alpha with 4 channels,
// a pad byte of any value with 3 (the searches give it weight 0). A block
// wholly inside an image whose base and row stride are aligned takes
// vector loads: a 16-byte row of RGBA, or a 12-byte row of RGB as three
// 4-byte words regrouped by byte permutes. Every other block (the ragged
// right and bottom edges, an unaligned view) takes byte loads at clamped
// coordinates, which replicate the edge pixel. Both give the same channels.
__device__ __forceinline__ void load_block(const uint8_t* __restrict__ img,
                                           int channels, int h, int w, int by,
                                           int bx, uint32_t (&px)[16]) {
  const long long stride = (long long)w * channels;
  const uintptr_t base = reinterpret_cast<uintptr_t>(img);
  const bool inside = 4 * by + 4 <= h && 4 * bx + 4 <= w && (w & 3) == 0;
  if (channels == 4 && inside && (base & 15) == 0) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          img + (4LL * by + y) * stride + 16LL * bx));
      px[4 * y] = v.x;
      px[4 * y + 1] = v.y;
      px[4 * y + 2] = v.z;
      px[4 * y + 3] = v.w;
    }
  } else if (channels == 3 && inside && (base & 3) == 0) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(
          img + (4LL * by + y) * stride + 12LL * bx);
      const uint32_t u0 = __ldg(row), u1 = __ldg(row + 1), u2 = __ldg(row + 2);
      // u0 = r0 g0 b0 r1, u1 = g1 b1 r2 g2, u2 = b2 r3 g3 b3 (byte 0 first).
      px[4 * y] = u0;
      px[4 * y + 1] = __byte_perm(u0, u1, 0x6543);
      px[4 * y + 2] = __byte_perm(u1, u2, 0x5432);
      px[4 * y + 3] = u2 >> 8;
    }
  } else {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const uint8_t* row = img + min(4 * by + y, h - 1) * stride;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const uint8_t* p = row + min(4 * bx + x, w - 1) * channels;
        px[4 * y + x] = uint32_t(p[0]) | (uint32_t(p[1]) << 8) |
                        (uint32_t(p[2]) << 16) |
                        (channels == 4 ? uint32_t(p[3]) << 24 : 0u);
      }
    }
  }
}

// __dp4a weights of a packed pixel's luminance 4r + 8g + b times 16: r in
// byte 0 (kLumKey) or, for BGR, in byte 2 (kLumKeySwap); byte 3 weighs 0.
// The unsigned overload: a weight of 128 is no signed byte.
constexpr uint32_t kLumKey = 0x00108040u;
constexpr uint32_t kLumKeySwap = 0x00408010u;

__device__ __forceinline__ void channels_of(uint32_t p, bool swap, int& r,
                                            int& g, int& b) {
  const int c0 = p & 255, c2 = (p >> 16) & 255;
  r = swap ? c2 : c0;
  g = (p >> 8) & 255;
  b = swap ? c0 : c2;
}

// n / d for 0 <= n < 2^31 as (n * m) >> s, with l = ceil(log2 d),
// m = floor(2^(31 + l) / d) + 1 and s = 31 + l (Granlund and Montgomery,
// "Division by invariant integers using multiplication", 1994, Thm 4.2):
// one wide multiply and a shift a thread where a division by a kernel
// argument is some twenty instructions.
struct DivMagic {
  unsigned long long m;
  int s;
};

inline DivMagic div_magic(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  return {(1ULL << (31 + l)) / unsigned(d) + 1, 31 + l};
}

template <bool kDxt5>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint8_t* __restrict__ img, int channels, int h, int w,
              int nbr, int nbc, DivMagic row_div,
              const uint8_t* __restrict__ lut_global,
              uint8_t* __restrict__ out, bool swap, bool always4) {
  // Each thread's 16 pixel words, word j at j * kThreads + thread: the two
  // base colours are read back by index, which a register array cannot
  // be without going to local memory.
  __shared__ uint32_t stage[16 * kThreads];

  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long total = (long long)nbr * nbc;
  if (n >= total) return;
  int by, bx;
  if (total <= 0x7FFFFFFF) {  // n < 2^31: by row_div, not the 64-bit routine
    by = int((static_cast<unsigned long long>(n) * row_div.m) >> row_div.s);
    bx = int(n) - by * nbc;
  } else {
    by = int(n / nbc);
    bx = int(n % nbc);
  }

  uint32_t px[16];
  load_block(img, kDxt5 ? 4 : channels, h, w, by, bx, px);

  // First minimum of lum * 16 + i and first maximum of lum * 16 + 15 - i:
  // each key carries its pixel's index in its low 4 bits.
  const uint32_t weights = swap ? kLumKeySwap : kLumKey;
  int l[16];
  int kmin = 0x7FFFFFFF, kmax = -1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int key = int(__dp4a(px[i], weights, uint32_t(i)));
    kmin = min(kmin, key);
    kmax = max(kmax, key + 15 - 2 * i);
    l[i] = key >> 4;
  }
  const int lo = kmin & 15, hi = 15 - (kmax & 15);
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 16; ++j) stage[j * kThreads + t] = px[j];
  const uint32_t plo = stage[lo * kThreads + t];
  const uint32_t phi = stage[hi * kThreads + t];
  int lor, log_, lob, hir, hig, hib;
  channels_of(plo, swap, lor, log_, lob);
  channels_of(phi, swap, hir, hig, hib);

  if (kDxt5) {
    int a[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = px[i] >> 24;
    const bool outside = 4 * by >= h && 4 * bx >= w;
    const uint2 alpha = encode_alpha(a, outside);
    const uint2 color = encode_color_bases(lor, log_, lob, hir, hig, hib, l,
                                           lut_global, swap, true);
    reinterpret_cast<uint4*>(out)[n] = make_uint4(alpha.x, alpha.y, color.x, color.y);
  } else {
    reinterpret_cast<uint2*>(out)[n] = encode_color_bases(
        lor, log_, lob, hir, hig, hib, l, lut_global, swap, always4);
  }
}

__device__ __forceinline__ uint32_t select4(uint32_t code, uint32_t v0,
                                            uint32_t v1, uint32_t v2,
                                            uint32_t v3) {
  return code == 0 ? v0 : code == 1 ? v1 : code == 2 ? v2 : v3;
}

// DecodeColors (dxtc_compressor.cc:167-192): the 4-entry palette of
// packed r | g << 8 | b << 16 pixels from the color word c0 | c1 << 16.
// `swap` swaps the endpoint channels; interpolation is channelwise.
__device__ void decode_palette(uint32_t cw, bool swap, bool always4,
                               uint32_t (&pal)[4]) {
  const int c0 = cw & 0xFFFF, c1 = cw >> 16;
  int e0[3] = {ext5(c0 >> 11), ext6((c0 >> 5) & 63), ext5(c0 & 31)};
  int e1[3] = {ext5(c1 >> 11), ext6((c1 >> 5) & 63), ext5(c1 & 31)};
  if (swap) {
    int t = e0[0]; e0[0] = e0[2]; e0[2] = t;
    t = e1[0]; e1[0] = e1[2]; e1[2] = t;
  }
  const bool equal = c0 == c1;
  const bool four = always4 || c0 > c1;
  pal[0] = pal[1] = pal[2] = pal[3] = 0;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int v0 = e0[ch], v1 = e1[ch];
    const int v2 = equal ? v1 : four ? combine<2, 1>(v0, v1) : combine<1, 1>(v0, v1);
    const int v3 = equal ? v1 : four ? combine<1, 2>(v0, v1) : 0;
    pal[0] |= uint32_t(v0) << (8 * ch);
    pal[1] |= uint32_t(v1) << (8 * ch);
    pal[2] |= uint32_t(v2) << (8 * ch);
    pal[3] |= uint32_t(v3) << (8 * ch);
  }
}

// DecodeAlphaValues (dxtc_compressor.cc:195-217) of the DXT5 block whose
// first two little-endian words are w0 and w1: the 8-entry ramp, and the
// 48-bit code field split into two 24-bit halves (pixels 0-7 and 8-15).
__device__ __forceinline__ void decode_alpha(uint32_t w0, uint32_t w1,
                                             uint32_t (&alpha)[8],
                                             uint32_t& half0,
                                             uint32_t& half1) {
  const int a0 = w0 & 255, a1 = (w0 >> 8) & 255;
  half0 = ((w0 >> 16) & 0xFFFFu) | ((w1 & 255u) << 16);
  half1 = (w1 >> 8) & 0xFFFFFFu;
  alpha[0] = a0;
  alpha[1] = a1;
  if (a0 > a1) {
    alpha[2] = combine<6, 1>(a0, a1);
    alpha[3] = combine<5, 2>(a0, a1);
    alpha[4] = combine<4, 3>(a0, a1);
    alpha[5] = combine<3, 4>(a0, a1);
    alpha[6] = combine<2, 5>(a0, a1);
    alpha[7] = combine<1, 6>(a0, a1);
  } else {
    alpha[2] = combine<4, 1>(a0, a1);
    alpha[3] = combine<3, 2>(a0, a1);
    alpha[4] = combine<2, 3>(a0, a1);
    alpha[5] = combine<1, 4>(a0, a1);
    alpha[6] = 0;
    alpha[7] = 255;
  }
}

// The alpha of pixel i (scan order y*4+x): a select chain over the ramp,
// not an indexed register array.
__device__ __forceinline__ uint32_t alpha_at(int i, uint32_t half0,
                                             uint32_t half1,
                                             const uint32_t (&alpha)[8]) {
  const uint32_t code = ((i < 8 ? half0 : half1) >> (3 * (i & 7))) & 7;
  uint32_t av = alpha[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) av = code == uint32_t(k) ? alpha[k] : av;
  return av;
}

// Replaces texcomp/ops/dxt_pallas.py:_dxt1_decode_kernel and
// :_dxt5_decode_kernel, and with them blocks_to_words and
// _unblock_transpose_u32.
//
// Reads (nbr * nbc, 8 | 16) uint8 blocks and writes the
// (4 * nbr, 4 * nbc, 4) uint8 image directly: RGBX with X = 0 for DXT1,
// RGBA for DXT5 (DecodeAlphaValues, dxtc_compressor.cc:195-217). Each
// thread writes its block's 4 rows as one 16-byte store each.
//
// Bound on the H100: memory traffic. A 4096^2 DXT1 decode reads 8 MiB and
// writes 64 MiB. This first version is one thread per block; rows of
// neighbouring threads are 16 bytes apart, so each store instruction of a
// warp touches 512 contiguous bytes.
template <bool kDxt5>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint8_t* __restrict__ blocks, int nbr, int nbc,
              uint8_t* __restrict__ out, bool swap, bool always4) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)nbr * nbc) return;
  const int by = int(n / nbc), bx = int(n % nbc);

  uint32_t cw, iw;
  uint32_t alpha[8];
  uint32_t half0 = 0, half1 = 0;
  if (kDxt5) {
    const uint4 v = reinterpret_cast<const uint4*>(blocks)[n];
    cw = v.z;
    iw = v.w;
    decode_alpha(v.x, v.y, alpha, half0, half1);
  } else {
    const uint2 v = reinterpret_cast<const uint2*>(blocks)[n];
    cw = v.x;
    iw = v.y;
  }

  uint32_t pal[4];
  decode_palette(cw, swap, kDxt5 || always4, pal);

  uint4* dst = reinterpret_cast<uint4*>(out);
  const long long row_quads = nbc;  // one uint4 per block per image row
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    uint32_t px[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 4 * y + x;
      px[x] = select4((iw >> (2 * i)) & 3, pal[0], pal[1], pal[2], pal[3]);
      if (kDxt5) px[x] |= alpha_at(i, half0, half1, alpha) << 24;
    }
    dst[(4LL * by + y) * row_quads + bx] = make_uint4(px[0], px[1], px[2], px[3]);
  }
}

// The fused level's decode works on byte planes: a channel's 4-entry
// palette (or the 8-entry alpha ramp) packed one entry a byte, looked up
// for a whole row of 4 pixels by one byte permute whose selector holds the
// row's codes, one a nibble. Every selector nibble is 0..7 (bit 3 clear),
// where __byte_perm and PRMT's default mode agree.

// DecodeColors (dxtc_compressor.cc:167-192) of the color word c0 | c1 << 16,
// swap-free, as three planes (r, g, b): entry k of a channel in byte k.
// decode_palette's rules: four colors when always4 or c0 > c1, otherwise
// v2 = (v0 + v1) / 2 and v3 = 0, except that c0 == c1 gives v2 = v3 = v1.
// With c0 == c1 every channel has v0 == v1, where both interpolants of the
// four-color mode equal v1, so v3 is the four-color one or 0.
__device__ __forceinline__ void palette_planes(uint32_t cw, bool always4,
                                               uint32_t (&plane)[3]) {
  const int c0 = cw & 0xFFFF, c1 = cw >> 16;
  const int e0[3] = {ext5(c0 >> 11), ext6((c0 >> 5) & 63), ext5(c0 & 31)};
  const int e1[3] = {ext5(c1 >> 11), ext6((c1 >> 5) & 63), ext5(c1 & 31)};
  const bool four = always4 || c0 > c1;
  const bool has_v3 = four || c0 == c1;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int v0 = e0[ch], v1 = e1[ch];
    const int v2 = four ? combine<2, 1>(v0, v1) : combine<1, 1>(v0, v1);
    const int v3 = has_v3 ? combine<1, 2>(v0, v1) : 0;
    plane[ch] = uint32_t(v0) | (uint32_t(v1) << 8) | (uint32_t(v2) << 16) |
                (uint32_t(v3) << 24);
  }
}

// Selectors of the index word's four rows (pixel (y, x) at bit 8y + 2x):
// nibble x of sel[y] is the code of pixel (y, x). Each pair of rows is one
// byte permute that puts them in bytes 0 and 2, then two shift-and-mask
// steps that spread the 2-bit codes into nibbles; a byte permute reads
// only a selector's low 16 bits.
__device__ __forceinline__ void color_selectors(uint32_t iw, uint32_t (&sel)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t x = __byte_perm(iw, 0u, h ? 0x4342 : 0x4140);
    x = (x | (x << 4)) & 0x0F0F0F0Fu;
    x = (x | (x << 2)) & 0x33333333u;
    sel[2 * h] = x;
    sel[2 * h + 1] = x >> 16;
  }
}

// The 24-bit code field of two rows of alpha (decode_alpha's half0 or
// half1: pixel n's 3-bit code at bit 3n) spread into nibble n.
__device__ __forceinline__ uint32_t alpha_selectors(uint32_t half) {
  uint32_t x = (half & 0xFFFu) | ((half << 4) & 0x0FFF0000u);
  x = (x & 0x003F003Fu) | ((x << 2) & 0x3F003F00u);
  return (x & 0x07070707u) | ((x << 1) & 0x70707070u);
}

// Destination pixel i (0 or 1) of one row of a quadrant: the sum of bytes
// 2i and 2i + 1 of the two source row words of one channel, then `>> 2`,
// the truncating average (ComputeAveragePixel2x2) of its non-negative
// sum, at most 1020. Two unsigned __dp4a a value, on the multiply-add
// pipe; summing in 16-bit lanes on the integer pipe took more
// instructions and was slower.
__device__ __forceinline__ void quad_pair(uint32_t top, uint32_t bottom,
                                          int& v0, int& v1) {
  v0 = int(__dp4a(top, 0x00000101u, __dp4a(bottom, 0x00000101u, 0u)) >> 2);
  v1 = int(__dp4a(top, 0x01010000u, __dp4a(bottom, 0x01010000u, 0u)) >> 2);
}

// Replaces texcomp/ops/dxt_pallas.py:_dxt1_down_kernel and
// :_dxt5_down_kernel, and with them the grouping transpose of
// dxtc_downsample_encode_words and the bf16 one-hot matmul that averaged
// and regrouped the pixels (_avg_regroup, _p4_matrix).
//
// One fused mip level: destination block (dy, dx) of the (nby/2, nbx/2)
// grid reads its four source blocks at rows 2dy + {0, 1} and columns
// 2dx + {0, 1} straight from the (nby * nbx, 8 | 16) payload. Source block
// s = 2 sy + sx is destination quadrant s, averaged in 2x2 groups, so each
// source block yields 4 finished destination pixels and nothing sums
// across blocks. A block is decoded swap-free (DXT1 colors by the c0 > c1
// rule, DXT5 colors in four-color mode and the alpha ramp) a row at a
// time: one byte permute per channel and row gives the row's 4 values
// (palette_planes, color_selectors, alpha_selectors), and each 2x2 sum
// comes straight from two row words (quad_pair). The block is then encoded
// as the Downsample path encodes it (compressor4x4_helper.h:602-607): DXT1
// with always4 = false, DXT5 with its alpha half (not has_one_pixel) and
// an always-4-color color half. Equal to decode -> 2x2 average -> encode.
//
// Bound on the H100: integer issue, not memory. At a 4096^2 source it reads
// 8 MiB (DXT1) or 16 MiB (DXT5) and writes a quarter of that, 3 or 6 us at
// 3.35 TB/s, but each destination block does four decodes and one encode:
// about 1,360 (DXT1) or 2,540 (DXT5) SASS instructions (nvcc 12.8), most of
// them the encode's (encode_color, encode_alpha).
template <bool kDxt5>
__global__ void __launch_bounds__(kThreads)
downsample_kernel(const uint8_t* __restrict__ src, int nby, int nbx,
                  const uint8_t* __restrict__ lut_global,
                  uint8_t* __restrict__ out) {
  __shared__ uint8_t lut[kLutBytes];
  for (int i = threadIdx.x; i < kLutBytes; i += blockDim.x) lut[i] = lut_global[i];
  __syncthreads();

  const int dnbx = nbx / 2;
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)(nby / 2) * dnbx) return;
  const int dy = int(n / dnbx), dx = int(n % dnbx);

  int r[16], g[16], b[16], a[16];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int sy = s >> 1, sx = s & 1;
    const long long i = (2LL * dy + sy) * nbx + 2 * dx + sx;
    uint32_t cw, iw;
    uint32_t ramp_lo = 0, ramp_hi = 0, asel[4] = {};
    if (kDxt5) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[i];
      cw = v.z;
      iw = v.w;
      uint32_t alpha[8], half0, half1;
      decode_alpha(v.x, v.y, alpha, half0, half1);
      ramp_lo = alpha[0] | (alpha[1] << 8) | (alpha[2] << 16) | (alpha[3] << 24);
      ramp_hi = alpha[4] | (alpha[5] << 8) | (alpha[6] << 16) | (alpha[7] << 24);
      const uint32_t s01 = alpha_selectors(half0);
      const uint32_t s23 = alpha_selectors(half1);
      asel[0] = s01;
      asel[1] = s01 >> 16;
      asel[2] = s23;
      asel[3] = s23 >> 16;
    } else {
      const uint2 v = reinterpret_cast<const uint2*>(src)[i];
      cw = v.x;
      iw = v.y;
    }
    uint32_t plane[3], sel[4];
    palette_planes(cw, kDxt5, plane);
    color_selectors(iw, sel);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // Source rows 2j and 2j + 1 make destination row 2 sy + j, columns
      // 2 sx and 2 sx + 1.
      const int d = (2 * sy + j) * 4 + 2 * sx;
      const uint32_t t = sel[2 * j], u = sel[2 * j + 1];
      quad_pair(__byte_perm(plane[0], 0u, t), __byte_perm(plane[0], 0u, u),
                r[d], r[d + 1]);
      quad_pair(__byte_perm(plane[1], 0u, t), __byte_perm(plane[1], 0u, u),
                g[d], g[d + 1]);
      quad_pair(__byte_perm(plane[2], 0u, t), __byte_perm(plane[2], 0u, u),
                b[d], b[d + 1]);
      if (kDxt5)
        quad_pair(__byte_perm(ramp_lo, ramp_hi, asel[2 * j]),
                  __byte_perm(ramp_lo, ramp_hi, asel[2 * j + 1]), a[d], a[d + 1]);
    }
  }
  if (kDxt5) {
    const uint2 alpha = encode_alpha(a, false);
    const uint2 color = encode_color(r, g, b, lut, false, true);
    reinterpret_cast<uint4*>(out)[n] = make_uint4(alpha.x, alpha.y, color.x, color.y);
  } else {
    reinterpret_cast<uint2*>(out)[n] = encode_color(r, g, b, lut, false, false);
  }
}

inline int grid_for(long long n) { return int((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int texcomp_dxt1_encode(const void* img, int channels, int h, int w, int nbr,
                        int nbc, const void* lut, void* out, int swap,
                        int always4, void* stream) {
  encode_kernel<false><<<grid_for((long long)nbr * nbc), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), channels, h, w, nbr, nbc,
      div_magic(nbc), static_cast<const uint8_t*>(lut),
      static_cast<uint8_t*>(out), swap != 0, always4 != 0);
  return int(cudaGetLastError());
}

int texcomp_dxt5_encode(const void* img, int h, int w, int nbr, int nbc,
                        const void* lut, void* out, int swap, void* stream) {
  encode_kernel<true><<<grid_for((long long)nbr * nbc), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), 4, h, w, nbr, nbc, div_magic(nbc),
      static_cast<const uint8_t*>(lut), static_cast<uint8_t*>(out), swap != 0,
      true);
  return int(cudaGetLastError());
}

int texcomp_dxt1_decode(const void* blocks, int nbr, int nbc, void* out,
                        int swap, int always4, void* stream) {
  decode_kernel<false><<<grid_for((long long)nbr * nbc), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), nbr, nbc, static_cast<uint8_t*>(out),
      swap != 0, always4 != 0);
  return int(cudaGetLastError());
}

int texcomp_dxt5_decode(const void* blocks, int nbr, int nbc, void* out,
                        int swap, void* stream) {
  decode_kernel<true><<<grid_for((long long)nbr * nbc), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), nbr, nbc, static_cast<uint8_t*>(out),
      swap != 0, true);
  return int(cudaGetLastError());
}

int texcomp_dxt1_downsample(const void* src, int nby, int nbx, const void* lut,
                            void* out, void* stream) {
  downsample_kernel<false><<<grid_for((long long)(nby / 2) * (nbx / 2)),
                             kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), nby, nbx,
      static_cast<const uint8_t*>(lut), static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}

int texcomp_dxt5_downsample(const void* src, int nby, int nbx, const void* lut,
                            void* out, void* stream) {
  downsample_kernel<true><<<grid_for((long long)(nby / 2) * (nbx / 2)),
                            kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), nby, nbx,
      static_cast<const uint8_t*>(lut), static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}

// Registers per thread, static shared memory in bytes, and resident CTAs
// per SM of the DXT1 (dxt5 = 0) or DXT5 fused level, into out[0..2].
int texcomp_dxt_downsample_info(int dxt5, int* out) {
  const void* fn = dxt5 ? reinterpret_cast<const void*>(downsample_kernel<true>)
                        : reinterpret_cast<const void*>(downsample_kernel<false>);
  return texcomp::kernel_info(fn, kThreads, out);
}

// Registers per thread, static shared memory in bytes, and resident CTAs
// per SM of the DXT1 (dxt5 = 0) or DXT5 encode, into out[0..2].
int texcomp_dxt_encode_info(int dxt5, int* out) {
  const void* fn = dxt5 ? reinterpret_cast<const void*>(encode_kernel<true>)
                        : reinterpret_cast<const void*>(encode_kernel<false>);
  return texcomp::kernel_info(fn, kThreads, out);
}

const char* texcomp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
