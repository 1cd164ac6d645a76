// The HQ PVRTC A/B fit's full-resolution steps for Hopper (sm_90a).
//
// Replaces no Pallas site: texcomp's HQ PVRTC (texcomp/codecs/pvrtc_hq.py)
// is plain XLA. Added because that fit, run as PyTorch ops, is bound by
// device-memory bytes it need not move. Each op read and wrote whole
// (2, H, W, 4) float32 tensors (the upscaled A and B, the weighted residual,
// its rolls), some 37 GB a 1024x1024 HQ 4bpp encode. The fit's state is the
// low-res A/B, (2, nby, nbx, 4) float32 (2 MB at 1024x1024 4bpp), and one
// blend weight a pixel; every full-resolution value is a short expression
// of at most 3x3 texels with a wrap at the edges. Here those values live in
// shared memory and registers and never reach device memory.
//
// Three entries, each bit-exact with its plain twin in
// ops/pvrtc_hq_cuda.py (whose docstring defines J and the weights):
//
//   texcomp_pvrtc_hq_normal  hp = ridge p + J^T (w J p), or, given the
//                            image, ridge p + J^T (w img): one CTA a tile
//                            of texels, all four channels.
//   texcomp_pvrtc_hq_dot     <x, y> in the twin's halving-tree order, as a
//                            0-d device value: one or more passes of
//                            residue-class subtrees, then the top of the
//                            tree in one CTA.
//   texcomp_pvrtc_hq_choose  each pixel's blend weight t: one CTA a 32x32
//                            pixel tile, all four channels.
//
// Each kernel is a template on the block shape (4x4 for 4bpp, 4x8 for
// 2bpp); the entries pick the instance from the shape they are given.
//
// Exactness. Every product, sum and difference is its own correctly
// rounded __fmul_rn / __fadd_rn / __fsub_rn, in the order of the twin's
// PyTorch expressions, so nvcc contracts nothing into an FMA whatever its
// -fmad default. x / 16 (or / 32) is the multiply by the exact reciprocal:
// both are the correctly rounded value of the same real number. Nothing
// flushes subnormals. An upscale pass at weight fw is (B - fw) prev + fw
// next, and its transpose (B - k) g[y + B/2] + k g[y - B/2] with k = y mod
// B, each term multiplied even where its weight is 0, as the twin does.
//
// Bound on the H100: bytes. At 1024x1024 4bpp a normal-operator call reads
// the 2 MB A/B and the 4 MB blend weights and writes 2 MB (the right-hand
// side reads the 16 MB float image instead of the A/B): 8 MB, 2.4 us at
// 3.35 TB/s, against some 110 M float operations, 1.7 us at 67 T/s. The
// PyTorch chain moved about 4 GB a call. The dot reads 4 MB, the choice
// 18 MB and writes 4 MB. What the kernels spend beyond that is the
// latency of their few dependent steps and the index arithmetic of the
// wrap; so each CTA issues all its device-memory reads first, a thread
// handles a pixel's or texel's four channels at once (one weight load and
// one index computation for four), and the dot keeps its subtrees in
// registers. The normal operator's wrap halo costs a tile (32 + BH)
// (16 + BW) / (32 16) of its pixels' work (1.41x at 4x4): small beside a
// design that would read each texel's 3x3 neighbourhood from memory per
// pixel.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// The choice's tile: 32x32 pixels. The normal operator's: 32 pixel rows by
// kNormalCols columns, 8x4 texels at 4x4, 8x2 at 4x8.
constexpr int kTile = 32;
constexpr int kNormalCols = 16;
constexpr float kRidge = 0.009999999776482582f;  // float32(1e-2)
// The dot's plan: while a leaf has more than kLanes << kLogMaxLast values,
// a pass reduces each 1 << kLogPer of them to one; the last pass reduces
// the rest on kLanes threads a leaf, at most 1 << kLogMaxLast values a
// thread. Mirrored by ops/pvrtc_hq_cuda.py (_DOT_PER, _DOT_LAST,
// dot_scratch_floats).
constexpr int kLogPer = 4;
constexpr int kLanes = 256;
constexpr int kLogMaxLast = 6;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// One separable pass of the upscale at weight fw (pvrtc._upscale_axis),
// on each channel: (B - fw) prev + fw next. With (g[y + B/2], g[y - B/2])
// for (prev, next) and fw = y mod B, one term of its transpose.
template <int B>
__device__ __forceinline__ float4 lerp4(int fw, float4 prev, float4 next) {
  const float wa = float(B - fw), wb = float(fw);
  return make_float4(add(mul(wa, prev.x), mul(wb, next.x)),
                     add(mul(wa, prev.y), mul(wb, next.y)),
                     add(mul(wa, prev.z), mul(wb, next.z)),
                     add(mul(wa, prev.w), mul(wb, next.w)));
}

__device__ __forceinline__ float4 scale4(float s, float4 a) {
  return make_float4(mul(s, a.x), mul(s, a.y), mul(s, a.z), mul(s, a.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z), add(a.w, b.w));
}

// The normal operator for a tile of TY x TX texels at (blockIdx.y,
// blockIdx.x), all four channels at once.
//
// The tile's texels read the weighted residual g on a window of pixels
// that reaches B/2 past the tile on each side (the transpose's rolls):
// window pixel (wy, wx) is image pixel (ty0 BH - BH/2 + wy, tx0 BW - BW/2 +
// wx), wrapped. The forward upscale of those pixels reads the texels one
// past the tile on each side: texel (ly, lx) of sp is (ty0 - 1 + ly,
// tx0 - 1 + lx), wrapped. In those coordinates a pass's prev texel of
// window index v is v / B, its next v / B + 1, and its weight v mod B.
//
// Steps, each over the CTA's threads: (1) the A/B halo into sp, and every
// other device-memory read of the CTA into registers, all issued at once;
// (2) the x pass of the halo's rows over the window's columns into sx;
// (3) per window pixel the y pass and / (BH BW) (up(A), up(B)), the
// residual r = (1 - t) up(A) + t up(B) (or the image), and g_k =
// (w_k r) / (BH BW) into sg; (4) the transposed y pass and each texel
// row's group sum, over the window's columns, into sx; (5) the transposed
// x pass and group sum, plus ridge p, written for the tile's texels inside
// the image. With the image (kImg) the halo and step 2 are skipped. A
// thread's element is a texel's or a pixel's four channels, so the index
// arithmetic and the weights' loads are shared by the channels.
template <int BH, int BW, bool kImg>
__global__ void __launch_bounds__(kThreads)
normal_kernel(const float4* __restrict__ p, const float* __restrict__ t,
              const float4* __restrict__ img, int nby, int nbx,
              float4* __restrict__ out) {
  constexpr int TY = kTile / BH, TX = kNormalCols / BW;
  constexpr int LY = TY + 2, LX = TX + 2;
  constexpr int WY = kTile + BH, WX = kNormalCols + BW;
  constexpr float kInv = 1.0f / float(BH * BW);
  __shared__ float4 sp[2][LY][LX];
  __shared__ float4 sx[2][LY][WX];
  __shared__ float4 sg[2][WY][WX];

  const int ty0 = blockIdx.y * TY, tx0 = blockIdx.x * TX;
  const int h = nby * BH, w = nbx * BW;
  const long long leaf = (long long)nby * nbx;
  const int tid = threadIdx.x;

  // Thread (ok, oy, ox) < 2 TY TX writes texel (ty0 + oy, tx0 + ox) of
  // leaf ok, if it lies in the image.
  static_assert(2 * TY * TX <= kThreads, "a texel a thread at most");
  const int ok = tid / (TY * TX), oy = tid / TX % TY, ox = tid % TX;
  const bool own = tid < 2 * TY * TX && ty0 + oy < nby && tx0 + ox < nbx;
  const long long o = ok * leaf + (long long)(ty0 + oy) * nbx + tx0 + ox;

  // Every device-memory read of the CTA first, at once: the A/B halo, each
  // window pixel's weight (and image value) into registers, NW a thread,
  // and with the image the thread's own texel of p.
  constexpr int NW = (WY * WX + kThreads - 1) / kThreads;
  float tw[NW];
  float4 iw[NW];
  const float4 p_own = kImg && own ? p[o] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!kImg) {
    for (int e = tid; e < 2 * LY * LX; e += kThreads) {
      const int k = e / (LY * LX), ly = e / LX % LY, lx = e % LX;
      const int gy = wrap(ty0 - 1 + ly, nby), gx = wrap(tx0 - 1 + lx, nbx);
      sp[k][ly][lx] = p[k * leaf + (long long)gy * nbx + gx];
    }
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int e = tid + i * kThreads;
    if (e < WY * WX) {
      const int gy = wrap(ty0 * BH - BH / 2 + e / WX, h);
      const int gx = wrap(tx0 * BW - BW / 2 + e % WX, w);
      const long long px = (long long)gy * w + gx;
      tw[i] = t[px];
      if (kImg) iw[i] = img[px];
    }
  }
  if (!kImg) {
    __syncthreads();
    for (int e = tid; e < 2 * LY * WX; e += kThreads) {
      const int k = e / (LY * WX), ly = e / WX % LY, wx = e % WX;
      sx[k][ly][wx] = lerp4<BW>(wx % BW, sp[k][ly][wx / BW], sp[k][ly][wx / BW + 1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int e = tid + i * kThreads;
    if (e >= WY * WX) break;
    const int wy = e / WX, wx = e % WX;
    const float tb = tw[i];
    const float w0 = sub(1.0f, tb);
    float4 r;
    if (kImg) {
      r = iw[i];
    } else {
      const int ly = wy / BH, fy = wy % BH;
      const float4 ua = scale4(kInv, lerp4<BH>(fy, sx[0][ly][wx], sx[0][ly + 1][wx]));
      const float4 ub = scale4(kInv, lerp4<BH>(fy, sx[1][ly][wx], sx[1][ly + 1][wx]));
      r = add4(scale4(w0, ua), scale4(tb, ub));
    }
    sg[0][wy][wx] = scale4(kInv, scale4(w0, r));
    sg[1][wy][wx] = scale4(kInv, scale4(tb, r));
  }
  __syncthreads();

  // Tile pixel row y = jy BH + ky reads window rows y + BH and y.
  for (int e = tid; e < 2 * TY * WX; e += kThreads) {
    const int k = e / (TY * WX), jy = e / WX % TY, wx = e % WX;
    const int y = jy * BH;
    float4 acc = lerp4<BH>(0, sg[k][y + BH][wx], sg[k][y][wx]);
#pragma unroll
    for (int ky = 1; ky < BH; ++ky)
      acc = add4(acc, lerp4<BH>(ky, sg[k][y + ky + BH][wx], sg[k][y + ky][wx]));
    sx[k][jy][wx] = acc;
  }
  __syncthreads();

  if (own) {
    const int x = ox * BW;
    float4 acc = lerp4<BW>(0, sx[ok][oy][x + BW], sx[ok][oy][x]);
#pragma unroll
    for (int kx = 1; kx < BW; ++kx)
      acc = add4(acc, lerp4<BW>(kx, sx[ok][oy][x + kx + BW], sx[ok][oy][x + kx]));
    out[o] = add4(scale4(kRidge, kImg ? p_own : sp[ok][oy + 1][ox + 1]), acc);
  }
}

// The blend weight of each pixel of the 32x32 tile at (blockIdx.y,
// blockIdx.x): up(A) and up(B) as in normal_kernel, all four channels at
// once (the tile's own pixels, so texel (ly, lx) of sp is (ty0 - 1 + ly,
// tx0 - 1 + lx) and pixel v's prev texel (v + B/2) / B, its next one more,
// its weight (v + B/2) mod B); then d = img - up(A), e = up(B) - up(A),
// s and q as c0 + c1 + c2 + c3 of d e and e e, and the strict-< chain of
// t^2 q - 2 t s over t = 3/8, 5/8, 1 from (t, score) = (0, 0).
template <int BH, int BW>
__global__ void __launch_bounds__(kThreads)
choose_kernel(const float4* __restrict__ img, const float4* __restrict__ ab,
              int nby, int nbx, float* __restrict__ t_out) {
  constexpr int TY = kTile / BH, TX = kTile / BW;
  constexpr int LY = TY + 2, LX = TX + 2;
  constexpr float kInv = 1.0f / float(BH * BW);
  __shared__ float4 sp[2][LY][LX];
  __shared__ float4 sx[2][LY][kTile];

  const int ty0 = blockIdx.y * TY, tx0 = blockIdx.x * TX;
  const int h = nby * BH, w = nbx * BW;
  const long long leaf = (long long)nby * nbx;
  const int tid = threadIdx.x;

  // The A/B halo and the thread's NP pixels, all read at once.
  constexpr int NP = kTile * kTile / kThreads;
  float4 px[NP];
  for (int e = tid; e < 2 * LY * LX; e += kThreads) {
    const int k = e / (LY * LX), ly = e / LX % LY, lx = e % LX;
    const int gy = wrap(ty0 - 1 + ly, nby), gx = wrap(tx0 - 1 + lx, nbx);
    sp[k][ly][lx] = ab[k * leaf + (long long)gy * nbx + gx];
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int e = tid + i * kThreads;
    const int gy = ty0 * BH + e / kTile, gx = tx0 * BW + e % kTile;
    if (gy < h && gx < w) px[i] = img[(long long)gy * w + gx];
  }
  __syncthreads();
  for (int e = tid; e < 2 * LY * kTile; e += kThreads) {
    const int k = e / (LY * kTile), ly = e / kTile % LY, v = e % kTile;
    const int lx = (v + BW / 2) / BW, fw = (v + BW / 2) % BW;
    sx[k][ly][v] = lerp4<BW>(fw, sp[k][ly][lx], sp[k][ly][lx + 1]);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int e = tid + i * kThreads;
    const int v = e / kTile, u = e % kTile;
    const int gy = ty0 * BH + v, gx = tx0 * BW + u;
    if (gy >= h || gx >= w) continue;
    const int ly = (v + BH / 2) / BH, fy = (v + BH / 2) % BH;
    const float4 ua = scale4(kInv, lerp4<BH>(fy, sx[0][ly][u], sx[0][ly + 1][u]));
    const float4 ub = scale4(kInv, lerp4<BH>(fy, sx[1][ly][u], sx[1][ly + 1][u]));
    const float4 im = px[i];
    const float4 d = make_float4(sub(im.x, ua.x), sub(im.y, ua.y), sub(im.z, ua.z),
                                 sub(im.w, ua.w));
    const float4 f = make_float4(sub(ub.x, ua.x), sub(ub.y, ua.y), sub(ub.z, ua.z),
                                 sub(ub.w, ua.w));
    const float s = add(add(add(mul(d.x, f.x), mul(d.y, f.y)), mul(d.z, f.z)),
                        mul(d.w, f.w));
    const float q = add(add(add(mul(f.x, f.x), mul(f.y, f.y)), mul(f.z, f.z)),
                        mul(f.w, f.w));
    constexpr float kT[3] = {0.375f, 0.625f, 1.0f};
    float best_t = 0.0f, best_e = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float cand = sub(mul(kT[j] * kT[j], q), mul(2.0f * kT[j], s));
      if (cand < best_e) {
        best_t = kT[j];
        best_e = cand;
      }
    }
    t_out[(long long)gy * w + gx] = best_t;
  }
}

// Element i of leaf k of a dot pass's input: the product x y (the first
// pass) or a partial, and 0 past the n real values (the twin's zero pad).
template <bool kProduct>
__device__ __forceinline__ float dot_value(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           long long i, int n) {
  if (i >= n) return 0.0f;
  return kProduct ? mul(x[i], y[i]) : x[i];
}

// The halving tree x[:m/2] + x[m/2:] (m a power of two) has at level L,
// index c, the node that is the halving tree over the 2^L values c,
// c + m/2^L, ..., c + (2^L - 1) m/2^L. This is that node for 2^L =
// 1 << kLog and m/2^L = `stride`. The halving tree over values s[0..2^L)
// is the tree over the even ones plus the tree over the odd ones: so by
// recursion, the same adds in the same association, with no array.
template <int kLog, bool kProduct>
__device__ __forceinline__ float residue_tree(const float* __restrict__ x,
                                              const float* __restrict__ y,
                                              int c, int stride, int n) {
  if constexpr (kLog == 0) {
    return dot_value<kProduct>(x, y, c, n);
  } else {
    return add(residue_tree<kLog - 1, kProduct>(x, y, c, 2 * stride, n),
               residue_tree<kLog - 1, kProduct>(x, y, c + stride, 2 * stride, n));
  }
}

// A pass over both leaves' m values (n of them real, each leaf `stride`
// after the other): thread g writes node c = g mod m_out of leaf
// g / m_out, m_out = m >> kLogPer.
template <bool kProduct>
__global__ void __launch_bounds__(kThreads)
dot_pass_kernel(const float* __restrict__ x, const float* __restrict__ y,
                int n, int stride, int m_out, float* __restrict__ out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= 2 * m_out) return;
  const int k = g / m_out, c = g % m_out;
  out[(long long)k * m_out + c] = residue_tree<kLogPer, kProduct>(
      x + (long long)k * stride, kProduct ? y + (long long)k * stride : nullptr,
      c, m_out, n);
}

// The last pass, one CTA of kLanes threads a leaf: thread c of leaf k
// computes node c of the m values' (m = lanes << kLog, lanes at most
// kLanes) tree, then the halving tree over the lanes' nodes in shared
// memory, then leaf A plus leaf B into out[0].
template <int kLog, bool kProduct>
__global__ void __launch_bounds__(2 * kLanes)
dot_last_kernel(const float* __restrict__ x, const float* __restrict__ y,
                int n, int stride, int lanes, float* __restrict__ out) {
  __shared__ float s[2][kLanes];
  const int k = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
  if (c < lanes)
    s[k][c] = residue_tree<kLog, kProduct>(
        x + (long long)k * stride,
        kProduct ? y + (long long)k * stride : nullptr, c, lanes, n);
  __syncthreads();
  for (int half = lanes / 2; half >= 1; half /= 2) {
    if (c < half) s[k][c] = add(s[k][c], s[k][c + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = add(s[0][0], s[1][0]);
}

template <bool kProduct>
void launch_dot_last(const float* x, const float* y, int n, int stride, int m,
                     float* out, cudaStream_t s) {
  int log = 0;
  while ((kLanes << log) < m) ++log;
  const int lanes = m >> log;
#define TEXCOMP_DOT_LAST(L)                                                  \
  case L:                                                                    \
    dot_last_kernel<L, kProduct><<<1, 2 * kLanes, 0, s>>>(x, y, n, stride, lanes, out); \
    break;
  switch (log) {
    TEXCOMP_DOT_LAST(0)
    TEXCOMP_DOT_LAST(1)
    TEXCOMP_DOT_LAST(2)
    TEXCOMP_DOT_LAST(3)
    TEXCOMP_DOT_LAST(4)
    TEXCOMP_DOT_LAST(5)
    TEXCOMP_DOT_LAST(6)
  }
#undef TEXCOMP_DOT_LAST
}

template <int BH, int BW>
void launch_normal(const float4* p, const float* t, const float4* img, int nby,
                   int nbx, float4* out, cudaStream_t s) {
  constexpr int TY = kTile / BH, TX = kNormalCols / BW;
  const dim3 grid((nbx + TX - 1) / TX, (nby + TY - 1) / TY);
  if (img)
    normal_kernel<BH, BW, true><<<grid, kThreads, 0, s>>>(p, t, img, nby, nbx, out);
  else
    normal_kernel<BH, BW, false><<<grid, kThreads, 0, s>>>(p, t, img, nby, nbx, out);
}

template <int BH, int BW>
void launch_choose(const float4* img, const float4* ab, int nby, int nbx,
                   float* out, cudaStream_t s) {
  constexpr int TY = kTile / BH, TX = kTile / BW;
  const dim3 grid((nbx + TX - 1) / TX, (nby + TY - 1) / TY);
  choose_kernel<BH, BW><<<grid, kThreads, 0, s>>>(img, ab, nby, nbx, out);
}

bool grid_ok(int nby, int nbx, int bh, int bw) {
  return nby > 0 && nbx > 0 && nby <= 65535 && nbx <= 65535 && bh == 4 &&
         (bw == 4 || bw == 8);
}

}  // namespace

extern "C" {

// p: (2, nby, nbx, 4) float32; t: (nby bh, nbx bw) float32; img: null, or
// (nby bh, nbx bw, 4) float32; out: like p. p, img and out 16-byte aligned.
int texcomp_pvrtc_hq_normal(const void* p, const void* t, const void* img,
                            int nby, int nbx, int bh, int bw, void* out,
                            void* stream) {
  if (!grid_ok(nby, nbx, bh, bw)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* pf = static_cast<const float4*>(p);
  const float* tf = static_cast<const float*>(t);
  const float4* imf = static_cast<const float4*>(img);
  float4* of = static_cast<float4*>(out);
  if (bw == 4)
    launch_normal<4, 4>(pf, tf, imf, nby, nbx, of, s);
  else
    launch_normal<4, 8>(pf, tf, imf, nby, nbx, of, s);
  return int(cudaGetLastError());
}

// x, y: two leaves of n float32 each, leaf B at x + n; scratch: the
// partials of the passes before the last (scratch_floats of them, at least
// dot_scratch_floats(n)); out: one float32.
int texcomp_pvrtc_hq_dot(const void* x, const void* y, int n, void* scratch,
                         int scratch_floats, void* out, void* stream) {
  if (n < 1 || n > (1 << 30)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float* ys = static_cast<const float*>(y);
  float* part = static_cast<float*>(scratch);
  int m = 1;
  while (m < n) m <<= 1;
  int len = n, used = 0;
  bool product = true;
  while (m > (kLanes << kLogMaxLast)) {
    const int m_out = m >> kLogPer;
    if (used + 2 * m_out > scratch_floats) return int(cudaErrorInvalidValue);
    float* dst = part + used;
    const int ctas = (2 * m_out + kThreads - 1) / kThreads;
    if (product)
      dot_pass_kernel<true><<<ctas, kThreads, 0, s>>>(xs, ys, len, len, m_out, dst);
    else
      dot_pass_kernel<false><<<ctas, kThreads, 0, s>>>(xs, ys, len, len, m_out, dst);
    xs = dst;
    ys = nullptr;
    len = m = m_out;
    used += 2 * m_out;
    product = false;
  }
  float* o = static_cast<float*>(out);
  if (product)
    launch_dot_last<true>(xs, ys, len, len, m, o, s);
  else
    launch_dot_last<false>(xs, ys, len, len, m, o, s);
  return int(cudaGetLastError());
}

// img: (nby bh, nbx bw, 4) float32; ab: (2, nby, nbx, 4) float32, both
// 16-byte aligned; out: (nby bh, nbx bw) float32.
int texcomp_pvrtc_hq_choose(const void* img, const void* ab, int nby, int nbx,
                            int bh, int bw, void* out, void* stream) {
  if (!grid_ok(nby, nbx, bh, bw)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* im = static_cast<const float4*>(img);
  const float4* lo = static_cast<const float4*>(ab);
  float* of = static_cast<float*>(out);
  if (bw == 4)
    launch_choose<4, 4>(im, lo, nby, nbx, of, s);
  else
    launch_choose<4, 8>(im, lo, nby, nbx, of, s);
  return int(cudaGetLastError());
}

// Registers per thread, static shared memory in bytes and resident CTAs
// per SM, into out[0..2], of kernel `kernel`: 0-3 the normal operator at
// 4x4 (J p, image), then 4x8 (J p, image); 4-5 the choice at 4x4, 4x8;
// 6-7 a dot pass (products, partials); 8-9 the dot's last pass at 64
// values a thread (products, partials), CTAs of 512 threads.
int texcomp_pvrtc_hq_info(int kernel, int* out) {
  const void* fns[10] = {
      reinterpret_cast<const void*>(normal_kernel<4, 4, false>),
      reinterpret_cast<const void*>(normal_kernel<4, 4, true>),
      reinterpret_cast<const void*>(normal_kernel<4, 8, false>),
      reinterpret_cast<const void*>(normal_kernel<4, 8, true>),
      reinterpret_cast<const void*>(choose_kernel<4, 4>),
      reinterpret_cast<const void*>(choose_kernel<4, 8>),
      reinterpret_cast<const void*>(dot_pass_kernel<true>),
      reinterpret_cast<const void*>(dot_pass_kernel<false>),
      reinterpret_cast<const void*>(dot_last_kernel<kLogMaxLast, true>),
      reinterpret_cast<const void*>(dot_last_kernel<kLogMaxLast, false>)};
  if (kernel < 0 || kernel > 9) return int(cudaErrorInvalidValue);
  return texcomp::kernel_info(fns[kernel], kernel < 8 ? kThreads : 2 * kLanes,
                              out);
}

}  // extern "C"
