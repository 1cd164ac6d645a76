// The HQ DXT cluster-fit top 4 for Hopper (sm_90a).
//
// Replaces texcomp/ops/dxt_pallas.py:_cf_topk_kernel. One thread per 4x4
// block scores every partition of the cluster-fit table in table order
// and keeps the 4 best. Byte-exact (bit-exact in its float payload) with
// the plain twin cluster_topk4_plain in texcomp_torch/ops/dxt_hq_cuda.py,
// whose module docstring defines the score. The entry point at the bottom
// has a plain C interface: pointers, ints and a stream, returning
// cudaGetLastError() so the caller sees a refused launch.
//
// Exactness. u, A = u.u, B = u.Pt and T = Pt.Pt are int32 (u <= 12,240,
// A <= 4.5e8). The float32 score multiplies bf16-representable factors
// only, so each product is exact; every step is written with __fmul_rn /
// __fadd_rn, so nvcc contracts nothing into an FMA and the add tree is the
// twin's. The bf16 split rounds to nearest even, as torch's conversion.
//
// Ties. A partition enters the top 4 only on a strict '>' against a slot,
// and partitions arrive in index order, so equal scores keep the lower
// index: the twin's iterated first-occurrence argmax.
//
// The partition table lives in constant memory: every thread of a warp
// reads the same partition at the same step, so each load is one
// broadcast. The entry point copies the caller's table there (device to
// device, 47 KB at most, on the launch's stream) before the kernel.
//
// What the TPU kernel did for its layout and this one does not: the
// 128-partition chunks, the one-hot bf16 MXU dots (hi/lo bytes) that
// gathered u, and the padded rows with a -3.4e38 bias.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 17 * 3;  // prefix sums P[0..16] x (r, g, b)
constexpr int kMaxParts = 969;  // every ordered cut; the table drops 4

__constant__ int c_cuts[kMaxParts * 3];
__constant__ float c_qtab[kMaxParts * 9];

__device__ __forceinline__ float bf16_round(float x) {
  uint32_t u = __float_as_uint(x);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  return __uint_as_float(u);
}

// (qh * vh + qh * vl) + ql * vh with v split into bf16 hi + lo.
__device__ __forceinline__ float term(float qh, float ql, int v) {
  const float vf = __int2float_rn(v);
  const float vh = bf16_round(vf);
  const float vl = bf16_round(__fsub_rn(vf, vh));
  return __fadd_rn(__fadd_rn(__fmul_rn(qh, vh), __fmul_rn(qh, vl)),
                   __fmul_rn(ql, vh));
}

// Reads (n, 17, 3) int32 prefix sums (row r: the sum of the r pixels of
// largest projection) and the table in constant memory: n_parts rows of
// c_cuts (c1, c2, c3) and of c_qtab [quu_h, quu_l, qut_h, qut_l, qtt_h,
// qtt_l, alpha, beta, delta] (codecs/dxt_hq._cf_tables_np). Writes (n, 4,
// 6) float32 payloads (u0, u1, u2, alpha, beta, delta), best first.
//
// A thread keeps its block's prefix sums in shared memory, [row][thread],
// so that the cut-indexed reads of a warp fall in distinct banks.
//
// Bound on the H100: integer and float issue. Each partition costs about
// 60 operations (the three gathered sums, A and B, two split terms, the
// score tree and the insertion test), 58,000 a block for 965 partitions;
// the bytes (204 in, 96 out a block) are negligible beside them.
__global__ void __launch_bounds__(kThreads)
cluster_topk4_kernel(const int32_t* __restrict__ prefix, int n, int n_parts,
                     float* __restrict__ out) {
  __shared__ int sp[kRows][kThreads];
  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;
  if (i >= n) return;
  const int32_t* src = prefix + (long long)i * kRows;
#pragma unroll
  for (int j = 0; j < kRows; ++j) sp[j][t] = src[j];

  const int pt0 = sp[48][t], pt1 = sp[49][t], pt2 = sp[50][t];
  const int ptt = pt0 * pt0 + pt1 * pt1 + pt2 * pt2;
  float top_s[4];
  int top_i[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    top_s[k] = -INFINITY;
    top_i[k] = 0;
  }

  for (int q = 0; q < n_parts; ++q) {
    const int r1 = 3 * c_cuts[3 * q];
    const int r2 = 3 * c_cuts[3 * q + 1];
    const int r3 = 3 * c_cuts[3 * q + 2];
    const int u0 = sp[r1][t] + sp[r2][t] + sp[r3][t];
    const int u1 = sp[r1 + 1][t] + sp[r2 + 1][t] + sp[r3 + 1][t];
    const int u2 = sp[r1 + 2][t] + sp[r2 + 2][t] + sp[r3 + 2][t];
    const int a = u0 * u0 + u1 * u1 + u2 * u2;
    const int b = pt0 * u0 + pt1 * u1 + pt2 * u2;
    const float* c = c_qtab + 9 * q;
    const float s = __fadd_rn(__fadd_rn(term(c[0], c[1], a),
                                        term(c[2], c[3], b)),
                              term(c[4], c[5], ptt));
    if (s > top_s[3]) {
      // Insert into the sorted slots: rise past strictly smaller scores.
      top_s[3] = s;
      top_i[3] = q;
#pragma unroll
      for (int k = 3; k > 0; --k) {
        if (top_s[k] > top_s[k - 1]) {
          const float fs = top_s[k];
          top_s[k] = top_s[k - 1];
          top_s[k - 1] = fs;
          const int fi = top_i[k];
          top_i[k] = top_i[k - 1];
          top_i[k - 1] = fi;
        }
      }
    }
  }

  float* dst = out + (long long)i * 24;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = top_i[k];
    const int r1 = 3 * c_cuts[3 * q], r2 = 3 * c_cuts[3 * q + 1];
    const int r3 = 3 * c_cuts[3 * q + 2];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      dst[6 * k + ch] =
          float(sp[r1 + ch][t] + sp[r2 + ch][t] + sp[r3 + ch][t]);
#pragma unroll
    for (int j = 0; j < 3; ++j) dst[6 * k + 3 + j] = c_qtab[9 * q + 6 + j];
  }
}

}  // namespace

extern "C" {

int texcomp_dxt_hq_cluster_topk4(const void* prefix, int n, const void* cuts,
                                 const void* qtab, int n_parts, void* out,
                                 void* stream) {
  if (n_parts < 4 || n_parts > kMaxParts) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_cuts, cuts, sizeof(int) * 3 * n_parts, 0, cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_qtab, qtab, sizeof(float) * 9 * n_parts,
                                  0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return int(err);
  cluster_topk4_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int32_t*>(prefix), n, n_parts,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
