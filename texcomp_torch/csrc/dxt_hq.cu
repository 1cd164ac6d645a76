// The HQ DXT cluster-fit top 4 for Hopper (sm_90a).
//
// Replaces texcomp/ops/dxt_pallas.py:_cf_topk_kernel. For each 4x4 block
// it scores every partition of the cluster-fit table and keeps the 4 best.
// Byte-exact (bit-exact in its float payload) with the plain twin
// cluster_topk4_plain in texcomp_torch/ops/dxt_hq_cuda.py, whose module
// docstring defines the score. The entry points at the bottom have a plain
// C interface: pointers, ints and a stream, returning cudaGetLastError() so
// the caller sees a refused launch.
//
// Exactness. u, A = u.u, B = u.Pt and T = Pt.Pt are int32 (u <= 12,240,
// A <= 4.5e8). The float32 score multiplies bf16-representable factors
// only, so each product is exact; every step is written with __fmul_rn /
// __fadd_rn, so nvcc contracts nothing into an FMA and the add tree is the
// twin's. The bf16 split is __floats2bfloat162_rn, round to nearest even
// as torch's conversion on finite values, A's and B's in one conversion
// instruction.
//
// Layout. A CTA of 8 warps owns 32 blocks, lane = block. Warp w scores the
// contiguous slice [w * ceil(P / 8), min(P, (w + 1) * ceil(P / 8))) of the
// table in table order, so all lanes of a warp read the same partition at
// the same step and each table load is one broadcast. Eight warps on one
// set of blocks give 8 times the warps of one thread per block scanning the
// whole table, enough to hide the latencies of each partition's dependent
// chain. The table is repacked before the scan (pack_table_kernel) into two
// 16-byte rows per partition in global memory, read through the read-only
// cache: two loads a partition where the (P, 3) cuts and (P, 9) constants
// took nine. Constant memory would serialise here: the 8 warps of a CTA,
// and the CTAs of an SM, read 8 or more places in the table at once, and
// the constant cache thrashes.
//
// Ties. Within a slice a partition enters the warp's top 4 only on a strict
// '>' against a slot, and partitions arrive in index order, so equal scores
// keep the lower index. Warp 0 then merges the 8 lists of each block by
// (score descending, index ascending), an explicit lexicographic order, so
// the result is the twin's iterated first-occurrence argmax whatever the
// merge order. An empty slice (the table can be as short as 4 rows)
// contributes -inf slots that never win.
//
// What the TPU kernel did for its layout and this one does not: the
// 128-partition chunks, the one-hot bf16 MXU dots (hi/lo bytes) that
// gathered u, and the padded rows with a -3.4e38 bias.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocks = 32;     // 4x4 blocks per CTA, one per lane
constexpr int kCutRows = 17;    // prefix sums P[0..16]
constexpr int kRows = kCutRows * 3;
constexpr int kMaxParts = 969;  // every ordered cut; the table drops 4
constexpr int kPayload = 24;    // 4 picks x (u0, u1, u2, alpha, beta, delta)

// The table as the scan reads it, two 16-byte rows per partition:
// {off1 | off2 << 16, off3, qtt_h, qtt_l} and {quu_h, quu_l, qut_h, qut_l},
// off the byte offset of a cut's row in the shared prefix sums. Written by
// pack_table_kernel before each scan on the same stream; read through the
// read-only cache. One table per device: scans with different tables on
// two streams at once would race.
__device__ int4 g_table[kMaxParts][2];

// v and w split into bf16 hi + lo, a pair per conversion.
__device__ __forceinline__ void split2(int v, int w, float& vh, float& vl,
                                      float& wh, float& wl) {
  const float vf = __int2float_rn(v), wf = __int2float_rn(w);
  const __nv_bfloat162 h = __floats2bfloat162_rn(vf, wf);
  vh = __low2float(h);
  wh = __high2float(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(vf, vh), __fsub_rn(wf, wh));
  vl = __low2float(l);
  wl = __high2float(l);
}

// (qh * vh + qh * vl) + ql * vh.
__device__ __forceinline__ float term(float qh, float ql, float vh, float vl) {
  return __fadd_rn(__fadd_rn(__fmul_rn(qh, vh), __fmul_rn(qh, vl)),
                   __fmul_rn(ql, vh));
}

// (s, q) ranks above (s2, q2): a higher score, or an equal one at a lower
// partition index.
__device__ __forceinline__ bool ranks_above(float s, int q, float s2, int q2) {
  return s > s2 || (s == s2 && q < q2);
}

// Reads (n, 17, 3) int32 prefix sums (row r: the sum of the r pixels of
// largest projection) and the table: n_parts rows of cuts (c1, c2, c3) and
// of qtab [quu_h, quu_l, qut_h, qut_l, qtt_h, qtt_l, alpha, beta, delta]
// (codecs/dxt_hq._cf_tables_np), packed into g_table for the scan and as
// given for the payloads. Writes (n, 4, 6) float32 payloads (u0, u1, u2,
// alpha, beta, delta), best first.
//
// The CTA's prefix sums arrive coalesced into shared memory, then are
// repacked [row][block] as (r | g << 16, b): a sum of three is below 2^16
// per channel, so one 64-bit load per cut gathers all three channels and
// a warp's loads hit consecutive words.
//
// Bound on the H100: integer and float issue. Each partition costs about
// 60 operations (the three gathered sums, A and B, two split terms, the
// score tree and the insertion test), 58,000 a block for 965 partitions;
// the bytes (204 in, 96 out a block) are negligible beside them. Beyond
// that count a warp issues the insertion whenever any of its 32 lanes
// inserts, which early in a slice is almost every step.
__global__ void __launch_bounds__(kThreads)
cluster_topk4_kernel(const int32_t* __restrict__ prefix, int n, int n_parts,
                     const int32_t* __restrict__ cuts,
                     const float* __restrict__ qtab,
                     float* __restrict__ out) {
  __shared__ union {
    int raw[kBlocks * kRows];  // the prefix sums as they arrive
    struct {
      float s[kWarps][4][kBlocks];
      int q[kWarps][4][kBlocks];
    } top;                     // each warp's top 4, once the scan is done
  } buf;
  __shared__ int2 sp[kCutRows][kBlocks];
  __shared__ int win[4][kBlocks];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long first = (long long)blockIdx.x * kBlocks;
  const int nb = (int)min((long long)kBlocks, (long long)n - first);
  const int32_t* src = prefix + first * kRows;
  for (int e = t; e < kBlocks * kRows; e += kThreads)
    buf.raw[e] = e < nb * kRows ? src[e] : 0;
  __syncthreads();
  for (int e = t; e < kCutRows * kBlocks; e += kThreads) {
    const int row = e / kBlocks, b = e % kBlocks;
    const int* p = buf.raw + b * kRows + 3 * row;
    sp[row][b] = make_int2(p[0] | (p[1] << 16), p[2]);
  }
  __syncthreads();

  const int2 ptp = sp[16][lane];
  const int pt0 = ptp.x & 0xFFFF, pt1 = ptp.x >> 16, pt2 = ptp.y;
  const char* rows = reinterpret_cast<const char*>(&sp[0][lane]);
  float ptt_h, ptt_l, zero_h, zero_l;  // T's split, once per block
  split2(pt0 * pt0 + pt1 * pt1 + pt2 * pt2, 0, ptt_h, ptt_l, zero_h, zero_l);

  float top_s[4];
  int top_q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    top_s[k] = -INFINITY;
    top_q[k] = INT_MAX;
  }
  const int per = (n_parts + kWarps - 1) / kWarps;
  const int q_end = min(n_parts, (warp + 1) * per);
  for (int q = warp * per; q < q_end; ++q) {
    const int4 t0 = __ldg(&g_table[q][0]), t1 = __ldg(&g_table[q][1]);
    const int2 x = *reinterpret_cast<const int2*>(rows + (t0.x & 0xFFFF));
    const int2 y = *reinterpret_cast<const int2*>(rows + (t0.x >> 16));
    const int2 z = *reinterpret_cast<const int2*>(rows + t0.y);
    const int u01 = x.x + y.x + z.x;
    const int u0 = u01 & 0xFFFF, u1 = u01 >> 16, u2 = x.y + y.y + z.y;
    float ah, al, bh, bl;
    split2(u0 * u0 + u1 * u1 + u2 * u2, pt0 * u0 + pt1 * u1 + pt2 * u2, ah,
           al, bh, bl);
    const float s = __fadd_rn(
        __fadd_rn(term(__int_as_float(t1.x), __int_as_float(t1.y), ah, al),
                  term(__int_as_float(t1.z), __int_as_float(t1.w), bh, bl)),
        term(__int_as_float(t0.z), __int_as_float(t0.w), ptt_h, ptt_l));
    if (s > top_s[3]) {
      // Insert into the sorted slots: rise past strictly smaller scores.
      top_s[3] = s;
      top_q[3] = q;
#pragma unroll
      for (int k = 3; k > 0; --k) {
        if (top_s[k] > top_s[k - 1]) {
          const float fs = top_s[k];
          top_s[k] = top_s[k - 1];
          top_s[k - 1] = fs;
          const int fq = top_q[k];
          top_q[k] = top_q[k - 1];
          top_q[k - 1] = fq;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    buf.top.s[warp][k][lane] = top_s[k];
    buf.top.q[warp][k][lane] = top_q[k];
  }
  __syncthreads();
  if (warp == 0) {
    // Warp 0's list is sorted; merge the other seven into it.
    for (int w = 1; w < kWarps; ++w) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = buf.top.s[w][j][lane];
        const int q = buf.top.q[w][j][lane];
        if (ranks_above(s, q, top_s[3], top_q[3])) {
          top_s[3] = s;
          top_q[3] = q;
#pragma unroll
          for (int k = 3; k > 0; --k) {
            if (ranks_above(top_s[k], top_q[k], top_s[k - 1], top_q[k - 1])) {
              const float fs = top_s[k];
              top_s[k] = top_s[k - 1];
              top_s[k - 1] = fs;
              const int fq = top_q[k];
              top_q[k] = top_q[k - 1];
              top_q[k - 1] = fq;
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) win[k][lane] = top_q[k];
  }
  __syncthreads();

  // The payloads, written coalesced by the whole CTA: element e of the
  // CTA's (nb, 4, 6) slice is field f of pick k of block b.
  float* dst = out + first * kPayload;
  for (int e = t; e < nb * kPayload; e += kThreads) {
    const int b = e / kPayload, j = e % kPayload, k = j / 6, f = j % 6;
    const int q = win[k][b];
    float v;
    if (f < 3) {
      int u = 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int2 r = sp[__ldg(cuts + 3 * q + c)][b];
        u += f == 2 ? r.y : f == 1 ? r.x >> 16 : r.x & 0xFFFF;
      }
      v = float(u);
    } else {
      v = __ldg(qtab + 9 * q + 3 + f);
    }
    dst[e] = v;
  }
}

// Packs the caller's (P, 3) cuts and (P, 9) constants into g_table.
__global__ void __launch_bounds__(kThreads)
pack_table_kernel(const int32_t* __restrict__ cuts,
                  const float* __restrict__ qtab, int n_parts) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n_parts) return;
  constexpr int kRowBytes = sizeof(int2) * kBlocks;
  const int32_t* c = cuts + 3 * q;
  const int* v = reinterpret_cast<const int*>(qtab + 9 * q);
  g_table[q][0] = make_int4((c[0] * kRowBytes) | ((c[1] * kRowBytes) << 16),
                            c[2] * kRowBytes, v[4], v[5]);
  g_table[q][1] = make_int4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" {

int texcomp_dxt_hq_cluster_topk4(const void* prefix, int n, const void* cuts,
                                 const void* qtab, int n_parts, void* out,
                                 void* stream) {
  if (n_parts < 4 || n_parts > kMaxParts) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pack_table_kernel<<<(n_parts + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int32_t*>(cuts), static_cast<const float*>(qtab),
      n_parts);
  cluster_topk4_kernel<<<(n + kBlocks - 1) / kBlocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(prefix), n, n_parts,
      static_cast<const int32_t*>(cuts), static_cast<const float*>(qtab),
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

// Registers per thread, static shared memory in bytes, and resident CTAs
// per SM of the kernel, into out[0..2].
int texcomp_dxt_hq_cluster_topk4_info(int* out) {
  return texcomp::kernel_info(
      reinterpret_cast<const void*>(cluster_topk4_kernel), kThreads, out);
}

}  // extern "C"
