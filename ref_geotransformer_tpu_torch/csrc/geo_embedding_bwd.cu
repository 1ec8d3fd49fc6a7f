// Backward of the geometric structure embedding: the gradients of the two
// projections, from the cotangent g of the (N, N, C) output.
//
// Replaces the TPU kernel `_geo_embedding_bwd` (`_geo_embedding_bwd_kernel`)
// in ref_geotransformer_tpu/models/pallas_kernels.py. With the forward of
// csrc/geo_embedding.cu, out_ij = (e_d(ij) @ Wd + bd) + max_t (e_t(ij) @ Wa + ba),
// summed over all N^2 node pairs (rows r = (i, j)):
//     dWd = sum_r e_d(r)^T g(r)            dbd = dba = sum_r g(r)
//     dWa = sum_r sum_t e_t(r)^T (g(r) * mask_t(r))
// where mask_t(r, c) = [proj_t(r, c) == max_s proj_s(r, c)] / #ties: the
// vjp of a max, which splits the gradient equally among tied branches. Ties
// are exact and frequent: on the diagonal and between nodes at one location
// the anchor vector is 0 and all k angles are 0. The k projections are
// recomputed here, as the TPU kernel does.
//
// What bounds it on an H100: arithmetic. Per row it recomputes (k + 1) * C/2
// sin/cos pairs and k products of a C-vector with the C x C matrix Wa, and
// accumulates k + 1 rank-one updates of C x C: at N = 1024, C = 256, k = 3
// that is 0.96 TFLOP of f32 FMA (14 ms at the 67 TFLOP/s f32 peak) against a
// single 1.07 GB read of g (0.32 ms at 3.35 TB/s).
//
// What the design does about it, simply (SIMT f32, no tensor cores yet):
// a block owns a slice of 64 output channels and a contiguous chunk of row
// tiles (32 pairs of one row i). Its slice of Wa (C x 64) stays in shared
// memory for the whole chunk; the sinusoid tiles of the current 32 pairs are
// recomputed into shared memory (precise sincosf and atan2f, -0 -> +0 on the
// diagonal as in the forward). The max over branches is per channel, so a
// block needs only its own channels' projections. Each thread keeps an
// 8 x 8 block of dWd and of dWa (channels ci = a + 32q, co = 8b .. 8b + 7) in
// registers across the chunk. The reduction over rows is deterministic: each
// (slice, chunk) block writes its partial sums to its own slot, and a second
// kernel adds the chunks' slots in a fixed order. No float atomics, so two
// launches on the same inputs give bit-identical gradients.
//
// Limits: N % 32 == 0, C % 64 == 0, C <= 256, 1 <= k <= 3.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 32;      // rows (pairs) per tile: row i, columns j0 .. j0 + 31
constexpr int kStride = 36;     // padded row stride of the transposed sinusoid tiles
constexpr int kSlice = 64;      // output channels per block
constexpr int kMaxC = 256;
constexpr int kMaxK = 3;
constexpr int kChunks = 256;    // row chunks: partial sums per (chunk, slice)

struct Smem {
  float emb[kMaxK][kMaxC * kStride];  // emb[t][ci * kStride + r]: sinusoids of branch t
  float wa[kMaxC * kSlice];           // wa[ci * kSlice + c]: this block's columns of Wa
  float gm[kMaxK][kPairs * kSlice];   // gm[t][r * kSlice + c]: g routed to branch t
  float g[kPairs * kSlice];           // g[r * kSlice + c]
  float idx[kMaxK + 1][kPairs];       // sinusoid arguments: distance, then the k angles
};

__device__ __forceinline__ void fill(float* emb, const float* idx, const float* __restrict__ div_term, int half) {
  for (int item = threadIdx.x; item < half * kPairs; item += kThreads) {
    const int f = item / kPairs, r = item % kPairs;
    float s, c;
    sincosf(idx[r] * div_term[f], &s, &c);
    emb[f * kStride + r] = s;
    emb[(half + f) * kStride + r] = c;
  }
}

// acc[q][e] += sum_r emb[(a + 32q) * kStride + r] * rhs[r * kSlice + 8b + e]
__device__ __forceinline__ void accumulate(float (&acc)[8][8], const float* emb, const float* rhs, int nq, int a,
                                           int b) {
  for (int r0 = 0; r0 < kPairs; r0 += 4) {
    float rv[4][8];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float4* p = reinterpret_cast<const float4*>(rhs + (r0 + rr) * kSlice + 8 * b);
      const float4 x = p[0], y = p[1];
      rv[rr][0] = x.x; rv[rr][1] = x.y; rv[rr][2] = x.z; rv[rr][3] = x.w;
      rv[rr][4] = y.x; rv[rr][5] = y.y; rv[rr][6] = y.z; rv[rr][7] = y.w;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q < nq) {
        const float4 ev = *reinterpret_cast<const float4*>(emb + (a + 32 * q) * kStride + r0);
        const float e4[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[q][e] = fmaf(e4[rr], rv[rr][e], acc[q][e]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    geo_embedding_bwd_kernel(const float* __restrict__ points, const float* __restrict__ ref_vectors,
                             const float* __restrict__ div_term, const float* __restrict__ wa,
                             const float* __restrict__ ba, const float* __restrict__ g,
                             float* __restrict__ partials, int n, int k, int c, float sigma_d, float factor_a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int co0 = blockIdx.x * kSlice;  // this block's output channels: co0 .. co0 + 63
  const int chunk = blockIdx.y;
  const int half = c / 2;
  const int nq = c / 32;
  const int a = tid / 8, b = tid % 8;      // accumulation: ci = a + 32q, co = 8b + e
  const int pr = tid / 32, pc = tid % 32;  // projection: rows 4pr .. 4pr + 3, channels 2pc, 2pc + 1

  for (int e = tid; e < c * kSlice; e += kThreads) s.wa[e] = wa[(size_t)(e / kSlice) * c + co0 + e % kSlice];
  float bias[2] = {ba[co0 + 2 * pc], ba[co0 + 2 * pc + 1]};

  float dwd[8][8], dwa[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) dwd[q][e] = dwa[q][e] = 0.0f;
  float db = 0.0f;  // thread tid < 64: channel co0 + tid

  const int tiles_per_row = n / kPairs;
  const long long tiles = (long long)n * tiles_per_row;
  const long long t_begin = tiles * chunk / kChunks, t_end = tiles * (chunk + 1) / kChunks;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const int i = (int)(tile / tiles_per_row);
    const int j0 = (int)(tile % tiles_per_row) * kPairs;
    __syncthreads();  // the previous tile's buffers are consumed
    if (tid < kPairs) {
      const int j = j0 + tid;
      const float ax = points[3 * j] - points[3 * i];
      const float ay = points[3 * j + 1] - points[3 * i + 1];
      const float az = points[3 * j + 2] - points[3 * i + 2];
      s.idx[0][tid] = sqrtf(fmaxf(ax * ax + ay * ay + az * az, 0.0f)) / sigma_d;
      for (int t = 0; t < k; ++t) {
        const float* r = ref_vectors + ((size_t)i * k + t) * 3;
        const float rx = r[0], ry = r[1], rz = r[2];
        const float cx = ry * az - rz * ay;
        const float cy = rz * ax - rx * az;
        const float cz = rx * ay - ry * ax;
        const float sin_v = sqrtf(fmaxf(cx * cx + cy * cy + cz * cz, 0.0f));
        float cos_v = rx * ax + ry * ay + rz * az;
        if (cos_v == 0.0f) cos_v = 0.0f;  // -0 -> +0: atan2f(+0, -0) would be pi
        s.idx[1 + t][tid] = atan2f(sin_v, cos_v) * factor_a;
      }
    }
    {
      const float* src = g + ((size_t)i * n + j0) * c + co0;
      for (int e = tid; e < kPairs * kSlice / 4; e += kThreads) {
        const int r = e / (kSlice / 4), q4 = e % (kSlice / 4);
        reinterpret_cast<float4*>(s.g)[e] = reinterpret_cast<const float4*>(src + (size_t)r * c)[q4];
      }
    }
    __syncthreads();

    // distance branch: dWd and the bias gradient
    fill(s.emb[0], s.idx[0], div_term, half);
    if (tid < kSlice)
      for (int r = 0; r < kPairs; ++r) db += s.g[r * kSlice + tid];
    __syncthreads();
    accumulate(dwd, s.emb[0], s.g, nq, a, b);
    __syncthreads();

    // angle branches: recompute the projections, route g to the winners
    for (int t = 0; t < k; ++t) fill(s.emb[t], s.idx[1 + t], div_term, half);
    __syncthreads();
    float proj[kMaxK][4][2];  // branch t, rows 4pr + rr, channels 2pc + q; static indices only
#pragma unroll
    for (int t = 0; t < kMaxK; ++t) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) proj[t][rr][0] = proj[t][rr][1] = 0.0f;
      if (t < k) {
        for (int ci = 0; ci < c; ++ci) {
          const float4 ev = *reinterpret_cast<const float4*>(s.emb[t] + ci * kStride + 4 * pr);
          const float2 w = *reinterpret_cast<const float2*>(s.wa + ci * kSlice + 2 * pc);
          const float e4[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            proj[t][rr][0] = fmaf(e4[rr], w.x, proj[t][rr][0]);
            proj[t][rr][1] = fmaf(e4[rr], w.y, proj[t][rr][1]);
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v[kMaxK];
        float best = -INFINITY;
#pragma unroll
        for (int t = 0; t < kMaxK; ++t) {
          v[t] = proj[t][rr][q] + bias[q];
          if (t < k) best = fmaxf(best, v[t]);
        }
        float ties = 0.0f;
#pragma unroll
        for (int t = 0; t < kMaxK; ++t) ties += (t < k && v[t] == best) ? 1.0f : 0.0f;
        const float share = 1.0f / ties;  // the mask value of a winning branch
        const int e = (4 * pr + rr) * kSlice + 2 * pc + q;
        const float ge = s.g[e];
#pragma unroll
        for (int t = 0; t < kMaxK; ++t)
          if (t < k) s.gm[t][e] = ge * ((v[t] == best) ? share : 0.0f);
      }
    }
    __syncthreads();
    for (int t = 0; t < k; ++t) accumulate(dwa, s.emb[t], s.gm[t], nq, a, b);
  }

  // this block's partial sums: [dWd (C x C) | dWa (C x C) | db (C)] of its chunk, its columns
  float* out = partials + (size_t)chunk * (2 * (size_t)c * c + c);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q < nq) {
      const size_t row = (size_t)(a + 32 * q) * c + co0 + 8 * b;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        out[row + e] = dwd[q][e];
        out[(size_t)c * c + row + e] = dwa[q][e];
      }
    }
  }
  if (tid < kSlice) out[2 * (size_t)c * c + co0 + tid] = db;
}

// out[e] = sum over chunks, in chunk order, of partials[chunk][e]
__global__ void sum_chunks_kernel(const float* __restrict__ partials, float* __restrict__ out, int size) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float acc = 0.0f;
  for (int ch = 0; ch < kChunks; ++ch) acc += partials[(size_t)ch * size + e];
  out[e] = acc;
}

}  // namespace

extern "C" int gt_geo_embedding_bwd_chunks() { return kChunks; }

// points (N, 3), ref_vectors (N, k, 3), div_term (C/2,), wa (C, C) with rows
// in [sin..., cos...] order, ba (C,), g (N, N, C); partials (chunks, 2C^2 + C)
// scratch; out (2C^2 + C,) = [dWd | dWa | db] with dbd = dba = db. All f32,
// contiguous, 16-byte aligned, on the device. Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for shapes outside the limits).
extern "C" int gt_geo_embedding_bwd(const float* points, const float* ref_vectors, const float* div_term,
                                    const float* wa, const float* ba, const float* g, float* partials, float* out,
                                    int n, int k, int c, float sigma_d, float factor_a, void* stream) {
  if (n <= 0 || n % kPairs != 0 || k < 1 || k > kMaxK || c <= 0 || c > kMaxC || c % kSlice != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(geo_embedding_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  geo_embedding_bwd_kernel<<<dim3(c / kSlice, kChunks), kThreads, smem, st>>>(
      points, ref_vectors, div_term, wa, ba, g, partials, n, k, c, sigma_d, factor_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = 2 * c * c + c;
  sum_chunks_kernel<<<(size + 255) / 256, 256, 0, st>>>(partials, out, size);
  return (int)cudaGetLastError();
}
