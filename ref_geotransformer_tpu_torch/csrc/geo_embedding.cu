// Geometric structure embedding, fused: sinusoids, both projections and the
// angle max in one kernel, with the (N, N, k, C) intermediate never written.
//
// Replaces the TPU kernel `geometric_embedding_pallas` (`_geo_embedding_kernel`)
// in ref_geotransformer_tpu/models/pallas_kernels.py. For every node pair
// (i, j), with anc = p_j - p_i:
//     d      = |anc| / sigma_d
//     a_t    = atan2(|r_it x anc|, r_it . anc) * factor_a      (t < k)
//     out_ij = (sc(d) @ Wd + bd) + max_t (sc(a_t) @ Wa + ba)
// where sc(x) = [sin(x * div_term), cos(x * div_term)] (C values: C/2
// frequencies, sines first) and Wd, Wa are (C, C) with rows in that order.
// With the cloud's node masks, out_ij is computed where nodes i and j are
// both valid and is 0 wherever either is padded: no caller reads those
// entries (the attention masks padded keys, and padded queries reach no
// valid row), and 0 keeps them finite.
//
// What bounds it on an H100: the products. Per pair it evaluates (k + 1)
// products of a C-vector with a C x C matrix (0.5 MFLOP at k = 3, C = 256):
// 0.55 TFLOP per call at N = 1024 with every node valid, against 1.07 GB of
// output. The products must keep f32 accuracy (the output is held to the
// plain f32 version), and the card's f32-accurate rate is on the tensor
// cores: three TF32 products per f32 product at 495 TFLOP/s, 165 TFLOP/s in
// effect (3.3 ms at N = 1024), against 67 TFLOP/s of f32 FMA on the CUDA
// cores (8.2 ms). Beside them: (k + 1) * C/2 precise sin/cos pairs per pair
// (arguments reach ~25 rad) on the CUDA cores, and the weights, which every
// block reads from L2. With n of N nodes valid the products scale with n^2
// (at n = 350 of 1024, 12% of them) and the output stays N^2 C floats: the
// zeros are 0.3 ms of the memory's rate at N = 1024.
//
// What the design does about it:
// - Only valid pairs are computed. The grid still covers all N^2 pairs, and
//   each block decides from the masks on the device (no count read on the
//   host): a block whose row i is padded, or whose 64 columns are all
//   padded, writes its zeros as 16-byte stores and exits before any
//   product; a block with some padded columns computes as one without
//   masks and stores 0 in those columns. The coarse level's valid nodes are
//   a prefix, so at n valid nodes about n * ceil(n / 64) of the
//   ceil(N / 64) * N blocks compute. Computed tiles run the same arithmetic
//   as without masks, so their valid entries are equal bit for bit.
// - Products on the tensor cores: warp-level `mma.sync.m16n8k8` TF32 with
//   f32 accumulators. Each operand x is split into big = x truncated to
//   TF32 and small = (x - big) truncated to TF32 (x - big is exact in f32),
//   and a product is small*big + big*small + big*big: ~2^-20 relative,
//   where one TF32 pass alone is off by ~1e-3 on this output. Shared memory
//   holds plain f32; the split (two masks and an add: cvt.rna.tf32.f32
//   took measurably longer) happens as a fragment is loaded.
// - A block owns 64 pairs (row i, columns j0 .. j0 + 63) and all C output
//   channels: 8 warps, 2 along the pairs x 4 along the channels, each warp
//   a 32-pair x C/4-channel tile (2 x C/32 mma tiles). Against 32 pairs a
//   block this halves the weight bytes read from L2 (~17 GB per call at
//   N = 1024).
// - The weights stream through shared memory in chunks of 32 rows, two
//   stages with `cp.async`: chunk s + 1 (of this branch or the next) is in
//   flight while chunk s is multiplied.
// - The sinusoid tiles (64 x C) are double-buffered: the next branch's tile
//   is computed on the CUDA cores a quarter of a chunk at a time between
//   this branch's mma steps, so only the first branch's sinusoids stand
//   alone. The arguments of all k + 1 branches are computed once per block.
// - The k angle branches run first, keeping the running max in one
//   accumulator set; the distance branch then runs into the free set and
//   each output element is written once: (d + bd) + max. Two sets of 64
//   f32 per thread; one block of 8 warps per SM (~197 KB of shared memory).
// - Row strides of C + 4 floats (sinusoids) and C + 8 (weights) put the A
//   and B fragment loads of a warp on 32 distinct banks.
// - Stores are 8 bytes a thread straight from the accumulators: each warp
//   store fills whole 32-byte sectors, and the output is a fraction of a
//   millisecond of the memory's rate.
// - Any N: the grid has ceil(N / 64) column tiles; the ragged last tile
//   computes its columns j >= N from node N - 1 and does not store them.
// - Each computing block adds 1 to a device counter, so a caller can read
//   how often the skip engaged.
// Measured on an H100 (PERF.md): 10.8 ms at N = 1024, 2.8 ms at N = 512,
// every node valid (11.0 ms at N = 1024 with the mask's code in place); with
// 310 / 350 / 410 valid nodes of 1024, 1.3 / 1.7 / 2.2 ms, where 9.5 / 12.8 /
// 17.5% of the blocks compute.
// Tried in trials and slower or no faster: 16-row chunks in three stages,
// the three products in passes over all tiles instead of per tile, a
// persistent block per SM that also fills the next tile's first sinusoids,
// 16 warps as 4 x 4 and 8 warps as 1 x 8 (2 x 8 was a little faster but
// needs C % 64 == 0). All land close to each other, which points at the
// `mma.sync` path itself rather than at this kernel's stalls.
// `wgmma` and TMA are left until a profile shows `mma.sync` issue-bound.
//
// Limits: N >= 1, C % 32 == 0, C <= 256, k >= 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsN = 4;                        // warps along the channels; 2 along the pairs
constexpr int kPairs = 64;                        // pairs per block: row i, columns j0 .. j0 + 63
constexpr int kMTiles = 2;                        // 16-pair mma tiles per warp
constexpr int kMaxC = 256;
constexpr int kMaxNTiles = kMaxC / (8 * kWarpsN);  // 8-channel mma tiles per warp
constexpr int kChunk = 32;                        // weight rows per pipeline stage
constexpr int kStages = 2;
constexpr int kFeatStride = kMaxC + 4;
constexpr int kWStride = kMaxC + 8;
// sin/cos pairs of the next branch's tile computed per chunk of this
// branch: kPairs * C/2 of them over C / kChunk chunks, whatever C is
constexpr int kFillPerChunk = kPairs * kChunk / 2;
constexpr int kFillPerStep = kFillPerChunk / (kChunk / 8);  // per 8-row mma step: one a thread

struct __align__(16) Smem {
  float feat[2][kPairs * kFeatStride];     // feat[b % 2][p * kFeatStride + ci]: sinusoids of branch b
  float w[kStages][kChunk * kWStride];     // weight rows of a chunk
};  // followed by the sinusoid arguments idx[b * kPairs + p] of the k + 1 branches

// rows 0 .. kChunk - 1 of src (row length c) into a stage
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ src, int c) {
  const int per_row = c / 4;
  for (int e = threadIdx.x; e < kChunk * per_row; e += kThreads) {
    const int r = e / per_row, q = e - r * per_row;
    cp_async16(dst + r * kWStride + 4 * q, src + (size_t)r * c + 4 * q);
  }
}

// sin/cos pair `item` (pair item / half, frequency item % half) of a tile
__device__ __forceinline__ void fill_one(float* feat, const float* idx, const float* __restrict__ div_term, int half,
                                         int item) {
  const int p = item / half, f = item - p * half;
  float s, c;
  sincosf(idx[p] * div_term[f], &s, &c);
  feat[p * kFeatStride + f] = s;
  feat[p * kFeatStride + half + f] = c;
}

// kC: the channel count when known at compile time, or 0 for any C % 32 == 0
// (at C = 256 the generic instance measured 62% slower: PERF.md)
template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
    geo_embedding_kernel(const float* __restrict__ points, const float* __restrict__ ref_vectors,
                         const float* __restrict__ div_term, const float* __restrict__ wd,
                         const float* __restrict__ bd, const float* __restrict__ wa, const float* __restrict__ ba,
                         const bool* __restrict__ masks, float* __restrict__ out,
                         unsigned long long* __restrict__ computed, int n, int k, int c_arg, float sigma_d,
                         float factor_a) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  float* idx = reinterpret_cast<float*>(&sm + 1);
  const int c = kC > 0 ? kC : c_arg;
  const int ntiles = c / (8 * kWarpsN);
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * kPairs;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;  // mma fragment coordinates: group, thread in group
  const int row0 = (warp / kWarpsN) * (16 * kMTiles);
  const int col0 = (warp % kWarpsN) * (c / kWarpsN);
  const int half = c / 2;
  const int nk = c / kChunk;         // chunks per branch
  const int total = (k + 1) * nk;    // k angle branches, then the distance branch

  // a padded row, or a tile of padded columns: zeros, and nothing computed
  // (the row's stored columns j0 .. j0 + cols - 1 are contiguous); else bit
  // 2 * mt + h of `keep` says whether this thread's output column
  // j0 + row0 + mt * 16 + g + 8 * h is valid
  unsigned keep = 0xfu;
  if (masks != nullptr) {
    const int cols = min(kPairs, n - j0);
    if (!(masks[i] && __syncthreads_or(tid < cols && masks[j0 + tid]))) {
      float4* dst = reinterpret_cast<float4*>(out + ((size_t)i * n + j0) * c);
      for (int e = tid; e < cols * c / 4; e += kThreads) dst[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      return;
    }
    keep = 0u;
#pragma unroll
    for (int b = 0; b < 2 * kMTiles; ++b) {
      const int j = j0 + row0 + (b / 2) * 16 + g + 8 * (b % 2);
      if (j < n && masks[j]) keep |= 1u << b;
    }
  }
  if (tid == 0) atomicAdd(computed, 1ull);

  auto issue = [&](int s) {
    if (s < total) {
      const float* w = (s / nk < k) ? wa : wd;
      load_chunk(sm.w[s % kStages], w + (size_t)(s % nk) * kChunk * c, c);
    }
    cp_async_commit();
  };
  issue(0);

  if (tid < kPairs) {
    const int j = min(j0 + tid, n - 1);  // the ragged tile's columns j >= n: any valid node, not stored
    const float ax = points[3 * j] - points[3 * i];
    const float ay = points[3 * j + 1] - points[3 * i + 1];
    const float az = points[3 * j + 2] - points[3 * i + 2];
    for (int a = 0; a < k; ++a) {
      const float* r = ref_vectors + ((size_t)i * k + a) * 3;
      const float rx = r[0], ry = r[1], rz = r[2];
      const float cx = ry * az - rz * ay;
      const float cy = rz * ax - rx * az;
      const float cz = rx * ay - ry * ax;
      const float sin_v = sqrtf(fmaxf(cx * cx + cy * cy + cz * cz, 0.0f));
      float cos_v = rx * ax + ry * ay + rz * az;
      // on the diagonal (anc = 0) the dot product can be -0, and
      // atan2f(+0, -0) = pi; the reference sums from +0 and gets angle 0
      if (cos_v == 0.0f) cos_v = 0.0f;
      idx[a * kPairs + tid] = atan2f(sin_v, cos_v) * factor_a;
    }
    idx[k * kPairs + tid] = sqrtf(fmaxf(ax * ax + ay * ay + az * az, 0.0f)) / sigma_d;
  }
  __syncthreads();
  for (int item = tid; item < kPairs * half; item += kThreads) fill_one(sm.feat[0], idx, div_term, half, item);

  float acc[kMTiles][kMaxNTiles][4];
  float amax[kMTiles][kMaxNTiles][4];
  for (int s = 0; s < total; ++s) {
    const int branch = s / nk, chunk = s % nk;
    cp_async_wait_all();  // this thread's copies of chunk s have landed
    __syncthreads();      // everyone's have; the tile is written; the other stage is free
    issue(s + 1);
    if (chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kMaxNTiles; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;
    }
    const float* feat = sm.feat[branch % 2];
    const float* w = sm.w[s % kStages];
    const bool fill_next = branch < k;  // the next branch's tile is filled under this one's products
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 8) {
      const int kc = chunk * kChunk + kk;  // feature column of the tile
      uint32_t a_big[kMTiles][4], a_small[kMTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        const float* f = feat + (row0 + mt * 16 + g) * kFeatStride + kc + tg;
        split(f[0], a_big[mt][0], a_small[mt][0]);
        split(f[8 * kFeatStride], a_big[mt][1], a_small[mt][1]);
        split(f[4], a_big[mt][2], a_small[mt][2]);
        split(f[8 * kFeatStride + 4], a_big[mt][3], a_small[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kMaxNTiles; ++nt) {
        if (nt < ntiles) {
          const float* b = w + (kk + tg) * kWStride + col0 + nt * 8 + g;
          uint32_t b_big[2], b_small[2];
          split(b[0], b_big[0], b_small[0]);
          split(b[4 * kWStride], b_big[1], b_small[1]);
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) {  // the small terms first
            mma_tf32(acc[mt][nt], a_small[mt], b_big);
            mma_tf32(acc[mt][nt], a_big[mt], b_small);
          }
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) mma_tf32(acc[mt][nt], a_big[mt], b_big);
        }
      }
      if (fill_next)
        fill_one(sm.feat[(branch + 1) % 2], idx + (branch + 1) * kPairs, div_term, half,
                 chunk * kFillPerChunk + (kk / 8) * kFillPerStep + tid);
    }

    if (chunk == nk - 1) {
      const bool angle = branch < k;
      const float* bias = angle ? ba : bd;
#pragma unroll
      for (int nt = 0; nt < kMaxNTiles; ++nt) {
        if (nt < ntiles) {
          const int col = col0 + nt * 8 + 2 * tg;  // this thread's channels col, col + 1
          const float2 bq = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the tile
              const float v0 = acc[mt][nt][2 * h] + bq.x, v1 = acc[mt][nt][2 * h + 1] + bq.y;
              if (angle) {
                amax[mt][nt][2 * h] = (branch == 0) ? v0 : fmaxf(amax[mt][nt][2 * h], v0);
                amax[mt][nt][2 * h + 1] = (branch == 0) ? v1 : fmaxf(amax[mt][nt][2 * h + 1], v1);
              } else {
                const int j = j0 + row0 + mt * 16 + g + 8 * h;
                if (j < n) {
                  float2 v = make_float2(v0 + amax[mt][nt][2 * h], v1 + amax[mt][nt][2 * h + 1]);
                  if (!((keep >> (2 * mt + h)) & 1u)) v = make_float2(0.0f, 0.0f);  // a padded column
                  *reinterpret_cast<float2*>(out + ((size_t)i * n + j) * c + col) = v;
                }
              }
            }
          }
        }
      }
    }
  }
}

constexpr size_t smem_bytes(int k) { return sizeof(Smem) + sizeof(float) * (size_t)(k + 1) * kPairs; }

template <int kC>
int launch(const float* points, const float* ref_vectors, const float* div_term, const float* wd, const float* bd,
           const float* wa, const float* ba, const bool* masks, float* out, unsigned long long* computed, int n,
           int k, int c, float sigma_d, float factor_a, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(geo_embedding_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes(k));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kPairs - 1) / kPairs, n);
  geo_embedding_kernel<kC><<<grid, kThreads, smem_bytes(k), stream>>>(points, ref_vectors, div_term, wd, bd, wa, ba,
                                                                       masks, out, computed, n, k, c, sigma_d,
                                                                       factor_a);
  return (int)cudaGetLastError();
}

}  // namespace

// points (N, 3), ref_vectors (N, k, 3), div_term (C/2,), wd and wa (C, C)
// with rows in [sin..., cos...] order, bd and ba (C,), out (N, N, C): f32,
// contiguous, 16-byte aligned, on the device; masks (N,) bool on the device,
// or null for every node valid; computed: one int64 on the device, to which
// each computing block adds 1. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes outside the limits).
extern "C" int gt_geo_embedding(const float* points, const float* ref_vectors, const float* div_term,
                                const float* wd, const float* bd, const float* wa, const float* ba, const bool* masks,
                                float* out, unsigned long long* computed, int n, int k, int c, float sigma_d,
                                float factor_a, void* stream) {
  if (n <= 0 || k < 1 || smem_bytes(k) > 227 * 1024 || c <= 0 || c > kMaxC ||
      c % (8 * kWarpsN) != 0 || computed == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == kMaxC)
    return launch<kMaxC>(points, ref_vectors, div_term, wd, bd, wa, ba, masks, out, computed, n, k, c, sigma_d,
                         factor_a, s);
  return launch<0>(points, ref_vectors, div_term, wd, bd, wa, ba, masks, out, computed, n, k, c, sigma_d, factor_a,
                   s);
}
