// Backward of the geometric structure embedding: the gradients of the two
// projections, from the cotangent g of the (N, N, C) output.
//
// Replaces the TPU kernel `_geo_embedding_bwd` (`_geo_embedding_bwd_kernel`)
// in ref_geotransformer_tpu/models/pallas_kernels.py. With the forward of
// csrc/geo_embedding.cu, out_ij = (e_d(ij) @ Wd + bd) + max_t (e_t(ij) @ Wa + ba),
// summed over all N^2 node pairs (rows r = (i, j)):
//     dWd = sum_r e_d(r)^T g(r)            dbd = dba = sum_r g(r)
//     dWa = sum_r sum_t e_t(r)^T (g(r) * mask_t(r))
// where mask_t(r, c) = [proj_t(r, c) == max_s proj_s(r, c)] / #ties and
// proj_t = e_t @ Wa + ba: the vjp of a max, which splits the gradient
// equally among tied branches. Ties are exact and frequent: on the diagonal
// and between nodes at one location the anchor vector is 0 and all k angles
// are 0. The k projections are recomputed here, as the TPU kernel does, and
// nothing of size (N, N, k, C) is written.
//
// What bounds it on an H100: the products. Per row, k projections of a
// C-vector through the C x C matrix Wa and k + 1 rank-one updates of C x C:
// at N = 1024, C = 256, k = 3, 0.96 TFLOP. They must keep f32 accuracy (the
// gradients are held to the plain f32 version), and the card's f32-accurate
// rate is on the tensor cores: three TF32 products per f32 product at 495
// TFLOP/s, 165 TFLOP/s in effect (5.83 ms), against 67 TFLOP/s of f32 FMA
// on the CUDA cores (14.36 ms). g is read twice (0.64 ms at 3.35 TB/s;
// 0.32 ms once). Beside them: (k + 1) * C/2 precise sin/cos pairs per row
// and slice of 64 channels on the CUDA cores (arguments reach ~25 rad).
//
// What the design does about it:
// - Every product on the tensor cores: `mma.sync.m16n8k8` TF32 with f32
//   accumulators and both operands split into two TF32 terms (tf32_mma.cuh),
//   small*big + big*small + big*big, as in the forward kernel.
// - A block owns 64 output channels and one of 256 fixed chunks of row
//   tiles (32 pairs of one row i). Blocks of two kinds, by blockIdx.z:
//   angle blocks (z = 0, launched first: they carry 6 of the 7 products)
//   recompute the k projections of their 64 channels and accumulate dWa;
//   distance blocks (z = 1) accumulate dWd and db. A warp's weight-gradient
//   tile is input channels 32w .. 32w + 31 by all 64 output channels (2 x 8
//   mma tiles), and g is read twice.
// - The sums: the tensor cores' f32 accumulation loses more than an f32
//   add, and the error grows with the rows a chunk sums (a copy that keeps
//   a chunk's sums in the mma accumulators reads 3.7e-5 of the gradients'
//   magnitude at N = 1024, against 1.6e-6), so a tile's products go into
//   one set of 64 accumulators and after every tile are added into a
//   second set in plain f32.
// - Angle block, per tile: the projections of all k branches run together
//   (a warp: 16 rows x 16 channels, the Wa fragments shared by the
//   branches; this block's C x 64 slice of Wa stays in shared memory for
//   the whole chunk); each thread routes g, loaded into registers at the
//   start of the tile, to the winners of its 8 (row, channel) elements
//   straight from the accumulators (ties split equally: share = 1 / #ties)
//   into k routed tiles; then dWa += e_t^T (g * mask_t), branch by branch.
//   Under branch t's product the next tile's branch t - 1 sinusoids are
//   filled, so only the last branch's fill stands alone.
// - Distance block: two stages each of g (`cp.async`) and of the
//   sinusoids; the next tile's are loaded and filled under this tile's
//   product. One barrier a tile (angle blocks: k + 2).
// - The sinusoid tiles are read row-major (projections: rows by lane
//   group) and transposed (weight gradients: rows by thread in group).
//   No padding serves both, so they are stored unpadded and swizzled: bits
//   2-4 of the channel are XOR-ed with bits 0-2 of the row (at()), which
//   puts both fragment loads of a warp on 32 distinct banks. The g, routed
//   g and Wa tiles have row strides of 64 + 8 floats.
// - The reduction over rows is deterministic: each (slice, chunk, kind)
//   block writes its partial sums to its own part of its chunk's slot, and
//   a second kernel adds the chunks' slots in a fixed order. No float
//   atomics, so two launches on the same inputs give bit-identical
//   gradients.
// - Any N: each row i has ceil(N / 32) tiles; the ragged last tile of a
//   row computes its pairs j >= N from node N - 1 and takes their g as 0,
//   so they add exactly 0 to every sum.
// - 200,448 bytes of shared memory (three sinusoid tiles, the Wa slice,
//   three routed tiles): one block of 8 warps per SM. C = 256 has its own
//   instance, as in the forward; any other C % 64 == 0 takes the generic one.
// Tried and not kept: the routed g stored pre-split (big and small terms)
// in shared memory, and a deeper unroll of the projection loop: no faster.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md): 26.4 ms
// at N = 1024 and 6.8 ms at N = 512, against 46.7-47.0 and 12.0 ms for the
// earlier SIMT f32 kernel in the same run.
//
// Limits: N >= 1, C % 64 == 0, C <= 256, 1 <= k <= 3.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 32;                // rows (pairs) per tile: row i, columns j0 .. j0 + 31
constexpr int kSteps = kPairs / 8;        // 8-row mma steps of a weight-gradient product
constexpr int kSlice = 64;                // output channels per block
constexpr int kNTiles = kSlice / 8;       // 8-channel mma tiles of a weight-gradient warp
constexpr int kStride = kSlice + 8;       // row stride of the g, routed g and Wa tiles
constexpr int kMaxC = 256;
constexpr int kMaxK = 3;
constexpr int kChunks = 256;              // row chunks: partial sums per (chunk, slice)

struct __align__(16) Smem {
  float emb[kMaxK][kPairs * kMaxC];  // sinusoid tiles, element (r, ci) at at(r, ci, c)
  float wa[kMaxC * kStride];         // angle blocks: wa[ci * kStride + co], this block's columns of Wa
  float gm[kMaxK][kPairs * kStride];  // angle blocks: g routed to branch t; distance blocks: g, stages 0 and 1
  float idx[2][kMaxK][kPairs];        // sinusoid arguments of two consecutive tiles
};

// element (r, ci) of a sinusoid tile with rows of c floats (c % 32 == 0):
// bits 2-4 of ci XOR-ed with bits 0-2 of r
__device__ __forceinline__ int at(int r, int ci, int c) { return r * c + (ci ^ (((r & 3) << 3) | (r & 4))); }

// share `part` of kSteps of a sinusoid tile's sin/cos pairs (pair r,
// frequency f): C/64 a thread, one at a time (it runs between mma steps,
// beside both accumulator sets)
__device__ __forceinline__ void fill_part(float* emb, const float* idx, const float* __restrict__ div_term, int c,
                                          int part) {
  const int half = c / 2, per = kPairs * half / kSteps;
#pragma unroll 1
  for (int item = part * per + threadIdx.x; item < (part + 1) * per; item += kThreads) {
    const int r = item / half, f = item - r * half;
    float s, co;
    sincosf(idx[r] * div_term[f], &s, &co);
    emb[at(r, f, c)] = s;
    emb[at(r, half + f, c)] = co;
  }
}

__device__ __forceinline__ void fill(float* emb, const float* idx, const float* __restrict__ div_term, int c) {
  for (int part = 0; part < kSteps; ++part) fill_part(emb, idx, div_term, c, part);
}

// the sinusoid arguments of tile (i, j0 ..): the distance (angle blocks:
// the k angles) of pair r = threadIdx.x < kPairs; pairs j >= n, whose g is
// taken as 0, are given node n - 1's
__device__ __forceinline__ void arguments(float (*idx)[kPairs], const float* __restrict__ points,
                                          const float* __restrict__ ref_vectors, int i, int j0, int n, int k,
                                          bool angle, float sigma_d, float factor_a) {
  const int r = threadIdx.x, j = min(j0 + r, n - 1);
  const float ax = points[3 * j] - points[3 * i];
  const float ay = points[3 * j + 1] - points[3 * i + 1];
  const float az = points[3 * j + 2] - points[3 * i + 2];
  if (!angle) {
    idx[0][r] = sqrtf(fmaxf(ax * ax + ay * ay + az * az, 0.0f)) / sigma_d;
    return;
  }
  for (int t = 0; t < k; ++t) {
    const float* v = ref_vectors + ((size_t)i * k + t) * 3;
    const float rx = v[0], ry = v[1], rz = v[2];
    const float cx = ry * az - rz * ay;
    const float cy = rz * ax - rx * az;
    const float cz = rx * ay - ry * ax;
    const float sin_v = sqrtf(fmaxf(cx * cx + cy * cy + cz * cz, 0.0f));
    float cos_v = rx * ax + ry * ay + rz * az;
    if (cos_v == 0.0f) cos_v = 0.0f;  // -0 -> +0: atan2f(+0, -0) would be pi
    idx[t][r] = atan2f(sin_v, cos_v) * factor_a;
  }
}

// acc[mt][nt] += emb^T rhs over the tile's 32 rows: input channels
// ci0 + 16 mt .. (A = emb^T, read transposed), output channels 8 nt ..
// (B = rhs, rows of kStride). After the mma steps of rows 8 part ..,
// between(part) runs: a share of the next tile's sinusoid fill.
template <class Between>
__device__ __forceinline__ void weight_grad(float (&acc)[2][kNTiles][4], const float* emb, const float* rhs, int c,
                                            int ci0, int g, int tg, Between&& between) {
#pragma unroll
  for (int k0 = 0; k0 < kPairs; k0 += 8) {
    uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int ci = ci0 + 16 * mt + g;
      split(emb[at(k0 + tg, ci, c)], a_big[mt][0], a_small[mt][0]);
      split(emb[at(k0 + tg, ci + 8, c)], a_big[mt][1], a_small[mt][1]);
      split(emb[at(k0 + tg + 4, ci, c)], a_big[mt][2], a_small[mt][2]);
      split(emb[at(k0 + tg + 4, ci + 8, c)], a_big[mt][3], a_small[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const float* b = rhs + (k0 + tg) * kStride + 8 * nt + g;
      uint32_t b_big[2], b_small[2];
      split(b[0], b_big[0], b_small[0]);
      split(b[4 * kStride], b_big[1], b_small[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {  // the small terms first
        mma_tf32(acc[mt][nt], a_small[mt], b_big);
        mma_tf32(acc[mt][nt], a_big[mt], b_small);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][nt], a_big[mt], b_big);
    }
    between(k0 / 8);
  }
}

// tot += acc; acc = 0
__device__ __forceinline__ void flush(float (&tot)[2][kNTiles][4], float (&acc)[2][kNTiles][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tot[mt][nt][q] += acc[mt][nt][q];
        acc[mt][nt][q] = 0.0f;
      }
}

// kC: the channel count when known at compile time, or 0 for any C % 64 == 0
template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
    geo_embedding_bwd_kernel(const float* __restrict__ points, const float* __restrict__ ref_vectors,
                             const float* __restrict__ div_term, const float* __restrict__ wa,
                             const float* __restrict__ ba, const float* __restrict__ g,
                             float* __restrict__ partials, int n, int k, int c_arg, float sigma_d, float factor_a) {
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int c = kC > 0 ? kC : c_arg;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tg = lane % 4;  // mma fragment coordinates: group, thread in group
  const int co0 = blockIdx.x * kSlice;     // this block's output channels: co0 .. co0 + 63
  const int chunk = blockIdx.y;
  const bool angle = blockIdx.z == 0;
  const int ci0 = 32 * warp;               // weight gradients: input channels ci0 .. ci0 + 31 of this warp
  const bool has_rows = ci0 < c;

  const int tiles_per_row = (n + kPairs - 1) / kPairs;
  const long long tiles = (long long)n * tiles_per_row;
  const long long t_begin = tiles * chunk / kChunks, t_end = tiles * (chunk + 1) / kChunks;
  auto row_of = [&](long long tile) { return (int)(tile / tiles_per_row); };
  auto col_of = [&](long long tile) { return (int)(tile % tiles_per_row) * kPairs; };
  auto g_tile = [&](long long tile) { return g + ((size_t)row_of(tile) * n + col_of(tile)) * c + co0; };

  // acc: this tile's sums on the tensor cores; tot: the chunk's, in f32 adds
  float acc[2][kNTiles][4], tot[2][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = tot[mt][nt][q] = 0.0f;

  // the sinusoid arguments of tile t_begin + m lie in idx[m % 2]; those of
  // tile t + 2 are computed during tile t, whose own were used up by then
  auto args_of = [&](long long tile) {
    if (tile < t_end && tid < kPairs)
      arguments(s.idx[(tile - t_begin) & 1], points, ref_vectors, row_of(tile), col_of(tile), n, k, angle, sigma_d,
                factor_a);
  };
  args_of(t_begin);
  args_of(t_begin + 1);

  if (angle) {
    // projections: warp rows 16 pm .. 16 pm + 15, channels pn .. pn + 15
    const int pm = 16 * (warp & 1), pn = 16 * (warp >> 1);
    for (int e = tid; e < c * (kSlice / 4); e += kThreads) {
      const int r = e / (kSlice / 4), q = e % (kSlice / 4);
      cp_async16(s.wa + r * kStride + 4 * q, wa + (size_t)r * c + co0 + 4 * q);
    }
    cp_async_commit();
    float bias[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      bias[nt][0] = ba[co0 + pn + 8 * nt + 2 * tg];
      bias[nt][1] = ba[co0 + pn + 8 * nt + 2 * tg + 1];
    }
    // this thread's columns of a row-major A fragment, swizzled: the
    // element (pm + gq (+ 8), k0 + tg (+ 4)) lies at row * c + k0 + col[.]
    const int swz = ((gq & 3) << 3) | (gq & 4);
    const int col_lo = tg ^ swz, col_hi = (tg + 4) ^ swz;
    cp_async_wait_all();
    __syncthreads();
    if (t_begin < t_end)
      for (int t = 0; t < k; ++t) fill(s.emb[t], s.idx[0][t], div_term, c);

    for (long long tile = t_begin; tile < t_end; ++tile) {
      const int it = (int)(tile - t_begin) & 1;
      __syncthreads();  // this tile's sinusoid tiles are filled; the routed tiles are consumed
      float2 gv[2][2];  // g at rows pm + gq + 8h, channels pn + 8nt + 2tg, + 1 (0 for pairs j >= n)
      {
        const float* src = g_tile(tile);
        const int rows = n - col_of(tile);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            gv[nt][h] = pm + gq + 8 * h < rows
                            ? __ldg(reinterpret_cast<const float2*>(src + (size_t)(pm + gq + 8 * h) * c + pn +
                                                                    8 * nt + 2 * tg))
                            : make_float2(0.0f, 0.0f);
      }
      args_of(tile + 2);

      // the k projections of this warp's 16 rows x 16 channels, together
      float proj[kMaxK][2][4];
#pragma unroll
      for (int t = 0; t < kMaxK; ++t)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) proj[t][nt][q] = 0.0f;
#pragma unroll 2
      for (int k32 = 0; k32 < c; k32 += 32) {
#pragma unroll
        for (int kk = 0; kk < 32; kk += 8) {
          // kk (bits 3-4) meets the swizzle (bits 2-4) in bits 3-4 only
          const int lo = k32 + (kk ^ (col_lo & ~7)) + (col_lo & 7);
          const int hi = k32 + (kk ^ (col_hi & ~7)) + (col_hi & 7);
          uint32_t b_big[2][2], b_small[2][2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* b = s.wa + (k32 + kk + tg) * kStride + pn + 8 * nt + gq;
            split(b[0], b_big[nt][0], b_small[nt][0]);
            split(b[4 * kStride], b_big[nt][1], b_small[nt][1]);
          }
#pragma unroll
          for (int t = 0; t < kMaxK; ++t) {
            if (t < k) {
              const float* e = s.emb[t] + (pm + gq) * c;
              uint32_t a_big[4], a_small[4];
              split(e[lo], a_big[0], a_small[0]);
              split(e[8 * c + lo], a_big[1], a_small[1]);
              split(e[hi], a_big[2], a_small[2]);
              split(e[8 * c + hi], a_big[3], a_small[3]);
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {  // the small terms first
                mma_tf32(proj[t][nt], a_small, b_big[nt]);
                mma_tf32(proj[t][nt], a_big, b_small[nt]);
              }
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) mma_tf32(proj[t][nt], a_big, b_big[nt]);
            }
          }
        }
      }

      // route g to the winning branches of each (row, channel)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float routed[kMaxK][2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float v[kMaxK];
            float best = -INFINITY;
#pragma unroll
            for (int t = 0; t < kMaxK; ++t) {
              v[t] = proj[t][nt][2 * h + q] + bias[nt][q];
              if (t < k) best = fmaxf(best, v[t]);
            }
            float ties = 0.0f;
#pragma unroll
            for (int t = 0; t < kMaxK; ++t) ties += (t < k && v[t] == best) ? 1.0f : 0.0f;
            const float share = 1.0f / ties;  // the mask value of a winning branch
            const float gval = q == 0 ? gv[nt][h].x : gv[nt][h].y;
#pragma unroll
            for (int t = 0; t < kMaxK; ++t) routed[t][q] = (v[t] == best) ? gval * share : 0.0f;
          }
          const int e = (pm + gq + 8 * h) * kStride + pn + 8 * nt + 2 * tg;
#pragma unroll
          for (int t = 0; t < kMaxK; ++t)
            if (t < k) *reinterpret_cast<float2*>(s.gm[t] + e) = make_float2(routed[t][0], routed[t][1]);
        }
      }
      __syncthreads();

      // dWa, branch by branch; under branch t the next tile's branch t - 1
      // is filled, once every warp is done with it
      const bool next = tile + 1 < t_end;
      const float(*next_idx)[kPairs] = s.idx[it ^ 1];
      for (int t = 0; t < k; ++t) {
        if (t > 0) __syncthreads();
        auto between = [&](int part) {
          if (next && t > 0) fill_part(s.emb[t - 1], next_idx[t - 1], div_term, c, part);
        };
        if (has_rows) {
          weight_grad(acc, s.emb[t], s.gm[t], c, ci0, gq, tg, between);
        } else {
          for (int part = 0; part < kSteps; ++part) between(part);
        }
      }
      if (has_rows) flush(tot, acc);
      __syncthreads();
      if (next) fill(s.emb[k - 1], next_idx[k - 1], div_term, c);
    }
  } else {
    float db = 0.0f;  // thread tid < kSlice: channel co0 + tid
    auto load_g = [&](long long tile, float* dst) {
      if (tile < t_end) {
        const float* src = g_tile(tile);
        const int rows = n - col_of(tile);  // pairs j >= n get g = 0
        for (int e = tid; e < kPairs * (kSlice / 4); e += kThreads) {
          const int r = e / (kSlice / 4), q = e % (kSlice / 4);
          if (r < rows)
            cp_async16(dst + r * kStride + 4 * q, src + (size_t)r * c + 4 * q);
          else
            *reinterpret_cast<float4*>(dst + r * kStride + 4 * q) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
      cp_async_commit();
    };
    // two stages each of g (gm[0], gm[1]) and of the sinusoids (emb[0], emb[1])
    load_g(t_begin, s.gm[0]);
    __syncthreads();
    if (t_begin < t_end) fill(s.emb[0], s.idx[0][0], div_term, c);
    for (long long tile = t_begin; tile < t_end; ++tile) {
      const int it = (int)(tile - t_begin) & 1;
      cp_async_wait_all();  // this tile's g
      __syncthreads();      // this tile's g and sinusoids are in; the other stages are consumed
      load_g(tile + 1, s.gm[it ^ 1]);
      args_of(tile + 2);
      const float* gt = s.gm[it];
      if (tid < kSlice)
        for (int r = 0; r < kPairs; ++r) db += gt[r * kStride + tid];
      const bool next = tile + 1 < t_end;
      auto between = [&](int part) {
        if (next) fill_part(s.emb[it ^ 1], s.idx[it ^ 1][0], div_term, c, part);
      };
      if (has_rows) {
        weight_grad(acc, s.emb[it], gt, c, ci0, gq, tg, between);
        flush(tot, acc);
      } else {
        for (int part = 0; part < kSteps; ++part) between(part);
      }
    }
    cp_async_wait_all();
    if (tid < kSlice) partials[(size_t)chunk * (2 * (size_t)c * c + c) + 2 * (size_t)c * c + co0 + tid] = db;
  }

  // this block's partial sums of its chunk, its columns: dWa (angle) or dWd
  // (distance), in the slot [dWd (C x C) | dWa (C x C) | db (C)]
  if (has_rows) {
    float* out = partials + (size_t)chunk * (2 * (size_t)c * c + c) + (angle ? (size_t)c * c : 0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const size_t e = (size_t)(ci0 + 16 * mt + gq) * c + co0 + 8 * nt + 2 * tg;
        *reinterpret_cast<float2*>(out + e) = make_float2(tot[mt][nt][0], tot[mt][nt][1]);
        *reinterpret_cast<float2*>(out + e + 8 * (size_t)c) = make_float2(tot[mt][nt][2], tot[mt][nt][3]);
      }
    }
  }
}

// out[e] = sum over chunks, in chunk order, of partials[chunk][e]
__global__ void sum_chunks_kernel(const float* __restrict__ partials, float* __restrict__ out, int size) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float acc = 0.0f;
  for (int ch = 0; ch < kChunks; ++ch) acc += partials[(size_t)ch * size + e];
  out[e] = acc;
}

template <int kC>
int launch(const float* points, const float* ref_vectors, const float* div_term, const float* wa, const float* ba,
           const float* g, float* partials, int n, int k, int c, float sigma_d, float factor_a, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  const cudaError_t err =
      cudaFuncSetAttribute(geo_embedding_bwd_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  geo_embedding_bwd_kernel<kC><<<dim3(c / kSlice, kChunks, 2), kThreads, smem, stream>>>(
      points, ref_vectors, div_term, wa, ba, g, partials, n, k, c, sigma_d, factor_a);
  return (int)cudaGetLastError();
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
  if (n <= 0 || k < 1 || k > kMaxK || c <= 0 || c > kMaxC || c % kSlice != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = c == kMaxC
                      ? launch<kMaxC>(points, ref_vectors, div_term, wa, ba, g, partials, n, k, c, sigma_d, factor_a, st)
                      : launch<0>(points, ref_vectors, div_term, wa, ba, g, partials, n, k, c, sigma_d, factor_a, st);
  if (err != cudaSuccess) return err;
  const int size = 2 * c * c + c;
  sum_chunks_kernel<<<(size + 255) / 256, 256, 0, st>>>(partials, out, size);
  return (int)cudaGetLastError();
}
