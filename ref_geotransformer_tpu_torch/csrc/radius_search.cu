// Fixed-width radius search: the `limit` nearest valid supports of each
// query inside a radius, from fused distances and a bounded top-k, with no
// (M, N) distance matrix written anywhere.
//
// Replaces `ref_geotransformer_tpu/ops/neighbors.py::radius_search_brute`
// through `lax.approx_min_k` (`_chunked_topk_neighbors`, the default method
// "approx" of `radius_search`): the TPU's PartialReduce over (chunk, N)
// blocks of distances. For queries q (M, 3) with validity qm and supports
// s (N, 3) with validity sm it writes an (M, limit) int32 table: row i holds
// the valid supports j with d2(i, j) < r2, in ascending (d2, j) order, cut
// at `limit`; empty slots, and every slot of an invalid query, hold N.
//     d2(i, j) = max(|q_i|^2 - 2 q_i . s_j + |s_j|^2, 0)
// in f32, the form of the plain version (ops/pairwise.py). Ties go to the
// lower index, as `lax.top_k` and the host C++ kernel order them, so the
// table is deterministic: two launches give the same bits.
//
// What bounds it on an H100: the operations. Each (query, support) pair
// costs 8 f32 operations (a 3-term dot product and two adds): the pyramid of
// a 3DMatch pair at full capacities covers ~3.5e9 pairs, ~28 GFLOP, 0.42 ms
// at 67 TFLOP/s, against ~30 MB of tables at 3.35 TB/s (0.01 ms). The plain
// version writes and reads every distance instead (3.8 GB for the level-0
// self search alone) and runs a radix select over each chunk of them.
//
// What the design does about it:
// - One thread per query, the distances in registers only. The hot loop is
//   three FMAs and an add per pair (the query is held as -2 q and |q|^2)
//   and one compare against a threshold, folded into a bit mask over a
//   chunk of 32 supports: r2 while the list has free slots, then the list's
//   last distance. Nearly every support fails it.
// - The candidate list lives in registers: K (d2, j) slots, K the first of
//   16, 32, 40, 64, 128 that holds `limit` (the pyramids' limits are 32-40),
//   indexed only by unrolled loops, so it never touches local memory. A slot
//   below `limit` starts as (r2, N), one above it as (-inf, N), which no
//   candidate displaces; so the list's last distance is the threshold, and
//   an insertion is one unrolled compare-and-swap pass that carries the
//   displaced entry to the end. The clamp at 0 is applied there.
// - Insertions run together across the warp: after a chunk's masks are
//   built, the warp loops while any lane holds a flagged support, each
//   lane inserting its lowest one; a warp pays for the most insertions one
//   of its lanes makes, not for their sum (a first design, with the list in
//   local memory and inserted at the support that passed, was bound by one
//   lane's dependent loads at a time). Supports are inserted in increasing
//   j, and a tie goes after the entries already held: (d2, j) order with no
//   index compare. A support flagged against an older threshold is still
//   inserted rightly: if it is no longer ahead of the last entry, the pass
//   drops it.
// - Supports go through shared memory in tiles of kTile as (x, y, z, |s|^2),
//   |s|^2 computed once per support and tile; an invalid support, and the
//   padding of a tile to whole chunks, carries |s|^2 = +inf, so it fails
//   the compare with no mask test. A tile with no valid support, and a
//   block with no valid query, is skipped (the pyramid's clouds are padded
//   to their capacities).
// - Filling the card: the register list leaves room for a few blocks of 128
//   on an SM, and one thread per query gives 240 blocks at M = 30720. So the
//   supports are cut into S slices along gridDim.y, enough to fill every SM
//   with as many blocks as the instance's occupancy allows; each (block,
//   slice) keeps its own list and writes it as a partial, and a second small
//   launch merges the S partials of each query in (d2, slice) order, which
//   is (d2, j) order since the slices hold increasing j. One slice (small M
//   and N) writes the table directly, with no second launch.
// - No atomics: every partial and every table row has one writer.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kThreads = 128;   // queries per block
constexpr int kTile = 512;      // supports per shared-memory tile
constexpr int kChunk = 32;      // supports per bit mask
constexpr int kMaxLimit = 128;  // longest candidate list
constexpr int kMaxSlices = 32;
constexpr unsigned kWarp = 0xffffffffu;

// Insert (d, j) into the sorted list: each slot keeps the smaller of its
// entry and the carried one (the entry already held on a tie) and carries
// the other on; the threshold is the last slot below `limit`.
template <int K>
__device__ __forceinline__ void insert(float (&dist)[K], int (&idx)[K], float d, int j, int limit, float& thresh) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (d < dist[k]) {
      const float td = dist[k];
      const int tj = idx[k];
      dist[k] = d;
      idx[k] = j;
      d = td;
      j = tj;
    }
    if (k == limit - 1) thresh = dist[k];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
radius_search_kernel(const float* __restrict__ q, const float* __restrict__ s, const unsigned char* __restrict__ qm,
                     const unsigned char* __restrict__ sm, int m, int n, int limit, float r2, int len,
                     int* __restrict__ out, float* __restrict__ part_d, int* __restrict__ part_j,
                     int* __restrict__ part_n) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int j0 = blockIdx.y * len;  // this block's slice of the supports: [j0, j1)
  const int j1 = min(n, j0 + len);
  const bool valid = i < m && qm[i] != 0;

  float ax = 0.f, ay = 0.f, az = 0.f, qq = 0.f;
  if (valid) {
    const float x = q[3 * (size_t)i], y = q[3 * (size_t)i + 1], z = q[3 * (size_t)i + 2];
    ax = -2.f * x;
    ay = -2.f * y;
    az = -2.f * z;
    qq = x * x + y * y + z * z;
  }
  float dist[K];
  int idx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    dist[k] = k < limit ? r2 : -INFINITY;
    idx[k] = n;
  }
  float thresh = valid ? r2 : -INFINITY;  // an invalid query takes nothing

  if (__syncthreads_or(valid)) {
    for (int t0 = j0; t0 < j1; t0 += kTile) {
      const int tn = min(kTile, j1 - t0);
      const int padded = (tn + kChunk - 1) / kChunk * kChunk;
      int any = 0;
      for (int l = threadIdx.x; l < padded; l += kThreads) {
        float4 p = make_float4(0.f, 0.f, 0.f, INFINITY);
        if (l < tn) {
          const size_t j = (size_t)(t0 + l);
          p.x = s[3 * j];
          p.y = s[3 * j + 1];
          p.z = s[3 * j + 2];
          if (sm[j] != 0) {
            p.w = p.x * p.x + p.y * p.y + p.z * p.z;
            any = 1;
          }
        }
        tile[l] = p;
      }
      if (__syncthreads_or(any)) {  // the barrier also publishes the tile
        for (int c = 0; c < padded; c += kChunk) {
          unsigned mask = 0u;
#pragma unroll
          for (int b = 0; b < kChunk; ++b) {
            const float4 p = tile[c + b];
            const float d = fmaf(az, p.z, fmaf(ay, p.y, fmaf(ax, p.x, qq))) + p.w;
            mask |= (d < thresh ? 1u : 0u) << b;
          }
          while (__any_sync(kWarp, mask != 0u)) {
            if (mask != 0u) {
              const int b = __ffs(mask) - 1;
              mask &= mask - 1u;
              const float4 p = tile[c + b];
              const float d = fmaf(az, p.z, fmaf(ay, p.y, fmaf(ax, p.x, qq))) + p.w;
              insert<K>(dist, idx, fmaxf(d, 0.f), t0 + c + b, limit, thresh);
            }
          }
        }
      }
      __syncthreads();  // every thread is done with the tile before it is refilled
    }
  }

  if (i >= m) return;
  if (part_n == nullptr) {
    int* row = out + (size_t)i * limit;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < limit) row[k] = idx[k];
    }
  } else {
    const size_t p = (size_t)blockIdx.y * m + i;
    int cnt = 0;  // the entries come first, then the (r2, N) slots
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < limit && idx[k] != n) {
        part_d[p * limit + k] = dist[k];
        part_j[p * limit + k] = idx[k];
        cnt = k + 1;
      }
    }
    part_n[p] = cnt;
  }
}

// Row i of the table from the S sorted partials of query i: the smallest
// head distance first, the lower slice on a tie.
__global__ void __launch_bounds__(kThreads)
radius_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_j, const int* __restrict__ part_n,
                    int m, int n, int limit, int slices, int* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  int head[kMaxSlices], count[kMaxSlices];
  for (int y = 0; y < slices; ++y) {
    head[y] = 0;
    count[y] = part_n[(size_t)y * m + i];
  }
  int* row = out + (size_t)i * limit;
  for (int k = 0; k < limit; ++k) {
    int best = -1;
    float best_d = INFINITY;
    size_t best_at = 0;
    for (int y = 0; y < slices; ++y) {
      if (head[y] < count[y]) {
        const size_t at = ((size_t)y * m + i) * limit + head[y];
        const float d = part_d[at];
        if (best < 0 || d < best_d) {
          best = y;
          best_d = d;
          best_at = at;
        }
      }
    }
    if (best < 0) {
      for (; k < limit; ++k) row[k] = n;
      break;
    }
    row[k] = part_j[best_at];
    ++head[best];
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Slices of at least one tile each: the last may be shorter.
int slice_len(int n, int slices) { return ceil_div(ceil_div(n, slices), kTile) * kTile; }

template <int K>
int slices_for(int m, int n) {
  int device = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, radius_search_kernel<K>, kThreads, 0);
  }
  if (err != cudaSuccess) return -(int)err;
  const int want = ceil_div(sms * std::max(blocks, 1), ceil_div(m, kThreads));
  const int slices = std::max(1, std::min({want, kMaxSlices, ceil_div(n, kTile)}));
  return ceil_div(n, slice_len(n, slices));
}

template <int K>
int launch(const float* q, const float* s, const unsigned char* qm, const unsigned char* sm, int* out, float* part_d,
           int* part_j, int* part_n, int m, int n, int limit, float r2, int slices, cudaStream_t st) {
  const int len = slice_len(n, slices);
  slices = ceil_div(n, len);  // no more than asked for
  const dim3 grid(ceil_div(m, kThreads), slices);
  if (slices == 1) {
    radius_search_kernel<K><<<grid, kThreads, 0, st>>>(q, s, qm, sm, m, n, limit, r2, len, out, nullptr, nullptr,
                                                       nullptr);
    return (int)cudaGetLastError();
  }
  if (part_d == nullptr || part_j == nullptr || part_n == nullptr) return (int)cudaErrorInvalidValue;
  radius_search_kernel<K><<<grid, kThreads, 0, st>>>(q, s, qm, sm, m, n, limit, r2, len, out, part_d, part_j,
                                                     part_n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  radius_merge_kernel<<<ceil_div(m, kThreads), kThreads, 0, st>>>(part_d, part_j, part_n, m, n, limit, slices, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of slices to cut N supports into for M queries and `limit` on
// the current device: enough to fill every SM with as many blocks of the
// search as its instance's occupancy allows, at most kMaxSlices and at most
// one a tile. The wrapper allocates the partials for it and passes it to
// `gt_radius_search`. A CUDA error comes back negated.
extern "C" int gt_radius_search_slices(int m, int n, int limit) {
  if (m <= 0 || n <= 0 || limit < 1 || limit > kMaxLimit) return -(int)cudaErrorInvalidValue;
  if (limit <= 16) return slices_for<16>(m, n);
  if (limit <= 32) return slices_for<32>(m, n);
  if (limit <= 40) return slices_for<40>(m, n);
  if (limit <= 64) return slices_for<64>(m, n);
  return slices_for<128>(m, n);
}

// q (M, 3), s (N, 3) f32; qm (M,), sm (N,) bool (one byte, 0 or 1); out
// (M, limit) int32; `slices` from gt_radius_search_slices(M, N, limit). With
// slices > 1, part_d (slices, M, limit) f32, part_j (slices, M, limit) int32
// and part_n (slices, M) int32 are scratch; with 1 they are unused (may be
// null). All contiguous, on the device. Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for M, N < 1, limit outside
// 1..kMaxLimit or slices outside 1..kMaxSlices).
extern "C" int gt_radius_search(const float* q, const float* s, const unsigned char* qm, const unsigned char* sm,
                                int* out, float* part_d, int* part_j, int* part_n, int m, int n, int limit, float r2,
                                int slices, void* stream) {
  if (m <= 0 || n <= 0 || limit < 1 || limit > kMaxLimit || slices < 1 || slices > kMaxSlices) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (limit <= 16) return launch<16>(q, s, qm, sm, out, part_d, part_j, part_n, m, n, limit, r2, slices, st);
  if (limit <= 32) return launch<32>(q, s, qm, sm, out, part_d, part_j, part_n, m, n, limit, r2, slices, st);
  if (limit <= 40) return launch<40>(q, s, qm, sm, out, part_d, part_j, part_n, m, n, limit, r2, slices, st);
  if (limit <= 64) return launch<64>(q, s, qm, sm, out, part_d, part_j, part_n, m, n, limit, r2, slices, st);
  return launch<128>(q, s, qm, sm, out, part_d, part_j, part_n, m, n, limit, r2, slices, st);
}
