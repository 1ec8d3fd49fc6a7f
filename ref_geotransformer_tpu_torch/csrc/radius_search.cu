// Fixed-width radius search over a group of searches in one launch: for
// each search the `limit` nearest valid supports of each query inside a
// radius, from fused distances and a bounded top-k, with no (M, N)
// distance matrix and no partial list written to device memory.
//
// Replaces `ref_geotransformer_tpu/ops/neighbors.py::radius_search_brute`
// through `lax.approx_min_k` (`_chunked_topk_neighbors`, the default method
// "approx" of `radius_search`): the TPU's PartialReduce over (chunk, N)
// blocks of distances, run for the two clouds of a pair inside one jitted
// program. For queries q (M, 3) with validity qm and supports s (N, 3) with
// validity sm, a search writes an (M, limit) int32 table: row i holds the
// valid supports j with d2(i, j) < r2, in ascending (d2, j) order, cut at
// `limit` (1..kMaxLimit); empty slots, and every slot of an invalid query,
// hold N.
//     d2(i, j) = max(|q_i|^2 - 2 q_i . s_j + |s_j|^2, 0)
// in f32, the form of the plain version (ops/pairwise.py), evaluated as
//     fma(-2 q_z, s_z, fma(-2 q_y, s_y, fma(-2 q_x, s_x, |q_i|^2))) + |s_j|^2
// with |p|^2 from norm2. Ties go to the
// lower index, as `lax.top_k` and the host C++ kernel order them; nothing is
// summed by atomics, so two launches give the same bits.
//
// What bounds it on an H100: the operations. Each (query, support) pair
// costs 8 f32 operations (a 3-term dot product and two adds): the level-0
// self search of a 3DMatch cloud at full capacities covers ~3.6e8 valid
// pairs, 0.043 ms at 67 TFLOP/s, against ~5 MB of points and table at
// 3.35 TB/s.
//
// What the design does about it:
// - One launch for a group. The pyramids of a pair make 20 searches
//   (KITTI's 26) over a few point clouds. A first small launch packs each
//   distinct cloud once as (x, y, z, |p|^2), |p|^2 = +inf for an invalid
//   point (and the padding of its last tile), and records each tile's
//   largest |p|^2 (-1 for a tile with no valid point). The search launch
//   takes every search's descriptor by value (a __grid_constant__ struct,
//   no copy to the device); its grid is the searches' clusters laid end to
//   end, the costliest search first, and a block finds its search by the
//   prefix of cluster counts.
// - One thread per query, kThreads a block. The scan is three FMAs and a
//   compare per pair, folded into a bit mask over a chunk of 32 supports:
//   fma(-2q, s, |s|^2) against the query's threshold less |q|^2, widened by
//   the most rounding can move it (filter_bar). A flagged support is then
//   taken or dropped in the exact f32 form above. The threshold is r2 while
//   the query's list has free slots, then the list's largest distance. An
//   invalid support carries +inf and fails the filter; an invalid query
//   holds -inf and takes nothing.
// - The candidate lists live in shared memory, not in registers: a
//   candidate is one 64-bit key, (d2 bits, j), so keys order as (d2, j),
//   laid out [slot][query] so a lane's slots all sit in its own banks. A
//   list is appended to while it has free slots; once full, a new
//   candidate overwrites the largest key and the largest is found again.
//   Supports come in increasing j, so a tie with the largest key loses, as
//   it does in (d2, j) order. Candidates are taken together across a warp:
//   after a chunk's masks are built, the warp loops while any lane holds a
//   flagged support, each taking its lowest. At the end each lane sorts its
//   list. One instance serves every limit from 1 to kMaxLimit, and no
//   limit spills to local memory.
// - Supports stream through two shared-memory tiles: thread 0 starts the
//   bulk copy (`cp.async.bulk`, the 1-D TMA) of the slice's next tile that
//   holds a valid point while the warps scan the current one, and the copy
//   completes on an mbarrier. Tiles with no valid point, and blocks with no
//   valid query, are skipped (the pyramid's clouds are padded to their
//   capacities).
// - Filling the card: a search's supports may be cut into S slices (1, 2, 4
//   or 8; slice s takes every S-th tile from tile s, so the slices share the
//   valid points however a cloud is padded), chosen on the host from the
//   group's work. The S slices of one query block run as S CTAs of a
//   thread-block cluster; after a cluster barrier each CTA writes a share of
//   the block's rows, merging the S sorted lists by key through the
//   cluster's distributed shared memory. One launch has one cluster size,
//   the group's largest S; a cluster of a search with fewer slices holds
//   (cluster size / S) query blocks. Every row has one writer.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;    // threads per search block
constexpr int kTile = 256;       // supports per shared-memory tile
constexpr int kChunk = 32;       // supports per bit mask
constexpr int kMaxLimit = 128;   // longest candidate list
constexpr int kMaxCluster = 8;   // most slices of one search (the portable cluster size)
constexpr int kMinBlocks = 4;    // resident blocks the registers must allow (at most 128 a thread)
constexpr int kMaxSearches = 48;
constexpr int kMaxClouds = 64;
constexpr unsigned kWarp = 0xffffffffu;
constexpr float kSlack = 2e-6f;  // the scan filter's relative margin (filter_bar)
constexpr unsigned kTileBytes = kTile * sizeof(float4);

struct Cloud {  // one point cloud packed by radius_pack_kernel
  const float* points;
  const unsigned char* masks;
  float4* packed;        // ceil(n / kTile) * kTile points
  float* tile_max;       // ceil(n / kTile): the tile's largest |p|^2, or -1 with no valid point
  int n;
  int first;  // its first block in the pack grid
};

struct PackGroup {
  int count;
  Cloud cloud[kMaxClouds];
};

struct Search {
  const float4* q;
  const float4* s;
  const float* tile_max;  // the supports' per tile
  int* out;
  int m, n, limit, slices;
  float r2;
  int first;  // its first cluster in the search grid
};

struct SearchGroup {
  int count;
  Search search[kMaxSearches];
};

static_assert(sizeof(PackGroup) <= 4096, "the pack descriptors exceed the 4 KB kernel parameter limit");
static_assert(sizeof(SearchGroup) <= 4096, "the search descriptors exceed the 4 KB kernel parameter limit");

// |p|^2 in the order nvcc gave the single-search kernel that this one
// replaced (its x * x + y * y + z * z compiled to FMUL y, FFMA x, FFMA z on
// sm_90a), written out so that no context contracts it otherwise: another
// order rounds otherwise and moves rows at ties.
__device__ __forceinline__ float norm2(float x, float y, float z) { return fmaf(z, z, fmaf(x, x, __fmul_rn(y, y))); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster; shared-memory writes before it
// are visible to the whole cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;" ::: "memory");
}

// The address of this CTA's shared `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ unsigned long long ld_cluster_u64(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ int ld_cluster_s32(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

// Thread 0: copy kTile packed supports into `dst`, completing on `bar`.
__device__ __forceinline__ void load_tile(float4* dst, const float4* src, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the warps' reads of dst come first
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(kTileBytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(smem_u32(dst)), "l"(src), "r"(kTileBytes), "r"(b)
               : "memory");
}

__device__ __forceinline__ void wait_tile(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}

// The first of tiles t, t + step, ... below end that holds a valid point
// (end or beyond if none).
__device__ __forceinline__ int next_tile(const float* __restrict__ tile_max, int t, int end, int step) {
  while (t < end && tile_max[t] < 0.f) t += step;
  return t;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

__global__ void __launch_bounds__(kTile) radius_pack_kernel(const __grid_constant__ PackGroup g) {
  __shared__ float warp_max[kTile / 32];
  int c = 0;
  while (c + 1 < g.count && g.cloud[c + 1].first <= (int)blockIdx.x) ++c;
  const Cloud& cl = g.cloud[c];
  const int tile = blockIdx.x - cl.first;
  const int j = tile * kTile + threadIdx.x;
  float4 p = make_float4(0.f, 0.f, 0.f, INFINITY);
  float w = -1.f;
  if (j < cl.n && cl.masks[j] != 0) {
    p.x = cl.points[3 * (size_t)j];
    p.y = cl.points[3 * (size_t)j + 1];
    p.z = cl.points[3 * (size_t)j + 2];
    p.w = norm2(p.x, p.y, p.z);
    w = p.w;
  }
  cl.packed[j] = p;
  for (int o = 16; o > 0; o >>= 1) w = fmaxf(w, __shfl_xor_sync(kWarp, w, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x / 32] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kTile / 32; ++k) w = fmaxf(w, warp_max[k]);
    cl.tile_max[tile] = w;
  }
}

// A candidate as one 64-bit key: the bits of its clamped squared distance
// (a non-negative float, so its bits order as it does) over its index, so
// keys order as (d2, j).
__device__ __forceinline__ unsigned long long make_key(float e, int j) {
  return ((unsigned long long)(__float_as_uint(e) & 0x7fffffffu) << 32) | (unsigned)j;
}

__device__ __forceinline__ float key_d(unsigned long long key) { return __uint_as_float((unsigned)(key >> 32)); }

// A query's list: `cnt` keys in column 0 of `keys`, `stride` keys a slot.
// The slot of the largest key, and the threshold, once the list is full.
__device__ __forceinline__ void find_max(const unsigned long long* keys, int limit, int stride, int& at, float& thresh) {
  unsigned long long best = keys[0];
  int best_at = 0;
#pragma unroll 8
  for (int k = 1; k < limit; ++k) {
    const unsigned long long key = keys[k * stride];
    if (key > best) {
      best = key;
      best_at = k;
    }
  }
  at = best_at;
  thresh = key_d(best);
}

// The scan's filter: a support passes when fma(-2q, s, |s|^2) < bar, the
// query's threshold less |q|^2, widened by the most that rounding can move
// the two forms apart: seven roundings, each within 2^-24 of a partial sum
// no larger than 2 (|q|^2 + |s|^2) or of the threshold, stay within 1e-6 of
// |q|^2 + |s|^2 + |threshold|, and kSlack is twice that (wmax, the tile's
// largest |s|^2, stands for |s|^2). So every support that the exact form
// puts below the threshold passes, and `take` decides in the exact form. An
// invalid query's -inf passes nothing.
__device__ __forceinline__ float filter_bar(float thresh, float qq, float wmax) {
  if (thresh == -INFINITY) return -INFINITY;
  return (thresh - qq) + kSlack * (qq + wmax + fabsf(thresh));
}

// Take support j at squared distance d if its clamped distance is below
// the threshold: appended while the list has free slots, then written over
// the largest key. Supports come in increasing j, so a tie with the largest
// key loses, as it would in (d2, j) order.
__device__ __forceinline__ void take(unsigned long long* keys, int& cnt, int& at, float& thresh, float d, int j,
                                     int limit, int stride) {
  const float e = fmaxf(d, 0.f);
  if (!(e < thresh)) return;
  if (cnt < limit) {
    keys[cnt * stride] = make_key(e, j);
    if (++cnt == limit) find_max(keys, limit, stride, at, thresh);
    return;
  }
  keys[at * stride] = make_key(e, j);
  find_max(keys, limit, stride, at, thresh);
}

// Sort the first `cnt` keys ascending, in place.
__device__ __forceinline__ void sort_keys(unsigned long long* keys, int cnt, int stride) {
  for (int a = 1; a < cnt; ++a) {
    const unsigned long long key = keys[a * stride];
    int k = a;
    for (; k > 0; --k) {
      const unsigned long long prev = keys[(k - 1) * stride];
      if (prev < key) break;
      keys[k * stride] = prev;
    }
    keys[k * stride] = key;
  }
}

// Dynamic shared memory: two tiles, then the lists' keys, [slot][query],
// for the group's longest limit.
__global__ void __launch_bounds__(kThreads, kMinBlocks) radius_search_group_kernel(const __grid_constant__ SearchGroup g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ int counts[kThreads];
  float4* tiles = reinterpret_cast<float4*>(smem);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + 2 * kTileBytes);

  const uint32_t csize = cluster_size(), rank = cluster_rank();
  const int cid = (int)cluster_id();
  int si = 0;
  while (si + 1 < g.count && g.search[si + 1].first <= cid) ++si;
  const Search& sd = g.search[si];
  const int m = sd.m, n = sd.n, limit = sd.limit, slices = sd.slices;

  // this CTA: query block qb, slice `slice` of its supports
  const int group = (int)rank / slices, slice = (int)rank % slices;
  const int q0 = ((cid - sd.first) * ((int)csize / slices) + group) * kThreads;
  const int t = threadIdx.x;
  float4 qp = make_float4(0.f, 0.f, 0.f, INFINITY);
  if (q0 + t < m) qp = sd.q[q0 + t];
  const bool valid = qp.w != INFINITY;
  const float ax = valid ? -2.f * qp.x : 0.f, ay = valid ? -2.f * qp.y : 0.f, az = valid ? -2.f * qp.z : 0.f;
  const float qq = valid ? qp.w : 0.f;
  float thresh = valid ? sd.r2 : -INFINITY;
  int cnt = 0, at = 0;
  unsigned long long* mine = keys + t;

  if (t == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // this slice's tiles: every slices-th tile from tile `slice`, so the
  // slices share the valid points however the cloud is padded
  if (__syncthreads_or(valid) && slice * kTile < n) {  // the barrier also publishes the mbarriers
    const int end = (n + kTile - 1) / kTile;
    int cur = next_tile(sd.tile_max, slice, end, slices);
    if (t == 0 && cur < end) load_tile(tiles, sd.s + (size_t)cur * kTile, &bars[0]);
    for (int k = 0; cur < end; ++k) {
      const int nxt = next_tile(sd.tile_max, cur + slices, end, slices);
      // the other buffer was released by the barrier that ended the last tile
      if (t == 0 && nxt < end) load_tile(tiles + ((k + 1) & 1) * kTile, sd.s + (size_t)nxt * kTile, &bars[(k + 1) & 1]);
      const float wmax = sd.tile_max[cur];
      wait_tile(&bars[k & 1], (k >> 1) & 1);
      const float4* tile = tiles + (k & 1) * kTile;
      const int base = cur * kTile;
      const int span = min(kTile, n - base);
      for (int c = 0; c < span; c += kChunk) {
        const float bar = filter_bar(thresh, qq, wmax);
        unsigned mask = 0u;
#pragma unroll
        for (int b = 0; b < kChunk; ++b) {
          const float4 p = tile[c + b];
          const float f = fmaf(az, p.z, fmaf(ay, p.y, fmaf(ax, p.x, p.w)));
          mask |= (f < bar ? 1u : 0u) << b;
        }
        while (__any_sync(kWarp, mask != 0u)) {
          if (mask != 0u) {
            const int b = __ffs(mask) - 1;
            mask &= mask - 1u;
            const float4 p = tile[c + b];
            const float d = fmaf(az, p.z, fmaf(ay, p.y, fmaf(ax, p.x, qq))) + p.w;
            take(mine, cnt, at, thresh, d, base + c + b, limit, kThreads);
          }
        }
      }
      __syncthreads();  // every warp is done with this buffer before it is refilled
      cur = nxt;
    }
  }
  sort_keys(mine, cnt, kThreads);
  counts[t] = cnt;
  cluster_sync();

  // the rows: this CTA writes rows [slice * share, (slice + 1) * share) of
  // its query block, merging the query's `slices` sorted lists (read through
  // the cluster's shared memory) by key
  const int share = kThreads / slices;
  constexpr uint32_t kStep = kThreads * sizeof(unsigned long long);
  const int qi = slice * share + t;
  if (t < share && q0 + qi < m) {
    int* row = sd.out + (size_t)(q0 + qi) * limit;
    uint32_t pos[kMaxCluster], stop[kMaxCluster];
    unsigned long long head[kMaxCluster];
    const uint32_t key_at = smem_u32(keys + qi), count_at = smem_u32(counts + qi);
#pragma unroll
    for (int a = 0; a < kMaxCluster; ++a) {
      pos[a] = stop[a] = 0u;
      head[a] = ~0ull;
      if (a < slices) {
        const uint32_t rk = (uint32_t)(group * slices + a);
        pos[a] = map_rank(key_at, rk);
        stop[a] = pos[a] + (uint32_t)ld_cluster_s32(map_rank(count_at, rk)) * kStep;
        if (pos[a] < stop[a]) head[a] = ld_cluster_u64(pos[a]);
      }
    }
    int k = 0;
    for (; k < limit; ++k) {
      int best = 0;
      unsigned long long key = head[0];
#pragma unroll
      for (int a = 1; a < kMaxCluster; ++a) {
        if (head[a] < key) {
          best = a;
          key = head[a];
        }
      }
      if (key == ~0ull) break;
#pragma unroll
      for (int a = 0; a < kMaxCluster; ++a) {
        if (a == best) {
          pos[a] += kStep;
          head[a] = pos[a] < stop[a] ? ld_cluster_u64(pos[a]) : ~0ull;
        }
      }
      row[k] = (int)(unsigned)key;
    }
    for (; k < limit; ++k) row[k] = n;
  }
  cluster_sync();  // no CTA leaves while another reads its lists
}

size_t search_smem(int limit) { return 2 * (size_t)kTileBytes + (size_t)limit * kThreads * sizeof(unsigned long long); }

// Resident search blocks an SM at `limit` on `device`, after allowing the
// longest lists' shared memory; looked up once per device and limit.
constexpr int kCachedDevices = 16;
int occupancy_cache[kCachedDevices][kMaxLimit + 1];

cudaError_t occupancy(int device, int limit, int* blocks) {
  if (device >= 0 && device < kCachedDevices && occupancy_cache[device][limit] > 0) {
    *blocks = occupancy_cache[device][limit];
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(radius_search_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)search_smem(kMaxLimit));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, radius_search_group_kernel, kThreads, search_smem(limit));
  }
  if (err == cudaSuccess && device >= 0 && device < kCachedDevices) occupancy_cache[device][limit] = *blocks;
  return err;
}

}  // namespace

// The C view of a group, as the wrapper (models/cuda_kernels.py) lays it out.
struct GtCloud {
  const float* points;         // (n, 3) f32
  const unsigned char* masks;  // (n,) bool
  int n;
  int tile_offset;  // its first tile in the packed buffer and in tile_max
};

struct GtSearch {
  int* out;  // (m, limit) int32
  int query_cloud, support_cloud;
  int limit;
  float r2;
};

constexpr int kInfo = 13;

// Facts of the build at `limit` (kInfo ints): kTile, kThreads, kMaxCluster,
// kMaxSearches, kMaxClouds, kMaxLimit; the search kernel's registers, local
// (stack and spill) bytes, static shared bytes, dynamic shared bytes at
// `limit` and resident blocks an SM at `limit`; the pack kernel's registers
// and local bytes. Returns a cudaError_t.
extern "C" int gt_radius_search_info(int limit, int* out) {
  if (limit < 1 || limit > kMaxLimit) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a, p;
  int device = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = occupancy(device, limit, &blocks);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, radius_search_group_kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&p, radius_pack_kernel);
  if (err != cudaSuccess) return (int)err;
  const int v[kInfo] = {kTile, kThreads, kMaxCluster, kMaxSearches, kMaxClouds, kMaxLimit, a.numRegs,
                        (int)a.localSizeBytes, (int)a.sharedSizeBytes, (int)search_smem(limit), blocks, p.numRegs,
                        (int)p.localSizeBytes};
  std::copy(v, v + kInfo, out);
  return 0;
}

// One group of radius searches over `n_clouds` distinct clouds: packs each
// cloud into `packed` (sum of its tiles x kTile float4) and `tile_max` (one
// float a tile) at its tile_offset, then runs every search in one launch.
// A search's limit is 1..kMaxLimit and at most the support cloud's n; each
// cuts its supports into as many slices as the group's work asks for. All
// pointers but `slices_out` are on the device, contiguous; `slices_out`
// (host, n_searches ints, may be null) receives each search's slice count.
// Returns the first cudaError_t (cudaErrorInvalidValue for arguments out of
// range).
extern "C" int gt_radius_search_group(const GtCloud* clouds, int n_clouds, const GtSearch* searches,
                                      int n_searches, void* packed, float* tile_max, int* slices_out, void* stream) {
  if (n_clouds < 1 || n_clouds > kMaxClouds || n_searches < 1 || n_searches > kMaxSearches) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* base = static_cast<float4*>(packed);

  PackGroup pack;
  pack.count = n_clouds;
  int blocks = 0;
  for (int c = 0; c < n_clouds; ++c) {
    const GtCloud& cl = clouds[c];
    if (cl.n < 1) return (int)cudaErrorInvalidValue;
    pack.cloud[c] = {cl.points, cl.masks, base + (size_t)cl.tile_offset * kTile, tile_max + cl.tile_offset, cl.n,
                     blocks};
    blocks += ceil_div(cl.n, kTile);
  }

  int limit_max = 1;
  for (int s = 0; s < n_searches; ++s) {
    const GtSearch& sr = searches[s];
    if (sr.query_cloud < 0 || sr.query_cloud >= n_clouds || sr.support_cloud < 0 || sr.support_cloud >= n_clouds ||
        sr.limit < 1 || sr.limit > kMaxLimit || sr.limit > clouds[sr.support_cloud].n) {
      return (int)cudaErrorInvalidValue;
    }
    limit_max = std::max(limit_max, sr.limit);
  }

  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = occupancy(device, limit_max, &per_sm);
  if (err != cudaSuccess) return (int)err;

  // Slices: `per_block` is the group's work in support visits per query
  // block over the card's resident blocks. A search takes the fewest slices
  // (a power of two, at most one a tile) that cut a block's supports to
  // twice that: measured on an H100, a pair's pyramids then run unsliced
  // (its blocks already fill the card) and a level-0 search alone in 2
  // slices, faster than in more, whose merges and cluster waits cost more
  // than the parallelism gains. The masks are on the device, so this counts
  // the capacities; blocks with no valid query end at once.
  double work = 0.0;
  for (int s = 0; s < n_searches; ++s) {
    work += (double)ceil_div(clouds[searches[s].query_cloud].n, kThreads) * clouds[searches[s].support_cloud].n;
  }
  const double target = 2.0 * work / std::max(1, sms * std::max(per_sm, 1));
  int order[kMaxSearches], slices[kMaxSearches];
  int cluster = 1;
  for (int s = 0; s < n_searches; ++s) {
    const int n = clouds[searches[s].support_cloud].n;
    int sl = 1;
    while (2 * sl <= kMaxCluster && 2 * sl <= ceil_div(n, kTile) && (double)n / sl > target) sl *= 2;
    slices[s] = sl;
    cluster = std::max(cluster, sl);
    order[s] = s;
    if (slices_out != nullptr) slices_out[s] = sl;
  }
  // the costliest first: the block scheduler hands out clusters in order
  std::stable_sort(order, order + n_searches, [&](int a, int b) {
    const double wa = (double)clouds[searches[a].query_cloud].n * clouds[searches[a].support_cloud].n;
    const double wb = (double)clouds[searches[b].query_cloud].n * clouds[searches[b].support_cloud].n;
    return wa > wb;
  });

  SearchGroup group;
  group.count = n_searches;
  int clusters = 0;
  for (int k = 0; k < n_searches; ++k) {
    const int s = order[k];
    const GtSearch& sr = searches[s];
    const int m = clouds[sr.query_cloud].n, n = clouds[sr.support_cloud].n;
    const float4* q = base + (size_t)clouds[sr.query_cloud].tile_offset * kTile;
    const float4* sp = base + (size_t)clouds[sr.support_cloud].tile_offset * kTile;
    group.search[k] = {q, sp, tile_max + clouds[sr.support_cloud].tile_offset, sr.out, m, n, sr.limit, slices[s],
                       sr.r2, clusters};
    clusters += ceil_div(ceil_div(m, kThreads), cluster / slices[s]);
  }

  radius_pack_kernel<<<blocks, kTile, 0, st>>>(pack);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = search_smem(limit_max);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, radius_search_group_kernel, group);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
