// Log-domain Sinkhorn normalization, one thread block per patch, every row
// (then every column) of the patch reduced at the same time.
//
// Replaces the TPU kernel `sinkhorn_log_norm_pallas` (`_sinkhorn_kernel`) in
// ref_geotransformer_tpu/models/pallas_kernels.py. For each of B patches it
// runs `iters` alternating updates of the duals
//     u_i = log_mu_i - logsumexp_j(s_ij + v_j)
//     v_j = log_nu_j - logsumexp_i(s_ij + u_i)
// from u = v = 0, and writes s_ij + u_i + v_j.
//
// What bounds it on an H100: the exponentials, and the latency between
// them. On the main path (B = 256 patches of 65 x 65, 100 iterations) a call
// takes 2 * 256 * 65^2 * 100 = 216 M exps: 0.052 ms at the SFU's 16 a clock
// per SM on 132 SMs, against 0.016 ms for its ~10 f32 operations an entry
// at 67 TFLOP/s and 0.003 ms for its 8.7 MB at 3.35 TB/s. Each of the 200
// half-sweeps of a patch waits on the one before, so the work of one
// half-sweep has to be spread over all the block's threads at once, and
// every instruction beside the exps competes with them for the warp
// schedulers.
//
// What the design does about it:
// - Lane groups: each row (then each column) of the patch is owned by a
//   group of T = 4 consecutive lanes of one warp, with max(M1, N1) * 4
//   threads, so all rows of a half-sweep are reduced together, with no walk
//   over rows. Four lanes, not eight: every lane of a group pays for the
//   group's log in SFU time, and four lanes lose less to padding (68
//   columns for 65, not 72); eight measured no faster.
// - Log-sum-exp of a group: each lane takes the max of its E entries
//   x = s + v (kept in registers); two xor-shuffle steps give the group's
//   max; each lane sums exp2(x - max) over its entries; two more shuffle
//   steps give the group's sum. Exactly one exp an entry: merging the
//   lanes' (max, sum) pairs online instead costs one exp a lane and step,
//   and measured ~10% slower at 65 x 65 (the SFU is the scarce unit, not
//   the shuffles' latency).
// - No branch in the loop: the patch is padded to P x P, P = 4 E, with a
//   large finite negative (kPad) whose exps vanish, and u and v with zeros.
// - The patch stays on chip for all iterations, read once from device
//   memory (staged through shared memory, coalesced) and written once: a
//   row-major slice (row r, columns lane + 4 e) for the row pass and a
//   column-major slice (column c, rows lane + 4 e) for the column pass,
//   E >= max(M1, N1) / 4 floats a thread. Three instances, the first that
//   serves the patch is taken:
//     max(M1, N1) <= 68:  E = 17 (the 3DMatch patch, 64 points and the
//                         dustbin), both copies in registers;
//     <= 132, <= 144:     E = 33 (the KITTI / ModelNet patch, 128 points
//                         and the dustbin) or 36, the row copy in registers
//                         and the column copy read from the staged patch in
//                         shared memory: two register copies would spill.
//   The other shared-memory traffic of a half-sweep is the vector u (or v),
//   read as a broadcast, and one barrier ends it: the row pass reads v and
//   writes u, the column pass reads u and writes v, so a barrier between
//   the two passes orders every read before the next write.
// - The staged patch's row stride is 8 modulo 32, so the column reads of a
//   warp (8 columns by 4 rows) hit 32 distinct banks.
// - Base-2 arithmetic: scores and marginals are multiplied by log2(e) once
//   on load and the result by ln(2) once on store; in between, each exp and
//   log is one SFU instruction, ex2 / lg2.approx.ftz (the instructions of
//   exp2f and log2f; compiled without flush-to-zero, exp2f adds a denormal
//   rescaling of three instructions an entry, which changes only results
//   below 2^-126 and so nothing of a sum that holds a 1, and log2f is a
//   polynomial). Their error stays near f32 rounding over the whole range;
//   no __expf or fast math, whose error grows with |x| and would compound
//   over the iterations.
//   Entries masked with -1e12 need no special path: -1e12 * log2(e) is
//   finite and its exp underflows to 0. Inputs must be finite.
// - B = 256 patches of 65 x 65 give 256 blocks of 288 threads, two blocks
//   an SM, one wave on 132 SMs. Times: PERF.md.
//
// Limits: M1, N1 <= 144 (kMaxDim).

#include <cuda_runtime.h>

namespace {

constexpr int kT = 4;  // lanes a group
constexpr int kMaxDim = 144;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kPad = -1e30f;  // padded entries: exp2(kPad - anything finite) = 0

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log2 of sum_e exp2(entry(e) + vec[lane + 4 e]) over the E entries of
// each of the group's four lanes; every lane of the group ends with the
// same value (xor butterflies: both partners add the same two numbers).
template <int E, class Entry>
__device__ __forceinline__ float group_lse2(Entry entry, const float* vec, int lane) {
  float x[E];
  float m = kPad;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    x[e] = entry(e) + vec[lane + kT * e];
    m = fmaxf(m, x[e]);
  }
#pragma unroll
  for (int offset = kT / 2; offset > 0; offset >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) s += ex2(x[e] - m);
#pragma unroll
  for (int offset = kT / 2; offset > 0; offset >>= 1) s += __shfl_xor_sync(0xffffffffu, s, offset);
  return m + lg2(s);
}

// E entries a lane and copy, the column copy in registers (kColShared
// false) or read from the staged patch (true); serves max(M1, N1) <= 4 E
// with round_up(4 max(M1, N1), 32) threads
template <int E, bool kColShared>
__global__ void __launch_bounds__((kT * kT * E + 31) / 32 * 32)
    sinkhorn_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                    const float* __restrict__ log_nu, float* __restrict__ out, int m1, int n1, int iters,
                    int stride) {
  constexpr int P = kT * E;  // padded rows and columns
  extern __shared__ float smem[];
  float* patch = smem;            // patch[i * stride + j]: s_ij * log2(e), kPad outside M1 x N1
  float* u = patch + P * stride;  // u_i * log2(e), 0 beyond M1
  float* v = u + P;               // v_j * log2(e), 0 beyond N1

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int grp = tid / kT, lane = tid % kT;  // row grp in the row pass, column grp in the column pass
  const int g = grp < P ? grp : P - 1;        // groups beyond P (the last warp's tail) read row / column P - 1
  const float* src = scores + (size_t)b * m1 * n1;
  for (int e = tid; e < P * P; e += blockDim.x) {
    const int i = e / P, j = e - i * P;
    patch[i * stride + j] = i < m1 && j < n1 ? src[i * n1 + j] * kLog2e : kPad;
  }
  for (int e = tid; e < 2 * P; e += blockDim.x) u[e] = 0.0f;  // u and v
  const float mu2 = grp < m1 ? log_mu[(size_t)b * m1 + grp] * kLog2e : 0.0f;
  const float nu2 = grp < n1 ? log_nu[(size_t)b * n1 + grp] * kLog2e : 0.0f;
  __syncthreads();

  float row[E];
  float col[kColShared ? 1 : E];
#pragma unroll
  for (int e = 0; e < E; ++e) row[e] = patch[g * stride + lane + kT * e];
  if constexpr (!kColShared) {
#pragma unroll
    for (int e = 0; e < E; ++e) col[e] = patch[(lane + kT * e) * stride + g];
  }
  auto row_entry = [&](int e) { return row[e]; };
  auto col_entry = [&](int e) {
    if constexpr (kColShared) {
      return patch[(lane + kT * e) * stride + g];
    } else {
      return col[e];
    }
  };

  float u2 = 0.0f;  // u of this thread's row, kept for the store
  for (int it = 0; it < iters; ++it) {
    u2 = mu2 - group_lse2<E>(row_entry, v, lane);
    if (lane == 0 && grp < m1) u[grp] = u2;
    __syncthreads();
    const float v2 = nu2 - group_lse2<E>(col_entry, u, lane);
    if (lane == 0 && grp < n1) v[grp] = v2;
    __syncthreads();
  }

  if (grp < m1) {
    float* dst = out + ((size_t)b * m1 + grp) * n1;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = lane + kT * e;
      if (j < n1) dst[j] = (row[e] + u2 + v[j]) * kLn2;
    }
  }
}

template <int E, bool kColShared>
int launch(const float* scores, const float* log_mu, const float* log_nu, float* out, int b, int m1, int n1,
           int iters, cudaStream_t stream) {
  constexpr int P = kT * E;
  const int d = m1 > n1 ? m1 : n1;
  const int threads = (d * kT + 31) / 32 * 32;
  const int stride = P + ((8 - P) % 32 + 32) % 32;  // >= P and 8 mod 32: a warp's column reads on distinct banks
  const size_t bytes = sizeof(float) * ((size_t)P * stride + 2 * P);
  const cudaError_t err =
      cudaFuncSetAttribute(sinkhorn_kernel<E, kColShared>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_kernel<E, kColShared><<<b, threads, bytes, stream>>>(scores, log_mu, log_nu, out, m1, n1, iters, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// scores (B, M1, N1), log_mu (B, M1), log_nu (B, N1), out (B, M1, N1): f32,
// contiguous, on the device. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for sizes beyond kMaxDim).
extern "C" int gt_sinkhorn(const float* scores, const float* log_mu, const float* log_nu, float* out, int b,
                           int m1, int n1, int iters, void* stream) {
  if (b <= 0 || m1 <= 0 || n1 <= 0 || m1 > kMaxDim || n1 > kMaxDim || iters < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = m1 > n1 ? m1 : n1;
  if (d <= 68) return launch<17, false>(scores, log_mu, log_nu, out, b, m1, n1, iters, s);
  if (d <= 132) return launch<33, true>(scores, log_mu, log_nu, out, b, m1, n1, iters, s);
  return launch<36, true>(scores, log_mu, log_nu, out, b, m1, n1, iters, s);
}
