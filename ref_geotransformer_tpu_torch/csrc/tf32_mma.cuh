// Pieces shared by the structure-embedding kernels (forward and backward):
// 16-byte `cp.async` copies and f32-accurate products on the tensor cores
// as three TF32 `mma.sync` passes on split operands.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

constexpr uint32_t kTf32Mask = 0xffffe000u;  // sign, exponent and the 10 mantissa bits of TF32

// x = big + small to ~2^-20 relative, each term a TF32 value, truncated by
// masks (x - big is exact in f32); faster than cvt.rna.tf32.f32 in a trial
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & kTf32Mask;
  small = __float_as_uint(x - __uint_as_float(big)) & kTf32Mask;
}

// d += a * b for one 16 x 8 x 8 tile (A row-major, B column-major)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
