// Building blocks shared by the decode kernels (int8_mm.cu, cross_attn.cu)
// and the flash backward kernels (flash_attn_bwd.cu, which uses the mma):
// mbarriers, TMA loads, cluster barriers and stores into another CTA's
// shared memory, the driver's tensor-map encoder, exact int8 -> bf16
// conversion, the bf16 mma.sync m16n8k16, and phase stamps for traced builds.
// Header-only; ops/_build.py hashes every csrc/*.cuh into each library's
// digest, so an edited header rebuilds its users.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait for the phase of parity `parity` to complete. A wait that never ends
// (a broken pipeline) traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}

// TMA: one box of a 2-D / 3-D tensor map into shared memory, completion
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The signed bytes in bytes 0 and 2 of `w` (bytes 1 and 3 are ignored) as
// a packed bf16 pair, exactly, in three instructions and no int-to-float
// conversion (a quarter-rate instruction): a byte b = -128 s + t (sign s,
// low bits t) becomes the bf16 bits 0x4300 | t = 128 + t, and one bf16x2
// subtraction of 128 + 128 s (bits 0x4300 | 0x80 s) leaves b, an integer of
// at most 8 significant bits, so nothing rounds.
__device__ __forceinline__ uint32_t bf16x2_of_i8_pair(uint32_t w) {
  const uint32_t mag = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                                   *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Four signed bytes of `v` as two packed bf16 pairs: lo = (b0, b1), hi = (b2, b3).
__device__ __forceinline__ void bf16x4_of_i8x4(uint32_t v, uint32_t& lo, uint32_t& hi) {
  lo = bf16x2_of_i8_pair(__byte_perm(v, 0, 0x0100));
  hi = bf16x2_of_i8_pair(__byte_perm(v, 0, 0x0302));
}

// D (16 x 8, fp32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col).
// Lane (g = lane / 4, c = lane % 4) holds a[0] = A[g][2c..2c+1],
// a[1] = A[g+8][2c..], a[2] = A[g][2c+8..], a[3] = A[g+8][2c+8..];
// b[0] = B[2c..2c+1][g], b[1] = B[2c+8..2c+9][g]; d[0..1] = D[g][2c..2c+1],
// d[2..3] = D[g+8][2c..2c+1].
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Phase stamps for a traced build (nvcc -DKERNEL_TRACE): thread 0 of each
// CTA writes %globaltimer (ns) into slot i of its row of 8 in the buffer set
// by the exported set_trace(). Without the macro a stamp is nothing.
#ifdef KERNEL_TRACE
__device__ unsigned long long* trace_buf;
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0 && trace_buf != nullptr) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    trace_buf[cta * 8 + i] = t;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

// Split cluster barrier: every thread of the cluster arrives (relaxed: no
// ordering), and later waits for all arrivals. Arriving at the kernel's start
// and waiting before the first access to another CTA's shared memory makes
// sure that CTA has started, at no cost once the work in between is longer.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// The shared::cluster address of the same shared variable in CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
// Store 16 bytes into another CTA's shared memory (both addresses from
// cluster_addr); completion is counted in bytes on that CTA's mbarrier.
__device__ __forceinline__ void st_async_v4(uint32_t dst, const float4& v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   dst),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime so that
// the library needs no -lcuda; null if the driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

}  // namespace hopper

#ifdef KERNEL_TRACE
extern "C" int set_trace(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(hopper::trace_buf, &buf, sizeof(buf)));
}
#endif
