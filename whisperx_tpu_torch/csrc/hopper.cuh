// Building blocks shared by the port's Hopper kernels: mbarriers, TMA loads
// (2-D, 3-D and the 4-D loads of (B, T, H, 64) views that both flash kernels
// use), cluster barriers and stores into another CTA's shared memory, the
// driver's tensor-map encoder, exact int8 -> bf16 conversion, the bf16
// mma.sync m16n8k16 (int8_mm.cu, cross_attn.cu), the wgmma descriptors and
// products of the flash kernels (flash_attn.cu, flash_attn_bwd.cu), and
// phase stamps for traced builds. Header-only; ops/_build.py hashes every
// csrc/*.cuh into each library's digest, so an edited header rebuilds its
// users.

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
// One box of a (B, T, H, 64) view's 4-D tensor map (encode_bthd): the rows
// t0.. of head h of batch element b.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int t0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(h), "r"(t0), "r"(b)
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

// ---- wgmma (flash_attn.cu, flash_attn_bwd.cu) ----

// wgmma descriptor of a tile of 128-byte rows under the 128-byte swizzle,
// starting at a 1,024-byte boundary (or 32 bytes a k16 step past one, for a
// K-major operand): start address, leading and stride byte offsets (both
// the 1,024 bytes of an 8-row swizzle atom: the stride between 8-row groups;
// the leading offset is unused for K-major operands and for a 64-wide
// MN-major one), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, fp32) = (or +=) A (64 x 16, smem) * B (16 x 128, smem), both K-major.
__device__ __forceinline__ void wgmma_m64n128_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) = (or +=) A (64 x 16, bf16 in registers) * B (16 x 64,
// smem): B K-major for TRANS_B 0, MN-major for TRANS_B 1 (the transpose flag).
// Warp w of the warpgroup holds rows 16 w .. 16 w + 15 of A as an mma.sync
// m16n8k16 A fragment: lane (g, c) a[0] = A[g][2c..2c+1], a[1] = A[g+8][2c..],
// a[2] = A[g][2c+8..], a[3] = A[g+8][2c+8..] (rows from 16 w); its D
// accumulators are d[4n..4n+1] = D[16w+g][8n+2c..], d[4n+2..4n+3] =
// D[16w+g+8][8n+2c..], for n = 0..7.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64_rs(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit, one instruction (results below 2^-126
// flush to zero; 2^-inf is 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// A (B, T, H, 64) bf16 view with strides (sb, st, 64, 1) elements as a 4-D
// tensor map (64, H, T, B) with boxes of 64 x 1 x box_rows x 1 under the
// 128-byte swizzle; rows at or beyond T load as zeros.
inline bool encode_bthd(EncodeTiled fn, CUtensorMap* map, const void* base, int B, int T, int H, long long sb,
                        long long st, int box_rows) {
  constexpr int DH = 64;
  const cuuint64_t dims[4] = {DH, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  // A size-1 dimension's stride is never stepped; give it a legal value.
  const long long st_b = T > 1 ? st : (long long)H * DH;
  const long long sb_b = B > 1 ? sb : (long long)T * st_b;
  const cuuint64_t strides[3] = {DH * 2, (cuuint64_t)st_b * 2, (cuuint64_t)sb_b * 2};
  const cuuint32_t box[4] = {DH, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper

#ifdef KERNEL_TRACE
extern "C" int set_trace(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(hopper::trace_buf, &buf, sizeof(buf)));
}
#endif
