// Bidirectional flash self-attention for the encoder stacks, written by hand
// for Hopper (sm_90a): TMA loads, wgmma products, a warp-specialized CTA.
//
// Replaces the flash branch of whisperx_tpu/ops/attention.py:
// fused_self_attention, which wraps the stock Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention. For each batch element b
// and head h, every query row t attends over the valid keys s:
//   s_ts   = q[b, t, h, :] . k[b, s, h, :]          fp32 (q and k carry Dh^-0.25 each)
//   m_t    = max over valid s of s_ts,  p_ts = exp(s_ts - m_t)     fp32
//   out[b, t, h, :] = sum_s bf16(p_ts) * v[b, s, h, :] / sum_s p_ts, rounded to bf16
// Keys with pad_mask[b, s] == 0, and keys at s >= T, are excluded, which is
// what the reference's additive -1e9 does. Padded query rows attend the valid
// keys like any other row; a row without a valid key gets zeros. Under
// training (the stock kernel's forward with residuals) it also writes each
// row's log-sum-exp lse[b, h, t] = m_t + ln(sum_s p_ts) (-inf for a row
// without a valid key), which the backward kernels of flash_attn_bwd.cu
// read; the inference path passes no lse pointer. Tensors are
// (B, T, H, 64) bf16 with the head and the head dim contiguous; the batch and
// time strides are arguments, so the q/k/v slices of a fused QKV projection
// need no copy.
//
// What bounds it on the card: operations. At the Whisper large-v2 encoder
// shape (B 8, T 1500, H 20) the two products are 92.2 GFLOP per call, about
// 0.093 ms at the 989 TFLOP/s bf16 tensor-core peak, against 123 MB of
// q/k/v/out (0.037 ms at 3.35 TB/s). At Dh 64 the softmax is a second limit
// of the same size: each logit costs 256 tensor-core FLOP and one exp2, and
// an SM retires 16 exp2 a cycle against ~4,096 bf16 FLOP, so the exponentials
// alone take as long as the products unless the two overlap.
//
// Design (the TPU kernel's 512-row blocks and segment ids do not carry over):
//  - Work item = (tile of 128 query rows, head, batch element): 1,920 items
//    at the large-v2 shape. The kernel is persistent: one CTA per SM walks
//    the items (w += gridDim.x), so the next item's Q and first K/V tiles
//    load while the current one finishes, and no CTA starts cold.
//  - A CTA is three warpgroups. Warpgroups 0 and 1 are consumers, each
//    owning 64 query rows; one warp of warpgroup 2 is the producer.
//    setmaxnreg gives the consumers 232 registers a thread and leaves the
//    producer 40.
//  - The producer issues TMA loads through 4-D tensor maps over the strided
//    (B, T, H, 64) views (dims 64, H, T, B; boxes of 64 dims x 128 rows,
//    128-byte swizzle): Q into one of two buffers, K and V tiles of 128 keys
//    through a ring of STAGES buffers, each guarded by full/empty mbarriers.
//    Rows at or beyond T come back as zeros (TMA's out-of-bounds fill). The
//    producer also writes each tile's key bias (0 or -inf, from the mask and
//    T) and a flag for whether any key is excluded (if none is, no bias is
//    added). A tile without a valid key runs like the others: its logits are
//    all -inf and its p all 0. (Skipping it would put the products under a
//    data-dependent branch, which makes ptxas serialize every wgmma.)
//  - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major); O += P V is wgmma m64n64k16 with P from registers (the S
//    accumulators rounded to bf16 and packed, which is the A-fragment
//    layout) and V in shared memory read MN-major (the transpose flag).
//    Accumulators are fp32. The online softmax keeps its running max and
//    sum in fp32 registers (exp2 with log2(e) folded in, on the special-
//    function unit); P is rounded to bf16 for the second product (the
//    reference rounds the normalised weights instead) and O is divided by
//    the sum at the end.
//  - Overlap, against the two limits above: a consumer issues S of tile j
//    and P V of tile j - 1 together, then runs the softmax of tile j while
//    P V runs; and the two consumers take turns issuing (named barriers), so
//    one's softmax runs beside the other's products.
//  - The tensor maps are encoded on the host for every call (the driver's
//    cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
//    library needs no -lcuda) and passed as __grid_constant__ parameters,
//    which CUDA-graph capture records by value.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.223 ms at the
// large-v2 shape, 414 TFLOP/s (42% of the peak; the exponentials and the
// issue turns keep the tensor cores from running back to back).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr int BM = 128;                        // query rows per CTA: two consumer warpgroups of 64
constexpr int BN = 128;                        // keys per tile
constexpr int STAGES = 4;                      // K/V ring depth
constexpr int CONSUMER_THREADS = 256;
constexpr int THREADS = CONSUMER_THREADS + 128;  // + the producer warpgroup
constexpr int TILE_BYTES = BN * DH * 2;        // one 128-row box: 16 KB
constexpr float LOG2E = 1.4426950408889634f;

// Tiles sit at 1,024-byte boundaries, as the 128-byte swizzle requires.
struct __align__(1024) Smem {
  __nv_bfloat16 q[2][BM * DH];  // double-buffered: the next item's Q loads during this one
  __nv_bfloat16 k[STAGES][BN * DH];
  __nv_bfloat16 v[STAGES][BN * DH];
  float bias[STAGES][BN];  // 0 for a valid key, -inf for an excluded one
  int some_masked[STAGES];  // 0: every key of the tile is valid, no bias to add
  uint64_t full[STAGES];   // the producer's tile is in
  uint64_t empty[STAGES];  // both consumer warpgroups are done with it
  uint64_t q_full[2];
  uint64_t q_empty[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
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

// Named barriers 1 and 2 pass the tensor cores between the two consumer
// warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(CONSUMER_THREADS) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(CONSUMER_THREADS) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int t0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(h), "r"(t0), "r"(b)
      : "memory");
}

// wgmma descriptor of a tile of 128-byte rows under the 128-byte swizzle:
// start address, leading and stride byte offsets (both the 1,024 bytes of an
// 8-row swizzle atom: the stride between 8-row groups; the leading offset is
// unused for these K-major operands and for a 64-wide MN-major one), layout 1.
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

// D (64 x 64, fp32) = (or +=) A (64 x 16, bf16 in registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_m64n64_rs(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit, one instruction (results below 2^-126,
// worthless beside a row sum of at least 1, flush to zero).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key tile of the online softmax for this thread's two rows: adds the
// key bias (when some key is excluded), updates the running max and sum,
// turns S into p = exp(s - m) in place and returns the rescale factor of
// the earlier tiles' O in alpha. Maxima and sums are taken as trees of four
// so that no dependent chain runs over the 32 values of a row.
__device__ __forceinline__ void softmax_tile(float (&s)[64], const float* bias, int c2, float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2]) {
  if (bias != nullptr) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + n * 8 + c2);
      s[4 * n] += bb.x;
      s[4 * n + 1] += bb.y;
      s[4 * n + 2] += bb.x;
      s[4 * n + 3] += bb.y;
    }
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[r][i] = fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
#pragma unroll
    for (int n = 4; n < BN / 8; ++n) mx[r][n & 3] = fmaxf(mx[r][n & 3], fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
  }
  float mscaled[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_run[r], mt);
    const float mu = m_new == -INFINITY ? 0.0f : m_new;  // every key so far masked: keep exp() finite
    alpha[r] = exp2_ftz((m_run[r] - mu) * LOG2E);
    mscaled[r] = mu * LOG2E;
    m_run[r] = m_new;
  }
  float sum[2][4];
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float p0 = exp2_ftz(fmaf(s[4 * n + 2 * r], LOG2E, -mscaled[r]));
      const float p1 = exp2_ftz(fmaf(s[4 * n + 2 * r + 1], LOG2E, -mscaled[r]));
      s[4 * n + 2 * r] = p0;
      s[4 * n + 2 * r + 1] = p1;
      sum[r][n & 3] = n < 4 ? p0 + p1 : sum[r][n & 3] + (p0 + p1);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// P, rounded to bf16, as the A fragments of the P V product: the S
// accumulators of keys 16 kc .. 16 kc + 15 form key chunk kc.
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&p)[32]) {
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc) {
    p[4 * kc] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
    p[4 * kc + 1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    p[4 * kc + 2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    p[4 * kc + 3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

__device__ __forceinline__ void issue_s(float (&s)[64], uint64_t dq, const __nv_bfloat16* k_tile) {
  const uint64_t dk = sw128_desc(k_tile);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wgmma_m64n128_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
  wgmma_commit();
}

__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[32], const __nv_bfloat16* v_tile) {
  const uint64_t dv = sw128_desc(v_tile);
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc) wgmma_m64n64_rs(o, p + 4 * kc, dv + kc * (16 * DH * 2 >> 4), 1);
  wgmma_commit();
}

// Work item w of the grid-stride loop: query tile w % n_m of head
// (w / n_m) % H of batch element w / (n_m H).
struct Item {
  int m0, h, b;
};
__device__ __forceinline__ Item item_of(int w, int n_m, int H) {
  const int mt = w % n_m, bh = w / n_m;
  return {mt * BM, bh % H, bh / H};
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attn_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int B, int T, int H, long long o_sb,
                  long long o_st) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int n_m = (T + BM - 1) / BM;
  const int n_items = n_m * H * B;
  const int n_tiles = (T + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_THREADS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.q_full[s], 1);
      mbar_init(&sm.q_empty[s], CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- producer warpgroup: one warp loads, three idle ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 != CONSUMER_THREADS / 32) return;
    const int lane = threadIdx.x & 31;
    int g = 0;  // K/V tiles loaded so far: ring slot g % STAGES, pass g / STAGES
    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      const Item x = item_of(w, n_m, H);
      if (lane == 0) {
        const int qb = it & 1;
        mbar_wait(&sm.q_empty[qb], ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.q_full[qb], BM * DH * 2);
        tma_load(sm.q[qb], &tq, &sm.q_full[qb], x.m0, x.h, x.b);
      }
      const uint8_t* mb = mask ? mask + (long long)x.b * T : nullptr;
      for (int j = 0; j < n_tiles; ++j, ++g) {
        const int stage = g % STAGES;
        mbar_wait(&sm.empty[stage], ((g / STAGES) & 1) ^ 1);
        bool all = true;
        float bias[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = j * BN + lane * 4 + i;
          const bool valid = s < T && (mb == nullptr || mb[s] != 0);
          bias[i] = valid ? 0.0f : -INFINITY;
          all = all && valid;
        }
        *reinterpret_cast<float4*>(&sm.bias[stage][lane * 4]) = make_float4(bias[0], bias[1], bias[2], bias[3]);
        all = __all_sync(0xffffffffu, all);
        __syncwarp();
        if (lane == 0) {
          sm.some_masked[stage] = !all;
          // The arrive's release semantics publish the bias and the flag.
          mbar_arrive_expect_tx(&sm.full[stage], 2 * TILE_BYTES);
          tma_load(sm.k[stage], &tk, &sm.full[stage], j * BN, x.h, x.b);
          tma_load(sm.v[stage], &tv, &sm.full[stage], j * BN, x.h, x.b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;  // first column of this thread's accumulator pairs
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);  // this thread's rows of the tile: r0 and r0 + 8
  auto bias_of = [&](int st) { return sm.some_masked[st] ? sm.bias[st] : nullptr; };

  // Accumulators: S is 64 rows x 128 keys, O 64 rows x 64 dims; a thread
  // holds rows r0 and r0 + 8, columns 8 n + c2 and 8 n + c2 + 1.
  float s[64], o[32];
  uint32_t p[32];
  float m_run[2], l_run[2], alpha[2];

  // Each turn issues this warpgroup's products back to back: S of tile j
  // and P V of tile j - 1. The softmax of tile j then runs while P V of
  // tile j - 1 (and the other warpgroup's products) occupy the tensor cores.
  if (wg == 1) turn_pass(wg);  // warpgroup 0 takes the first turn
  int g = 0;  // K/V tiles consumed so far, as the producer counts them
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const Item x = item_of(w, n_m, H);
    const int qb = it & 1;
    const uint64_t dq = sw128_desc(sm.q[qb] + wg * 64 * DH);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.0f;

    mbar_wait(&sm.q_full[qb], (it >> 1) & 1);
    int stage = g % STAGES;
    mbar_wait(&sm.full[stage], (g / STAGES) & 1);
    turn_wait(wg);
    fence_regs(s);
    wgmma_fence();
    issue_s(s, dq, sm.k[stage]);
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, bias_of(stage), c2, m_run, l_run, alpha);
    pack_p(s, p);

    for (int j = 1; j < n_tiles; ++j) {
      const int prev = stage;  // the stage whose V the pending P V reads
      ++g;
      stage = g % STAGES;
      mbar_wait(&sm.full[stage], (g / STAGES) & 1);
      turn_wait(wg);
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
      issue_s(s, dq, sm.k[stage]);
      issue_pv(o, p, sm.v[prev]);
      turn_pass(wg);
      wgmma_wait<1>();  // S is in; P V may still run
      fence_regs(s);
      softmax_tile(s, bias_of(stage), c2, m_run, l_run, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&sm.empty[prev]);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
      pack_p(s, p);
    }
    mbar_arrive(&sm.q_empty[qb]);  // every S of this item is done
    turn_wait(wg);
    fence_regs(o);
    wgmma_fence();
    issue_pv(o, p, sm.v[stage]);
    // The turns alternate: warpgroup 1 leaves no pass unclaimed at the end.
    if (wg == 0 || w + (int)gridDim.x < n_items) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&sm.empty[stage]);
    ++g;

    // Normalise and store rows r0 and r0 + 8 (and, when asked for, their
    // log-sum-exp m + ln(l) for the backward kernels; -inf for a row
    // without a valid key).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = x.m0 + r0 + r * 8;
      if (t >= T) continue;
      const float inv = l_run[r] > 0.0f ? 1.0f / l_run[r] : 0.0f;
      if (lse != nullptr && (lane & 3) == 0)
        lse[((long long)x.b * H + x.h) * T + t] = l_run[r] > 0.0f ? m_run[r] + logf(l_run[r]) : -INFINITY;
      __nv_bfloat16* orow = out + x.b * o_sb + t * o_st + x.h * DH;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + c2) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
    }
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, T, H, 64) bf16 view with strides (sb, st, 64, 1) elements, as 4-D
// (64, H, T, B) with boxes of 64 x 1 x 128 x 1 under the 128-byte swizzle.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int B, int T, int H, long long sb, long long st) {
  const cuuint64_t dims[4] = {DH, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  // A size-1 dimension's stride is never stepped; give it a legal value.
  const long long st_b = T > 1 ? st : (long long)H * DH;
  const long long sb_b = B > 1 ? sb : (long long)T * st_b;
  const cuuint64_t strides[3] = {DH * 2, (cuuint64_t)st_b * 2, (cuuint64_t)sb_b * 2};
  const cuuint32_t box[4] = {DH, 1, BN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The caller (whisperx_tpu_torch/ops/flash_attn.py) checks shapes, types,
// the unit head and head-dim strides and 16-byte alignment. Strides are in
// elements; `mask` is a (B, T) bool array (1 = valid key) or null; `lse` is
// a contiguous (B, H, T) fp32 output for the training path, or null (the
// inference path: nothing more is written). Returns a
// cudaError_t: cudaErrorNotSupported if the driver has no
// cuTensorMapEncodeTiled, cudaErrorInvalidValue if it refuses a view.
extern "C" int flash_attn(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                          int B, int T, int H, long long q_sb, long long q_st, long long k_sb, long long k_st,
                          long long v_sb, long long v_st, long long o_sb, long long o_st, void* stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, B, T, H, q_sb, q_st) || !encode(fn, &tk, k, B, T, H, k_sb, k_st) ||
      !encode(fn, &tv, v, B, T, H, v_sb, v_st))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Smem) + 1024;  // + room to align the base to 1,024 bytes
  cudaError_t e = cudaFuncSetAttribute(flash_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // Persistent: one CTA per SM walks the work items.
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long items = (long long)((T + BM - 1) / BM) * H * B;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_attn_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), B, T, H,
      o_sb, o_st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
