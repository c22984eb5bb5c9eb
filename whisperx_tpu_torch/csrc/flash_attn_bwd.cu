// The backward of the encoder's flash self-attention, written by hand for
// Hopper (sm_90a): two warp-specialized kernels, TMA loads into a ring,
// every product a wgmma with fp32 accumulators.
//
// Replaces the gradient of whisperx_tpu/ops/attention.py:fused_self_attention's
// flash branch, which the stock Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention defines as a custom_vjp:
// _flash_attention_bwd_dkv (its pallas_call at flash_attention.py:1121) and
// _flash_attention_bwd_dq (:1456), fed by the forward's row statistics. Here
// the forward (csrc/flash_attn.cu) writes lse = m + ln(l) per query row, and
// for each batch element b, head h, query row t and key s:
//   S_ts  = q_t . k_s                                fp32 (q, k carry Dh^-0.25 each)
//   P_ts  = exp(S_ts - lse_t), 0 for an excluded key (pad_mask 0, or s >= T)
//           and for a row without a valid key (lse_t = -inf)
//   D_t   = sum_d dout_td * out_td                   fp32
//   dV_s  = sum_t bf16(P_ts) dout_t
//   dP_ts = dout_t . v_s
//   dS_ts = P_ts (dP_ts - D_t)
//   dK_s  = sum_t bf16(dS_ts) q_t,   dQ_t = sum_s bf16(dS_ts) k_s
// with every sum in fp32 and dq, dk, dv rounded to bf16 at the end.
// (The caller's `k * scale` takes its own gradient through autograd.)
//
// What bounds it on the card: operations. At the Whisper large-v2 training
// shape (B 2, T 1500, H 20) each T x T x 64 product is 11.5 GFLOP; the
// dK/dV kernel runs four of them (S, dP, dV, dK: 46.1 GFLOP, 0.047 ms at
// the 989 TFLOP/s bf16 peak) and the dQ kernel three (S, dP, dQ: 34.6
// GFLOP), against 31 MB of operands (about 0.01 ms at 3.35 TB/s). Both
// recompute S and dP, as the stock split does, so that no kernel needs
// atomics or a reduction across CTAs: the results are the same bits on
// every run. Each logit costs one exp2 on the special-function unit against
// 384 (dQ) or 512 (dK/dV) tensor-core FLOP, so the exponentials bind less
// than in the forward (256 FLOP a logit).
//
// Design (both kernels; the forward's, csrc/flash_attn.cu, turned around):
//  - Work item = (128 resident rows, head, batch element): query rows for
//    the dQ kernel, keys for the dK/dV kernel; 480 items at the training
//    shape. Persistent: one CTA per SM walks the items (w += gridDim.x).
//  - A CTA is three warpgroups. Warpgroups 0 and 1 are consumers, each
//    owning 64 of the resident rows; one warp of warpgroup 2 is the
//    producer. setmaxnreg gives the consumers 232 registers a thread and
//    leaves the producer 40.
//  - The producer issues TMA loads through 4-D tensor maps over the strided
//    (B, T, H, 64) views (128-byte swizzle), so the slices of a fused QKV
//    projection need no copy, and rows at or beyond T arrive as zeros
//    (TMA's out-of-bounds fill). The resident tiles (dQ: Q, dO, O; dK/dV:
//    K, V) land in one buffer guarded by res_full / res_empty mbarriers;
//    the streamed tiles of 64 rows (dQ: K and V; dK/dV: Q and dO) pass
//    through a ring of STAGES buffers, each guarded by full / empty
//    mbarriers. With each streamed tile the producer stages its row
//    values: the key bias (0, or -inf for an excluded key) for the dQ
//    kernel; lse * log2(e) (+inf for a row without a valid key or beyond
//    T) and D for the dK/dV kernel.
//  - Each consumer reads its 64 resident rows once per item into registers,
//    as wgmma A fragments (dQ: Q and dO; dK/dV: K and V), and computes with
//    the m64n64k16 wgmma, A from registers and B from the ring:
//      dQ kernel, per key tile:     S = Q K^T, dP = dO V^T (K, V K-major);
//                                   dQ += bf16(dS) K (K MN-major: the transpose flag)
//      dK/dV kernel, per query tile: S^T = K Q^T, dP^T = V dO^T (Q, dO K-major);
//                                   dV += bf16(P^T) dO, dK += bf16(dS^T) Q
//                                   (dO, Q MN-major)
//    P (or P^T) and dS come out of the accumulators in the A-fragment layout
//    of the next product (rounded to bf16 and packed), so no tile is ever
//    transposed or written back to shared memory.
//  - The dQ kernel's consumers also compute D for their rows from the dO
//    fragments and O (read once per item) and write it for the dK/dV
//    kernel, which runs next on the stream: no third launch.
//  - Overlap: a consumer issues S and dP of tile j together with the
//    accumulating products of tile j - 1, and computes P and dS of tile j
//    while those run; the two consumers' issue streams interleave freely
//    (taking turns through named barriers, as the forward does, measured
//    6-8% slower for dK/dV). Six ring stages: two were 1.9x slower, six 1%
//    faster than four.
//  - Masks by value, never by a branch on data (ptxas serializes every
//    wgmma under one, C7518): an excluded key, a row without a valid key
//    and a row or key beyond T all give P = exp2(-inf) = 0.
//  - The tensor maps are encoded on the host for every call and passed as
//    __grid_constant__ parameters, which CUDA-graph capture records by value.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, at the training
// shape: dQ 0.087 ms (~400 TFLOP/s), dK/dV 0.100 ms (~460 TFLOP/s), the pair
// within 2% of cuDNN's whole backward under SDPA. Not addressed: the wave
// tail (480 items on 132 SMs: 3.6 rounds, the last one on 84 SMs).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int DH = 64;
constexpr int BR = 128;                          // resident rows per work item: two consumer warpgroups of 64
constexpr int BS = 64;                           // rows of a streamed tile
constexpr int STAGES = 6;                        // ring depth
constexpr int CONSUMER_THREADS = 256;
constexpr int THREADS = CONSUMER_THREADS + 128;  // + the producer warpgroup
constexpr int RES_BYTES = BR * DH * 2;           // one resident tile: 16 KB
constexpr int TILE_BYTES = BS * DH * 2;          // one streamed tile: 8 KB
constexpr int KSTEP_MN = 16 * DH * 2 >> 4;       // a k16 step down an MN-major operand, in descriptor units
constexpr float LOG2E = 1.4426950408889634f;

// Tiles sit at 1,024-byte boundaries, as the 128-byte swizzle requires.
struct __align__(1024) SmemDq {
  __nv_bfloat16 q[BR * DH], dout[BR * DH], out[BR * DH];  // this item's query rows
  __nv_bfloat16 k[STAGES][BS * DH], v[STAGES][BS * DH];
  float bias[STAGES][BS];  // 0 for a valid key, -inf for an excluded one
  uint64_t full[STAGES], empty[STAGES], res_full, res_empty;
};

struct __align__(1024) SmemDkv {
  __nv_bfloat16 k[BR * DH], v[BR * DH];  // this item's keys
  __nv_bfloat16 q[STAGES][BS * DH], dout[STAGES][BS * DH];
  float lse[STAGES][BS];    // lse * log2(e); +inf for a row without a valid key or at or beyond T
  float delta[STAGES][BS];  // D; 0 at or beyond T
  uint64_t full[STAGES], empty[STAGES], res_full, res_empty;
};

// Work item w of the grid-stride loop: row tile w % n_r of head
// (w / n_r) % H of batch element w / (n_r H).
struct Item {
  int r0, h, b;
};
__device__ __forceinline__ Item item_of(int w, int n_r, int H) {
  const int rt = w % n_r, bh = w / n_r;
  return {rt * BR, bh % H, bh / H};
}

__device__ __forceinline__ bool key_valid(const uint8_t* mask_b, int s, int T) {
  return s < T && (mask_b == nullptr || mask_b[s] != 0);
}

// The 32-bit word holding elements (row, col) and (row, col + 1) of a tile
// of 128-byte rows as TMA writes it under the 128-byte swizzle: the 16-byte
// chunk col / 8 of a row sits at chunk (col / 8) ^ (row % 8).
__device__ __forceinline__ uint32_t lds_sw128(const __nv_bfloat16* tile, int row, int col) {
  const int off = row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
  return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const uint8_t*>(tile) + off);
}

// The two bf16 values of a packed pair as floats (exact).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Rows r and r + 8 (r = this thread's first row in its warp's 16) of a
// resident tile as the wgmma A fragments of its four k16 steps.
__device__ __forceinline__ void load_a(const __nv_bfloat16* tile, int r, uint32_t (&a)[16]) {
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    a[4 * kc] = lds_sw128(tile, r, 16 * kc + c2);
    a[4 * kc + 1] = lds_sw128(tile, r + 8, 16 * kc + c2);
    a[4 * kc + 2] = lds_sw128(tile, r, 16 * kc + 8 + c2);
    a[4 * kc + 3] = lds_sw128(tile, r + 8, 16 * kc + 8 + c2);
  }
}

// The 64 x 64 fp32 accumulators x, rounded to bf16, as the A fragments of
// the next product's four k16 steps (columns 16 kc .. 16 kc + 15 of x form
// step kc).
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[4 * kc] = pack_bf16(x[8 * kc], x[8 * kc + 1]);
    a[4 * kc + 1] = pack_bf16(x[8 * kc + 2], x[8 * kc + 3]);
    a[4 * kc + 2] = pack_bf16(x[8 * kc + 4], x[8 * kc + 5]);
    a[4 * kc + 3] = pack_bf16(x[8 * kc + 6], x[8 * kc + 7]);
  }
}

// x (64 x 64) = A (64 x 64, fragments a) times the transpose of a streamed
// 64-row tile (K-major B).
__device__ __forceinline__ void mma_abt(float (&x)[32], const uint32_t (&a)[16], const __nv_bfloat16* tile) {
  const uint64_t d = sw128_desc(tile);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wgmma_m64n64_rs<0>(x, a + 4 * kk, d + 2 * kk, kk > 0);
}

// acc (64 x 64) += X (64 x 64, fragments a) times a streamed 64-row tile
// (MN-major B).
__device__ __forceinline__ void mma_acc(float (&acc)[32], const uint32_t (&a)[16], const __nv_bfloat16* tile) {
  const uint64_t d = sw128_desc(tile);
#pragma unroll
  for (int kc = 0; kc < BS / 16; ++kc) wgmma_m64n64_rs<1>(acc, a + 4 * kc, d + kc * KSTEP_MN, 1);
}

// Rows r0 and r0 + 8 of a 64 x 64 fp32 accumulator as bf16 into rows
// t0 + r of a contiguous (B, T, H, 64) tensor at `base` (its (b, h) slice).
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int H, int t0, int T, const float (&acc)[32]) {
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + 8 * r;
    if (t >= T) continue;
    __nv_bfloat16* row = base + (long long)t * H * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + c2) = __floats2bfloat162_rn(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// dQ kernel, one key tile, in place in s: P = exp2(S log2(e) - lse log2(e)
// + key bias) and dS = P (dP - D) for this thread's rows (lse2 = lse log2(e),
// or +inf; d = D).
__device__ __forceinline__ void dq_grad_logits(float (&s)[32], const float (&dp)[32], const float* bias, int c2,
                                               const float (&lse2)[2], const float (&d)[2]) {
#pragma unroll
  for (int n = 0; n < BS / 8; ++n) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * n + c2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float p0 = exp2_ftz(fmaf(s[4 * n + 2 * r], LOG2E, -lse2[r]) + bb.x);
      const float p1 = exp2_ftz(fmaf(s[4 * n + 2 * r + 1], LOG2E, -lse2[r]) + bb.y);
      s[4 * n + 2 * r] = p0 * (dp[4 * n + 2 * r] - d[r]);
      s[4 * n + 2 * r + 1] = p1 * (dp[4 * n + 2 * r + 1] - d[r]);
    }
  }
}

// dK/dV kernel, one query tile: P^T = exp2(S^T log2(e) - lse log2(e) + key
// bias) into s and dS^T = P^T (dP^T - D) into dp, for this thread's keys
// (kb: their bias) against the tile's rows (lse2, d: their staged values).
__device__ __forceinline__ void dkv_grad_logits(float (&s)[32], float (&dp)[32], const float* lse2, const float* d,
                                                int c2, const float (&kb)[2]) {
#pragma unroll
  for (int n = 0; n < BS / 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * n + c2);
    const float2 dd = *reinterpret_cast<const float2*>(d + 8 * n + c2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float p0 = exp2_ftz(fmaf(s[4 * n + 2 * r], LOG2E, -l.x) + kb[r]);
      const float p1 = exp2_ftz(fmaf(s[4 * n + 2 * r + 1], LOG2E, -l.y) + kb[r]);
      s[4 * n + 2 * r] = p0;
      s[4 * n + 2 * r + 1] = p1;
      dp[4 * n + 2 * r] = p0 * (dp[4 * n + 2 * r] - dd.x);
      dp[4 * n + 2 * r + 1] = p1 * (dp[4 * n + 2 * r + 1] - dd.y);
    }
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* res_full, uint64_t* res_empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_THREADS);
    }
    mbar_init(res_full, 1);
    mbar_init(res_empty, CONSUMER_THREADS);
    mbar_fence_init();
  }
  __syncthreads();
}

template <typename Smem>
__device__ __forceinline__ Smem& smem_of(uint8_t* raw) {
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                         const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                         const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq,
                         float* __restrict__ delta, int B, int T, int H) {
  extern __shared__ uint8_t smem_raw[];
  SmemDq& sm = smem_of<SmemDq>(smem_raw);
  const int n_r = (T + BR - 1) / BR;
  const int n_items = n_r * H * B;
  const int n_s = (T + BS - 1) / BS;
  init_barriers(sm.full, sm.empty, &sm.res_full, &sm.res_empty);

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- producer warpgroup: one warp loads, three idle ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 != CONSUMER_THREADS / 32) return;
    const int lane = threadIdx.x & 31;
    int g = 0;  // streamed tiles loaded so far: ring slot g % STAGES, pass g / STAGES
    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      const Item x = item_of(w, n_r, H);
      if (lane == 0) {
        mbar_wait(&sm.res_empty, (it & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.res_full, 3 * RES_BYTES);
        tma_load_4d(sm.q, &tq, &sm.res_full, x.r0, x.h, x.b);
        tma_load_4d(sm.dout, &tdo, &sm.res_full, x.r0, x.h, x.b);
        tma_load_4d(sm.out, &to, &sm.res_full, x.r0, x.h, x.b);
      }
      const uint8_t* mb = mask ? mask + (long long)x.b * T : nullptr;
      for (int j = 0; j < n_s; ++j, ++g) {
        const int stage = g % STAGES;
        mbar_wait(&sm.empty[stage], ((g / STAGES) & 1) ^ 1);
        const int s = j * BS + 2 * lane;
        *reinterpret_cast<float2*>(&sm.bias[stage][2 * lane]) =
            make_float2(key_valid(mb, s, T) ? 0.0f : -INFINITY, key_valid(mb, s + 1, T) ? 0.0f : -INFINITY);
        __syncwarp();
        if (lane == 0) {
          // The arrive's release semantics publish the bias.
          mbar_arrive_expect_tx(&sm.full[stage], 2 * TILE_BYTES);
          tma_load_4d(sm.k[stage], &tk, &sm.full[stage], j * BS, x.h, x.b);
          tma_load_4d(sm.v[stage], &tv, &sm.full[stage], j * BS, x.h, x.b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c2 = (threadIdx.x & 3) * 2;
  // This thread's rows of the item's tile: r0 and r0 + 8.
  const int r0 = (threadIdx.x / 128) * 64 + ((threadIdx.x / 32) & 3) * 16 + ((threadIdx.x & 31) >> 2);

  uint32_t qa[16], da[16], dsa[16];
  float s[32], dp[32], dqa[32];
  float lse2[2], d_r[2];

  int g = 0;  // streamed tiles consumed so far, as the producer counts them
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const Item x = item_of(w, n_r, H);
    mbar_wait(&sm.res_full, it & 1);
    load_a(sm.q, r0, qa);
    load_a(sm.dout, r0, da);
    // D of rows r0 and r0 + 8: this thread's 16 dims of each (the columns
    // of its dO fragments), then the sum over the four threads of a row.
    d_r[0] = d_r[1] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t ow = lds_sw128(sm.out, r0 + 8 * (i & 1), 16 * kc + 8 * (i >> 1) + c2);
        const uint32_t dw = da[4 * kc + i];
        d_r[i & 1] = fmaf(bf16_hi(dw), bf16_hi(ow), fmaf(bf16_lo(dw), bf16_lo(ow), d_r[i & 1]));
      }
    }
    mbar_arrive(&sm.res_empty);  // Q, dO and O are in registers: the next item's may load
    const float* lse_bh = lse + ((long long)x.b * H + x.h) * T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      d_r[r] += __shfl_xor_sync(0xffffffffu, d_r[r], 1);
      d_r[r] += __shfl_xor_sync(0xffffffffu, d_r[r], 2);
      const int t = x.r0 + r0 + 8 * r;
      const float l = t < T ? lse_bh[t] : -INFINITY;
      lse2[r] = l == -INFINITY ? INFINITY : l * LOG2E;
      if (c2 == 0 && t < T) delta[((long long)x.b * H + x.h) * T + t] = d_r[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = 0.0f;

    int stage = g % STAGES;
    mbar_wait(&sm.full[stage], (g / STAGES) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_abt(s, qa, sm.k[stage]);   // S  = Q K^T
    mma_abt(dp, da, sm.v[stage]);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    dq_grad_logits(s, dp, sm.bias[stage], c2, lse2, d_r);
    pack_a(s, dsa);

    for (int j = 1; j < n_s; ++j) {
      const int prev = stage;  // the stage whose K the pending dQ product reads
      ++g;
      stage = g % STAGES;
      mbar_wait(&sm.full[stage], (g / STAGES) & 1);
        fence_regs(s);
      fence_regs(dp);
      fence_regs(dqa);
      wgmma_fence();
      mma_abt(s, qa, sm.k[stage]);
      mma_abt(dp, da, sm.v[stage]);
      wgmma_commit();
      mma_acc(dqa, dsa, sm.k[prev]);  // dQ += bf16(dS) K of the previous tile
      wgmma_commit();
        wgmma_wait<1>();  // S and dP are in; the dQ product may still run
      fence_regs(s);
      fence_regs(dp);
      dq_grad_logits(s, dp, sm.bias[stage], c2, lse2, d_r);
      wgmma_wait<0>();
      fence_regs(dqa);
      mbar_arrive(&sm.empty[prev]);
      pack_a(s, dsa);
    }
    fence_regs(dqa);
    wgmma_fence();
    mma_acc(dqa, dsa, sm.k[stage]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    mbar_arrive(&sm.empty[stage]);
    ++g;
    store_rows(dq + (long long)x.b * T * H * DH + x.h * DH, H, x.r0 + r0, T, dqa);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int B, int T, int H) {
  extern __shared__ uint8_t smem_raw[];
  SmemDkv& sm = smem_of<SmemDkv>(smem_raw);
  const int n_r = (T + BR - 1) / BR;
  const int n_items = n_r * H * B;
  const int n_s = (T + BS - 1) / BS;
  init_barriers(sm.full, sm.empty, &sm.res_full, &sm.res_empty);

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- producer warpgroup: one warp loads, three idle ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 != CONSUMER_THREADS / 32) return;
    const int lane = threadIdx.x & 31;
    int g = 0;
    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      const Item x = item_of(w, n_r, H);
      if (lane == 0) {
        mbar_wait(&sm.res_empty, (it & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.res_full, 2 * RES_BYTES);
        tma_load_4d(sm.k, &tk, &sm.res_full, x.r0, x.h, x.b);
        tma_load_4d(sm.v, &tv, &sm.res_full, x.r0, x.h, x.b);
      }
      const long long bh = ((long long)x.b * H + x.h) * T;
      for (int j = 0; j < n_s; ++j, ++g) {
        const int stage = g % STAGES;
        mbar_wait(&sm.empty[stage], ((g / STAGES) & 1) ^ 1);
        float l2[2], d2[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = j * BS + 2 * lane + i;
          const float l = t < T ? lse[bh + t] : -INFINITY;
          l2[i] = l == -INFINITY ? INFINITY : l * LOG2E;
          d2[i] = t < T ? delta[bh + t] : 0.0f;
        }
        *reinterpret_cast<float2*>(&sm.lse[stage][2 * lane]) = make_float2(l2[0], l2[1]);
        *reinterpret_cast<float2*>(&sm.delta[stage][2 * lane]) = make_float2(d2[0], d2[1]);
        __syncwarp();
        if (lane == 0) {
          // The arrive's release semantics publish lse and D.
          mbar_arrive_expect_tx(&sm.full[stage], 2 * TILE_BYTES);
          tma_load_4d(sm.q[stage], &tq, &sm.full[stage], j * BS, x.h, x.b);
          tma_load_4d(sm.dout[stage], &tdo, &sm.full[stage], j * BS, x.h, x.b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c2 = (threadIdx.x & 3) * 2;
  // This thread's keys of the item's tile: r0 and r0 + 8.
  const int r0 = (threadIdx.x / 128) * 64 + ((threadIdx.x / 32) & 3) * 16 + ((threadIdx.x & 31) >> 2);

  uint32_t ka[16], va[16], pa[16], dsa[16];
  float s[32], dp[32], dka[32], dva[32];
  float kb[2];  // bias of keys r0 and r0 + 8: 0, or -inf for an excluded key

  int g = 0;
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const Item x = item_of(w, n_r, H);
    mbar_wait(&sm.res_full, it & 1);
    load_a(sm.k, r0, ka);
    load_a(sm.v, r0, va);
    mbar_arrive(&sm.res_empty);  // K and V are in registers: the next item's may load
    const uint8_t* mb = mask ? mask + (long long)x.b * T : nullptr;
#pragma unroll
    for (int r = 0; r < 2; ++r) kb[r] = key_valid(mb, x.r0 + r0 + 8 * r, T) ? 0.0f : -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.0f;

    int stage = g % STAGES;
    mbar_wait(&sm.full[stage], (g / STAGES) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_abt(s, ka, sm.q[stage]);      // S^T  = K Q^T
    mma_abt(dp, va, sm.dout[stage]);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    dkv_grad_logits(s, dp, sm.lse[stage], sm.delta[stage], c2, kb);
    pack_a(s, pa);
    pack_a(dp, dsa);

    for (int j = 1; j < n_s; ++j) {
      const int prev = stage;  // the stage whose Q and dO the pending products read
      ++g;
      stage = g % STAGES;
      mbar_wait(&sm.full[stage], (g / STAGES) & 1);
        fence_regs(s);
      fence_regs(dp);
      fence_regs(dka);
      fence_regs(dva);
      wgmma_fence();
      mma_abt(s, ka, sm.q[stage]);
      mma_abt(dp, va, sm.dout[stage]);
      wgmma_commit();
      mma_acc(dva, pa, sm.dout[prev]);  // dV += bf16(P^T) dO of the previous tile
      mma_acc(dka, dsa, sm.q[prev]);    // dK += bf16(dS^T) Q
      wgmma_commit();
        wgmma_wait<1>();  // S^T and dP^T are in; dV and dK may still run
      fence_regs(s);
      fence_regs(dp);
      dkv_grad_logits(s, dp, sm.lse[stage], sm.delta[stage], c2, kb);
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      mbar_arrive(&sm.empty[prev]);
      pack_a(s, pa);
      pack_a(dp, dsa);
    }
    fence_regs(dka);
    fence_regs(dva);
    wgmma_fence();
    mma_acc(dva, pa, sm.dout[stage]);
    mma_acc(dka, dsa, sm.q[stage]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    mbar_arrive(&sm.empty[stage]);
    ++g;
    const long long off = (long long)x.b * T * H * DH + x.h * DH;
    store_rows(dk + off, H, x.r0 + r0, T, dka);
    store_rows(dv + off, H, x.r0 + r0, T, dva);
  }
}

// One CTA per SM (at most one per work item); dynamic shared memory above
// 48 KB needs the attribute. Called before the tensor maps are encoded: its
// runtime calls make the device's context current on the calling thread
// (the encoder needs one, and autograd runs the backward on a thread of
// its own, where no runtime call may have come first).
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int T, int H, int B, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long items = (long long)((T + BR - 1) / BR) * H * B;
  *grid = static_cast<int>(items < sms ? items : sms);
  return e;
}

constexpr size_t SMEM_DQ = sizeof(SmemDq) + 1024;  // + room to align the base to 1,024 bytes
constexpr size_t SMEM_DKV = sizeof(SmemDkv) + 1024;

}  // namespace

// ---- host side ----

// The caller (whisperx_tpu_torch/ops/flash_attn.py) checks shapes, types,
// the unit head and head-dim strides and 16-byte alignment. `strides` holds
// (batch, time) strides in elements of q, k, v, out and dout in that order;
// `lse` and `delta` are contiguous (B, H, T) fp32, `mask` a (B, T) bool array
// (1 = valid key) or null; dq, dk and dv are contiguous (B, T, H, 64) bf16.
// dQ first: it writes delta (D), which the dK/dV kernel reads. Each returns
// a cudaError_t: cudaErrorNotSupported if the driver has no
// cuTensorMapEncodeTiled, cudaErrorInvalidValue if it refuses a view.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* out, const void* dout,
                                 const void* lse, const void* mask, void* dq, void* delta, int B, int T, int H,
                                 const long long* strides, void* stream) {
  int grid = 0;
  const cudaError_t e = persistent_grid(flash_attn_bwd_dq_kernel, SMEM_DQ, T, H, B, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, to, tdo;
  const long long* sd = strides;
  if (!encode_bthd(fn, &tq, q, B, T, H, sd[0], sd[1], BR) || !encode_bthd(fn, &tk, k, B, T, H, sd[2], sd[3], BS) ||
      !encode_bthd(fn, &tv, v, B, T, H, sd[4], sd[5], BS) || !encode_bthd(fn, &to, out, B, T, H, sd[6], sd[7], BR) ||
      !encode_bthd(fn, &tdo, dout, B, T, H, sd[8], sd[9], BR))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_attn_bwd_dq_kernel<<<grid, THREADS, SMEM_DQ, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, tdo, static_cast<const float*>(lse), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(dq), static_cast<float*>(delta), B, T, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                  const void* delta, const void* mask, void* dk, void* dv, int B, int T, int H,
                                  const long long* strides, void* stream) {
  int grid = 0;
  const cudaError_t e = persistent_grid(flash_attn_bwd_dkv_kernel, SMEM_DKV, T, H, B, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, tdo;
  const long long* sd = strides;
  if (!encode_bthd(fn, &tq, q, B, T, H, sd[0], sd[1], BS) || !encode_bthd(fn, &tk, k, B, T, H, sd[2], sd[3], BR) ||
      !encode_bthd(fn, &tv, v, B, T, H, sd[4], sd[5], BR) || !encode_bthd(fn, &tdo, dout, B, T, H, sd[6], sd[7], BS))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_attn_bwd_dkv_kernel<<<grid, THREADS, SMEM_DKV, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, T, H);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread (as compiled; the consumers raise theirs to 232 with
// setmaxnreg and the producer lowers its to 40), local-memory (spill) bytes
// a thread and dynamic shared memory a CTA of kernel `which` (0: dQ, 1:
// dK/dV). Returns a cudaError_t.
extern "C" int flash_attn_bwd_resources(int which, int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = which == 0 ? cudaFuncGetAttributes(&a, flash_attn_bwd_dq_kernel)
                                   : cudaFuncGetAttributes(&a, flash_attn_bwd_dkv_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = static_cast<int>(which == 0 ? SMEM_DQ : SMEM_DKV);
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
