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

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// Named barriers 1 and 2 pass the tensor cores between the two consumer
// warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(CONSUMER_THREADS) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(CONSUMER_THREADS) : "memory");
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
  for (int kc = 0; kc < BN / 16; ++kc) wgmma_m64n64_rs<1>(o, p + 4 * kc, dv + kc * (16 * DH * 2 >> 4), 1);
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
    mbar_fence_init();
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
        tma_load_4d(sm.q[qb], &tq, &sm.q_full[qb], x.m0, x.h, x.b);
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
          tma_load_4d(sm.k[stage], &tk, &sm.full[stage], j * BN, x.h, x.b);
          tma_load_4d(sm.v[stage], &tv, &sm.full[stage], j * BN, x.h, x.b);
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

}  // namespace

// ---- host side ----

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
  // The runtime calls come first: they make the device's context current on
  // this thread, which the tensor-map encoder needs.
  const size_t smem = sizeof(Smem) + 1024;  // + room to align the base to 1,024 bytes
  cudaError_t e = cudaFuncSetAttribute(flash_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // Persistent: one CTA per SM walks the work items.
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode_bthd(fn, &tq, q, B, T, H, q_sb, q_st, BM) || !encode_bthd(fn, &tk, k, B, T, H, k_sb, k_st, BN) ||
      !encode_bthd(fn, &tv, v, B, T, H, v_sb, v_st, BN))
    return static_cast<int>(cudaErrorInvalidValue);
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
