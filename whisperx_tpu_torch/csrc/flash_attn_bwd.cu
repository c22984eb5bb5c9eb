// The backward of the encoder's flash self-attention, written by hand for
// Hopper (sm_90a): two kernels on bf16 mma.sync m16n8k16, fp32 accumulators.
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
// atomics or a reduction across CTAs.
//
// Design (a first, simple version: mma.sync, no TMA, no wgmma):
//  - dQ kernel, launched first: one CTA of four warps per (64 query rows,
//    head, batch element); each warp owns 16 rows and keeps their Q and dO
//    as mma A fragments in registers. Its prologue computes D for its rows
//    from out and dout and writes it to a (B, H, T) fp32 buffer, which the
//    dK/dV kernel reads: no third launch. It walks every key tile of 64:
//    K (row-major and transposed) and V into shared memory, S and dP on
//    the tensor cores, P and dS in registers, dQ += bf16(dS) K.
//  - dK/dV kernel: one CTA of four warps per (64 keys, head, batch
//    element); each warp keeps its 16 keys' K and V as A fragments and
//    computes the transposed products S^T = K Q^T and dP^T = V dO^T, so
//    that P^T and dS^T come out of the accumulators already in the A
//    fragment layout of dV += bf16(P^T) dO and dK += bf16(dS^T) Q. It walks
//    every query tile of 64 (Q, dO, each also transposed, lse and D in
//    shared memory).
//  - Shared-memory rows are padded from 64 to 72 elements (144 bytes), so
//    the 32-bit fragment reads of a warp fall in 32 distinct banks. Tiles
//    are loaded with 16-byte reads; rows at or beyond T read as zeros.
//  - An excluded key or a row without a valid key is handled by value (its
//    P is 0), never by skipping a tile, so that no branch depends on data.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int DH = 64;
constexpr int TILE = 64;      // rows of a CTA, and rows of each inner tile
constexpr int THREADS = 128;  // four warps of 16 rows
constexpr int LD = DH + 8;    // padded shared-memory row, in elements
constexpr float LOG2E = 1.4426950408889634f;

// Batch and time strides (elements) of the five (B, T, H, 64) inputs.
struct Strides {
  long long sb[5], st[5];
};
enum { Q = 0, K = 1, V = 2, O = 3, DO = 4 };

typedef __nv_bfloat16 Tile[TILE][LD];

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows t0 .. t0 + 63 of one (b, h) slice of a (B, T, H, 64) tensor into
// `dst` (and transposed into `dst_t`, when given); rows at or beyond T are
// zeros. Thread i reads 16 bytes of row (i mod 64), so a warp's transposed
// 16-bit stores fall in distinct 32-bit words of distinct banks.
__device__ __forceinline__ void load_tile(const __nv_bfloat16* base, long long st, int t0, int T, Tile& dst,
                                          Tile* dst_t) {
#pragma unroll
  for (int i = 0; i < TILE * DH / 8 / THREADS; ++i) {
    const int id = threadIdx.x + i * THREADS;
    const int r = id & (TILE - 1), d0 = (id / TILE) * 8;
    const int t = t0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < T) v = *reinterpret_cast<const uint4*>(base + t * st + d0);
    *reinterpret_cast<uint4*>(&dst[r][d0]) = v;
    if (dst_t != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) (*dst_t)[d0 + j][r] = e[j];
    }
  }
}

// The A fragments (16 rows from r0, all 64 columns as 4 k-chunks) of a
// row-major tile.
__device__ __forceinline__ void load_a(const Tile& x, int r0, uint32_t (&a)[4][4]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    a[kc][0] = ld32(&x[r0 + g][kc * 16 + 2 * c]);
    a[kc][1] = ld32(&x[r0 + g + 8][kc * 16 + 2 * c]);
    a[kc][2] = ld32(&x[r0 + g][kc * 16 + 2 * c + 8]);
    a[kc][3] = ld32(&x[r0 + g + 8][kc * 16 + 2 * c + 8]);
  }
}

// acc[n] (16 x 8 tile n of a 16 x 64 result) = A (16 x 64, fragments a) times
// the transpose of the 64 x 64 row-major tile bt: acc[n][r][c] = sum_k
// A[r][k] bt[8 n + c][k].
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[4][4], const Tile& bt) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc)
      hopper::mma_bf16_16816(acc[n], a[kc], ld32(&bt[8 * n + g][kc * 16 + 2 * c]),
                             ld32(&bt[8 * n + g][kc * 16 + 2 * c + 8]));
  }
}

// acc[n] += X (16 x 64, the fp32 accumulators x of a previous product,
// rounded to bf16: their C layout is the A layout of k-chunk kc = tiles 2 kc
// and 2 kc + 1) times the 64 x 64 tile whose transpose bt is stored
// row-major: acc[n][r][c] += sum_k X[r][k] bt[8 n + c][k].
__device__ __forceinline__ void mma_xbt_acc(float (&acc)[8][4], const float (&x)[8][4], const Tile& bt) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  uint32_t a[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    a[kc][1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    a[kc][2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    a[kc][3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      hopper::mma_bf16_16816(acc[n], a[kc], ld32(&bt[8 * n + g][kc * 16 + 2 * c]),
                             ld32(&bt[8 * n + g][kc * 16 + 2 * c + 8]));
  }
}

// Rows r0 + g and r0 + g + 8 of a 16 x 64 fp32 accumulator as bf16, into
// rows t0 + r of a (B, T, H, 64) tensor at `base` with time stride st.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long st, int t0, int T, int r0,
                                           const float (&acc)[8][4]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + r0 + g + 8 * half;
    if (t >= T) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(base + t * st + 8 * n + 2 * c) =
          __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

__device__ __forceinline__ bool key_valid(const uint8_t* mask_b, int s, int T) {
  return s < T && (mask_b == nullptr || mask_b[s] != 0);
}

// lse of a row as the kernels subtract it: +inf for a row at or beyond T or
// without a valid key, so that its P is exp(-inf) = 0.
__device__ __forceinline__ float lse_of_row(const float* lse_bh, int t, int T) {
  const float l = t < T ? lse_bh[t] : -INFINITY;
  return l == -INFINITY ? INFINITY : l;
}

__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ out,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq,
                         float* __restrict__ delta, int T, int H, Strides sd) {
  __shared__ __align__(16) Tile ks, kt, vs;
  __shared__ float key_ok[TILE], d_s[TILE];
  const int m0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, r0 = warp * 16;
  auto at = [&](const __nv_bfloat16* p, int which) { return p + b * sd.sb[which] + h * DH; };
  const float* lse_bh = lse + ((long long)b * H + h) * T;
  float* delta_bh = delta + ((long long)b * H + h) * T;
  const uint8_t* mask_b = mask ? mask + (long long)b * T : nullptr;

  // Prologue: this tile's Q and dO as A fragments, and D = sum_d dout * out
  // per row (two threads a row, 32 dims each), written for the dK/dV kernel.
  uint32_t qa[4][4], oa[4][4];
  load_tile(at(q, Q), sd.st[Q], m0, T, ks, nullptr);
  load_tile(at(dout, DO), sd.st[DO], m0, T, vs, nullptr);
  load_tile(at(out, O), sd.st[O], m0, T, kt, nullptr);
  __syncthreads();
  load_a(ks, r0, qa);
  load_a(vs, r0, oa);
  {
    const int r = threadIdx.x >> 1, d0 = (threadIdx.x & 1) * 32;
    float sum = 0.0f;
#pragma unroll 8
    for (int d = 0; d < 32; ++d) sum = fmaf(__bfloat162float(vs[r][d0 + d]), __bfloat162float(kt[r][d0 + d]), sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((threadIdx.x & 1) == 0 && m0 + r < T) delta_bh[m0 + r] = sum;
    if ((threadIdx.x & 1) == 0) d_s[r] = sum;
  }
  __syncthreads();
  float lse_r[2], d_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    lse_r[half] = lse_of_row(lse_bh, m0 + r0 + g + 8 * half, T) * LOG2E;
    d_r[half] = d_s[r0 + g + 8 * half];
  }

  float dqa[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.0f;
  float s[8][4], dp[8][4];
  for (int k0 = 0; k0 < T; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(at(k, K), sd.st[K], k0, T, ks, &kt);
    load_tile(at(v, V), sd.st[V], k0, T, vs, nullptr);
    if (threadIdx.x < TILE) key_ok[threadIdx.x] = key_valid(mask_b, k0 + threadIdx.x, T) ? 1.0f : 0.0f;
    __syncthreads();
    mma_abt(s, qa, ks);   // S  = Q K^T   (16 rows x 64 keys)
    mma_abt(dp, oa, vs);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, key = 8 * n + 2 * c + (e & 1);
        const float p = key_ok[key] != 0.0f ? exp2f(fmaf(s[n][e], LOG2E, -lse_r[half])) : 0.0f;
        s[n][e] = p * (dp[n][e] - d_r[half]);  // dS
      }
    }
    mma_xbt_acc(dqa, s, kt);  // dQ += bf16(dS) K
  }
  store_rows(dq + b * (long long)T * H * DH + h * DH, (long long)H * DH, m0, T, r0, dqa);
}

__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int T, int H, Strides sd) {
  __shared__ __align__(16) Tile qs, qt, os, ot;
  __shared__ float lse_s[TILE], d_s[TILE];
  const int n0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, r0 = warp * 16;
  auto at = [&](const __nv_bfloat16* p, int which) { return p + b * sd.sb[which] + h * DH; };
  const float* lse_bh = lse + ((long long)b * H + h) * T;
  const float* delta_bh = delta + ((long long)b * H + h) * T;
  const uint8_t* mask_b = mask ? mask + (long long)b * T : nullptr;

  // This warp's 16 keys: K and V as A fragments, and whether each is valid.
  uint32_t ka[4][4], va[4][4];
  load_tile(at(k, K), sd.st[K], n0, T, qs, nullptr);
  load_tile(at(v, V), sd.st[V], n0, T, os, nullptr);
  __syncthreads();
  load_a(qs, r0, ka);
  load_a(os, r0, va);
  const bool ok0 = key_valid(mask_b, n0 + r0 + g, T), ok1 = key_valid(mask_b, n0 + r0 + g + 8, T);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.0f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.0f;
  }
  float s[8][4], dp[8][4];
  for (int m0 = 0; m0 < T; m0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(at(q, Q), sd.st[Q], m0, T, qs, &qt);
    load_tile(at(dout, DO), sd.st[DO], m0, T, os, &ot);
    if (threadIdx.x < TILE) {
      lse_s[threadIdx.x] = lse_of_row(lse_bh, m0 + threadIdx.x, T) * LOG2E;
      d_s[threadIdx.x] = m0 + threadIdx.x < T ? delta_bh[m0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    mma_abt(s, ka, qs);   // S^T  = K Q^T   (16 keys x 64 query rows)
    mma_abt(dp, va, os);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * n + 2 * c + (e & 1);  // the query row of this element
        const bool ok = (e >> 1) ? ok1 : ok0;
        const float p = ok ? exp2f(fmaf(s[n][e], LOG2E, -lse_s[row])) : 0.0f;
        s[n][e] = p;                       // P^T
        dp[n][e] = p * (dp[n][e] - d_s[row]);  // dS^T
      }
    }
    mma_xbt_acc(dva, s, ot);   // dV += bf16(P^T) dO
    mma_xbt_acc(dka, dp, qt);  // dK += bf16(dS^T) Q
  }
  const long long st = (long long)H * DH, sb = (long long)T * st;
  store_rows(dk + b * sb + h * DH, st, n0, T, r0, dka);
  store_rows(dv + b * sb + h * DH, st, n0, T, r0, dva);
}

Strides strides_of(const long long* s) {
  Strides sd;
  for (int i = 0; i < 5; ++i) {
    sd.sb[i] = s[2 * i];
    sd.st[i] = s[2 * i + 1];
  }
  return sd;
}

}  // namespace

// The caller (whisperx_tpu_torch/ops/flash_attn.py) checks shapes, types,
// the unit head and head-dim strides and 16-byte alignment. `strides` holds
// (batch, time) strides in elements of q, k, v, out and dout in that order;
// `lse` and `delta` are contiguous (B, H, T) fp32, `mask` a (B, T) bool array
// (1 = valid key) or null; dq, dk and dv are contiguous (B, T, H, 64) bf16.
// dQ first: it writes delta (D), which the dK/dV kernel reads. Each returns
// a cudaError_t.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* out, const void* dout,
                                 const void* lse, const void* mask, void* dq, void* delta, int B, int T, int H,
                                 const long long* strides, void* stream) {
  const dim3 grid((T + TILE - 1) / TILE, H, B);
  flash_attn_bwd_dq_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(dq), static_cast<float*>(delta), T, H, strides_of(strides));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                  const void* delta, const void* mask, void* dk, void* dv, int B, int T, int H,
                                  const long long* strides, void* stream) {
  const dim3 grid((T + TILE - 1) / TILE, H, B);
  flash_attn_bwd_dkv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, H, strides_of(strides));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
