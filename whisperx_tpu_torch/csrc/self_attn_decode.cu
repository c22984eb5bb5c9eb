// Decode-step self-attention over the decoder's static self cache, written
// by hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs the cache store and the
// two einsums in XLA (whisperx_tpu/models/whisper.py:400-446), and the
// port's plain version (whisperx_tpu_torch/ops/self_attn_decode.py:
// self_attention_plain) ran them as 36 small PyTorch kernels a layer-step,
// casting and copying the whole cache for both products. For one query
// token of row r and head h at slot p = positions[0] (read on the card: the
// step is captured in a CUDA graph), one launch a layer-step:
//   store:   k, v of (r, h) quantized per (token, head) as quantize_kv does
//            (scale = amax |x| / 127, int8 = clamp(round_half_even(x / max(scale,
//            1e-8)), +-127)), or rounded to bf16 for a bf16 cache, into slot p
//   logits:  l[s] = (bf16(q * Dh^-0.25) . k[s]) * Dh^-0.25 * k_scale[s]      fp32, s <= p
//   weights: w[s] = bf16(softmax(l)[s] * v_scale[s])                      fp32 softmax
//   out:     sum_s w[s] v[s], accumulated in fp32, stored as bf16
// Layouts are the port's: q, k, v rows of the fp32 projection output (a
// fused QKV output is read in place: three pointers, one row stride), the
// cache (rows, S, H, 64) int8 or bf16, its scales (rows, S, H, 1) fp32, the
// output (rows, 1, H * 64) bf16. The slots after p are never read: the plain
// version masks them with -1e9, whose exp is exactly 0 in fp32.
//
// What bounds it on the card: bytes, and the latency of one round trip. At
// large-v2's beam step (40 rows x 20 heads, 128 slots) the filled slots of
// K and V are ~6 MB at the mean fill, ~2 us at 3.35 TB/s; the arithmetic is
// ~16 MFLOP. So:
//  - one CTA of 128 threads per (row, head): 800 CTAs of 19 KB (int8: 11 an
//    SM, all resident at once) or 35 KB (bf16: 6 an SM, 792 at once) of
//    shared memory. The CTA that owns (r, h) is the only one that writes or
//    reads its slots, so the store of slot p races no read.
//  - at its first instructions each CTA asks for all its filled slots
//    [0, p) of K (with the k scales) and then of V (with the v scales) by
//    cp.async, two commit groups, so the loads overlap the new token's
//    quantization, and V arrives while the logits and the softmax run. No
//    slot is read twice.
//  - the new slot p is written to the cache and to shared memory from
//    registers; the logits, an exact two-pass softmax over <= 448 fp32
//    logits in shared memory, and the V product then read shared memory
//    only (4 lanes a slot, 16 values a lane).
// The products are on the CUDA cores: an int8 or bf16 value times a bf16 q
// or weight is exact in fp32, so only the order of the fp32 sums differs
// from the plain version.
// Measured (step_breakdown.py, H100, int8, over 32 caches out of L2): 8.0 us
// at the mean fill and 12.5 us full, against 2.2 / 4.4 us of bytes: the
// phases of a CTA run one after another, with five barriers between them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 4;            // lanes a slot
constexpr int VALS = DH / LANES;    // values a lane: 16
constexpr int SLOTS_A_WARP = 32 / LANES;
constexpr int MAX_SLOTS = 448;      // ops/self_attn_decode.py MAX_SLOTS
constexpr float SCALE = 0.35355339059327373f;  // Dh^-0.25, as torch rounds the Python float
constexpr float INV_QMAX = 1.0f / 127.0f;       // torch on CUDA divides by a scalar as a product with its reciprocal
constexpr float MIN_SCALE = 1e-8f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 cache values as floats (int8 -> float and bf16 -> float are exact).
__device__ __forceinline__ void load16(const int8_t* p, float (&x)[VALS]) {
  const int4 w = *reinterpret_cast<const int4*>(p);
  const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b) x[4 * i + b] = static_cast<float>(static_cast<int8_t>(words[i] >> (8 * b)));
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[VALS]) {
  const uint4* w = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = w[i];
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[8 * i + 2 * j] = __uint_as_float(words[j] << 16);
      x[8 * i + 2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
    }
  }
}

// Shared memory of a CTA over a cache of S slots: K and V of every slot,
// their scales (int8), the logits, q, the warps' partial outputs and the
// block reductions.
struct Layout {
  size_t k, v, ks, vs, lg, q, part, red, total;
  __host__ __device__ Layout(int S, int elem, bool scaled) {
    k = 0;
    v = k + static_cast<size_t>(S) * DH * elem;
    ks = v + static_cast<size_t>(S) * DH * elem;
    vs = ks + (scaled ? S * 4 : 0);
    lg = vs + (scaled ? S * 4 : 0);
    q = lg + S * 4;
    part = q + DH * 4;
    red = part + WARPS * DH * 4;
    total = red + 3 * WARPS * 4;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    self_attn_decode_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                            const float* __restrict__ v_new, long long row_stride, T* kc, T* vc, float* ksc,
                            float* vsc, const long long* __restrict__ positions, __nv_bfloat16* __restrict__ out,
                            int H, int S) {
  constexpr bool SCALED = sizeof(T) == 1;
  constexpr int CHUNKS = DH * static_cast<int>(sizeof(T)) / 16;  // 16-byte copies a slot
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L(S, sizeof(T), SCALED);
  T* ksm = reinterpret_cast<T*>(smem + L.k);
  T* vsm = reinterpret_cast<T*>(smem + L.v);
  float* kss = reinterpret_cast<float*>(smem + L.ks);
  float* vss = reinterpret_cast<float*>(smem + L.vs);
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int h = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long pos = *positions;
  if (pos < 0 || pos >= S) __trap();  // index_copy_ would fault too
  const int p = static_cast<int>(pos);
  const size_t slot = static_cast<size_t>(H) * DH;                  // elements from one slot to the next
  const size_t base = (static_cast<size_t>(r) * S * H + h) * DH;      // slot 0 of (r, h)
  const size_t sbase = static_cast<size_t>(r) * S * H + h;           // its scale

  // 1. The filled slots [0, p): K and its scales, then V and its scales.
  for (int i = tid; i < p * CHUNKS; i += THREADS) {
    const int s = i / CHUNKS, c = i % CHUNKS;
    cp_async16(reinterpret_cast<uint8_t*>(ksm + s * DH) + 16 * c,
               reinterpret_cast<const uint8_t*>(kc + base + s * slot) + 16 * c);
  }
  if (SCALED)
    for (int s = tid; s < p; s += THREADS) cp_async4(kss + s, ksc + sbase + static_cast<size_t>(s) * H);
  cp_async_commit();
  for (int i = tid; i < p * CHUNKS; i += THREADS) {
    const int s = i / CHUNKS, c = i % CHUNKS;
    cp_async16(reinterpret_cast<uint8_t*>(vsm + s * DH) + 16 * c,
               reinterpret_cast<const uint8_t*>(vc + base + s * slot) + 16 * c);
  }
  if (SCALED)
    for (int s = tid; s < p; s += THREADS) cp_async4(vss + s, vsc + sbase + static_cast<size_t>(s) * H);
  cp_async_commit();

  // 2. The new token: warps 0-1 store k, warps 2-3 v, one value a thread;
  // threads 0-63 also round q.
  const int d = tid & (DH - 1);
  const bool is_v = tid >= DH;
  const size_t row = static_cast<size_t>(r) * row_stride + static_cast<size_t>(h) * DH;
  const float x = (is_v ? v_new : k_new)[row + d];
  if (tid < DH) qs[d] = __bfloat162float(__float2bfloat16_rn(q[row + d] * SCALE));
  T* dst_smem = (is_v ? vsm : ksm) + p * DH;
  T* dst = (is_v ? vc : kc) + base + p * slot;
  if constexpr (SCALED) {
    const float a = warp_max(fabsf(x));
    if (lane == 0) red[warp] = a;
    __syncthreads();
    const float amax = fmaxf(red[is_v ? 2 : 0], red[is_v ? 3 : 1]);
    const float scale = amax * INV_QMAX;
    const float qv = fminf(fmaxf(rintf(__fdiv_rn(x, fmaxf(scale, MIN_SCALE))), -127.0f), 127.0f);
    const T b = static_cast<T>(static_cast<int>(qv));
    dst_smem[d] = b;
    dst[d] = b;
    if (d == 0) {
      (is_v ? vss : kss)[p] = scale;
      (is_v ? vsc : ksc)[sbase + static_cast<size_t>(p) * H] = scale;
    }
  } else {
    const T b = __float2bfloat16_rn(x);
    dst_smem[d] = b;
    dst[d] = b;
  }
  cp_async_wait<1>();  // this thread's K copies
  __syncthreads();     // everyone's, the new slot and q

  // 3. Logits of slots [0, p]: 4 lanes a slot, 8 slots a warp at a time.
  const int sub = lane & (LANES - 1);
  float qr[VALS];
#pragma unroll
  for (int j = 0; j < VALS; ++j) qr[j] = qs[sub * VALS + j];
  for (int s0 = warp * SLOTS_A_WARP; s0 <= p; s0 += WARPS * SLOTS_A_WARP) {
    const int s = s0 + lane / LANES;
    float dot = 0.0f;
    if (s <= p) {
      float kv[VALS];
      load16(ksm + s * DH + sub * VALS, kv);
#pragma unroll
      for (int j = 0; j < VALS; ++j) dot = fmaf(qr[j], kv[j], dot);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    if (s <= p && sub == 0) {
      float l = dot * SCALE;
      if (SCALED) l *= kss[s];
      lg[s] = l;
    }
  }
  __syncthreads();

  // 4. Softmax over the p + 1 logits: max, then exp and sum, then weights.
  float m = -INFINITY;
  for (int s = tid; s <= p; s += THREADS) m = fmaxf(m, lg[s]);
  m = warp_max(m);
  if (lane == 0) red[WARPS + warp] = m;
  __syncthreads();
  m = fmaxf(fmaxf(red[WARPS], red[WARPS + 1]), fmaxf(red[WARPS + 2], red[WARPS + 3]));
  float sum = 0.0f;
  for (int s = tid; s <= p; s += THREADS) {
    const float e = expf(lg[s] - m);
    lg[s] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[2 * WARPS + warp] = sum;
  cp_async_wait<0>();  // this thread's V copies
  __syncthreads();
  sum = (red[2 * WARPS] + red[2 * WARPS + 1]) + (red[2 * WARPS + 2] + red[2 * WARPS + 3]);
  for (int s = tid; s <= p; s += THREADS) {
    float w = __fdiv_rn(lg[s], sum);
    if (SCALED) w *= vss[s];
    lg[s] = __bfloat162float(__float2bfloat16_rn(w));
  }
  __syncthreads();

  // 5. The V product, as the logits' lanes: each lane sums 16 dims over its
  // slots, then the 8 slot lanes of a warp and the 4 warps are added.
  float acc[VALS];
#pragma unroll
  for (int j = 0; j < VALS; ++j) acc[j] = 0.0f;
  for (int s0 = warp * SLOTS_A_WARP; s0 <= p; s0 += WARPS * SLOTS_A_WARP) {
    const int s = s0 + lane / LANES;
    if (s <= p) {
      const float w = lg[s];
      float vv[VALS];
      load16(vsm + s * DH + sub * VALS, vv);
#pragma unroll
      for (int j = 0; j < VALS; ++j) acc[j] = fmaf(w, vv[j], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < VALS; ++j) {
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 4);
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 8);
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
  }
  if (lane < LANES)
#pragma unroll
    for (int j = 0; j < VALS; ++j) part[warp * DH + lane * VALS + j] = acc[j];
  __syncthreads();
  if (tid < DH) {
    const float o = (part[tid] + part[DH + tid]) + (part[2 * DH + tid] + part[3 * DH + tid]);
    out[static_cast<size_t>(r) * H * DH + static_cast<size_t>(h) * DH + tid] = __float2bfloat16_rn(o);
  }
}

template <typename T>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 64) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (!done[dev]) {
    const int bytes = static_cast<int>(Layout(MAX_SLOTS, sizeof(T), sizeof(T) == 1).total);
    e = cudaFuncSetAttribute(self_attn_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, long long row_stride, void* kc, void* vc, void* ks,
                   void* vs, const void* positions, void* out, int rows, int H, int S, cudaStream_t stream) {
  cudaError_t e = allow_smem<T>();
  if (e != cudaSuccess) return e;
  const size_t smem = Layout(S, sizeof(T), sizeof(T) == 1).total;
  self_attn_decode_kernel<T><<<dim3(H, rows), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), row_stride,
      static_cast<T*>(kc), static_cast<T*>(vc), static_cast<float*>(ks), static_cast<float*>(vs),
      static_cast<const long long*>(positions), static_cast<__nv_bfloat16*>(out), H, S);
  return cudaGetLastError();
}

}  // namespace

// The caller (whisperx_tpu_torch/ops/self_attn_decode.py) checks shapes,
// types, strides, contiguity and the caches' 16-byte alignment. q, k, v:
// fp32 rows `row_stride` floats apart; kv_int8 selects an int8 cache with
// fp32 scales (1) or a bf16 cache without (0; ks and vs unused). Returns a
// cudaError_t.
extern "C" int self_attn_decode(const void* q, const void* k, const void* v, long long row_stride, void* k_cache,
                                void* v_cache, void* k_scale, void* v_scale, const void* positions, void* out,
                                int rows, int H, int S, int kv_int8, void* stream) {
  if (rows < 1 || rows > 65535 || H < 1 || S < 1 || S > MAX_SLOTS || row_stride < static_cast<long long>(H) * DH ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      kv_int8 ? launch<int8_t>(q, k, v, row_stride, k_cache, v_cache, k_scale, v_scale, positions, out, rows, H, S, st)
              : launch<__nv_bfloat16>(q, k, v, row_stride, k_cache, v_cache, k_scale, v_scale, positions, out, rows,
                                      H, S, st);
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
