// Bidirectional flash self-attention for the encoder stacks, written by hand
// for Hopper (sm_90a).
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
// keys like any other row. Tensors are (B, T, H, 64) bf16 with the head and
// the head dim contiguous; the batch and time strides are arguments, so the
// q/k/v slices of a fused QKV projection need no copy.
//
// What bounds it on the card: operations. At the Whisper large-v2 encoder
// shape (B 8, T 1500, H 20) the two products are 92.2 GFLOP per call, about
// 0.093 ms at the 989 TFLOP/s bf16 tensor-core peak, against 123 MB of
// q/k/v/out (0.037 ms at 3.35 TB/s). So both products run on the tensor cores
// and the (T, T) logits never leave the registers.
//
// Design (the TPU kernel's 512-row blocks and segment ids do not carry over):
//  - One CTA of 4 warps per (tile of 64 query rows, head, batch element):
//    3,840 CTAs at the large-v2 shape. Each warp owns 16 query rows.
//  - K and V tiles of 64 keys stream through a two-stage cp.async ring in
//    shared memory; rows are padded to 144 bytes so ldmatrix is free of bank
//    conflicts. Rows beyond T are zero-filled and their keys masked.
//  - S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 in, fp32 sums).
//    The online softmax keeps its running max and sum in fp32 registers; P is
//    rounded to bf16 as the A operand of the second product (the reference
//    rounds the normalised weights instead), and O is divided by the sum at
//    the end. A row whose keys are all masked gets zeros.
//  - The T tail (1499, 1500) is handled by bounds, not by padding to a block
//    multiple.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr int BM = 64;       // query rows per CTA
constexpr int BN = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int LDS = DH + 8;   // padded shared-memory row, in bf16 elements (144 bytes)
constexpr float LOG2E = 1.4426950408889634f;

struct __align__(16) Smem {
  __nv_bfloat16 q[BM * LDS];
  __nv_bfloat16 k[2][BN * LDS];
  __nv_bfloat16 v[2][BN * LDS];
  float bias[2][BN];  // 0 for a valid key, -inf for an excluded one
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; `bytes` = 0 writes zeros without reading.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// D += A (16x16 bf16, row) * B (16x8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Copy rows [t0, t0 + 64) of one head of a (B, T, H, 64) tensor into a
// padded shared-memory tile; rows at or beyond T become zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, long long st, int t0,
                                          int T, int tid) {
#pragma unroll
  for (int i = 0; i < BM * DH / 8 / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int row = c >> 3, part = c & 7;
    const int t = t0 + row;
    const int tc = t < T ? t : T - 1;
    cp_async16(dst + row * LDS + part * 8, src + tc * st + part * 8, t < T ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                  __nv_bfloat16* __restrict__ out, int T, long long q_sb, long long q_st, long long k_sb,
                  long long k_st, long long v_sb, long long v_st, long long o_sb, long long o_st) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // row of the mma fragment
  const int c2 = (lane & 3) * 2;  // first column of the mma fragment
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* qb = q + b * q_sb + h * DH;
  const __nv_bfloat16* kb = k + b * k_sb + h * DH;
  const __nv_bfloat16* vb = v + b * v_sb + h * DH;
  const uint8_t* mb = mask ? mask + (long long)b * T : nullptr;
  const int n_tiles = (T + BN - 1) / BN;

  auto load_kv = [&](int j) {
    const int buf = j & 1;
    load_tile(sm.k[buf], kb, k_st, j * BN, T, tid);
    load_tile(sm.v[buf], vb, v_st, j * BN, T, tid);
    if (tid < BN) {
      const int s = j * BN + tid;
      const bool valid = s < T && (mb == nullptr || mb[s] != 0);
      sm.bias[buf][tid] = valid ? 0.0f : -INFINITY;
    }
  };

  load_tile(sm.q, qb, q_st, m0, T, tid);
  load_kv(0);
  cp_async_commit();

  unsigned qf[4][4];  // this warp's 16 query rows as A fragments, 4 chunks of 16 dims
  float acc[8][4];    // O: 16 rows x 64 dims, 8 tiles of 8 dims
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = j & 1;
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        ldmatrix_x4(qf[kc], sm.q + (warp * 16 + (lane & 15)) * LDS + kc * 16 + (lane >> 4) * 8);
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned r[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(r, sm.k[buf] + key * LDS + kc * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kc], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kc], r[2], r[3]);
      }
    }

    // Online softmax: mask, row max over the quad, rescale.
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float b0 = sm.bias[buf][n * 8 + c2], b1 = sm.bias[buf][n * 8 + c2 + 1];
      s[n][0] += b0;
      s[n][1] += b1;
      s[n][2] += b0;
      s[n][3] += b1;
      mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_run[r], mt[r]);
      mu[r] = m_new == -INFINITY ? 0.0f : m_new;  // all keys so far masked: keep exp() finite
      alpha[r] = exp2f((m_run[r] - mu[r]) * LOG2E);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f((s[n][0] - mu[0]) * LOG2E);
      s[n][1] = exp2f((s[n][1] - mu[0]) * LOG2E);
      s[n][2] = exp2f((s[n][2] - mu[1]) * LOG2E);
      s[n][3] = exp2f((s[n][3] - mu[1]) * LOG2E);
      l_run[0] += s[n][0] + s[n][1];
      l_run[1] += s[n][2] + s[n][3];
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += bf16(P) V: the S accumulators of key tiles 2kc, 2kc+1 form the A
    // fragment of key chunk kc.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        unsigned r[4];
        const int key = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, sm.v[buf] + key * LDS + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // the next iteration refills the buffer just read
  }

  // Normalise and store rows g and g + 8 of this warp's 16.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = m0 + warp * 16 + g + r * 8;
    if (t >= T) continue;
    const float inv = l_run[r] > 0.0f ? 1.0f / l_run[r] : 0.0f;
    __nv_bfloat16* orow = out + b * o_sb + t * o_st + h * DH;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + c2) = val;
    }
  }
}

}  // namespace

// The caller (whisperx_tpu_torch/ops/flash_attn.py) checks shapes, types,
// the unit head and head-dim strides and 16-byte alignment. Strides are in
// elements; `mask` is a (B, T) bool array (1 = valid key) or null.
extern "C" int flash_attn(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                          int T, int H, long long q_sb, long long q_st, long long k_sb, long long k_st,
                          long long v_sb, long long v_st, long long o_sb, long long o_st, void* stream) {
  const dim3 grid((T + BM - 1) / BM, H, B);
  flash_attn_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out),
      T, q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
