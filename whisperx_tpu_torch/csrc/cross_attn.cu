// Decode-step cross attention over int8 (or bf16) encoder K/V, written by
// hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// whisperx_tpu/ops/pallas_cross_attn.py:cross_attention_decode. For each
// batch element b and head h, G query rows (the beams of b, pre-scaled by
// 1/sqrt(Dh)) attend over S encoder positions:
//   logits[g, s] = (q[b, g, h, :] . k[b, s, h, :]) * k_scale[b, h, s]     fp32
//   p[g, :]      = softmax(logits[g, :])                                  fp32
//   w[g, s]      = bf16(p[g, s] * v_scale[b, h, s])   (the Pallas kernel rounds here too)
//   out[b, g, h, :] = sum_s w[g, s] * v[b, s, h, :]                       fp32
// Layouts are the JAX package's flat ones: q (B, G, D) bf16, k and v
// (B, S, D) int8 or bf16, scales (B, H, S) fp32, out (B, G, D) fp32, with
// D = H * 64.
//
// What bounds it on the card: bytes. At large-v2 batch 8 a call reads
// 30.7 MB of int8 K/V and 1.9 MB of scales, about 9.8 us at 3.35 TB/s, for
// about 0.12 GFLOP. So K and V are each read from device memory exactly
// once, nothing of size S goes back to device memory, and all of a block's
// bytes are requested at once, so that memory latency is paid once per
// block and not once per chunk.
//
// Design:
//  - The TPU grid (B,) runs in order on one core. Here S is also split:
//    each (b, h) gets a thread-block cluster of SPLIT = ceil(S / 256) <= 8
//    CTAs, each owning ROWS = ceil(S / SPLIT) consecutive positions (960
//    CTAs of 256 threads at B = 8, H = 20, S = 1500).
//  - At entry a CTA issues cp.async copies of its K rows and both scale
//    rows (one group) and its V rows (a second group) into shared memory,
//    so V arrives while the logits and the softmax are computed. Rows are
//    padded by 16 bytes so the 16-byte reads of consecutive rows hit
//    distinct banks.
//  - Query rows are taken GT = 8 at a time (a decode step has G = 5 beams;
//    a prompt may have more). Per block of rows: logits of the CTA's
//    positions into shared memory; the softmax's max and sum combined across
//    the cluster through distributed shared memory, in rank order; the
//    weights rounded to bf16; the CTA's partial weighted sum of V; the
//    partials summed across the cluster in rank order. Deterministic: no
//    atomics, no workspace, one launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int DH = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GT = 8;             // query rows per block of rows
constexpr int ROWS_PER_CTA = 256;  // positions per CTA before S is split further
constexpr int MAX_SPLIT = 8;      // portable thread-block cluster size
constexpr int CGROUPS = DH / 4;   // phase-3 column groups of 4 values (16)
constexpr int RGROUPS = THREADS / CGROUPS;  // phase-3 row groups (16)

template <typename T>
__host__ __device__ constexpr int row_stride() {  // padded shared-memory row, bytes
  return DH * static_cast<int>(sizeof(T)) + 16;
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Shared-memory layout of one CTA owning `rows` positions (byte offsets).
struct Layout {
  size_t k, v, ks, vs, lg, qs, red, part, mx, sm, total;
  __host__ __device__ Layout(int rows, int stride) {
    k = 0;
    v = k + align16(static_cast<size_t>(rows) * stride);
    ks = v + align16(static_cast<size_t>(rows) * stride);
    vs = ks + align16(rows * sizeof(float));
    lg = vs + align16(rows * sizeof(float));
    qs = lg + align16(static_cast<size_t>(GT) * rows * sizeof(float));
    red = qs + GT * DH * sizeof(float);
    part = red + WARPS * GT * DH * sizeof(float);
    mx = part + GT * DH * sizeof(float);
    sm = mx + GT * sizeof(float);
    total = sm + GT * sizeof(float);
  }
};

__host__ __device__ inline int split_of(int S) {
  const int s = (S + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  return s < MAX_SPLIT ? s : MAX_SPLIT;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four signed bytes of `word` as exact floats without int-to-float
// conversions (a quarter-rate instruction): each byte, biased to unsigned,
// becomes the low mantissa bits of 2^23, and one subtraction removes 2^23
// and the bias.
__device__ __forceinline__ void i8x4_to_f32(int word, float* r) {
  const unsigned u = static_cast<unsigned>(word) ^ 0x80808080u;
#pragma unroll
  for (int t = 0; t < 4; ++t) r[t] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | t)) - 8388736.0f;
}

__device__ __forceinline__ float lo_bf16(int word) {
  return __uint_as_float(static_cast<uint32_t>(word) << 16);
}
__device__ __forceinline__ float hi_bf16(int word) {
  return __uint_as_float(static_cast<uint32_t>(word) & 0xffff0000u);
}

// The 16-byte piece `p` of a head row (in shared memory) into fp32 registers:
// 16 values of int8, 8 of bf16.
template <typename T>
__host__ __device__ constexpr int piece_values() {
  return 16 / static_cast<int>(sizeof(T));
}
__device__ __forceinline__ void load_piece(const int8_t* row, int p, float* r) {
  const int4 c = reinterpret_cast<const int4*>(row)[p];
  i8x4_to_f32(c.x, r);
  i8x4_to_f32(c.y, r + 4);
  i8x4_to_f32(c.z, r + 8);
  i8x4_to_f32(c.w, r + 12);
}
__device__ __forceinline__ void load_piece(const __nv_bfloat16* row, int p, float* r) {
  const int4 c = reinterpret_cast<const int4*>(row)[p];
  const int words[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j * 2] = lo_bf16(words[j]);
    r[j * 2 + 1] = hi_bf16(words[j]);
  }
}

// Four consecutive values of a row (in shared memory) into fp32 registers.
__device__ __forceinline__ void load4(const int8_t* p, float* r) {
  i8x4_to_f32(*reinterpret_cast<const int*>(p), r);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* r) {
  const int2 words = *reinterpret_cast<const int2*>(p);
  r[0] = lo_bf16(words.x);
  r[1] = hi_bf16(words.x);
  r[2] = lo_bf16(words.y);
  r[3] = hi_bf16(words.y);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_attn_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, float* __restrict__ out, int G, int S,
                  int H) {
  constexpr int STRIDE = row_stride<T>();
  constexpr int PIECES = DH * static_cast<int>(sizeof(T)) / 16;  // 16-byte pieces per row
  constexpr int PV = piece_values<T>();
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = gridDim.x;  // one cluster spans the grid's x dimension
  const int rank = static_cast<int>(cluster.block_rank());
  const int max_rows = (S + split - 1) / split;
  const Layout L(max_rows, STRIDE);
  unsigned char* kbuf = smem + L.k;
  unsigned char* vbuf = smem + L.v;
  float* kss = reinterpret_cast<float*>(smem + L.ks);
  float* vss = reinterpret_cast<float*>(smem + L.vs);
  float* lg = reinterpret_cast<float*>(smem + L.lg);  // GT x max_rows logits, then weights
  float* qs = reinterpret_cast<float*>(smem + L.qs);  // GT x DH queries
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* part = reinterpret_cast<float*>(smem + L.part);  // this CTA's GT x DH partial output
  float* mx = reinterpret_cast<float*>(smem + L.mx);
  float* sm = reinterpret_cast<float*>(smem + L.sm);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = rank * max_rows;
  const int rows = max(0, min(S, s0 + max_rows) - s0);
  const T* kb = k + ((size_t)b * S + s0) * D + h * DH;
  const T* vb = v + ((size_t)b * S + s0) * D + h * DH;
  const float* ksb = k_scale + ((size_t)b * H + h) * S + s0;
  const float* vsb = v_scale + ((size_t)b * H + h) * S + s0;

  // Every byte this CTA reads is requested here: K and the scales, then V.
  for (int i = tid; i < rows * PIECES; i += THREADS) {
    const int r = i / PIECES, p = i % PIECES;
    cp_async16(kbuf + r * STRIDE + p * 16, reinterpret_cast<const unsigned char*>(kb + (size_t)r * D) + p * 16);
  }
  for (int i = tid; i < rows; i += THREADS) {
    cp_async4(kss + i, ksb + i);
    cp_async4(vss + i, vsb + i);
  }
  cp_async_commit();
  for (int i = tid; i < rows * PIECES; i += THREADS) {
    const int r = i / PIECES, p = i % PIECES;
    cp_async16(vbuf + r * STRIDE + p * 16, reinterpret_cast<const unsigned char*>(vb + (size_t)r * D) + p * 16);
  }
  cp_async_commit();

  for (int g0 = 0; g0 < G; g0 += GT) {
    const int gn = min(GT, G - g0);
    for (int i = tid; i < GT * DH; i += THREADS) {
      const int gi = i / DH;
      qs[i] = gi < gn ? __bfloat162float(q[((size_t)b * G + g0 + gi) * D + h * DH + i % DH]) : 0.0f;
    }
    cp_async_wait<1>();  // this thread's K and scale copies have landed
    __syncthreads();     // ... everyone's, and the queries

    // Phase 1: logits of this CTA's positions, a whole key row per thread.
    for (int r = tid; r < rows; r += THREADS) {
      const T* row = reinterpret_cast<const T*>(kbuf + r * STRIDE);
      float acc[GT];
#pragma unroll
      for (int gi = 0; gi < GT; ++gi) acc[gi] = 0.0f;
#pragma unroll
      for (int p = 0; p < PIECES; ++p) {
        float kv[PV];
        load_piece(row, p, kv);
#pragma unroll
        for (int gi = 0; gi < GT; ++gi) {
          if (gi < gn) {
            const float4* q4 = reinterpret_cast<const float4*>(qs + gi * DH + p * PV);
#pragma unroll
            for (int j = 0; j < PV / 4; ++j) {
              const float4 qq = q4[j];
              acc[gi] = fmaf(qq.x, kv[4 * j], acc[gi]);
              acc[gi] = fmaf(qq.y, kv[4 * j + 1], acc[gi]);
              acc[gi] = fmaf(qq.z, kv[4 * j + 2], acc[gi]);
              acc[gi] = fmaf(qq.w, kv[4 * j + 3], acc[gi]);
            }
          }
        }
      }
      const float ks = kss[r];
#pragma unroll
      for (int gi = 0; gi < GT; ++gi) {
        if (gi < gn) lg[gi * max_rows + r] = acc[gi] * ks;
      }
    }
    __syncthreads();

    // Phase 2: softmax over all S positions, one warp per query row; the
    // max and the sum are combined across the cluster in rank order.
    for (int gi = warp; gi < gn; gi += WARPS) {
      float m = -INFINITY;
      for (int r = lane; r < rows; r += 32) m = fmaxf(m, lg[gi * max_rows + r]);
      m = warp_max(m);
      if (lane == 0) mx[gi] = m;
    }
    cluster.sync();
    for (int gi = warp; gi < gn; gi += WARPS) {
      float m = -INFINITY;
      for (int c = 0; c < split; ++c) m = fmaxf(m, cluster.map_shared_rank(mx, c)[gi]);
      float s = 0.0f;
      for (int r = lane; r < rows; r += 32) {
        const float e = expf(lg[gi * max_rows + r] - m);
        lg[gi * max_rows + r] = e;
        s += e;
      }
      s = warp_sum(s);
      if (lane == 0) sm[gi] = s;
    }
    cluster.sync();
    for (int gi = warp; gi < gn; gi += WARPS) {
      float s = 0.0f;
      for (int c = 0; c < split; ++c) s += cluster.map_shared_rank(sm, c)[gi];
      for (int r = lane; r < rows; r += 32) {
        float* w = lg + gi * max_rows + r;
        *w = __bfloat162float(__float2bfloat16_rn((*w / s) * vss[r]));
      }
    }
    cp_async_wait<0>();  // this thread's V copies have landed
    __syncthreads();     // ... everyone's, and the weights

    // Phase 3: this CTA's partial weighted sum of V. Thread = (row group,
    // four columns); the row groups are summed through shared memory.
    const int rg = tid / CGROUPS;
    const int d0 = (tid % CGROUPS) * 4;
    float acc[GT][4];
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[gi][t] = 0.0f;
    }
    for (int r = rg; r < rows; r += RGROUPS) {
      float vr[4];
      load4(reinterpret_cast<const T*>(vbuf + r * STRIDE) + d0, vr);
#pragma unroll
      for (int gi = 0; gi < GT; ++gi) {
        if (gi < gn) {
          const float wgt = lg[gi * max_rows + r];
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[gi][t] = fmaf(wgt, vr[t], acc[gi][t]);
        }
      }
    }
    // Lanes l and l + 16 of a warp hold two row groups of the same columns.
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[gi][t] += __shfl_down_sync(0xffffffffu, acc[gi][t], 16);
    }
    if (lane < 16) {
#pragma unroll
      for (int gi = 0; gi < GT; ++gi) {
#pragma unroll
        for (int t = 0; t < 4; ++t) red[(warp * GT + gi) * DH + d0 + t] = acc[gi][t];
      }
    }
    __syncthreads();
    for (int i = tid; i < GT * DH; i += THREADS) {
      float a = 0.0f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) a += red[wi * GT * DH + i];
      part[i] = a;
    }
    cluster.sync();  // every CTA's partial output is in its shared memory

    // The cluster's partials summed in rank order; CTA `rank` writes every
    // split-th value. The loads are independent, so their latencies overlap.
    for (int i = rank * THREADS + tid; i < gn * DH; i += split * THREADS) {
      float pv[MAX_SPLIT];
#pragma unroll
      for (int c = 0; c < MAX_SPLIT; ++c) pv[c] = c < split ? cluster.map_shared_rank(part, c)[i] : 0.0f;
      float a = 0.0f;
#pragma unroll
      for (int c = 0; c < MAX_SPLIT; ++c) a += pv[c];
      out[((size_t)b * G + g0 + i / DH) * D + h * DH + i % DH] = a;
    }
    cluster.sync();  // no CTA moves on (or leaves) while another reads its shared memory
  }
}

template <typename T>
size_t smem_bytes(int S) {
  const int split = split_of(S);
  return Layout((S + split - 1) / split, row_stride<T>()).total;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   void* out, int B, int G, int S, int H, cudaStream_t stream) {
  auto kern = cross_attn_kernel<T>;
  const int split = split_of(S);
  const size_t smem = smem_bytes<T>(S);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<float*>(out), G, S, H);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a launch needs; the caller checks it against the
// card's per-block limit before launching.
extern "C" long long cross_attn_smem_bytes(int S, int kv_int8) {
  return static_cast<long long>(kv_int8 ? smem_bytes<int8_t>(S) : smem_bytes<__nv_bfloat16>(S));
}

// The caller (whisperx_tpu_torch/ops/cross_attn.py) checks shapes, types,
// contiguity and 16-byte alignment. kv_int8 selects int8 (1) or bf16 (0) K/V.
extern "C" int cross_attn(const void* q, const void* k, const void* v, const void* k_scale,
                          const void* v_scale, void* out, int B, int G, int S, int H, int kv_int8,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      kv_int8 ? launch<int8_t>(q, k, v, k_scale, v_scale, out, B, G, S, H, st)
              : launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, out, B, G, S, H, st);
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
