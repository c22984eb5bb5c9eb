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
// 0.12 GFLOP. On the CUDA cores those products (154 M FMAs and 31 M int8
// conversions) would take 5-7 us of the card's whole fp32 issue rate, so
// they go to the tensor cores, and the memory pipe must never wait for them:
//  - One wave. Each (b, h) is a thread-block cluster of C CTAs, each owning
//    a 64-aligned range of at least ~256 positions (C from
//    ops/cross_attn.py:launch_plan: the largest split whose clusters the
//    card holds all at once, as cross_attn_max_clusters asks it; 4 at the
//    flagship: 640 CTAs of 128 threads and ~36 KB, five an SM, 186 clusters
//    held). With a 6-slot ring (43 KB) the card held 154 of the 160, and
//    the second wave cost half the time again.
//  - A CTA streams its K chunks (64 positions x 64 dims) and then its V
//    chunks through a ring of RING slots by TMA (3-D tensor maps over the
//    flat (B, S, D) view, 64- or 128-byte swizzle, encoded once per K/V
//    buffer and cached on the host), one full and one empty mbarrier per
//    slot. The scales and the first RING chunks are requested at the
//    kernel's first instructions; each chunk consumed frees its slot for the
//    next, so V arrives while the logits and the softmax run. Shared memory
//    no longer grows with S except for the fp32 logits (8 x positions per CTA).
//  - Both products are bf16 mma.sync m16n8k16 with fp32 accumulation, G on
//    the narrow side: logits^T = K q^T (16 positions x 8 query rows) and
//    out^T = V^T w^T (16 dims x 8 query rows). q is bf16 and int8 -> bf16 is
//    exact, so the products are the Pallas kernel's. wgmma's 64-row minimum
//    would be 92% padding at G = 5; an n8 column pads G = 5 to 8. Query rows
//    go 8 at a time (any G; K and V are streamed again for each 8).
//  - No shared-memory copy for layouts: K rows are already the A operand of
//    K q^T (a lane reads 16 dims of two positions in one load; the
//    contraction over dims is permuted alike in q). For V^T the lane reads
//    32-bit words of four positions and byte-permutes them into the A
//    fragments (int8: four dims; bf16: two), as in int8_mm.cu.
//  - The exact two-pass softmax of the plain version: each CTA keeps
//    exp(l - m) of its positions and sends its (max m, sum) pairs to every
//    CTA of the cluster; after one cluster barrier each rescales the sums to
//    the global max M in rank order and rounds w = bf16(exp(l - m) exp(m - M)
//    / sum * v_scale) with the global max and sum over all S (the factor is
//    exactly 1 with one CTA per (b, h), so w is then the plain version's to
//    the bit). Each CTA sends its partial output to the outputs' owners;
//    after a second barrier each owner sums them in rank order. Two cluster
//    exchanges per 8 query rows, deterministic, no atomics, one launch.
// What limits it now (kernel_trace.py on an H100): not bytes (the loads are
// in by ~10 us of ~29) but the serial phases of each CTA at five CTAs an SM:
// the logits, the softmax passes and P V each take 4-6 us of issue-bound
// work (int8 conversion, exp, MMA), with a cluster barrier between them.

#include <cooperative_groups.h>
#include <math.h>

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using namespace hopper;

namespace {

constexpr int DH = 64;
constexpr int CHUNK = 64;          // positions per TMA box
constexpr int WARPS = 4;           // one 16-position tile of each chunk per warp
constexpr int THREADS = WARPS * 32;
constexpr int QB = 8;              // query rows per pass: one n8 column
constexpr int RING = 4;            // chunk slots
constexpr int MAX_CLUSTER = 8;     // portable thread-block cluster size
constexpr int RECV_FLOATS = QB * DH + MAX_CLUSTER;  // n_ranks x ceil(512 / n_ranks), at most
constexpr int SMEM_LIMIT = 232448;

template <typename T>
struct Kv;
template <>
struct Kv<int8_t> {  // 64-byte rows, 64-byte swizzle (bits 7-8 into 4-5)
  static constexpr int ROW = 64;
  static constexpr int SWZ_MASK = 3;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr CUtensorMapDataType DTYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
template <>
struct Kv<__nv_bfloat16> {  // 128-byte rows, 128-byte swizzle (bits 7-9 into 4-6)
  static constexpr int ROW = 128;
  static constexpr int SWZ_MASK = 7;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr CUtensorMapDataType DTYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// The byte of a TMA-swizzled chunk (1,024-byte aligned) at logical offset `off`.
template <typename T>
__device__ __forceinline__ int swz(int off) {
  return off ^ (((off >> 7) & Kv<T>::SWZ_MASK) << 4);
}

// Shared-memory layout of a CTA owning up to `rows_pad` positions (byte
// offsets from a 1,024-byte aligned base).
struct Layout {
  size_t ring, lg, ks, vs, recv, xch, full, empty, total;
  int lgs;  // floats per logits row
  __host__ __device__ Layout(int rows_pad, int row_bytes) {
    lgs = rows_pad + 4;  // + 4: the logit stores of a warp hit distinct banks
    ring = 0;
    lg = ring + static_cast<size_t>(RING) * CHUNK * row_bytes;
    // The logits, then the bf16 weights (a packed pair in the slot of each
    // even position), then the warps' partial outputs.
    const size_t lg_bytes = static_cast<size_t>(QB) * lgs * 4;
    const size_t red_bytes = static_cast<size_t>(WARPS) * QB * DH * 4;
    ks = lg + (lg_bytes > red_bytes ? lg_bytes : red_bytes);
    vs = ks + static_cast<size_t>(rows_pad) * 4;
    recv = vs + static_cast<size_t>(rows_pad) * 4;  // partial outputs from the cluster
    xch = recv + RECV_FLOATS * 4;                   // (max, sum) pairs from the cluster
    full = xch + MAX_CLUSTER * QB * 2 * 4;
    empty = full + RING * 8;
    total = empty + RING * 8 + 1024;  // + room to align the base
  }
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem));
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

// A fragments of K (16 positions x 16 dims, k16 step j) for positions g and
// g + 8 of a tile. The lane holds dims 16c .. 16c + 15 of both rows; step j
// contracts dims 16c + 4j .. 16c + 4j + 3 over the four lanes c (the same
// permutation as the q fragments).
__device__ __forceinline__ void k_rows(const uint8_t* tile, int g, int c, const int8_t*, uint32_t (&r)[2][8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int off = (g + 8 * h) * 64 + c * 16;
    const uint4 u = *reinterpret_cast<const uint4*>(tile + swz<int8_t>(off));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) bf16x4_of_i8x4(w[j], r[h][2 * j], r[h][2 * j + 1]);
  }
}
__device__ __forceinline__ void k_rows(const uint8_t* tile, int g, int c, const __nv_bfloat16*, uint32_t (&r)[2][8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int off = (g + 8 * h) * 128 + c * 32 + p * 16;
      const uint4 u = *reinterpret_cast<const uint4*>(tile + swz<__nv_bfloat16>(off));
      r[h][4 * p] = u.x;
      r[h][4 * p + 1] = u.y;
      r[h][4 * p + 2] = u.z;
      r[h][4 * p + 3] = u.w;
    }
  }
}

// A fragments of V^T (16 dims x 16 positions of a tile) for the four MMAs
// of the tile, from 32-bit words of positions 2c, 2c+1, 2c+8, 2c+9.
// int8: a word holds dims 32e + 4g .. + 3 (e = 0, 1): MMA 2e + s takes dims
// 32e + 4g + 2s (row g) and + 1 (row g + 8).
// bf16: a word holds dims 16e + 2g, + 1 (e = 0..3): MMA e takes them as
// rows g and g + 8.
__device__ __forceinline__ void v_frags(const uint8_t* tile, int g, int c, const int8_t*, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    uint32_t w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = 2 * c + (t & 1) + (t >> 1) * 8;
      w[t] = *reinterpret_cast<const uint32_t*>(tile + swz<int8_t>(r * 64 + e * 32 + 4 * g));
    }
    bf16x4_of_i8x4(__byte_perm(w[0], w[1], 0x5140), a[2 * e][0], a[2 * e][1]);
    bf16x4_of_i8x4(__byte_perm(w[2], w[3], 0x5140), a[2 * e][2], a[2 * e][3]);
    bf16x4_of_i8x4(__byte_perm(w[0], w[1], 0x7362), a[2 * e + 1][0], a[2 * e + 1][1]);
    bf16x4_of_i8x4(__byte_perm(w[2], w[3], 0x7362), a[2 * e + 1][2], a[2 * e + 1][3]);
  }
}
__device__ __forceinline__ void v_frags(const uint8_t* tile, int g, int c, const __nv_bfloat16*,
                                        uint32_t (&a)[4][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = 2 * c + (t & 1) + (t >> 1) * 8;
      w[t] = *reinterpret_cast<const uint32_t*>(tile + swz<__nv_bfloat16>(r * 128 + e * 32 + 4 * g));
    }
    a[e][0] = __byte_perm(w[0], w[1], 0x5410);
    a[e][1] = __byte_perm(w[0], w[1], 0x7632);
    a[e][2] = __byte_perm(w[2], w[3], 0x5410);
    a[e][3] = __byte_perm(w[2], w[3], 0x7632);
  }
}
// The head dim of row g (h = 0) or g + 8 (h = 1) of MMA t, as v_frags lays them.
__device__ __forceinline__ int v_dim(int t, int g, int h, const int8_t*) { return 32 * (t >> 1) + 4 * g + 2 * (t & 1) + h; }
__device__ __forceinline__ int v_dim(int t, int g, int h, const __nv_bfloat16*) { return 16 * t + 2 * g + h; }

template <typename T>
__global__ void __launch_bounds__(THREADS, 5)  // <= 102 registers: five CTAs an SM
cross_attn_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const __nv_bfloat16* __restrict__ q, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, float* __restrict__ out, int G, int S, int H, int rows_pad) {
  constexpr int CHUNK_BYTES = CHUNK * Kv<T>::ROW;
  const T* tag = nullptr;  // selects the int8 or bf16 overloads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L(rows_pad, Kv<T>::ROW);
  uint8_t* ring = smem + L.ring;
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  uint32_t* wt = reinterpret_cast<uint32_t*>(lg);  // bf16 weight pairs, same slots
  float* red = lg;                                 // the warps' partial outputs, after the weights
  float* kss = reinterpret_cast<float*>(smem + L.ks);
  float* vss = reinterpret_cast<float*>(smem + L.vs);
  float* recv = reinterpret_cast<float*>(smem + L.recv);  // [source rank][output / n_ranks]
  float* xch = reinterpret_cast<float*>(smem + L.xch);    // [source rank][query row][max, sum]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + L.empty);
  const int lgs = L.lgs;
  stamp(0);
  cluster_arrive_relaxed();  // waited for before the first remote store

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int s0 = rank * rows_pad;
  const int rows = min(rows_pad, S - s0);  // >= 1: the launch plan leaves no CTA empty
  const int n_chunks = (rows + CHUNK - 1) / CHUNK;
  const int passes = (G + QB - 1) / QB;
  const int n_loads = passes * 2 * n_chunks;  // per pass: K chunks, then V chunks

  // Load i of the stream goes to slot i % RING.
  auto issue = [&](int i) {
    const int slot = i % RING;
    const int j = i % (2 * n_chunks);
    const bool is_v = j >= n_chunks;
    mbar_arrive_expect_tx(&full[slot], CHUNK_BYTES);
    tma_load_3d(ring + slot * CHUNK_BYTES, is_v ? &tv : &tk, &full[slot], h * DH,
                s0 + (is_v ? j - n_chunks : j) * CHUNK, b);
  };
  // The scales first (the logits wait for them), then the first RING chunks.
  const float* ksb = k_scale + (static_cast<size_t>(b) * H + h) * S + s0;
  const float* vsb = v_scale + (static_cast<size_t>(b) * H + h) * S + s0;
  for (int i = tid; i < rows; i += THREADS) {
    cp_async4(kss + i, ksb + i);
    cp_async4(vss + i, vsb + i);
  }
  if (tid == 0) {
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    for (int i = 0; i < RING; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WARPS);
    }
    mbar_fence_init();
    for (int i = 0; i < min(RING, n_loads); ++i) issue(i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  stamp(1);

  // Consume load i (the warp's tile of it through `use`), release the slot,
  // and let warp 0 refill it with load i + RING once every warp is done.
  int load = 0;
  auto consume = [&](auto use) {
    const int slot = load % RING;
    mbar_wait(&full[slot], (load / RING) & 1);
    use(ring + slot * CHUNK_BYTES);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (warp == 0 && load + RING < n_loads) {
      mbar_wait(&empty[slot], (load / RING) & 1);
      if (lane == 0) issue(load + RING);
      __syncwarp();
    }
    ++load;
  };

  for (int pass = 0; pass < passes; ++pass) {
    const int q0 = pass * QB;
    // B fragments of q^T: the lane's query row q0 + g, dims 16c .. 16c + 15.
    uint32_t qw[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (q0 + g < G) {
      const uint4* qp = reinterpret_cast<const uint4*>(q + (static_cast<size_t>(b) * G + q0 + g) * D + h * DH + 16 * c);
      const uint4 u0 = qp[0], u1 = qp[1];
      qw[0] = u0.x; qw[1] = u0.y; qw[2] = u0.z; qw[3] = u0.w;
      qw[4] = u1.x; qw[5] = u1.y; qw[6] = u1.z; qw[7] = u1.w;
    }

    // Logits of this warp's 16 positions of each K chunk, times k_scale.
    for (int j = 0; j < n_chunks; ++j) {
      consume([&](const uint8_t* chunk) {
        const int p0 = j * CHUNK + warp * 16;
        if (p0 >= rows) return;
        uint32_t kr[2][8];
        k_rows(chunk + warp * 16 * Kv<T>::ROW, g, c, tag, kr);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t a[4] = {kr[0][2 * s], kr[1][2 * s], kr[0][2 * s + 1], kr[1][2 * s + 1]};
          mma_bf16_16816(acc, a, qw[2 * s], qw[2 * s + 1]);
        }
        // acc: (position g, rows 2c, 2c+1), (position g + 8, rows 2c, 2c+1).
        const float k0 = kss[p0 + g], k1 = kss[p0 + g + 8];
        lg[(2 * c) * lgs + p0 + g] = acc[0] * k0;
        lg[(2 * c + 1) * lgs + p0 + g] = acc[1] * k0;
        lg[(2 * c) * lgs + p0 + g + 8] = acc[2] * k1;
        lg[(2 * c + 1) * lgs + p0 + g + 8] = acc[3] * k1;
      });
    }
    __syncthreads();
    stamp(2);

    // Softmax: this CTA's (max, sum) of each query row, warp w taking rows
    // 2w and 2w + 1, with exp(l - max) kept in place; each CTA sends its
    // pairs to every CTA of the cluster (exchange 1), and each rescales the
    // sums to the global max in rank order.
    if (pass == 0) cluster_wait();  // every CTA of the cluster has started
    for (int r = 2 * warp; r < 2 * warp + 2; ++r) {
      if (q0 + r >= G) continue;
      float* row = lg + r * lgs;
      float m = -INFINITY;
      for (int p = lane; p < rows; p += 32) m = fmaxf(m, row[p]);
      m = warp_max(m);
      float l = 0.0f;
      for (int p = lane; p < rows; p += 32) {
        const float e = expf(row[p] - m);
        row[p] = e;
        l += e;
      }
      l = warp_sum(l);
      if (lane < n_ranks) {
        float* x = cluster.map_shared_rank(xch, lane) + (rank * QB + r) * 2;
        x[0] = m;
        x[1] = l;
      }
    }
    cluster.sync();  // exchange 1: every CTA's (max, sum) pairs are in every CTA
    stamp(3);
    const int tiles_end = min(rows_pad, (rows + 15) / 16 * 16);  // positions the P V tiles read
    for (int r = 2 * warp; r < 2 * warp + 2; ++r) {
      if (q0 + r >= G) continue;
      float M = -INFINITY;
      for (int k = 0; k < n_ranks; ++k) M = fmaxf(M, xch[(k * QB + r) * 2]);
      float Ls = 0.0f;
      for (int k = 0; k < n_ranks; ++k) Ls += xch[(k * QB + r) * 2 + 1] * expf(xch[(k * QB + r) * 2] - M);
      // exp(l - M) = exp(l - m) * exp(m - M): the factor is exactly 1 where
      // this CTA holds the global max (always, with one CTA per (b, h)).
      const float f = expf(xch[(rank * QB + r) * 2] - M);
      // bf16(p * v_scale) of positions 2i, 2i + 1 into the slot of 2i; 0
      // beyond this CTA's positions.
      float* row = lg + r * lgs;
      for (int p = 2 * lane; p < tiles_end; p += 64) {
        const float w0 = p < rows ? (row[p] * f / Ls) * vss[p] : 0.0f;
        const float w1 = p + 1 < rows ? (row[p + 1] * f / Ls) * vss[p + 1] : 0.0f;
        const __nv_bfloat162 pair = __floats2bfloat162_rn(w0, w1);
        wt[r * lgs + p] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    }
    __syncthreads();
    stamp(4);

    // out^T += V^T w^T over this warp's 16 positions of each V chunk.
    float o[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.0f;
    }
    for (int j = 0; j < n_chunks; ++j) {
      consume([&](const uint8_t* chunk) {
        const int p0 = j * CHUNK + warp * 16;
        if (p0 >= rows) return;
        uint32_t a[4][4];
        v_frags(chunk + warp * 16 * Kv<T>::ROW, g, c, tag, a);
        const uint32_t b0 = wt[g * lgs + p0 + 2 * c];
        const uint32_t b1 = wt[g * lgs + p0 + 2 * c + 8];
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_bf16_16816(o[t], a[t], b0, b1);
      });
    }
    __syncthreads();  // every warp's weights are read: the region takes the partial outputs
    stamp(5);

    // o[t]: (dim of row g, query rows 2c, 2c+1), (dim of row g + 8, the same).
    float* rw = red + warp * QB * DH;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int d = v_dim(t, g, hh, tag);
        rw[(2 * c) * DH + d] = o[t][2 * hh];
        rw[(2 * c + 1) * DH + d] = o[t][2 * hh + 1];
      }
    }
    __syncthreads();
    // The CTA's partial output, sent to its owner: output i belongs to CTA
    // i % n_ranks, at [this rank][i / n_ranks] of its receive buffer.
    const int per = (QB * DH + n_ranks - 1) / n_ranks;
    for (int i = tid; i < QB * DH; i += THREADS) {
      float s = red[i];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += red[w * QB * DH + i];
      cluster.map_shared_rank(recv, i % n_ranks)[rank * per + i / n_ranks] = s;
    }
    cluster.sync();  // exchange 2: every partial output is in its owner
    stamp(6);

    // This CTA's outputs: the cluster's partials summed in rank order.
    for (int k = tid; k < per; k += THREADS) {
      const int i = k * n_ranks + rank;
      if (i >= QB * DH || q0 + i / DH >= G) continue;
      float s = recv[k];
      for (int src = 1; src < n_ranks; ++src) s += recv[src * per + k];
      out[(static_cast<size_t>(b) * G + q0 + i / DH) * D + h * DH + i % DH] = s;
    }
  }
  stamp(7);
}

// ---- host side ----

// Tensor maps of K/V buffers, encoded once each: a map holds only the
// address, shape and layout, so (address, B, S, D, type) names it exactly.
struct MapKey {
  uintptr_t p;
  int B, S, D, int8;
  bool operator==(const MapKey& o) const { return p == o.p && B == o.B && S == o.S && D == o.D && int8 == o.int8; }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<uintptr_t>()(k.p) ^ (static_cast<size_t>(k.S) << 24) ^ (static_cast<size_t>(k.B) << 12) ^
           static_cast<size_t>(k.D) ^ static_cast<size_t>(k.int8);
  }
};

// (B, S, D) as 3-D (D, S, B) with boxes of 64 dims x 64 positions x 1 under
// the type's swizzle. False if the driver refuses it.
template <typename T>
bool kv_map(const void* p, int B, int S, int D, CUtensorMap* map) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{reinterpret_cast<uintptr_t>(p), B, S, D, static_cast<int>(sizeof(T) == 1)};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * sizeof(T);
  const cuuint64_t strides[2] = {row, row * static_cast<cuuint64_t>(S)};
  const cuuint32_t box[3] = {DH, CHUNK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (fn(map, Kv<T>::DTYPE, 3, const_cast<void*>(p), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         Kv<T>::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  maps.emplace(key, *map);
  return true;
}

template <typename T>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 64) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(cross_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    // All of the SM's 228 KB as shared memory: five CTAs an SM.
    e = cudaFuncSetAttribute(cross_attn_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs, void* out, int B,
                   int G, int S, int H, int cluster, int rows_pad, cudaStream_t stream) {
  const int D = H * DH;
  CUtensorMap tk, tv;
  if (!kv_map<T>(k, B, S, D, &tk) || !kv_map<T>(v, B, S, D, &tv)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem<T>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Layout(rows_pad, Kv<T>::ROW).total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cross_attn_kernel<T>, tk, tv, static_cast<const __nv_bfloat16*>(q),
                         static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<float*>(out), G, S,
                         H, rows_pad);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int max_clusters(int rows_pad, int cluster) {
  if (allow_smem<T>() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Layout(rows_pad, Kv<T>::ROW).total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, cross_attn_kernel<T>, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace

// How many clusters of `cluster` CTAs owning `rows_pad` positions the card
// holds at once; clusters are placed within one GPC, so this can be fewer
// than the SM count allows. -1 on error.
extern "C" int cross_attn_max_clusters(int rows_pad, int cluster, int kv_int8) {
  return kv_int8 ? max_clusters<int8_t>(rows_pad, cluster) : max_clusters<__nv_bfloat16>(rows_pad, cluster);
}

// Dynamic shared memory of a CTA owning `rows_pad` positions.
extern "C" long long cross_attn_smem_bytes(int rows_pad, int kv_int8) {
  return static_cast<long long>(Layout(rows_pad, kv_int8 ? Kv<int8_t>::ROW : Kv<__nv_bfloat16>::ROW).total);
}

// The caller (whisperx_tpu_torch/ops/cross_attn.py) checks shapes, types,
// contiguity and 16-byte alignment, and passes its launch plan: `cluster`
// CTAs per (b, h), each owning `rows_pad` positions (a multiple of 64), the
// last at least one. kv_int8 selects int8 (1) or bf16 (0) K/V. Returns a
// cudaError_t.
extern "C" int cross_attn(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
                          void* out, int B, int G, int S, int H, int cluster, int rows_pad, int kv_int8,
                          void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || rows_pad < CHUNK || rows_pad % CHUNK != 0 ||
      (cluster - 1) * rows_pad >= S || cluster * rows_pad < S ||
      static_cast<int>(cross_attn_smem_bytes(rows_pad, kv_int8)) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      kv_int8 ? launch<int8_t>(q, k, v, k_scale, v_scale, out, B, G, S, H, cluster, rows_pad, st)
              : launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, out, B, G, S, H, cluster, rows_pad, st);
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
