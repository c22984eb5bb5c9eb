// Weight-only int8 matmul for the decode path, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel whisperx_tpu/ops/pallas_int8_mm.py:int8_matmul:
//   y = (bf16(x) @ bf16(w_int8)) accumulated in fp32,
//       then * scale[N] + bias[N] in fp32, stored as bf16 or fp32.
// x is (M, K) bf16 with M <= 256, w is (K, N) int8 row-major (the layout the
// JAX package stores), scale and bias are (N,) fp32.
//
// What bounds it on the card: bytes. At the large-v2 decode shapes (M = 40
// rows = batch 8 x 5 beams; K x N up to 1280 x 5120) the int8 weight is
// 1.6-6.5 MB and is read once per call, about 2 us of HBM at 3.35 TB/s, while
// the 2*M*K*N products are a fraction of a microsecond on the bf16 tensor
// cores. So the weight is read exactly once, as int8, and converted to bf16
// only on chip, and as much of it as possible is in flight at once: a call
// is short enough that memory latency, not bandwidth, is what a simple kernel
// loses to.
//
// Design (simple first; TMA and wgmma are later work):
//  - CTA tile 64 rows x 64 columns, 4 warps. Each warp owns 16 columns and
//    all four 16-row fragments: bf16 WMMA (mma.sync 16x16x16) with fp32
//    accumulators. Fragments wholly beyond M are skipped; rows beyond M are
//    zero in shared memory and never stored.
//  - 64-deep K tiles stream through a 3-stage cp.async ring (int8 weight
//    tile 64 x 64 B, coalesced along N; bf16 x tile), so two tiles are in
//    flight while the tensor cores work on a third. Each int8 tile is
//    converted to bf16 in shared memory before its MMAs.
//  - The TPU grid (N/512,) runs in order on one core; on 132 SMs that would
//    leave most of the card idle (at M = 40, N = 1280 there are only 20
//    output tiles). Here K is also split across up to 8 CTAs (grid.z) until
//    the grid holds about two CTAs per SM. The splits of one output tile form
//    a thread-block cluster: after the main loop each CTA's fp32 partial tile
//    sits in its shared memory, and the CTAs of the cluster sum the partials
//    through distributed shared memory in a fixed order (deterministic, no
//    atomics, no workspace, no second kernel) and apply scale and bias.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cg = cooperative_groups;
using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr int STAGES = 3;
constexpr int MAX_SPLITS = 8;  // portable thread-block cluster size
constexpr int LDX = BK + 8;    // bf16 per shared row of an x tile (padding breaks bank conflicts)
constexpr int LDW = BN + 8;    // bf16 per shared row of the converted weight tile
constexpr int LDC = BN + 4;    // floats per shared row of the output tile
constexpr int XS_BYTES = STAGES * BM * LDX * 2;
constexpr int WRAW_BYTES = STAGES * BK * BN;
constexpr int WB_BYTES = BK * LDW * 2;
constexpr int SMEM_BYTES = XS_BYTES + WRAW_BYTES + WB_BYTES;  // 48 KB: static shared memory
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");
static_assert(BM * LDC * 4 <= XS_BYTES, "the output tile reuses the x stages");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store_out(float v, __nv_bfloat16* out, size_t i) {
  out[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_out(float v, float* out, size_t i) { out[i] = v; }

// Two signed bytes of `word` (bytes 2*half and 2*half+1) as a packed bf16
// pair, exactly, without int-to-float conversions (a quarter-rate
// instruction): each byte, biased to unsigned, becomes the low mantissa bits
// of 2^23, one subtraction removes 2^23 and the bias, and one cvt packs the
// pair.
__device__ __forceinline__ uint32_t bf16x2_of_i8(int word, int half) {
  const unsigned u = static_cast<unsigned>(word) ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | (2 * half))) - 8388736.0f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | (2 * half + 1))) - 8388736.0f;
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
int8_mm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               OutT* __restrict__ out, int M, int K, int N, int tiles_per_split) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* wraw = reinterpret_cast<int8_t*>(smem + XS_BYTES);
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem + XS_BYTES + WRAW_BYTES);
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);
  const int m_frags = (rows + 15) / 16;
  const int kt_begin = blockIdx.z * tiles_per_split;
  const int n_tiles = min(K / BK, kt_begin + tiles_per_split) - kt_begin;

  // x rows beyond M stay zero in every stage (cp.async never writes them).
  for (int i = tid; i < STAGES * BM * (BK / 8); i += THREADS) {
    const int r = (i / (BK / 8)) % BM;
    if (r >= rows) {
      *reinterpret_cast<int4*>(xs + (i / (BK / 8)) * LDX + (i % (BK / 8)) * 8) = make_int4(0, 0, 0, 0);
    }
  }

  // Tile t of this split (global K tile kt_begin + t) into ring slot t % STAGES.
  // Every call commits one group, empty past the last tile, so the group
  // count per iteration stays uniform.
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int kt = kt_begin + t;
      const int slot = t % STAGES;
      for (int c = tid; c < rows * (BK / 8); c += THREADS) {
        const int r = c / (BK / 8);
        const int col = (c % (BK / 8)) * 8;
        cp_async16(xs + (slot * BM + r) * LDX + col, x + (size_t)(m0 + r) * K + kt * BK + col);
      }
      for (int c = tid; c < BK * (BN / 16); c += THREADS) {
        const int r = c / (BN / 16);
        const int col = (c % (BN / 16)) * 16;
        cp_async16(wraw + (slot * BK + r) * BN + col, w + (size_t)(kt * BK + r) * N + n0 + col);
      }
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) wmma::fill_fragment(acc[i], 0.0f);

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and tile t-1's MMAs are done
    issue(t + STAGES - 1);        // refills the slot tile t-1 used
    const int slot = t % STAGES;
    for (int c = tid; c < BK * (BN / 16); c += THREADS) {
      const int r = c / (BN / 16);
      const int col = (c % (BN / 16)) * 16;
      const int4 q = *reinterpret_cast<const int4*>(wraw + (slot * BK + r) * BN + col);
      uint4* dst = reinterpret_cast<uint4*>(wb + r * LDW + col);
      dst[0] = make_uint4(bf16x2_of_i8(q.x, 0), bf16x2_of_i8(q.x, 1), bf16x2_of_i8(q.y, 0),
                          bf16x2_of_i8(q.y, 1));
      dst[1] = make_uint4(bf16x2_of_i8(q.z, 0), bf16x2_of_i8(q.z, 1), bf16x2_of_i8(q.w, 0),
                          bf16x2_of_i8(q.w, 1));
    }
    __syncthreads();
    const __nv_bfloat16* xt = xs + slot * BM * LDX;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfrag;
      wmma::load_matrix_sync(bfrag, wb + kk * LDW + warp * 16, LDW);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        if (i < m_frags) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afrag;
          wmma::load_matrix_sync(afrag, xt + i * 16 * LDX + kk, LDX);
          wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // all MMAs done before the output tile overwrites the x stages

#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    if (i < m_frags) {
      wmma::store_matrix_sync(cs + i * 16 * LDC + warp * 16, acc[i], LDC, wmma::mem_row_major);
    }
  }

  const int splits = gridDim.z;
  if (splits == 1) {
    __syncthreads();
    for (int e = tid; e < rows * BN; e += THREADS) {
      const int r = e / BN;
      const int n = n0 + e % BN;
      const float v = cs[r * LDC + e % BN];
      store_out(v * scale[n] + (bias != nullptr ? bias[n] : 0.0f), out, (size_t)(m0 + r) * N + n);
    }
    return;
  }

  // The splits of this output tile are one cluster: CTA `rank` sums rows
  // rank, rank + splits, ... over all splits' partial tiles, in rank order.
  // The remote loads of one value are independent, so their latencies
  // overlap.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial tile is in its CTA's shared memory
  const int rank = static_cast<int>(cluster.block_rank());
  const float* parts[MAX_SPLITS];
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s) parts[s] = cluster.map_shared_rank(cs, s < splits ? s : 0);
  const int my_rows = rank < rows ? (rows - rank + splits - 1) / splits : 0;
  for (int e = tid; e < my_rows * BN; e += THREADS) {
    const int r = rank + (e / BN) * splits;
    const int c = e % BN;
    float p[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) p[s] = s < splits ? parts[s][r * LDC + c] : 0.0f;
    float v = 0.0f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) v += p[s];
    const int n = n0 + c;
    store_out(v * scale[n] + (bias != nullptr ? bias[n] : 0.0f), out, (size_t)(m0 + r) * N + n);
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

template <typename OutT>
cudaError_t launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
                   int M, int K, int N, int splits, int tiles_per_split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN, (M + BM - 1) / BM, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_mm_kernel<OutT>, static_cast<const __nv_bfloat16*>(x),
                            static_cast<const int8_t*>(w), static_cast<const float*>(scale),
                            static_cast<const float*>(bias), static_cast<OutT*>(out), M, K, N,
                            tiles_per_split);
}

}  // namespace

// The caller (whisperx_tpu_torch/ops/int8_mm.py) checks shapes, types,
// contiguity and 16-byte alignment: K % 64 == 0, N % 64 == 0, 1 <= M <= 256,
// 1 <= splits <= 8 with every split holding at least one K tile. `bias` may
// be null.
extern "C" int int8_mm(const void* x, const void* w, const void* scale, const void* bias,
                       void* out, int M, int K, int N, int splits, int tiles_per_split,
                       int out_bf16, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      out_bf16 ? launch<__nv_bfloat16>(x, w, scale, bias, out, M, K, N, splits, tiles_per_split, st)
               : launch<float>(x, w, scale, bias, out, M, K, N, splits, tiles_per_split, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
