// Weight-only int8 matmul for the decode path, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel whisperx_tpu/ops/pallas_int8_mm.py:int8_matmul:
//   y = (bf16(x) @ bf16(w_int8)) accumulated in fp32,
//       then * scale[N] + bias[N] in fp32, stored as bf16 or fp32.
// x is (M, K) bf16 with M <= 256, w is (K, N) int8 row-major (the layout the
// JAX package stores and the fallback matmul reads; nothing is prepacked),
// scale and bias are (N,) fp32.
//
// What bounds it on the card: bytes in principle, latency in practice. At
// the large-v2 decode shapes (M = 40 rows = batch 8 x 5 beams; K x N in
// {1280 x 3840, 1280 x 1280, 1280 x 5120, 5120 x 1280}) the int8 weight is
// 1.6-6.5 MB, 0.5-2 us of HBM at 3.35 TB/s, while the 2*M*K*N products take
// a fraction of a microsecond on the tensor cores. A call that short loses
// to DRAM latency unless every byte is in flight at once, so the design pays
// one DRAM round trip per call:
//  - Grid: (N / 128 channel slabs, M blocks of <= 64 rows, K splits), sized
//    by ops/int8_mm.py:launch_plan to about one CTA per SM and cut until the
//    card holds every cluster at once (it asks int8_mm_max_clusters: clusters
//    stay within a GPC, so 40 clusters of 3 do not fit where 132 CTAs
//    would). A CTA owns a 128-channel x (chunks x 64)-row slab of W, at most
//    80 KB at the decode shapes, which fits in shared memory whole.
//  - At its first instructions the CTA requests every byte it reads: one
//    thread a TMA box (64 rows x 128 bytes, 128-byte swizzle) per 64-row
//    chunk of W, through a tensor map encoded once per weight and cached on
//    the host; every thread its 16-byte cp.async pieces of x (x comes through
//    L2; every CTA reads its K range of it). Each chunk has its own mbarrier
//    (W's bytes plus one arrival per thread when its x pieces land), so the
//    products start on the first chunk while the rest are in flight. (Only a
//    K range too large for shared memory is loaded in passes.)
//  - Tensor cores with M on the narrow side (swap-AB): y^T = W^T x^T as bf16
//    mma.sync m16n8k16. 16 output channels form the M side of an MMA and the
//    M = 40 rows of x five n8 columns, so nothing is padded to 64 rows
//    (wgmma's 64-row side would take the channels, but its B operand, x,
//    would have to sit in its swizzled layout and its A, W, be converted
//    through shared memory or registers all the same).
//  - The transpose of W (two K values of one channel lie N bytes apart) is
//    done in registers, not through a bf16 copy in shared memory: a lane
//    reads four 32-bit words (4 channels at K rows 2c, 2c+1, 2c+8, 2c+9; under
//    the 128-byte swizzle these four rows of a warp's load fall in distinct
//    banks), and byte-permutes pair them into the A fragments of two MMAs
//    (channels 4g, 4g+1 and 4g+2, 4g+3). int8 -> bf16 is exact in three
//    instructions a pair (hopper.cuh), so no write, no barrier and no extra
//    shared memory per tile. x's B fragments come from ldmatrix over rows
//    padded to 144 bytes (conflict-free).
//  - 16 warps: 4 channel groups x the 4 k16 steps of every chunk, two chunks
//    at a time; the four K quarters are summed in shared memory in a fixed
//    order.
//  - Split K without atomics or workspace: the K splits of one slab form a
//    thread-block cluster; each CTA sends each partial row to the CTA that
//    owns the row (st.async into its shared memory, counted in bytes on its
//    mbarrier), and the owner sums the rows in rank order and applies scale
//    and bias. No cluster barrier after the products; one launch in all.
// What limits it now (kernel_trace.py on an H100): about 2 us from launch to
// the loads being issued (the tensor map's first fetch), 2 us more to the
// first chunk, 0.4-0.7 us of conversion and MMA issue per 8 KB chunk of an
// SM, and 2-2.5 us for the exchange and the epilogue: latency, not bytes.

#include <cooperative_groups.h>

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using namespace hopper;

namespace {

constexpr int BN = 128;            // output channels per CTA: 128-byte rows of W
constexpr int BK = 64;             // K rows per chunk
constexpr int MAX_BM = 64;         // x rows per CTA
constexpr int MAX_SPLITS = 8;      // portable thread-block cluster size
constexpr int WARPS = 16;          // 4 channel groups of 32 x 4 K quarters
constexpr int THREADS = WARPS * 32;
constexpr int W_CHUNK = BK * BN;   // bytes of one W chunk (8 KB)
constexpr int XS = BK * 2 + 16;    // bytes of one padded x row of a chunk
constexpr int PS = BN + 4;         // floats per row of the partial tile
constexpr int SMEM_LIMIT = 232448;  // per-block dynamic shared memory on Hopper

// Shared-memory layout (byte offsets from a 1,024-byte aligned base): W
// chunks (aligned as the 128-byte swizzle requires), then x chunks, the
// fp32 partial tile reusing their start once every product is done; the
// CTA's 128 scales and biases; one mbarrier per slot; with K split over a
// cluster, the partial rows that the other CTAs send this one.
struct Layout {
  size_t sb, bar, recv, total;
  __host__ __device__ Layout(int bm, int slots, int splits) {
    const size_t data = static_cast<size_t>(slots) * (W_CHUNK + bm * XS);
    const size_t part = 3 * static_cast<size_t>(bm) * PS * 4;  // three quarters' tiles
    sb = data > part ? data : part;
    bar = sb + 2 * BN * 4;
    recv = (bar + static_cast<size_t>(slots + 1) * 8 + 15) / 16 * 16;  // + the receive mbarrier
    const size_t per = (bm + splits - 1) / splits;
    total = recv + (splits > 1 ? static_cast<size_t>(splits) * per * BN * 4 : 0) + 1024;  // + room to align
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem) : "memory");
}
// Arrive on `bar` once this thread's cp.async copies so far have landed
// (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ void store4(const float4& v, __nv_bfloat16* out) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = u;
}
__device__ __forceinline__ void store4(const float4& v, float* out) { *reinterpret_cast<float4*>(out) = v; }

// Channels 4q .. 4q + 3 of the CTA: v * scale + bias (both in shared memory).
template <typename OutT>
__device__ __forceinline__ void epilogue(float4 v, const float* sb, bool has_bias, OutT* out, int q) {
  const float4 s = reinterpret_cast<const float4*>(sb)[q];
  const float4 b = has_bias ? reinterpret_cast<const float4*>(sb + BN)[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = v.x * s.x + b.x;
  v.y = v.y * s.y + b.y;
  v.z = v.z * s.z + b.z;
  v.w = v.w * s.w + b.w;
  store4(v, out + 4 * q);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
int8_mm_kernel(const __grid_constant__ CUtensorMap tw, const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ scale, const float* __restrict__ bias, OutT* __restrict__ out, int M,
               int K, int N, int bm, int cps, int slots) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int splits = gridDim.z;
  const Layout L(bm, slots, splits);
  uint8_t* wbuf = smem;
  uint8_t* xbuf = smem + static_cast<size_t>(slots) * W_CHUNK;
  float* part = reinterpret_cast<float*>(smem);
  float* sb = reinterpret_cast<float*>(smem + L.sb);  // scale[128], then bias[128]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  uint64_t* recv_bar = bar + slots;

  stamp(0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group: A/D row, B column
  const int c = lane & 3;   // mma thread in group
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * bm;
  const int rows = min(bm, M - m0);
  const int c_begin = blockIdx.z * cps;  // this split's first chunk
  const int n_chunks = min(cps, K / BK - c_begin);
  const int passes = (n_chunks + slots - 1) / slots;

  // Slot i of pass p holds chunk p * slots + i of this split. The last
  // thread (it has no x pieces at M <= 64) requests the W boxes, counted in
  // bytes on the slot's mbarrier; its first request waits for the tensor
  // map to be fetched, and holds up no one else. Every thread copies its
  // 16-byte pieces of the chunk's x rows with cp.async and arrives on the
  // same mbarrier when they land (x rows are 128 bytes: as bulk copies they
  // would cost the TMA unit a request each).
  constexpr int W_ISSUER = THREADS - 1;
  auto issue_w = [&](int pass) {
    const int first = pass * slots;
    for (int i = 0; i < min(slots, n_chunks - first); ++i) {
      mbar_arrive_expect_tx(&bar[i], W_CHUNK);
      tma_load_2d(wbuf + i * W_CHUNK, &tw, &bar[i], n0, (c_begin + first + i) * BK);
    }
  };
  auto issue_x = [&](int pass) {
    const int first = pass * slots;
    const int cnt = min(slots, n_chunks - first);
    for (int i = 0; i < cnt; ++i) {
      const __nv_bfloat16* xc = x + static_cast<size_t>(m0) * K + (c_begin + first + i) * BK;
      for (int e = tid; e < rows * (BK / 8); e += THREADS) {
        const int r = e / (BK / 8), p = e % (BK / 8);
        cp_async16(xbuf + (i * bm + r) * XS + p * 16, xc + static_cast<size_t>(r) * K + p * 8);
      }
      cp_async_arrive(&bar[i]);
    }
  };

  // With split K: the rows this CTA owns in the cluster's reduction, and
  // the bytes of partial rows it will receive for them.
  const int rank = blockIdx.z;  // the cluster spans the grid's z dimension
  const int per = (bm + splits - 1) / splits;  // rows per owner
  const int mine = rank < rows ? (rows - rank + splits - 1) / splits : 0;
  if (tid == W_ISSUER) {
    prefetch_tensormap(&tw);
    for (int i = 0; i < slots; ++i) mbar_init(&bar[i], 1 + THREADS);
    if (splits > 1) {
      mbar_init(recv_bar, 1);
      mbar_arrive_expect_tx(recv_bar, splits * mine * BN * 4);
    }
    mbar_fence_init();
    issue_w(0);
  }
  // Arrives after the mbarrier inits (whose fence releases them to the
  // cluster); waited for before the first store into another CTA.
  if (splits > 1) cluster_arrive_relaxed();
  // The slab's scales and biases, among the copies chunk 0's arrivals wait for.
  if (tid < BN / 4) {
    cp_async16(sb + 4 * tid, scale + n0 + 4 * tid);
  } else if (tid < BN / 2 && bias != nullptr) {
    cp_async16(sb + BN + 4 * (tid - BN / 4), bias + n0 + 4 * (tid - BN / 4));
  }
  // x rows at or beyond M stay zero in every slot (no copy writes them).
  const int pieces = (bm - rows) * (XS / 16);
  for (int e = tid; e < slots * pieces; e += THREADS) {
    const int i = e / pieces, r = rows + (e % pieces) / (XS / 16), q = e % (XS / 16);
    *reinterpret_cast<int4*>(xbuf + (i * bm + r) * XS + q * 16) = make_int4(0, 0, 0, 0);
  }
  __syncthreads();  // the mbarriers are initialized
  issue_x(0);
  stamp(1);

  const int cgrp = warp & 3;  // channels n0 + 32 cgrp .. + 31
  const int kq = warp >> 2;   // k16 step kq of every chunk
  const int nt = bm / 8;      // n8 tiles of x rows
  float acc[2][MAX_BM / 8][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int j = 0; j < MAX_BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.0f;
    }
  }

  // A: W^T from a W chunk. Rows 16 kq + {2c, 2c+1, 2c+8, 2c+9}, bytes
  // 32 cgrp + 4g (channels 4g .. 4g+3 of the group), read through the
  // 128-byte swizzle. MMA 0 takes channels 4g (row g) and 4g+1 (row g+8),
  // MMA 1 4g+2 and 4g+3: channel 4g + k is byte k of the words, paired
  // across two rows into bytes 0 and 2 (selector 0x0{k+4}0k).
  auto load_a = [&](const uint8_t* wt, uint32_t (&a)[2][4]) {
    uint32_t w4[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = kq * 16 + 2 * c + (t & 1) + (t >> 1) * 8;
      const int off = r * BN + cgrp * 32 + 4 * g;
      w4[t] = *reinterpret_cast<const uint32_t*>(wt + (off ^ ((r & 7) << 4)));
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t sel = 0x0400u + 0x0101u * (2 * t + h);
        a[t][h] = bf16x2_of_i8_pair(__byte_perm(w4[0], w4[1], sel));
        a[t][2 + h] = bf16x2_of_i8_pair(__byte_perm(w4[2], w4[3], sel));
      }
    }
  };
  // B: x^T from an x chunk, two n8 tiles of x rows per ldmatrix.x4; the
  // products of both MMA row tiles.
  const int mi = lane >> 3;
  auto products = [&](const uint8_t* xt, const uint32_t (&a)[2][4]) {
#pragma unroll
    for (int j = 0; j < MAX_BM / 8; j += 2) {
      if (j < nt) {
        uint32_t b[4];
        if (j + 1 < nt) {
          ldmatrix_x4(b, xt + (8 * (j + (mi >> 1)) + (lane & 7)) * XS + (kq * 16 + (mi & 1) * 8) * 2);
        } else {
          ldmatrix_x2(b, xt + (8 * j + (lane & 7)) * XS + (kq * 16 + (mi & 1) * 8) * 2);
        }
        mma_bf16_16816(acc[0][j], a[0], b[0], b[1]);
        mma_bf16_16816(acc[1][j], a[1], b[0], b[1]);
        if (j + 1 < nt) {
          mma_bf16_16816(acc[0][j + 1], a[0], b[2], b[3]);
          mma_bf16_16816(acc[1][j + 1], a[1], b[2], b[3]);
        }
      }
    }
  };

  for (int pass = 0; pass < passes; ++pass) {
    if (pass > 0) {
      __syncthreads();  // every warp is done with the slots
      if (tid == W_ISSUER) issue_w(pass);
      issue_x(pass);
    }
    const int cnt = min(slots, n_chunks - pass * slots);
    // Two chunks at a time: both chunks' loads and conversions are in flight
    // before their products, so a warp has independent work to hide latency.
    for (int i = 0; i < cnt; i += 2) {
      const int i2 = min(i + 1, cnt - 1);  // the second chunk (the first again at an odd end)
      mbar_wait(&bar[i], pass & 1);
      mbar_wait(&bar[i2], pass & 1);
      if (i == 0) stamp(2);
      uint32_t a[2][2][4];
      load_a(wbuf + i * W_CHUNK, a[0]);
      load_a(wbuf + i2 * W_CHUNK, a[1]);
      products(xbuf + i * bm * XS, a[0]);
      if (i2 != i) products(xbuf + i2 * bm * XS, a[1]);
    }
  }
  stamp(3);

  // The four K quarters: quarters 1-3 store their tiles part[q - 1][m][channel],
  // quarter 0 sums (q0 + q1) + (q2 + q3). A lane holds, for x row
  // m = 8j + 2c + h, the channels 32 cgrp + 4g .. + 3.
  auto value = [&](int j, int h) {
    return make_float4(acc[0][j][h], acc[0][j][2 + h], acc[1][j][h], acc[1][j][2 + h]);
  };
  auto slot = [&](int q, int j, int h) {
    return reinterpret_cast<float4*>(part + ((q - 1) * bm + 8 * j + 2 * c + h) * PS + cgrp * 32 + 4 * g);
  };
  auto total = [&](int j, int h) {
    return add4(add4(value(j, h), *slot(1, j, h)), add4(*slot(2, j, h), *slot(3, j, h)));
  };
  __syncthreads();  // every product is done: the slots take the partial tiles
  if (kq > 0) {
#pragma unroll
    for (int j = 0; j < MAX_BM / 8; ++j) {
      if (j < nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) *slot(kq, j, h) = value(j, h);
      }
    }
  }
  __syncthreads();
  stamp(4);

  if (splits == 1) {
    if (kq == 0) {  // the CTA's tile is whole: epilogue straight from registers
#pragma unroll
      for (int j = 0; j < MAX_BM / 8; ++j) {
        if (j < nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 8 * j + 2 * c + h;
            if (m < rows) {
              epilogue(total(j, h), sb, bias != nullptr,
                       out + static_cast<size_t>(m0 + m) * N + n0, cgrp * 8 + g);
            }
          }
        }
      }
    }
    stamp(6);
    return;
  }

  // The K splits of this slab are one cluster; CTA d owns the rows m with
  // m % splits == d. Quarter 0 sends each row's partial to its owner's
  // shared memory (slot [this rank][m / splits]) with st.async, counted in
  // bytes on the owner's mbarrier; each owner waits for its bytes and sums
  // its rows over the splits in rank order. No cluster barrier: a CTA waits
  // only for the partials it sums, and nobody reads its shared memory.
  cluster_wait();  // every CTA of the cluster has started (and set its mbarrier)
  if (kq == 0) {
#pragma unroll
    for (int j = 0; j < MAX_BM / 8; ++j) {
      if (j < nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 8 * j + 2 * c + h;
          if (m < rows) {
            const int d = m % splits;
            st_async_v4(cluster_addr(recv + (rank * per + m / splits) * BN + cgrp * 32 + 4 * g, d), total(j, h),
                        cluster_addr(recv_bar, d));
          }
        }
      }
    }
  }
  mbar_wait(recv_bar, 0);  // every partial row this CTA owns has arrived
  stamp(5);
  for (int e = tid; e < mine * (BN / 4); e += THREADS) {
    const int i = e / (BN / 4), q = e % (BN / 4);
    float4 v = reinterpret_cast<const float4*>(recv + i * BN)[q];
    for (int s = 1; s < splits; ++s) v = add4(v, reinterpret_cast<const float4*>(recv + (s * per + i) * BN)[q]);
    epilogue(v, sb, bias != nullptr, out + static_cast<size_t>(m0 + rank + i * splits) * N + n0, q);
  }
  stamp(6);
}

// ---- host side ----

// Tensor maps of the weights, encoded once each: a map holds only the
// address, shape and layout, so (address, K, N) names it exactly, whatever
// tensor later lives there.
struct MapKey {
  uintptr_t w;
  int K, N;
  bool operator==(const MapKey& o) const { return w == o.w && K == o.K && N == o.N; }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<uintptr_t>()(k.w) ^ (static_cast<size_t>(k.K) << 20) ^ static_cast<size_t>(k.N);
  }
};

// (K, N) int8 row-major as 2-D (N, K) with boxes of 128 bytes x 64 rows
// under the 128-byte swizzle. False if the driver refuses it.
bool weight_map(const void* w, int K, int N, CUtensorMap* map) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{reinterpret_cast<uintptr_t>(w), K, N};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t box[2] = {BN, BK};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  maps.emplace(key, *map);
  return true;
}

// The shared-memory limit is raised once per kernel and device.
template <typename OutT>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 64) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(int8_mm_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename OutT>
cudaError_t launch(const CUtensorMap& tw, const void* x, const void* scale, const void* bias, void* out, int M,
                   int K, int N, int bm, int m_blocks, int splits, int cps, int slots, cudaStream_t stream) {
  cudaError_t e = allow_smem<OutT>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN, m_blocks, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Layout(bm, slots, splits).total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_mm_kernel<OutT>, tw, static_cast<const __nv_bfloat16*>(x),
                            static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<OutT*>(out),
                            M, K, N, bm, cps, slots);
}

}  // namespace

// How many clusters of `splits` CTAs (`bm` x rows, `slots` chunk slots) the
// card holds at once; clusters are placed within one GPC, so this can be
// fewer than the SM count allows. -1 on error.
extern "C" int int8_mm_max_clusters(int bm, int slots, int splits) {
  if (allow_smem<__nv_bfloat16>() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Layout(bm, slots, splits).total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, int8_mm_kernel<__nv_bfloat16>, &cfg) == cudaSuccess ? n : -1;
}

// Dynamic shared memory of a CTA with `bm` x rows and `slots` chunk slots,
// K split `splits` ways.
extern "C" long long int8_mm_smem_bytes(int bm, int slots, int splits) {
  return static_cast<long long>(Layout(bm, slots, splits).total);
}

// The caller (whisperx_tpu_torch/ops/int8_mm.py) checks shapes, types,
// contiguity and 16-byte alignment (K % 64 == 0, N % 128 == 0, 1 <= M <= 256)
// and passes its launch plan: x-row blocks of `bm` (a multiple of 8, <= 64),
// `splits` (<= 8) K splits of `cps` 64-row chunks each, every split holding
// at least one, and `slots` chunk buffers per CTA. `bias` may be null.
// Returns a cudaError_t.
extern "C" int int8_mm(const void* x, const void* w, const void* scale, const void* bias, void* out, int M, int K,
                       int N, int bm, int m_blocks, int splits, int cps, int slots, int out_bf16, void* stream) {
  const int k_chunks = K / BK;
  if (bm % 8 != 0 || bm < 8 || bm > MAX_BM || m_blocks * bm < M || splits < 1 || splits > MAX_SPLITS ||
      cps < 1 || splits * cps < k_chunks || (splits - 1) * cps >= k_chunks || slots < 1 || slots > cps ||
      Layout(bm, slots, splits).total > SMEM_LIMIT || N % BN != 0 || K % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tw;
  if (!weight_map(w, K, N, &tw)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      out_bf16 ? launch<__nv_bfloat16>(tw, x, scale, bias, out, M, K, N, bm, m_blocks, splits, cps, slots, st)
               : launch<float>(tw, x, scale, bias, out, M, K, N, bm, m_blocks, splits, cps, slots, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
