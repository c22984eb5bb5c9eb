// Fused Whisper log-mel front end, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel whisperx_tpu/ops/pallas_mel.py:
// log_mel_pallas. For each batch row of audio (n samples, fp32, or int16 PCM
// divided by 32768) and each frame f < n / 160:
//   frame    = reflect-padded samples [160 f, 160 f + 400)          (pad 200 per end)
//   re, im   = frame @ [cos | -sin] (the Hann-windowed real DFT, 400 x 201 each)
//   power    = re^2 + im^2                                          (201 bins)
//   mel      = power @ filters^T                                    (n_mels)
//   x        = log10(max(mel, 1e-10))
// then, per batch row, out = (max(x, max_row(x) - 8) + 4) / 4, written as
// (B, n_mels, n_frames) fp32.
//
// What bounds it on the card: operations. The DFT is 400 x 402 multiply-adds
// per frame: 7.7 GFLOP at B 8 x 3000 frames, plus 0.8 GFLOP for the mel
// product at n_mels 80. It has to stay within 1e-4 of the fp32 plain version
// after the log, which TF32 (10-bit mantissa) cannot promise and a split of
// the operands into bf16 parts only narrowly does, so the products run in
// fp32 on the CUDA cores (67 TFLOP/s peak: 0.127 ms for the batch), against
// 23 MB of audio and output (7 us).
//
// Design (the TPU kernel's stride-2 row slices of 80-sample blocks, and its
// im2col-free framing, become a shared-memory window):
//  - One CTA of 256 threads per (tile of 32 frames, batch row): 752 CTAs at
//    8 x 3000 frames. The tile's 5,360 reflect-padded samples are read once
//    into shared memory; frame i of the tile starts at sample 160 i there, so
//    framing is an offset, not a copy.
//  - The basis streams through shared memory 8 rows at a time. A warp owns
//    4 frames and each lane 7 bins (224 >= 201), re and im: 56 fp32
//    accumulators a thread, 56 FMAs per 18 shared loads, of which the 4
//    sample loads are broadcasts.
//  - power goes to shared memory (stride 201: the 32 frames of a warp hit 32
//    banks); a warp then computes one mel band for the tile's 32 frames, so
//    its output stores are coalesced and the filter loads are broadcasts.
//  - The per-row max is reduced in the same launch: one atomicMax per warp on
//    an order-preserving unsigned image of the float (exact, so the order of
//    the atomics does not matter). A second, elementwise kernel of the same
//    call applies the clip and the scale in place.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int HALF = N_FFT / 2;
constexpr int NF = 201;          // one-sided bins
constexpr int NFP = 224;         // bins padded to 7 x 32
constexpr int FT = 32;           // frames per CTA
constexpr int THREADS = 256;
constexpr int KC = 8;            // basis rows per shared-memory chunk
constexpr int WIN = FT * HOP + N_FFT - HOP;  // samples a tile reads (5,360)
constexpr int BINS_PER_LANE = NFP / 32;      // 7
constexpr int FRAMES_PER_WARP = FT / (THREADS / 32);  // 4

// Shared memory: the sample window and one basis chunk during the DFT, then
// the tile's power spectrum in the same bytes.
constexpr int SMEM_FLOATS_DFT = WIN + KC * 2 * NFP;
constexpr int SMEM_FLOATS_POWER = FT * NF;
constexpr int SMEM_FLOATS = SMEM_FLOATS_DFT > SMEM_FLOATS_POWER ? SMEM_FLOATS_DFT : SMEM_FLOATS_POWER;

__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float order_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ float sample(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float sample(const int16_t* x, long long i) {
  return static_cast<float>(x[i]) / 32768.0f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const T* __restrict__ audio, const float* __restrict__ basis,  // (400, 2 * NFP)
               const float* __restrict__ filt,                                // (NF, n_mels)
               float* __restrict__ out, unsigned* __restrict__ row_max, int n, int n_frames, int n_mels) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  float* win = smem;             // WIN samples
  float* bas = smem + WIN;       // KC rows of [cos (NFP) | -sin (NFP)]
  float* power = smem;           // FT x NF, after the DFT

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f0 = blockIdx.x * FT;
  const int b = blockIdx.y;
  const T* x = audio + (long long)b * n;

  // Reflect-padded window: padded index p maps to sample p - 200, mirrored at
  // both ends. Indices only frames beyond n_frames would use are clamped.
  for (int i = tid; i < WIN; i += THREADS) {
    int o = f0 * HOP + i - HALF;
    if (o < 0) o = -o;
    if (o >= n) o = 2 * (n - 1) - o;
    o = min(max(o, 0), n - 1);
    win[i] = sample(x, o);
  }

  float re[FRAMES_PER_WARP][BINS_PER_LANE], im[FRAMES_PER_WARP][BINS_PER_LANE];
#pragma unroll
  for (int f = 0; f < FRAMES_PER_WARP; ++f) {
#pragma unroll
    for (int j = 0; j < BINS_PER_LANE; ++j) re[f][j] = im[f][j] = 0.0f;
  }
  const float* wf = win + warp * FRAMES_PER_WARP * HOP;  // this warp's first frame

  for (int k0 = 0; k0 < N_FFT; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed (and the window is written)
    for (int i = tid; i < KC * 2 * NFP; i += THREADS) bas[i] = basis[k0 * 2 * NFP + i];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float xs[FRAMES_PER_WARP];
#pragma unroll
      for (int f = 0; f < FRAMES_PER_WARP; ++f) xs[f] = wf[f * HOP + k0 + kk];
#pragma unroll
      for (int j = 0; j < BINS_PER_LANE; ++j) {
        const float c = bas[kk * 2 * NFP + lane + 32 * j];
        const float s = bas[kk * 2 * NFP + NFP + lane + 32 * j];
#pragma unroll
        for (int f = 0; f < FRAMES_PER_WARP; ++f) {
          re[f][j] = fmaf(xs[f], c, re[f][j]);
          im[f][j] = fmaf(xs[f], s, im[f][j]);
        }
      }
    }
  }
  __syncthreads();  // the window and the basis are dead: power reuses the bytes
#pragma unroll
  for (int f = 0; f < FRAMES_PER_WARP; ++f) {
#pragma unroll
    for (int j = 0; j < BINS_PER_LANE; ++j) {
      const int bin = lane + 32 * j;
      if (bin < NF) power[(warp * FRAMES_PER_WARP + f) * NF + bin] = re[f][j] * re[f][j] + im[f][j] * im[f][j];
    }
  }
  __syncthreads();

  // Mel bands: warp w takes bands w, w + 8, ...; lane = frame of the tile.
  const int f = f0 + lane;
  float mx = -INFINITY;
  for (int m = warp; m < n_mels; m += THREADS / 32) {
    float acc = 0.0f;
    const float* prow = power + lane * NF;
    for (int c = 0; c < NF; ++c) acc = fmaf(prow[c], __ldg(filt + c * n_mels + m), acc);
    const float lg = log10f(fmaxf(acc, 1e-10f));
    if (f < n_frames) {
      out[((long long)b * n_mels + m) * n_frames + f] = lg;
      mx = fmaxf(mx, lg);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0 && mx > -INFINITY) atomicMax(row_max + b, order_key(mx));
}

// out = (max(out, row_max - 8) + 4) / 4, in place.
__global__ void clip_scale_kernel(float* __restrict__ out, const unsigned* __restrict__ row_max,
                                  long long per_row, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const float lo = order_value(row_max[i / per_row]) - 8.0f;
    out[i] = (fmaxf(out[i], lo) + 4.0f) / 4.0f;
  }
}

template <typename T>
cudaError_t launch(const void* audio, const void* basis, const void* filt, void* out, void* row_max, int B, int n,
                   int n_mels, cudaStream_t stream) {
  const int n_frames = n / HOP;
  cudaError_t e = cudaMemsetAsync(row_max, 0, sizeof(unsigned) * B, stream);  // 0 is below every key
  if (e != cudaSuccess) return e;
  log_mel_kernel<T><<<dim3((n_frames + FT - 1) / FT, B), THREADS, 0, stream>>>(
      static_cast<const T*>(audio), static_cast<const float*>(basis), static_cast<const float*>(filt),
      static_cast<float*>(out), static_cast<unsigned*>(row_max), n, n_frames, n_mels);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long per_row = (long long)n_mels * n_frames;
  const long long total = per_row * B;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
  clip_scale_kernel<<<blocks, 256, 0, stream>>>(static_cast<float*>(out), static_cast<const unsigned*>(row_max),
                                                per_row, total);
  return cudaGetLastError();
}

}  // namespace

// The caller (whisperx_tpu_torch/ops/mel.py) checks shapes and types: audio
// (B, n) fp32 (is_int16 = 0) or int16 (1), n a multiple of 160 and above 200;
// basis (400, 448) fp32; filt (201, n_mels) fp32; out (B, n_mels, n / 160)
// fp32; row_max B words of scratch.
extern "C" int log_mel(const void* audio, int is_int16, const void* basis, const void* filt, void* out,
                       void* row_max, int B, int n, int n_mels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_int16 ? launch<int16_t>(audio, basis, filt, out, row_max, B, n, n_mels, st)
                                 : launch<float>(audio, basis, filt, out, row_max, B, n, n_mels, st);
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
