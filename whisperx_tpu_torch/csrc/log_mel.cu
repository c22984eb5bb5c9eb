// Fused Whisper log-mel front end, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel whisperx_tpu/ops/pallas_mel.py:
// log_mel_pallas. For each batch row of audio (n samples, fp32, or int16 PCM
// divided by 32768) and each frame f < n / 160:
//   frame    = reflect-padded samples [160 f, 160 f + 400)          (pad 200 per end)
//   X[k]     = sum_t hann[t] frame[t] e^{-2 pi i t k / 400}, k = 0..200
//   power    = |X|^2                                                (201 bins)
//   mel      = power @ filters^T                                    (n_mels)
//   x        = log10(max(mel, 1e-10))
// then, per batch row, out = (max(x, max_row(x) - 8) + 4) / 4, written as
// (B, n_mels, n_frames) fp32.
//
// What bounds it on the card: bytes. At B 8 x 3000 frames of int16 audio the
// call reads 7.7 MB and writes 7.7 MB (n_mels 80): 15.4 MB, 0.0046 ms at
// 3.35 TB/s. A radix FFT's least work (2.5 N log2 N a frame, ~0.24 GFLOP for
// the batch) would take 0.0036 ms at the 67 TFLOP/s fp32 peak.
//
// The algorithm: a two-stage Cooley-Tukey split of the real DFT, 400 = 20 x 20,
// with t = 20 n1 + n2 and k = k1 + 20 k2:
//   Y[n2][k1] = sum_n1 x[20 n1 + n2] W20^(n1 k1)      20 real DFT-20s (k1 0..10,
//                                                     the rest by conjugate symmetry)
//   Z[n2][k1] = Y[n2][k1] W400^(n2 k1)                 one twiddle multiply
//   X[k1 + 20 k2] = sum_n2 Z[n2][k1] W20^(n2 k2)       20 complex DFT-20s, 201 bins kept
// All in fp32 on the CUDA cores: the result has to stay within 1e-4 of the
// fp32 plain version after the log, which TF32 cannot promise. The small DFTs
// are direct products, about 57 kFLOP a frame (1.37 GFLOP for the batch:
// 0.020 ms at the fp32 peak) against 322 kFLOP for the dense DFT it replaces;
// the mel product is banded, 391 taps a frame at n_mels 80 (394 at 128)
// instead of 201 x n_mels.
//
// Design:
//  - One CTA of 320 threads per (tile of 16 frames, batch row): 1,504 CTAs
//    at 8 x 3000 frames. The tile's 2,800 reflect-padded samples are read
//    from device memory once into shared memory, where frame i starts at
//    sample 160 i: framing is an offset, not a copy.
//  - Thread (frame, n2) computes one real DFT-20 and its twiddles; thread
//    (frame, k1) then one complex DFT-20 and its 10 (or 11) power bins. The
//    DFT-20 coefficients, built in float64 on the host, are a kernel
//    parameter: with the loops unrolled every index is a constant, so they
//    are read from the constant bank as FMA operands. The Hann window and
//    the twiddles (runtime-indexed) sit in shared memory, 4.8 KB a CTA. The
//    intermediate Z lives in shared memory with strides (500 a frame, 25 a
//    k1) under which both the writes of stage 1 and the reads of stage 2 are
//    free of bank conflicts.
//  - The mel product reads a (start, length, taps) table per band: a warp
//    takes two bands for the tile's 16 frames, so its output stores are two
//    64-byte runs and the tap loads are broadcasts.
//  - The per-row max is reduced in the same launch: one atomicMax per CTA on
//    an order-preserving unsigned image of the float (exact, so the order of
//    the atomics does not matter). A second, elementwise kernel of the same
//    call applies the clip and the scale in place.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.065 ms at
// 8 x 30 s int16, n_mels 80 (torch.stft + the filterbank matmul: 0.262 ms).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int HALF = N_FFT / 2;
constexpr int NF = 201;                       // one-sided bins
constexpr int R = 20;                         // 400 = R x R
constexpr int FT = 16;                        // frames per CTA
constexpr int THREADS = FT * R;               // 320: one thread per (frame, n2) and per (frame, k1)
constexpr int WARPS = THREADS / 32;
constexpr int WIN = FT * HOP + N_FFT - HOP;   // samples a tile reads (2,800)
constexpr int ZF = 500;                       // Z stride per frame (= 20 mod 32)
constexpr int ZK = 25;                        // Z stride per k1 (= 1 mod 8)
constexpr int MAX_TAPS = 16;                  // widest mel band (14 bins at n_mels 80)

// Shared memory, in floats: window, Hann, twiddles (re, im; [k1][n2]), Z
// (re, im planes). The power spectrum reuses the Z bytes after stage 2.
constexpr int OFF_HANN = WIN;
constexpr int OFF_TWR = OFF_HANN + N_FFT;
constexpr int OFF_TWI = OFF_TWR + R * R;
constexpr int OFF_ZR = OFF_TWI + R * R;
constexpr int OFF_ZI = OFF_ZR + FT * ZF;
constexpr int SMEM_FLOATS = OFF_ZI + FT * ZF;
static_assert(FT * NF <= FT * ZF, "power fits in the Z planes");

// cos and sin of 2 pi j / 20, j = 0..19 (built in float64 on the host).
struct Dft20 {
  float c[R];
  float s[R];
};

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
__global__ void __launch_bounds__(THREADS, 2)
log_mel_kernel(const T* __restrict__ audio, const Dft20 w,
               const float* __restrict__ tables,  // hann (400) | twiddle re (20 x 20) | twiddle im (20 x 20)
               const int* __restrict__ band,      // start (n_mels) | length (n_mels)
               const float* __restrict__ taps,    // (n_mels, MAX_TAPS)
               float* __restrict__ out, unsigned* __restrict__ row_max, int n, int n_frames, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  float* win = smem;
  float* hann = smem + OFF_HANN;
  float* twr = smem + OFF_TWR;
  float* twi = smem + OFF_TWI;
  float* zr = smem + OFF_ZR;
  float* zi = smem + OFF_ZI;
  float* power = zr;  // (FT, NF), after stage 2
  __shared__ float warp_max[WARPS];

  const int tid = threadIdx.x;
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
  for (int i = tid; i < N_FFT + 2 * R * R; i += THREADS) hann[i] = tables[i];
  __syncthreads();

  const int f = tid / R;   // frame of the tile
  const int r = tid - f * R;  // n2 in stage 1, k1 in stage 2

  // Stage 1: thread (f, n2) -> Z[f][k1][n2] for k1 = 0..19.
  {
    const int n2 = r;
    float xs[R];
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) xs[n1] = win[f * HOP + R * n1 + n2] * hann[R * n1 + n2];
    float yr[R / 2 + 1], yi[R / 2 + 1];
#pragma unroll
    for (int k1 = 0; k1 <= R / 2; ++k1) {
      float a = 0.0f, c = 0.0f;
#pragma unroll
      for (int n1 = 0; n1 < R; ++n1) {
        a = fmaf(xs[n1], w.c[(n1 * k1) % R], a);
        c = fmaf(xs[n1], w.s[(n1 * k1) % R], c);
      }
      yr[k1] = a;
      yi[k1] = -c;
    }
    float* zr_f = zr + f * ZF + n2;
    float* zi_f = zi + f * ZF + n2;
#pragma unroll
    for (int k1 = 0; k1 < R; ++k1) {
      const float ar = k1 <= R / 2 ? yr[k1] : yr[R - k1];
      const float ai = k1 <= R / 2 ? yi[k1] : -yi[R - k1];
      const float wr = twr[k1 * R + n2], wi = twi[k1 * R + n2];
      zr_f[k1 * ZK] = ar * wr - ai * wi;
      zi_f[k1 * ZK] = fmaf(ar, wi, ai * wr);
    }
  }
  __syncthreads();

  // Stage 2: thread (f, k1) -> bins k1 + 20 k2, k2 = 0..9 (and bin 200 for k1 = 0).
  {
    const int k1 = r;
    float xr[R / 2 + 1], xi[R / 2 + 1];
#pragma unroll
    for (int k2 = 0; k2 <= R / 2; ++k2) xr[k2] = xi[k2] = 0.0f;
    const float* zr_f = zr + f * ZF + k1 * ZK;
    const float* zi_f = zi + f * ZF + k1 * ZK;
#pragma unroll
    for (int n2 = 0; n2 < R; ++n2) {
      const float a = zr_f[n2], c = zi_f[n2];
#pragma unroll
      for (int k2 = 0; k2 <= R / 2; ++k2) {
        const float cs = w.c[(n2 * k2) % R], sn = w.s[(n2 * k2) % R];
        xr[k2] = fmaf(a, cs, fmaf(c, sn, xr[k2]));
        xi[k2] = fmaf(c, cs, fmaf(-a, sn, xi[k2]));
      }
    }
    __syncthreads();  // every Z read is done: power reuses the bytes
    float* p = power + f * NF + k1;
#pragma unroll
    for (int k2 = 0; k2 < R / 2; ++k2) p[R * k2] = xr[k2] * xr[k2] + xi[k2] * xi[k2];
    if (k1 == 0) p[R * (R / 2)] = xr[R / 2] * xr[R / 2] + xi[R / 2] * xi[R / 2];
  }
  __syncthreads();

  // Stage 3: banded mel. Thread (f = tid % 16) takes bands tid / 16 + 20 j.
  const int ff = tid & (FT - 1);
  const int frame = f0 + ff;
  const float* prow = power + ff * NF;
  float mx = -INFINITY;
  for (int m = tid / FT; m < n_mels; m += THREADS / FT) {
    const int start = __ldg(band + m), len = __ldg(band + n_mels + m);
    const float* tm = taps + m * MAX_TAPS;
    float acc = 0.0f;
    for (int i = 0; i < len; ++i) acc = fmaf(prow[start + i], __ldg(tm + i), acc);
    const float lg = log10f(fmaxf(acc, 1e-10f));
    if (frame < n_frames) {
      out[((long long)b * n_mels + m) * n_frames + frame] = lg;
      mx = fmaxf(mx, lg);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((tid & 31) == 0) warp_max[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) m = fmaxf(m, warp_max[i]);
    if (m > -INFINITY) atomicMax(row_max + b, order_key(m));
  }
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
cudaError_t launch(const void* audio, const Dft20& w, const void* tables, const void* band, const void* taps,
                   void* out, void* row_max, int B, int n, int n_mels, cudaStream_t stream) {
  const int n_frames = n / HOP;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  auto kern = log_mel_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(row_max, 0, sizeof(unsigned) * B, stream);  // 0 is below every key
  if (e != cudaSuccess) return e;
  kern<<<dim3((n_frames + FT - 1) / FT, B), THREADS, smem, stream>>>(
      static_cast<const T*>(audio), w, static_cast<const float*>(tables), static_cast<const int*>(band),
      static_cast<const float*>(taps), static_cast<float*>(out), static_cast<unsigned*>(row_max), n, n_frames,
      n_mels);
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
// dft20 40 host floats (cos | sin of 2 pi j / 20); tables 1,200 fp32 on the
// card (hann | twiddle re | twiddle im, [k1][n2]); band 2 x n_mels int32
// (start | length <= 16); taps (n_mels, 16) fp32; out (B, n_mels, n / 160)
// fp32; row_max B words of scratch.
extern "C" int log_mel(const void* audio, int is_int16, const float* dft20, const void* tables, const void* band,
                       const void* taps, void* out, void* row_max, int B, int n, int n_mels, void* stream) {
  Dft20 w;
  for (int j = 0; j < R; ++j) {
    w.c[j] = dft20[j];
    w.s[j] = dft20[R + j];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_int16 ? launch<int16_t>(audio, w, tables, band, taps, out, row_max, B, n, n_mels, st)
                                 : launch<float>(audio, w, tables, band, taps, out, row_max, B, n, n_mels, st);
  return static_cast<int>(e);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
