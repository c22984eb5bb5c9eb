// CTC forced alignment, trellis and backtrack in one launch, written by hand
// for Hopper (sm_90a).
//
// Replaces the JAX package's one compiled alignment program,
// whisperx_tpu/ops/ctc.py:188 ctc_align_batch_device: its lax.scan trellis
// (ctc_trellis_batch, the scan at :65) and its vmapped lax.scan walk
// (_backtrack_one, the scan at :183). Neither is a Pallas kernel: XLA
// compiles them. The port's plain version is whisperx_tpu_torch/ops/ctc.py:
// ctc_trellis_batch_plain and ctc_align_batch_device_plain.
//
// For each batch row b, with lp = log_probs[b] (T, V), tok = tokens[b] (N),
// col0 = column 0 of the trellis (T + 1, computed by the caller with the
// plain version's torch.cumsum + where, so that both see the same bits):
//   trellis[0]       = [col0[0], -inf, ..., -inf]
//   trellis[t+1][0]  = col0[t+1]
//   stay             = trellis[t][j]   + lp[t][blank]
//   advance          = trellis[t][j-1] + lp[t][tok[j-1]]                 j = 1..N
//   trellis[t+1][j]  = advance > stay ? advance : stay
// Two fp32 adds and a compare, in the plain version's order; on ties the
// compare keeps `stay`, as torch.maximum(stay, advance) does. The inputs are
// log-softmax emissions (finite) and a first column of finite values and
// +inf, so no cell is NaN and the compare is a total order on what it sees.
// Then the start row t_start = the first argmax over rows r <= t_len of
// trellis[r][n_len] (torch.argmax's tie rule), and the greedy walk from
// (t_start, n_len) down to t = 1: at time t with pointer j the walk moves to
// j - 1 when t <= t_start, j > 0 and
//   trellis[t-1][j-1] + lp[t-1][tok[j-1]] > trellis[t-1][j] + lp[t-1][blank],
// which is exactly the trellis's decision `advance > stay` for row t - 1,
// column j. Walk position k (time index T - 1 - k, descending t) gives
//   tok_idx = max(j - 1, 0), probs = exp(take ? lp[r][tok[j-1]] : lp[r][blank]),
//   active = (t <= t_start) && (j > 0),
// with j the pointer before the step, and success = (final pointer == 0).
// The plain version's packed outputs hold these values at inactive positions
// too (t > t_start, or the pointer at 0). At j = 0 it compares
// col0[r] + lp[r][tok[0]] with col0[r] + lp[r][blank], a decision the
// trellis never makes: the epilogue computes it apart.
//
// What bounds it on the card. Bytes: the function reads B x T x V fp32
// emissions, the tokens, lengths and first column, and writes three (B, T)
// arrays and two (B,): about 1.8 MB at the alignment path's shapes (B 8,
// T 1,499, N 448, V 32), 0.5 us at 3.35 TB/s. Operations: 3 x B x T x N,
// 16 MFLOP, far less. But the recurrence is T dependent steps, each of one
// shared-memory round trip and one barrier of the CTA, and then a walk of T
// dependent steps: that dependency bound governs, by two orders of
// magnitude (chip_smoke.py measures it as T barriered steps of an empty loop
// body, the probe below).
//
// Design (one right, simple kernel; its time is in PERF.md):
//  - One CTA per batch row; threads stride over the columns j (a warp holds
//    32 neighbouring columns). The previous trellis row lives in shared
//    memory, double-buffered: one barrier a step.
//  - Emissions are staged in shared memory a chunk of rows at a time (one
//    coalesced load every `chunk` steps), with column 0 of those rows; the
//    token ids sit in shared memory. A step reads nothing from device
//    memory.
//  - One warp ballot a step and 32 columns stores the decision bits
//    `advance > stay`: T x ceil((N+1)/32) words, in shared memory where they
//    fit under the 227 KB limit (90 KB at the alignment path's shapes), else
//    in a scratch buffer the caller allocates (B, T, words). The trellis
//    itself is not kept.
//  - The thread that owns column n_len tracks its argmax as the rows are
//    produced. One thread then walks the bits from t_start down, writing the
//    pointer of each position into tok_idx; the whole CTA then turns those
//    pointers into the outputs in parallel.
//  - A second mode (no align outputs) writes every row of the trellis to an
//    output instead (ctc_trellis_batch on the card).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

struct Args {
  const float* lp;        // (B, T, V) fp32 log-probs
  const int64_t* tokens;  // (B, N)
  const int64_t* t_len;   // (B,)
  const int64_t* n_len;   // (B,)
  const float* col0;      // (B, T + 1) column 0 of the trellis
  float* trellis;         // (B, T + 1, N + 1), or null
  int64_t* tok_idx;       // (B, T), or null: trellis mode
  float* probs;           // (B, T)
  bool* active;           // (B, T)
  bool* success;          // (B,)
  int64_t* t_start;       // (B,)
  uint32_t* bits_global;  // (B, T, words), or null: the bits in shared memory
  int T, N, V, blank, chunk;
};

// Shared memory, in 4-byte words: two rows (2 (N+1)), the emission chunk
// (chunk V), its first-column values (chunk), the token ids (N), 4 spare
// words, then the decision bits (T words-per-row) where they are kept here.
__host__ __device__ inline size_t smem_words(int T, int N, int V, int chunk, bool bits_here) {
  const size_t n1 = static_cast<size_t>(N) + 1;
  const size_t words = (n1 + 31) / 32;
  return 2 * n1 + static_cast<size_t>(chunk) * V + chunk + N + 4 + (bits_here ? static_cast<size_t>(T) * words : 0);
}

template <bool kAlign>
__global__ void ctc_kernel(Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int T = a.T, N = a.N, N1 = N + 1, V = a.V, CH = a.chunk;
  const int W = (N1 + 31) >> 5;
  float* rows = smem;
  float* em = rows + 2 * N1;
  float* c0 = em + CH * V;
  int* tok_s = reinterpret_cast<int*>(c0 + CH);
  int* misc = tok_s + N;
  uint32_t* bits = a.bits_global != nullptr ? a.bits_global + static_cast<size_t>(b) * T * W
                                            : reinterpret_cast<uint32_t*>(misc + 4);

  const float* lp = a.lp + static_cast<size_t>(b) * T * V;
  const float* col0 = a.col0 + static_cast<size_t>(b) * (T + 1);
  float* trellis = a.trellis != nullptr ? a.trellis + static_cast<size_t>(b) * (T + 1) * N1 : nullptr;
  const int nl = kAlign ? static_cast<int>(a.n_len[b]) : 0;
  const long long tl = kAlign ? a.t_len[b] : 0;

  // Indices from the caller, checked on the card as torch.gather checks the
  // plain version's: a token id outside the vocabulary or a token count
  // outside [0, N] traps (a launch error at the next synchronization).
  if (kAlign && (nl < 0 || nl > N)) __trap();
  for (int j = tid; j < N; j += nt) {
    const int64_t id = a.tokens[static_cast<size_t>(b) * N + j];
    if (id < 0 || id >= V) __trap();
    tok_s[j] = static_cast<int>(id);
  }
  for (int j = tid; j < N1; j += nt) {
    const float v = j == 0 ? col0[0] : -INFINITY;
    rows[j] = v;
    if (trellis != nullptr) trellis[j] = v;
  }
  // Column n_len's running argmax, kept by the thread that owns the column.
  const bool owner = kAlign && tid == nl % nt;
  float best = nl == 0 ? col0[0] : -INFINITY;
  int best_r = 0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int tc = t % CH;
    if (tc == 0) {  // the next chunk of emission rows and their first-column values
      const int n = min(CH, T - t);
      for (int i = tid; i < n * V; i += nt) em[i] = lp[static_cast<size_t>(t) * V + i];
      for (int i = tid; i < n; i += nt) c0[i] = col0[t + 1 + i];
      __syncthreads();
    }
    const float* prev = rows + (t & 1) * N1;
    float* next = rows + ((t + 1) & 1) * N1;
    const float* e = em + tc * V;
    const float bl = e[a.blank];
    for (int base = 0; base < N1; base += nt) {  // uniform across the warp: the ballot needs every lane
      const int j = base + tid;
      bool take = false;
      if (j <= N) {
        float v;
        if (j == 0) {
          v = c0[tc];
        } else {
          const float stay = prev[j] + bl;
          const float advance = prev[j - 1] + e[tok_s[j - 1]];
          take = advance > stay;
          v = take ? advance : stay;
        }
        next[j] = v;
        if (trellis != nullptr) trellis[static_cast<size_t>(t + 1) * N1 + j] = v;
        if (owner && j == nl && t + 1 <= tl && v > best) {
          best = v;
          best_r = t + 1;
        }
      }
      if (kAlign) {
        const uint32_t word = __ballot_sync(kFullMask, take);
        const int w = j >> 5;
        if (lane == 0 && w < W) bits[static_cast<size_t>(t) * W + w] = word;
      }
    }
    __syncthreads();
  }
  if (!kAlign) return;

  if (owner) misc[0] = best_r;
  __syncthreads();
  const int ts = misc[0];
  int64_t* out_idx = a.tok_idx + static_cast<size_t>(b) * T;
  if (tid == 0) {  // the walk: position k holds the pointer before its step
    int j = nl;
    for (int k = 0; k < T; ++k) {
      const int t = T - k;
      out_idx[k] = j;
      if (t <= ts && j > 0 && ((bits[static_cast<size_t>(t - 1) * W + (j >> 5)] >> (j & 31)) & 1u)) --j;
    }
    a.success[b] = j == 0;
    a.t_start[b] = ts;
  }
  __syncthreads();
  for (int k = tid; k < T; k += nt) {
    const int r = T - 1 - k;
    const int j = static_cast<int>(out_idx[k]);
    const int jm1 = max(j - 1, 0);
    const float* e = lp + static_cast<size_t>(r) * V;
    const float bl = e[a.blank];
    bool take;
    if (j == 0) {  // the plain walk's own decision at j = 0
      const float c = col0[r];
      take = c + e[tok_s[0]] > c + bl;
    } else {
      take = (bits[static_cast<size_t>(r) * W + (j >> 5)] >> (j & 31)) & 1u;
    }
    out_idx[k] = jm1;
    a.probs[static_cast<size_t>(b) * T + k] = expf(take ? e[tok_s[jm1]] : bl);
    a.active[static_cast<size_t>(b) * T + k] = r + 1 <= ts && j > 0;
  }
}

// The dependency probe: T steps of an otherwise empty loop, each one
// shared-memory round trip (a neighbour's value from the previous row) and
// one barrier, as the trellis's recurrence makes them.
__global__ void barrier_steps(int T, float* out) {
  extern __shared__ float buf[];
  const int tid = threadIdx.x, nt = blockDim.x;
  buf[tid] = static_cast<float>(tid);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* prev = buf + (t & 1) * nt;
    float* next = buf + ((t + 1) & 1) * nt;
    next[tid] = prev[tid == 0 ? 0 : tid - 1] + 1.0f;
    __syncthreads();
  }
  out[static_cast<size_t>(blockIdx.x) * nt + tid] = buf[(T & 1) * nt + tid];
}

template <bool kAlign>
cudaError_t launch(const Args& a, int B, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(ctc_kernel<kAlign>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ctc_kernel<kAlign><<<B, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Trellis mode when tok_idx is null (writes `trellis`), align mode otherwise
// (writes tok_idx, probs, active, success, t_start; `trellis` may be null).
// bits_global null keeps the decision bits in shared memory. `smem_bytes` is
// the caller's plan (ops/ctc.py:launch_plan); a plan smaller than this
// layout is refused. threads: a multiple of 32, at most 1024.
extern "C" int ctc_align(const void* lp, const void* tokens, const void* t_len, const void* n_len, const void* col0,
                         void* trellis, void* tok_idx, void* probs, void* active, void* success, void* t_start,
                         void* bits_global, int B, int T, int N, int V, int blank, int threads, int chunk,
                         long long smem_bytes, void* stream) {
  const bool align = tok_idx != nullptr;
  const size_t need = 4 * smem_words(T, N, V, chunk, align && bits_global == nullptr);
  if (need > static_cast<size_t>(smem_bytes) || threads % 32 != 0 || threads > 1024 || chunk < 1 || N < 0 ||
      (align && N < 1) || blank < 0 || blank >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.lp = static_cast<const float*>(lp);
  a.tokens = static_cast<const int64_t*>(tokens);
  a.t_len = static_cast<const int64_t*>(t_len);
  a.n_len = static_cast<const int64_t*>(n_len);
  a.col0 = static_cast<const float*>(col0);
  a.trellis = static_cast<float*>(trellis);
  a.tok_idx = static_cast<int64_t*>(tok_idx);
  a.probs = static_cast<float*>(probs);
  a.active = static_cast<bool*>(active);
  a.success = static_cast<bool*>(success);
  a.t_start = static_cast<int64_t*>(t_start);
  a.bits_global = static_cast<uint32_t*>(bits_global);
  a.T = T;
  a.N = N;
  a.V = V;
  a.blank = blank;
  a.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = align ? launch<true>(a, B, threads, need, st) : launch<false>(a, B, threads, need, st);
  return static_cast<int>(e);
}

// B CTAs of `threads` threads, each T barriered steps (the dependency bound's
// probe); out: B x threads floats.
extern "C" int ctc_barrier_steps(int B, int T, int threads, void* out, void* stream) {
  barrier_steps<<<B, threads, 2 * threads * sizeof(float), static_cast<cudaStream_t>(stream)>>>(T, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
