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
// Two fp32 adds in the plain version's order, then their max. The inputs are
// log-softmax emissions (finite, at most 0) and a first column of finite
// values and +inf, so no cell is NaN; the kernel reads -0.0 as +0.0, so no
// cell is -0.0 and a tie is the same bits either way (with -0.0 in the
// inputs the outputs are equal as numbers, a zero's sign aside).
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
// 16 MFLOP, far less. The recurrence is T dependent steps, and a step cannot
// take less than one exchange of a neighbour between lanes, one fp32 add and
// one compare-select: chip_smoke.py measures that chain (ctc_shuffle_steps)
// as the function's bound. ctc_barrier_steps measures the barriered design's
// floor, one barrier of a CTA a step.
//
// Design: one warp a segment, the trellis row in registers (PERF.md has the
// measurements behind each choice).
//  - Virtual columns v = 0 .. 32 K W - 1, K slots a lane (8, 16, 32 or 64),
//    W warps (W > 1 only at 64 slots, above 2,048 columns). Lane l of warp w
//    holds v = (32 w + l) K + k in its slot k (the strided layout,
//    v = 32 (w K + k) + l with K shuffles and K ballots a step, measured
//    slower: PERF.md), so a step is one
//    __shfl_up_sync of slot K - 1 (the left neighbour of slot 0) and K
//    independent columns: stay and advance (two fp32 adds), their max, and
//    the decision bit advance > stay as the sign bit of stay - advance (a
//    third add, on the FMA pipe; an infinity minus itself is the GPU's
//    canonical NaN, sign clear), shifted into the lane's K-bit word. At the
//    alignment path's K 16 that is 97 instructions a step (cuobjdump of the
//    sm_90a build): 48 FADD, 16 FMNMX, 14 funnel shifts, 4.25 LDS.128, one
//    SHFL, one STS, the argmax and the addresses. The words of a row, lane
//    after lane, are its bits in column order. With W > 1, warp w
//    - 1 posts its last column of each row to warp w's mailbox in shared
//    memory (row and value in one 64-bit word); the W warps never wait at a
//    barrier inside a chunk.
//  - Emissions: a ring of `stages` chunks of `rows` rows in shared memory,
//    each ring column (a vocabulary id, then -0.0, column 1's advance X, and
//    col0) holding its rows contiguously, so one 16-byte load gives a slot 4
//    rows (K 64: one row a load). The warps that do not compute fill chunk
//    c + 1 while the others run chunk c; one CTA barrier a chunk hands it
//    over. No step waits on device memory.
//  - Trellis mode (the trellis is the output): column j sits at v = j - 1,
//    and lane 0 of warp 0 takes column 0's value col0[t] as its left
//    neighbour. Every lane stores its K cells of each row.
//  - Align mode: the columns are shifted right so that column n_len sits at
//    the last slot of the last lane (v = 32 K W - 1): the lane that owns it
//    tracks the argmax of that register, a static slot, with no per-step
//    selection among K registers. Column j sits at v = j - 1 + s, s =
//    32 K W - n_len. The s virtual columns left of column 1 hold -0.0 with
//    -0.0 as their emission (ring column V): for a blank log-prob at most 0
//    the max keeps a signed zero (stay = bl <= advance = -0). Column 1's
//    emission is the ring's column V + 1, X_t = col0[t] + lp[t][tok[0]] (the
//    plain version's advance, one fp32 add), so its advance is +-0 + X_t =
//    X_t bit for bit (X_t is never -0.0). A blank above 0 (not a
//    log-probability) traps.
//  - Decision bits: T rows (to a whole 4-row load) of 32 K W bits, in shared
//    memory where they fit (96 KB at the alignment path's shapes), else in a
//    scratch buffer the caller allocates.
//  - The walk: warp 0, 32 steps at a time. Lane i reads the 32 bits of
//    row T - 1 - (k0 + i) at the columns the pointer can reach in the block
//    (two words and a funnel shift); every lane then takes every lane's word
//    by shuffles and runs the 32 dependent steps in registers (shift, and,
//    subtract) and writes the pointer before its own step. Then all the
//    CTA's threads turn the pointers into the outputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kEpilogueWarps = 8;
constexpr int kMaxWarps = 11;  // computing warps at K 64 (registers: 384 threads of ~150, one warp fills the ring)
constexpr int kMaxRows = 32;  // emission rows a ring stage holds at most
// Rows a warp's mailbox holds: two ring stages, so that a row's value is read
// before the chunk barrier after next lets its writer overwrite it.
constexpr int kMailbox = 2 * kMaxRows;

struct Args {
  const float* lp;        // (B, T, V) fp32 log-probs
  const int64_t* tokens;  // (B, N)
  const int64_t* t_len;   // (B,)
  const int64_t* n_len;   // (B,)
  const float* col0;      // (B, T + 1) column 0 of the trellis
  float* trellis;         // (B, T + 1, N + 1), or null: align mode
  int64_t* tok_idx;       // (B, T), or null: trellis mode
  float* probs;           // (B, T)
  bool* active;           // (B, T)
  bool* success;          // (B,)
  int64_t* t_start;       // (B,)
  uint32_t* bits_global;  // (B, bit_rows(T), K W), or null: the bits in shared memory
  int T, N, V, blank, warps, rows, stages;
};

// Shared memory, in 4-byte words: the emission ring, `stages` stages of V + 3
// columns (the V emissions, -0.0, column 1's advance X, col0) of `rows` rows
// each, a column's rows contiguous at row_pitch apart; the W warps' mailboxes
// (W x kMailbox 64-bit words, when a 64-slot plan has W > 1), t_start (1),
// then at a 16-byte boundary the decision bits (T x K W) where they are kept
// here.
struct Layout {
  size_t ring, mbox, misc, bits, total;
};

// A ring column's pitch in floats. Plans below 64 slots read 4 rows a load
// (16 bytes): the pitch is a multiple of 4 whose quarter is odd, so the 8
// lanes of a load phase that read different columns hit different bank
// groups unless their token ids agree mod 8. 64-slot plans read a row a load:
// an odd pitch does the same for the banks of 32 lanes.
__host__ __device__ inline int row_pitch(int rows, int slots) {
  if (slots == 64) return rows | 1;
  return rows + 4 + (((rows / 4) & 1) ? 4 : 0);
}

// Rows of decision bits: T, to a whole 4-row load.
__host__ __device__ inline int bit_rows(int T) { return (T + 3) & ~3; }

__host__ __device__ inline Layout layout(int T, int V, int slots, int warps, int rows, int stages, bool bits_here) {
  Layout l;
  l.ring = 0;
  l.mbox = (static_cast<size_t>(stages) * (V + 3) * row_pitch(rows, slots) + 1) & ~static_cast<size_t>(1);
  l.misc = l.mbox + (warps > 1 ? 2 * static_cast<size_t>(warps) * kMailbox : 0);
  l.bits = (l.misc + 1 + 3) & ~static_cast<size_t>(3);
  l.total = bits_here ? l.bits + static_cast<size_t>(bit_rows(T)) * slots * warps : l.misc + 1;
  return l;
}

__device__ __forceinline__ float plus_zero(float v) { return v == 0.0f ? 0.0f : v; }  // -0.0 as +0.0

// VW consecutive rows of one ring column at a shared-memory byte address.
template <int VW>
struct Rows {
  float r[VW];
};
template <int VW>
__device__ __forceinline__ Rows<VW> ld_rows(uint32_t addr) {
  Rows<VW> v;
  if constexpr (VW == 4)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.r[0]), "=f"(v.r[1]), "=f"(v.r[2]), "=f"(v.r[3])
                 : "r"(addr));
  else
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v.r[0]) : "r"(addr));
  return v;
}

// The mailbox between warp w and warp w + 1: row r's value of warp w's last
// column as one 64-bit word (r << 32 | float bits), so a reader sees value
// and row together.
__device__ __forceinline__ void post(uint32_t addr, int row, float v) {
  const uint64_t x = (static_cast<uint64_t>(static_cast<uint32_t>(row)) << 32) | __float_as_uint(v);
  asm volatile("st.volatile.shared.u64 [%0], %1;\n" ::"r"(addr), "l"(x) : "memory");
}
__device__ __forceinline__ float take_post(uint32_t addr, int row) {
  uint64_t x;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile("ld.volatile.shared.u64 %0, [%1];\n" : "=l"(x) : "r"(addr) : "memory");
    if (static_cast<int>(x >> 32) == row) break;
    if (spins == (1u << 28)) __trap();  // a neighbour that never posts: fail the launch, do not hang
  }
  return __uint_as_float(static_cast<uint32_t>(x));
}

// Virtual column of slot k of lane `lane` in warp `warp`.
template <int K>
__device__ __forceinline__ int virtual_column(int warp, int lane, int k) {
  return (warp * 32 + lane) * K + k;
}

// The warps that do not compute fill the ring: each chunk's emissions and
// col0 with -0.0 read as +0.0 (no cell of the trellis is then -0.0, which the
// recurrence's max and sign bit rely on), and in align mode column 1's
// advance X, after checking that the blank log-probs are at most 0.
template <int K, bool kAlign>
__device__ __forceinline__ void fill_ring(const Args& a, float* smem, const Layout& L) {
  const int b = blockIdx.x, W = K == 64 ? a.warps : 1, ptid = threadIdx.x - 32 * W, PT = blockDim.x - 32 * W;
  const int T = a.T, V = a.V, R = a.rows, S = a.stages, RP = row_pitch(R, K), SW = (V + 3) * RP;
  const float* lp = a.lp + static_cast<size_t>(b) * T * V;
  const float* col0 = a.col0 + static_cast<size_t>(b) * (T + 1);
  const int tok0 = kAlign ? static_cast<int>(a.tokens[static_cast<size_t>(b) * a.N]) : 0;
  const int chunks = (T + R - 1) / R;
  for (int c = 0; c < chunks; ++c) {
    if (S == 1) __syncthreads();  // the computing warps are done with chunk c - 1
    const int t0 = c * R, n = min(R, T - t0);
    float* stage = smem + L.ring + static_cast<size_t>(c % S) * SW;
    for (int x = ptid; x < n * V; x += PT) {
      const int i = x / V, col = x - i * V;
      stage[col * RP + i] = plus_zero(lp[static_cast<size_t>(t0) * V + x]);
    }
    for (int i = ptid; i < n; i += PT) {
      const float c0 = plus_zero(col0[t0 + i]);
      stage[(V + 2) * RP + i] = c0;
      if (kAlign) {
        const float* row = lp + static_cast<size_t>(t0 + i) * V;
        if (row[a.blank] > 0.0f) __trap();  // not a log-probability: the signed zeros would not hold
        stage[(V + 1) * RP + i] = c0 + plus_zero(row[tok0]);
      }
    }
    __syncthreads();  // chunk c is in its stage
  }
}

template <int K, bool kAlign, bool kBitsShared>
__device__ __forceinline__ void recurrence(const Args& a, float* smem, const Layout& L, uint32_t* bits, int s, int tl) {
  constexpr int VW = K == 64 ? 1 : 4;  // rows a load covers
  constexpr bool kMulti = K == 64;     // only 64-slot plans split a segment over warps
  using Word = typename std::conditional<K == 64, uint64_t, uint32_t>::type;  // a lane's decision bits
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, N = a.N, V = a.V, W = kMulti ? a.warps : 1, R = a.rows, S = a.stages;
  const int RP = row_pitch(R, K), SW = (V + 3) * RP, words = K * W, N1 = N + 1;
  float* ring = smem + L.ring;
  const int64_t* tok = a.tokens + static_cast<size_t>(b) * N;
  float* trellis = kAlign ? nullptr : a.trellis + static_cast<size_t>(b) * (T + 1) * N1;
  const uint32_t ring_at = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t mbox_at = static_cast<uint32_t>(__cvta_generic_to_shared(smem + L.mbox));
  const uint32_t post_at = mbox_at + 8u * kMailbox * warp, take_at = mbox_at + 8u * kMailbox * (warp - 1);

  float p[K];
  uint32_t at[K];  // shared-memory address of the slot's ring column in stage 0
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = virtual_column<K>(warp, lane, k) - s + 1;  // the slot's trellis column
    int col;
    if (kAlign && j < 1) {  // left of column 1: a signed zero, emission -0.0
      p[k] = -0.0f;
      col = V;
    } else {
      p[k] = -INFINITY;
      col = kAlign && j == 1 ? V + 1 : j <= N ? static_cast<int>(tok[j - 1]) : 0;
    }
    at[k] = ring_at + 4u * static_cast<uint32_t>(col * RP);
  }
  const uint32_t blank_at = ring_at + 4u * static_cast<uint32_t>(a.blank * RP);
  const uint32_t c0_at = ring_at + 4u * static_cast<uint32_t>((V + 2) * RP);
  if (kMulti && W > 1 && warp < W - 1 && lane == 31) post(post_at, 0, p[K - 1]);

  // Chunk c goes into ring stage c % S. With two stages the filling warps
  // write chunk c while the computing warps read chunk c - 1, and one CTA
  // barrier a chunk hands it over; with one stage a second barrier first
  // waits for the stage to be read.
  const int chunks = (T + R - 1) / R;
  float best = -INFINITY;  // column n_len's running argmax (the owner's registers)
  int best_r = 0;
  for (int c = 0; c < chunks; ++c) {
    if (S == 1) __syncthreads();
    __syncthreads();
    // The last chunk runs on to a whole load (nv rows): rows past T change
    // registers only, and no row follows them.
    const int t0 = c * R, n = min(R, T - t0), nv = (n + VW - 1) / VW * VW;
    const uint32_t stage_at = 4u * static_cast<uint32_t>((c % S) * SW);
#pragma unroll(K <= 16 ? 2 : 1)  // two loads' rows at a time where the registers allow (no spills)
    for (int g = 0; g < nv; g += VW) {
      const uint32_t off = stage_at + 4u * g;
      Rows<VW> e[K];
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = ld_rows<VW>(at[k] + off);
      const Rows<VW> blv = ld_rows<VW>(blank_at + off);
      Rows<VW> c0v;
      if constexpr (!kAlign) c0v = ld_rows<VW>(c0_at + off);
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        const int t = t0 + g + u;
        const float bl = blv.r[u];
        float prev_left = 0.0f;  // slot 0's left neighbour from the previous warp (row t)
        if (kMulti && W > 1 && warp > 0) prev_left = take_post(take_at + 8u * (t & (kMailbox - 1)), t);
        float left = __shfl_up_sync(kFullMask, p[K - 1], 1);
        if (lane == 0) {
          if constexpr (kAlign)
            left = warp > 0 ? prev_left : -0.0f;
          else
            left = warp > 0 ? prev_left : c0v.r[u];
        }

        Word word = 0;
#pragma unroll
        for (int k = K - 1; k >= 0; --k) {  // descending: p[k - 1] is still the previous row's
          const float l = k == 0 ? left : p[k - 1];
          // advance > stay is the sign of stay - advance: no cell is -0.0
          // but the signed zeros left of column 1, whose bits go unread, and
          // an infinity minus itself is the GPU's canonical NaN, sign clear.
          // On ties max keeps either: the same bits.
          const float stay = p[k] + bl;
          const float advance = l + e[k].r[u];
          p[k] = fmaxf(stay, advance);
          const uint32_t take = __float_as_uint(stay - advance) >> 31;
          if constexpr (kAlign)
            word = (word << 1) | static_cast<Word>(take);  // slot K - 1 first: bit k is slot k
          if (kMulti && k == K - 1 && W > 1 && warp < W - 1 && lane == 31)
            post(post_at + 8u * ((t + 1) & (kMailbox - 1)), t + 1, p[K - 1]);
        }
        if (kAlign) {  // rows past T too: the bits have rows to the last whole load
          uint32_t* brow = (kBitsShared ? reinterpret_cast<uint32_t*>(smem + L.bits) : bits) + static_cast<size_t>(t) * words;
          if constexpr (K == 8) {
            reinterpret_cast<uint8_t*>(brow)[warp * 32 + lane] = static_cast<uint8_t>(word);
          } else if constexpr (K == 16) {
            reinterpret_cast<uint16_t*>(brow)[warp * 32 + lane] = static_cast<uint16_t>(word);
          } else {
            reinterpret_cast<Word*>(brow)[warp * 32 + lane] = word;  // K bits a lane, lane after lane
          }
          if (t < tl && p[K - 1] > best) {
            best = p[K - 1];
            best_r = t + 1;
          }
        } else if (t < T) {
          float* out = trellis + static_cast<size_t>(t + 1) * N1 + 1;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = virtual_column<K>(warp, lane, k);
            if (v < N) out[v] = p[k];
          }
        }
      }
    }
  }
  if (kAlign && warp == W - 1 && lane == 31) reinterpret_cast<int*>(smem + L.misc)[0] = best_r;
}

template <int K, bool kAlign, bool kBitsShared>
__global__ void __launch_bounds__(K == 64 ? 32 * (kMaxWarps + 1) : 32 * kEpilogueWarps, 1) ctc_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, N = a.N, V = a.V, W = a.warps, words = K * W, N1 = N + 1;
  const Layout L = layout(T, V, K, W, a.rows, a.stages, kBitsShared);
  uint32_t* bits = kBitsShared ? reinterpret_cast<uint32_t*>(smem + L.bits)
                               : a.bits_global + static_cast<size_t>(b) * bit_rows(T) * words;
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  const float* lp = a.lp + static_cast<size_t>(b) * T * V;
  const float* col0 = a.col0 + static_cast<size_t>(b) * (T + 1);
  const int64_t* tok = a.tokens + static_cast<size_t>(b) * N;

  // Indices from the caller, checked on the card as torch.gather checks the
  // plain version's: a token id outside the vocabulary or a token count
  // outside [0, N] traps (a launch error at the next synchronization).
  const int64_t nl64 = kAlign ? a.n_len[b] : N;
  if (nl64 < 0 || nl64 > N) __trap();
  const int nl = static_cast<int>(nl64);
  const int64_t tl64 = kAlign ? a.t_len[b] : 0;
  const int tl = static_cast<int>(tl64 < -1 ? -1 : tl64 > T ? T : tl64);
  for (int j = tid; j < N; j += nt) {
    const int64_t id = tok[j];
    if (id < 0 || id >= V) __trap();
  }
  const int s = kAlign ? 32 * words - nl : 0;  // virtual column of trellis column 1
  if (kAlign) {  // the ring's column V: -0.0, the emission of the columns left of column 1
    const int rp = row_pitch(a.rows, K);
    for (int i = tid; i < a.stages * rp; i += nt) smem[L.ring + static_cast<size_t>(i / rp) * (V + 3) * rp + V * rp + i % rp] = -0.0f;
  } else {
    float* trellis = a.trellis + static_cast<size_t>(b) * (T + 1) * N1;
    for (int j = tid; j < N1; j += nt) trellis[j] = j == 0 ? col0[0] : -INFINITY;
    for (int t = 1 + tid; t <= T; t += nt) trellis[static_cast<size_t>(t) * N1] = col0[t];
  }
  __syncthreads();
  if (!kAlign || nl > 0) {  // the first W warps compute, the others fill the ring
    if (warp < W)
      recurrence<K, kAlign, kBitsShared>(a, smem, L, bits, s, tl);
    else
      fill_ring<K, kAlign>(a, smem, L);
  }
  if (!kAlign) return;
  if (nl == 0 && warp == 0) {  // no token: t_start is the first argmax of column 0 over rows <= t_len
    float bv = -INFINITY;
    int br = 0;
    for (int r = lane; r <= tl; r += 32) {
      const float v = col0[r];
      if (v > bv) {
        bv = v;
        br = r;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(kFullMask, bv, o);
      const int orow = __shfl_down_sync(kFullMask, br, o);
      if (ov > bv || (ov == bv && orow < br)) {
        bv = ov;
        br = orow;
      }
    }
    if (lane == 0) misc[0] = br;
  }
  __syncthreads();
  const int ts = misc[0];
  int64_t* out_idx = a.tok_idx + static_cast<size_t>(b) * T;

  if (warp == 0) {  // the walk, 32 positions a block; position k holds the pointer before its step
    int j = nl;
    for (int k0 = 0; k0 < T; k0 += 32) {
      const int k = k0 + lane, t = T - k;
      const int vb = j - 1 + s - 31;  // the block's pointer stays in virtual columns vb .. vb + 31
      uint32_t m = 0;
      if (j > 0 && k < T && t <= ts) {
        const uint32_t* row = bits + static_cast<size_t>(t - 1) * words;
        const int w0 = vb >> 5;
        const uint32_t lo = w0 >= 0 ? row[w0] : 0u, hi = vb & 31 ? row[w0 + 1] : 0u;  // vb >= -31
        m = __funnelshift_r(lo, hi, vb & 31);
        const int below = s - vb;  // window bits left of column 1
        if (below > 0) m &= below >= 32 ? 0u : ~0u << below;
      }
      uint32_t ms[32];  // every lane's mask in every lane, then the chain in registers
#pragma unroll
      for (int i = 0; i < 32; ++i) ms[i] = __shfl_sync(kFullMask, m, i);
      int e = 31;
      uint32_t moves = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint32_t bit = (ms[i] >> e) & 1u;
        moves |= bit << i;
        e -= static_cast<int>(bit);
      }
      if (k < T) out_idx[k] = j - __popc(moves & ((1u << lane) - 1u));
      j -= __popc(moves);
    }
    if (lane == 0) {
      a.success[b] = j == 0;
      a.t_start[b] = ts;
    }
  }
  __syncthreads();
  const int tok0 = static_cast<int>(tok[0]);
  for (int k = tid; k < T; k += nt) {
    const int r = T - 1 - k;
    const int j = static_cast<int>(out_idx[k]);
    const int jm1 = max(j - 1, 0);
    const float* e = lp + static_cast<size_t>(r) * V;
    const float bl = e[a.blank];
    bool take;
    if (j == 0) {  // the plain walk's own decision at j = 0
      const float c = col0[r];
      take = c + e[tok0] > c + bl;
    } else {
      const int v = j - 1 + s;
      take = (bits[static_cast<size_t>(r) * words + (v >> 5)] >> (v & 31)) & 1u;
    }
    out_idx[k] = jm1;
    a.probs[static_cast<size_t>(b) * T + k] = expf(take ? e[tok[jm1]] : bl);
    a.active[static_cast<size_t>(b) * T + k] = r + 1 <= ts && j > 0;
  }
}

// The barriered design's floor (this kernel before its redesign): T steps
// of an otherwise empty loop, each one shared-memory round trip (a
// neighbour's value from the previous row) and one barrier, as its
// recurrence made them.
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

// The function's dependency bound: T dependent steps of one warp, each one
// __shfl_up_sync of the left neighbour, one fp32 add and one compare-select.
__global__ void shuffle_steps(int T, float* out) {
  const int lane = threadIdx.x;
  const float c = -1.0f / static_cast<float>(lane + 2);
  float x = lane == 0 ? 0.0f : -INFINITY;
  for (int t = 0; t < T; ++t) {
    const float y = __shfl_up_sync(kFullMask, x, 1) + c;
    x = y > x ? y : x;
  }
  out[static_cast<size_t>(blockIdx.x) * 32 + lane] = x;
}

template <int K, bool kAlign, bool kBitsShared>
cudaError_t launch(const Args& a, int B, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(ctc_kernel<K, kAlign, kBitsShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  ctc_kernel<K, kAlign, kBitsShared><<<B, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Trellis mode, align mode with the decision bits in shared memory, align
// mode with them in the caller's scratch buffer.
template <int K>
cudaError_t launch_mode(const Args& a, int B, int threads, size_t smem, cudaStream_t stream) {
  if (a.tok_idx == nullptr) return launch<K, false, false>(a, B, threads, smem, stream);
  return a.bits_global == nullptr ? launch<K, true, true>(a, B, threads, smem, stream)
                                  : launch<K, true, false>(a, B, threads, smem, stream);
}

}  // namespace

// Trellis mode when tok_idx is null (writes `trellis`), align mode otherwise
// (writes tok_idx, probs, active, success, t_start; `trellis` may be null).
// bits_global null keeps the decision bits in shared memory. The plan is the
// caller's (ops/ctc.py:launch_plan): `slots` K of 8, 16, 32 or 64 a lane,
// `warps` W computing warps (32 K W >= N), `threads` a multiple of 32 of at
// least 32 W, emission chunks of `rows` rows in `stages` ring stages, and
// `smem_bytes` no smaller than this layout.
extern "C" int ctc_align(const void* lp, const void* tokens, const void* t_len, const void* n_len, const void* col0,
                         void* trellis, void* tok_idx, void* probs, void* active, void* success, void* t_start,
                         void* bits_global, int B, int T, int N, int V, int blank, int slots, int warps, int threads,
                         int rows, int stages, long long smem_bytes, void* stream) {
  const bool align = tok_idx != nullptr;
  const int max_threads = 32 * (slots == 64 ? kMaxWarps + 1 : kEpilogueWarps);
  if (warps < 1 || (warps > 1 && slots != 64) || 32LL * slots * warps < N || threads % 32 != 0 ||
      threads < 32 * (warps + 1) || threads > max_threads || rows < 1 || rows > kMaxRows || (slots < 64 && rows % 4 != 0) ||
      stages < 1 || stages > 2 || N < 0 ||
      (align && N < 1) || V < 1 || blank < 0 || blank >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(T, V, slots, warps, rows, stages, align && bits_global == nullptr);
  if (4 * L.total > static_cast<size_t>(smem_bytes)) return static_cast<int>(cudaErrorInvalidValue);
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
  a.warps = warps;
  a.rows = rows;
  a.stages = stages;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 4 * L.total;
  switch (slots) {
    case 8: return static_cast<int>(launch_mode<8>(a, B, threads, smem, st));
    case 16: return static_cast<int>(launch_mode<16>(a, B, threads, smem, st));
    case 32: return static_cast<int>(launch_mode<32>(a, B, threads, smem, st));
    case 64: return static_cast<int>(launch_mode<64>(a, B, threads, smem, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B CTAs of `threads` threads, each T barriered steps (the barriered design's
// floor); out: B x threads floats.
extern "C" int ctc_barrier_steps(int B, int T, int threads, void* out, void* stream) {
  barrier_steps<<<B, threads, 2 * threads * sizeof(float), static_cast<cudaStream_t>(stream)>>>(T, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// B warps, each T dependent shuffle steps (the function's dependency bound);
// out: B x 32 floats.
extern "C" int ctc_shuffle_steps(int B, int T, void* out, void* stream) {
  shuffle_steps<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(T, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
