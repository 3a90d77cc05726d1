// Kernel B1: the whole bitpacked MatrixEnvCore.step on Hopper, plus its
// apply-only part for the reset scramble loop.
//
// Replaces the Pallas TPU kernel of the JAX package, ops/pallas_fused.py:
// _fused_kernel (entry fused_step, launcher _fused_call). What it computes
// is the XLA step MatrixEnvCore.step (ops/matrix_env.py), the reference:
//   left multiply   a'    = a ^ U (S a)        (<= 2 rank-1 GF(2) terms)
//   right multiply  ainv' = ainv ^ (ainv U) S  (INV only)
//   metrics update and penalty (metrics.cuh; layer fields only if TRACK)
//   swap a'/ainv' where flip is set, inverted ^= flip (INV only)
//   depth - 1, solved = (a == packed identity), reward = solved - penalty.
// Unlike the Pallas kernel it honours track_layers (TRACK) and supports
// add_inverts=False (INV false: ainv and inverted are left untouched).
//
// State layout (as in the JAX package): a, ainv are [B, W*Dr] words, word
// w of column d at index w*Dr + d holds rows 32w..32w+31 of that column.
// Per-action operands come from one int32 table row [F] (see
// ops/fused_step.py:build_op_table): mtype, q1, q2, then U32[k][w],
// S32[k][w], the <= 2 columns u[k][s] that U's column k selects (-1 if
// absent), and Slm[k] as a Dr-bit column mask in max(W, 2) words (for
// W <= 2 the two words of a 64-bit mask).
//
// Two designs. For W <= 2 (Dr <= 64), one warp per env, templated on W, as
// described next. For W >= 3 (Clifford above 32 qubits, the other families
// above 64), one block per env streaming its words in memory order, W at run
// time; see "Wide states" below.
//
// Bound: bytes. Per env (27q Clifford, W=2, Dr=54) the step reads and
// writes a and ainv (864 B each way) plus ~30 B of scalars, and does a few
// hundred integer operations, so it is far below the card's ratio of
// operations to bytes. Design: one warp per env, 8 envs per block. Lane t
// owns columns t and t+32 (Dr <= 64), so the loads and stores of each
// W-slice are contiguous. The left multiply is a per-column popcount parity,
// no data exchange. The right multiply needs two whole columns of ainv: the
// column index is warp-uniform, so one __shfl_sync per word fetches it. The
// solved flag is one __all_sync. Everything stays in registers; the table
// row is tiny and cached.
#include <cstdint>

#include <cuda_runtime.h>

#include "metrics.cuh"

namespace qgt {

constexpr int kK = 2;  // rank terms per action
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int W>
struct Cols {
  static constexpr int kU = 3;
  static constexpr int kS = 3 + kK * W;
  static constexpr int kUcol = 3 + 2 * kK * W;
  static constexpr int kSlm = kUcol + 2 * kK;
  static constexpr int kF = kSlm + 2 * kK;
};

struct StepArgs {
  const int64_t* action;
  const uint8_t* flip;
  const uint32_t* a;
  const uint32_t* ainv;
  const int32_t* last_g;
  const int32_t* last_c;
  const int32_t* depth;
  const uint8_t* inverted;
  const int32_t* max_g;
  const int32_t* max_c;
  const int32_t* n_cnots;
  const int32_t* n_gates;
  const int32_t* tab;
  uint32_t* o_a;
  uint32_t* o_ainv;
  int32_t* o_last_g;
  int32_t* o_last_c;
  int32_t* o_depth;
  uint8_t* o_success;
  float* o_reward;
  uint8_t* o_inverted;
  int32_t* o_max_g;
  int32_t* o_max_c;
  int32_t* o_n_cnots;
  int32_t* o_n_gates;
  int B, Dr, n, noop_action;
  float w0, w1, w2, w3;
};

// Word w of column u of the warp's matrix (held as mv[j][w] by lane u % 32,
// slot u / 32); 0 when the column is absent (u < 0). u is warp-uniform.
template <int W>
__device__ __forceinline__ uint32_t column_word(const uint32_t (&mv)[2][W],
                                                int w, int u) {
  if (u < 0) return 0u;
  const uint32_t lo = __shfl_sync(kFull, mv[0][w], u & 31);
  const uint32_t hi = __shfl_sync(kFull, mv[1][w], u & 31);
  return u < 32 ? lo : hi;
}

// a' = (I ^ U S) a and, if INV, m' = m (I ^ U S), in registers.
template <int W, bool INV>
__device__ __forceinline__ void apply_terms(const int32_t* __restrict__ row,
                                            int lane, uint32_t (&av)[2][W],
                                            uint32_t (&mv)[2][W]) {
  using C = Cols<W>;
  uint32_t acc[2][W] = {};
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    uint32_t U[W], S[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      U[w] = static_cast<uint32_t>(row[C::kU + k * W + w]);
      S[w] = static_cast<uint32_t>(row[C::kS + k * W + w]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t x = 0u;
#pragma unroll
      for (int w = 0; w < W; ++w) x ^= av[j][w] & S[w];
      const uint32_t sel = 0u - static_cast<uint32_t>(__popc(x) & 1);
#pragma unroll
      for (int w = 0; w < W; ++w) acc[j][w] ^= U[w] & sel;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int w = 0; w < W; ++w) av[j][w] ^= acc[j][w];
  if (!INV) return;

  uint32_t racc[2][W] = {};
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int u0 = row[C::kUcol + 2 * k];
    const int u1 = row[C::kUcol + 2 * k + 1];
    const uint64_t slm =
        static_cast<uint64_t>(static_cast<uint32_t>(row[C::kSlm + 2 * k])) |
        (static_cast<uint64_t>(static_cast<uint32_t>(row[C::kSlm + 2 * k + 1]))
         << 32);
    uint32_t c[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
      c[w] = column_word<W>(mv, w, u0) ^ column_word<W>(mv, w, u1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = lane + 32 * j;
      const uint32_t sel = 0u - static_cast<uint32_t>((slm >> d) & 1u);
#pragma unroll
      for (int w = 0; w < W; ++w) racc[j][w] ^= c[w] & sel;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int w = 0; w < W; ++w) mv[j][w] ^= racc[j][w];
}

template <int W, bool INV>
__device__ __forceinline__ void load_state(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ ainv,
                                           size_t base, int Dr, int lane,
                                           uint32_t (&av)[2][W],
                                           uint32_t (&mv)[2][W]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = lane + 32 * j;
    const bool ok = d < Dr;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      av[j][w] = ok ? a[base + w * Dr + d] : 0u;
      mv[j][w] = (INV && ok) ? ainv[base + w * Dr + d] : 0u;
    }
  }
}

template <int W, bool TRACK, bool INV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_step_kernel(const StepArgs p) {
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (env >= p.B) return;  // warp-uniform: whole warps leave together
  const int act = static_cast<int>(p.action[env]);
  const int32_t* row = p.tab + static_cast<size_t>(act) * Cols<W>::kF;
  const int Dr = p.Dr;
  const size_t base = static_cast<size_t>(env) * W * Dr;

  uint32_t av[2][W], mv[2][W];
  load_state<W, INV>(p.a, p.ainv, base, Dr, lane, av, mv);
  apply_terms<W, INV>(row, lane, av, mv);

  const bool flip = INV && p.flip[env] != 0;
  bool eq = true;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = lane + 32 * j;
    if (d >= Dr) continue;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t sa = flip ? mv[j][w] : av[j][w];
      p.o_a[base + w * Dr + d] = sa;
      if (INV) p.o_ainv[base + w * Dr + d] = flip ? av[j][w] : mv[j][w];
      const uint32_t ident = (d >> 5) == w ? (1u << (d & 31)) : 0u;
      eq = eq && sa == ident;
    }
  }
  const bool success = __all_sync(kFull, eq);

  const int mtype = row[0], q1 = row[1], q2 = row[2];
  const bool noop = act == p.noop_action;
  const size_t qrow = static_cast<size_t>(env) * p.n;
  int lg1 = 0, lg2 = 0, lc1 = 0, lc2 = 0;
  if (TRACK) {
    lg1 = p.last_g[qrow + q1];
    lg2 = p.last_g[qrow + q2];
    lc1 = p.last_c[qrow + q1];
    lc2 = p.last_c[qrow + q2];
  }
  const MetricsOut m = metrics_update<TRACK>(
      mtype, noop, lg1, lg2, lc1, lc2, TRACK ? p.max_g[env] : 0,
      TRACK ? p.max_c[env] : 0, p.n_cnots[env], p.n_gates[env], p.w0, p.w1,
      p.w2, p.w3);
  if (TRACK) {
    write_layer_row(p.last_g + qrow, p.o_last_g + qrow, p.n, q1, q2, m.v1,
                    m.v2, lane);
    write_layer_row(p.last_c + qrow, p.o_last_c + qrow, p.n, q1, q2, m.w1,
                    m.w2, lane);
  }
  if (lane == 0) {
    p.o_depth[env] = max(p.depth[env] - 1, 0);
    p.o_success[env] = success ? 1 : 0;
    p.o_reward[env] = __fsub_rn(success ? 1.0f : 0.0f, m.penalty);
    p.o_n_cnots[env] = m.n_cnots;
    p.o_n_gates[env] = m.n_gates;
    if (TRACK) {
      p.o_max_g[env] = m.max_g;
      p.o_max_c[env] = m.max_c;
    }
    if (INV) p.o_inverted[env] = (p.inverted[env] != 0) != flip ? 1 : 0;
  }
}

template <int W, bool INV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
apply_kernel(const int64_t* __restrict__ action,
             const uint32_t* __restrict__ a, const uint32_t* __restrict__ ainv,
             const int32_t* __restrict__ tab, uint32_t* __restrict__ o_a,
             uint32_t* __restrict__ o_ainv, int B, int Dr) {
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (env >= B) return;
  const int32_t* row =
      tab + static_cast<size_t>(action[env]) * Cols<W>::kF;
  const size_t base = static_cast<size_t>(env) * W * Dr;
  uint32_t av[2][W], mv[2][W];
  load_state<W, INV>(a, ainv, base, Dr, lane, av, mv);
  apply_terms<W, INV>(row, lane, av, mv);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = lane + 32 * j;
    if (d >= Dr) continue;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      o_a[base + w * Dr + d] = av[j][w];
      if (INV) o_ainv[base + w * Dr + d] = mv[j][w];
    }
  }
}

template <int W, bool TRACK, bool INV>
void launch_step(const StepArgs& p, cudaStream_t st) {
  const dim3 grid((p.B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  fused_step_kernel<W, TRACK, INV><<<grid, kWarpsPerBlock * 32, 0, st>>>(p);
}

template <int W>
void dispatch_step(const StepArgs& p, bool track, bool inv, cudaStream_t st) {
  if (track) {
    if (inv) launch_step<W, true, true>(p, st);
    else launch_step<W, true, false>(p, st);
  } else {
    if (inv) launch_step<W, false, true>(p, st);
    else launch_step<W, false, false>(p, st);
  }
}

template <int W, bool INV>
void launch_apply(const int64_t* action, const uint32_t* a,
                  const uint32_t* ainv, const int32_t* tab, uint32_t* o_a,
                  uint32_t* o_ainv, int B, int Dr, cudaStream_t st) {
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  apply_kernel<W, INV><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      action, a, ainv, tab, o_a, o_ainv, B, Dr);
}

// ---------------------------------------------------------------------------
// Wide states (W >= 3: Clifford above 32 qubits, the other families above 64
// rows): the same step as above, and like it the counterpart of the JAX
// package's Pallas kernel ops/pallas_fused.py:_fused_kernel. Bound: bytes.
// Per env it reads a and ainv once and writes them once, 4*W*Dr bytes each
// way (397.3 MB at 433 qubits, B=1024: 118.60 us at 3.35 TB/s; 266.7 MB at
// 127 qubits, B=8192: 79.60 us), against ~10 integer operations a word. So
// the step is a copy that changes a few words, and it is built like one.
//
// Design: one block per env streams the env's W*Dr words of a and of ainv
// in the order they lie in memory, each word loaded once into a register
// and stored once, so a warp's accesses are runs of adjacent words, as a
// copy's are: 16-byte accesses where the env's words start on a 16-byte
// mark (W*Dr % 4 == 0 and 16-byte aligned tensors; else 4-byte ones),
// kWideUnroll of them in flight a thread a round, the first round loaded
// before the block stages. What a word needs from the rest of the env is
// staged first, in shared memory: U_k and the right multiply's
// C_k = col(u0) ^ col(u1) of ainv (a word a row each), Slm_k, and sel_k,
// the left multiply's parity of each column under S_k (a bit a column,
// taken from the rows that S selects, which a block-uniform test finds: at
// most two a term for every gate of the shipped gate sets, so those rows
// are read twice, the second time from L2). Word (w, d) of a' is then
// a ^ (U_0[w] & sel_0(d)) ^ (U_1[w] & sel_1(d)), and of ainv'
// m ^ (C_0[w] & Slm_0(d)) ^ (C_1[w] & Slm_1(d)): two 16-byte shared loads
// a word. The solved flag is one __syncthreads_and; warp 0 runs the metrics
// update (metrics.cuh) and writes the scalars.
//
// Why this shape, measured on one H100 (PERF.md): a first design cut each
// env into tiles of 128 columns, a thread per column holding its W words in
// registers (templated on a bucket of W), the env's tiles one thread-block
// cluster whose AND went through distributed shared memory. It took 400 us
// at 433 qubits, slower than the kernel it replaced: 3 blocks an SM at 152
// registers, a warp's accesses 128-byte pieces of rows 3464 bytes apart,
// and (likely) the cluster barrier's release waiting on the block's
// stores. One block per env needs no flag across blocks. Threads: 512 for
// an env of 4096 or more accesses (433 qubits: 6062 of 16 bytes, 1024
// blocks at 2 an SM), else 256 (127 qubits: 508); each was the faster at
// its shape. The two -D settings below are what scripts/wide_kernel_probe.py
// sweeps.
#ifndef QGT_B1_WIDE_THREADS
#define QGT_B1_WIDE_THREADS 512
#endif
#ifndef QGT_B1_WIDE_UNROLL
#define QGT_B1_WIDE_UNROLL 2
#endif

constexpr int kWideThreads = QGT_B1_WIDE_THREADS;  // threads of a block, most
constexpr int kWideUnroll = QGT_B1_WIDE_UNROLL;    // accesses a thread a round

struct WideCols {
  int u, s, ucol, slm, f;
  __host__ __device__ explicit WideCols(int W)
      : u(3),
        s(3 + kK * W),
        ucol(3 + 2 * kK * W),
        slm(3 + 2 * kK * W + 2 * kK),
        f(3 + 2 * kK * W + 2 * kK + kK * W) {}
};

// Shared memory of a wide block: per word row w, {U_0, U_1, C_0, C_1}[w];
// per 32-column group q, {sel_0, sel_1, Slm_0, Slm_1}[q] (bit d & 31 of
// column d); and S_0, S_1 for the staging. 16 (W + Wq) + 8 W bytes.
inline size_t wide_smem(int W, int Dr) {
  return 16 * static_cast<size_t>(W + (Dr + 31) / 32) + 8 * W;
}

__device__ __forceinline__ uint32_t tab_word(const int32_t* row, int i) {
  return static_cast<uint32_t>(__ldg(row + i));
}

// Stage the env's operands in shared memory (see wide_smem); ends with a
// barrier. `a` and `m` point at the env's first word.
template <bool INV>
__device__ __forceinline__ void stage_wide(const int32_t* __restrict__ row,
                                           const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ m,
                                           int W, int Dr, uint4* uc,
                                           uint4* sr) {
  const WideCols c(W);
  const int Wq = (Dr + 31) / 32;
  uint32_t* ucw = reinterpret_cast<uint32_t*>(uc);
  uint32_t* srw = reinterpret_cast<uint32_t*>(sr);
  uint32_t* S = reinterpret_cast<uint32_t*>(sr + Wq);  // [2][W]
  for (int i = threadIdx.x; i < kK * W; i += blockDim.x) {
    const int k = i / W, w = i - k * W;
    ucw[4 * w + k] = tab_word(row, c.u + i);
    S[i] = tab_word(row, c.s + i);
    if (INV) {
      const int u0 = __ldg(row + c.ucol + 2 * k);
      const int u1 = __ldg(row + c.ucol + 2 * k + 1);
      const uint32_t* col = m + static_cast<size_t>(w) * Dr;
      ucw[4 * w + 2 + k] = (u0 >= 0 ? col[u0] : 0u) ^ (u1 >= 0 ? col[u1] : 0u);
    }
  }
  for (int i = threadIdx.x; i < kK * Wq; i += blockDim.x) {
    const int k = i / Wq, q = i - k * Wq;
    srw[4 * q + 2 + k] = INV ? tab_word(row, c.slm + k * W + q) : 0u;
  }
  __syncthreads();
  // sel_k bit d: the parity of column d of a under S_k, from the rows that
  // S selects (a block-uniform test); a warp's 32 columns are one word
  const int lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < 32 * Wq; d += blockDim.x) {
    uint32_t x0 = 0u, x1 = 0u;
    for (int w = 0; w < W; ++w) {
      const uint32_t s0 = S[w], s1 = S[W + w];
      if ((s0 | s1) != 0u && d < Dr) {
        const uint32_t v = a[static_cast<size_t>(w) * Dr + d];
        x0 ^= v & s0;
        x1 ^= v & s1;
      }
    }
    const uint32_t b0 = __ballot_sync(kFull, __popc(x0) & 1);
    const uint32_t b1 = __ballot_sync(kFull, __popc(x1) & 1);
    if (lane == 0) {
      srw[4 * (d >> 5)] = b0;
      srw[4 * (d >> 5) + 1] = b1;
    }
  }
  __syncthreads();
}

// E consecutive words of a matrix, moved as one access (E = 1 or 4).
template <int E>
struct Words {
  uint32_t w[E];
};

template <int E>
__device__ __forceinline__ Words<E> load_words(const uint32_t* __restrict__ p,
                                               int e) {
  Words<E> r;
  if constexpr (E == 4) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[e];
    r.w[0] = v.x;
    r.w[1] = v.y;
    r.w[2] = v.z;
    r.w[3] = v.w;
  } else {
    r.w[0] = p[e];
  }
  return r;
}

template <int E>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ p, int e,
                                            const Words<E>& v) {
  if constexpr (E == 4)
    reinterpret_cast<uint4*>(p)[e] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  else
    p[e] = v.w[0];
}

// A thread's elements (E words each): element t, t + blockDim, ...,
// kWideUnroll of them a round.
template <bool INV, int E>
__device__ __forceinline__ void load_round(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ m,
                                           int n, int e0,
                                           Words<E> (&av)[kWideUnroll],
                                           Words<E> (&mv)[kWideUnroll]) {
#pragma unroll
  for (int j = 0; j < kWideUnroll; ++j) {
    const int e = e0 + j * static_cast<int>(blockDim.x);
    if (e < n) {
      av[j] = load_words<E>(a, e);
      if (INV) mv[j] = load_words<E>(m, e);
    }
  }
}

// Stream the env's L = W * Dr words, E at a time: word i (row w = i / Dr,
// column d = i % Dr) of a' = a ^ U_0 sel_0 ^ U_1 sel_1 and, if INV, of
// m' = m ^ C_0 Slm_0 ^ C_1 Slm_1, written to (out_a, out_m) or, where flip
// is set, to (out_m, out_a). The first round was loaded (av, mv) before the
// staging. Returns whether every word written as the new a is the
// identity's.
template <bool INV, int E>
__device__ __forceinline__ bool stream_wide(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ m,
    uint32_t* __restrict__ out_a, uint32_t* __restrict__ out_m, bool flip,
    int W, int Dr, const uint4* uc, const uint4* sr,
    Words<E> (&av)[kWideUnroll], Words<E> (&mv)[kWideUnroll]) {
  const int n = W * Dr / E;
  const int step = blockDim.x;
  const int first = static_cast<int>(threadIdx.x);
  int w = first * E / Dr, d = first * E - w * Dr;  // of the element's word 0
  bool eq = true;
  for (int e0 = first; e0 < n; e0 += kWideUnroll * step) {
    if (e0 != first) load_round<INV, E>(a, m, n, e0, av, mv);
#pragma unroll
    for (int j = 0; j < kWideUnroll; ++j) {
      const int e = e0 + j * step;
      if (e < n) {
        Words<E> oa, om;
        int wk = w, dk = d;
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const uint4 o = uc[wk];       // U_0, U_1, C_0, C_1 of row wk
          const uint4 b = sr[dk >> 5];  // sel_0, sel_1, Slm_0, Slm_1
          const int sh = dk & 31;
          const uint32_t na = av[j].w[k] ^ (o.x & (0u - ((b.x >> sh) & 1u))) ^
                              (o.y & (0u - ((b.y >> sh) & 1u)));
          uint32_t sa = na;
          if (INV) {
            const uint32_t nm = mv[j].w[k] ^
                                (o.z & (0u - ((b.z >> sh) & 1u))) ^
                                (o.w & (0u - ((b.w >> sh) & 1u)));
            sa = flip ? nm : na;
            om.w[k] = flip ? na : nm;
          }
          oa.w[k] = sa;
          eq = eq && sa == ((dk >> 5) == wk ? (1u << sh) : 0u);
          if (++dk == Dr) {
            dk = 0;
            ++wk;
          }
        }
        store_words<E>(out_a, e, oa);
        if (INV) store_words<E>(out_m, e, om);
      }
      d += E * step;
      while (d >= Dr) {
        d -= Dr;
        ++w;
      }
    }
  }
  return eq;
}

template <bool TRACK, bool INV, int E>
__global__ void __launch_bounds__(kWideThreads)
fused_step_wide_kernel(const StepArgs p, int W) {
  extern __shared__ uint4 wide_sm[];
  const int env = blockIdx.x;
  const int Dr = p.Dr;
  const size_t base = static_cast<size_t>(env) * W * Dr;
  Words<E> av[kWideUnroll], mv[kWideUnroll];
  load_round<INV, E>(p.a + base, p.ainv + base, W * Dr / E, threadIdx.x, av,
                     mv);
  const int act = static_cast<int>(p.action[env]);
  const int32_t* row = p.tab + static_cast<size_t>(act) * WideCols(W).f;
  uint4* uc = wide_sm;
  uint4* sr = wide_sm + W;
  stage_wide<INV>(row, p.a + base, p.ainv + base, W, Dr, uc, sr);
  const bool flip = INV && p.flip[env] != 0;
  const bool eq = stream_wide<INV, E>(p.a + base, p.ainv + base,
                                      p.o_a + base,
                                      INV ? p.o_ainv + base : nullptr, flip,
                                      W, Dr, uc, sr, av, mv);
  const bool success = __syncthreads_and(eq) != 0;
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const int mtype = row[0], q1 = row[1], q2 = row[2];
  const bool noop = act == p.noop_action;
  const size_t qrow = static_cast<size_t>(env) * p.n;
  int lg1 = 0, lg2 = 0, lc1 = 0, lc2 = 0;
  if (TRACK) {
    lg1 = p.last_g[qrow + q1];
    lg2 = p.last_g[qrow + q2];
    lc1 = p.last_c[qrow + q1];
    lc2 = p.last_c[qrow + q2];
  }
  const MetricsOut mo = metrics_update<TRACK>(
      mtype, noop, lg1, lg2, lc1, lc2, TRACK ? p.max_g[env] : 0,
      TRACK ? p.max_c[env] : 0, p.n_cnots[env], p.n_gates[env], p.w0, p.w1,
      p.w2, p.w3);
  if (TRACK) {
    write_layer_row(p.last_g + qrow, p.o_last_g + qrow, p.n, q1, q2, mo.v1,
                    mo.v2, lane);
    write_layer_row(p.last_c + qrow, p.o_last_c + qrow, p.n, q1, q2, mo.w1,
                    mo.w2, lane);
  }
  if (lane == 0) {
    p.o_depth[env] = max(p.depth[env] - 1, 0);
    p.o_success[env] = success ? 1 : 0;
    p.o_reward[env] = __fsub_rn(success ? 1.0f : 0.0f, mo.penalty);
    p.o_n_cnots[env] = mo.n_cnots;
    p.o_n_gates[env] = mo.n_gates;
    if (TRACK) {
      p.o_max_g[env] = mo.max_g;
      p.o_max_c[env] = mo.max_c;
    }
    if (INV) p.o_inverted[env] = (p.inverted[env] != 0) != flip ? 1 : 0;
  }
}

template <bool INV, int E>
__global__ void __launch_bounds__(kWideThreads)
apply_wide_kernel(const int64_t* __restrict__ action,
                  const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ ainv,
                  const int32_t* __restrict__ tab, uint32_t* __restrict__ o_a,
                  uint32_t* __restrict__ o_ainv, int W, int Dr) {
  extern __shared__ uint4 wide_sm[];
  const int env = blockIdx.x;
  const size_t base = static_cast<size_t>(env) * W * Dr;
  Words<E> av[kWideUnroll], mv[kWideUnroll];
  load_round<INV, E>(a + base, ainv + base, W * Dr / E, threadIdx.x, av, mv);
  const int32_t* row = tab + static_cast<size_t>(action[env]) * WideCols(W).f;
  uint4* uc = wide_sm;
  uint4* sr = wide_sm + W;
  stage_wide<INV>(row, a + base, ainv + base, W, Dr, uc, sr);
  stream_wide<INV, E>(a + base, ainv + base, o_a + base,
                      INV ? o_ainv + base : nullptr, false, W, Dr, uc, sr, av,
                      mv);
}

// Words an access of the wide kernels: 4 (16-byte loads and stores) where
// every env's words start on a 16-byte mark, else 1.
inline int wide_vec(int W, int Dr, const void* a, const void* m,
                    const void* oa, const void* om) {
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return (W * Dr) % 4 == 0 && aligned(a) && aligned(m) && aligned(oa) &&
                 (om == nullptr || aligned(om))
             ? 4
             : 1;
}

// Threads of a wide block for an env of n accesses: kWideThreads where a
// block of half as many would take 16 accesses a thread or more, else half.
inline int wide_threads(int n) {
  return n >= 16 * (kWideThreads / 2) ? kWideThreads : kWideThreads / 2;
}

template <bool TRACK, bool INV>
void launch_step_wide(const StepArgs& p, int W, cudaStream_t st) {
  const size_t smem = wide_smem(W, p.Dr);
  const int E = wide_vec(W, p.Dr, p.a, p.ainv, p.o_a, INV ? p.o_ainv : nullptr);
  const int threads = wide_threads(W * p.Dr / E);
  if (E == 4)
    fused_step_wide_kernel<TRACK, INV, 4><<<p.B, threads, smem, st>>>(p, W);
  else
    fused_step_wide_kernel<TRACK, INV, 1><<<p.B, threads, smem, st>>>(p, W);
}

void dispatch_step_wide(const StepArgs& p, int W, bool track, bool inv,
                        cudaStream_t st) {
  if (track) {
    if (inv) launch_step_wide<true, true>(p, W, st);
    else launch_step_wide<true, false>(p, W, st);
  } else {
    if (inv) launch_step_wide<false, true>(p, W, st);
    else launch_step_wide<false, false>(p, W, st);
  }
}

template <bool INV>
void launch_apply_wide(const int64_t* action, const uint32_t* a,
                       const uint32_t* ainv, const int32_t* tab,
                       uint32_t* o_a, uint32_t* o_ainv, int B, int W, int Dr,
                       cudaStream_t st) {
  const size_t smem = wide_smem(W, Dr);
  const int E = wide_vec(W, Dr, a, ainv, o_a, INV ? o_ainv : nullptr);
  const int threads = wide_threads(W * Dr / E);
  if (E == 4)
    apply_wide_kernel<INV, 4><<<B, threads, smem, st>>>(action, a, ainv, tab,
                                                        o_a, o_ainv, W, Dr);
  else
    apply_wide_kernel<INV, 1><<<B, threads, smem, st>>>(action, a, ainv, tab,
                                                        o_a, o_ainv, W, Dr);
}

}  // namespace qgt

extern "C" {

const char* qgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Table width F for W words per column (-1 for W < 1); the Python table
// builder checks it.
int qgt_op_table_width(int W) {
  if (W < 1) return -1;
  if (W <= 2) return W == 1 ? qgt::Cols<1>::kF : qgt::Cols<2>::kF;
  return qgt::WideCols(W).f;
}

// A shape the kernels take: W words hold Dr rows (Dr <= 32 W), and for
// W <= 2 also Dr <= 64.
static bool shape_ok(int W, int Dr) {
  return W >= 1 && Dr >= 1 && Dr <= 32 * W && (W >= 3 || Dr <= 64);
}

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// shape the kernels do not take (see shape_ok).
int qgt_fused_step(const void* action, const void* flip, const void* a,
                   const void* ainv, const void* last_g, const void* last_c,
                   const void* depth, const void* inverted, const void* max_g,
                   const void* max_c, const void* n_cnots,
                   const void* n_gates, const void* tab, void* o_a,
                   void* o_ainv, void* o_last_g, void* o_last_c,
                   void* o_depth, void* o_success, void* o_reward,
                   void* o_inverted, void* o_max_g, void* o_max_c,
                   void* o_n_cnots, void* o_n_gates, int B, int W, int Dr,
                   int n, int noop_action, int track, int inv, float w0,
                   float w1, float w2, float w3, void* stream) {
  using namespace qgt;
  if (!shape_ok(W, Dr)) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  StepArgs p;
  p.action = static_cast<const int64_t*>(action);
  p.flip = static_cast<const uint8_t*>(flip);
  p.a = static_cast<const uint32_t*>(a);
  p.ainv = static_cast<const uint32_t*>(ainv);
  p.last_g = static_cast<const int32_t*>(last_g);
  p.last_c = static_cast<const int32_t*>(last_c);
  p.depth = static_cast<const int32_t*>(depth);
  p.inverted = static_cast<const uint8_t*>(inverted);
  p.max_g = static_cast<const int32_t*>(max_g);
  p.max_c = static_cast<const int32_t*>(max_c);
  p.n_cnots = static_cast<const int32_t*>(n_cnots);
  p.n_gates = static_cast<const int32_t*>(n_gates);
  p.tab = static_cast<const int32_t*>(tab);
  p.o_a = static_cast<uint32_t*>(o_a);
  p.o_ainv = static_cast<uint32_t*>(o_ainv);
  p.o_last_g = static_cast<int32_t*>(o_last_g);
  p.o_last_c = static_cast<int32_t*>(o_last_c);
  p.o_depth = static_cast<int32_t*>(o_depth);
  p.o_success = static_cast<uint8_t*>(o_success);
  p.o_reward = static_cast<float*>(o_reward);
  p.o_inverted = static_cast<uint8_t*>(o_inverted);
  p.o_max_g = static_cast<int32_t*>(o_max_g);
  p.o_max_c = static_cast<int32_t*>(o_max_c);
  p.o_n_cnots = static_cast<int32_t*>(o_n_cnots);
  p.o_n_gates = static_cast<int32_t*>(o_n_gates);
  p.B = B;
  p.Dr = Dr;
  p.n = n;
  p.noop_action = noop_action;
  p.w0 = w0;
  p.w1 = w1;
  p.w2 = w2;
  p.w3 = w3;
  auto st = static_cast<cudaStream_t>(stream);
  if (W == 1) dispatch_step<1>(p, track != 0, inv != 0, st);
  else if (W == 2) dispatch_step<2>(p, track != 0, inv != 0, st);
  else dispatch_step_wide(p, W, track != 0, inv != 0, st);
  return static_cast<int>(cudaGetLastError());
}

int qgt_apply_gates(const void* action, const void* a, const void* ainv,
                    const void* tab, void* o_a, void* o_ainv, int B, int W,
                    int Dr, int inv, void* stream) {
  using namespace qgt;
  if (!shape_ok(W, Dr)) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  auto act = static_cast<const int64_t*>(action);
  auto ia = static_cast<const uint32_t*>(a);
  auto im = static_cast<const uint32_t*>(ainv);
  auto t = static_cast<const int32_t*>(tab);
  auto oa = static_cast<uint32_t*>(o_a);
  auto om = static_cast<uint32_t*>(o_ainv);
  auto st = static_cast<cudaStream_t>(stream);
  if (W == 1) {
    if (inv) launch_apply<1, true>(act, ia, im, t, oa, om, B, Dr, st);
    else launch_apply<1, false>(act, ia, im, t, oa, om, B, Dr, st);
  } else if (W == 2) {
    if (inv) launch_apply<2, true>(act, ia, im, t, oa, om, B, Dr, st);
    else launch_apply<2, false>(act, ia, im, t, oa, om, B, Dr, st);
  } else if (inv) {
    launch_apply_wide<true>(act, ia, im, t, oa, om, B, W, Dr, st);
  } else {
    launch_apply_wide<false>(act, ia, im, t, oa, om, B, W, Dr, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch of the wide kernels at (W, Dr) for 16-byte aligned tensors,
// untracked with add_inverts: threads a block, and resident blocks an SM of
// the step and of the apply kernel as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them. Returns a CUDA
// error code.
int qgt_wide_occupancy(int W, int Dr, int* threads, int* step_blocks,
                       int* apply_blocks) {
  using namespace qgt;
  if (W < 3 || !shape_ok(W, Dr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int E = (W * Dr) % 4 == 0 ? 4 : 1;
  *threads = wide_threads(W * Dr / E);
  const size_t smem = wide_smem(W, Dr);
  cudaError_t e;
  if (E == 4) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        step_blocks, fused_step_wide_kernel<false, true, 4>, *threads, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          apply_blocks, apply_wide_kernel<true, 4>, *threads, smem);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        step_blocks, fused_step_wide_kernel<false, true, 1>, *threads, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          apply_blocks, apply_wide_kernel<true, 1>, *threads, smem);
  }
  return static_cast<int>(e);
}

}  // extern "C"
