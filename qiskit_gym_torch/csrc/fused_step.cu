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
// above 64), one block per env with W a runtime argument; see "Wide
// states" below.
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
// Wide states (W >= 3): one block of min(256, 32W) threads per env, W at run
// time. The block first stages the action's table words in shared memory:
// U32[k] and S32[k] (W words each), the Slm[k] masks, and, with INV, the
// right multiply's operand col(u0) ^ col(u1) of ainv for each term (W words
// each; the <= 2 columns that U's column k selects). Then its threads loop
// over the columns, thread t taking columns t, t + blockDim, ... so that
// adjacent threads touch adjacent words (word w of column d is at w*Dr + d)
// and every load and store is coalesced. For column d a thread
//   - reads the W words of a's column and takes, per term, the parity of
//     the column masked by S32[k] (left multiply: a' = a ^ U (S a));
//   - reads them again (from L1) with ainv's W words, and writes
//     a ^ (U32[k] where the parity is set) and ainv ^ (the staged column
//     where bit d of Slm[k] is set) to o_a or o_ainv as flip says;
//   - compares the word it stores into o_a with the identity's.
// The solved flag is a block-wide AND (__syncthreads_and), and warp 0 runs
// the metrics update (metrics.cuh) and writes the env's scalars.
// Bound: bytes, as for W <= 2: per env it reads and writes a and ainv
// (4*W*Dr bytes each way); the operations are ~10 per word.
constexpr int kWideThreads = 256;

struct WideCols {
  int u, s, ucol, slm, f;
  __host__ __device__ explicit WideCols(int W)
      : u(3),
        s(3 + kK * W),
        ucol(3 + 2 * kK * W),
        slm(3 + 2 * kK * W + 2 * kK),
        f(3 + 2 * kK * W + 2 * kK + kK * W) {}
};

// Stage the action's operands in shared memory: U [K*W], S [K*W], Slm
// [K*W] and, if INV, C [K*W] = col(u0) ^ col(u1) of the env's ainv.
template <bool INV>
__device__ __forceinline__ void stage_wide(const int32_t* __restrict__ row,
                                           const uint32_t* __restrict__ ainv,
                                           size_t base, int W, int Dr,
                                           uint32_t* sm) {
  const WideCols c(W);
  const int kw = kK * W;
  for (int i = threadIdx.x; i < kw; i += blockDim.x) {
    sm[i] = static_cast<uint32_t>(row[c.u + i]);
    sm[kw + i] = static_cast<uint32_t>(row[c.s + i]);
    sm[2 * kw + i] = static_cast<uint32_t>(row[c.slm + i]);
    if (INV) {
      const int k = i / W, w = i - k * W;
      const int u0 = row[c.ucol + 2 * k], u1 = row[c.ucol + 2 * k + 1];
      const uint32_t* col = ainv + base + static_cast<size_t>(w) * Dr;
      sm[3 * kw + i] = (u0 >= 0 ? col[u0] : 0u) ^ (u1 >= 0 ? col[u1] : 0u);
    }
  }
  __syncthreads();
}

// Column d of a' = (I ^ U S) a and, if INV, of m' = m (I ^ U S), written
// to (out_a, out_m) or, where flip is set, to (out_m, out_a). Returns
// whether the column written as the new a is the identity's.
template <bool INV>
__device__ __forceinline__ bool apply_column_wide(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ m,
    uint32_t* __restrict__ out_a, uint32_t* __restrict__ out_m, bool flip,
    int W, int Dr, int d, const uint32_t* sm) {
  const int kw = kK * W;
  const uint32_t* U = sm;
  const uint32_t* S = sm + kw;
  const uint32_t* slm = sm + 2 * kw;
  const uint32_t* C = sm + 3 * kw;
  uint32_t x0 = 0u, x1 = 0u;
  for (int w = 0; w < W; ++w) {
    const uint32_t v = a[static_cast<size_t>(w) * Dr + d];
    x0 ^= v & S[w];
    x1 ^= v & S[W + w];
  }
  const uint32_t sel0 = 0u - static_cast<uint32_t>(__popc(x0) & 1);
  const uint32_t sel1 = 0u - static_cast<uint32_t>(__popc(x1) & 1);
  uint32_t r0 = 0u, r1 = 0u;
  if (INV) {
    r0 = 0u - ((slm[d >> 5] >> (d & 31)) & 1u);
    r1 = 0u - ((slm[W + (d >> 5)] >> (d & 31)) & 1u);
  }
  bool eq = true;
  for (int w = 0; w < W; ++w) {
    const size_t at = static_cast<size_t>(w) * Dr + d;
    const uint32_t na = a[at] ^ (U[w] & sel0) ^ (U[W + w] & sel1);
    uint32_t sa = na;
    if (INV) {
      const uint32_t nm = m[at] ^ (C[w] & r0) ^ (C[W + w] & r1);
      sa = flip ? nm : na;
      out_m[at] = flip ? na : nm;
    }
    out_a[at] = sa;
    const uint32_t ident = (d >> 5) == w ? (1u << (d & 31)) : 0u;
    eq = eq && sa == ident;
  }
  return eq;
}

template <bool TRACK, bool INV>
__global__ void __launch_bounds__(kWideThreads)
fused_step_wide_kernel(const StepArgs p, int W) {
  extern __shared__ uint32_t sm[];
  const int env = blockIdx.x;
  const int act = static_cast<int>(p.action[env]);
  const int Dr = p.Dr;
  const int32_t* row = p.tab + static_cast<size_t>(act) * WideCols(W).f;
  const size_t base = static_cast<size_t>(env) * W * Dr;
  stage_wide<INV>(row, p.ainv, base, W, Dr, sm);

  const bool flip = INV && p.flip[env] != 0;
  bool eq = true;
  for (int d = threadIdx.x; d < Dr; d += blockDim.x)
    eq = apply_column_wide<INV>(p.a + base, p.ainv + base, p.o_a + base,
                                INV ? p.o_ainv + base : nullptr, flip, W,
                                Dr, d, sm) && eq;
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

template <bool INV>
__global__ void __launch_bounds__(kWideThreads)
apply_wide_kernel(const int64_t* __restrict__ action,
                  const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ ainv,
                  const int32_t* __restrict__ tab, uint32_t* __restrict__ o_a,
                  uint32_t* __restrict__ o_ainv, int W, int Dr) {
  extern __shared__ uint32_t sm[];
  const int env = blockIdx.x;
  const int32_t* row = tab + static_cast<size_t>(action[env]) * WideCols(W).f;
  const size_t base = static_cast<size_t>(env) * W * Dr;
  stage_wide<INV>(row, ainv, base, W, Dr, sm);
  for (int d = threadIdx.x; d < Dr; d += blockDim.x)
    apply_column_wide<INV>(a + base, ainv + base, o_a + base,
                           INV ? o_ainv + base : nullptr, false, W, Dr, d,
                           sm);
}

// Threads and shared bytes of a wide launch.
inline int wide_threads(int W) {
  return 32 * W < kWideThreads ? 32 * W : kWideThreads;
}
inline size_t wide_smem(int W) { return sizeof(uint32_t) * 4 * kK * W; }

template <bool TRACK, bool INV>
void launch_step_wide(const StepArgs& p, int W, cudaStream_t st) {
  fused_step_wide_kernel<TRACK, INV>
      <<<p.B, wide_threads(W), wide_smem(W), st>>>(p, W);
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
    apply_wide_kernel<true><<<B, wide_threads(W), wide_smem(W), st>>>(
        act, ia, im, t, oa, om, W, Dr);
  } else {
    apply_wide_kernel<false><<<B, wide_threads(W), wide_smem(W), st>>>(
        act, ia, im, t, oa, om, W, Dr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
