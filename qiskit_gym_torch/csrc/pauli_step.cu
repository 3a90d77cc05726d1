// The Pauli-network env step's transition on Hopper: PauliEnvCore.step
// after the metrics update (kernel B2, its own launch before this one).
//
// Replaces no Pallas kernel: in the JAX package this step is plain XLA
// (ops/pauli.py PauliEnvCore.step), which XLA fuses into a few kernels. In
// PyTorch the same ops run eagerly as some 460 launches a step (the three
// primitive slots and a trivial-rotation sweep of RT passes after each
// CNOT), so the host that issues them paces the step. This kernel computes,
// bit for bit, what ops/pauli_step.py:pauli_step_plain computes:
//   tab'    = (I ^ U S) tab, the action's net tableau matrix in <= K2 rank
//             terms (packed_apply_left);
//   rx, rz, rphase through the action's <= 3 primitive slots (H, S, Sdg,
//             CNOT on one or two qubit bits), and after each CNOT the sweep
//             that retires active rotations of weight <= 1 that no active
//             rotation they anticommute with blocks, to a fixed point;
//   success = no rotation active and tab' the identity;
//   reward  = success - penalty + layer_reward * retired, in float32 in
//             that order (no fused multiply-add);
//   depth   = max(depth - 1, 0).
// It writes new tensors: the step is out of place, as the plain one is.
//
// State layout: tab [B, W2*D2] words, word w of column d at w*D2 + d holds
// rows 32w..32w+31 of that column; rx, rz [B, RT, Wn] (qubit q at bit q%32
// of word q/32); rphase int8, active and anti bool [B, RT] and [B, RT, RT].
// Each env's operands come from its own op-table row [F]: mtype, q1, q2,
// the primitive codes, first and second qubits of the 3 slots, then the U
// and S word masks [K2][W2] of the net matrix.
//
// Bound: bytes. Per env of the 27q artifact (W2 = 2, D2 = 56, RT = 7,
// Wn = 1) the step reads and writes tab (896 B), rx and rz (112 B), and
// about 90 B of phases, flags, anti (49 B), penalty, reward and depth:
// ~1.1 KB, 36 MB at B = 32768, 11 us at 3.35 TB/s. The arithmetic is a few
// hundred integer operations an env, far below the card's ratio of
// operations to bytes.
//
// Design: one warp per env, 4 envs a block. For the tableau, lane t owns
// columns t, t + 32, ...: each W2-slice of the state is one contiguous run,
// so loads and stores coalesce; a column's new words are its old ones and
// the parity of each term's masked words (no data exchange), held in
// registers (templated on a bound of W2: 2, or 32 for the wide lines). The
// identity check is one __all_sync. For the rotations, lane t owns
// rotations t and t + 32 (RT <= 64). The env's rotation words are copied
// into the warp's shared memory with coalesced loads, updated there (a
// primitive touches the one or two words holding its qubits), and copied
// out the same way. Each lane holds its rotations' phases, active flags
// and anti rows as 64-bit masks in registers, so a sweep pass is a few bit
// operations and two __ballot_sync: the active set is warp-uniform. A
// sweep stops at the first pass that retires nothing, which is the plain
// version's fixed point after its RT passes. The table row is tiny and
// cached.
#include <cstdint>

#include <cuda_runtime.h>

namespace qgt {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;       // envs a block
constexpr int kPrims = 3;       // primitive slots a table row
constexpr int kMaxRT = 64;      // rotations: two a lane, 64-bit masks
constexpr int kMaxK = 4;        // rank terms of a net matrix
constexpr int kMaxW2 = 32;      // tableau words a column (D2 <= 1024)
constexpr int kMaxWn = 16;      // rotation words (n <= 512)
constexpr int kRowCodes = 3;    // table columns of the codes, then qubits
constexpr int kRowTerms = kRowCodes + 3 * kPrims;
enum : int { kH = 1, kS = 2, kCnot = 3, kSdg = 4 };  // 0: no primitive

struct PauliStepArgs {
  const int64_t* action;
  const float* penalty;
  const uint32_t* tab;
  const uint32_t* rx;
  const uint32_t* rz;
  const int8_t* rphase;
  const uint8_t* active;
  const uint8_t* anti;
  const int32_t* depth;
  const int32_t* op_tab;
  uint32_t* o_tab;
  uint32_t* o_rx;
  uint32_t* o_rz;
  int8_t* o_rphase;
  uint8_t* o_active;
  uint8_t* o_success;
  float* o_reward;
  int32_t* o_depth;
  int B, RT, Wn, W2, D2, K2, max_prims, F;
  float layer_reward;
};

// tab' = (I ^ U S) tab for one env, lane t on columns t, t + 32, ...;
// returns (warp-uniform) whether tab' is the packed identity.
template <int MAXW>
__device__ __forceinline__ bool apply_tableau(const PauliStepArgs& p,
                                              const int32_t* __restrict__ row,
                                              size_t env, int lane) {
  const int W2 = p.W2, D2 = p.D2, K2 = p.K2;
  const int32_t* U = row + kRowTerms;
  const int32_t* S = U + K2 * W2;
  const uint32_t* a = p.tab + env * W2 * D2;
  uint32_t* o = p.o_tab + env * W2 * D2;
  bool ident = true;
  for (int d = lane; d < D2; d += 32) {
    uint32_t v[MAXW], acc[MAXW];
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      v[w] = w < W2 ? __ldg(a + w * D2 + d) : 0u;
      acc[w] = 0u;
    }
    for (int k = 0; k < K2; ++k) {
      uint32_t x = 0u;
#pragma unroll
      for (int w = 0; w < MAXW; ++w)
        if (w < W2) x ^= v[w] & static_cast<uint32_t>(__ldg(S + k * W2 + w));
      const uint32_t sel = 0u - static_cast<uint32_t>(__popc(x) & 1);
#pragma unroll
      for (int w = 0; w < MAXW; ++w)
        if (w < W2)
          acc[w] ^= static_cast<uint32_t>(__ldg(U + k * W2 + w)) & sel;
    }
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      if (w < W2) {
        const uint32_t nv = v[w] ^ acc[w];
        o[w * D2 + d] = nv;
        const uint32_t id = w == (d >> 5) ? 1u << (d & 31) : 0u;
        ident = ident && nv == id;
      }
    }
  }
  return __all_sync(kFull, ident);
}

// One sweep: retire, pass after pass, the active trivial rotations that no
// active rotation in their anti row blocks, until a pass retires none.
// act/triv/anti are this lane's two rotations; A the warp's active set.
__device__ __forceinline__ int sweep(bool (&act)[2], const bool (&triv)[2],
                                     const uint64_t (&anti)[2], uint64_t& A) {
  int removed = 0;
  for (;;) {
    const bool t0 = act[0] && triv[0] && (anti[0] & A) == 0;
    const bool t1 = act[1] && triv[1] && (anti[1] & A) == 0;
    const uint32_t lo = __ballot_sync(kFull, t0);
    const uint32_t hi = __ballot_sync(kFull, t1);
    if ((lo | hi) == 0u) return removed;
    removed += __popc(lo) + __popc(hi);
    act[0] = act[0] && !t0;
    act[1] = act[1] && !t1;
    A &= ~(static_cast<uint64_t>(hi) << 32 | lo);
  }
}

template <int MAXW>
__global__ void __launch_bounds__(32 * kWarps)
    pauli_step_kernel(PauliStepArgs p) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t env = static_cast<size_t>(blockIdx.x) * kWarps + warp;
  if (env >= static_cast<size_t>(p.B)) return;  // the whole warp
  const int RT = p.RT, Wn = p.Wn, RW = RT * Wn;
  const int32_t* row = p.op_tab + static_cast<size_t>(p.action[env]) * p.F;

  const bool ident = apply_tableau<MAXW>(p, row, env, lane);

  // the env's rotation words into this warp's shared memory
  uint32_t* sx = smem + warp * 2 * RW;
  uint32_t* sz = sx + RW;
  const size_t rbase = env * RW;
  for (int i = lane; i < RW; i += 32) {
    sx[i] = __ldg(p.rx + rbase + i);
    sz[i] = __ldg(p.rz + rbase + i);
  }
  int ph[2];
  bool act[2];
  uint64_t anti[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = lane + 32 * j;
    ph[j] = 0;
    act[j] = false;
    anti[j] = 0;
    if (r < RT) {
      const size_t at = env * RT + r;
      ph[j] = p.rphase[at];
      act[j] = p.active[at] != 0;
      const uint8_t* ar = p.anti + at * RT;
      for (int c = 0; c < RT; ++c)
        anti[j] |= static_cast<uint64_t>(ar[c] != 0) << c;
    }
  }
  __syncwarp();
  uint64_t A = static_cast<uint64_t>(__ballot_sync(kFull, act[1])) << 32 |
               __ballot_sync(kFull, act[0]);

  int removed = 0;
  for (int k = 0; k < p.max_prims; ++k) {
    const int c = __ldg(row + kRowCodes + k);  // warp-uniform
    const int qa = __ldg(row + kRowCodes + kPrims + k);
    const int qb = __ldg(row + kRowCodes + 2 * kPrims + k);
    const int wa = qa >> 5, wb = qb >> 5;
    const uint32_t ma = 1u << (qa & 31), mb = 1u << (qb & 31);
    bool triv[2] = {false, false};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = lane + 32 * j;
      if (r >= RT) continue;
      uint32_t* x = sx + r * Wn;
      uint32_t* z = sz + r * Wn;
      // H(a): x_a, z_a ^= x_a ^ z_a, ph += 2 x_a z_a; S(a): z_a ^= x_a,
      // ph += x_a; Sdg(a): z_a ^= x_a, ph += 3 x_a; CNOT(a, b): x_a ^= x_b,
      // z_b ^= z_a. All from the bits before the slot.
      const bool xa = (x[wa] & ma) != 0, za = (z[wa] & ma) != 0;
      const bool xb = (x[wb] & mb) != 0;
      const bool flip = xa != za;
      const bool dxa = c == kH ? flip : c == kCnot && xb;
      const bool dza = c == kH ? flip : (c == kS || c == kSdg) && xa;
      const bool dzb = c == kCnot && za;
      if (dxa) x[wa] ^= ma;
      if (dza) z[wa] ^= ma;
      if (dzb) z[wb] ^= mb;
      ph[j] += c == kH    ? 2 * (xa && za)
               : c == kS  ? static_cast<int>(xa)
               : c == kSdg ? 3 * static_cast<int>(xa)
                           : 0;
      if (c == kCnot) {
        int weight = 0;
        for (int w = 0; w < Wn; ++w) weight += __popc(x[w] | z[w]);
        triv[j] = weight <= 1;
      }
    }
    if (c == kCnot) removed += sweep(act, triv, anti, A);
  }

  __syncwarp();
  for (int i = lane; i < RW; i += 32) {
    p.o_rx[rbase + i] = sx[i];
    p.o_rz[rbase + i] = sz[i];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = lane + 32 * j;
    if (r < RT) {
      p.o_rphase[env * RT + r] = static_cast<int8_t>(ph[j] & 3);
      p.o_active[env * RT + r] = act[j];
    }
  }
  if (lane == 0) {
    const bool success = A == 0 && ident;
    p.o_success[env] = success;
    p.o_reward[env] = __fadd_rn(
        __fsub_rn(success ? 1.0f : 0.0f, p.penalty[env]),
        __fmul_rn(p.layer_reward, static_cast<float>(removed)));
    const int d = static_cast<int>(static_cast<uint32_t>(p.depth[env]) - 1u);
    p.o_depth[env] = d < 0 ? 0 : d;
  }
}

}  // namespace qgt

extern "C" {

const char* qgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qgt_pauli_step(const void* action, const void* penalty, const void* tab,
                   const void* rx, const void* rz, const void* rphase,
                   const void* active, const void* anti, const void* depth,
                   const void* op_tab, void* o_tab, void* o_rx, void* o_rz,
                   void* o_rphase, void* o_active, void* o_success,
                   void* o_reward, void* o_depth, int B, int RT, int Wn,
                   int W2, int D2, int K2, int max_prims, float layer_reward,
                   void* stream) {
  using namespace qgt;
  if (B <= 0) return 0;
  if (RT < 1 || RT > kMaxRT || Wn < 1 || Wn > kMaxWn || W2 < 1 ||
      W2 > kMaxW2 || D2 < 1 || D2 > 32 * W2 || K2 < 0 || K2 > kMaxK ||
      max_prims < 0 || max_prims > kPrims)
    return static_cast<int>(cudaErrorInvalidValue);
  PauliStepArgs p{
      static_cast<const int64_t*>(action), static_cast<const float*>(penalty),
      static_cast<const uint32_t*>(tab), static_cast<const uint32_t*>(rx),
      static_cast<const uint32_t*>(rz), static_cast<const int8_t*>(rphase),
      static_cast<const uint8_t*>(active), static_cast<const uint8_t*>(anti),
      static_cast<const int32_t*>(depth), static_cast<const int32_t*>(op_tab),
      static_cast<uint32_t*>(o_tab), static_cast<uint32_t*>(o_rx),
      static_cast<uint32_t*>(o_rz), static_cast<int8_t*>(o_rphase),
      static_cast<uint8_t*>(o_active), static_cast<uint8_t*>(o_success),
      static_cast<float*>(o_reward), static_cast<int32_t*>(o_depth),
      B, RT, Wn, W2, D2, K2, max_prims, kRowTerms + 2 * K2 * W2,
      layer_reward};
  const size_t smem = sizeof(uint32_t) * kWarps * 2 * RT * Wn;
  const unsigned grid = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  auto st = static_cast<cudaStream_t>(stream);
  if (W2 <= 2)
    pauli_step_kernel<2><<<grid, 32 * kWarps, smem, st>>>(p);
  else
    pauli_step_kernel<kMaxW2><<<grid, 32 * kWarps, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
