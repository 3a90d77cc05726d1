// Kernel B3: the dense-state row-op step on Hopper.
//
// Replaces the Pallas TPU kernel of the JAX package, ops/pallas_step.py:
// _vpu_kernel (entry fused_step_apply, tables build_rowop_tables). Per env,
// on the dense int8 state (a, ainv: [B, D, D], D a multiple of 8, 0/1
// values, identity in the padding block):
//   up to two rank-1 GF(2) updates M ^= u w^T, term 2 applied to the result
//   of term 1,
//     on the left to a:     w = row ska ^ row skb, XORed into rows dka, dkb
//     on the right to ainv: w = col dka ^ col dkb, XORed into cols ska, skb
//   then a and ainv swap where flip is set, and solved = all(a == I) over the
//   whole D x D tile.
// The table row of an action is ten int32: d1a d1b s1a s1b t1 d2a d2b s2a s2b
// t2; index D means "no row", tk = 0 disables term k.
//
// The TPU kernel builds one-hot vectors by iota compares and reduces masked
// rows, because it has no dynamic indexing. Here the indices are read from
// the table row and used as addresses.
//
// Bound: bytes. The step reads and writes both tiles (4 D^2 bytes per env,
// 12.5 KB at D = 56) and does a few hundred byte operations on them.
// Design: one warp per env. The warp stages both tiles in shared memory with
// 16-byte loads (a tile is contiguous and D^2 is a multiple of 64, so every
// tile is 16-byte aligned), applies the terms there (left: lane = column,
// right: lane = row, so no two lanes touch one byte), and writes both tiles
// back with 16-byte stores while comparing the new `a` with the identity;
// the solved flag is one __all_sync. Warps of a block share nothing, so only
// __syncwarp is needed. Any B: whole warps past the edge return together.
#include <cstdint>

#include <cuda_runtime.h>

namespace qgt {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTableWidth = 10;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kStaticSmemLimit = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

// M ^= u w^T on the left: w = row sa ^ row sb, into rows da and db.
__device__ __forceinline__ void left_term(uint8_t* t, int D, int lane, int da,
                                          int db, int sa, int sb) {
  for (int c = lane; c < D; c += 32) {
    uint8_t w = 0;
    if (sa < D) w ^= t[sa * D + c];
    if (sb < D) w ^= t[sb * D + c];
    if (da < D) t[da * D + c] ^= w;
    if (db < D) t[db * D + c] ^= w;
  }
}

// M ^= w s^T on the right: w = col da ^ col db, into cols sa and sb.
__device__ __forceinline__ void right_term(uint8_t* t, int D, int lane, int da,
                                           int db, int sa, int sb) {
  for (int r = lane; r < D; r += 32) {
    uint8_t* row = t + r * D;
    uint8_t w = 0;
    if (da < D) w ^= row[da];
    if (db < D) w ^= row[db];
    if (sa < D) row[sa] ^= w;
    if (sb < D) row[sb] ^= w;
  }
}

__global__ void rowop_step_kernel(const int64_t* __restrict__ action,
                                  const uint8_t* __restrict__ flip,
                                  const int8_t* __restrict__ a,
                                  const int8_t* __restrict__ ainv,
                                  const int32_t* __restrict__ tab,
                                  int8_t* __restrict__ o_a,
                                  int8_t* __restrict__ o_ainv,
                                  uint8_t* __restrict__ o_succ, int B, int D) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int env = blockIdx.x * warps + warp;
  if (env >= B) return;  // warp-uniform: whole warps leave together

  const int tile = D * D;      // bytes, a multiple of 64
  const int vecs = tile / 16;  // 16-byte vectors per tile
  uint4* ta4 = smem + static_cast<size_t>(warp) * 2 * vecs;
  uint4* ti4 = ta4 + vecs;
  const size_t base = static_cast<size_t>(env) * tile;
  const uint4* ga = reinterpret_cast<const uint4*>(a + base);
  const uint4* gi = reinterpret_cast<const uint4*>(ainv + base);
  for (int j = lane; j < vecs; j += 32) {
    ta4[j] = ga[j];
    ti4[j] = gi[j];
  }
  const int32_t* row = tab + static_cast<size_t>(action[env]) * kTableWidth;
  __syncwarp();

  uint8_t* ta = reinterpret_cast<uint8_t*>(ta4);
  uint8_t* ti = reinterpret_cast<uint8_t*>(ti4);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int32_t* term = row + 5 * k;
    if (term[4] == 0) continue;  // warp-uniform
    left_term(ta, D, lane, term[0], term[1], term[2], term[3]);
    right_term(ti, D, lane, term[0], term[1], term[2], term[3]);
    __syncwarp();  // term 2 reads what term 1 wrote
  }

  const bool fl = flip[env] != 0;
  const uint4* sel_a = fl ? ti4 : ta4;
  const uint4* sel_i = fl ? ta4 : ti4;
  uint4* oa = reinterpret_cast<uint4*>(o_a + base);
  uint4* oi = reinterpret_cast<uint4*>(o_ainv + base);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(sel_a);
  bool eq = true;
  for (int j = lane; j < vecs; j += 32) {
    oa[j] = sel_a[j];
    oi[j] = sel_i[j];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // word 4j+q holds bytes c0..c0+3 of row r (D is a multiple of 4)
      const int byte0 = 16 * j + 4 * q;
      const int r = byte0 / D;
      const int c0 = byte0 - r * D;
      const uint32_t want =
          (r >= c0 && r < c0 + 4) ? (1u << (8 * (r - c0))) : 0u;
      eq = eq && words[4 * j + q] == want;
    }
  }
  const bool success = __all_sync(kFull, eq);
  if (lane == 0) o_succ[env] = success ? 1 : 0;
}

}  // namespace qgt

extern "C" {

const char* qgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Columns of one action's table row; the Python side checks it against its
// own.
int qgt_rowop_table_width() { return qgt::kTableWidth; }

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// shape the kernel does not take (D not a positive multiple of 8, or one
// env's two tiles larger than a block's shared memory).
int qgt_rowop_step(const void* action, const void* flip, const void* a,
                   const void* ainv, const void* tab, void* o_a, void* o_ainv,
                   void* o_succ, int B, int D, void* stream) {
  using namespace qgt;
  if (D <= 0 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per_env = 2 * D * D;
  if (per_env > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  // as many warps (envs) per block as fit in the static 48 KB, at most 8;
  // one env per block with the opt-in limit when a single env needs more
  int warps = kStaticSmemLimit / per_env;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  if (warps < 1) warps = 1;
  const int smem = warps * per_env;
  if (smem > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        rowop_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + warps - 1) / warps);
  rowop_step_kernel<<<grid, warps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(action), static_cast<const uint8_t*>(flip),
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(ainv),
      static_cast<const int32_t*>(tab), static_cast<int8_t*>(o_a),
      static_cast<int8_t*>(o_ainv), static_cast<uint8_t*>(o_succ), B, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
