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
//
// Two launch paths, chosen by D:
//
// Small D (2 D^2 <= 227 KB, D <= 336), rowop_step_kernel: one warp per env. The warp stages both tiles in shared memory with
// 16-byte loads (a tile is contiguous and D^2 is a multiple of 64, so every
// tile is 16-byte aligned), applies the terms there (left: lane = column,
// right: lane = row, so no two lanes touch one byte), and writes both tiles
// back with 16-byte stores while comparing the new `a` with the identity;
// the solved flag is one __all_sync. Warps of a block share nothing, so only
// __syncwarp is needed. Any B: whole warps past the edge return together.
//
// Large D (2 D^2 > 227 KB, D >= 344: the dense Clifford state from 172
// qubits), rowop_stream_kernel: no tile fits in shared memory, so one block
// per env streams both tiles once, in memory order, from the inputs to the
// outputs. Each term touches at most two rows of `a` and two columns of
// `ainv`, so the block first stages what the two terms add (term 2 on the
// result of term 1), D bytes each, in shared memory:
//   left:  w1 = row s1a ^ row s1b of a; w2 = the same rows of a after
//          term 1: row s ^ u1[s] w1, with u1[s] = [s == d1a] ^ [s == d1b];
//          output row r = a[r] ^ u1[r] w1 ^ u2[r] w2;
//   right: v1[r] = ainv[r][d1a] ^ ainv[r][d1b]; v2[r] = ainv[r][d2a] ^
//          ainv[r][d2b] ^ v1[r] (s1[d2a] ^ s1[d2b]), with s1[c] = [c == s1a]
//          ^ [c == s1b]; output ainv[r][c] ^ s1[c] v1[r] ^ s2[c] v2[r].
// Then every 16-byte word of both tiles is loaded once, each of its two
// 8-byte halves (D is a multiple of 8, so a half never spans two rows)
// takes the terms' bytes, and the words are stored to the outputs the flip
// selects, the new `a` compared with the identity on the way; the solved
// flag is one __syncthreads_and.
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

// Envs past 2 D^2 bytes of tiles: a block per env, streaming (see the head).
constexpr int kStreamThreads = 256;

__device__ __forceinline__ uint8_t at(const int8_t* t, int D, int r, int c) {
  return (r < D && c < D) ? static_cast<uint8_t>(t[r * D + c]) : 0;
}

// u[r] of a term: 1 where row r is one of the term's two destinations.
__device__ __forceinline__ bool hit(int r, int x, int y) {
  return (r == x) != (r == y);
}

// The bytes of a term's columns (x, y) inside the 8 bytes from column c0,
// each set to v: s[c] v for c in [c0, c0 + 8).
__device__ __forceinline__ uint64_t cols8(int c0, int x, int y, uint8_t v) {
  uint64_t m = 0;
  const unsigned ox = static_cast<unsigned>(x - c0);
  const unsigned oy = static_cast<unsigned>(y - c0);
  if (ox < 8u) m ^= static_cast<uint64_t>(v) << (8 * ox);
  if (oy < 8u) m ^= static_cast<uint64_t>(v) << (8 * oy);
  return m;
}

__global__ void __launch_bounds__(kStreamThreads)
rowop_stream_kernel(const int64_t* __restrict__ action,
                    const uint8_t* __restrict__ flip,
                    const int8_t* __restrict__ a,
                    const int8_t* __restrict__ ainv,
                    const int32_t* __restrict__ tab,
                    int8_t* __restrict__ o_a, int8_t* __restrict__ o_ainv,
                    uint8_t* __restrict__ o_succ, int D) {
  extern __shared__ uint64_t stage[];  // w1 | w2 | v1 | v2, D bytes each
  uint8_t* w1 = reinterpret_cast<uint8_t*>(stage);
  uint8_t* w2 = w1 + D;
  uint8_t* v1 = w2 + D;
  uint8_t* v2 = v1 + D;
  const int env = blockIdx.x;
  const size_t tile = static_cast<size_t>(D) * D;
  const int8_t* ga = a + env * tile;
  const int8_t* gi = ainv + env * tile;
  const int32_t* row = tab + static_cast<size_t>(action[env]) * kTableWidth;
  const bool on1 = row[4] != 0, on2 = row[9] != 0;
  const int d1a = row[0], d1b = row[1], s1a = row[2], s1b = row[3];
  const int d2a = row[5], d2b = row[6], s2a = row[7], s2b = row[8];

  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    // left, column i of the two added rows
    const uint8_t x1 = on1 ? (at(ga, D, s1a, i) ^ at(ga, D, s1b, i)) : 0;
    uint8_t x2 = 0;
    if (on2) {
      // row s2a of a after term 1 is a[s2a] ^ u1[s2a] w1
      x2 = at(ga, D, s2a, i) ^ at(ga, D, s2b, i);
      if (s2a < D && hit(s2a, d1a, d1b)) x2 ^= x1;
      if (s2b < D && hit(s2b, d1a, d1b)) x2 ^= x1;
    }
    w1[i] = x1;
    w2[i] = x2;
    // right, row i of the two added columns
    const uint8_t y1 = on1 ? (at(gi, D, i, d1a) ^ at(gi, D, i, d1b)) : 0;
    uint8_t y2 = 0;
    if (on2) {
      y2 = at(gi, D, i, d2a) ^ at(gi, D, i, d2b);
      // column d2a of ainv after term 1 is ainv[i][d2a] ^ s1[d2a] v1[i]
      if (d2a < D && hit(d2a, s1a, s1b)) y2 ^= y1;
      if (d2b < D && hit(d2b, s1a, s1b)) y2 ^= y1;
    }
    v1[i] = y1;
    v2[i] = y2;
  }
  __syncthreads();

  const bool fl = flip[env] != 0;
  uint4* oa = reinterpret_cast<uint4*>((fl ? o_ainv : o_a) + env * tile);
  uint4* oi = reinterpret_cast<uint4*>((fl ? o_a : o_ainv) + env * tile);
  const uint4* ia = reinterpret_cast<const uint4*>(ga);
  const uint4* ii = reinterpret_cast<const uint4*>(gi);
  const uint64_t* w1w = stage;
  const uint64_t* w2w = stage + D / 8;
  const int vecs = static_cast<int>(tile / 16);
  bool eq = true;  // the output `a` (new a, or new ainv where flipped)
  for (int j = threadIdx.x; j < vecs; j += blockDim.x) {
    const uint4 va = ia[j];
    const uint4 vi = ii[j];
    uint64_t ha[2] = {(static_cast<uint64_t>(va.y) << 32) | va.x,
                      (static_cast<uint64_t>(va.w) << 32) | va.z};
    uint64_t hi[2] = {(static_cast<uint64_t>(vi.y) << 32) | vi.x,
                      (static_cast<uint64_t>(vi.w) << 32) | vi.z};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int byte0 = 16 * j + 8 * h;
      const int r = byte0 / D;
      const int c0 = byte0 - r * D;
      if (hit(r, d1a, d1b)) ha[h] ^= w1w[c0 / 8];
      if (hit(r, d2a, d2b)) ha[h] ^= w2w[c0 / 8];
      hi[h] ^= cols8(c0, s1a, s1b, v1[r]) ^ cols8(c0, s2a, s2b, v2[r]);
      const uint64_t ident = (r >= c0 && r < c0 + 8)
                                 ? (uint64_t{1} << (8 * (r - c0)))
                                 : uint64_t{0};
      eq = eq && (fl ? hi[h] : ha[h]) == ident;
    }
    oa[j] = make_uint4(static_cast<uint32_t>(ha[0]),
                       static_cast<uint32_t>(ha[0] >> 32),
                       static_cast<uint32_t>(ha[1]),
                       static_cast<uint32_t>(ha[1] >> 32));
    oi[j] = make_uint4(static_cast<uint32_t>(hi[0]),
                       static_cast<uint32_t>(hi[0] >> 32),
                       static_cast<uint32_t>(hi[1]),
                       static_cast<uint32_t>(hi[1] >> 32));
  }
  const bool solved = __syncthreads_and(eq) != 0;
  if (threadIdx.x == 0) o_succ[env] = solved ? 1 : 0;
}

// Whether a launch at this D takes the streaming kernel.
__host__ __forceinline__ bool streams(int D) {
  return 2LL * D * D > kMaxSmem;
}

}  // namespace qgt

extern "C" {

const char* qgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Columns of one action's table row; the Python side checks it against its
// own.
int qgt_rowop_table_width() { return qgt::kTableWidth; }

// 1 where a launch at this D takes the streaming kernel (one env's two
// tiles exceed a block's shared memory), else 0.
int qgt_rowop_streams(int D) { return qgt::streams(D) ? 1 : 0; }

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// shape no kernel takes (D not a positive multiple of 8, or past 32768,
// where the streaming kernel's 32-bit byte offsets end).
int qgt_rowop_step(const void* action, const void* flip, const void* a,
                   const void* ainv, const void* tab, void* o_a, void* o_ainv,
                   void* o_succ, int B, int D, void* stream) {
  using namespace qgt;
  if (D <= 0 || D % 8 != 0 || D > 32768)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  if (streams(D)) {
    // the stage is 4 D bytes: past the static 48 KB (D > 12288) the launch
    // opts in to more, up to 128 KB at D = 32768
    const int stage = 4 * D;
    if (stage > kStaticSmemLimit) {
      const cudaError_t err = cudaFuncSetAttribute(
          rowop_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          stage);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    rowop_stream_kernel<<<B, kStreamThreads, stage,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(action),
        static_cast<const uint8_t*>(flip), static_cast<const int8_t*>(a),
        static_cast<const int8_t*>(ainv), static_cast<const int32_t*>(tab),
        static_cast<int8_t*>(o_a), static_cast<int8_t*>(o_ainv),
        static_cast<uint8_t*>(o_succ), D);
    return static_cast<int>(cudaGetLastError());
  }
  const int per_env = 2 * D * D;
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
