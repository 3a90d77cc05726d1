// The Pauli-network env's observation on Hopper: PauliEnvCore.dense, the
// uint8 [B, 2n, 2n + R] matrix the policy reads, from the packed state.
//
// Replaces no Pallas kernel: in the JAX package the observation is plain
// XLA (ops/pauli.py PauliEnvCore.dense), which XLA fuses. In PyTorch the
// same ops run eagerly as some 30 launches a step that widen the packed
// tableau to an int64 bit tensor (~0.94 GB at the 27q artifact's B = 32768)
// and gather it twice through expanded int64 indices: ~4.8 GB of traffic
// for 104 MB of output. This kernel computes, bit for bit, what
// ops/pauli_observe.py:pauli_observe_plain computes:
//   out[i, j]     = tab[perm[i], perm[j]]                  for j < 2n,
//   out[i, 2n + d] = bit perm[i] of (x | z) of the (d+1)-th active rotation
//                    in slot order (x on rows < n, z on rows >= n), or 0
//                    where fewer than d + 1 rotations are active,
// with perm the row of the core's perm_rows table that the lane's perm_idx
// picks (row 0 for a one-row table, where the plain version reads no
// index; an index outside the table is clamped, where the plain version
// raises).
//
// Layout: tab [B, W2*D2] words, word w of column c at w*D2 + c holds rows
// 32w..32w+31 of that column; rx, rz [B, RT, Wn] (qubit q at bit q%32 of
// word q/32); active bool [B, RT]; perm_idx int32 [B]; perm_rows int64
// [P, 2n]; out [B, 2n, C] bytes, C = 2n + R, rows one after another.
//
// Bound: bytes. Per env of the 27q artifact (n = 27, W2 = 2, D2 = 56,
// RT = 7, R = 5, Wn = 1) it reads the tableau (448 B), the rotations
// (56 B), the active flags and the index (11 B) and writes 54 x 59 =
// 3186 B: ~3.7 KB, 121 MB at B = 32768, 36 us at 3.35 TB/s. The output is
// 86 % of it, so the design is about writing: the arithmetic is a few
// operations a byte.
//
// Design: a block of 4 warps takes a tile of consecutive envs (4 at 27q, 1
// at 127q: at most 12 KB of shared memory, or one env's), whose output is
// one contiguous run of bytes, and builds that run in shared memory as a bit
// stream, one bit an output byte. (1) A warp an env puts its perm row and
// the inverse in shared memory and turns its active flags into the
// compaction map (two __ballot_sync over the RT <= 64 slots; a slot's
// output column is the __popc of the active slots below it), then the
// compacted rotations' words. (2) The block's warps turn each env's
// columns, the tableau's in perm order and then the rotations, into rows:
// a lane loads one packed word (32 rows of its column), four such words at
// once, the warp transposes each 32 x 32 bit block with five
// __shfl_xor_sync rounds, and lane b ors the 32 column bits of row 32w + b
// into the stream where its output row starts
// (a row starts anywhere in a word, so two shared-memory atomics). (3) The
// block writes the tile's bytes in memory order, 32 a thread's turn as two
// 16-byte stores: one funnel shift takes their 32 bits from the stream and
// one multiply spreads each nibble to 4 bytes. Bytes before the first and
// after the last 32-byte boundary of a tile go out one at a time. Nothing
// is staged in device memory and no index tensor is built. The tableau is
// read once; a row and column permutation costs only the order of the
// loads and the inverse perm.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace qgt {

#ifndef QGT_OBSERVE_TILE
#define QGT_OBSERVE_TILE 4      // envs a block, at most
#endif
#ifndef QGT_OBSERVE_THREADS
#define QGT_OBSERVE_THREADS 128
#endif
#ifndef QGT_OBSERVE_SMEM_KB
#define QGT_OBSERVE_SMEM_KB 12  // a tile's shared memory, at most (but one
#endif                          // env's): 16 blocks, 2048 threads an SM

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = QGT_OBSERVE_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = QGT_OBSERVE_TILE;
constexpr int kLoads = 4;                   // column words in flight a warp
constexpr int kUnit = 32;                   // output bytes a thread's turn
constexpr size_t kTileSmem = QGT_OBSERVE_SMEM_KB * 1024;
constexpr size_t kMaxSmem = 227 * 1024;     // a block's most
constexpr int kMaxRT = 64;                  // two 32-slot ballots
constexpr int kMaxWn = 16;                  // n <= 512
constexpr int kMaxW2 = 32;                  // D2 <= 1024

struct ObserveArgs {
  const uint32_t* tab;
  const uint32_t* rx;
  const uint32_t* rz;
  const uint8_t* active;
  const int32_t* perm_idx;
  const int64_t* perm_rows;
  uint8_t* out;
  int B, n, R, RT, Wn, W2, D2, P;
  int dim, C, WR, CW, S;  // rows, columns, 32-row words, 32-column chunks,
                          // bytes an env
  int tile;               // envs a block
};

// Shared memory of a tile of `tile` envs, in 32-bit words: the output bit
// stream (one bit an output byte, and a word of zeros past its end), then
// per env the perm row, its inverse and the compacted rotations' words.
__host__ __device__ __forceinline__ int stream_words(int tile, int S) {
  return (tile * S + 31) / 32 + 1;
}
__host__ __device__ __forceinline__ int env_words(int dim, int R, int WR) {
  return 2 * dim + R * WR;
}

// The 32 x 32 bit block held a column a lane (lane j: bit b = row b of
// column j) as a row a lane (lane b: bit j = column j of row b): swap the
// off-diagonal halves at each scale.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 16 >> k;
    const uint32_t m = masks[k];
    const uint32_t y = __shfl_xor_sync(kFull, x, s);
    x = (lane & s) ? (x & ~m) | ((y & ~m) >> s) : (x & m) | ((y & m) << s);
  }
  return x;
}

// Bits [off, off + 32) of the n-bit vector held in v[0..Wn), zeros outside
// [0, n); off may be negative.
__device__ __forceinline__ uint32_t window(const uint32_t* __restrict__ v,
                                           int Wn, int n, int off) {
  if (off >= n || off <= -32) return 0u;
  const int q = off >> 5;  // floor: -1 for a negative off
  const uint32_t lo = q >= 0 ? __ldg(v + q) : 0u;
  const uint32_t hi = q + 1 < Wn ? __ldg(v + q + 1) : 0u;
  uint32_t x = __funnelshift_r(lo, hi, off & 31);
  const int keep = n - off;  // bits at and above it lie past the vector
  if (keep < 32) x &= (1u << keep) - 1u;
  return x;
}

// Four bits as four bytes of 0 or 1, bit t in byte t.
__device__ __forceinline__ uint32_t spread(uint32_t nibble) {
  return ((nibble & 0xfu) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads)
    pauli_observe_kernel(ObserveArgs p) {
  extern __shared__ uint32_t smem[];
  const int dim = p.dim, C = p.C, WR = p.WR, CW = p.CW, R = p.R, S = p.S;
  const int nstream = stream_words(p.tile, S);
  uint32_t* stream = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t e0 = static_cast<size_t>(blockIdx.x) * p.tile;
  const int envs = static_cast<size_t>(p.B) - e0 < static_cast<size_t>(p.tile)
                       ? static_cast<int>(p.B - e0)
                       : p.tile;
  auto perm = [&](int e) {
    return reinterpret_cast<int32_t*>(smem + nstream +
                                      e * env_words(dim, R, WR));
  };

  // (1) a warp an env: its perm row and the inverse, the compaction map
  // and the compacted rotations' words; all threads zero the stream
  for (int q = threadIdx.x; q < nstream; q += kThreads) stream[q] = 0u;
  for (int e = warp; e < envs; e += kWarps) {
    const size_t env = e0 + e;
    int32_t* pe = perm(e);
    int32_t* inv = pe + dim;
    uint32_t* rot = reinterpret_cast<uint32_t*>(inv + dim);  // [R][WR]
    const int k = p.P == 1 ? 0 : min(max(__ldg(p.perm_idx + env), 0),
                                     p.P - 1);
    const int64_t* row = p.perm_rows + static_cast<size_t>(k) * dim;
    for (int i = lane; i < dim; i += 32) {
      const int r = static_cast<int>(__ldg(row + i));
      pe[i] = r;
      inv[r] = i;
    }
    const uint8_t* a = p.active + env * p.RT;
    const bool a0 = lane < p.RT && __ldg(a + lane) != 0;
    const bool a1 = lane + 32 < p.RT && __ldg(a + lane + 32) != 0;
    const uint32_t m0 = __ballot_sync(kFull, a0);
    const uint32_t m1 = __ballot_sync(kFull, a1);
    const uint32_t below = (1u << lane) - 1u;
    // output column d of the rotations shows slot s: a lane of each
    for (int d = lane; d < R; d += 32) rot[d * WR] = ~0u;  // none yet
    __syncwarp();
    const int d0 = __popc(m0 & below);
    const int d1 = __popc(m0) + __popc(m1 & below);
    if (a0 && d0 < R) rot[d0 * WR] = lane;
    if (a1 && d1 < R) rot[d1 * WR] = lane + 32;
    __syncwarp();
    for (int d = lane; d < R; d += 32) {
      const uint32_t s = rot[d * WR];
      for (int w = WR - 1; w >= 0; --w) {
        uint32_t x = 0u;
        if (s != ~0u) {
          const size_t at = (env * p.RT + s) * p.Wn;
          x = window(p.rx + at, p.Wn, p.n, 32 * w) |
              window(p.rz + at, p.Wn, p.n, 32 * w - p.n);
        }
        rot[d * WR + w] = x;
      }
    }
  }
  __syncthreads();

  // (2) a warp task: kLoads of an env's (32-row word w, 32-column chunk c)
  // blocks of its columns (the tableau's in perm order, then the compacted
  // rotations), loaded at once and each turned into rows; each row's bits
  // or-ed into the stream at its output row
  const int tasks = WR * CW, groups = (tasks + kLoads - 1) / kLoads;
  for (int gi = warp; gi < envs * groups; gi += kWarps) {
    const int e = gi / groups, t0 = (gi - e * groups) * kLoads;
    const int32_t* pe = perm(e);
    const int32_t* inv = pe + dim;
    const uint32_t* rot = reinterpret_cast<const uint32_t*>(inv + dim);
    const uint32_t* te = p.tab + (e0 + e) * p.W2 * p.D2;
    const int w0 = t0 / CW, c0 = t0 - w0 * CW;
    uint32_t x[kLoads];
#pragma unroll
    for (int u = 0, w = w0, c = c0; u < kLoads; ++u, ++c) {
      if (c == CW) {
        c = 0;
        ++w;
      }
      const int col = 32 * c + lane;
      x[u] = t0 + u >= tasks ? 0u
             : col < dim     ? __ldg(te + w * p.D2 + pe[col])
             : col < C       ? rot[(col - dim) * WR + w]
                             : 0u;
    }
#pragma unroll
    for (int u = 0, w = w0, c = c0; u < kLoads; ++u, ++c) {
      if (t0 + u >= tasks) break;  // warp-uniform
      if (c == CW) {
        c = 0;
        ++w;
      }
      const uint32_t y = transpose32(x[u], lane);
      const int r = 32 * w + lane;
      if (r < dim && y != 0u) {
        const int o = e * S + inv[r] * C + 32 * c, sh = o & 31;
        atomicOr(stream + (o >> 5), y << sh);
        if (sh) atomicOr(stream + (o >> 5) + 1, y >> (32 - sh));
      }
    }
  }
  __syncthreads();

  // (3) the tile's bytes in memory order, kUnit bytes a thread's turn as
  // two 16-byte stores; the ragged ends a byte at a time
  const size_t start = e0 * S, end = start + static_cast<size_t>(envs) * S;
  size_t a = (start + kUnit - 1) & ~static_cast<size_t>(kUnit - 1);
  size_t b = end & ~static_cast<size_t>(kUnit - 1);
  if (a > end) a = end;
  if (b < a) b = a;
  const int head = static_cast<int>(a - start);
  const int ends = head + static_cast<int>(end - b);
  for (int t = threadIdx.x; t < ends; t += kThreads) {
    const int k = t < head ? t : static_cast<int>(b - start) + t - head;
    p.out[start + k] = static_cast<uint8_t>((stream[k >> 5] >> (k & 31)) & 1u);
  }
  uint4* out16 = reinterpret_cast<uint4*>(p.out);
  for (size_t g = a + kUnit * threadIdx.x; g < b; g += kUnit * kThreads) {
    const int k = static_cast<int>(g - start);
    const uint32_t m =
        __funnelshift_r(stream[k >> 5], stream[(k >> 5) + 1], k & 31);
    out16[g >> 4] =
        make_uint4(spread(m), spread(m >> 4), spread(m >> 8), spread(m >> 12));
    out16[(g >> 4) + 1] = make_uint4(spread(m >> 16), spread(m >> 20),
                                     spread(m >> 24), spread(m >> 28));
  }
}

}  // namespace qgt

extern "C" {

const char* qgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qgt_pauli_observe(const void* tab, const void* rx, const void* rz,
                      const void* active, const void* perm_idx,
                      const void* perm_rows, void* out, int B, int n, int R,
                      int RT, int Wn, int W2, int D2, int P, void* stream) {
  using namespace qgt;
  if (B <= 0) return 0;
  if (n < 1 || R < 1 || RT < R || RT > kMaxRT || Wn != (n + 31) / 32 ||
      Wn > kMaxWn || W2 < 1 || W2 > kMaxW2 || D2 < 2 * n || D2 > 32 * W2 ||
      P < 1 || (reinterpret_cast<uintptr_t>(out) & (kUnit - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dim = 2 * n, C = dim + R, WR = (dim + 31) / 32;
  const int CW = (C + 31) / 32, S = dim * C;
  // the tile's shared memory, in words, at `tile` envs
  auto words = [&](int tile) {
    return static_cast<size_t>(stream_words(tile, S)) +
           static_cast<size_t>(tile) * env_words(dim, R, WR);
  };
  int tile = kMaxTile;
  while (tile > 1 && sizeof(uint32_t) * words(tile) > kTileSmem) --tile;
  const size_t smem = sizeof(uint32_t) * words(tile);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pauli_observe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ObserveArgs p{static_cast<const uint32_t*>(tab),
                static_cast<const uint32_t*>(rx),
                static_cast<const uint32_t*>(rz),
                static_cast<const uint8_t*>(active),
                static_cast<const int32_t*>(perm_idx),
                static_cast<const int64_t*>(perm_rows),
                static_cast<uint8_t*>(out),
                B, n, R, RT, Wn, W2, D2, P,
                dim, C, WR, CW, S, tile};
  const unsigned grid = static_cast<unsigned>((B + tile - 1) / tile);
  pauli_observe_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
