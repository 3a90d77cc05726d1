// Kernel B2: the standalone per-step circuit-metrics update on Hopper.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_metrics.py:_kernel
// (entry metrics_update_pallas). Same operands: last_g/last_c int32 [B, n]
// and scal int32 [B, 8] = (max_g, max_c, n_cnots, n_gates, mtype, q1, q2,
// is_noop); out: new last_g/last_c (TRACK only), new scal, penalty f32 [B].
//
// Bound: bytes. Per env it reads and writes 2n + 8 int32 words and does a
// few dozen integer operations, far below the card's ratio of operations to
// bytes, so the design is about how the bytes move.
//
// A block owns tiles of E consecutive envs. [B, n] is contiguous, so a tile's
// last_g rows are one run of E*n*4 bytes, likewise last_c, and its scal one
// run of E*32 bytes; with E a multiple of 4 every run starts and ends on a
// 16-byte boundary for any n. One thread arms an mbarrier with the byte count
// and starts one bulk asynchronous copy per run (the 1-D cp.async.bulk form:
// no tensor map), so no thread spends registers or address arithmetic on the
// copy and a block has a whole tile in flight from three copies. Thread e
// then updates env e in shared memory, in place: it reads its 8 scal words,
// gathers the four layer values, and writes back v1 at q1 then v2 at q2 (q2
// wins, as in the XLA step) and the four new scal words. Every other word of
// the tile is a straight copy that no thread touches. The tile leaves by bulk
// store. The grid is persistent (a few blocks per SM, looping over tiles)
// with a ring of kStages tiles, so the next tile's load is in flight while
// this one is computed and stored.
//
// Shared-memory banks: thread e gathers at word e*n + q. For odd n (27) the
// row starts of a warp fall on 32 different banks, so the gathers conflict
// only where two envs' qubits happen to collide; for even n the row starts
// share banks (n = 12: 8 distinct banks, up to 4-way; n a multiple of 32:
// all rows on one bank, 32-way) and the four gathers serialise accordingly.
// The scal words are read and written as two 16-byte accesses per thread at
// a 32-byte stride, a 2-way conflict. Both are small beside the copy.
//
// Edges run the same kernel with ordinary loads and stores into and out of
// the same shared-memory tile: the last tile when B is not a multiple of E,
// and every tile when a base address is not 16-byte aligned (a bulk copy
// needs 16-byte addresses and sizes).
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "metrics.cuh"

// Tile size (envs per tile = threads per block), ring depth and resident
// blocks per SM; the defaults are what scripts/tune_metrics_kernel.py
// measured best on an H100, and it overrides them with -D to try others.
#ifndef QGT_B2_TILE
#define QGT_B2_TILE 64
#endif
#ifndef QGT_B2_TILE_UNTRACKED
#define QGT_B2_TILE_UNTRACKED 128
#endif
#ifndef QGT_B2_STAGES
#define QGT_B2_STAGES 2
#endif
#ifndef QGT_B2_BLOCKS_PER_SM
#define QGT_B2_BLOCKS_PER_SM 4
#endif

namespace qgt {

constexpr int kTile = QGT_B2_TILE;
constexpr int kTileUntracked = QGT_B2_TILE_UNTRACKED;
// Tile for rows so wide that kStages tiles of kTile envs exceed a block's
// shared memory (n > ~220 at the defaults).
constexpr int kTileWide = 32;
constexpr int kStages = QGT_B2_STAGES;
constexpr int kBlocksPerSM = QGT_B2_BLOCKS_PER_SM;
constexpr int kMaxSmem = 232448;  // bytes a block can use on sm_90
static_assert(kTile % 4 == 0 && kTileUntracked % 4 == 0 && kTile >= 32 &&
                  kTileUntracked >= 32,
              "a tile must keep its runs 16-byte aligned");
static_assert(kStages >= 2, "the ring needs two stages to overlap anything");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Global -> shared, completion counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared -> global, tracked by the thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

template <int PENDING>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING)
               : "memory");
}

// E envs per tile and E threads per block; thread e owns env e of the tile.
template <bool TRACK, int E>
__global__ void __launch_bounds__(E)
metrics_kernel(const int32_t* __restrict__ last_g,
               const int32_t* __restrict__ last_c,
               const int32_t* __restrict__ scal, int32_t* __restrict__ o_lg,
               int32_t* __restrict__ o_lc, int32_t* __restrict__ o_scal,
               float* __restrict__ o_pen, int B, int n, int aligned, float w0,
               float w1, float w2, float w3) {
  extern __shared__ __align__(128) int32_t smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int tid = threadIdx.x;
  const int row_words = TRACK ? E * n : 0;   // one tile of last_g (or last_c)
  const int stage_words = 2 * row_words + E * 8;
  const int num_tiles = (B + E - 1) / E;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The k-th tile of this block, and whether it moves by bulk copy.
  auto tile_of = [&](int k) {
    return static_cast<int>(blockIdx.x) + k * static_cast<int>(gridDim.x);
  };
  auto is_bulk = [&](int tile) { return aligned && (tile + 1) * E <= B; };
  // Thread 0: start the load of this block's k-th tile into its ring stage.
  auto start_load = [&](int k) {
    const int tile = tile_of(k);
    if (tile >= num_tiles || !is_bulk(tile)) return;
    const int s = k % kStages;
    int32_t* st = smem + static_cast<size_t>(s) * stage_words;
    const size_t env0 = static_cast<size_t>(tile) * E;
    mbar_expect_tx(&full[s], static_cast<uint32_t>(stage_words) * 4u);
    if (TRACK) {
      bulk_load(st, last_g + env0 * n, row_words * 4u, &full[s]);
      bulk_load(st + row_words, last_c + env0 * n, row_words * 4u, &full[s]);
    }
    bulk_load(st + 2 * row_words, scal + env0 * 8, E * 32u, &full[s]);
  };

  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) start_load(k);
  }

  for (int k = 0;; ++k) {
    const int tile = tile_of(k);
    if (tile >= num_tiles) break;
    const int s = k % kStages;
    int32_t* s_lg = smem + static_cast<size_t>(s) * stage_words;
    int32_t* s_lc = s_lg + row_words;
    int32_t* s_sc = s_lg + 2 * row_words;
    const size_t env0 = static_cast<size_t>(tile) * E;
    const int rows = min(E, B - static_cast<int>(env0));
    const bool bulk = is_bulk(tile);

    if (bulk) {
      mbar_wait(&full[s], (k / kStages) & 1);
    } else {
      // Ordinary loads into the same tile. The barrier orders them after
      // thread 0 has seen this stage's last bulk store read out.
      __syncthreads();
      if (TRACK) {
        for (int i = tid; i < rows * n; i += E) {
          s_lg[i] = last_g[env0 * n + i];
          s_lc[i] = last_c[env0 * n + i];
        }
      }
      for (int i = tid; i < rows * 8; i += E) s_sc[i] = scal[env0 * 8 + i];
      __syncthreads();
    }

    if (tid < rows) {
      int4* sc = reinterpret_cast<int4*>(s_sc + tid * 8);
      const int4 acc = sc[0];  // max_g, max_c, n_cnots, n_gates
      const int4 op = sc[1];   // mtype, q1, q2, is_noop
      int32_t* rg = s_lg + tid * n;
      int32_t* rc = s_lc + tid * n;
      int lg1 = 0, lg2 = 0, lc1 = 0, lc2 = 0;
      if (TRACK) {
        lg1 = rg[op.y];
        lg2 = rg[op.z];
        lc1 = rc[op.y];
        lc2 = rc[op.z];
      }
      const MetricsOut m =
          metrics_update<TRACK>(op.x, op.w != 0, lg1, lg2, lc1, lc2, acc.x,
                                acc.y, acc.z, acc.w, w0, w1, w2, w3);
      if (TRACK) {
        rg[op.y] = m.v1;
        rg[op.z] = m.v2;
        rc[op.y] = m.w1;
        rc[op.z] = m.w2;
      }
      sc[0] = make_int4(m.max_g, m.max_c, m.n_cnots, m.n_gates);
      o_pen[env0 + tid] = m.penalty;
    }

    if (bulk) {
      // Make the threads' writes visible to the copy engine, then store.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        if (TRACK) {
          bulk_store(o_lg + env0 * n, s_lg, row_words * 4u);
          bulk_store(o_lc + env0 * n, s_lc, row_words * 4u);
        }
        bulk_store(o_scal + env0 * 8, s_sc, E * 32u);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (k >= 1) {
          // The previous tile's store has been read out of its stage once
          // at most this tile's group is pending: refill that stage.
          bulk_wait_read<1>();
          start_load(k - 1 + kStages);
        }
      }
    } else {
      __syncthreads();
      if (TRACK) {
        for (int i = tid; i < rows * n; i += E) {
          o_lg[env0 * n + i] = s_lg[i];
          o_lc[env0 * n + i] = s_lc[i];
        }
      }
      for (int i = tid; i < rows * 8; i += E) o_scal[env0 * 8 + i] = s_sc[i];
    }
  }
  // Shared memory must outlive the stores that still read it.
  if (tid == 0) bulk_wait_read<0>();
}

template <bool TRACK, int E>
cudaError_t launch(const int32_t* lg, const int32_t* lc, const int32_t* sc,
                   int32_t* o_lg, int32_t* o_lc, int32_t* o_scal,
                   float* o_pen, int B, int n, int aligned, float w0,
                   float w1, float w2, float w3, int sms, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(kStages) * 4 *
                      ((TRACK ? 2 * static_cast<size_t>(E) * n : 0) + E * 8);
  auto kernel = metrics_kernel<TRACK, E>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles = (B + E - 1) / E;
  const int grid = std::min(tiles, sms * kBlocksPerSM);
  kernel<<<grid, E, smem, st>>>(lg, lc, sc, o_lg, o_lc, o_scal, o_pen, B, n,
                                aligned, w0, w1, w2, w3);
  return cudaGetLastError();
}

}  // namespace qgt

extern "C" {

const char* qgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qgt_metrics_update(const void* last_g, const void* last_c,
                       const void* scal, void* o_lg, void* o_lc, void* o_scal,
                       void* o_pen, int B, int n, int track, float w0,
                       float w1, float w2, float w3, void* stream) {
  using namespace qgt;
  if (B <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  auto lg = static_cast<const int32_t*>(last_g);
  auto lc = static_cast<const int32_t*>(last_c);
  auto sc = static_cast<const int32_t*>(scal);
  auto olg = static_cast<int32_t*>(o_lg);
  auto olc = static_cast<int32_t*>(o_lc);
  auto osc = static_cast<int32_t*>(o_scal);
  auto pen = static_cast<float*>(o_pen);
  auto is16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  if (!track) {
    const int aligned = is16(scal) && is16(o_scal);
    return static_cast<int>(launch<false, kTileUntracked>(
        lg, lc, sc, nullptr, nullptr, osc, pen, B, n, aligned, w0, w1, w2, w3,
        sms, st));
  }
  const int aligned = is16(last_g) && is16(last_c) && is16(scal) &&
                      is16(o_lg) && is16(o_lc) && is16(o_scal);
  const size_t ring = static_cast<size_t>(kStages) * 4 *
                      (2 * static_cast<size_t>(kTile) * n + kTile * 8);
  if (ring <= static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(launch<true, kTile>(lg, lc, sc, olg, olc, osc,
                                                pen, B, n, aligned, w0, w1,
                                                w2, w3, sms, st));
  }
  // Rows too wide for a ring of kTile envs: a narrower tile. Beyond that the
  // launch itself is refused for its shared memory and the error returned.
  return static_cast<int>(launch<true, kTileWide>(lg, lc, sc, olg, olc, osc,
                                                  pen, B, n, aligned, w0, w1,
                                                  w2, w3, sms, st));
}

}  // extern "C"
