// Kernel B2: the standalone per-step circuit-metrics update on Hopper.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_metrics.py:_kernel
// (entry metrics_update_pallas). Same operands: last_g/last_c int32 [B, n]
// and scal int32 [B, 8] = (max_g, max_c, n_cnots, n_gates, mtype, q1, q2,
// is_noop); out: new last_g/last_c (TRACK only), new scal, penalty f32 [B].
//
// Bound: bytes. Per env it reads and writes 2n + 8 int32 words and does a
// few dozen integer operations, far below the card's ratio of operations to
// bytes. Design: one warp per env, 8 envs per 256-thread block. Every lane
// computes the warp-uniform scalar update (metrics.cuh) from two broadcast
// loads of last_g/last_c; lanes then stream the [n] rows coalesced, lane q
// writing qubit q. Lane 0 writes the 8 scal words and the penalty. The
// Pallas kernel always tracks layers; here TRACK is a template parameter so
// the default untracked step reads and writes no [B, n] row at all.
#include <cstdint>

#include <cuda_runtime.h>

#include "metrics.cuh"

namespace qgt {

constexpr int kWarpsPerBlock = 8;

template <bool TRACK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
metrics_kernel(const int32_t* __restrict__ last_g,
               const int32_t* __restrict__ last_c,
               const int32_t* __restrict__ scal, int32_t* __restrict__ o_lg,
               int32_t* __restrict__ o_lc, int32_t* __restrict__ o_scal,
               float* __restrict__ o_pen, int B, int n, float w0, float w1,
               float w2, float w3) {
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (env >= B) return;
  const int32_t* s = scal + static_cast<size_t>(env) * 8;
  const int mtype = s[4], q1 = s[5], q2 = s[6];
  const bool noop = s[7] != 0;
  const int32_t* lg = last_g + static_cast<size_t>(env) * n;
  const int32_t* lc = last_c + static_cast<size_t>(env) * n;
  int lg1 = 0, lg2 = 0, lc1 = 0, lc2 = 0;
  if (TRACK) {
    lg1 = lg[q1];
    lg2 = lg[q2];
    lc1 = lc[q1];
    lc2 = lc[q2];
  }
  const MetricsOut m = metrics_update<TRACK>(mtype, noop, lg1, lg2, lc1, lc2,
                                             s[0], s[1], s[2], s[3], w0, w1,
                                             w2, w3);
  if (TRACK) {
    const size_t row = static_cast<size_t>(env) * n;
    write_layer_row(lg, o_lg + row, n, q1, q2, m.v1, m.v2, lane);
    write_layer_row(lc, o_lc + row, n, q1, q2, m.w1, m.w2, lane);
  }
  if (lane == 0) {
    int32_t* o = o_scal + static_cast<size_t>(env) * 8;
    o[0] = m.max_g;
    o[1] = m.max_c;
    o[2] = m.n_cnots;
    o[3] = m.n_gates;
    o[4] = s[4];
    o[5] = s[5];
    o[6] = s[6];
    o[7] = s[7];
    o_pen[env] = m.penalty;
  }
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
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  auto st = static_cast<cudaStream_t>(stream);
  auto lg = static_cast<const int32_t*>(last_g);
  auto lc = static_cast<const int32_t*>(last_c);
  auto sc = static_cast<const int32_t*>(scal);
  if (track) {
    metrics_kernel<true><<<grid, block, 0, st>>>(
        lg, lc, sc, static_cast<int32_t*>(o_lg), static_cast<int32_t*>(o_lc),
        static_cast<int32_t*>(o_scal), static_cast<float*>(o_pen), B, n, w0,
        w1, w2, w3);
  } else {
    metrics_kernel<false><<<grid, block, 0, st>>>(
        lg, lc, sc, nullptr, nullptr, static_cast<int32_t*>(o_scal),
        static_cast<float*>(o_pen), B, n, w0, w1, w2, w3);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
