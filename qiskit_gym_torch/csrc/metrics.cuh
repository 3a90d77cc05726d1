// Per-env circuit-metrics update, shared by the fused env step
// (fused_step.cu, kernel B1) and the standalone metrics kernel (metrics.cu,
// kernel B2).
//
// It is MatrixEnvCore._metrics_update_terms for one env: ASAP layer bumps
// for 1Q/CX/CZ/SWAP gates, the running max_g/max_c, the n_cnots/n_gates
// counters and the penalty w . (d_cnots, d_layers_c, d_layers, d_gates).
// With TRACK false (both layer weights zero, the reference default) only the
// counters move and the layer fields stay frozen, as in the XLA step.
//
// Float arithmetic uses the _rn intrinsics so nvcc cannot contract a
// multiply-add into an FMA: the penalty is bit-identical to the plain
// PyTorch version, which multiplies and adds in separate float32 ops.
#pragma once

#include <cstdint>

namespace qgt {

constexpr int kMT1Q = 0, kMTCX = 1, kMTCZ = 2, kMTSwap = 3;

struct MetricsOut {
  int v1, v2;   // new last_g at q1 and q2 (TRACK only)
  int w1, w2;   // new last_c at q1 and q2 (TRACK only)
  int max_g, max_c, n_cnots, n_gates;
  float penalty;
};

// lg1/lg2/lc1/lc2 are last_g/last_c at q1 and q2; ignored unless TRACK.
template <bool TRACK>
__device__ __forceinline__ MetricsOut metrics_update(
    int mtype, bool noop, int lg1, int lg2, int lc1, int lc2, int max_g,
    int max_c, int n_cnots, int n_gates, float w0, float w1, float w2,
    float w3) {
  const bool is1q = mtype == kMT1Q;
  const bool iscx = mtype == kMTCX;
  const bool issw = mtype == kMTSwap;
  const int d_gates = noop ? 0 : ((is1q || iscx) ? 1 : 3);
  const int d_cnots = (is1q || noop) ? 0 : (issw ? 3 : 1);
  MetricsOut m;
  m.n_cnots = n_cnots + d_cnots;
  m.n_gates = n_gates + d_gates;
  if (!TRACK) {
    m.v1 = lg1;
    m.v2 = lg2;
    m.w1 = lc1;
    m.w2 = lc2;
    m.max_g = max_g;
    m.max_c = max_c;
    m.penalty = __fadd_rn(__fmul_rn(w0, static_cast<float>(d_cnots)),
                          __fmul_rn(w3, static_cast<float>(d_gates)));
    return m;
  }
  const int mg = max(lg1, lg2);
  const int m_cx = mg + 1;
  const int m_sw = mg + 3;
  const int m_cz = max(lg1, lg2 + 1) + 1;
  int v1 = is1q ? lg1 + 1 : (iscx ? m_cx : (issw ? m_sw : m_cz));
  int v2 = is1q ? lg1 + 1 : (iscx ? m_cx : (issw ? m_sw : m_cz + 1));
  if (noop) {
    v1 = lg1;
    v2 = lg2;
  }
  const int c_new = max(lc1, lc2) + (issw ? 3 : 1);
  const bool has_cx = !is1q && !noop;
  m.v1 = v1;
  m.v2 = v2;
  m.w1 = has_cx ? c_new : lc1;
  m.w2 = has_cx ? c_new : lc2;
  m.max_g = max(max_g, max(v1, v2));
  m.max_c = max(max_c, max(m.w1, m.w2));
  const float d_layers_c = static_cast<float>(m.max_c - max_c);
  const float d_layers = static_cast<float>(m.max_g - max_g);
  float p = __fmul_rn(w0, static_cast<float>(d_cnots));
  p = __fadd_rn(p, __fmul_rn(w1, d_layers_c));
  p = __fadd_rn(p, __fmul_rn(w2, d_layers));
  p = __fadd_rn(p, __fmul_rn(w3, static_cast<float>(d_gates)));
  m.penalty = p;
  return m;
}

// Write one env's last_g/last_c row: qubit q takes v2 if q == q2, else v1 if
// q == q1, else keeps its value (q2 wins, as in the XLA step). Lane l of the
// warp handles qubits l, l + 32, ... Used by the fused step, where a warp owns
// an env; the standalone kernel updates its tile in shared memory instead.
__device__ __forceinline__ void write_layer_row(const int32_t* row,
                                                int32_t* out, int n, int q1,
                                                int q2, int v1, int v2,
                                                int lane) {
  for (int q = lane; q < n; q += 32) {
    const int old = row[q];
    out[q] = q == q2 ? v2 : (q == q1 ? v1 : old);
  }
}

}  // namespace qgt
