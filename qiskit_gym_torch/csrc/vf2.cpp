// Host runtime of the PyTorch port: coupling-graph automorphism enumeration.
//
// The symmetry ("twists") subsystem needs all automorphisms of the qubit
// adjacency graph at env construction time (the reference's petgraph VF2
// search, rust/src/envs/symmetry.rs:115-176). This is a VF2-style
// backtracking enumeration with degree and neighborhood-consistency pruning,
// on the host, behind a C ABI loaded with ctypes
// (qiskit_gym_torch/utils/native.py builds it with the host C++ compiler at
// first use); the port's own copy of the JAX package's `csrc/vf2.cpp`.
// spec/symmetry.py falls back to its pure-Python enumerator where no
// compiler exists.

#include <cstdint>
#include <cstddef>
using std::size_t;
#include <vector>

namespace {

struct Search {
    int n;
    const uint8_t* adj;           // n*n adjacency (0/1)
    std::vector<int> degree;
    std::vector<int> order;       // vertices by decreasing degree
    std::vector<int> mapping;     // order-position -> image (-1 = unmapped)
    std::vector<int> mapped_of;   // vertex -> image or -1
    std::vector<uint8_t> used;
    int* out;
    long long cap;
    long long count = 0;
    bool overflow = false;

    bool edge(int a, int b) const { return adj[(size_t)a * n + b] != 0; }

    void emit() {
        if ((count + 1) * (long long)n > cap) {
            overflow = true;
            return;
        }
        for (int v = 0; v < n; ++v) out[count * n + v] = mapped_of[v];
        ++count;
    }

    void backtrack(int pos) {
        if (overflow) return;
        if (pos == n) {
            emit();
            return;
        }
        int u = order[pos];
        for (int v = 0; v < n && !overflow; ++v) {
            if (used[v] || degree[v] != degree[u]) continue;
            bool ok = true;
            // consistency against every already-mapped vertex
            for (int p = 0; p < pos && ok; ++p) {
                int w = order[p];
                if (edge(u, w) != edge(v, mapped_of[w])) ok = false;
            }
            if (!ok) continue;
            mapped_of[u] = v;
            used[v] = 1;
            backtrack(pos + 1);
            used[v] = 0;
            mapped_of[u] = -1;
        }
    }
};

}  // namespace

extern "C" long long qgt_automorphisms(int n, const uint8_t* adj, int* out,
                                       long long cap) {
    if (n <= 0) return 0;
    Search s;
    s.n = n;
    s.adj = adj;
    s.out = out;
    s.cap = cap;
    s.degree.assign(n, 0);
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
            if (adj[(size_t)i * n + j]) ++s.degree[i];
    s.order.resize(n);
    for (int i = 0; i < n; ++i) s.order[i] = i;
    // order by decreasing degree (stable) for pruning power
    for (int i = 1; i < n; ++i) {
        int v = s.order[i], j = i;
        while (j > 0 && s.degree[s.order[j - 1]] < s.degree[v]) {
            s.order[j] = s.order[j - 1];
            --j;
        }
        s.order[j] = v;
    }
    s.mapped_of.assign(n, -1);
    s.used.assign(n, 0);
    s.backtrack(0);
    return s.overflow ? -1 : s.count;
}
