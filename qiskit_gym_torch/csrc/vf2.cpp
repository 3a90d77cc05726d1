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
    std::vector<int> order;       // search order of the vertices
    std::vector<int> anchor;      // order-position -> earlier neighbor or -1
    std::vector<int> mapped_of;   // vertex -> image or -1
    std::vector<uint8_t> used;
    int* out;
    long long cap;
    long long count = 0;
    bool overflow = false;

    bool edge(int a, int b) const { return adj[(size_t)a * n + b] != 0; }

    // VF2++-style order: each component starts at a vertex of the rarest
    // degree (then the largest degree), and the next vertex is the one with
    // the most neighbors already ordered (then the largest degree). Every
    // vertex but a root then has an earlier neighbor, whose image bounds its
    // candidates to one neighborhood: on a 433-node line the search meets
    // its two automorphisms without exploring a dead branch.
    void make_order() {
        std::vector<int> rarity(n, 0), links(n, 0);
        for (int v = 0; v < n; ++v)
            for (int w = 0; w < n; ++w)
                if (degree[w] == degree[v]) ++rarity[v];
        std::vector<uint8_t> placed(n, 0);
        order.clear();
        anchor.clear();
        while ((int)order.size() < n) {
            int best = -1;
            for (int v = 0; v < n; ++v) {
                if (placed[v] || links[v] == 0) continue;
                if (best < 0 || links[v] > links[best] ||
                    (links[v] == links[best] && degree[v] > degree[best]))
                    best = v;
            }
            if (best < 0) {  // a new component: its root
                for (int v = 0; v < n; ++v) {
                    if (placed[v]) continue;
                    if (best < 0 || rarity[v] < rarity[best] ||
                        (rarity[v] == rarity[best] &&
                         degree[v] > degree[best]))
                        best = v;
                }
            }
            int a = -1;
            for (int p : order)
                if (edge(best, p)) {
                    a = p;
                    break;
                }
            placed[best] = 1;
            order.push_back(best);
            anchor.push_back(a);
            for (int w = 0; w < n; ++w)
                if (edge(best, w)) ++links[w];
        }
    }

    void emit() {
        if ((count + 1) * (long long)n > cap) {
            overflow = true;
            return;
        }
        for (int v = 0; v < n; ++v) out[count * n + v] = mapped_of[v];
        ++count;
    }

    void try_image(int pos, int u, int v) {
        if (used[v] || degree[v] != degree[u]) return;
        // consistency against every already-mapped vertex
        for (int p = 0; p < pos; ++p) {
            int w = order[p];
            if (edge(u, w) != edge(v, mapped_of[w])) return;
        }
        mapped_of[u] = v;
        used[v] = 1;
        backtrack(pos + 1);
        used[v] = 0;
        mapped_of[u] = -1;
    }

    void backtrack(int pos) {
        if (overflow) return;
        if (pos == n) {
            emit();
            return;
        }
        int u = order[pos];
        // u's image is a neighbor of its anchor's image
        int img = anchor[pos] < 0 ? -1 : mapped_of[anchor[pos]];
        for (int v = 0; v < n && !overflow; ++v)
            if (img < 0 || edge(img, v)) try_image(pos, u, v);
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
    s.make_order();
    s.mapped_of.assign(n, -1);
    s.used.assign(n, 0);
    s.backtrack(0);
    return s.overflow ? -1 : s.count;
}
