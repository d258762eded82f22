// Chain-MRF MAP labeling for MST channel matching.
//
// The reference delegates this to PyMaxflow's C++ aexpansion_grid
// (utils/mst.py:3,157) on a (C, k) data term — a 1-D chain of C channel
// nodes with Potts pairwise costs. Two solvers:
//
//   * chain_viterbi    — exact MAP via dynamic programming, O(C·k²).
//   * aexpansion_chain — α-expansion (the reference's algorithm): sweep
//     labels, solve each binary expansion move exactly; on a chain each
//     move is itself a 2-label Viterbi. Converges to a local minimum with
//     the usual 2-approximation bound; provided for semantics parity with
//     the reference's solver.
//
// Exposed with C linkage for ctypes; no external dependencies.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

double chain_energy(const double* D, const double* V, int64_t C, int64_t k,
                    const int32_t* labels) {
  double e = 0.0;
  for (int64_t c = 0; c < C; ++c) {
    e += D[c * k + labels[c]];
    if (c + 1 < C) e += V[labels[c] * k + labels[c + 1]];
  }
  return e;
}

}  // namespace

extern "C" {

// Exact MAP of sum_c D[c, l_c] + sum_c V[l_c, l_{c+1}].
// D: C*k row-major, V: k*k, labels: out C.
void chain_viterbi(const double* D, const double* V, int64_t C, int64_t k,
                   int32_t* labels) {
  std::vector<double> m(D, D + k);          // best cost ending at label
  std::vector<double> m_next(k);
  std::vector<int32_t> back((C > 1 ? (C - 1) * k : 0));
  for (int64_t c = 1; c < C; ++c) {
    for (int64_t l = 0; l < k; ++l) {
      double best = std::numeric_limits<double>::infinity();
      int32_t arg = 0;
      for (int64_t p = 0; p < k; ++p) {
        double cost = m[p] + V[p * k + l];
        if (cost < best) { best = cost; arg = static_cast<int32_t>(p); }
      }
      m_next[l] = best + D[c * k + l];
      back[(c - 1) * k + l] = arg;
    }
    m.swap(m_next);
  }
  int32_t cur = 0;
  double best = m[0];
  for (int64_t l = 1; l < k; ++l)
    if (m[l] < best) { best = m[l]; cur = static_cast<int32_t>(l); }
  labels[C - 1] = cur;
  for (int64_t c = C - 2; c >= 0; --c) {
    cur = back[c * k + cur];
    labels[c] = cur;
  }
}

// α-expansion on the chain (reference-parity solver).
// Initial labels = per-node argmin of D (like fastmin). max_cycles<=0 ⇒
// iterate to convergence.
void aexpansion_chain(const double* D, const double* V, int64_t C, int64_t k,
                      int32_t max_cycles, int32_t* labels) {
  for (int64_t c = 0; c < C; ++c) {
    int32_t arg = 0;
    double best = D[c * k];
    for (int64_t l = 1; l < k; ++l)
      if (D[c * k + l] < best) { best = D[c * k + l]; arg = (int32_t)l; }
    labels[c] = arg;
  }
  if (k <= 1 || C <= 1) return;

  std::vector<int32_t> trial(C);
  std::vector<double> m0(C), m1(C);        // binary DP: keep / take-alpha
  std::vector<int8_t> back0(C), back1(C);
  int cycles = (max_cycles > 0) ? max_cycles : 1 << 30;
  for (int cycle = 0; cycle < cycles; ++cycle) {
    bool improved = false;
    for (int64_t alpha = 0; alpha < k; ++alpha) {
      // Binary expansion move: x_c ∈ {keep labels[c], switch to alpha}.
      // Exact on a chain via 2-state Viterbi.
      auto unary = [&](int64_t c, int s) {
        return D[c * k + (s ? alpha : labels[c])];
      };
      auto pair = [&](int64_t c, int s0, int s1) {
        int64_t a = s0 ? alpha : labels[c];
        int64_t b = s1 ? alpha : labels[c + 1];
        return V[a * k + b];
      };
      m0[0] = unary(0, 0);
      m1[0] = unary(0, 1);
      for (int64_t c = 1; c < C; ++c) {
        double c00 = m0[c - 1] + pair(c - 1, 0, 0);
        double c10 = m1[c - 1] + pair(c - 1, 1, 0);
        back0[c] = (c10 < c00);
        m0[c] = (back0[c] ? c10 : c00) + unary(c, 0);
        double c01 = m0[c - 1] + pair(c - 1, 0, 1);
        double c11 = m1[c - 1] + pair(c - 1, 1, 1);
        back1[c] = (c11 < c01);
        m1[c] = (back1[c] ? c11 : c01) + unary(c, 1);
      }
      double before = chain_energy(D, V, C, k, labels);
      int s = (m1[C - 1] < m0[C - 1]);
      double after = s ? m1[C - 1] : m0[C - 1];
      if (after + 1e-12 >= before) continue;
      for (int64_t c = C - 1; c >= 0; --c) {
        trial[c] = s ? static_cast<int32_t>(alpha) : labels[c];
        if (c > 0) s = s ? back1[c] : back0[c];
      }
      std::memcpy(labels, trial.data(), C * sizeof(int32_t));
      improved = true;
    }
    if (!improved) break;
  }
}

double chain_energy_of(const double* D, const double* V, int64_t C,
                       int64_t k, const int32_t* labels) {
  return chain_energy(D, V, C, k, labels);
}

}  // extern "C"
