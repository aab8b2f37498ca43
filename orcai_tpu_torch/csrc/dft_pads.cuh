// The exchange layouts of a mixed-radix plan, computed at compile time:
// ops/dft.py::exchange_pads in constexpr C++, so that a plan compiled whole
// into dft_mixed.cu (its COMPILED table) is given by its radices alone and
// its pads are the ones the host would send. Plain C++17 (no CUDA), so that
// g++ can compile it on a machine without nvcc (tests/test_torch_dft_mixed.py
// holds it to exchange_pads).
//
// A pass of radix R over an N-point buffer, Ns the product of the earlier
// radices, runs its butterflies j = l, l + 32, ... on lane l of a warp:
// butterfly j writes z'[(j / Ns) Ns R + j % Ns + r Ns] and reads
// z[j + r N/R], r = 0..R-1, one warp-wide 8-byte access per r; the untangle
// reads bins k and (N - k) % N, k = 0..N/2. The buffer that pass p writes
// holds z[a] at a + ((a >> s) << g) ((0, 0): at a); of the candidate
// layouts, pass p takes the one whose writes and the next pass's (or the
// untangle's) reads take the fewest shared-memory wavefronts (each
// half-warp as many as the most distinct addresses that share a bank pair,
// address mod 16), the least padding on a tie, the first candidate on an
// equal padding.

#ifndef ORCAI_DFT_PADS_CUH
#define ORCAI_DFT_PADS_CUH

#ifdef __CUDACC__
#define ORCAI_HD __host__ __device__
#else
#define ORCAI_HD
#endif

constexpr int PLAN_PASSES = 12;  // the most passes of a plan

struct Pads {
  int s[PLAN_PASSES], g[PLAN_PASSES];
};

// the candidate layouts in ops/dft.py::_PADS's order: (0, 0), then
// (s, g) for s = 2..8 and g = 0..s-2
constexpr int N_PAD_CANDIDATES = 29;
struct PadCandidates {
  int s[N_PAD_CANDIDATES], g[N_PAD_CANDIDATES];
};
ORCAI_HD constexpr PadCandidates pad_candidates() {
  PadCandidates c{};
  int i = 1;
  for (int s = 2; s <= 8; ++s)
    for (int g = 0; g <= s - 2; ++g, ++i) {
      c.s[i] = s;
      c.g[i] = g;
    }
  return c;
}

// Adds to cost[i] the wavefronts that one access takes in a buffer of
// candidate layout i: lane l (0..31) at at(l), -1 for an idle lane. A
// layout moves every address up by a nondecreasing amount, so two lanes
// share an address after it exactly where they did before.
template <typename At>
ORCAI_HD constexpr void add_wavefronts(const At& at, const PadCandidates& pads, int* cost) {
  for (int half = 0; half < 32; half += 16) {
    int distinct[16] = {};
    int m = 0;
    for (int i = 0; i < 16; ++i) {
      const int a = at(half + i);
      bool again = a < 0;
      for (int k = 0; k < m && !again; ++k) again = distinct[k] == a;
      if (!again) distinct[m++] = a;
    }
    for (int c = 0; c < N_PAD_CANDIDATES; ++c) {
      const int s = pads.s[c], g = pads.g[c];
      int count[16] = {};
      int most = 0;
      for (int k = 0; k < m; ++k) {
        const int a = distinct[k];
        const int n = ++count[(s ? a + ((a >> s) << g) : a) % 16];
        most = n > most ? n : most;
      }
      cost[c] += most;
    }
  }
}

// adds the wavefronts of pass p's writes (write true) or reads, over every
// round of its butterflies
ORCAI_HD constexpr void add_pass(const int* radix, int p, int n, bool write,
                                 const PadCandidates& pads, int* cost) {
  int ns = 1;
  for (int q = 0; q < p; ++q) ns *= radix[q];
  const int R = radix[p], nb = n / R;
  for (int j0 = 0; j0 < nb; j0 += 32)
    for (int r = 0; r < R; ++r)
      add_wavefronts(
          [&](int l) {
            const int j = j0 + l;
            return j >= nb ? -1 : write ? j / ns * ns * R + j % ns + r * ns : j + r * nb;
          },
          pads, cost);
}

// adds the wavefronts of the untangle's reads, bins k and their mirrors
ORCAI_HD constexpr void add_untangle(int n, const PadCandidates& pads, int* cost) {
  const int bins = n / 2 + 1;
  for (int k0 = 0; k0 < bins; k0 += 32)
    for (int mirror = 0; mirror < 2; ++mirror)
      add_wavefronts(
          [&](int l) {
            const int k = k0 + l;
            return k >= bins ? -1 : mirror ? (n - k) % n : k;
          },
          pads, cost);
}

// The layout of each pass's output buffer for the plan of `n_passes`
// radices (their product the FFT's size): ops/dft.py::exchange_pads.
ORCAI_HD constexpr Pads exchange_pads(const int* radix, int n_passes) {
  int n = 1;
  for (int p = 0; p < n_passes; ++p) n *= radix[p];
  const PadCandidates candidates = pad_candidates();
  Pads pads{};
  for (int p = 0; p < n_passes; ++p) {
    int cost[N_PAD_CANDIDATES] = {};
    add_pass(radix, p, n, true, candidates, cost);
    if (p + 1 < n_passes)
      add_pass(radix, p + 1, n, false, candidates, cost);
    else
      add_untangle(n, candidates, cost);
    int extra[N_PAD_CANDIDATES] = {};  // the padding a candidate adds
    for (int i = 1; i < N_PAD_CANDIDATES; ++i) extra[i] = (n >> candidates.s[i]) << candidates.g[i];
    int best = 0;
    for (int i = 1; i < N_PAD_CANDIDATES; ++i)
      if (cost[i] < cost[best] || (cost[i] == cost[best] && extra[i] < extra[best])) best = i;
    pads.s[p] = candidates.s[best];
    pads.g[p] = candidates.g[best];
  }
  return pads;
}

#endif  // ORCAI_DFT_PADS_CUH
