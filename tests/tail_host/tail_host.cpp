// The shared tail (fhmcanalysis_torch/csrc/thermo_tail.cuh) on the CPU,
// one point per call at G = 1: body 0 is the small build's body
// (thermo_point_small, the code every build ran before the wide build's
// own) at 64 slots, body 1 the wide build's (thermo_point_wide), both with
// 6 sums; last_max [B] gets each point's last maximum (K3's edge guard
// reads it).  And K3's cell (csrc/iso_cell.cuh) over a grid, one lane a
// cell.  Built with g++ -ffp-contract=off (the kernels' -fmad=false) by
// tests/test_torch_capacity.py, which holds the two bodies bit for bit,
// and K3's cell with x_m formed once against x_m formed on read.
#include <vector>

#include "iso_cell.cuh"

// K1's and K2's sink, and the last maximum that K3's sink keeps for its
// edge guard.
struct HostSink {
  static constexpr bool ROW_ON_EVERY_LANE = true;
  tail::OutSink<4> out;
  int* last_max;
  void phase(int p, int l, int r, bool m, double fe, const double* acc) const { out.phase(p, l, r, m, fe, acc); }
  void finish(int n, bool v, int lm) const {
    out.finish(n, v, lm);
    *last_max = lm;
  }
  template <int G, int CAP, int KACC>
  void row(const tail::Group<G>& g, const tail::WideRow<CAP, KACC>& w) const { out.row(g, w); }
};

extern "C" void tail_run(int body, const double* x, const double* keys, double volume, int B, int N, int S, int P, int smooth,
                         int props, int janus, double* fe, int* left, int* right, unsigned char* mask, int* n_phases,
                         unsigned char* valid, double* n_i, double* x_i, double* ntot, double* u, double* density, int* last_max) {
  const tail::Out o{fe, left, right, mask, n_phases, valid, n_i, x_i, ntot, u, density};
  for (int b = 0; b < B; ++b) {
    alignas(16) unsigned char tile[tail::ROW_TILE];
    HostSink sink{{o, b, P, S, props, &volume, 1u, tile}, last_max + b};
    const double* xb = x + (size_t)b * N;
    const auto xf = [&](int i) { return xb[i]; };
    const auto kf = [&](int k, int i) { return keys[(size_t)k * N + i]; };
    int mx[tail::WIDE], mn[tail::WIDE + 1];
    for (int j = 0; j <= tail::WIDE; ++j) mn[j] = mx[j < tail::WIDE ? j : 0] = -99;  // stale slots
    const tail::Group<1> g{0, 0, 1u};
    if (body == 0) tail::thermo_point_small<tail::WIDE, 6>(xf, kf, g, N, S, P, smooth, props, janus, sink, mx, mn, 1);
    else tail::thermo_point_wide<tail::WIDE, 6>(xf, kf, g, N, S, P, smooth, props, janus, sink, mx, mn, 1);
  }
}

// K3's cells b = 0 .. NY*NX-1 of the grid, one lane each (G = 1), the rows
// in place: the build of `cap` phase slots (8 or 64), x_m formed on read
// (xm_once 0, the kernel's first build) or once per cell into a buffer of
// N doubles (xm_once 1, the wide build's area; 64 slots only).  Outputs
// as iso_grid.cu's: z, rho, fe, ok, code [NY, NX].
extern "C" int iso_cell_run(int cap, int xm_once, const double* lnpi, const double* op, const double* xrows, const double* krows,
                            const double* a, const unsigned char* edge, const double* mu, const int* lr, const double* wts,
                            const double* tg, const double* volume, int W, int NX, int NY, int N, int R, int KG, int P, int smooth,
                            int order, int janus, double cutoff, double* z, double* rho, double* fe, unsigned char* ok, int* code) {
  if (cap != tail::SMALL && cap != tail::WIDE) return 1;
  if (xm_once && cap != tail::WIDE) return 1;
  const iso::Args g{lnpi, op, xrows, krows, a, edge, mu, lr, wts, tg, volume, W, NX, NY, N, R, KG, P, smooth, order, janus,
                    cutoff, 0, z, rho, fe, ok, code};
  std::vector<double> xm(N);
  const tail::Group<1> grp{0, 0, 1u};
  for (long long b = 0; b < (long long)NX * NY; ++b) {
    const int iy = (int)(b / NX), ix = (int)(b % NX);
    const int jl = lr[2 * iy], jr = lr[2 * iy + 1];
    const iso::Rows rl = iso::global_rows(g, jl), rr = iso::global_rows(g, jr);
    int mx[tail::WIDE], mn[tail::WIDE + 1];
    for (int j = 0; j <= tail::WIDE; ++j) mn[j] = mx[j < tail::WIDE ? j : 0] = -99;  // stale slots
    for (double& v : xm) v = -1e300;  // a bin the cell does not form shows
    if (cap == tail::SMALL) iso::cell<1, tail::SMALL, true, false>(g, b, iy, ix, jl, jr, rl, rr, grp, mx, mn, 1, nullptr, 1);
    else if (xm_once) iso::cell<1, tail::WIDE, true, true>(g, b, iy, ix, jl, jr, rl, rr, grp, mx, mn, 1, xm.data(), 1);
    else iso::cell<1, tail::WIDE, true, false>(g, b, iy, ix, jl, jr, rl, rr, grp, mx, mn, 1, nullptr, 1);
  }
  return 0;
}
