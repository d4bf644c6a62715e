// The kernels' shared-memory layout rules (fhmcanalysis_torch/csrc:
// thermo_tail.cuh, mb_xarea.cuh, iso_cell.cuh, and the rules at the heads of
// boundary2d.cu and watershed2d.cu, whose kernels g++ does not see: they lie
// under __CUDACC__)
// on the CPU, the same functions the libraries launch by and export.
// Built with g++ by tests/test_torch_capacity.py, which holds them to
// their numbers.
#include "boundary2d.cu"
#include "iso_cell.cuh"
#include "mb_xarea.cuh"
#include "watershed2d.cu"

extern "C" {

// The tail's index slots, K1's and K2's row tile and their sum.
int tail_slot_bytes(int G, int cap) { return tail::slot_bytes(G, cap); }
int tail_row_tile_bytes(int G, int cap) { return tail::row_tile_bytes(G, cap); }
int tail_block_static_bytes(int G, int cap) { return tail::block_static_bytes(G, cap); }

// tail::stages_rows for the builds the kernels have (-1 for any other).
int tail_stages_rows(int G, int cap, long long rows, long long extra) {
  const size_t r = (size_t)rows, e = (size_t)extra;
  if (G == 1 && cap == tail::SMALL) return tail::stages_rows<1, tail::SMALL>(r, e);
  if (G == 1 && cap == tail::WIDE) return tail::stages_rows<1, tail::WIDE>(r, e);
  if (G == 32 && cap == tail::SMALL) return tail::stages_rows<32, tail::SMALL>(r, e);
  if (G == 32 && cap == tail::WIDE) return tail::stages_rows<32, tail::WIDE>(r, e);
  return -1;
}

// K2's x' area.
int mb_xarea_fits(int G, int cap, int N) { return mbxa::xarea_fits(G, cap, N); }
long long mb_xarea_bytes(int G, int N) {
  return G == 1 ? (long long)mbxa::xarea_bytes<1>(N) : G == 32 ? (long long)mbxa::xarea_bytes<32>(N) : -1;
}
int mb_static_bytes(int G, int cap, int xa) { return mbxa::static_bytes(G, cap, xa != 0); }

// K2's target tile.
int mb_tile_fits(int G, int cap, int paired, int N, long long M, long long A) { return mbxa::tile_fits(G, cap, paired != 0, N, M, A); }
long long mb_tile_block_bytes(int N) { return (long long)mbxa::tile_block_bytes<tail::SMALL>(N); }
long long mb_tile_table_bytes(int S, int N) { return (long long)mbxa::tile_table_bytes(S, N); }
long long mb_tile_blocks(long long M, long long A) { return mbxa::tile_blocks(M, A); }
int mb_tile_targets() { return mbxa::TILE_T; }
long long mb_smem_sm() { return (long long)mbxa::SMEM_SM; }

// K3's staging and x_m area, for a grid of W sources, NX x NY cells and
// N bins with R x-rows and KG key-row groups a source.
int iso_staged_sources(int G, int cap, int W, int NX, int NY, int N, int R, int KG) {
  return iso::staged_sources(G, cap, iso::grid_args(W, NX, NY, N, R, KG));
}
int iso_xm_bytes(int G, int cap, int W, int NX, int NY, int N, int R, int KG) {
  return iso::xm_bytes(G, cap, iso::grid_args(W, NX, NY, N, R, KG));
}
int iso_static_bytes(int G, int cap) { return iso::static_bytes(G, cap); }
int iso_list_bytes() { return (int)iso::LIST_BYTES; }
int iso_smem_optin() { return (int)iso::SMEM_OPTIN; }

// The 2-D boundary integrals' list, pair table and scratch.
int b2d_list_cap() { return b2d::CAP; }
long long b2d_list_bytes() { return (long long)b2d::LIST_BYTES; }
int b2d_list_blocks() { return b2d::LIST_BLOCKS; }
int b2d_table_fits(int L) { return b2d::table_fits(L); }
long long b2d_table_bytes(int L) { return (long long)b2d::table_bytes(L); }
long long b2d_smem_bytes(int L) { return (long long)b2d::smem_bytes(L); }
long long b2d_scratch_bytes(long long S, int L) { return (long long)b2d::scratch_bytes(S, L); }

// The 2-D watershed's rule: which shapes it takes, a block's shared bytes,
// its band of rows and the blocks an SM, for footprint radii (ry, rx).
int ws2d_fits(int H, int N, int ry, int rx, int P) { return ws2d::fits(H, N, ry, rx, P); }
long long ws2d_smem_bytes(int H, int N, int ry, int rx, int P) { return (long long)ws2d::smem_bytes(H, N, ry, rx, P); }
int ws2d_band_rows(int H, int N, int ry, int rx, int P) { return ws2d::band_rows(H, N, ry, rx, P); }
int ws2d_blocks_per_sm(int H, int N, int ry, int rx, int P) { return ws2d::blocks_per_sm(H, N, ry, rx, P); }
long long ws2d_max_cells() { return ws2d::MAX_CELLS; }
long long ws2d_smem_optin() { return (long long)ws2d::SMEM_OPTIN; }

}  // extern "C"
