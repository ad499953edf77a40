// Level table of a pyramid atlas, shared by the kernels that work on one
// (fast_score.cu, gaussian_blur7.cu, brief_sample.cu): the levels of one pyramid stacked
// along the rows of a (HA, W) image, level l at rows off_l .. off_l + h_l
// and columns 0 .. w_l.  The table is filled on the host from the level
// sizes and travels by value with the launch (no device table, no copy).
#pragma once

constexpr int kMaxLevels = 16;

struct AtlasLevels {
  int n;
  int off[kMaxLevels];  // first atlas row
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Fills `lv` from `n_levels` pairs (h_l, w_l) in host memory, stacked in that
// order from row 0; the unused entries get 1 x 1.  False unless there are 1 to
// kMaxLevels levels, each at least `min_side` on both sides and at most W
// wide, that fit the HA rows.
inline bool fill_levels(AtlasLevels& lv, const int* hw, int n_levels, int HA, int W,
                        int min_side) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  lv.n = n_levels;
  int off = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool live = l < n_levels;
    lv.off[l] = off;
    lv.h[l] = live ? hw[2 * l] : 1;
    lv.w[l] = live ? hw[2 * l + 1] : 1;
    if (live) {
      if (lv.h[l] < min_side || lv.w[l] < min_side || lv.w[l] > W) return false;
      off += lv.h[l];
    }
  }
  return off <= HA;
}

// The grid of square cells that corner selection lays over every level, cells
// counted row-major within a level and level after level.  A level that is
// asked for no candidates (k = 0) has no cells.
struct AtlasCells {
  int first[kMaxLevels + 1];  // first cell of each level; [n] = all cells
  int per_row[kMaxLevels];    // cells in one row of the level's grid
  int k[kMaxLevels];          // candidates kept per cell of the level
};

// Fills `cells` for the levels of `lv` from `n_levels` counts k_l in host
// memory; returns the number of cells of all levels.
inline int fill_cells(AtlasCells& cells, const AtlasLevels& lv, const int* k, int cell) {
  int n = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool live = l < lv.n && k[l] > 0;
    cells.first[l] = n;
    cells.per_row[l] = live ? (lv.w[l] + cell - 1) / cell : 1;
    cells.k[l] = live ? k[l] : 0;
    if (live) n += cells.per_row[l] * ((lv.h[l] + cell - 1) / cell);
  }
  cells.first[kMaxLevels] = n;
  return n;
}
