// K1: FAST-9/16 corners.  Two kernels over one scoring function:
//
//   fast_candidates_kernel  pyramid atlas (B, HA, W0) float32 -> per-cell
//                           corner candidates (B, NC, KC): scores float32 and
//                           in-cell indices int32.  One launch a frame; the
//                           form the extraction path runs.
//   fast_score_kernel       (B, H, W) float32 -> dense score map (B, H, W),
//                           the single-level form.
//
// Replaces the Pallas kernels `_fast_kernel` / `_fast_kernel_b` behind
// `fast_score` in orb_slam3_noted_tpu/ops/pallas_kernels.py, and the first
// half of `detect_level` (orb_slam3_noted_tpu/ops/fast.py) that the JAX
// package leaves to XLA behind them: border and low-threshold mask, 3x3 peak
// test, the cell's dual threshold, the cell's k best.  The TPU kernel wrote a
// dense score map because XLA fuses what follows; in eager PyTorch that map
// (4.5 MB a frame) was written only to be read back by some 45 small
// operations a level, among them a stable sort of (cells, 1024) rows.  Here a
// block owns one 32 x 32 cell, keeps its scores in shared memory and writes
// the cell's k candidates: 94 KB out for 4.5 MB in at the bench size.
//
// score(p) = max over the 16 contiguous 9-arcs of the Bresenham ring of
// min(ring - centre) (bright) and of min(centre - ring) (dark).  Only
// subtractions, minima and maxima, so it is bit-exact with the plain version
// (ops/fast.py, `fast_score`), whose doubling form it shares: a windowed
// minimum over 9 ring positions in four steps (windows of 2, 4, 8, 9), 64
// minima instead of 128, and the dark side as the negated windowed maximum of
// the same differences (min(-a, -b) = -max(a, b) exactly).
//
// Candidates: the steps of `cell_candidates` (ops/fast.py) in its order.
// Equal scores go lowest in-cell index first, as the stable sort of the plain
// version does: survivors are compacted in index order with ballots and a
// prefix over the 32 warp-sized chunks (no atomics, nothing depends on
// timing), then one warp takes the maximum k times, the lower position
// winning ties.  Slots the cell cannot fill hold -1e30 and the indices the
// stable sort would put there (the lowest indices that did not survive);
// slots past the level's k hold -1e30 and index 0.
//
// The dense kernel's ring wraps at the image edges, as `torch.roll` does in
// the plain version.  The candidate kernel needs no wrap: a pixel that can
// survive lies `border` >= 4 pixels inside its level, so its ring and the
// rings of its eight neighbours stay inside the level.  It scores only the
// kept area and the one row and column around it, and reads neither the
// atlas's padding columns nor a neighbouring level (coordinates are clamped
// to the level where the staged window overhangs it).
//
// Bound on the H100: operations (about 200 a scored pixel against 4 bytes
// read).  Design: a flat grid of one 128-thread block per cell over all
// levels and images; the block finds its level in the by-value tables of
// atlas_levels.cuh, stages the cell's window with a halo of 4 (ring radius 3
// plus the peak test's 1) as 40 x 40 floats, scores the 34 x 34 inner window
// from it, and does the peak test, the masks, the cell maximum and the
// selection from shared memory (18 KB a block).  Scoring goes in two passes
// so that the lanes of a warp stay together: the compass test of every pixel
// (four differences) lists the few that can score above th_low, then the
// listed pixels get the full score, 16 differences in registers.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "atlas_levels.cuh"

namespace {

// FAST-9/16 score from the 16 ring differences d[k] = ring_k - centre.
__device__ __forceinline__ float fast9_score(const float (&d)[16]) {
  float lo[16], hi[16], t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {  // windows of 2
    lo[k] = fminf(d[k], d[(k + 1) & 15]);
    hi[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
  // windows of 4, 8 and 9: w[k] with w[k + s] for s = 2, 4, 1
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int s = step == 0 ? 2 : (step == 1 ? 4 : 1);
#pragma unroll
    for (int k = 0; k < 16; ++k) t[k] = fminf(lo[k], lo[(k + s) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) lo[k] = t[k];
#pragma unroll
    for (int k = 0; k < 16; ++k) t[k] = fmaxf(hi[k], hi[(k + s) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) hi[k] = t[k];
  }
  float bright = lo[0], dark = hi[0];
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    bright = fmaxf(bright, lo[k]);
    dark = fminf(dark, hi[k]);
  }
  return fmaxf(bright, -dark);
}

// Ring position k as (dy, dx), in the order of CIRCLE_16 of
// orb_slam3_noted_tpu/ops/fast.py; a constant after unrolling.
__device__ __forceinline__ void ring_offset(int k, int& dy, int& dx) {
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  dy = kDy[k];
  dx = kDx[k];
}

// ---------------------------------------------------------------------------
// dense form
// ---------------------------------------------------------------------------

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ int wrap(int i, int n) {
  i += (i < 0) ? n : 0;
  return i - ((i >= n) ? n : 0);
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const float* im = img + static_cast<size_t>(blockIdx.z) * H * W;
  const float c = im[static_cast<size_t>(y) * W + x];

  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    int dy, dx;
    ring_offset(k, dy, dx);
    const int yy = wrap(y + dy, H);
    const int xx = wrap(x + dx, W);
    d[k] = __fsub_rn(__ldg(im + static_cast<size_t>(yy) * W + xx), c);
  }
  out[static_cast<size_t>(blockIdx.z) * H * W + static_cast<size_t>(y) * W + x] =
      fast9_score(d);
}

// ---------------------------------------------------------------------------
// candidates over an atlas
// ---------------------------------------------------------------------------

constexpr int kCell = 32;                  // cell side; a warp-sized chunk is one cell row
constexpr int kHalo = 4;                   // ring radius 3 + the peak test's 1
constexpr int kTile = kCell + 2 * kHalo;   // 40: staged window
constexpr int kScored = kCell + 2;         // 34: scored window
// 128 threads a block: 13 blocks fit an SM (shared memory), so one image's
// 1,182 cells are a single wave.  Measured on an H100 in one run, one image /
// a stereo pair: 0.0210-0.0221 / 0.0349-0.0366 ms, against 0.0234-0.0262 /
// 0.0391-0.0434 with 256 threads and 0.0251-0.0260 / 0.0408-0.0415 with 64.
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = kCell * kCell / kThreads;  // 8 cell pixels a thread
constexpr float kNeg = -1e30f;             // NEG of ops/fast.py

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
fast_candidates_kernel(const float* __restrict__ atlas, float* __restrict__ cand_s,
                       int* __restrict__ cand_i, int HA, int W, int NC, int KC,
                       float th_high, float th_low, int border, const AtlasLevels lv,
                       const AtlasCells cells) {
  __shared__ float tile[kTile * kTile];
  __shared__ float score[kScored * kScored];
  __shared__ float list_s[kCell * kCell];          // survivors, in index order
  __shared__ unsigned short list_i[kCell * kCell];
  __shared__ unsigned chunk_mask[kCell];           // survivors of in-cell row r, bit = column
  __shared__ int chunk_first[kCell + 1];           // survivors ahead of row r; [32] = all
  __shared__ float warp_max[kWarps];
  __shared__ int n_todo;
  // pixels that pass the compass test; done with before the survivors are listed
  unsigned short* todo = reinterpret_cast<unsigned short*>(list_s);
  static_assert(sizeof(list_s) >= kScored * kScored * sizeof(unsigned short), "todo fits");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x;
  int l = 0;
  while (cells.first[l + 1] <= c) ++l;
  const int h = lv.h[l], w = lv.w[l], k = cells.k[l];
  const int in_level = c - cells.first[l];
  const int y0 = (in_level / cells.per_row[l]) * kCell;
  const int x0 = (in_level % cells.per_row[l]) * kCell;
  const float* im = atlas + (static_cast<size_t>(blockIdx.y) * HA + lv.off[l]) * W;
  const size_t out0 = (static_cast<size_t>(blockIdx.y) * NC + c) * KC;

  if (tid < kCell) chunk_mask[tid] = 0u;
  if (tid <= kCell) chunk_first[tid] = 0;
  if (tid == 0) n_todo = 0;
  // the kept area, border pixels inside the level, cut to this cell
  const bool live = max(y0, border) < min(y0 + kCell, h - border) &&
                    max(x0, border) < min(x0 + kCell, w - border);
  if (live) {  // the same for every thread of the block
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, q = e - r * kTile;
      const int y = clampi(y0 - kHalo + r, 0, h - 1);
      const int x = clampi(x0 - kHalo + q, 0, w - 1);
      tile[e] = __ldg(im + static_cast<size_t>(y) * W + x);
    }
    __syncthreads();

    // Pass 1, every pixel of the kept area and of the row and column around
    // it (nothing else is read): the compass test.  A 9-arc of the ring holds
    // two neighbouring compass points, so a score above th_low needs two of
    // them both brighter than the centre by more than th_low, or both darker.
    // Where it fails the score is at most th_low: such a pixel is no
    // candidate, and as a neighbour it loses every peak test a candidate
    // makes, so -inf stands for its score.  The others are listed.
    for (int e0 = 0; e0 < kScored * kScored; e0 += kThreads) {
      const int e = e0 + tid;
      bool full = false;
      if (e < kScored * kScored) {
        const int r = e / kScored, q = e - r * kScored;
        const int y = y0 - 1 + r, x = x0 - 1 + q;
        if (y >= border - 1 && y <= h - border && x >= border - 1 && x <= w - border) {
          const float* p = tile + (r + kHalo - 1) * kTile + (q + kHalo - 1);
          const float ctr = *p;
          const float n = __fsub_rn(p[-3 * kTile], ctr), ea = __fsub_rn(p[3], ctr);
          const float so = __fsub_rn(p[3 * kTile], ctr), we = __fsub_rn(p[-3], ctr);
          const bool bn = n > th_low, be = ea > th_low, bs = so > th_low, bw = we > th_low;
          const bool dn = n < -th_low, de = ea < -th_low, ds = so < -th_low, dw = we < -th_low;
          full = (bn && be) || (be && bs) || (bs && bw) || (bw && bn) ||
                 (dn && de) || (de && ds) || (ds && dw) || (dw && dn);
        }
        score[e] = -CUDART_INF_F;
      }
      const unsigned vote = __ballot_sync(0xffffffffu, full);
      int base = 0;
      if (lane == 0 && vote) base = atomicAdd(&n_todo, __popc(vote));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (full) todo[base + __popc(vote & ((1u << lane) - 1u))] = static_cast<unsigned short>(e);
    }
    __syncthreads();
    // Pass 2, the listed pixels (in no particular order: each writes its own
    // score): the 16 differences in registers, the full score.
    for (int t = tid; t < n_todo; t += kThreads) {
      const int e = todo[t];
      const int r = e / kScored, q = e - r * kScored;
      const float* p = tile + (r + kHalo - 1) * kTile + (q + kHalo - 1);
      const float ctr = *p;
      float d[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        int dy, dx;
        ring_offset(j, dy, dx);
        d[j] = __fsub_rn(p[dy * kTile + dx], ctr);
      }
      score[e] = fast9_score(d);
    }
    __syncthreads();

    // border and low-threshold mask, 3x3 peak test on the raw score
    float val[kPerThread];
    float best = kNeg;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int cy = j * kWarps + warp, cx = lane;  // in-cell index cy * 32 + cx
      const int y = y0 + cy, x = x0 + cx;
      float v = kNeg;
      if (y >= border && y < h - border && x >= border && x < w - border) {
        const float* s = score + (cy + 1) * kScored + (cx + 1);
        const float me = *s;
        const float around = fmaxf(
            fmaxf(fmaxf(s[-kScored - 1], s[-kScored]), fmaxf(s[-kScored + 1], s[-1])),
            fmaxf(fmaxf(s[1], s[kScored - 1]), fmaxf(s[kScored], s[kScored + 1])));
        if (me > th_low && me >= around) v = me;
      }
      val[j] = v;
      best = fmaxf(best, v);
    }
    for (int o = 16; o > 0; o >>= 1) best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
    if (lane == 0) warp_max[warp] = best;
    __syncthreads();
    best = warp_max[0];
#pragma unroll
    for (int j = 1; j < kWarps; ++j) best = fmaxf(best, warp_max[j]);
    const float cell_th = best > th_high ? th_high : th_low;

    // survivors, compacted in index order
    unsigned mine[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      mine[j] = __ballot_sync(0xffffffffu, val[j] > cell_th);
      if (lane == 0) chunk_mask[j * kWarps + warp] = mine[j];
    }
    __syncthreads();
    if (warp == 0) {
      const int n = __popc(chunk_mask[lane]);
      int incl = n;
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      chunk_first[lane] = incl - n;
      if (lane == 31) chunk_first[kCell] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if ((mine[j] >> lane) & 1u) {
        const int cy = j * kWarps + warp;
        const int pos = chunk_first[cy] + __popc(mine[j] & ((1u << lane) - 1u));
        list_s[pos] = val[j];
        list_i[pos] = static_cast<unsigned short>(cy * kCell + lane);
      }
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // one warp: the k best, the lower position first among equals
  const int n_surv = chunk_first[kCell];
  const int n_sel = min(n_surv, k);
  for (int r = 0; r < n_sel; ++r) {
    float bv = -CUDART_INF_F;
    int bp = kCell * kCell;
    for (int p = lane; p < n_surv; p += 32) {
      const float v = list_s[p];
      if (v > bv) { bv = v; bp = p; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int op = __shfl_xor_sync(0xffffffffu, bp, o);
      if (ov > bv || (ov == bv && op < bp)) { bv = ov; bp = op; }
    }
    if (lane == 0) {
      cand_s[out0 + r] = bv;
      cand_i[out0 + r] = list_i[bp];
      list_s[bp] = -CUDART_INF_F;  // taken
    }
    __syncwarp();
  }
  // what the stable sort puts behind the survivors: the lowest indices that
  // did not survive, in order
  int filled = n_sel;
  for (int cy = 0; cy < kCell && filled < k; ++cy) {
    const unsigned rest = ~chunk_mask[cy];
    const int slot = filled + __popc(rest & ((1u << lane) - 1u));
    if (((rest >> lane) & 1u) && slot < k) {
      cand_s[out0 + slot] = kNeg;
      cand_i[out0 + slot] = cy * kCell + lane;
    }
    filled += __popc(rest);
  }
  for (int slot = k + lane; slot < KC; slot += 32) {
    cand_s[out0 + slot] = kNeg;
    cand_i[out0 + slot] = 0;
  }
}

}  // namespace

extern "C" int orb_fast_score(const float* img, float* out, int B, int H, int W,
                              void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

// `hw` holds n_levels pairs (h_l, w_l) and `k` n_levels candidate counts per
// cell (0: the level is skipped), both in host memory; the levels are stacked
// in that order from row 0 of each (HA, W) image.  `cand_s` and `cand_i` are
// (B, NC, KC) with NC the cells of all levels that have k > 0, in level order,
// and KC >= every k.
extern "C" int orb_fast_candidates(const float* atlas, float* cand_s, int* cand_i, int B,
                                   int HA, int W, int n_levels, const int* hw, const int* k,
                                   int NC, int KC, float th_high, float th_low, int border,
                                   void* stream) {
  AtlasLevels lv;
  AtlasCells cells;
  if (border < kHalo || !fill_levels(lv, hw, n_levels, HA, W, 2 * border + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fill_cells(cells, lv, k, kCell) != NC) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < n_levels; ++l)
    if (k[l] < 0 || k[l] > KC || k[l] > kCell * kCell)
      return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(NC, B);
  fast_candidates_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      atlas, cand_s, cand_i, HA, W, NC, KC, th_high, th_low, border, lv, cells);
  return static_cast<int>(cudaGetLastError());
}
