// How the run kernels of window_mma_tile.cuh (window_run_mma) share their
// windows among blocks: the run a block walks, chosen on the host
// (window_run_launch), and, for the slab kernel, the windows of one window
// row that a block owns.
//
// Host-only C++ but for the VTT_HD functions, so the CPU tests compile this
// header with the system's C++ compiler and walk every block of a plan
// (tests/test_torch_host_plans.py).
#pragma once

#ifdef __CUDACC__
#define VTT_HD __host__ __device__
#else
#define VTT_HD
#endif

namespace vtt {
namespace mma {

constexpr int kMaxRun = 16;  // steps a block walks at most

// A launch of g windows, H heads, wpb windows a step, on a card that holds
// `wave` blocks at once: `run` steps a block, `blocks` blocks a head.
struct RunPlan {
  int run;
  long long blocks;
};

// row_windows 0: the windows are one sequence (rows 11 and 12). The
// blocks the card holds at once are shared evenly among the heads, each
// head's ceil(g / wpb) steps split among its share, so that one wave covers
// the work; at most kMaxRun steps a block, and more blocks (waves) past
// that.
//
// row_windows > 0 (the slab kernel of row 13, g a multiple of it): no
// block crosses a window row. A block owns `run` steps of one row, run a
// divisor of the row's ceil(row_windows / wpb) steps, so every block of a
// row walks as many; of those runs the one whose waves cost the fewest
// steps, ceil(blocks · H / wave) · run, and of equal costs the longest (the
// fewest blocks, the most copies in flight behind the products).
inline RunPlan window_run_plan(long long g, int row_windows, int wpb,
                               int heads, long long wave) {
  if (row_windows <= 0) {
    const long long steps = (g + wpb - 1) / wpb;
    long long share = wave / heads;
    if (share < 1) share = 1;
    long long run = (steps + share - 1) / share;
    if (run > kMaxRun) run = kMaxRun;
    return {static_cast<int>(run), (steps + run - 1) / run};
  }
  const long long rows = g / row_windows;
  const int row_steps = (row_windows + wpb - 1) / wpb;
  RunPlan best{0, 0};
  long long best_cost = 0;
  for (int run = 1; run <= row_steps && run <= kMaxRun; ++run) {
    if (row_steps % run != 0) continue;
    const long long blocks = rows * (row_steps / run);
    const long long cost = (blocks * heads + wave - 1) / wave * run;
    if (best.run == 0 || cost <= best_cost) {
      best = {run, blocks};
      best_cost = cost;
    }
  }
  return best;
}

// The windows block x of a row-constrained launch walks: row `row`, slot 0
// from window `first` on, every window it takes below `end`, the row's end.
struct RowBlock {
  int row;
  long long first, end;
};

VTT_HD inline RowBlock row_block(int x, int row_windows, int wpb, int run) {
  const int per = wpb * run;
  const int chunks = (row_windows + per - 1) / per;
  const int row = x / chunks;
  const long long row_first = static_cast<long long>(row) * row_windows;
  return {row, row_first + static_cast<long long>(x % chunks) * per,
          row_first + row_windows};
}

}  // namespace mma
}  // namespace vtt
