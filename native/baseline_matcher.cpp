// Single-threaded CPU NDT scan matcher: the benchmark baseline.
//
// This is a from-scratch flat-array implementation of the same algorithm the
// reference runs (window NDT build + exhaustive 3-DoF candidate search,
// cf. /root/reference/src/scan_matcher_ndt.cpp and src/ndt_model.cpp) so that
// bench.py can measure an honest C++ single-core candidates/sec figure on the
// benchmark host and compare the JAX matcher against it.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libndt2d_native.so \
//            baseline_matcher.cpp graph_codec.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "ndt_core.hpp"

using ndt2d_native::CellStats;
using ndt2d_native::Grid;
using ndt2d_native::finalize;
using ndt2d_native::score_point;

extern "C" {

// Build the window NDT and run one exhaustive candidate search.
// Returns the per-beam-normalized best score; fills correction[3] and the
// candidate count evaluated (for throughput math).
double ndt2d_match_baseline(
    const float* window_poses,   // [S, 3]
    const float* window_points,  // [S, P, 2] robot frame
    const uint8_t* window_mask,  // [S, P]
    int S, int P,
    const float* scan_points,    // [P, 2]
    const uint8_t* scan_mask,    // [P]
    int n_scan_points,
    const float* pose,           // [3]
    double range_max, double ndt_resolution,
    double angular_res, double angular_size,
    double linear_res, double linear_size,
    int max_beams,
    float* correction_out,       // [3]
    long long* candidates_out) {
  // --- bounding box over window poses +- range_max ---
  double minx = 1e30, miny = 1e30, maxx = -1e30, maxy = -1e30;
  for (int i = 0; i < S; ++i) {
    minx = std::min(minx, (double)window_poses[i * 3 + 0] - range_max);
    maxx = std::max(maxx, (double)window_poses[i * 3 + 0] + range_max);
    miny = std::min(miny, (double)window_poses[i * 3 + 1] - range_max);
    maxy = std::max(maxy, (double)window_poses[i * 3 + 1] + range_max);
  }
  Grid g;
  g.ox = minx;
  g.oy = miny;
  g.cell = ndt_resolution;
  g.w = static_cast<int>((maxx - minx) / ndt_resolution) + 1;
  g.h = static_cast<int>((maxy - miny) / ndt_resolution) + 1;
  g.cells.assign(static_cast<size_t>(g.w) * g.h, CellStats());

  // --- accumulate window points ---
  for (int i = 0; i < S; ++i) {
    const double px = window_poses[i * 3 + 0];
    const double py = window_poses[i * 3 + 1];
    const double ct = std::cos(window_poses[i * 3 + 2]);
    const double st = std::sin(window_poses[i * 3 + 2]);
    for (int j = 0; j < P; ++j) {
      if (!window_mask[i * P + j]) continue;
      const double lx = window_points[(i * P + j) * 2 + 0];
      const double ly = window_points[(i * P + j) * 2 + 1];
      const double x = px + ct * lx - st * ly;
      const double y = py + st * lx + ct * ly;
      const int idx = g.index(x, y);
      if (idx < 0) continue;
      CellStats& c = g.cells[idx];
      c.n += 1;
      c.sx += x;
      c.sy += y;
      c.sxx += x * x;
      c.sxy += x * y;
      c.syy += y * y;
    }
  }
  finalize(g);

  // --- subsample the scan ---
  const int used = std::min(max_beams, n_scan_points);
  const double step = used > 0 ? (double)n_scan_points / used : 1.0;
  std::vector<double> bx(used), by(used);
  for (int i = 0; i < used; ++i) {
    int idx = static_cast<int>(i * step);
    if (idx >= n_scan_points) idx = n_scan_points - 1;
    bx[i] = scan_points[idx * 2 + 0];
    by[i] = scan_points[idx * 2 + 1];
  }

  // --- exhaustive search ---
  double best = 0.0;
  double bdx = 0.0, bdy = 0.0, bdth = 0.0;
  long long candidates = 0;
  std::vector<double> rx(used), ry(used);
  for (double dth = -angular_size; dth < angular_size; dth += angular_res) {
    const double ct = std::cos(pose[2] + dth);
    const double st = std::sin(pose[2] + dth);
    for (int i = 0; i < used; ++i) {
      rx[i] = ct * bx[i] - st * by[i] + pose[0];
      ry[i] = st * bx[i] + ct * by[i] + pose[1];
    }
    for (double dx = -linear_size; dx < linear_size; dx += linear_res) {
      for (double dy = -linear_size; dy < linear_size; dy += linear_res) {
        double sum = 0.0;
        for (int i = 0; i < used; ++i) {
          sum += score_point(g, rx[i] + dx, ry[i] + dy);
        }
        const double score = -sum;
        ++candidates;
        if (score < best) {
          best = score;
          bdx = dx;
          bdy = dy;
          bdth = dth;
        }
      }
    }
  }

  correction_out[0] = static_cast<float>(bdx);
  correction_out[1] = static_cast<float>(bdy);
  correction_out[2] = static_cast<float>(bdth);
  *candidates_out = candidates;
  return used > 0 ? best / used : 0.0;
}

}  // extern "C"
