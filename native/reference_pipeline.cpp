// Reference-shaped full SLAM pipeline: the trajectory ORACLE.
//
// "Reference-equivalent ATE" needs a reference-shaped full pipeline that
// produces a trajectory on the benchmark bags.  This file is that
// pipeline: a from-scratch single-threaded C++ SLAM loop with the same
// structure and math as the reference node
// (cf. /root/reference/src/ndt_mapper.cpp:495-683):
//
//   per scan: motion gate -> dead-reckon from odometry -> rolling-window NDT
//   build -> exhaustive matchScan (with Olson covariance) -> apply correction
//   -> odometry constraint (makeConstraint math, src/constraint.cpp:35-56);
//   on a scan cadence: barycenter radius candidate search
//   (src/graph.cpp:167-189 semantics: SQUARED radius, sorted, excludes the
//   rolling window), per-candidate 2-scan-region NDT rebuild + matchScan,
//   accept when score < EWMA(typical response) * gate_scale
//   (src/ndt_mapper.cpp:645), correct the pose, add a switchable constraint;
//   optimize with Gauss-Newton on the PoseGraph2dErrorTerm residual
//   (include/ndt_2d/ceres_solver_pose.hpp:93-108), first node gauge-fixed,
//   dense Cholesky normal equations (the reference's
//   SPARSE_NORMAL_CHOLESKY analog at these graph sizes).
//
// benchmarks/reference_oracle.py replays the SAME bags through this loop and
// through the JAX mapper and reports ATE side by side.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "ndt_core.hpp"

namespace {

using ndt2d_native::CellStats;
using ndt2d_native::Grid;
using ndt2d_native::finalize;
using ndt2d_native::score_point;

struct Pose {
  double x = 0.0, y = 0.0, th = 0.0;
};

struct Constraint {
  int a, b;
  double t[3];
  double info[9];
};

double normalize_angle(double a) {
  return a - 2.0 * M_PI * std::floor((a + M_PI) / (2.0 * M_PI));
}

struct MatchResult {
  double score = 0.0;
  double corr[3] = {0.0, 0.0, 0.0};
  double cov[9] = {0.0};
};

// Exhaustive matchScan over an explicit scan window, with the Olson
// covariance accumulation the reference computes
// (src/scan_matcher_ndt.cpp:103-148).
MatchResult match_scan(const std::vector<int>& window,
                       const std::vector<Pose>& poses,
                       const std::vector<int>& ids,  // bag index per keyframe
                       const float* points, const uint8_t* mask, int P,
                       int scan_idx, const Pose& start, double range_max,
                       double res, double ang_res, double ang_size,
                       double lin_res, double lin_size, int max_beams) {
  MatchResult out;
  if (window.empty()) return out;
  double minx = 1e30, miny = 1e30, maxx = -1e30, maxy = -1e30;
  for (int s : window) {
    minx = std::min(minx, poses[s].x - range_max);
    maxx = std::max(maxx, poses[s].x + range_max);
    miny = std::min(miny, poses[s].y - range_max);
    maxy = std::max(maxy, poses[s].y + range_max);
  }
  Grid g;
  g.ox = minx;
  g.oy = miny;
  g.cell = res;
  g.w = static_cast<int>((maxx - minx) / res) + 1;
  g.h = static_cast<int>((maxy - miny) / res) + 1;
  g.cells.assign(static_cast<size_t>(g.w) * g.h, CellStats());
  for (int s : window) {
    const double ct = std::cos(poses[s].th), st = std::sin(poses[s].th);
    const size_t b = (size_t)ids[s] * P;  // points/mask are BAG-indexed
    for (int j = 0; j < P; ++j) {
      if (!mask[b + j]) continue;
      const double lx = points[(b + j) * 2 + 0];
      const double ly = points[(b + j) * 2 + 1];
      const double x = poses[s].x + ct * lx - st * ly;
      const double y = poses[s].y + st * lx + ct * ly;
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

  // stride-subsample the query scan (scan_matcher_ndt.cpp:94-101)
  std::vector<double> bx, by;
  {
    std::vector<double> vx, vy;
    for (int j = 0; j < P; ++j) {
      if (!mask[(size_t)scan_idx * P + j]) continue;
      vx.push_back(points[((size_t)scan_idx * P + j) * 2 + 0]);
      vy.push_back(points[((size_t)scan_idx * P + j) * 2 + 1]);
    }
    const int n = static_cast<int>(vx.size());
    const int used = std::min(max_beams, n);
    const double step = used > 0 ? (double)n / used : 1.0;
    bx.resize(used);
    by.resize(used);
    for (int i = 0; i < used; ++i) {
      int k = static_cast<int>(i * step);
      if (k >= n) k = n - 1;
      bx[i] = vx[k];
      by[i] = vy[k];
    }
  }
  const int used = static_cast<int>(bx.size());
  if (used == 0) return out;

  double best = 0.0, bdx = 0.0, bdy = 0.0, bdth = 0.0;
  // Olson covariance accumulators (scan_matcher_ndt.cpp:136-141)
  double K[9] = {0.0}, u[3] = {0.0}, sw = 0.0;
  std::vector<double> rx(used), ry(used);
  for (double dth = -ang_size; dth < ang_size; dth += ang_res) {
    const double ct = std::cos(start.th + dth);
    const double st = std::sin(start.th + dth);
    for (int i = 0; i < used; ++i) {
      rx[i] = ct * bx[i] - st * by[i] + start.x;
      ry[i] = st * bx[i] + ct * by[i] + start.y;
    }
    for (double dx = -lin_size; dx < lin_size; dx += lin_res) {
      for (double dy = -lin_size; dy < lin_size; dy += lin_res) {
        double sum = 0.0;
        for (int i = 0; i < used; ++i) {
          sum += score_point(g, rx[i] + dx, ry[i] + dy);
        }
        const double score = -sum;
        const double v[3] = {dx, dy, dth};
        for (int r = 0; r < 3; ++r) {
          for (int c = 0; c < 3; ++c) K[r * 3 + c] += v[r] * v[c] * score;
          u[r] += v[r] * score;
        }
        sw += score;
        if (score < best) {
          best = score;
          bdx = dx;
          bdy = dy;
          bdth = dth;
        }
      }
    }
  }
  out.score = best / used;
  out.corr[0] = bdx;
  out.corr[1] = bdy;
  out.corr[2] = bdth;
  if (sw < 0.0) {
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        out.cov[r * 3 + c] = K[r * 3 + c] / sw + u[r] * u[c] / (sw * sw);
  } else {
    out.cov[0] = out.cov[4] = 1.0;   // degenerate search: weak isotropic
    out.cov[8] = 0.25;
  }
  return out;
}

// makeConstraint (src/constraint.cpp:35-56): relative transform in a's
// frame; information = covariance^-1 (3x3 closed-form inverse).
Constraint make_constraint(int a, int b, const Pose& pa, const Pose& pb,
                           const double cov[9]) {
  Constraint c;
  c.a = a;
  c.b = b;
  const double dx = pb.x - pa.x, dy = pb.y - pa.y;
  const double ct = std::cos(pa.th), st = std::sin(pa.th);
  c.t[0] = ct * dx + st * dy;
  c.t[1] = -st * dx + ct * dy;
  c.t[2] = pb.th - pa.th;
  // 3x3 inverse via adjugate
  const double* m = cov;
  const double det = m[0] * (m[4] * m[8] - m[5] * m[7]) -
                     m[1] * (m[3] * m[8] - m[5] * m[6]) +
                     m[2] * (m[3] * m[7] - m[4] * m[6]);
  const double d = std::fabs(det) > 1e-30 ? det : 1e-30;
  c.info[0] = (m[4] * m[8] - m[5] * m[7]) / d;
  c.info[1] = (m[2] * m[7] - m[1] * m[8]) / d;
  c.info[2] = (m[1] * m[5] - m[2] * m[4]) / d;
  c.info[3] = (m[5] * m[6] - m[3] * m[8]) / d;
  c.info[4] = (m[0] * m[8] - m[2] * m[6]) / d;
  c.info[5] = (m[2] * m[3] - m[0] * m[5]) / d;
  c.info[6] = (m[3] * m[7] - m[4] * m[6]) / d;
  c.info[7] = (m[1] * m[6] - m[0] * m[7]) / d;
  c.info[8] = (m[0] * m[4] - m[1] * m[3]) / d;
  return c;
}

// Dense Cholesky solve of A x = b (A symmetric positive definite, n x n).
bool cholesky_solve(std::vector<double>& A, std::vector<double>& b, int n) {
  for (int j = 0; j < n; ++j) {
    double d = A[(size_t)j * n + j];
    for (int k = 0; k < j; ++k) d -= A[(size_t)j * n + k] * A[(size_t)j * n + k];
    if (d <= 1e-12) return false;
    const double l = std::sqrt(d);
    A[(size_t)j * n + j] = l;
    for (int i = j + 1; i < n; ++i) {
      double s = A[(size_t)i * n + j];
      for (int k = 0; k < j; ++k)
        s -= A[(size_t)i * n + k] * A[(size_t)j * n + k];
      A[(size_t)i * n + j] = s / l;
    }
  }
  for (int i = 0; i < n; ++i) {  // forward
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= A[(size_t)i * n + k] * b[k];
    b[i] = s / A[(size_t)i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {  // backward
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= A[(size_t)k * n + i] * b[k];
    b[i] = s / A[(size_t)i * n + i];
  }
  return true;
}

// Gauss-Newton pose-graph optimization: PoseGraph2dErrorTerm residual
// (ceres_solver_pose.hpp:93-108), node 0 gauge-fixed, <=50 iterations.
void optimize(std::vector<Pose>& poses, const std::vector<Constraint>& cons) {
  const int n = static_cast<int>(poses.size());
  if (n < 2 || cons.empty()) return;
  const int dim = 3 * n;
  std::vector<double> H, g;
  for (int it = 0; it < 50; ++it) {
    H.assign((size_t)dim * dim, 0.0);
    g.assign(dim, 0.0);
    for (const auto& c : cons) {
      const Pose& pa = poses[c.a];
      const Pose& pb = poses[c.b];
      const double ct = std::cos(pa.th), st = std::sin(pa.th);
      const double dx = pb.x - pa.x, dy = pb.y - pa.y;
      const double r[3] = {ct * dx + st * dy - c.t[0],
                           -st * dx + ct * dy - c.t[1],
                           normalize_angle(pb.th - pa.th - c.t[2])};
      // Jacobians (same blocks as ndt_2d_tpu/graph/solver.py)
      const double ja[9] = {-ct, -st, -st * dx + ct * dy,
                            st, -ct, -ct * dx - st * dy,
                            0.0, 0.0, -1.0};
      const double jb[9] = {ct, st, 0.0, -st, ct, 0.0, 0.0, 0.0, 1.0};
      double lr[3] = {0.0, 0.0, 0.0};    // info * r
      double lja[9], ljb[9];             // info * J
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
          lr[i] += c.info[i * 3 + j] * r[j];
          double sa = 0.0, sb = 0.0;
          for (int k = 0; k < 3; ++k) {
            sa += c.info[i * 3 + k] * ja[k * 3 + j];
            sb += c.info[i * 3 + k] * jb[k * 3 + j];
          }
          lja[i * 3 + j] = sa;
          ljb[i * 3 + j] = sb;
        }
      }
      const int ia = 3 * c.a, ib = 3 * c.b;
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
          double haa = 0.0, hab = 0.0, hbb = 0.0;
          for (int k = 0; k < 3; ++k) {
            haa += ja[k * 3 + i] * lja[k * 3 + j];
            hab += ja[k * 3 + i] * ljb[k * 3 + j];
            hbb += jb[k * 3 + i] * ljb[k * 3 + j];
          }
          H[(size_t)(ia + i) * dim + (ia + j)] += haa;
          H[(size_t)(ia + i) * dim + (ib + j)] += hab;
          H[(size_t)(ib + j) * dim + (ia + i)] += hab;  // transpose block
          H[(size_t)(ib + i) * dim + (ib + j)] += hbb;
        }
        double ga = 0.0, gb = 0.0;
        for (int k = 0; k < 3; ++k) {
          ga += ja[k * 3 + i] * lr[k];
          gb += jb[k * 3 + i] * lr[k];
        }
        g[ia + i] += ga;
        g[ib + i] += gb;
      }
    }
    // gauge fix node 0: identity rows/cols, zero rhs
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < dim; ++j) {
        H[(size_t)i * dim + j] = 0.0;
        H[(size_t)j * dim + i] = 0.0;
      }
      H[(size_t)i * dim + i] = 1.0;
      g[i] = 0.0;
    }
    // Levenberg damping for robustness
    for (int i = 0; i < dim; ++i) H[(size_t)i * dim + i] += 1e-9;
    std::vector<double> rhs(dim);
    for (int i = 0; i < dim; ++i) rhs[i] = -g[i];
    std::vector<double> A = H;
    if (!cholesky_solve(A, rhs, dim)) return;  // keep old poses (failed)
    double step = 0.0;
    for (int i = 0; i < n; ++i) {
      poses[i].x += rhs[3 * i + 0];
      poses[i].y += rhs[3 * i + 1];
      poses[i].th += rhs[3 * i + 2];
      step += std::fabs(rhs[3 * i + 0]) + std::fabs(rhs[3 * i + 1]) +
              std::fabs(rhs[3 * i + 2]);
    }
    if (step < 1e-9) break;
  }
}

}  // namespace

extern "C" {

// Full reference-shaped SLAM over pre-projected scans.  Returns the number
// of accepted keyframes; fills poses_out[accepted * 3],
// accepted_ids_out[accepted], n_closures_out, n_optimizations_out.
int ndt2d_reference_slam(
    const float* points,          // [T, P, 2] robot-frame projected points
    const uint8_t* mask,          // [T, P]
    const double* odom,           // [T, 3]
    int T, int P,
    double range_max,
    double min_travel_d, double min_travel_rot, int rolling_depth,
    double l_res, double l_ang_res, double l_ang_size, double l_lin_res,
    double l_lin_size,
    double g_res, double g_ang_res, double g_ang_size, double g_lin_res,
    double g_lin_size,
    int max_beams,
    double global_search_size,    // SQUARED radius (nanoflann semantics)
    int global_search_limit, int optimization_node_limit,
    int loop_closure_every, double gate_scale,
    double* poses_out, int* accepted_ids_out,
    int* n_closures_out, int* n_optimizations_out) {
  std::vector<Pose> poses;          // accepted keyframe poses
  std::vector<int> ids;             // bag index per keyframe
  std::vector<Constraint> cons;
  double typical = -0.5;            // ndt_mapper.cpp:55
  Pose prev_odom, prev_robot;
  bool have_prev = false;
  int closures = 0, optimizations = 0;
  int processed = 0;                // loop-closure cursor
  int last_opt = 0;
  int since_lc = 0;

  auto barycenter = [&](int k, double* bx, double* by) {
    const int s = ids[k];
    double mx = 0.0, my = 0.0;
    int n = 0;
    for (int j = 0; j < P; ++j) {
      if (!mask[(size_t)s * P + j]) continue;
      mx += points[((size_t)s * P + j) * 2 + 0];
      my += points[((size_t)s * P + j) * 2 + 1];
      ++n;
    }
    if (n) {
      mx /= n;
      my /= n;
    }
    const double ct = std::cos(poses[k].th), st = std::sin(poses[k].th);
    *bx = poses[k].x + ct * mx - st * my;
    *by = poses[k].y + st * mx + ct * my;
  };

  auto loop_closure_pass = [&]() {
    since_lc = 0;
    const int num = static_cast<int>(poses.size());
    if (num <= rolling_depth) return;
    if (processed <= rolling_depth) processed = rolling_depth + 1;
    int added = 0;
    for (; processed < num; ++processed) {
      const int idx = processed;
      const int rolling = idx - rolling_depth;
      if (rolling <= 0) continue;
      double qx, qy;
      barycenter(idx, &qx, &qy);
      // brute-force squared-radius search over barycenters, sorted
      std::vector<std::pair<double, int>> cand;
      for (int i = 0; i < rolling; ++i) {
        double bx, by;
        barycenter(i, &bx, &by);
        const double d2 = (bx - qx) * (bx - qx) + (by - qy) * (by - qy);
        if (d2 < global_search_size) cand.emplace_back(d2, i);
      }
      std::sort(cand.begin(), cand.end());
      int checks = 0;
      for (const auto& [d2, i] : cand) {
        if (checks++ >= global_search_limit) break;
        // candidate region {i-1, i} (exclusive end, ndt_mapper.cpp:627-631)
        std::vector<int> region;
        if (i > 0) region.push_back(i - 1);
        region.push_back(i);
        std::vector<int> region_ids;
        for (int k : region) region_ids.push_back(k);
        MatchResult m = match_scan(region_ids, poses, ids, points, mask, P,
                                   ids[idx], poses[idx], range_max, g_res,
                                   g_ang_res, g_ang_size, g_lin_res,
                                   g_lin_size, max_beams);
        if (std::isfinite(m.score) && m.score < typical * gate_scale) {
          poses[idx].x += m.corr[0];
          poses[idx].y += m.corr[1];
          poses[idx].th += m.corr[2];
          cons.push_back(
              make_constraint(i, idx, poses[i], poses[idx], m.cov));
          ++closures;
          ++added;
        }
      }
    }
    if (added && num - last_opt > optimization_node_limit) {
      optimize(poses, cons);
      ++optimizations;
      last_opt = num;
      // re-anchor the dead-reckoning chain (round-3 fix; see
      // mapping/mapper.py::_reanchor_pose)
      prev_robot = poses.back();
    }
  };

  for (int t = 0; t < T; ++t) {
    const Pose od = {odom[(size_t)t * 3 + 0], odom[(size_t)t * 3 + 1],
                     odom[(size_t)t * 3 + 2]};
    Pose robot;
    if (have_prev) {
      const double dx = od.x - prev_odom.x;
      const double dy = od.y - prev_odom.y;
      const double dth = normalize_angle(od.th - prev_odom.th);
      if (dx * dx + dy * dy < min_travel_d * min_travel_d &&
          std::fabs(dth) < min_travel_rot) {
        continue;  // motion gate (ndt_mapper.cpp:343-355)
      }
      const double heading = normalize_angle(prev_robot.th - prev_odom.th);
      const double ch = std::cos(heading), sh = std::sin(heading);
      robot.x = prev_robot.x + dx * ch - dy * sh;
      robot.y = prev_robot.y + dx * sh + dy * ch;
      robot.th = normalize_angle(prev_robot.th + dth);
    }

    double cov[9] = {0.0};
    if (!poses.empty()) {
      // rolling window = last rolling_depth keyframes
      std::vector<int> window;
      const int lo =
          std::max(0, static_cast<int>(poses.size()) - rolling_depth);
      for (int k = lo; k < static_cast<int>(poses.size()); ++k)
        window.push_back(k);
      MatchResult m =
          match_scan(window, poses, ids, points, mask, P, t, robot, range_max,
                     l_res, l_ang_res, l_ang_size, l_lin_res, l_lin_size,
                     max_beams);
      typical = 0.95 * typical + 0.05 * m.score;  // EWMA (ndt_mapper.cpp:518)
      robot.x += m.corr[0];
      robot.y += m.corr[1];
      robot.th += m.corr[2];
      std::memcpy(cov, m.cov, sizeof(cov));
    }

    // NOTE: the reference stores the scan with id == index
    // (ndt_mapper.cpp:398); window scans reference keyframe indices but
    // match_scan needs the BAG index for the query's points.
    poses.push_back(robot);
    ids.push_back(t);
    if (poses.size() > 1) {
      const int k = static_cast<int>(poses.size()) - 1;
      cons.push_back(
          make_constraint(k - 1, k, poses[k - 1], poses[k], cov));
    }
    prev_odom = od;
    prev_robot = robot;
    have_prev = true;

    if (++since_lc >= loop_closure_every) loop_closure_pass();
  }
  loop_closure_pass();
  // final optimization if closures arrived after the last cadence check
  if (closures && optimizations == 0) {
    optimize(poses, cons);
    ++optimizations;
  }

  const int n = static_cast<int>(poses.size());
  for (int k = 0; k < n; ++k) {
    poses_out[k * 3 + 0] = poses[k].x;
    poses_out[k * 3 + 1] = poses[k].y;
    poses_out[k * 3 + 2] = poses[k].th;
    accepted_ids_out[k] = ids[k];
  }
  *n_closures_out = closures;
  *n_optimizations_out = optimizations;
  return n;
}

}  // extern "C"
