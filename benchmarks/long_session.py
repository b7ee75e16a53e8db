"""Long-session robustness benchmark: a 10k-scan multi-lap office session.

The unbounded-map-growth axis (SURVEY.md §5.7) at a scale no test touches (largest: 2000 scans).  A robot laps the office-grid world for
``--scans`` raw scans (~25 laps at the default), so keyframes, loop
closures, and constraints keep accumulating the whole run.  Records:

  * wall-clock curve: per-1000-raw-scan block walls (does the session slow
    down as the graph grows?),
  * solver bucket recompiles: every optimization's power-of-two
    (node, constraint) bucket — each NEW bucket is one LM program compile,
  * graph/lc_log growth: keyframes, constraints, closure accept/reject
    counts, lc_log deque lengths vs their 100k cap,
  * peak RSS,
  * final ATE (raw + SE(2)-aligned) vs odometry-only.

Usage: python benchmarks/long_session.py [--scans 10000] [--quick]
Appends one JSON row to benchmarks/long_session.json and prints it.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "long_session.json")


def make_lap_bag(n_scans: int, laps: int, seed: int = 1):
    """Multi-lap office loop: the office-world waypoint ring traversed
    ``laps`` times, sampled to n_scans with drifting odometry."""
    from ndt_2d_tpu.io.bag import ScanBag
    from ndt_2d_tpu.utils import sim

    world = sim.make_office_world(16.0)
    ring = [(2.0, 2.0), (14.0, 2.0), (14.0, 14.0), (2.0, 14.0), (2.0, 2.0)]
    pts = []
    for _ in range(laps):
        for i in range(len(ring) - 1):
            a, b = np.asarray(ring[i]), np.asarray(ring[i + 1])
            seg = max(int(np.hypot(*(b - a)) / 0.3), 1)
            for s in range(seg):
                pts.append(a + (b - a) * s / seg)
    pts = np.asarray(pts)
    idx = np.linspace(0, len(pts) - 1, n_scans).astype(int)
    pts = pts[idx]
    ths = np.zeros(len(pts))
    ths[1:] = np.arctan2(np.diff(pts[:, 1]), np.diff(pts[:, 0]))
    truth = np.concatenate([pts, ths[:, None]], axis=-1)

    odom = sim.drift_odometry(truth, trans_noise=0.02, rot_noise=0.004,
                              seed=seed)
    rng = np.random.default_rng(seed)
    msgs = [sim.scan_at_pose(world, truth[t], n_beams=360, range_max=12.0,
                             noise=0.01, rng=rng)
            for t in range(len(truth))]
    return world, truth, odom, msgs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=10_000)
    ap.add_argument("--laps", type=int, default=25)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if args.quick:
        args.scans, args.laps = 600, 2

    from ndt_2d_tpu.config import (MapperConfig, ScanMatcherConfig,
                                   SolverConfig)
    from ndt_2d_tpu.graph import solver as solver_mod
    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.utils import metrics
    from ndt_2d_tpu.utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()

    print(f"generating {args.scans}-scan / {args.laps}-lap bag...",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    world, truth, odom, msgs = make_lap_bag(args.scans, args.laps)
    gen_s = time.perf_counter() - t0

    # Solver-bucket recompile tracking: every optimize call's padded
    # power-of-two (nodes, constraints) bucket; a NEW pair = one LM
    # program compile.
    buckets = []
    orig_solve = solver_mod.solve_graph

    def tracking_solve(graph, config, **kw):
        np_b = max(64, 1 << (graph.num_scans - 1).bit_length())
        cp_b = max(64, 1 << (graph.num_constraints - 1).bit_length())
        buckets.append((np_b, cp_b))
        return orig_solve(graph, config, **kw)

    solver_mod.solve_graph = tracking_solve

    mcfg = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    gcfg = ScanMatcherConfig(
        ndt_resolution=0.35, search_linear_size=0.15,
        search_linear_resolution=0.01, search_angular_size=0.05,
        grid_cells_x=160, grid_cells_y=160, refine_iterations=8)
    cfg = MapperConfig(
        local_scan_matcher=mcfg, global_scan_matcher=gcfg,
        max_points_per_scan=512, global_search_size=4.0,
        loop_closure_every=20, minimum_travel_distance=0.3,
        max_inflight=8, loop_closure_region_size=3,
        solver=dc.replace(SolverConfig(), robust_loss="geman_mcclure"))
    mapper = Mapper(cfg)

    block_walls = []
    used_truth = []
    t_session = time.perf_counter()
    t_block = t_session
    try:
        for t in range(len(truth)):
            res = mapper.process_scan(msgs[t], odom[t])
            if res.accepted:
                used_truth.append(truth[t])
            if (t + 1) % 1000 == 0:
                now = time.perf_counter()
                block_walls.append(round(now - t_block, 2))
                t_block = now
                print(json.dumps({
                    "scans": t + 1, "block_wall_s": block_walls[-1],
                    "keyframes": mapper.graph.num_scans,
                    "constraints": mapper.graph.num_constraints,
                    "closures": int(
                        mapper.graph.constraint_switchable.sum()),
                    "rss_mb": round(resource.getrusage(
                        resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
                }), file=sys.stderr, flush=True)
        mapper.flush()
        mapper.loop_closure()
    finally:
        solver_mod.solve_graph = orig_solve
    wall = time.perf_counter() - t_session

    used_truth = np.asarray(used_truth)
    final = mapper.graph.poses[:len(used_truth)]
    uniq_buckets = sorted(set(buckets))
    row = {
        "name": "long_session_office",
        "scans_in": args.scans,
        "laps": args.laps,
        "bag_gen_s": round(gen_s, 1),
        "keyframes": int(mapper.graph.num_scans),
        "constraints": int(mapper.graph.num_constraints),
        "loop_closures": int(mapper.graph.constraint_switchable.sum()),
        "loop_closures_rejected": mapper.stats.loop_closures_rejected,
        "optimizations": len(buckets),
        "solver_buckets": [list(b) for b in uniq_buckets],
        "solver_bucket_compiles": len(uniq_buckets),
        "lc_log_candidates": len(mapper.lc_log["candidates"]),
        "lc_log_decisions": len(mapper.lc_log["decisions"]),
        "lc_log_cap": mapper.lc_log["decisions"].maxlen,
        "wall_s": round(wall, 1),
        "block_walls_s": block_walls,
        "scan_wall_ms_first_vs_last_block": (
            [round(block_walls[0], 2), round(block_walls[-1], 2)]
            if len(block_walls) >= 2 else None),
        "peak_rss_mb": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
        "odom_only_ate_m": round(metrics.ate_rmse(odom, truth), 4),
        "ate_rmse_m": round(metrics.ate_rmse(final, used_truth), 4),
        "ate_aligned_m": round(
            metrics.ate_rmse_aligned(final, used_truth), 4),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    existing = []
    if os.path.exists(RESULTS):
        with open(RESULTS) as f:
            existing = json.load(f)
    existing.append(row)
    with open(RESULTS, "w") as f:
        json.dump(existing, f, indent=1)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
