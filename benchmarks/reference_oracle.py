"""Reference-pipeline trajectory oracle: measured reference-vs-JAX ATE.

"Reference-equivalent ATE" needs a reference-shaped full pipeline that
produces a trajectory on the benchmark bags, not odometry-relative claims.
This benchmark replays the SAME bags through

  * the native single-threaded C++ reference-shaped SLAM loop
    (native/reference_pipeline.cpp: rolling-window match -> constraint ->
    barycenter-radius loop closure + EWMA gate -> Gauss-Newton solve, the
    structure of /root/reference/src/ndt_mapper.cpp:495-683), and
  * the JAX mapper (pipelined, same parameters),

and reports ATE / closures / wall side by side.  Configs: 2 (corridor,
open-loop), 3 (office + loop closure), 9 (CARMEN simlab).

Usage: python benchmarks/reference_oracle.py [--quick] [2 3 9]
Appends rows to benchmarks/oracle_results.json.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "oracle_results.json")


def _project_all(bag, max_points=512):
    from ndt_2d_tpu.mapping import laser
    pts, msks = [], []
    for t in range(len(bag)):
        msg, _ = bag[t]
        p, m = laser.project_scan(msg, bag.range_max, np.zeros(3), False,
                                  np.zeros(3), max_points)
        pts.append(p)
        msks.append(m)
    return np.stack(pts), np.stack(msks)


def _jax_session(bag, truth, cfg):
    import jax

    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.utils import metrics
    mapper = Mapper(cfg)
    used_truth = []
    t0 = time.perf_counter()
    for t in range(len(bag)):
        msg, odom = bag[t]
        res = mapper.process_scan(msg, odom)
        if res.accepted:
            used_truth.append(truth[t])
    mapper.flush()
    mapper.loop_closure()
    wall = time.perf_counter() - t0
    used_truth = np.asarray(used_truth)
    final = mapper.graph.poses[:len(used_truth)]
    return {
        "accepted": len(used_truth),
        "loop_closures": int(mapper.graph.constraint_switchable.sum()),
        "optimizations": mapper.stats.optimizations,
        "ate_rmse_m": round(metrics.ate_rmse(final, used_truth), 4),
        "ate_aligned_m": round(
            metrics.ate_rmse_aligned(final, used_truth), 4),
        "wall_s": round(wall, 2),
    }


def _native_session(bag, truth, cfg, gate_scale):
    from ndt_2d_tpu.io import native
    from ndt_2d_tpu.utils import metrics
    pts, msks = _project_all(bag, cfg.max_points_per_scan)
    t0 = time.perf_counter()
    poses, ids, ncl, nopt = native.reference_slam(
        pts, msks, bag.odom, bag.range_max, cfg, gate_scale=gate_scale)
    wall = time.perf_counter() - t0
    used_truth = truth[ids]
    return {
        "accepted": len(poses),
        "loop_closures": ncl,
        "optimizations": nopt,
        "ate_rmse_m": round(metrics.ate_rmse(poses, used_truth), 4),
        "ate_aligned_m": round(
            metrics.ate_rmse_aligned(poses, used_truth), 4),
        "wall_s": round(wall, 2),
    }


def _office_cfg():
    from ndt_2d_tpu.config import (MapperConfig, ScanMatcherConfig,
                                   SolverConfig)
    return MapperConfig(
        local_scan_matcher=ScanMatcherConfig(grid_cells_x=192,
                                             grid_cells_y=192),
        global_scan_matcher=ScanMatcherConfig(
            ndt_resolution=0.35, search_linear_size=0.15,
            search_linear_resolution=0.01, search_angular_size=0.05,
            grid_cells_x=160, grid_cells_y=160,
            # This build's recipe additions: Newton-polished confirmation
            refine_iterations=8),
        max_points_per_scan=512, global_search_size=4.0,
        optimization_node_limit=10, loop_closure_every=20,
        minimum_travel_distance=0.3, max_inflight=8,
        loop_closure_gate_scale=0.85,
        # ... region-3 confirmation windows and the dual-position radius
        # search (reverse-revisit recall) — the "office" recipe of
        # cli._RECIPES; the native arm below still runs the
        # reference's own recipe on the same bags.
        loop_closure_region_size=3, loop_search_positions="both",
        solver=dc.replace(SolverConfig(), robust_loss="geman_mcclure"))


def run_config(num: int, quick: bool) -> dict:
    from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig
    from ndt_2d_tpu.io import bag as bag_mod
    from ndt_2d_tpu.utils import metrics

    if num == 2:
        n = 60 if quick else 200
        bag = bag_mod.record_synthetic("corridor", n, n_beams=600, seed=0)
        truth = bag.truth
        cfg = MapperConfig(
            local_scan_matcher=ScanMatcherConfig(grid_cells_x=192,
                                                 grid_cells_y=192),
            global_scan_matcher=ScanMatcherConfig(grid_cells_x=192,
                                                  grid_cells_y=192),
            max_points_per_scan=512, loop_closure_every=10**9,
            max_inflight=8)
    elif num == 3:
        n = 200 if quick else 2000
        bag = bag_mod.record_synthetic("office", n, n_beams=600,
                                       range_max=12.0, seed=1,
                                       odom_trans_noise=0.02,
                                       odom_rot_noise=0.004)
        truth = bag.truth
        cfg = _office_cfg()
    elif num == 9:
        from ndt_2d_tpu.io import carmen
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        bag = carmen.load_carmen(
            os.path.join(root, "datasets", "simlab.clf.gz"), range_max=10.0)
        truth = np.load(os.path.join(root, "datasets",
                                     "simlab_truth.npz"))["truth"]
        if quick:
            k = min(len(bag), 300)
            bag = dc.replace(
                bag, ranges=bag.ranges[:k], odom=bag.odom[:k],
                times=bag.times[:k] if bag.times is not None else None)
            truth = truth[:k]
        # Simlab's measured recipe keeps the PARITY gate (1.0): with the
        # dual-position candidates the 0.85 office gate over-accepts
        # reverse-direction edges (measured: ATE 0.208 vs 0.101 at 1.0).
        cfg = dc.replace(_office_cfg(), max_range=10.0,
                         loop_closure_gate_scale=1.0)
    else:
        raise ValueError(num)

    # The native arm runs the REFERENCE'S OWN recipe: gate_scale 1.0
    # (score < typical_matcher_response_, ndt_mapper.cpp:645) and plain
    # squared loss — the behavior a user of the reference gets.  The JAX arm
    # runs this build's tuned recipe (gate 0.85 + redescending loss on
    # switchable edges).  Both see identical bags and matcher parameters.
    native_row = _native_session(bag, truth, cfg, gate_scale=1.0)
    jax_row = _jax_session(bag, truth, cfg)
    return {
        "config": num,
        "name": f"oracle_config{num}",
        "scans_in": len(bag),
        "odom_only_ate_m": round(metrics.ate_rmse(bag.odom[:len(truth)],
                                                  truth), 4),
        "reference_pipeline": native_row,
        "jax_pipeline": jax_row,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("configs", nargs="*", type=int, default=None)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    configs = args.configs or [2, 3, 9]

    from ndt_2d_tpu.utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()

    rows = []
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    for c in configs:
        r = run_config(c, args.quick)
        r["ts"] = stamp
        rows.append(r)
        print(json.dumps(r), flush=True)

    existing = []
    if os.path.exists(RESULTS):
        with open(RESULTS) as f:
            existing = json.load(f)
    existing.extend(rows)
    with open(RESULTS, "w") as f:
        json.dump(existing, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
