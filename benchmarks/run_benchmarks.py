"""Benchmark harness for the five BASELINE.json configs.

The reference publishes no numbers (SURVEY.md section 6), so this harness
*creates* the baseline record: each config measures accuracy (ATE / tracking
error) and throughput (scans/sec, candidates/sec, particles/sec) on whatever
backend JAX selects (the GPU on a card host; ``--cpu`` forces the virtual
CPU mesh).  Every row names its device.  Results append to
``benchmarks/results.json`` and print as a table.

Usage:
  python benchmarks/run_benchmarks.py            # all configs
  python benchmarks/run_benchmarks.py 1 4        # selected configs
  python benchmarks/run_benchmarks.py --quick    # CI-sized inputs

Configs (BASELINE.json:6-12):
  1. single scan-pair NDT registration (one exhaustive matchScan)
  2. rolling local mapping: 200-scan corridor, rolling_depth=10
  3. full SLAM with loop closure + optimization + occupancy export (office)
  4. particle-filter localization, 5000 particles, KLD resampling
  5. multi-host district map: 50k keyframes, constraint-sharded LM/PCG solve
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "results.json")


def _now_steady(fn, warmup=2, reps=5):
    """Median wall time of fn() after warmup calls."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _device_name():
    import jax
    d = jax.devices()[0]
    return f"{d.platform}:{d.device_kind} x{jax.device_count()}"


# ---------------------------------------------------------------------------
def bench_config1(quick: bool) -> dict:
    """Single scan-pair NDT registration (config 1)."""
    import jax
    import jax.numpy as jnp

    from ndt_2d_tpu.config import ScanMatcherConfig
    from ndt_2d_tpu.matching import matcher
    from ndt_2d_tpu.utils import sim

    cfg = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    world = sim.make_box_world(10.0, 8.0)
    rng = np.random.default_rng(0)
    pose_a = np.asarray([5.0, 4.0, 0.1], np.float32)
    true_offset = np.asarray([0.03, -0.02, 0.012], np.float32)

    # A single-scan NDT needs dense beams: cells score only at >= 5 points
    # (ndt_model.cpp:105-116), and 360 beams over a 36 m perimeter leave
    # most 0.25 m cells below that.
    msg = sim.scan_at_pose(world, pose_a, n_beams=1440, range_max=15.0,
                           noise=0.005, rng=rng)
    pts_a, mask_a = sim.project_scan(msg, 2048)
    msg = sim.scan_at_pose(world, pose_a + true_offset, n_beams=1440,
                           range_max=15.0, noise=0.005, rng=rng)
    pts_b, mask_b = sim.project_scan(msg, 2048)

    grid = matcher.build_window_ndt(
        cfg, jnp.asarray(pose_a[None]), jnp.asarray(pts_a[None]),
        jnp.asarray(mask_a[None]), jnp.ones(1, bool), jnp.float32(15.0))
    jax.block_until_ready(grid)

    jb, jm = jnp.asarray(pts_b), jnp.asarray(mask_b)
    nb = jnp.int32(int(mask_b.sum()))
    guess = jnp.asarray(pose_a, jnp.float32)  # start without the offset

    def run():
        r = matcher.match_scan(cfg, grid, jb, jm, nb, guess,
                               jnp.float32(15.0))
        jax.block_until_ready(r)
        return r

    res = run()
    corr = np.asarray(res.correction)
    err = corr - true_offset

    # Device time via a fori_loop chain of K distinct matches in one jit
    # (per-dispatch launch overhead would dominate the match otherwise).
    K = 8 if quick else 64
    offsets = jnp.asarray(
        0.0005 * np.arange(K)[:, None] * np.ones(3, np.float32), jnp.float32)

    @jax.jit
    def chain(p0):
        def body(i, acc):
            r = matcher.match_scan(cfg, grid, jb, jm, nb, p0 + offsets[i],
                                   jnp.float32(15.0))
            return acc + r.score
        return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))

    jax.block_until_ready(chain(guess))
    t = _now_steady(lambda: jax.block_until_ready(chain(guess)),
                    warmup=0, reps=3) / K
    return {
        "config": 1,
        "name": "scan_pair_registration",
        "recovered_offset": [round(float(v), 4) for v in corr],
        "true_offset": [round(float(v), 4) for v in true_offset],
        "registration_err_m": round(float(np.hypot(err[0], err[1])), 4),
        "registration_err_rad": round(float(abs(err[2])), 4),
        "match_ms": round(t * 1e3, 3),
        "candidates_per_sec": round(cfg.num_candidates / t),
    }


# ---------------------------------------------------------------------------
def _mapper_config(grid_cells=192, **kw):
    from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig
    mcfg = ScanMatcherConfig(grid_cells_x=grid_cells, grid_cells_y=grid_cells)
    return MapperConfig(local_scan_matcher=mcfg, global_scan_matcher=mcfg,
                        max_points_per_scan=512, **kw)


def bench_config2(quick: bool, high_accuracy: bool = False) -> dict:
    """Rolling local mapping: 200-scan corridor, no loop closure (config 2).

    high_accuracy=True (config 8) turns on the beyond-parity accuracy stack:
    Biber 4-overlapping-grids scoring + Newton sub-lattice polish.
    """
    from ndt_2d_tpu.io import bag as bag_mod
    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.utils import metrics

    import dataclasses as dc

    n = 60 if quick else 200
    bag = bag_mod.record_synthetic("corridor", n, n_beams=600, seed=0)
    cfg = _mapper_config(loop_closure_every=10**9)
    if high_accuracy:
        cfg = dc.replace(
            cfg,
            local_scan_matcher=dc.replace(cfg.local_scan_matcher,
                                          overlapping_grids=True,
                                          refine_iterations=10),
            global_scan_matcher=dc.replace(cfg.global_scan_matcher,
                                           overlapping_grids=True,
                                           refine_iterations=10))
    mapper = Mapper(cfg)

    est, used_truth, times = [], [], []
    for t, (msg, odom) in enumerate(bag):
        t0 = time.perf_counter()
        res = mapper.process_scan(msg, odom)
        times.append(time.perf_counter() - t0)
        if res.accepted:
            est.append(res.pose)
            used_truth.append(bag.truth[t])
    steady = np.asarray(times[3:])
    ate = metrics.ate_rmse(np.asarray(est), np.asarray(used_truth))
    ate_al = metrics.ate_rmse_aligned(np.asarray(est), np.asarray(used_truth))
    odom_ate = metrics.ate_rmse(bag.odom, bag.truth)
    odom_al = metrics.ate_rmse_aligned(bag.odom, bag.truth)

    # Pipelined arm (max_inflight=8): device-resident pose chain, no
    # per-scan host round trip.  Same bag, fresh mapper; the sync run above
    # already compiled/loaded every kernel, so this measures steady state.
    pmapper = Mapper(dc.replace(cfg, max_inflight=8))
    ptimes = []
    t_pipe0 = time.perf_counter()
    for t, (msg, odom) in enumerate(bag):
        t0 = time.perf_counter()
        res = pmapper.process_scan(msg, odom)
        if res.accepted:
            ptimes.append(time.perf_counter() - t0)
    pmapper.flush()
    pipe_wall = time.perf_counter() - t_pipe0
    pipe_ate = metrics.ate_rmse(pmapper.graph.poses[:len(used_truth)],
                                np.asarray(used_truth))
    pipe_median = float(np.median(np.asarray(ptimes[3:])))

    # Device-only fused step (window NDT build + score + 35k-candidate
    # match): chained inside one jit to exclude per-dispatch overhead.
    import jax
    import jax.numpy as jnp

    from ndt_2d_tpu.matching import matcher as matcher_mod
    w = mapper._sync_window()
    from ndt_2d_tpu.mapping import laser
    pts, pmask = laser.project_scan(bag[n - 1][0], mapper.range_max,
                                    np.zeros(3), False, np.zeros(3),
                                    mapper.config.max_points_per_scan)
    jpts, jmask = jnp.asarray(pts), jnp.asarray(pmask)
    jn = jnp.int32(int(pmask.sum()))
    pose0 = jnp.asarray(mapper.prev_robot_pose, jnp.float32)
    mcfg = mapper.config.local_scan_matcher
    K = 4 if quick else 32

    @jax.jit
    def chain(p0):
        def body(i, acc):
            unc, s, corr, cov = matcher_mod.match_scan_rolling(
                mcfg, w, jnp.float32(mapper.range_max), jpts, jmask, jn,
                p0 + 0.001 * i)
            return acc + s
        return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))

    jax.block_until_ready(chain(pose0))
    t0 = time.perf_counter()
    jax.block_until_ready(chain(pose0))
    t_dev = (time.perf_counter() - t0) / K
    return {
        "config": 8 if high_accuracy else 2,
        "name": ("rolling_mapping_corridor_high_accuracy" if high_accuracy
                 else "rolling_mapping_corridor"),
        "scans": n,
        "accepted": len(est),
        "ate_rmse_m": round(ate, 4),
        "ate_aligned_m": round(ate_al, 4),
        "odom_only_ate_m": round(odom_ate, 4),
        "odom_aligned_m": round(odom_al, 4),
        "scan_ms_median": round(float(np.median(steady)) * 1e3, 2),
        "scans_per_sec": round(1.0 / float(np.median(steady)), 2),
        "pipelined_scan_ms_median": round(pipe_median * 1e3, 2),
        "pipelined_scans_per_sec_wall": round(len(ptimes) / pipe_wall, 1),
        "pipelined_ate_rmse_m": round(pipe_ate, 4),
        "fused_step_device_ms": round(t_dev * 1e3, 3),
        "scans_per_sec_device": round(1.0 / t_dev, 1),
        "first_scan_ms": round(times[1] * 1e3, 1) if len(times) > 1 else None,
    }


# ---------------------------------------------------------------------------
def bench_config3(quick: bool, loop_search: str = "radius") -> dict:
    """Full SLAM: office loop with loop closure + optimization + occupancy
    export (config 3; config 6 = the same with descriptor loop search)."""
    import dataclasses as dc

    from ndt_2d_tpu.config import ScanMatcherConfig
    from ndt_2d_tpu.io import bag as bag_mod
    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.utils import metrics

    # Drift-y odometry (2.5 m ATE over the loop) + 0.3 m keyframe spacing:
    # the recipe validated by tests/test_mapper_e2e.py::TestLoopClosure.
    # Near-perfect odometry with 0.18 m spacing makes the rolling-window
    # EWMA gate stricter than any 2-scan candidate NDT can score, so no
    # closure would fire.  With real drift the benchmark exercises closure
    # + optimization, the point of config 3.
    n = 150 if quick else 2000
    bag = bag_mod.record_synthetic("office", n, n_beams=600, range_max=12.0,
                                   seed=1, odom_trans_noise=0.02,
                                   odom_rot_noise=0.004)
    global_mcfg = ScanMatcherConfig(
        ndt_resolution=0.35, search_linear_size=0.15,
        search_linear_resolution=0.01, search_angular_size=0.05,
        grid_cells_x=160, grid_cells_y=160)
    cfg = dc.replace(_mapper_config(), global_scan_matcher=global_mcfg,
                     global_search_size=4.0, optimization_node_limit=10,
                     loop_closure_every=20, loop_search=loop_search,
                     minimum_travel_distance=0.3)
    if loop_search == "descriptor":
        # The descriptor recipe (cli._RECIPES "office-descriptor"):
        # redescending loss on switchable edges (a
        # drift-agnostic wrong correspondence can pass the score gate),
        # gate 0.85 + region-3 windows + Newton-polished global matcher
        # (the recall/ATE-dominant combination), and best-accept + the
        # 1.5 m separation gate (the precision levers that keep the
        # wide-heading coarse lattice's false aliases out of the graph).
        from ndt_2d_tpu.config import SolverConfig
        cfg = dc.replace(
            cfg, solver=dc.replace(SolverConfig(),
                                   robust_loss="geman_mcclure"),
            loop_closure_gate_scale=0.85, loop_closure_region_size=3,
            loop_closure_accept="best", loop_closure_max_separation=1.5,
            loop_closure_solve_before_reanchor=True,
            # Far-alias pruning: one coarse confirmation per (query,
            # candidate) site pair per pass, similarity-ranked 16-row cap,
            # negative cache of clear far rejections (the pruned rows are
            # distant appearance aliases; benchmarks/loop_closure_pr.py
            # scenario round5prune A/Bs them).
            loop_closure_far_dedup=2.5,
            loop_closure_reject_cache_margin=0.10,
            loop_closure_max_far_rows=16,
            global_scan_matcher=dc.replace(global_mcfg,
                                           refine_iterations=8))
    import jax

    def run_session(session_cfg):
        """One full SLAM session; returns (metrics dict, mapper)."""
        mapper = Mapper(session_cfg)
        est_raw, used_truth, times = [], [], []
        t_all0 = time.perf_counter()
        for t, (msg, odom) in enumerate(bag):
            t0 = time.perf_counter()
            res = mapper.process_scan(msg, odom)
            if res.accepted:  # motion-gated scans cost microseconds; exclude
                times.append(time.perf_counter() - t0)
                est_raw.append(res.pose if res.pose is not None
                               else res.pose_future)
                used_truth.append(bag.truth[t])
        mapper.flush()
        mapper.loop_closure()
        wall = time.perf_counter() - t_all0
        est = [np.asarray(jax.device_get(p), np.float64) for p in est_raw]
        used_truth = np.asarray(used_truth)
        final = mapper.graph.poses[:len(used_truth)]
        # ate_online: poses as estimated at acceptance time (never
        # retroactively optimized) = the before-optimization trajectory;
        # ate_rmse_m: the final graph after loop closures + LM optimization.
        return {
            "accepted": len(est),
            "loop_closures": int(mapper.graph.constraint_switchable.sum()),
            "loop_closures_rejected": mapper.stats.loop_closures_rejected,
            "optimizations": mapper.stats.optimizations,
            "ate_online_m": round(
                metrics.ate_rmse(np.asarray(est), used_truth), 4),
            "ate_online_aligned_m": round(
                metrics.ate_rmse_aligned(np.asarray(est), used_truth), 4),
            "ate_rmse_m": round(metrics.ate_rmse(final, used_truth), 4),
            "ate_aligned_m": round(
                metrics.ate_rmse_aligned(final, used_truth), 4),
            "wall_s": round(wall, 2),
            "scans_per_sec_wall": round(n / wall, 2),
            # Steady-state per-scan wall time: the mean is dominated by the
            # first executions, which compile and load the programs.
            "scan_ms_median": round(
                float(np.median(np.asarray(times[3:]))) * 1e3, 2),
        }, mapper

    # Both arms run the same bag so the pipelined-vs-sync ATE comparison is
    # a first-class benchmark output.  Pipelined is the headline arm.
    sync_row, _ = run_session(cfg)
    pipe_row, mapper = run_session(dc.replace(cfg, max_inflight=8))
    grid = mapper.render_map()
    timing = mapper.stats.timer.summary()
    lc = timing.get("loop_closure", {})

    row = {
        "config": 3 if loop_search == "radius" else 6,
        "name": ("full_slam_office" if loop_search == "radius"
                 else "full_slam_office_descriptor"),
        "loop_search": loop_search,
        "scans_in": n,
        "odom_only_ate_m": round(metrics.ate_rmse(bag.odom, bag.truth), 4),
        # timer section "loop_closure" wraps one scan's candidate search +
        # batched confirmation (<=2 dispatches regardless of K candidates).
        "loop_closure_scan_ms_mean": round(lc.get("mean_ms", 0.0), 2),
        "occupied_cells": int((grid.data == 100).sum()),
        "timing": timing,
        "sync": sync_row,
    }
    row.update(pipe_row)  # headline numbers = pipelined arm
    return row


# ---------------------------------------------------------------------------
def bench_config4(quick: bool) -> dict:
    """Particle-filter localization: 5000 particles, KLD (config 4)."""
    import dataclasses as dc

    from ndt_2d_tpu.config import MapperConfig
    from ndt_2d_tpu.io import bag as bag_mod
    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.utils import metrics

    n_map, n_loc = (40, 30) if quick else (150, 150)
    max_particles = 1000 if quick else 5000
    bag = bag_mod.record_synthetic("box", n_map, n_beams=360, seed=2)
    mapper = Mapper(_mapper_config(loop_closure_every=10**9))
    for t, (msg, odom) in enumerate(bag):
        mapper.process_scan(msg, odom)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.npz")
        from ndt_2d_tpu.mapping.mapper import LOAD_FROM_FILE, SAVE_TO_FILE
        mapper.configure(SAVE_TO_FILE, path)

        pf_cfg = _mapper_config(use_particle_filter=True)
        pf_cfg = dc.replace(
            pf_cfg, particle_filter=dc.replace(
                MapperConfig().particle_filter,
                min_particles=max(100, max_particles // 10),
                max_particles=max_particles,
                odom_alpha1=0.05, odom_alpha2=0.05,
                odom_alpha3=0.05, odom_alpha4=0.05))
        loc = Mapper(pf_cfg, seed=3)
        loc.configure(LOAD_FROM_FILE, path)

    loc_bag = bag_mod.record_synthetic("box", n_loc, n_beams=360, seed=7,
                                       odom_trans_noise=0.01)
    rel_truth = metrics.relative_to_first(loc_bag.truth)
    loc.set_initial_pose(rel_truth[0], np.diag([0.04, 0.04, 0.01]),
                         loc_bag.truth[0])
    errs, times = [], []
    for t, (msg, odom) in enumerate(loc_bag):
        if t == 0:
            continue
        t0 = time.perf_counter()
        res = loc.process_scan(msg, odom)
        times.append(time.perf_counter() - t0)
        if res.accepted:
            errs.append(float(np.hypot(*(res.pose[:2] - rel_truth[t][:2]))))
    steady = float(np.median(np.asarray(times[2:])))
    beams = loc.config.global_scan_matcher.laser_max_beams

    # Pipelined arm: device-chained particle state + deferred statistics
    # (max_inflight=8); same log, fresh filter.
    ploc = Mapper(dc.replace(pf_cfg, max_inflight=8), seed=3)
    with tempfile.TemporaryDirectory() as d2:
        path2 = os.path.join(d2, "map.npz")
        mapper.configure(SAVE_TO_FILE, path2)
        ploc.configure(LOAD_FROM_FILE, path2)
    ploc.set_initial_pose(rel_truth[0], np.diag([0.04, 0.04, 0.01]),
                          loc_bag.truth[0])
    ptimes = []
    t_pipe0 = time.perf_counter()
    for t, (msg, odom) in enumerate(loc_bag):
        if t == 0:
            continue
        t0 = time.perf_counter()
        ploc.process_scan(msg, odom)
        ptimes.append(time.perf_counter() - t0)
    ploc.flush()
    pipe_wall = time.perf_counter() - t_pipe0
    pipe_err = float(np.hypot(*(ploc.prev_robot_pose[:2]
                                - rel_truth[n_loc - 1][:2])))
    pipe_median = float(np.median(np.asarray(ptimes[2:])))

    # Device-only PF step time: chain K sequential steps inside one jit
    # (states thread through lax.fori_loop; per-dispatch overhead excluded).
    import jax
    import jax.numpy as jnp

    from ndt_2d_tpu.filter import particle_filter as pf_mod
    f = loc.filter
    c = f.config
    matcher = loc.global_matcher
    from ndt_2d_tpu.mapping import laser
    pts, pmask = laser.project_scan(loc_bag[10][0], loc.range_max,
                                    np.zeros(3), False, np.zeros(3),
                                    loc.config.max_points_per_scan)
    K = 4 if quick else 32
    alphas = jnp.asarray([c.odom_alpha1, c.odom_alpha2, c.odom_alpha3,
                          c.odom_alpha4], jnp.float32)
    bins = jnp.asarray([c.kld_bin_x, c.kld_bin_y, c.kld_bin_theta],
                       jnp.float32)
    jpts, jmask = jnp.asarray(pts), jnp.asarray(pmask)
    jn = jnp.int32(int(pmask.sum()))
    ctrl = jnp.asarray([0.05, 0.0, 0.0], jnp.float32)

    @jax.jit
    def chain(key, particles, mask):
        def body(i, s):
            key, p, m = s
            key, k1, k2 = jax.random.split(key, 3)
            p, w, n, mean, cov = pf_mod.pf_step(
                k1, k2, p, m, ctrl, matcher.config, matcher.grid,
                jpts, jmask, jn, alphas, jnp.float32(c.kld_err),
                jnp.float32(c.kld_z), bins, c.min_particles,
                c.max_particles)
            return key, p, jnp.arange(c.max_particles) < n
        return jax.lax.fori_loop(0, K, body, (key, particles, mask))

    out = chain(jax.random.PRNGKey(0), f.particles, f.mask)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = chain(jax.random.PRNGKey(1), f.particles, f.mask)
    jax.block_until_ready(out)
    t_dev = (time.perf_counter() - t0) / K

    return {
        "config": 4,
        "name": "particle_filter_localization",
        "max_particles": max_particles,
        "scans": n_loc,
        "mean_pos_err_m": round(float(np.mean(errs)), 4),
        "final_pos_err_m": round(errs[-1], 4),
        "scan_ms_median": round(steady * 1e3, 2),
        "pipelined_scan_ms_median": round(pipe_median * 1e3, 2),
        "pipelined_updates_per_sec_wall": round(len(ptimes) / pipe_wall, 1),
        "pipelined_final_pos_err_m": round(pipe_err, 4),
        "pf_step_device_ms": round(t_dev * 1e3, 3),
        "particle_scores_per_sec": round(max_particles * beams / t_dev),
        "particle_scores_per_sec_dispatched": round(
            max_particles * beams / steady),
    }


# ---------------------------------------------------------------------------
def bench_config5(quick: bool) -> dict:
    """Multi-host district map: 50k keyframes, constraint-sharded distributed
    LM/PCG pose-graph solve over the device mesh (config 5)."""
    import jax
    import jax.numpy as jnp

    from ndt_2d_tpu.config import SolverConfig
    from ndt_2d_tpu.graph import solver as base
    from ndt_2d_tpu.parallel import mesh as mesh_mod
    from ndt_2d_tpu.parallel import solver as psolver

    n = 5_000 if quick else 50_000
    rng = np.random.default_rng(0)

    # Synthetic district: a serpentine survey over a grid with odometry
    # chain + periodic loop-closure constraints, then noise on the initial
    # poses.  Ground truth is exactly recoverable.
    side = int(np.sqrt(n))
    xs = np.arange(n) % side
    ys = np.arange(n) // side
    xs = np.where(ys % 2 == 0, xs, side - 1 - xs)  # serpentine
    truth = np.stack([xs.astype(np.float64) * 2.0, ys * 2.0,
                      rng.uniform(-0.3, 0.3, n)], -1)

    begin = np.arange(n - 1, dtype=np.int32)
    end = begin + 1
    # loop closures: column revisits between adjacent rows
    lc_end = np.arange(n - side, dtype=np.int32)
    lc_begin = lc_end + side
    keep = rng.random(len(lc_begin)) < (0.2 if quick else 0.1)
    begin = np.concatenate([begin, lc_begin[keep]])
    end = np.concatenate([end, lc_end[keep]])

    def rel(a, b):
        d = truth[b, :2] - truth[a, :2]
        c, s = np.cos(truth[a, 2]), np.sin(truth[a, 2])
        return np.stack([c * d[:, 0] + s * d[:, 1],
                         -s * d[:, 0] + c * d[:, 1],
                         truth[b, 2] - truth[a, 2]], -1)

    transform = rel(begin, end)
    info = np.tile(np.eye(3, dtype=np.float32) * 100.0, (len(begin), 1, 1))
    noisy = truth + rng.normal(0, [0.3, 0.3, 0.02], (n, 3))
    noisy[0] = truth[0]

    import jax as _jax
    mesh = mesh_mod.make_mesh(shape=(1, _jax.device_count()))  # all on batch
    n_shards = mesh.shape[mesh_mod.BATCH_AXIS]
    b, e, t_, i_, cm = psolver.pad_constraints(
        begin.astype(np.int32), end.astype(np.int32),
        transform.astype(np.float32), info, np.ones(len(begin), bool),
        n_shards)
    cfg = SolverConfig(max_iterations=30, cg_max_iterations=150)

    poses0 = jnp.asarray(noisy, jnp.float32)
    nm = jnp.ones(n, bool)

    def run():
        r = psolver.solve_multichip(cfg, mesh, poses0, b, e, t_, i_, cm, nm)
        jax.block_until_ready(r.poses)
        return r

    t0 = time.perf_counter()
    res = run()
    first = time.perf_counter() - t0
    t_solve = _now_steady(run, warmup=0, reps=1 if quick else 2)

    out = np.asarray(res.poses, np.float64)
    err = np.sqrt(np.mean(np.sum((out[:, :2] - truth[:, :2]) ** 2, -1)))
    err0 = np.sqrt(np.mean(np.sum((noisy[:, :2] - truth[:, :2]) ** 2, -1)))
    return {
        "config": 5,
        "name": "district_distributed_solve",
        "nodes": n,
        "constraints": int(len(begin)),
        "mesh": dict(zip(mesh.axis_names, (int(v) for v in mesh.devices.shape))),
        "initial_rmse_m": round(float(err0), 4),
        "final_rmse_m": round(float(err), 4),
        "iterations": int(res.iterations),
        "solve_s": round(t_solve, 3),
        "first_solve_s": round(first, 3),
        "constraints_per_sec": round(len(begin) * int(res.iterations)
                                     / t_solve),
    }


# ---------------------------------------------------------------------------
def bench_config7(quick: bool) -> dict:
    """Global relocalization: uniform particle cloud over map free space
    (no reference equivalent; Mapper.global_localize).  Measures whether the
    filter converges from zero prior and how fast the big-cloud PF steps run.
    """
    import dataclasses as dc

    from ndt_2d_tpu.config import MapperConfig
    from ndt_2d_tpu.mapping.mapper import (Mapper, LOAD_FROM_FILE,
                                           SAVE_TO_FILE)
    from ndt_2d_tpu.utils import metrics, sim

    # Symmetry-broken office (the bare office ring is 4-fold symmetric).
    world = np.concatenate([
        sim.make_office_world(16.0),
        np.asarray([[[1.0, 13.0], [3.0, 15.0]]]),
    ], axis=0)
    n = 16 if quick else 40
    max_particles = 6000 if quick else 20000
    truth = np.stack([np.linspace(2.0, 10.0, n),
                      np.full(n, 2.0), np.zeros(n)], axis=-1)
    mapper = Mapper(_mapper_config(loop_closure_every=10**9, max_range=14.0))
    for t in range(n):
        msg = sim.scan_at_pose(world, truth[t], n_beams=240, range_max=14.0,
                               noise=0.01, rng=np.random.default_rng(t))
        mapper.process_scan(msg, truth[t])

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.npz")
        mapper.configure(SAVE_TO_FILE, path)
        pf_cfg = _mapper_config(use_particle_filter=True, max_range=14.0)
        pf_cfg = dc.replace(
            pf_cfg, particle_filter=dc.replace(
                MapperConfig().particle_filter,
                min_particles=200, max_particles=max_particles,
                odom_alpha1=0.05, odom_alpha2=0.05,
                odom_alpha3=0.05, odom_alpha4=0.05))
        loc = Mapper(pf_cfg, seed=7)
        loc.configure(LOAD_FROM_FILE, path)
        ploc = Mapper(dc.replace(pf_cfg, max_inflight=8), seed=7)
        ploc.configure(LOAD_FROM_FILE, path)

    assert loc.global_localize(truth[0])
    initial_spread = float(loc.filter.get_covariance()[0, 0])

    rel_truth = metrics.relative_to_first(truth)
    odom = sim.drift_odometry(truth, 0.01, 0.003, seed=31)
    errs, times, converged_at = [], [], None
    for t in range(1, n):
        msg = sim.scan_at_pose(world, truth[t], n_beams=240, range_max=14.0,
                               noise=0.01, rng=np.random.default_rng(900 + t))
        t0 = time.perf_counter()
        res = loc.process_scan(msg, odom[t])
        times.append(time.perf_counter() - t0)
        if res.accepted:
            e = float(np.hypot(*(res.pose[:2] - rel_truth[t][:2])))
            errs.append(e)
            if converged_at is None and e < 0.5:
                converged_at = t

    # Pipelined arm (max_inflight=8): the big-cloud PF state chains on
    # device exactly like config 4's pipelined arm; per-scan convergence
    # tracking still works because each step's mean pose comes back as an
    # async future (ScanResult.pose_future) resolved after the run.
    import jax
    assert ploc.global_localize(truth[0])
    futures, ptimes = [], []
    t_pipe0 = time.perf_counter()
    for t in range(1, n):
        msg = sim.scan_at_pose(world, truth[t], n_beams=240, range_max=14.0,
                               noise=0.01, rng=np.random.default_rng(900 + t))
        t0 = time.perf_counter()
        res = ploc.process_scan(msg, odom[t])
        ptimes.append(time.perf_counter() - t0)
        futures.append(res.pose_future)
    ploc.flush()
    pipe_wall = time.perf_counter() - t_pipe0
    perrs, pconverged = [], None
    for t, fut in enumerate(futures, start=1):
        pose = np.asarray(jax.device_get(fut))
        e = float(np.hypot(*(pose[:2] - rel_truth[t][:2])))
        perrs.append(e)
        if pconverged is None and e < 0.5:
            pconverged = t

    return {
        "config": 7,
        "name": "global_relocalization",
        "max_particles": max_particles,
        "scans": n,
        "initial_spread_var_m2": round(initial_spread, 3),
        "converged_at_scan": converged_at,
        "final_pos_err_m": (round(float(np.mean(errs[-3:])), 4)
                            if errs else None),
        "scan_ms_median": (round(float(np.median(times[2:])) * 1e3, 2)
                           if len(times) > 2 else None),
        "pipelined_scan_ms_median": (round(
            float(np.median(np.asarray(ptimes[2:]))) * 1e3, 2)
            if len(ptimes) > 2 else None),
        "pipelined_wall_s": round(pipe_wall, 2),
        "pipelined_converged_at_scan": pconverged,
        "pipelined_final_pos_err_m": (round(float(np.mean(perrs[-3:])), 4)
                                      if perrs else None),
    }


def bench_config9(quick: bool) -> dict:
    """CARMEN-format dataset end-to-end: import datasets/simlab.clf.gz (the
    committed lab survey; see benchmarks/make_simlab.py for why it is
    generated — this build environment has no network egress to fetch the
    classic Intel/ACES logs), run full SLAM with loop closure on it, export
    the occupancy grid + viz PNG into benchmarks/.

    Ground truth comes from the separate simlab_truth.npz and is used ONLY
    for the ATE report; the SLAM pipeline sees just FLASER ranges + drifting
    odometry, exactly what a real CARMEN log provides.
    """
    import dataclasses as dc

    from ndt_2d_tpu.config import ScanMatcherConfig
    from ndt_2d_tpu.io import carmen
    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.utils import metrics

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log = os.path.join(root, "datasets", "simlab.clf.gz")
    bag = carmen.load_carmen(log, range_max=10.0)
    truth = np.load(os.path.join(root, "datasets", "simlab_truth.npz"))[
        "truth"]
    n = len(bag)
    if quick:
        n = min(n, 300)

    global_mcfg = ScanMatcherConfig(
        ndt_resolution=0.35, search_linear_size=0.15,
        search_linear_resolution=0.01, search_angular_size=0.05,
        grid_cells_x=160, grid_cells_y=160)
    from ndt_2d_tpu.config import SolverConfig
    cfg = dc.replace(_mapper_config(),
                     global_search_size=4.0, optimization_node_limit=10,
                     loop_closure_every=20, minimum_travel_distance=0.3,
                     max_range=10.0, max_inflight=8,
                     # The simlab recipe (cli._RECIPES "simlab"): region-3
                     # windows + Newton polish score well enough that the
                     # PARITY gate (1.0) keeps precision high — the
                     # loosened gate (0.85) over-accepts with the denser
                     # regions.  Redescending loss stays on.
                     loop_closure_gate_scale=1.0,
                     loop_closure_region_size=3,
                     # The dual-position radius search catches the
                     # reverse-direction revisits the barycenter
                     # convention misses (benchmarks/loop_closure_pr.py
                     # scenario round5simlab).
                     loop_search_positions="both",
                     global_scan_matcher=dc.replace(global_mcfg,
                                                    refine_iterations=8),
                     solver=dc.replace(SolverConfig(),
                                       robust_loss="geman_mcclure"))
    mapper = Mapper(cfg)

    import jax

    est_raw, used_truth, times = [], [], []
    t_all0 = time.perf_counter()
    for t in range(n):
        msg, odom = bag[t]
        t0 = time.perf_counter()
        res = mapper.process_scan(msg, odom)
        if res.accepted:
            times.append(time.perf_counter() - t0)
            est_raw.append(res.pose if res.pose is not None
                           else res.pose_future)
            used_truth.append(truth[t])
    mapper.flush()
    mapper.loop_closure()
    wall = time.perf_counter() - t_all0
    est = [np.asarray(jax.device_get(p), np.float64) for p in est_raw]
    grid = mapper.render_map()

    out_dir = os.path.dirname(os.path.abspath(__file__))
    if not quick:
        np.savez_compressed(os.path.join(out_dir, "simlab_grid.npz"),
                            data=grid.data, origin=grid.origin,
                            resolution=grid.resolution)
        try:
            from ndt_2d_tpu.utils import viz
            viz.save_graph_png(mapper.graph,
                               os.path.join(out_dir, "simlab_map.png"),
                               grid=grid)
        except Exception as e:  # pragma: no cover
            print(f"viz skipped: {e}", file=sys.stderr)

    final = mapper.graph.poses[:len(used_truth)]
    ut = np.asarray(used_truth)
    return {
        "config": 9,
        "name": "carmen_simlab_full_slam",
        "dataset": "datasets/simlab.clf.gz",
        "scans_in": n,
        "accepted": len(est),
        "loop_closures": int(mapper.graph.constraint_switchable.sum()),
        "loop_closures_rejected": mapper.stats.loop_closures_rejected,
        "optimizations": mapper.stats.optimizations,
        "ate_online_m": round(metrics.ate_rmse(np.asarray(est), ut), 4),
        "ate_rmse_m": round(metrics.ate_rmse(final, ut), 4),
        "ate_aligned_m": round(metrics.ate_rmse_aligned(final, ut), 4),
        "odom_only_ate_m": round(metrics.ate_rmse(bag.odom[:n], truth[:n]),
                                 4),
        "wall_s": round(wall, 2),
        "scan_ms_median": round(
            float(np.median(np.asarray(times[3:]))) * 1e3, 2),
        "occupied_cells": int((grid.data == 100).sum()),
        "timing": mapper.stats.timer.summary(),
    }


def bench_config10(quick: bool) -> dict:
    """End-to-end multichip SLAM through the real runtime (Mapper(mesh=...))
    on the 8-virtual-device CPU mesh; see benchmarks/mesh_slam_bench.py.

    Subprocess: the CPU platform must be forced before jax initializes,
    which is impossible once this process touched the GPU.
    """
    import subprocess
    cmd = [sys.executable,
           os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mesh_slam_bench.py")]
    if quick:
        cmd.append("--quick")
    env = dict(os.environ)
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=3600)
    if out.returncode != 0:
        raise RuntimeError(f"mesh_slam_bench failed:\n{out.stderr[-2000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


BENCHES = {1: bench_config1, 2: bench_config2, 3: bench_config3,
           4: bench_config4, 5: bench_config5,
           # extra (beyond the 5 driver configs): descriptor-mode full SLAM
           6: lambda quick: bench_config3(quick, loop_search="descriptor"),
           # extra: global relocalization from zero prior
           7: bench_config7,
           # extra: high-accuracy mapping (overlapping grids + Newton polish)
           8: lambda quick: bench_config2(quick, high_accuracy=True),
           # extra: CARMEN-format dataset end-to-end (committed simlab log)
           9: bench_config9,
           # extra: multichip SLAM through the real runtime (virtual mesh)
           10: bench_config10}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("configs", nargs="*", type=int,
                    default=None, help="config numbers (default: all)")
    ap.add_argument("--quick", action="store_true", help="CI-sized inputs")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (virtual 8-device mesh)")
    ap.add_argument("--out", default=RESULTS_PATH)
    args = ap.parse_args(argv)
    configs = args.configs or [1, 2, 3, 4, 5]

    if args.cpu:
        # jax.config still takes effect after jax was imported; the
        # JAX_PLATFORMS variable does not (see tests/conftest.py).
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")

    from ndt_2d_tpu.utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()

    device = _device_name()
    print(f"device: {device}", file=sys.stderr)
    # Traceability: every row carries a run id (UTC timestamp + git rev) so
    # a claim maps to specific rows.
    import subprocess
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
            timeout=10).stdout.strip() or "unknown"
    except Exception:
        rev = "unknown"
    run_id = f"{time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime())}@{rev}"
    results = []
    for c in configs:
        print(f"--- config {c} ---", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        r = BENCHES[c](args.quick)
        r["device"] = device
        r["quick"] = args.quick
        r["run_id"] = run_id
        r["bench_wall_s"] = round(time.perf_counter() - t0, 1)
        results.append(r)
        print(json.dumps(r), flush=True)

    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    existing.extend(results)
    with open(args.out, "w") as f:
        json.dump(existing, f, indent=1)
    print(f"appended {len(results)} results to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
