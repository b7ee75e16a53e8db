"""End-to-end SLAM / localization tests on simulated worlds.

The reference has no integration tests at all (SURVEY.md section 4); these
close the loop the way the BASELINE.json configs describe: corridor rolling
mapping, localization against a saved map, and save/load resume.
"""

import dataclasses

import numpy as np
import pytest

from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu.mapping.mapper import (Mapper, DISABLE_MAPPING,
                                       LOAD_FROM_FILE, SAVE_TO_FILE)
from ndt_2d_tpu.utils import metrics, sim

MCFG = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
CFG = MapperConfig(
    local_scan_matcher=MCFG, global_scan_matcher=MCFG,
    max_points_per_scan=512,
    loop_closure_every=10**9,  # off unless a test calls loop_closure()
)


def corridor_trajectory(n=40, step=0.18):
    """Straight drive down the corridor with a gentle weave."""
    xs = 2.0 + step * np.arange(n)
    ys = 1.5 + 0.2 * np.sin(np.linspace(0, 2 * np.pi, n))
    ths = np.zeros(n)
    ths[1:] = np.arctan2(np.diff(ys), np.diff(xs))
    return np.stack([xs, ys, ths], axis=-1)


def run_mapping(world, truth, odom, cfg=CFG, range_max=12.0, n_beams=240):
    mapper = Mapper(cfg)
    est, used_truth = [], []
    for t in range(len(truth)):
        msg = sim.scan_at_pose(world, truth[t], n_beams=n_beams,
                               range_max=range_max, noise=0.01,
                               rng=np.random.default_rng(t))
        res = mapper.process_scan(msg, odom[t])
        if res.accepted:
            est.append(res.pose)
            used_truth.append(truth[t])
    return mapper, np.asarray(est), np.asarray(used_truth)


class TestCorridorMapping:
    """Rolling-window odometry-corrected mapping (BASELINE config 2)."""

    def test_open_loop_ate(self):
        world = sim.make_corridor_world(40.0, 3.0)
        truth = corridor_trajectory(40)
        odom = sim.drift_odometry(truth, trans_noise=0.008, rot_noise=0.002,
                                  seed=5)
        mapper, est, used_truth = run_mapping(world, truth, odom)

        assert mapper.graph.num_scans >= 35
        # Odometry constraints: one per scan after the first.
        assert mapper.graph.num_constraints == mapper.graph.num_scans - 1

        ate = metrics.ate_rmse(est, used_truth)
        odom_ate = metrics.ate_rmse(odom, truth)
        assert ate < 0.08, f"ATE {ate} too large (odom-only {odom_ate})"

    def test_motion_gate_rejects_stationary(self):
        world = sim.make_corridor_world(40.0, 3.0)
        mapper = Mapper(CFG)
        pose = np.asarray([2.0, 1.5, 0.0])
        msg = sim.scan_at_pose(world, pose, n_beams=240, range_max=12.0)
        r1 = mapper.process_scan(msg, pose)
        assert r1.accepted  # first scan always lands
        r2 = mapper.process_scan(msg, pose + [0.01, 0.0, 0.0])
        assert not r2.accepted  # < minimum_travel_distance

    def test_session_stats_survive_loop_closure(self):
        """Regression: loop_closure() must not reset session statistics
        (the runtime reads mapper.stats.summary() after a final pass)."""
        world = sim.make_corridor_world(40.0, 3.0)
        truth = corridor_trajectory(15)
        odom = sim.drift_odometry(truth, 0.005, 0.002, seed=9)
        mapper, est, _ = run_mapping(world, truth, odom)
        processed = mapper.stats.scans_processed
        accepted = mapper.stats.scans_accepted
        assert accepted >= 10
        mapper.loop_closure()
        assert mapper.stats.scans_processed == processed
        assert mapper.stats.scans_accepted == accepted
        assert mapper.stats.timer.count["local_match"] >= accepted - 1

    def test_map_render(self):
        world = sim.make_box_world(8.0, 6.0)
        truth = np.stack([np.linspace(2.0, 5.0, 12),
                          np.full(12, 3.0), np.zeros(12)], axis=-1)
        odom = truth.copy()
        mapper, est, _ = run_mapping(world, truth, odom, range_max=12.0)
        grid = mapper.render_map()
        assert (grid.data == 100).sum() > 50      # walls seen
        assert (grid.data == 0).sum() > 500       # interior free
        assert not mapper.map_update_available    # consumed


class TestLocalization:
    def _build_map(self, tmp_path):
        world = sim.make_box_world(10.0, 8.0)
        truth = np.stack([np.linspace(3.0, 7.0, 14),
                          np.full(14, 4.0), np.zeros(14)], axis=-1)
        mapper, est, used = run_mapping(world, truth, truth.copy(),
                                        range_max=14.0)
        path = str(tmp_path / "map.npz")
        mapper.configure(SAVE_TO_FILE, path)
        return world, truth, path

    def test_scan_match_localization(self, tmp_path):
        world, truth, path = self._build_map(tmp_path)
        cfg = dataclasses.replace(CFG, enable_mapping=False)
        loc = Mapper(cfg)
        loc.configure(LOAD_FROM_FILE, path)
        assert loc.graph.num_scans == 14
        # Must localize first (loaded map, ndt_mapper.cpp:316-320).
        msg = sim.scan_at_pose(world, truth[0], n_beams=240, range_max=14.0)
        res = loc.process_scan(msg, truth[0])
        assert not res.accepted
        # The map frame equals the build run's map frame here (truth started
        # at the first scan), so the initial pose is just truth[0] - truth[0].
        map_pose0 = metrics.relative_to_first(truth)[0]
        loc.set_initial_pose(map_pose0, np.diag([0.05, 0.05, 0.02]), truth[0])
        # Track along the trajectory with noisy odometry.
        odom = sim.drift_odometry(truth, 0.01, 0.003, seed=9)
        errs = []
        rel_truth = metrics.relative_to_first(truth)
        for t in range(1, len(truth)):
            msg = sim.scan_at_pose(world, truth[t], n_beams=240,
                                   range_max=14.0, noise=0.01,
                                   rng=np.random.default_rng(100 + t))
            res = loc.process_scan(msg, odom[t])
            if res.accepted:
                errs.append(np.hypot(*(res.pose[:2] - rel_truth[t][:2])))
                # localization never adds scans
                assert loc.graph.num_scans == 14
        assert len(errs) > 5
        assert np.mean(errs) < 0.12

    def test_global_grid_autosizes_to_loaded_map(self):
        """Localization grows the static global NDT grid to fit the map.

        The reference sizes its grid dynamically from the scan bounding box
        (scan_matcher_ndt.cpp:52-67); with XLA static shapes the grid extent
        is a config, so a map wider than the configured extent must auto-grow
        it instead of failing the capacity check.
        """
        from ndt_2d_tpu.graph.pose_graph import Graph
        g = Graph(max_points_per_scan=8)
        pts = np.zeros((8, 2), np.float32)
        msk = np.ones(8, bool)
        # 60 m of corridor: needs 60/0.25 + 2*12/0.25 cells ≈ 337 > 160.
        for x in (0.0, 60.0):
            g.add_scan(np.asarray([x, 0.0, 0.0]), pts, msk)
        cfg = dataclasses.replace(CFG, enable_mapping=False, max_range=12.0)
        loc = Mapper(cfg, graph=g)
        loc._ensure_matchers(12.0)
        gx = loc.global_matcher.config.grid_cells_x
        gy = loc.global_matcher.config.grid_cells_y
        assert gx >= (60 + 24) / 0.25 and gx % 32 == 0
        assert gy == 160  # never shrinks below the configured extent
        # Mapping mode keeps the configured size (rolling windows are small).
        m = Mapper(CFG)
        m._ensure_matchers(12.0)
        assert m.global_matcher.config.grid_cells_x == 160

    def test_save_load_roundtrip(self, tmp_path):
        world, truth, path = self._build_map(tmp_path)
        from ndt_2d_tpu.io import serialization
        g = serialization.load_graph(path, CFG.max_points_per_scan)
        assert g.num_scans == 14
        assert g.num_constraints == 13
        m2 = Mapper(CFG, graph=g)
        # Loaded map requires re-localization before scans are accepted
        # (ndt_mapper.cpp:114, :316-320).
        msg = sim.scan_at_pose(world, truth[0], n_beams=240, range_max=14.0)
        assert not m2.process_scan(msg, truth[0]).accepted


class TestLoopClosure:
    def test_office_loop(self):
        """Drive a loop around the office ring; loop closure should fire and
        optimization should pull the trajectory back toward truth."""
        world = sim.make_office_world(16.0)
        # Square ring loop through the corridor (between outer wall and
        # inner block), twice around the first corner to revisit.
        waypoints = [(2.0, 2.0, 0.0), (14.0, 2.0, np.pi / 2),
                     (14.0, 14.0, np.pi), (2.0, 14.0, -np.pi / 2),
                     (2.0, 2.6, 0.0), (8.0, 2.6, 0.0)]
        traj = []
        for i in range(len(waypoints) - 1):
            a = np.asarray(waypoints[i], float)
            b = np.asarray(waypoints[i + 1], float)
            seg_len = np.hypot(b[0] - a[0], b[1] - a[1])
            steps = max(int(seg_len / 0.35), 1)
            heading = np.arctan2(b[1] - a[1], b[0] - a[0])
            for s in range(steps):
                f = s / steps
                traj.append([a[0] + f * (b[0] - a[0]),
                             a[1] + f * (b[1] - a[1]), heading])
        truth = np.asarray(traj)
        odom = sim.drift_odometry(truth, trans_noise=0.006, rot_noise=0.002,
                                  seed=11)
        # The global matcher needs a coarser NDT (so 2-scan candidate regions
        # still produce scoreable >=5-point cells) and a wider search window
        # than the local matcher — exactly how the reference's per-instance
        # namespaced parameters are meant to be used (README.md:87-108).
        global_mcfg = ScanMatcherConfig(
            ndt_resolution=0.35, search_linear_size=0.15,
            search_linear_resolution=0.01, search_angular_size=0.05,
            grid_cells_x=160, grid_cells_y=160)
        cfg = dataclasses.replace(
            CFG, global_scan_matcher=global_mcfg,
            global_search_size=4.0,  # (2m radius; default 0.45m is tiny)
            optimization_node_limit=10)
        mapper, est, used_truth = run_mapping(world, truth, odom, cfg=cfg,
                                              range_max=12.0, n_beams=600)
        n_before = mapper.graph.num_constraints
        mapper.loop_closure()
        closures = int(mapper.graph.constraint_switchable.sum())
        assert closures >= 1, "expected at least one loop closure"
        assert mapper.graph.num_constraints > n_before
        ate = metrics.ate_rmse(mapper.graph.poses[:len(used_truth)],
                               used_truth)
        assert ate < 0.25

    def test_optimization_reanchors_dead_reckoning(self):
        """Regression (round 3): after a mid-session optimization (or a
        loop closure that moves the newest keyframe) the dead-reckoning
        chain must re-anchor on the corrected graph pose.  Leaving it stale
        strands the next start pose outside the +-search_linear_size match
        window of the (rebuilt-from-optimized-poses) rolling window, and
        every later odometry constraint inherits the offset — measured on
        the config-3 office benchmark as final ATE *worse* than online.
        The reference has this defect (loopClosureThread never touches
        prev_robot_pose_, src/ndt_mapper.cpp:569-685); we fix it."""
        world, truth, odom = _office_loop_inputs(trans_noise=0.02,
                                                 rot_noise=0.004)
        global_mcfg = ScanMatcherConfig(
            ndt_resolution=0.35, search_linear_size=0.15,
            search_linear_resolution=0.01, search_angular_size=0.05,
            grid_cells_x=160, grid_cells_y=160)
        cfg = dataclasses.replace(
            CFG, global_scan_matcher=global_mcfg, global_search_size=4.0,
            optimization_node_limit=10, loop_closure_every=15)
        mapper = Mapper(cfg)
        est, used_truth = [], []
        for t in range(len(truth)):
            msg = sim.scan_at_pose(world, truth[t], n_beams=600,
                                   range_max=12.0, noise=0.01,
                                   rng=np.random.default_rng(t))
            res = mapper.process_scan(msg, odom[t])
            if res.accepted:
                est.append(res.pose)
                used_truth.append(truth[t])
                # Invariant: the dead-reckoning anchor always equals the
                # newest graph pose, even right after a loop-closure pass
                # inside process_scan moved/optimized it.
                np.testing.assert_allclose(
                    mapper.prev_robot_pose,
                    mapper.graph.poses[mapper.graph.num_scans - 1])
        mapper.loop_closure()
        assert mapper.stats.optimizations >= 1, \
            "scenario must exercise a mid-session optimization"
        online = metrics.ate_rmse(np.asarray(est), np.asarray(used_truth))
        final = metrics.ate_rmse(mapper.graph.poses[:len(used_truth)],
                                 np.asarray(used_truth))
        # Optimization must not degrade the trajectory it was given
        # (the reference's solver keeps old poses on failure for the same
        # reason, ceres_solver.cpp:98-101).
        assert final <= online * 1.10 + 1e-6, (
            f"optimization degraded ATE: online {online} -> final {final}")


def _office_loop_inputs(trans_noise=0.006, rot_noise=0.002):
    """The revisiting office-ring scenario from TestLoopClosure, shared by
    the batched-vs-sequential equivalence tests."""
    world = sim.make_office_world(16.0)
    waypoints = [(2.0, 2.0, 0.0), (14.0, 2.0, np.pi / 2),
                 (14.0, 14.0, np.pi), (2.0, 14.0, -np.pi / 2),
                 (2.0, 2.6, 0.0), (8.0, 2.6, 0.0)]
    traj = []
    for i in range(len(waypoints) - 1):
        a = np.asarray(waypoints[i], float)
        b = np.asarray(waypoints[i + 1], float)
        seg_len = np.hypot(b[0] - a[0], b[1] - a[1])
        steps = max(int(seg_len / 0.35), 1)
        heading = np.arctan2(b[1] - a[1], b[0] - a[0])
        for s in range(steps):
            f = s / steps
            traj.append([a[0] + f * (b[0] - a[0]),
                         a[1] + f * (b[1] - a[1]), heading])
    truth = np.asarray(traj)
    odom = sim.drift_odometry(truth, trans_noise=trans_noise,
                              rot_noise=rot_noise, seed=11)
    return world, truth, odom


class TestBatchedLoopClosureEquivalence:
    """The batched confirmation (one vmapped dispatch for all candidates,
    matching.matcher.match_scan_batch) must make the same decisions as the
    reference-shaped per-candidate loop."""

    @pytest.mark.parametrize("loop_search", ["radius", "descriptor", "both"])
    def test_same_closures_and_poses(self, loop_search):
        world, truth, odom = _office_loop_inputs()
        global_mcfg = ScanMatcherConfig(
            ndt_resolution=0.35, search_linear_size=0.15,
            search_linear_resolution=0.01, search_angular_size=0.05,
            grid_cells_x=160, grid_cells_y=160)
        # optimization_node_limit=10**9 keeps the LM optimizer out of this
        # comparison: it amplifies f32-round-off start differences
        # chaotically, and its equivalence isn't the property under test
        # (TestLoopClosure covers the full closure+optimize flow).
        # region_size=3: the 2-slot parity region leaves this scenario's
        # best closure scores within ~0.01 of the gate (a lattice-phase
        # coin flip); the 3-scan region builds a denser confirmation NDT
        # whose acceptances clear the gate robustly, which the equivalence
        # assertion below needs (>= 1 acceptance on both arms).
        base = dataclasses.replace(
            CFG, global_scan_matcher=global_mcfg,
            global_search_size=4.0, optimization_node_limit=10**9,
            loop_search=loop_search, descriptor_min_similarity=0.97,
            loop_closure_region_size=3)

        results = {}
        for batched in (False, True):
            cfg = dataclasses.replace(base, batch_loop_closure=batched)
            mapper, est, used_truth = run_mapping(world, truth, odom,
                                                  cfg=cfg, range_max=12.0,
                                                  n_beams=600)
            mapper.loop_closure()
            g = mapper.graph
            results[batched] = dict(
                begin=g.constraint_begin.copy(), end=g.constraint_end.copy(),
                switchable=g.constraint_switchable.copy(),
                poses=g.poses.copy(),
                accepted=mapper.stats.loop_closures_accepted,
                rejected=mapper.stats.loop_closures_rejected)

        seq, bat = results[False], results[True]
        assert seq["accepted"] >= 1, "scenario must fire at least one closure"
        assert bat["accepted"] == seq["accepted"]
        assert bat["rejected"] == seq["rejected"]
        np.testing.assert_array_equal(bat["begin"], seq["begin"])
        np.testing.assert_array_equal(bat["end"], seq["end"])
        np.testing.assert_array_equal(bat["switchable"], seq["switchable"])
        # Poses agree to float32 round-off (the fused coarse-to-fine path
        # adds the coarse correction on device in f32; the sequential path
        # adds it on host in f64).
        np.testing.assert_allclose(bat["poses"], seq["poses"], atol=1e-5)


class TestCandidateRegion:
    """config.loop_closure_region_size: the S-slot confirmation window."""

    def _mapper_with_line_graph(self, region):
        cfg = dataclasses.replace(CFG,
                                  loop_closure_region_size=region)
        mapper = Mapper(cfg)
        rng = np.random.default_rng(0)
        pts = rng.normal(0, 1, (30, CFG.max_points_per_scan, 2)).astype(
            np.float32)
        msk = np.ones((30, CFG.max_points_per_scan), bool)
        for t in range(30):
            mapper.graph.add_scan(np.asarray([0.5 * t, 0.0, 0.0]), pts[t],
                                  msk[t])
        return mapper, pts

    def test_region_2_is_reference_parity(self):
        mapper, pts = self._mapper_with_line_graph(2)
        poses, p, pm, wm = mapper._candidate_window(5, rolling=20)
        # {i-1, i}: exclusive end bound (ndt_mapper.cpp:627-631).
        assert wm.tolist() == [True, True]
        np.testing.assert_allclose(poses[:, 0], [2.0, 2.5])
        np.testing.assert_array_equal(p[0], pts[4])
        np.testing.assert_array_equal(p[1], pts[5])

    def test_region_3_takes_one_either_side(self):
        mapper, pts = self._mapper_with_line_graph(3)
        poses, p, pm, wm = mapper._candidate_window(5, rolling=20)
        assert wm.tolist() == [True, True, True]
        np.testing.assert_allclose(poses[:, 0], [2.0, 2.5, 3.0])
        np.testing.assert_array_equal(p[2], pts[6])

    def test_region_3_clips_at_rolling_window(self):
        """Scan i+1 must never leak from the query's rolling window."""
        mapper, pts = self._mapper_with_line_graph(3)
        poses, p, pm, wm = mapper._candidate_window(5, rolling=6)
        assert wm.tolist() == [True, True, False]
        np.testing.assert_allclose(poses[:2, 0], [2.0, 2.5])

    def test_region_3_clips_at_zero(self):
        mapper, pts = self._mapper_with_line_graph(3)
        poses, p, pm, wm = mapper._candidate_window(0, rolling=20)
        assert wm.tolist() == [True, True, False]
        np.testing.assert_array_equal(p[0], pts[0])
        np.testing.assert_array_equal(p[1], pts[1])

    def test_office_loop_region3(self):
        """The wider region still closes the office loop end-to-end."""
        world, truth, odom = _office_loop_inputs()
        global_mcfg = ScanMatcherConfig(
            ndt_resolution=0.35, search_linear_size=0.15,
            search_linear_resolution=0.01, search_angular_size=0.05,
            grid_cells_x=160, grid_cells_y=160)
        cfg = dataclasses.replace(
            CFG, global_scan_matcher=global_mcfg, global_search_size=4.0,
            optimization_node_limit=10, loop_closure_every=15,
            loop_closure_region_size=3, loop_closure_gate_scale=0.85)
        mapper, est, used_truth = run_mapping(world, truth, odom, cfg=cfg,
                                              range_max=12.0, n_beams=600)
        mapper.loop_closure()
        assert mapper.stats.loop_closures_accepted >= 1
        ate = metrics.ate_rmse(mapper.graph.poses[:len(used_truth)],
                               used_truth)
        assert ate < 0.3


class TestSeparationGate:
    """config.loop_closure_max_separation: the corrected query pose must
    land within the bound of the candidate's pose."""

    def _mapper(self, max_sep):
        cfg = dataclasses.replace(CFG,
                                  loop_closure_max_separation=max_sep)
        mapper = Mapper(cfg)
        pts = np.zeros((CFG.max_points_per_scan, 2), np.float32)
        msk = np.ones(CFG.max_points_per_scan, bool)
        mapper.graph.add_scan(np.asarray([0.0, 0.0, 0.0]), pts, msk)
        for k in range(12):
            mapper.graph.add_scan(np.asarray([0.2 * k, 2.0, 0.0]), pts, msk)
        mapper.typical_matcher_response = -0.5
        return mapper

    def test_far_landing_rejected_near_accepted(self):
        mapper = self._mapper(1.5)
        cov = np.eye(3) * 1e-4
        # Candidate 0 at origin; query 12's matched pose lands 2.0 m away.
        start = np.asarray([2.0, 0.0, 0.0])
        assert not mapper._apply_gate(12, 0, start, -0.9, np.zeros(3), cov)
        # Same score, landing 0.5 m away: accepted.
        start = np.asarray([0.5, 0.0, 0.0])
        assert mapper._apply_gate(12, 0, start, -0.9, np.zeros(3), cov)

    def test_inf_is_reference_parity(self):
        mapper = self._mapper(float("inf"))
        cov = np.eye(3) * 1e-4
        start = np.asarray([5.0, 0.0, 0.0])
        assert mapper._apply_gate(12, 0, start, -0.9, np.zeros(3), cov)

    def test_correction_counts_toward_separation(self):
        mapper = self._mapper(1.5)
        cov = np.eye(3) * 1e-4
        # Start within bound but the correction pushes the landing out.
        start = np.asarray([1.0, 0.0, 0.0])
        assert not mapper._apply_gate(12, 0, start, -0.9,
                                      np.asarray([1.0, 0.0, 0.0]), cov)


class TestBestAcceptPolicy:
    """config.loop_closure_accept='best': at most one closure per query per
    pass, chosen by score; batched and sequential paths agree."""

    def test_best_mode_one_per_query_and_path_equivalence(self):
        world, truth, odom = _office_loop_inputs()
        global_mcfg = ScanMatcherConfig(
            ndt_resolution=0.35, search_linear_size=0.15,
            search_linear_resolution=0.01, search_angular_size=0.05,
            grid_cells_x=160, grid_cells_y=160)
        base = dataclasses.replace(
            CFG, global_scan_matcher=global_mcfg, global_search_size=4.0,
            optimization_node_limit=10**9, loop_closure_region_size=3,
            loop_closure_gate_scale=0.85, loop_closure_accept="best")

        results = {}
        for batched in (False, True):
            cfg = dataclasses.replace(base, batch_loop_closure=batched)
            mapper, est, used_truth = run_mapping(world, truth, odom,
                                                  cfg=cfg, range_max=12.0,
                                                  n_beams=600)
            mapper.loop_closure()
            g = mapper.graph
            results[batched] = dict(
                begin=g.constraint_begin.copy(), end=g.constraint_end.copy(),
                switchable=g.constraint_switchable.copy(),
                accepted=mapper.stats.loop_closures_accepted,
                decisions=list(mapper.lc_log["decisions"]))

        seq, bat = results[False], results[True]
        assert bat["accepted"] == seq["accepted"] >= 1
        np.testing.assert_array_equal(bat["begin"], seq["begin"])
        np.testing.assert_array_equal(bat["end"], seq["end"])
        # At most one accepted closure per (query, pass): the accepted
        # (query -> candidate) pairs must have unique queries within each
        # pass; across the whole session a query may close at most once per
        # pass, so duplicates of (idx, i) must not appear at all.
        accepted_pairs = [(idx, i) for idx, i, _, _, ok in bat["decisions"]
                          if ok]
        assert len(accepted_pairs) == len(set(accepted_pairs))


class TestPipelinedLoopClosure:
    """config.pipeline_loop_closure: the whole-pass pipelined confirmation
    (dispatch all pending scans, then drain; mapper._loop_closure_pass_
    pipelined) must make bitwise-identical decisions to the per-scan batched
    path, including the restart-on-acceptance case."""

    @pytest.mark.parametrize("loop_search", ["radius", "descriptor"])
    def test_same_closures_and_poses(self, loop_search):
        world, truth, odom = _office_loop_inputs()
        global_mcfg = ScanMatcherConfig(
            ndt_resolution=0.35, search_linear_size=0.15,
            search_linear_resolution=0.01, search_angular_size=0.05,
            grid_cells_x=160, grid_cells_y=160)
        base = dataclasses.replace(
            CFG, global_scan_matcher=global_mcfg,
            global_search_size=4.0, optimization_node_limit=10**9,
            loop_search=loop_search, descriptor_min_similarity=0.97,
            batch_loop_closure=True, loop_closure_region_size=3)

        results = {}
        for pipelined in (False, True):
            cfg = dataclasses.replace(base,
                                      pipeline_loop_closure=pipelined)
            mapper, est, used_truth = run_mapping(world, truth, odom,
                                                  cfg=cfg, range_max=12.0,
                                                  n_beams=600)
            mapper.loop_closure()
            g = mapper.graph
            results[pipelined] = dict(
                begin=g.constraint_begin.copy(), end=g.constraint_end.copy(),
                switchable=g.constraint_switchable.copy(),
                poses=g.poses.copy(),
                accepted=mapper.stats.loop_closures_accepted,
                rejected=mapper.stats.loop_closures_rejected)

        seq, pipe = results[False], results[True]
        # The restart-on-acceptance branch must actually be exercised.
        assert seq["accepted"] >= 1, "scenario must fire at least one closure"
        assert pipe["accepted"] == seq["accepted"]
        assert pipe["rejected"] == seq["rejected"]
        np.testing.assert_array_equal(pipe["begin"], seq["begin"])
        np.testing.assert_array_equal(pipe["end"], seq["end"])
        np.testing.assert_array_equal(pipe["switchable"], seq["switchable"])
        # Same jitted dispatches in the same order => bitwise-equal poses.
        np.testing.assert_array_equal(pipe["poses"], seq["poses"])


class TestPipelinedMapping:
    """config.max_inflight > 0: device-resident pose chain + async drains
    (matcher.mapping_step_async) must reproduce the synchronous path."""

    def test_map_to_odom_undrained_consistent(self):
        """map_to_odom(drain=False) mid-pipeline must pair pose estimates
        consistently (review finding r2: prev_robot@t-k composed with
        odom@t was corrupted by the in-flight window's motion)."""
        world = sim.make_corridor_world(40.0, 3.0)
        truth = corridor_trajectory(30)
        odom = sim.drift_odometry(truth, trans_noise=0.005, rot_noise=0.001,
                                  seed=7)
        cfg = dataclasses.replace(CFG, max_inflight=8)
        mapper = Mapper(cfg)
        for t in range(len(truth)):
            msg = sim.scan_at_pose(world, truth[t], n_beams=240,
                                   range_max=12.0, noise=0.01,
                                   rng=np.random.default_rng(t))
            mapper.process_scan(msg, odom[t])
        assert mapper._pending  # genuinely mid-pipeline
        tf_fast = mapper.map_to_odom(drain=False)
        tf_exact = mapper.map_to_odom()  # drains
        # The undrained estimate differs only by the <= max_inflight scans
        # of unapplied match corrections (cm scale), NOT by the robot's
        # travel over the window (~0.5 m/scan here).
        assert float(np.hypot(*(tf_fast[:2] - tf_exact[:2]))) < 0.25, (
            tf_fast, tf_exact)

    def test_matches_synchronous_path(self):
        world = sim.make_corridor_world(40.0, 3.0)
        truth = corridor_trajectory(40)
        odom = sim.drift_odometry(truth, trans_noise=0.008, rot_noise=0.002,
                                  seed=5)
        out = {}
        for inflight in (0, 8):
            cfg = dataclasses.replace(CFG, max_inflight=inflight)
            mapper = Mapper(cfg)
            for t in range(len(truth)):
                msg = sim.scan_at_pose(world, truth[t], n_beams=240,
                                       range_max=12.0, noise=0.01,
                                       rng=np.random.default_rng(t))
                res = mapper.process_scan(msg, odom[t])
                if inflight and res.accepted and res.scan_id > 0:
                    assert res.pose is None  # deferred
            mapper.flush()
            g = mapper.graph
            out[inflight] = dict(
                poses=g.poses.copy(), n=g.num_scans, c=g.num_constraints,
                ewma=mapper.typical_matcher_response,
                info=g.constraint_information.copy())
        sync, pipe = out[0], out[8]
        assert pipe["n"] == sync["n"]
        assert pipe["c"] == sync["c"]
        # Device f32 dead-reckoning vs host f64 can flip a lattice cell at
        # quantization boundaries; divergence is bounded by the lattice
        # resolution per scan and re-corrected by the next match.
        np.testing.assert_allclose(pipe["poses"], sync["poses"], atol=0.03)
        assert abs(pipe["ewma"] - sync["ewma"]) < 0.02

    def test_localization_matches_synchronous(self, tmp_path):
        """Pipelined scan-match localization (localization_step_async) vs
        the synchronous branch on the same bag and map."""
        world = sim.make_corridor_world(40.0, 3.0)
        truth = corridor_trajectory(30)
        mapper, _, _ = run_mapping(world, truth, truth.copy())
        path = str(tmp_path / "map.npz")
        mapper.configure(SAVE_TO_FILE, path)

        odom = sim.drift_odometry(truth, trans_noise=0.006, rot_noise=0.002,
                                  seed=9)
        rel_truth = metrics.relative_to_first(truth)  # map frame = scan 0
        out = {}
        for inflight in (0, 8):
            cfg = dataclasses.replace(CFG, enable_mapping=False,
                                      max_inflight=inflight)
            loc = Mapper(cfg)
            loc.configure(LOAD_FROM_FILE, path)
            loc.set_initial_pose(rel_truth[0], np.diag([0.01, 0.01, 0.005]),
                                 odom[0])
            for t in range(1, len(truth)):
                msg = sim.scan_at_pose(world, truth[t], n_beams=240,
                                       range_max=12.0, noise=0.01,
                                       rng=np.random.default_rng(500 + t))
                loc.process_scan(msg, odom[t])
            loc.flush()
            out[inflight] = loc.prev_robot_pose.copy()
        np.testing.assert_allclose(out[8], out[0], atol=0.03)
        np.testing.assert_allclose(out[0][:2], rel_truth[-1][:2], atol=0.3)

    def test_particle_filter_pipelined(self, tmp_path):
        """Pipelined PF localization: device-chained particle state +
        deferred statistics must track like the synchronous filter."""
        world = sim.make_corridor_world(40.0, 3.0)
        truth = corridor_trajectory(24)
        mapper, _, _ = run_mapping(world, truth, truth.copy())
        path = str(tmp_path / "map.npz")
        mapper.configure(SAVE_TO_FILE, path)

        odom = sim.drift_odometry(truth, trans_noise=0.004, rot_noise=0.001,
                                  seed=3)
        rel_truth = metrics.relative_to_first(truth)  # map frame = scan 0
        out = {}
        for inflight in (0, 4):
            cfg = dataclasses.replace(
                CFG, use_particle_filter=True, max_inflight=inflight,
                particle_filter=dataclasses.replace(
                    MapperConfig().particle_filter,
                    min_particles=100, max_particles=400,
                    odom_alpha1=0.05, odom_alpha2=0.05,
                    odom_alpha3=0.05, odom_alpha4=0.05))
            loc = Mapper(cfg, seed=11)
            loc.configure(LOAD_FROM_FILE, path)
            loc.set_initial_pose(rel_truth[0], np.diag([0.02, 0.02, 0.01]),
                                 odom[0])
            for t in range(1, len(truth)):
                msg = sim.scan_at_pose(world, truth[t], n_beams=240,
                                       range_max=12.0, noise=0.01,
                                       rng=np.random.default_rng(700 + t))
                res = loc.process_scan(msg, odom[t])
                if inflight:
                    assert res.accepted and res.pose is None
            loc.flush()
            out[inflight] = loc.prev_robot_pose.copy()
            assert np.hypot(*(loc.prev_robot_pose[:2]
                              - rel_truth[-1][:2])) < 0.4
        # Same seed + same key-split sequence; the control inputs agree only
        # to f64->f32 rounding, and one flipped KLD resample draw diverges
        # the clouds stochastically — so compare as estimators (both track),
        # not bitwise.
        np.testing.assert_allclose(out[4], out[0], atol=0.1)

    def test_consumers_force_drain(self):
        """render_map / map_to_odom / save must see a fully drained graph."""
        world = sim.make_corridor_world(40.0, 3.0)
        truth = corridor_trajectory(20)
        cfg = dataclasses.replace(CFG, max_inflight=32)  # never auto-drains
        mapper = Mapper(cfg)
        for t in range(len(truth)):
            msg = sim.scan_at_pose(world, truth[t], n_beams=240,
                                   range_max=12.0, noise=0.01,
                                   rng=np.random.default_rng(t))
            mapper.process_scan(msg, truth[t].copy())
        assert mapper._pending  # steps genuinely in flight
        grid = mapper.render_map()
        assert not mapper._pending
        assert mapper.graph.num_constraints == mapper.graph.num_scans - 1
        assert (grid.data == 100).sum() > 0
        # poses were filled in (not the odometry approximations): the
        # drained trajectory must track truth despite no odometry noise
        # here, so just check finiteness + ordering
        assert np.isfinite(mapper.graph.poses).all()
        t2o = mapper.map_to_odom()
        assert np.isfinite(t2o).all()


class TestGlobalRelocalization:
    """Uniform-over-free-space particle init (no reference equivalent: the
    reference requires a manual initialpose after map load)."""

    def test_global_init_converges(self, tmp_path):
        # Office ring plus a symmetry-breaking diagonal wall: the bare
        # office world is 4-fold symmetric, which makes global localization
        # genuinely ambiguous.
        world = np.concatenate([
            sim.make_office_world(16.0),
            np.asarray([[[1.0, 13.0], [3.0, 15.0]]]),
        ], axis=0)
        n = 16
        truth = np.stack([np.linspace(2.0, 10.0, n),
                          np.full(n, 2.0), np.zeros(n)], axis=-1)
        mapper, _, _ = run_mapping(world, truth, truth.copy(),
                                   range_max=14.0)
        path = str(tmp_path / "map.npz")
        mapper.configure(SAVE_TO_FILE, path)

        pf_cfg = dataclasses.replace(
            CFG, use_particle_filter=True,
            particle_filter=dataclasses.replace(
                MapperConfig().particle_filter,
                min_particles=100, max_particles=6000,
                odom_alpha1=0.05, odom_alpha2=0.05,
                odom_alpha3=0.05, odom_alpha4=0.05))
        loc = Mapper(pf_cfg, seed=7)
        loc.configure(LOAD_FROM_FILE, path)

        # No initial pose at all.
        assert loc.global_localize(truth[0])
        spread = loc.filter.get_covariance()
        assert spread[0, 0] > 1.0  # genuinely global: meters of uncertainty

        rel_truth = metrics.relative_to_first(truth)
        odom = sim.drift_odometry(truth, 0.01, 0.003, seed=31)
        errs = []
        for t in range(1, n):
            msg = sim.scan_at_pose(world, truth[t], n_beams=240,
                                   range_max=14.0, noise=0.01,
                                   rng=np.random.default_rng(900 + t))
            res = loc.process_scan(msg, odom[t])
            if res.accepted:
                errs.append(np.hypot(*(res.pose[:2] - rel_truth[t][:2])))
        assert len(errs) > 8
        # Converged: the last few poses track truth.
        assert np.mean(errs[-3:]) < 0.5

    def test_global_localize_requires_pf_and_map(self):
        m = Mapper(CFG)  # mapping mode, no PF
        assert not m.global_localize(np.zeros(3))
        pf_cfg = dataclasses.replace(CFG, use_particle_filter=True)
        m2 = Mapper(pf_cfg)  # PF but empty map
        assert not m2.global_localize(np.zeros(3))


class TestParticleFilterLocalization:
    """AMCL-parity localization (BASELINE config 4, miniature)."""

    def test_particle_filter_tracks(self, tmp_path):
        world = sim.make_box_world(10.0, 8.0)
        truth = np.stack([np.linspace(3.0, 7.0, 14),
                          np.full(14, 4.0), np.zeros(14)], axis=-1)
        mapper, est, used = run_mapping(world, truth, truth.copy(),
                                        range_max=14.0)
        path = str(tmp_path / "map.npz")
        mapper.configure(SAVE_TO_FILE, path)

        pf_cfg = dataclasses.replace(
            CFG, use_particle_filter=True,
            particle_filter=dataclasses.replace(
                MapperConfig().particle_filter,
                min_particles=80, max_particles=300,
                odom_alpha1=0.05, odom_alpha2=0.05,
                odom_alpha3=0.05, odom_alpha4=0.05))
        loc = Mapper(pf_cfg, seed=3)
        loc.configure(LOAD_FROM_FILE, path)
        # re-create the particle filter config binding after configure
        rel_truth = metrics.relative_to_first(truth)
        loc.set_initial_pose(rel_truth[0], np.diag([0.04, 0.04, 0.01]),
                             truth[0])
        odom = sim.drift_odometry(truth, 0.01, 0.003, seed=21)
        errs = []
        for t in range(1, len(truth)):
            msg = sim.scan_at_pose(world, truth[t], n_beams=240,
                                   range_max=14.0, noise=0.01,
                                   rng=np.random.default_rng(300 + t))
            res = loc.process_scan(msg, odom[t])
            if res.accepted:
                errs.append(np.hypot(*(res.pose[:2] - rel_truth[t][:2])))
                assert loc.graph.num_scans == 14  # PF never adds scans
        assert len(errs) > 5
        # The filter tracks: mean position error bounded, and the last
        # half is no worse than the first (no divergence).
        assert np.mean(errs) < 0.35
        half = len(errs) // 2
        assert np.mean(errs[half:]) < np.mean(errs[:half]) + 0.15

    def test_recovery_arms_lazily_from_loaded_map(self, tmp_path):
        """With recovery_alpha_* set, the mapper builds the free-space pool
        from the loaded map on the first PF scan and the EWMAs start
        tracking measurement quality (pf_step_recovery path)."""
        world = sim.make_box_world(10.0, 8.0)
        truth = np.stack([np.linspace(3.0, 7.0, 10),
                          np.full(10, 4.0), np.zeros(10)], axis=-1)
        mapper, _, _ = run_mapping(world, truth, truth.copy(), range_max=14.0)
        path = str(tmp_path / "map.npz")
        mapper.configure(SAVE_TO_FILE, path)

        pf_cfg = dataclasses.replace(
            CFG, use_particle_filter=True,
            particle_filter=dataclasses.replace(
                MapperConfig().particle_filter,
                min_particles=80, max_particles=300,
                recovery_alpha_slow=0.05, recovery_alpha_fast=0.5))
        loc = Mapper(pf_cfg, seed=3)
        loc.configure(LOAD_FROM_FILE, path)
        rel_truth = metrics.relative_to_first(truth)
        loc.set_initial_pose(rel_truth[0], np.diag([0.04, 0.04, 0.01]),
                             truth[0])
        assert loc.filter.free_xy is None  # not armed before the first scan
        for t in range(1, 4):
            msg = sim.scan_at_pose(world, truth[t], n_beams=240,
                                   range_max=14.0, noise=0.01,
                                   rng=np.random.default_rng(40 + t))
            loc.process_scan(msg, truth[t])
        assert loc.filter.recovery_enabled
        assert len(loc.filter.free_xy) > 100
        # EWMAs seeded from the first measurement and positive since.
        assert float(loc.filter.w_slow) > 0.0
        assert float(loc.filter.w_fast) > 0.0



class TestSolveBeforeReanchor:
    """Default-on alias-reanchor guard (PARITY.md deviation 9).

    Mechanism pinned: an accepted wrong FAR closure on the NEWEST scan
    rewrites its pose (reference semantics, ndt_mapper.cpp:651) and the
    dead-reckoning chain re-anchors on the rewrite — without the guard the
    alias jump enters the pose chain (a multi-metre config-6 ATE failure);
    with ``loop_closure_solve_before_
    reanchor`` the robust solve arbitrates FIRST, the switched-off alias
    edge loses to the odometry chain, and the tracker stays anchored.
    """

    def _mapper_with_chain(self, flag: bool):
        from ndt_2d_tpu.config import SolverConfig
        from ndt_2d_tpu.graph import pose_graph

        cfg = dataclasses.replace(
            CFG,
            solver=dataclasses.replace(SolverConfig(),
                                       robust_loss="geman_mcclure"),
            loop_closure_solve_before_reanchor=flag)
        mapper = Mapper(cfg)
        g = mapper.graph
        pts = np.zeros((cfg.max_points_per_scan, 2), np.float32)
        mask = np.zeros(cfg.max_points_per_scan, bool)
        mask[:8] = True
        # Straight 30-keyframe chain at 0.5 m spacing, tight odometry
        # constraints: the newest scan's consensus position is (14.5, 0).
        for k in range(30):
            g.add_scan(np.asarray([0.5 * k, 0.0, 0.0]), pts, mask)
            if k:
                pose_graph.make_constraint_np(
                    g, k - 1, k, np.diag([1e-4, 1e-4, 1e-5]))
        mapper.prev_robot_pose = g.poses[g.num_scans - 1].copy()
        mapper.prev_odom_pose = mapper.prev_robot_pose.copy()
        return mapper

    @pytest.mark.parametrize("flag,expect_jump", [(False, True),
                                                  (True, False)])
    def test_alias_closure_on_newest_scan(self, flag, expect_jump):
        mapper = self._mapper_with_chain(flag)
        g = mapper.graph
        idx = g.num_scans - 1          # the newest scan
        alias = 5                      # a 12 m appearance alias
        start = g.poses[idx].copy()
        true_pos = start[:2].copy()
        # Fabricated confirmed match (score passes the EWMA gate): the
        # correction lands the query exactly on the alias keyframe.
        correction = g.poses[alias] - start
        accepted = mapper._apply_gate(
            idx, alias, start, -1.0, correction,
            np.diag([1e-3, 1e-3, 1e-4]))
        assert accepted  # the gate cannot tell an alias from a revisit

        jump = float(np.linalg.norm(mapper.prev_robot_pose[:2] - true_pos))
        if expect_jump:
            # Reference behavior: the tracker re-anchored on the alias.
            assert jump > 8.0, jump
        else:
            # Guard: the robust solve restored the consensus pose before
            # the re-anchor; the alias edge was switched off.
            assert jump < 1.0, jump
            assert float(np.linalg.norm(
                g.poses[idx, :2] - true_pos)) < 1.0


class TestAutoGrowGrids:
    """Mid-session static-grid growth (config.auto_grow_grids, default on).

    The reference sizes every window NDT from its bounding box and can
    never overflow (scan_matcher_ndt.cpp:52-67); our static grids used to
    raise ValueError when a session outgrew them.  With auto_grow_grids
    the tripped matcher rebuilds at the next 32-multiple extent (one
    amortized recompile) and the session continues.
    """

    def _cfg(self, auto):
        small = ScanMatcherConfig(grid_cells_x=64, grid_cells_y=64)
        return dataclasses.replace(
            CFG, local_scan_matcher=small, global_scan_matcher=small,
            max_range=5.0, auto_grow_grids=auto)

    def _drive(self, cfg):
        # 0.75 m keyframe spacing: the 10-scan window spans ~6.75 m and
        # with 2 * range_max = 10 m needs ~68 cells at 0.25 m — beyond the
        # 64-cell grid once the window fills.
        world = sim.make_corridor_world(40.0, 3.0)
        truth = corridor_trajectory(24, step=0.75)
        odom = sim.drift_odometry(truth, trans_noise=0.005, rot_noise=0.001,
                                  seed=7)
        return run_mapping(world, truth, odom, cfg=cfg, range_max=5.0)

    def test_session_grows_and_completes(self):
        mapper, est, used_truth = self._drive(self._cfg(True))
        assert mapper.graph.num_scans >= 20
        # The local matcher was rebuilt at a larger 32-multiple extent.
        gx = mapper.local_matcher.config.grid_cells_x
        assert gx > 64 and gx % 32 == 0
        ate = metrics.ate_rmse(est, used_truth)
        assert ate < 0.5, ate

    def test_flag_off_raises_with_advice(self):
        with pytest.raises(ValueError, match="auto_grow_grids"):
            self._drive(self._cfg(False))


class TestConfirmRowReuse:
    """Pass-restart row reuse (mapper._loop_closure_pass_pipelined): after
    an acceptance restarts the pass, rows whose snapshot key (query pose,
    window poses, grid sizes) is unchanged reuse their fetched result
    instead of re-dispatching — and the decisions must be bitwise identical
    to a cache-disabled run."""

    def test_reuse_fires_and_is_decision_neutral(self):
        world, truth, odom = _office_loop_inputs()
        global_mcfg = ScanMatcherConfig(
            ndt_resolution=0.35, search_linear_size=0.15,
            search_linear_resolution=0.01, search_angular_size=0.05,
            grid_cells_x=160, grid_cells_y=160)
        cfg = dataclasses.replace(
            CFG, global_scan_matcher=global_mcfg,
            global_search_size=4.0, optimization_node_limit=10**9,
            batch_loop_closure=True, pipeline_loop_closure=True,
            loop_closure_region_size=3)

        results = {}
        for cache_on in (True, False):
            mapper, est, used_truth = run_mapping(world, truth, odom,
                                                  cfg=cfg, range_max=12.0,
                                                  n_beams=600)
            if not cache_on:
                # Force every snapshot lookup to miss: unique key per call.
                counter = [0]
                orig = mapper._confirm_row_key

                def always_miss(j, i, _c=counter, _o=orig):
                    _c[0] += 1
                    return _o(j, i) + _c[0].to_bytes(8, "little")
                mapper._confirm_row_key = always_miss
            mapper.loop_closure()
            g = mapper.graph
            results[cache_on] = dict(
                begin=g.constraint_begin.copy(), end=g.constraint_end.copy(),
                poses=g.poses.copy(),
                accepted=mapper.stats.loop_closures_accepted,
                rejected=mapper.stats.loop_closures_rejected,
                reused=mapper.stats.confirm_rows_reused)

        on, off = results[True], results[False]
        # The scenario must exercise reuse: >= 1 acceptance restarts the
        # pass with unchanged remaining rows.
        assert on["accepted"] >= 1
        assert on["reused"] > 0
        assert off["reused"] == 0
        assert on["accepted"] == off["accepted"]
        assert on["rejected"] == off["rejected"]
        np.testing.assert_array_equal(on["begin"], off["begin"])
        np.testing.assert_array_equal(on["end"], off["end"])
        np.testing.assert_array_equal(on["poses"], off["poses"])
