"""Native C++ runtime components: baseline matcher + binary graph codec."""

import numpy as np
import pytest

from ndt_2d_tpu.config import ScanMatcherConfig
from ndt_2d_tpu.io import native
from ndt_2d_tpu.matching import registry
from ndt_2d_tpu.utils import sim

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")

MCFG = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)


class TestBaselineMatcher:
    def test_agrees_with_tpu_matcher(self):
        world = sim.make_box_world(10.0, 8.0)
        poses = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05],
                            [5.2, 4.1, -0.05]], np.float32)
        pts, msk = [], []
        for p in poses:
            msg = sim.scan_at_pose(world, p, n_beams=360, range_max=15.0)
            a, b = sim.project_scan(msg, 512)
            pts.append(a)
            msk.append(b)
        window_points = np.stack(pts)
        window_mask = np.stack(msk)

        msg = sim.scan_at_pose(world, np.asarray([5.0, 4.0, 0.0]),
                               n_beams=360, range_max=15.0)
        qpts, qmask = sim.project_scan(msg, 512)
        n = int(qmask.sum())
        pose = np.asarray([5.02, 3.98, 0.01], np.float32)

        score, corr, cands = native.match_baseline(
            poses, window_points, window_mask, qpts, qmask, n, pose, 15.0,
            MCFG)
        assert cands == MCFG.num_candidates

        m = registry.create("ndt", MCFG, 15.0)
        m.add_scans(poses, window_points, window_mask)
        res = m.match_scan(qpts, qmask, n, pose)
        # Cross-implementation agreement (float64 C++ vs float32 JAX).
        assert score == pytest.approx(float(res.score), abs=2e-3)
        np.testing.assert_allclose(corr, np.asarray(res.correction),
                                   atol=1e-6)


class TestReferencePipelineIndexing:
    """Regression for the round-3 bag-vs-keyframe indexing bug.

    The oracle arm (native/reference_pipeline.cpp) keeps keyframe poses in a
    compacted array but its points/mask buffers are BAG-indexed; match_scan
    must translate keyframe index -> bag index via `ids` before gathering a
    window scan's points.  The pre-fix code indexed points by KEYFRAME index,
    so whenever the motion gate skipped scans (accepted < scans_in) every
    rolling-window NDT was built from the wrong scans' points and the
    open-loop trajectory diverged wildly.  This test runs a bag where the
    gate rejects roughly half the scans and pins the open-loop trajectory to
    ground truth.
    """

    def test_gated_open_loop_tracks_truth(self):
        from ndt_2d_tpu.config import MapperConfig
        from ndt_2d_tpu.io import bag as bag_mod
        from ndt_2d_tpu.mapping import laser
        from ndt_2d_tpu.utils import metrics

        n = 90
        bag = bag_mod.record_synthetic("corridor", n, n_beams=240, seed=3)
        cfg = MapperConfig(
            local_scan_matcher=MCFG, global_scan_matcher=MCFG,
            max_points_per_scan=256,
            minimum_travel_distance=0.9,     # corridor step ~0.4 m => skips
            loop_closure_every=10**9)        # open loop
        pts, msks = [], []
        for t in range(n):
            msg, _ = bag[t]
            p, m = laser.project_scan(msg, bag.range_max, np.zeros(3), False,
                                      np.zeros(3), cfg.max_points_per_scan)
            pts.append(p)
            msks.append(m)
        poses, ids, ncl, _ = native.reference_slam(
            np.stack(pts), np.stack(msks), bag.odom, bag.range_max, cfg)
        assert ncl == 0
        # The gate must actually skip scans, or keyframe and bag indexings
        # coincide and this test proves nothing.
        assert 10 < len(poses) < n
        assert not np.array_equal(ids, np.arange(len(poses)))
        ate = metrics.ate_rmse(poses, bag.truth[ids])
        assert ate < 0.3, f"open-loop ATE {ate:.3f} m: window NDTs likely " \
                          "built from wrong scans' points (bag-index bug)"


class TestGraphCodec:
    def test_roundtrip(self, tmp_path):
        from ndt_2d_tpu.graph.pose_graph import Graph
        g = Graph(max_points_per_scan=32)
        rng = np.random.default_rng(0)
        for i in range(5):
            pts = rng.normal(0, 1, (32, 2)).astype(np.float32)
            mask = np.arange(32) < 20 + i
            g.add_scan(rng.normal(0, 1, 3), pts, mask)
        for j in range(3):
            g.add_constraint(j, j + 1, rng.normal(0, 1, 3),
                             np.eye(3) * (j + 1), switchable=(j == 2))
        path = str(tmp_path / "map.ndt2")
        native.save_graph(g, path)
        g2 = native.load_graph(path, 32)
        assert g2.num_scans == 5
        assert g2.num_constraints == 3
        np.testing.assert_allclose(g2.poses, g.poses)
        np.testing.assert_allclose(g2.points, g.points)
        np.testing.assert_array_equal(g2.point_mask, g.point_mask)
        np.testing.assert_allclose(g2.constraint_transform,
                                   g.constraint_transform)
        np.testing.assert_allclose(g2.constraint_information,
                                   g.constraint_information)
        np.testing.assert_array_equal(g2.constraint_switchable,
                                      g.constraint_switchable)


class TestNativeBagCodec:
    def test_roundtrip(self, tmp_path):
        from ndt_2d_tpu.io import bag as bag_mod
        bag = bag_mod.record_synthetic("box", 6, n_beams=90, seed=1)
        path = str(tmp_path / "log.ndtbag")
        bag_mod.save_bag(bag, path)
        out = bag_mod.load_bag(path)
        np.testing.assert_array_equal(out.ranges, bag.ranges)
        np.testing.assert_array_equal(out.odom, bag.odom)
        np.testing.assert_array_equal(out.truth, bag.truth)
        assert out.range_max == bag.range_max
        assert out.angle_increment == bag.angle_increment

    def test_no_truth(self, tmp_path):
        from ndt_2d_tpu.io import bag as bag_mod
        b = bag_mod.record_synthetic("box", 4, n_beams=60, seed=2)
        b = bag_mod.ScanBag(ranges=b.ranges, angle_min=b.angle_min,
                            angle_increment=b.angle_increment,
                            time_increment=b.time_increment,
                            range_max=b.range_max, odom=b.odom, truth=None)
        path = str(tmp_path / "nt.ndtbag")
        bag_mod.save_bag(b, path)
        out = bag_mod.load_bag(path)
        assert out.truth is None
        np.testing.assert_array_equal(out.ranges, b.ranges)

    def test_bad_magic_rejected(self, tmp_path):
        from ndt_2d_tpu.io import native
        path = str(tmp_path / "junk.ndtbag")
        with open(path, "wb") as f:
            f.write(b"JUNKJUNKJUNKJUNK" * 8)
        with pytest.raises(IOError):
            native.load_bag(path)
