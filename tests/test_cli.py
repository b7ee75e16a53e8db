"""CLI + runtime control channel tests (the reference's scripts/ surface)."""

import json
import threading
import time

import numpy as np
import pytest

from ndt_2d_tpu import cli
from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu.io import bag as bag_mod
from ndt_2d_tpu.mapping import runtime
from ndt_2d_tpu.mapping.mapper import Mapper


@pytest.fixture(scope="module")
def small_bag(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bags") / "bag.npz")
    rc = cli.main(["simulate", "--world", "box", "--scans", "16",
                   "--beams", "180", "--range-max", "14.0", "--out", path])
    assert rc == 0
    return path


class TestCli:
    def test_simulate_reproducible(self, small_bag):
        bag = bag_mod.load_bag(small_bag)
        assert len(bag) == 16
        assert bag.truth is not None

    def test_run_and_info(self, small_bag, tmp_path, capsys):
        map_out = str(tmp_path / "map.npz")
        grid_out = str(tmp_path / "grid.npz")
        rc = cli.main(["run", "--bag", small_bag, "--map-out", map_out,
                       "--grid-out", grid_out,
                       "--local_scan_matcher.grid_cells", "160",
                       "--loop-closure-every", "1000000"])
        assert rc == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["graph_scans"] >= 10
        assert stats["ate_rmse_m"] < 0.15

        rc = cli.main(["info", "--map", map_out])
        assert rc == 0
        info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert info["scans"] == stats["graph_scans"]

        grid = np.load(grid_out)
        assert (grid["data"] == 100).sum() > 10

    def test_viz_outputs(self, small_bag, tmp_path, capsys):
        map_out = str(tmp_path / "map.npz")
        viz_out = str(tmp_path / "session.png")
        rc = cli.main(["run", "--bag", small_bag, "--map-out", map_out,
                       "--viz-out", viz_out,
                       "--local_scan_matcher.grid_cells", "160",
                       "--loop-closure-every", "1000000"])
        assert rc == 0
        capsys.readouterr()
        with open(viz_out, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"

        map_png = str(tmp_path / "map.png")
        rc = cli.main(["viz", "--map", map_out, "--render-grid",
                       "--out", map_png])
        assert rc == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["scans"] >= 10
        with open(map_png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    def test_localize_against_map(self, small_bag, tmp_path, capsys):
        map_out = str(tmp_path / "map.npz")
        assert cli.main(["run", "--bag", small_bag, "--map-out", map_out,
                         "--local_scan_matcher.grid_cells", "160",
                         "--loop-closure-every", "1000000"]) == 0
        capsys.readouterr()
        rc = cli.main(["localize", "--bag", small_bag, "--map", map_out,
                       "--global_scan_matcher.grid_cells", "192"])
        assert rc == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        # localization never grows the graph
        assert stats["graph_scans"] == stats["graph_constraints"] + 1


class TestControlChannel:
    def test_configure_roundtrip(self, tmp_path):
        cfg = MapperConfig(
            local_scan_matcher=ScanMatcherConfig(grid_cells_x=64,
                                                 grid_cells_y=64),
            max_points_per_scan=64)
        mapper = Mapper(cfg)
        sock = str(tmp_path / "ctl.sock")
        server = runtime.ControlServer(mapper, sock)
        try:
            time.sleep(0.05)
            out = runtime.send_configure(sock, 2)  # DISABLE_MAPPING
            assert out["ok"]
            assert mapper.enable_mapping is False
            out = runtime.send_configure(sock, 1)  # ENABLE_MAPPING
            assert out["ok"]
            assert mapper.enable_mapping is True

            # save/load through the channel
            pts = np.zeros((64, 2), np.float32)
            mask = np.zeros(64, bool)
            mapper.graph.add_scan([1.0, 2.0, 0.1], pts, mask)
            map_path = str(tmp_path / "m.npz")
            assert runtime.send_configure(sock, 8, map_path)["ok"]
            assert runtime.send_configure(sock, 4, map_path)["ok"]
            assert mapper.graph.num_scans == 1
            # load requires re-localization (ndt_mapper.cpp:178)
            assert mapper.prev_odom_pose_is_initialized is False
        finally:
            server.close()


class TestSessionCheckpoint:
    """Full session checkpoint/resume (beyond the reference's map-only
    save, which loses the pose estimate and needs re-localization)."""

    def test_split_session_matches_continuous(self, tmp_path, capsys):
        import dataclasses as dc

        from ndt_2d_tpu.io import serialization
        from ndt_2d_tpu.utils import sim

        mcfg = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
        cfg = MapperConfig(local_scan_matcher=mcfg, global_scan_matcher=mcfg,
                           max_points_per_scan=512,
                           loop_closure_every=10**9)
        world = sim.make_box_world(10.0, 8.0)
        truth = np.stack([np.linspace(3.0, 6.0, 16), np.full(16, 4.0),
                          np.zeros(16)], -1)
        odom = sim.drift_odometry(truth, 0.01, 0.003, seed=2)

        def scan(t):
            return sim.scan_at_pose(world, truth[t], n_beams=240,
                                    range_max=12.0, noise=0.01,
                                    rng=np.random.default_rng(t))

        # continuous run
        cont = Mapper(cfg)
        for t in range(16):
            cont.process_scan(scan(t), odom[t])

        # split run with checkpoint in the middle
        half = Mapper(cfg)
        for t in range(8):
            half.process_scan(scan(t), odom[t])
        ckpt = str(tmp_path / "session.npz")
        serialization.save_session(half, ckpt)
        resumed = serialization.load_session(ckpt, cfg)
        assert resumed.prev_odom_pose_is_initialized
        for t in range(8, 16):
            resumed.process_scan(scan(t), odom[t])

        assert resumed.graph.num_scans == cont.graph.num_scans
        np.testing.assert_allclose(resumed.graph.poses, cont.graph.poses,
                                   atol=1e-6)
        np.testing.assert_allclose(resumed.typical_matcher_response,
                                   cont.typical_matcher_response, atol=1e-9)

    def test_map_file_rejected_as_session(self, tmp_path):
        from ndt_2d_tpu.io import serialization

        cfg = MapperConfig(
            local_scan_matcher=ScanMatcherConfig(grid_cells_x=64,
                                                 grid_cells_y=64),
            max_points_per_scan=64)
        m = Mapper(cfg)
        m.graph.add_scan([0.0, 0.0, 0.0], np.zeros((64, 2), np.float32),
                         np.zeros(64, bool))
        map_path = str(tmp_path / "m.npz")
        serialization.save_graph(m.graph, map_path)
        with pytest.raises(ValueError, match="session"):
            serialization.load_session(map_path, cfg)


class TestTrajectoryExport:
    def test_run_traj_out_tum(self, tmp_path, capsys):
        from ndt_2d_tpu import cli
        from ndt_2d_tpu.io import serialization
        import numpy as np
        import json
        bag = str(tmp_path / "bag.npz")
        assert cli.main(["simulate", "--world", "corridor", "--scans", "40",
                         "--out", bag]) == 0
        capsys.readouterr()
        traj = str(tmp_path / "traj.tum")
        assert cli.main(["run", "--bag", bag, "--traj-out", traj,
                         "--loop-closure-every", "1000000",
                         "--local_scan_matcher.grid_cells", "192"]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["traj_out"] == traj
        assert "_est" not in stats
        times, poses = serialization.load_tum(traj)
        assert len(times) == stats["scans_accepted"]
        assert np.isfinite(poses).all()
        # yaw round-trips through the quaternion encoding
        assert abs(poses[0][2]) < np.pi


class TestCliMesh:
    def test_run_with_mesh(self, small_bag, tmp_path, capsys):
        """cli run --mesh N drives the sharded pipeline end-to-end."""
        import jax
        if jax.device_count() < 2:
            pytest.skip("needs the multi-device CPU mesh")
        map_out = str(tmp_path / "map.npz")
        rc = cli.main(["run", "--bag", small_bag, "--map-out", map_out,
                       "--mesh", str(jax.device_count()),
                       "--local_scan_matcher.grid_cells", "160",
                       "--loop-closure-every", "1000000"])
        assert rc == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["scans_accepted"] >= 14
        assert stats["ate_rmse_m"] < 0.12


class TestRecipePresets:
    """--recipe applies the loop-closure recipe presets, with explicit flags
    overriding preset values."""

    def _config(self, argv):
        # Parse through the real parser (no execution), then build config.
        args = cli._parse_for_test(["run", "--bag", "x"] + argv)
        return cli._mapper_config(args)

    def test_office_recipe(self):
        cfg = self._config(["--recipe", "office"])
        assert cfg.loop_closure_gate_scale == 0.85
        assert cfg.loop_closure_region_size == 3
        assert cfg.loop_search_positions == "both"
        assert cfg.solver.robust_loss == "geman_mcclure"
        assert cfg.global_scan_matcher.refine_iterations == 8
        # untouched session scaffolding keeps its defaults
        assert cfg.loop_search == "radius"
        assert cfg.local_scan_matcher.refine_iterations == 0

    def test_descriptor_recipe(self):
        cfg = self._config(["--recipe", "office-descriptor"])
        assert cfg.loop_search == "descriptor"
        assert cfg.loop_closure_accept == "best"
        assert cfg.loop_closure_max_separation == 1.5
        assert cfg.loop_closure_far_dedup == 2.5
        assert cfg.loop_closure_reject_cache_margin == 0.10
        assert cfg.loop_closure_max_far_rows == 16

    def test_drift_recipe(self):
        cfg = self._config(["--recipe", "drift"])
        assert cfg.loop_search == "both"
        assert cfg.global_search_limit == 8
        assert cfg.descriptor_min_similarity == 0.80

    def test_explicit_flags_override_preset(self):
        cfg = self._config(["--recipe", "office",
                            "--loop-closure-gate-scale", "0.95",
                            "--robust-loss", "none",
                            "--global_scan_matcher.refine_iterations", "4",
                            "--loop-search-positions", "barycenter"])
        assert cfg.loop_closure_gate_scale == 0.95
        assert cfg.solver.robust_loss == "none"
        assert cfg.global_scan_matcher.refine_iterations == 4
        assert cfg.loop_search_positions == "barycenter"
        # non-overridden preset values still apply
        assert cfg.loop_closure_region_size == 3

    def test_no_recipe_is_parity(self):
        cfg = self._config([])
        ref = MapperConfig()
        assert cfg.loop_closure_gate_scale == ref.loop_closure_gate_scale
        assert cfg.solver.robust_loss == ref.solver.robust_loss

    def test_gate_and_loss_flags_without_recipe(self):
        cfg = self._config(["--loop-closure-gate-scale", "0.9",
                            "--robust-loss", "huber"])
        assert cfg.loop_closure_gate_scale == 0.9
        assert cfg.solver.robust_loss == "huber"
