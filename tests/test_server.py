"""Live streaming runtime (mapping.server): scans over a socket, latched
map artifacts, Configure + initialpose on the same channel."""

import json
import os
import socket
import time

import numpy as np
import pytest

from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu.io import bag as bag_mod
from ndt_2d_tpu.mapping.mapper import Mapper
from ndt_2d_tpu.mapping import server as server_mod


@pytest.fixture()
def live(tmp_path):
    cfg = MapperConfig(
        local_scan_matcher=ScanMatcherConfig(grid_cells_x=160,
                                             grid_cells_y=160),
        global_scan_matcher=ScanMatcherConfig(grid_cells_x=160,
                                              grid_cells_y=160),
        max_points_per_scan=512, loop_closure_every=10**9)
    mapper = Mapper(cfg)
    sock = str(tmp_path / "scan.sock")
    pub = str(tmp_path / "pub")
    srv = server_mod.ScanServer(mapper, sock, publish_dir=pub)
    # shorten the publish cadence for the test
    srv.publisher.period = 0.02
    yield mapper, srv, sock, pub
    srv.close()


def _roundtrip(sock_path, req):
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock_path)
        f = s.makefile("rwb")
        f.write(json.dumps(req).encode() + b"\n")
        f.flush()
        return json.loads(f.readline())


class TestScanServer:
    def test_stream_bag_end_to_end(self, live):
        mapper, srv, sock, pub = live
        bag = bag_mod.record_synthetic("box", 10, n_beams=240, seed=4)
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "bag.npz")
            bag_mod.save_bag(bag, path)
            last = server_mod.stream_bag(path, sock)
        assert last["ok"] and last["accepted"]
        assert mapper.graph.num_scans >= 8
        assert len(last["pose"]) == 3 and len(last["map_to_odom"]) == 3

        # latched artifacts appear on the publish cadence
        # Latched artifacts appear on the publish cadence and converge to
        # the final graph (the latched-topic behavior: latest wins).
        deadline = time.time() + 5.0
        map_path = os.path.join(pub, "map.npz")
        state_path = os.path.join(pub, "state.json")
        state = None
        while time.time() < deadline:
            if os.path.exists(map_path) and os.path.exists(state_path):
                try:
                    state = json.load(open(state_path))
                except json.JSONDecodeError:  # mid-write
                    state = None
                if state and state["nodes"] == mapper.graph.num_scans:
                    break
            time.sleep(0.05)
        assert state is not None
        assert state["nodes"] == mapper.graph.num_scans
        grid = np.load(map_path)
        assert (grid["data"] == 100).sum() > 10

    def test_configure_and_error_on_same_channel(self, live, tmp_path):
        mapper, srv, sock, pub = live
        out = _roundtrip(sock, {"action": 2})  # DISABLE_MAPPING
        assert out["ok"] and mapper.enable_mapping is False
        out = _roundtrip(sock, {"action": 1})
        assert out["ok"] and mapper.enable_mapping is True

        out = _roundtrip(sock, {"garbage": True})
        assert out["ok"] is False and "error" in out

    def test_initial_pose_message(self, live):
        mapper, srv, sock, pub = live
        mapper.enable_mapping = False  # localization mode accepts seeds
        mapper.prev_odom_pose_is_initialized = False
        out = _roundtrip(sock, {"initial_pose": [1.0, 2.0, 0.1],
                                "odom": [0.0, 0.0, 0.0]})
        assert out["ok"]
        assert mapper.prev_odom_pose_is_initialized
        np.testing.assert_allclose(mapper.prev_robot_pose, [1.0, 2.0, 0.1])

    def test_nan_ranges_survive_json(self, live):
        mapper, srv, sock, pub = live
        ranges = [1.0, float("nan"), 2.0] * 80
        out = _roundtrip(sock, {
            "ranges": ranges, "angle_min": -np.pi,
            "angle_increment": 2 * np.pi / len(ranges), "range_max": 10.0,
            "odom": [0.0, 0.0, 0.0]})
        assert out["ok"]


class TestWindowedProtocol:
    """Round-3: pipelined live surface — immediate acks, async pose results,
    unconditional state.json cadence (TF-broadcast parity)."""

    @pytest.fixture()
    def live_pipelined(self, tmp_path):
        cfg = MapperConfig(
            local_scan_matcher=ScanMatcherConfig(grid_cells_x=160,
                                                 grid_cells_y=160),
            global_scan_matcher=ScanMatcherConfig(grid_cells_x=160,
                                                  grid_cells_y=160),
            max_points_per_scan=512, loop_closure_every=10**9,
            max_inflight=8)
        mapper = Mapper(cfg)
        sock = str(tmp_path / "scan.sock")
        pub = str(tmp_path / "pub")
        srv = server_mod.ScanServer(mapper, sock, publish_dir=pub)
        srv.publisher.period = 0.02
        yield mapper, srv, sock, pub
        srv.close()

    def test_windowed_stream_delivers_all_poses(self, live_pipelined):
        mapper, srv, sock, pub = live_pipelined
        bag = bag_mod.record_synthetic("box", 12, n_beams=240, seed=4)
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "bag.npz")
            bag_mod.save_bag(bag, path)
            last = server_mod.stream_bag(path, sock, windowed=True)
        assert last["ok"]
        results = last["results"]
        # every accepted scan eventually produced a result line
        accepted = mapper.graph.num_scans
        assert accepted >= 10
        # scan 0 takes the synchronous first-scan path (no future) and some
        # scans may be motion-gated; all others stream results.
        assert len(results) >= accepted - 2
        assert last["scans_accepted"] == accepted
        assert last["poses_delivered"] == accepted
        for r in results.values():
            assert len(r["pose"]) == 3 and len(r["map_to_odom"]) == 3
            assert np.isfinite(r["pose"]).all()
        # deferred poses match what drained into the graph
        ids = sorted(results)
        graph_tail = mapper.graph.poses[-len(ids):]
        got = np.asarray([results[i]["pose"] for i in ids])
        np.testing.assert_allclose(got, graph_tail, atol=1e-5)

    def test_windowed_gated_scan_does_not_drain(self, live_pipelined):
        """A motion-gated scan in a windowed stream must ack without
        draining the in-flight pipeline (review finding r6: the rejected
        scan's reply went through map_to_odom() -> _drain_all(), collapsing
        windowed throughput to sync speed at sensor rate)."""
        mapper, srv, sock, pub = live_pipelined
        # Quiesce the 50 Hz publisher: its render path drains the pipeline
        # by design, which under a loaded CI host races the "pipeline in
        # flight" precondition this test needs to observe.
        srv.publisher.period = 60.0
        bag = bag_mod.record_synthetic("box", 8, n_beams=240, seed=4)

        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(sock)
            f = s.makefile("rwb")

            def send(t, odom):
                msg, _ = bag[t]
                f.write(json.dumps({
                    "id": t, "windowed": True,
                    "ranges": msg.ranges.astype(float).tolist(),
                    "angle_min": msg.angle_min,
                    "angle_increment": msg.angle_increment,
                    "time_increment": msg.time_increment,
                    "range_max": msg.range_max,
                    "odom": list(map(float, odom)),
                }).encode() + b"\n")
                f.flush()
                while True:
                    line = json.loads(f.readline())
                    if "result" not in line:
                        return line
            for t in range(6):
                send(t, bag.odom[t])
            assert mapper._pending  # pipeline in flight
            pending_before = len(mapper._pending)
            # repeat the last odometry: motion-gated scan
            rep = send(5, bag.odom[5])
            assert rep["ok"] and rep["accepted"] is False
            assert "map_to_odom" not in rep
            assert len(mapper._pending) == pending_before  # NOT drained

    def test_state_json_publishes_unconditionally(self, live_pipelined):
        """map->odom state must refresh on the cadence even with NO map
        update (reference broadcasts TF every 250 ms regardless,
        ndt_mapper.cpp:716-742)."""
        mapper, srv, sock, pub = live_pipelined
        state_path = os.path.join(pub, "state.json")
        deadline = time.time() + 5.0
        while not os.path.exists(state_path) and time.time() < deadline:
            time.sleep(0.02)
        assert os.path.exists(state_path)
        m1 = os.stat(state_path).st_mtime_ns
        # No scans are flowing and no map update is pending...
        assert not mapper.map_update_available
        deadline = time.time() + 5.0
        while time.time() < deadline:
            if os.stat(state_path).st_mtime_ns > m1:
                break
            time.sleep(0.02)
        assert os.stat(state_path).st_mtime_ns > m1, \
            "state.json must advance between map updates"
