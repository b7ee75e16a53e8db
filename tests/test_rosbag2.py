"""Reference rosbag2 map interop (io/rosbag2.py vs src/graph.cpp:49-165).

Since no ROS stack exists in this environment, the CDR layout is pinned two
independent ways: (1) golden blobs hand-assembled byte-by-byte from the
XCDR1 rules and the message IDL (msg/Scan.msg, msg/Constraint.msg), compared
against the encoder; (2) full export -> import round trips through the
sqlite3 storage, including via a real mapping session.
"""

import struct

import numpy as np

from ndt_2d_tpu.graph.pose_graph import Graph
from ndt_2d_tpu.io import rosbag2


def _golden_scan_blob():
    """ndt_2d/msg/Scan, assembled field-by-field per XCDR1:
    u64 id | Pose (3 f64 position, 4 f64 orientation) | sequence length u32 |
    pad to 8 | points as geometry_msgs/Point (3 f64 each).
    theta rides in orientation.w (graph.cpp:125)."""
    out = b"\x00\x01\x00\x00"                       # CDR_LE encapsulation
    out += struct.pack("<Q", 7)                     # id
    out += struct.pack("<d", 1.5)                   # position.x
    out += struct.pack("<d", -2.25)                 # position.y
    out += struct.pack("<d", 0.0)                   # position.z
    out += struct.pack("<d", 0.0) * 3               # orientation.x/y/z
    out += struct.pack("<d", 0.75)                  # orientation.w = theta
    out += struct.pack("<I", 2)                     # points.size()
    out += b"\x00" * 4                              # align 8 for first f64
    out += struct.pack("<3d", 0.5, 0.25, 0.0)       # point 0
    out += struct.pack("<3d", -1.0, 2.0, 0.0)       # point 1
    return out


def _golden_constraint_blob():
    """ndt_2d/msg/Constraint: i64 begin | i64 end | Transform (3 f64
    translation, 4 f64 rotation) | f64[9] information | bool.
    dtheta rides in translation.z (graph.cpp:148)."""
    info = np.arange(1.0, 10.0)
    out = b"\x00\x01\x00\x00"
    out += struct.pack("<q", 3)                     # begin
    out += struct.pack("<q", 9)                     # end
    out += struct.pack("<3d", 0.1, -0.2, 0.05)      # translation (z = dtheta)
    out += struct.pack("<4d", 0.0, 0.0, 0.0, 0.0)   # rotation (unused)
    out += struct.pack("<9d", *info)                # information row-major
    out += struct.pack("<?", True)                  # switchable
    return out


class TestCdrGolden:
    def test_scan_encode_matches_golden(self):
        blob = rosbag2.encode_scan(7, [1.5, -2.25, 0.75],
                                   [[0.5, 0.25], [-1.0, 2.0]])
        assert blob == _golden_scan_blob()

    def test_scan_decode_golden(self):
        sid, pose, pts = rosbag2.decode_scan(_golden_scan_blob())
        assert sid == 7
        np.testing.assert_allclose(pose, [1.5, -2.25, 0.75])
        np.testing.assert_allclose(pts, [[0.5, 0.25], [-1.0, 2.0]])

    def test_constraint_encode_matches_golden(self):
        blob = rosbag2.encode_constraint(3, 9, [0.1, -0.2, 0.05],
                                         np.arange(1.0, 10.0).reshape(3, 3),
                                         True)
        assert blob == _golden_constraint_blob()

    def test_constraint_decode_golden(self):
        b, e, t, info, sw = rosbag2.decode_constraint(
            _golden_constraint_blob())
        assert (b, e, sw) == (3, 9, True)
        np.testing.assert_allclose(t, [0.1, -0.2, 0.05])
        np.testing.assert_allclose(info, np.arange(1.0, 10.0).reshape(3, 3))

    def test_empty_scan_no_alignment_pad(self):
        """CDR pads only BEFORE sequence elements: a point-less scan (the
        reference tolerates them, ndt_mapper.cpp:625) has a 68-byte body
        with no pad after the count."""
        blob = rosbag2.encode_scan(2, [0.5, 0.5, 0.1], np.zeros((0, 2)))
        assert len(blob) == 4 + 68
        sid, pose, pts = rosbag2.decode_scan(blob)
        assert sid == 2 and pts.shape == (0, 2)
        np.testing.assert_allclose(pose, [0.5, 0.5, 0.1])

    def test_empty_scan_roundtrip_via_graph(self, tmp_path):
        g = Graph(8, True)
        g.add_scan([1.0, 2.0, 0.3], np.zeros((8, 2), np.float32),
                   np.zeros(8, bool))
        g.add_scan([1.5, 2.0, 0.3], np.ones((8, 2), np.float32),
                   np.ones(8, bool))
        bag_dir = str(tmp_path / "m")
        rosbag2.export_map(g, bag_dir)
        g2 = rosbag2.import_map(bag_dir, max_points_per_scan=8)
        assert g2.num_scans == 2
        assert g2.point_mask[0].sum() == 0
        assert g2.point_mask[1].sum() == 8

    def test_big_endian_rejected(self):
        blob = b"\x00\x00\x00\x00" + _golden_scan_blob()[4:]
        try:
            rosbag2.decode_scan(blob)
            assert False, "expected ValueError"
        except ValueError:
            pass


def _make_graph(n_scans=5, n_points=16, n_constraints=4, max_points=32):
    rng = np.random.default_rng(3)
    g = Graph(max_points, True)
    for i in range(n_scans):
        pts = np.zeros((max_points, 2), np.float32)
        mask = np.zeros(max_points, bool)
        k = n_points - i  # varying point counts
        pts[:k] = rng.normal(0, 2.0, (k, 2))
        mask[:k] = True
        g.add_scan(rng.normal(0, 1.0, 3), pts, mask)
    for j in range(n_constraints):
        g.add_constraint(j, j + 1, rng.normal(0, 0.1, 3),
                         np.diag(rng.uniform(1, 100, 3)), switchable=j % 2)
    return g


class TestRoundTrip:
    def test_export_import_roundtrip(self, tmp_path):
        g = _make_graph()
        bag_dir = str(tmp_path / "refmap")
        rosbag2.export_map(g, bag_dir)
        # metadata.yaml + one .db3 storage file, like a real rosbag2 dir
        assert (tmp_path / "refmap" / "metadata.yaml").exists()
        assert (tmp_path / "refmap" / "refmap_0.db3").exists()

        for opened_as in (bag_dir, str(tmp_path / "refmap" / "refmap_0.db3")):
            g2 = rosbag2.import_map(opened_as, max_points_per_scan=32)
            assert g2.num_scans == g.num_scans
            assert g2.num_constraints == g.num_constraints
            # float32 storage in Graph vs float64 on the wire
            np.testing.assert_allclose(g2.poses, g.poses, atol=1e-6)
            np.testing.assert_array_equal(g2.point_mask, g.point_mask)
            np.testing.assert_allclose(g2.points, g.points, atol=1e-6)
            np.testing.assert_array_equal(g2.constraint_begin,
                                          g.constraint_begin)
            np.testing.assert_array_equal(g2.constraint_end, g.constraint_end)
            np.testing.assert_allclose(g2.constraint_transform,
                                       g.constraint_transform, atol=1e-12)
            np.testing.assert_allclose(g2.constraint_information,
                                       g.constraint_information, atol=1e-9)
            np.testing.assert_array_equal(g2.constraint_switchable,
                                          g.constraint_switchable)

    def test_import_repads_to_capacity(self, tmp_path):
        g = _make_graph(n_points=16, max_points=32)
        bag_dir = str(tmp_path / "refmap")
        rosbag2.export_map(g, bag_dir)
        g2 = rosbag2.import_map(bag_dir, max_points_per_scan=8)  # truncates
        assert g2.points.shape[1] == 8
        assert g2.point_mask[0].sum() == 8

    def test_cli_roundtrip(self, tmp_path):
        """import-rosbag2 / export-rosbag2 CLI verbs over a real session."""
        from ndt_2d_tpu import cli
        from ndt_2d_tpu.io import serialization
        g = _make_graph()
        native = str(tmp_path / "map.npz")
        serialization.save_graph(g, native)
        bag_dir = str(tmp_path / "refbag")
        assert cli.main(["export-rosbag2", "--map", native,
                         "--out", bag_dir]) == 0
        back = str(tmp_path / "back.npz")
        assert cli.main(["import-rosbag2", "--bag", bag_dir,
                         "--out", back, "--max-points", "32"]) == 0
        g2 = serialization.load_graph(back, 32)
        np.testing.assert_allclose(g2.poses, g.poses, atol=1e-6)
        assert g2.num_constraints == g.num_constraints


class TestFrozenHexGoldens:
    """Immutable hex-literal goldens (round 3).

    The hand-assembled goldens above share their XCDR1 derivation with the
    encoder; no ROS stack was available to capture a real rmw_fastrtps
    blob, so the strongest
    available pin is FREEZING the bytes: these constants were generated
    2026-08-20 and must never be regenerated from the code under test — any
    future change to the layout rules (in the encoder OR the assembly
    helpers) now fails against an immutable artifact.  The one rule a real
    capture would still de-risk is Fast-CDR's alignment-on-next-write
    semantics for sequences (pad exists only when elements follow), pinned
    here by the empty-scan golden: Fast-CDR aligns lazily at each write, so
    after the u32 count an empty sequence writes nothing — byte 68 is the
    record end, with no trailing pad.
    """

    SCAN_HEX = (
        "000100000700000000000000000000000000f83f00000000000002c000000000"
        "0000000000000000000000000000000000000000000000000000000000000000"
        "0000e83f0200000000000000000000000000e03f000000000000d03f00000000"
        "00000000000000000000f0bf00000000000000400000000000000000")
    EMPTY_SCAN_HEX = (
        "000100000100000000000000000000000000e03f000000000000e0bf00000000"
        "0000000000000000000000000000000000000000000000000000000000000000"
        "0000d03f00000000")
    CONSTRAINT_HEX = (
        "00010000030000000000000009000000000000009a9999999999b93f9a999999"
        "9999c9bf9a9999999999a93f0000000000000000000000000000000000000000"
        "000000000000000000000000000000000000f03f000000000000004000000000"
        "0000084000000000000010400000000000001440000000000000184000000000"
        "00001c400000000000002040000000000000224001")

    def test_scan_blob_frozen(self):
        blob = rosbag2.encode_scan(7, [1.5, -2.25, 0.75],
                                   [[0.5, 0.25], [-1.0, 2.0]])
        assert blob.hex() == self.SCAN_HEX

    def test_empty_scan_blob_frozen(self):
        """Point-less scan: u32 count then record END — no alignment pad
        (Fast-CDR aligns lazily on the next write, which never comes)."""
        blob = rosbag2.encode_scan(1, [0.5, -0.5, 0.25], [])
        assert blob.hex() == self.EMPTY_SCAN_HEX
        assert len(blob) == 4 + 68  # header + body ending right after count
        sid, pose, pts = rosbag2.decode_scan(blob)
        assert sid == 1 and pts.shape == (0, 2)
        np.testing.assert_allclose(pose, [0.5, -0.5, 0.25])

    def test_constraint_blob_frozen(self):
        blob = rosbag2.encode_constraint(
            3, 9, [0.1, -0.2, 0.05], np.arange(1.0, 10.0).reshape(3, 3),
            True)
        assert blob.hex() == self.CONSTRAINT_HEX

    def test_frozen_blobs_decode(self):
        sid, pose, pts = rosbag2.decode_scan(bytes.fromhex(self.SCAN_HEX))
        assert sid == 7
        np.testing.assert_allclose(pose, [1.5, -2.25, 0.75])
        np.testing.assert_allclose(pts, [[0.5, 0.25], [-1.0, 2.0]])
        b, e, t, info, sw = rosbag2.decode_constraint(
            bytes.fromhex(self.CONSTRAINT_HEX))
        assert (b, e, sw) == (3, 9, True)
        np.testing.assert_allclose(t, [0.1, -0.2, 0.05])
        np.testing.assert_allclose(info, np.arange(1.0, 10.0).reshape(3, 3))
