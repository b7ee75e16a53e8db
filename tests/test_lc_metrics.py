"""Transform-error loop-closure metrics (benchmarks/loop_closure_pr.py).

Precision by 1 m-truth-set membership conflates "wrong edge"
with "edge between scans 1-3 m apart"; the transform-error criterion scores
an accepted closure TRUE iff its constraint's relative transform matches the
truth relative transform within (0.3 m, 0.05 rad).  These pin the
criterion's discrimination: a geometrically-correct edge between 2 m-apart
scans is TRUE (old criterion: false), a 12 m alias edge with a plausible
small transform is FALSE (old criterion: could score true if the alias
happened to sit within 1 m in truth).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

from loop_closure_pr import _rel_transform, transform_error_rows  # noqa: E402

from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig  # noqa: E402
from ndt_2d_tpu.graph import pose_graph  # noqa: E402
from ndt_2d_tpu.mapping.mapper import Mapper  # noqa: E402


def _mapper_with_truth():
    cfg = MapperConfig(
        local_scan_matcher=ScanMatcherConfig(grid_cells_x=96,
                                             grid_cells_y=96),
        global_scan_matcher=ScanMatcherConfig(grid_cells_x=96,
                                              grid_cells_y=96),
        max_points_per_scan=16)
    mapper = Mapper(cfg)
    g = mapper.graph
    pts = np.zeros((16, 2), np.float32)
    msk = np.ones(16, bool)
    # Truth: a straight line; estimates perturbed slightly.
    truth = np.stack([np.arange(8.0) * 0.5, np.zeros(8),
                      np.zeros(8)], -1)
    for k in range(8):
        g.add_scan(truth[k] + [0.01, -0.01, 0.002], pts, msk)
    return mapper, truth


def test_rel_transform_frame():
    pa = np.asarray([1.0, 2.0, np.pi / 2])
    pb = np.asarray([1.0, 3.0, np.pi / 2])
    t = _rel_transform(pa, pb)
    np.testing.assert_allclose(t, [1.0, 0.0, 0.0], atol=1e-12)


def test_good_edge_true_alias_edge_false():
    mapper, truth = _mapper_with_truth()
    g = mapper.graph
    # Good 2 m-separation edge: transform == truth relative transform.
    good_t = _rel_transform(truth[1], truth[5])
    g.add_constraint(1, 5, good_t, np.eye(3), switchable=True)
    # Alias edge: claims scan 7 sits right next to scan 0 (it is 3.5 m
    # away in truth) — a plausible small transform, wrong correspondence.
    g.add_constraint(0, 7, np.asarray([0.2, 0.0, 0.0]), np.eye(3),
                     switchable=True)
    # Odometry (non-switchable) edges must be ignored by the metric.
    pose_graph.make_constraint_np(g, 0, 1, np.eye(3) * 1e-3)

    rows = transform_error_rows(mapper, truth)
    assert len(rows) == 2
    by_pair = {(b, e): ok for b, e, _, _, ok in rows}
    assert by_pair[(1, 5)] is True
    assert by_pair[(0, 7)] is False
    errs = {(b, e): p for b, e, p, _, _ in rows}
    assert errs[(1, 5)] < 0.01
    assert abs(errs[(0, 7)] - 3.3) < 0.2   # |3.5 - 0.2| claimed vs truth


def test_angle_tolerance():
    mapper, truth = _mapper_with_truth()
    g = mapper.graph
    t = _rel_transform(truth[0], truth[6])
    g.add_constraint(0, 6, t + [0.0, 0.0, 0.2], np.eye(3), switchable=True)
    rows = transform_error_rows(mapper, truth)
    (b, e, pos_err, ang_err, ok), = rows
    assert pos_err < 0.01 and abs(ang_err - 0.2) < 1e-6 and not ok
