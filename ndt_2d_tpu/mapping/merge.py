"""Multi-session map merge: align and fuse two saved maps into one graph.

No reference equivalent — the ROS package can load only one map per node.
The merge reuses the framework's own machinery end-to-end:

1. **Candidate pairs** — rotation-invariant descriptors for every keyframe
   of both maps (parallel.loop_search.descriptors, one matmul), cross
   cosine-similarity [Na, Nb], top-K pairs above a similarity floor.
2. **Confirmation** — per pair (i, j): build a 2-slot NDT window around
   map A's scan i (the loop-closure window shape, ndt_mapper.cpp:627-631)
   and register map B's scan j against it coarse-to-fine.  Unlike in-session
   loop closure, the relative HEADING between two sessions is arbitrary, so
   the coarse lattice spans the full +-pi angle range (a ~200k-candidate
   exhaustive search — cheap on the GPU, impossible in the reference's
   per-candidate C++ loop).
3. **Consistency** — every confirmed pair votes an SE(2) alignment
   T_ab = pose_j_in_a o inverse(pose_j_in_b); the largest mutually
   consistent subset wins (rejects aliased matches in self-similar
   buildings), and needs >= min_matches members.
4. **Fusion** — B's scans are appended with poses T_ab o pose_b, B's
   internal odometry/loop constraints carry over (relative transforms are
   frame-invariant), each surviving match becomes a switchable cross-map
   constraint with the match covariance, and one joint LM solve polishes
   the seam.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu.core import pose as pose_ops
from ndt_2d_tpu.graph import solver
from ndt_2d_tpu.graph.pose_graph import Graph

logger = logging.getLogger(__name__)


def _round32(x: float) -> int:
    return int(-(-x // 32) * 32)


def _coarse_config(range_max: float, window_span: float) -> ScanMatcherConfig:
    """Full-heading coarse lattice for cross-session registration.

    Grids are sized from the actual confirmation-window pose spread (sparse
    keyframes can spread a 7-scan window arbitrarily wide) — a hardcoded
    span would abort the merge with a capacity error on such maps.
    """
    span = window_span + 4.0 + 2.0 * range_max
    cells = _round32(span / 0.5)
    return ScanMatcherConfig(
        ndt_resolution=0.5, search_linear_size=2.0,
        search_linear_resolution=0.1,
        search_angular_size=np.pi, search_angular_resolution=0.05,
        grid_cells_x=cells, grid_cells_y=cells)


def _fine_config(range_max: float, window_span: float) -> ScanMatcherConfig:
    span = window_span + 4.0 + 2.0 * range_max
    cells = _round32(span / 0.25)
    return ScanMatcherConfig(grid_cells_x=cells, grid_cells_y=cells)


def _window(graph: Graph, i: int, half: int = 3):
    """Scans [i-half, i+half] as a fixed (2*half+1)-slot window.

    Wider than the in-session loop-closure window (2 slots,
    ndt_mapper.cpp:627-631): a cross-session query scan views the scene
    from an unrelated pose, so the window NDT needs enough coverage to
    explain most of its beams or even a perfect alignment scores weakly.
    """
    slots = 2 * half + 1
    begin = max(i - half, 0)
    end = min(i + half, graph.num_scans - 1)
    k = end - begin + 1
    poses = np.zeros((slots, 3), np.float32)
    pts = np.zeros((slots, graph.max_points, 2), np.float32)
    msk = np.zeros((slots, graph.max_points), bool)
    wmask = np.zeros(slots, bool)
    poses[:k] = graph.poses[begin:end + 1].astype(np.float32)
    pts[:k] = graph.points[begin:end + 1]
    msk[:k] = graph.point_mask[begin:end + 1]
    wmask[:k] = True
    return poses, pts, msk, wmask


@dataclasses.dataclass
class MergeResult:
    graph: Graph
    transform: np.ndarray          # SE(2) taking B-frame poses into A-frame
    pairs_checked: int
    pairs_accepted: int
    optimized: bool


def merge_maps(graph_a: Graph, graph_b: Graph, range_max: float,
               config: MapperConfig = MapperConfig(),
               top_k: int = 10, min_similarity: float = 0.9,
               score_threshold: float = -0.25, min_matches: int = 2,
               consistency_xy: float = 0.5,
               consistency_theta: float = 0.2) -> MergeResult:
    """Merge graph_b into graph_a's frame.  Raises ValueError if no
    consistent alignment is found."""
    import jax.numpy as jnp

    from ndt_2d_tpu.matching.matcher import NDTScanMatcher
    from ndt_2d_tpu.parallel import loop_search

    na, nb = graph_a.num_scans, graph_b.num_scans
    if not na or not nb:
        raise ValueError("both maps need scans to merge")
    if graph_a.max_points != graph_b.max_points:
        raise ValueError("maps were saved with different max_points_per_scan")

    # 1. Descriptor cross-similarity -> candidate pairs.
    da = loop_search.descriptors(jnp.asarray(graph_a.points),
                                 jnp.asarray(graph_a.point_mask),
                                 np.float32(range_max),
                                 config.descriptor_bins)
    db = loop_search.descriptors(jnp.asarray(graph_b.points),
                                 jnp.asarray(graph_b.point_mask),
                                 np.float32(range_max),
                                 config.descriptor_bins)
    sims = np.asarray(loop_search.cross_similarity(da, db))   # [Na, Nb]
    order = np.argsort(sims, axis=None)[::-1][:top_k]
    pairs = [(int(p // nb), int(p % nb)) for p in order
             if sims.flat[p] >= min_similarity]
    # Group pairs by A-scan so consecutive pairs sharing a confirmation
    # window reuse its built NDTs.
    pairs.sort()

    # Grid extent from the widest actual window (fixed per merge so the
    # match kernels compile once).
    window_span = 0.0
    for i, _ in pairs:
        poses, _, _, wmask = _window(graph_a, i)
        wp = poses[wmask]
        if len(wp):
            window_span = max(window_span,
                              float((wp[:, :2].max(0) - wp[:, :2].min(0)).max()))

    # 2. Coarse-to-fine confirmation of each pair.
    coarse = NDTScanMatcher(_coarse_config(range_max, window_span), range_max)
    fine = NDTScanMatcher(_fine_config(range_max, window_span), range_max)
    matches = []  # (i, j, pose_j_in_a [3], covariance [3,3], score)
    window_i = None
    for i, j in pairs:
        if not graph_a.point_mask[i].any() or not graph_b.point_mask[j].any():
            continue
        if i != window_i:
            poses, pts, msk, wmask = _window(graph_a, i)
            try:
                coarse.add_scans(poses, pts, msk, wmask)
                fine.add_scans(poses, pts, msk, wmask)
            except ValueError as e:  # capacity: skip this window, not the merge
                logger.warning("merge: skipping window around A[%d]: %s", i, e)
                window_i = None
                continue
            window_i = i
        qpts = graph_b.points[j]
        qmask = graph_b.point_mask[j]
        nq = int(qmask.sum())
        # Start at A's candidate position; heading unknown -> the coarse
        # lattice covers the full +-pi range.
        start = graph_a.poses[i].copy()
        cres = coarse.match_scan(qpts, qmask, nq, start.astype(np.float32))
        start = start + np.asarray(cres.correction, np.float64)
        fres = fine.match_scan(qpts, qmask, nq, start.astype(np.float32))
        score = float(fres.score)
        if np.isfinite(score) and score < score_threshold:
            pose_j_in_a = start + np.asarray(fres.correction, np.float64)
            matches.append((i, j, pose_j_in_a,
                            np.asarray(fres.covariance, np.float64), score))
            logger.info("merge match A[%d] <- B[%d] score %.3f", i, j, score)
        else:
            logger.info("merge reject A[%d] <- B[%d] score %.3f", i, j, score)

    # 3. Consistency vote on T_ab.  Consistency is evaluated at each match's
    # own location — "does transform k predict match m's registered pose?" —
    # NOT by comparing T translations directly, which would be lever-arm
    # amplified (a small heading difference times the distance of the
    # overlap from B's frame origin) and spuriously reject correct matches
    # on large maps.
    def t_ab(m):
        _, j, pja, _, _ = m
        return np.asarray(pose_ops.compose(
            jnp.asarray(pja), pose_ops.inverse(jnp.asarray(graph_b.poses[j]))))

    transforms = [t_ab(m) for m in matches]
    best_set = []
    for tk in transforms:
        jtk = jnp.asarray(tk)
        group = []
        for m in matches:
            _, j, pja, _, _ = m
            pred = np.asarray(pose_ops.compose(
                jtk, jnp.asarray(graph_b.poses[j])))
            if (np.hypot(*(pred[:2] - pja[:2])) < consistency_xy
                    and abs(float(pose_ops.normalize_angle(
                        pred[2] - pja[2]))) < consistency_theta):
                group.append(m)
        if len(group) > len(best_set):
            best_set = group
    if len(best_set) < min_matches:
        raise ValueError(
            f"map merge failed: {len(matches)} confirmed matches, largest "
            f"consistent set {len(best_set)} < min_matches={min_matches}")
    best_set.sort(key=lambda m: m[4])  # best (lowest) score first
    T = t_ab(best_set[0])

    # 4. Fuse into one graph.
    merged = Graph(max_points_per_scan=graph_a.max_points,
                   use_barycenter=graph_a.use_barycenter)
    for i in range(na):
        merged.add_scan(graph_a.poses[i], graph_a.points[i],
                        graph_a.point_mask[i])
    jT = jnp.asarray(T)
    for j in range(nb):
        pb = np.asarray(pose_ops.compose(jT, jnp.asarray(graph_b.poses[j])))
        merged.add_scan(pb, graph_b.points[j], graph_b.point_mask[j])
    for c in range(graph_a.num_constraints):
        merged.add_constraint(
            int(graph_a.constraint_begin[c]), int(graph_a.constraint_end[c]),
            graph_a.constraint_transform[c], graph_a.constraint_information[c],
            bool(graph_a.constraint_switchable[c]))
    for c in range(graph_b.num_constraints):
        merged.add_constraint(
            na + int(graph_b.constraint_begin[c]),
            na + int(graph_b.constraint_end[c]),
            graph_b.constraint_transform[c], graph_b.constraint_information[c],
            bool(graph_b.constraint_switchable[c]))
    # Cross-map constraints encode the MEASURED relative pose (the match),
    # not the current estimate (makeConstraint math, constraint.cpp:35-56).
    from ndt_2d_tpu.graph.pose_graph import make_constraint_np
    for i, j, pja, cov, _ in best_set:
        make_constraint_np(merged, i, na + j, cov, switchable=True,
                           measured_end_pose=pja)

    # 5. Joint solve (gauge-fixed to A's frame at node 0).
    optimized = solver.solve_graph(merged, config.solver)
    return MergeResult(graph=merged, transform=T,
                       pairs_checked=len(pairs), pairs_accepted=len(best_set),
                       optimized=bool(optimized))
