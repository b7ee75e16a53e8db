"""NDT scan matching: the exhaustive 3-DoF candidate search as one batched op.

The reference's hot loop (ScanMatcherNDT::matchScan,
src/scan_matcher_ndt.cpp:76-149) evaluates, with default parameters,
80 angles x 20 x 20 translations = 32 000 candidate poses x <=100 subsampled
beams sequentially on one CPU core.  Here the whole candidate grid is scored
as a single fused XLA computation on the device: rotate the subsampled beams
once per angle, broadcast the translation offsets, gather the packed NDT cell
table, evaluate the Gaussian quadratic forms, and reduce.  The
best-candidate argmin and the Olson-style covariance over the full search
distribution (src/scan_matcher_ndt.cpp:136-146) reduce on-chip as well.

Semantics match the reference:
* stride subsampling to ``laser_max_beams`` (src/scan_matcher_ndt.cpp:94-101),
* search lattice ``for (v=-size; v<size; v+=res)`` per axis,
* candidate score = -sum of cell likelihoods; best strictly below 0.0 wins,
  else the correction stays (0,0,0) (best_score init, :83, :128-134),
* returned score is normalized by the number of subsampled beams (:148),
* covariance = K/s + u u^T / s^2 over all candidates (:136-146).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ndt_2d_tpu.config import ScanMatcherConfig
from ndt_2d_tpu.ndt import grid as ndt_grid


class MatchResult(NamedTuple):
    score: jnp.ndarray        # scalar: best candidate score / beams used
    correction: jnp.ndarray   # [3] (dx, dy, dtheta) to add to the scan pose
    covariance: jnp.ndarray   # [3, 3] Olson covariance of the search


def subsample(points, point_mask, num_points, max_beams: int):
    """Stride-subsample a padded scan to ``max_beams`` slots.

    Mirrors src/scan_matcher_ndt.cpp:94-101: ``used = min(max_beams, n)``,
    ``step = n / used``, ``idx_i = floor(i * step)``.  Returns
    (points [max_beams, 2], mask [max_beams], used).
    """
    n = num_points.astype(jnp.float32)
    used = jnp.minimum(jnp.int32(max_beams), num_points)
    step = n / jnp.maximum(used, 1).astype(jnp.float32)
    i = jnp.arange(max_beams, dtype=jnp.float32)
    idx = jnp.minimum((i * step).astype(jnp.int32), num_points - 1)
    idx = jnp.clip(idx, 0, points.shape[0] - 1)
    mask = (jnp.arange(max_beams) < used) & point_mask[idx]
    return points[idx], mask, used


@functools.partial(jax.jit, static_argnames=("config",))
def window_origin(config: ScanMatcherConfig, poses, window_mask, range_max):
    """Grid origin for a scan window: min pose - range_max per axis.

    Mirrors ScanMatcherNDT::addScans' bounding box (src/scan_matcher_ndt.cpp:52-67);
    the extent itself is static (config.grid_cells_*) instead of dynamic.
    """
    big = jnp.asarray(jnp.finfo(poses.dtype).max, poses.dtype)
    xy = jnp.where(window_mask[:, None], poses[:, :2], big)
    return jnp.min(xy, axis=0) - range_max


def _grid_slice(grid: ndt_grid.NDTGrid, i: int) -> ndt_grid.NDTGrid:
    """Grid #i of a stacked (overlapping) NDT grid."""
    return jax.tree.map(lambda x: x[i], grid)


def is_multi_grid(grid: ndt_grid.NDTGrid) -> bool:
    """True for the 4-stacked overlapping-grids representation."""
    return grid.mean.ndim == 3


@functools.partial(jax.jit, static_argnames=("config",))
def build_window_ndt(config: ScanMatcherConfig, poses, points, point_mask,
                     window_mask, range_max) -> ndt_grid.NDTGrid:
    """Build the window NDT (ScanMatcherNDT::addScans, src/scan_matcher_ndt.cpp:49-74).

    With config.overlapping_grids, returns a stacked NDTGrid (leading axis 4)
    whose origins are shifted by half a cell in (x, y, xy) — the Biber-paper
    overlapping-grid scheme the reference omits (README.md:114-118).

    Args:
      poses: [S, 3]; points: [S, P, 2] robot-frame; point_mask: [S, P];
      window_mask: [S] which scans participate; range_max: scalar.
    """
    origin = window_origin(config, poses, window_mask, range_max)
    mask = point_mask & window_mask[:, None]
    if config.overlapping_grids:
        h = 0.5 * config.ndt_resolution
        offs = jnp.asarray([[0.0, 0.0], [h, 0.0], [0.0, h], [h, h]],
                           poses.dtype)
        return jax.vmap(
            lambda o: ndt_grid.build_ndt_from_scans(
                poses, points, mask, o, config.ndt_resolution,
                config.grid_cells_x, config.grid_cells_y)
        )(origin[None, :] - offs)
    return ndt_grid.build_ndt_from_scans(
        poses, points, mask, origin, config.ndt_resolution,
        config.grid_cells_x, config.grid_cells_y)


def _search_offsets(config: ScanMatcherConfig, dtype=jnp.float32):
    """The candidate lattice: angles [A], linear offsets [L] (both axes)."""
    a = (-config.search_angular_size
         + jnp.arange(config.num_angles, dtype=dtype)
         * config.search_angular_resolution)
    l = (-config.search_linear_size
         + jnp.arange(config.num_linear, dtype=dtype)
         * config.search_linear_resolution)
    return a, l


def prepare_neighborhood(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                         spts, smask, pose, dths, dls, table=None):
    """Precompute per-(angle, beam) scoring operands with ONE row-gather.

    Returns (bx, by, cross_x, cross_y [A, B]; pack [A, B, 24]; bounds
    (x_lo, x_hi, y_lo, y_hi) scalars) where pack holds the 2x2 neighborhood
    records (mean_x, mean_y, i00, i01, i11, ok) in y-major order.

    The whole 2x2 patch lives in ONE [H*W, 32] table row
    (ndt.grid.packed_patch_table), so the neighborhood fetch is a single
    row-gather per (angle, beam) of one 128-byte row, instead of four
    [H*W, 8] row-gathers or a multi-dim (2, 2, 8) slice-gather.  At 160^2
    cells the table is about 3.3 MB.

    The patch base index clips to [0, W-2] x [0, H-2] so every row read is
    in-grid; candidates outside the grid MUST be masked by the returned
    ``bounds`` in the selection phase (out-of-grid candidates may
    geometrically select an in-grid patch column near the edges).

    Args:
      table: optional prebuilt packed_patch_table(grid, W); pass it when
        the grid is static across many matches (e.g. the localization
        global NDT) so the table isn't re-materialized inside every
        dispatch.
    """
    W, H = config.grid_cells_x, config.grid_cells_y
    th = pose[2] + dths
    c, s = jnp.cos(th)[:, None], jnp.sin(th)[:, None]
    px, py = spts[:, 0][None, :], spts[:, 1][None, :]
    bx = c * px - s * py + pose[0]
    by = s * px + c * py + pose[1]

    cell = grid.cell_size
    ix0 = jnp.floor((bx + dls[0] - grid.origin[0]) / cell).astype(jnp.int32)
    iy0 = jnp.floor((by + dls[0] - grid.origin[1]) / cell).astype(jnp.int32)
    ixc = jnp.clip(ix0, 0, W - 2)
    iyc = jnp.clip(iy0, 0, H - 2)
    cross_x = grid.origin[0] + (ixc.astype(bx.dtype) + 1.0) * cell
    cross_y = grid.origin[1] + (iyc.astype(by.dtype) + 1.0) * cell

    flat = iyc * W + ixc                                   # [A, B]
    if table is None:
        table = ndt_grid.packed_patch_table(grid, W)       # [H*W, 32]
    nb = table[flat]                                       # [A, B, 32]
    nb = nb.reshape(nb.shape[0], nb.shape[1], 2, 2, 8)     # y-major 2x2

    ok = (nb[..., 5] > 0.5) & smask[None, :, None, None]
    pack = jnp.concatenate([nb[..., :5], ok[..., None].astype(nb.dtype)],
                           axis=-1)                        # [A, B, 2, 2, 6]
    a, b = pack.shape[0], pack.shape[1]
    bounds = (grid.origin[0], grid.origin[0] + W * cell,
              grid.origin[1], grid.origin[1] + H * cell)
    return bx, by, cross_x, cross_y, pack.reshape(a, b, 24), bounds


def candidate_scores(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                     spts, smask, pose, dths, dls, packed_table=None):
    """Score a block of candidate poses: [A_blk, L, L] negative likelihoods.

    The computational core of the search; the multichip matcher
    (ndt_2d_tpu.parallel.matcher) calls this per-device on an angle shard.

    Dispatches to a locality-exploiting fast path when the translation window
    fits inside one NDT cell (the default config: 0.1 m window vs 0.25 m
    cells): each (angle, beam) then touches at most 2x2 cells, so the gather
    count drops from A*L*L*B to A*B*4 (~100x) and the per-candidate work is
    pure dense VPU math.

    A stacked overlapping-grids NDT is scored as the MEAN over its grids —
    same scale as a single grid, so score gates/EWMA thresholds carry over.
    """
    if is_multi_grid(grid):
        n = grid.mean.shape[0]
        per = [
            _candidate_scores_one(
                config, _grid_slice(grid, i), spts, smask, pose, dths, dls,
                None if packed_table is None else packed_table[i])
            for i in range(n)
        ]
        return sum(per) / n
    return _candidate_scores_one(config, grid, spts, smask, pose, dths, dls,
                                 packed_table)


def _candidate_scores_one(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                          spts, smask, pose, dths, dls, packed_table=None):
    """candidate_scores for one (non-stacked) grid."""
    span = 2.0 * config.search_linear_size
    if span <= config.ndt_resolution:
        return _candidate_scores_local(config, grid, spts, smask, pose,
                                       dths, dls, packed_table)
    return _candidate_scores_gather(config, grid, spts, smask, pose,
                                    dths, dls)


def _candidate_scores_local(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                            spts, smask, pose, dths, dls, packed_table=None):
    """Fast path: per-(angle, beam) 2x2 cell neighborhood + dense selection.

    Exactly equivalent to the gather path whenever
    2*search_linear_size <= ndt_resolution (asserted by the dispatcher).
    The neighborhood fetch (the path's only gather) is prepare_neighborhood,
    shared with the Pallas kernel.
    """
    bx, by, cross_x, cross_y, pack24, bounds = prepare_neighborhood(
        config, grid, spts, smask, pose, dths, dls, table=packed_table)
    a, b = pack24.shape[0], pack24.shape[1]
    pack = pack24.reshape(a, b, 2, 2, 6)                  # [A, B, 2(y), 2(x), 6]

    # Candidate offsets: jx/jy pick which neighborhood cell each (dx, dy)
    # lands in.  [A, Lx, B] / [A, Ly, B] booleans.
    wxc = bx[:, None, :] + dls[None, :, None]             # [A, Lx, B]
    wyc = by[:, None, :] + dls[None, :, None]             # [A, Ly, B]
    jx = wxc >= cross_x[:, None, :]
    jy = wyc >= cross_y[:, None, :]
    jxf = jx[:, :, None, :, None]                         # [A, Lx, 1, B, 1]
    jyf = jy[:, None, :, :, None]                         # [A, 1, Ly, B, 1]
    # Grid-bounds mask at CANDIDATE level (the patch base was clipped, so
    # out-of-grid candidates can select in-grid patch data near the edges).
    x_lo, x_hi, y_lo, y_hi = bounds
    in_gx = ((wxc >= x_lo) & (wxc < x_hi))[:, :, None, :]  # [A, Lx, 1, B]
    in_gy = ((wyc >= y_lo) & (wyc < y_hi))[:, None, :, :]  # [A, 1, Ly, B]

    def sel(v):
        """Select per-candidate value from the 2x2 neighborhood.

        v: [A, B, 2(y), 2(x), ...] -> [A, Lx, Ly, B, ...]
        """
        v = v[:, None, None]                              # [A, 1, 1, B, 2, 2, ...]
        v00, v01 = v[..., 0, 0, :], v[..., 0, 1, :]
        v10, v11 = v[..., 1, 0, :], v[..., 1, 1, :]
        lo = jnp.where(jxf, v01, v00)
        hi = jnp.where(jxf, v11, v10)
        return jnp.where(jyf, hi, lo)

    psel = sel(pack)                                      # [A, Lx, Ly, B, 6]
    mx, my = psel[..., 0], psel[..., 1]
    i00, i01, i11 = psel[..., 2], psel[..., 3], psel[..., 4]
    valid = (psel[..., 5] > 0.5) & in_gx & in_gy          # smask folded in

    # Same candidate coordinates the bounds mask tested (wxc/wyc), in the
    # [A, Lx, Ly, B] layout.
    qx = wxc[:, :, None, :] - mx
    qy = wyc[:, None, :, :] - my
    e = -0.5 * (i00 * qx * qx + 2.0 * i01 * qx * qy + i11 * qy * qy)
    pt_scores = jnp.where(valid, jnp.exp(jnp.minimum(e, 0.0)), 0.0)
    return -jnp.sum(pt_scores, axis=-1)


def _candidate_scores_gather(config: ScanMatcherConfig,
                             grid: ndt_grid.NDTGrid, spts, smask, pose,
                             dths, dls):
    """General path: direct per-candidate cell gather (any window size)."""
    W, H = config.grid_cells_x, config.grid_cells_y
    # Rotate once per angle (outer loop of the reference), then broadcast
    # translations: world point = R(theta+dth) p + pose_xy + (dx, dy).
    th = pose[2] + dths                                   # [A]
    c, s = jnp.cos(th)[:, None], jnp.sin(th)[:, None]     # [A, 1]
    px, py = spts[:, 0][None, :], spts[:, 1][None, :]     # [1, B]
    rx = c * px - s * py + pose[0]                        # [A, B]
    ry = s * px + c * py + pose[1]

    # Candidate world positions [A, L(dx), L(dy), B]
    wx = rx[:, None, None, :] + dls[None, :, None, None]
    wy = ry[:, None, None, :] + dls[None, None, :, None]

    # Cell lookup + Gaussian score (NDT::likelihood per point).
    ix = jnp.floor((wx - grid.origin[0]) / grid.cell_size).astype(jnp.int32)
    iy = jnp.floor((wy - grid.origin[1]) / grid.cell_size).astype(jnp.int32)
    inb = (ix >= 0) & (iy >= 0) & (ix < W) & (iy < H)
    flat = jnp.where(inb, jnp.clip(iy, 0, H - 1) * W + jnp.clip(ix, 0, W - 1), 0)

    mean = grid.mean[flat]                                # [A, L, L, B, 2]
    info = grid.information[flat]                         # [A, L, L, B, 3]
    scorable = grid.count[flat] >= 5
    qx = wx - mean[..., 0]
    qy = wy - mean[..., 1]
    e = -0.5 * (info[..., 0] * qx * qx + 2.0 * info[..., 1] * qx * qy
                + info[..., 2] * qy * qy)
    # Clamp like ndt.grid.score_points: guards against float32 round-off
    # making a floored information matrix slightly indefinite.
    pt_scores = jnp.where(inb & scorable & smask[None, None, None, :],
                          jnp.exp(jnp.minimum(e, 0.0)), 0.0)

    # Candidate scores: negative likelihood sum (lower is better).
    return -jnp.sum(pt_scores, axis=-1)                   # [A, L, L]


def reduce_candidates(cand, dths, dls):
    """Best-candidate + Olson covariance reduction over a candidate block.

    Returns (best, correction [3], k [3,3], u [3], s) — k/u/s are the raw
    covariance accumulators (src/scan_matcher_ndt.cpp:136-141) so that
    multi-device partial reductions can be psum'd before the final divide.
    """
    a, l = cand.shape[0], cand.shape[1]
    flat_cand = cand.reshape(-1)
    best_idx = jnp.argmin(flat_cand)
    best = flat_cand[best_idx]
    ai, xi, yi = jnp.unravel_index(best_idx, cand.shape)
    correction = jnp.where(
        best < 0.0,
        jnp.stack([dls[xi], dls[yi], dths[ai]]),
        jnp.zeros(3, cand.dtype))

    x = jnp.stack([jnp.broadcast_to(dls[None, :, None], (a, l, l)),
                   jnp.broadcast_to(dls[None, None, :], (a, l, l)),
                   jnp.broadcast_to(dths[:, None, None], (a, l, l))],
                  axis=-1)  # [A, L, L, 3] candidate (dx, dy, dth)
    sw = cand[..., None]
    u = jnp.sum(x * sw, axis=(0, 1, 2))                   # [3]
    k = jnp.sum(x[..., :, None] * x[..., None, :] * sw[..., None],
                axis=(0, 1, 2))
    s = jnp.sum(cand)
    return best, correction, k, u, s


def finalize_match(best, correction, k, u, s, used) -> MatchResult:
    """Olson covariance (cov = K/s + u u^T / s^2) + per-beam normalization.

    A search where NO candidate scored any point (s == 0: the window NDT has
    no >=5-point cells under the scan, e.g. sparse beams or a degenerate
    window) would divide by zero here.  The reference computes the same
    expressions and returns inf/NaN covariance in that case
    (scan_matcher_ndt.cpp:136-146), which poisons the constraint information
    matrix and later the whole solve; we return a weak isotropic covariance
    instead (1 m^2, 0.25 rad^2 — ~4 orders of magnitude weaker than a real
    match's Olson scale), so the odometry edge still connects the chain but
    carries ~zero weight.
    """
    ok = s < 0.0  # candidate scores are <= 0; s == 0 means nothing scored
    safe = jnp.where(ok, s, -1.0)
    covariance = k / safe + (u[:, None] * u[None, :]) / (safe * safe)
    fallback = jnp.diag(jnp.asarray([1.0, 1.0, 0.25], best.dtype))
    covariance = jnp.where(ok, covariance, fallback)
    used_f = jnp.maximum(used, 1).astype(best.dtype)
    return MatchResult(score=best / used_f, correction=correction,
                       covariance=covariance)


@functools.partial(jax.jit, static_argnames=("config",))
def match_scan(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid, points,
               point_mask, num_points, pose, range_max,
               packed_table=None) -> MatchResult:
    """Exhaustive 3-DoF search of one scan against the window NDT.

    Args:
      grid: the window NDT (from build_window_ndt).
      points: [P, 2] robot-frame scan points (padded), point_mask: [P],
      num_points: scalar int, pose: [3] current scan pose estimate.
      packed_table: optional prebuilt packed_patch_table(grid, W) for static
        grids matched many times (see prepare_neighborhood).
    """
    del range_max  # part of the signature for symmetry; unused here
    B = config.laser_max_beams
    spts, smask, used = subsample(points, point_mask, num_points, B)
    dths, dls = _search_offsets(config, spts.dtype)
    cand = candidate_scores(config, grid, spts, smask, pose, dths, dls,
                            packed_table)
    best, correction, k, u, s = reduce_candidates(cand, dths, dls)
    res = finalize_match(best, correction, k, u, s, used)
    if config.refine_iterations > 0:
        # Newton polish: continuous ascent of the score surface from the
        # lattice winner (never worse than it; matching/newton.py).
        from ndt_2d_tpu.matching import newton
        refined, best_f = newton.refine_pose(
            config, grid, spts, smask, pose + res.correction,
            config.refine_iterations)
        used_f = jnp.maximum(used, 1).astype(best_f.dtype)
        res = MatchResult(score=best_f / used_f, correction=refined - pose,
                          covariance=res.covariance)
    return res


@functools.partial(jax.jit, static_argnames=("config",))
def score_points_at_pose(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                         points, point_mask, num_points, pose):
    """ScanMatcherNDT::scorePoints (src/scan_matcher_ndt.cpp:156-178).

    Transforms the (subsampled) points by ``pose`` and returns the mean
    negative likelihood.
    """
    B = config.laser_max_beams
    spts, smask, used = subsample(points, point_mask, num_points, B)
    c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
    wx = c * spts[:, 0] - s * spts[:, 1] + pose[0]
    wy = s * spts[:, 0] + c * spts[:, 1] + pose[1]
    w = jnp.stack([wx, wy], axis=-1)
    if is_multi_grid(grid):
        n = grid.mean.shape[0]
        sc = sum(ndt_grid.score_points(_grid_slice(grid, i), w, smask,
                                       config.grid_cells_x,
                                       config.grid_cells_y)
                 for i in range(n)) / n
    else:
        sc = ndt_grid.score_points(grid, w, smask,
                                   config.grid_cells_x, config.grid_cells_y)
    return -jnp.sum(sc) / jnp.maximum(used, 1).astype(w.dtype)


@functools.partial(jax.jit, static_argnames=("config",))
def score_points_batch(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                       points, point_mask, num_points, poses):
    """Vectorized scorePoints over a batch of poses [N, 3].

    This is the particle-filter measurement model: all particles score the
    same scan against the global NDT in one batched gather+exp
    (replaces the per-particle loop at src/particle_filter.cpp:81-88).
    """
    fn = jax.vmap(lambda p: score_points_at_pose(
        config, grid, points, point_mask, num_points, p))
    return fn(poses)




@functools.partial(jax.jit, static_argnames=("config",))
def match_scan_windowed(config: ScanMatcherConfig, poses, points, point_mask,
                        window_mask, range_max, scan_points, scan_mask,
                        num_points, pose):
    """Fused per-scan device step: window-NDT build + uncorrected score +
    exhaustive match in ONE dispatch.

    The mapper's hot path (ndt_mapper.cpp:504-515 does addScans + scoreScan +
    matchScan back-to-back every accepted scan); fusing them keeps the whole
    thing on-device with a single host round-trip.
    Returns (uncorrected_score, MatchResult).
    """
    grid = build_window_ndt(config, poses, points, point_mask, window_mask,
                            range_max)
    uncorrected = score_points_at_pose(config, grid, scan_points, scan_mask,
                                       num_points, pose)
    res = match_scan(config, grid, scan_points, scan_mask, num_points, pose,
                     range_max)
    return uncorrected, res

class RollingWindow(NamedTuple):
    """Device-resident rolling scan window (newest scan in the last slot).

    The reference rebuilds its local matcher from the last ``rolling_depth``
    graph scans on every accepted scan (ndt_mapper.cpp:504-509), shipping all
    window data each time.  Keeping the window on device turns the per-scan
    host->device traffic into a single small append (the new scan only) and
    keeps every jit signature canonical, so the fused match step compiles
    exactly once per session.
    """

    poses: jnp.ndarray       # [D, 3] float32
    points: jnp.ndarray      # [D, P, 2] float32
    point_mask: jnp.ndarray  # [D, P] bool
    mask: jnp.ndarray        # [D] bool


def make_window(depth: int, max_points: int) -> RollingWindow:
    return RollingWindow(
        poses=jnp.zeros((depth, 3), jnp.float32),
        points=jnp.zeros((depth, max_points, 2), jnp.float32),
        point_mask=jnp.zeros((depth, max_points), bool),
        mask=jnp.zeros((depth,), bool))


@functools.partial(jax.jit, donate_argnums=(0,))
def window_append(window: RollingWindow, pose, points,
                  point_mask) -> RollingWindow:
    """Shift the window left and place the new scan in the last slot."""
    one = jnp.ones((1,), bool)
    return RollingWindow(
        poses=jnp.concatenate([window.poses[1:], pose[None]]),
        points=jnp.concatenate([window.points[1:], points[None]]),
        point_mask=jnp.concatenate([window.point_mask[1:], point_mask[None]]),
        mask=jnp.concatenate([window.mask[1:], one]))


@functools.partial(jax.jit, static_argnames=("config",))
def match_scan_batch(config: ScanMatcherConfig, poses, points, point_mask,
                     window_mask, range_max, scan_points, scan_mask,
                     num_points, start_poses):
    """Loop-closure confirmation: K candidate-window builds + matches in ONE
    dispatch.

    The reference confirms loop-closure candidates one at a time — per
    candidate it rebuilds the global matcher's NDT from a 2-scan region and
    runs the exhaustive search (src/ndt_mapper.cpp:623-663).  Here all K
    candidate windows build and match as a single vmapped device program, so
    a whole loop-closure pass costs one dispatch + one fetch regardless of K
    (two in descriptor mode: coarse then fine).

    Args:
      poses: [K, S, 3] candidate-window scan poses (S = region size, 2 for
        reference parity); points: [K, S, P, 2]; point_mask: [K, S, P];
      window_mask: [K, S] (all-False rows are padding: their empty grids
        score 0 and never pass the acceptance gate);
      scan_points / scan_mask / num_points: the ONE query scan, shared by
        every candidate; start_poses: [K, 3] per-candidate start pose.
    Returns (scores [K], corrections [K, 3], covariances [K, 3, 3]).
    """
    def one(p, pt, pm, wm, st):
        grid = build_window_ndt(config, p, pt, pm, wm, range_max)
        return match_scan(config, grid, scan_points, scan_mask, num_points,
                          st, range_max)
    res = jax.vmap(one)(poses, points, point_mask, window_mask, start_poses)
    return res.score, res.correction, res.covariance


@functools.partial(jax.jit, static_argnames=("coarse_config", "fine_config"))
def match_scan_batch_coarse_fine(coarse_config: ScanMatcherConfig,
                                 fine_config: ScanMatcherConfig, poses,
                                 points, point_mask, window_mask, range_max,
                                 scan_points, scan_mask, num_points,
                                 start_poses):
    """Descriptor-mode confirmation: coarse-to-fine match of K candidate
    windows fused into ONE dispatch.

    Per candidate: build the coarse NDT, run the wide coarse lattice (to
    absorb odometry drift), then build the fine NDT and run the fine search
    from the coarse-corrected start.  Returns (fine_starts [K, 3],
    scores [K], corrections [K, 3], covariances [K, 3, 3]) where
    fine_starts = start + coarse correction (the pose the fine correction is
    relative to).
    """
    def one(p, pt, pm, wm, st):
        cgrid = build_window_ndt(coarse_config, p, pt, pm, wm, range_max)
        cres = match_scan(coarse_config, cgrid, scan_points, scan_mask,
                          num_points, st, range_max)
        st2 = st + cres.correction
        fgrid = build_window_ndt(fine_config, p, pt, pm, wm, range_max)
        fres = match_scan(fine_config, fgrid, scan_points, scan_mask,
                          num_points, st2, range_max)
        return st2, fres.score, fres.correction, fres.covariance
    return jax.vmap(one)(poses, points, point_mask, window_mask, start_poses)


@functools.partial(jax.jit, static_argnames=("config",))
def match_scan_batch_multi(config: ScanMatcherConfig, poses, points,
                           point_mask, window_mask, range_max, query_points,
                           query_mask, query_num, start_poses):
    """match_scan_batch generalized to one query scan PER ROW.

    A whole loop-closure pass confirms many pending query scans; batching
    them into one dispatch (rows = every (query, candidate) pair of the
    pass) replaces Q per-query dispatches with one device program — the
    per-dispatch latency stops scaling with the pass size.

    Args are match_scan_batch's plus per-row query arrays:
      query_points [N, P, 2], query_mask [N, P], query_num [N].
    Returns (scores [N], corrections [N, 3], covariances [N, 3, 3]); each
    row's result is bitwise identical to the same row through
    match_scan_batch (independent vmap lanes).
    """
    def one(p, pt, pm, wm, qp, qm, qn, st):
        grid = build_window_ndt(config, p, pt, pm, wm, range_max)
        return match_scan(config, grid, qp, qm, qn, st, range_max)
    res = jax.vmap(one)(poses, points, point_mask, window_mask, query_points,
                        query_mask, query_num, start_poses)
    return res.score, res.correction, res.covariance


@functools.partial(jax.jit, static_argnames=("coarse_config", "fine_config"))
def match_scan_batch_multi_coarse_fine(coarse_config: ScanMatcherConfig,
                                       fine_config: ScanMatcherConfig, poses,
                                       points, point_mask, window_mask,
                                       range_max, query_points, query_mask,
                                       query_num, start_poses):
    """Multi-query coarse-to-fine confirmation in one dispatch.

    The far-candidate arm of a confirmation pass: every row's start pose
    carries unknown odometry drift, so the wide coarse lattice aligns
    first, then the fine match scores from the coarse-corrected start.
    (Near rows — start already within the radius-search reach — go through
    match_scan_batch_multi instead; the host splits the pass into the two
    segments, so the coarse build + search is never spent where drift
    cannot require it.)
    Returns (fine_starts [N, 3], scores [N], corrections [N, 3],
    covariances [N, 3, 3]).
    """
    def one(p, pt, pm, wm, qp, qm, qn, st):
        cgrid = build_window_ndt(coarse_config, p, pt, pm, wm, range_max)
        cres = match_scan(coarse_config, cgrid, qp, qm, qn, st, range_max)
        st2 = st + cres.correction
        fgrid = build_window_ndt(fine_config, p, pt, pm, wm, range_max)
        fres = match_scan(fine_config, fgrid, qp, qm, qn, st2, range_max)
        return st2, fres.score, fres.correction, fres.covariance
    return jax.vmap(one)(poses, points, point_mask, window_mask,
                         query_points, query_mask, query_num, start_poses)


@functools.partial(jax.jit, static_argnames=("config",))
def match_scan_with_score(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                          scan_points, scan_mask, num_points, pose,
                          packed_table=None):
    """Fused scoreScan + matchScan against a prebuilt (global) grid.

    The scan-match localization branch runs both back-to-back every scan
    (ndt_mapper.cpp:556-558); fusing keeps it at one dispatch + one fetch.
    Returns (uncorrected_score, score, correction, covariance).
    """
    unc = score_points_at_pose(config, grid, scan_points, scan_mask,
                               num_points, pose)
    res = match_scan(config, grid, scan_points, scan_mask, num_points, pose,
                     jnp.float32(0.0), packed_table)
    return unc, res.score, res.correction, res.covariance


@functools.partial(jax.jit, static_argnames=("config",))
def match_scan_rolling(config: ScanMatcherConfig, window: RollingWindow,
                       range_max, scan_points, scan_mask, num_points, pose):
    """match_scan_windowed over a device-resident RollingWindow, returning a
    flat result so the host fetches everything in one device_get."""
    unc, res = match_scan_windowed(
        config, window.poses, window.points, window.point_mask, window.mask,
        range_max, scan_points, scan_mask, num_points, pose)
    return unc, res.score, res.correction, res.covariance


@functools.partial(jax.jit, static_argnames=("config",), donate_argnums=(1, 2))
def mapping_step_async(config: ScanMatcherConfig, window: RollingWindow,
                       prev_pose, range_max, points, mask, num_points,
                       delta):
    """Fully device-resident mapping step for the pipelined host loop.

    The synchronous path (match_scan_rolling) forces one host round-trip per
    scan because the host dead-reckons the next start pose from the fetched
    correction.  Keeping the pose chain ON DEVICE breaks that dependency:
    dead-reckon from the device-resident previous pose, match, apply the
    correction, append the corrected scan to the window — one dispatch, and
    the host never has to block (results drain asynchronously;
    mapping/mapper.py pipelined path).  That turns a one-round-trip-per-scan
    loop into an overlap-limited one.

    Args:
      prev_pose: [3] device-resident previous corrected robot pose.
      delta: [3] odometry motion since the previous scan, expressed in the
        previous ROBOT frame (host computes it from consecutive odometry
        poses alone — R(-odom_th0)·(xy1-xy0) — so it needs no device state;
        composing it onto prev_pose reproduces ndt_mapper.cpp:357-364).
    Returns (window', pose', results (unc, score, corr, cov, pose')).
    """
    c, s = jnp.cos(prev_pose[2]), jnp.sin(prev_pose[2])
    th = prev_pose[2] + delta[2]
    pose = jnp.stack([prev_pose[0] + c * delta[0] - s * delta[1],
                      prev_pose[1] + s * delta[0] + c * delta[1],
                      jnp.arctan2(jnp.sin(th), jnp.cos(th))])
    unc, res = match_scan_windowed(
        config, window.poses, window.points, window.point_mask, window.mask,
        range_max, points, mask, num_points, pose)
    new_pose = pose + res.correction
    window2 = window_append(window, new_pose, points, mask)
    return window2, new_pose, (unc, res.score, res.correction,
                               res.covariance, new_pose)


@functools.partial(jax.jit, static_argnames=("config",), donate_argnums=(2,))
def localization_step_async(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                            prev_pose, points, mask, num_points, delta,
                            packed_table=None):
    """Scan-match localization step with the pose chain ON DEVICE.

    The synchronous branch (match_scan_with_score) blocks one host round
    trip per scan to learn the correction before dead-reckoning the next
    start pose (ndt_mapper.cpp:547-566).  Composing the odometry motion onto
    a device-resident previous pose removes that dependency; results drain
    asynchronously (mapping/mapper.py pipelined path).

    Args:
      delta: [3] odometry motion since the previous scan in the previous
        ROBOT frame (see mapping_step_async).
    Returns (pose', results (unc, score, correction, pose')).
    """
    c, s = jnp.cos(prev_pose[2]), jnp.sin(prev_pose[2])
    th = prev_pose[2] + delta[2]
    pose = jnp.stack([prev_pose[0] + c * delta[0] - s * delta[1],
                      prev_pose[1] + s * delta[0] + c * delta[1],
                      jnp.arctan2(jnp.sin(th), jnp.cos(th))])
    unc = score_points_at_pose(config, grid, points, mask, num_points, pose)
    res = match_scan(config, grid, points, mask, num_points, pose,
                     jnp.float32(0.0), packed_table)
    new_pose = pose + res.correction
    return new_pose, (unc, res.score, res.correction, new_pose)


# Module-level jits: stable function identity so repeated add_scans calls hit
# the trace cache instead of retracing (a fresh jit(vmap(...)) per call would
# recompile every time).
_PACK_SINGLE = jax.jit(ndt_grid.packed_patch_table, static_argnums=(1,))
_PACK_MULTI = jax.jit(jax.vmap(ndt_grid.packed_patch_table,
                               in_axes=(0, None)), static_argnums=(1,))


class NDTScanMatcher:
    """Host-side stateful wrapper mirroring the ScanMatcher plugin interface.

    The reference's abstract interface (include/ndt_2d/scan_matcher.hpp:42-91):
    initialize / addScans / matchScan / scoreScan / scorePoints / reset.
    Construction happens through ``ndt_2d_tpu.matching.registry`` the way the
    reference loads matchers by type string via pluginlib.
    """

    def __init__(self, config: ScanMatcherConfig, range_max: float):
        self.config = config
        self.range_max = float(range_max)
        self.grid: Optional[ndt_grid.NDTGrid] = None
        # Packed scoring table cached per add_scans: the grid is static
        # across all subsequent matches (e.g. the localization global NDT),
        # so the [H*W, 8] stack shouldn't be re-materialized per dispatch.
        self.packed_table = None

    def add_scans(self, poses, points, point_mask, window_mask=None):
        poses = jnp.asarray(poses)
        if window_mask is None:
            window_mask = jnp.ones(poses.shape[0], bool)
        # Host-side capacity check (the reference sizes its grid dynamically;
        # ours is static, so verify the window fits).
        wp = np.asarray(poses)[np.asarray(window_mask)]
        if wp.size:
            span = wp[:, :2].max(0) - wp[:, :2].min(0) + 2 * self.range_max
            need = np.ceil(span / self.config.ndt_resolution) + 1
            if (need[0] > self.config.grid_cells_x
                    or need[1] > self.config.grid_cells_y):
                raise ValueError(
                    f"scan window needs {need} cells > static grid "
                    f"({self.config.grid_cells_x}, {self.config.grid_cells_y}); "
                    "increase ScanMatcherConfig.grid_cells_*")
        self.grid = build_window_ndt(self.config, poses, jnp.asarray(points),
                                     jnp.asarray(point_mask), window_mask,
                                     self.range_max)
        pack = (_PACK_MULTI if is_multi_grid(self.grid) else _PACK_SINGLE)
        self.packed_table = pack(self.grid, self.config.grid_cells_x)

    def match_scan(self, points, point_mask, num_points, pose) -> MatchResult:
        if self.grid is None:  # "Scans must be added first" (:80)
            return MatchResult(jnp.zeros(()), jnp.zeros(3), jnp.zeros((3, 3)))
        return match_scan(self.config, self.grid, jnp.asarray(points),
                          jnp.asarray(point_mask), jnp.asarray(num_points),
                          jnp.asarray(pose), self.range_max,
                          self.packed_table)

    def score_points(self, points, point_mask, num_points, pose):
        if self.grid is None:
            return jnp.zeros(())
        return score_points_at_pose(self.config, self.grid,
                                    jnp.asarray(points),
                                    jnp.asarray(point_mask),
                                    jnp.asarray(num_points), jnp.asarray(pose))

    def reset(self):
        self.grid = None
        self.packed_table = None
