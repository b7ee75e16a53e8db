"""NDT grid: batched Gaussian cell statistics over a dense grid.

The reference builds the NDT one point at a time (``Cell::addPoint``,
src/ndt_model.cpp:50-63) and then finalizes each cell (``Cell::compute``,
src/ndt_model.cpp:65-103).  Here the whole grid is built in one shot:

* point->cell binning is a masked ``segment_sum`` scatter (all points of all
  window scans at once),
* per-cell covariance, eigenvalue flooring, and information matrices are
  computed for *all* cells as one batched closed-form 2x2 operation (no
  eigensolver: symmetric 2x2 eigenvalues are ``m +- sqrt(m^2 - det)``),
* scoring is a batched gather + quadratic form + exp.

Numerical semantics match the reference:
* incremental mean/correlation telescopes to ``sum/n`` exactly,
* covariance = (corr - mean mean^T) * n/(n-1)  (src/ndt_model.cpp:73-81),
* the small eigenvalue is floored at 0.001x the large one, in which case the
  information matrix uses determinant (0.001*large)*large
  (src/ndt_model.cpp:83-100),
* cells score 0 unless they hold >= 5 points (src/ndt_model.cpp:105-111), and
  statistics exist only for n >= 3 (src/ndt_model.cpp:68),
* out-of-grid points score 0 (src/ndt_model.cpp:162-170, :203-218).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Guard against division by an exactly-singular covariance (all cell points
# identical).  The reference inverts a zero matrix there and produces inf/NaN
# scores (src/ndt_model.cpp:99); we clamp instead, which only diverges from the
# reference in that degenerate case (and is strictly better behaved).
_DET_EPS = 1e-20


class NDTGrid(NamedTuple):
    """Dense NDT grid as structure-of-arrays.

    Row-major cell layout matches the reference: ``index = iy * W + ix``
    (src/ndt_model.cpp:203-218).

    Attributes:
      origin:      [2] world coords of grid min corner.
      cell_size:   scalar cell edge length (meters).
      mean:        [H*W, 2] per-cell Gaussian mean (world frame).
      information: [H*W, 3] packed symmetric inverse covariance
                   (i00, i01, i11).
      count:       [H*W] int32 number of points binned into the cell.
      covariance:  [H*W, 3] packed symmetric covariance (c00, c01, c11);
                   kept for introspection/tests.
    """

    origin: jnp.ndarray
    cell_size: jnp.ndarray
    mean: jnp.ndarray
    information: jnp.ndarray
    count: jnp.ndarray
    covariance: jnp.ndarray

    @property
    def num_cells(self) -> int:
        return self.mean.shape[0]


def cell_ij(origin, cell_size, points):
    """Raw (ix, iy) floor binning for [..., 2] world points."""
    rel = (points - origin) / cell_size
    ix = jnp.floor(rel[..., 0]).astype(jnp.int32)
    iy = jnp.floor(rel[..., 1]).astype(jnp.int32)
    return ix, iy


def cell_index(origin, cell_size, width, height, points):
    """Flat cell index + validity for [..., 2] world points.

    Matches NDT::getIndex (src/ndt_model.cpp:203-218): floor binning from the
    origin; anything left/below the origin or beyond the extent is invalid.
    """
    ix, iy = cell_ij(origin, cell_size, points)
    valid = (ix >= 0) & (iy >= 0) & (ix < width) & (iy < height)
    flat = jnp.clip(iy, 0, height - 1) * width + jnp.clip(ix, 0, width - 1)
    return flat, valid


def build_ndt(points, mask, origin, cell_size, width: int, height: int) -> NDTGrid:
    """Build an NDT grid from world-frame points in one scatter pass.

    Args:
      points: [N, 2] world-frame points (any padding allowed).
      mask:   [N] bool validity of each point.
      origin: [2] grid min corner.
      cell_size: scalar.
      width, height: static grid extent in cells.

    Replaces the reference's per-point Cell::addPoint / per-cell
    Cell::compute loops (src/ndt_model.cpp:50-103, :132-160).
    """
    num_cells = width * height
    origin = jnp.asarray(origin, points.dtype)
    cell_size = jnp.asarray(cell_size, points.dtype)

    flat, valid = cell_index(origin, cell_size, width, height, points)
    valid = valid & mask
    return build_ndt_binned(points, valid, flat, origin, cell_size,
                            num_cells)


def build_ndt_binned(points, valid, flat, origin, cell_size,
                     num_cells: int) -> NDTGrid:
    """Build cell statistics from precomputed (flat index, validity).

    Split out of build_ndt so sharded builders (parallel.ndt_blocks) can
    compute GLOBAL indices once and offset into their block — bitwise
    identical binning to the dense grid at stripe boundaries.
    """
    # Invalid points fall into a scratch bin that is sliced away.
    seg = jnp.where(valid, flat, num_cells)

    ones = valid.astype(points.dtype)
    x, y = points[..., 0], points[..., 1]
    # Moments: n, sum(x), sum(y), sum(xx), sum(xy), sum(yy)
    vals = jnp.stack([ones, x * ones, y * ones, x * x * ones,
                      x * y * ones, y * y * ones], axis=-1)
    moments = jax.ops.segment_sum(vals, seg, num_segments=num_cells + 1,
                                  indices_are_sorted=False)[:num_cells]

    n = moments[:, 0]
    n_safe = jnp.maximum(n, 1.0)
    mean = moments[:, 1:3] / n_safe[:, None]
    corr = moments[:, 3:6] / n_safe[:, None]          # (xx, xy, yy)/n

    # covariance = (corr - mean mean^T) * n/(n-1)   (src/ndt_model.cpp:73-81)
    scale = n / jnp.maximum(n - 1.0, 1.0)
    c00 = (corr[:, 0] - mean[:, 0] * mean[:, 0]) * scale
    c01 = (corr[:, 1] - mean[:, 0] * mean[:, 1]) * scale
    c11 = (corr[:, 2] - mean[:, 1] * mean[:, 1]) * scale

    # Closed-form symmetric 2x2 eigenvalues.
    half_tr = 0.5 * (c00 + c11)
    det = c00 * c11 - c01 * c01
    disc = jnp.sqrt(jnp.maximum(half_tr * half_tr - det, 0.0))
    large = half_tr + disc
    small = half_tr - disc

    # Eigenvalue floor: small >= 0.001 * large (src/ndt_model.cpp:83-100).
    floored = small < 0.001 * large
    det_used = jnp.where(floored, (0.001 * large) * large, det)
    det_used = jnp.where(jnp.abs(det_used) < _DET_EPS, _DET_EPS, det_used)
    inv = 1.0 / det_used
    i00 = c11 * inv
    i01 = -c01 * inv
    i11 = c00 * inv

    has_stats = n >= 3.0                              # src/ndt_model.cpp:68
    zeros = jnp.zeros_like(i00)
    information = jnp.stack([jnp.where(has_stats, i00, zeros),
                             jnp.where(has_stats, i01, zeros),
                             jnp.where(has_stats, i11, zeros)], axis=-1)
    covariance = jnp.stack([jnp.where(has_stats, c00, zeros),
                            jnp.where(has_stats, c01, zeros),
                            jnp.where(has_stats, c11, zeros)], axis=-1)

    return NDTGrid(origin=origin, cell_size=cell_size, mean=mean,
                   information=information, count=n.astype(jnp.int32),
                   covariance=covariance)


def build_ndt_from_scans(scan_poses, scan_points, point_mask, origin,
                         cell_size, width: int, height: int) -> NDTGrid:
    """Build an NDT from a window of scans (poses + robot-frame points).

    Equivalent to ScanMatcherNDT::addScans' NDT::addScan loop
    (src/scan_matcher_ndt.cpp:66-74) with the transform fused in.

    Args:
      scan_poses:  [S, 3], scan_points: [S, P, 2], point_mask: [S, P].
    """
    from ndt_2d_tpu.core import pose as pose_ops
    world = pose_ops.transform_points(scan_poses, scan_points)  # [S, P, 2]
    return build_ndt(world.reshape(-1, 2), point_mask.reshape(-1),
                     origin, cell_size, width, height)


def packed_cell_table(grid: NDTGrid):
    """[H*W, 8] packed per-cell scoring table.

    Columns: mean_x, mean_y, i00, i01, i11, scorable(0/1), 0, 0.
    One gather of this table feeds the candidate-scoring kernel; padding to 8
    keeps the minor dimension lane-friendly.
    """
    scorable = (grid.count >= 5).astype(grid.mean.dtype)  # src/ndt_model.cpp:107
    pad = jnp.zeros_like(scorable)
    return jnp.stack([grid.mean[:, 0], grid.mean[:, 1],
                      grid.information[:, 0], grid.information[:, 1],
                      grid.information[:, 2], scorable, pad, pad], axis=-1)


def packed_patch_table(grid: NDTGrid, width: int):
    """[H*W, 32] table whose row i packs the full 2x2 cell PATCH with cell i
    at the top-left: cells (i, i+1, i+width, i+width+1), each as the 8
    packed_cell_table fields.

    The candidate-scoring fast path fetches one 2x2 neighborhood per
    (angle, beam); with this layout that is ONE row-gather instead of four —
    measured 2.8x faster on the real chip (the kernel is gather-bound).
    Rows whose patch wraps past the grid edge contain out-of-row/column
    garbage in the wrapped slots; consumers must clip the patch base to
    [0, W-2] x [0, H-2] and mask candidates by grid bounds
    (matching/matcher.py::prepare_neighborhood).
    """
    t = packed_cell_table(grid)
    return jnp.concatenate(
        [t, jnp.roll(t, -1, 0), jnp.roll(t, -width, 0),
         jnp.roll(t, -(width + 1), 0)], axis=1)


def score_at_cells(mean_table, info_table, count_table, points, valid, flat):
    """Gaussian scores for points with precomputed cell bindings.

    Shared by the dense path (score_points) and the sharded-map path
    (parallel.ndt_blocks), which bins against global indices.
    """
    safe = jnp.where(valid, flat, 0)
    mean = mean_table[safe]
    info = info_table[safe]
    scorable = count_table[safe] >= 5
    q = points - mean
    qx, qy = q[..., 0], q[..., 1]
    e = -0.5 * (info[..., 0] * qx * qx + 2.0 * info[..., 1] * qx * qy
                + info[..., 2] * qy * qy)
    # A true Gaussian score never exceeds 1; clamping guards against float32
    # round-off making a floored information matrix slightly indefinite
    # (exp of a positive exponent would overflow to inf and poison the
    # matcher-score EWMA).
    s = jnp.exp(jnp.minimum(e, 0.0))
    return jnp.where(valid & scorable, s, 0.0)


def score_points(grid: NDTGrid, points, mask, width: int, height: int):
    """Per-point Gaussian likelihood scores for [..., 2] world points.

    exp(-0.5 q^T Lambda q) with q = p - mean (src/ndt_model.cpp:105-116);
    0 for out-of-grid points, masked points, or cells with < 5 points.
    """
    flat, valid = cell_index(grid.origin, grid.cell_size, width, height, points)
    return score_at_cells(grid.mean, grid.information, grid.count, points,
                          valid & mask, flat)


def likelihood(grid: NDTGrid, points, mask, width: int, height: int):
    """Summed likelihood of a point set (NDT::likelihood overloads,
    src/ndt_model.cpp:178-201)."""
    return jnp.sum(score_points(grid, points, mask, width, height), axis=-1)
