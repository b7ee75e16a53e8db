"""Correlative occupancy scan matcher — an alternative matcher plugin.

The reference's matcher layer is a pluginlib interface precisely so other
matchers can be swapped in by parameter string (README.md:6-10 points users
at the external ``ndt_2d_karto`` package).  This module provides a second,
independently-implemented matcher behind the same registry surface, in the
style of Olson's correlative scan matching (and Karto's grid search):

* the window's points render into a hit grid, which is blurred with a small
  separable Gaussian into a smooth log-likelihood field (the smearing plays
  the role the reference's NDT Gaussians play),
* a candidate pose's score is the negative mean field value under the
  subsampled beams — the same exhaustive (angle x dx x dy) lattice, argmin,
  per-beam normalization, and Olson covariance as the NDT matcher, so it is
  drop-in compatible with the mapper's gates and constraint construction.

Being a plain gather+reduce over a [H, W] field, it shares the NDT matcher's
execution shape; the blur is two tiny 1-D convolutions.

Select with ``scan_matcher_type="correlative"`` (MapperConfig) — the same
mechanism as the reference's ``scan_matcher_type`` ROS parameter
(src/ndt_mapper.cpp:91-92).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ndt_2d_tpu.config import ScanMatcherConfig
from ndt_2d_tpu.core import pose as pose_ops
from ndt_2d_tpu.matching import matcher as ndt_matcher


@functools.partial(jax.jit, static_argnames=("config",))
def build_field(config: ScanMatcherConfig, poses, points, point_mask,
                window_mask, range_max):
    """Blurred log-occupancy field [H, W] + origin for a scan window.

    Grid resolution follows ``ndt_resolution`` for configuration parity.
    """
    W, H = config.grid_cells_x, config.grid_cells_y
    origin = ndt_matcher.window_origin(config, poses, window_mask, range_max)
    cell = jnp.asarray(config.ndt_resolution, points.dtype)

    world = pose_ops.transform_points(poses, points)          # [S, P, 2]
    mask = (point_mask & window_mask[:, None]).reshape(-1)
    w = world.reshape(-1, 2)
    ix = jnp.floor((w[:, 0] - origin[0]) / cell).astype(jnp.int32)
    iy = jnp.floor((w[:, 1] - origin[1]) / cell).astype(jnp.int32)
    ok = mask & (ix >= 0) & (iy >= 0) & (ix < W) & (iy < H)
    flat = jnp.where(ok, jnp.clip(iy, 0, H - 1) * W + jnp.clip(ix, 0, W - 1),
                     H * W)
    hits = jax.ops.segment_sum(ok.astype(points.dtype), flat,
                               num_segments=H * W + 1)[:H * W]
    field = hits.reshape(H, W)

    # Separable Gaussian blur (sigma = 1 cell, radius 3): smooth likelihood
    # that decays with distance to the nearest surface, like an NDT cell.
    r = 3
    x = jnp.arange(-r, r + 1, dtype=points.dtype)
    k = jnp.exp(-0.5 * x * x)
    k = k / jnp.sum(k)
    # Full f32: a default-precision GPU convolution may run in TF32.
    hi = jax.lax.Precision.HIGHEST
    f = jax.vmap(lambda row: jnp.convolve(row, k, mode="same",
                                          precision=hi))(field)
    f = jax.vmap(lambda col: jnp.convolve(col, k, mode="same", precision=hi),
                 in_axes=1, out_axes=1)(f)
    # Normalize so a beam landing exactly on a well-observed surface scores
    # ~1 (comparable to the NDT Gaussian peak).
    peak = jnp.maximum(jnp.max(f), 1e-6)
    return f / peak, origin


@functools.partial(jax.jit, static_argnames=("config",))
def match_scan_field(config: ScanMatcherConfig, field, origin, points,
                     point_mask, num_points, pose) -> ndt_matcher.MatchResult:
    """Exhaustive lattice search of one scan against the field."""
    W, H = config.grid_cells_x, config.grid_cells_y
    B = config.laser_max_beams
    spts, smask, used = ndt_matcher.subsample(points, point_mask, num_points,
                                              B)
    dths, dls = ndt_matcher._search_offsets(config, spts.dtype)
    cell = jnp.asarray(config.ndt_resolution, spts.dtype)

    th = pose[2] + dths
    c, s = jnp.cos(th)[:, None], jnp.sin(th)[:, None]
    px, py = spts[:, 0][None, :], spts[:, 1][None, :]
    rx = c * px - s * py + pose[0]
    ry = s * px + c * py + pose[1]
    wx = rx[:, None, None, :] + dls[None, :, None, None]   # [A, L, L, B]
    wy = ry[:, None, None, :] + dls[None, None, :, None]
    ix = jnp.floor((wx - origin[0]) / cell).astype(jnp.int32)
    iy = jnp.floor((wy - origin[1]) / cell).astype(jnp.int32)
    inb = (ix >= 0) & (iy >= 0) & (ix < W) & (iy < H)
    flat = jnp.where(inb, jnp.clip(iy, 0, H - 1) * W
                     + jnp.clip(ix, 0, W - 1), 0)
    vals = field.reshape(-1)[flat]
    pt_scores = jnp.where(inb & smask[None, None, None, :], vals, 0.0)
    cand = -jnp.sum(pt_scores, axis=-1)                     # [A, L, L]

    best, correction, k, u, s_ = ndt_matcher.reduce_candidates(cand, dths,
                                                               dls)
    return ndt_matcher.finalize_match(best, correction, k, u, s_, used)


@functools.partial(jax.jit, static_argnames=("config",))
def score_points_field(config: ScanMatcherConfig, field, origin, points,
                       point_mask, num_points, pose):
    """Mean negative field value under the (subsampled) beams at ``pose``."""
    W, H = config.grid_cells_x, config.grid_cells_y
    B = config.laser_max_beams
    spts, smask, used = ndt_matcher.subsample(points, point_mask, num_points,
                                              B)
    c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
    wx = c * spts[:, 0] - s * spts[:, 1] + pose[0]
    wy = s * spts[:, 0] + c * spts[:, 1] + pose[1]
    cell = jnp.asarray(config.ndt_resolution, spts.dtype)
    ix = jnp.floor((wx - origin[0]) / cell).astype(jnp.int32)
    iy = jnp.floor((wy - origin[1]) / cell).astype(jnp.int32)
    inb = (ix >= 0) & (iy >= 0) & (ix < W) & (iy < H)
    flat = jnp.where(inb, jnp.clip(iy, 0, H - 1) * W
                     + jnp.clip(ix, 0, W - 1), 0)
    vals = jnp.where(inb & smask, field.reshape(-1)[flat], 0.0)
    return -jnp.sum(vals) / jnp.maximum(used, 1).astype(spts.dtype)


class CorrelativeScanMatcher:
    """Stateful wrapper with the ScanMatcher plugin surface
    (include/ndt_2d/scan_matcher.hpp:42-91)."""

    def __init__(self, config: ScanMatcherConfig, range_max: float):
        self.config = config
        self.range_max = float(range_max)
        self.field = None
        self.origin = None

    def add_scans(self, poses, points, point_mask, window_mask=None):
        poses = jnp.asarray(poses)
        if window_mask is None:
            window_mask = jnp.ones(poses.shape[0], bool)
        self.field, self.origin = build_field(
            self.config, poses, jnp.asarray(points), jnp.asarray(point_mask),
            jnp.asarray(window_mask), jnp.float32(self.range_max))

    def match_scan(self, points, point_mask, num_points, pose):
        if self.field is None:
            return ndt_matcher.MatchResult(jnp.zeros(()), jnp.zeros(3),
                                           jnp.zeros((3, 3)))
        return match_scan_field(self.config, self.field, self.origin,
                                jnp.asarray(points), jnp.asarray(point_mask),
                                jnp.asarray(num_points), jnp.asarray(pose))

    def score_points(self, points, point_mask, num_points, pose):
        """scorePoints analog: mean negative field value at this pose."""
        if self.field is None:
            return jnp.zeros(())
        return score_points_field(
            self.config, self.field, self.origin, jnp.asarray(points),
            jnp.asarray(point_mask), jnp.asarray(num_points),
            jnp.asarray(pose))

    def reset(self):
        self.field = None
        self.origin = None
