"""Keyframe (scan) batch pytree.

The reference stores one ``Scan`` per keyframe: id, corrected pose, robot-frame
point cloud, and a lazily cached barycenter (include/ndt_2d/scan.hpp:40-88,
src/scan.cpp:72-91).  Here all keyframes live in one padded
structure-of-arrays pytree so every op batches over scans.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ndt_2d_tpu.core import pose as pose_ops


class ScanBatch(NamedTuple):
    """Padded batch of scans.

    Attributes:
      poses:       [S, 3] (x, y, theta) corrected map-frame poses.
      points:      [S, P, 2] robot-frame laser points (padded).
      point_mask:  [S, P] bool; True where a point slot is real.
      num_scans:   scalar int32; number of live scans (<= S).
    """

    poses: jnp.ndarray
    points: jnp.ndarray
    point_mask: jnp.ndarray
    num_scans: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def max_points(self) -> int:
        return self.points.shape[1]

    @property
    def scan_mask(self):
        """[S] bool mask of live scan slots."""
        return jnp.arange(self.capacity) < self.num_scans

    @property
    def point_counts(self):
        """[S] int32 number of real points per scan."""
        return jnp.sum(self.point_mask, axis=-1).astype(jnp.int32)


def empty_scan_batch(capacity: int, max_points: int,
                     dtype=jnp.float32) -> ScanBatch:
    return ScanBatch(
        poses=jnp.zeros((capacity, 3), dtype),
        points=jnp.zeros((capacity, max_points, 2), dtype),
        point_mask=jnp.zeros((capacity, max_points), jnp.bool_),
        num_scans=jnp.zeros((), jnp.int32),
    )


def append_scan(batch: ScanBatch, pose, points, point_mask) -> ScanBatch:
    """Functionally append one scan into the next free slot."""
    i = batch.num_scans
    return ScanBatch(
        poses=batch.poses.at[i].set(pose),
        points=batch.points.at[i].set(points),
        point_mask=batch.point_mask.at[i].set(point_mask),
        num_scans=i + 1,
    )


def barycenters(batch: ScanBatch):
    """[S, 2] barycenter positions (mean of world-frame points per scan).

    Matches Scan::update (src/scan.cpp:72-91): pose translation plus the mean
    of the pose-rotated points; equals the pose itself for empty scans.
    """
    rotated = pose_ops.rotate(batch.poses[:, 2:3], batch.points)  # [S, P, 2]
    m = batch.point_mask[..., None]
    counts = jnp.maximum(jnp.sum(batch.point_mask, axis=1), 1)[:, None]
    center = jnp.sum(jnp.where(m, rotated, 0.0), axis=1) / counts
    has_pts = (jnp.sum(batch.point_mask, axis=1) > 0)[:, None]
    return batch.poses[:, :2] + jnp.where(has_pts, center, 0.0)


def world_points(batch: ScanBatch):
    """[S, P, 2] points transformed into the map frame by each scan's pose."""
    return pose_ops.transform_points(batch.poses, batch.points)
