"""Newton refinement of a pose on the NDT score surface.

The reference's matcher is purely an exhaustive lattice search
(src/scan_matcher_ndt.cpp:103-143), so its accuracy is quantized to the
lattice resolution (0.005 m / 0.0025 rad by default).  Classic NDT (Biber &
Strasser 2003) instead ascends the smooth score surface with Newton's method;
here that is implemented as a fixed-iteration ``lax.scan`` whose
body is one batched gradient/Hessian accumulation over all beams — a few
microseconds per iteration on-chip, giving *sub-lattice* registration when
chained after the exhaustive search (coarse global alignment from the
lattice, continuous polish from Newton).

Math (for score s_b = exp(-1/2 q^T L q), q = R(th) p_b + t - mu, per beam b,
objective f = -sum_b s_b minimized over pose pi = (x, y, th)):

  J = dq/dpi = [ I_2 | dR/dth p ],      dR/dth p = (-s px - c py, c px - s py)
  a_i   = q^T L J_i
  df/dpi_i        = sum_b s_b a_i
  d2f/dpi_i dpi_j = sum_b s_b (-a_i a_j + J_i^T L J_j + [i=j=th] q^T L d2q/dth2)
  d2q/dth2 = -R p

Each iteration re-bins points into cells (a Newton step may hop cell
boundaries), Levenberg-damps the 3x3 Hessian, and tracks the best pose seen
so the result is never worse than the starting point.  The TOTAL deviation
from the starting pose is clamped to one lattice step per axis: the lattice
already found the best quantization bin, so the continuous optimum lives
within half a step of it — an unbounded ascent can instead wander along
weakly-constrained directions (e.g. down a corridor) toward cell-mean
attractors of the single-grid NDT surface and was measured to *worsen*
trajectory ATE.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ndt_2d_tpu.config import ScanMatcherConfig
from ndt_2d_tpu.ndt import grid as ndt_grid


def _objective_grad_hess(grid: ndt_grid.NDTGrid, width: int, height: int,
                         spts, smask, pose):
    """(f, grad [3], hess [3, 3]) of f = -mean-over-grids of cell scores.

    A stacked overlapping-grids NDT (matcher.is_multi_grid) contributes the
    average of its 4 sub-grids, matching candidate_scores' score scale; a
    single grid passes through unchanged.
    """
    if grid.mean.ndim == 3:
        import jax
        n = grid.mean.shape[0]
        parts = [_objective_grad_hess_one(jax.tree.map(lambda x: x[i], grid),
                                          width, height, spts, smask, pose)
                 for i in range(n)]
        return tuple(sum(p[k] for p in parts) / n for k in range(3))
    return _objective_grad_hess_one(grid, width, height, spts, smask, pose)


def _objective_grad_hess_one(grid: ndt_grid.NDTGrid, width: int, height: int,
                             spts, smask, pose):
    """(f, grad [3], hess [3, 3]) of f = -sum of cell scores at ``pose``."""
    c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
    px, py = spts[:, 0], spts[:, 1]
    rx = c * px - s * py                                   # R p   [B]
    ry = s * px + c * py
    wx = rx + pose[0]
    wy = ry + pose[1]
    w = jnp.stack([wx, wy], axis=-1)

    flat, valid = ndt_grid.cell_index(grid.origin, grid.cell_size,
                                      width, height, w)
    safe = jnp.where(valid, flat, 0)
    mean = grid.mean[safe]                                 # [B, 2]
    info = grid.information[safe]                          # [B, 3]
    ok = valid & smask & (grid.count[safe] >= 5)

    qx = wx - mean[:, 0]
    qy = wy - mean[:, 1]
    i00, i01, i11 = info[:, 0], info[:, 1], info[:, 2]
    lqx = i00 * qx + i01 * qy                              # L q
    lqy = i01 * qx + i11 * qy
    e = -0.5 * (qx * lqx + qy * lqy)
    sc = jnp.where(ok, jnp.exp(jnp.minimum(e, 0.0)), 0.0)  # [B]

    j3x = -s * px - c * py                                 # dR/dth p
    j3y = c * px - s * py
    a1, a2 = lqx, lqy                                      # q^T L J_i
    a3 = lqx * j3x + lqy * j3y
    a = jnp.stack([a1, a2, a3], axis=-1)                   # [B, 3]

    f = -jnp.sum(sc)
    grad = jnp.sum(sc[:, None] * a, axis=0)                # [3]

    # J^T L J (symmetric [3, 3] per beam, assembled from its 6 entries).
    lj3x = i00 * j3x + i01 * j3y                           # L J_3
    lj3y = i01 * j3x + i11 * j3y
    j33 = j3x * lj3x + j3y * lj3y
    # q^T L d2q/dth2 with d2q/dth2 = -R p.
    hq = -(lqx * rx + lqy * ry)

    def acc(v):
        return jnp.sum(sc * v)

    h11 = acc(-a1 * a1 + i00)
    h12 = acc(-a1 * a2 + i01)
    h13 = acc(-a1 * a3 + lj3x)
    h22 = acc(-a2 * a2 + i11)
    h23 = acc(-a2 * a3 + lj3y)
    h33 = acc(-a3 * a3 + j33 + hq)
    hess = jnp.asarray([[h11, h12, h13],
                        [h12, h22, h23],
                        [h13, h23, h33]])
    return f, grad, hess


@functools.partial(jax.jit, static_argnames=("config", "iterations"))
def refine_pose(config: ScanMatcherConfig, grid: ndt_grid.NDTGrid,
                spts, smask, pose, iterations: int):
    """Run ``iterations`` damped Newton steps from ``pose``.

    Args:
      spts: [B, 2] robot-frame (already subsampled) points; smask: [B].
      pose: [3] starting pose (typically lattice-search corrected).
    Returns (best_pose [3], best_f) where best_f = -sum of cell scores at
    best_pose (same convention as the lattice candidate scores); the result
    is never worse than the starting pose and never further from it than one
    lattice step per axis.
    """
    W, H = config.grid_cells_x, config.grid_cells_y
    trust = jnp.asarray([config.search_linear_resolution,
                         config.search_linear_resolution,
                         config.search_angular_resolution])

    # best_f starts at +inf: the first scan iteration evaluates f(pose) and
    # always installs it as the incumbent, so the starting pose is never
    # evaluated twice.
    f0 = jnp.asarray(jnp.inf, spts.dtype)

    def body(carry, _):
        cur, best, best_f = carry
        f, grad, hess = _objective_grad_hess(grid, W, H, spts, smask, cur)
        # Levenberg damping keeps the 3x3 solve well-posed even where the
        # score surface is locally non-convex or empty (all scores 0).
        lam = 1e-3 * (jnp.trace(hess) / 3.0) + 1e-6
        hess = hess + jnp.maximum(lam, 1e-6) * jnp.eye(3, dtype=hess.dtype)
        # (matmul precision forced: a TF32 product on a GPU is too coarse
        # for a sub-lattice polish step)
        with jax.default_matmul_precision("highest"):
            step = -jnp.linalg.solve(hess, grad)
        step = jnp.where(jnp.isfinite(step), step, 0.0)
        # Trust region: total displacement from the lattice winner stays
        # within one lattice step per axis.
        nxt = pose + jnp.clip(cur + step - pose, -trust, trust)
        better = f < best_f
        best = jnp.where(better, cur, best)
        best_f = jnp.where(better, f, best_f)
        return (nxt, best, best_f), None

    (final, best, best_f), _ = jax.lax.scan(
        body, (pose, pose, f0), None, length=iterations)
    # The last iterate was stepped to but never evaluated inside the scan.
    f_final, _, _ = _objective_grad_hess(grid, W, H, spts, smask, final)
    better = f_final < best_f
    best = jnp.where(better, final, best)
    best_f = jnp.where(better, f_final, best_f)
    return best, best_f
