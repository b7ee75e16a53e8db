"""Batched Levenberg-Marquardt pose-graph solver (the Ceres replacement).

The reference hands optimization to Ceres: autodiff'd
``PoseGraph2dErrorTerm`` residuals (include/ndt_2d/ceres_solver_pose.hpp:76-129),
SPARSE_NORMAL_CHOLESKY, <=100 iterations, first node held constant as the
gauge fix (src/ceres_solver.cpp:39-40, :88-92).

Here this becomes: analytic 3x3 Jacobian blocks for *all*
constraints at once, normal equations assembled by ``segment_sum`` scatter,
and either

* a dense Cholesky solve (small graphs: pads to [3N, 3N]), or
* matrix-free block-Jacobi-preconditioned conjugate gradients whose matvec
  is two gathers + batched 3x3 block multiplies + one scatter (large graphs),

inside a Levenberg-Marquardt accept/reject loop (`lax.while_loop`).  The
residual math is the reference's exactly:

    r_xy = R(theta_a)^T (p_b - p_a) - t_ab
    r_th = NormalizeAngle(theta_b - theta_a - t_ab_theta)
    cost = sum r^T Information r

Failed solves leave the input poses untouched, matching the reference's
"duplicate node map" safety behavior (src/ceres_solver.hpp:65-67,
src/ceres_solver.cpp:98-101).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndt_2d_tpu.config import SolverConfig
from ndt_2d_tpu.core.pose import normalize_angle


class SolveResult(NamedTuple):
    poses: jnp.ndarray       # [N, 3] optimized poses
    success: jnp.ndarray     # scalar bool
    cost: jnp.ndarray        # final cost
    iterations: jnp.ndarray  # LM iterations executed


def residuals(poses, begin, end, transform):
    """[C, 3] residuals (ceres_solver_pose.hpp:93-108)."""
    pa = poses[begin]
    pb = poses[end]
    d = pb[:, :2] - pa[:, :2]
    c, s = jnp.cos(pa[:, 2]), jnp.sin(pa[:, 2])
    rx = c * d[:, 0] + s * d[:, 1] - transform[:, 0]
    ry = -s * d[:, 0] + c * d[:, 1] - transform[:, 1]
    rth = normalize_angle(pb[:, 2] - pa[:, 2] - transform[:, 2])
    return jnp.stack([rx, ry, rth], axis=-1)


def _jacobian_blocks(poses, begin, end):
    """Analytic per-constraint Jacobians Ja, Jb: [C, 3, 3].

    d r / d (x_a, y_a, th_a) and d r / d (x_b, y_b, th_b) for the residual
    above.  R_aT = [[c, s], [-s, c]]; dR_aT/dth = [[-s, c], [-c, -s]].
    """
    pa = poses[begin]
    pb = poses[end]
    d = pb[:, :2] - pa[:, :2]
    c, s = jnp.cos(pa[:, 2]), jnp.sin(pa[:, 2])
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    # dr_xy/dth_a
    dth_x = -s * d[:, 0] + c * d[:, 1]
    dth_y = -c * d[:, 0] - s * d[:, 1]
    ja = jnp.stack([
        jnp.stack([-c, -s, dth_x], -1),
        jnp.stack([s, -c, dth_y], -1),
        jnp.stack([zero, zero, -one], -1)], axis=-2)
    jb = jnp.stack([
        jnp.stack([c, s, zero], -1),
        jnp.stack([-s, c, zero], -1),
        jnp.stack([zero, zero, one], -1)], axis=-2)
    return ja, jb


def _cost(poses, begin, end, transform, information, cmask):
    r = residuals(poses, begin, end, transform)
    w = jnp.einsum("ci,cij,cj->c", r, information, r)
    return jnp.sum(jnp.where(cmask, w, 0.0))


def robust_weights(config: SolverConfig, poses, begin, end, transform,
                   information, robust_mask):
    """Per-constraint IRLS weights for the Huber loss.

    ``robust_mask`` selects which constraints are robustified (loop
    closures; the reference stores ``switchable`` for exactly this purpose
    but never acts on it — constraint.hpp:46, ceres_solver.cpp:159-166).
    With s = sqrt(r^T L r): w = 1 for s <= delta, delta/s beyond — the
    standard Gauss-Newton reweighting whose fixed point minimizes the Huber
    objective.  Returns [C] weights (all-ones when the loss is "none").
    """
    if config.robust_loss == "none":
        return jnp.ones(begin.shape[0], poses.dtype)
    r = residuals(poses, begin, end, transform)
    s2 = jnp.einsum("ci,cij,cj->c", r, information, r)
    delta = jnp.asarray(config.huber_delta, poses.dtype)
    if config.robust_loss == "huber":
        s = jnp.sqrt(jnp.maximum(s2, 1e-20))
        w = jnp.where(s > delta, delta / s, 1.0)
    elif config.robust_loss == "geman_mcclure":
        # Redescending: w -> 0 quadratically for gross outliers, so a false
        # loop closure is effectively switched OFF — the behavior the
        # switchable-constraints literature aims for.
        t = 1.0 + s2 / (delta * delta)
        w = 1.0 / (t * t)
    else:
        raise ValueError(f"unknown robust_loss {config.robust_loss!r}")
    return jnp.where(robust_mask, w, 1.0)


def _robust_cost(config: SolverConfig, poses, begin, end, transform,
                 information, cmask, robust_mask):
    """Huber objective: rho(s) = s^2 for s <= delta, delta(2s - delta)
    beyond (s is the information-weighted residual norm)."""
    r = residuals(poses, begin, end, transform)
    s2 = jnp.einsum("ci,cij,cj->c", r, information, r)
    if config.robust_loss == "none":
        return jnp.sum(jnp.where(cmask, s2, 0.0))
    delta = jnp.asarray(config.huber_delta, poses.dtype)
    if config.robust_loss == "huber":
        s = jnp.sqrt(jnp.maximum(s2, 1e-20))
        rho = jnp.where(s > delta, delta * (2.0 * s - delta), s2)
    else:  # geman_mcclure (validated in robust_weights)
        rho = s2 / (1.0 + s2 / (delta * delta))
    rho = jnp.where(robust_mask, rho, s2)
    return jnp.sum(jnp.where(cmask, rho, 0.0))


def _normal_blocks(poses, begin, end, transform, information, cmask):
    """Per-constraint weighted normal-equation blocks.

    Returns (Baa, Bab, Bbb [C,3,3], ga, gb [C,3]) where B** = J*^T L J* and
    g* = J*^T L r, all masked.
    """
    r = residuals(poses, begin, end, transform)
    ja, jb = _jacobian_blocks(poses, begin, end)
    m = cmask[:, None, None]
    lw = jnp.where(m, information, 0.0)
    lja = jnp.einsum("cij,cjk->cik", lw, ja)
    ljb = jnp.einsum("cij,cjk->cik", lw, jb)
    baa = jnp.einsum("cji,cjk->cik", ja, lja)
    bab = jnp.einsum("cji,cjk->cik", ja, ljb)
    bbb = jnp.einsum("cji,cjk->cik", jb, ljb)
    lr = jnp.einsum("cij,cj->ci", lw, r)
    ga = jnp.einsum("cji,cj->ci", ja, lr)
    gb = jnp.einsum("cji,cj->ci", jb, lr)
    return baa, bab, bbb, ga, gb


def _gather_gradient_and_diag(n, begin, end, baa, bab, bbb, ga, gb):
    """Scatter per-constraint blocks to per-node gradient g [N,3] and
    block-diagonal D [N,3,3]."""
    g = (jax.ops.segment_sum(ga, begin, num_segments=n)
         + jax.ops.segment_sum(gb, end, num_segments=n))
    d = (jax.ops.segment_sum(baa, begin, num_segments=n)
         + jax.ops.segment_sum(bbb, end, num_segments=n))
    return g, d


def _dense_solve(n, begin, end, baa, bab, bbb, g, diag, lam, free_mask):
    """Assemble the full [3N, 3N] damped system and Cholesky-solve it."""
    h = jnp.zeros((n, n, 3, 3), baa.dtype)
    h = h.at[begin, begin].add(baa)
    h = h.at[end, end].add(bbb)
    h = h.at[begin, end].add(bab)
    h = h.at[end, begin].add(jnp.swapaxes(bab, -1, -2))
    # LM damping on the block diagonal (Marquardt scaling).
    eye = jnp.eye(3, dtype=baa.dtype)
    damp = lam * (diag * eye + 1e-12 * eye)
    h = h.at[jnp.arange(n), jnp.arange(n)].add(damp)
    # Gauge fix + inactive nodes: identity rows/cols, zero rhs.
    fm = free_mask.astype(baa.dtype)
    h = h * fm[:, None, None, None] * fm[None, :, None, None]
    h = h.at[jnp.arange(n), jnp.arange(n)].add(
        (1.0 - fm)[:, None, None] * eye)
    rhs = -g * free_mask[:, None].astype(g.dtype)
    hm = h.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)
    delta = jax.scipy.linalg.solve(hm, rhs.reshape(-1), assume_a="pos")
    return delta.reshape(n, 3)


def _pcg_solve(n, begin, end, baa, bab, bbb, g, diag, lam, free_mask,
               max_iter: int, tol: float):
    """Matrix-free block-Jacobi PCG on the damped normal equations."""
    eye = jnp.eye(3, dtype=baa.dtype)
    dd = diag + lam * (diag * eye) + 1e-8 * eye
    # Block-Jacobi preconditioner: invert 3x3 diagonal blocks.
    pinv = jnp.linalg.inv(dd + (1.0 - free_mask[:, None, None].astype(dd.dtype)) * eye)
    fm = free_mask[:, None].astype(g.dtype)
    bab_t = jnp.swapaxes(bab, -1, -2)

    def matvec(v):
        v = v * fm
        va, vb = v[begin], v[end]
        out = (jax.ops.segment_sum(
                   jnp.einsum("cij,cj->ci", baa, va)
                   + jnp.einsum("cij,cj->ci", bab, vb), begin, num_segments=n)
               + jax.ops.segment_sum(
                   jnp.einsum("cij,cj->ci", bab_t, va)
                   + jnp.einsum("cij,cj->ci", bbb, vb), end, num_segments=n))
        out = out + lam * jnp.einsum("nij,nj->ni", diag * eye, v)
        return out * fm

    b = -g * fm

    def prec(r):
        return jnp.einsum("nij,nj->ni", pinv, r) * fm

    x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)
    z0 = prec(r0)

    def body(state):
        x, r, z, p, rz, it = state
        ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.vdot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return x, r, z, p, rz_new, it + 1

    def cond(state):
        _, r, _, _, _, it = state
        return (jnp.linalg.norm(r) > tol) & (it < max_iter)

    x, *_ = jax.lax.while_loop(
        cond, body, (x0, r0, z0, z0, jnp.vdot(r0, z0), jnp.int32(0)))
    return x


@functools.partial(jax.jit, static_argnames=("config", "use_dense"))
def solve(config: SolverConfig, poses, begin, end, transform, information,
          constraint_mask, node_mask, fixed_index=0,
          use_dense: bool = True, robust_mask=None) -> SolveResult:
    """Optimize the pose graph with Levenberg-Marquardt.

    Args:
      poses: [N, 3] initial poses (padded).
      begin/end: [C] int32 node ids per constraint (padded).
      transform: [C, 3]; information: [C, 3, 3]; constraint_mask: [C] bool.
      node_mask: [N] bool live nodes.
      fixed_index: gauge-fixed node (reference fixes scans[0],
        src/ceres_solver.cpp:88-92).
      use_dense: static choice of dense Cholesky vs PCG path.
      robust_mask: [C] bool — constraints under the configured robust loss
        (typically the switchable/loop-closure edges); None = none.
    """
    n = poses.shape[0]
    dtype = poses.dtype
    begin = jnp.clip(begin, 0, n - 1)
    end = jnp.clip(end, 0, n - 1)
    free_mask = node_mask & (jnp.arange(n) != fixed_index)
    if robust_mask is None:
        robust_mask = jnp.zeros(begin.shape[0], bool)

    # Full f32 contractions: on a GPU a default-precision f32 product may
    # run in TF32 (about three decimal digits), and the normal-equation
    # blocks, PCG matvecs and Cholesky solve are numerically fragile at
    # that precision.  Tiny 3x3 contractions gain nothing from tensor
    # cores anyway.
    with jax.default_matmul_precision("highest"):
        return _solve_impl(config, poses, begin, end, transform, information,
                           constraint_mask, free_mask, robust_mask, n, dtype,
                           use_dense)


def _solve_impl(config, poses, begin, end, transform, information,
                constraint_mask, free_mask, robust_mask, n, dtype,
                use_dense):

    cost0 = _robust_cost(config, poses, begin, end, transform, information,
                         constraint_mask, robust_mask)

    def lm_step(state):
        poses, lam, cost, it, stall = state
        rw = robust_weights(config, poses, begin, end, transform,
                            information, robust_mask)
        info_eff = information * rw[:, None, None]
        baa, bab, bbb, ga, gb = _normal_blocks(
            poses, begin, end, transform, info_eff, constraint_mask)
        g, diag = _gather_gradient_and_diag(n, begin, end, baa, bab, bbb,
                                            ga, gb)
        if use_dense:
            delta = _dense_solve(n, begin, end, baa, bab, bbb, g, diag,
                                 lam, free_mask)
        else:
            delta = _pcg_solve(n, begin, end, baa, bab, bbb, g, diag, lam,
                               free_mask, config.cg_max_iterations,
                               jnp.asarray(config.cg_tolerance, dtype))
        new_poses = poses + delta
        new_cost = _robust_cost(config, new_poses, begin, end, transform,
                                information, constraint_mask, robust_mask)
        accept = new_cost < cost
        poses = jnp.where(accept, new_poses, poses)
        lam = jnp.where(accept, lam * config.lm_lambda_down,
                        lam * config.lm_lambda_up)
        lam = jnp.clip(lam, 1e-12, 1e8)
        improved = jnp.abs(cost - new_cost) > config.tolerance * (cost + 1e-12)
        stall = jnp.where(accept & improved, 0, stall + 1)
        cost = jnp.where(accept, new_cost, cost)
        return poses, lam, cost, it + 1, stall

    def lm_cond(state):
        _, _, _, it, stall = state
        return (it < config.max_iterations) & (stall < 3)

    init = (poses, jnp.asarray(config.lm_lambda_init, dtype), cost0,
            jnp.int32(0), jnp.int32(0))
    out_poses, _, cost, iters, _ = jax.lax.while_loop(lm_cond, lm_step, init)

    ok = jnp.isfinite(cost) & (cost <= cost0)
    final = jnp.where(ok, out_poses, poses)
    return SolveResult(poses=final, success=ok, cost=cost, iterations=iters)


def solve_graph(graph, config: SolverConfig, fixed_index: int = 0):
    """Host convenience: optimize a ``pose_graph.Graph`` in place.

    Mirrors CeresSolver::optimize semantics (src/ceres_solver.cpp:50-120):
    no-op on an empty graph; on success, writes optimized poses back.
    Returns True on success.
    """
    import numpy as np
    if graph.num_scans == 0 or graph.num_constraints == 0:
        return False
    n = graph.num_scans
    c = graph.num_constraints
    # Pad nodes/constraints to power-of-two buckets so the growing graph
    # reuses a handful of compiled programs instead of recompiling the whole
    # LM while_loop at every optimization (each compile costs seconds and a
    # session optimizes dozens of times).
    np_ = max(64, 1 << (n - 1).bit_length())
    cp = max(64, 1 << (c - 1).bit_length())
    poses = np.zeros((np_, 3), np.float32)
    poses[:n] = graph.poses
    begin = np.zeros(cp, np.int32)
    begin[:c] = graph.constraint_begin
    end = np.zeros(cp, np.int32)
    end[:c] = graph.constraint_end
    transform = np.zeros((cp, 3), np.float32)
    transform[:c] = graph.constraint_transform
    information = np.zeros((cp, 3, 3), np.float32)
    information[:c] = graph.constraint_information
    cmask = np.arange(cp) < c
    nmask = np.arange(np_) < n
    switchable = np.zeros(cp, bool)
    switchable[:c] = graph.constraint_switchable
    use_dense = 3 * np_ <= config.dense_size_limit
    res = solve(
        config,
        jnp.asarray(poses),
        jnp.asarray(begin),
        jnp.asarray(end),
        jnp.asarray(transform),
        jnp.asarray(information),
        jnp.asarray(cmask),
        jnp.asarray(nmask),
        fixed_index=fixed_index,
        use_dense=use_dense,
        robust_mask=jnp.asarray(switchable))
    if not bool(res.success):
        return False
    graph.set_poses(np.asarray(res.poses[:n], np.float64))
    return True
