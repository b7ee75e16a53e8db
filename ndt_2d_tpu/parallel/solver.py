"""Distributed pose-graph optimization: constraints sharded over the mesh.

The factor graph's work scales with the constraint count, so constraints are
block-partitioned over the mesh's ``batch`` axis.  Each device builds the
weighted normal-equation blocks for its shard; the per-node gradient and
block-diagonal reduce with one ``psum`` each, and the PCG matvec is
local-gather + batched 3x3 block products + scatter + ``psum`` per iteration
— the distributed-Gauss-Newton shape called for by BASELINE.json's
north-star (Schur-style block reduction over collectives).

Poses are replicated (3N floats is tiny next to the constraint work); the LM
control flow runs identically on every device on psum'd scalars, so no
divergence is possible.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ndt_2d_tpu.config import SolverConfig
from ndt_2d_tpu.graph import solver as base
from ndt_2d_tpu.parallel.mesh import BATCH_AXIS


def pad_constraints(begin, end, transform, information, cmask, n_shards: int):
    """Pad constraint arrays to a multiple of the shard count."""
    c = begin.shape[0]
    c_pad = -(-c // n_shards) * n_shards
    if c_pad == c:
        return begin, end, transform, information, cmask
    pb = np.zeros(c_pad, np.int32)
    pe = np.zeros(c_pad, np.int32)
    pt = np.zeros((c_pad, 3), np.float32)
    pi = np.zeros((c_pad, 3, 3), np.float32)
    pm = np.zeros(c_pad, bool)
    pb[:c] = begin
    pe[:c] = end
    pt[:c] = transform
    pi[:c] = information
    pm[:c] = cmask
    return (jnp.asarray(pb), jnp.asarray(pe), jnp.asarray(pt),
            jnp.asarray(pi), jnp.asarray(pm))


@functools.partial(jax.jit, static_argnames=("config", "mesh", "axis"))
def solve_multichip(config: SolverConfig, mesh, poses, begin, end, transform,
                    information, constraint_mask, node_mask, fixed_index=0,
                    axis: str = BATCH_AXIS,
                    robust_mask=None) -> base.SolveResult:
    """Levenberg-Marquardt with constraint-sharded PCG normal equations."""
    n = poses.shape[0]
    dtype = poses.dtype
    n_shards = mesh.shape[axis]
    if begin.shape[0] % n_shards != 0:
        raise ValueError(
            f"constraint capacity {begin.shape[0]} must divide by the "
            f"{axis!r} shard count {n_shards}; use pad_constraints()")
    begin = jnp.clip(jnp.asarray(begin), 0, n - 1)
    end = jnp.clip(jnp.asarray(end), 0, n - 1)
    free_mask = node_mask & (jnp.arange(n) != fixed_index)
    if robust_mask is None:
        robust_mask = jnp.zeros(begin.shape[0], bool)

    shard = P(axis)
    rep = P()

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(rep, shard, shard, shard, shard, shard, rep, shard),
        out_specs=(rep, rep, rep, rep), check_vma=False)
    def _solve(poses0, b, e, t, info, cm, fm, rm):
        eye = jnp.eye(3, dtype=dtype)
        fmask = fm[:, None].astype(dtype)

        def cost_fn(p):
            local = base._robust_cost(config, p, b, e, t, info, cm, rm)
            return jax.lax.psum(local, axis)

        def lm_step(state):
            poses_c, lam, cost, it, stall = state
            rw = base.robust_weights(config, poses_c, b, e, t, info, rm)
            baa, bab, bbb, ga, gb = base._normal_blocks(
                poses_c, b, e, t, info * rw[:, None, None], cm)
            g, diag = base._gather_gradient_and_diag(n, b, e, baa, bab, bbb,
                                                     ga, gb)
            g = jax.lax.psum(g, axis)
            diag = jax.lax.psum(diag, axis)

            dd = diag + lam * (diag * eye) + 1e-8 * eye
            pinv = jnp.linalg.inv(
                dd + (1.0 - fm[:, None, None].astype(dtype)) * eye)
            bab_t = jnp.swapaxes(bab, -1, -2)

            def matvec(v):
                v = v * fmask
                va, vb = v[b], v[e]
                out = (jax.ops.segment_sum(
                           jnp.einsum("cij,cj->ci", baa, va)
                           + jnp.einsum("cij,cj->ci", bab, vb), b,
                           num_segments=n)
                       + jax.ops.segment_sum(
                           jnp.einsum("cij,cj->ci", bab_t, va)
                           + jnp.einsum("cij,cj->ci", bbb, vb), e,
                           num_segments=n))
                out = jax.lax.psum(out, axis)
                out = out + lam * jnp.einsum("nij,nj->ni", diag * eye, v)
                return out * fmask

            rhs = -g * fmask

            def prec(r):
                return jnp.einsum("nij,nj->ni", pinv, r) * fmask

            x0 = jnp.zeros_like(rhs)
            r0 = rhs - matvec(x0)
            z0 = prec(r0)

            def cg_body(s):
                x, r, z, p, rz, i = s
                ap = matvec(p)
                alpha = rz / jnp.maximum(jnp.vdot(p, ap), 1e-30)
                x = x + alpha * p
                r = r - alpha * ap
                z = prec(r)
                rz_new = jnp.vdot(r, z)
                beta = rz_new / jnp.maximum(rz, 1e-30)
                return x, r, z, z + beta * p, rz_new, i + 1

            def cg_cond(s):
                _, r, _, _, _, i = s
                return (jnp.linalg.norm(r) > config.cg_tolerance) \
                    & (i < config.cg_max_iterations)

            delta, *_ = jax.lax.while_loop(
                cg_cond, cg_body,
                (x0, r0, z0, z0, jnp.vdot(r0, z0), jnp.int32(0)))

            new_poses = poses_c + delta
            new_cost = cost_fn(new_poses)
            accept = new_cost < cost
            poses_c = jnp.where(accept, new_poses, poses_c)
            lam = jnp.where(accept, lam * config.lm_lambda_down,
                            lam * config.lm_lambda_up)
            lam = jnp.clip(lam, 1e-12, 1e8)
            improved = jnp.abs(cost - new_cost) > config.tolerance * (cost + 1e-12)
            stall = jnp.where(accept & improved, 0, stall + 1)
            cost = jnp.where(accept, new_cost, cost)
            return poses_c, lam, cost, it + 1, stall

        def lm_cond(state):
            _, _, _, it, stall = state
            return (it < config.max_iterations) & (stall < 3)

        cost0 = cost_fn(poses0)
        init = (poses0, jnp.asarray(config.lm_lambda_init, dtype), cost0,
                jnp.int32(0), jnp.int32(0))
        out_poses, _, cost, iters, _ = jax.lax.while_loop(lm_cond, lm_step,
                                                          init)
        ok = jnp.isfinite(cost) & (cost <= cost0)
        final = jnp.where(ok, out_poses, poses0)
        return final, ok, cost, iters

    # Force f32 contractions: a default-precision GPU product may run in
    # TF32, too coarse for the LM/PCG solve (see graph/solver.py::solve);
    # the context applies while _solve traces.
    with jax.default_matmul_precision("highest"):
        poses_out, ok, cost, iters = _solve(
            poses, begin, end, transform, information, constraint_mask,
            free_mask, jnp.asarray(robust_mask))
    return base.SolveResult(poses=poses_out, success=ok, cost=cost,
                            iterations=iters)
