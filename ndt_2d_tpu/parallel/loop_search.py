"""Distributed loop-closure candidate search over keyframe descriptors.

The reference finds loop-closure candidates by a radius search over scan
barycenters (Graph::findNearest, src/graph.cpp:167-189, rebuilt per query),
which assumes odometry drift is smaller than the search radius.  At district
scale — and across hosts — the replacement here is appearance-based:

* every keyframe gets a compact rotation-invariant **descriptor** (a
  normalized radial range histogram of its points, computed batched on
  device),
* descriptors are L2-normalized so candidate search is a **cosine-similarity
  matmul** — one matrix product does all-pairs correlation,
* across a device mesh the keyframe set is sharded over the ``batch`` axis;
  each device ``all_gather``s the descriptor table, correlates
  its query shard against ALL keyframes in one matmul, and ``top_k``s
  locally — the all-to-all batched correlation named by the project
  north-star (BASELINE.json).

Candidates are *proposals*; the mapper still confirms each with a full NDT
match + score gate exactly like the reference's loopClosureThread
(src/ndt_mapper.cpp:623-663).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ndt_2d_tpu.parallel.mesh import BATCH_AXIS


def _dot(a, b):
    """Full-f32 product.  Descriptor cosines are compared against similarity
    thresholds (``descriptor_min_similarity``), and a default-precision GPU
    product may run in TF32 (about three decimal digits), which moves
    cosines across the cutoff."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("n_bins", "n_sectors",
                                             "n_rings"))
def descriptors(points, point_mask, range_max, n_bins: int = 32,
                n_sectors: int = 64, n_rings: int = 4):
    """Rotation-invariant keyframe descriptors, L2-normalized.

    ``points`` [S, P, 2] robot-frame, ``point_mask`` [S, P].  Three parts,
    concatenated and jointly normalized to unit L2 norm (so cosine similarity
    is a plain dot product):

    * the **magnitude spectrum** of the angular range profile: mean beam
      range per angular sector -> |DFT| over sectors.  A rotation of the
      robot circularly shifts the profile, which only changes DFT phases —
      the magnitudes are exactly shift-invariant and capture *where the
      walls are*, not just how far.  The DFT is two small matmuls
      ([S, A] @ [A, A/2] cos/sin tables), no FFT needed.
    * **per-ring angular occupancy spectra** (Scan-Context-like radial
      decomposition): points binned into ``n_rings`` range bands x
      ``n_sectors`` sectors; each ring's angular occupancy profile gets the
      same |DFT| treatment.  This angularly resolves the radial structure a
      single mean-range profile collapses (measured on the 3x-drift office:
      the profile+histogram descriptor ranked true revisits in the top-8
      for only ~25% of revisit queries).
    * a mean-centered range histogram (counts of beam ranges over
      ``n_bins`` equal bins), the distribution texture of the place.

    All DFTs drop the k=0 (DC) magnitude and the histogram is mean-centered:
    those components are near-identical across scans of one environment and
    saturated every pairwise cosine toward 1.0, deadening top-k ranking and
    the ``min_similarity`` knob.  Scans with no valid points get a zero
    descriptor (cosine 0 against everything).
    """
    dtype = points.dtype
    S = points.shape[0]
    r = jnp.linalg.norm(points, axis=-1)                        # [S, P]
    msk = point_mask.astype(dtype)
    # Flat per-(scan, bin) segment ids; masked points go to a scratch
    # segment that is sliced away.  (segment_sum instead of one_hot keeps
    # memory at O(S*P) rather than O(S*P*bins) — at district-scale padded
    # capacities the one_hot formulation allocates hundreds of MB.)
    scan_base = jnp.arange(S, dtype=jnp.int32)[:, None]

    def binned_sum(values, bins, n):
        seg = jnp.where(point_mask, scan_base * n + bins, S * n)
        return jax.ops.segment_sum(
            values.reshape(-1), seg.reshape(-1),
            num_segments=S * n + 1)[:S * n].reshape(S, n)

    # --- angular profile -> |DFT| ---
    ang = jnp.arctan2(points[..., 1], points[..., 0])           # [S, P]
    sec = jnp.clip(((ang + jnp.pi) / (2.0 * jnp.pi) * n_sectors)
                   .astype(jnp.int32), 0, n_sectors - 1)
    cnt = binned_sum(msk, sec, n_sectors)                       # [S, A]
    prof = binned_sum(r * msk, sec, n_sectors) / jnp.maximum(cnt, 1.0)
    prof = prof / range_max                                     # [S, A] in [0,1]
    # Frequencies start at k=1: the k=0 (DC) magnitude is just the mean
    # range, which is nearly identical for every scan of the same indoor
    # space and saturated all-pairs cosines near 1.0 (measured: the
    # min_similarity knob had no effect at 0.90-0.97 because every
    # similarity exceeded it) — dropping DC spreads the distribution so
    # top-k ranks on *shape*, not scale.
    k = jnp.arange(1, n_sectors // 2 + 1, dtype=dtype)          # [F]
    a = jnp.arange(n_sectors, dtype=dtype)
    w = 2.0 * jnp.pi * a[:, None] * k[None, :] / n_sectors      # [A, F]
    spec = jnp.sqrt(_dot(prof, jnp.cos(w)) ** 2
                    + _dot(prof, jnp.sin(w)) ** 2)              # [S, F]

    # --- per-ring angular occupancy spectra ---
    ring = jnp.clip((r / range_max * n_rings).astype(jnp.int32),
                    0, n_rings - 1)
    ring_cnt = binned_sum(msk, ring * n_sectors + sec,
                          n_rings * n_sectors)                  # [S, R*A]
    ring_cnt = (ring_cnt
                / jnp.maximum(jnp.sum(msk, axis=1, keepdims=True), 1.0))
    ring_prof = ring_cnt.reshape(S, n_rings, n_sectors)         # [S, R, A]
    ring_spec = jnp.sqrt(_dot(ring_prof, jnp.cos(w)) ** 2
                         + _dot(ring_prof, jnp.sin(w)) ** 2)    # [S, R, F]
    ring_spec = ring_spec.reshape(S, -1)

    # --- range histogram (mean-centered: the histogram always sums to 1,
    # so its uncentered bins share a constant +1/n_bins component in every
    # scan — the same cosine-saturating DC term) ---
    b = jnp.clip((r / range_max * n_bins).astype(jnp.int32), 0, n_bins - 1)
    hist = binned_sum(msk, b, n_bins)                           # [S, B]
    hist = hist / jnp.maximum(jnp.sum(msk, axis=1, keepdims=True), 1.0)
    hist = hist - jnp.mean(hist, axis=-1, keepdims=True)

    d = jnp.concatenate([spec, ring_spec, hist], axis=-1)
    norm = jnp.linalg.norm(d, axis=-1, keepdims=True)
    has_points = jnp.sum(msk, axis=1, keepdims=True) > 0
    return jnp.where(has_points, d / jnp.maximum(norm, 1e-12), 0.0)


@jax.jit
def cross_similarity(desc_a, desc_b):
    """[Na, Nb] cosine similarities between two descriptor tables (map
    merging's cross-session candidate search)."""
    return _dot(desc_a, desc_b.T)


@functools.partial(jax.jit, static_argnames=("k", "rolling_exclude"))
def search_dense(desc, valid, query_idx, k: int = 8,
                 rolling_exclude: int = 10):
    """Single-device candidate search: top-k most similar earlier keyframes.

    Args:
      desc: [N, B] descriptor table; valid: [N] mask of real keyframes.
      query_idx: scalar int — the scan looking for closures.
      rolling_exclude: candidates must satisfy ``i <= query - exclude``
        (the reference excludes the rolling window the same way,
        src/ndt_mapper.cpp:613-615).

    Returns (indices [k], scores [k]); empty slots have score -inf.
    """
    sims = _dot(desc, desc[query_idx])                          # [N] cosine
    n = desc.shape[0]
    eligible = valid & (jnp.arange(n) <= query_idx - rolling_exclude)
    sims = jnp.where(eligible, sims, -jnp.inf)
    scores, idx = jax.lax.top_k(sims, k)
    return idx, scores


@functools.partial(jax.jit, static_argnames=("k", "rolling_exclude"))
def search_all_pairs(desc, valid, k: int = 8, rolling_exclude: int = 10):
    """Single-device all-pairs candidate search: every keyframe's top-k in
    ONE [N, B] @ [B, N] matmul + row-wise top_k.

    A loop-closure pass used to run search_dense per pending query — one
    dispatch + one synchronous fetch each.  Descriptors depend only on
    scan points, which acceptances never change, so precomputing the whole
    table per pass is decision-identical to the per-query search (the same
    argument as the sharded all-pairs path).  Returns (indices [N, k],
    scores [N, k]).
    """
    n = desc.shape[0]
    sims = jnp.einsum("ib,jb->ij", desc, desc,
                      precision=jax.lax.Precision.HIGHEST)
    ar = jnp.arange(n)
    eligible = valid[None, :] & (ar[None, :] <= ar[:, None] - rolling_exclude)
    sims = jnp.where(eligible, sims, -jnp.inf)
    scores, idx = jax.lax.top_k(sims, k)
    return idx, scores


@functools.partial(jax.jit,
                   static_argnames=("mesh", "k", "rolling_exclude", "axis"))
def search_all_pairs_multichip(mesh, desc, valid, k: int = 8,
                               rolling_exclude: int = 10,
                               axis: str = BATCH_AXIS):
    """All-pairs candidate search with the keyframe set sharded over the mesh.

    ``desc`` [N, B] is passed sharded over ``axis`` (N must divide the shard
    count; pad with ``valid=False`` rows).  Each device all_gathers the
    descriptor table, correlates its local query shard against the full set
    in one matmul ([N/n_dev, B] @ [B, N]), masks the rolling
    window per query, and top_k's locally.  Returns (indices [N, k],
    scores [N, k]) for every keyframe as query.
    """
    n_shards = mesh.shape[axis]
    n = desc.shape[0]
    if n % n_shards:
        raise ValueError(f"keyframe capacity {n} must divide the "
                         f"{axis!r} shard count {n_shards}")

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis)), check_vma=False)
    def _search(d_local, v_local):
        idx_dev = jax.lax.axis_index(axis)
        ns = d_local.shape[0]
        # Full table on every device: one all_gather.
        d_all = jax.lax.all_gather(d_local, axis).reshape(n, -1)   # [N, B]
        v_all = jax.lax.all_gather(v_local, axis).reshape(n)       # [N]
        sims = _dot(d_local, d_all.T)                              # [ns, N]
        q_ids = idx_dev * ns + jnp.arange(ns)                      # [ns]
        eligible = (v_all[None, :] & v_local[:, None]
                    & (jnp.arange(n)[None, :]
                       <= q_ids[:, None] - rolling_exclude))
        sims = jnp.where(eligible, sims, -jnp.inf)
        scores, idx = jax.lax.top_k(sims, k)                       # [ns, k]
        return idx, scores

    return _search(desc, valid)


def pad_descriptors(desc: np.ndarray, valid: np.ndarray, n_shards: int):
    """Pad the descriptor table to a multiple of the shard count.

    Returns host numpy: in multi-controller mode the search jit treats host
    arrays as process-replicated inputs (committed jnp arrays would pin to
    one process's local device); single-process jit transfers them the same
    way a jnp.asarray would have.
    """
    desc = np.asarray(desc)
    valid = np.asarray(valid)
    n = desc.shape[0]
    n_pad = -(-n // n_shards) * n_shards
    if n_pad == n:
        return desc, valid
    d = np.zeros((n_pad, desc.shape[1]), desc.dtype)
    v = np.zeros(n_pad, bool)
    d[:n] = desc
    v[:n] = valid
    return d, v
