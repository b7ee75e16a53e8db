"""AMCL-style particle filter with KLD-adaptive resampling, batched on device.

The reference (src/particle_filter.cpp) loops per particle for the motion
update and the measurement model and resamples one draw at a time, counting
occupied (x, y, theta) histogram bins with a custom incremental KD-tree
(include/ndt_2d/kd_tree.hpp) purely to evaluate the KLD bound.

Batched redesign:
* motion update: one vectorized sample over all particles,
* measurement: one batched scorePoints gather over all particles x beams
  against the global NDT (replaces the loop at particle_filter.cpp:81-88),
* KLD resampling: draw ``max_particles`` candidates at once, mark
  first-occurrence of each discretized bin, prefix-sum to get k(m) (the
  distinct-bin count after m draws == the KD-tree leaf count), evaluate the
  KLD bound Mx(m) for every prefix in parallel, and pick the first m
  satisfying ``m >= max(min_particles, Mx(m))`` — bit-for-bit the same
  stopping rule as the sequential loop (particle_filter.cpp:91-137), with no
  tree at all.

Deviation from the reference (bug fix): updateStatistics accumulates
cov(2,2) across calls without zeroing (particle_filter.cpp:216 uses ``+=``
on a member); we compute it fresh each time.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ndt_2d_tpu.config import ParticleFilterConfig
from ndt_2d_tpu.core.pose import normalize_angle, shortest_angular_distance
from ndt_2d_tpu.filter import motion_model
from ndt_2d_tpu.matching import matcher as matcher_mod


def normalize_weights(weights, mask):
    """Normalize raw particle weights to a positive distribution.

    The reference stores the *negative* NDT response as the weight
    (particle_filter.cpp:84-88: lower = better matches are more negative)
    and normalizes by the (negative) total in updateStatistics — which
    flips sign and ranks correctly.  This helper reproduces exactly that:
    w_i / sum(w), falling back to uniform over the mask when the total is
    zero."""
    w = jnp.where(mask, weights, 0.0)
    total = jnp.sum(w)
    return jnp.where(total != 0.0, w / total,
                     mask.astype(w.dtype) / jnp.maximum(jnp.sum(mask), 1))


@jax.jit
def update_statistics(particles, weights, mask):
    """Normalize weights; weighted mean (circular for theta) and covariance.

    Mirrors ParticleFilter::updateStatistics (particle_filter.cpp:163-218),
    including the xy covariance from correlation minus mean outer product and
    the theta variance via shortest angular distances to the circular mean.
    """
    w = normalize_weights(weights, mask)

    mean_xy = jnp.sum(w[:, None] * particles[:, :2], axis=0)
    sum_cos = jnp.sum(w * jnp.cos(particles[:, 2]))
    sum_sin = jnp.sum(w * jnp.sin(particles[:, 2]))
    mean_th = jnp.arctan2(sum_sin, sum_cos)
    mean = jnp.asarray([mean_xy[0], mean_xy[1], mean_th])

    corr = jnp.einsum("m,mi,mj->ij", w, particles[:, :2], particles[:, :2],
                      precision="highest")  # TF32 would skew the cov
    cov_xy = corr - jnp.outer(mean_xy, mean_xy)
    d = shortest_angular_distance(particles[:, 2], mean_th)
    cov_th = jnp.sum(w * d * d)
    cov = jnp.zeros((3, 3), particles.dtype)
    cov = cov.at[:2, :2].set(cov_xy).at[2, 2].set(cov_th)
    return w, mean, cov


@functools.partial(jax.jit, static_argnames=("min_particles", "max_particles"))
def kld_resample(key, particles, weights, mask, kld_err, kld_z, bin_sizes,
                 min_particles: int, max_particles: int):
    """KLD-adaptive resampling as one batched draw + prefix scan.

    Returns (particles, weights, n_active).  Matches the sequential semantics
    of ParticleFilter::resample (particle_filter.cpp:91-137): weighted draws
    with replacement; after each draw m the KLD bound

        Mx = (k-1)/(2 eps) * (1 - 2/(9(k-1)) + sqrt(2/(9(k-1))) z)^3

    (truncated to integer, as the C++ double->size_t cast does) is evaluated
    with k = occupied-bin count among the first m draws; sampling stops at the
    first m >= max(min_particles, Mx), capped at max_particles.  While k == 1
    the bound keeps its initial value max_particles.
    """
    m_total = max_particles
    # Raw weights may be the reference's negative NDT responses; the
    # sign-flipping normalization ranks them correctly either way.
    p = normalize_weights(weights, mask)
    idx = jax.random.choice(key, particles.shape[0], shape=(m_total,), p=p)
    samp = particles[idx]
    samp_w = weights[idx]

    # Discretized (x, y, theta) bins; C-style truncation toward zero
    # (kd_tree.hpp:99-102 uses static_cast<int>).
    keys = jnp.trunc(samp / bin_sizes[None, :]).astype(jnp.int32)  # [M, 3]
    # First-occurrence-in-draw-order per bin, O(M log M): lexsort the keys
    # so equal bins are contiguous, number the groups, take each group's
    # minimum draw index, and mark the draws equal to it.  (Replaces the
    # O(M^2) all-pairs comparison, which dominates the fused PF step at
    # 5000 particles.)
    order = jnp.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    ks = keys[order]                                               # [M, 3]
    new_group = jnp.concatenate([
        jnp.ones((1,), bool),
        jnp.any(ks[1:] != ks[:-1], axis=-1)])
    gid = jnp.cumsum(new_group.astype(jnp.int32)) - 1              # [M]
    first_draw = jax.ops.segment_min(order, gid, num_segments=m_total)
    first_sorted = order == first_draw[gid]
    first = jnp.zeros(m_total, bool).at[order].set(first_sorted)
    k = jnp.cumsum(first.astype(jnp.int32))                        # [M] k(m)

    kf = k.astype(samp.dtype)
    a = (kf - 1.0) / (2.0 * kld_err)
    b = 2.0 / (9.0 * jnp.maximum(kf - 1.0, 1.0))
    c = 1.0 - b + jnp.sqrt(b) * kld_z
    mx = jnp.floor(a * c * c * c).astype(jnp.int32)
    mx = jnp.where(k > 1, mx, jnp.int32(m_total))

    m_idx = jnp.arange(1, m_total + 1)
    done = (m_idx >= min_particles) & (m_idx >= mx)
    n_active = jnp.where(jnp.any(done),
                         jnp.argmax(done) + 1, jnp.int32(m_total))
    return samp, samp_w, n_active.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=(
    "mcfg", "min_particles", "max_particles"))
def pf_step(key_motion, key_resample, particles, mask, control,
            mcfg, grid, points, point_mask, num_points,
            alphas, kld_err, kld_z, bin_sizes,
            min_particles: int, max_particles: int):
    """Fused particle-filter scan update: motion sample + batched NDT
    measurement + KLD resample + statistics in ONE device dispatch.

    Semantically identical to calling update() / measure() / resample() /
    updateStatistics() in sequence (the laserCallback PF branch,
    ndt_mapper.cpp:471-476) — the intermediate statistics refreshes of the
    sequential path only normalize weights that the next stage re-normalizes
    anyway.  Returns (particles, weights, n_active, mean, cov).
    """
    p = motion_model.sample(key_motion, particles, control[0], control[1],
                            control[2], alphas[0], alphas[1], alphas[2],
                            alphas[3])
    scores = matcher_mod.score_points_batch(mcfg, grid, points, point_mask,
                                            num_points, p)
    p, w, n = kld_resample(key_resample, p, scores, mask, kld_err, kld_z,
                           bin_sizes, min_particles, max_particles)
    new_mask = jnp.arange(max_particles) < n
    w, mean, cov = update_statistics(p, w, new_mask)
    return p, w, n, mean, cov


@functools.partial(jax.jit, static_argnames=(
    "mcfg", "min_particles", "max_particles"))
def pf_step_recovery(key_motion, key_resample, key_inject, particles, mask,
                     control, mcfg, grid, points, point_mask, num_points,
                     alphas, kld_err, kld_z, bin_sizes,
                     min_particles: int, max_particles: int,
                     free_xy, free_cell, w_slow, w_fast,
                     alpha_slow, alpha_fast):
    """pf_step + AMCL w_slow/w_fast recovery (Probabilistic Robotics
    table 8.3), still ONE fused device dispatch.

    The per-scan average measurement quality w_avg (the positive mean NDT
    likelihood over active particles; score_points_batch returns its
    negation) feeds two EWMAs: w_slow (long-term) and w_fast (short-term).
    After KLD resampling, each surviving particle is replaced with
    probability max(0, 1 - w_fast/w_slow) by a uniform draw over the map's
    free space — so a sustained drop in measurement quality (kidnapping,
    divergence) injects exploration mass exactly the way AMCL does.  The
    reference filter has no such recovery (README.md:123-127).

    With w_fast >= w_slow (injection probability 0) the returned cloud is
    BITWISE identical to pf_step on the same key_motion/key_resample
    (pinned by tests/test_particle.py).

    Args (beyond pf_step):
      key_inject: RNG key for the injection draws.
      free_xy: [F, 2] world-frame centers of free map cells.
      free_cell: scalar — jitter each draw uniformly within its cell.
      w_slow, w_fast: scalar EWMA state (0.0 = uninitialized, AMCL's own
        convention: first update seeds both to w_avg).
      alpha_slow, alpha_fast: EWMA gains (config.recovery_alpha_*).

    Returns (particles, weights, n_active, mean, cov, w_slow', w_fast').
    """
    p = motion_model.sample(key_motion, particles, control[0], control[1],
                            control[2], alphas[0], alphas[1], alphas[2],
                            alphas[3])
    scores = matcher_mod.score_points_batch(mcfg, grid, points, point_mask,
                                            num_points, p)
    goodness = -scores                       # positive mean likelihood
    n_in = jnp.maximum(jnp.sum(mask), 1)
    w_avg = jnp.sum(jnp.where(mask, goodness, 0.0)) / n_in.astype(
        goodness.dtype)
    w_slow = jnp.where(w_slow == 0.0, w_avg,
                       w_slow + alpha_slow * (w_avg - w_slow))
    w_fast = jnp.where(w_fast == 0.0, w_avg,
                       w_fast + alpha_fast * (w_avg - w_fast))
    p_inject = jnp.maximum(0.0, 1.0 - w_fast / jnp.maximum(w_slow, 1e-30))

    samp, samp_w, n = kld_resample(key_resample, p, scores, mask, kld_err,
                                   kld_z, bin_sizes, min_particles,
                                   max_particles)
    new_mask = jnp.arange(max_particles) < n
    samp, samp_w = inject_free_space(key_inject, samp, samp_w, n, free_xy,
                                     free_cell, p_inject, max_particles)
    w, mean, cov = update_statistics(samp, samp_w, new_mask)
    return samp, w, n, mean, cov, w_slow, w_fast


@functools.partial(jax.jit, static_argnames=("max_particles",))
def inject_free_space(key, particles, weights, n, free_xy, free_cell,
                      p_inject, max_particles: int):
    """Replace each active particle with probability ``p_inject`` by a
    uniform draw over the map's free space (AMCL recovery injection).

    Shared by the fused pf_step_recovery and the granular resample() path
    (mesh-mode PF) so the two cannot drift.
    """
    new_mask = jnp.arange(max_particles) < n
    k_sel, k_idx, k_jit, k_th = jax.random.split(key, 4)
    m = max_particles
    inject = (jax.random.uniform(k_sel, (m,)) < p_inject) & new_mask
    idx = jax.random.randint(k_idx, (m,), 0, free_xy.shape[0])
    jit_xy = jax.random.uniform(k_jit, (m, 2), particles.dtype, -0.5, 0.5)
    th = jax.random.uniform(k_th, (m, 1), particles.dtype, -np.pi, np.pi)
    rand_p = jnp.concatenate([free_xy[idx] + jit_xy * free_cell, th],
                             axis=-1)
    # Injected particles take the active mean weight: neutral in the
    # statistics, corrected by the next scan's measurement (AMCL gives its
    # random particles the uniform 1/M weight for the same reason).
    neutral_w = (jnp.sum(jnp.where(new_mask, weights, 0.0))
                 / jnp.maximum(n, 1).astype(weights.dtype))
    out_p = jnp.where(inject[:, None], rand_p, particles)
    out_w = jnp.where(inject, neutral_w, weights)
    return out_p, out_w


class ParticleFilter:
    """Host-side stateful wrapper (the reference class surface:
    init / update / measure / resample / getMean / getCovariance,
    include/ndt_2d/particle_filter.hpp:45-115)."""

    def __init__(self, config: ParticleFilterConfig, seed: int = 0):
        self.config = config
        self._key = jax.random.PRNGKey(seed)
        m = config.max_particles
        self.particles = jnp.zeros((m, 3), jnp.float32)
        self.weights = jnp.full((m,), 1.0 / config.min_particles, jnp.float32)
        self.n_active = config.min_particles
        # Device-resident active count, set by step_async: lets the NEXT
        # step's mask derive on device without waiting for the host fetch
        # (the pipelined localization path, mapping/mapper.py).
        self._n_dev = None
        # AMCL recovery state (pf_step_recovery): free-space sample pool and
        # the w_slow/w_fast EWMAs, chained on device so the pipelined path
        # never blocks on them.  0.0 = uninitialized (first w_avg seeds both).
        self.free_xy = None
        self.free_cell = 0.0
        self.w_slow = jnp.float32(0.0)
        self.w_fast = jnp.float32(0.0)
        self._refresh_statistics()

    # ------------------------------------------------------------------
    def _split(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    @property
    def mask(self):
        if self._n_dev is not None:
            return jnp.arange(self.config.max_particles) < self._n_dev
        return jnp.arange(self.config.max_particles) < self.n_active

    def _refresh_statistics(self):
        self._n_dev = None
        self.weights, self._mean, self._cov = update_statistics(
            self.particles, self.weights, self.mask)

    # ------------------------------------------------------------------
    def init(self, x, y, theta, sigma_x, sigma_y, sigma_theta):
        """Gaussian-seed the particle cloud (particle_filter.cpp:53-69)."""
        noise = jax.random.normal(self._split(), (self.config.max_particles, 3),
                                  jnp.float32)
        mean = jnp.asarray([x, y, theta], jnp.float32)
        sig = jnp.asarray([sigma_x, sigma_y, sigma_theta], jnp.float32)
        p = mean + noise * sig
        self.particles = p.at[:, 2].set(normalize_angle(p[:, 2]))
        self.weights = jnp.full((self.config.max_particles,),
                                1.0 / self.n_active, jnp.float32)
        self.w_slow = jnp.float32(0.0)
        self.w_fast = jnp.float32(0.0)
        self._refresh_statistics()

    def init_global(self, free_xy, cell_size: float):
        """Global-localization seeding: uniform over free space x uniform
        heading (AMCL's global_localization service; the reference has no
        equivalent — it requires a manual initialpose after map load,
        README.md:50-52).  Cheap on device: the whole max_particles cloud is
        scored in one batched measurement.

        Args:
          free_xy: [N, 2] world-frame centers of free map cells.
          cell_size: jitter each draw uniformly within its cell.
        """
        m = self.config.max_particles
        k1, k2, k3 = jax.random.split(self._split(), 3)
        free = jnp.asarray(free_xy, jnp.float32)
        idx = jax.random.randint(k1, (m,), 0, free.shape[0])
        jit_xy = jax.random.uniform(k2, (m, 2), jnp.float32, -0.5, 0.5)
        th = jax.random.uniform(k3, (m, 1), jnp.float32, -np.pi, np.pi)
        p = jnp.concatenate([free[idx] + jit_xy * cell_size, th], axis=-1)
        self.particles = p
        self.n_active = m
        self.weights = jnp.full((m,), 1.0 / m, jnp.float32)
        self.w_slow = jnp.float32(0.0)
        self.w_fast = jnp.float32(0.0)
        # The free-space pool doubles as the recovery injection pool.
        self.set_free_space(free, cell_size)
        self._refresh_statistics()

    def set_free_space(self, free_xy, cell_size: float) -> None:
        """Provide the free-space sample pool used by AMCL-style recovery
        injection (pf_step_recovery).  Recovery activates when both
        config.recovery_alpha_* are > 0 AND a pool is set."""
        self.free_xy = jnp.asarray(free_xy, jnp.float32)
        self.free_cell = float(cell_size)

    @property
    def recovery_enabled(self) -> bool:
        c = self.config
        return (c.recovery_alpha_slow > 0.0 and c.recovery_alpha_fast > 0.0
                and self.free_xy is not None and len(self.free_xy) > 0)

    def update(self, dx, dy, dth):
        """Motion update (particle_filter.cpp:71-76)."""
        c = self.config
        self.particles = motion_model.sample(
            self._split(), self.particles, dx, dy, dth,
            c.odom_alpha1, c.odom_alpha2, c.odom_alpha3, c.odom_alpha4)
        self._refresh_statistics()

    def measure(self, matcher, points, point_mask, num_points, mesh=None,
                host_grid=None):
        """Measurement update: weight_i = scorePoints(scan, particle_i)
        (particle_filter.cpp:78-89).  The raw (negative) NDT score is used
        directly as the weight and becomes positive on normalization, exactly
        as in the reference.

        When recovery is armed, the w_slow/w_fast EWMAs update here from the
        RAW scores (the granular path normalizes weights immediately after,
        losing the absolute measurement quality the EWMAs need), and
        resample() performs the matching free-space injection — so the
        granular update/measure/resample sequence (the mesh-mode PF path)
        has the same recovery behavior as the fused pf_step_recovery.

        ``mesh``: optional jax mesh — shards the particle axis over the
        'batch' axis (parallel.filter.measure_multichip); pure data
        parallelism, identical scores.  ``host_grid``: the grid as
        host-side arrays — REQUIRED when the mesh spans processes (the
        matcher's own grid is a process-local device array there); the
        particle state also feeds as process-replicated numpy and the
        sharded scores come back via one process_allgather.
        """
        if mesh is not None:
            from ndt_2d_tpu.parallel import distributed
            from ndt_2d_tpu.parallel import filter as pfilter
            from ndt_2d_tpu.parallel.mesh import BATCH_AXIS
            multiproc = distributed.is_multiprocess(mesh)
            m = self.particles.shape[0]
            nb = mesh.shape[BATCH_AXIS]
            m_pad = -(-m // nb) * nb
            parts = (jnp.pad(self.particles, ((0, m_pad - m), (0, 0)))
                     if m_pad != m else self.particles)
            grid = host_grid if host_grid is not None else matcher.grid
            if multiproc:
                parts = np.asarray(parts, np.float32)
                args = (np.asarray(points, np.float32),
                        np.asarray(point_mask), np.int32(num_points))
            else:
                args = (jnp.asarray(points), jnp.asarray(point_mask),
                        jnp.asarray(num_points))
            scores = pfilter.measure_multichip(
                matcher.config, mesh, grid, *args, parts)
            if multiproc:
                scores = jnp.asarray(distributed.fetch(scores))
            scores = scores[:m]
        else:
            scores = matcher_mod.score_points_batch(
                matcher.config, matcher.grid, jnp.asarray(points),
                jnp.asarray(point_mask), jnp.asarray(num_points),
                self.particles)
        if self.recovery_enabled:
            c = self.config
            goodness = -scores
            n_in = jnp.maximum(jnp.sum(self.mask), 1)
            w_avg = (jnp.sum(jnp.where(self.mask, goodness, 0.0))
                     / n_in.astype(goodness.dtype))
            self.w_slow = jnp.where(
                self.w_slow == 0.0, w_avg,
                self.w_slow + c.recovery_alpha_slow * (w_avg - self.w_slow))
            self.w_fast = jnp.where(
                self.w_fast == 0.0, w_avg,
                self.w_fast + c.recovery_alpha_fast * (w_avg - self.w_fast))
        self.weights = scores
        self._refresh_statistics()

    def resample(self, kld_err=None, kld_z=None):
        c = self.config
        kld_err = c.kld_err if kld_err is None else kld_err
        kld_z = c.kld_z if kld_z is None else kld_z
        bins = jnp.asarray([c.kld_bin_x, c.kld_bin_y, c.kld_bin_theta],
                           jnp.float32)
        self.particles, self.weights, n = kld_resample(
            self._split(), self.particles, self.weights, self.mask,
            jnp.float32(kld_err), jnp.float32(kld_z), bins,
            c.min_particles, c.max_particles)
        self.n_active = int(n)
        if self.recovery_enabled:
            p_inject = jnp.maximum(
                0.0, 1.0 - self.w_fast / jnp.maximum(self.w_slow, 1e-30))
            self.particles, self.weights = inject_free_space(
                self._split(), self.particles, self.weights, n,
                self.free_xy, jnp.float32(self.free_cell), p_inject,
                c.max_particles)
        self._refresh_statistics()

    def step_async(self, matcher, control, points, point_mask, num_points):
        """Dispatch one fused PF scan update (pf_step) WITHOUT fetching the
        result: the particle/weight/count state chains on device, so the
        next step can dispatch before this one's statistics reach the host.
        Device->host copies start immediately (copy_to_host_async); pass the
        returned handle to resolve_async() to finalize.
        """
        import jax

        c = self.config
        alphas = jnp.asarray([c.odom_alpha1, c.odom_alpha2, c.odom_alpha3,
                              c.odom_alpha4], jnp.float32)
        bins = jnp.asarray([c.kld_bin_x, c.kld_bin_y, c.kld_bin_theta],
                           jnp.float32)
        if self.recovery_enabled:
            k1, k2, k3 = jax.random.split(self._split(), 3)
            p, w, n, mean, cov, self.w_slow, self.w_fast = pf_step_recovery(
                k1, k2, k3, self.particles, self.mask,
                jnp.asarray(control, jnp.float32), matcher.config,
                matcher.grid, jnp.asarray(points), jnp.asarray(point_mask),
                jnp.int32(num_points), alphas, jnp.float32(c.kld_err),
                jnp.float32(c.kld_z), bins, c.min_particles, c.max_particles,
                self.free_xy, jnp.float32(self.free_cell),
                self.w_slow, self.w_fast,
                jnp.float32(c.recovery_alpha_slow),
                jnp.float32(c.recovery_alpha_fast))
        else:
            k1, k2 = jax.random.split(self._split())
            p, w, n, mean, cov = pf_step(
                k1, k2, self.particles, self.mask,
                jnp.asarray(control, jnp.float32), matcher.config,
                matcher.grid, jnp.asarray(points), jnp.asarray(point_mask),
                jnp.int32(num_points), alphas, jnp.float32(c.kld_err),
                jnp.float32(c.kld_z), bins, c.min_particles, c.max_particles)
        self.particles, self.weights = p, w
        self._n_dev = n
        for leaf in (n, mean, cov):
            leaf.copy_to_host_async()
        return (n, mean, cov)

    def resolve_async(self, handle):
        """Fetch a step_async result into the host-visible statistics;
        returns the mean pose."""
        import jax

        n, self._mean, self._cov = jax.device_get(handle)
        self.n_active = int(n)
        return np.asarray(self._mean)

    def step(self, matcher, control, points, point_mask, num_points):
        """Fused per-scan update (see pf_step): one device dispatch, one
        result fetch.  Replaces update()+measure()+resample() in the hot
        localization loop."""
        return self.resolve_async(
            self.step_async(matcher, control, points, point_mask,
                            num_points))

    # ------------------------------------------------------------------
    def get_mean(self):
        return np.asarray(self._mean)

    def get_covariance(self):
        return np.asarray(self._cov)

    def cloud(self):
        """Active particles as numpy (the particlecloud PoseArray analog,
        particle_filter.cpp:149-161)."""
        return np.asarray(self.particles[:self.n_active])
