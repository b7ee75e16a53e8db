"""The mapper runtime: SLAM / localization orchestration.

Re-design of the reference's ``ndt_2d::Mapper`` node
(src/ndt_mapper.cpp:48-749).  The reference runs three POSIX threads sharing
state under two mutexes (README.md:129-142); here the runtime is a
single-threaded, deterministic host loop driving jitted device computations:

* ``process_scan``  == laserCallback (ndt_mapper.cpp:267-567): motion gate,
  odometry dead-reckoning, de-skewed projection, then the mapping /
  particle-filter / scan-match-localization branch.
* ``loop_closure``  == one iteration of loopClosureThread
  (ndt_mapper.cpp:569-685), invoked synchronously on a scan cadence
  (config.loop_closure_every) instead of a 1 Hz wall-clock thread.
* ``render_map`` / ``map_to_odom`` == mapPublishThread products
  (ndt_mapper.cpp:687-744), computed on demand.
* ``set_initial_pose`` == poseCallback (ndt_mapper.cpp:188-265).
* ``configure``      == the Configure service (ndt_mapper.cpp:155-186).

Instead of TF lookups, callers pass the odometry-frame robot pose at scan
start (and optionally scan end, for de-skew) along with each scan message.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

from ndt_2d_tpu.config import MapperConfig
from ndt_2d_tpu.graph import pose_graph, solver
from ndt_2d_tpu.filter.particle_filter import ParticleFilter
from ndt_2d_tpu.mapping import laser, occupancy
from ndt_2d_tpu.matching import registry
from ndt_2d_tpu.utils.profiling import SessionStats
from ndt_2d_tpu.utils.sim import LaserScanMsg

logger = logging.getLogger("ndt_2d_tpu.mapper")


def _normalize_angle(a: float) -> float:
    return float(a - 2.0 * np.pi * np.floor((a + np.pi) / (2.0 * np.pi)))


# Configure service actions (srv/Configure.srv).
ENABLE_MAPPING = 1
DISABLE_MAPPING = 2
LOAD_FROM_FILE = 4
SAVE_TO_FILE = 8


@dataclasses.dataclass
class ScanResult:
    """Outcome of one process_scan call (the reference logs these,
    ndt_mapper.cpp:497-517)."""

    accepted: bool
    scan_id: int = -1
    pose: Optional[np.ndarray] = None
    uncorrected_score: float = 0.0
    matched_score: float = 0.0
    correction: Optional[np.ndarray] = None
    # Pipelined paths (config.max_inflight > 0) defer the pose: ``pose`` is
    # None and this holds the device array of the corrected pose (its
    # device->host copy is already in flight).  Resolve with
    # jax.device_get AFTER Mapper.flush(); or read graph poses instead.
    pose_future: Optional[object] = None
    # Device array of the match score for deferred scans (None for PF).
    score_future: Optional[object] = None


class Mapper:
    def __init__(self, config: MapperConfig = MapperConfig(),
                 graph: Optional[pose_graph.Graph] = None,
                 laser_transform=np.zeros(3),
                 laser_inverted: Optional[bool] = None,
                 laser_rotation=None, seed: int = 0, mesh=None):
        """Args (laser extrinsic, mirroring the reference's first-scan TF
        lookup, ndt_mapper.cpp:271-290):
          laser_transform: (x, y, theta) robot->laser 2D extrinsic.
          laser_rotation: optional full (x, y, z, w) robot->laser rotation
            quaternion.  When given, the yaw overrides laser_transform[2]
            and an upside-down mount is AUTO-DETECTED the way the reference
            does from the TF quaternion (|q.x| or |q.y| > 0.02,
            ndt_mapper.cpp:278-283).
          laser_inverted: explicit override of the mirrored-laser branch;
            None (default) = auto-detect from laser_rotation (False if no
            rotation given).
          mesh: optional jax.sharding.Mesh (parallel.mesh.make_mesh) — runs
            the FULL pipeline sharded: the rolling match's candidate angles
            over the 'space' axis, loop-closure candidate windows over
            'batch' (each window's match angle-sharded over 'space'),
            pose-graph constraints over 'batch', occupancy rays over the
            whole mesh.  Host-side orchestration (gates, constraints,
            cadences) is identical to the single-device runtime, so the
            decisions — and on exact-reduction paths, the bits — match it.
            max_inflight composes with BOTH single- and multi-process
            meshes (the pipelined pose chain dispatches the angle-sharded
            runtime.mapping_step_async_multichip; under multi-process the
            window/pose state threads through as replicated jit-output
            global arrays while fresh per-scan inputs stay
            process-replicated numpy — the standard multi-controller
            training-loop pattern).
        """
        self.config = config
        self.mesh = mesh
        # Multi-process mesh (jax.distributed): device inputs must be host
        # numpy (process-replicated) rather than committed single-device jnp
        # arrays, and mesh-sharded outputs fetch via process_allgather.  See
        # parallel/distributed.py for the process model.
        if mesh is not None:
            from ndt_2d_tpu.parallel import distributed
            self._mp = distributed.is_multiprocess(mesh)
        else:
            self._mp = False
        self._host_grid_cache = None
        self.enable_mapping = config.enable_mapping
        self.use_particle_filter = config.use_particle_filter
        self.range_max = config.max_range

        loaded = graph is not None
        self.graph = graph if loaded else pose_graph.Graph(
            config.max_points_per_scan, config.use_barycenter)

        self.laser_transform = np.asarray(laser_transform, np.float64)
        if laser_rotation is not None:
            xy_yaw, detected = laser.extrinsic_from_transform(
                np.concatenate([self.laser_transform[:2], [0.0]]),
                laser_rotation)
            self.laser_transform = xy_yaw
            if laser_inverted is None and detected:
                logger.warning("Treating laser as inverted")
            self.laser_inverted = (detected if laser_inverted is None
                                   else laser_inverted)
        else:
            self.laser_inverted = bool(laser_inverted)

        self.local_matcher = None
        self.global_matcher = None
        self.coarse_matcher = None

        self.prev_odom_pose = np.zeros(3)
        self.prev_robot_pose = np.zeros(3)
        # A loaded map requires re-localization first (ndt_mapper.cpp:114).
        self.prev_odom_pose_is_initialized = not loaded

        self.typical_matcher_response = -0.5   # ndt_mapper.cpp:55
        self.global_scans_processed = 0
        self.optimization_last = 0
        self.map_update_available = loaded

        self.filter: Optional[ParticleFilter] = None
        if self.use_particle_filter:
            self.filter = ParticleFilter(config.particle_filter, seed=seed)

        self._scans_since_loop_closure = 0
        self.stats = SessionStats()
        # Loop-closure observability (fed by _loop_candidates/_apply_gate):
        # "candidates" rows are (query_idx, tuple(candidate ids)); "decisions"
        # rows are (query_idx, candidate_id, score, gate, accepted).  Powers
        # the precision/recall benchmark (benchmarks/loop_closure_pr.py); the
        # reference's only signal here is a log line (ndt_mapper.cpp:648,666).
        # Bounded (FIFO) so a long-lived serve session cannot grow RSS
        # without limit; benchmark sessions stay far below the cap.
        from collections import deque
        self.lc_log = {"candidates": deque(maxlen=100_000),
                       "decisions": deque(maxlen=100_000)}
        # Device-resident rolling window (matcher.RollingWindow); rebuilt
        # from the graph whenever poses change outside the append path
        # (optimization, map load, initial pose).  _window_synced tracks how
        # many graph scans the window reflects; -1 forces a rebuild.
        self._window = None
        self._window_poses_host = None  # host mirror for capacity checks
        self._window_mask_host = None
        self._window_synced = -1
        self._range_max_dev = None
        # Pipelined mapping (config.max_inflight > 0): device-resident pose
        # chain + FIFO of in-flight (scan_id, device results) not yet drained
        # into the graph.  _approx_pose dead-reckons odometry-only on the
        # host for the window capacity check (corrections are cm-scale).
        self._pending = []
        self._pose_dev = None
        self._approx_pose = None
        # Mesh mode: per-pass all-to-all descriptor top-k cache.
        self._desc_topk = None
        # Far-candidate pruning state (config.loop_closure_far_dedup /
        # _reject_cache_margin): last-seen descriptor similarity per
        # (query, candidate) row (cleared per pass) and the cross-pass
        # negative cache of clearly-rejected far (query cell, candidate
        # cell) pairs (cleared on any acceptance / optimization).
        self._desc_sim = {}
        self._reject_cache = {}
        # Rows already counted in stats.far_rows_pruned this
        # loop_closure() call (pass restarts re-prune the same rows).
        self._pruned_counted = set()

    # ------------------------------------------------------------------
    def _ensure_matchers(self, msg_range_max: float) -> None:
        """Lazy matcher construction on the first scan (the reference defers
        until range_max is known, ndt_mapper.cpp:270-313)."""
        if self.local_matcher is not None:
            return
        if self.range_max < 0:
            self.range_max = float(msg_range_max)
        mtype = self.config.scan_matcher_type
        gcfg = self.config.global_scan_matcher
        if (self.use_particle_filter or not self.enable_mapping) \
                and self.graph.num_scans:
            # Localization builds ONE global NDT over the whole loaded map
            # (ndt_mapper.cpp:296-303).  The reference sizes its grid
            # dynamically from the scan bounding box (scan_matcher_ndt.cpp:
            # 52-67); our grids are static for XLA, so grow the configured
            # extent to fit the map (rounded up to 32-cell multiples to keep
            # compilation signatures coarse).  Never shrink below config.
            wp = np.asarray(self.graph.poses[:, :2], np.float64)
            span = wp.max(0) - wp.min(0) + 2.0 * self.range_max
            need = np.ceil(span / gcfg.ndt_resolution).astype(int) + 1
            gx = max(gcfg.grid_cells_x, int(-(-need[0] // 32) * 32))
            gy = max(gcfg.grid_cells_y, int(-(-need[1] // 32) * 32))
            if (gx, gy) != (gcfg.grid_cells_x, gcfg.grid_cells_y):
                logger.info("Auto-sizing global NDT grid to %dx%d cells "
                            "for the loaded map", gx, gy)
                gcfg = dataclasses.replace(gcfg, grid_cells_x=gx,
                                           grid_cells_y=gy)
        self.global_matcher = registry.create(mtype, gcfg, self.range_max)
        self.local_matcher = registry.create(
            mtype, self.config.local_scan_matcher, self.range_max)
        if (self.enable_mapping
                and getattr(self.local_matcher.config, "refine_iterations",
                            0) > 0):
            # Measured on synthetic corridors: continuous refinement against
            # the rolling window drags poses sub-cell toward the window's own
            # history and worsens trajectory ATE (see matching/newton.py).
            logger.warning(
                "Newton refinement is enabled on the LOCAL (rolling-window) "
                "matcher while mapping; this was measured to worsen "
                "trajectory ATE. Prefer refinement on the global matcher "
                "only (localization / loop-closure confirmation).")
        if self.config.loop_search in ("descriptor", "both"):
            self.coarse_matcher = registry.create(
                mtype, self.config.coarse_scan_matcher, self.range_max)
        else:
            self.coarse_matcher = None
        if self.use_particle_filter or not self.enable_mapping:
            # Localization: global NDT over ALL scans of the loaded map
            # (ndt_mapper.cpp:296-303), built once.
            if self.graph.num_scans:
                self.global_matcher.add_scans(
                    self.graph.poses.astype(np.float32), self.graph.points,
                    self.graph.point_mask)

    # ------------------------------------------------------------------
    def set_initial_pose(self, pose, covariance, odom_pose) -> bool:
        """poseCallback (ndt_mapper.cpp:188-265).

        Args:
          pose: (x, y, theta) in map frame; covariance: [3, 3] or diagonal 3;
          odom_pose: current robot pose in the odometry frame.
        """
        self._drain_all()
        if self.enable_mapping and self.prev_odom_pose_is_initialized:
            logger.warning("Ignoring initial pose, already mapping")
            return False
        pose = np.asarray(pose, np.float64)
        cov = np.asarray(covariance, np.float64)
        if cov.ndim == 1:
            cov = np.diag(cov)

        if self.use_particle_filter:
            self.filter.init(pose[0], pose[1], pose[2],
                             np.sqrt(cov[0, 0]), np.sqrt(cov[1, 1]),
                             np.sqrt(cov[2, 2]))
        elif self.enable_mapping:
            # Connect this pose to the graph (ndt_mapper.cpp:231-256).
            nearest = self.graph.find_nearest(pose[:2])
            if len(nearest) == 0:
                logger.error(
                    "Cannot localize robot, not close enough to existing graph")
                return False
            empty_pts = np.zeros((self.config.max_points_per_scan, 2),
                                 np.float32)
            empty_mask = np.zeros(self.config.max_points_per_scan, bool)
            scan_id = self.graph.add_scan(pose, empty_pts, empty_mask)
            pose_graph.make_constraint_np(self.graph, int(nearest[0]),
                                          scan_id, cov)

        self.prev_robot_pose = pose.copy()
        self.prev_odom_pose = np.asarray(odom_pose, np.float64).copy()
        self.prev_odom_pose_is_initialized = True
        self._pose_dev = None  # restart any device pose chain from here
        logger.info("Localized to %f, %f, %f", *pose)
        return True

    # ------------------------------------------------------------------
    def _map_free_space(self):
        """World-frame centers of observed-free occupancy cells, or None.

        Renders the occupancy grid directly: render_map() would clear the
        map_update_available publisher flag as a side effect, suppressing
        the post-load map publish in the live-serve runtime.
        """
        g = self.graph
        grid = occupancy.render_occupancy(
            g.poses, g.points, g.point_mask, self.config.resolution,
            self.config.occupancy_threshold, mesh=self.mesh)
        free = np.argwhere(grid.data == 0)                 # [N, (iy, ix)]
        if not len(free):
            return None
        centers = grid.origin + (free[:, ::-1] + 0.5) * grid.resolution
        return centers, grid.resolution

    # ------------------------------------------------------------------
    def global_localize(self, odom_pose) -> bool:
        """Global relocalization: seed the particle cloud uniformly over the
        map's free space (AMCL's global_localization service; the reference
        has no equivalent — after a map load it requires a manual initialpose,
        README.md:50-52, ndt_mapper.cpp:316-320).

        Requires particle-filter localization mode and a loaded map.  The
        filter converges over the next few scans as the batched NDT
        measurement concentrates weight on consistent hypotheses.
        """
        self._drain_all()
        if not self.use_particle_filter or self.filter is None:
            logger.error("global_localize requires use_particle_filter")
            return False
        if not self.graph.num_scans:
            logger.error("global_localize requires a loaded map")
            return False
        fs = self._map_free_space()
        if fs is None:
            logger.error("map has no observed-free cells")
            return False
        centers, res = fs
        self.filter.init_global(centers, res)
        self._pose_dev = None
        self.prev_robot_pose = self.filter.get_mean().astype(np.float64)
        self.prev_odom_pose = np.asarray(odom_pose, np.float64).copy()
        self.prev_odom_pose_is_initialized = True
        logger.info("Global localization: %d particles over %d free cells",
                    self.filter.n_active, len(centers))
        return True

    # ------------------------------------------------------------------
    def process_scan(self, msg: LaserScanMsg, odom_pose,
                     odom_pose_end=None) -> ScanResult:
        """laserCallback (ndt_mapper.cpp:267-567)."""
        self._ensure_matchers(msg.range_max)

        if not self.prev_odom_pose_is_initialized:
            logger.warning("Can not handle scan, not localized within map")
            self.stats.record_scan(False)
            return ScanResult(accepted=False)

        odom_pose = np.asarray(odom_pose, np.float64)
        robot_pose = np.zeros(3)

        if self.graph.num_scans:
            # Motion gate (ndt_mapper.cpp:343-355).
            dx = odom_pose[0] - self.prev_odom_pose[0]
            dy = odom_pose[1] - self.prev_odom_pose[1]
            dth = _normalize_angle(odom_pose[2] - self.prev_odom_pose[2])
            dist = dx * dx + dy * dy
            cfg = self.config
            if (dist < cfg.minimum_travel_distance ** 2
                    and abs(dth) < cfg.minimum_travel_rotation):
                self.stats.record_scan(False)
                return ScanResult(accepted=False)
            # Dead-reckon the map-frame pose from the odometry delta,
            # corrected by the odom->map heading offset (ndt_mapper.cpp:357-364).
            heading = _normalize_angle(
                self.prev_robot_pose[2] - self.prev_odom_pose[2])
            ch, sh = np.cos(heading), np.sin(heading)
            robot_pose = np.asarray([
                self.prev_robot_pose[0] + dx * ch - dy * sh,
                self.prev_robot_pose[1] + dx * sh + dy * ch,
                _normalize_angle(self.prev_robot_pose[2] + dth)])

        # De-skew translation: odometry motion across the sweep
        # (ndt_mapper.cpp:366-395).
        if odom_pose_end is not None:
            translation = np.asarray(odom_pose_end, np.float64) - odom_pose
        else:
            translation = np.zeros(3)

        points, mask = laser.project_scan(
            msg, self.range_max, self.laser_transform, self.laser_inverted,
            translation, self.config.max_points_per_scan)
        num_points = int(mask.sum())

        if self.use_particle_filter:
            return self._process_particle_filter(robot_pose, odom_pose,
                                                 points, mask, num_points)
        elif self.enable_mapping:
            return self._process_mapping(robot_pose, odom_pose, points, mask,
                                         num_points)
        else:
            return self._process_localization(robot_pose, odom_pose, points,
                                              mask, num_points)

    # ------------------------------------------------------------------
    def _mesh_grid(self, m):
        """Global-matcher grid as a mesh-program input.  Single-process: the
        device-resident grid pytree.  Multi-process: the grid was built by a
        process-local jit, so fetch it to host once (cached until the matcher
        rebuilds it) and feed it replicated."""
        if not self._mp:
            return m.grid
        import jax
        if (self._host_grid_cache is None
                or self._host_grid_cache[0] is not m.grid):
            self._host_grid_cache = (m.grid, jax.device_get(m.grid))
        return self._host_grid_cache[1]

    def _sync_window(self):
        """(Re)build the device rolling window from the graph tail.

        Runs only when poses changed outside the append path (optimization,
        map load, initial pose); the steady-state path is window_append.
        """
        import jax.numpy as jnp

        from ndt_2d_tpu.matching import matcher as matcher_mod
        g = self.graph
        depth = self.config.rolling_depth
        if self._window_synced == g.num_scans and self._window is not None:
            return self._window
        start = max(0, g.num_scans - depth)
        n = g.num_scans - start
        poses = np.zeros((depth, 3), np.float32)
        pts = np.zeros((depth, g.max_points, 2), np.float32)
        pmask = np.zeros((depth, g.max_points), bool)
        wmask = np.zeros(depth, bool)
        if n:  # newest scan occupies the LAST slot (window_append order)
            poses[depth - n:] = g.poses[start:].astype(np.float32)
            pts[depth - n:] = g.points[start:]
            pmask[depth - n:] = g.point_mask[start:]
            wmask[depth - n:] = True
        if self._mp:
            # Multi-process: host arrays feed the mesh jit replicated.
            self._window = matcher_mod.RollingWindow(poses, pts, pmask, wmask)
        else:
            self._window = matcher_mod.RollingWindow(
                jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(pmask),
                jnp.asarray(wmask))
        self._window_poses_host = poses
        self._window_mask_host = wmask
        self._window_synced = g.num_scans
        return self._window

    def _check_grid_capacity(self, poses_xy, cfg, what: str,
                             remedy: str):
        """Static-grid capacity check (the reference sizes its grid
        dynamically, scan_matcher_ndt.cpp:66; our extent is static).

        Returns None when the window fits.  When it does not:
        config.auto_grow_grids picks the next 32-multiple extent that fits
        and returns it as (gx, gy) for the caller to rebuild the matcher
        with (the reference's never-overflow behavior at one amortized
        recompile); otherwise raises with sizing advice."""
        if not len(poses_xy):
            return None
        span = poses_xy.max(0) - poses_xy.min(0) + 2 * self.range_max
        need = np.ceil(span / cfg.ndt_resolution) + 1
        if need[0] <= cfg.grid_cells_x and need[1] <= cfg.grid_cells_y:
            return None
        if not self.config.auto_grow_grids:
            raise ValueError(
                f"{what} needs {need} cells > static grid "
                f"({cfg.grid_cells_x}, {cfg.grid_cells_y}); increase "
                f"{remedy} (or set auto_grow_grids)")
        gx = max(cfg.grid_cells_x, int(-(-int(need[0]) // 32) * 32))
        gy = max(cfg.grid_cells_y, int(-(-int(need[1]) // 32) * 32))
        return gx, gy

    def _grow_matcher(self, attr: str, grown) -> None:
        """Rebuild matcher ``attr`` ('local_matcher'/'global_matcher'/
        'coarse_matcher') at the grown static extent.  The rebuilt matcher
        carries no grid state in mapping mode (grids build per dispatch),
        so only the compiled-program signature changes — one recompile,
        then the session continues where the static grid used to raise."""
        m = getattr(self, attr)
        cfg = dataclasses.replace(m.config, grid_cells_x=grown[0],
                                  grid_cells_y=grown[1])
        logger.warning("Auto-growing %s NDT grid %dx%d -> %dx%d cells "
                       "(one-time recompile)", attr, m.config.grid_cells_x,
                       m.config.grid_cells_y, grown[0], grown[1])
        setattr(self, attr, type(m)(cfg, self.range_max))

    def _check_window_capacity(self):
        wp = self._window_poses_host[self._window_mask_host]
        grown = self._check_grid_capacity(
            wp[:, :2] if len(wp) else wp, self.local_matcher.config,
            "scan window", "local_scan_matcher.grid_cells_*")
        if grown:
            self._grow_matcher("local_matcher", grown)

    def _process_mapping(self, robot_pose, odom_pose, points, mask,
                         num_points) -> ScanResult:
        """Mapping branch (ndt_mapper.cpp:495-546)."""
        import jax
        import jax.numpy as jnp

        from ndt_2d_tpu.matching import matcher as matcher_mod
        from ndt_2d_tpu.matching.matcher import NDTScanMatcher
        if (self.config.max_inflight > 0 and self.graph.num_scans
                and isinstance(self.local_matcher, NDTScanMatcher)):
            # NOTE: robot_pose was dead-reckoned from the host pose mirror,
            # which is stale while results are in flight; the pipelined path
            # recomputes the motion on device from odometry alone.
            return self._process_mapping_pipelined(odom_pose, points, mask,
                                                   num_points)
        self._drain_all()
        g = self.graph
        uncorrected = 0.0
        matched = 0.0
        correction = np.zeros(3)
        covariance = None
        pose = robot_pose.copy()

        # One host->device transfer of the new scan, reused by both the
        # match and the window append.  (Multi-process: stays host numpy —
        # replicated input to the mesh program.)
        if self._mp:
            dev_points = np.asarray(points, np.float32)
            dev_mask = np.asarray(mask)
        else:
            dev_points = jnp.asarray(points, jnp.float32)
            dev_mask = jnp.asarray(mask)

        from ndt_2d_tpu.matching.matcher import NDTScanMatcher
        fused = isinstance(self.local_matcher, NDTScanMatcher)
        if g.num_scans:
            # Rolling window of the last rolling_depth scans
            # (ndt_mapper.cpp:504-509): window-NDT build + scoring + matching
            # fused into a single device dispatch over the device-resident
            # window, fetched with one device_get.  Alternative matcher
            # plugins go through the generic ScanMatcher surface instead
            # (addScans + scoreScan + matchScan, ndt_mapper.cpp:504-515).
            window = self._sync_window()
            self._check_window_capacity()
            if self._range_max_dev is None:
                self._range_max_dev = (np.float32(self.range_max) if self._mp
                                       else jnp.float32(self.range_max))
            with self.stats.timer.section("local_match"):
                if fused and self.mesh is not None:
                    # Mesh mode: the candidate search's angle axis shards
                    # over the mesh 'space' axis (parallel.runtime).
                    from ndt_2d_tpu.parallel import runtime
                    out = runtime.match_scan_rolling_multichip(
                        self.local_matcher.config, self.mesh, window,
                        self._range_max_dev, dev_points, dev_mask,
                        np.int32(num_points),
                        np.asarray(pose, np.float32))
                elif fused:
                    # Instance config, not config.local_scan_matcher: the
                    # registry factory may have adjusted it (e.g. ndt_newton
                    # enables refine_iterations).
                    out = matcher_mod.match_scan_rolling(
                        self.local_matcher.config, window,
                        self._range_max_dev, dev_points, dev_mask,
                        jnp.int32(num_points),
                        jnp.asarray(pose, jnp.float32))
                else:
                    m = self.local_matcher
                    m.add_scans(window.poses, window.points,
                                window.point_mask, window.mask)
                    pose32 = jnp.asarray(pose, jnp.float32)
                    res = m.match_scan(dev_points, dev_mask,
                                       jnp.int32(num_points), pose32)
                    out = (m.score_points(dev_points, dev_mask,
                                          jnp.int32(num_points), pose32),
                           res.score, res.correction, res.covariance)
                unc, score, corr, cov = jax.device_get(out)
            uncorrected = float(unc)
            matched = float(score)
            correction = np.asarray(corr, np.float64)
            covariance = np.asarray(cov, np.float64)
            # EWMA of match quality -> loop-closure accept threshold
            # (ndt_mapper.cpp:518).
            self.typical_matcher_response = (
                0.95 * self.typical_matcher_response + 0.05 * matched)
            pose = pose + correction

        scan_id = g.add_scan(pose, points, mask)
        if scan_id > 0:
            # Odometry constraint from the previous scan (ndt_mapper.cpp:527-529).
            pose_graph.make_constraint_np(g, scan_id - 1, scan_id, covariance)

        # Append the corrected scan to the device window (steady-state path:
        # the only per-scan transfer is the new scan itself).  Multi-process
        # keeps the window host-side, so it rebuilds from the graph tail
        # (the transfer happens at dispatch either way).
        if self._mp:
            self._window_synced = -1
            self._sync_window()
        elif self._window is None or self._window_synced != g.num_scans - 1:
            self._window_synced = -1
            self._sync_window()
        else:
            self._window = matcher_mod.window_append(
                self._window, jnp.asarray(pose, jnp.float32), dev_points,
                dev_mask)
            self._window_poses_host = np.concatenate(
                [self._window_poses_host[1:], pose[None].astype(np.float32)])
            self._window_mask_host = np.concatenate(
                [self._window_mask_host[1:], np.ones(1, bool)])
            self._window_synced = g.num_scans

        self.prev_odom_pose = odom_pose.copy()
        self.prev_robot_pose = pose.copy()
        self.map_update_available = True
        self.stats.record_scan(True, matched if g.num_scans > 1 else None)

        self._scans_since_loop_closure += 1
        if self._scans_since_loop_closure >= self.config.loop_closure_every:
            self.loop_closure()

        return ScanResult(accepted=True, scan_id=scan_id, pose=pose,
                          uncorrected_score=uncorrected,
                          matched_score=matched, correction=correction)

    # ------------------------------------------------------------------
    def _process_mapping_pipelined(self, odom_pose, points, mask,
                                   num_points) -> ScanResult:
        """Mapping branch with the pose chain ON DEVICE and up to
        config.max_inflight steps in flight (matcher.mapping_step_async).

        The synchronous branch pays one full host<->device round trip per
        scan because the next dead-reckoned start pose needs the fetched
        correction.  Here the composition happens on device, the host never
        blocks on the result, and (pose, score, covariance) drain into the
        graph asynchronously — always completely before loop closure,
        optimization, map export, save, or a mode switch, so downstream
        consumers see the same graph as the synchronous path.

        Multi-process meshes pipeline too (round 5): the window/pose chain
        threads through as REPLICATED jit-output global arrays — the
        standard multi-controller training-loop pattern — while the fresh
        per-scan inputs stay process-replicated host numpy; drains read
        the process-local copy of the replicated outputs
        (distributed.fetch), so no per-scan cross-process fetch is added.
        """
        import jax.numpy as jnp

        from ndt_2d_tpu.matching import matcher as matcher_mod
        g = self.graph

        if self._window is None or self._window_synced != g.num_scans:
            # Entering the pipeline (or poses changed behind our back via
            # optimization / load): pending results were drained by whoever
            # invalidated the window, so host mirrors are exact here.
            assert not self._pending
            self._sync_window()
            self._pose_dev = None
        if self._pose_dev is None:
            # (Re)start the device pose chain from the exact host estimate
            # (first pipelined scan after the sync first-scan path, or after
            # a drain-and-invalidate).  Multi-process: host numpy feeds the
            # mesh program replicated; the chain continues on the returned
            # global arrays.
            assert not self._pending
            self._pose_dev = (
                np.asarray(self.prev_robot_pose, np.float32) if self._mp
                else jnp.asarray(self.prev_robot_pose, jnp.float32))
            self._approx_pose = self.prev_robot_pose.copy()
        if self._range_max_dev is None:
            self._range_max_dev = (np.float32(self.range_max) if self._mp
                                   else jnp.float32(self.range_max))

        # Odometry motion in the previous ROBOT frame — host-only inputs.
        odom_pose = np.asarray(odom_pose, np.float64)
        delta = self._odom_delta(odom_pose)

        # Approximate host pose chain (odometry-composed, no corrections)
        # for the static-grid capacity check; cm-scale error over the
        # <= max_inflight undrained scans.
        ca, sa = np.cos(self._approx_pose[2]), np.sin(self._approx_pose[2])
        self._approx_pose = np.asarray([
            self._approx_pose[0] + ca * delta[0] - sa * delta[1],
            self._approx_pose[1] + sa * delta[0] + ca * delta[1],
            _normalize_angle(self._approx_pose[2] + delta[2])])
        self._window_poses_host = np.concatenate(
            [self._window_poses_host[1:],
             self._approx_pose[None].astype(np.float32)])
        self._window_mask_host = np.concatenate(
            [self._window_mask_host[1:], np.ones(1, bool)])
        self._check_window_capacity()

        if self._mp:
            dev_points = np.asarray(points, np.float32)
            dev_mask = np.asarray(mask)
            num_in = np.int32(num_points)
            delta_in = np.asarray(delta, np.float32)
        else:
            dev_points = jnp.asarray(points, jnp.float32)
            dev_mask = jnp.asarray(mask)
            num_in = jnp.int32(num_points)
            delta_in = jnp.asarray(delta, jnp.float32)
        with self.stats.timer.section("local_match"):
            if self.mesh is not None:
                # Mesh x pipelining: same device-resident chain, candidate
                # search angle-sharded (runtime.mapping_step_async_multichip).
                from ndt_2d_tpu.parallel import runtime
                self._window, self._pose_dev, out = \
                    runtime.mapping_step_async_multichip(
                        self.local_matcher.config, self.mesh, self._window,
                        self._pose_dev, self._range_max_dev, dev_points,
                        dev_mask, num_in, delta_in)
            else:
                self._window, self._pose_dev, out = \
                    matcher_mod.mapping_step_async(
                        self.local_matcher.config, self._window,
                        self._pose_dev, self._range_max_dev, dev_points,
                        dev_mask, jnp.int32(num_points),
                        jnp.asarray(delta, jnp.float32))
            # Start the device->host copies NOW, while the host moves on to
            # the next scan: without this, the drain's device_get pays a
            # full synchronous pull round trip per scan even though the
            # compute finished long ago.
            for leaf in out:
                leaf.copy_to_host_async()

        # Graph slot now (points are host-known); pose + constraint fill in
        # at drain time.
        scan_id = g.add_scan(self._approx_pose, points, mask)
        self._window_synced = g.num_scans
        self._pending.append(("map", scan_id, out))
        self.prev_odom_pose = odom_pose.copy()
        self.map_update_available = True

        if len(self._pending) > self.config.max_inflight:
            self._drain(1)

        self._scans_since_loop_closure += 1
        if self._scans_since_loop_closure >= self.config.loop_closure_every:
            self.loop_closure()
        return ScanResult(accepted=True, scan_id=scan_id, pose=None,
                          pose_future=out[4], score_future=out[1])

    def _odom_delta(self, odom_pose) -> np.ndarray:
        """Odometry motion since the previous scan, in the previous ROBOT
        frame: R(-odom_th0) * (xy1 - xy0), dth.  Composing it onto the
        previous corrected pose reproduces the host dead-reckoning math
        (ndt_mapper.cpp:357-364), and it equals the PF's robot-centric
        control (ndt_mapper.cpp:457-468) — both are host-computable from
        consecutive odometry poses alone, which is what lets the pipelined
        paths run without the device-resident pose estimate."""
        d = odom_pose[:2] - self.prev_odom_pose[:2]
        c0, s0 = np.cos(self.prev_odom_pose[2]), np.sin(self.prev_odom_pose[2])
        return np.asarray([c0 * d[0] + s0 * d[1],
                           -s0 * d[0] + c0 * d[1],
                           _normalize_angle(odom_pose[2]
                                            - self.prev_odom_pose[2])])

    def _drain(self, k=None) -> None:
        """Resolve the oldest k in-flight pipelined steps (all if None), in
        dispatch order, so the drained state is structurally identical to
        what the synchronous path builds.  Mapping entries fill the graph
        pose, append the odometry constraint and update the EWMA;
        localization entries update the pose estimate; PF entries finalize
        the filter statistics."""
        if not self._pending:
            return
        import jax

        from ndt_2d_tpu.parallel import distributed
        g = self.graph
        n = len(self._pending) if k is None else min(k, len(self._pending))
        for _ in range(n):
            entry = self._pending.pop(0)
            if entry[0] == "map":
                _, scan_id, out = entry
                # distributed.fetch reads the process-local copy of the
                # replicated multi-process outputs (plain device_get
                # otherwise).
                unc, score, corr, cov, new_pose = distributed.fetch(out)
                pose = np.asarray(new_pose, np.float64)
                g.poses[scan_id] = pose
                if scan_id > 0:
                    pose_graph.make_constraint_np(
                        g, scan_id - 1, scan_id, np.asarray(cov, np.float64))
                matched = float(score)
                self.typical_matcher_response = (
                    0.95 * self.typical_matcher_response + 0.05 * matched)
                self.stats.record_scan(True, matched)
                self.prev_robot_pose = pose
            elif entry[0] == "loc":
                _, out = entry
                unc, score, corr, new_pose = jax.device_get(out)
                self.prev_robot_pose = np.asarray(new_pose, np.float64)
                self.stats.record_scan(True, float(score))
            else:  # "pf"
                _, out = entry
                mean = self.filter.resolve_async(out)
                self.prev_robot_pose = np.asarray(mean, np.float64)
                self.stats.record_scan(True)
        if not self._pending:
            # Re-anchor the approximate chain on the exact estimate.
            self._approx_pose = self.prev_robot_pose.copy()

    def _drain_all(self) -> None:
        self._drain(None)

    def flush(self) -> None:
        """Block until every in-flight pipelined mapping step has drained
        into the graph (no-op in synchronous mode)."""
        self._drain_all()

    # ------------------------------------------------------------------
    def _process_localization(self, robot_pose, odom_pose, points, mask,
                              num_points) -> ScanResult:
        """Scan-match-only localization branch (ndt_mapper.cpp:547-566)."""
        import jax
        import jax.numpy as jnp

        from ndt_2d_tpu.matching import matcher as matcher_mod
        from ndt_2d_tpu.matching.matcher import NDTScanMatcher
        m = self.global_matcher
        if (self.mesh is not None and isinstance(m, NDTScanMatcher)
                and m.grid is not None):
            from ndt_2d_tpu.parallel import runtime
            self._drain_all()
            grid = self._mesh_grid(m)
            with self.stats.timer.section("global_match"):
                out = runtime.match_scan_global_multichip(
                    m.config, self.mesh, grid,
                    np.asarray(points, np.float32), np.asarray(mask),
                    np.int32(num_points),
                    np.asarray(robot_pose, np.float32))
                unc, score, corr, _ = jax.device_get(out)
            correction = np.asarray(corr, np.float64)
            pose = robot_pose + correction
            self.prev_odom_pose = odom_pose.copy()
            self.prev_robot_pose = pose.copy()
            self.stats.record_scan(True, float(score))
            return ScanResult(accepted=True, pose=pose,
                              uncorrected_score=float(unc),
                              matched_score=float(score),
                              correction=correction)
        if (self.config.max_inflight > 0 and isinstance(m, NDTScanMatcher)
                and m.grid is not None):
            odom_pose = np.asarray(odom_pose, np.float64)
            delta = self._odom_delta(odom_pose)
            if self._pose_dev is None:
                assert not self._pending
                self._pose_dev = jnp.asarray(self.prev_robot_pose,
                                             jnp.float32)
            with self.stats.timer.section("global_match"):
                self._pose_dev, out = matcher_mod.localization_step_async(
                    m.config, m.grid, self._pose_dev,
                    jnp.asarray(points, jnp.float32), jnp.asarray(mask),
                    jnp.int32(num_points), jnp.asarray(delta, jnp.float32),
                    m.packed_table)
                for leaf in out:
                    leaf.copy_to_host_async()
            self._pending.append(("loc", out))
            self.prev_odom_pose = odom_pose.copy()
            if len(self._pending) > self.config.max_inflight:
                self._drain(1)
            return ScanResult(accepted=True, pose=None, pose_future=out[3],
                              score_future=out[1])
        self._drain_all()
        with self.stats.timer.section("global_match"):
            if isinstance(m, NDTScanMatcher) and m.grid is not None:
                # Fused score+match: one dispatch, one fetch.
                out = matcher_mod.match_scan_with_score(
                    m.config, m.grid, jnp.asarray(points, jnp.float32),
                    jnp.asarray(mask), jnp.int32(num_points),
                    jnp.asarray(robot_pose, jnp.float32), m.packed_table)
                unc, score, corr, _ = jax.device_get(out)
            else:  # plugin matchers go through the generic surface
                unc = m.score_points(points, mask, num_points,
                                     robot_pose.astype(np.float32))
                res = m.match_scan(points, mask, num_points,
                                   robot_pose.astype(np.float32))
                unc, score, corr = (float(unc), float(res.score),
                                    np.asarray(res.correction))
        correction = np.asarray(corr, np.float64)
        pose = robot_pose + correction
        self.prev_odom_pose = odom_pose.copy()
        self.prev_robot_pose = pose.copy()
        self.stats.record_scan(True, float(score))
        return ScanResult(accepted=True, pose=pose,
                          uncorrected_score=float(unc),
                          matched_score=float(score),
                          correction=correction)

    # ------------------------------------------------------------------
    def _process_particle_filter(self, robot_pose, odom_pose, points, mask,
                                 num_points) -> ScanResult:
        """Particle-filter branch (ndt_mapper.cpp:455-494)."""
        f = self.filter
        pc = f.config
        if (pc.recovery_alpha_slow > 0.0 and pc.recovery_alpha_fast > 0.0
                and f.free_xy is None and self.graph.num_scans):
            # Arm AMCL-style recovery injection: build the free-space pool
            # once from the loaded map (pf_step_recovery needs somewhere to
            # put the injected particles).
            fs = self._map_free_space()
            if fs is not None:
                f.set_free_space(*fs)
                logger.info("PF recovery armed: %d free cells", len(fs[0]))
        from ndt_2d_tpu.matching.matcher import NDTScanMatcher
        if (self.mesh is not None
                and isinstance(self.global_matcher, NDTScanMatcher)
                and self.global_matcher.grid is not None):
            # Mesh mode: reference-shaped update/measure/resample sequence
            # with the MEASUREMENT (the PF's compute bulk) particle-sharded
            # over the 'batch' axis (parallel.filter.measure_multichip).
            # Multi-process (round 5): the motion/resample state chain stays
            # process-local (replicated by the shared seed), while the
            # measurement shards particles over the GLOBAL mesh — host-numpy
            # particles in, process_allgather of the sharded scores out
            # (filter.measure handles both through host_grid).
            self._drain_all()
            delta = robot_pose[:2] - self.prev_robot_pose[:2]
            c = np.cos(-self.prev_robot_pose[2])
            s = np.sin(-self.prev_robot_pose[2])
            with self.stats.timer.section("pf_step"):
                f.update(c * delta[0] - s * delta[1],
                         s * delta[0] + c * delta[1],
                         _normalize_angle(robot_pose[2]
                                          - self.prev_robot_pose[2]))
                f.measure(self.global_matcher, points, mask, num_points,
                          mesh=self.mesh,
                          host_grid=(self._mesh_grid(self.global_matcher)
                                     if self._mp else None))
                f.resample()
            pose = np.asarray(f.get_mean(), np.float64)
            self.prev_odom_pose = odom_pose.copy()
            self.prev_robot_pose = pose.copy()
            self.stats.record_scan(True)
            return ScanResult(accepted=True, pose=pose)
        if self.config.max_inflight > 0:
            # Pipelined: the control equals the odometry delta in the
            # previous robot frame (see _odom_delta), so the dispatch needs
            # no device state fetch; particles/weights/count chain on
            # device and statistics drain asynchronously.
            odom_pose = np.asarray(odom_pose, np.float64)
            control = self._odom_delta(odom_pose)
            with self.stats.timer.section("pf_step"):
                out = f.step_async(self.global_matcher, control, points,
                                   mask, num_points)
            self._pending.append(("pf", out))
            self.prev_odom_pose = odom_pose.copy()
            if len(self._pending) > self.config.max_inflight:
                self._drain(1)
            return ScanResult(accepted=True, pose=None, pose_future=out[1])

        # Robot-centric control from the map-frame delta (ndt_mapper.cpp:457-468).
        delta = robot_pose[:2] - self.prev_robot_pose[:2]
        c = np.cos(-self.prev_robot_pose[2])
        s = np.sin(-self.prev_robot_pose[2])
        control = np.asarray([
            c * delta[0] - s * delta[1],
            s * delta[0] + c * delta[1],
            _normalize_angle(robot_pose[2] - self.prev_robot_pose[2])])

        with self.stats.timer.section("pf_step"):
            mean = f.step(self.global_matcher, control, points, mask,
                          num_points)
        pose = np.asarray(mean, np.float64)
        self.prev_odom_pose = odom_pose.copy()
        self.prev_robot_pose = pose.copy()
        self.stats.record_scan(True)
        return ScanResult(accepted=True, pose=pose)

    # ------------------------------------------------------------------
    def loop_closure(self) -> int:
        """One pass of the loop-closure search (loopClosureThread body,
        ndt_mapper.cpp:569-685).  Returns the number of closures added."""
        self._scans_since_loop_closure = 0
        if not self.enable_mapping:
            return 0
        self._drain_all()
        g = self.graph
        num_scans = g.num_scans
        depth = self.config.rolling_depth
        if num_scans <= depth:
            return 0
        if self.global_scans_processed <= depth:
            self.global_scans_processed = depth + 1

        added = 0
        desc_table = desc_valid = None
        self._desc_topk = None
        self._desc_sim = {}
        self._pruned_counted = set()
        # Guard: nothing pending means no queries will run — skip the
        # whole-pass descriptor precompute (the O(N^2) all-pairs search
        # used to run even on the flush-with-nothing-pending call every
        # session ends with).
        if (self.config.loop_search in ("descriptor", "both") and num_scans
                and self.global_scans_processed < num_scans):
            # Appearance-based candidates: batched rotation-invariant
            # descriptors + cosine top-k (ndt_2d_tpu.parallel.loop_search).
            # Computed over the graph's padded capacity buffers so the jit
            # signature only changes on capacity doubling.
            from ndt_2d_tpu.parallel import loop_search
            desc_table = loop_search.descriptors(
                g.points_padded, g.point_mask_padded,
                np.float32(self.range_max), self.config.descriptor_bins)
            desc_valid = np.arange(g.points_padded.shape[0]) < num_scans
            if self.mesh is not None:
                # Mesh mode: ONE sharded all-to-all search serves every
                # query of this pass (descriptors depend only on scan
                # points, which acceptances never change, so precomputing
                # is decision-identical to the per-query search).
                from ndt_2d_tpu.parallel.mesh import BATCH_AXIS
                dp, vp = loop_search.pad_descriptors(
                    np.asarray(desc_table), desc_valid,
                    self.mesh.shape[BATCH_AXIS])
                idx_t, score_t = loop_search.search_all_pairs_multichip(
                    self.mesh, dp, vp, k=self.config.global_search_limit,
                    rolling_exclude=self.config.rolling_depth + 1)
                # Outputs are query-sharded over the mesh; fetch handles the
                # multi-process allgather (plain device_get otherwise).
                from ndt_2d_tpu.parallel import distributed
                self._desc_topk = tuple(
                    np.asarray(x) for x in distributed.fetch((idx_t, score_t)))
            else:
                # Single-device: the same one-search-per-pass precompute
                # (one dispatch + one fetch instead of one per query,
                # whose blocking fetches would each cost a round trip).
                import jax.numpy as jnp
                idx_t, score_t = loop_search.search_all_pairs(
                    desc_table, jnp.asarray(desc_valid),
                    k=self.config.global_search_limit,
                    rolling_exclude=self.config.rolling_depth + 1)
                self._desc_topk = (np.asarray(idx_t), np.asarray(score_t))
        if self._fused_confirmation_available() and \
                self.config.pipeline_loop_closure:
            added = self._loop_closure_pass_pipelined(num_scans, desc_table,
                                                      desc_valid)
        else:
            while self.global_scans_processed < num_scans:
                idx = self.global_scans_processed
                with self.stats.timer.section("loop_closure"):
                    candidates = self._loop_candidates(idx, desc_table,
                                                       desc_valid)
                    if candidates:
                        added += self._confirm_candidates(idx, candidates)
                self.global_scans_processed += 1

        # Optimization cadence (ndt_mapper.cpp:676-683).
        if added and (num_scans - self.optimization_last
                      > self.config.optimization_node_limit):
            logger.info("Optimizing pose graph")
            with self.stats.timer.section("optimize"):
                self._solve_graph()
            self.stats.optimizations += 1
            self.optimization_last = g.num_scans
            self.map_update_available = True
            self._window_synced = -1  # optimized poses invalidate the window
            self._reject_cache.clear()  # optimized poses move far starts
            self._reanchor_pose()
        # Return the pass's freed buffer pages to the OS: the padded
        # candidate batches + fetched rows churn tens of MB per pass and
        # glibc retains them in its arenas otherwise (measured ~6 MB/pass
        # steady RSS creep on closure-dense sessions; utils/memory.py).
        from ndt_2d_tpu.utils.memory import trim_host_heap
        trim_host_heap()
        return added

    def _reanchor_pose(self) -> None:
        """Re-anchor the dead-reckoning chain on the latest graph pose.

        After an optimization (or a loop closure that moved the newest scan)
        the graph's estimate of the last keyframe pose is better than the
        pre-correction ``prev_robot_pose``; the next scan's start pose
        dead-reckons from it and matches against a window REBUILT from the
        corrected graph poses, so leaving the chain stale strands the start
        pose outside the +-search_linear_size match window and every
        subsequent odometry constraint inherits the offset (measured on the
        config-3 office benchmark: final ATE *worse* than online).  The
        reference has exactly this defect — loopClosureThread corrects scan
        poses and optimizes but never touches prev_robot_pose_
        (src/ndt_mapper.cpp:569-685 vs :541-545) — which we fix rather than
        reproduce.  The device pose chain restarts from the new anchor on
        the next pipelined dispatch.
        """
        g = self.graph
        if self.enable_mapping and not self.use_particle_filter \
                and g.num_scans:
            self.prev_robot_pose = g.poses[g.num_scans - 1].copy()
            self._pose_dev = None
            self._approx_pose = self.prev_robot_pose.copy()

    # --- loop-closure internals ------------------------------------------
    def _loop_candidates(self, idx: int, desc_table, desc_valid) -> list:
        """Candidate scan ids for a loop closure of scan ``idx``, ordered,
        point-less scans dropped (ndt_mapper.cpp:625), capped at
        global_search_limit (the reference's checks_left budget,
        ndt_mapper.cpp:619,665-668 — equivalent here because candidates that
        would be skipped never enter the list)."""
        g = self.graph
        mode = self.config.loop_search
        limit = self.config.global_search_limit
        rolling = idx - self.config.rolling_depth
        out = []
        # "pose" searches pose space outright (overriding the graph's
        # barycenter convention); "both" keeps barycenter primary and adds
        # the pose-space arm below.
        use_bary = (g.use_barycenter
                    and self.config.loop_search_positions != "pose")
        query = g.barycenter(idx) if use_bary else g.poses[idx, :2]
        if mode in ("radius", "both"):
            near = g.find_nearest(query, self.config.global_search_size,
                                  rolling, use_barycenter=use_bary)
            out = []
            for i in near:
                i = int(i)
                if len(out) >= limit:
                    break
                if not g.point_mask[i].any():
                    continue
                # The cross-pass negative cache applies to far rows from
                # EITHER source — a clearly-rejected far site stays
                # rejected no matter which arm re-proposes it.
                if (self._reject_cache and self._is_far(idx, i)
                        and self._far_key(idx, i) in self._reject_cache):
                    self.stats.far_rows_cache_skipped += 1
                    continue
                out.append(i)
            if self.config.loop_search_positions == "both":
                # Pose-space arm: catches reverse-direction revisits whose
                # barycenters face away from each other (see config.py).
                # Its OWN limit-sized budget: the barycenter arm fills its
                # slots with same-direction neighbors in dense surveys, so
                # a shared cap would starve exactly the reverse revisits
                # this arm exists for (measured: all 28 residual simlab
                # misses sat within 0.9 m pose distance while the shared
                # cap was exhausted).
                near2 = g.find_nearest(g.poses[idx, :2],
                                       self.config.global_search_size,
                                       rolling, use_barycenter=False)
                extras = 0
                for i in near2:
                    i = int(i)
                    if extras >= limit:
                        break
                    if i in out or not g.point_mask[i].any():
                        continue
                    if (self._reject_cache and self._is_far(idx, i)
                            and self._far_key(idx, i) in self._reject_cache):
                        self.stats.far_rows_cache_skipped += 1
                        continue
                    out.append(i)
                    extras += 1
        if mode in ("descriptor", "both") and desc_table is not None:
            from ndt_2d_tpu.parallel import loop_search
            # Exclude i >= idx - depth: findNearest's limit_scan_index
            # semantics (graph.cpp:181, candidates strictly below the
            # rolling window).
            if getattr(self, "_desc_topk", None) is not None:
                cand_idx = self._desc_topk[0][idx]
                cand_sim = self._desc_topk[1][idx]
            else:
                cand_idx, cand_sim = loop_search.search_dense(
                    desc_table, desc_valid, idx, k=limit,
                    rolling_exclude=self.config.rolling_depth + 1)
            cand_idx = np.asarray(cand_idx)
            cand_sim = np.asarray(cand_sim)
            keep = (np.isfinite(cand_sim)
                    & (cand_sim >= self.config.descriptor_min_similarity))
            desc_out = []
            for i, s in zip(cand_idx[keep], cand_sim[keep]):
                i = int(i)
                if not g.point_mask[i].any():
                    continue
                if len(desc_out) >= limit:
                    break
                # Cross-pass negative cache: skip far sites whose
                # confirmation clearly failed for a nearby query already
                # (config.loop_closure_reject_cache_margin).
                if (self._reject_cache and self._is_far(idx, i)
                        and self._far_key(idx, i) in self._reject_cache):
                    self.stats.far_rows_cache_skipped += 1
                    continue
                desc_out.append(i)
                self._desc_sim[(idx, i)] = float(s)
            # "both": union, radius proposals first (they carry the precise
            # start pose), descriptor extras deduped after — one combined
            # confirmation pass handles all of them.
            out.extend(i for i in desc_out if i not in out)
        # Third element: the AT-QUERY-TIME search position (map-frame
        # barycenter/pose under the then-current drift) — what the radius
        # search actually saw; the recall benchmark's miss attribution
        # needs it because the final optimized poses no longer carry the
        # drift that caused a reach miss.
        self.lc_log["candidates"].append((idx, tuple(out),
                                          tuple(np.asarray(query, float))))
        return out

    def _window_bounds(self, i: int, rolling: int):
        """[begin, end) scan range of candidate ``i``'s S-slot confirmation
        region (shared by the window build and the row-reuse snapshot key —
        the two MUST agree or the cache reuses results for rows whose
        window changed)."""
        S = self.config.loop_closure_region_size
        begin_idx = max(i - S // 2, 0)
        end_idx = max(min(i + (S - S // 2), rolling), i + 1)
        return begin_idx, begin_idx + min(end_idx - begin_idx, S)

    def _grid_cells_snapshot(self):
        """Current (global, coarse) matcher grid sizes — the compiled-
        program identity the row-reuse key and the auto-grow redo check
        depend on."""
        gm = self.global_matcher.config
        cells = [gm.grid_cells_x, gm.grid_cells_y]
        if self.coarse_matcher is not None:
            cells += [self.coarse_matcher.config.grid_cells_x,
                      self.coarse_matcher.config.grid_cells_y]
        return tuple(cells)

    def _confirm_row_key(self, j: int, i: int) -> bytes:
        """Snapshot of everything a confirmation row's result depends on:
        the query pose (start pose + far classification), the candidate
        window's poses (the NDT build; points are immutable once added),
        and the matcher grid sizes (auto-grow changes the compiled
        program).  Equal keys mean the row re-runs the same per-row math
        on identical inputs; see _loop_closure_pass_pipelined for the
        exact reuse guarantee (and its padding caveat)."""
        g = self.graph
        begin_idx, end_idx = self._window_bounds(
            i, j - self.config.rolling_depth)
        return (g.poses[j].tobytes() + g.poses[begin_idx:end_idx].tobytes()
                + np.asarray(self._grid_cells_snapshot(), np.int64).tobytes())

    def _candidate_window(self, i: int, rolling: int):
        """The candidate's S-slot scan region around scan ``i``
        (ndt_mapper.cpp:627-631), S = config.loop_closure_region_size.

        NOTE the reference's comment says "one additional scan on either
        side" but its code uses end_idx as an EXCLUSIVE iterator bound, so
        its region is [i-1, i+1) = {i-1, i} — at most 2 scans.  S=2 (the
        default) reproduces that exactly; S=3 realizes the stated intent
        {i-1, i, i+1}.  The region never reaches into the query's rolling
        window (indices >= ``rolling``), and is padded to a fixed S slots so
        the build kernel compiles once."""
        g = self.graph
        S = self.config.loop_closure_region_size
        begin_idx, end_idx = self._window_bounds(i, rolling)
        k = end_idx - begin_idx
        poses2 = np.zeros((S, 3), np.float32)
        pts2 = np.zeros((S, g.max_points, 2), np.float32)
        pmask2 = np.zeros((S, g.max_points), bool)
        wmask2 = np.zeros(S, bool)
        poses2[:k] = g.poses[begin_idx:end_idx].astype(np.float32)
        pts2[:k] = g.points[begin_idx:end_idx]
        pmask2[:k] = g.point_mask[begin_idx:end_idx]
        wmask2[:k] = True
        return poses2, pts2, pmask2, wmask2

    def _candidate_start(self, idx: int, i: int, descriptor: bool):
        """(start pose, wants_coarse) for candidate ``i`` of query ``idx``.

        Radius candidates (and descriptor candidates the pose estimate
        already places within the radius-search reach) start at the query's
        own pose — the best drift-consistent estimate — and go straight to
        the fine lattice.  Far descriptor candidates carry unknown odometry
        drift: they start at the CANDIDATE's position (keeping the query's
        heading) and get the wide coarse lattice first (ndt_mapper.cpp:643's
        start is always the query pose because the reference only has
        radius candidates)."""
        g = self.graph
        st = g.poses[idx].copy()
        if descriptor:
            d2 = float(np.sum((g.poses[i, :2] - st[:2]) ** 2))
            # global_search_size is the radius search's SQUARED-distance
            # bound (nanoflann semantics) — same scale as d2.
            if d2 > self.config.global_search_size:
                st[:2] = g.poses[i, :2]
                return st, True
        return st, False

    # --- far-candidate pruning (config.loop_closure_far_dedup etc.) -------
    def _is_far(self, idx: int, i: int) -> bool:
        """Whether candidate ``i`` of query ``idx`` would take the FAR
        (coarse-to-fine) confirmation arm — the same squared-distance test
        _candidate_start applies."""
        if self.coarse_matcher is None:
            return False
        g = self.graph
        d2 = float(np.sum((g.poses[i, :2] - g.poses[idx, :2]) ** 2))
        return d2 > self.config.global_search_size

    def _far_key(self, idx: int, i: int):
        """Spatial cell key of a far (query, candidate) pair for the
        negative cache: positions quantized at the dedup radius."""
        cell = self.config.loop_closure_far_dedup or 2.0
        g = self.graph
        q = g.poses[idx, :2] / cell
        c = g.poses[i, :2] / cell
        return (int(np.floor(q[0])), int(np.floor(q[1])),
                int(np.floor(c[0])), int(np.floor(c[1])))

    def _prune_far_pass(self, pending: list) -> list:
        """Per-pass spatial dedup + cap of FAR rows (see config.py).

        ``pending`` is the pass's [(query, [candidates])] list.  Near rows
        always survive.  Far rows are ranked by descriptor similarity —
        radius-sourced far rows (no similarity entry) rank FIRST, since
        they carry a precise drift-consistent start pose while descriptor
        rows are appearance guesses; a row is dropped when an
        already-selected far row has BOTH its query and candidate within
        loop_closure_far_dedup meters (one representative confirmation per
        site pair per pass), or once loop_closure_max_far_rows is
        reached."""
        ded = self.config.loop_closure_far_dedup
        cap = self.config.loop_closure_max_far_rows
        if (ded <= 0 and cap <= 0) or self.coarse_matcher is None:
            return pending
        g = self.graph
        far = []
        for j, cands in pending:
            for i in cands:
                if self._is_far(j, i):
                    far.append((self._desc_sim.get((j, i), float("inf")),
                                j, i))
        if not far:
            return pending
        selected = set()
        sel_pos = []
        for sim, j, i in sorted(far, key=lambda r: -r[0]):
            if cap > 0 and len(selected) >= cap:
                break
            qp, cp = g.poses[j, :2], g.poses[i, :2]
            if ded > 0 and any(
                    np.hypot(*(qp - sq)) < ded and np.hypot(*(cp - sc)) < ded
                    for sq, sc in sel_pos):
                continue
            selected.add((j, i))
            sel_pos.append((qp.copy(), cp.copy()))
        # Count each physically distinct suppressed row once per
        # loop_closure() call: pass restarts re-propose and re-prune the
        # same rows, which used to multiply the stat.
        dropped = {(j, i) for _, j, i in far if (j, i) not in selected}
        dropped -= self._pruned_counted
        self._pruned_counted |= dropped
        self.stats.far_rows_pruned += len(dropped)
        out = []
        for j, cands in pending:
            kept = [i for i in cands
                    if not self._is_far(j, i) or (j, i) in selected]
            if kept:
                out.append((j, kept))
        return out

    def _apply_gate(self, idx: int, i: int, start, score: float, correction,
                    covariance) -> bool:
        """Acceptance gate + graph update for one confirmed candidate
        (ndt_mapper.cpp:645-668).  Shared by the sequential and batched
        confirmation paths so their semantics cannot drift."""
        g = self.graph
        gate = (self.typical_matcher_response
                * self.config.loop_closure_gate_scale)
        accepted = bool(np.isfinite(score) and score < gate)
        if accepted:
            # Separation gate: the corrected query pose must land within
            # loop_closure_max_separation of the candidate — the match's
            # own estimate of how far apart the scans were taken (see
            # config.py; inf = reference parity).
            sep = np.hypot(*(start[:2] + np.asarray(correction)[:2]
                             - g.poses[i, :2]))
            accepted = sep <= self.config.loop_closure_max_separation
        self.lc_log["decisions"].append((idx, i, float(score), float(gate),
                                         accepted))
        margin = self.config.loop_closure_reject_cache_margin
        if not accepted and margin > 0 and self._is_far(idx, i):
            # Negative cache: remember clear far rejections so nearby
            # queries stop re-confirming the same alias site (see
            # config.loop_closure_reject_cache_margin).
            if (not np.isfinite(score)
                    or score - gate >= margin * abs(gate)):
                self._reject_cache[self._far_key(idx, i)] = float(score)
        if accepted:
            # Graph corrections change far starts/classification: drop the
            # negative cache rather than risk suppressing a now-confirmable
            # true revisit.
            self._reject_cache.clear()
            self.stats.loop_closures_accepted += 1
            logger.info("***Adding loop closure from %d to %d (score %f)",
                        i, idx, score)
            new_pose = start + np.asarray(correction, np.float64)
            poses = g.poses.copy()
            poses[idx] = new_pose
            g.set_poses(poses)
            pose_graph.make_constraint_np(
                g, i, idx, np.asarray(covariance, np.float64),
                switchable=True)
            self.map_update_available = True
            # The corrected pose may sit inside the device rolling window;
            # force a rebuild from the graph.
            self._window_synced = -1
            if idx == g.num_scans - 1:
                # The closure moved the newest keyframe: the dead-reckoning
                # chain must follow it (see _reanchor_pose).  Optionally let
                # the robust solve arbitrate FIRST, so a wrong far closure
                # (appearance alias) is switched off before its jump enters
                # the pose chain (config.loop_closure_solve_before_reanchor;
                # measured: one such alias sent the pipelined descriptor
                # benchmark from 0.14 to 5.6 m ATE).
                if self.config.loop_closure_solve_before_reanchor:
                    with self.stats.timer.section("optimize"):
                        if self._solve_graph():
                            self.stats.optimizations += 1
                            self.optimization_last = g.num_scans
                self._reanchor_pose()
            return True
        self.stats.loop_closures_rejected += 1
        logger.info("***Rejecting loop closure from %d to %d (score %f)",
                    i, idx, score)
        return False

    def _fused_confirmation_available(self) -> bool:
        """Whether the single-dispatch vmapped confirmation applies (NDT
        matchers only; plugin matchers fall back to the sequential path)."""
        from ndt_2d_tpu.matching.matcher import NDTScanMatcher
        return (self.config.batch_loop_closure
                and isinstance(self.global_matcher, NDTScanMatcher)
                and (self.coarse_matcher is None
                     or isinstance(self.coarse_matcher, NDTScanMatcher)))

    def _loop_closure_pass_pipelined(self, num_scans: int, desc_table,
                                     desc_valid) -> int:
        """Fuse a whole loop-closure pass into (at most) two dispatches:
        every pending scan's (query, candidate) pairs batch through the
        multi-query confirmation programs (match_scan_batch_multi /
        _coarse_fine), then results drain in scan order — the per-dispatch
        latency stops scaling with the pass size entirely.

        Decisions are identical to the per-scan path: each dispatch depends
        only on graph state, which rejections never touch; the first
        acceptance invalidates the remaining in-flight results and the pass
        restarts from the next scan with the corrected graph — exactly the
        state the per-scan path would have seen.  Equivalence is pinned by
        tests/test_mapper_e2e.py::TestPipelinedLoopClosure."""
        added = 0
        # Row-result reuse across pass restarts: an acceptance rewrites ONE
        # pose (the query's; ndt_mapper.cpp:651) yet the restart used to
        # re-dispatch every remaining row.  Results are cached under a
        # snapshot of everything the row's match depends on (query pose,
        # window poses, grid sizes — _confirm_row_key), so on restart only
        # rows whose inputs actually changed re-dispatch.  Guarantee: a
        # matching snapshot re-runs the same per-row math on identical
        # inputs; per-row results are lane-independent of the batch they
        # ride in, so decisions are identical to a cache-disabled run
        # (pinned bitwise on the CPU scenarios by TestConfirmRowReuse; on
        # an accelerator a different batch padding compiles a different
        # program whose last-bit rounding could in principle flip a gate at
        # the exact threshold — the same lattice-flip equivalence class the
        # pipelined-vs-sync chains already live in).
        # Optimizations (incl. solve-before-reanchor) rewrite all poses and
        # invalidate every entry through the snapshot mismatch — no manual
        # invalidation exists to get wrong.
        row_cache = {}
        while self.global_scans_processed < num_scans:
            pending = []
            rows = []
            with self.stats.timer.section("loop_closure"):
                for j in range(self.global_scans_processed, num_scans):
                    cands = self._loop_candidates(j, desc_table, desc_valid)
                    if cands:
                        pending.append((j, cands))
                self.global_scans_processed = num_scans
                pending = self._prune_far_pass(pending)
                rows = [(j, i) for j, cands in pending for i in cands]
                if not rows:
                    break
                while True:
                    keys = {r: self._confirm_row_key(*r) for r in rows}
                    fresh = [r for r in rows
                             if row_cache.get(r, (None,))[0] != keys[r]]
                    if not fresh:
                        break
                    cells0 = self._grid_cells_snapshot()
                    starts, segments = self._dispatch_confirm_rows(fresh)
                    fsc, fco, fcv, ffs = self._fetch_rows(starts, segments)
                    if self._grid_cells_snapshot() != cells0:
                        # auto_grow_grids fired mid-dispatch: the keys above
                        # snapshot the OLD grid sizes while (some of) the
                        # fetched results ran post-growth, and any reused
                        # entries would be pre-growth.  Drop everything and
                        # redo this iteration under the grown config —
                        # growth is monotonic and amortized-rare, so the
                        # redo is a one-time cost, and it keeps the
                        # cache-disabled equivalence exact.
                        row_cache.clear()
                        continue
                    for m, r in enumerate(fresh):
                        row_cache[r] = (keys[r], float(fsc[m]),
                                        fco[m].copy(), fcv[m].copy(),
                                        ffs[m].copy())
                    break
                self.stats.confirm_rows_reused += len(rows) - len(fresh)
                N = len(rows)
                scores = np.zeros(N)
                corrs = np.zeros((N, 3))
                covs = np.zeros((N, 3, 3))
                fstarts = np.zeros((N, 3))
                for m, r in enumerate(rows):
                    _, scores[m], corrs[m], covs[m], fstarts[m] = \
                        row_cache[r]
            off = 0
            for (j, cands) in pending:
                k = len(cands)
                with self.stats.timer.section("loop_closure"):
                    a, changed = self._gate_rows(
                        j, cands, fstarts[off:off + k], scores[off:off + k],
                        corrs[off:off + k], covs[off:off + k])
                added += a
                off += k
                if changed and j + 1 < num_scans:
                    # Everything dispatched after j saw the pre-acceptance
                    # graph; recompute candidates from the corrected state.
                    self.global_scans_processed = j + 1
                    break
        return added

    def _confirm_candidates(self, idx: int, candidates: list) -> int:
        """Confirm the candidates of scan ``idx``; returns closures added."""
        if self._fused_confirmation_available():
            return self._confirm_candidates_batched(idx, candidates)
        return self._confirm_candidates_sequential(idx, candidates)

    def _confirm_candidates_sequential(self, idx: int,
                                       candidates: list) -> int:
        """Reference-shaped path: per candidate, rebuild the global matcher's
        NDT and match (ndt_mapper.cpp:623-663).  Kept for plugin matchers and
        as the equivalence oracle for the batched path."""
        g = self.graph
        rolling = idx - self.config.rolling_depth
        n = int(g.point_mask[idx].sum())
        best_mode = self.config.loop_closure_accept == "best"
        results = []
        added = 0
        for i in candidates:
            poses2, pts2, pmask2, wmask2 = self._candidate_window(i, rolling)
            grown = self._check_grid_capacity(
                poses2[wmask2][:, :2], self.global_matcher.config,
                "loop-closure candidate window", "scan matcher grid_cells_*")
            if grown:
                self._grow_matcher("global_matcher", grown)
            self.global_matcher.reset()
            self.global_matcher.add_scans(poses2, pts2, pmask2, wmask2)
            start, wants_coarse = self._candidate_start(
                idx, i, self.coarse_matcher is not None)
            if wants_coarse:
                # Far (drift-agnostic) candidates run coarse-to-fine: the
                # wide coarse lattice absorbs the drift so the fine window
                # below only has to cover the coarse quantization.
                grown = self._check_grid_capacity(
                    poses2[wmask2][:, :2], self.coarse_matcher.config,
                    "loop-closure candidate window",
                    "scan matcher grid_cells_*")
                if grown:
                    self._grow_matcher("coarse_matcher", grown)
                self.coarse_matcher.reset()
                self.coarse_matcher.add_scans(poses2, pts2, pmask2, wmask2)
                coarse = self.coarse_matcher.match_scan(
                    g.points[idx], g.point_mask[idx], n,
                    start.astype(np.float32))
                start = start + np.asarray(coarse.correction, np.float64)
            res = self.global_matcher.match_scan(
                g.points[idx], g.point_mask[idx], n, start.astype(np.float32))
            if best_mode:
                results.append((float(res.score), i, start,
                                np.asarray(res.correction),
                                np.asarray(res.covariance)))
                continue
            added += int(self._apply_gate(idx, i, start, float(res.score),
                                          np.asarray(res.correction),
                                          np.asarray(res.covariance)))
        if best_mode:
            for score, i, start, corr, cov in sorted(results,
                                                     key=lambda r: r[0]):
                if self._apply_gate(idx, i, start, score, corr, cov):
                    added += 1
                    break
        return added

    def _confirm_candidates_batched(self, idx: int, candidates: list) -> int:
        """Batched path: ALL candidate windows build + match as one
        vmapped dispatch (at most two: the near/fine segment and the
        far/coarse-to-fine segment), fetched once.

        The reference's analog is K sequential rebuild+match rounds
        (ndt_mapper.cpp:623-663); here a whole confirmation pass costs one
        device round-trip regardless of K.  Exact sequential semantics are
        preserved: if a mid-batch acceptance moves the scan pose, the
        remaining candidates re-match from the corrected pose (rare — one
        extra dispatch per acceptance)."""
        starts, segments = self._dispatch_confirm(idx, candidates)
        added, _ = self._drain_confirm(idx, candidates, starts, segments)
        return added

    def _dispatch_confirm(self, idx: int, candidates: list):
        """Dispatch the confirmation of ``candidates`` of scan ``idx``.
        Returns (starts [K, 3], segments) — see _dispatch_confirm_rows."""
        return self._dispatch_confirm_rows([(idx, i) for i in candidates])

    def _dispatch_confirm_rows(self, rows: list):
        """Build + dispatch the vmapped confirmation of ``rows`` — a list
        of (query_idx, candidate_i) pairs, possibly spanning MANY query
        scans (a whole pipelined pass fuses into these dispatches).

        Rows split by drift class: near rows (start within the radius-search
        reach) run the fine lattice only; far descriptor rows run
        coarse-to-fine.  One dispatch per non-empty segment (so at most 2
        per pass); host copies are issued immediately so a later drain pays
        only the async-copy completion.

        Returns (starts [N, 3] float64, segments) where segments is a list
        of (row_positions int array, device outputs, coarse flag).
        """
        import jax

        descriptor = self.coarse_matcher is not None
        N = len(rows)
        starts = np.zeros((N, 3), np.float64)
        wants = np.zeros(N, bool)
        for r, (q, i) in enumerate(rows):
            starts[r], wants[r] = self._candidate_start(q, i, descriptor)
        segments = []
        for coarse in (False, True):
            pos = np.nonzero(wants == coarse)[0]
            if not len(pos):
                continue
            # Device-memory cap: the confirmation programs materialize
            # O(rows x lattice x beams) intermediates, the wide-heading
            # coarse lattice most of all (measured: one 32-row coarse
            # chunk peaks at 1.47 GiB of device memory on an NVIDIA H100
            # 80GB HBM3, chip_smoke.py phase 1).  The caps also fix the
            # padded shapes, so changing them changes compiled programs.
            # Chunk the segment — still O(pass/cap) dispatches, not
            # O(queries).
            cap = 32 if coarse else 64
            for c0 in range(0, len(pos), cap):
                chunk = pos[c0:c0 + cap]
                out = self._dispatch_rows_segment(
                    [rows[r] for r in chunk], starts[chunk], coarse)
                if not self._mp:   # sharded outputs allgather at drain
                    for leaf in jax.tree_util.tree_leaves(out):
                        leaf.copy_to_host_async()
                segments.append((chunk, out, coarse))
        return starts, segments

    def _dispatch_rows_segment(self, rows: list, starts, coarse: bool):
        """One segment's device dispatch: padded multi-query batch through
        the fine-only or coarse-to-fine program (single-device or mesh)."""
        import jax.numpy as jnp

        from ndt_2d_tpu.matching import matcher as matcher_mod
        g = self.graph
        K = len(rows)
        # Power-of-two bucket (min 4) keeps the jit signature set tiny.
        pad = max(4, 1 << (K - 1).bit_length())
        if self.mesh is not None:
            # Rows shard over the mesh 'batch' axis.
            from ndt_2d_tpu.parallel.mesh import BATCH_AXIS
            nb = self.mesh.shape[BATCH_AXIS]
            pad = -(-pad // nb) * nb
        S = self.config.loop_closure_region_size
        poses = np.zeros((pad, S, 3), np.float32)
        pts = np.zeros((pad, S, g.max_points, 2), np.float32)
        pmask = np.zeros((pad, S, g.max_points), bool)
        wmask = np.zeros((pad, S), bool)
        qpts = np.zeros((pad, g.max_points, 2), np.float32)
        qmask = np.zeros((pad, g.max_points), bool)
        qnum = np.zeros(pad, np.int32)
        st = np.zeros((pad, 3), np.float32)
        for j, (q, i) in enumerate(rows):
            rolling = q - self.config.rolling_depth
            poses[j], pts[j], pmask[j], wmask[j] = \
                self._candidate_window(i, rolling)
            qpts[j] = g.points[q]
            qmask[j] = g.point_mask[q]
            qnum[j] = int(g.point_mask[q].sum())
            st[j] = starts[j]

        self._check_batch_capacity(poses, wmask, coarse)

        if self._mp:
            # Host inputs: process-replicated into the mesh program.
            args = (poses, pts, pmask, wmask, np.float32(self.range_max),
                    qpts, qmask, qnum, st)
        else:
            args = (jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(pmask),
                    jnp.asarray(wmask), jnp.float32(self.range_max),
                    jnp.asarray(qpts), jnp.asarray(qmask),
                    jnp.asarray(qnum), jnp.asarray(st))
        if self.mesh is not None:
            from ndt_2d_tpu.parallel import runtime
            if coarse:
                return runtime.confirm_rows_coarse_fine_multichip(
                    self.coarse_matcher.config, self.global_matcher.config,
                    self.mesh, *args)
            return runtime.confirm_rows_multichip(
                self.global_matcher.config, self.mesh, *args)
        if coarse:
            return matcher_mod.match_scan_batch_multi_coarse_fine(
                self.coarse_matcher.config, self.global_matcher.config,
                *args)
        return matcher_mod.match_scan_batch_multi(
            self.global_matcher.config, *args)

    def _fetch_rows(self, starts, segments):
        """Materialize dispatched segments into per-row (scores, corrs,
        covs, fine_starts) arrays in row order."""
        from ndt_2d_tpu.parallel import distributed
        N = len(starts)
        scores = np.zeros(N)
        corrs = np.zeros((N, 3))
        covs = np.zeros((N, 3, 3))
        fstarts = np.asarray(starts, np.float64).copy()
        for pos, out, coarse in segments:
            fetched = distributed.fetch(out)
            if coarse:
                fst, sc, co, cv = fetched
                fstarts[pos] = np.asarray(fst, np.float64)[:len(pos)]
            else:
                sc, co, cv = fetched
            scores[pos] = np.asarray(sc)[:len(pos)]
            corrs[pos] = np.asarray(co)[:len(pos)]
            covs[pos] = np.asarray(cv)[:len(pos)]
        return scores, corrs, covs, fstarts

    def _gate_rows(self, idx: int, candidates: list, fstarts, scores, corrs,
                   covs):
        """Apply the acceptance gates for one query's candidates.
        Returns (closures added, graph changed)."""
        K = len(candidates)
        if self.config.loop_closure_accept == "best":
            # Candidates face the gate in score order and at most ONE
            # closure is added per query per pass; a separation-gate
            # rejection falls through to the next-best candidate
            # (config.loop_closure_accept).
            for j in np.argsort(scores[:K]):
                ok = self._apply_gate(idx, candidates[j], fstarts[j],
                                      float(scores[j]), corrs[j], covs[j])
                if ok:
                    return 1, True
            return 0, False
        added = 0
        for j, i in enumerate(candidates):
            ok = self._apply_gate(idx, i, fstarts[j], float(scores[j]),
                                  corrs[j], covs[j])
            if ok:
                added += 1
                if j + 1 < K:
                    # The acceptance moved g.poses[idx]; the sequential path
                    # would match the remaining candidates from the corrected
                    # pose.  Re-batch just those.
                    added += self._confirm_candidates_batched(
                        idx, candidates[j + 1:])
                return added, True
        return added, False

    def _drain_confirm(self, idx: int, candidates: list, starts, segments):
        """Fetch a dispatched confirmation and apply the acceptance gates in
        candidate order.  Returns (closures added, graph changed)."""
        scores, corrs, covs, fstarts = self._fetch_rows(starts, segments)
        return self._gate_rows(idx, candidates, fstarts, scores, corrs, covs)

    def _check_batch_capacity(self, poses, wmask, coarse: bool) -> None:
        """Static-grid capacity check over all candidate windows (the same
        check NDTScanMatcher.add_scans runs per window); auto-grows the
        tripped matcher(s) to the largest window's need."""
        matchers = ["global_matcher"] + (["coarse_matcher"] if coarse else [])
        for attr in matchers:
            need = None
            for w in range(poses.shape[0]):
                wp = poses[w][wmask[w]]
                if not len(wp):
                    continue
                grown = self._check_grid_capacity(
                    wp[:, :2], getattr(self, attr).config,
                    "loop-closure candidate window",
                    "scan matcher grid_cells_*")
                if grown:
                    need = (max(grown[0], need[0]),
                            max(grown[1], need[1])) if need else grown
            if need:
                self._grow_matcher(attr, need)

    def _solve_graph(self) -> bool:
        """Optimize the graph in place — constraint-sharded over the mesh
        when one is configured, single-device LM otherwise."""
        if self.mesh is not None:
            from ndt_2d_tpu.parallel import runtime
            return runtime.solve_graph_multichip(self.graph,
                                                 self.config.solver,
                                                 self.mesh)
        return solver.solve_graph(self.graph, self.config.solver)

    def optimize(self) -> bool:
        """Force a pose-graph optimization."""
        self._drain_all()
        ok = self._solve_graph()
        if ok:
            self.optimization_last = self.graph.num_scans
            self.map_update_available = True
            self._window_synced = -1
            self._reject_cache.clear()
            self._reanchor_pose()
        return ok

    # ------------------------------------------------------------------
    def render_map(self) -> occupancy.OccupancyGridResult:
        """Occupancy-grid export (mapPublishThread, ndt_mapper.cpp:696-705)."""
        self._drain_all()
        self.map_update_available = False
        g = self.graph
        return occupancy.render_occupancy(
            g.poses, g.points, g.point_mask, self.config.resolution,
            self.config.occupancy_threshold, mesh=self.mesh)

    def graph_snapshot(self) -> dict:
        """Graph visualization data (Graph::getMsg, src/graph.cpp:191-256)."""
        self._drain_all()
        g = self.graph
        return {
            "nodes": g.poses[:, :2].copy(),
            "edges": np.stack([g.constraint_begin, g.constraint_end], -1),
            "switchable": g.constraint_switchable.copy(),
        }

    def map_to_odom(self, drain: bool = True) -> np.ndarray:
        """map->odom transform = (map->robot) * (odom->robot)^-1
        (ndt_mapper.cpp:722-739).

        ``drain=False`` reads the current host estimate without blocking on
        in-flight pipelined steps.  ``prev_odom_pose`` advances at every
        pipelined DISPATCH while ``prev_robot_pose`` only advances at drain,
        so mid-pipeline the pair (prev_robot@t-k, odom@t) would be corrupted
        by the robot's motion over the in-flight window; ``_approx_pose``
        (the odometry-composed chain from the last corrected anchor) is the
        map->robot estimate consistent with ``prev_odom_pose``, differing
        from the drained answer only by the <= max_inflight scans of
        not-yet-applied match corrections — the same bounded lag as the
        reference's 4 Hz broadcast vs its ingest thread
        (ndt_mapper.cpp:716-742)."""
        if drain:
            self._drain_all()
        mr = self.prev_robot_pose
        if (not drain and self._pending and self._approx_pose is not None
                and self.enable_mapping and not self.use_particle_filter):
            mr = self._approx_pose
        orp = self.prev_odom_pose
        th = _normalize_angle(mr[2] - orp[2])
        c, s = np.cos(th), np.sin(th)
        return np.asarray([mr[0] - (c * orp[0] - s * orp[1]),
                           mr[1] - (s * orp[0] + c * orp[1]),
                           th])

    # ------------------------------------------------------------------
    def configure(self, action: int, filename: str = "") -> bool:
        """Configure service (srv/Configure.srv, ndt_mapper.cpp:155-186)."""
        self._drain_all()
        from ndt_2d_tpu.io import serialization
        if action & ENABLE_MAPPING:
            logger.info("Enabling mapping")
            self.enable_mapping = True
        elif action & DISABLE_MAPPING:
            logger.info("Disabling mapping")
            self.enable_mapping = False
            self.prev_odom_pose_is_initialized = False
        if action & LOAD_FROM_FILE:
            logger.info("Loading map from %s", filename)
            self.graph = serialization.load_graph(
                filename, self.config.max_points_per_scan,
                self.config.use_barycenter)
            self.map_update_available = True
            self.prev_odom_pose_is_initialized = False
            self.global_scans_processed = 0
            self.optimization_last = 0
            self._window_synced = -1  # new graph invalidates the window
            self._pose_dev = None
        elif action & SAVE_TO_FILE:
            logger.info("Saving map to %s", filename)
            serialization.save_graph(self.graph, filename)
        return True
