"""Command-line interface.

Covers the reference's runtime tooling surface (scripts/enable_mapping.py,
disable_mapping.py, save_map.py, load_map.py + launching the node) in one
binary:

  python -m ndt_2d_tpu.cli simulate --world corridor --scans 200 --out bag.npz
  python -m ndt_2d_tpu.cli run --bag bag.npz --map-out map.npz
  python -m ndt_2d_tpu.cli localize --bag bag.npz --map map.npz [--particle-filter]
  python -m ndt_2d_tpu.cli enable-mapping / disable-mapping --socket CTL
  python -m ndt_2d_tpu.cli save-map --socket CTL --filename map.npz
  python -m ndt_2d_tpu.cli load-map --socket CTL --filename map.npz
  python -m ndt_2d_tpu.cli info --map map.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

import numpy as np


def _add_matcher_args(p: argparse.ArgumentParser, ns: str) -> None:
    """Expose the reference's namespaced matcher parameters
    (scan_matcher_ndt.cpp:37-44) as CLI flags."""
    for name, default in [("ndt_resolution", 0.25),
                          ("search_angular_resolution", 0.0025),
                          ("search_angular_size", 0.1),
                          ("search_linear_resolution", 0.005),
                          ("search_linear_size", 0.05)]:
        p.add_argument(f"--{ns}.{name}", type=float, default=None,
                       dest=f"{ns}__{name}")
    p.add_argument(f"--{ns}.laser_max_beams", type=int, default=None,
                   dest=f"{ns}__laser_max_beams")
    p.add_argument(f"--{ns}.grid_cells", type=int, default=None,
                   dest=f"{ns}__grid_cells")
    p.add_argument(f"--{ns}.refine_iterations", type=int, default=None,
                   dest=f"{ns}__refine_iterations",
                   help="Newton sub-lattice polish iterations (0 = off)")
    p.add_argument(f"--{ns}.overlapping_grids", type=int, default=None,
                   dest=f"{ns}__overlapping_grids",
                   help="1 = Biber 4-overlapping-grids scoring (the "
                        "reference's single-grid simplification off)")


def _add_pf_args(p: argparse.ArgumentParser) -> None:
    """The reference's particle-filter parameters (ndt_mapper.cpp:71-88),
    derived from the config dataclass so the flag list can't drift."""
    import dataclasses as _dc

    from ndt_2d_tpu.config import ParticleFilterConfig
    for f in _dc.fields(ParticleFilterConfig):
        # f.type is a string under `from __future__ import annotations`;
        # the default value's type is the reliable source.
        p.add_argument(f"--pf.{f.name}", type=type(f.default),
                       default=None, dest=f"pf__{f.name}")


def _pf_config(args):
    import dataclasses as _dc

    from ndt_2d_tpu.config import ParticleFilterConfig
    kw = {}
    for f in _dc.fields(ParticleFilterConfig):
        v = getattr(args, f"pf__{f.name}", None)
        if v is not None:
            kw[f.name] = v
    return ParticleFilterConfig(**kw)


def _matcher_config(args, ns: str):
    from ndt_2d_tpu.config import ScanMatcherConfig
    kw = {}
    for f in ("ndt_resolution", "search_angular_resolution",
              "search_angular_size", "search_linear_resolution",
              "search_linear_size", "laser_max_beams", "refine_iterations"):
        v = getattr(args, f"{ns}__{f}", None)
        if v is not None:
            kw[f] = v
    gc = getattr(args, f"{ns}__grid_cells", None)
    if gc is not None:
        kw["grid_cells_x"] = gc
        kw["grid_cells_y"] = gc
    og = getattr(args, f"{ns}__overlapping_grids", None)
    if og is not None:
        kw["overlapping_grids"] = bool(og)
    return ScanMatcherConfig(**kw)


# Loop-closure recipes, exposed as one-flag presets.  Each preset sets only
# the QUALITY levers (gate, confirmation region, candidate sources, pruning,
# robust loss, Newton polish); session scaffolding (keyframe spacing, grid
# sizing, search radius, pipelining depth) stays bag-dependent and at its
# defaults unless set explicitly.  Any explicit flag overrides its preset
# value.  "global_refine_iterations" / "robust_loss" apply to the nested
# global-matcher / solver configs.  Each recipe's correctness bar on the
# current device lives with the cell that runs it (chip_smoke.py runs
# "simlab"); benchmarks/loop_closure_pr.py measures closure recall and
# precision against ground truth.
_RECIPES = {
    # Radius search over structured indoor loops: a loosened gate (0.85 x
    # typical score) with 3-scan confirmation regions, the dual-position
    # radius search, and a redescending loss that switches off a rare wrong
    # closure in the solve.
    "office": dict(
        loop_closure_gate_scale=0.85, loop_closure_region_size=3,
        loop_search_positions="both", robust_loss="geman_mcclure",
        global_refine_iterations=8),
    # Appearance (descriptor) search with far-alias pruning: best-only
    # acceptance, a 1.5 m separation gate, per-pass spatial dedup, a
    # negative cache of clearly rejected pairs and a cap of 16 far rows.
    "office-descriptor": dict(
        loop_search="descriptor", loop_closure_gate_scale=0.85,
        loop_closure_region_size=3, loop_closure_accept="best",
        loop_closure_max_separation=1.5, loop_closure_far_dedup=2.5,
        loop_closure_reject_cache_margin=0.10, loop_closure_max_far_rows=16,
        robust_loss="geman_mcclure", global_refine_iterations=8),
    # Open/cluttered geometry surveyed densely (CARMEN-style): the parity
    # gate (1.0) with the denser region-3 windows; the dual-position search
    # catches reverse-direction revisits the barycenter convention misses.
    "simlab": dict(
        loop_closure_gate_scale=1.0, loop_closure_region_size=3,
        loop_search_positions="both", robust_loss="geman_mcclure",
        global_refine_iterations=8),
    # High odometry drift (radius search can't reach the revisits): union
    # candidates + best-accept + separation gate + far-row pruning.
    "drift": dict(
        loop_search="both", loop_closure_accept="best",
        loop_closure_max_separation=1.5, global_search_limit=8,
        descriptor_min_similarity=0.80, loop_closure_region_size=3,
        loop_closure_far_dedup=2.5, loop_closure_reject_cache_margin=0.10,
        loop_closure_max_far_rows=16,
        robust_loss="geman_mcclure", global_refine_iterations=8),
}


def _mapper_config(args):
    import dataclasses as _dc

    from ndt_2d_tpu.config import MapperConfig, SolverConfig
    recipe = dict(_RECIPES.get(getattr(args, "recipe", None) or "", {}))
    robust_loss = recipe.pop("robust_loss", None)
    global_refine = recipe.pop("global_refine_iterations", None)
    kw = recipe
    for f in ("resolution", "minimum_travel_distance",
              "minimum_travel_rotation", "global_search_size",
              "occupancy_threshold", "max_range",
              "descriptor_min_similarity", "loop_closure_gate_scale"):
        v = getattr(args, f.replace("-", "_"), None)
        if v is not None:
            kw[f] = v
    for f in ("rolling_depth", "global_search_limit",
              "optimization_node_limit", "loop_closure_every",
              "max_points_per_scan", "loop_search", "scan_matcher_type",
              "max_inflight", "loop_closure_region_size",
              "loop_closure_accept", "loop_closure_max_separation",
              "loop_closure_solve_before_reanchor", "loop_search_positions",
              "loop_closure_far_dedup", "loop_closure_reject_cache_margin",
              "loop_closure_max_far_rows", "auto_grow_grids"):
        v = getattr(args, f, None)
        if v is not None:
            kw[f] = v
    if getattr(args, "particle_filter", False):
        kw["use_particle_filter"] = True
    if getattr(args, "no_mapping", False):
        kw["enable_mapping"] = False
    kw["local_scan_matcher"] = _matcher_config(args, "local_scan_matcher")
    gm = _matcher_config(args, "global_scan_matcher")
    if (global_refine is not None
            and getattr(args, "global_scan_matcher__refine_iterations",
                        None) is None):
        gm = _dc.replace(gm, refine_iterations=global_refine)
    kw["global_scan_matcher"] = gm
    robust_loss = getattr(args, "robust_loss", None) or robust_loss
    if robust_loss is not None:
        kw["solver"] = _dc.replace(SolverConfig(), robust_loss=robust_loss)
    kw["particle_filter"] = _pf_config(args)
    return MapperConfig(**kw)


def cmd_simulate(args) -> int:
    from ndt_2d_tpu.io import bag as bag_mod
    bag = bag_mod.record_synthetic(
        args.world, args.scans, n_beams=args.beams, range_max=args.range_max,
        scan_noise=args.scan_noise, odom_trans_noise=args.odom_noise,
        odom_rot_noise=args.odom_rot_noise, seed=args.seed)
    bag_mod.save_bag(bag, args.out)
    print(json.dumps({"out": args.out, "scans": len(bag),
                      "beams": args.beams}))
    return 0


def _run_session(args, localize: bool) -> int:
    from ndt_2d_tpu.io import bag as bag_mod
    from ndt_2d_tpu.io import serialization
    from ndt_2d_tpu.mapping import runtime
    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.utils import metrics

    cfg = _mapper_config(args)
    bag = bag_mod.load_bag(args.bag)

    graph = None
    if getattr(args, "map", None):
        graph = serialization.load_graph(args.map, cfg.max_points_per_scan,
                                         cfg.use_barycenter)
    if localize:
        cfg = dataclasses.replace(cfg, enable_mapping=False)
    mesh = None
    if getattr(args, "distributed", False):
        # Multi-process mesh: join the jax.distributed runtime (coordinator
        # etc. from NDT2D_DIST_* env vars) and span ALL processes' devices.
        # An explicit --mesh smaller than the global device count would
        # cover only the first processes' devices; the remaining processes
        # would then each take the single-process path and diverge, so the
        # mesh is forced to span everything.
        from ndt_2d_tpu.parallel import distributed, mesh as mesh_mod
        distributed.initialize()
        import jax
        requested = getattr(args, "mesh", None)
        if requested and requested != jax.device_count():
            print(json.dumps({
                "warning": f"--distributed forces the mesh over all "
                           f"{jax.device_count()} global devices; "
                           f"ignoring --mesh {requested}"}))
        mesh = mesh_mod.make_mesh(jax.device_count())
    elif getattr(args, "mesh", None):
        from ndt_2d_tpu.parallel import mesh as mesh_mod
        mesh = mesh_mod.make_mesh(args.mesh)
    if getattr(args, "resume", None):
        mapper = serialization.load_session(args.resume, cfg, mesh=mesh)
    else:
        mapper = Mapper(cfg, graph=graph, mesh=mesh)

    control = None
    if args.socket:
        control = runtime.ControlServer(mapper, args.socket)

    if getattr(args, "global_init", False) and (
            getattr(args, "resume", None) or
            (not localize and graph is None)):
        print(json.dumps({"error": "--global-init requires a map to "
                          "localize in and is incompatible with --resume"}))
        return 1
    if (localize or graph is not None) and not getattr(args, "resume", None):
        if getattr(args, "global_init", False):
            # Global relocalization: no initial pose at all, uniform
            # particle cloud over the map's free space.
            if not mapper.global_localize(bag.odom[0]):
                print(json.dumps({"error": "global_localize failed "
                                  "(requires --particle-filter and a map)"}))
                return 1
        else:
            # Seed localization at the bag's first true/odometric pose.
            # (A resumed session already carries its pose estimate.)
            init = (metrics.relative_to_first(bag.truth)[0]
                    if bag.truth is not None else np.zeros(3))
            mapper.set_initial_pose(init, np.diag([0.25, 0.25, 0.06]),
                                    bag.odom[0])

    def progress(t, res):
        if args.verbose and res.accepted:
            print(f"scan {t}: pose={np.round(res.pose, 3) if res.pose is not None else None} "
                  f"score={res.matched_score:.3f}", file=sys.stderr)

    if getattr(args, "trace_dir", None):
        from ndt_2d_tpu.utils.profiling import device_trace
        with device_trace(args.trace_dir):
            stats = runtime.run_bag(mapper, bag, progress=progress,
                                    control=control)
        stats["trace_dir"] = args.trace_dir
    else:
        stats = runtime.run_bag(mapper, bag, progress=progress,
                                control=control)

    est = stats.pop("_est", None)
    est_t = stats.pop("_est_t", None)
    if getattr(args, "traj_out", None):
        serialization.save_tum(args.traj_out, est_t, est)
        stats["traj_out"] = args.traj_out
    if getattr(args, "map_out", None):
        mapper.configure(8, args.map_out)  # SAVE_TO_FILE
        stats["map_out"] = args.map_out
    if getattr(args, "session_out", None):
        serialization.save_session(mapper, args.session_out)
        stats["session_out"] = args.session_out
    if getattr(args, "grid_out", None):
        grid = mapper.render_map()
        np.savez_compressed(args.grid_out, data=grid.data, origin=grid.origin,
                            resolution=grid.resolution)
        stats["grid_out"] = args.grid_out
    if getattr(args, "viz_out", None):
        from ndt_2d_tpu.utils import viz
        viz.save_graph_png(
            mapper.graph, args.viz_out, grid=mapper.render_map(),
            particles=(mapper.filter.cloud() if mapper.filter else None),
            truth=(metrics.relative_to_first(bag.truth)
                   if bag.truth is not None else None))
        stats["viz_out"] = args.viz_out
    if control:
        control.close()
    import jax
    dev = jax.devices()[0]
    stats["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                       "count": jax.device_count()}
    print(json.dumps(stats))
    return 0


def cmd_run(args) -> int:
    return _run_session(args, localize=False)


def cmd_localize(args) -> int:
    return _run_session(args, localize=True)


def cmd_configure(args, action: int) -> int:
    from ndt_2d_tpu.mapping import runtime
    out = runtime.send_configure(args.socket, action,
                                 getattr(args, "filename", "") or "")
    print(json.dumps(out))
    return 0 if out.get("ok") else 1


def cmd_serve(args) -> int:
    import signal
    import threading

    from ndt_2d_tpu.io import serialization
    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.mapping.server import ScanServer

    cfg = _mapper_config(args)
    graph = None
    if args.map:
        graph = serialization.load_graph(args.map, cfg.max_points_per_scan,
                                         cfg.use_barycenter)
    mapper = Mapper(cfg, graph=graph)
    server = ScanServer(mapper, args.socket, publish_dir=args.publish_dir,
                        publish_png=args.publish_png)
    print(json.dumps({"serving": args.socket,
                      "publish_dir": args.publish_dir}), flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        server.close()
    return 0


def cmd_feed(args) -> int:
    from ndt_2d_tpu.mapping.server import stream_bag
    last = stream_bag(args.bag, args.socket, realtime_hz=args.hz,
                      windowed=args.windowed)
    last["results"] = len(last.get("results", {}))  # keep the print short
    times = last.pop("scan_times_s", [])
    if len(times) > 3:  # median over scans 4.. (first dispatch compiles)
        import numpy as np
        last["scan_ms_median"] = round(float(np.median(times[3:])) * 1e3, 2)
    print(json.dumps(last))
    return 0 if last.get("ok") else 1


def cmd_import_carmen(args) -> int:
    from ndt_2d_tpu.io import bag as bag_mod
    from ndt_2d_tpu.io import carmen
    report = carmen.CarmenReport()
    bag = carmen.load_carmen(args.log, fov_degrees=args.fov_degrees,
                             range_max=args.range_max,
                             use_laser_pose=not args.robot_odom,
                             time_increment=args.time_increment,
                             report=report)
    bag_mod.save_bag(bag, args.out)
    print(json.dumps({"out": args.out, "scans": len(bag),
                      "beams": int(bag.ranges.shape[1]),
                      "range_max": bag.range_max,
                      "config": list(report.kept_config),
                      "skipped_lines": report.skipped,
                      "has_timestamps": bag.times is not None}))
    return 0


def cmd_import_rosbag2(args) -> int:
    """One-way migration of a reference (ROS ndt_2d) map file
    (src/graph.cpp:49-105 format) into the native npz schema."""
    from ndt_2d_tpu.io import rosbag2, serialization
    g = rosbag2.import_map(args.bag, args.max_points)
    serialization.save_graph(g, args.out)
    print(json.dumps({"out": args.out, "scans": g.num_scans,
                      "constraints": g.num_constraints,
                      "loop_closures": int(g.constraint_switchable.sum())}))
    return 0


def cmd_export_rosbag2(args) -> int:
    """Write a native map as a reference-format rosbag2 directory so the
    ROS ndt_2d package can load it (src/graph.cpp:107-165 format)."""
    from ndt_2d_tpu.io import rosbag2, serialization
    g = serialization.load_graph(args.map, args.max_points)
    rosbag2.export_map(g, args.out)
    print(json.dumps({"out": args.out, "scans": g.num_scans,
                      "constraints": g.num_constraints}))
    return 0


def cmd_viz(args) -> int:
    """Render a saved map (and optional occupancy grid) to PNG — the
    offline analog of the reference's RViz graph/map displays."""
    from ndt_2d_tpu.io import serialization
    from ndt_2d_tpu.mapping import occupancy
    from ndt_2d_tpu.utils import viz
    g = serialization.load_graph(args.map, args.max_points)
    grid = None
    if args.grid:
        z = np.load(args.grid)
        grid = occupancy.OccupancyGridResult(
            data=z["data"], origin=z["origin"],
            resolution=float(z["resolution"]))
    elif args.render_grid:
        grid = occupancy.render_occupancy(g.poses, g.points, g.point_mask,
                                          args.resolution, 0.25)
    viz.save_graph_png(g, args.out, grid=grid)
    print(json.dumps({"out": args.out, "scans": g.num_scans,
                      "constraints": g.num_constraints}))
    return 0


def cmd_merge_maps(args) -> int:
    from ndt_2d_tpu.io import serialization
    from ndt_2d_tpu.mapping import merge

    ga = serialization.load_graph(args.map_a, args.max_points)
    gb = serialization.load_graph(args.map_b, args.max_points)
    try:
        res = merge.merge_maps(ga, gb, range_max=args.max_range,
                               min_similarity=args.min_similarity,
                               score_threshold=args.score_threshold,
                               top_k=args.top_k)
    except ValueError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    serialization.save_graph(res.graph, args.out)
    print(json.dumps({
        "out": args.out,
        "scans": res.graph.num_scans,
        "constraints": res.graph.num_constraints,
        "cross_constraints": res.pairs_accepted,
        "pairs_checked": res.pairs_checked,
        "transform_b_to_a": [round(float(v), 4) for v in res.transform],
        "optimized": res.optimized,
    }))
    return 0


def cmd_info(args) -> int:
    from ndt_2d_tpu.io import serialization
    g = serialization.load_graph(args.map, 512)
    print(json.dumps({
        "scans": g.num_scans,
        "constraints": g.num_constraints,
        "loop_closures": int(g.constraint_switchable.sum()),
        "bounds_min": g.poses[:, :2].min(0).tolist() if g.num_scans else None,
        "bounds_max": g.poses[:, :2].max(0).tolist() if g.num_scans else None,
    }))
    return 0


def _add_loop_closure_args(p: argparse.ArgumentParser) -> None:
    """Loop-closure quality levers, shared by run/localize and serve (the
    live node tunes closures exactly like the replay surface)."""
    p.add_argument("--loop-search",
                   choices=["radius", "descriptor", "both"],
                   default=None, dest="loop_search",
                   help="loop-closure candidate source (default radius; "
                        "descriptor = drift-robust appearance search; "
                        "both = deduped union of the two)")
    p.add_argument("--loop-closure-region-size", type=int, default=None,
                   dest="loop_closure_region_size", metavar="S",
                   help="scans per candidate confirmation region "
                        "(2 = reference parity, 3 = one either side)")
    p.add_argument("--loop-closure-accept", choices=["first", "best"],
                   default=None, dest="loop_closure_accept",
                   help="per-query acceptance policy: first passing "
                        "candidate (reference order) or only the "
                        "best-scoring one (precision lever)")
    p.add_argument("--loop-closure-max-separation", type=float,
                   default=None, dest="loop_closure_max_separation",
                   metavar="M",
                   help="accept a closure only if the match lands the "
                        "query within M meters of the candidate "
                        "(inf = reference parity, score-only gate)")
    p.add_argument("--descriptor-min-similarity", type=float,
                   default=None, dest="descriptor_min_similarity",
                   help="cosine cutoff for descriptor loop-closure "
                        "candidates (loop-search descriptor/both)")
    p.add_argument("--recipe", choices=sorted(_RECIPES), default=None,
                   help="apply a loop-closure recipe preset: office = "
                        "radius search on structured loops (loosened "
                        "gate, region-3 windows); office-descriptor = "
                        "appearance search with far-alias pruning; "
                        "simlab = dense surveys (parity gate, dual-"
                        "position search); drift = high odometry drift "
                        "(union candidates + precision gates).  "
                        "Explicit flags override preset values")
    p.add_argument("--loop-closure-gate-scale", type=float, default=None,
                   dest="loop_closure_gate_scale",
                   help="loop-closure accept gate as a multiple of the "
                        "EWMA typical match score (1.0 = reference "
                        "parity; 0.85 = the measured high-recall "
                        "office recipe)")
    p.add_argument("--robust-loss", default=None,
                   choices=["none", "huber", "geman_mcclure"],
                   help="robust loss on switchable (loop-closure) "
                        "edges in the pose-graph solve (none = "
                        "reference parity; geman_mcclure = the "
                        "measured recipes' redescending loss)")
    p.add_argument("--loop-closure-solve-before-reanchor",
                   action=argparse.BooleanOptionalAction, default=None,
                   dest="loop_closure_solve_before_reanchor",
                   help="robust-solve before re-anchoring the tracker "
                        "on a newest-scan closure (default ON since "
                        "round 5; --no-... restores the reference's "
                        "re-anchor-first behavior)")
    p.add_argument("--loop-search-positions",
                   choices=["barycenter", "pose", "both"], default=None,
                   dest="loop_search_positions",
                   help="radius-search position space; 'both' adds a "
                        "pose-space arm that catches reverse-direction "
                        "revisits the barycenter convention misses")
    p.add_argument("--loop-closure-far-dedup", type=float, default=None,
                   dest="loop_closure_far_dedup", metavar="M",
                   help="per-pass spatial dedup radius for far "
                        "(coarse) confirmation rows (0 = off)")
    p.add_argument("--loop-closure-reject-cache-margin", type=float,
                   default=None, dest="loop_closure_reject_cache_margin",
                   help="cache clearly-rejected far site pairs and "
                        "skip re-proposing them (fraction of |gate|; "
                        "0 = off)")
    p.add_argument("--loop-closure-max-far-rows", type=int, default=None,
                   dest="loop_closure_max_far_rows",
                   help="per-pass cap on far confirmation rows, "
                        "similarity-ranked (0 = unlimited)")


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ndt_2d_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate", help="generate a synthetic scan bag")
    p.add_argument("--world", choices=["corridor", "box", "office"],
                   default="corridor")
    p.add_argument("--scans", type=int, default=200)
    p.add_argument("--beams", type=int, default=360)
    p.add_argument("--range-max", type=float, default=15.0)
    p.add_argument("--scan-noise", type=float, default=0.01)
    p.add_argument("--odom-noise", type=float, default=0.008)
    p.add_argument("--odom-rot-noise", type=float, default=0.002)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_simulate)

    for name, localize in [("run", False), ("localize", True)]:
        p = sub.add_parser(name, help=("replay a bag " +
                                       ("localizing" if localize
                                        else "mapping")))
        p.add_argument("--bag", required=True)
        p.add_argument("--map", default=None,
                       help="existing map to load (resume/localize)")
        p.add_argument("--map-out", default=None)
        p.add_argument("--session-out", default=None,
                       help="full session checkpoint (resume exactly, no "
                            "re-localization; beyond the reference's "
                            "map-only save)")
        p.add_argument("--resume", default=None,
                       help="resume from a --session-out checkpoint")
        p.add_argument("--grid-out", default=None,
                       help="occupancy grid npz output")
        p.add_argument("--traj-out", default=None,
                       help="estimated trajectory in TUM format "
                            "(t x y z qx qy qz qw; timestamps = scan "
                            "indices) for external evaluation tools")
        p.add_argument("--viz-out", default=None,
                       help="session visualization PNG (graph + map + "
                            "particles over ground truth)")
        p.add_argument("--socket", default=None,
                       help="UNIX socket path for runtime control")
        p.add_argument("--particle-filter", action="store_true")
        p.add_argument("--global-init", action="store_true",
                       help="global relocalization: uniform particle cloud "
                            "over the map's free space instead of an initial "
                            "pose (requires --particle-filter)")
        p.add_argument("--no-mapping", action="store_true")
        _add_loop_closure_args(p)
        p.add_argument("--auto-grow-grids",
                       action=argparse.BooleanOptionalAction, default=None,
                       dest="auto_grow_grids",
                       help="rebuild a matcher at a larger static grid "
                            "when a session outgrows it (default on; "
                            "--no-... raises with sizing advice instead)")
        p.add_argument("--scan-matcher-type", default=None,
                       dest="scan_matcher_type",
                       help="matcher plugin (ndt_mapper.cpp:91-92): ndt, "
                            "correlative, or ndt_newton (sub-lattice Newton "
                            "polish; best for localize, measured to worsen "
                            "rolling-mapping ATE)")
        p.add_argument("--verbose", action="store_true")
        p.add_argument("--trace-dir", default=None,
                       help="capture a jax.profiler device trace of the "
                            "session (view with xprof/TensorBoard)")
        # mapper params (ndt_mapper.cpp:59-103)
        p.add_argument("--resolution", type=float, default=None)
        p.add_argument("--minimum-travel-distance", type=float, default=None,
                       dest="minimum_travel_distance")
        p.add_argument("--minimum-travel-rotation", type=float, default=None,
                       dest="minimum_travel_rotation")
        p.add_argument("--rolling-depth", type=int, default=None,
                       dest="rolling_depth")
        p.add_argument("--global-search-size", type=float, default=None,
                       dest="global_search_size")
        p.add_argument("--global-search-limit", type=int, default=None,
                       dest="global_search_limit")
        p.add_argument("--optimization-node-limit", type=int, default=None,
                       dest="optimization_node_limit")
        p.add_argument("--loop-closure-every", type=int, default=None,
                       dest="loop_closure_every")
        p.add_argument("--max-points-per-scan", type=int, default=None,
                       dest="max_points_per_scan")
        p.add_argument("--occupancy-threshold", type=float, default=None,
                       dest="occupancy_threshold")
        p.add_argument("--max-range", type=float, default=None,
                       dest="max_range")
        p.add_argument("--max-inflight", type=int, default=None,
                       dest="max_inflight",
                       help="pipelined mapping: keep the pose chain on "
                            "device with up to N steps in flight (0 = "
                            "synchronous per-scan round trips, the default; "
                            "8 is a good pipelined value)")
        p.add_argument("--mesh", type=int, default=None, metavar="N",
                       help="run the full pipeline sharded over an N-device "
                            "jax mesh: match angles over 'space', "
                            "loop-closure candidate windows + pose-graph "
                            "constraints over 'batch', occupancy rays over "
                            "the whole mesh (parallel.runtime)")
        p.add_argument("--distributed", action="store_true",
                       help="join the jax.distributed multi-process runtime "
                            "(coordinator/process id from NDT2D_DIST_COORD/"
                            "_NPROC/_PID env vars; launch one identical "
                            "process per host) and mesh over every "
                            "process's devices; implies --mesh <all>")
        _add_matcher_args(p, "local_scan_matcher")
        _add_matcher_args(p, "global_scan_matcher")
        _add_pf_args(p)
        p.set_defaults(fn=cmd_run if not localize else cmd_localize)

    # The four reference scripts (scripts/*.py) as control-channel verbs.
    p = sub.add_parser("enable-mapping")
    p.add_argument("--socket", required=True)
    p.set_defaults(fn=lambda a: cmd_configure(a, 1))
    p = sub.add_parser("disable-mapping")
    p.add_argument("--socket", required=True)
    p.set_defaults(fn=lambda a: cmd_configure(a, 2))
    p = sub.add_parser("load-map")
    p.add_argument("--socket", required=True)
    p.add_argument("--filename", required=True)
    p.set_defaults(fn=lambda a: cmd_configure(a, 4))
    p = sub.add_parser("save-map")
    p.add_argument("--socket", required=True)
    p.add_argument("--filename", required=True)
    p.set_defaults(fn=lambda a: cmd_configure(a, 8))

    p = sub.add_parser("import-carmen",
                       help="convert a CARMEN .log/.clf dataset "
                            "(Intel, MIT, Freiburg...) to a scan bag")
    p.add_argument("--log", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--fov-degrees", type=float, default=180.0)
    p.add_argument("--range-max", type=float, default=None)
    p.add_argument("--robot-odom", action="store_true",
                   help="use the robot odometry columns instead of the "
                        "laser pose")
    p.add_argument("--time-increment", type=float, default=0.0,
                   help="per-beam time (s) for motion de-skew; CARMEN logs "
                        "record no per-beam time, so this is a sensor "
                        "constant (75 Hz SICK LMS-200 / 180 beams: 7.4e-5). "
                        "0 disables de-skew")
    p.set_defaults(fn=cmd_import_carmen)

    p = sub.add_parser("import-rosbag2",
                       help="migrate a reference (ROS ndt_2d) rosbag2 map "
                            "file to the native npz schema")
    p.add_argument("--bag", required=True,
                   help="bag directory or .db3 file written by the "
                        "reference's save_map")
    p.add_argument("--out", required=True)
    p.add_argument("--max-points", type=int, default=512)
    p.set_defaults(fn=cmd_import_rosbag2)

    p = sub.add_parser("export-rosbag2",
                       help="write a native map as a reference-format "
                            "rosbag2 directory (loadable by the ROS "
                            "ndt_2d package)")
    p.add_argument("--map", required=True)
    p.add_argument("--out", required=True, help="bag DIRECTORY to create")
    p.add_argument("--max-points", type=int, default=512)
    p.set_defaults(fn=cmd_export_rosbag2)

    p = sub.add_parser("info", help="inspect a saved map")
    p.add_argument("--map", required=True)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("merge-maps",
                       help="align and fuse two saved maps (descriptor "
                            "search + full-heading NDT registration + joint "
                            "solve); no reference equivalent")
    p.add_argument("--map-a", required=True, help="base map (keeps its frame)")
    p.add_argument("--map-b", required=True, help="map merged into A's frame")
    p.add_argument("--out", required=True)
    p.add_argument("--max-range", type=float, default=15.0)
    p.add_argument("--max-points", type=int, default=512)
    p.add_argument("--top-k", type=int, default=10,
                   help="descriptor candidate pairs to confirm")
    p.add_argument("--min-similarity", type=float, default=0.9)
    p.add_argument("--score-threshold", type=float, default=-0.25,
                   help="NDT accept gate for cross-map matches")
    p.set_defaults(fn=cmd_merge_maps)

    p = sub.add_parser("serve", help="live scan server (the node analog): "
                                     "scans in over a socket, pose out, "
                                     "4 Hz latched map artifacts")
    p.add_argument("--socket", required=True, help="UNIX socket path")
    p.add_argument("--map", default=None, help="map to load at startup")
    p.add_argument("--publish-dir", default=None,
                   help="directory for latched map.npz/state.json artifacts")
    p.add_argument("--publish-png", action="store_true")
    p.add_argument("--particle-filter", action="store_true")
    p.add_argument("--no-mapping", action="store_true")
    _add_matcher_args(p, "local_scan_matcher")
    _add_matcher_args(p, "global_scan_matcher")
    _add_loop_closure_args(p)
    p.add_argument("--max-range", type=float, default=None)
    p.add_argument("--max-inflight", type=int, default=None,
                   dest="max_inflight",
                   help="pipelined device pose chain (required for windowed "
                        "clients to gain throughput; see 'feed --windowed')")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("feed", help="stream a bag into a running server")
    p.add_argument("--bag", required=True)
    p.add_argument("--socket", required=True)
    p.add_argument("--hz", type=float, default=0.0,
                   help="pace the stream (0 = as fast as possible)")
    p.add_argument("--windowed", action="store_true",
                   help="windowed protocol: immediate per-scan acks, poses "
                        "stream back asynchronously (pairs with a server "
                        "run with --max-inflight)")
    p.set_defaults(fn=cmd_feed)

    p = sub.add_parser("viz", help="render a saved map to PNG")
    p.add_argument("--map", required=True)
    p.add_argument("--grid", default=None, help="occupancy grid npz overlay")
    p.add_argument("--render-grid", action="store_true",
                   help="re-render the occupancy grid from the map")
    p.add_argument("--resolution", type=float, default=0.05)
    p.add_argument("--max-points", type=int, default=512)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_viz)
    return ap


# Subcommands that compile device programs and so use the persistent cache.
_COMPUTE_COMMANDS = frozenset({"run", "localize", "serve", "merge-maps"})


def _parse_for_test(argv):
    """Parse argv through the real parser without executing (tests)."""
    return _build_parser().parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.WARNING)
    args = _build_parser().parse_args(argv)
    platform = os.environ.get("NDT2D_PLATFORM")
    if platform:
        # jax.config still takes effect after jax was imported (the
        # JAX_PLATFORMS variable does not); no backend starts here.
        import jax
        jax.config.update("jax_platforms", platform)
    if args.cmd in _COMPUTE_COMMANDS:
        # Client commands (feed, save-map, info, ...) leave JAX untouched:
        # a second process that opened the card would reserve most of its
        # memory beside a running `serve`.
        from ndt_2d_tpu.utils.jax_cache import enable_compilation_cache
        enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
