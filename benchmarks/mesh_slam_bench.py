"""Config 10: end-to-end multichip SLAM through the REAL runtime.

Runs the config-3 office recipe twice on the SAME bag — once on a single
device, once through ``Mapper(mesh=...)`` over the 8-virtual-device CPU mesh
(the mesh validates the sharded pipeline on virtual devices; on real
cards use ``chip_smoke.py --multi-gpu``) — and reports closures + ATE for
both.  The multichip claim this row backs: the FULL product pipeline
(sharded rolling match, loop-closure search + sharded vmapped confirmation +
gate, constraint-sharded solve, sharded occupancy export) runs to completion
with >= 1 closure at single-device trajectory quality.

Standalone script (not a run_benchmarks config function) because the CPU
platform must be forced BEFORE jax initializes; run_benchmarks.bench_config10
invokes it as a subprocess and forwards the JSON row.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    quick = "--quick" in (argv or sys.argv[1:])
    import jax
    jax.config.update("jax_platforms", "cpu")

    from ndt_2d_tpu.utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()

    import dataclasses as dc

    from ndt_2d_tpu.config import ScanMatcherConfig
    from ndt_2d_tpu.io import bag as bag_mod
    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.parallel import mesh as mesh_mod
    from ndt_2d_tpu.utils import metrics

    n = 150 if quick else 600
    bag = bag_mod.record_synthetic("office", n, n_beams=600, range_max=12.0,
                                   seed=1, odom_trans_noise=0.02,
                                   odom_rot_noise=0.004)
    global_mcfg = ScanMatcherConfig(
        ndt_resolution=0.35, search_linear_size=0.15,
        search_linear_resolution=0.01, search_angular_size=0.05,
        grid_cells_x=160, grid_cells_y=160)
    mcfg = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    from ndt_2d_tpu.config import MapperConfig
    cfg = MapperConfig(local_scan_matcher=mcfg, global_scan_matcher=global_mcfg,
                       max_points_per_scan=512, global_search_size=4.0,
                       optimization_node_limit=10, loop_closure_every=20,
                       minimum_travel_distance=0.3)

    def run(mesh):
        mapper = Mapper(cfg, mesh=mesh)
        est, used_truth, times = [], [], []
        t0 = time.perf_counter()
        for t, (msg, odom) in enumerate(bag):
            t1 = time.perf_counter()
            res = mapper.process_scan(msg, odom)
            if res.accepted:
                times.append(time.perf_counter() - t1)
                est.append(res.pose)
                used_truth.append(bag.truth[t])
        mapper.loop_closure()
        wall = time.perf_counter() - t0
        used_truth = np.asarray(used_truth)
        final = mapper.graph.poses[:len(used_truth)]
        grid = mapper.render_map()
        return {
            "accepted": len(est),
            "loop_closures": int(mapper.graph.constraint_switchable.sum()),
            "loop_closures_rejected": mapper.stats.loop_closures_rejected,
            "optimizations": mapper.stats.optimizations,
            "ate_online_m": round(
                metrics.ate_rmse(np.asarray(est), used_truth), 4),
            "ate_rmse_m": round(metrics.ate_rmse(final, used_truth), 4),
            "ate_aligned_m": round(
                metrics.ate_rmse_aligned(final, used_truth), 4),
            "wall_s": round(wall, 2),
            "scan_ms_median": round(
                float(np.median(np.asarray(times[3:]))) * 1e3, 2),
            "occupied_cells": int((grid.data == 100).sum()),
        }

    mesh = mesh_mod.make_mesh(jax.device_count())
    single_row = run(None)
    mesh_row = run(mesh)
    row = {
        "config": 10,
        "name": "mesh_full_slam_office",
        "scans_in": n,
        "devices": jax.device_count(),
        "mesh": dict(zip(mesh.axis_names,
                         (int(v) for v in mesh.devices.shape))),
        "odom_only_ate_m": round(metrics.ate_rmse(bag.odom, bag.truth), 4),
        "single_device": single_row,
    }
    row.update(mesh_row)  # headline numbers = mesh arm
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
