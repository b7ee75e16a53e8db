"""Attribute long-session RSS growth to its mechanisms.

The 10k-scan benchmark (long_session.py) measures a linear RSS curve.
This benchmark runs a closure-dense multi-lap office session in three arms
on the CPU backend and one optional arm on the default (GPU) backend, and
reports the steady-state RSS slope of each:

  * ``noloop``    — loop closure disabled: isolates the per-scan path.
  * ``notrim``    — full pipeline with ``NDT2D_HEAP_TRIM=0``: measures the
                    glibc-arena retention of the loop-closure pass's
                    short-lived padded batches.
  * ``trim``      — full pipeline with the default per-pass
                    ``malloc_trim`` (utils/memory.py).

What the arms separate:

  * the per-scan path should be RSS-flat (graph SoA is ~MBs; the pipelined
    window is bounded at max_inflight entries);
  * host-side growth from loop-closure-pass churn retained by the
    allocator, which ``malloc_trim`` after each pass should hold flat;
  * whatever the device backend's client retains on top — the CPU arms
    bound what the framework itself retains.

Each arm REEXECUTES this script as a subprocess (the arms must not share
an allocator or a JAX runtime).  Appends one JSON row to
``benchmarks/memory_attribution.json``.

Usage: python benchmarks/memory_attribution.py [--scans 600]
       python benchmarks/memory_attribution.py --arm trim --scans 600  # one arm
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "memory_attribution.json")


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024
    return 0.0


def run_arm(arm: str, scans: int) -> None:
    """One session in-process; prints a JSON result line on stdout."""
    # CPU backend, forced the way tests/conftest.py does (jax.config works
    # even after jax was imported).
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses as dc

    from long_session import make_lap_bag

    from ndt_2d_tpu.config import (MapperConfig, ScanMatcherConfig,
                                   SolverConfig)
    from ndt_2d_tpu.mapping.mapper import Mapper

    world, truth, odom, msgs = make_lap_bag(scans, laps=max(2, scans // 300))
    kw = dict(
        local_scan_matcher=ScanMatcherConfig(grid_cells_x=192,
                                             grid_cells_y=192),
        global_scan_matcher=ScanMatcherConfig(
            ndt_resolution=0.35, search_linear_size=0.15,
            search_linear_resolution=0.01, search_angular_size=0.05,
            grid_cells_x=160, grid_cells_y=160, refine_iterations=8),
        max_points_per_scan=512, global_search_size=4.0,
        optimization_node_limit=10, loop_closure_every=20,
        minimum_travel_distance=0.3, max_inflight=8,
        loop_closure_gate_scale=0.85, loop_closure_region_size=3,
        solver=dc.replace(SolverConfig(), robust_loss="geman_mcclure"))
    if arm == "noloop":
        kw["loop_closure_every"] = 10 ** 9
    mapper = Mapper(MapperConfig(**kw))

    samples = []
    for t in range(len(truth)):
        mapper.process_scan(msgs[t], odom[t])
        if (t + 1) % 100 == 0:
            samples.append((t + 1, round(rss_mb(), 1)))
    # Steady-state slope over the second half (past the one-time compiles).
    xs = np.asarray([s for s, _ in samples[len(samples) // 2:]], float)
    ys = np.asarray([r for _, r in samples[len(samples) // 2:]], float)
    slope = float(np.polyfit(xs, ys, 1)[0]) if len(xs) > 1 else float("nan")
    print(json.dumps({
        "arm": arm, "scans": scans, "samples": samples,
        "keyframes": mapper.graph.num_scans,
        "closures": mapper.stats.loop_closures_accepted,
        "rss_final_mb": samples[-1][1] if samples else None,
        "mb_per_scan_steady": round(slope, 4),
    }))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=600)
    ap.add_argument("--arm", default=None,
                    choices=["noloop", "notrim", "trim"],
                    help="run ONE arm in-process (used by the driver mode)")
    args = ap.parse_args(argv)

    if args.arm:
        env_trim = os.environ.get("NDT2D_HEAP_TRIM", "1")
        arm = args.arm
        if arm == "notrim" and env_trim != "0":
            print("notrim arm needs NDT2D_HEAP_TRIM=0", file=sys.stderr)
            return 1
        run_arm(arm, args.scans)
        return 0

    rows = {}
    for arm in ("noloop", "notrim", "trim"):
        env = dict(os.environ)
        env["NDT2D_HEAP_TRIM"] = "0" if arm == "notrim" else "1"
        print(f"arm {arm}...", file=sys.stderr, flush=True)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--arm", arm, "--scans", str(args.scans)],
            env=env, capture_output=True, text=True, timeout=3600)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return 1
        rows[arm] = json.loads(out.stdout.strip().splitlines()[-1])

    row = {"scans": args.scans, "arms": rows}
    try:
        with open(RESULTS) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        data = []
    data.append(row)
    with open(RESULTS, "w") as f:
        json.dump(data, f, indent=1)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
