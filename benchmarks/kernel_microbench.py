"""Scan-match kernel micro-benchmark: gather-strategy shootout.

The candidate-scoring program's cost is set by how many table rows it
gathers.  This benchmark measures, chained inside one jit on the device
(the bench.py methodology), the per-match device time of:

  * local       — the current XLA fast path (2x2 packed-patch row-gather,
                  A*B rows)
  * grouped-G   — matching.gather_opt: one 3x3 patch per G-angle group
                  ((A/G)*B rows, 9-way select)

Usage: python benchmarks/kernel_microbench.py [--quick]
Appends to benchmarks/kernel_microbench.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ndt_2d_tpu.config import ScanMatcherConfig
    from ndt_2d_tpu.matching import gather_opt, matcher
    from ndt_2d_tpu.utils import sim
    from ndt_2d_tpu.utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()

    cfg = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    range_max = 15.0
    world = sim.make_box_world(10.0, 8.0)
    rng = np.random.default_rng(0)
    poses = np.asarray([[4.8, 3.9, 0.0], [5.0, 4.0, 0.05],
                        [5.2, 4.1, -0.05]], np.float32)
    pts, msk = [], []
    for p in poses:
        msg = sim.scan_at_pose(world, p, n_beams=1440, range_max=range_max,
                               noise=0.005, rng=rng)
        a, b = sim.project_scan(msg, 2048)
        pts.append(a)
        msk.append(b)
    grid = matcher.build_window_ndt(
        cfg, jnp.asarray(poses), jnp.asarray(np.stack(pts)),
        jnp.asarray(np.stack(msk)), jnp.ones(3, bool), jnp.float32(range_max))
    msg = sim.scan_at_pose(world, np.asarray([5.0, 4.0, 0.01]), n_beams=1440,
                           range_max=range_max, noise=0.005, rng=rng)
    qp, qm = sim.project_scan(msg, 2048)
    spts, smask, _ = matcher.subsample(
        jnp.asarray(qp), jnp.asarray(qm), jnp.int32(int(qm.sum())),
        cfg.laser_max_beams)
    dths, dls = matcher._search_offsets(cfg)
    pose0 = jnp.asarray([5.02, 3.98, 0.01], jnp.float32)
    K = 64 if args.quick else 512
    A = cfg.num_angles
    n_cand = cfg.num_candidates

    def chain(fn):
        """Sum of best scores over K distinct poses inside one jit."""
        @jax.jit
        def run(p0):
            def body(i, acc):
                cand = fn(p0 + 0.0005 * i)
                return acc + jnp.min(cand)
            return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))
        return run

    variants = {
        "local_2x2": lambda p: matcher._candidate_scores_local(
            cfg, grid, spts, smask, p, dths, dls),
    }
    gmax = gather_opt.max_group(cfg, range_max)
    for g in sorted({2, 4, 8, gmax}):
        if g <= gmax and (A % g == 0 or True):
            variants[f"grouped_{g}"] = (
                lambda p, g=g: gather_opt.candidate_scores_grouped(
                    cfg, grid, spts, smask, p, dths, dls, g))
    rows = {}
    ref = None
    for name, fn in variants.items():
        out = np.asarray(fn(pose0))
        if ref is None:
            ref = out
        delta = float(np.max(np.abs(out - ref)))
        run = chain(fn)
        jax.block_until_ready(run(pose0))
        t0 = time.perf_counter()
        jax.block_until_ready(run(pose0))
        t1 = time.perf_counter()
        jax.block_until_ready(run(pose0))
        t = (min(t1 - t0, time.perf_counter() - t1)) / K
        rows[name] = {"ms_per_match": round(t * 1e3, 4),
                      "candidates_per_sec": round(n_cand / t),
                      "max_abs_delta_vs_local": round(delta, 7)}
        print(f"{name}: {t*1e3:.4f} ms/match  "
              f"{n_cand/t:.3e} cands/s  delta={delta:.2e}",
              file=sys.stderr, flush=True)

    out_row = {
        "name": "kernel_microbench",
        "device": str(jax.devices()[0].device_kind),
        "chain": K,
        "candidates": n_cand,
        "variants": rows,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    print(json.dumps(out_row))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "kernel_microbench.json")
    existing = []
    if os.path.exists(path):
        existing = json.load(open(path))
    existing.append(out_row)
    json.dump(existing, open(path, "w"), indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
